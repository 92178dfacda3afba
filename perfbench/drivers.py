"""The three loops a traffic mix can name.  Each builds the system under
test from the seed, warms every shape it will time, runs the measured
window, then judges what the timed path produced against the plain
reference (or, for the swap tier, against the benchmark's own bytes).

Each returns an ``Outcome``: the end-to-end metrics it measured, the
counts, the numbers compared with their limits, the peak device memory
(read before the reference runs) and what the per-layer readers read.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

import torch

import harness
import system
import traffic as T
import weights as W
from work import percentile


@dataclass
class Ctx:
    workload: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    device: torch.device
    started: float
    tracer_for: object = None  # (first, count, per_item) -> Tracer, or None
    dtype: torch.dtype = torch.bfloat16
    control: bool = False            # also read the control (control.py)

    @property
    def arch(self) -> dict:
        return self.config["arch"]

    @property
    def family(self):
        """The configuration's model family (``families/<reference>.py``)."""
        return harness.family(self.config["reference"])

    @property
    def reference(self):
        """Its plain float32 forward (``reference/<reference>.py``)."""
        return harness.reference(self.config["reference"])

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        if self.device.type == "cuda":
            return torch.cuda.max_memory_allocated(self.device)
        return 0

    def tracer(self, per_item: bool):
        """The traced slice's tracer (``tracing.Tracer``), or None."""
        if self.tracer_for is None:
            return None
        return self.tracer_for(self.traffic["trace_after"],
                               self.traffic["trace_items"], per_item)

    def compared(self, look: dict) -> dict:
        """The numbers the cell's limits file names, each with its
        limit."""
        return {k: (look[k], lim) for k, lim in self.limits.items()}

    def sample_rng(self) -> random.Random:
        return random.Random(T.stream_seed(self.seed, T.STREAM_SAMPLE))


@dataclass
class Outcome:
    e2e: dict
    attempted: int
    failed: int
    compared: dict                   # name -> (value, limit)
    setup_s: float
    memory_peak_bytes: int
    records: dict = field(default_factory=dict)
    slice: object = None

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(v <= lim for v, lim in
                                        self.compared.values())


def _weights(ctx: Ctx):
    """The port's configuration, the benchmark's weights drawn from the
    family's table, and the port's tree of views of them."""
    cfg = system.arch_config(ctx.arch)
    w = W.make(ctx.family.leaves(ctx.arch), ctx.arch,
               ctx.config.get("init", {}),
               T.stream_seed(ctx.seed, T.STREAM_WEIGHTS), ctx.device,
               ctx.dtype)
    return cfg, w, system.program_params(cfg, w, ctx.family, ctx.arch)


# ------------------------------------------------------------- prefill --

def prefill(ctx: Ctx) -> Outcome:
    """Closed loop, one batch in flight: each batch's TTFT runs from its
    submission to ``Engine.prefill`` until its first tokens (the argmax
    of the last position's logits) are on the host."""
    mix = ctx.traffic
    cycle = T.prefill_batches(mix)
    cfg, w, params = _weights(ctx)
    vocab = ctx.arch["vocab_size"]
    eng = system.engine(cfg, params, ctx.device, max(L for L, _ in cycle),
                        max(B for _, B in cycle))

    def serve(toks):
        logits, caches = eng.prefill({"tokens": toks})
        out = torch.argmax(logits, dim=-1).cpu()
        del logits, caches
        return out

    for k, (L, B) in enumerate(cycle):          # warm every shape
        serve(T.tokens(ctx.seed, -1 - k, (B, L), vocab, ctx.device))
    ctx.sync()
    tracer = ctx.tracer(per_item=True)
    batches = []
    start = time.perf_counter()
    setup_s = start - ctx.started
    i = 0
    while time.perf_counter() - start < ctx.seconds or (
            tracer and tracer.holds(i)):
        L, B = cycle[i % len(cycle)]
        toks = T.tokens(ctx.seed, i, (B, L), vocab, ctx.device)
        if tracer:
            tracer.before(i)
        t0 = time.perf_counter()
        served = serve(toks)
        t1 = time.perf_counter()
        if tracer:
            tracer.after(i, {"B": B, "L": L})
        batches.append({"i": i, "L": L, "B": B, "ttft_s": t1 - t0,
                        "tokens": toks, "served": served})
        i += 1
    peak = ctx.memory_peak()
    del eng, params
    ttft_ms = [b["ttft_s"] * 1e3 for b in batches for _ in range(b["B"])]
    gaps = judge(ctx, w, prefill_sample(ctx, batches))
    return Outcome(
        e2e={"ttft_p95_ms": percentile(ttft_ms, 95)},
        attempted=len(ttft_ms), failed=0,
        compared=ctx.compared(gaps),
        setup_s=setup_s, memory_peak_bytes=peak,
        records={"batches": [{k: v for k, v in b.items()
                              if k in ("i", "L", "B", "ttft_s")}
                             for b in batches], **gaps},
        slice=tracer.slice if tracer else None)


def prefill_sample(ctx: Ctx, batches: list) -> list:
    """The requests to compare, drawn from the seed.  Where a row's
    result depends on the other rows of its batch (the family's
    ``couples_rows``, as the experts' capacity does): every row of
    ``compare_batches_moe`` batches of each length, so that every seed
    compares as many rows of each length.  Else
    ``compare_rows_dense`` rows of a batch of the longest length and of
    one of another.  Each as (tokens, positions, served tokens)."""
    rng = ctx.sample_rng()
    by_len = {}
    for b in batches:
        by_len.setdefault(b["L"], []).append(b)
    longest = max(by_len)
    if ctx.family.couples_rows(ctx.arch):
        n = ctx.traffic["compare_batches_moe"]
        return [(b["tokens"], [b["L"] - 1], b["served"][:, None])
                for L in sorted(by_len)
                for b in rng.sample(by_len[L], min(n, len(by_len[L])))]
    picks = [rng.choice(by_len[longest])]
    others = [b for b in batches if b["L"] != longest]
    if others:
        picks.append(rng.choice(others))
    out = []
    for b in picks:
        rows = sorted(rng.sample(range(b["B"]),
                                 min(ctx.traffic["compare_rows_dense"],
                                     b["B"])))
        out.append((b["tokens"][rows], [b["L"] - 1], b["served"][rows][:, None]))
    return out


def judge(ctx: Ctx, w: dict, items: list) -> dict:
    """The gaps by which the served tokens' reference logits lie below
    the reference's best, over ``items`` ((tokens (r, L), positions,
    served (r, n)) each): their widest and their mean (the numbers a
    cell can compare), the share that is not 0 and their count.  With
    ``ctx.control``, the same of the control's: the reference in fp8,
    the token it puts first at each of the same positions, judged by
    the float32 reference.  The reference is the configuration's
    family's."""
    ref = ctx.reference
    prog, ctrl = [], []
    with torch.no_grad():
        for toks, positions, served in items:
            lg = ref.logits_at(ctx.arch, w, toks, positions)
            lg = lg.reshape(-1, lg.shape[-1])
            prog.append(ref.gaps(lg, served.reshape(-1)).cpu())
            if ctx.control:
                low = ref.logits_at(ctx.arch, w, toks, positions,
                                    quant="fp8")
                first = low.reshape(-1, low.shape[-1]).argmax(-1)
                del low
                ctrl.append(ref.gaps(lg, first).cpu())
            del lg
    out = _look("", torch.cat(prog))
    if ctrl:
        out.update(_look("control_", torch.cat(ctrl)))
    return out


def _look(prefix: str, g: torch.Tensor) -> dict:
    return {f"{prefix}widest_gap": float(g.max()),
            f"{prefix}mean_gap": float(g.mean()),
            f"{prefix}mismatch_share": float((g > 0).float().mean()),
            f"{prefix}compared": int(g.numel())}


# -------------------------------------------------------------- decode --

def decode(ctx: Ctx) -> Outcome:
    """B sessions of one prompt length, prefilled in set-up into a cache
    of ``cache_len`` positions; the window calls ``Engine.decode`` step
    after step, greedily, and restarts at the prompt's end with the
    prefill's token once the cache is full.  Each gap between two
    tokens is read between CUDA events recorded after each step, with no
    synchronisation in the loop."""
    mix = ctx.traffic
    B, P, S = mix["batch"], mix["prompt_len"], mix["cache_len"]
    cfg, w, params = _weights(ctx)
    eng = system.engine(cfg, params, ctx.device, S, B)
    prompt = T.tokens(ctx.seed, 0, (B, P), ctx.arch["vocab_size"],
                      ctx.device)
    logits, caches = eng.prefill({"tokens": prompt})
    first = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    del logits
    caches = system.extend_caches(cfg, caches, S)
    eng.decode(caches, first, P)                 # warm the step's shapes
    ctx.sync()
    tracer = ctx.tracer(per_item=False)
    cuda = ctx.device.type == "cuda"

    def mark():
        if cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    marks, outs = [], []
    tok, pos = first, P
    start = time.perf_counter()
    setup_s = start - ctx.started
    marks.append(mark())
    i = 0
    while time.perf_counter() - start < ctx.seconds or (
            tracer and tracer.holds(i)):
        if tracer:
            tracer.before(i)
        logits, caches = eng.decode(caches, tok, pos)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        del logits
        marks.append(mark())
        if tracer:
            tracer.after(i, {"B": B, "pos": pos})
        outs.append((pos, tok))
        pos += 1
        if pos == S:                             # a new generation
            tok, pos = first, P
        i += 1
    ctx.sync()
    window_s = time.perf_counter() - start
    gaps_ms = [(marks[j].elapsed_time(marks[j + 1]) if cuda
                else (marks[j + 1] - marks[j]) * 1e3)
               for j in range(len(marks) - 1)]
    peak = ctx.memory_peak()
    del eng, params, caches
    steps = len(outs)
    gaps = judge(ctx, w, decode_sample(ctx, prompt, first, outs))
    return Outcome(
        e2e={"tpot_p95_ms": percentile(gaps_ms, 95),
             "output_tokens_per_s": B * steps / window_s},
        attempted=B * steps, failed=0,
        compared=ctx.compared(gaps),
        setup_s=setup_s, memory_peak_bytes=peak,
        records={"steps": steps, "window_s": window_s, "batch": B, **gaps},
        slice=tracer.slice if tracer else None)


def first_generation(prompt_len: int, outs: list) -> list:
    """The steps of the window's first generation, in order."""
    gen = []
    for pos, tok in outs:
        if pos == prompt_len and gen:
            break
        gen.append(tok)
    return gen


def decode_sample(ctx: Ctx, prompt, first, outs) -> list:
    """The sessions to compare, drawn from the seed:
    ``compare_sequences`` of them, each as its prompt, the prefill's
    token and the tokens its first generation was fed, against every
    token that generation served."""
    P = prompt.shape[1]
    gen = first_generation(P, outs)
    rows = sorted(ctx.sample_rng().sample(range(prompt.shape[0]),
                                          ctx.traffic["compare_sequences"]))
    served = torch.cat(gen, dim=1)[rows]          # (r, n)
    fed = torch.cat([first[rows], served[:, :-1]], dim=1)
    seqs = torch.cat([prompt[rows], fed.to(prompt.dtype)], dim=1)
    return [(seqs, range(P, P + served.shape[1]), served)]


# ---------------------------------------------------------------- swap --

def swap(ctx: Ctx) -> Outcome:
    """Closed loop, one request outstanding, tenants in turn: a cold
    start runs from ``ModelCache.request`` until the checkpoint's last
    trigger batch has landed on the card and the device is synchronised
    (the backend moves the bytes within the call).  After each, the
    landed bytes are held to the tenant's own."""
    mix = ctx.traffic
    cfg = system.arch_config(ctx.arch)
    names = [f"{ctx.config['name']}.tenant{t}" for t in range(mix["tenants"])]
    profiles = [system.checkpoint_profile(cfg, n) for n in names]
    nbytes = system.nbytes_of(profiles[0].total_mb)
    payloads = {f"ckpt:{n}": T.payload(ctx.seed, t, nbytes, ctx.device)
                for t, n in enumerate(names)}
    mc, be = system.swap_tier(mix, ctx.device, payloads)
    gpu = mix["gpu"]
    for p in profiles:
        mc.register(p, gpu, 0.0, prestage=True)
    sim = mc.sim
    tracer = ctx.tracer(per_item=True)
    records, differ, failed = [], 0, 0
    warm = mix["warmup_requests"]

    def request(n: int):
        name = names[T.swap_tenant(mix, n)]
        sim.run()
        loads, reports = mc.stats["loads"], len(be.reports)
        t0 = time.perf_counter()
        mc.request(name, (n + 1) * mix["sim_gap_ms"])
        ctx.sync()
        cold_s = time.perf_counter() - t0
        rep = be.reports[-1] if len(be.reports) == reports + 1 else None
        ok = (mc.stats["loads"] == loads + 1 and rep is not None
              and rep.func == name and rep.dst == gpu)
        return name, cold_s, rep, ok

    def landed_differ(name: str) -> int:
        return system.landed_bytes_differ(be, f"ckpt:{name}", gpu,
                                          payloads[f"ckpt:{name}"])

    for n in range(warm):
        request(n)
    ctx.sync()
    start = time.perf_counter()
    setup_s = start - ctx.started
    i = 0
    while time.perf_counter() - start < ctx.seconds or (
            tracer and tracer.holds(i)):
        if tracer:
            tracer.before(i)
        name, cold_s, rep, ok = request(warm + i)
        if tracer:
            tracer.after(i, {"bytes": nbytes})
        differ += landed_differ(name)
        if not ok:
            failed += 1
        else:
            records.append({"i": i, "tenant": name, "cold_s": cold_s,
                            "wall_s": rep.wall_ms / 1e3, "bytes": nbytes,
                            "traced": bool(tracer and tracer.active(i))})
        i += 1
    sim.run()
    peak = ctx.memory_peak()
    cold_ms = [r["cold_s"] * 1e3 for r in records]
    return Outcome(
        e2e={"cold_start_p90_ms": percentile(cold_ms, 90) if cold_ms
             else float("nan")},
        attempted=i, failed=failed,
        compared=ctx.compared({"bytes_differ": differ}),
        setup_s=setup_s, memory_peak_bytes=peak,
        records={"reloads": records},
        slice=tracer.slice if tracer else None)


DRIVERS = {"prefill": prefill, "decode": decode, "swap": swap}
