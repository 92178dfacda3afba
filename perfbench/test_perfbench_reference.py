"""The plain reference (``reference/<reference>.py``, the configuration's
family's) agrees with the port on each configuration cut to a small
size, on the CPU in float32: prefill's
last-position logits, and every decode step's logits against the
reference's forward over the prompt and the tokens fed (the port keeps
its K/V cache in bf16, the configuration's cache type, so decode agrees
to that rounding)."""
import pytest
import torch

import _testkit as K
import harness
import system
import traffic as T
import weights as W

CONFIGS = sorted({c["config"] for c in K.cells()})
#: the configurations a decode cell serves: the experts' capacity makes a
#: capacity-bounded MoE's result depend on which tokens route together,
#: so its decode steps are no teacher-forced forward
DECODED = sorted({c["config"] for c in K.cells() if c["traffic"] == "decode"})
CPU = torch.device("cpu")


def _setup(name, seed=K.SEEDS[0]):
    """arch, weights, the port's configuration and tree, and the
    family's reference."""
    cfg = K.small_config(name)
    arch = cfg["arch"]
    fam = harness.family(cfg["reference"])
    w = W.make(fam.leaves(arch), arch, cfg.get("init", {}), seed, CPU,
               torch.float32)
    pc = system.arch_config(arch)
    return (arch, w, pc, system.program_params(pc, w, fam, arch),
            harness.reference(cfg["reference"]))


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_logits_match_the_port(name):
    arch, w, pc, params, ref = _setup(name)
    toks = T.tokens(K.SEEDS[0], 0, (3, 24), arch["vocab_size"], CPU)
    eng = system.engine(pc, params, CPU, 24, 3)
    got, _ = eng.prefill({"tokens": toks})
    want = ref.logits_at(arch, w, toks, [23])[:, 0]
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
    assert float(ref.gaps(want, got.argmax(-1)).max()) == 0.0


@pytest.mark.parametrize("name", DECODED)
def test_decode_logits_match_the_reference_forward(name):
    arch, w, pc, params, ref = _setup(name)
    B, P, S, n = 2, 8, 20, 6
    prompt = T.tokens(K.SEEDS[1], 0, (B, P), arch["vocab_size"], CPU)
    eng = system.engine(pc, params, CPU, S, B)
    logits, caches = eng.prefill({"tokens": prompt})
    caches = system.extend_caches(pc, caches, S)
    tok = logits.argmax(-1)[:, None]
    fed, got = [tok], []
    for pos in range(P, P + n):
        lg, caches = eng.decode(caches, tok, pos)
        got.append(lg)
        tok = lg.argmax(-1)[:, None]
        fed.append(tok)
    seq = torch.cat([prompt] + fed[:-1], dim=1)
    want = ref.logits_at(arch, w, seq, range(P, P + n))
    got = torch.stack(got, 1)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 2 ** -6 * float(want.abs().max())
    served = got.argmax(-1).reshape(-1)
    assert float(ref.gaps(want.reshape(-1, want.shape[-1]), served).max()) \
        < 2 ** -6 * float(want.abs().max())


def test_moe_capacity_drops_the_overflow_in_token_order():
    """With a capacity below the load, the reference keeps each expert's
    first assignments in token order and drops the rest, as the port."""
    name = next(n for n in CONFIGS
                if K.small_config(n)["arch"].get("n_experts"))
    arch, w, pc, params, ref = _setup(name)
    arch = dict(arch, capacity_factor=0.5)
    pc = system.arch_config(arch)
    fam = harness.family(K.small_config(name)["reference"])
    toks = T.tokens(K.SEEDS[0], 1, (2, 16), arch["vocab_size"], CPU)
    got, _ =system.engine(pc, system.program_params(pc, w, fam, arch), CPU,
                           16, 2).prefill({"tokens": toks})
    want = ref.logits_at(arch, w, toks, [15])[:, 0]
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
    full = ref.logits_at(dict(arch, capacity_factor=8.0), w, toks, [15])
    assert not torch.allclose(full[:, 0], want)


@pytest.mark.parametrize("name", CONFIGS)
def test_fp8_control_rounds_every_product(name):
    arch, w, _, _, ref = _setup(name)
    toks = T.tokens(K.SEEDS[0], 2, (2, 12), arch["vocab_size"], CPU)
    exact = ref.logits_at(arch, w, toks, [11])
    low = ref.logits_at(arch, w, toks, [11], quant="fp8")
    rel = float((low - exact).norm() / exact.norm())
    assert 1e-3 < rel < 0.5
