"""End-to-end training on PyTorch: a ~100M-param minicpm-family model on
a learnable synthetic language (sparse Markov chain), with WSD schedule,
grad accumulation, async checkpointing and mid-run restart, through the
port's ``run_training`` on a 1x1 mesh (``launch/mesh.py``'s smoke mesh,
as the JAX example trains on one), on an NVIDIA GPU or, with
``--device cpu``, on the CPU.

Loss starts near ln(vocab)=9.0 and converges toward ln(branch)=2.08 as the
model learns the transition table — proving the whole substrate (pipeline
-> sharded train step -> optimizer -> checkpoint/restore) end to end.
The last line printed is a JSON summary.

Run:  PYTHONPATH=src python examples/train_small_torch.py [--steps 300] [--tiny] [--device cpu]
"""
import argparse
import dataclasses
import json
import math
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch.distributed as dist                              # noqa: E402

from repro_torch.configs import get_arch                      # noqa: E402
from repro_torch.configs.base import ShapeSpec                # noqa: E402
from repro_torch.data.pipeline import MarkovPipeline          # noqa: E402
from repro_torch.distributed.fault import FaultPolicy         # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh           # noqa: E402
from repro_torch.training.optimizer import OptConfig          # noqa: E402
from repro_torch.training.train_loop import run_training      # noqa: E402


def model_100m(tiny: bool = False):
    """minicpm family scaled to ~100M params (~20M with --tiny)."""
    kw = (dict(n_layers=6, d_model=384, n_heads=6, n_kv_heads=6,
               head_dim=64, d_ff=1536, vocab_size=512)
          if tiny else
          dict(n_layers=10, d_model=768, n_heads=12, n_kv_heads=12,
               head_dim=64, d_ff=3072, vocab_size=8192))
    cfg = dataclasses.replace(
        get_arch("minicpm-2b"), cache_dtype="f32", **kw,
    )
    from repro_torch.models import model as M
    from repro_torch.models.param import count_params
    n = count_params(M.model_specs(cfg))
    print(f"model: {n / 1e6:.1f}M params (WSD schedule, "
          f"{cfg.n_layers}L x {cfg.d_model}d, vocab {cfg.vocab_size})")
    return cfg


def run(steps: int, batch: int, seq: int, tiny: bool, device: str) -> dict:
    """Train the first half with checkpoints, restart from the latest and
    finish; returns the losses and the final step."""
    cfg = model_100m(tiny)
    shape = ShapeSpec("train_small", seq, batch, "train")
    oc = OptConfig(lr=1e-3, warmup_steps=10, total_steps=steps,
                   schedule="wsd", stable_frac=0.6)
    own_group = not dist.is_initialized()
    mesh = make_smoke_mesh(device)
    try:
        with tempfile.TemporaryDirectory() as ckpt_dir:
            # phase 1: train the first half, checkpointing twice
            half = steps // 2
            every = max(half // 2, 1)
            state, losses1, _ = run_training(
                cfg, shape, mesh, steps=half, oc=oc, accum=2,
                ckpt_dir=ckpt_dir, policy=FaultPolicy(checkpoint_every=every),
                log_every=20, pipeline_cls=MarkovPipeline, device=device)
            print(f"phase 1 done at step {state.step}; restarting from the "
                  f"latest checkpoint to prove resumability...")
            # phase 2: resume from checkpoint and finish
            state, losses2, _ = run_training(
                cfg, shape, mesh, steps=steps, oc=oc, accum=2,
                ckpt_dir=ckpt_dir, resume=True,
                policy=FaultPolicy(checkpoint_every=every), log_every=20,
                pipeline_cls=MarkovPipeline, device=device)
    finally:
        if own_group:
            dist.destroy_process_group()
    return {"vocab": cfg.vocab_size, "first_half": half,
            "resumed_from": steps - len(losses2), "step": state.step,
            "losses": losses1 + losses2}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--tiny", action="store_true",
                    help="~20M params for a short run")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    res = run(args.steps, args.batch, args.seq, args.tiny, args.device)
    assert res["step"] == args.steps
    losses = res["losses"]
    first, last = losses[0], sum(losses[-10:]) / len(losses[-10:])
    print(f"\nloss: {first:.3f} -> {last:.3f} "
          f"(floor ln(branch)={math.log(8):.3f}, "
          f"start ~ln(vocab)={math.log(res['vocab']):.3f})")
    assert last < first - 1.0, "loss must drop by >1 nat"
    print("OK: end-to-end training converges and resumes from checkpoints")
    from repro_torch.kernels.flash_attention import kernel as FK
    print(json.dumps({"train_small": {
        "first_loss": first, "last_loss": last, "step": res["step"],
        "resumed_from": res["resumed_from"],
        "launches": {"flash_attention": FK.flash_attention.launches,
                     "flash_attention_bwd": FK.flash_attention_bwd.launches}}}))


if __name__ == "__main__":
    main()
