"""Training launcher, PyTorch port:
    python -m repro_torch.launch.train --arch <id> [options]

Trains on one device through ``training.train_loop.run_training``: the
synthetic data pipeline, the train step (``loss_fn``'s gradient, AdamW
with the architecture's schedule), async checkpoints and fault
recovery.  ``--smoke`` takes the reduced config (same family, tiny
dims).  The model runs on ``cuda`` unless ``--device cpu`` asks for the
CPU (the kernels' plain versions); without a card it raises.  The JAX
launcher's mesh flags have no counterpart on one card.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-72b \\
      --smoke --steps 20 --inject-failure 8 --ckpt-dir /tmp/ckpt \\
      --checkpoint-every 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --seq 4096 --batch 4 --accum 2 --steps 3
"""
from __future__ import annotations

import argparse


def main(argv=None):
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.fault import FaultPolicy, NodeFailure
    from repro_torch.serving.engine import resolve_device
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import run_training

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config on the local device")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--inject-failure", type=int, default=-1,
                    help="simulate a host failure at this step (recovery demo)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")

    injector = None
    if args.inject_failure >= 0:
        fired = {}

        def injector(i):
            if i == args.inject_failure and not fired:
                fired["x"] = True
                # the reference passes host=1, which NodeFailure does not
                # take (ROADMAP.md §3)
                return NodeFailure(1)
            return None

    oc = OptConfig(schedule=cfg.lr_schedule, total_steps=args.steps,
                   warmup_steps=max(args.steps // 10, 1))
    state, losses, stats = run_training(
        cfg, shape, steps=args.steps, oc=oc, accum=args.accum,
        ckpt_dir=args.ckpt_dir, resume=args.resume,
        policy=FaultPolicy(checkpoint_every=args.checkpoint_every),
        failure_injector=injector, device=device)
    print(f"done: step={state.step} loss={losses[0]:.3f}->{losses[-1]:.3f} "
          f"restarts={stats.restarts} failed_hosts={stats.failed_hosts} "
          f"on {device}")


if __name__ == "__main__":
    main()
