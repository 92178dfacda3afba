"""Training launcher, PyTorch port:
    python -m repro_torch.launch.train --arch <id> [options]

Trains through ``training.train_loop.run_training`` on a device mesh:
the synthetic data pipeline, the train step (``loss_fn``'s gradient,
data-parallel over the mesh, AdamW with the architecture's schedule and
ZeRO-1 moments), async checkpoints and fault recovery.  ``--smoke``
takes the reduced config (same family, tiny dims) on
``make_smoke_mesh``: 1x1 in one process, or the ``--mesh`` shape under
``torchrun``.  Without ``--smoke`` it runs on the production mesh
(``--multi-pod`` for 2x16x16) under ``torchrun`` with 256 or 512
processes.  The model runs on ``cuda`` (NCCL) unless ``--device cpu``
asks for the CPU (gloo, the kernels' plain versions); without a card it
raises.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --smoke --device cpu
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train --arch minicpm-2b \\
      --smoke --device cpu --mesh 2x2
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-72b \\
      --smoke --steps 20 --inject-failure 8 --ckpt-dir /tmp/ckpt \\
      --checkpoint-every 5
"""
from __future__ import annotations

import argparse


def main(argv=None):
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.fault import FaultPolicy, NodeFailure
    from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
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
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default="1x1",
                    help="--smoke's data x model mesh (under torchrun)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    device = resolve_device(args.device)
    if args.smoke:
        cfg = cfg.reduced()
        mesh = make_smoke_mesh(
            device.type, tuple(int(n) for n in args.mesh.split("x")))
    else:
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device_type=device.type)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
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
        cfg, shape, mesh, steps=args.steps, oc=oc, accum=args.accum,
        ckpt_dir=args.ckpt_dir, resume=args.resume,
        policy=FaultPolicy(checkpoint_every=args.checkpoint_every),
        failure_injector=injector, device=device)
    print(f"done: step={state.step} loss={losses[0]:.3f}->{losses[-1]:.3f} "
          f"restarts={stats.restarts} failed_hosts={stats.failed_hosts} "
          f"on {device}, rank {dist.get_rank()} of {dist.get_world_size()} "
          f"({dist.get_backend()}, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))})")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
