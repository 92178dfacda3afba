"""Serving launcher, PyTorch port:
    python -m repro_torch.launch.serve --arch <id> [options]

Runs batched greedy generation through ``Engine.generate`` on the card
at the architecture's full width (``--smoke`` takes ``.reduced()``),
and/or replays a serverless workflow trace over the port's FaaSTube
data plane to report the tube-timed data-passing budget per request.
As the JAX launcher does, the model is served on the smoke mesh
(``launch/mesh.make_smoke_mesh``): 1x1, NCCL on ``cuda``, gloo on the
CPU, under the shape's serving rules; each rank holds its slices of the
weights.  ``--mesh DxM`` serves on a (data, model) mesh of that shape,
one rank a process, under ``torchrun``.  The model runs on ``cuda``
unless ``--device cpu`` asks for the CPU (the kernels' plain versions);
without a card it raises.  ``--w8a16`` rounds the weights through
``serving/wquant.py``'s int8 quantization first, as the JAX launcher
does.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm-2b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm-2b \
      --smoke --device cpu --batch 4 --prompt-len 16 --max-new 8
  OMP_NUM_THREADS=1 PYTHONPATH=src python -m torch.distributed.run \
      --standalone --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch dbrx-132b --smoke --device cpu --batch 4 --mesh 2x2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm-2b --w8a16
  PYTHONPATH=src python -m repro_torch.launch.serve --workflow traffic \
      --system faastube --requests 16
"""
from __future__ import annotations

import argparse

import torch


def serve_model(args):
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    from repro_torch.serving.engine import Engine, resolve_device

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    shape = ShapeSpec("serve", args.prompt_len + args.max_new,
                      args.batch, "decode")
    mesh = make_smoke_mesh(device.type, tuple(
        int(n) for n in args.mesh.split("x")))
    try:
        local = PM.shard_local(M.model_specs(cfg),
                               M.build_ctx(cfg, shape, mesh).rules, mesh)
        if args.w8a16:
            # the scales are the whole weights' (a column's max over every
            # row), so quantize whole and cut after
            from repro_torch.serving.wquant import dequant_tree, quantize_tree
            whole = dequant_tree(quantize_tree(M.init_params(cfg, 0, device),
                                               min_size=1024))
            params = PM.tree_unflatten(whole, [
                t[ix.index] for t, ix in zip(PM.tree_leaves(whole),
                                             PM.tree_leaves(local))])
        else:
            params = M.init_params(cfg, 0, device, local=local)
        eng = Engine(cfg, shape, params, device=device, mesh=mesh)
        toks = torch.arange(args.batch * args.prompt_len,
                            dtype=torch.int32).reshape(args.batch, -1) % 64
        with torch.no_grad():
            out, _ = eng.generate({"tokens": toks},
                                  max_new_tokens=args.max_new)
        if dist.get_rank() == 0:
            print(f"{cfg.name}: generated {tuple(out.shape)} tokens "
                  f"(batch {args.batch} x {args.max_new} new) on "
                  f"{eng.device}, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
                  f" ({dist.get_backend()})")
            for row in out.tolist():
                print("  ", row)
    finally:
        dist.destroy_process_group()


def serve_workflow(args):
    from repro_torch.core.api import SYSTEMS
    from repro_torch.core.topology import dgx_v100
    from repro_torch.serving.executor import run_closed_loop
    from repro_torch.serving.workflow import WORKFLOWS

    w = WORKFLOWS[args.workflow]
    eng = run_closed_loop(dgx_v100, SYSTEMS[args.system], w,
                          n_requests=args.requests, interarrival_ms=20.0)
    lats = sorted(r.t_done - r.t_arrive for r in eng.completed)
    p50 = lats[len(lats) // 2]
    print(f"{args.workflow} on {args.system}: {len(lats)} requests, "
          f"p50={p50:.1f} ms p99={lats[-1]:.1f} ms")
    r = eng.completed[0]
    print(f"  first request: h2g={r.h2g_ms:.2f} ms g2g={r.g2g_ms:.2f} ms "
          f"compute={r.compute_ms:.1f} ms")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--w8a16", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="1x1",
                    help="DxM: the (data, model) mesh; more than one rank "
                    "needs torchrun")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--workflow", default=None)
    ap.add_argument("--system", default="faastube")
    ap.add_argument("--requests", type=int, default=8)
    args = ap.parse_args(argv)
    if args.arch:
        serve_model(args)
    if args.workflow:
        serve_workflow(args)
    if not args.arch and not args.workflow:
        raise SystemExit("pass --arch and/or --workflow")


if __name__ == "__main__":
    main()
