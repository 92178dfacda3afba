"""Serverless inference workflow on PyTorch, end to end: REAL model
compute (reduced LMs through the port's ``Engine``, on an NVIDIA GPU or,
with ``--device cpu``, on the CPU) + the FaaSTube data plane
(tube-timed inter-function passing).

A two-model "yelp" workflow (paper Table 1): a detector LM scores each
comment batch, then a generator LM produces replies — the detector's
hidden intermediates pass gFunc-to-gFunc through the tube.  We run the
same workflow over INFless+ (host-oriented) and FaaSTube and report the
data-passing budget each system would spend on a DGX-V100.  Both engines
serve on a 1x1 mesh (``launch/mesh.py``'s smoke mesh), as the JAX
example does.  The last line printed is a JSON summary.

Run:  PYTHONPATH=src python examples/serve_workflow_torch.py [--device cpu]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch                                                  # noqa: E402
import torch.distributed as dist                              # noqa: E402

from repro_torch.configs import get_arch                      # noqa: E402
from repro_torch.configs.base import ShapeSpec                # noqa: E402
from repro_torch.core.api import FAASTUBE, INFLESS, FaaSTube  # noqa: E402
from repro_torch.core.topology import dgx_v100                # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh           # noqa: E402
from repro_torch.models import model as M                     # noqa: E402
from repro_torch.serving.engine import Engine                 # noqa: E402


def build_engine(arch: str, mesh, device: str, params=None):
    """The reduced ``arch`` served on ``mesh``: weights of seed 0, or
    ``params`` (the same tree, e.g. carried over by
    ``param.from_numpy``)."""
    cfg = get_arch(arch).reduced()
    if params is None:
        params = M.init_params(cfg, 0, device)
    return Engine(cfg, ShapeSpec("s", 64, 4, "decode"), params,
                  device=device, mesh=mesh), cfg


def run(device: str = "cuda", params: dict | None = None) -> dict:
    """The workflow; ``params`` maps an arch to its weights.  Returns
    what ``main`` prints."""
    params = params or {}
    own_group = not dist.is_initialized()
    mesh = make_smoke_mesh(device)
    try:
        detector, _ = build_engine("minicpm-2b", mesh, device,
                                   params.get("minicpm-2b"))
        generator, _ = build_engine("qwen2-72b", mesh, device,
                                    params.get("qwen2-72b"))
        batch = {"tokens": torch.arange(4 * 12, dtype=torch.int32)
                 .reshape(4, 12) % 64}

        # --- stage 1: detector (gFunc on gpu0) ---------------------------
        t0 = time.perf_counter()
        verdict_toks, _ = detector.generate(batch, max_new_tokens=4)
        verdict_toks = verdict_toks.cpu()
        t_det = (time.perf_counter() - t0) * 1e3

        # --- inter-function pass: detector output -> generator (gpu4) ----
        # 4 comments x 12 tokens of hidden state ~ 24 MB intermediate
        passing = {}
        for cfg_tube in (INFLESS, FAASTUBE):
            tube = FaaSTube(dgx_v100(), cfg_tube)
            tube.store("detector", "hidden", 24.0, "gpu0", 0.0)
            tube.fetch("generator", "hidden", "gpu4", 0.0,
                       on_ready=lambda s, t, n=cfg_tube.name:
                       passing.setdefault(n, t))
            tube.sim.run()

        # --- stage 2: generator consumes and replies ---------------------
        gen_in = {"tokens": torch.cat([batch["tokens"], verdict_toks % 64],
                                      dim=1)}
        t0 = time.perf_counter()
        replies, _ = generator.generate(gen_in, max_new_tokens=8)
        replies = replies.cpu()
        t_gen = (time.perf_counter() - t0) * 1e3
    finally:
        if own_group:
            dist.destroy_process_group()
    return {"detector_ms": t_det, "generator_ms": t_gen, "passing": passing,
            "speedup": passing["infless+"] / passing["faastube"],
            "replies": replies.tolist()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    res = run(args.device)
    print(f"detector compute : {res['detector_ms']:8.1f} ms (real, "
          f"{args.device})")
    print(f"generator compute: {res['generator_ms']:8.1f} ms (real, "
          f"{args.device})")
    for name, t in res["passing"].items():
        print(f"g2g pass ({name:9s}): {t:8.2f} ms (tube-timed, DGX-V100)")
    print(f"\nFaaSTube moves the intermediate {res['speedup']:.1f}x faster "
          f"(NVLink direct vs 2x PCIe through host)")
    print(f"reply token ids: {res['replies'][0]}")
    assert res["speedup"] > 2.0
    from repro_torch.kernels.flash_attention import kernel as FK
    print(json.dumps({"serve_workflow": dict(
        res, launches={"flash_attention": FK.flash_attention.launches})}))


if __name__ == "__main__":
    main()
