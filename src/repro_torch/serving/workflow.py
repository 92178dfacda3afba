"""The paper's six inference workflows (Table 1) as DAG specs + placement.

Stage compute times and edge sizes are calibrated to V100-class numbers
(documented assumptions — the paper gives app structure and aggregate
behaviour, not per-stage constants; we tuned these so the INFless+ baseline
reproduces the paper's Fig. 3 data-passing fraction of ~85-92% on the
media-heavy workflows).  Types: condition / sequence / fan-in / fan-out.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Stage:
    name: str
    kind: str                    # cpu | gpu
    compute_ms: float
    deps: tuple = ()             # ((src_stage, size_mb), ...)
    # overlap contract opt-in (TubeConfig.overlap): the stage kernel can
    # run TensorRT-style on landed trigger batches of its inputs, so the
    # executor may start it against a partial prefix (consume(partial=
    # True)) and pipeline compute with the residual transfer.  False
    # pins the stage to the all-deps-complete gate even under overlap
    # (e.g. a global-reduction kernel that needs every byte up front).
    partial: bool = True


@dataclass(frozen=True)
class Workflow:
    name: str
    wtype: str                   # condition | sequence | fan-in | fan-out
    stages: tuple                # topologically ordered
    input_mb: dict = field(default_factory=dict)    # stage -> host input MB
    output_mb: dict = field(default_factory=dict)   # stage -> MB returned to host


TRAFFIC = Workflow(
    "traffic", "condition",
    stages=(
        Stage("decode", "cpu", 8.0),
        Stage("preproc", "gpu", 4.0, ()),
        Stage("yolo_det", "gpu", 18.0, (("preproc", 96.0),)),
        Stage("resnet_ped", "gpu", 9.0, (("yolo_det", 64.0),)),
        Stage("resnet_veh", "gpu", 9.0, (("yolo_det", 64.0),)),
        Stage("postproc", "cpu", 2.0, (("resnet_ped", 2.0), ("resnet_veh", 2.0))),
    ),
    input_mb={"preproc": 96.0},
    output_mb={},
)

DRIVING = Workflow(
    "driving", "sequence",
    stages=(
        Stage("decode", "cpu", 6.0),
        Stage("denoise", "gpu", 12.0, ()),
        Stage("yolo_seg", "gpu", 22.0, (("denoise", 128.0),)),
        Stage("blur", "gpu", 8.0, (("yolo_seg", 128.0),)),
    ),
    input_mb={"denoise": 128.0},
    output_mb={"blur": 128.0},          # colored image back to host
)

VIDEO = Workflow(
    "video", "fan-in",
    stages=(
        Stage("decode", "cpu", 6.0),
        Stage("face_det0", "gpu", 14.0, ()),
        Stage("face_det1", "gpu", 14.0, ()),
        Stage("face_det2", "gpu", 14.0, ()),
        Stage("recognize", "gpu", 10.0,
              (("face_det0", 48.0), ("face_det1", 48.0), ("face_det2", 48.0))),
    ),
    input_mb={"face_det0": 85.0, "face_det1": 85.0, "face_det2": 85.0},
    output_mb={},
)

IMAGE = Workflow(
    "image", "fan-out",
    stages=(
        Stage("decode", "cpu", 4.0),
        Stage("denoise", "gpu", 10.0, ()),
        Stage("resnet", "gpu", 8.0, (("denoise", 64.0),)),
        Stage("alexnet", "gpu", 6.0, (("denoise", 64.0),)),
        Stage("aggregate", "cpu", 1.0, (("resnet", 1.0), ("alexnet", 1.0))),
    ),
    input_mb={"denoise": 64.0},
    output_mb={},
)

SOCIAL = Workflow(
    "social", "condition",
    stages=(
        Stage("decode", "cpu", 3.0),
        Stage("ocr", "gpu", 12.0, ()),
        Stage("bert", "gpu", 8.0, (("ocr", 8.0),)),
    ),
    input_mb={"ocr": 24.0},
    output_mb={},
)

YELP = Workflow(
    "yelp", "sequence",
    stages=(
        Stage("bert_detect", "gpu", 7.0, ()),
        Stage("bert_gen", "gpu", 9.0, (("bert_detect", 4.0),)),
    ),
    input_mb={"bert_detect": 4.0},
    output_mb={},
)

WORKFLOWS = {w.name: w for w in
             (TRAFFIC, DRIVING, VIDEO, IMAGE, SOCIAL, YELP)}


def isolated_compute_ms(w: Workflow) -> float:
    return sum(s.compute_ms for s in w.stages)


def place(w: Workflow, topo, *, occupied: dict | None = None) -> dict:
    """MAPA-style greedy placement: maximize NVLink bandwidth between
    adjacent gpu stages; avoid GPUs already claimed by other workflows."""
    occupied = dict(occupied or {})
    gpu_stages = [s for s in w.stages if s.kind == "gpu"]
    placement: dict[str, str] = {}
    free = [g for g in topo.gpus if g not in occupied.values()] or list(topo.gpus)
    for s in gpu_stages:
        neighbors = [placement[d] for d, _ in s.deps if d in placement]
        best, best_score = None, -1.0
        for g in free:
            if g in placement.values():
                continue
            score = sum(topo.bw(g, nb) for nb in neighbors)
            if score > best_score:
                best, best_score = g, score
        if best is None:                 # more stages than GPUs: reuse
            best = free[len(placement) % len(free)]
        placement[s.name] = best
    return placement
