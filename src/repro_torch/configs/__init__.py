"""Architecture registry: ``--arch <id>`` resolves here."""
from repro_torch.configs.base import (
    ArchConfig,
    ShapeSpec,
    SHAPES,
    LONG_CONTEXT_ARCHS,
    applicable_shapes,
)

from repro_torch.configs.minicpm_2b import CONFIG as _minicpm
from repro_torch.configs.qwen2_72b import CONFIG as _qwen2
from repro_torch.configs.nemotron_4_15b import CONFIG as _nemotron
from repro_torch.configs.gemma3_27b import CONFIG as _gemma3
from repro_torch.configs.jamba_1_5_large import CONFIG as _jamba
from repro_torch.configs.dbrx_132b import CONFIG as _dbrx
from repro_torch.configs.grok_1_314b import CONFIG as _grok
from repro_torch.configs.whisper_medium import CONFIG as _whisper
from repro_torch.configs.xlstm_1_3b import CONFIG as _xlstm
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2vl

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in [
        _minicpm, _qwen2, _nemotron, _gemma3, _jamba,
        _dbrx, _grok, _whisper, _xlstm, _qwen2vl,
    ]
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeSpec:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells() -> list[tuple[str, str]]:
    """All applicable (arch, shape) dry-run cells."""
    cells = []
    for arch in ARCHS:
        for shape in applicable_shapes(arch):
            cells.append((arch, shape))
    return cells
