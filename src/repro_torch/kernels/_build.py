"""Build and load the port's hand-written CUDA kernels.

Each source under ``src/repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, at
first use, under ``build/kernels/`` in the checkout (gitignored).  The
library's name carries a hash of the source, the ``csrc/*.cuh`` headers
it includes and the flags, so an edit to any of them builds anew and a
fresh checkout builds everything it needs.
The compiler's register and shared-memory report (``-Xptxas -v``) is
kept beside each library as ``<library>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]          # src/repro_torch
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _headers(text: str) -> list[Path]:
    """The ``csrc/`` headers a source includes (``#include "x.cuh"``)."""
    return [CSRC / name for name in
            re.findall(r'^\s*#\s*include\s+"([^"]+\.cuh)"', text, re.M)]


def library_path(source: str) -> Path:
    """Where the library of ``csrc/<source>`` lives for this source, the
    ``csrc/*.cuh`` headers it includes and these flags."""
    src = CSRC / source
    text = src.read_bytes()
    parts = [text] + [h.read_bytes() for h in _headers(text.decode())]
    key = hashlib.sha256(b"".join(parts)
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{key}.so"


def build(source: str) -> tuple[Path, float]:
    """Compile ``csrc/<source>`` unless its library exists.  Returns
    (library path, seconds spent compiling: 0.0 when cached)."""
    lib = library_path(source)
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                              str(CSRC / source)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} ({res.returncode}):"
                               f"\n{res.stdout}\n{res.stderr}")
        lib.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, time.perf_counter() - t0


def build_all(sources) -> dict[str, float]:
    """Compile several sources at once, one ``nvcc`` each, all started
    together.  Returns {source: seconds spent compiling it}."""
    from concurrent.futures import ThreadPoolExecutor
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(len(sources), 1)) as pool:
        futs = {s: pool.submit(build, s) for s in sources}
        return {s: f.result()[1] for s, f in futs.items()}


@functools.cache
def load(source: str, signatures: tuple) -> ctypes.CDLL:
    """The library of ``csrc/<source>``, built if needed, with each entry
    point's ``argtypes`` set and ``restype`` int (a ``cudaError_t``).
    ``signatures``: ((name, (ctypes type, ...)), ...)."""
    lib = ctypes.CDLL(str(build(source)[0]))
    for name, argtypes in signatures:
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
