"""The port's attention against the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX package's Pallas
kernels (in interpret mode), its jnp oracles and ``blockwise_attention``,
and through the port's ``ops.attention`` wrappers, which on a CPU tensor
take the plain PyTorch versions that the CUDA kernels are held against
on the card.  Tolerances are those of ``tests/test_kernels.py``: flash
2e-5 (f32) / 2e-2 (bf16), paged 5e-5 / 3e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention_ref, flash_attention  # noqa: E402
from repro.kernels.paged_attention import (  # noqa: E402
    paged_attention,
    paged_attention_ref,
)
from repro.models.attention import blockwise_attention  # noqa: E402
from repro.models.attention import decode_attention as jax_decode  # noqa: E402

from repro_torch.kernels.flash_attention import ops as tflash  # noqa: E402
from repro_torch.kernels.paged_attention import ops as tpaged  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.param import from_numpy  # noqa: E402

FLASH_TOL = {"f32": 2e-5, "bf16": 2e-2}
PAGED_TOL = {"f32": 5e-5, "bf16": 3e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _inputs(seed, dt, *shapes):
    """numpy normals -> (jax arrays in ``dt``, the same values in torch)."""
    rng = np.random.default_rng(seed)
    js = [jnp.asarray(rng.standard_normal(s, dtype=np.float32)).astype(JDT[dt])
          for s in shapes]
    return js, [from_numpy(np.asarray(a), "cpu") for a in js]


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol)


# The shape sweep of tests/test_kernels.py (b, hkv, group, lq, lk_extra, d,
# causal, window), one case per row, both dtypes.
FLASH_CASES = [
    (1, 1, 1, 128, 0, 64, True, 0),
    (2, 2, 2, 128, 128, 64, True, 64),
    (1, 4, 1, 256, 0, 128, False, 0),
    (2, 1, 4, 128, 0, 128, True, 0),
    (1, 2, 4, 256, 128, 64, False, 64),
    (2, 4, 2, 128, 0, 64, True, 64),
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_plain_matches_pallas_and_refs(case, dt):
    b, hkv, group, lq, lk_extra, d, causal, window = case
    lk = lq + lk_extra
    (q, k, v), (tq, tk, tv) = _inputs(hash(case) % 2 ** 31, dt,
                                      (b, hkv * group, lq, d),
                                      (b, hkv, lk, d), (b, hkv, lk, d))
    port = tflash.attention(tq, tk, tv, causal=causal, window=window)
    assert port.dtype == tq.dtype and port.shape == tq.shape
    tol = FLASH_TOL[dt]
    _close(port, flash_attention(q, k, v, causal=causal, window=window,
                                 interpret=True), tol)
    _close(port, attention_ref(q, k, v, causal=causal, window=window), tol)
    _close(port, blockwise_attention(q, k, v, causal=causal, window=window),
           tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("lq,lk,window", [(200, 200, 0), (200, 200, 37),
                                          (77, 300, 0), (1, 65, 16)])
def test_flash_plain_ragged(lq, lk, window, dt):
    """Any Lq, Lkv: held against the jnp oracle and the model's blockwise
    form (the Pallas kernel asserts multiples of its block)."""
    (q, k, v), (tq, tk, tv) = _inputs(lq * lk + window, dt, (2, 4, lq, 16),
                                      (2, 2, lk, 16), (2, 2, lk, 16))
    tol = FLASH_TOL[dt]
    port = tflash.attention(tq, tk, tv, causal=True, window=window)
    _close(port, attention_ref(q, k, v, causal=True, window=window), tol)
    _close(tattn.blockwise_attention(tq, tk, tv, causal=True, window=window),
           blockwise_attention(q, k, v, causal=True, window=window), tol)


@pytest.mark.parametrize("q_offset,kv_offset", [(16, 0), (5, 3)])
def test_blockwise_offsets_match_reference(q_offset, kv_offset):
    (q, k, v), (tq, tk, tv) = _inputs(q_offset, "f32", (1, 4, 24, 16),
                                      (1, 2, 40, 16), (1, 2, 40, 16))
    for window in (0, 9):
        _close(tattn.blockwise_attention(tq, tk, tv, window=window,
                                         q_offset=q_offset,
                                         kv_offset=kv_offset),
               blockwise_attention(q, k, v, window=window, q_offset=q_offset,
                                   kv_offset=kv_offset), 2e-5)


# (b, hkv, group, d, page, np_) from the sweep of tests/test_kernels.py
PAGED_CASES = [
    (1, 1, 1, 64, 128, 2),
    (2, 2, 4, 128, 128, 4),
    (3, 1, 2, 64, 256, 2),
    (2, 2, 1, 128, 256, 4),
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", PAGED_CASES, ids=str)
def test_paged_plain_matches_pallas_and_ref(case, dt):
    b, hkv, group, d, page, np_ = case
    P = np_ * 4
    rng = np.random.default_rng(sum(case))
    (q, kp, vp), (tq, tkp, tvp) = _inputs(sum(case), dt, (b, hkv * group, d),
                                          (P, page, hkv, d), (P, page, hkv, d))
    pt = rng.integers(0, P, (b, np_), dtype=np.int32)       # ids may repeat
    sl = rng.integers(1, np_ * page, (b,), dtype=np.int32)
    port = tpaged.attention(tq, tkp, tvp, torch.from_numpy(pt),
                            torch.from_numpy(sl))
    assert port.dtype == tq.dtype and port.shape == tq.shape
    tol = PAGED_TOL[dt]
    _close(port, paged_attention(q, kp, vp, jnp.asarray(pt), jnp.asarray(sl),
                                 interpret=True), tol)
    _close(port, paged_attention_ref(q, kp, vp, jnp.asarray(pt),
                                     jnp.asarray(sl)), tol)


def test_paged_plain_edge_ids_and_lengths():
    """Negative and too-large page ids read what JAX's indexing reads; a
    sequence with no live position takes the uniform average."""
    (q, kp, vp), (tq, tkp, tvp) = _inputs(3, "f32", (3, 4, 16),
                                          (6, 8, 2, 16), (6, 8, 2, 16))
    pt = np.array([[-1, 7, 2], [0, -6, 5], [9, 1, -3]], dtype=np.int32)
    sl = np.array([0, 24, 30], dtype=np.int32)
    port = tpaged.attention(tq, tkp, tvp, torch.from_numpy(pt),
                            torch.from_numpy(sl))
    _close(port, paged_attention_ref(q, kp, vp, jnp.asarray(pt),
                                     jnp.asarray(sl)), 5e-5)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_matches_reference(window):
    (q, kc, vc), (tq, tkc, tvc) = _inputs(11, "bf16", (2, 4, 1, 16),
                                          (2, 2, 12, 16), (2, 2, 12, 16))
    for pos in (0, 7, 11):
        _close(tattn.decode_attention(tq, tkc, tvc, pos, window=window),
               jax_decode(q, kc, vc, pos, window=window), 1e-2)


def test_paged_matches_decode_attention_on_a_paged_cache():
    """The paged path on a cache cut into shuffled pages equals decode
    attention on the contiguous cache (the check chip_smoke.py makes at
    full width on the card)."""
    _, (tq, tkc, tvc) = _inputs(5, "f32", (2, 4, 1, 16), (2, 2, 32, 16),
                                (2, 2, 32, 16))
    page = 8
    perm = np.random.default_rng(5).permutation(2 * 4)
    kp = tkc.permute(0, 2, 1, 3).reshape(2 * 4, page, 2, 16)
    vp = tvc.permute(0, 2, 1, 3).reshape(2 * 4, page, 2, 16)
    table = torch.from_numpy(np.argsort(perm).reshape(2, 4).astype(np.int32))
    out = tpaged.attention(tq[:, :, 0], kp[perm], vp[perm], table,
                           torch.tensor([32, 32], dtype=torch.int32))
    want = tattn.decode_attention(tq, tkc, tvc, 31)[:, :, 0]
    torch.testing.assert_close(out, want, atol=5e-5, rtol=5e-5)


def test_kv_update_writes_one_slot_in_place():
    cache = torch.zeros((2, 2, 6, 4))
    new = torch.ones((2, 2, 1, 4))
    out = tattn.kv_update(cache, new, 3)
    assert out is cache
    assert cache[:, :, 3].eq(1).all() and cache.sum() == new.sum()


@pytest.mark.parametrize("positions", [np.arange(7), np.arange(14).reshape(2, 7)])
def test_rope_matches_reference(positions):
    from repro.models.attention import apply_rope
    (x,), (tx,) = _inputs(9, "bf16", (2, 3, 7, 16))
    port = tattn.apply_rope(tx, torch.from_numpy(positions), 1e4)
    ref = apply_rope(x, jnp.asarray(positions), 1e4)
    assert port.dtype == torch.bfloat16
    _close(port, ref, 1e-2)


def test_non_cpu_tensor_never_falls_back(monkeypatch):
    """A tensor off the CPU goes to the kernel wrapper: there is no silent
    plain-version arm, forward or backward.  The one exception is
    a ``meta`` tensor, which holds no data (the dry-run's cost trace): it
    takes the plain versions.  The CUDA tensors here are fake (shapes on
    this CPU build) and the wrappers stand-ins that raise; under grad the
    forward stand-in returns an output and statistics, and the backward
    reaches the backward kernel's stand-in, never ``attention_bwd_ref``."""
    from types import SimpleNamespace

    from torch._subclasses.fake_tensor import FakeTensorMode

    def kernel(*args, **kw):
        raise ValueError("the CUDA kernel was called")

    def forward(q, k, v, return_stats=False, **kw):
        calls.append("forward")
        return q.new_empty(q.shape), q.new_empty(q.shape[:3],
                                                 dtype=torch.float32)

    def backward(q, k, v, do, stats, **kw):
        calls.append("backward")
        assert do.shape == q.shape and stats.shape == q.shape[:3]
        raise ValueError("the CUDA backward kernel was called")

    def plain_backward(*args, **kw):
        raise AssertionError("attention_bwd_ref on a CUDA tensor")
    monkeypatch.setattr(tflash, "flash_attention", kernel)
    monkeypatch.setattr(tflash, "attention_bwd_ref", plain_backward)
    monkeypatch.setattr(tpaged, "paged_attention", kernel)
    with FakeTensorMode():
        q = torch.empty((1, 2, 8, 16), device="cuda")
        qd = torch.empty((1, 2, 16), device="cuda")
        pages = torch.empty((2, 8, 2, 16), device="cuda")
        ids = torch.empty((1, 2), dtype=torch.int32, device="cuda")
        lens = torch.empty((1,), dtype=torch.int32, device="cuda")
        leaf = torch.empty((1, 2, 8, 16), device="cuda", requires_grad=True)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        tpaged.attention(qd, pages, pages, ids, lens)
    # the Function's forward and backward are called as autograd calls
    # them, without its graph: this CPU build cannot give a fake CUDA leaf
    # a gradient accumulator
    calls = []
    ctx = SimpleNamespace(
        save_for_backward=lambda *t: setattr(ctx, "saved_tensors", t))
    monkeypatch.setattr(tflash, "flash_attention", forward)
    monkeypatch.setattr(tflash, "flash_attention_bwd", backward)
    monkeypatch.setattr(tflash.FlashAttention, "apply",
                        lambda *a: tflash.FlashAttention.forward(ctx, *a))
    out = tflash.attention(leaf, leaf, leaf)
    assert calls == ["forward"] and len(ctx.saved_tensors) == 4
    with pytest.raises(ValueError, match="CUDA backward"):
        tflash.FlashAttention.backward(ctx, out)
    assert calls == ["forward", "backward"]
    monkeypatch.undo()
    m = torch.empty((1, 2, 8, 16), device="meta")
    assert tflash.attention(m, m, m).shape == m.shape
    ml = m.clone().requires_grad_()
    (g,) = torch.autograd.grad(tflash.attention(ml, ml, ml), ml,
                               torch.empty_like(m))
    assert g.shape == m.shape and g.device.type == "meta"
    md = torch.empty((1, 2, 16), device="meta")
    mp = torch.empty((2, 8, 2, 16), device="meta")
    assert tpaged.attention(
        md, mp, mp, torch.empty((1, 2), dtype=torch.int32, device="meta"),
        torch.empty((1,), dtype=torch.int32, device="meta")).shape == md.shape
