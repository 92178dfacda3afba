"""The port's resharding (``distributed/resharding.py``) against the JAX
package's, on the CPU.

On 4 gloo ranks of a 2x2 (data, model) mesh, each rank's shard of a
16 x 3 tensor sharded over ``model`` goes through
``single_path_permute`` and ``multipath_permute`` (``detour_frac`` 0.25
and 0.5); the shards equal the reference's results, which run on 4 host
devices.  ``tube_reshard`` moves a 16 x 4 tensor's ``model`` sharding
from its rows to its columns with one all-to-all; each rank's shard is
its ``local_slice`` of the same tensor.  The serving handoffs
(``TUBE_CASES``: an axis that leaves, one that joins, the prefill K/V's
heads over ``model`` onto a dim split over ``(data, model)``, a spec
kept) give each rank its ``local_slice`` under the new spec; a handoff
that would split a source dim's axes raises before any collective.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _meshref as MR  # noqa: E402
from _meshrun import launch  # noqa: E402

from repro_torch.distributed.mesh import local_slice  # noqa: E402
from repro_torch.distributed.resharding import tube_reshard  # noqa: E402

MESH = SimpleNamespace(shape=(2, 2), mesh_dim_names=("data", "model"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("resharding")
    ref, out = d / "ref", d / "port"
    ref.mkdir()
    out.mkdir()
    x = np.arange(48, dtype=np.float32).reshape(16, 3)
    y = np.random.default_rng(3).standard_normal((16, 4)).astype(np.float32)
    np.savez(out / "x.npz", x=x, y=y)
    MR.run("resharding", str(out / "x.npz"), str(ref), devices=4)
    launch(4, "resharding", ref, out)
    return (np.load(ref / "resharding.npz"), np.load(out / "x.npz"),
            [np.load(out / f"resharding_rank{r}.npz") for r in range(4)])


@pytest.mark.parametrize("how", ["single", "multi_0.25", "multi_0.5"])
def test_permute_matches_reference(runs, how):
    ref, x, ranks = runs
    want = ref[how]
    assert not np.array_equal(want, x["x"])        # the shards moved
    for got in ranks:
        sl = local_slice(want.shape, ("model", None), MESH,
                         tuple(got["coord"]))
        np.testing.assert_array_equal(got[how], want[sl])


def test_tube_reshard_moves_rows_to_columns(runs):
    _, x, ranks = runs
    for got in ranks:
        sl = local_slice((16, 4), (None, "model"), MESH, tuple(got["coord"]))
        np.testing.assert_array_equal(got["tube"], x["y"][sl])


@pytest.mark.parametrize("case", range(len(MR.TUBE_CASES)))
def test_tube_reshard_serving_handoffs(runs, case):
    _, x, ranks = runs
    src, dst = MR.TUBE_CASES[case]
    for got in ranks:
        sl = local_slice((16, 4), dst, MESH, tuple(got["coord"]))
        np.testing.assert_array_equal(got[f"tube_{case}"], x["y"][sl])


@pytest.mark.parametrize("src,dst", [
    ((("data", "model"), None), ("data", None)),
    ((None, ("data", "model")), (("data", "model"), None)),
    ((("data", "model"), None), (None, ("data", "model"))),
    (("model", None), (("model", "data"), None)),
])
def test_tube_reshard_refuses_other_handoffs(src, dst):
    with pytest.raises(NotImplementedError, match="tube_reshard"):
        tube_reshard(torch.zeros(8, 4), src, dst, MESH)
