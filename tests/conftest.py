import jax
import pytest

from _jaxcompat import MODERN_JAX


@pytest.fixture(scope="session")
def smoke_mesh():
    if not MODERN_JAX:
        pytest.skip(f"installed jax {jax.__version__} lacks "
                    "set_mesh/AxisType; model tests require jax>=0.6")
    from repro.launch.mesh import make_smoke_mesh
    return make_smoke_mesh()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (and nvcc); skips without one")
