"""Both packages' framework-free modules side by side, for the tests
that run one scenario through the reference and through the port."""
import importlib
from types import SimpleNamespace

_MODULES = {"api": "core.api", "faults": "core.faults",
            "linksim": "core.linksim", "topology": "core.topology",
            "transfer": "core.transfer", "migration": "core.migration",
            "elastic_pool": "core.elastic_pool", "shard": "core.shard",
            "errors": "errors", "executor": "serving.executor",
            "workflow": "serving.workflow",
            "modelcache": "serving.modelcache"}


def _lib(pkg: str) -> SimpleNamespace:
    return SimpleNamespace(pkg=pkg, **{
        k: importlib.import_module(f"{pkg}.{m}") for k, m in _MODULES.items()})


REF, PORT = _lib("repro"), _lib("repro_torch")


def both(scenario):
    """Run a scenario through the reference and the port; the port's
    result must equal the reference's."""
    ref, port = scenario(REF), scenario(PORT)
    assert port == ref
    return port
