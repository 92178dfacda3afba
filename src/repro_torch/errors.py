"""Shared error taxonomy for the data plane and the training runner.

One module, one vocabulary: the tube (`core/*`), the workflow executor
(`serving/executor.py`) and the training-side recovery loop
(`distributed/fault.py`) all raise and catch the same structured
exceptions, so a node crash surfaced by the fault injector reads the
same whether it killed a collective, a transfer, or a resident
intermediate.

Hierarchy:

    FaaSTubeError (RuntimeError)
    ├── TransferFailed      a TransferPlan gave up after its retry budget
    ├── ObjectLost          a stored intermediate has no surviving copy
    ├── NodeFailure         a host/node died (detector or injector)
    ├── StragglerTimeout    a step blew its deadline
    └── PoolCapacityError   an alloc would overflow an ElasticPool

`NodeFailure`/`StragglerTimeout` were lifted from `distributed/fault.py`
and `PoolCapacityError` from `core/elastic_pool.py`; both modules
re-export them, so existing imports keep working.
"""
from __future__ import annotations


class FaaSTubeError(RuntimeError):
    """Base class for every structured failure the repro raises."""


class TransferFailed(FaaSTubeError):
    """A transfer plan exhausted its retry/degradation ladder.

    Attributes mirror the plan that died: ``func``, ``src``, ``dst``,
    ``kind`` (g2g/h2g/...), the root ``cause`` string recorded by the
    simulator (e.g. ``"link gpu0-gpu2"``, ``"node n3"``, ``"deadline"``)
    and how many ``attempts`` were burned.
    """

    def __init__(self, func: str, src: str, dst: str, kind: str,
                 cause: str, attempts: int = 1):
        super().__init__(
            f"transfer {kind} {src}->{dst} for {func} failed "
            f"after {attempts} attempt(s): {cause}")
        self.func = func
        self.src = src
        self.dst = dst
        self.kind = kind
        self.cause = cause
        self.attempts = attempts


class ObjectLost(FaaSTubeError):
    """A stored intermediate has no surviving copy anywhere.

    ``data_id`` is the tube id, ``node`` the device/host whose loss took
    the last copy, ``cause`` the underlying fault (string or exception).
    """

    def __init__(self, data_id: str, node: str = "", cause=""):
        super().__init__(f"object {data_id} lost"
                         + (f" on {node}" if node else "")
                         + (f": {cause}" if cause else ""))
        self.data_id = data_id
        self.node = node
        self.cause = cause


class NodeFailure(FaaSTubeError):
    """Raised by the failure detector (or injector) when a host dies.

    ``host_id`` keeps the training-runner int contract; the tube passes
    node name strings through it unchanged.
    """

    def __init__(self, host_id):
        super().__init__(f"host {host_id} failed")
        self.host_id = host_id


class StragglerTimeout(FaaSTubeError):
    pass


class PoolCapacityError(FaaSTubeError):
    """An allocation would push used blocks past ``capacity_mb``.

    Raised instead of silently over-committing: the caller (the FaaSTube
    store facade) must spill victims and retry once their g2h copies
    complete.  ``alloc(..., force=True)`` bypasses the check for single
    items larger than the whole store, where no victim can ever help.

    Structured fields (all optional, default empty) let waiter wakeups
    carry the cause: ``device``, ``need_mb``, ``cause``.
    """

    def __init__(self, msg: str = "", *, device: str = "",
                 need_mb: float = 0.0, cause: str = ""):
        super().__init__(msg or f"{device}: alloc {need_mb:.0f} MB "
                                f"over capacity" + (f" ({cause})" if cause
                                                    else ""))
        self.device = device
        self.need_mb = need_mb
        self.cause = cause
