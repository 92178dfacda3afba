"""Loop-aware cost accounting of one rank's step, traced on ``meta``
tensors: the dry-run's ``flops``, ``traffic_bytes`` and
``collective_bytes`` (``launch/dryrun.py``), with the meaning the JAX
package's ``launch/hlo_analysis.py`` gives them over compiled HLO.

``CostCounter`` is a ``TorchDispatchMode`` that sees every aten op the
step dispatches, autograd's backward and the checkpoints' recomputation
included, and adds up:

  * ``flops``: the matrix products only (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``; einsum and matmul lower to them), ``2 * prod(out) *
    contracted``, the rule of ``torch.utils.flop_counter`` and of
    ``hlo_analysis`` (``2 * prod(out) * prod(contracting)``).  Elementwise
    ops count 0;
  * ``traffic_bytes``: the bytes of every tensor operand and every tensor
    output of each op that materializes a result (not a view, not an
    allocation alone), on the device: an unfused HBM model, as the
    reference's walker is an unfused one over CPU HLO, plus each
    collective's output bytes;
  * ``collective_bytes``: by the reference's kind names, the output bytes
    of every collective the port's primitives call (``collective``).

A loop whose trips do the same work on tensors of the same shapes runs
two trips while a counter is active, the first counted once and the
second ``n - 1`` times, as ``hlo_analysis`` multiplies a while body by
its trip count (the first trip may do less: a recurrence's zero initial
state needs no gradient): the loop iterates ``trips(n)`` or
``each(items)``, and ``fill`` restores the outputs the loop would have
collected.  With no counter active these
are ``range(n)``, the items themselves and the identity, so a run
computes exactly what it computed without them.

The multiplier of an op is the product of the loops around it.  Its
backward runs after the loops have exited, so the counter remembers, by
autograd sequence number, the multiplier under which each autograd node
was created, and an op of the backward takes its node's
(``torch._C._current_autograd_node``); nodes created inside a backward
(a Function's own ``autograd.grad``) take the node that created them.  A
checkpointed function's recomputation takes the loops around the
checkpoint call (``replay``).  The trace runs on the calling thread: the
``meta`` device's backward does.
"""
from __future__ import annotations

import bisect
import contextlib
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

#: ops that are not views yet move no tensor data: allocations, and the
#: reshape of a fresh result (``_unsafe_view``) that aliases it
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default,
               aten.empty_like.default, aten.new_empty.default,
               aten.new_empty_strided.default, aten._unsafe_view.default}

_ACTIVE: "CostCounter | None" = None


def _numel(shape) -> int:
    return math.prod(shape)


def _mm_flops(func, args, out) -> int:
    """2 x prod(out) x the contracted length of a matrix product."""
    if func in (aten.mm.default, aten.bmm.default):
        k = args[0].shape[-1]
    elif func in (aten.addmm.default, aten.baddbmm.default):
        k = args[1].shape[-1]
    else:
        return 0
    return 2 * _numel(out.shape) * k


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _device_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree)
               if t.device.type != "cpu")


class CostCounter(TorchDispatchMode):
    """Within ``with CostCounter() as c:``, ``c.flops``,
    ``c.traffic_bytes`` and ``c.collective_bytes`` add up what the ops
    dispatched cost, each times its multiplier (module docstring)."""

    def __init__(self, loops: bool = True):
        super().__init__()
        self.loops = loops               # False: every trip runs
        self.flops = 0
        self.flops_by_op: dict[str, int] = {}
        self.traffic_bytes = 0
        self.collective_bytes: dict[str, int] = {}
        self._stack: list[int] = []      # the trip counts of open loops
        self._replaying = 0
        self._seen = 0                   # sequence numbers assigned so far
        self._starts: list[int] = []     # breakpoints: nodes >= start ...
        self._mults: list[int] = []      # ... were created under this

    # -- multipliers --------------------------------------------------------
    def _node_mult(self, seq: int) -> int:
        i = bisect.bisect_right(self._starts, seq) - 1
        return self._mults[i] if i >= 0 else 1

    def mult(self) -> int:
        """The multiplier of an op dispatched now; the autograd nodes
        created since the last call are assigned it."""
        node = None if self._replaying else torch._C._current_autograd_node()
        m = math.prod(self._stack) if node is None else \
            self._node_mult(node._sequence_nr())
        self._assign(m)
        return m

    def _assign(self, m: int) -> None:
        seq = torch.autograd._get_sequence_nr()
        if seq > self._seen:
            if not self._mults or self._mults[-1] != m:
                self._starts.append(self._seen)
                self._mults.append(m)
            self._seen = seq

    def _loop(self, n: int, two):
        """The trips ``two`` (the first two), counted 1 and ``n - 1``
        times."""
        self.mult()                      # nodes so far: the outer loops'
        for item, m in zip(two, (1, n - 1)):
            self._stack.append(m)
            try:
                yield item
                self.mult()
            finally:
                self._stack.pop()

    @contextlib.contextmanager
    def _replay(self, stack):
        self.mult()
        saved, self._stack = self._stack, list(stack)
        self._replaying += 1
        try:
            yield
        finally:
            self.mult()
            self._stack = saved
            self._replaying -= 1

    # -- counting -----------------------------------------------------------
    def add_collective(self, kind: str, nbytes: int) -> None:
        m = self.mult()
        self.collective_bytes[kind] = \
            self.collective_bytes.get(kind, 0) + m * nbytes
        self.traffic_bytes += m * nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        m = self.mult()
        out = func(*args, **kwargs)
        if func.namespace == "c10d":     # counted by ``collective``
            return out
        flops = m * _mm_flops(func, args, out)
        if flops:
            self.flops += flops
            name = str(func.overloadpacket)
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + flops
        if not func.is_view and func not in _NO_TRAFFIC:
            self.traffic_bytes += m * (_device_bytes((args, kwargs))
                                       + _device_bytes(out))
        return out

    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a CostCounter is already active")
        self._seen = torch.autograd._get_sequence_nr()
        _ACTIVE = self
        return super().__enter__()

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = None
        return super().__exit__(*exc)

    def totals(self) -> dict:
        return {"flops": self.flops, "traffic_bytes": self.traffic_bytes,
                "collective_bytes": dict(self.collective_bytes)}


def counting() -> bool:
    return _ACTIVE is not None


def trips(n: int):
    """``range(n)`` for a loop whose trips do the same work; under a
    counter, trips 0 and 1 alone, counted once and ``n - 1`` times."""
    if _ACTIVE is None or not _ACTIVE.loops or n <= 2:
        return range(n)
    return _ACTIVE._loop(n, (0, 1))


def each(items):
    """``items`` for a loop over equal-shaped pieces (``x.split(chunk)``);
    under a counter, the first two alone, counted once and
    ``len(items) - 1`` times."""
    items = list(items)
    if _ACTIVE is None or not _ACTIVE.loops or len(items) <= 2:
        return items
    return _ACTIVE._loop(len(items), items[:2])


def fill(outs: list, n: int) -> list:
    """The ``n`` outputs a loop collects: ``outs`` itself, or under a
    counter its last output repeated (same shape, for the stack or
    concatenation after the loop)."""
    if _ACTIVE is None or len(outs) == n:
        return outs
    return outs + outs[-1:] * (n - len(outs))


def replay(fn):
    """``fn`` to hand to ``torch.utils.checkpoint``: under a counter, its
    recomputation in the backward runs under the loops around the
    checkpoint call."""
    c = _ACTIVE
    if c is None:
        return fn
    stack, calls = list(c._stack), []

    def run(*args, **kwargs):
        if not calls:
            calls.append(1)
            return fn(*args, **kwargs)
        with c._replay(stack):
            return fn(*args, **kwargs)
    return run


def collective(kind: str, out) -> None:
    """Count a collective of ``kind`` whose output is ``out`` (tensors),
    when a counter is active."""
    if _ACTIVE is not None:
        _ACTIVE.add_collective(kind, sum(t.numel() * t.element_size()
                                         for t in _tensors(out)))
