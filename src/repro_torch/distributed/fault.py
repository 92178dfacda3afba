"""Fault tolerance: node-failure recovery, elastic re-mesh, stragglers.

Recovery contract (1000+-node ready):
  * every K steps an async checkpoint lands on shared storage;
  * on a node failure the runner rebuilds a degraded mesh
    (launch.mesh.make_degraded_mesh — model axis intact, data axis shrunk),
    re-lowers the step for the new mesh, and restores the last checkpoint
    with resharding (training/checkpoint.restore takes the new shardings);
  * stragglers: each step has a deadline; a straggling step is retried once
    (hedged) and the slow host reported to the scheduler hook.

This module is exercised on CPU by injecting failures (tests/test_fault.py):
the recovery path — degraded mesh, resharded restore, pipeline state rewind
— is identical to the real-pod path; only the failure *detector* differs
(heartbeats/NCCL-style timeouts on a real cluster, injected exceptions here).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

# the exception classes moved to the shared taxonomy (repro.errors) so
# the tube's fault injector and the training runner raise the same
# types; re-exported here for existing imports
from repro_torch.errors import NodeFailure, StragglerTimeout

__all__ = ["NodeFailure", "StragglerTimeout", "FaultPolicy", "FaultStats",
           "run_with_recovery"]


@dataclass
class FaultPolicy:
    checkpoint_every: int = 50
    step_deadline_s: float = 0.0        # 0 = no deadline
    max_restarts: int = 3
    on_failure: Optional[Callable[[int], None]] = None   # scheduler hook


@dataclass
class FaultStats:
    restarts: int = 0
    straggler_retries: int = 0
    failed_hosts: list = field(default_factory=list)


def run_with_recovery(step_fn, state, steps: int, policy: FaultPolicy,
                      *, save_fn, restore_fn, remesh_fn=None,
                      failure_injector=None):
    """Generic fault-tolerant step loop.

    step_fn(state, step_idx) -> state           (may raise NodeFailure)
    save_fn(state, step_idx), restore_fn(mesh_or_none) -> (state, step_idx)
    remesh_fn(failed_host) -> new context for re-lowering (optional)
    failure_injector(step_idx) -> None | NodeFailure  (tests)
    """
    stats = FaultStats()
    i = 0
    while i < steps:
        try:
            if failure_injector is not None:
                exc = failure_injector(i)
                if exc is not None:
                    raise exc
            t0 = time.time()
            state = step_fn(state, i)
            if policy.step_deadline_s and time.time() - t0 > policy.step_deadline_s:
                # hedged retry: rerun the step once, flag the straggler
                stats.straggler_retries += 1
                state = step_fn(state, i)
            if policy.checkpoint_every and (i + 1) % policy.checkpoint_every == 0:
                save_fn(state, i + 1)
            i += 1
        except NodeFailure as f:
            stats.restarts += 1
            stats.failed_hosts.append(f.host_id)
            if stats.restarts > policy.max_restarts:
                raise
            if policy.on_failure:
                policy.on_failure(f.host_id)
            if remesh_fn is not None:
                remesh_fn(f.host_id)
            state, i = restore_fn()
    return state, stats
