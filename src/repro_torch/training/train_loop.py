"""End-to-end training runner, PyTorch port of
``src/repro/training/train_loop.py``: data pipeline, train step, async
checkpoints and fault recovery.  Used by ``launch/train.py``.

The model runs on ``cuda`` unless the caller asks for the CPU.  The step
updates the parameters and the optimizer state in place; the
checkpointer copies them to the host before its thread writes.

With a mesh (a ``DeviceMesh``; ``None`` is one device and no process
group), every rank runs this loop: it holds its slice of every
parameter under the cell's rules (drawn whole leaf by leaf from the
seed, then cut), draws the same global batch from the pipeline (keyed
by seed and step), and the step keeps the rank's rows and averages the
gradients.  The moments are slices of their parameter's shape or, for
the small-dense cells (whole parameters), ZeRO-1's shards
(``optimizer.zero1_shardings`` under ``mesh.make_opt_rules``).  Every
rank takes part in a checkpoint's gather, rank 0 writes it, and a
restore reads each rank's slices.  The recovery path
(``distributed/fault.py``) is the same on every rank.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.data.pipeline import Pipeline
from repro_torch.distributed import fault as F
from repro_torch.distributed.mesh import make_opt_rules, use_small_dense_dp
from repro_torch.models import model as M
from repro_torch.models import param as PM
from repro_torch.training import checkpoint as CKPT
from repro_torch.training.optimizer import (
    OptConfig, init_opt_state, opt_pspecs, zero1_shardings)
from repro_torch.training.train_step import build_train_step


@dataclass
class TrainState:
    params: object
    opt_state: object
    pipeline: Pipeline
    step: int = 0


def run_training(cfg: ArchConfig, shape: ShapeSpec, mesh=None, *, steps: int,
                 oc: OptConfig | None = None, accum: int = 1,
                 ckpt_dir: str | None = None, resume: bool = False,
                 policy: F.FaultPolicy | None = None,
                 failure_injector=None, log_every: int = 10,
                 log_fn=print, pipeline_cls=Pipeline, device="cuda"):
    """Train ``steps`` steps from the weights of seed 0 (or the latest
    checkpoint, with ``resume``).  Returns (state, losses, FaultStats)."""
    oc = oc or OptConfig(schedule=cfg.lr_schedule)
    policy = policy or F.FaultPolicy(checkpoint_every=0)
    ctx = M.build_ctx(cfg, shape, mesh)
    pspecs = M.model_specs(cfg)
    opt_rules = zshd = tree_shd = local = None
    if mesh is not None:
        opt_rules = make_opt_rules(cfg, shape, mesh, ctx.rules)
        # checks that int8 moments keep whole 128-blocks in either case
        zshd = zero1_shardings(pspecs, oc.state_dtype, opt_rules, mesh)
        if not use_small_dense_dp(cfg, shape, mesh):
            zshd = None
        tree_shd = {"params": PM.shardings(pspecs, ctx.rules, mesh),
                    "opt": PM.shardings(opt_pspecs(pspecs, oc.state_dtype),
                                        opt_rules, mesh)}
        local = PM.shard_local(pspecs, ctx.rules, mesh)
    train_step = build_train_step(cfg, ctx, oc, accum, zshd)

    def fresh_state():
        params = PM.trainable(M.init_params(cfg, 0, device, local))
        opt_state = init_opt_state(pspecs, oc.state_dtype, device,
                                   rules=opt_rules, mesh=mesh)
        return TrainState(params, opt_state,
                          pipeline_cls(cfg, shape, device=device))

    ckpt = CKPT.AsyncCheckpointer()

    def wait_for_writes():
        ckpt.wait()
        if mesh is not None:
            dist.barrier()          # rank 0's write is every rank's read

    def save_fn(state: TrainState, step: int):
        if ckpt_dir:
            ckpt.save(ckpt_dir, state.step,
                      {"params": state.params, "opt": state.opt_state},
                      extra={"pipeline": state.pipeline.state()},
                      shardings=tree_shd)

    def restore_fn():
        wait_for_writes()
        last = CKPT.latest_step(ckpt_dir) if ckpt_dir else None
        if last is None:
            return fresh_state(), 0
        st = fresh_state()
        tree, manifest = CKPT.restore(
            ckpt_dir, last, {"params": st.params, "opt": st.opt_state},
            tree_shd)
        pipe = pipeline_cls.from_state(cfg, shape,
                                       manifest["extra"]["pipeline"],
                                       device=device)
        return TrainState(PM.trainable(tree["params"]), tree["opt"], pipe,
                          last), last

    losses = []

    def step_fn(state: TrainState, i: int):
        batch = state.pipeline.next_batch()
        params, opt_state, metrics = train_step(
            state.params, state.opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if log_every and state.step % log_every == 0:
            log_fn(f"step {state.step}: loss={loss:.4f} "
                   f"lr={float(metrics['lr']):.2e} "
                   f"gnorm={float(metrics['grad_norm']):.3f}")
        # the global step lives on the state (resume-correct), not the
        # local loop index
        return TrainState(params, opt_state, state.pipeline, state.step + 1)

    if resume and ckpt_dir and CKPT.latest_step(ckpt_dir) is not None:
        state, start = restore_fn()
    else:
        state, start = fresh_state(), 0

    state, stats = F.run_with_recovery(
        step_fn, state, steps - start, policy,
        save_fn=save_fn, restore_fn=restore_fn,
        failure_injector=failure_injector)
    wait_for_writes()
    return state, losses, stats
