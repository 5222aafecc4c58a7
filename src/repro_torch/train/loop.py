"""The training loop: the compiled step, checkpoint/restart and the
straggler hooks, on one device or on a mesh.

Counterpart of ``repro.train.loop``, the driver of
``repro_torch.examples.train_e2e`` and ``repro_torch.launch.train``.  The
reference always runs its step under ``jax.jit``; here the step runs
under ``torch.compile`` (``core.jit.Entry``) with the backend the caller
names, ``"inductor"`` by default; the CPU tests pass ``"aot_eager"``, and
``backend=None`` runs the step uncompiled.  On one device the whole step
(forward, backward by ``torch.func.grad_and_value``, AdamW) is one graph
(``fullgraph=True``; an unrolled loop with microbatches), and the
``lilac`` MoE's ``lilac_torch::moe_ffn`` lands in it; under ``cfg.remat``
the gradient is ``torch.autograd.grad`` (``torch.func`` takes no
checkpoint), a graph break.  Torch has no
buffer donation, so the compiled step holds its inputs and its outputs
at once, as the eager step does.  On a mesh the collectives are graph
breaks (``launch.collectives``: gloo, staged through the host), and so is
``torch.autograd.grad``: the forward compiles between the collectives and
autograd runs the compiled pieces' backward.  On
a mesh (``mesh=``, ``rules=``; the model's config has
``spmd_constraints``) every rank draws the same parameters from the seed
and keeps its blocks at the parameter shardings, the optimizer state at
the same placements, and takes its rows of each global batch; the
checkpoints are sharded (``train.checkpoint``) and rank 0 alone emits
the log.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import jit
from repro_torch.launch import collectives as C
from repro_torch.models.factory import Model
from repro_torch.train import optim as O
from repro_torch.train import train_step as TS
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.elastic import StragglerMonitor, heartbeat


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    resume: bool = True
    # torch.use_deterministic_algorithms for the loop: every step then
    # computes the same bits from the same state, so a restart from a
    # checkpoint repeats the uninterrupted run's losses exactly (on CUDA
    # cuBLAS also needs CUBLAS_WORKSPACE_CONFIG=:4096:8 set at start-up)
    deterministic: bool = False


@contextlib.contextmanager
def _deterministic(on: bool):
    was = torch.are_deterministic_algorithms_enabled()
    if on:
        torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def shard_params(params, shardings):
    """The rank's blocks of a global tree at ``shardings`` (under the
    current mesh)."""
    from repro_torch.models.spec import tree_map
    return tree_map(lambda v, sh: C.local_of(v, sh.spec).clone(), params,
                    shardings)


#: dynamo's recompile limit for a step with graph breaks (the mesh's):
#: each Python frame that runs between two breaks compiles on its own
#: (a tree_map's per-leaf lambda at every leaf's shape and dtype), where
#: dynamo's default, 8, would raise
BROKEN_RECOMPILE_LIMIT = 64


def compile_step(step_fn: Callable, backend) -> jit.Entry:
    """``step_fn`` under ``torch.compile`` with ``backend``: one graph
    (``fullgraph``) where the step says it traces whole (``one_graph``:
    ``make_train_step`` on one device without remat), else with graph
    breaks, which the entry counts."""
    one = getattr(step_fn, "one_graph", False)
    return jit.Entry(step_fn, backend, fullgraph=one,
                     recompile_limit=None if one else BROKEN_RECOMPILE_LIMIT,
                     name="train_step")


def train_loop(model: Model, opt_cfg: O.AdamWConfig, loop_cfg: LoopConfig,
               batch_fn: Callable[[int], Dict[str, np.ndarray]], *,
               params=None, device="cuda", seed: int = 0,
               step_fn: Optional[Callable] = None, mesh=None, rules=None,
               backend=jit.DEFAULT_BACKEND,
               emit: Callable[[str], None] = print) -> Dict[str, Any]:
    """Runs the loop from the latest checkpoint of ``loop_cfg.ckpt_dir``
    (with ``resume``) or from ``params`` (global; drawn from ``seed`` when
    None), each step by ``step_fn`` (default ``make_train_step(model,
    opt_cfg)``) compiled with ``backend`` (:func:`compile_step`; None runs
    it uncompiled; a ``step_fn`` that is already a ``core.jit.Entry`` runs
    as it is, so that a second loop reuses its compiled graphs); returns
    {params, opt_state, history, step_seconds (each step's wall time to
    its loss on the host), straggler, start_step, compiled: the entry's
    counts or None}, on a mesh the rank's blocks."""
    if mesh is None:
        return _run(model, opt_cfg, loop_cfg, batch_fn, params, device, seed,
                    step_fn, backend, None, None, emit)
    with C.use_mesh(mesh):
        return _run(model, opt_cfg, loop_cfg, batch_fn, params, device, seed,
                    step_fn, backend, TS.param_shardings(model, mesh, rules),
                    TS.opt_state_shardings(model, opt_cfg, mesh, rules),
                    emit if mesh.get_rank() == 0 else (lambda _: None),
                    TS.batch_pspec(rules))


def _run(model, opt_cfg, loop_cfg, batch_fn, params, device, seed, step_fn,
         backend, pshard, oshard, emit, bspec=None):
    device = torch.device(device)
    step_fn = step_fn or TS.make_train_step(model, opt_cfg)
    if not isinstance(step_fn, jit.Entry) and backend is not None:
        step_fn = compile_step(step_fn, backend)
    entry = step_fn if isinstance(step_fn, jit.Entry) else None
    # a compiled step skips the check that every parameter gets a
    # gradient inside its trace: it runs once here, on fake tensors
    check = entry and getattr(entry.fn, "check_gradients", None)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(seed),
                            device)
    if pshard is not None:
        params = shard_params(params, pshard)
    opt_state = O.adamw_init(opt_cfg, params)
    start_step = 0
    ckpt = None
    if loop_cfg.ckpt_dir:
        ckpt = Checkpointer(loop_cfg.ckpt_dir)
        latest = ckpt.latest_step() if loop_cfg.resume else None
        if latest is not None:
            state = ckpt.restore(
                latest, {"params": params, "opt": opt_state},
                None if pshard is None else {"params": pshard,
                                             "opt": oshard})
            params, opt_state = state["params"], state["opt"]
            start_step = latest
            emit(f"[restart] restored checkpoint step {latest}")
    shardings = None if pshard is None else {"params": pshard, "opt": oshard}

    mon = StragglerMonitor()
    history, seconds = [], []
    with _deterministic(loop_cfg.deterministic):
        for step in range(start_step, loop_cfg.steps):
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in batch_fn(step).items()}
            if bspec is not None:
                batch = {k: C.local_of(v, bspec[:v.dim()])
                         for k, v in batch.items()}
            if check is not None:
                check(params, batch)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])      # waits for the step
            dt = time.perf_counter() - t0
            mon.observe(step, dt)
            history.append(loss)
            seconds.append(dt)
            heartbeat(step, {**metrics, "sec": dt},
                      log_every=loop_cfg.log_every, emit=emit)
            if ckpt and (step + 1) % loop_cfg.ckpt_every == 0:
                ckpt.save(step + 1, {"params": params, "opt": opt_state},
                          shardings=shardings)
    if ckpt and loop_cfg.steps % loop_cfg.ckpt_every == 0 \
            and loop_cfg.steps > start_step:
        ckpt.wait()             # the last step's save is the final one
    elif ckpt:
        ckpt.save(loop_cfg.steps, {"params": params, "opt": opt_state},
                  blocking=True, shardings=shardings)
    return {"params": params, "opt_state": opt_state, "history": history,
            "step_seconds": seconds, "straggler": mon, "start_step": start_step,
            "compiled": entry.stats() if entry is not None else None}
