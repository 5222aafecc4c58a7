"""The training loop: the step, checkpoint/restart and the straggler
hooks.

Counterpart of ``repro.train.loop`` on one device, the driver of
``repro_torch.examples.train_e2e`` and ``repro_torch.launch.train``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

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


def train_loop(model: Model, opt_cfg: O.AdamWConfig, loop_cfg: LoopConfig,
               batch_fn: Callable[[int], Dict[str, np.ndarray]], *,
               params=None, device="cuda", seed: int = 0,
               step_fn: Optional[Callable] = None,
               emit: Callable[[str], None] = print) -> Dict[str, Any]:
    """Runs the loop from the latest checkpoint of ``loop_cfg.ckpt_dir``
    (with ``resume``) or from ``params`` (drawn from ``seed`` when None),
    each step by ``step_fn`` (default ``make_train_step(model, opt_cfg)``);
    returns {params, opt_state, history, straggler, start_step}."""
    device = torch.device(device)
    step_fn = step_fn or TS.make_train_step(model, opt_cfg)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(seed),
                            device)
    opt_state = O.adamw_init(opt_cfg, params)
    start_step = 0
    ckpt = None
    if loop_cfg.ckpt_dir:
        ckpt = Checkpointer(loop_cfg.ckpt_dir)
        latest = ckpt.latest_step() if loop_cfg.resume else None
        if latest is not None:
            state = ckpt.restore(latest, {"params": params,
                                          "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start_step = latest
            emit(f"[restart] restored checkpoint step {latest}")

    mon = StragglerMonitor()
    history = []
    with _deterministic(loop_cfg.deterministic):
        for step in range(start_step, loop_cfg.steps):
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in batch_fn(step).items()}
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])      # waits for the step
            dt = time.perf_counter() - t0
            mon.observe(step, dt)
            history.append(loss)
            heartbeat(step, {**metrics, "sec": dt},
                      log_every=loop_cfg.log_every, emit=emit)
            if ckpt and (step + 1) % loop_cfg.ckpt_every == 0:
                ckpt.save(step + 1, {"params": params, "opt": opt_state})
    if ckpt and loop_cfg.steps % loop_cfg.ckpt_every == 0 \
            and loop_cfg.steps > start_step:
        ckpt.wait()             # the last step's save is the final one
    elif ckpt:
        ckpt.save(loop_cfg.steps, {"params": params, "opt": opt_state},
                  blocking=True)
    return {"params": params, "opt_state": opt_state, "history": history,
            "straggler": mon, "start_step": start_step}
