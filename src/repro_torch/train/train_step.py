"""The train step: loss, gradients and the AdamW update.

Counterpart of ``repro.train.train_step``'s ``make_train_step`` on one
device (the sharding trees come with the distributed slice).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.models.factory import Model
from repro_torch.train import optim as O


def value_and_grad(loss_fn: Callable) -> Callable:
    """``(params, batch) -> (loss, grads)`` by autograd: the floating
    leaves of ``params`` are differentiated (``torch.utils.checkpoint``,
    custom ops and ``torch.autograd.Function``s all take part).  A
    floating leaf that the loss does not reach raises ``ValueError``
    naming it: a harness that lost autograd history must not train its
    parameters with a zero gradient.  Other leaves get zeros."""
    def run(params, batch):
        leaves, spec = pytree.tree_flatten_with_path(params)
        live = [t.detach().requires_grad_(t.is_floating_point())
                for _, t in leaves]
        loss = loss_fn(pytree.tree_unflatten(live, spec), batch)
        wrt = [t for t in live if t.requires_grad]
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
        grads = []
        for (path, _), t in zip(leaves, live):
            if not t.requires_grad:
                grads.append(torch.zeros_like(t))
                continue
            g = next(got)
            if g is None:
                raise ValueError(f"no gradient reaches parameter "
                                 f"{pytree.keystr(path)}")
            grads.append(g)
        return loss.detach(), pytree.tree_unflatten(grads, spec)
    return run


def make_train_step(model: Model, opt_cfg: O.AdamWConfig, *,
                    lilac_grad: bool = False,
                    lilac_options: Optional[Dict[str, Any]] = None):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``.

    With ``cfg.microbatches > 1`` the batch is split on its leading axis
    and the gradients are accumulated in f32; the optimizer applies once a
    step.  ``lilac_grad=True`` passes
    ``torch.func.grad_and_value(model.loss_fn)`` through ``lilac.compile``
    (with ``lilac_options`` as its keyword arguments): the gradient's own
    graph is detected and rewritten, so a sparse computation of the
    backward pass is harnessed like one of the forward, and a resolved
    entry bakes (docs/transforms.md)."""
    mb = max(1, model.cfg.microbatches)
    if lilac_grad:
        from repro_torch import lilac

        compiled = lilac.compile(torch.func.grad_and_value(model.loss_fn),
                                 **(lilac_options or {}))

        def vg(params, batch):
            grads, loss = compiled(params, batch)
            return loss, grads
    else:
        vg = value_and_grad(model.loss_fn)

    def train_step(params, opt_state, batch):
        if mb == 1:
            loss, grads = vg(params, batch)
        else:
            loss = 0.0
            grads = pytree.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            for i in range(mb):
                part = pytree.tree_map(
                    lambda a: a.reshape((mb, a.shape[0] // mb)
                                        + tuple(a.shape[1:]))[i], batch)
                loss_i, g_i = vg(params, part)
                grads = pytree.tree_map(lambda a, g: a + g.float(), grads,
                                        g_i)
                loss = loss + loss_i
            loss = loss / mb
            grads = pytree.tree_map(lambda g: g / mb, grads)
        new_params, new_state, metrics = O.adamw_update(
            opt_cfg, grads, opt_state, params)
        return new_params, new_state, dict(metrics, loss=loss)

    return train_step
