"""Step builders (the train step: loss, gradients and the AdamW update;
the serve steps: prefill and decode) and the sharding trees of their
inputs and outputs on a mesh.

Counterpart of ``repro.train.train_step``.  A sharding tree is the
structure of what it describes with a ``models.spec.NamedSharding`` (a
mesh and a partition spec) at each leaf; ``mesh`` is a ``DeviceMesh`` or
a mapping of axis sizes (the dry-run's production meshes).  On a mesh the
train step runs one rank's share (``cfg.spmd_constraints``, under
``launch.collectives``' current mesh): its gradients are summed over the
mesh axes that each leaf's storage does not shard (the reference's
gradient constraint: a gradient lives at its parameter's storage
sharding), and the loss it reports is the ranks' shares summed.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import collectives as C
from repro_torch.models import spec as S
from repro_torch.models import transformer as T
from repro_torch.models.factory import Model
from repro_torch.train import optim as O


class ValueAndGrad:
    """The one-device step's ``(params, batch) -> (loss, grads)`` by
    ``torch.func.grad_and_value``
    over the floating leaves of ``params`` (``torch.utils.checkpoint``,
    custom ops and ``torch.autograd.Function``s with ``setup_context``
    all take part); other leaves, and the top-level entries named in
    ``unread`` (which the loss does not read by construction), get zeros.
    The functional transform traces whole under ``torch.compile``
    (``torch.autograd.grad`` is a graph break there), so the eager step
    and the compiled step compute the same bits.

    A floating leaf that the loss does not reach raises ``ValueError``
    naming it: a harness that lost autograd history must not train its
    parameters with a zero gradient.  :meth:`check` runs
    :func:`value_and_grad`, which finds such leaves, on fake copies of
    the inputs (the graph's structure, no device work), once for each
    structure of the inputs; an eager call checks before it computes,
    and a compiled caller calls :meth:`check` before its first call
    (inside the trace the check is skipped)."""

    def __init__(self, loss_fn: Callable, unread=()):
        self.loss_fn = loss_fn
        self.unread = tuple(unread)
        self._checked: set = set()

    @staticmethod
    def _key(params, batch):
        def sig(t):
            return (tuple(t.shape), t.dtype, t.device.type) \
                if isinstance(t, torch.Tensor) else repr(t)
        return repr([(pytree.keystr(p), sig(t)) for p, t in
                     pytree.tree_flatten_with_path((params, batch))[0]])

    def check(self, params, batch) -> None:
        from torch._subclasses.fake_tensor import FakeTensorMode

        key = self._key(params, batch)
        if key in self._checked:
            return
        mode = FakeTensorMode()

        def fake(t):
            return mode.from_tensor(t) if isinstance(t, torch.Tensor) else t
        with mode:
            value_and_grad(self.loss_fn, self.unread)(
                pytree.tree_map(fake, params), pytree.tree_map(fake, batch))
        self._checked.add(key)

    def __call__(self, params, batch):
        if not torch.compiler.is_compiling():
            self.check(params, batch)
        leaves, spec = pytree.tree_flatten_with_path(params)
        mask = [t.is_floating_point()
                and getattr(path[0], "key", None) not in self.unread
                for path, t in leaves]
        wrt = [t for (_, t), m in zip(leaves, mask) if m]

        def loss_of(wrt):
            it = iter(wrt)
            full = [next(it) if m else t for (_, t), m in zip(leaves, mask)]
            return self.loss_fn(pytree.tree_unflatten(full, spec), batch)

        got, loss = torch.func.grad_and_value(loss_of)(wrt)
        got = iter(got)
        grads = [next(got) if m else torch.zeros_like(t)
                 for (_, t), m in zip(leaves, mask)]
        return loss.detach(), pytree.tree_unflatten(grads, spec)


@torch.compiler.disable
def _autograd_grad(loss, wrt):
    """``torch.autograd.grad`` outside ``torch.compile``: a graph break in
    a compiled step, where it runs the compiled pieces' backward; no
    Python frame of the backward (an autograd Function's, a
    collective's) is traced."""
    return torch.autograd.grad(loss, wrt, allow_unused=True)


def value_and_grad(loss_fn: Callable, unread=()) -> Callable:
    """``(params, batch) -> (loss, grads)`` by autograd: the floating
    leaves of ``params`` are differentiated (``torch.utils.checkpoint``,
    custom ops and ``torch.autograd.Function``s all take part).  A
    floating leaf that the loss does not reach raises ``ValueError``
    naming it: a harness that lost autograd history must not train its
    parameters with a zero gradient.  Other leaves, and the top-level
    entries named in ``unread`` (which the loss does not read by
    construction), get zeros.

    The step's route on a mesh, whose collectives are autograd Functions
    that stage through the host (``launch.collectives``) and take no
    functional transform, and under ``cfg.remat``, whose
    ``torch.utils.checkpoint`` saved-tensor hooks ``torch.func`` refuses.
    Under ``torch.compile`` ``torch.autograd.grad`` is a graph break: the
    forward compiles (between the collectives) and autograd runs the
    compiled pieces' backward."""
    def run(params, batch):
        leaves, spec = pytree.tree_flatten_with_path(params)
        live = [t.detach().requires_grad_(
                    t.is_floating_point()
                    and getattr(path[0], "key", None) not in unread)
                for path, t in leaves]
        loss = loss_fn(pytree.tree_unflatten(live, spec), batch)
        wrt = [t for t in live if t.requires_grad]
        got = iter(_autograd_grad(loss, wrt))
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


def batch_pspec(rules) -> S.PSpec:
    return (rules.get("batch", "data"), None)


def storage_pspecs(model: Model):
    """Each parameter's storage partition spec at ``cfg.mesh_axis_sizes``
    (None off the mesh)."""
    cfg = model.cfg
    if not cfg.spmd_constraints:
        return None
    sizes = T._axis_sizes(cfg)
    return S.tree_pspecs(model.spec, sizes, T._storage_rules(sizes))


def _grad_constraint(grads, specs):
    """Each rank's gradient of a leaf it holds replicated over a mesh axis
    is a partial sum there (``launch.collectives``): sum it over the axes
    that the leaf's storage does not shard."""
    if specs is None:
        return grads
    names = C.current_mesh().mesh_dim_names

    def fix(g, ps):
        used = {a for e in ps for a in S.pspec_axes(e)}
        return C.psum(g, tuple(a for a in names if a not in used))
    with torch.no_grad():
        return pytree.tree_map(fix, grads, specs)


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
    entry bakes (docs/transforms.md); it runs on one device.

    On a mesh the step takes the rank's shards of params, opt_state and
    the batch, and returns the rank's shards."""
    mb = max(1, model.cfg.microbatches)
    specs = storage_pspecs(model)
    if lilac_grad and specs is not None:
        raise ValueError("lilac_grad compiles a one-device step")
    if lilac_grad:
        from repro_torch import lilac

        compiled = lilac.compile(torch.func.grad_and_value(model.loss_fn),
                                 **(lilac_options or {}))

        def vg(params, batch):
            grads, loss = compiled(params, batch)
            return loss, grads
    else:
        # a stub frontend's training reads embeddings, not the token table
        # its decode keeps (the reference gives the table a zero gradient)
        unread = ("embed",) if model.cfg.frontend == "stub" else ()
        vg = (ValueAndGrad if specs is None and not model.cfg.remat
              else value_and_grad)(model.loss_fn, unread=unread)

    def train_step(params, opt_state, batch):
        if mb == 1:
            loss, grads = vg(params, batch)
            grads = _grad_constraint(grads, specs)
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
                                        _grad_constraint(g_i, specs))
                loss = loss + loss_i
            loss = loss / mb
            grads = pytree.tree_map(lambda g: g / mb, grads)
        if specs is not None:
            loss = C.psum(loss, tuple(C.current_mesh().mesh_dim_names))
        new_params, new_state, metrics = O.adamw_update(
            opt_cfg, grads, opt_state, params, mesh_specs=specs)
        return new_params, new_state, dict(metrics, loss=loss)

    # a step that traces as one graph (torch.func's gradient; a Python
    # loop over the microbatches unrolls), and what a compiled caller runs
    # before its first call (train.loop)
    train_step.one_graph = isinstance(vg, ValueAndGrad)
    if train_step.one_graph:
        train_step.check_gradients = vg.check
    return train_step


def make_serve_step(model: Model, kind: str):
    """The prefill step ``(params, batch) -> (logits, caches)`` or the
    decode step ``(params, cache, tokens, pos) -> (logits, cache)``."""
    if kind == "prefill":
        return model.prefill
    if kind == "decode":
        return model.decode
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Sharding trees
# ---------------------------------------------------------------------------

def param_shardings(model: Model, mesh, rules):
    return S.tree_shardings(model.spec, mesh, rules)


def opt_state_shardings(model: Model, opt_cfg: O.AdamWConfig, mesh, rules):
    """The optimizer state at the parameters' placements (``err`` too,
    under ``compress_grads``); ``step`` replicated."""
    ps = param_shardings(model, mesh, rules)
    tree = {"step": S.NamedSharding(mesh, ()), "mu": ps, "nu": ps,
            "master": ps}
    if opt_cfg.compress_grads:
        tree["err"] = ps
    return tree


def _leaf_name(path) -> str:
    return str(getattr(path[-1], "key", "")) if path else ""


def prefill_cache_shardings(model: Model, shape: ShapeConfig, mesh, rules):
    """The prefill's stacked caches (``Model.prefill_cache_specs``): the
    batch dim over the batch axes, and a k/v cache's sequence dim over
    the model axis where it divides (32k x many-layer caches would not
    fit replicated)."""
    b = rules.get("batch", "data")
    msize = S.mesh_axis_sizes(mesh).get("model", 1)

    def shard(path, leaf):
        entries = [None] * leaf.dim()
        if leaf.dim() >= 2 and leaf.shape[1] == shape.global_batch:
            entries[1] = b
        if _leaf_name(path) in ("k", "v") and leaf.dim() == 5 \
                and leaf.shape[2] % msize == 0:
            entries[2] = "model"
        return S.NamedSharding(mesh, tuple(entries))

    return pytree.tree_map_with_path(shard,
                                     model.prefill_cache_specs(shape))


def batch_shardings(model: Model, shape: ShapeConfig, mesh, rules):
    """The sharding tree of ``model.input_specs(shape)``: the batch over
    the batch axes; a decode cache's batch too where the batch axes
    divide it (else its sequence dim), k/v over the model axis by kv
    heads (or, with ``decode_cache_seq_shard``, an MQA cache by
    sequence), a Mamba state and conv tail by their inner dim and an RWKV
    state by heads."""
    b = rules.get("batch", "data")
    sizes = S.mesh_axis_sizes(mesh)
    tok = S.NamedSharding(mesh, (b, None))
    cfg = model.cfg
    if shape.kind in ("train", "prefill"):
        out = ({"embeds": S.NamedSharding(mesh, (b, None, None))}
               if cfg.frontend == "stub" else {"tokens": tok})
        if shape.kind == "train":
            out["labels"] = tok
        return out
    if shape.kind != "decode":
        raise ValueError(shape.kind)
    dsize = 1
    for a in S.pspec_axes(b):
        dsize *= sizes[a]
    msize = sizes.get("model", 1)
    batch_ok = shape.global_batch % dsize == 0
    b_entry = b if batch_ok else None

    def cache_shard(path, leaf):
        name = _leaf_name(path)
        entries = [None] * leaf.dim()
        entries[0] = b_entry
        if name in ("k", "v"):              # (B, S, KV, hd)
            if not batch_ok:
                entries[1] = b              # sequence-sharded cache
            if leaf.shape[2] % msize == 0:
                entries[2] = "model"
            elif cfg.decode_cache_seq_shard and leaf.shape[1] % msize == 0:
                entries[1] = "model"        # MQA: ring-style decode
        elif name == "ssm":                 # (B, di, N)
            if leaf.shape[1] % msize == 0:
                entries[1] = "model"
        elif name == "conv":                # (B, K-1, di)
            if leaf.shape[2] % msize == 0:
                entries[2] = "model"
        elif name == "s":                   # rwkv (B, H, dh, dh)
            if leaf.shape[1] % msize == 0:
                entries[1] = "model"
        return S.NamedSharding(mesh, tuple(entries))

    return {"tokens": S.NamedSharding(mesh, (b_entry, None)),
            "pos": S.NamedSharding(mesh, ()),
            "cache": pytree.tree_map_with_path(
                cache_shard, model.init_cache(shape.global_batch,
                                              shape.seq_len, device="meta"))}
