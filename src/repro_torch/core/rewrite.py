"""Code replacement (paper §4.1.2): splice harness calls into FX graphs.

Counterpart of ``repro.core.rewrite``.  The paper inserts a harness call
before the matched loop nest, removes the result store, and lets DCE sweep
the rest.  Two realizations, one per mode:

* host mode (``run_rewritten``) interprets the traced graph: every operator
  is run except the matched anchors, whose values come from the selected
  harness, and the operators that only fed them;
* trace mode (``rewrite_graph``) builds a new ``GraphModule`` from that
  same interpretation, traced once on the graph's fake tensors — the
  counterpart of evaluating the rewritten jaxpr under ``jax.jit``.  A
  jit-safe CUDA harness appears in it as one node of its custom op
  (``torch.ops.lilac_torch.*``), a plain-torch harness as its aten ops.

**Scans.**  A ``scan_body`` match runs the loop around its rewritten body
(the reference's ``_eval_scan_body``).  Host mode runs a plain Python
loop of ``length`` steps, each one interpreting the body on the carries,
the step's slices of ``xs`` and the closed-over tensors, and stacks the
per-step outputs.  It does not call the user-level
``torch._higher_order_ops.scan.scan``, which would compile the step with
dynamo and trace into the data plane's host-side work.  The first step
selects the harnesses, under containment as any anchor; the later steps
run them as pinned and are not validated one by one
(:class:`~repro_torch.core.resilience.SteadySteps`: their finiteness is
read once after the loop, and a failure runs the whole scan plain).  The
closed-over tensors are the same objects at every step, so a later step
gets the marshaled matrix from a :class:`~repro_torch.core.marshal.
LoopCache` without fingerprinting it, and the data plane is consulted
once a call.  Trace mode rewrites the body into
a ``GraphModule`` of its own and emits ``torch.ops.higher_order.scan`` on
it, the selected custom op inside the body.  A ``loop`` match anchored at
a scan writes its final accumulator, and the counter (``length``, from
zero) where one is carried.

**Differentiation** (docs/transforms.md).  A call whose binding holds a
tensor that requires grad (under ``.backward()`` or ``torch.func.grad``)
runs its harness with the detected epilogue unfused: the kernel without
it, ``apply_epilogue`` after it, where autograd sees the bias and the
activation.  Run on real tensors (the interpreter), a harness with a
``vjp`` clause runs inside one ``torch.autograd.Function`` per call
(:class:`HarnessCall`) whose backward is the clause's body; only the
binding values that require grad are its inputs, everything else stays
captured, so marshal sources still fingerprint.  Traced into a graph, the
harness appears as its aten ops or its custom op, whose
``torch.library.register_autograd`` formula is the same body (such a
formula serves ``.backward()``; ``torch.library`` gives it no
``setup_context`` for ``torch.func``, so a ``torch.func`` call of a
trace-mode function runs the interpreter).  A harness that would lose a
gradient raises ``ValueError`` naming the key; a gradient is never
silently ``None`` or zero.

**Batching** (``torch.func.vmap`` of a compiled function).  Either
realization runs on batched tensors as it stands: the graph's aten ops
batch, a harness's body is written out of place so that its ops batch too,
and each custom op batches through its ``register_vmap`` rule, one launch
for the batch.  :class:`HarnessCall` carries a generated vmap rule.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
from torch._C import _functorch as F
from torch.fx import GraphModule, Node
from torch.fx.node import map_arg

from repro_torch.core import levels
from repro_torch.core.detect import (Match, anchor_value, normalize_graph,
                                     out_like, own_trace, scan_parts)
from repro_torch.core.harness import CallCtx, Harness
from repro_torch.core.marshal import LoopCache
from repro_torch.core.resilience import SteadySteps
from repro_torch.kernels.common import apply_epilogue_inregister

#: The detected epilogue applied outside the harness — the unfused
#: realization, and the semantics the fused kernels must reproduce.
apply_epilogue = apply_epilogue_inregister

#: select(match, binding, ctx) -> Harness; it may set ctx.schedule/fuse
Select = Callable[[Match, Dict[str, Any], CallCtx], Harness]


def effective_fuse(harness, ctx) -> bool:
    """Whether this call applies the detected epilogue in the kernel: the
    harness must be fuse-capable (``fuse epilogue``), and then ``ctx.fuse``
    overrides its declared default, so fusion is a measured decision."""
    if not harness.fuse_epilogue:
        return False
    return True if ctx.fuse is None else bool(ctx.fuse)


def fused_bias(binding: Dict[str, Any], ctx: CallCtx):
    """The detected bias for a fuse-capable body to apply: None when the
    call's epilogue is applied after it (the unfused realization hides
    ``ctx.epilogue``), so the bias is added once."""
    return binding.get("bias") if ctx.epilogue is not None else None


def needed_nodes(gm: GraphModule, matches: List[Match]) -> frozenset:
    """The operators the rewritten program must still run: everything
    live through the function outputs or a harness binding, minus the
    replaced anchors and the operators that only fed them."""
    anchors = {m.anchor for m in matches}
    live = set()
    for m in matches:
        live.update(v for v in m.binding.values() if isinstance(v, Node))
    needed = set()
    for n in reversed(gm.graph.nodes):
        if n.op == "output":
            live.update(n.all_input_nodes)
            continue
        if n.op != "call_function" or n in anchors or n not in live:
            continue
        needed.add(n)
        live.update(n.all_input_nodes)
    return frozenset(needed)


def run_rewritten(gm: GraphModule,
                  matches: List[Match],
                  select: Select,
                  args: List[Any],
                  ctx_factory: Callable[[Match], CallCtx],
                  on_select: Optional[Callable[[Match, Harness, CallCtx],
                                               None]] = None,
                  needed: Optional[frozenset] = None,
                  contain: Optional[Callable] = None,
                  bodies: Optional[Dict[Node, Any]] = None,
                  last_use: Optional[Dict[Node, list]] = None) -> List[Any]:
    """Evaluate ``gm`` on ``args`` with matched anchors replaced by harness
    calls.  ``on_select`` observes every (match, harness, ctx) triple;
    ``needed`` and ``last_use`` are a precomputed :func:`needed_nodes`
    and ``_last_uses`` for these matches (a scan's steps share them).
    ``bodies`` maps a ``scan_body`` anchor to its rewritten body and the
    inner selections to report (trace mode: the scan is emitted as
    ``torch.ops.higher_order.scan`` on that body); a ``scan_body`` anchor
    without one runs the host loop.

    ``contain`` (a :class:`repro_torch.core.resilience.Containment`)
    selects and runs every anchor, ``(m, binding, ctx, select, attempt,
    on_select) -> out``, so a failing harness is retried with another
    candidate or escalated to ``ReferenceFallback`` instead of reaching
    the caller.  When it retries it issues ``on_select`` again for the
    same match: observers treat that as a replacement."""
    env: Dict[Node, Any] = {}
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    if len(placeholders) != len(args):
        raise ValueError(f"graph takes {len(placeholders)} tensors, "
                         f"got {len(args)}")
    env.update(zip(placeholders, args))
    anchor_map = {m.anchor: m for m in matches}
    if needed is None:
        needed = needed_nodes(gm, matches)
    if last_use is None:
        last_use = _last_uses(gm, anchor_map, needed)
    for n in gm.graph.nodes:
        if n.op == "output":
            return list(map_arg(n.args[0], env.__getitem__))
        m = anchor_map.get(n)
        if n.op == "placeholder":
            continue
        if m is not None and m.body is not None:
            env[n] = _eval_scan_body(m, env, select, ctx_factory, on_select,
                                     contain, (bodies or {}).get(n))
        elif m is not None:
            env[n] = _eval_anchor(m, env, select, ctx_factory, on_select,
                                  contain)
        elif n.op == "get_attr":
            env[n] = getattr(gm, n.target)
        elif n in needed:
            args_, kwargs_ = (map_arg(n.args, env.__getitem__),
                              map_arg(n.kwargs, env.__getitem__))
            env[n] = _view_of_copy(n, args_)(*args_, **kwargs_)
        for dead in last_use.get(n, ()):
            del env[dead]
    raise ValueError("graph has no output node")


def _last_uses(gm: GraphModule, anchor_map, needed) -> Dict[Node, list]:
    """node -> the values whose last reader it is, so that the interpreter
    frees each value once nothing evaluated later reads it (a traced
    16-layer decode step would otherwise hold every intermediate to the
    end).  The output node reads last and frees nothing."""
    last: Dict[Node, Node] = {}
    for n in gm.graph.nodes:
        m = anchor_map.get(n)
        if m is not None:
            reads = [v for v in m.binding.values() if isinstance(v, Node)]
        elif n in needed:
            reads = n.all_input_nodes
        else:
            continue
        for r in reads:
            last[r] = n
    out: Dict[Node, list] = {}
    for v, n in last.items():
        out.setdefault(n, []).append(v)
    outputs = next(n for n in reversed(gm.graph.nodes)
                   if n.op == "output").all_input_nodes
    for vs in out.values():
        vs[:] = [v for v in vs if v not in outputs]
    return out


def _view_of_copy(n: Node, args) -> Callable:
    """The operator to evaluate ``n`` with: a layer's slice of a stacked
    tensor (``select_copy`` along dim 0 of a contiguous tensor, which
    functionalization writes for ``w[j]``) is taken as the view it was in
    the program, with the same contiguous layout, instead of a copy of
    the layer's weights on every call.  The graph is functional, so
    nothing writes the stack while the view is read; a graph output
    stays a copy."""
    if n.target is torch.ops.aten.select_copy.int and args[1] == 0 \
            and isinstance(args[0], torch.Tensor) \
            and args[0].is_contiguous() and not _is_output(n):
        return torch.ops.aten.select.int
    return n.target


def _is_output(n: Node) -> bool:
    return any(u.op == "output" for u in n.users)


def _binding(m: Match, lookup) -> Dict[str, Any]:
    return {k: (lookup(v) if isinstance(v, Node) else v)
            for k, v in m.binding.items()}


def _eval_anchor(m: Match, env, select, ctx_factory, on_select,
                 contain=None):
    binding = _binding(m, env.__getitem__)
    ctx = ctx_factory(m)

    def attempt(h: Harness, c: CallCtx):
        return call_harness(h, binding, c, m.epilogue)

    if contain is not None:
        out = contain(m, binding, ctx, select, attempt, on_select)
    else:
        h = select(m, binding, ctx)
        if on_select is not None:
            on_select(m, h, ctx)
        out = attempt(h, ctx)
    return anchor_value(m, _coerce(out, out_like(m)))


def _eval_scan_body(m: Match, env, select, ctx_factory, on_select, contain,
                    rewritten=None) -> List[Any]:
    """The outputs of a ``scan_body`` match's scan: the final carries, then
    the per-step outputs stacked.  ``rewritten`` = (body graph, inner
    selections) emits the scan on the rewritten body (trace mode);
    without it the loop runs here (host mode)."""
    body, inner = m.body
    parts = scan_parts(m.anchor.graph.owning_module, m.anchor)

    def value(v):
        return env[v] if isinstance(v, Node) else v

    carry = [value(v) for v in parts.init]
    xs = [value(v) for v in parts.xs]
    extra = [value(v) for v in parts.extra]
    if rewritten is not None:
        graph, selected = rewritten
        if on_select is not None:
            for args in selected:
                on_select(*args)
        return list(torch.ops.higher_order.scan(graph, carry, xs,
                                                tuple(extra)))
    needed = needed_nodes(body, inner)
    last_use = _last_uses(body, {mm.anchor: mm for mm in inner}, needed)
    chosen: Dict[Node, tuple] = {}
    fronts: Dict[Node, LoopCache] = {}

    def loop_ctx(mm):
        ctx = ctx_factory(mm)
        if ctx.cache is not None:
            if mm.anchor not in fronts:
                fronts[mm.anchor] = LoopCache(ctx.cache)
            ctx.cache = fronts[mm.anchor]
        return ctx

    def first(mm, h, ctx):
        chosen[mm.anchor] = (h, ctx.schedule, ctx.fuse)
        if on_select is not None:
            on_select(mm, h, ctx)

    def pinned(mm, binding, ctx):
        h, ctx.schedule, ctx.fuse = chosen[mm.anchor]
        return h

    steady = SteadySteps(contain) if contain is not None else None
    ys = []
    for t in range(parts.length):
        outs = run_rewritten(body, inner, select if t == 0 else pinned,
                             carry + [x[t] for x in xs] + extra, loop_ctx,
                             on_select=first if t == 0 else None,
                             needed=needed, last_use=last_use,
                             contain=contain if t == 0 else steady)
        carry, y = outs[:len(carry)], outs[len(carry):]
        ys.append(y)
    if steady is not None:
        steady.settle()
    return carry + [torch.stack(col) for col in zip(*ys)]


def _live(v) -> bool:
    return levels.requires_grad(v)


def differentiating(binding: Dict[str, Any]) -> bool:
    """Whether a call must carry gradients: grad mode is on and a binding
    value requires grad at some level (a ``torch.func.grad`` input does
    too, and so does a batched tensor over one)."""
    return torch.is_grad_enabled() and any(map(_live, binding.values()))


def _traced(binding: Dict[str, Any]) -> bool:
    """Whether the call is being traced into a graph (fake values): the
    graph then holds the harness's own ops, not a Python Function."""
    from torch._subclasses.fake_tensor import is_fake

    return any(is_fake(v) for v in binding.values()
               if isinstance(v, torch.Tensor))


def _plain(v):
    """A ``torch.func.grad`` wrapper of a value that does not require grad,
    unwrapped to the tensor it holds: a repack may read its data.  A
    ``vmap`` level is never unwrapped: below it lies the whole batch, not
    the element, so a batched value stays batched (and a harness that
    would repack it runs once an element, ``levels.per_element``)."""
    while isinstance(v, torch.Tensor) and not v.requires_grad \
            and F.is_gradtrackingtensor(v):
        v = F.get_unwrapped(v)
    return v


class HarnessCall(torch.autograd.Function):
    """One harness call with a ``vjp`` clause as an autograd node:
    ``forward`` runs the harness, ``backward`` the clause's body.  A
    separate ``setup_context`` lets ``torch.func.grad`` / ``vjp`` compose
    with it, not only ``.backward()``; ``generate_vmap_rule`` lets
    ``torch.func.vmap`` compose with it: under a batch level ``forward``
    and ``backward`` run on the batched values, so the harness's own ops
    (or its custom op's vmap rule) batch them."""

    generate_vmap_rule = True

    @staticmethod
    def forward(run, pull, *dv):
        return run(*dv)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.pull = inputs[1]
        ctx.save_for_backward(*inputs[2:])

    @staticmethod
    def backward(ctx, ct):
        return (None, None) + ctx.pull(ctx.saved_tensors, ct)


def _call_with_vjp(h: Harness, binding: Dict[str, Any], ctx: CallCtx,
                   live: List[str]):
    """``h`` inside a :class:`HarnessCall` over the binding values in
    ``live`` (those that require grad; all must be named by its clause, or
    this raises)."""
    from repro_torch.core.spec import VJPS

    clause = h.vjp
    wrt = tuple(k for k in clause.wrt if k in live)
    stray = [k for k in live if k not in wrt]
    if stray:
        raise ValueError(
            f"harness {h.name!r}: {stray} require grad but its clause "
            f"{clause} does not differentiate them")
    body = VJPS[clause.name]
    nondiff = {k: _plain(v) for k, v in binding.items() if k not in wrt}

    def run(*dv):
        b = dict(nondiff)
        b.update(zip(wrt, (d.detach() for d in dv)))
        return h(b, ctx)

    def pull(saved, ct):
        b = {k: v for k, v in binding.items() if k not in wrt}
        b.update(zip(wrt, saved))
        grads = body(b, ctx, None, ct)
        missing = [k for k in wrt if grads.get(k) is None]
        if missing:
            raise ValueError(
                f"vjp {clause.name!r} returned no gradient for {missing} "
                f"(declared wrt: {list(clause.wrt)})")
        return tuple(grads[k].to(d.dtype) for k, d in zip(wrt, saved))

    return HarnessCall.apply(run, pull, *(binding[k] for k in wrt))


def _call_differentiable(h: Harness, binding: Dict[str, Any], ctx: CallCtx,
                         epilogue: Optional[str]):
    """The call under differentiation: the epilogue unfused (the kernel
    runs without it); on real tensors the clause's Function, else (no
    clause, or traced into a graph) autograd through the harness: its aten
    ops or its custom op's formula."""
    if ctx.epilogue is not None:
        ctx = dataclasses.replace(ctx, epilogue=None)
    live = [k for k, v in binding.items()
            if _live(v) and not (k == "bias" and epilogue is not None)]
    if h.vjp is not None and not _traced(binding):
        out = _call_with_vjp(h, binding, ctx, live) if live \
            else h({k: _plain(v) for k, v in binding.items()}, ctx)
    else:
        out = h(binding, ctx)
        if live and not levels.requires_grad(out):
            raise ValueError(
                f"harness {h.name!r} returned no gradient for {live}: its "
                f"body leaves autograd; declare a vjp clause")
    if epilogue is not None:
        out = apply_epilogue(out, binding.get("bias"), epilogue)
    return out


def call_harness(h: Harness, binding: Dict[str, Any], ctx: CallCtx,
                 epilogue: Optional[str]):
    """One harness call with the detected ``epilogue`` realized as the
    call's fusion decision says: in the kernel, or after the call; under
    differentiation always after it."""
    if ctx.differentiable or differentiating(binding):
        return _call_differentiable(h, binding, ctx, epilogue)
    fused = effective_fuse(h, ctx)
    if epilogue is not None and not fused and h.fuse_epilogue \
            and ctx.epilogue is not None:
        # a fuse-capable harness pinned unfused: the body must not see it
        ctx = dataclasses.replace(ctx, epilogue=None)
    out = h(binding, ctx)
    if epilogue is not None and not fused:
        out = apply_epilogue(out, binding.get("bias"), epilogue)
    return out


def _coerce(val: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The harness result in the dtype and shape the graph traced."""
    if val.dtype != like.dtype:
        val = val.to(like.dtype)
    if tuple(val.shape) != tuple(like.shape):
        val = val.reshape(like.shape)
    return val


def rewrite_graph(gm: GraphModule,
                  matches: List[Match],
                  select: Select,
                  ctx_factory: Callable[[Match], CallCtx],
                  on_select: Optional[Callable[[Match, Harness, CallCtx],
                                               None]] = None,
                  needed: Optional[frozenset] = None,
                  contain: Optional[Callable] = None,
                  inputs: Optional[List[Any]] = None) -> GraphModule:
    """Trace mode: the rewritten program as a new ``GraphModule`` with the
    traced graph's placeholders and outputs, traced on ``inputs`` (by
    default the placeholders' traced values; a scan body's closed-over
    integers have none).  A graph for calls that carry
    gradients is traced with ``ctx.differentiable`` set: its harnesses
    appear as they run under differentiation (epilogues unfused).

    Every match selects once, here, on the traced (fake) values of its
    binding — the autotuner, under ``policy='autotune'``, measures then —
    and the choice is pinned into the graph: each anchor becomes the
    selected harness traced in place (one custom-op node for a jit-safe
    CUDA harness), an unfused epilogue aten nodes after it, and operators
    that only fed an anchor are gone; a ``scan_body`` anchor becomes a
    ``torch.ops.higher_order.scan`` on its body rewritten the same way.  A
    harness that is not jit-safe raises: it would marshal inside the
    graph.  Under ``contain`` a
    harness that fails to trace (or traces to the wrong size) is replaced
    by the next candidate; ``on_select`` observes what was traced in.
    """
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.func import functionalize

    if not matches:
        return gm               # nothing to replace: the traced graph
    chosen: Dict[Node, tuple] = {}
    bodies: Dict[Node, tuple] = {}
    for m in matches:
        if m.body is not None:
            # the body rewritten once, its selections reported when the
            # outer trace reaches the scan
            parts = scan_parts(gm, m.anchor)
            selected: List[tuple] = []
            body = rewrite_graph(
                m.body[0], m.body[1], select, ctx_factory,
                on_select=lambda *a, s=selected: s.append(a),
                contain=contain, inputs=[
                    ph.meta.get("val", v.meta["val"] if isinstance(v, Node)
                                else v)
                    for ph, v in zip(parts.placeholders, parts.operands)])
            bodies[m.anchor] = (body, selected)
            continue
        binding = _binding(m, lambda v: v.meta["val"])
        ctx = ctx_factory(m)
        h = contain.pick(m, binding, ctx, select) if contain is not None \
            else select(m, binding, ctx)
        if not h.jit_safe:
            raise ValueError(
                f"harness {h.name!r} is host_only and cannot be traced into "
                f"a graph; compile with mode='host' to use it")
        chosen[m.anchor] = (h, ctx)

    def pinned(m, binding, ctx):
        return chosen[m.anchor][0]

    def interpret(*args):
        return run_rewritten(gm, matches, pinned, list(args),
                             lambda m: chosen[m.anchor][1],
                             on_select=on_select, needed=needed,
                             contain=contain, bodies=bodies)

    fakes = inputs if inputs is not None else [
        n.meta["val"] for n in gm.graph.nodes if n.op == "placeholder"]
    with own_trace():
        out = make_fx(functionalize(interpret, remove="mutations_and_views"),
                      tracing_mode="fake", _allow_non_fake_inputs=True)(*fakes)
    return normalize_graph(out)
