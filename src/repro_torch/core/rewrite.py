"""Code replacement (paper §4.1.2): splice harness calls into FX graphs.

Counterpart of ``repro.core.rewrite``.  The paper inserts a harness call
before the matched loop nest, removes the result store, and lets DCE sweep
the rest.  Here the rewritten program is an interpretation of the traced
graph: every operator is run except the matched anchors, whose values come
from the selected harness, and the operators that only fed them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
from torch.fx import GraphModule, Node
from torch.fx.node import map_arg

from repro_torch.core.detect import Match
from repro_torch.core.harness import CallCtx, Harness
from repro_torch.kernels.common import apply_epilogue_inregister

#: The detected epilogue applied outside the harness — the unfused
#: realization, and the semantics the fused kernels must reproduce.
apply_epilogue = apply_epilogue_inregister


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
                  select: Callable[[Match], Harness],
                  args: List[Any],
                  ctx_factory: Callable[[Match], CallCtx],
                  on_select: Optional[Callable[[Match, Harness], None]] = None,
                  needed: Optional[frozenset] = None) -> List[Any]:
    """Evaluate ``gm`` on ``args`` with matched anchors replaced by harness
    calls.  ``on_select`` observes every (match, chosen harness) pair;
    ``needed`` is a precomputed :func:`needed_nodes` for these matches."""
    env: Dict[Node, Any] = {}
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    if len(placeholders) != len(args):
        raise ValueError(f"graph takes {len(placeholders)} tensors, "
                         f"got {len(args)}")
    env.update(zip(placeholders, args))
    anchor_map = {m.anchor: m for m in matches}
    if needed is None:
        needed = needed_nodes(gm, matches)
    for n in gm.graph.nodes:
        if n.op == "output":
            return list(map_arg(n.args[0], env.__getitem__))
        m = anchor_map.get(n)
        if n.op == "placeholder":
            continue
        if m is not None:
            env[n] = _eval_anchor(m, env, select, ctx_factory, on_select)
        elif n.op == "get_attr":
            env[n] = getattr(gm, n.target)
        elif n in needed:
            env[n] = n.target(*map_arg(n.args, env.__getitem__),
                              **map_arg(n.kwargs, env.__getitem__))
    raise ValueError("graph has no output node")


def _eval_anchor(m: Match, env, select, ctx_factory, on_select):
    binding = {k: (env[v] if isinstance(v, Node) else v)
               for k, v in m.binding.items()}
    ctx = ctx_factory(m)
    h = select(m)
    if on_select is not None:
        on_select(m, h)
    out = h(binding, ctx)
    if m.epilogue is not None and not h.fuse_epilogue:
        out = apply_epilogue(out, binding.get("bias"), m.epilogue)
    return _coerce(out, m.anchor)


def _coerce(val: torch.Tensor, node: Node) -> torch.Tensor:
    """The harness result in the dtype and shape the graph traced."""
    like = node.meta["val"]
    if val.dtype != like.dtype:
        val = val.to(like.dtype)
    if tuple(val.shape) != tuple(like.shape):
        val = val.reshape(like.shape)
    return val
