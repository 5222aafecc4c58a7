"""LiLAC detection: backtracking search for What-computations in FX graphs.

Counterpart of ``repro.core.detect``.  The paper (§4.1) detects
computations in LLVM IR after -O2 normalization: first the control-flow
skeleton is recognized, then a backtracking search (Fig. 13) assigns the
What-program's expressions to IR values one by one.  Here:

* Normalization — ``trace`` runs ``make_fx`` over ``functionalize(fn)`` in
  fake-tensor mode: every call is inlined down to aten operators, in-place
  updates become functional ones (``index_add_`` -> ``index_add``), and no
  data moves.  ``normalize_graph`` drops dead nodes.
* Skeletons — the vectorized realization of a row loop: the scatter-add
  (``index_add`` / ``scatter_add`` / ``index_put(accumulate=True)``) of a
  gathered product for CSR/COO, the row sum of a padded product for
  ELL/JDS, the scatter-add of scaled row windows for SpMM, the
  contraction over experts of a one-hot dispatch for the MoE FFN, the
  sum of a product of two vectors (or ``aten.dot``) for a dot product, and
  ``aten.mv`` or the row sum of a matrix times a broadcast vector for a
  dense GEMV.
* Loops — ``make_fx`` unrolls a Python loop, so the counterpart of the
  reference's ``fori_loop`` skeleton is a chain of n identical statements
  on the same arrays, statement k reading element k at a literal index
  (``row[k:k+1]``, ``row[k, None]``, ``val[k]``).  ``out[row[k:k+1]] +=
  val[k] * vec[col[k:k+1]]`` from zeros (traced as get + add +
  ``index_put``, or written ``index_put_(..., accumulate=True)`` or
  ``index_add_``) matches as one COO SpMV of nnz = n, and ``acc = acc +
  a[k] * b[k]`` from zero as one dot product: ``variant="loop"``,
  anchored at the last statement, every node of the chain claimed.  A
  0-d tensor index is an integer index in PyTorch: ``out[row[k]]`` reads
  the id as a Python int, which a fake-tensor trace refuses and a
  concrete trace bakes into the graph as a constant, and such a chain is
  no sparse matrix and does not match.  Tracing costs O(n), so this form
  suits small programs, like the reference's tests.
* Scans — ``torch._higher_order_ops.scan.scan(step, init, xs)`` traces to
  one ``torch.ops.higher_order.scan(body, init, xs, additional_inputs)``
  node, its body a ``GraphModule`` whose placeholders are the carries,
  the slices of ``xs`` and the tensors the step closes over, in that
  order.  The ``fori_loop`` skeletons of the reference match on the scan
  itself (``variant="loop"``, a trace of O(1) size in nnz): the step reads
  element k of closed-over arrays as ``arr[k.reshape(1)]`` (or
  ``index_select``), k being the scan's slice of ``torch.arange(n)`` or a
  carried integer counter the step increments by one from zero, and
  ``out.index_add(0, row[k], val[k] * vec[col[k]])`` from zeros is a COO
  SpMV of nnz = n, ``acc + a[k] * b[k]`` from zero a dot product.  Any
  other scan whose body holds a match becomes one ``variant="scan_body"``
  match (``_detect_scan_bodies``): the body is detected once and the
  rewriter runs the loop around the rewritten body, so the harnesses
  selected for it serve every iteration.
* Backtracking — pattern matching is generator-based: every commutative
  operand order, alternative idiom and candidate assignment is a backtrack
  point; the first complete, semantically validated assignment wins.
* Semantic validation — the row-pointer expansion subgraph and the MoE
  dispatch subgraph are *executed* on random concrete inputs and checked
  against the What-semantics, so a structural false positive cannot
  silently corrupt results; any idiom that computes
  ``repeat_interleave(arange(rows), diff(row_ptr))`` (a ``searchsorted``,
  say) is accepted.

Every builtin computation has a matcher; a spec-registered computation
whose shape no matcher skeleton fits is listed in ``Detector.unmatchable``
and never matches.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.fx import GraphModule, Node
from torch.fx.node import map_arg

from repro_torch.core import what_lang as W
from repro_torch.core.resilience import device_fault as _device_fault

aten = torch.ops.aten


# ---------------------------------------------------------------------------
# Normalization (the -O2 analogue).
# ---------------------------------------------------------------------------

def trace(fn: Callable, args: Sequence[torch.Tensor]) -> GraphModule:
    """Trace ``fn`` on fake tensors shaped like ``args`` into a functional
    aten-level graph.  The program must not branch on tensor values.

    The trace is a fresh one even where the call is itself being traced
    or transformed (a compiled function called inside ``make_fx`` or
    ``torch.func.grad``): the ambient modes and ``torch.func`` levels are
    set aside while it runs, and it starts from fake tensors of its own
    with the arguments' shapes, strides, dtypes and devices."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.func import functionalize

    with own_trace():
        mode = FakeTensorMode()
        with mode:
            # int(): a size or stride symbolic in an outer trace is
            # specialized to this call's
            fakes = [torch.empty_strided(tuple(map(int, a.shape)),
                                         tuple(map(int, a.stride())),
                                         dtype=a.dtype,
                                         device=a.device) for a in args]
        gm = make_fx(functionalize(fn, remove="mutations_and_views"),
                     tracing_mode="fake")(*fakes)
    return normalize_graph(gm)


@contextlib.contextmanager
def own_trace():
    """A context in which operators run on real tensors, or trace a graph
    of their own, even while an outer ``make_fx`` or ``torch.func``
    transform runs (a compiled function called inside another trace): the
    fake-tensor and proxy modes and the ``torch.func`` levels are set
    aside, so semantic validation computes values and nothing is recorded
    in the outer graph."""
    from torch._functorch.pyfunctorch import \
        temporarily_clear_interpreter_stack
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes(), temporarily_clear_interpreter_stack():
        yield


def normalize_graph(gm: GraphModule) -> GraphModule:
    gm.graph.eliminate_dead_code()
    gm.recompile()
    return gm


def _val(atom):
    """The traced value (a fake tensor) of a node, or the atom itself."""
    return atom.meta.get("val") if isinstance(atom, Node) else atom


def _shape(atom) -> Optional[Tuple[int, ...]]:
    v = _val(atom)
    return tuple(v.shape) if isinstance(v, torch.Tensor) else None


def _ndim(atom) -> int:
    s = _shape(atom)
    return -1 if s is None else len(s)


def _is_int(atom) -> bool:
    v = _val(atom)
    return isinstance(v, torch.Tensor) and not v.is_floating_point() \
        and not v.is_complex() and v.dtype != torch.bool


def _nonunit_dims(shape) -> Tuple[int, ...]:
    return tuple(d for d in shape if d != 1)


# ---------------------------------------------------------------------------
# Match context: peeling, provenance, concrete evaluation.
# ---------------------------------------------------------------------------

_PASSTHROUGH = {aten._to_copy.default, aten.clone.default, aten.alias.default,
                aten.detach.default, aten.lift_fresh_copy.default}
_RESHAPES = {aten.view.default, aten._unsafe_view.default,
             aten.reshape.default, aten.squeeze.default, aten.squeeze.dim,
             aten.squeeze.dims, aten.unsqueeze.default,
             aten.view_copy.default, aten.unsqueeze_copy.default,
             aten.squeeze_copy.default, aten.squeeze_copy.dim,
             aten.squeeze_copy.dims}
# Layout-only operators an einsum decomposes into around its bmm.
_LAYOUT = _RESHAPES | {aten.permute.default, aten.permute_copy.default,
                       aten.expand.default, aten.expand_copy.default,
                       aten.clone.default, aten.alias.default}
_EXPANDS = {aten.expand.default, aten.expand_copy.default}
_ZEROS = {aten.zeros.default, aten.zeros_like.default, aten.new_zeros.default}
_FULLS = {aten.full.default: 1, aten.full_like.default: 1,
          aten.new_full.default: 2, aten.fill.Scalar: 1}


class Ctx:
    def __init__(self, gm: GraphModule):
        self.gm = gm
        self.nodes: List[Node] = list(gm.graph.nodes)
        self.index: Dict[Node, int] = {n: i for i, n in enumerate(self.nodes)}
        out = next(n for n in self.nodes if n.op == "output")
        self.outvars = set(out.all_input_nodes)
        self.log: List[str] = []
        self._peel_cache: Dict[Any, Any] = {}
        self._prov_cache: Dict[Node, Tuple[List[Node], List[Node]]] = {}
        # semantic-validation verdicts, keyed by the validator on the
        # participating nodes: one subgraph validates once
        self.validation_cache: Dict[Tuple, bool] = {}

    def prod(self, atom) -> Optional[Node]:
        """The operator that produced ``atom`` (None for graph inputs,
        constants and Python scalars)."""
        if isinstance(atom, Node) and atom.op == "call_function":
            return atom
        return None

    def sole_consumer(self, node: Node) -> Optional[Node]:
        """The unique consumer of ``node``, or None when it is consumed
        more than once or escapes as a function output."""
        if node in self.outvars:
            return None
        users = list(node.users)
        return users[0] if len(users) == 1 else None

    def peel(self, atom):
        """See through semantics-preserving wrappers: dtype/device copies,
        clones, aliases and reshapes that keep the non-unit dims."""
        if not isinstance(atom, Node):
            return atom
        cached = self._peel_cache.get(atom)
        if cached is not None:
            return cached
        out = atom
        while True:
            n = self.prod(out)
            if n is None:
                break
            if n.target in _PASSTHROUGH:
                out = n.args[0]
                continue
            if n.target in _RESHAPES and isinstance(n.args[0], Node) \
                    and _nonunit_dims(_shape(n.args[0]) or ()) \
                    == _nonunit_dims(_shape(n) or ()):
                out = n.args[0]
                continue
            if n.target in _EXPANDS and isinstance(n.args[0], Node) \
                    and _shape(n.args[0]) == _shape(n):
                # an expand to the operand's own shape (autograd's
                # backward of a gather writes one)
                out = n.args[0]
                continue
            break
        self._peel_cache[atom] = out
        return out

    def is_zeros(self, atom) -> bool:
        atom = self.peel(atom)
        if isinstance(atom, (int, float)):
            return atom == 0
        n = self.prod(atom)
        if n is not None:
            if n.target in _ZEROS:
                return True
            if n.target in _FULLS:
                return n.args[_FULLS[n.target]] == 0
            if n.target == aten.expand.default:
                return self.is_zeros(n.args[0])
            return False
        if isinstance(atom, Node) and atom.op == "get_attr":
            with own_trace():
                return bool(torch.all(getattr(self.gm, atom.target) == 0))
        return False

    # -- provenance ----------------------------------------------------------

    def provenance(self, atom: Node) -> Tuple[List[Node], List[Node]]:
        """Transitive producer closure: (leaf nodes [inputs / constants],
        operators in graph order)."""
        cached = self._prov_cache.get(atom)
        if cached is not None:
            return cached
        ops: Dict[int, Node] = {}
        leaves: List[Node] = []
        stack, seen = [atom], set()
        while stack:
            a = stack.pop()
            if a in seen:
                continue
            seen.add(a)
            if self.prod(a) is None:
                leaves.append(a)
                continue
            ops[self.index[a]] = a
            stack.extend(a.all_input_nodes)
        out = (leaves, [ops[i] for i in sorted(ops)])
        self._prov_cache[atom] = out
        return out

    def eval_subgraph(self, out: Node, leaf_values: Dict[Node, Any]):
        """Concretely evaluate the provenance subgraph of ``out`` given
        values for its leaves — the semantic validation step (the
        validators run it under :func:`own_trace`).  The given values cut
        the subgraph: what only feeds them is not evaluated."""
        env: Dict[Node, Any] = dict(leaf_values)
        ops: Dict[int, Node] = {}
        stack = [out]
        while stack:
            a = stack.pop()
            if a in env or self.index[a] in ops:
                continue
            if self.prod(a) is None:
                if a.op != "get_attr":
                    raise KeyError(f"no value for leaf {a}")
                env[a] = getattr(self.gm, a.target)
                continue
            ops[self.index[a]] = a
            stack.extend(a.all_input_nodes)
        for n in (ops[i] for i in sorted(ops)):
            args = map_arg(n.args, env.__getitem__)
            kwargs = map_arg(n.kwargs, env.__getitem__)
            env[n] = n.target(*args, **kwargs)
        return env[out]


# ---------------------------------------------------------------------------
# Pattern combinators (generator-based backtracking — Fig. 13).
# ---------------------------------------------------------------------------

class Pat:
    def match(self, ctx: Ctx, atom, env: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
        raise NotImplementedError


class B(Pat):
    """Bind the (peeled) atom to a name; if already bound, require identity."""

    def __init__(self, name: str, pred: Optional[Callable] = None):
        self.name = name
        self.pred = pred

    def match(self, ctx, atom, env):
        a = ctx.peel(atom)
        if self.pred is not None and not self.pred(ctx, a):
            return
        if self.name in env:
            if env[self.name] is a:
                yield env
            return
        e2 = dict(env)
        e2[self.name] = a
        ctx.log.append(f"  bind {self.name} := {a}")
        yield e2


class AnyP(Pat):
    def match(self, ctx, atom, env):
        yield env


class P(Pat):
    """Match the producing operator of the atom; operand patterns apply to
    its positional arguments."""

    def __init__(self, targets, *operands: Pat,
                 params: Optional[Callable[[Node], bool]] = None,
                 peel: bool = True):
        self.targets = set(targets) if isinstance(targets, (set, tuple, list)) \
            else {targets}
        self.operands = operands
        self.params = params
        self.do_peel = peel

    def match(self, ctx, atom, env):
        a = ctx.peel(atom) if self.do_peel else atom
        n = ctx.prod(a)
        if n is None or n.target not in self.targets:
            return
        if self.params is not None and not self.params(n):
            return
        if len(n.args) < len(self.operands):
            return

        def rec(i, e):
            if i == len(self.operands):
                yield e
                return
            for e2 in self.operands[i].match(ctx, n.args[i], e):
                yield from rec(i + 1, e2)

        yield from rec(0, env)


class Comm(Pat):
    """Commutative binary op: try both operand orders (backtrack point)."""

    def __init__(self, targets, p1: Pat, p2: Pat):
        self.targets = set(targets) if isinstance(targets, (set, tuple, list)) \
            else {targets}
        self.p1, self.p2 = p1, p2

    def match(self, ctx, atom, env):
        n = ctx.prod(ctx.peel(atom))
        if n is None or n.target not in self.targets or len(n.args) != 2:
            return
        x, y = n.args
        for first, second in ((x, y), (y, x)):
            ctx.log.append(f"  try {n.target}({first},{second})")
            for e1 in self.p1.match(ctx, first, env):
                yield from self.p2.match(ctx, second, e1)
            ctx.log.append("  backtrack")


class Alt(Pat):
    def __init__(self, *pats: Pat):
        self.pats = pats

    def match(self, ctx, atom, env):
        for p in self.pats:
            yield from p.match(ctx, atom, env)


class Gather1D(Pat):
    """vec[idx] on a 1-D vector (any index rank): ``aten.index`` with one
    index tensor, or ``index_select`` along dim 0."""

    def __init__(self, arr: Pat, idx: Pat):
        self.arr, self.idx = arr, idx

    def match(self, ctx, atom, env):
        n = ctx.prod(ctx.peel(atom))
        if n is None:
            return
        if n.target == aten.index.Tensor:
            indices = n.args[1]
            if len(indices) != 1 or indices[0] is None:
                return
            arr, idx = n.args[0], indices[0]
        elif n.target == aten.index_select.default and n.args[1] == 0:
            arr, idx = n.args[0], n.args[2]
        else:
            return
        if _ndim(arr) != 1:
            return
        for e in self.arr.match(ctx, arr, env):
            yield from self.idx.match(ctx, idx, e)


# ---------------------------------------------------------------------------
# Match result
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Match:
    computation: str          # What-program name
    variant: str              # 'vectorized' | 'loop' (an unrolled chain)
    format: str               # CSR / COO / ELL / JDS
    anchor: Node              # the node whose value the harness replaces
    binding: Dict[str, Any]   # What-name -> graph node or Python number
    notes: str = ""
    claimed: Tuple[Node, ...] = ()  # extra nodes covered by this match
    # Detected fused epilogue covering the consumer chain of the core
    # computation: 'relu' | 'silu' (activation, possibly after a bias add
    # bound as binding['bias']) | 'none' (bias only) | None (no epilogue).
    # The anchor is then the *final* epilogue node.
    epilogue: Optional[str] = None
    # For variant='scan_body': (normalized body GraphModule, inner
    # matches), the body detected once; the anchor is the scan node and
    # the inner bindings name the body's placeholders.
    body: Optional[Tuple[GraphModule, List["Match"]]] = None

    def __repr__(self):
        names = {k: (v if isinstance(v, (int, float)) else str(v))
                 for k, v in self.binding.items()}
        ep = f" +{self.epilogue}" if self.epilogue else ""
        return (f"Match({self.computation}/{self.format} [{self.variant}]"
                f"{ep} @ {self.anchor} {names})")


def out_like(m) -> Any:
    """The traced value a match's harness output stands for: its anchor's,
    or, for a loop skeleton anchored at its scan, the accumulator's (the
    scan's last carry)."""
    v = m.anchor.meta["val"]
    return v[-1] if isinstance(v, (tuple, list)) else v


def anchor_value(m, out) -> Any:
    """The anchor's value from the harness output ``out`` (shaped as
    :func:`out_like`): ``out`` itself, or, for a loop skeleton anchored at
    its scan, the scan's final carries: the accumulator, after the counter
    where one is carried (from zero, so it ends at the scan's length)."""
    v = m.anchor.meta["val"]
    if not isinstance(v, (tuple, list)):
        return out
    if len(v) == 1:
        return [out]
    length = scan_parts(m.anchor.graph.owning_module, m.anchor).length
    return [torch.full(v[0].shape, length, dtype=v[0].dtype,
                       device=out.device), out]


@dataclasses.dataclass
class DetectionReport:
    matches: List[Match]
    n_eqns: int
    log: List[str]

    def summary(self) -> str:
        lines = [f"{len(self.matches)} match(es) in {self.n_eqns} operators"]
        lines += [f"  {m!r}" for m in self.matches]
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Semantic validation
# ---------------------------------------------------------------------------

def _concretely(fn):
    """Run a validator under :func:`own_trace`: its trial tensors and its
    comparisons are real under an ambient trace too."""
    def run(*args, **kwargs):
        with own_trace():
            return fn(*args, **kwargs)
    return run


@_concretely
def _validate_row_expansion(ctx: Ctx, row_node: Node, row_ptr: Node, nnz: int,
                            rows: int, trials: int = 2) -> bool:
    """Check the subgraph row_ptr -> row_ids really is CSR row expansion:
    out == repeat(arange(rows), diff(row_ptr)) for random valid row_ptrs,
    evaluated and compared on the device the program was traced for.  A
    subgraph that fails to evaluate on another row_ptr is rejected; a
    fault of the card raises.  Verdicts are memoized per (row_node,
    row_ptr) subgraph."""
    key = ("row_expansion", row_node, row_ptr, nnz, rows)
    cached = ctx.validation_cache.get(key)
    if cached is not None:
        return cached
    proto = _val(row_ptr)
    rng = np.random.default_rng(0)
    ok = True
    for _ in range(trials):
        cuts = np.sort(rng.integers(0, nnz + 1, size=max(rows - 1, 0)))
        rp = torch.as_tensor(np.concatenate([[0], cuts, [nnz]]),
                             dtype=proto.dtype, device=proto.device)
        try:
            got = ctx.eval_subgraph(row_node, {row_ptr: rp})
        except (RuntimeError, ValueError, TypeError, IndexError) as e:
            if _device_fault(e):
                raise
            ok = False
            break
        # slot j belongs to the row whose end is the first one past j
        expect = torch.searchsorted(
            rp[1:], torch.arange(nnz, dtype=rp.dtype, device=rp.device),
            right=True)
        if not isinstance(got, torch.Tensor) or tuple(got.shape) != (nnz,) \
                or not torch.equal(got.to(expect.device, torch.int64),
                                   expect):
            ok = False
            break
    ctx.validation_cache[key] = ok
    return ok


@_concretely
def _validate_onehot_dispatch(ctx: Ctx, combine: Node, idx: Node, gate: Node,
                              n_experts: int, trials: int = 2) -> bool:
    """Check the subgraph (idx, gate) -> combine really is a top-k one-hot
    dispatch: combine[t, e] == sum_k gate[t, k] * (idx[t, k] == e) for
    random idx and gate, evaluated on the device the program was traced
    for.  The trial gates are multiples of 1/8 below 1, so the sums are
    exact in bf16 as in f32.  A subgraph that fails to evaluate is
    rejected; a fault of the card raises.  Memoized per subgraph."""
    key = ("onehot", combine, idx, gate, n_experts)
    cached = ctx.validation_cache.get(key)
    if cached is not None:
        return cached
    pi, pg = _val(idx), _val(gate)
    t, k = pi.shape
    rng = np.random.default_rng(0)
    ok = True
    for _ in range(trials):
        ti = torch.as_tensor(rng.integers(0, n_experts, size=(t, k)),
                             dtype=pi.dtype, device=pi.device)
        tg = torch.as_tensor(rng.integers(1, 8, size=(t, k)) / 8.0,
                             dtype=pg.dtype, device=pg.device)
        expect = torch.zeros((t, n_experts), dtype=torch.float32,
                             device=pg.device).scatter_add_(
            1, ti.long(), tg.float())
        try:
            got = ctx.eval_subgraph(combine, {idx: ti, gate: tg})
        except (RuntimeError, ValueError, TypeError, IndexError) as e:
            if _device_fault(e):
                raise
            ok = False
            break
        if not isinstance(got, torch.Tensor) \
                or tuple(got.shape) != (t, n_experts) \
                or not torch.equal(got.float(), expect):
            ok = False
            break
    ctx.validation_cache[key] = ok
    return ok


# ---------------------------------------------------------------------------
# Matchers, generated from What-ASTs.
# ---------------------------------------------------------------------------

def _updates_pattern_from_expr(expr: W.Expr, loopvar: str) -> Pat:
    """Compile the What reduction body into a vectorized-updates pattern:
    loads indexed by the loop variable become whole-array binds; loads
    indexed through another array become gathers (Fig. 13's assignment
    targets)."""
    if isinstance(expr, W.Mul):
        return Comm(aten.mul.Tensor,
                    _updates_pattern_from_expr(expr.lhs, loopvar),
                    _updates_pattern_from_expr(expr.rhs, loopvar))
    if isinstance(expr, W.Add):
        return Comm(aten.add.Tensor,
                    _updates_pattern_from_expr(expr.lhs, loopvar),
                    _updates_pattern_from_expr(expr.rhs, loopvar))
    if isinstance(expr, W.Load):
        idx = expr.index
        if isinstance(idx, W.Var) and idx.name == loopvar:
            return B(expr.array)                       # a[j] -> whole array
        if isinstance(idx, W.Load) and isinstance(idx.index, W.Var) \
                and idx.index.name == loopvar:
            return Gather1D(B(expr.array), B(idx.array))  # iv[colidx[j]]
        # composite index (2D padded layouts): bind the whole array; the
        # skeleton match constrains the shape.
        return B(expr.array)
    if isinstance(expr, W.Var):
        return B(expr.name)
    if isinstance(expr, W.Const):
        return AnyP()
    raise TypeError(expr)


def _range_is_ragged(rng: W.Range, outer_var: str) -> bool:
    def uses_outer_load(e: W.Expr) -> bool:
        if isinstance(e, W.Load):
            return True
        if isinstance(e, (W.Add, W.Mul)):
            return uses_outer_load(e.lhs) or uses_outer_load(e.rhs)
        return False
    return uses_outer_load(rng.lo) or uses_outer_load(rng.hi)


def _row_scatter_add(n: Node):
    """(operand, row indices, updates) of a 1-D scatter-add along dim 0 —
    ``index_add``, ``scatter_add`` or ``index_put(accumulate=True)`` — else
    None."""
    if n.target == aten.index_add.default:
        if n.args[1] != 0 or n.kwargs.get("alpha", 1) != 1 \
                or (len(n.args) > 4 and n.args[4] != 1):
            return None
        return n.args[0], n.args[2], n.args[3]
    if n.target == aten.scatter_add.default:
        if n.args[1] != 0 or _shape(n.args[2]) != _shape(n.args[3]):
            return None
        return n.args[0], n.args[2], n.args[3]
    if n.target == aten.index_put.default:
        acc = n.args[3] if len(n.args) > 3 else n.kwargs.get("accumulate", False)
        if not acc or len(n.args[1]) != 1 or n.args[1][0] is None:
            return None
        return n.args[0], n.args[1][0], n.args[2]
    return None


def _row_scatter(n: Node):
    """(operand, row indices, updates) of ``out[perm] = updates`` —
    ``index_put`` without accumulation, or ``scatter`` along dim 0."""
    if n.target == aten.index_put.default:
        acc = n.args[3] if len(n.args) > 3 else n.kwargs.get("accumulate", False)
        if acc or len(n.args[1]) != 1 or n.args[1][0] is None:
            return None
        return n.args[0], n.args[1][0], n.args[2]
    if n.target == aten.scatter.src and n.args[1] == 0:
        return n.args[0], n.args[2], n.args[3]
    return None


class Matcher:
    """A generated detection function for one What-program."""

    computation: str
    anchor_targets: frozenset = frozenset()

    def match_node(self, ctx: Ctx, node: Node) -> Optional[Match]:
        raise NotImplementedError


class RaggedRowMatcher(Matcher):
    """CSR / COO SpMV: the vectorized realization of

        forall(i) { out[i] = sum(ragged range(i)) expr(j) }

    is scatter-add(zeros, row_ids, updates).  row_ids provenance decides the
    format: a raw vector input -> COO; a validated expansion of a single
    (rows+1,) pointer vector -> CSR (binding the paper's `rowstr`)."""

    anchor_targets = frozenset({aten.index_add.default, aten.scatter_add.default,
                                aten.index_put.default})

    def __init__(self, comp: W.Computation):
        self.computation = comp.name
        stmt = comp.stmt()
        self.updates_pat = _updates_pattern_from_expr(stmt.expr, stmt.range.var)
        self.row_ptr_name = (stmt.range.lo.array
                             if isinstance(stmt.range.lo, W.Load) else "rowstr")

    def match_node(self, ctx, node):
        parts = _row_scatter_add(node)
        if parts is None:
            return None
        operand, indices, updates = parts
        if _ndim(updates) != 1 or _ndim(node) != 1 or not _is_int(indices):
            return None
        if not ctx.is_zeros(operand):
            return None
        nnz = _shape(updates)[0]
        for env in self.updates_pat.match(ctx, updates, {}):
            # every bound array is per stored entry: (nnz,)
            if any(_shape(env[k]) != (nnz,) for k in env
                   if k not in ("iv", self.row_ptr_name)):
                continue
            row_atom = ctx.peel(indices)
            rows = _shape(node)[0]
            fmt, binding = self._classify_rows(ctx, row_atom, nnz, rows, env)
            binding["rows"] = rows
            binding["nnz"] = nnz
            return Match(self.computation, "vectorized", fmt, node, binding)
        return None

    def _classify_rows(self, ctx, row_atom, nnz, rows, env):
        b = dict(env)
        if ctx.prod(row_atom) is not None:
            leaves, _ = ctx.provenance(row_atom)
            ptr_leaves = [lf for lf in leaves
                          if _shape(lf) == (rows + 1,) and _is_int(lf)]
            if len(ptr_leaves) == 1 and _validate_row_expansion(
                    ctx, row_atom, ptr_leaves[0], nnz, rows):
                b[self.row_ptr_name] = ptr_leaves[0]
                return "CSR", b
        # a raw row vector, or a derived one: COO
        b["rowidx"] = row_atom
        return "COO", b


def _is_2d(ctx, atom):
    return _ndim(atom) == 2


def _row_sum(n: Node) -> bool:
    """sum over dim 1 of a 2-D value, no keepdim, no dtype change."""
    dims = n.args[1] if len(n.args) > 1 else None
    keep = n.args[2] if len(n.args) > 2 else n.kwargs.get("keepdim", False)
    return (_ndim(n.args[0]) == 2 and dims is not None
            and [d % 2 for d in dims] == [1] and not keep
            and n.kwargs.get("dtype") is None)


class PaddedRowMatcher(Matcher):
    """ELL (and JDS, which adds a perm scatter on the output):

        forall(i) { out[i] = sum(0<=j<width) val2d[i,j]*vec[col2d[i,j]] }

    vectorized: sum(dim=1)(mul(val2d, vec[col2d]))."""

    def __init__(self, comp: W.Computation, jds: bool):
        self.computation = comp.name
        self.jds = jds
        self.anchor_targets = frozenset(
            {aten.index_put.default, aten.scatter.src} if jds
            else {aten.sum.dim_IntList})
        self.core_pat = P(
            aten.sum.dim_IntList,
            Comm(aten.mul.Tensor, B("val", pred=_is_2d),
                 Gather1D(B("vector"), B("col_ind"))),
            params=_row_sum)

    def match_node(self, ctx, node):
        if self.jds:
            # out[perm[i]] = core[i] into zeros
            parts = _row_scatter(node)
            if parts is None:
                return None
            operand, indices, updates = parts
            if not ctx.is_zeros(operand) or _ndim(node) != 1:
                return None
            for env in self.core_pat.match(ctx, updates, {}):
                if _shape(env["col_ind"]) != _shape(env["val"]):
                    continue
                env = dict(env)
                env["perm"] = ctx.peel(indices)
                env["rows"] = _shape(node)[0]
                core = ctx.prod(ctx.peel(updates))
                return Match(self.computation, "vectorized", "JDS", node, env,
                             claimed=(core,) if core is not None else ())
            return None
        for env in self.core_pat.match(ctx, node, {}):
            if _shape(env["col_ind"]) != _shape(env["val"]):
                continue        # a broadcast index is no ELL layout
            env = dict(env)
            env["rows"] = _shape(node)[0]
            return Match(self.computation, "vectorized", "ELL", node, env)
        return None


class RowScale(Pat):
    """``a[:, None]``: a 1-D array lifted to a (k, 1) column, so that it
    scales rows (a 1-D ``a`` would broadcast along the last dim)."""

    def __init__(self, inner: Pat):
        self.inner = inner

    def match(self, ctx, atom, env):
        s = _shape(atom)
        if s is None or len(s) != 2 or s[1] != 1 or _ndim(ctx.peel(atom)) != 1:
            return
        yield from self.inner.match(ctx, atom, env)


class GatherRows(Pat):
    """``dense[idx]`` on a 2-D ``dense``: rows gathered by a 1-D index
    (``aten.index`` with one index tensor, or ``index_select`` along 0)."""

    def __init__(self, arr: Pat, idx: Pat):
        self.arr, self.idx = arr, idx

    def match(self, ctx, atom, env):
        n = ctx.prod(ctx.peel(atom))
        if n is None:
            return
        if n.target == aten.index.Tensor:
            indices = n.args[1]
            if len(indices) != 1 or indices[0] is None:
                return
            arr, idx = n.args[0], indices[0]
        elif n.target == aten.index_select.default and n.args[1] == 0:
            arr, idx = n.args[0], n.args[2]
        else:
            return
        if _ndim(arr) != 2 or _ndim(idx) != 1:
            return
        for e in self.arr.match(ctx, arr, env):
            yield from self.idx.match(ctx, idx, e)


class SpmmMatcher(RaggedRowMatcher):
    """SpMM (CSR x dense matrix): the doubly-forall What-program realizes
    as the scatter-add of scaled row windows

        out = index_add(zeros(rows, n), 0, row_ids, a[:, None] * dense[colidx])

    (or ``scatter_add`` with the row ids expanded over the columns, or
    ``index_put(accumulate=True)``).  The row ids decide CSR or COO as for
    SpMV."""

    def __init__(self, comp: W.Computation):
        self.computation = comp.name
        self.row_ptr_name = "rowstr"
        self.updates_pat = Comm(aten.mul.Tensor, RowScale(B("a")),
                                GatherRows(B("dense"), B("colidx")))

    def match_node(self, ctx, node):
        parts = _row_scatter_add(node)
        if parts is None:
            return None
        operand, indices, updates = parts
        if _ndim(updates) != 2 or _ndim(node) != 2 \
                or not ctx.is_zeros(operand):
            return None
        if _ndim(indices) == 2:          # scatter_add: ids expanded over n
            ind = ctx.prod(indices)
            if ind is None or ind.target not in (aten.expand.default,
                                                 aten.expand_copy.default):
                return None
            indices = ind.args[0]
        if not _is_int(indices) or _ndim(ctx.peel(indices)) != 1:
            return None
        nnz, ncols = _shape(updates)
        rows = _shape(node)[0]
        for env in self.updates_pat.match(ctx, updates, {}):
            if _shape(env["a"]) != (nnz,) or _shape(env["colidx"]) != (nnz,):
                continue
            fmt, binding = self._classify_rows(ctx, ctx.peel(indices), nnz,
                                               rows, env)
            binding.update(rows=rows, nnz=nnz, ncols=ncols)
            return Match(self.computation, "vectorized", fmt, node, binding)
        return None


def _layout_chain(ctx: Ctx, atom) -> List[Any]:
    """``atom`` and the values under it through layout-only operators
    (views, permutes, expands, copies), down to the first other operator
    or leaf, which comes last."""
    chain = [atom]
    while True:
        n = ctx.prod(chain[-1])
        if n is None or n.target not in _LAYOUT:
            return chain
        chain.append(n.args[0])


def _contraction(ctx: Ctx, atom):
    """(left, right) operands, seen through layout operators, of the
    ``bmm`` under ``atom``, or None."""
    n = ctx.prod(_layout_chain(ctx, atom)[-1])
    if n is None or n.target != aten.bmm.default:
        return None
    return (_layout_chain(ctx, n.args[0])[-1],
            _layout_chain(ctx, n.args[1])[-1])


class MoeMatcher(Matcher):
    """The MoE expert FFN with one-hot dispatch (naive dense realization):

        combine (T,E) = einsum('tke,tk->te', onehot(idx), gate)
        g = einsum('td,edf->etf', x, wg); u = einsum('td,edf->etf', x, wu)
        y = einsum('etf,efd->etd', silu(g)*u, wd)
        out = einsum('te,etd->td', combine, y)

    An einsum traces to a ``bmm`` between layout operators, so each
    contraction is recognized by its ``bmm``, the values of the einsum's
    own shape in the layout chains around it, and the shapes of the
    weights it reaches.  A weight is a graph input or one layer's slice
    of a stacked input (``w[j]``, as a model's layer loop takes it); x,
    idx and gate may be computed in the graph (a decode step's router
    feeds them).  Anchored at the (T, D) output of the final contraction;
    the combine operand is semantically validated to be a top-k one-hot
    dispatch of (idx, gate), the (T, K) values it is computed from
    (``_routing``)."""

    anchor_targets = frozenset({aten.bmm.default})

    def __init__(self, comp: W.Computation):
        self.computation = comp.name

    @staticmethod
    def _weight(ctx, w) -> bool:
        """``w`` is a graph input, or ``w_stack[j]`` of one."""
        n = ctx.prod(w)
        return n is None or (n.target in _SELECTS and n.args[1] == 0
                             and ctx.prod(n.args[0]) is None)

    @classmethod
    def _expert_mm(cls, ctx, atom, x, w_shape):
        """The weight of einsum('td,edf->etf', x, w), or None."""
        n = ctx.prod(_layout_chain(ctx, atom)[-1])
        if n is None or n.target != aten.bmm.default:
            return None
        chains = [_layout_chain(ctx, a) for a in n.args[:2]]
        for a, w in (chains, chains[::-1]):
            if x in a and _shape(w[-1]) == w_shape \
                    and cls._weight(ctx, w[-1]):
                return w[-1]
        return None

    @staticmethod
    def _silu_arg(ctx, n: Node):
        """g for silu(g) or g * sigmoid(g), else None."""
        if n.target == aten.silu.default:
            return n.args[0]
        if n.target == aten.mul.Tensor:
            for g, sg in (n.args, n.args[::-1]):
                p = ctx.prod(sg)
                if p is not None and p.target == aten.sigmoid.default \
                        and p.args[0] is g:
                    return g
        return None

    @staticmethod
    def _x_candidates(ctx, g, T):
        """The (T, D) float values in the layout chains of the operands of
        the contraction under ``g``."""
        n = ctx.prod(_layout_chain(ctx, g)[-1])
        if n is None or n.target != aten.bmm.default:
            return []
        return [v for a in n.args[:2] for v in _layout_chain(ctx, a)
                if _ndim(v) == 2 and _shape(v)[0] == T and not _is_int(v)]

    def _match_y(self, ctx, y, T, E):
        """Binding of x, wg, wu, wd for y = einsum('etf,efd->etd',
        silu(g) * u, wd), or None."""
        ops = _contraction(ctx, y)
        if ops is None:
            return None
        for h, wd in (ops, ops[::-1]):
            hn = ctx.prod(h)
            if hn is None or hn.target != aten.mul.Tensor \
                    or _ndim(wd) != 3 or not self._weight(ctx, wd):
                continue
            _, F, D = _shape(wd)
            for sg, u in (hn.args, hn.args[::-1]):
                sn = ctx.prod(sg)
                g = None if sn is None else self._silu_arg(ctx, sn)
                if g is None:
                    continue
                for x in self._x_candidates(ctx, g, T):
                    if _shape(x) != (T, D):
                        continue
                    wg = self._expert_mm(ctx, g, x, (E, D, F))
                    wu = self._expert_mm(ctx, u, x, (E, D, F))
                    if wg is not None and wu is not None:
                        return dict(x=x, wg=wg, wu=wu, wd=wd)
        return None

    @staticmethod
    def _routing(ctx, combine, T):
        """The values ``combine`` is computed from: graph leaves and, on a
        path back from it, the first (T, K) value that is not computed
        from (T, K) values alone (in a decode step, the router's (T, 1, K)
        top-k reshaped); a (T, K) value computed from (T, K) values is
        followed to them, so ``gate * gate`` leads to ``gate``."""
        found, stack, seen = [], [combine], set()
        while stack:
            a = stack.pop()
            if a in seen:
                continue
            seen.add(a)
            n = ctx.prod(a)
            if n is None:
                found.append(a)
                continue
            ins = n.all_input_nodes
            if a is not combine and _ndim(a) == 2 and _shape(a)[0] == T \
                    and not all(_shape(i) == _shape(a) for i in ins):
                found.append(a)
                continue
            stack.extend(ins)
        return found

    def match_node(self, ctx, node):
        # the output chain: the bmm's sole consumers while they are layout
        # operators
        out_chain = [node]
        while len(out_chain[-1].users) == 1 and out_chain[-1] not in ctx.outvars:
            nxt = next(iter(out_chain[-1].users))
            if nxt.target not in _LAYOUT:
                break
            out_chain.append(nxt)
        chains = [_layout_chain(ctx, a) for a in node.args[:2]]
        for cchain, ychain in (chains, chains[::-1]):
            combine = next((c for c in cchain if _ndim(c) == 2), None)
            if combine is None:
                continue
            T, E = _shape(combine)
            y = next((v for v in ychain if _ndim(v) == 3
                      and _shape(v)[:2] == (E, T)), None)
            if y is None:
                continue
            D = _shape(y)[2]
            outs = [i for i, v in enumerate(out_chain) if _shape(v) == (T, D)]
            if not outs:
                continue
            env = self._match_y(ctx, y, T, E)
            if env is None or _shape(env["x"])[1] != D:
                continue
            leaves = [lf for lf in self._routing(ctx, combine, T)
                      if lf.op != "get_attr"]
            ints = [lf for lf in leaves if _is_int(lf)]
            floats = [lf for lf in leaves if lf not in ints]
            if len(ints) != 1 or len(floats) != 1 \
                    or _shape(ints[0]) != _shape(floats[0]) \
                    or _ndim(ints[0]) != 2 or _shape(ints[0])[0] != T:
                continue
            idx, gate = ints[0], floats[0]
            if not _validate_onehot_dispatch(ctx, combine, idx, gate, E):
                continue
            env.update(idx=idx, gate=gate, experts=E, tokens=T,
                       topk=_shape(idx)[1])
            anchor = out_chain[outs[-1]]
            return Match(self.computation, "vectorized", "MOE", anchor, env,
                         claimed=tuple(out_chain[:outs[-1]]))
        return None



def _is_1d(ctx, atom):
    return _ndim(atom) == 1


def _flat_sum(n: Node) -> bool:
    """sum over every element of a 1-D value (no dim, or dim 0), no
    keepdim, no dtype change."""
    if n.kwargs.get("dtype") is not None or _ndim(n.args[0]) != 1:
        return False
    if n.target == aten.sum.default:
        return len(n.args) < 2
    dims = n.args[1] if len(n.args) > 1 else None
    keep = n.args[2] if len(n.args) > 2 else n.kwargs.get("keepdim", False)
    return dims is not None and list(dims) in ([0], [-1]) and not keep


class DotMatcher(Matcher):
    """result = sum(i) a[i] * b[i]: the sum of a product of two vectors of
    one length (``(a * b).sum()``, ``torch.sum(a * b)``), ``aten.dot``
    (``a @ b``, ``torch.dot``, ``torch.inner``), and the loop ``acc = acc
    + a[k] * b[k]`` from zero, unrolled or as a scan (``variant="loop"``)."""

    anchor_targets = frozenset({aten.sum.default, aten.sum.dim_IntList,
                                aten.dot.default, aten.add.Tensor,
                                torch.ops.higher_order.scan})

    def __init__(self, comp: W.Computation):
        self.computation = comp.name
        self.vec_pat = Alt(
            P({aten.sum.default, aten.sum.dim_IntList},
              Comm(aten.mul.Tensor, B("a", pred=_is_1d),
                   B("b", pred=_is_1d)),
              params=_flat_sum),
            P(aten.dot.default, B("a", pred=_is_1d), B("b", pred=_is_1d)),
        )

    def match_node(self, ctx, node):
        if node.target == aten.add.Tensor:
            return _match_unrolled_dot(ctx, node, self.computation)
        if node.target is _SCAN:
            return _match_scan_dot(ctx, node, self.computation)
        if _shape(node) != ():
            return None
        for env in self.vec_pat.match(ctx, node, {}):
            if _shape(env["a"]) != _shape(env["b"]):
                continue            # a broadcast is no dot product
            env = dict(env)
            env["length"] = _shape(env["a"])[0]
            return Match(self.computation, "vectorized", "DOT", node, env)
        return None


class VecRow(Pat):
    """A 1-D vector broadcast along dim 0 of a matrix: the atom is the
    vector of the matrix's column count, as is or lifted to (1, cols)."""

    def __init__(self, inner: Pat):
        self.inner = inner

    def match(self, ctx, atom, env):
        s = _shape(atom)
        if s is None or len(s) not in (1, 2) or (len(s) == 2 and s[0] != 1) \
                or _ndim(ctx.peel(atom)) != 1:
            return
        yield from self.inner.match(ctx, atom, env)


class GemvMatcher(Matcher):
    """Dense matrix-vector product (the paper: "we fully support dense"):
    ``aten.mv`` (``m @ v``, ``torch.mv``), or the row sum of ``m * v``
    with ``v`` broadcast along dim 0."""

    anchor_targets = frozenset({aten.mv.default, aten.sum.dim_IntList})

    def __init__(self, comp: W.Computation):
        self.computation = comp.name
        self.sum_pat = P(aten.sum.dim_IntList,
                         Comm(aten.mul.Tensor, B("mat", pred=_is_2d),
                              VecRow(B("vec"))),
                         params=_row_sum)

    def match_node(self, ctx, node):
        if node.target == aten.mv.default:
            mat, vec = (a if _ndim(ctx.peel(a)) == _ndim(a) else None
                        for a in (ctx.peel(node.args[0]),
                                  ctx.peel(node.args[1])))
            if mat is None or vec is None:
                mat, vec = node.args[0], node.args[1]
            rows, cols = _shape(node.args[0])
            return Match(self.computation, "vectorized", "GEMV", node,
                         {"mat": mat, "vec": vec, "rows": rows,
                          "cols": cols})
        for env in self.sum_pat.match(ctx, node, {}):
            rows, cols = _shape(env["mat"])
            if _shape(env["vec"]) != (cols,):
                continue
            env = dict(env)
            env.update(rows=rows, cols=cols)
            return Match(self.computation, "vectorized", "GEMV", node, env)
        return None


# -- unrolled loops (the fori_loop skeleton's counterpart) -------------------

_SELECTS = {aten.select.int, aten.select_copy.int}
_SLICES = {aten.slice.Tensor, aten.slice_copy.Tensor}
_GATHERS = {aten.index.Tensor, aten.index_select.default}
_STEPS = {aten.index_put.default, aten.index_add.default,
          aten.scatter_add.default}


def _elem_load(ctx: Ctx, atom) -> Optional[Tuple[Node, int, List[Node]]]:
    """(array, k, nodes) when ``atom`` is element k of a 1-D array at a
    literal index: ``arr[k]`` (a select), ``arr[k:k+1]`` (a one-element
    slice) or ``arr[k, None]``, through reshapes.  ``nodes`` are the
    operators of the load."""
    a = ctx.peel(atom)
    n = ctx.prod(a)
    if n is None:
        return None
    if n.target in _SELECTS:
        arr, dim, k = n.args[:3]
    elif n.target in _SLICES:
        arr = n.args[0]
        dim = n.args[1] if len(n.args) > 1 else 0
        start = n.args[2] if len(n.args) > 2 else None
        end = n.args[3] if len(n.args) > 3 else None
        step = n.args[4] if len(n.args) > 4 else 1
        if not isinstance(start, int) or not isinstance(end, int) \
                or end - start != 1 or step != 1:
            return None
        k = start
    else:
        return None
    if dim != 0 or not isinstance(k, int) or _ndim(arr) != 1:
        return None
    length = _shape(arr)[0]
    nodes = [x for x in (atom, a, n) if isinstance(x, Node)
             and ctx.prod(x) is not None]
    return ctx.peel(arr), k % length if length else k, nodes


def _elem_product(ctx: Ctx, atom, gathered: bool):
    """The product at one step: ``a[k] * b[k]`` (``gathered=False``) or
    ``val[k] * vec[col[k]]`` (``gathered=True``), either order.  Returns
    (arrays, k, nodes) or None; arrays are (a, b) or (val, col, vec)."""
    n = ctx.prod(ctx.peel(atom))
    if n is None or n.target != aten.mul.Tensor or len(n.args) != 2:
        return None
    for x, y in (n.args, n.args[::-1]):
        lx = _elem_load(ctx, x)
        if lx is None:
            continue
        if not gathered:
            ly = _elem_load(ctx, y)
            if ly is None or ly[1] != lx[1]:
                continue
            return (lx[0], ly[0]), lx[1], [n] + lx[2] + ly[2]
        g = ctx.prod(ctx.peel(y))
        if g is None or g.target not in _GATHERS:
            continue
        if g.target == aten.index.Tensor:
            if len(g.args[1]) != 1 or g.args[1][0] is None:
                continue
            vec, idx = g.args[0], g.args[1][0]
        else:
            if g.args[1] != 0:
                continue
            vec, idx = g.args[0], g.args[2]
        lc = _elem_load(ctx, idx)
        if lc is None or lc[1] != lx[1] or _ndim(vec) != 1:
            continue
        return ((lx[0], lc[0], ctx.peel(vec)), lx[1],
                [n, g] + lx[2] + lc[2])
    return None


def _coo_step(ctx: Ctx, n: Node):
    """One statement ``out[row[k]] += val[k] * vec[col[k]]``: (previous
    output, (row, val, col, vec), k, nodes) or None.  Accepts the three
    forms ``make_fx`` gives: get + add + ``index_put`` (``+=`` through
    advanced indexing), ``index_put(accumulate=True)`` and ``index_add``
    (or ``scatter_add``)."""
    extra: List[Node] = []
    if n.target == aten.index_put.default:
        prev, indices, upd = n.args[:3]
        acc = n.args[3] if len(n.args) > 3 \
            else n.kwargs.get("accumulate", False)
        if len(indices) != 1 or indices[0] is None:
            return None
        idx = indices[0]
    elif n.target == aten.index_add.default:
        if n.args[1] != 0 or n.kwargs.get("alpha", 1) != 1 \
                or (len(n.args) > 4 and n.args[4] != 1):
            return None
        prev, idx, upd, acc = n.args[0], n.args[2], n.args[3], True
    elif n.target == aten.scatter_add.default and n.args[1] == 0:
        prev, idx, upd, acc = n.args[0], n.args[2], n.args[3], True
    else:
        return None
    lr = _elem_load(ctx, idx)
    if lr is None or _ndim(n) != 1 or not _is_int(idx):
        return None
    if not acc:
        # out[i] = out[i] + upd: the get must read the element it writes
        add = ctx.prod(ctx.peel(upd))
        if add is None or add.target != aten.add.Tensor \
                or add.kwargs.get("alpha", 1) != 1:
            return None
        for get, u in (add.args, add.args[::-1]):
            g = ctx.prod(ctx.peel(get))
            if g is not None and g.target == aten.index.Tensor \
                    and g.args[0] is prev and len(g.args[1]) == 1 \
                    and (_elem_load(ctx, g.args[1][0]) or ())[:2] == lr[:2]:
                extra = [x for x in (upd, ctx.peel(upd), g, get)
                         if ctx.prod(x) is not None] + [add]
                upd = u
                break
        else:
            return None
    prod = _elem_product(ctx, upd, gathered=True)
    if lr is None or prod is None or prod[1] != lr[1]:
        return None
    (val, col, vec), k, nodes = prod
    return prev, (lr[0], val, col, vec), k, [n] + extra + lr[2] + nodes


def _dot_step(ctx: Ctx, n: Node):
    """One statement ``acc = acc + a[k] * b[k]``: (previous accumulator,
    (a, b), k, nodes) or None."""
    if n.target != aten.add.Tensor or n.kwargs.get("alpha", 1) != 1 \
            or len(n.args) != 2:
        return None
    for acc, p in (n.args, n.args[::-1]):
        prod = _elem_product(ctx, p, gathered=False)
        if prod is not None:
            arrays, k, nodes = prod
            return acc, arrays, k, [n] + nodes
    return None


def _continues(ctx: Ctx, n: Node, step) -> bool:
    """``n`` is the accumulator of a later statement of the same chain:
    it is not the chain's end."""
    return any((got := step(ctx, u)) is not None and got[0] is n
               for u in n.users)


def _unrolled_chain(ctx: Ctx, anchor: Node, step):
    """Walk the statements back from ``anchor`` to the zeros the chain
    starts from.  Returns (arrays, n, nodes) when statement j reads
    element j of the same arrays for j = 0..n-1 and no intermediate value
    escapes the chain; else None."""
    if anchor.target not in _STEPS | {aten.add.Tensor} \
            or _continues(ctx, anchor, step):
        return None
    steps = []
    cur = anchor
    arrays = None
    while True:
        got = step(ctx, cur) if isinstance(cur, Node) else None
        if got is None:
            break
        prev, arrs, k, nodes = got
        if arrays is None:
            arrays = arrs
        elif any(x is not y for x, y in zip(arrs, arrays)):
            return None
        steps.append((k, nodes))
        cur = prev
        if ctx.is_zeros(cur):
            break
    if not steps or not ctx.is_zeros(cur):
        return None
    steps.reverse()
    if [k for k, _ in steps] != list(range(len(steps))):
        return None
    chain = [x for _, nodes in steps for x in nodes]
    members = set(chain)
    for _, nodes in steps[:-1]:
        out = nodes[0]
        if out in ctx.outvars or any(u not in members for u in out.users):
            return None
    return arrays, len(steps), chain


def _match_unrolled_coo(ctx: Ctx, anchor: Node, computation: str):
    got = _unrolled_chain(ctx, anchor, _coo_step)
    if got is None:
        return None
    (row, val, col, vec), nnz, chain = got
    if any(_shape(a) != (nnz,) for a in (row, val, col)) \
            or not _is_int(row) or not _is_int(col):
        return None
    binding = {"a": val, "rowidx": row, "colidx": col, "iv": vec,
               "rows": _shape(anchor)[0], "nnz": nnz}
    return Match(computation, "loop", "COO", anchor, binding,
                 notes="unrolled loop skeleton",
                 claimed=tuple(x for x in chain if x is not anchor))


def _match_unrolled_dot(ctx: Ctx, anchor: Node, computation: str):
    v = _val(anchor)
    if not isinstance(v, torch.Tensor) or v.numel() != 1:
        return None
    got = _unrolled_chain(ctx, anchor, _dot_step)
    if got is None:
        return None
    (a, b), n, chain = got
    if _shape(a) != (n,) or _shape(b) != (n,):
        return None
    return Match(computation, "loop", "DOT", anchor,
                 {"a": a, "b": b, "length": n},
                 notes="unrolled loop skeleton",
                 claimed=tuple(x for x in chain if x is not anchor))


# -- scan loops (the fori_loop skeleton on a torch scan) ---------------------

_SCAN = torch.ops.higher_order.scan
_ARANGES = {aten.arange.default, aten.arange.start, aten.arange.start_step}


@dataclasses.dataclass
class ScanParts:
    """A scan node's body and operands.  The body's placeholders are the
    carries, the slices of ``xs`` and the closed-over ``extra`` values
    (``additional_inputs``), in that order."""
    body: GraphModule
    init: List[Any]
    xs: List[Any]
    extra: List[Any]
    placeholders: List[Node]

    @property
    def operands(self) -> List[Any]:
        """The outer values in the order of the body's placeholders."""
        return self.init + self.xs + self.extra

    @property
    def length(self) -> int:
        return _shape(self.xs[0])[0]

    def outer(self, ph) -> Optional[Node]:
        """The outer node a loop-invariant placeholder (a closed-over
        tensor) stands for, else None."""
        i = self.placeholders.index(ph) if ph in self.placeholders else -1
        if i < len(self.init) + len(self.xs):
            return None
        v = self.operands[i]
        return v if isinstance(v, Node) else None


def scan_parts(gm: GraphModule, node: Node) -> Optional[ScanParts]:
    """The parts of a ``torch.ops.higher_order.scan`` node of ``gm``, or
    None when ``node`` is no scan, or its body's placeholders do not line up
    with its operands."""
    if node.op != "call_function" or node.target is not _SCAN \
            or len(node.args) < 4:
        return None
    fn, init, xs, extra = node.args[:4]
    body = getattr(gm, fn.target, None) \
        if isinstance(fn, Node) and fn.op == "get_attr" else None
    if not isinstance(body, GraphModule) or not xs:
        return None
    phs = [n for n in body.graph.nodes if n.op == "placeholder"]
    if len(phs) != len(init) + len(xs) + len(extra):
        return None
    return ScanParts(body, list(init), list(xs), list(extra), phs)


def _scan_zero(ctx: Ctx, atom) -> bool:
    """``atom`` is zeros, also through the ``detach`` that ``torch.tensor(0)``
    traces to."""
    n = ctx.prod(ctx.peel(atom))
    if n is not None and n.target == aten.detach_copy.default:
        atom = n.args[0]
    return ctx.is_zeros(atom)


def _scan_load(bctx: Ctx, parts: ScanParts, atom, counter: Node):
    """The outer array when ``atom`` is element k of a closed-over 1-D
    array at the body's counter k: ``arr[k.reshape(1)]`` (or ``k[None]``)
    or ``arr.index_select(0, k...)``; else None."""
    n = bctx.prod(bctx.peel(atom))
    if n is None:
        return None
    if n.target == aten.index.Tensor and len(n.args[1]) == 1:
        arr, idx = n.args[0], n.args[1][0]
    elif n.target == aten.index_select.default and n.args[1] == 0:
        arr, idx = n.args[0], n.args[2]
    else:
        return None
    if idx is None or bctx.peel(idx) is not counter or _ndim(arr) != 1:
        return None
    return parts.outer(arr)


def _scan_gathered(bctx: Ctx, parts: ScanParts, atom, counter: Node):
    """(vec, col) when ``atom`` is ``vec[col[k]]`` on closed-over arrays."""
    n = bctx.prod(bctx.peel(atom))
    if n is None or n.target not in _GATHERS:
        return None
    if n.target == aten.index.Tensor:
        if len(n.args[1]) != 1 or n.args[1][0] is None:
            return None
        vec, idx = n.args[0], n.args[1][0]
    elif n.args[1] == 0:
        vec, idx = n.args[0], n.args[2]
    else:
        return None
    col = _scan_load(bctx, parts, idx, counter)
    vec = parts.outer(vec) if _ndim(vec) == 1 else None
    return None if col is None or vec is None else (vec, col)


def _scan_loop(ctx: Ctx, node: Node):
    """The loop frame of a scan: (parts, body ctx, counter, accumulator in,
    accumulator out) when the scan carries an accumulator and possibly a
    counter, returns no per-step outputs, and k runs 0..length-1 (the
    slice of ``torch.arange(length)`` or a counter carried from zero and
    incremented by one); else None."""
    parts = scan_parts(ctx.gm, node)
    if parts is None:
        return None
    bctx = Ctx(parts.body)
    out = next(n for n in bctx.nodes if n.op == "output").args[0]
    ncarry = len(parts.init)
    if len(out) != ncarry or ncarry not in (1, 2):
        return None
    phs = parts.placeholders
    if ncarry == 1:
        if len(parts.xs) != 1:
            return None
        ar = ctx.prod(ctx.peel(parts.xs[0]))
        if ar is None or ar.target not in _ARANGES:
            return None
        bounds = [a for a in ar.args if isinstance(a, int)]
        if bounds not in ([parts.length], [0, parts.length],
                          [0, parts.length, 1]):
            return None
        counter = phs[1]
    else:
        counter = phs[0]
        step = bctx.prod(bctx.peel(out[0]))
        if step is None or step.target != aten.add.Tensor \
                or step.kwargs.get("alpha", 1) != 1 \
                or bctx.peel(step.args[0]) is not counter \
                or step.args[1] != 1 or not _is_int(counter) \
                or not _scan_zero(ctx, parts.init[0]):
            return None
    if not _scan_zero(ctx, parts.init[-1]):
        return None
    return parts, bctx, counter, phs[ncarry - 1], out[-1]


def _match_scan_coo(ctx: Ctx, node: Node, computation: str):
    """``out = out.index_add(0, row[k], val[k] * vec[col[k]])`` (or
    ``index_put(accumulate=True)`` / ``scatter_add``) over k = 0..nnz-1
    from zeros: one ``variant="loop"`` COO SpMV anchored at the scan."""
    frame = _scan_loop(ctx, node)
    if frame is None:
        return None
    parts, bctx, counter, acc_in, acc_out = frame
    upd = bctx.prod(bctx.peel(acc_out))
    got = _row_scatter_add(upd) if upd is not None else None
    if got is None or bctx.peel(got[0]) is not acc_in or _ndim(acc_in) != 1:
        return None
    _, indices, updates = got
    row = _scan_load(bctx, parts, indices, counter)
    prod = bctx.prod(bctx.peel(updates))
    if row is None or prod is None or prod.target != aten.mul.Tensor:
        return None
    nnz = parts.length
    for x, y in (prod.args, prod.args[::-1]):
        val = _scan_load(bctx, parts, x, counter)
        gathered = _scan_gathered(bctx, parts, y, counter)
        if val is None or gathered is None:
            continue
        vec, col = gathered
        if any(_shape(a) != (nnz,) for a in (row, val, col)) \
                or not _is_int(row) or not _is_int(col):
            return None
        binding = {"a": val, "rowidx": row, "colidx": col, "iv": vec,
                   "rows": _shape(acc_in)[0], "nnz": nnz}
        return Match(computation, "loop", "COO", node, binding,
                     notes="scan loop skeleton")
    return None


def _match_scan_dot(ctx: Ctx, node: Node, computation: str):
    """``acc = acc + a[k] * b[k]`` (or ``+ (a[k] * b[k]).sum()``) over
    k = 0..n-1 from zero: one ``variant="loop"`` dot product anchored at
    the scan."""
    frame = _scan_loop(ctx, node)
    if frame is None:
        return None
    parts, bctx, counter, acc_in, acc_out = frame
    v = _val(acc_in)
    add = bctx.prod(bctx.peel(acc_out))
    if not isinstance(v, torch.Tensor) or v.numel() != 1 or add is None \
            or add.target != aten.add.Tensor or add.kwargs.get("alpha", 1) != 1:
        return None
    n = parts.length
    for acc, p in (add.args, add.args[::-1]):
        if bctx.peel(acc) is not acc_in:
            continue
        prod = bctx.prod(bctx.peel(p))
        if prod is not None and prod.target == aten.sum.default:
            prod = bctx.prod(bctx.peel(prod.args[0]))
        if prod is None or prod.target != aten.mul.Tensor:
            continue
        a, b = (_scan_load(bctx, parts, x, counter) for x in prod.args)
        if a is None or b is None or _shape(a) != (n,) or _shape(b) != (n,):
            continue
        return Match(computation, "loop", "DOT", node,
                     {"a": a, "b": b, "length": n},
                     notes="scan loop skeleton")
    return None


class CooLoopMatcher(Matcher):
    """The COO loop ``out[row[k]] += val[k] * vec[col[k]]``, k =
    0..nnz-1, from zeros, unrolled or as a scan: one ``variant="loop"``
    COO SpMV."""

    anchor_targets = frozenset(_STEPS | {_SCAN})

    def __init__(self, comp: W.Computation):
        self.computation = comp.name

    def match_node(self, ctx, node):
        if node.target is _SCAN:
            return _match_scan_coo(ctx, node, self.computation)
        return _match_unrolled_coo(ctx, node, self.computation)


# ---------------------------------------------------------------------------
# Matcher generation (What-AST -> detection function) + top-level detect().
# ---------------------------------------------------------------------------

def generate_matcher(comp: W.Computation) -> List[Matcher]:
    """The paper generates C++ detection functions from LiLAC-What at LLVM
    build time; we generate matcher objects from the AST at import time."""
    if comp.name == "moe_ffn":
        return [MoeMatcher(comp)]
    foralls = comp.foralls()
    stmt = comp.stmt()
    if len(foralls) == 2 and _range_is_ragged(stmt.range, foralls[0].range.var):
        return [SpmmMatcher(comp)]   # doubly-parallel ragged = SpMM
    if not foralls and isinstance(stmt.target, W.Var):
        return [DotMatcher(comp)]
    if len(foralls) == 1:
        # permuted output target (JDS) takes precedence: its inner range is
        # "ragged" in the What-text (nzcnt[i]) but the vectorized
        # realization is the padded 2D layout with a perm scatter.
        if isinstance(stmt.target, W.Load) and isinstance(stmt.target.index, W.Load):
            return [PaddedRowMatcher(comp, jds=True)]
        if _range_is_ragged(stmt.range, foralls[0].range.var):
            # the loop first: a statement of an unrolled loop is itself a
            # one-element scatter-add, which the row matcher would take
            return [CooLoopMatcher(comp), RaggedRowMatcher(comp)]
        if comp.name == "gemv":
            return [GemvMatcher(comp)]
        # dense inner range with 2D loads -> padded rows
        return [PaddedRowMatcher(comp, jds=False)]
    raise NotImplementedError(f"cannot generate a matcher for {comp.name}")


# ---------------------------------------------------------------------------
# Fused-epilogue extension: grow SpMV/SpMM matches down their consumer chain
# through (+bias) -> (relu | silu), so the harness replaces the whole fused
# subgraph and the intermediate output-size arrays never round-trip memory.
# ---------------------------------------------------------------------------

_EPILOGUE_COMPS = ("spmv_csr", "spmv_coo", "spmm_csr", "spmv_ell", "spmv_jds")


def _broadcastable_to(shape, out_shape) -> bool:
    try:
        return tuple(torch.broadcast_shapes(tuple(shape), tuple(out_shape))) \
            == tuple(out_shape)
    except RuntimeError:
        return False


def _is_relu(ctx: Ctx, n: Node, cur) -> bool:
    """relu(cur), clamp_min(cur, 0), clamp(cur, 0) or maximum with zeros."""
    if n.target == aten.relu.default:
        return ctx.peel(n.args[0]) is cur
    if n.target in (aten.clamp_min.default, aten.clamp.default):
        hi = n.args[2] if len(n.args) > 2 else n.kwargs.get("max")
        return ctx.peel(n.args[0]) is cur and n.args[1] == 0 and hi is None
    if n.target == aten.maximum.default:
        x, y = n.args
        if ctx.peel(x) is cur:
            return ctx.is_zeros(y)
        if ctx.peel(y) is cur:
            return ctx.is_zeros(x)
    return False


def extend_epilogue(ctx: Ctx, m: Match) -> Match:
    """Walk the sole-consumer chain of a vectorized SpMV/SpMM match through an
    optional bias add and an optional relu/silu activation; on success,
    return a widened match anchored at the chain's last node with the
    original anchor (and intermediates) claimed.  Escaping values (several
    consumers, function outputs) stop the walk — fusing them away would
    change observable results."""
    if m.computation not in _EPILOGUE_COMPS or m.variant != "vectorized":
        return m
    cur = m.anchor
    out_shape = _shape(cur)
    claimed: List[Node] = []
    bias = None
    epilogue: Optional[str] = None
    while epilogue is None:
        if cur in ctx.outvars:
            break
        cons = list(cur.users)
        if len(cons) == 1:
            e = cons[0]
            if e.target in (aten._to_copy.default, aten.clone.default):
                claimed.append(e)
                cur = e
                continue
            if e.target == aten.add.Tensor and bias is None \
                    and e.kwargs.get("alpha", 1) == 1:
                x, y = e.args
                other = y if ctx.peel(x) is cur else (
                    x if ctx.peel(y) is cur else None)
                if other is None:
                    break
                b = ctx.peel(other)
                bshape = _shape(b) if isinstance(b, Node) else ()
                if bshape is None or not _broadcastable_to(bshape, out_shape):
                    break
                bias = b
                claimed.append(e)
                cur = e
                continue
            if _is_relu(ctx, e, cur):
                epilogue = "relu"
            elif e.target == aten.silu.default:
                epilogue = "silu"
            else:
                break
            claimed.append(e)
            cur = e
            continue
        if len(cons) == 2:
            # silu spelled out: cur feeds sigmoid(cur) and mul(cur, sigmoid)
            sig = next((e for e in cons if e.target == aten.sigmoid.default),
                       None)
            mul = next((e for e in cons if e.target == aten.mul.Tensor), None)
            if sig is None or mul is None or ctx.sole_consumer(sig) is not mul:
                break
            if {id(ctx.peel(v)) for v in mul.args} != {id(cur), id(sig)}:
                break
            epilogue = "silu"
            claimed.extend([sig, mul])
            cur = mul
            continue
        break
    if bias is None and epilogue is None:
        return m
    binding = dict(m.binding)
    if bias is not None:
        binding["bias"] = bias
    return dataclasses.replace(
        m, anchor=cur, binding=binding, epilogue=epilogue or "none",
        claimed=m.claimed + (m.anchor,) + tuple(e for e in claimed
                                                if e is not cur),
        notes=(m.notes + " " if m.notes else "") + "fused epilogue")


_DEFAULT_PRIORITY = ["moe_ffn", "spmm_csr", "spmv_csr", "spmv_jds",
                     "spmv_ell", "spmv_coo", "gemv", "dotproduct"]


class Detector:
    def __init__(self, computations: Optional[Sequence[W.Computation]] = None,
                 fuse_epilogues: bool = True):
        self.fuse_epilogues = fuse_epilogues
        if computations is not None:
            comps = list(computations)
            lenient = False
        else:
            # priority order first, then any spec-registered extras
            names = [n for n in _DEFAULT_PRIORITY if n in W.BUILTINS]
            names += [n for n in W.BUILTINS if n not in names]
            comps = [W.BUILTINS[n] for n in names]
            lenient = True
        self.matchers: List[Matcher] = []
        self.unmatchable: List[str] = []
        for c in comps:
            try:
                self.matchers.extend(generate_matcher(c))
            except NotImplementedError:
                # a computation with no matcher skeleton must not break
                # detection of everything else
                if not lenient:
                    raise
                self.unmatchable.append(c.name)

    def detect(self, gm: GraphModule) -> DetectionReport:
        ctx = Ctx(gm)
        ops = [n for n in ctx.nodes if n.op == "call_function"]
        matches: List[Match] = []
        claimed: set = set()
        # matcher-major iteration: matchers are in priority order (JDS
        # outranks its own ELL core; CSR outranks COO).
        for m in self.matchers:
            for n in ops:
                if n.target not in m.anchor_targets or n in claimed:
                    continue
                found = m.match_node(ctx, n)
                if found is not None:
                    matches.append(found)
                    claimed.add(n)
                    claimed.update(found.claimed)
        matches += self._detect_scan_bodies(ctx, claimed)
        if self.fuse_epilogues:
            matches = [extend_epilogue(ctx, m) for m in matches]
        matches.sort(key=lambda mm: ctx.index[mm.anchor])
        return DetectionReport(matches=matches, n_eqns=len(ops), log=ctx.log)

    def _detect_scan_bodies(self, ctx: Ctx, claimed: set) -> List[Match]:
        """Descend into every unclaimed scan (a solver's iterations, a
        training loop) and detect inside its body, once.  A scan whose
        body holds a match becomes one ``variant="scan_body"`` match
        carrying the normalized body and the inner matches, its binding
        the scan's operands (so their producers stay live through the
        rewrite); the rewriter runs the loop around the rewritten body, so
        the harnesses selected for the inner matches serve every
        iteration."""
        out: List[Match] = []
        for n in ctx.nodes:
            if n in claimed:
                continue
            parts = scan_parts(ctx.gm, n)
            if parts is None:
                continue
            body = normalize_graph(parts.body)
            sub = self.detect(body)
            if not sub.matches:
                continue
            binding = {f"scan_in{i}": v for i, v in enumerate(parts.operands)
                       if isinstance(v, Node)}
            out.append(Match(
                "scan_body", "scan_body", "SCAN", n, binding,
                notes=f"{len(sub.matches)} match(es) in scan body",
                body=(body, sub.matches)))
            claimed.add(n)
        return out

    def detect_fn(self, fn: Callable, *example_args) -> DetectionReport:
        return self.detect(trace(fn, example_args))


def flat_matches(matches: Sequence[Match],
                 loop_invariant: bool = False) -> List[Match]:
    """The matches with every ``scan_body`` wrapper replaced by its inner
    matches, recursively: the matches that select a harness, in the order
    the pass manager numbers them (pins, disabled matches, selections).
    With ``loop_invariant`` an inner binding that names a closed-over
    tensor of the scan names the outer node instead, so a cost model sees
    that an inner match and an outer one marshal the same matrix."""
    out: List[Match] = []
    for m in matches:
        if m.body is None:
            out.append(m)
            continue
        inner = flat_matches(m.body[1], loop_invariant)
        if loop_invariant:
            parts = scan_parts(m.anchor.graph.owning_module, m.anchor)
            inner = [dataclasses.replace(im, binding={
                k: (parts.outer(v) or v) if isinstance(v, Node) else v
                for k, v in im.binding.items()}) for im in inner]
        out.extend(inner)
    return out


_default_detector: Optional[Detector] = None


def default_detector() -> Detector:
    global _default_detector
    if _default_detector is None:
        _default_detector = Detector()
    return _default_detector


def reset_default_detector() -> None:
    """Drop the cached detector so newly spec-registered computations are
    picked up by the next ``default_detector()`` call."""
    global _default_detector
    _default_detector = None
