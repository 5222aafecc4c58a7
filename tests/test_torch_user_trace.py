"""A compiled function inside a user's ``torch.compile`` and ``make_fx``:
the reference's user ``jax.jit`` row (docs/transforms.md: "the rewrite
traces into the user's jit; with all selections resolved, the plan bakes
under the trace (warm-up deferred to the first concrete dispatch)").

Held against the JAX package's ``jax.jit`` of the same program on the same
seeded inputs (64 x 48, as tests/test_torch_transform_plans.py): SpMV
values and gradients within 1e-5, the MoE FFN and its weight gradients at
``FFN_TOL`` (atol 1e-4, rtol 1e-3: the port's einsums sum in another
order).  ``torch.compile`` runs with ``backend="aot_eager"`` (dynamo, then
AOT autograd's trace; no inductor build here).  Covered:

  * fault 1: a host-mode call inside ``torch.compile(g)`` raised
    ``InternalTorchDynamoError: RecursionError`` (dynamo traced the pass
    manager down to ``_RecordingCache.__getattr__``, which recursed with no
    ``_inner``); dynamo now never traces the pass manager's Python, and the
    proxy without its inner cache raises ``AttributeError``;
  * fault 4: under a real-mode ``make_fx`` a host-mode call recorded
    containment's ``isfinite(...).all()`` into the user's graph; the
    check now reads a concrete output outside the ambient modes, and a
    traced output is skipped and counted (``unread_traced``);
  * the ``fullgraph`` matrix: trace mode is one opaque node whose program
    (its ``lilac_torch::*`` node) lands in the user's graph; host mode is
    a graph break, an error under ``fullgraph=True`` that names
    ``mode='trace'`` (``cuda.bcsr`` on the CSR form, host-only, among
    them);
  * baking under a trace: a function first called inside ``make_fx(g)``
    or ``torch.compile(g)`` has a plan after the trace, and its next
    concrete call is a plan hit with no re-bake and no detection (the
    counterpart of ``tests/test_transforms.py::
    test_plan_bakes_under_user_jit_and_serves_concrete``);
  * serving into a trace, counted (``trace_serves``), or the rewritten
    graph / interpreter when no plan can serve (``traced_calls``); a
    host-mode marshaling harness under a trace runs its match as the plain
    program for the call, quarantines nothing and bakes nothing;
  * an in-place edit of the matrix between two calls of the compiled step
    (host mode through the graph break, trace mode in the graph);
  * ``torch.library.opcheck`` on the CPU path of the four custom ops (all
    four of its checks hold for each: none is waived);
  * gradients through a trace-mode call inside ``torch.compile``, through
    the ops' registered formulas;
  * the OLMoE block (``moe_block(impl="lilac")``, the compiled MoE under
    ``torch.func.vmap``) inside ``torch.compile(fullgraph=True)``;
  * a compiled step called at a second size (``torch.compile``'s dynamic
    retrace), each size specialized and held against ``jax.jit``;
  * a dispatch mode that only watches (``FlopCounterMode``) is no trace;
  * ``LilacFunction.report_for`` against the reference's.
"""
import copy
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._dynamo.testing import AotEagerAndRecordGraphs
from torch.fx.experimental.proxy_tensor import make_fx

from repro import lilac as jlilac
from repro.models import layers as jlayers
from repro.models.layers import _moe_naive_2d as jmoe_naive_2d
from repro.sparse import random_csr
from repro_torch import lilac
from repro_torch.core import faults
from repro_torch.core import plan as P
from repro_torch.core import resilience as R
from repro_torch.core.marshal import DataPlane, MarshalPolicy
from repro_torch.core.resilience import (LilacContainmentWarning,
                                         reset_shared_quarantine)
from repro_torch.kernels.bsr_spmm import ops as bsr_ops
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.spmv_ell import ops as ell_ops
from repro_torch.models import layers as tlayers
from repro_torch.sparse import convert as tconvert
from repro_torch.sparse import formats as tf

ROWS, COLS, NVEC = 64, 48, 5
TOL = dict(atol=1e-5, rtol=1e-5)
FFN_TOL = dict(atol=1e-4, rtol=1e-3)
OPS = {"spmv_ell": torch.ops.lilac_torch.spmv_ell.default,
       "spmv_ell_layout": torch.ops.lilac_torch.spmv_ell_layout.default,
       "bsr_spmm": torch.ops.lilac_torch.bsr_spmm.default,
       "moe_ffn": torch.ops.lilac_torch.moe_ffn.default}
aten = torch.ops.aten
#: what an ``isfinite(...).all()`` decomposes into under ``make_fx``
VALIDATOR_OPS = {aten.isfinite.default, aten.all.default, aten.abs.default,
                 aten.ne.Scalar, aten.eq.Tensor, aten.logical_and.default}


@pytest.fixture(autouse=True)
def _own_store(tmp_path, monkeypatch):
    # containment's store in this test's directory, no ambient chaos plan
    # and no shadow checks; dynamo's caches cleared, so that no compiled
    # step of another test serves this one's
    monkeypatch.setenv("LILAC_TORCH_QUARANTINE_CACHE",
                       str(tmp_path / "quarantine.json"))
    for k in ("LILAC_TORCH_FAULTS", "LILAC_TORCH_FAULTS_SEED",
              "LILAC_TORCH_SHADOW_RATE"):
        monkeypatch.delenv(k, raising=False)
    faults.load_env()
    reset_shared_quarantine()
    monkeypatch.setenv("LILAC_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.setenv("LILAC_TORCH_PLAN_CACHE", str(tmp_path / "plans.json"))
    torch._dynamo.reset()
    yield
    torch._dynamo.reset()


@pytest.fixture(scope="module")
def problem():
    csr = random_csr(ROWS, COLS, density=0.12, seed=7)
    vecs = np.random.default_rng(9).standard_normal(
        (NVEC, COLS)).astype(np.float32)
    j = (jnp.asarray(csr.val), jnp.asarray(csr.col_ind),
         jnp.asarray(csr.row_ptr), jnp.asarray(vecs[0]))
    t = tuple(torch.from_numpy(np.array(a)) for a in j)
    return j, t


def naive_jax(val, col, row_ptr, vec):
    row = jnp.repeat(jnp.arange(ROWS, dtype=jnp.int32), jnp.diff(row_ptr),
                     total_repeat_length=val.shape[0])
    return jax.ops.segment_sum(val * vec[col], row, num_segments=ROWS)


def naive(val, col, row_ptr, v):
    rows = row_ptr.shape[0] - 1
    row = torch.repeat_interleave(torch.arange(rows, device=val.device),
                                  torch.diff(row_ptr), output_size=val.shape[0])
    out = torch.zeros(rows, dtype=val.dtype, device=val.device)
    return out.index_add(0, row, val * v[col])


def ell_jax(val, col, vec):
    return jnp.sum(val * vec[col], axis=1)


def ell_form(val, col, v):
    return torch.sum(val * v[col], dim=1)


def _ell_arrays(j):
    """The problem's matrix as row-padded ELL arrays."""
    val, col, ptr = (np.asarray(a) for a in j[:3])
    width = int(np.diff(ptr).max())
    v = np.zeros((ROWS, width), np.float32)
    c = np.zeros((ROWS, width), np.int32)
    for r in range(ROWS):
        n = ptr[r + 1] - ptr[r]
        v[r, :n], c[r, :n] = val[ptr[r]:ptr[r + 1]], col[ptr[r]:ptr[r + 1]]
    return v, c


def _operands(problem, form):
    """(torch operands, jax operands, torch fn, jax fn) of the CSR or the
    ELL form, the vector last."""
    j, t = problem
    if form == "csr":
        return t, j, naive, naive_jax
    v, c = _ell_arrays(j)
    return ((torch.from_numpy(v), torch.from_numpy(c), t[3]),
            (jnp.asarray(v), jnp.asarray(c), j[3]), ell_form, ell_jax)


def _step(f):
    """The user's step around a compiled call: its own elementwise work."""
    return lambda *a: f(*a) * 2 + 1


def _jitted(jfn):
    """``jax.jit`` of the same step over the reference's compiled fn."""
    jfast = jlilac.compile(jfn)
    return jax.jit(lambda *a: jfast(*a) * 2 + 1)


def _targets(gm):
    return [n.target for n in gm.graph.nodes if n.op == "call_function"]


def _custom(gm):
    return [t for t in _targets(gm) if t in OPS.values()]


class _Quiet:
    """No LilacContainmentWarning and nothing quarantined inside."""

    def __enter__(self):
        self._cm = warnings.catch_warnings(record=True)
        self.caught = self._cm.__enter__()
        warnings.simplefilter("always")
        return self

    def __exit__(self, *exc):
        self._cm.__exit__(*exc)
        hits = [str(w.message) for w in self.caught
                if issubclass(w.category, LilacContainmentWarning)]
        assert not hits, hits
        assert not R.shared_quarantine().active()


# ---------------------------------------------------------------------------
# fault 1: a host-mode call inside torch.compile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warm,policy", [(False, "default"),
                                         (True, "cuda.ell")],
                         ids=["cold-default", "warm-cuda.ell"])
def test_a_host_mode_call_inside_torch_compile_returns_its_values(
        problem, warm, policy):
    """A cold host-mode function first called inside the compiled step,
    and a warm one on the marshaling harness (its plan baked by two eager
    calls): each returns ``naive(...) * 2 + 1`` within 1e-5 (it raised
    ``InternalTorchDynamoError: RecursionError``), and dynamo ran the call
    behind a graph break, so the plan served it."""
    j, t = problem
    fast = lilac.compile(naive, platform="cpu", mode="host", policy=policy)
    if warm:
        fast(*t)
        fast(*t)
    with _Quiet():
        got = torch.compile(_step(fast), backend="aot_eager")(*t)
    np.testing.assert_allclose(got.numpy(), (naive(*t) * 2 + 1).numpy(),
                               **TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(_jitted(naive_jax)(*j)), **TOL)
    info = fast.plan_info()
    assert info["baked"] == 1 and info["plan_hits"] == (2 if warm else 0)
    assert sum(info["traced_calls"].values()) == 0     # concrete calls only


def test_a_recording_proxy_without_its_inner_cache_does_not_recurse():
    """``_RecordingCache.__getattr__`` read ``self._inner`` through
    itself when the slot was unset (a copy, an unpickled proxy, dynamo's
    reconstruction): ``AttributeError`` now, and a copy works."""
    plane = DataPlane(MarshalPolicy.parse(None))
    proxy = P.recording_cache(plane, [])
    bare = object.__new__(type(proxy))
    assert not hasattr(bare, "stats")
    assert not hasattr(bare, "_inner")
    assert copy.copy(proxy).stats is plane.stats


# ---------------------------------------------------------------------------
# fault 4: containment's check in the user's graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["default", "torch.segment"])
def test_no_validator_op_enters_a_real_mode_make_fx_graph(problem, policy):
    """Under a real-mode ``make_fx`` of the step, a cold host-mode call
    validates its concrete output outside the ambient modes: the graph
    holds the program's ops (those of the uncompiled step's graph, and
    the harness's cast of its row ids) and no ``isfinite(...).all()``
    decomposition, and it computes the step."""
    j, t = problem
    fast = lilac.compile(naive, platform="cpu", mode="host", policy=policy)
    with _Quiet():
        gm = make_fx(_step(fast))(*t)
    plain = make_fx(_step(naive))(*t)
    assert not VALIDATOR_OPS & set(_targets(gm)), _targets(gm)
    # the segment harness's own ops: the program's, its row ids cast
    assert set(_targets(gm)) <= set(_targets(plain)) | {aten._to_copy.default}
    np.testing.assert_allclose(gm(*t).numpy(),
                               np.asarray(_jitted(naive_jax)(*j)), **TOL)
    assert fast.resilience_info()["containment"] == \
        R.ContainmentStats().as_dict()


def test_a_traced_output_is_not_read_and_is_counted(problem):
    """Under a fake-mode ``make_fx`` the harness output is a fake tensor:
    containment checks its size, reads nothing, and counts it."""
    j, t = problem
    fast = lilac.compile(naive, platform="cpu", mode="host")
    with _Quiet():
        gm = make_fx(_step(fast), tracing_mode="fake")(*t)
    assert not VALIDATOR_OPS & set(_targets(gm))
    assert fast.resilience_info()["unread_traced"] == 1
    np.testing.assert_allclose(gm(*t).numpy(),
                               np.asarray(_jitted(naive_jax)(*j)), **TOL)


# ---------------------------------------------------------------------------
# the fullgraph matrix
# ---------------------------------------------------------------------------

#: (form, trace-mode policy, the custom op its graph holds)
TRACE_CASES = [("csr", "default", None), ("csr", "torch.segment", None),
               ("ell", "torch.ell", None), ("ell", "cuda.ell", "spmv_ell")]
TRACE_IDS = [f"{c[0]}-{c[1]}" for c in TRACE_CASES]


@pytest.mark.parametrize("form,policy,op", TRACE_CASES, ids=TRACE_IDS)
def test_trace_mode_under_fullgraph_matches_jax_jit(problem, form, policy,
                                                    op):
    """``torch.compile(g, fullgraph=True)`` over a trace-mode call: one
    program, the call's custom-op node in AOT's forward graph beside the
    user's ops, and no validator op; within 1e-5 of ``jax.jit`` of the
    reference's compiled step; one detection."""
    ops, jops, fn, jfn = _operands(problem, form)
    fast = lilac.compile(fn, platform="cpu", policy=policy)
    rec = AotEagerAndRecordGraphs()
    with _Quiet():
        got = torch.compile(_step(fast), backend=rec, fullgraph=True)(*ops)
    np.testing.assert_allclose(got.numpy(), np.asarray(_jitted(jfn)(*jops)),
                               **TOL)
    (fw,) = rec.fw_graphs
    assert _custom(fw) == ([OPS[op]] if op else [])
    assert not VALIDATOR_OPS & set(_targets(fw))
    assert aten.mul.Tensor in _targets(fw)        # the user's own work
    assert fast.stats["detects"] == 1


@pytest.mark.parametrize("form,policy", [("csr", "default"),
                                         ("csr", "cuda.ell"),
                                         ("csr", "cuda.bcsr")],
                         ids=["csr-default", "csr-cuda.ell", "csr-cuda.bcsr"])
def test_host_mode_is_a_graph_break_that_names_trace_mode(problem, form,
                                                          policy):
    """Host mode under ``fullgraph=True``: dynamo's own graph-break error,
    its message saying to compile with ``mode='trace'``; without it the
    step breaks at the call, which runs concretely (its plan baked), and
    the answer is ``jax.jit``'s."""
    ops, jops, fn, jfn = _operands(problem, form)
    fast = lilac.compile(fn, platform="cpu", mode="host", policy=policy)
    with pytest.raises(torch._dynamo.exc.Unsupported, match="mode='trace'"):
        torch.compile(_step(fast), backend="aot_eager", fullgraph=True)(*ops)
    torch._dynamo.reset()
    with _Quiet():
        got = torch.compile(_step(fast), backend="aot_eager")(*ops)
    np.testing.assert_allclose(got.numpy(), np.asarray(_jitted(jfn)(*jops)),
                               **TOL)
    assert [n for _, n in fast.last_selections] == [
        "torch.segment" if policy == "default" else policy]
    assert fast.plan_info()["baked"] == 1


@pytest.mark.parametrize("tracing_mode", ["real", "fake"])
@pytest.mark.parametrize("case", ["ell-cuda.ell", "moe-cuda.gmm"])
def test_make_fx_graph_holds_the_selected_custom_op(problem, tracing_mode,
                                                    case):
    """Under ``make_fx`` of the step the user's graph holds the selected
    harness's ``lilac_torch::*`` node (``spmv_ell`` for ``cuda.ell`` on
    the ELL form, ``moe_ffn`` for ``cuda.gmm``) and no interpreter or
    validator op, and it computes the reference's step."""
    if case == "ell-cuda.ell":
        ops, jops, fn, jfn = _operands(problem, "ell")
        policy, op, tol = "cuda.ell", "spmv_ell", TOL
    else:
        x, gate, idx, ws = _moe_problem()
        ops = tuple(map(torch.from_numpy, (x, gate, idx, *ws)))
        jops = tuple(map(jnp.asarray, (x, gate, idx, *ws)))
        fn, jfn = tlayers._moe_naive_2d, jmoe_naive_2d
        policy, op, tol = "cuda.gmm", "moe_ffn", FFN_TOL
    fast = lilac.compile(fn, platform="cpu", policy=policy)
    with _Quiet():
        gm = make_fx(_step(fast), tracing_mode=tracing_mode)(*ops)
    assert _custom(gm) == [OPS[op]]
    assert not VALIDATOR_OPS & set(_targets(gm))
    np.testing.assert_allclose(gm(*ops).numpy(),
                               np.asarray(_jitted(jfn)(*jops)), **tol)


# ---------------------------------------------------------------------------
# baking under a trace, serving into one
# ---------------------------------------------------------------------------

def _trace_with(how, step, ops):
    """The step traced (and run) under ``how``; its output."""
    if how == "compile":
        return torch.compile(step, backend="aot_eager", fullgraph=True)(*ops)
    gm = make_fx(step, tracing_mode=how.split("-")[1])(*ops)
    return gm(*ops)


@pytest.mark.parametrize("how", ["make_fx-real", "make_fx-fake", "compile"])
@pytest.mark.parametrize("form,policy", [("csr", "default"),
                                         ("ell", "cuda.ell")],
                         ids=["csr-default", "ell-cuda.ell"])
def test_a_function_first_called_under_a_user_trace_bakes_and_serves(
        problem, how, form, policy):
    """The counterpart of the reference's
    ``test_plan_bakes_under_user_jit_and_serves_concrete``: a trace-mode
    function first called inside the user's trace has a plan after it
    (no bake error); the next concrete call is a plan hit, with no
    re-bake and no new detection; both equal ``jax.jit``'s step within
    1e-5."""
    ops, jops, fn, jfn = _operands(problem, form)
    want = np.asarray(_jitted(jfn)(*jops))
    fast = lilac.compile(fn, platform="cpu", policy=policy)
    with _Quiet():
        traced = _trace_with(how, _step(fast), ops)
        info = fast.plan_info()
        assert info["baked"] >= 1 and not info["bake_errors"], info
        assert fast.stats["detects"] == 1
        concrete = _step(fast)(*ops)
    info = fast.plan_info()
    assert info["plan_hits"] >= 1 and info["rebakes"] == 0, info
    assert fast.stats["detects"] == 1
    np.testing.assert_allclose(traced.numpy(), want, **TOL)
    np.testing.assert_allclose(concrete.numpy(), want, **TOL)


@pytest.mark.parametrize("how", ["make_fx-real", "make_fx-fake", "compile"])
def test_a_baked_plan_serves_a_later_trace_and_counts_it(problem, how):
    """Two eager calls bake the trace-mode plan; a later trace of the step
    traces the plan's program into the user's graph (``trace_serves``),
    with no detection and no re-bake."""
    ops, jops, fn, jfn = _operands(problem, "ell")
    fast = lilac.compile(fn, platform="cpu", policy="cuda.ell")
    fast(*ops)
    fast(*ops)
    assert fast.plan_info()["plan_hits"] == 1
    with _Quiet():
        got = _trace_with(how, _step(fast), ops)
    info = fast.plan_info()
    assert info["trace_serves"] >= 1 and info["rebakes"] == 0, info
    assert info["traced_calls"]["rewritten_graph"] == 0
    assert info["plans"][0]["trace_serves"] == info["trace_serves"]
    assert fast.stats["detects"] == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(_jitted(jfn)(*jops)),
                               **TOL)


@pytest.mark.parametrize("mode", ["trace", "host"])
def test_an_unplanned_traced_call_says_what_it_ran(problem, mode):
    """With baking off no plan serves the trace: trace mode traces its
    rewritten graph, host mode runs the interpreter, each counted in
    ``traced_calls``; nothing is baked."""
    ops, jops, fn, jfn = _operands(problem, "csr")
    fast = lilac.compile(fn, platform="cpu", mode=mode, bake=False)
    with _Quiet():
        gm = make_fx(_step(fast), tracing_mode="fake")(*ops)
    info = fast.plan_info()
    ran = "rewritten_graph" if mode == "trace" else "interpreter"
    assert info["traced_calls"][ran] == 1 and info["trace_serves"] == 0
    assert info["baked"] == 0
    np.testing.assert_allclose(gm(*ops).numpy(),
                               np.asarray(_jitted(jfn)(*jops)), **TOL)


@pytest.mark.parametrize("policy", ["cuda.ell", "cuda.bcsr", "torch.ell"])
def test_a_host_marshal_under_make_fx_runs_plain_for_the_call(problem,
                                                              policy):
    """A host-mode harness that marshals on the host has no concrete
    matrix under a trace: on the CPU its match runs as the plain program
    for the call (``plain_anchors``; on the card the call raises, which
    ``tests/test_torch_kernels_gpu.py`` holds), nothing is quarantined or
    baked (no bake
    error either); the next concrete call selects the harness and bakes,
    and its plan, whose layout is hoisted, never serves a later trace."""
    j, t = problem
    fast = lilac.compile(naive, platform="cpu", mode="host", policy=policy)
    with _Quiet():
        gm = make_fx(_step(fast), tracing_mode="fake")(*t)
        info = fast.plan_info()
        assert info["baked"] == 0 and not info["bake_errors"]
        assert info["traced_calls"]["plain_anchors"] == 1
        assert not _custom(gm)
        fast(*t)
        assert [n for _, n in fast.last_selections] == [policy]
        assert fast.plan_info()["baked"] == 1
        again = make_fx(_step(fast), tracing_mode="real")(*t)
    info = fast.plan_info()
    assert info["trace_serves"] == 0
    assert info["traced_calls"]["plain_anchors"] == 2
    assert not any(n.op == "get_attr" for n in again.graph.nodes)
    want = np.asarray(_jitted(naive_jax)(*j))
    np.testing.assert_allclose(gm(*t).numpy(), want, **TOL)
    np.testing.assert_allclose(again(*t).numpy(), want, **TOL)


@pytest.mark.parametrize("mode,form,policy", [("host", "csr", "cuda.ell"),
                                              ("trace", "ell", "cuda.ell")],
                         ids=["host-graph-break", "trace-in-graph"])
def test_an_in_place_edit_between_compiled_steps_is_seen(problem, mode, form,
                                                         policy):
    """``val.mul_(2)`` between two calls of the user's compiled step: host
    mode's plan guard misses behind the graph break (a repack), trace
    mode's graph reads the tensor itself; both return the edited matrix's
    step, ``jax.jit``'s within 1e-5."""
    ops, jops, fn, jfn = _operands(problem, form)
    val = ops[0].clone()
    fast = lilac.compile(fn, platform="cpu", mode=mode, policy=policy)
    step = torch.compile(_step(fast), backend="aot_eager",
                         fullgraph=mode == "trace")
    with _Quiet():
        step(val, *ops[1:])
        step(val, *ops[1:])
        val.mul_(2)
        got = step(val, *ops[1:])
    jstep = _jitted(jfn)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jstep(jops[0] * 2, *jops[1:])),
                               **TOL)
    if mode == "host":
        assert fast.cache.stats.misses == 2


def _ell_at(rows, width, cols, seed):
    """Seeded ELL operands of one size, as numpy arrays."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, width)).astype(np.float32),
            rng.integers(0, cols, (rows, width)).astype(np.int32),
            rng.standard_normal(cols).astype(np.float32))


@pytest.mark.parametrize("mode,policy", [("trace", "cuda.ell"),
                                         ("trace", "default"),
                                         ("host", "cuda.ell")])
def test_a_compiled_step_at_a_second_size_matches_jax_jit(mode, policy):
    """The same compiled step called at three sizes and back: the second
    size makes ``torch.compile`` retrace with symbolic sizes, which the
    call specializes to the call's (each size a signature: one detection
    each, and none for the size seen before); every call equals
    ``jax.jit``'s step at that size within 1e-5."""
    fast = lilac.compile(ell_form, platform="cpu", mode=mode, policy=policy)
    step = torch.compile(_step(fast), backend="aot_eager",
                         fullgraph=mode == "trace")
    jstep = _jitted(ell_jax)
    sizes = [(64, 6, 48), (80, 6, 48), (96, 7, 50), (64, 6, 48)]
    with _Quiet():
        for rows, width, cols in sizes:
            arrays = _ell_at(rows, width, cols, seed=rows)
            got = step(*map(torch.from_numpy, arrays))
            assert got.shape == (rows,)
            np.testing.assert_allclose(
                got.numpy(), np.asarray(jstep(*map(jnp.asarray, arrays))),
                **TOL)
    assert fast.stats["detects"] == 3
    assert fast.plan_info()["entries"] == 3


def test_a_mode_that_only_watches_is_not_a_trace(problem):
    """Under ``FlopCounterMode`` (a dispatch mode that records nothing) a
    host-mode call runs as under no mode: its plan serves it, and no
    call counts as traced."""
    from torch.utils.flop_counter import FlopCounterMode

    j, t = problem
    fast = lilac.compile(naive, platform="cpu", mode="host",
                         policy="cuda.ell")
    with _Quiet(), FlopCounterMode(display=False):
        fast(*t)
        got = fast(*t)
    info = fast.plan_info()
    assert info["baked"] == 1 and info["plan_hits"] == 1, info
    assert sum(info["traced_calls"].values()) == 0
    assert fast.resilience_info()["unread_traced"] == 0
    np.testing.assert_allclose(got.numpy(), naive(*t).numpy(), **TOL)


# ---------------------------------------------------------------------------
# the custom ops under dynamo and AOT; gradients through them
# ---------------------------------------------------------------------------

def _op_args(problem, name):
    """One call's arguments of each custom op on its CPU path."""
    j, t = problem
    v, c = (torch.from_numpy(a) for a in _ell_arrays(j))
    bias = torch.linspace(-1, 1, ROWS)
    csr = tf.CSR(val=t[0], col_ind=t[1], row_ptr=t[2], shape=(ROWS, COLS))
    if name == "spmv_ell":
        return (v, c, t[3], bias, None, None, "relu", 32)
    if name == "spmv_ell_layout":
        lay = ell_ops.pack_ell128(csr)
        return (lay.val, lay.col, lay.seg_ptr, lay.seg_window,
                lay.seg_offset, lay.perm, t[3], bias, lay.window, ROWS, COLS,
                "relu")
    if name == "bsr_spmm":
        pk = tconvert.csr_to_packed_bcsr(csr, (16, 16))
        return (pk.val, pk.local, pk.tile_ptr, pk.row_start, pk.col_mask,
                pk.block_col, pk.block_rowptr, t[3][:, None].contiguous(),
                bias, ROWS, COLS, 16, 16, ROWS, "row", "relu")
    x, gate, idx, ws = _moe_problem()
    return (*map(torch.from_numpy, (x, gate, idx, *ws)), 16)


@pytest.mark.parametrize("name", list(OPS))
def test_opcheck_each_custom_op(problem, name):
    """``torch.library.opcheck`` on each op's CPU path: its schema, its
    autograd registration, its fake kernel and AOT dispatch (what dynamo,
    AOT autograd and inductor rely on).  No check is waived."""
    op = {"spmv_ell": ell_ops.spmv_ell_op,
          "spmv_ell_layout": ell_ops.spmv_ell_layout_op,
          "bsr_spmm": bsr_ops.bsr_spmm_op,
          "moe_ffn": gmm_ops.moe_ffn_op}[name]
    got = torch.library.opcheck(op, _op_args(problem, name),
                                raise_exception=False)
    assert set(got.values()) == {"SUCCESS"}, got


def test_backward_through_a_trace_mode_call_inside_torch_compile(problem):
    """``.backward()`` of a loss over the compiled step: AOT differentiates
    through ``lilac_torch::spmv_ell``'s registered formula (the op's node
    in the forward graph; the backward graph holds no op of the forward),
    and the vector's gradient is ``jax.jit(jax.grad(...))``'s within
    1e-5."""
    ops, jops, fn, jfn = _operands(problem, "ell")
    fast = lilac.compile(fn, platform="cpu", policy="cuda.ell")
    jfast = jlilac.compile(jfn)
    want = jax.jit(jax.grad(
        lambda v: jnp.sum((jfast(*jops[:2], v) * 2 + 1) ** 2)))(jops[2])
    rec = AotEagerAndRecordGraphs()
    step = torch.compile(lambda a, b, v: (_step(fast)(a, b, v) ** 2).sum(),
                         backend=rec, fullgraph=True)
    vec = ops[2].clone().requires_grad_()
    with _Quiet():
        step(ops[0], ops[1], vec).backward()
    np.testing.assert_allclose(vec.grad.numpy(), np.asarray(want), **TOL)
    (fw,), (bw,) = rec.fw_graphs, rec.bw_graphs
    assert _custom(fw) == [OPS["spmv_ell"]] and not _custom(bw)
    assert fast.stats["detects"] == 1


def _moe_problem(T=32, D=8, F=16, E=4, seed=0):
    """One token group with balanced routes (token t to experts t % E and
    (t + 1) % E), so no harness drops a pair, and f32 weights."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D)).astype(np.float32)
    gate = rng.random((T, 2)).astype(np.float32)
    idx = ((np.arange(T)[:, None] + np.arange(2)[None, :]) % E).astype(
        np.int32)
    ws = [(rng.standard_normal(s) * .1).astype(np.float32)
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    return x, gate, idx, ws


def test_moe_weight_gradients_inside_torch_compile():
    """The compiled ``_moe_naive_2d`` on ``cuda.gmm`` inside
    ``torch.compile(fullgraph=True)``, differentiated with respect to the
    expert weights: ``lilac_torch::moe_ffn`` in the forward graph, and the
    output and the weights' gradients equal ``jax.jit(jax.grad(...))`` of
    the reference's compiled FFN at ``FFN_TOL``."""
    x, gate, idx, ws = _moe_problem()
    jfast = jlilac.compile(jmoe_naive_2d)

    def jloss(wg, wu, wd):
        out = jfast(jnp.asarray(x), jnp.asarray(gate), jnp.asarray(idx),
                    wg, wu, wd)
        return jnp.sum(out ** 2), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(*map(jnp.asarray, ws))
    fast = lilac.compile(tlayers._moe_naive_2d, platform="cpu",
                         policy="cuda.gmm")
    w = [torch.from_numpy(a).requires_grad_() for a in ws]
    rec = AotEagerAndRecordGraphs()

    def loss(wg, wu, wd):
        out = fast(torch.from_numpy(x), torch.from_numpy(gate),
                   torch.from_numpy(idx), wg, wu, wd)
        return (out ** 2).sum(), out

    with _Quiet():
        total, out = torch.compile(loss, backend=rec, fullgraph=True)(*w)
        total.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FFN_TOL)
    for got, want in zip(w, jgrads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   **FFN_TOL)
    assert _custom(rec.fw_graphs[0]) == [OPS["moe_ffn"]]
    assert [n for _, n in fast.last_selections] == ["cuda.gmm"]


B, S, DM, FF, E, TOPK = 3, 24, 32, 16, 8, 2


def test_the_moe_block_inside_torch_compile_fullgraph(monkeypatch):
    """``moe_block(impl="lilac")`` with its router and the residual inside
    ``torch.compile(fullgraph=True)``: the compiled MoE under
    ``torch.func.vmap`` is one ``lilac_torch::moe_ffn`` node for the B
    sequences (the op's vmap rule), detected once; the block equals the
    reference's ``jax.jit`` of ``moe_block(impl="naive")`` at ``FFN_TOL``,
    and a second compiled call detects nothing."""
    rng = np.random.default_rng(4)
    p = {"router": (rng.standard_normal((DM, E)) * .5).astype(np.float32),
         "wg": (rng.standard_normal((E, DM, FF)) * .05).astype(np.float32),
         "wu": (rng.standard_normal((E, DM, FF)) * .05).astype(np.float32),
         "wd": (rng.standard_normal((E, FF, DM)) * .05).astype(np.float32)}
    x = rng.standard_normal((B, S, DM)).astype(np.float32)
    want = jax.jit(lambda p, x: x + jlayers.moe_block(
        p, x, topk=TOPK, impl="naive")[0])(p, jnp.asarray(x))
    tp = tlayers.moe_params_from_numpy(p)
    fast = lilac.compile(tlayers._moe_naive_2d, platform="cpu",
                         policy="cuda.gmm")
    monkeypatch.setitem(tlayers._LILAC_MOE, "cpu", fast)
    rec = AotEagerAndRecordGraphs()
    step = torch.compile(
        lambda p, x: x + tlayers.moe_block(p, x, topk=TOPK,
                                           impl="lilac")[0],
        backend=rec, fullgraph=True)
    with _Quiet():
        got = step(tp, torch.from_numpy(x))
        again = step(tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFN_TOL)
    assert torch.equal(got, again)
    assert _custom(rec.fw_graphs[0]) == [OPS["moe_ffn"]]
    assert fast.stats["detects"] == 1
    assert [n for _, n in fast.last_selections] == ["cuda.gmm"]


# ---------------------------------------------------------------------------
# report_for
# ---------------------------------------------------------------------------

def _summary(report):
    return [(m.computation, m.variant, m.format, m.epilogue,
             sorted(m.binding)) for m in report.matches]


@pytest.mark.parametrize("form,mode", [("csr", "host"), ("csr", "trace"),
                                       ("ell", "trace"), ("moe", "trace")],
                         ids=["csr-host", "csr-trace", "ell", "moe"])
def test_report_for_matches_the_reference(problem, form, mode):
    """``report_for`` returns the signature's detection report without
    running the function or selecting a harness; its matches are the
    reference's ``report_for``'s for the same program and inputs."""
    if form == "moe":
        x, gate, idx, ws = _moe_problem()
        ops = tuple(map(torch.from_numpy, (x, gate, idx, *ws)))
        jops = tuple(map(jnp.asarray, (x, gate, idx, *ws)))
        fn, jfn = tlayers._moe_naive_2d, jmoe_naive_2d
    else:
        ops, jops, fn, jfn = _operands(problem, form)
    fast = lilac.compile(fn, platform="cpu", mode=mode)
    got = fast.report_for(*ops)
    want = jlilac.compile(jfn, mode=mode).report_for(*jops)
    assert _summary(got) == _summary(want) and got.matches
    assert fast.stats["detects"] == 1 and not fast.last_selections
    info = fast.plan_info()
    assert info["entries"] == 1 and info["baked"] == 0
    fast.report_for(*ops)
    assert fast.stats["detects"] == 1
