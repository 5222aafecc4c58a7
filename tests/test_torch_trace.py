"""Trace mode: ``lilac.compile(fn)`` builds the rewritten ``GraphModule``
(the counterpart of the rewritten jaxpr under ``jax.jit``) and runs it.

Held against the JAX package's ``lilac.compile`` (trace mode there too) on
the same seeded inputs: the naive CSR SpMV and the naive MoE FFN.  Also:
the graph's shape (the custom-op node of a jit-safe CUDA harness, the
anchor's feeders gone, the traced placeholders), ``graph_for`` under
``torch.compile(backend="aot_eager", fullgraph=True)``, code without a
match passing through, host-only harnesses never traced in, the names in
``last_selections`` being what the graph runs, ``torch.library.opcheck``
on each custom op, and ``policy="autotune"`` pinning its winner (and its
schedule) into the graph.

Tolerances: the reference's for f32 (atol = rtol = 1e-4 for SpMV; atol
1e-4, rtol 1e-3 for the MoE FFN).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import lilac as jlilac
from repro.models import layers as jlayers
from repro.sparse import random_csr
from repro_torch import lilac
from repro_torch.core.harness import REGISTRY
from repro_torch.core.rewrite import rewrite_graph
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.spmv_ell import ops as ell_ops
from repro_torch.models import layers as tlayers
from repro_torch.sparse import formats as tf
from repro_torch.core import faults
from repro_torch.core.resilience import reset_shared_quarantine

ROWS, COLS = 96, 80
TOL = dict(atol=1e-4, rtol=1e-4)
FFN_TOL = dict(atol=1e-4, rtol=1e-3)
D, F, E, TOPK, S = 32, 48, 6, 2, 24
SPMV_OP = torch.ops.lilac_torch.spmv_ell.default
MOE_OP = torch.ops.lilac_torch.moe_ffn.default


@pytest.fixture(autouse=True)
def _own_store(tmp_path, monkeypatch):
    # containment's store in this test's directory, no ambient chaos plan
    # and no shadow checks: a quarantine must not outlive its test
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
    monkeypatch.delenv("LILAC_TORCH_AUTOTUNE_DISABLE", raising=False)
    REGISTRY.reset_autotuner()
    yield
    REGISTRY.reset_autotuner()


def naive(val, col, row_ptr, v):
    rows = row_ptr.shape[0] - 1
    row = torch.repeat_interleave(torch.arange(rows, device=val.device),
                                  torch.diff(row_ptr), output_size=val.shape[0])
    out = torch.zeros(rows, dtype=val.dtype, device=val.device)
    return out.index_add_(0, row, val * v[col])


def naive_jax(val, col, row_ptr, v):
    row = jnp.repeat(jnp.arange(ROWS, dtype=jnp.int32), jnp.diff(row_ptr),
                     total_repeat_length=val.shape[0])
    return jax.ops.segment_sum(val * v[col], row, num_segments=ROWS)


def ell_layer(val, col, vec, bias):
    return torch.relu((val * vec[col]).sum(dim=1) + bias)


def _spmv_operands():
    ref = random_csr(ROWS, COLS, density=0.08, seed=5, skew=1.0)
    v = np.random.default_rng(2).standard_normal(COLS).astype(np.float32)
    csr = tf.from_numpy(ref)
    return ref, (csr.val, csr.col_ind, csr.row_ptr, torch.from_numpy(v)), v


def _ell_operands(seed=3):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((40, 16)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 30, (40, 16)).astype(np.int32)),
            torch.from_numpy(rng.standard_normal(30).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(40).astype(np.float32)))


def _moe_operands(seed=4):
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((D, E)).astype(np.float32),
         "wg": (rng.standard_normal((E, D, F)) * .1).astype(np.float32),
         "wu": (rng.standard_normal((E, D, F)) * .1).astype(np.float32),
         "wd": (rng.standard_normal((E, F, D)) * .1).astype(np.float32)}
    x = rng.standard_normal((1, S, D)).astype(np.float32)
    return p, x


def _targets(gm):
    return [n.target for n in gm.graph.nodes if n.op == "call_function"]


def test_the_default_mode_is_trace():
    assert lilac.compile(naive, platform="cpu").mode == "trace"


def test_trace_spmv_matches_reference_compile():
    ref, args, v = _spmv_operands()
    jfast = jlilac.compile(naive_jax)
    want = np.asarray(jfast(ref.val, ref.col_ind, ref.row_ptr,
                            jnp.asarray(v)))
    fast = lilac.compile(naive, platform="cpu")
    np.testing.assert_allclose(fast(*args).numpy(), want, **TOL)
    # both run the plain segment-sum harness: the marshaling ones are
    # host-only, and trace mode never selects them
    assert [n for _, n in jfast.last_selections] == ["jnp.segment"]
    assert [n for _, n in fast.last_selections] == ["torch.segment"]
    (m,) = fast.last_report.matches
    assert (m.computation, m.format) == ("spmv_csr", "CSR")
    for _ in range(2):
        fast(*args)
    assert fast.stats["traces"] == 1


@pytest.mark.parametrize("policy,harness", [("default", "torch.capacity"),
                                            ("cuda.gmm", "cuda.gmm")])
def test_trace_moe_matches_reference_compile(policy, harness):
    """The reference's own call (``models/layers.py`` compiles
    ``_moe_naive_2d`` in trace mode): the capacity harness on both sides
    under the default policy; K4's plain version, exact, under cuda.gmm."""
    p, x = _moe_operands()
    jg, ji, _ = jlayers.moe_router(p, jnp.asarray(x), TOPK)
    jpol = "default" if policy == "default" else "jnp.capacity"
    jfast = jlilac.compile(jlayers._moe_naive_2d, policy=jpol)
    want = np.asarray(jfast(jnp.asarray(x[0]), jg[0], ji[0], p["wg"],
                            p["wu"], p["wd"]))
    tp = tlayers.moe_params_from_numpy(p)
    tg, ti, _ = tlayers.moe_router(tp, torch.from_numpy(x), TOPK)
    fast = lilac.compile(tlayers._moe_naive_2d, policy=policy, platform="cpu")
    args = (torch.from_numpy(x[0]), tg[0], ti[0], tp["wg"], tp["wu"],
            tp["wd"])
    got = fast(*args)
    assert [n for _, n in fast.last_selections] == [harness]
    if policy == "default":
        np.testing.assert_allclose(got.numpy(), want, **FFN_TOL)
    else:
        exact = np.asarray(jlayers._moe_naive_2d(
            jnp.asarray(x[0]), jg[0], ji[0], p["wg"], p["wu"], p["wd"]))
        np.testing.assert_allclose(got.numpy(), exact, **FFN_TOL)
        assert MOE_OP in _targets(fast.graph_for(*args))


def test_moe_block_lilac_runs_in_trace_mode():
    p, x = _moe_operands()
    tp = tlayers.moe_params_from_numpy(p)
    got, _ = tlayers.moe_block(tp, torch.from_numpy(x), topk=TOPK,
                               impl="lilac")
    fast = tlayers._lilac_moe_2d("cpu")
    assert fast.mode == "trace" and fast.last_selections[0][1] == \
        "torch.capacity"
    want, _ = jlayers.moe_block(p, jnp.asarray(x), topk=TOPK, impl="lilac")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFN_TOL)


def test_the_rewritten_graph_holds_the_custom_op():
    """Each anchor becomes the pinned harness's custom-op node; the
    operators that only fed it are gone; placeholders are the traced
    graph's; the output equals host mode's bit for bit."""
    args = _ell_operands()
    fast = lilac.compile(ell_layer, policy="cuda.ell", platform="cpu")
    gm = fast.graph_for(*args)
    entry = next(iter(fast._compiled.values()))
    assert _targets(gm) == [SPMV_OP]
    (node,) = [n for n in gm.graph.nodes if n.op == "call_function"]
    assert node.args[6:] == ("relu", 32)     # fused epilogue, default slab
    traced = [n for n in entry.gm.graph.nodes if n.op == "placeholder"]
    assert len([n for n in gm.graph.nodes if n.op == "placeholder"]) \
        == len(traced) == 4
    assert torch.ops.aten.mul.Tensor in _targets(entry.gm)
    host = lilac.compile(ell_layer, mode="host", policy="cuda.ell",
                         platform="cpu")
    assert torch.equal(fast(*args), host(*args))
    torch.testing.assert_close(fast(*args), ell_layer(*args), **TOL)


@pytest.mark.parametrize("case", ["spmv_default", "ell_cuda", "moe_gmm"])
def test_graph_for_compiles_whole_and_equals_eager(case):
    """``torch.compile(graph_for(...), backend="aot_eager",
    fullgraph=True)``: no graph break at the custom ops."""
    if case == "spmv_default":
        fn, args, policy = naive, _spmv_operands()[1], "default"
    elif case == "ell_cuda":
        fn, args, policy = ell_layer, _ell_operands(), "cuda.ell"
    else:
        p, x = _moe_operands()
        tp = tlayers.moe_params_from_numpy(p)
        g, i, _ = tlayers.moe_router(tp, torch.from_numpy(x), TOPK)
        fn, policy = tlayers._moe_naive_2d, "cuda.gmm"
        args = (torch.from_numpy(x[0]), g[0], i[0], tp["wg"], tp["wu"],
                tp["wd"])
    gm = lilac.compile(fn, policy=policy, platform="cpu").graph_for(*args)
    eager = gm(*args)
    compiled = torch.compile(gm, backend="aot_eager", fullgraph=True)
    for a, b in zip(compiled(*args), eager):
        assert torch.equal(a, b)
    torch.testing.assert_close(eager[0], fn(*args), **FFN_TOL)


def test_an_unfused_pin_puts_the_epilogue_after_the_op():
    """A fuse-capable harness pinned unfused (the tuner's other
    realization): the op gets neither bias nor activation, aten nodes
    after it apply them once."""
    args = _ell_operands()
    host = lilac.compile(ell_layer, mode="host", platform="cpu")
    host(*args)
    entry = next(iter(host._compiled.values()))

    def select(m, binding, ctx):
        ctx.fuse = False
        return REGISTRY.get(m.computation, "cuda.ell")

    gm = rewrite_graph(entry.gm, entry.report.matches, select,
                       host._ctx_factory)
    (node,) = gm.graph.find_nodes(op="call_function", target=SPMV_OP)
    assert node.args[3] is None and node.args[6] is None
    assert torch.ops.aten.clamp_min.default in _targets(gm)
    torch.testing.assert_close(gm(*args)[0], ell_layer(*args), **TOL)


def test_unmatched_code_passes_through():
    def plain(x, y):
        return torch.tanh(x @ y) + 1.0, x.sum()

    x, y = torch.randn(5, 4), torch.randn(4, 3)
    fast = lilac.compile(plain, platform="cpu")
    got = fast(x, y)
    assert fast.last_report.matches == [] and fast.last_selections == []
    for a, b in zip(got, plain(x, y)):
        torch.testing.assert_close(a, b)


def test_trace_mode_never_selects_a_host_only_harness():
    _, args, _ = _spmv_operands()
    for policy in ("default", "autotune"):
        REGISTRY.reset_autotuner()
        fast = lilac.compile(naive, policy=policy, platform="cpu")
        fast(*args)
        (name,) = [n for _, n in fast.last_selections]
        assert REGISTRY.get("spmv_csr", name).jit_safe
    cands = {h.name for h in REGISTRY.candidates("spmv_csr", "CSR", "cuda",
                                                 "trace")}
    assert cands == {"torch.segment"}
    assert "cuda.ell" in {h.name for h in REGISTRY.candidates(
        "spmv_csr", "CSR", "cuda", "host")}
    for name in ("cuda.ell", "cuda.bcsr", "torch.ell"):
        fast = lilac.compile(naive, policy=name, platform="cpu")
        with pytest.raises(ValueError, match="host_only"):
            fast(*args)


def test_last_selections_name_what_the_graph_runs():
    """R3: the name in last_selections is the harness in the graph, not
    only a harness with equal values."""
    args = _ell_operands()
    for policy, op_in_graph in (("default", False), ("cuda.ell", True)):
        fast = lilac.compile(ell_layer, policy=policy, platform="cpu")
        fast(*args)
        name = fast.last_selections[0][1]
        assert name == ("torch.ell" if policy == "default" else "cuda.ell")
        assert (SPMV_OP in _targets(fast.graph_for(*args))) == op_in_graph


@pytest.mark.parametrize("kw", [
    dict(bias=None, perm=None, out_rows=None, epilogue=None),
    dict(bias="b", perm=None, out_rows=None, epilogue="relu"),
    dict(bias=None, perm="p", out_rows=50, epilogue=None),
    dict(bias="b", perm="p", out_rows=None, epilogue="silu"),
])
def test_opcheck_spmv_ell(kw):
    val, col, vec, bias = _ell_operands()
    perm = torch.randperm(40, generator=torch.Generator().manual_seed(0)) \
        .to(torch.int32)
    rows = kw["out_rows"] or 40
    args = (val, col, vec,
            bias[:rows] if kw["bias"] else None,
            perm if kw["perm"] else None, kw["out_rows"], kw["epilogue"], 8)
    torch.library.opcheck(ell_ops.spmv_ell_op, args)


@pytest.mark.parametrize("tm", [128, 64, 256])
def test_opcheck_moe_ffn(tm):
    p, x = _moe_operands()
    tp = tlayers.moe_params_from_numpy(p)
    g, i, _ = tlayers.moe_router(tp, torch.from_numpy(x), TOPK)
    torch.library.opcheck(gmm_ops.moe_ffn_op,
                          (torch.from_numpy(x[0]), g[0], i[0], tp["wg"],
                           tp["wu"], tp["wd"], tm))


def test_custom_ops_refuse_what_their_fake_cannot_describe():
    val, col, vec, _ = _ell_operands()
    with pytest.raises(ValueError, match="bias must be 1-D"):
        ell_ops.spmv_ell_op(val, col, vec, torch.ones(3), None, None,
                            "relu", 32)


def test_trace_autotune_pins_harness_schedule_and_fusion():
    """policy='autotune' in trace mode measures once, when the graph is
    built, on operands synthesized from the traced shapes, and pins the
    winner (with its schedule and fusion) into the graph; a second compiled
    function warm-starts with zero re-timing."""
    args = _ell_operands()
    fast = lilac.compile(ell_layer, policy="autotune", platform="cpu")
    out = fast(*args)
    torch.testing.assert_close(out, ell_layer(*args), **TOL)
    tuner = REGISTRY.autotuner
    timed = tuner.stats.timing_calls + tuner.stats.elimination_calls
    assert timed > 0
    dec = tuner.last_decision
    rec = tuner.cache.get(dec.sig, "trace")
    # cuda.ell fused and unfused plus torch.ell: 3 variants swept
    assert rec["harness"] == fast.last_selections[0][1]
    assert sum(len(v) for v in rec["variant_s"].values()) >= 2
    entry = next(iter(fast._compiled.values()))
    assert entry.pins == {0: dec.as_pin()}
    gm = fast.graph_for(*args)
    if dec.harness == "cuda.ell":
        (node,) = gm.graph.find_nodes(op="call_function", target=SPMV_OP)
        assert node.args[7] == dec.schedule["rows_per_slab"]
        assert fast.last_schedules == [dec.schedule]
    for _ in range(2):
        fast(*args)
    again = lilac.compile(ell_layer, policy="autotune", platform="cpu")
    again(*args)
    assert [n for _, n in again.last_selections] == \
        [n for _, n in fast.last_selections]
    assert again.last_schedules == fast.last_schedules
    assert tuner.stats.timing_calls + tuner.stats.elimination_calls == timed


def test_trace_autotune_sweeps_the_gmm_row_tile():
    p, x = _moe_operands()
    tp = tlayers.moe_params_from_numpy(p)
    g, i, _ = tlayers.moe_router(tp, torch.from_numpy(x), TOPK)
    args = (torch.from_numpy(x[0]), g[0], i[0], tp["wg"], tp["wu"], tp["wd"])
    fast = lilac.compile(tlayers._moe_naive_2d, policy="autotune",
                         platform="cpu")
    fast(*args)
    tuner = REGISTRY.autotuner
    rec = tuner.cache.get(tuner.last_decision.sig, "trace")
    assert sorted(rec["variant_s"]["cuda.gmm"]) == ["tm=128", "tm=256",
                                                    "tm=64"]
    assert set(rec["timings"]) == {"cuda.gmm", "torch.capacity", "dense"}
