"""``torch.func.vmap`` over ``lilac.compile`` (docs/transforms.md, the vmap
row), held against the JAX package's ``jax.vmap(lilac.compile(f))`` on
the same seeded inputs (``tests/test_transforms.py::
test_vmap_batched_detection_parity``'s problem):

  * a batch of vectors through every ``spmv_csr`` harness by policy, in
    host and trace mode, and the direct ELL form through ``torch.ell`` and
    ``cuda.ell`` (the kernels' plain versions on the CPU);
  * a batch of matrices: a harness that repacks it runs once an element
    (no quarantine), the custom op loops over it;
  * detection once, on the per-element graph; the entry never bakes and
    an unbatched call's plan still serves; the quarantine store, the
    containment counters and the warnings stay as they were;
  * gradients through a vmapped compiled call (``.backward()`` and
    ``torch.func.grad``, a ``vjp`` clause's Function batched);
  * the MoE block's ``naive`` and ``lilac`` impls: ``lilac`` through
    ``torch.func.vmap`` as the reference runs ``jax.vmap``, ``naive`` over
    the flattened tokens (the same per-token function);
  * the shadow check and the validator on a vmapped call;
  * the ``register_vmap`` rules of ``lilac_torch::spmv_ell``,
    ``::spmv_ell_layout``, ``::bsr_spmm`` and ``::moe_ffn`` against a loop
    over the batch, and their one call for a batch of vectors.

A vmapped program writes out of place (``zeros(...).index_add(...)``):
eager ``torch.func.vmap`` cannot run the in-place ``index_add_`` into an
unbatched buffer.  Tolerance: 1e-5 (atol and rtol) for the SpMV, the
reference's own; the MoE's f32 FFN at the reference's atol 1e-4, rtol
1e-3 (the port's einsums batch in another order).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import lilac as jlilac
from repro.models import layers as jlayers
from repro.sparse import random_csr
from repro_torch import lilac
from repro_torch.core import detect as D
from repro_torch.core import faults
from repro_torch.core import resilience as R
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
SPMV_HARNESSES = ("torch.segment", "torch.ell", "torch.bcsr", "torch.dense",
                  "cuda.ell", "cuda.bcsr")


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


@pytest.fixture(scope="module")
def problem():
    csr = random_csr(ROWS, COLS, density=0.12, seed=7)
    vecs = np.random.default_rng(9).standard_normal(
        (NVEC, COLS)).astype(np.float32)
    j = (jnp.asarray(csr.val), jnp.asarray(csr.col_ind),
         jnp.asarray(csr.row_ptr), jnp.asarray(vecs))
    t = tuple(torch.from_numpy(np.asarray(a)) for a in j)
    return j, t


def naive_jax(val, col, row_ptr, vec):
    row = jnp.repeat(jnp.arange(ROWS, dtype=jnp.int32), jnp.diff(row_ptr),
                     total_repeat_length=val.shape[0])
    return jax.ops.segment_sum(val * vec[col], row, num_segments=ROWS)


def naive(val, col, row_ptr, v):
    """The textbook CSR SpMV written out of place, as a vmapped program
    must be."""
    rows = row_ptr.shape[0] - 1
    row = torch.repeat_interleave(torch.arange(rows, device=val.device),
                                  torch.diff(row_ptr), output_size=val.shape[0])
    out = torch.zeros(rows, dtype=val.dtype, device=val.device)
    return out.index_add(0, row, val * v[col])


def ell_form(val, col, v):
    return torch.sum(val * v[col], dim=1)


def _ell_arrays(j):
    """The problem's matrix as row-padded ELL arrays (numpy), a padded
    slot holding value 0 and column 0."""
    val, col, ptr = (np.asarray(a) for a in j[:3])
    width = int(np.diff(ptr).max())
    v = np.zeros((ROWS, width), np.float32)
    c = np.zeros((ROWS, width), np.int32)
    for r in range(ROWS):
        n = ptr[r + 1] - ptr[r]
        v[r, :n], c[r, :n] = val[ptr[r]:ptr[r + 1]], col[ptr[r]:ptr[r + 1]]
    return v, c


def _spy_detect(monkeypatch):
    calls = {"n": 0}
    real = D.Detector.detect

    def spy(self, *a, **kw):
        calls["n"] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(D.Detector, "detect", spy)
    return calls


class _Quiet:
    """Records LilacContainmentWarnings and the quarantine store around a
    block; ``check()`` asserts the block left both as they were."""

    def __enter__(self):
        self.before = dict(R.shared_quarantine().active())
        self._cm = warnings.catch_warnings(record=True)
        self.caught = self._cm.__enter__()
        warnings.simplefilter("always")
        return self

    def __exit__(self, *exc):
        self._cm.__exit__(*exc)

    def check(self, fast=None):
        hits = [w for w in self.caught
                if issubclass(w.category, LilacContainmentWarning)]
        assert not hits, [str(w.message) for w in hits]
        assert R.shared_quarantine().active() == self.before
        if fast is not None:
            info = fast.resilience_info()
            assert info["containment"] == R.ContainmentStats().as_dict()
            assert info["disabled_matches"] == 0


def _ref_vmapped(j):
    fast = jlilac.compile(naive_jax)
    out = jax.vmap(lambda v: fast(j[0], j[1], j[2], v))(j[3])
    assert fast.last_report.matches
    return np.asarray(out)


# ---------------------------------------------------------------------------
# a batch of vectors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,policy", [
    *(("host", p) for p in SPMV_HARNESSES + ("default", "autotune")),
    ("trace", "torch.segment"), ("trace", "default")])
def test_vmap_of_compile_matches_the_reference(problem, monkeypatch, mode,
                                               policy):
    """Detection fires once, on the per-element graph; every harness runs
    once on the batch (its name in ``last_selections``) and gives
    ``jax.vmap(jlilac.compile(f))``'s answer; the entry never bakes, and
    nothing is quarantined or warned."""
    j, (val, col, ptr, vecs) = problem
    want = _ref_vmapped(j)
    calls = _spy_detect(monkeypatch)
    fast = lilac.compile(naive, mode=mode, policy=policy, platform="cpu")
    with _Quiet() as quiet:
        got = torch.func.vmap(lambda v: fast(val, col, ptr, v))(vecs)
        again = torch.func.vmap(lambda v: fast(val, col, ptr, v))(vecs)
    quiet.check(fast)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got, again)
    assert calls["n"] == 1 and fast.stats["traces"] == 1
    ((m, name),) = fast.last_selections
    assert m.computation == "spmv_csr"
    if policy not in ("default", "autotune"):
        assert name == policy
    info = fast.plan_info()
    assert info["baked"] == 0 and info["plan_hits"] == 0
    assert any("vmap" in e for e in info["bake_errors"])


@pytest.mark.parametrize("mode", ["host", "trace"])
@pytest.mark.parametrize("policy", ["torch.ell", "cuda.ell"])
def test_vmap_of_the_direct_ell_form(problem, mode, policy):
    """The padded-row form detects as ``spmv_ell``; ``cuda.ell`` reaches
    ``lilac_torch::spmv_ell``, whose vmap rule runs the batch as one call
    of the wrapper."""
    j, (_, _, _, vecs) = problem
    v, c = _ell_arrays(j)
    want = jax.vmap(jlilac.compile(
        lambda a, b, x: jnp.sum(a * x[b], axis=1)), in_axes=(None, None, 0))(
        jnp.asarray(v), jnp.asarray(c), j[3])
    fast = lilac.compile(ell_form, mode=mode, policy=policy, platform="cpu")
    calls = {"n": 0}
    real = ell_ops.spmv_ell_cuda

    def count(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    with _Quiet() as quiet, pytest.MonkeyPatch.context() as mp:
        mp.setattr(ell_ops, "spmv_ell_cuda", count)
        got = torch.func.vmap(
            lambda x: fast(torch.from_numpy(v), torch.from_numpy(c), x))(vecs)
    quiet.check(fast)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert [n for _, n in fast.last_selections] == [policy]
    assert calls["n"] == (1 if policy == "cuda.ell" else 0)


def test_the_traced_graph_is_the_per_element_program(problem):
    """A batched tensor hides its batch axis: the graph the compiled
    function traced for the vmapped call takes the per-element shapes, as
    an unbatched call's does, and its entry keys apart from that call's."""
    _, (val, col, ptr, vecs) = problem
    fast = lilac.compile(naive, mode="host", platform="cpu")
    torch.func.vmap(lambda v: fast(val, col, ptr, v))(vecs)
    fast(val, col, ptr, vecs[0])
    entries = list(fast._compiled.values())
    assert len(entries) == 2 and [e.batched for e in entries] == [True, False]
    for e in entries:
        shapes = [tuple(n.meta["val"].shape) for n in e.gm.graph.nodes
                  if n.op == "placeholder"]
        assert shapes == [tuple(val.shape), tuple(col.shape),
                          tuple(ptr.shape), (COLS,)]
    assert [(m.computation, m.format) for m in entries[0].report.matches] \
        == [(m.computation, m.format) for m in entries[1].report.matches] \
        == [("spmv_csr", "CSR")]


def test_an_unbatched_plan_still_serves_after_a_vmapped_call(problem):
    """The vmapped call keys its own entry; the unbatched entry's plan
    serves on either side of it, with no re-bake."""
    _, (val, col, ptr, vecs) = problem
    fast = lilac.compile(naive, mode="host", policy="torch.ell",
                         platform="cpu")
    x = vecs[0].clone()
    fast(val, col, ptr, x)
    fast(val, col, ptr, x)
    assert fast.plan_info()["plan_hits"] == 1
    before = fast.resilience_info()
    with _Quiet() as quiet:
        torch.func.vmap(lambda v: fast(val, col, ptr, v))(vecs)
        out = fast(val, col, ptr, x)
    quiet.check(fast)
    info = fast.plan_info()
    assert info["plan_hits"] == 2 and info["rebakes"] == 0
    assert info["entries"] == 2 and info["baked"] == 1
    assert fast.resilience_info() == before
    np.testing.assert_allclose(out.numpy(), naive(val, col, ptr, x).numpy(),
                               **TOL)


# ---------------------------------------------------------------------------
# a batch of matrices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", SPMV_HARNESSES)
def test_a_batched_matrix_runs_the_pinned_harness_once_an_element(problem,
                                                                   policy):
    """vmap over the values: the pinned harness runs.  One that repacks
    the matrix runs once an element (``levels.per_element``: a repack and
    a call each, the repacks cached, so a second call repacks nothing);
    nothing is quarantined or counted."""
    j, (val, col, ptr, _) = problem
    scales = np.random.default_rng(3).uniform(0.5, 2.0, NVEC).astype(
        np.float32)
    vals = np.asarray(j[0])[None, :] * scales[:, None]
    x = np.asarray(j[3][0])
    jfast = jlilac.compile(naive_jax)
    want = jax.vmap(lambda a: jfast(a, j[1], j[2], jnp.asarray(x)))(
        jnp.asarray(vals))
    fast = lilac.compile(naive, mode="host", policy=policy, platform="cpu")

    def call():
        return torch.func.vmap(lambda a: fast(a, col, ptr, torch.from_numpy(
            x)))(torch.from_numpy(vals))

    with _Quiet() as quiet:
        got = call()
        misses = fast.cache.stats.misses
        again = call()
    quiet.check(fast)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(again, got)
    assert [n for _, n in fast.last_selections] == [policy]
    if fast.registry.get("spmv_csr", policy).marshal:
        assert misses > 0 and misses % NVEC == 0
    else:
        assert misses == 0
    assert fast.cache.stats.misses == misses


def test_a_batched_ell_matrix_loops_in_the_custom_op(problem):
    j, (_, _, _, vecs) = problem
    v, c = _ell_arrays(j)
    vals = np.stack([v * s for s in (1.0, -0.5, 2.0)])
    fast = lilac.compile(ell_form, policy="cuda.ell", platform="cpu")
    got = torch.func.vmap(lambda a: fast(a, torch.from_numpy(c), vecs[0]))(
        torch.from_numpy(vals))
    want = jax.vmap(lambda a: jnp.sum(a * j[3][0][jnp.asarray(c)], axis=1))(
        jnp.asarray(vals))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# shadow checks and the validator on a vmapped call
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,policy", [("host", "torch.ell"),
                                         ("trace", "torch.segment")])
def test_a_vmapped_call_is_shadowed_an_element_at_a_time(problem,
                                                         monkeypatch, mode,
                                                         policy):
    """A vmapped call serves no plan, so it is shadowed itself: at rate 1
    each call runs the uncompiled function under the same vmap and holds
    every element to the shadow's bound; ``shadow_checks`` counts the
    call's NVEC elements, with no divergence and nothing quarantined."""
    monkeypatch.setenv("LILAC_TORCH_SHADOW_RATE", "1")
    j, (val, col, ptr, vecs) = problem
    fast = lilac.compile(naive, mode=mode, policy=policy, platform="cpu")
    with _Quiet() as quiet:
        for _ in range(2):
            got = torch.func.vmap(lambda v: fast(val, col, ptr, v))(vecs)
    quiet.check()
    info = fast.resilience_info()
    assert info["containment"]["shadow_checks"] == 2 * NVEC
    assert info["containment"]["shadow_divergences"] == 0
    assert info["shadow"]["checks"] == 2
    np.testing.assert_allclose(got.numpy(), _ref_vmapped(j), **TOL)


def test_a_vmapped_shadow_divergence_quarantines_the_selection(problem,
                                                               monkeypatch):
    """A divergence seen by a vmapped call's shadow is answered as a
    plan's: the uncompiled answer is returned, what the call selected is
    quarantined, and the next call selects again."""
    monkeypatch.setenv("LILAC_TORCH_SHADOW_RATE", "1")
    j, (val, col, ptr, vecs) = problem
    fast = lilac.compile(naive, mode="host", policy="torch.ell",
                         platform="cpu")

    def call():
        return torch.func.vmap(lambda v: fast(val, col, ptr, v))(vecs)

    with faults.inject("shadow_diverge:dispatch"):
        got = call()
    np.testing.assert_allclose(got.numpy(), _ref_vmapped(j), **TOL)
    info = fast.resilience_info()
    assert info["containment"]["shadow_divergences"] == 1
    assert info["shadow"]["incidents"] == 1
    assert R.shared_quarantine().is_quarantined("spmv_csr", "torch.ell",
                                                "default")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", LilacContainmentWarning)
        again = call()
    assert [n for _, n in fast.last_selections] != ["torch.ell"]
    np.testing.assert_allclose(again.numpy(), _ref_vmapped(j), **TOL)


def test_a_nan_in_a_batched_output_is_contained(problem):
    """The validator reads a batched output (its verdict below the
    levels) on a vmapped entry's first call: a NaN in ``torch.ell``'s
    output under vmap quarantines it and the next candidate's answer is
    returned."""
    j, (val, col, ptr, vecs) = problem
    fast = lilac.compile(naive, mode="host", policy="torch.ell",
                         platform="cpu")
    with faults.inject("nan_output:torch.ell"), warnings.catch_warnings():
        warnings.simplefilter("ignore", LilacContainmentWarning)
        got = torch.func.vmap(lambda v: fast(val, col, ptr, v))(vecs)
    assert fast.resilience_info()["containment"]["nonfinite_outputs"] == 1
    assert [n for _, n in fast.last_selections] != ["torch.ell"]
    np.testing.assert_allclose(got.numpy(), _ref_vmapped(j), **TOL)


def test_a_clean_vmapped_entry_is_sampled_by_the_shadow(problem,
                                                      monkeypatch):
    """After a clean call a vmapped entry's calls are not validated (no
    sync a harness call: such an entry never bakes), and the shadow check
    samples them as it samples plan calls: at rate 1 a NaN in
    ``torch.ell``'s output is a divergence, the uncompiled answer is
    returned and ``torch.ell`` is quarantined."""
    j, (val, col, ptr, vecs) = problem
    fast = lilac.compile(naive, mode="host", policy="torch.ell",
                         platform="cpu")

    def call():
        return torch.func.vmap(lambda v: fast(val, col, ptr, v))(vecs)

    with _Quiet() as quiet:
        call()
    quiet.check(fast)
    monkeypatch.setenv("LILAC_TORCH_SHADOW_RATE", "1")
    with faults.inject("nan_output:torch.ell"):
        got = call()
    info = fast.resilience_info()["containment"]
    assert info["nonfinite_outputs"] == 0
    assert info["shadow_checks"] == NVEC and info["shadow_divergences"] == 1
    assert R.shared_quarantine().is_quarantined("spmv_csr", "torch.ell",
                                                "default")
    np.testing.assert_allclose(got.numpy(), _ref_vmapped(j), **TOL)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["torch.segment", "cuda.ell", "cuda.bcsr"])
def test_func_grad_of_a_vmapped_compiled_call(problem, policy):
    """``torch.func.grad`` outside the vmap: each harness's ``vjp`` clause
    runs as a ``HarnessCall`` on the batched values (its generated vmap
    rule), with the gradient of ``jax.grad`` over ``jax.vmap``."""
    j, (val, col, ptr, vecs) = problem

    def loss_j(x):
        return jnp.sum(jax.vmap(lambda v: naive_jax(j[0], j[1], j[2], v))(
            x) ** 2)

    want = jax.grad(loss_j)(j[3])
    fast = lilac.compile(naive, mode="host", policy=policy, platform="cpu")
    with _Quiet() as quiet:
        got = torch.func.grad(lambda x: (torch.func.vmap(
            lambda v: fast(val, col, ptr, v))(x) ** 2).sum())(vecs)
    quiet.check(fast)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert [n for _, n in fast.last_selections] == [policy]


def test_backward_through_a_vmapped_trace_mode_graph(problem):
    """``.backward()`` through ``lilac_torch::spmv_ell`` run by its vmap
    rule: the batched call's autograd formula gives each vector its
    gradient and the matrix the sum of theirs."""
    j, (_, _, _, vecs) = problem
    v, c = _ell_arrays(j)
    val = torch.from_numpy(v).requires_grad_()
    x = vecs.clone().requires_grad_()
    fast = lilac.compile(ell_form, policy="cuda.ell", platform="cpu")
    (torch.func.vmap(lambda y: fast(val, torch.from_numpy(c), y))(x) ** 2) \
        .sum().backward()
    gv, gx = jax.grad(lambda a, y: jnp.sum(jax.vmap(
        lambda z: jnp.sum(a * z[jnp.asarray(c)], axis=1))(y) ** 2),
        argnums=(0, 1))(jnp.asarray(v), j[3])
    np.testing.assert_allclose(val.grad.numpy(), np.asarray(gv), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), atol=1e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------

B, S, DM, FF, E, TOPK = 3, 24, 32, 16, 8, 2


def _moe_inputs(seed=4):
    rng = np.random.default_rng(seed)
    p = {"router": (rng.standard_normal((DM, E)) * .5).astype(np.float32),
         "wg": (rng.standard_normal((E, DM, FF)) * .05).astype(np.float32),
         "wu": (rng.standard_normal((E, DM, FF)) * .05).astype(np.float32),
         "wd": (rng.standard_normal((E, FF, DM)) * .05).astype(np.float32)}
    x = rng.standard_normal((B, S, DM)).astype(np.float32)
    return p, x


@pytest.mark.parametrize("impl", ["naive", "lilac"])
def test_moe_block_runs_each_sequence_as_the_reference(impl, monkeypatch):
    """The port's ``moe_block`` runs ``lilac`` under ``torch.func.vmap``
    and ``naive`` over the B·S tokens at once, a function of each token
    (no loop over sequences): the compiled MoE is detected once, on one
    sequence, and each impl gives the reference's ``jax.vmap`` answer (on
    the CPU both packages' default harness drops the same pairs past
    capacity)."""
    p, x = _moe_inputs()
    want, jaux = jlayers.moe_block(p, jnp.asarray(x), topk=TOPK, impl=impl)
    tp = tlayers.moe_params_from_numpy(p)
    monkeypatch.setattr(tlayers, "_LILAC_MOE", {})
    calls = _spy_detect(monkeypatch)
    with _Quiet() as quiet:
        got, aux = tlayers.moe_block(tp, torch.from_numpy(x), topk=TOPK,
                                     impl=impl)
    quiet.check()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFN_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    if impl == "lilac":
        fast = tlayers._LILAC_MOE["cpu"]
        assert calls["n"] == 1 and fast.stats["traces"] == 1
        assert [(m.computation, n) for m, n in fast.last_selections] == \
            [("moe_ffn", "torch.capacity")]
        assert any("vmap" in e for e in fast.plan_info()["bake_errors"])


def test_moe_block_on_k4_is_one_call_for_all_sequences(monkeypatch):
    """``cuda.gmm`` (the dropless K4 path; plain versions on the CPU):
    ``lilac_torch::moe_ffn``'s vmap rule runs the B sequences as one call
    over their tokens, 3 grouped matmuls where a loop ran 3·B, equal to
    the reference's naive block and to the port's loop over sequences."""
    p, x = _moe_inputs(seed=6)
    want, _ = jlayers.moe_block(p, jnp.asarray(x), topk=TOPK, impl="naive")
    tp = tlayers.moe_params_from_numpy(p)
    fast = lilac.compile(tlayers._moe_naive_2d, policy="cuda.gmm",
                         platform="cpu")
    monkeypatch.setattr(tlayers, "_LILAC_MOE", {"cpu": fast})
    grouped = {"n": 0}
    real = gmm_ops.gmm_cuda

    def count(*a, **k):
        grouped["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(gmm_ops, "gmm_cuda", count)
    got, _ = tlayers.moe_block(tp, torch.from_numpy(x), topk=TOPK,
                               impl="lilac")
    assert grouped["n"] == 3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFN_TOL)
    gate, idx, _ = tlayers.moe_router(tp, torch.from_numpy(x), TOPK)
    loop = torch.stack([fast(torch.from_numpy(x[b]), gate[b], idx[b],
                             tp["wg"], tp["wu"], tp["wd"]) for b in range(B)])
    np.testing.assert_allclose(got.numpy(), loop.numpy(), **FFN_TOL)
    assert grouped["n"] == 3 + 3 * B


# ---------------------------------------------------------------------------
# the custom ops' vmap rules
# ---------------------------------------------------------------------------

def _counted(monkeypatch, module, name):
    calls = {"n": 0}
    real = getattr(module, name)

    def count(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(module, name, count)
    return calls


def _loop(fn, *batched):
    return torch.stack([fn(*xs) for xs in zip(*batched)])


def test_spmv_ell_op_vmap_rule_against_the_loop(problem, monkeypatch):
    j, (_, _, _, vecs) = problem
    v, c = (torch.from_numpy(a) for a in _ell_arrays(j))
    bias = torch.linspace(-1, 1, ROWS)
    perm = torch.randperm(ROWS, generator=torch.Generator().manual_seed(0)
                          ).int()
    op = ell_ops.spmv_ell_op
    calls = _counted(monkeypatch, ell_ops, "spmv_ell_cuda")
    for b, p, epi in ((None, None, None), (bias, None, "relu"),
                      (None, perm, None)):
        f = lambda x: op(v, c, x, b, p, None if p is None else ROWS, epi, 32)
        n0 = calls["n"]
        got = torch.func.vmap(f)(vecs)
        assert calls["n"] == n0 + 1         # the batch in one call
        torch.testing.assert_close(got, _loop(f, vecs), rtol=0, atol=0)
    vals = torch.stack([v, 2 * v, -v])
    f = lambda a: op(a, c, vecs[0], None, None, None, None, 32)
    n0 = calls["n"]
    got = torch.func.vmap(f)(vals)
    assert calls["n"] == n0 + 3             # a batched matrix loops
    torch.testing.assert_close(got, _loop(f, vals), rtol=0, atol=0)


def test_spmv_ell_layout_op_vmap_rule_against_the_loop(problem, monkeypatch):
    j, (val, col, ptr, vecs) = problem
    csr = tf.CSR(val=val, col_ind=col, row_ptr=ptr, shape=(ROWS, COLS))
    packed = ell_ops.pack_ell128(csr)
    for limit in (ell_ops.RESIDENT_VEC_LIMIT, 16):   # K1 staged, then K2
        monkeypatch.setattr(ell_ops, "RESIDENT_VEC_LIMIT", limit)
        name = "spmv_ell_staged_cuda" if limit > COLS \
            else "spmv_ell_windowed_cuda"
        calls = _counted(monkeypatch, ell_ops, name)
        f = lambda x: ell_ops.spmv_ell_packed(packed, x, epilogue="silu",
                                              bias=torch.ones(ROWS))
        got = torch.func.vmap(f)(vecs)
        assert calls["n"] == 1
        torch.testing.assert_close(got, _loop(f, vecs), rtol=0, atol=0)
        np.testing.assert_allclose(
            got.numpy(), torch.nn.functional.silu(
                torch.stack([naive(val, col, ptr, x) for x in vecs]) + 1)
            .numpy(), **TOL)


def test_bsr_spmm_op_vmap_rule_lays_the_batch_as_columns(problem,
                                                          monkeypatch):
    j, (val, col, ptr, vecs) = problem
    csr = tf.CSR(val=val, col_ind=col, row_ptr=ptr, shape=(ROWS, COLS))
    packed = tconvert.csr_to_packed_bcsr(csr, (16, 16))
    calls = _counted(monkeypatch, bsr_ops, "bsr_spmm_cuda")
    dense = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (NVEC, COLS, 3)).astype(np.float32))
    for b, kind in ((None, None), (torch.linspace(0, 1, 3), "col"),
                    (torch.linspace(0, 1, ROWS), "row")):
        f = lambda d: bsr_ops.bsr_spmm(packed, d, epilogue="relu", bias=b,
                                       bias_kind=kind, out_rows=ROWS)
        n0 = calls["n"]
        got = torch.func.vmap(f)(dense)
        assert calls["n"] == n0 + 1
        torch.testing.assert_close(got, _loop(f, dense), atol=1e-6,
                                   rtol=1e-6)
    # vectors as the operand's columns: (cols, B)
    g = lambda x: bsr_ops.bsr_spmm(packed, x[:, None], out_rows=ROWS)[:, 0]
    np.testing.assert_allclose(
        torch.func.vmap(g)(vecs).numpy(),
        torch.stack([naive(val, col, ptr, x) for x in vecs]).numpy(), **TOL)


def test_moe_ffn_op_vmap_rule_against_the_loop(monkeypatch):
    rng = np.random.default_rng(8)
    T, K = 10, 2
    x = torch.from_numpy(rng.standard_normal((B, T, DM)).astype(np.float32))
    gate = torch.from_numpy(rng.random((B, T, K)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, E, (B, T, K)).astype(np.int32))
    w = [torch.from_numpy((rng.standard_normal(s) * .05).astype(np.float32))
         for s in ((E, DM, FF), (E, DM, FF), (E, FF, DM))]
    calls = _counted(monkeypatch, gmm_ops, "moe_ffn")
    f = lambda a, g, i: gmm_ops.moe_ffn_op(a, g, i, *w, 16)
    got = torch.func.vmap(f)(x, gate, idx)
    assert calls["n"] == 1
    torch.testing.assert_close(got, _loop(f, x, gate, idx), atol=1e-6,
                               rtol=1e-6)
    # an unbatched routing table is shared by every element
    h = lambda a: gmm_ops.moe_ffn_op(a, gate[0], idx[0], *w, 16)
    torch.testing.assert_close(torch.func.vmap(h)(x), _loop(h, x),
                               atol=1e-6, rtol=1e-6)
    # batched weights: one call an element
    ws = torch.stack([w[0], 2 * w[0]])
    k = lambda a: gmm_ops.moe_ffn_op(x[0], gate[0], idx[0], a, w[1], w[2], 16)
    n0 = calls["n"]
    got = torch.func.vmap(k)(ws)
    assert calls["n"] == n0 + 2
    torch.testing.assert_close(got, _loop(k, ws), atol=0, rtol=0)
