"""Plans under transforms (docs/transforms.md, "Plans under transform
traces"): a call under ``torch.func.vmap``, one whose tensors require grad
and one under ``torch.func.grad`` each bake a plan and are then served by
it.  Held against the JAX package on the same seeded inputs:

  * values: ``jax.vmap(jlilac.compile(f))`` (SpMV, 1e-5), ``jax.grad(
    jlilac.compile(f))`` (1e-5; over a vmapped call 1e-4, the reference's
    vmapped-gradient tolerance) and the compiled ``_moe_naive_2d`` under
    ``jax.vmap`` (atol 1e-4, rtol 1e-3 for the f32 FFN and its weight
    gradients: the port's einsums sum in another order);
  * the counterpart of ``tests/test_transforms.py::
    test_plan_bakes_under_user_jit_and_serves_concrete``: a function only
    ever called under ``torch.func.vmap`` bakes and then serves, in host
    mode (``torch.ell``, ``cuda.ell``, ``cuda.bcsr`` on the CSR form) and
    in trace mode (``torch.ell`` and ``cuda.ell`` on the ELL form, whose
    harnesses are jit-safe; ``torch.segment`` on the CSR form: the CSR
    forms of the other three are host-only), its program holding one
    custom-op node for the batch;
  * a change of B or of the batch dim is a guard miss and a new bake; a
    batched matrix serves no plan and says why; an in-place edit of the
    matrix busts a batched plan;
  * ``.backward()`` and ``torch.func.grad`` (and ``torch.func.vmap`` of
    it) with respect to the vector, or to the MoE weights, bake and serve
    an eager plan, with the reference's gradients;
  * a shadow divergence on a batched plan call quarantines the selection
    and tears the plan down; a vmapped call's shadow runs the uncompiled
    function once an element, and a shadow whose uncompiled run raises is
    not counted as a check;
  * fault 1: ``make_train_step(..., lilac_grad=True)`` over a model whose
    MoE is compiled with ``policy="cuda.gmm"`` ran ``torch.capacity`` in
    its place under containment ("NYI: Functionalize rule for
    custom_function_call", or the custom op's formula refused under the
    grad level); fault 2: ``torch.func.grad`` of a trace-mode call ran the
    interpreter, and the custom ops' formulas ran under ``.backward()``
    only.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import lilac as jlilac
from repro.models.layers import _moe_naive_2d as jmoe_naive_2d
from repro.sparse import random_csr
from repro_torch import lilac
from repro_torch.core import faults
from repro_torch.core import pass_manager as PM
from repro_torch.core import resilience as R
from repro_torch.core.resilience import (LilacContainmentWarning,
                                         reset_shared_quarantine)
from repro_torch.kernels.bsr_spmm import ops as bsr_ops
from repro_torch.kernels.bsr_spmm import ref as bsr_ref
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.spmv_ell import ops as ell_ops
from repro_torch.kernels.spmv_ell import ref as ell_ref
from repro_torch.models import layers as tlayers
from repro_torch.sparse import convert as tconvert
from repro_torch.sparse import formats as tf

ROWS, COLS, NVEC = 64, 48, 5
TOL = dict(atol=1e-5, rtol=1e-5)
VGRAD_TOL = dict(atol=1e-4, rtol=1e-4)
FFN_TOL = dict(atol=1e-4, rtol=1e-3)
OPS = {"spmv_ell": torch.ops.lilac_torch.spmv_ell.default,
       "spmv_ell_layout": torch.ops.lilac_torch.spmv_ell_layout.default,
       "bsr_spmm": torch.ops.lilac_torch.bsr_spmm.default,
       "moe_ffn": torch.ops.lilac_torch.moe_ffn.default}


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
    t = tuple(torch.from_numpy(np.array(a)) for a in j)
    return j, t


def naive_jax(val, col, row_ptr, vec):
    row = jnp.repeat(jnp.arange(ROWS, dtype=jnp.int32), jnp.diff(row_ptr),
                     total_repeat_length=val.shape[0])
    return jax.ops.segment_sum(val * vec[col], row, num_segments=ROWS)


def naive(val, col, row_ptr, v):
    """The CSR SpMV written out of place, as a vmapped program must be."""
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
    """The problem's matrix as row-padded ELL arrays (a padded slot holds
    value 0 and column 0)."""
    val, col, ptr = (np.asarray(a) for a in j[:3])
    width = int(np.diff(ptr).max())
    v = np.zeros((ROWS, width), np.float32)
    c = np.zeros((ROWS, width), np.int32)
    for r in range(ROWS):
        n = ptr[r + 1] - ptr[r]
        v[r, :n], c[r, :n] = val[ptr[r]:ptr[r + 1]], col[ptr[r]:ptr[r + 1]]
    return v, c


def _operands(problem, form):
    """(torch matrix operands, jax matrix operands, torch fn, jax fn) of
    the CSR or the ELL form."""
    j, t = problem
    if form == "csr":
        return t[:3], j[:3], naive, naive_jax
    v, c = _ell_arrays(j)
    return ((torch.from_numpy(v), torch.from_numpy(c)),
            (jnp.asarray(v), jnp.asarray(c)), ell_form, ell_jax)


def _quiet():
    """A warnings recorder; ``_no_containment(rec)`` asserts it saw no
    LilacContainmentWarning."""
    cm = warnings.catch_warnings(record=True)
    rec = cm.__enter__()
    warnings.simplefilter("always")
    return cm, rec


def _no_containment(rec):
    hits = [str(w.message) for w in rec
            if issubclass(w.category, LilacContainmentWarning)]
    assert not hits, hits


def _counted(monkeypatch, module, name):
    calls = {"n": 0}
    real = getattr(module, name)

    def count(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(module, name, count)
    return calls


#: (mode, policy, form, the custom op its program holds, the wrapper that
#: launches the kernel: module, name)
VMAP_CASES = [
    ("host", "torch.ell", "csr", None, None),
    ("host", "cuda.ell", "csr", "spmv_ell_layout",
     (ell_ops, "spmv_ell_staged_cuda")),
    ("host", "cuda.bcsr", "csr", "bsr_spmm", (bsr_ops, "bsr_spmm_cuda")),
    ("trace", "torch.ell", "ell", None, None),
    ("trace", "cuda.ell", "ell", "spmv_ell", (ell_ops, "spmv_ell_cuda")),
    ("trace", "torch.segment", "csr", None, None),
]


# ---------------------------------------------------------------------------
# a function only ever called under torch.func.vmap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,policy,form,op,wrapper", VMAP_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in VMAP_CASES])
def test_a_function_called_only_under_vmap_bakes_and_serves(
        problem, monkeypatch, mode, policy, form, op, wrapper):
    """The first vmapped call bakes a batched plan, the later ones are plan
    hits, bit for bit the first call's and the reference's
    ``jax.vmap(jlilac.compile(f))`` within 1e-5; the program holds the
    custom op once, and each plan call launches the kernel once for the
    batch."""
    j, t = problem
    mats, jmats, fn, jfn = _operands(problem, form)
    jfast = jlilac.compile(jfn)
    want = jax.vmap(lambda v: jfast(*jmats, v))(j[3])
    fast = lilac.compile(fn, mode=mode, policy=policy, platform="cpu")

    def call():
        return torch.func.vmap(lambda v: fast(*mats, v))(t[3])

    cm, rec = _quiet()
    try:
        first = call()
        launches = _counted(monkeypatch, *wrapper) if wrapper else None
        served = [call(), call()]
    finally:
        cm.__exit__(None, None, None)
    _no_containment(rec)
    np.testing.assert_allclose(first.numpy(), np.asarray(want), **TOL)
    assert all(torch.equal(s, first) for s in served)
    assert [n for _, n in fast.last_selections] == [policy]
    info = fast.plan_info()
    assert info["baked"] == 1 and info["plan_hits"] == 2, info
    assert not info["bake_errors"]
    (plan,) = info["plans"]
    assert plan["transform"]["vmap"] == [
        [NVEC, [None] * len(mats) + [0]]] and not plan["transform"]["grad"]
    program = fast._last_plan.program
    custom = [n.target for n in program.graph.nodes
              if n.op == "call_function" and n.target in OPS.values()]
    assert custom == ([OPS[op]] if op else [])
    if launches is not None:
        assert launches["n"] == 2           # one launch a call, the batch


def test_a_function_called_only_under_vmap_in_host_mode_by_default(problem):
    """The default policy in host mode (the CPU's default harness) too,
    and the plan's answer equals the unplanned call's (``bake=False``)."""
    j, t = problem
    fast = lilac.compile(naive, mode="host", platform="cpu")
    slow = lilac.compile(naive, mode="host", platform="cpu", bake=False)
    outs = [torch.func.vmap(lambda v: f(*t[:3], v))(t[3])
            for f in (fast, fast, slow)]
    assert fast.plan_info()["plan_hits"] == 1
    assert slow.plan_info()["baked"] == 0
    assert torch.equal(outs[1], outs[2]) and torch.equal(outs[0], outs[2])


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_a_change_of_batch_size_or_batch_dim_is_a_guard_miss_and_a_new_bake(
        problem):
    """One entry (the per-element signature), whose plan guards B and each
    leaf's batch dim: B = 5, then 3, then the vectors as columns
    (``in_dims=1``) each miss and re-bake, and the same call again hits."""
    j, t = problem
    jfast = jlilac.compile(naive_jax)
    fast = lilac.compile(naive, mode="host", policy="cuda.ell",
                         platform="cpu")
    cases = [(t[3], 0, j[3]), (t[3][:3], 0, j[3][:3]),
             (t[3].T, 1, j[3])]
    for k, (vecs, dim, jvecs) in enumerate(cases):
        for _ in range(2):
            got = torch.func.vmap(lambda v: fast(*t[:3], v),
                                  in_dims=dim)(vecs)
        want = jax.vmap(lambda v: jfast(*j[:3], v))(jvecs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        info = fast.plan_info()
        # the re-baked plan replaces the old one, and serves the second call
        assert info["rebakes"] == k and info["entries"] == 1, info
        assert info["baked"] == 1 and info["plan_hits"] == 1
        (plan,) = info["plans"]
        assert plan["transform"]["vmap"] == [
            [vecs.shape[dim], [None, None, None, dim]]]


@pytest.mark.parametrize("policy", ["torch.ell", "cuda.ell", "cuda.bcsr"])
def test_a_batched_matrix_serves_no_plan_and_says_why(problem, policy):
    """vmap over the values: the marshal source is batched, so the harness
    repacks once an element (``levels.per_element``) and the entry never
    bakes; ``bake_errors`` names the batched marshal source."""
    j, t = problem
    scales = np.random.default_rng(3).uniform(0.5, 2.0, NVEC).astype(
        np.float32)
    vals = np.asarray(j[0])[None, :] * scales[:, None]
    jfast = jlilac.compile(naive_jax)
    want = jax.vmap(lambda a: jfast(a, j[1], j[2], j[3][0]))(
        jnp.asarray(vals))
    fast = lilac.compile(naive, mode="host", policy=policy, platform="cpu")
    for _ in range(2):
        got = torch.func.vmap(lambda a: fast(a, t[1], t[2], t[3][0]))(
            torch.from_numpy(vals))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    info = fast.plan_info()
    assert info["baked"] == 0 and info["plan_hits"] == 0
    assert "batched marshal source" in info["bake_errors"][0]


def test_an_in_place_edit_of_the_matrix_busts_a_batched_plan(problem):
    """The marshal source's version guard holds under vmap: after
    ``val.mul_(2)`` the batched plan misses, the data plane repacks, and
    the answer is the edited matrix's."""
    j, t = problem
    val = t[0].clone()
    jfast = jlilac.compile(naive_jax)
    fast = lilac.compile(naive, mode="host", policy="cuda.ell",
                         platform="cpu")

    def call():
        return torch.func.vmap(lambda v: fast(val, t[1], t[2], v))(t[3])

    call()
    call()
    assert fast.plan_info()["plan_hits"] == 1
    misses = fast.cache.stats.misses
    val.mul_(2)
    got = call()
    want = jax.vmap(lambda v: jfast(j[0] * 2, j[1], j[2], v))(j[3])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert fast.cache.stats.misses == misses + 1
    info = fast.plan_info()
    assert info["rebakes"] == 1 and info["plan_hits"] == 0   # a new plan
    assert torch.equal(call(), got)
    assert fast.plan_info()["plan_hits"] == 1


# ---------------------------------------------------------------------------
# calls that carry gradients
# ---------------------------------------------------------------------------

GRAD_CASES = [("host", "torch.ell", "csr"), ("host", "cuda.ell", "csr"),
              ("host", "cuda.bcsr", "csr"), ("trace", "cuda.ell", "ell"),
              ("trace", "torch.segment", "csr")]
GRAD_IDS = [f"{c[0]}-{c[1]}-{c[2]}" for c in GRAD_CASES]


def _grad_calls(fast, mats, vec, how):
    """The gradient of sum(fast(..., x)^2) in the vector, by ``how``."""
    def loss(x):
        return (fast(*mats, x) ** 2).sum()

    if how == "func_grad":
        return torch.func.grad(loss)(vec)
    if how == "vmap_of_func_grad":
        return torch.func.vmap(torch.func.grad(loss))(vec)
    x = vec.clone().requires_grad_()
    if how == "backward":
        loss(x).backward()
    else:                                   # .backward() through a vmap
        (torch.func.vmap(lambda v: fast(*mats, v))(x) ** 2).sum().backward()
    return x.grad


@pytest.mark.parametrize("how", ["backward", "func_grad", "vmapped_backward",
                                 "vmap_of_func_grad"])
@pytest.mark.parametrize("mode,policy,form", GRAD_CASES, ids=GRAD_IDS)
def test_gradient_carrying_calls_bake_and_serve(problem, mode, policy, form,
                                                how):
    """With respect to the vector: the first call bakes an eager plan
    (``runs`` "eager", its reason the autograd graph), the next two are
    plan hits, and the gradients equal ``jax.grad(jlilac.compile(f))``'s
    (of ``jax.vmap`` of it for a vmapped call)."""
    j, t = problem
    mats, jmats, fn, jfn = _operands(problem, form)
    jfast = jlilac.compile(jfn)
    vmapped = how in ("vmapped_backward", "vmap_of_func_grad")
    vec, jvec = (t[3], j[3]) if vmapped else (t[3][0], j[3][0])

    def jloss(x):
        return jnp.sum(jfast(*jmats, x) ** 2)

    want = (jax.vmap(jax.grad(jloss)) if vmapped else jax.grad(jloss))(jvec)
    fast = lilac.compile(fn, mode=mode, policy=policy, platform="cpu")
    cm, rec = _quiet()
    try:
        got = [_grad_calls(fast, mats, vec, how) for _ in range(3)]
    finally:
        cm.__exit__(None, None, None)
    _no_containment(rec)
    for g in got:
        np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                   **(VGRAD_TOL if vmapped else TOL))
    assert [n for _, n in fast.last_selections] == [policy]
    info = fast.plan_info()
    assert info["baked"] == 1 and info["plan_hits"] == 2, info
    assert not info["bake_errors"]
    (plan,) = info["plans"]
    assert plan["runs"] == "eager" and plan["transform"]["grad"] \
        and "autograd" in plan["eager_reason"]


def _moe_problem(B=3, T=32, D=8, F=16, E=4, seed=0):
    """Token groups with balanced routes (token t to experts t % E and
    (t + 1) % E), so no harness drops a pair, and f32 weights."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    gate = rng.random((B, T, 2)).astype(np.float32)
    ids = (np.arange(T)[:, None] + np.arange(2)[None, :]) % E
    idx = np.broadcast_to(ids, (B, T, 2)).astype(np.int32).copy()
    ws = [(rng.standard_normal(s) * .1).astype(np.float32)
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    return x, gate, idx, ws


@pytest.mark.parametrize("how", ["backward", "func_grad"])
@pytest.mark.parametrize("policy", ["cuda.gmm", "torch.capacity"])
def test_moe_weight_gradients_bake_and_serve(how, policy):
    """The training step's MoE call: the compiled ``_moe_naive_2d``
    vmapped over token groups, differentiated with respect to the expert
    weights.  It bakes a batched, gradient-carrying plan run eagerly; the
    next calls hit it, and the output and the weights' gradients equal the
    reference's ``jax.vmap(jlilac.compile(_moe_naive_2d))``."""
    x, gate, idx, ws = _moe_problem()
    jfast = jlilac.compile(jmoe_naive_2d)

    def jloss(wg, wu, wd):
        out = jax.vmap(lambda a, g, i: jfast(a, g, i, wg, wu, wd))(
            jnp.asarray(x), jnp.asarray(gate), jnp.asarray(idx))
        return jnp.sum(out ** 2), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(*map(jnp.asarray, ws))
    fast = lilac.compile(tlayers._moe_naive_2d, policy=policy,
                         platform="cpu")
    tx, tg, ti = (torch.from_numpy(a) for a in (x, gate, idx))

    def loss(wg, wu, wd):
        out = torch.func.vmap(lambda a, g, i: fast(a, g, i, wg, wu, wd))(
            tx, tg, ti)
        return (out ** 2).sum(), out

    cm, rec = _quiet()
    try:
        for _ in range(3):
            w = [torch.from_numpy(a.copy()) for a in ws]
            if how == "func_grad":
                grads, out = torch.func.grad(loss, argnums=(0, 1, 2),
                                             has_aux=True)(*w)
            else:
                w = [a.requires_grad_() for a in w]
                value, out = loss(*w)
                value.backward()
                grads = [a.grad for a in w]
            np.testing.assert_allclose(out.detach().numpy(),
                                       np.asarray(jout), **FFN_TOL)
            for g, jg in zip(grads, jgrads):
                np.testing.assert_allclose(g.numpy(), np.asarray(jg),
                                           **FFN_TOL)
    finally:
        cm.__exit__(None, None, None)
    _no_containment(rec)
    assert [n for _, n in fast.last_selections] == [policy]
    info = fast.plan_info()
    assert info["baked"] == 1 and info["plan_hits"] == 2, info
    (plan,) = info["plans"]
    assert plan["runs"] == "eager" and plan["transform"]["grad"]


def test_the_matrix_values_gradient_stays_refused(problem):
    """Differentiating the matrix's values (a marshal source) stays off
    plans, as in the reference: ``bake_errors`` says it carries gradients
    into a marshal source, and the gradient is still right."""
    j, t = problem
    jfast = jlilac.compile(naive_jax)
    want = jax.grad(lambda a: jnp.sum(jfast(a, j[1], j[2], j[3][0]) ** 2))(
        j[0])
    fast = lilac.compile(naive, mode="host", policy="cuda.ell",
                         platform="cpu")
    for _ in range(2):
        got = torch.func.grad(lambda a: (fast(a, t[1], t[2], t[3][0]) ** 2)
                              .sum())(t[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    info = fast.plan_info()
    assert info["baked"] == 0 and info["plan_hits"] == 0
    assert "carries gradients into a marshal source" in info["bake_errors"][0]


# ---------------------------------------------------------------------------
# shadow checks
# ---------------------------------------------------------------------------

def test_a_shadow_divergence_on_a_batched_plan_tears_it_down(problem,
                                                              monkeypatch):
    """At rate 1 the batched plan's call is shadowed an element at a time
    (NVEC checks a call); a divergence serves the uncompiled answer,
    quarantines the selection and tears the plan down, and the next call
    selects again."""
    monkeypatch.setenv("LILAC_TORCH_SHADOW_RATE", "1")
    j, t = problem
    jfast = jlilac.compile(naive_jax)
    want = np.asarray(jax.vmap(lambda v: jfast(*j[:3], v))(j[3]))
    fast = lilac.compile(naive, mode="host", policy="torch.ell",
                         platform="cpu")

    def call():
        return torch.func.vmap(lambda v: fast(*t[:3], v))(t[3])

    call()
    assert fast.plan_info()["baked"] == 1
    with faults.inject("shadow_diverge:dispatch"):
        got = call()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    c = fast.resilience_info()["containment"]
    assert c["shadow_checks"] == 2 * NVEC and c["shadow_divergences"] == 1
    assert fast.plan_info()["baked"] == 0
    assert R.shared_quarantine().is_quarantined("spmv_csr", "torch.ell",
                                                "default")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", LilacContainmentWarning)
        again = call()
    assert [n for _, n in fast.last_selections] != ["torch.ell"]
    np.testing.assert_allclose(again.numpy(), want, **TOL)


def _spy_moe(seen, fail):
    """``_moe_naive_2d`` that records whether a concrete call's input is
    batched, and raises while ``fail`` is set."""
    from torch._subclasses.fake_tensor import is_fake

    from repro_torch.core import levels

    def moe(x, gate, idx, wg, wu, wd):
        if not is_fake(x):
            if fail:
                raise MemoryError("the uncompiled block ran out of memory")
            seen.append(levels.batched(x))
        return tlayers._moe_naive_2d(x, gate, idx, wg, wu, wd)

    return moe


def test_a_vmapped_shadow_runs_the_reference_once_an_element(monkeypatch):
    """The shadow of a vmapped MoE call (at reduced width) runs the
    uncompiled block on each sequence alone, so no batch rule of its own
    copies the expert weights a sequence; each call counts B checks."""
    monkeypatch.setenv("LILAC_TORCH_SHADOW_RATE", "1")
    x, gate, idx, ws = _moe_problem()
    seen = []
    fast = lilac.compile(_spy_moe(seen, []), policy="cuda.gmm",
                         platform="cpu")
    tw = [torch.from_numpy(a) for a in ws]
    for _ in range(2):
        torch.func.vmap(lambda a, g, i: fast(a, g, i, *tw))(
            *(torch.from_numpy(a) for a in (x, gate, idx)))
    assert seen == [False] * (2 * x.shape[0])
    c = fast.resilience_info()["containment"]
    assert c["shadow_checks"] == 2 * x.shape[0]
    assert c["shadow_divergences"] == c["shadow_errors"] == 0


def test_a_shadow_whose_reference_raises_is_not_counted(monkeypatch):
    """A shadow whose uncompiled run raises (the vmapped einsum ran out of
    memory at Jamba's width) checks nothing: the port's answer is kept,
    ``shadow_errors`` counts it and ``shadow_checks`` does not."""
    monkeypatch.setenv("LILAC_TORCH_SHADOW_RATE", "1")
    x, gate, idx, ws = _moe_problem()
    seen, fail = [], []
    fast = lilac.compile(_spy_moe(seen, fail), policy="cuda.gmm",
                         platform="cpu")
    tw = [torch.from_numpy(a) for a in ws]
    args = [torch.from_numpy(a) for a in (x, gate, idx)]

    def call():
        return torch.func.vmap(lambda a, g, i: fast(a, g, i, *tw))(*args)

    first = call()
    fail.append(True)
    got = call()
    assert torch.equal(got, first)
    c = fast.resilience_info()["containment"]
    assert c["shadow_checks"] == x.shape[0] and c["shadow_errors"] == 1
    assert c["shadow_divergences"] == 0


# ---------------------------------------------------------------------------
# fault 1: compile-of-grad over an inner cuda.gmm MoE
# ---------------------------------------------------------------------------

def test_compile_of_grad_runs_the_inner_moe_on_cuda_gmm(monkeypatch):
    """``make_train_step(..., lilac_grad=True)`` over the smoke OLMoE whose
    MoE is the compiled ``_moe_naive_2d`` pinned to ``cuda.gmm``: the inner
    call traces into the gradient's graph through the custom op's
    differentiable call (``torch.func.functionalize`` given a rule for an
    ``autograd.Function``), ``last_selections`` names ``cuda.gmm``, no
    containment warning fires, and the loss and the updated parameters
    equal the plain step's (rtol 1e-6 and atol 1e-5, as
    ``tests/test_torch_train.py`` holds the lilac_grad step)."""
    from repro.configs import get_arch as jget_arch, smoke_config as jsmoke
    from repro.models import build_model as jbuild_model
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.factory import params_from_numpy
    from repro_torch.models.spec import leaves
    from repro_torch.train import optim as O
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.train_step import make_train_step

    cfg = smoke_config(get_arch("olmoe-1b-7b")).replace(moe_impl="lilac")
    jm = jbuild_model(jsmoke(jget_arch("olmoe-1b-7b")))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.key(0)))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jp))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        vocab=cfg.vocab, seq_len=32, global_batch=2, seed=1).batch_at(
        0).items()}
    inner = lilac.compile(tlayers._moe_naive_2d, platform="cpu",
                          policy="cuda.gmm")
    monkeypatch.setitem(tlayers._LILAC_MOE, "cpu", inner)
    model = build_model(cfg)
    opt = O.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    plain = make_train_step(model, opt)
    fast = make_train_step(model, opt, lilac_grad=True,
                           lilac_options={"platform": "cpu"})
    cm, rec = _quiet()
    try:
        pb, _, mb = fast(params, O.adamw_init(opt, params), batch)
    finally:
        cm.__exit__(None, None, None)
    _no_containment(rec)
    assert [n for _, n in inner.last_selections] == ["cuda.gmm"]
    assert inner.resilience_info()["containment"] == \
        R.ContainmentStats().as_dict()
    pa, _, ma = plain(params, O.adamw_init(opt, params), batch)
    np.testing.assert_allclose(float(mb["loss"]), float(ma["loss"]),
                               rtol=1e-6)
    a, b = dict(leaves(pa)), dict(leaves(pb))
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# fault 2: torch.func.grad through the custom ops and trace-mode graphs
# ---------------------------------------------------------------------------

def test_func_grad_of_a_trace_mode_call_runs_its_rewritten_graph(
        problem, monkeypatch):
    """A trace-mode call under ``torch.func.grad`` runs its rewritten
    graph (the interpreter never runs), ``lilac_torch::spmv_ell``'s
    formula giving the reference's gradients in the values and the
    vector."""
    assert not hasattr(PM, "_interprets")
    j, _ = problem
    v, c = _ell_arrays(j)
    want = jax.grad(lambda a, x: jnp.sum(jlilac.compile(ell_jax)(
        a, jnp.asarray(c), x) ** 2), argnums=(0, 1))(jnp.asarray(v),
                                                     j[3][0])
    interpreted = _counted(monkeypatch, PM.LilacFunction, "_interpret")
    fast = lilac.compile(ell_form, policy="cuda.ell", platform="cpu")
    got = torch.func.grad(lambda a, x: (fast(a, torch.from_numpy(c), x)
                                        ** 2).sum(), argnums=(0, 1))(
        torch.from_numpy(v), torch.from_numpy(np.asarray(j[3][0])))
    assert interpreted["n"] == 0
    assert [n for _, n in fast.last_selections] == ["cuda.ell"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _op_cases(problem):
    """Per custom op: (its differentiable call on (vector-like x), x, the
    plain function of x it computes)."""
    j, t = problem
    v, c = (torch.from_numpy(a) for a in _ell_arrays(j))
    bias = torch.linspace(-1, 1, ROWS)
    csr = tf.CSR(val=t[0], col_ind=t[1], row_ptr=t[2], shape=(ROWS, COLS))
    layout = ell_ops.pack_ell128(csr)
    packed = tconvert.csr_to_packed_bcsr(csr, (16, 16))
    x, gate, idx, ws = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                        else [torch.from_numpy(w) for w in a]
                        for a in _moe_problem(B=1))
    return {
        "spmv_ell": (
            lambda x: ell_ops.spmv_ell_call(v, c, x, bias, None, None,
                                            "silu", 32),
            t[3][0], lambda x: torch.nn.functional.silu(
                ell_ref.spmv_ell_ref(v, c, x) + bias)),
        "spmv_ell_layout": (
            lambda x: ell_ops.spmv_ell_layout_call(
                layout.val, layout.col, layout.seg_ptr, layout.seg_window,
                layout.seg_offset, layout.perm, x, bias, layout.window, ROWS,
                COLS, "relu"),
            t[3][0], lambda x: torch.relu(naive(t[0], t[1], t[2], x) + bias)),
        "bsr_spmm": (
            lambda x: bsr_ops.bsr_spmm_call(
                packed.val, packed.local, packed.tile_ptr, packed.row_start,
                packed.col_mask, packed.block_col, packed.block_rowptr,
                x[:, None], bias, ROWS, COLS, 16, 16, ROWS, "row", "relu"
            )[:, 0],
            t[3][0], lambda x: torch.relu(bsr_ref.bsr_spmm_plain(
                packed, x[:, None], out_rows=ROWS)[:, 0] + bias)),
        "moe_ffn": (
            lambda x: gmm_ops.moe_ffn_call(x, gate[0], idx[0], *ws, 8),
            x[0], lambda x: gmm_ops.moe_ffn_oracle(x, gate[0], idx[0], *ws)),
    }


@pytest.mark.parametrize("op", list(OPS))
def test_each_custom_op_differentiates_under_every_transform(problem, op):
    """Each custom op's differentiable call against the plain function it
    computes, under ``torch.func.grad``, ``torch.func.vmap`` of it,
    ``torch.func.grad`` of a vmapped call and ``.backward()`` (1e-4); a
    call that carries no gradients is the op itself."""
    call, x, plain = _op_cases(problem)[op]

    def grad_of(f):
        return torch.func.grad(lambda y: (f(y) ** 2).sum())

    xs = torch.stack([x, 2 * x, -x])
    checks = [(grad_of(call)(x), grad_of(plain)(x)),
              (torch.func.vmap(grad_of(call))(xs),
               torch.func.vmap(grad_of(plain))(xs)),
              (torch.func.grad(lambda y: (torch.func.vmap(call)(y) ** 2)
                               .sum())(xs),
               torch.func.grad(lambda y: (torch.func.vmap(plain)(y) ** 2)
                               .sum())(xs))]
    y = x.clone().requires_grad_()
    (call(y) ** 2).sum().backward()
    checks.append((y.grad, grad_of(plain)(x)))
    for got, want in checks:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(call(x), plain(x), atol=1e-5, rtol=1e-5)


def test_a_plan_keeps_no_tensor_of_the_call_that_baked_it():
    """A gradient-carrying batched plan holds none of its bake call's
    tensors: the training step's activations (and the autograd graph
    behind them) are freed once the step lets go of them."""
    import gc
    import weakref

    x, gate, idx, ws = _moe_problem()
    fast = lilac.compile(tlayers._moe_naive_2d, policy="cuda.gmm",
                         platform="cpu")
    tw = [torch.from_numpy(a).requires_grad_() for a in ws]
    tg, ti = torch.from_numpy(gate), torch.from_numpy(idx)
    refs = []
    for _ in range(2):
        h = torch.from_numpy(x).requires_grad_() * 2     # a non-leaf
        refs.append(weakref.ref(h))
        out = torch.func.vmap(lambda a, g, i: fast(a, g, i, *tw))(h, tg, ti)
        out.sum().backward()
        del h, out
    gc.collect()
    assert fast.plan_info()["baked"] == 1
    assert [r() for r in refs] == [None, None]
