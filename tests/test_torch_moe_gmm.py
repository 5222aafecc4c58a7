"""The port's MoE path against the JAX package: the grouped matmul and the
routed expert FFN against the Pallas kernel in interpret mode (as
tests/test_kernels.py runs it), the routing tables, the router, and the
MoE block through ``lilac.compile`` on the CPU.  On the CPU the kernel
wrapper takes its plain version; tests/test_torch_kernels_gpu.py holds
the CUDA kernel itself against that plain version on the card.

Tolerances: the reference's own for f32 (atol 1e-4, rtol 1e-3 for the
FFN); 2e-2 for bf16, whose rounding of ``h`` and of the output may land
one unit of bf16 (2^-8 relative) apart when the f32 sums differ in order.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import lilac as jlilac
from repro.configs import get_arch
from repro.kernels.moe_gmm.ref import gmm_ref as ref_gmm
from repro.kernels.moe_gmm import ops as ref_ops
from repro.kernels.moe_gmm.kernel import gmm_pallas
from repro.models import layers as jlayers
from repro_torch import lilac
from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE
from repro_torch.kernels.moe_gmm import kernel as K
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.models import layers as tlayers
from repro_torch.core import faults
from repro_torch.core.resilience import reset_shared_quarantine

FFN_TOL = dict(atol=1e-4, rtol=1e-3)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(autouse=True)
def _own_plan_cache(tmp_path, monkeypatch):
    """The plan cache in this test's directory."""
    # containment's store in this test's directory, no ambient chaos plan
    # and no shadow checks: a quarantine must not outlive its test
    monkeypatch.setenv("LILAC_TORCH_QUARANTINE_CACHE",
                       str(tmp_path / "quarantine.json"))
    for k in ("LILAC_TORCH_FAULTS", "LILAC_TORCH_FAULTS_SEED",
              "LILAC_TORCH_SHADOW_RATE"):
        monkeypatch.delenv(k, raising=False)
    faults.load_env()
    reset_shared_quarantine()
    monkeypatch.setenv("LILAC_TORCH_PLAN_CACHE", str(tmp_path / "plans.json"))



def _moe_operands(T, D, F, E, K, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((T, D)).astype(dtype),
        gate=rng.random((T, K)).astype(np.float32),
        idx=rng.integers(0, E, (T, K)).astype(np.int32),
        wg=(rng.standard_normal((E, D, F)) * .05).astype(dtype),
        wu=(rng.standard_normal((E, D, F)) * .05).astype(dtype),
        wd=(rng.standard_normal((E, F, D)) * .05).astype(dtype),
    )


def _torch(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("Tp,D,F,E,tm,fn,dk", [
    (64, 32, 64, 4, 16, 32, 16),        # tests/test_kernels.py:106
    (48, 96, 192, 3, 16, 64, 32),
])
def test_gmm_plain_matches_pallas(Tp, D, F, E, tm, fn, dk):
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((Tp, D)).astype(np.float32)
    w = rng.standard_normal((E, D, F)).astype(np.float32)
    te = rng.integers(0, E, Tp // tm).astype(np.int32)
    want = gmm_pallas(jnp.asarray(xs), jnp.asarray(w), jnp.asarray(te),
                      tm=tm, fn=fn, dk=dk, interpret=True)
    before = K.LAUNCHES["gmm"]
    got = K.gmm_cuda(torch.from_numpy(xs), torch.from_numpy(w),
                     torch.from_numpy(te), tm=tm)
    assert K.LAUNCHES["gmm"] == before          # no launch on the CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("D,F,offset,expect", [
    (2048, 1024, 0, True),      # OLMoE's gate/up
    (1024, 2048, 0, True),      # and down
    (37, 50, 0, False),         # D and F off the 16-byte step
    (36, 50, 0, False),
    (36, 52, 0, True),
    (64, 128, 1, False),        # xs off 16-byte alignment
])
def test_f32_vector_path_rule(D, F, offset, expect):
    """Which f32 operands K4's f32 body loads 16 bytes a thread (the CUDA
    wrapper passes this to the kernel); the rest take its scalar loads."""
    xs = torch.zeros(8 * D + 4)[offset:][:8 * D].view(8, D)
    w = torch.zeros(2, D, F)
    assert xs.is_contiguous() and w.data_ptr() % 16 == 0
    assert K.f32_vector_path(xs, w) == expect


def test_gmm_plain_maps_out_of_range_expert_ids_as_the_reference():
    """Ids past E or below 0 (which the kernel must not follow past w) take
    the expert that the JAX oracle's gather takes: a negative id counts
    from the end, then ids are clamped.  Tolerance as above."""
    rng = np.random.default_rng(3)
    E, tm = 3, 8
    xs = rng.standard_normal((48, 16)).astype(np.float32)
    w = rng.standard_normal((E, 16, 24)).astype(np.float32)
    te = np.array([E, -1, E + 1000, -E - 1000, 1, -2], np.int32)
    want = ref_gmm(jnp.asarray(xs), jnp.asarray(w), jnp.asarray(te), tm)
    got = K.gmm_cuda(torch.from_numpy(xs), torch.from_numpy(w),
                     torch.from_numpy(te), tm=tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def test_olmoe_config_matches_the_reference():
    """The port's OLMoE-1B-7B config carries the reference's published
    architecture field for field."""
    ref = get_arch("olmoe-1b-7b")
    for f in dataclasses.fields(OLMOE):
        want = getattr(ref, f.name)
        if f.name in ("param_dtype", "cache_dtype"):
            want = getattr(torch, jnp.dtype(want).name)
        assert getattr(OLMOE, f.name) == want, f.name


@pytest.mark.parametrize("T,K,E,tm", [(64, 2, 8, 16), (32, 4, 4, 8),
                                      (128, 2, 16, 32), (5, 3, 64, 128)])
def test_route_matches_reference(T, K, E, tm):
    idx = np.random.default_rng(T + E).integers(0, E, (T, K)).astype(np.int32)
    jd, jt, jtp = ref_ops._route(jnp.asarray(idx), T, K, E, tm)
    td, tt, ttp = gmm_ops._route(torch.from_numpy(idx), T, K, E, tm)
    assert ttp == jtp
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tt.dtype == torch.int32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D,F,E,K,tm", [
    (64, 128, 256, 8, 2, 16),
    (32, 96, 192, 4, 4, 8),
])
def test_moe_ffn_matches_pallas(T, D, F, E, K, tm, dtype):
    ops = _moe_operands(T, D, F, E, K, seed=T + E)
    if dtype == "bfloat16":
        for k in ("x", "wg", "wu", "wd"):
            ops[k] = ops[k].astype(jnp.bfloat16)
    want = ref_ops.moe_ffn(*(jnp.asarray(ops[k]) for k in
                             ("x", "gate", "idx", "wg", "wu", "wd")),
                           tm=tm, interpret=True)
    got = gmm_ops.moe_ffn(*(_torch(ops[k]) for k in
                            ("x", "gate", "idx", "wg", "wu", "wd")), tm=tm)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(FFN_TOL if dtype == "float32" else BF16_TOL))
    oracle = gmm_ops.moe_ffn_oracle(*(_torch(ops[k]) for k in
                                      ("x", "gate", "idx", "wg", "wu", "wd")))
    np.testing.assert_allclose(got.float().numpy(), oracle.numpy(),
                               **(FFN_TOL if dtype == "float32" else BF16_TOL))


def _jax_params(D, F, E, seed):
    rng = np.random.default_rng(seed)
    return {
        "router": (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32),
        "wg": (rng.standard_normal((E, D, F)) * .1).astype(np.float32),
        "wu": (rng.standard_normal((E, D, F)) * .1).astype(np.float32),
        "wd": (rng.standard_normal((E, F, D)) * .1).astype(np.float32),
    }


B, S, D, F, E, TOPK = 2, 24, 32, 16, 8, 2


def test_moe_router_matches_reference():
    p = _jax_params(D, F, E, seed=1)
    x = np.random.default_rng(2).standard_normal((B, S, D)).astype(np.float32)
    jg, ji, jaux = jlayers.moe_router(p, jnp.asarray(x), TOPK)
    tg, ti, taux = tlayers.moe_router(tlayers.moe_params_from_numpy(p),
                                      torch.from_numpy(x), TOPK)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_moe_params_from_numpy_takes_bf16():
    p = {k: jnp.asarray(v).astype(jnp.bfloat16) if k != "router"
         else jnp.asarray(v) for k, v in _jax_params(D, F, E, 3).items()}
    t = tlayers.moe_params_from_numpy(p)
    assert t["wg"].dtype == torch.bfloat16 and t["router"].dtype == torch.float32
    np.testing.assert_array_equal(t["wd"].float().numpy(),
                                  np.asarray(p["wd"], np.float32))
    spec = tlayers.moe_spec(D, F, E)
    assert {k: v[0] for k, v in spec.items()} \
        == {k: tuple(v.shape) for k, v in t.items()}


def _block_inputs(seed=4):
    p = _jax_params(D, F, E, seed)
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, S, D)).astype(np.float32)
    return p, x


def test_compiled_moe_default_policy_matches_reference_compile():
    """The capacity harness on both sides: the same capacity drops."""
    p, x = _block_inputs()
    jg, ji, _ = jlayers.moe_router(p, jnp.asarray(x), TOPK)
    jfast = jlilac.compile(jlayers._moe_naive_2d)
    tp = tlayers.moe_params_from_numpy(p)
    tg, ti, _ = tlayers.moe_router(tp, torch.from_numpy(x), TOPK)
    fast = lilac.compile(tlayers._moe_naive_2d, mode="host", platform="cpu")
    for b in range(B):
        want = jfast(jnp.asarray(x[b]), jg[b], ji[b], p["wg"], p["wu"],
                     p["wd"])
        got = fast(torch.from_numpy(x[b]), tg[b], ti[b], tp["wg"], tp["wu"],
                   tp["wd"])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFN_TOL)
    assert [n for _, n in fast.last_selections] == ["torch.capacity"]
    assert fast.stats["traces"] == 1
    (m,) = fast.last_report.matches
    assert (m.computation, m.format) == ("moe_ffn", "MOE")


def test_compiled_moe_block_on_gmm_matches_reference_naive():
    """policy='cuda.gmm' on CPU tensors (the kernels' plain versions) is
    exact: it equals the naive block, and names its own harness."""
    p, x = _block_inputs()
    want, _ = jlayers.moe_block(p, jnp.asarray(x), topk=TOPK, impl="naive")
    tp = tlayers.moe_params_from_numpy(p)
    gate, idx, _ = tlayers.moe_router(tp, torch.from_numpy(x), TOPK)
    fast = lilac.compile(tlayers._moe_naive_2d, mode="host", policy="cuda.gmm",
                         platform="cpu")
    got = torch.stack([fast(torch.from_numpy(x[b]), gate[b], idx[b],
                            tp["wg"], tp["wu"], tp["wd"]) for b in range(B)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFN_TOL)
    assert [n for _, n in fast.last_selections] == ["cuda.gmm"]
    naive, _ = tlayers.moe_block(tp, torch.from_numpy(x), topk=TOPK,
                                 impl="naive")
    np.testing.assert_allclose(naive.numpy(), np.asarray(want), **FFN_TOL)


def test_moe_block_lilac_traces_once_for_all_sequences():
    p, x = _block_inputs(seed=7)
    tp = tlayers.moe_params_from_numpy(p)
    out, aux = tlayers.moe_block(tp, torch.from_numpy(x), topk=TOPK,
                                 impl="lilac")
    fast = tlayers._lilac_moe_2d("cpu")
    assert out.shape == (B, S, D) and fast.stats["traces"] >= 1
    traces = fast.stats["traces"]
    tlayers.moe_block(tp, torch.from_numpy(x), topk=TOPK, impl="lilac")
    assert fast.stats["traces"] == traces
    jout, jaux = jlayers.moe_block(p, jnp.asarray(x), topk=TOPK, impl="lilac")
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FFN_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    with pytest.raises(ValueError):
        tlayers.moe_block(tp, torch.from_numpy(x), topk=TOPK, impl="ragged")


def test_moe_params_are_seeded():
    spec = tlayers.moe_spec(D, F, E)
    a = tlayers.moe_params(spec, torch.Generator().manual_seed(0))
    b = tlayers.moe_params(spec, torch.Generator().manual_seed(0))
    assert all(torch.equal(a[k], b[k]) for k in spec)
    assert a["wg"].dtype == torch.bfloat16 and a["router"].dtype == torch.float32
