"""The slices end to end: ``repro_torch.lilac.compile`` in host mode
against ``repro.lilac.compile`` on the same CSR and vector (SpMV) or
dense matrix (SpMM), the data plane's one-repack contract over a CG loop
and a GNN-style SpMM loop, the platform rules, and the package's
independence from JAX and from the JAX package."""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import lilac as jlilac
from repro.sparse import random_csr
from repro_torch import lilac
from repro_torch.core.marshal import fingerprint
from repro_torch.sparse import formats as tf
from repro_torch.sparse import random as trandom
from repro_torch.core import faults
from repro_torch.core.resilience import reset_shared_quarantine

ROWS, COLS = 96, 80
TOL = dict(atol=1e-4, rtol=1e-4)


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



def naive_jax(val, col, row_ptr, v):
    row = jnp.repeat(jnp.arange(ROWS, dtype=jnp.int32), jnp.diff(row_ptr),
                     total_repeat_length=val.shape[0])
    return jax.ops.segment_sum(val * v[col], row, num_segments=ROWS)


def naive(val, col, row_ptr, v):
    rows = row_ptr.shape[0] - 1
    row = torch.repeat_interleave(torch.arange(rows, device=val.device),
                                  torch.diff(row_ptr), output_size=val.shape[0])
    out = torch.zeros(rows, dtype=val.dtype, device=val.device)
    return out.index_add_(0, row, val * v[col])


def _operands():
    ref = random_csr(ROWS, COLS, density=0.08, seed=5, skew=1.0)
    v = np.random.default_rng(2).standard_normal(COLS).astype(np.float32)
    return ref, tf.from_numpy(ref), v


def test_host_mode_matches_reference_compile():
    ref, csr, v = _operands()
    jfast = jlilac.compile(naive_jax, mode="host", policy="jnp.ell")
    want = np.asarray(jfast(ref.val, ref.col_ind, ref.row_ptr, jnp.asarray(v)))
    fast = lilac.compile(naive, mode="host", policy="cuda.ell", platform="cpu")
    got = fast(csr.val, csr.col_ind, csr.row_ptr, torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert [n for _, n in jfast.last_selections] == ["jnp.ell"]
    assert [n for _, n in fast.last_selections] == ["cuda.ell"]
    (m,) = fast.last_report.matches
    (jm,) = jfast.last_report.matches
    assert (m.computation, m.format) == (jm.computation, jm.format) \
        == ("spmv_csr", "CSR")
    assert sorted(m.binding) == sorted(jm.binding)


@pytest.mark.parametrize("policy", ["default", "torch.ell", "torch.dense",
                                    "cuda.ell"])
def test_every_spmv_harness_agrees(policy):
    _, csr, v = _operands()
    fast = lilac.compile(naive, mode="host", policy=policy, platform="cpu")
    got = fast(csr.val, csr.col_ind, csr.row_ptr, torch.from_numpy(v))
    want = naive(csr.val, csr.col_ind, csr.row_ptr, torch.from_numpy(v))
    torch.testing.assert_close(got, want, **TOL)
    expect = "torch.segment" if policy == "default" else policy
    assert [n for _, n in fast.last_selections] == [expect]


def cg(spmv, csr, b, iters):
    """Unpreconditioned CG, written against a plain spmv callable."""
    x = torch.zeros_like(b)
    r = b - spmv(csr.val, csr.col_ind, csr.row_ptr, x)
    p = r
    rs = torch.dot(r, r)
    for _ in range(iters):
        ap = spmv(csr.val, csr.col_ind, csr.row_ptr, p)
        alpha = rs / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
    return x


def test_cg_loop_repacks_once():
    """The main path at a small size: a CG solver calling a naive CSR SpMV,
    compiled with cuda.ell, repacks CSR->ELL128 once and serves every later
    call from its executable plan (the default) or the data plane."""
    n = 120
    csr = trandom.random_spd_csr(n, 9, seed=1)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(n)
                         .astype(np.float32))
    fast = lilac.compile(naive, mode="host", policy="cuda.ell", platform="cpu")
    x = cg(fast, csr, b, iters=10)
    x_ref = cg(naive, csr, b, iters=10)
    torch.testing.assert_close(x, x_ref, atol=1e-4, rtol=1e-4)
    assert fast.cache.stats.misses == 1
    assert fast.cache.stats.hits + fast.plan_info()["plan_hits"] == 10
    assert fast.stats["traces"] == 1        # one signature, traced once
    assert fast.cache.plan_stats()["csr_binding->ELL128"]["last_path"] \
        == ("CSR", "ELL128")
    (m,) = fast.last_report.matches
    assert (m.computation, m.format) == ("spmv_csr", "CSR")


def test_direct_ell_with_fused_epilogue_on_cpu():
    rng = np.random.default_rng(3)
    val = torch.from_numpy(rng.standard_normal((40, 16)).astype(np.float32))
    col = torch.from_numpy(rng.integers(0, 30, (40, 16)).astype(np.int32))
    vec = torch.from_numpy(rng.standard_normal(30).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(40).astype(np.float32))

    def layer(val, col, vec, bias):
        return torch.relu((val * vec[col]).sum(dim=1) + bias)

    for policy, name in (("default", "torch.ell"), ("cuda.ell", "cuda.ell")):
        fast = lilac.compile(layer, mode="host", policy=policy,
                             platform="cpu")
        torch.testing.assert_close(fast(val, col, vec, bias),
                                   layer(val, col, vec, bias), **TOL)
        (m,) = fast.last_report.matches
        assert m.epilogue == "relu" and "bias" in m.binding
        assert [n for _, n in fast.last_selections] == [name]


SPMM_ROWS, SPMM_COLS, SPMM_NNZ, SPMM_N = 64, 48, 200, 5


def spmm_jax(val, col, row_ptr, dmat):     # benchmarks/tab3_detection.py:70
    r = jnp.repeat(jnp.arange(SPMM_ROWS, dtype=jnp.int32), jnp.diff(row_ptr),
                   total_repeat_length=SPMM_NNZ)
    return jax.ops.segment_sum(val[:, None] * dmat[col], r,
                               num_segments=SPMM_ROWS)


def naive_spmm(val, col, row_ptr, dmat):
    rows = row_ptr.shape[0] - 1
    r = torch.repeat_interleave(torch.arange(rows, device=val.device),
                                torch.diff(row_ptr), output_size=val.shape[0])
    out = torch.zeros((rows, dmat.shape[1]), dtype=val.dtype,
                      device=val.device)
    return out.index_add_(0, r, val[:, None] * dmat[col])


def _spmm_operands():
    rng = np.random.default_rng(0)
    cuts = np.sort(rng.integers(0, SPMM_NNZ + 1, SPMM_ROWS - 1))
    return dict(
        val=rng.standard_normal(SPMM_NNZ).astype(np.float32),
        col=rng.integers(0, SPMM_COLS, SPMM_NNZ).astype(np.int32),
        row_ptr=np.concatenate([[0], cuts, [SPMM_NNZ]]).astype(np.int32),
        dmat=rng.standard_normal((SPMM_COLS, SPMM_N)).astype(np.float32))


def test_spmm_compile_matches_reference_compile():
    ops = _spmm_operands()
    names = ("val", "col", "row_ptr", "dmat")
    want = np.asarray(jlilac.compile(spmm_jax)(*(jnp.asarray(ops[n])
                                                 for n in names)))
    fast = lilac.compile(naive_spmm, mode="host", platform="cpu")
    got = fast(*(torch.from_numpy(ops[n]) for n in names))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    (m,) = fast.last_report.matches
    assert (m.computation, m.format) == ("spmm_csr", "CSR")
    assert [n for _, n in fast.last_selections] == ["torch.segment"]


@pytest.mark.parametrize("policy", ["default", "torch.segment", "torch.bcsr",
                                    "cuda.bcsr"])
def test_every_spmm_harness_agrees(policy):
    ops = {k: torch.from_numpy(v) for k, v in _spmm_operands().items()}
    fast = lilac.compile(naive_spmm, mode="host", policy=policy,
                         platform="cpu")
    got = fast(ops["val"], ops["col"], ops["row_ptr"], ops["dmat"])
    torch.testing.assert_close(got, naive_spmm(ops["val"], ops["col"],
                                               ops["row_ptr"], ops["dmat"]),
                               **TOL)
    expect = "torch.segment" if policy == "default" else policy
    assert [n for _, n in fast.last_selections] == [expect]
    assert sorted(h.name for h in lilac.REGISTRY.harnesses_for("spmm_csr")) \
        == ["cuda.bcsr", "torch.bcsr", "torch.segment"]
    assert lilac.REGISTRY.default_name("spmm_csr", "cuda") == "cuda.bcsr"
    assert lilac.REGISTRY.default_name("moe_ffn", "cuda") == "cuda.gmm"


@pytest.mark.parametrize("n", [SPMM_N, SPMM_ROWS])
def test_gnn_loop_on_bcsr_repacks_once(n):
    """The SpMM main path at a small size: H <- relu(A @ H + b), rescaled,
    for several steps through cuda.bcsr's plain version — one CSR ->
    BCSR128x128 repack, a hit (of the plan or the data plane) on every
    later step, the relu-bias epilogue
    fused, and the column bias right also where rows == N."""
    ops = {k: torch.from_numpy(v) for k, v in _spmm_operands().items()}
    h0 = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (SPMM_COLS, n)).astype(np.float32))
    b = torch.from_numpy(np.random.default_rng(4).standard_normal(n)
                         .astype(np.float32))
    val, col, row_ptr = ops["val"], ops["col"], ops["row_ptr"]

    def step(val, col, row_ptr, h, b):
        return torch.relu(naive_spmm(val, col, row_ptr, h) + b)

    fast = lilac.compile(step, mode="host", policy="cuda.bcsr",
                         platform="cpu")
    h, h_ref = h0, h0
    for _ in range(4):
        h = fast(val, col, row_ptr, h[:SPMM_COLS], b)
        h = h / h.abs().max()
        h_ref = step(val, col, row_ptr, h_ref[:SPMM_COLS], b)
        h_ref = h_ref / h_ref.abs().max()
    torch.testing.assert_close(h, h_ref, **TOL)
    (m,) = fast.last_report.matches
    assert (m.computation, m.format, m.epilogue) == ("spmm_csr", "CSR", "relu")
    assert fast.cache.stats.misses == 1
    assert fast.cache.stats.hits + fast.plan_info()["plan_hits"] == 3
    assert fast.cache.plan_stats()["csr_binding_mm->BCSR128x128"][
        "last_path"] == ("CSR", "BCSR128x128")


def _marshaled(fast, kind):
    """The data plane's cached values of container class ``kind``."""
    return [v for v in fast.cache._store.values() if isinstance(v, kind)]


@pytest.mark.parametrize("n", [SPMM_N, 130])
def test_compiled_spmm_marshals_packed_tiles_like_the_reference(n):
    """The naive SpMM compiled for cuda.bcsr on CPU tensors: the marshaled
    value is the packed tile layout (no dense tile), R3's check that
    cuda.bcsr itself served the call, and the result against the JAX
    package's compile of the same program (N = 130 takes the kernel's
    wide body on the card, N = 5 its narrow one)."""
    ops = _spmm_operands()
    ops["dmat"] = np.random.default_rng(n).standard_normal(
        (SPMM_COLS, n)).astype(np.float32)
    names = ("val", "col", "row_ptr", "dmat")
    want = np.asarray(jlilac.compile(spmm_jax)(*(jnp.asarray(ops[k])
                                                 for k in names)))
    fast = lilac.compile(naive_spmm, mode="host", policy="cuda.bcsr",
                         platform="cpu")
    got = fast(*(torch.from_numpy(ops[k]) for k in names))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert [name for _, name in fast.last_selections] == ["cuda.bcsr"]
    (packed,) = _marshaled(fast, tf.PackedBCSR)
    assert not _marshaled(fast, tf.BCSR)
    assert packed.block_shape == (128, 128) and packed.nnz <= SPMM_NNZ
    assert packed.local.dtype == torch.uint16


def test_compiled_spmv_marshals_the_staged_layout_like_the_reference():
    """The naive CSR SpMV compiled for cuda.ell on CPU tensors: the
    marshaled value is the column-window layout at the staged body's
    window (no ELL kept), R3's check that cuda.ell served the call, and
    the result against the JAX package's compile of the same program."""
    ref, csr, v = _operands()
    want = np.asarray(jlilac.compile(naive_jax, mode="host",
                                     policy="jnp.ell")(
        ref.val, ref.col_ind, ref.row_ptr, jnp.asarray(v)))
    fast = lilac.compile(naive, mode="host", policy="cuda.ell",
                         platform="cpu")
    got = fast(csr.val, csr.col_ind, csr.row_ptr, torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert [name for _, name in fast.last_selections] == ["cuda.ell"]
    (layout,) = _marshaled(fast, tf.WindowedELL)
    assert not _marshaled(fast, tf.ELL)
    assert layout.window == 80 and layout.n_windows == 1    # COLS, by 8
    assert layout.perm is not None and layout.col.dtype == torch.uint16


def test_platform_rules():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lilac.compile(naive)
    fast = lilac.compile(naive, mode="host", device="cpu")
    assert fast.platform == "cpu"
    with pytest.raises(ValueError):
        lilac.compile(naive, platform="cuda", device="cpu")
    with pytest.raises(ValueError, match="compiled for 'cpu'"):
        _, csr, v = _operands()
        fast(csr.val.to("meta"), csr.col_ind, csr.row_ptr,
             torch.from_numpy(v))
    with pytest.raises(ValueError, match="mode must be"):
        lilac.compile(naive, mode="jit", platform="cpu")


def test_fingerprint_samples_large_tensors():
    small = torch.arange(100, dtype=torch.float32)
    assert fingerprint(small)[0] == "full"
    big = torch.zeros(1 << 16)
    fp = fingerprint(big)
    assert fp[0] == "sampled"
    big[1000] = 1.0             # off the strided sample: same fingerprint
    assert fingerprint(big) == fp
    big[64 * 7] = 1.0           # on it: changed
    assert fingerprint(big) != fp
    assert fingerprint(big, exact=True)[0] == "full"


def test_data_plane_keeps_the_most_recent_entries():
    """The data plane holds at most max_entries marshaled values; past
    capacity the cheapest to recompute of the least recently used goes
    first (entries 2-8 take 2 ms to build, so of the window keys[1] is the
    cheapest), and a refreshed entry stays."""
    import time

    plane = lilac.DataPlane()
    n = plane.max_entries
    keys = [torch.full((4,), float(i)) for i in range(n + 1)]
    for i, k in enumerate(keys[:n]):
        plane.get("pack", (k,), lambda i=i: (
            time.sleep(0.002) if 2 <= i <= plane.EVICT_WINDOW else None, i)[1])
    assert plane.get("pack", (keys[0],), lambda: -1) == 0    # a hit: recent
    plane.get("pack", (keys[n],), lambda: n)                 # evicts keys[1]
    assert plane.stats.evictions == 1
    assert plane.get("pack", (keys[0],), lambda: -1) == 0
    assert plane.get("pack", (keys[1],), lambda: -1) == -1   # rebuilt
    assert plane.stats.hits == 2 and plane.stats.misses == n + 2


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    root = pathlib.Path(__file__).resolve().parents[1]
    bad = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    names = {f.relative_to(root).as_posix() for f in files}
    for module in ("sparse/convert.py", "kernels/bsr_spmm/ops.py",
                   "kernels/bsr_spmm/kernel.py", "kernels/moe_gmm/ops.py",
                   "kernels/moe_gmm/kernel.py", "models/layers.py",
                   "configs/base.py", "configs/olmoe_1b_7b.py"):
        assert f"src/repro_torch/{module}" in names
    assert len(files) > 30
    for f in files:
        hits = bad.findall(f.read_text())
        assert not hits, f"{f} imports {hits}"
