"""The slice end to end: ``repro_torch.lilac.compile`` in host mode against
``repro.lilac.compile`` on the same CSR and vector, the data plane's
one-repack contract over a CG loop, the platform rules, and the package's
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

ROWS, COLS = 96, 80
TOL = dict(atol=1e-4, rtol=1e-4)


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
    fast = lilac.compile(naive, policy=policy, platform="cpu")
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
    call from the data plane."""
    n = 120
    csr = trandom.random_spd_csr(n, 9, seed=1)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(n)
                         .astype(np.float32))
    fast = lilac.compile(naive, mode="host", policy="cuda.ell", platform="cpu")
    x = cg(fast, csr, b, iters=10)
    x_ref = cg(naive, csr, b, iters=10)
    torch.testing.assert_close(x, x_ref, atol=1e-4, rtol=1e-4)
    assert fast.cache.stats.misses == 1 and fast.cache.stats.hits == 10
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
        fast = lilac.compile(layer, policy=policy, platform="cpu")
        torch.testing.assert_close(fast(val, col, vec, bias),
                                   layer(val, col, vec, bias), **TOL)
        (m,) = fast.last_report.matches
        assert m.epilogue == "relu" and "bias" in m.binding
        assert [n for _, n in fast.last_selections] == [name]


def test_platform_rules():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lilac.compile(naive)
    fast = lilac.compile(naive, device="cpu")
    assert fast.platform == "cpu"
    with pytest.raises(ValueError):
        lilac.compile(naive, platform="cuda", device="cpu")
    with pytest.raises(ValueError, match="compiled for 'cpu'"):
        _, csr, v = _operands()
        fast(csr.val.to("meta"), csr.col_ind, csr.row_ptr,
             torch.from_numpy(v))
    with pytest.raises(NotImplementedError):
        lilac.compile(naive, mode="trace", platform="cpu")


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
    """The data plane holds at most MAX_ENTRIES marshaled values and lets
    the least recently used go first."""
    plane = lilac.DataPlane()
    n = plane.MAX_ENTRIES
    keys = [torch.full((4,), float(i)) for i in range(n + 1)]
    for i, k in enumerate(keys[:n]):
        plane.get("pack", (k,), lambda i=i: i)
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
    assert len(files) > 20
    for f in files:
        hits = bad.findall(f.read_text())
        assert not hits, f"{f} imports {hits}"
