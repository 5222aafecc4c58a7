"""The port's BCSR path against the JAX package: the BCSR containers and
the direct CSR -> BCSR repack byte for byte, the SpMM ops layer against
the Pallas kernel run in interpret mode (as tests/test_kernels.py runs it),
on dense tiles (packed by the ops layer) and on packed tiles
(``PackedBCSR``, what the kernel reads), and the data plane's planned
path.  On the CPU the kernel wrapper takes its plain version;
tests/test_torch_kernels_gpu.py holds the CUDA kernel itself against that
plain version on the card.

Tolerances: atol = rtol = 1e-4 in f32 (the reference's own, for sums in
another order); 5e-2 for bf16 storage (the reference's bf16 tolerance).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bsr_spmm import ops as ref_ops
from repro.sparse import convert as jconvert
from repro.sparse import formats as jf
from repro.sparse import random as jrandom
from repro_torch import lilac
from repro_torch.core import marshal as M
from repro_torch.kernels.bsr_spmm import kernel as K
from repro_torch.kernels.bsr_spmm import ops as bsr_ops
from repro_torch.sparse import convert as tconvert
from repro_torch.sparse import formats as tf

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)


def _same(torch_c, jax_c):
    for name, arr in tf.to_numpy(torch_c).items():
        ref = getattr(jax_c, name)
        if name in ("shape", "block_shape"):
            assert tuple(arr) == tuple(ref), name
            continue
        ref = np.asarray(ref)
        assert arr.dtype == ref.dtype and arr.shape == ref.shape, name
        assert arr.tobytes() == ref.tobytes(), name


LAYOUTS = ["tiles", "packed"]


def _as(layout, bcsr):
    """The ops layer's operand: the dense tiles, or their packed form."""
    return tf.pack_bcsr(bcsr) if layout == "packed" else bcsr


def _dense_operand(cols, n, seed=1, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((cols, n)).astype(dtype)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("rows,cols,n,bm,density", [
    (256, 384, 256, 128, 0.3),
    (128, 128, 128, 64, 0.5),
    (384, 256, 128, 128, 0.1),
])
def test_bsr_spmm_shapes_match_pallas(rows, cols, n, bm, density, layout):
    ref = jrandom.random_bcsr(rows, cols, block_shape=(bm, 128),
                              block_density=density, seed=rows + n)
    x = _dense_operand(cols, n)
    want = ref_ops.bsr_spmm(ref, jnp.asarray(x), interpret=True)
    got = bsr_ops.bsr_spmm(_as(layout, tf.from_numpy(ref)),
                           torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    oracle = bsr_ops.bsr_spmm_oracle(tf.from_numpy(ref), torch.from_numpy(x))
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_bsr_spmm_bf16_matches_pallas(layout):
    ref = jrandom.random_bcsr(256, 256, block_shape=(128, 128),
                              block_density=0.4, seed=7)
    blocks = np.asarray(ref.blocks).astype(jnp.bfloat16)
    jb = jf.BCSR(jnp.asarray(blocks), ref.block_col, ref.block_rowptr,
                 ref.shape, ref.block_shape)
    x = _dense_operand(256, 128, seed=2).astype(jnp.bfloat16)
    want = ref_ops.bsr_spmm(jb, jnp.asarray(x), interpret=True)
    t = tf.from_numpy(ref)
    t = tf.BCSR(torch.from_numpy(blocks.astype(np.float32)).to(torch.bfloat16),
                t.block_col, t.block_rowptr, t.shape, t.block_shape)
    t = _as(layout, t)
    if layout == "packed":
        assert t.val.dtype == torch.bfloat16
    got = bsr_ops.bsr_spmm(t, torch.from_numpy(x.astype(np.float32))
                           .to(torch.bfloat16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **BF16_TOL)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_bsr_spmm_empty_block_rows_match_pallas(layout):
    d = np.zeros((256, 256), np.float32)
    d[:128] = np.random.default_rng(0).standard_normal((128, 256))
    ref = jf.bcsr_from_dense(d, (128, 128))
    t = tf.bcsr_from_dense(d, (128, 128))
    _same(t, ref)
    assert t.all_block_rows_nonempty      # the explicit zero tile
    bare = tf.BCSR(t.blocks[:1], t.block_col[:1],
                   torch.tensor([0, 1, 1], dtype=torch.int32), t.shape,
                   t.block_shape)
    assert not bare.all_block_rows_nonempty
    x = _dense_operand(256, 128)
    got = bsr_ops.bsr_spmm(_as(layout, t), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy()[128:], 0.0)
    # the bare container (no tile in block row 1) as well
    got_bare = bsr_ops.bsr_spmm(_as(layout, bare), torch.from_numpy(x))
    np.testing.assert_allclose(got_bare.numpy()[128:], 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        ref_ops.bsr_spmm(ref, jnp.asarray(x), interpret=True)), **TOL)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("epilogue", ["relu", "silu", "none"])
@pytest.mark.parametrize("kind", ["row", "col"])
def test_bsr_spmm_fused_epilogues_match_pallas(epilogue, kind, layout):
    """Row and column biases with every epilogue, on a matrix with an
    empty block row: the reference falls back to its unfused epilogue
    there, the port's kernel writes epilogue(0 + bias) itself."""
    d = np.asarray(jrandom.random_dense_sparse(384, 256, 0.05, seed=3))
    d[128:256] = 0
    ref = jf.bcsr_from_dense(d, (128, 128))
    x = _dense_operand(256, 128)
    bias = np.random.default_rng(4).standard_normal(
        384 if kind == "row" else 128).astype(np.float32)
    want = ref_ops.bsr_spmm(ref, jnp.asarray(x), epilogue=epilogue,
                            bias=jnp.asarray(bias), bias_kind=kind,
                            interpret=True)
    got = bsr_ops.bsr_spmm(_as(layout, tf.from_numpy(ref)),
                           torch.from_numpy(x), epilogue=epilogue,
                           bias=torch.from_numpy(bias), bias_kind=kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", [1, 6, 200])
def test_bsr_spmm_ragged_n_matches_pallas(n, layout):
    """N off the 128-column tile: the reference pads N, the port's kernel
    masks the edge."""
    ref = jrandom.random_bcsr(256, 256, block_shape=(128, 128),
                              block_density=0.5, seed=n)
    x = _dense_operand(256, n)
    bias = np.random.default_rng(5).standard_normal(256).astype(np.float32)
    want = ref_ops.bsr_spmm(ref, jnp.asarray(x), epilogue="relu",
                            bias=jnp.asarray(bias), bias_kind="row",
                            interpret=True)
    got = bsr_ops.bsr_spmm(_as(layout, tf.from_numpy(ref)),
                           torch.from_numpy(x), epilogue="relu",
                           bias=torch.from_numpy(bias))
    assert got.shape == (256, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_kernel_wrapper_takes_the_plain_version_on_cpu():
    ref = jrandom.random_bcsr(256, 256, block_shape=(128, 128),
                              block_density=0.5, seed=2)
    t = tf.pack_bcsr(tf.from_numpy(ref))
    x = torch.from_numpy(_dense_operand(256, 128))
    before = dict(K.LAUNCHES)
    out = K.bsr_spmm_cuda(t, x, out_rows=200)
    assert K.LAUNCHES == before      # no launch on the CPU
    assert out.shape == (200, 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(
        ref_ops.bsr_spmm_oracle(ref, jnp.asarray(x.numpy())))[:200], **TOL)


def _csr_with_edge_cases(rows, cols):
    """A CSR with a duplicate entry, an explicit stored zero, an empty
    block row (rows 8..15) and ragged edges."""
    d = np.asarray(jrandom.random_dense_sparse(rows, cols, 0.1, seed=rows))
    d[8:16] = 0
    r, c = np.nonzero(d)
    v = d[r, c]
    r = np.concatenate([r, [0, 1]])
    c = np.concatenate([c, [c[0], cols - 1]])
    v = np.concatenate([v, [0.5, 0.0]]).astype(np.float32)
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=rows))])
    return jf.CSR(jnp.asarray(v), jnp.asarray(c.astype(np.int32)),
                  jnp.asarray(row_ptr.astype(np.int32)), (rows, cols))


@pytest.mark.parametrize("block_shape", [(8, 128), (128, 128)])
@pytest.mark.parametrize("rows,cols", [(45, 300), (130, 129), (16, 128)])
def test_csr_to_bcsr_byte_identical(block_shape, rows, cols):
    ref = _csr_with_edge_cases(rows, cols)
    _same(tconvert.csr_to_bcsr(tf.from_numpy(ref), block_shape),
          jconvert.csr_to_bcsr(ref, block_shape))


@pytest.mark.parametrize("block_shape", [(8, 128), (64, 128), (128, 128)])
@pytest.mark.parametrize("density", [0.0, 0.002, 0.05])
def test_bcsr_from_dense_byte_identical(block_shape, density):
    d = np.asarray(jrandom.random_dense_sparse(256, 384, density, seed=3))
    _same(tf.bcsr_from_dense(d, block_shape), jf.bcsr_from_dense(d, block_shape))
    np.testing.assert_array_equal(
        tf.bcsr_from_dense(d, block_shape).todense().numpy(), d)


def test_bcsr_pack_plans_the_direct_edge_never_dense():
    """CSR -> BCSR128x128 takes the direct edge even when a densified copy
    of the same matrix is cached and the CSR -> DENSE edge measured cheap:
    the planner never routes a BCSR repack through DENSE."""
    ref = _csr_with_edge_cases(130, 129)
    csr = tf.from_numpy(ref)
    dense = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (129, 4)).astype(np.float32))
    binding = {"a": csr.val, "colidx": csr.col_ind, "rowstr": csr.row_ptr,
               "rows": 130, "nnz": csr.nnz, "dense": dense}
    keys = (csr.val, csr.col_ind, csr.row_ptr)
    plane = M.DataPlane()
    plane.ensure("csr_binding_mm", "DENSE", keys, binding)
    assert plane.plans["csr_binding_mm", "DENSE"].last_path == ("CSR", "DENSE")
    for dst in ("BCSR128x128", "BCSR8x128"):
        plane.ensure("csr_binding_mm", dst, keys, binding)
        assert plane.plans["csr_binding_mm", dst].last_path == ("CSR", dst)
    assert M.GRAPH.plan({"CSR": 1.0}, "BCSR128x128")[1][0].name \
        == "csr_to_bcsr128x128"
    # a dense source still reaches BCSR through its own edge
    assert M.GRAPH.plan({"DENSE": 0.0}, "BCSR8x128")[1][0].name \
        == "dense_to_bcsr8x128"


def test_compiled_bcsr_spmv_on_cpu_matches_naive():
    """spmv_csr under policy='cuda.bcsr' on CPU tensors: the marshaled
    BCSR128x128 and the kernel's plain version, with a fused relu."""
    ref = _csr_with_edge_cases(130, 129)
    csr = tf.from_numpy(ref)
    rng = np.random.default_rng(1)
    v = torch.from_numpy(rng.standard_normal(129).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(130).astype(np.float32))

    def layer(val, col, row_ptr, v, b):
        rows = row_ptr.shape[0] - 1
        row = torch.repeat_interleave(torch.arange(rows), torch.diff(row_ptr),
                                      output_size=val.shape[0])
        return torch.relu(torch.zeros(rows).index_add_(0, row, val * v[col])
                          + b)

    for policy in ("cuda.bcsr", "torch.bcsr"):
        fast = lilac.compile(layer, policy=policy, platform="cpu")
        got = fast(csr.val, csr.col_ind, csr.row_ptr, v, b)
        torch.testing.assert_close(got, layer(csr.val, csr.col_ind,
                                              csr.row_ptr, v, b), **TOL)
        assert [n for _, n in fast.last_selections] == [policy]
        (m,) = fast.last_report.matches
        assert (m.computation, m.format, m.epilogue) \
            == ("spmv_csr", "CSR", "relu")
        # cuda.bcsr's kernel reads packed tiles, torch.bcsr dense ones
        tiles = [v for v in fast.cache._store.values()
                 if isinstance(v, (tf.BCSR, tf.PackedBCSR))]
        assert [type(v) for v in tiles] == [
            tf.PackedBCSR if policy == "cuda.bcsr" else tf.BCSR]
