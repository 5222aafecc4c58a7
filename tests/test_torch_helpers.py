"""The port's public helpers against the JAX package's, on seeded inputs:
the random generators (``random_graph_csr`` byte for byte, also when it
draws its stream in several blocks of rows), the reference ops
``spmv_jds_ref`` / ``spmm_csr_ref``, the conversions ``infer_cols``,
``csr_to_dense`` and ``pad_vector``, ``tree_nbytes``,
``Model.abstract_params`` and the re-exports of ``repro_torch.train``;
and the graph the port's BFS and PageRank examples run on, which is the
reference examples' graph.

Tolerances: the generators and conversions exact; the f32 reference ops
within 1e-5 relative (their sums run in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, smoke_config as jsmoke
from repro.core import marshal as jmarshal
from repro.models import build_model as jbuild_model
from repro.sparse import convert as jconvert
from repro.sparse import formats as jf
from repro.sparse import ops as jops
from repro.sparse import random as jrandom
from repro_torch.configs import get_arch, smoke_config
from repro_torch.core import marshal as tmarshal
from repro_torch.examples import bfs, pagerank
from repro_torch.models import build_model
from repro_torch.models.spec import leaves
from repro_torch.sparse import convert as tconvert
from repro_torch.sparse import formats as tf
from repro_torch.sparse import ops as tops
from repro_torch.sparse import random as trandom


def _same(torch_c, jax_c):
    for name, arr in tf.to_numpy(torch_c).items():
        ref = getattr(jax_c, name)
        if name in ("shape", "block_shape"):
            assert tuple(arr) == tuple(ref)
            continue
        ref = np.asarray(ref)
        assert arr.dtype == ref.dtype and arr.shape == ref.shape, name
        assert arr.tobytes() == ref.tobytes(), name


@pytest.mark.parametrize("nodes,degree,seed,block", [
    (300, 8.0, 0, None), (512, 16.0, 3, None), (257, 4.0, 1, 300 * 7),
    (64, 100.0, 2, 64), (1, 8.0, 0, None)])
def test_random_graph_csr_is_the_references(nodes, degree, seed, block,
                                            monkeypatch):
    """The same bytes as the reference's one (nodes, nodes) draw, also
    when the stream is drawn a few rows at a time (``block`` elements)."""
    if block is not None:
        monkeypatch.setattr(trandom, "GRAPH_DRAW_ELEMENTS", block)
    got = trandom.random_graph_csr(nodes, avg_degree=degree, seed=seed)
    _same(got, jrandom.random_graph_csr(nodes, avg_degree=degree, seed=seed))
    # no self-loops; each linked column sums to one
    row = np.repeat(np.arange(nodes), np.diff(got.row_ptr.numpy()))
    assert not np.any(row == got.col_ind.numpy())
    sums = np.bincount(got.col_ind.numpy(), weights=got.val.numpy(),
                       minlength=nodes)
    linked = np.unique(got.col_ind.numpy())
    np.testing.assert_allclose(sums[linked], 1.0, rtol=1e-6)


@pytest.mark.parametrize("rows,cols,block,density,seed", [
    (64, 256, (8, 128), 0.3, 0), (32, 32, (8, 8), 0.5, 4),
    (16, 128, (8, 128), 0.0, 1)])
def test_random_bcsr_is_the_references(rows, cols, block, density, seed):
    _same(trandom.random_bcsr(rows, cols, block, density, seed),
          jrandom.random_bcsr(rows, cols, block, density, seed))


@pytest.mark.parametrize("rows,cols,density,skew", [
    (200, 300, 0.05, 0.0), (512, 128, 0.02, 1.0), (9, 5, 0.0, 0.0)])
def test_spmv_jds_ref_is_the_references(rows, cols, density, skew):
    dense = jrandom.random_dense_sparse(rows, cols, density, seed=5,
                                        skew=skew)
    vec = np.random.default_rng(6).standard_normal(cols).astype(np.float32)
    got = tops.spmv_jds_ref(tf.jds_from_csr(tf.csr_from_dense(dense)),
                            torch.from_numpy(vec))
    want = jops.spmv_jds_ref(jf.jds_from_csr(jf.csr_from_dense(dense)),
                             jnp.asarray(vec))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), dense @ vec, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n", [1, 7, 32])
def test_spmm_csr_ref_is_the_references(n):
    dense = jrandom.random_dense_sparse(150, 90, 0.08, seed=7)
    x = np.random.default_rng(8).standard_normal((90, n)).astype(np.float32)
    got = tops.spmm_csr_ref(tf.csr_from_dense(dense), torch.from_numpy(x))
    want = jops.spmm_csr_ref(jf.csr_from_dense(dense), jnp.asarray(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("col,explicit", [
    ([3, 0, 9, 2], None), ([3, 0, 9, 2], 40), ([], None), ([0], None)])
def test_infer_cols_is_the_references(col, explicit):
    want = jconvert.infer_cols(np.asarray(col, np.int32), explicit)
    assert tconvert.infer_cols(np.asarray(col, np.int32), explicit) == want
    assert tconvert.infer_cols(torch.tensor(col, dtype=torch.int32),
                               explicit) == want


def test_csr_to_dense_and_pad_vector_are_the_references():
    dense = jrandom.random_dense_sparse(40, 30, 0.1, seed=9)
    got = tconvert.csr_to_dense(tf.csr_from_dense(dense))
    want = jconvert.csr_to_dense(jf.csr_from_dense(dense))
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    v = np.arange(5, dtype=np.float32)
    for to in (3, 5, 9):
        got = tconvert.pad_vector(torch.from_numpy(v), to)
        want = np.asarray(jconvert.pad_vector(v, to))
        assert got.numpy().tobytes() == want.tobytes(), to
        assert tconvert.pad_vector(v, to).numpy().tobytes() == want.tobytes()


def test_tree_nbytes_is_the_references():
    rng = np.random.default_rng(10)
    arrays = [rng.standard_normal((7, 3)).astype(np.float32),
              np.arange(11, dtype=np.int32),
              rng.standard_normal(5).astype(np.float16)]

    def tree(a):
        return (a[0], {"x": [a[1], (a[2],)], "y": None}, [])

    want = jmarshal.tree_nbytes(tree([jnp.asarray(a) for a in arrays]))
    assert want == 7 * 3 * 4 + 11 * 4 + 5 * 2
    assert tmarshal.tree_nbytes(
        tree([torch.from_numpy(a) for a in arrays])) == want


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-v0.1-52b"])
def test_abstract_params_are_the_references(arch):
    """Meta tensors of the reference's shapes and dtypes, the published
    config and the smoke one, with nothing allocated."""
    for tcfg, jcfg in ((get_arch(arch), jget_arch(arch)),
                       (smoke_config(get_arch(arch)),
                        jsmoke(jget_arch(arch)))):
        got = dict(leaves(build_model(tcfg).abstract_params()))
        want = {"/".join(str(getattr(k, "key", k)) for k in path): s
                for path, s in jax.tree_util.tree_flatten_with_path(
                    jbuild_model(jcfg).abstract_params())[0]}
        assert set(got) == set(want)
        for name, t in got.items():
            assert t.device.type == "meta", name
            assert tuple(t.shape) == tuple(want[name].shape), name
            assert str(t.dtype).split(".")[-1] == str(want[name].dtype), name


def test_train_reexports_are_the_references():
    import repro.train as jtrain
    import repro_torch.train as ttrain
    from repro_torch.train import optim, train_step
    names = ("AdamWConfig", "adamw_init", "adamw_update", "make_train_step",
             "make_serve_step")
    for name in names:
        assert hasattr(jtrain, name), name
    assert [getattr(ttrain, n) for n in names] == [
        optim.AdamWConfig, optim.adamw_init, optim.adamw_update,
        train_step.make_train_step, train_step.make_serve_step]


@pytest.mark.parametrize("example,degree", [("bfs", 8), ("pagerank", 16)])
def test_graph_examples_run_on_the_reference_graph(example, degree):
    """The port's BFS and PageRank examples draw the reference examples'
    graph (``random_graph_csr`` at their degree, seed 0); BFS takes its
    0/1 values, PageRank its column-stochastic ones."""
    n = 700
    g, val = (bfs.graph if example == "bfs" else pagerank.links)(n, "cpu")
    want = jrandom.random_graph_csr(n, avg_degree=degree, seed=0)
    _same(g, want)
    want_val = ((np.asarray(want.val) > 0).astype(np.float32)
                if example == "bfs" else np.asarray(want.val))
    assert val.numpy().tobytes() == want_val.tobytes()
