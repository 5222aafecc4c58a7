"""Detection parity: the same naive SpMV written in torch and in JAX must
give the same computation, format, fused epilogue and binding — each
binding key naming the same function argument (or the same integer) —
from the port's FX-graph detector and the JAX package's jaxpr detector."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import detect as JD
from repro_torch.core import detect as TD

ROWS, COLS, NNZ, W = 16, 8, 40, 8


def _arrays():
    rng = np.random.default_rng(0)
    cuts = np.sort(rng.integers(0, NNZ + 1, ROWS - 1))
    return dict(
        val=rng.standard_normal(NNZ).astype(np.float32),
        col=rng.integers(0, COLS, NNZ).astype(np.int32),
        row=np.sort(rng.integers(0, ROWS, NNZ)).astype(np.int32),
        row_ptr=np.concatenate([[0], cuts, [NNZ]]).astype(np.int32),
        vec=rng.standard_normal(COLS).astype(np.float32),
        val2=rng.standard_normal((ROWS, W)).astype(np.float32),
        col2=rng.integers(0, COLS, (ROWS, W)).astype(np.int32),
        perm=rng.permutation(ROWS).astype(np.int32),
        bias=rng.standard_normal(ROWS).astype(np.float32),
    )


# -- the two spellings of each program ---------------------------------------

def csr_jax(val, col, row_ptr, v):          # examples/quickstart.py
    row = jnp.repeat(jnp.arange(ROWS, dtype=jnp.int32), jnp.diff(row_ptr),
                     total_repeat_length=val.shape[0])
    return jax.ops.segment_sum(val * v[col], row, num_segments=ROWS)


def csr_torch(val, col, row_ptr, v):
    row = torch.repeat_interleave(torch.arange(ROWS), torch.diff(row_ptr),
                                  output_size=val.shape[0])
    return torch.zeros(ROWS).index_add_(0, row, val * v[col])


def csr_search_jax(val, col, row_ptr, v):
    row = jnp.searchsorted(row_ptr, jnp.arange(NNZ, dtype=jnp.int32),
                           side="right").astype(jnp.int32) - 1
    return jax.ops.segment_sum(val * v[col], row, num_segments=ROWS)


def csr_search_torch(val, col, row_ptr, v):
    row = torch.searchsorted(row_ptr, torch.arange(NNZ, dtype=torch.int32),
                             right=True) - 1
    return torch.zeros(ROWS).scatter_add_(0, row.long(), val * v[col.long()])


def csr_relu_jax(val, col, row_ptr, v, bias):
    return jax.nn.relu(csr_jax(val, col, row_ptr, v) + bias)


def csr_relu_torch(val, col, row_ptr, v, bias):
    return torch.relu(csr_torch(val, col, row_ptr, v) + bias)


def coo_jax(val, row, col, v):
    return jax.ops.segment_sum(v[col] * val, row, num_segments=ROWS)


def coo_torch(val, row, col, v):
    out = torch.zeros(ROWS)
    out.index_put_((row,), v[col] * val, accumulate=True)
    return out


def ell_jax(val2, col2, vec):
    return jnp.sum(val2 * vec[col2], axis=1)


def ell_torch(val2, col2, vec):
    return (val2 * vec[col2]).sum(dim=1)


def ell_relu_bias_jax(val2, col2, vec, bias):
    return jax.nn.relu(jnp.sum(val2 * vec[col2], axis=1) + bias)


def ell_relu_bias_torch(val2, col2, vec, bias):
    return torch.relu((val2 * vec[col2]).sum(dim=1) + bias)


def ell_silu_jax(val2, col2, vec):
    return jax.nn.silu(jnp.sum(val2 * vec[col2], axis=1))


def ell_silu_torch(val2, col2, vec):
    s = torch.sum(val2 * vec[col2], dim=1)
    return s * torch.sigmoid(s)


def jds_jax(val2, col2, perm, vec):
    acc = jnp.sum(val2 * vec[col2], axis=1)
    return jnp.zeros(ROWS, acc.dtype).at[perm].set(acc)


def jds_torch(val2, col2, perm, vec):
    acc = (val2 * vec[col2]).sum(1)
    out = torch.zeros(ROWS)
    out[perm] = acc
    return out


CASES = [
    (csr_jax, csr_torch, ("val", "col", "row_ptr", "vec")),
    (csr_search_jax, csr_search_torch, ("val", "col", "row_ptr", "vec")),
    (csr_relu_jax, csr_relu_torch, ("val", "col", "row_ptr", "vec", "bias")),
    (coo_jax, coo_torch, ("val", "row", "col", "vec")),
    (ell_jax, ell_torch, ("val2", "col2", "vec")),
    (ell_relu_bias_jax, ell_relu_bias_torch, ("val2", "col2", "vec", "bias")),
    (ell_silu_jax, ell_silu_torch, ("val2", "col2", "vec")),
    (jds_jax, jds_torch, ("val2", "col2", "perm", "vec")),
]


def _summary(matches, inputs):
    """Per match: (computation, format, epilogue, {key: arg index | int})."""
    out = []
    for m in matches:
        b = {}
        for k, v in m.binding.items():
            if isinstance(v, (int, float)):
                b[k] = ("num", v)
            else:
                b[k] = ("arg", inputs.index(v)) if v in inputs else "derived"
        out.append((m.computation, m.format, m.epilogue, b))
    return out


@pytest.mark.parametrize("fj,ft,names", CASES,
                         ids=[c[1].__name__ for c in CASES])
def test_detection_matches_reference(fj, ft, names):
    arrs = _arrays()
    jargs = [jnp.asarray(arrs[n]) for n in names]
    targs = [torch.from_numpy(arrs[n]) for n in names]
    ncj = JD.normalize_closed_jaxpr(jax.make_jaxpr(fj)(*jargs))
    want = _summary(JD.Detector().detect(ncj, normalize=False).matches,
                    list(ncj.jaxpr.invars))
    gm = TD.trace(ft, targs)
    got = _summary(TD.Detector().detect(gm).matches,
                   [n for n in gm.graph.nodes if n.op == "placeholder"])
    assert len(want) == 1
    assert got == want
    # the traced graph computes what the program computes
    torch.testing.assert_close(gm(*targs), ft(*targs))


def test_no_match_without_the_skeleton():
    """Negative controls: a scatter-add onto a non-zero operand, a
    gathered product that is never reduced, a padded row sum whose index
    is broadcast, and a scatter-add of one scalar weight are not SpMVs."""
    arrs = _arrays()
    val, row, col, vec = (torch.from_numpy(arrs[n])
                          for n in ("val", "row", "col", "vec"))

    def accumulate_into(val, row, col, vec):
        return torch.ones(ROWS).index_add_(0, row, val * vec[col])

    def unreduced(val, col, vec):
        return val * vec[col]

    def broadcast_index(val2, col, vec):
        return (val2 * vec[col[:W]]).sum(dim=1)

    def scalar_weight(val, row, col, vec):
        return torch.zeros(ROWS).index_add_(0, row, val[0] * vec[col])

    det = TD.Detector()
    assert det.detect_fn(accumulate_into, val, row, col, vec).matches == []
    assert det.detect_fn(unreduced, val, col, vec).matches == []
    val2 = torch.from_numpy(arrs["val2"])
    assert det.detect_fn(broadcast_index, val2, col, vec).matches == []
    assert det.detect_fn(scalar_weight, val, row, col, vec).matches == []


def test_row_expansion_is_validated_not_assumed():
    """A (rows+1,) integer input that feeds the row ids but is not a row
    pointer (here: row ids taken modulo) stays COO."""
    arrs = _arrays()
    val, col, row_ptr, vec = (torch.from_numpy(arrs[n])
                              for n in ("val", "col", "row_ptr", "vec"))

    def not_csr(val, col, row_ptr, v):
        row = (torch.arange(NNZ) + row_ptr[0]) % ROWS
        return torch.zeros(ROWS).index_add_(0, row, val * v[col])

    (m,) = TD.Detector().detect_fn(not_csr, val, col, row_ptr, vec).matches
    assert m.format == "COO"
    assert "rowidx" in m.binding and "rowstr" not in m.binding


@pytest.mark.parametrize("error,verdict", [
    (RuntimeError("shape '[240]' is invalid for input of size 7"), "COO"),
    (IndexError("index 9 is out of bounds"), "COO"),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), "raises"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "raises"),
])
def test_row_expansion_validation_rejects_or_raises(monkeypatch, error,
                                                    verdict):
    """A row-expansion subgraph that fails to evaluate on a trial row_ptr
    is not CSR; a fault of the card is no verdict, and raises."""
    arrs = _arrays()
    args = [torch.from_numpy(arrs[n]) for n in ("val", "col", "row_ptr", "vec")]

    def fail(self, out, leaf_values):
        raise error

    monkeypatch.setattr(TD.Ctx, "eval_subgraph", fail)
    if verdict == "raises":
        with pytest.raises(type(error)):
            TD.Detector().detect_fn(csr_torch, *args)
        return
    (m,) = TD.Detector().detect_fn(csr_torch, *args).matches
    assert m.format == verdict and "rowstr" not in m.binding
