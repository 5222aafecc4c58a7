"""Deterministic sparse matrix generators (host-side numpy).

``random_dense_sparse``, ``random_csr``, ``random_bcsr`` and
``random_graph_csr`` are the counterparts of ``repro.sparse.random`` and
give the same bytes from the same seed.  The first three build a dense
``rows x cols`` array first, so they serve small sizes only;
``random_graph_csr`` draws the reference's stream a block of rows at a
time, and ``random_spd_csr`` and ``stencil27_csr`` build CSR directly and
reach the sizes sparse solvers run (a symmetric diagonally dominant matrix
at the NAS CG benchmark's sizes, and HPCG's 27-point operator).
"""
from __future__ import annotations

import numpy as np

from repro_torch.sparse.formats import (BCSR, CSR, _t, bcsr_from_dense,
                                        csr_from_dense)


def random_dense_sparse(rows: int, cols: int, density: float, seed: int = 0,
                        dtype=np.float32, skew: float = 0.0) -> np.ndarray:
    """Dense array with ~density nonzeros; ``skew`` > 0 gives power-law rows
    (graph-like degree distribution, the hard case for padded formats)."""
    rng = np.random.default_rng(seed)
    if skew > 0:
        # per-row density drawn from a Pareto-ish distribution
        row_density = density * (1.0 + rng.pareto(1.0 + 1.0 / skew, rows))
        row_density = np.minimum(row_density, 1.0)
        mask = rng.random((rows, cols)) < row_density[:, None]
    else:
        mask = rng.random((rows, cols)) < density
    vals = rng.standard_normal((rows, cols)).astype(dtype)
    return np.where(mask, vals, 0).astype(dtype)


def random_csr(rows: int, cols: int, density: float = 0.05, seed: int = 0,
               dtype=np.float32, skew: float = 0.0, device="cpu") -> CSR:
    return csr_from_dense(
        random_dense_sparse(rows, cols, density, seed, dtype, skew), device)


def random_bcsr(rows: int, cols: int, block_shape=(8, 128),
                block_density: float = 0.2, seed: int = 0,
                dtype=np.float32, device="cpu") -> BCSR:
    rng = np.random.default_rng(seed)
    bm, bn = block_shape
    mask = rng.random((rows // bm, cols // bn)) < block_density
    d = rng.standard_normal((rows, cols)).astype(dtype)
    d = d * np.kron(mask, np.ones((bm, bn))).astype(dtype)
    return bcsr_from_dense(d, block_shape, device)


#: rows of the (rows, nodes) float64 draw random_graph_csr holds at once
GRAPH_DRAW_ELEMENTS = 1 << 24


def random_graph_csr(nodes: int, avg_degree: float = 8.0, seed: int = 0,
                     dtype=np.float32, device="cpu") -> CSR:
    """Erdos-Renyi-ish adjacency in CSR, no self-loops, each column's
    entries summing to one (column-stochastic: PageRank's links).  The
    reference draws one (nodes, nodes) float64 matrix; the same stream is
    drawn here a block of rows at a time (``Generator.random`` fills row
    by row), so the bytes are the reference's with ~128 MB held at once
    instead of 8·nodes² bytes."""
    rng = np.random.default_rng(seed)
    density = min(1.0, avg_degree / nodes)
    step = max(1, GRAPH_DRAW_ELEMENTS // max(nodes, 1))
    rs, cs = [], []
    for r0 in range(0, nodes, step):
        mask = rng.random((min(step, nodes - r0), nodes)) < density
        r, c = np.nonzero(mask)          # row-major: CSR order
        keep = r + r0 != c
        rs.append(r[keep] + r0)
        cs.append(c[keep])
    r = np.concatenate(rs) if rs else np.zeros(0, np.int64)
    c = np.concatenate(cs) if cs else np.zeros(0, np.int64)
    deg = np.bincount(c, minlength=nodes).astype(dtype)
    val = np.divide(np.ones(c.shape[0], dtype), np.maximum(deg, 1.0)[c],
                    dtype=dtype)
    row_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(r, minlength=nodes))]).astype(np.int32)
    return CSR(val=_t(val, device), col_ind=_t(c.astype(np.int32), device),
               row_ptr=_t(row_ptr, device), shape=(nodes, nodes))


def _csr_from_triplets(r, c, v, n, device) -> CSR:
    """Sorted, duplicate-summed CSR from (row, col, val) triplets."""
    key = r.astype(np.int64) * n + c
    order = np.argsort(key, kind="stable")
    key, v = key[order], v[order]
    first = np.concatenate([[True], key[1:] != key[:-1]])
    starts = np.flatnonzero(first)
    val = np.add.reduceat(v, starts).astype(np.float32) if v.size else v
    key = key[starts]
    rows = (key // n).astype(np.int64)
    row_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(rows, minlength=n))]).astype(np.int32)
    return CSR(val=_t(val, device), col_ind=_t((key % n).astype(np.int32), device),
               row_ptr=_t(row_ptr, device), shape=(n, n))


def random_spd_csr(n: int, row_nnz: int, seed: int = 0, device="cpu") -> CSR:
    """Symmetric, strictly diagonally dominant (so positive definite) n x n
    matrix with about ``row_nnz`` stored entries a row at random columns:
    ``n*(row_nnz-1)/2`` random off-diagonal pairs mirrored across the
    diagonal, standard-normal values, and a diagonal of 1 + the row's
    absolute off-diagonal sum."""
    rng = np.random.default_rng(seed)
    m = n * (row_nnz - 1) // 2
    i = rng.integers(0, n, m)
    j = rng.integers(0, n, m)
    keep = i != j
    i, j = i[keep], j[keep]
    a = rng.standard_normal(i.shape[0]).astype(np.float32)
    r = np.concatenate([i, j])
    c = np.concatenate([j, i])
    v = np.concatenate([a, a])
    diag = 1.0 + np.bincount(r, weights=np.abs(v), minlength=n)
    d = np.arange(n)
    return _csr_from_triplets(np.concatenate([r, d]), np.concatenate([c, d]),
                              np.concatenate([v, diag.astype(np.float32)]),
                              n, device)


def stencil27_csr(nx: int, ny: int, nz: int, device="cpu") -> CSR:
    """HPCG's operator: the 27-point stencil on an nx*ny*nz grid, 26 on the
    diagonal and -1 for every neighbour inside the grid, rows in HPCG's
    order (x fastest) and columns ascending within a row."""
    n = nx * ny * nz
    ix = np.arange(n) % nx
    iy = (np.arange(n) // nx) % ny
    iz = np.arange(n) // (nx * ny)
    cols, vals, ok = [], [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                inside = ((ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0)
                          & (iy + dy < ny) & (iz + dz >= 0) & (iz + dz < nz))
                cols.append(np.arange(n) + dx + nx * (dy + ny * dz))
                vals.append(26.0 if dx == dy == dz == 0 else -1.0)
                ok.append(inside)
    ok = np.stack(ok, axis=1)                                  # (n, 27)
    col = np.stack(cols, axis=1)[ok].astype(np.int32)          # row-major
    val = np.broadcast_to(np.asarray(vals, np.float32), ok.shape)[ok]
    row_ptr = np.concatenate([[0], np.cumsum(ok.sum(axis=1))]).astype(np.int32)
    return CSR(val=_t(val, device), col_ind=_t(col, device),
               row_ptr=_t(row_ptr, device), shape=(n, n))
