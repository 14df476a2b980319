"""Block-ELL sparse matrix-vector product (plain XLA).

The general sparse-operator tier (SURVEY.md §2 SpMV; BASELINE: ">= 80% of
roofline SpMV nnz/s per chip").  The matrix is cut into (bm x bn) dense
blocks; each block-row stores a fixed number K of blocks (padded with
explicit zero blocks), so every array has a static shape:

* ``data``: (nbr, K, bm, bn) block values — streamed once per product
  (this stream is the roofline).
* ``cols``: (nbr, K) block-column indices.

The forward product gathers the ``bn``-wide slices of ``x`` named by
``cols`` and contracts them with ``data``; XLA fuses the gather into the
contraction, so the product runs at the speed of one ``data`` stream.

Zero-padding blocks point at column 0 with zero values, so no masking
arithmetic is needed.  PDE operators with several unknowns per node have
dense sub-blocks and bounded row degree, making the K-padding overhead
small; `bell_from_scipy` reports the fill ratio.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..linops import LinearOperator

__all__ = ["BellMatrix", "bell_from_scipy", "bell_spmv", "bell_rspmv",
           "BellOperator"]

# f32 contractions at full f32 precision: the default may round operands
# to TF32 (about three decimal digits) on GPUs with tensor cores.
_HIGHEST = jax.lax.Precision.HIGHEST


class BellMatrix:
    """Host-side container for a Block-ELL matrix (device arrays)."""

    def __init__(self, data, cols, shape, nnz: int):
        self.data = data      # (nbr, K, bm, bn)
        self.cols = cols      # (nbr, K) int32
        self.shape = shape    # (m, n) logical (possibly unpadded) shape
        self.nnz = nnz        # true scalar nonzeros (for nnz/s accounting)

    @property
    def bm(self):
        return self.data.shape[2]

    @property
    def bn(self):
        return self.data.shape[3]

    @property
    def K(self):
        return self.data.shape[1]


def bell_from_scipy(A, bm: int = 8, bn: int = 128, dtype=np.float32) -> BellMatrix:
    """Convert a scipy sparse matrix to Block-ELL (host-side assembly)."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    A.sum_duplicates()
    m, n = A.shape
    m_p = -(-m // bm) * bm
    n_p = -(-n // bn) * bn
    nbr = m_p // bm
    nbc = n_p // bn

    # Native C++ assembler for real dtypes (identical layout contract);
    # numpy fallback below otherwise.
    if np.dtype(dtype) in (np.float32, np.float64):
        from .. import native

        if native.available():
            data, cols, K = native.bell_assemble(A, bm, bn, dtype)
            mat = BellMatrix(jnp.asarray(data), jnp.asarray(cols), (m, n), A.nnz)
            mat.fill_ratio = A.nnz / data.size if data.size else 1.0
            return mat

    coo = A.tocoo()
    br = coo.row.astype(np.int64) // bm
    bc = coo.col.astype(np.int64) // bn
    bid = br * nbc + bc
    uniq, inv = np.unique(bid, return_inverse=True)
    ubr = (uniq // nbc).astype(np.int64)
    ubc = (uniq % nbc).astype(np.int64)
    # uniq is sorted by (block-row, block-col): the slot of each unique
    # block is its rank within its block-row.
    row_start = np.searchsorted(ubr, np.arange(nbr))
    slot_of_uniq = np.arange(len(uniq)) - row_start[ubr]
    K = max(int(slot_of_uniq.max()) + 1, 1) if len(uniq) else 1

    data = np.zeros((nbr, K, bm, bn), dtype)
    cols = np.zeros((nbr, K), np.int32)
    cols[ubr, slot_of_uniq] = ubc.astype(np.int32)
    data[br, slot_of_uniq[inv], coo.row % bm, coo.col % bn] = coo.data.astype(dtype)
    fill = A.nnz / data.size if data.size else 1.0
    mat = BellMatrix(jnp.asarray(data), jnp.asarray(cols), (m, n), A.nnz)
    mat.fill_ratio = fill
    return mat


@jax.jit
def bell_spmv(data, cols, x_padded):
    """``y = A x`` for a Block-ELL matrix; ``x_padded`` is the (n_p,) dense
    vector, zero-padded to the block grid.  Returns the (nbr * bm,) rows."""
    bn = data.shape[3]
    xg = x_padded.reshape(-1, bn)[cols]                       # (nbr, K, bn)
    return jnp.einsum("rkms,rks->rm", data, xg,
                      precision=_HIGHEST).reshape(-1)


def bell_rspmv(data, cols, y_padded, n_p: int):
    """``x = A^H y``: each block's transpose contribution is scattered into
    its block-column (``y_padded`` has length nbr * bm; returns (n_p,))."""
    nbr, K, bm, bn = data.shape
    contrib = jnp.einsum("rkms,rm->rks", data.conj(), y_padded.reshape(nbr, bm),
                         precision=_HIGHEST)                  # (nbr, K, bn)
    out = jnp.zeros((n_p // bn, bn), data.dtype)
    out = out.at[cols.reshape(-1)].add(contrib.reshape(-1, bn))
    return out.reshape(-1)


class BellOperator(LinearOperator):
    """LinearOperator over a Block-ELL matrix (square; rank-1 array state).

    ``rmatvec`` scatters the block transposes (:func:`bell_rspmv`) unless
    the matrix is marked symmetric.
    """

    _children = ("data", "cols")
    _static = ("shape", "nnz", "is_hermitian")

    def __init__(self, bell: BellMatrix, is_hermitian: bool = False):
        self.data = bell.data
        self.cols = bell.cols
        self.shape = bell.shape
        self.nnz = bell.nnz
        self.is_hermitian = is_hermitian

    def template(self):
        return jnp.zeros((self.shape[1],), self.data.dtype)

    def matvec(self, x):
        bn = self.data.shape[3]
        n_p = (-(-self.shape[1] // bn)) * bn
        x_p = jnp.pad(x, (0, n_p - x.shape[0])) if n_p != x.shape[0] else x
        return bell_spmv(self.data, self.cols, x_p)[: self.shape[0]]

    def rmatvec(self, y):
        if self.is_hermitian:
            return self.matvec(y)
        nbr, K, bm, bn = self.data.shape
        n_p = (-(-self.shape[1] // bn)) * bn
        y_p = jnp.pad(y, (0, nbr * bm - y.shape[0]))
        return bell_rspmv(self.data, self.cols, y_p, n_p)[: self.shape[1]]
