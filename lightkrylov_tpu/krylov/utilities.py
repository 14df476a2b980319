"""Krylov basis utilities.

Counterpart of ``src/Krylov/utilities.fypp``: column permutation
``permcols`` and its inverse ``invperm`` (utilities.fypp:12-27),
``initialize_krylov_subspace`` (zero buffer + copy + orthonormalize seed
block, :34-48), ``initialize_random_orthonormal_basis`` (:56-64),
``orthonormalize_basis`` as a QR wrapper (:72-82) and the orthonormality
check ``||X^H X - I||_F < rtol`` (:90-98).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import constants, vectors
from .qr import qr

__all__ = [
    "permcols",
    "invperm",
    "initialize_krylov_subspace",
    "initialize_random_orthonormal_basis",
    "orthonormalize_basis",
    "is_orthonormal",
]


def permcols(X, perm):
    """Permute stacked columns: ``Y_i = X_{perm[i]}`` (reference:
    utilities.fypp:12-27; works on bases and on coefficient matrices)."""
    perm = jnp.asarray(perm)
    if isinstance(X, jnp.ndarray) and X.ndim == 2:
        return X[:, perm]
    return jax.tree.map(lambda l: l[perm], X)


def invperm(perm):
    """Inverse permutation (reference: utilities.fypp:12-27)."""
    return jnp.argsort(jnp.asarray(perm))


def initialize_krylov_subspace(X, seed=None):
    """Zero the buffer and seed its leading column(s) with the orthonormalized
    ``seed`` block (reference: utilities.fypp:34-48).

    ``seed`` may be a vector or a stacked block; returns the new buffer.
    """
    X = vectors.zero_basis_like(X)
    if seed is None:
        return X
    seed_leaves = jax.tree_util.tree_leaves(seed)
    x_leaves = jax.tree_util.tree_leaves(X)
    if seed_leaves[0].ndim == x_leaves[0].ndim - 1:
        # single seed vector
        x0 = vectors.scal(1.0 / vectors.norm(seed), seed)
        return vectors.set_column(X, 0, x0)
    p = vectors.basis_size(seed)
    Q, _, _ = qr(seed)
    for i in range(p):
        X = vectors.set_column(X, i, vectors.get_column(Q, i))
    return X


def initialize_random_orthonormal_basis(key, x_template, k: int):
    """Random orthonormal k-column basis (reference: utilities.fypp:56-64).

    A Gaussian basis is well-conditioned with overwhelming probability, so
    the matmul-based CholeskyQR2 path applies; the CGS2 fallback inside
    :func:`orthonormalize_basis` covers the measure-zero remainder."""
    X = vectors.rand_basis(key, vectors.zeros_basis(x_template, k))
    return orthonormalize_basis(X, key=jax.random.fold_in(key, 1),
                                method="cholqr2")


def orthonormalize_basis(X, key=None, method: str = "cgs2"):
    """QR wrapper returning only Q (reference: utilities.fypp:72-82).

    ``method="cholqr2"`` uses :func:`~lightkrylov_tpu.krylov.cholesky_qr2`
    — two matmul passes and one fused all-reduce per pass instead of
    the k-step CGS2 column loop; it falls back to CGS2 automatically when
    the basis is numerically rank-deficient (Cholesky breakdown).
    """
    if method == "cholqr2":
        from .qr import cholesky_qr2

        Q, _, info = cholesky_qr2(X)
        if info == 0:
            return Q
    Q, _, _ = qr(X, key=key)
    return Q


def is_orthonormal(X, rtol: float | None = None) -> jnp.ndarray:
    """``||X^H X - I||_F < rtol`` (reference: utilities.fypp:90-98 — the
    reference hard-codes ``rtol_sp`` as the threshold)."""
    if rtol is None:
        rtol = constants.rtol(jnp.float32)
    G = vectors.gram(X)
    k = G.shape[0]
    return jnp.linalg.norm(G - jnp.eye(k, dtype=G.dtype)) < rtol
