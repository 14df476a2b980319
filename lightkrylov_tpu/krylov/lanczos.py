"""Lanczos tridiagonalization for symmetric/Hermitian operators.

Counterpart of ``src/Krylov/lanczos.fypp``: three-term recurrence
**with full re-orthogonalization** against the whole basis at each step via
CGS2 (lanczos.fypp:46-64), ``T[k+1, k] = beta`` and breakdown exit
(:29-40).  The reference types this on symmetric/Hermitian operators only
(BaseKrylov.fypp:220-234); here we trust ``A.is_hermitian`` or the caller.

Same buffer discipline as :mod:`arnoldi`: jitted ``while_loop``, dynamic
``kstart/kend``, zero unfilled columns.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .. import constants, vectors
from ..utils.timer import timed_fn
from .arnoldi import _count_steps
from .gram_schmidt import double_gram_schmidt_step

__all__ = ["lanczos", "lanczos_step", "initialize_lanczos"]


@partial(jax.jit, static_argnames=("kdim",))
def initialize_lanczos(x0, kdim: int):
    """Buffers: (kdim+1)-column basis + (kdim+1, kdim) real tridiagonal T.
    Jitted: one compiled executable serves every call."""
    dt = vectors.dtype_of(x0)
    X = vectors.zeros_basis(x0, kdim + 1)
    X = vectors.set_column(X, 0, vectors.scal(1.0 / vectors.norm(x0), x0))
    T = jnp.zeros((kdim + 1, kdim), dt)
    return X, T


def lanczos_step(A, X, T, k, tol: float = 0.0):
    """One Lanczos step with full CGS2 re-orthogonalization
    (reference: lanczos.fypp:46-64)."""
    dt = vectors.dtype_of(X)
    xk = vectors.get_column(X, k)
    v = A.matvec(xk)
    # Full re-orthogonalization subsumes the 3-term recurrence; the CGS2
    # coefficients give alpha = proj[k] (and beta_{k-1} = proj[k-1]).
    # Active-prefix reads: columns 0..k are filled.
    v, proj = double_gram_schmidt_step(v, X, k=k + 1)
    beta = vectors.norm(v)
    ok = beta > tol
    inv = jnp.where(ok, 1.0 / jnp.where(beta == 0, 1.0, beta), 0.0)
    v = vectors.scal(inv.astype(constants.real_dtype_of(dt)), v)
    T = T.at[:, k].set(proj.astype(dt))
    T = T.at[k + 1, k].set(jnp.where(ok, beta.astype(dt), jnp.zeros((), dt)))
    X = vectors.set_column(X, k + 1, v)
    return X, T, beta


@timed_fn("krylov.lanczos", "BaseKrylov")
def lanczos(A, X, T, kstart=1, kend=None, tol: float | None = None):
    """Grow the Lanczos factorization ``A X_k = X_{k+1} T_k`` from
    ``kstart`` to ``kend`` (1-based inclusive).  Returns ``(X, T, info)``
    with ``info = k`` on invariant-subspace breakdown
    (reference: lanczos.fypp:8-45)."""
    kdim = T.shape[1]
    if kend is None:
        kend = kdim
    dt = vectors.dtype_of(X)
    if tol is None:
        tol = constants.atol(constants.real_dtype_of(dt))
    kstart = jnp.asarray(kstart, jnp.int32)
    kend = jnp.asarray(kend, jnp.int32)

    def cond(carry):
        _, _, k, info = carry
        return (k < kend) & (info == 0)

    def body(carry):
        X, T, k, info = carry
        X, T, beta = lanczos_step(A, X, T, k, tol=tol)
        info = jnp.where(beta <= tol, k + 1, info).astype(jnp.int32)
        # NaN beta: fatal negative info (reference: qr.fypp:72-78)
        info = jnp.where(jnp.isnan(jnp.real(beta)), -(k + 1), info).astype(jnp.int32)
        return X, T, k + 1, info

    X, T, _, info = jax.lax.while_loop(
        cond, body, (X, T, kstart - 1, jnp.zeros((), jnp.int32))
    )
    _count_steps(A, info, kstart, kend, 1, "matvec")
    return X, T, info
