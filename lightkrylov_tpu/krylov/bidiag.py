"""Golub-Kahan (Lanczos) bidiagonalization.

Counterpart of ``src/Krylov/golub_kahan.fypp``: alternating
``A^H u -> v`` / ``A v -> u`` sweeps with full CGS2 re-orthogonalization of
*both* bases, building a lower-bidiagonal ``B`` with ``B[k, k] = alpha`` and
``B[k+1, k] = beta``, and breakdown exits when either norm vanishes
(reference: golub_kahan.fypp:26-61).

Supports rectangular operators: ``U`` lives in the codomain of ``A`` and
``V`` in its domain (the reference's abstract vectors allow the same).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .. import constants, vectors
from ..utils.timer import count_applications, time_lightkrylov, timed_fn
from .gram_schmidt import double_gram_schmidt_step

__all__ = ["bidiagonalization", "bidiag_step", "initialize_bidiag"]


@partial(jax.jit, static_argnames=("kdim",))
def initialize_bidiag(u0, v_template, kdim: int):
    """Buffers: U with kdim+1 columns (codomain), V with kdim columns
    (domain), B of shape (kdim+1, kdim).
    Jitted: one compiled executable serves every call."""
    dt = vectors.dtype_of(u0)
    U = vectors.zeros_basis(u0, kdim + 1)
    U = vectors.set_column(U, 0, vectors.scal(1.0 / vectors.norm(u0), u0))
    V = vectors.zeros_basis(v_template, kdim)
    B = jnp.zeros((kdim + 1, kdim), dt)
    return U, V, B


def bidiag_step(A, U, V, B, k, tol: float = 0.0):
    """One Golub-Kahan step (0-based ``k``): ``v_k = A^H u_k`` then
    ``u_{k+1} = A v_k``, both fully re-orthogonalized
    (reference: golub_kahan.fypp:26-61).  Returns
    ``(U, V, B, alpha, beta)``."""
    dt = vectors.dtype_of(U)
    rdt = constants.real_dtype_of(dt)
    # v_k = A^H u_k, re-orthogonalized against V[:, :k]
    uk = vectors.get_column(U, k)
    v = A.rmatvec(uk)
    v, _ = double_gram_schmidt_step(v, V, k=k)  # V has k filled columns
    alpha = vectors.norm(v)
    ok_a = alpha > tol
    inva = jnp.where(ok_a, 1.0 / jnp.where(alpha == 0, 1.0, alpha), 0.0)
    v = vectors.scal(inva.astype(rdt), v)
    V = vectors.set_column(V, k, v)
    B = B.at[k, k].set(jnp.where(ok_a, alpha.astype(dt), jnp.zeros((), dt)))

    # u_{k+1} = A v_k, re-orthogonalized against U[:, :k+1].  The *full*
    # CGS2 coefficient column is stored (Arnoldi-style): in exact
    # arithmetic it is alpha e_k, but after a thick restart the
    # factorization carries couplings to the compressed columns, and
    # storing the complete projections keeps ``A V = U B`` exact.
    u = A.matvec(v)
    u, proj_u = double_gram_schmidt_step(u, U, k=k + 1)
    beta = vectors.norm(u)
    ok_b = ok_a & (beta > tol)
    invb = jnp.where(ok_b, 1.0 / jnp.where(beta == 0, 1.0, beta), 0.0)
    u = vectors.scal(invb.astype(rdt), u)
    U = vectors.set_column(U, k + 1, u)
    B = B.at[:, k].set(proj_u.astype(dt))
    B = B.at[k + 1, k].set(jnp.where(ok_b, beta.astype(dt), jnp.zeros((), dt)))
    return U, V, B, alpha, beta


@timed_fn("krylov.bidiagonalization", "BaseKrylov")
def bidiagonalization(A, U, V, B, kstart=1, kend=None, tol: float | None = None):
    """Grow the factorization ``A V_k = U_{k+1} B_k`` from ``kstart`` to
    ``kend`` (1-based inclusive) -> ``(U, V, B, info)``
    (reference: golub_kahan.fypp:7-61; ``info = k`` on breakdown)."""
    kdim = B.shape[1]
    if kend is None:
        kend = kdim
    dt = vectors.dtype_of(U)
    rdt = constants.real_dtype_of(dt)
    if tol is None:
        tol = constants.atol(rdt)
    kstart = jnp.asarray(kstart, jnp.int32)
    kend = jnp.asarray(kend, jnp.int32)

    def cond(carry):
        _, _, _, k, info = carry
        return (k < kend) & (info == 0)

    def body(carry):
        U, V, B, k, info = carry
        U, V, B, alpha, beta = bidiag_step(A, U, V, B, k, tol=tol)
        broke = (alpha <= tol) | (beta <= tol)
        info = jnp.where(broke & (info == 0), k + 1, info).astype(jnp.int32)
        # NaN alpha/beta: fatal negative info (reference: qr.fypp:72-78)
        nan = jnp.isnan(jnp.real(alpha)) | jnp.isnan(jnp.real(beta))
        info = jnp.where(nan, -(k + 1), info).astype(jnp.int32)
        return U, V, B, k + 1, info

    U, V, B, _, info = jax.lax.while_loop(
        cond, body, (U, V, B, kstart - 1, jnp.zeros((), jnp.int32))
    )
    # each step applies one rmatvec AND one matvec (golub_kahan.fypp:26-61)
    if time_lightkrylov():
        try:
            i, k0, k1 = int(info), int(kstart), int(kend)
            steps = max(0, (abs(i) if i != 0 else k1) - k0 + 1)
            count_applications(A, steps, "matvec")
            count_applications(A, steps, "rmatvec")
        except (jax.errors.ConcretizationTypeError,
                jax.errors.TracerIntegerConversionError):  # traced: skip
            pass
    return U, V, B, info
