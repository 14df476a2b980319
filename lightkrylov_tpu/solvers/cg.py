"""Preconditioned conjugate gradient.

Counterpart of ``src/IterativeSolvers/CG/CG.fypp``: PCG on a
symmetric/Hermitian positive-definite operator with the ``z = M^-1 r``
variant (CG.fypp:106-171), maxiter=100 default
(IterativeSolvers.fypp:467-474) and residual-history metadata.  The
reference types this on sym/hermitian operators (IterativeSolvers.fypp:
558-565); we trust ``A.is_hermitian`` or the caller.

One jitted ``lax.while_loop``; two fused reductions per iteration
(``r^H z`` and ``p^H Ap``), each a single all-reduce on a sharded mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants, vectors
from ..linops import IdentityOperator, Preconditioner, aslinop
from ..utils.logger import check_info
from ..utils.options import CGOptions, SolverMetadata
from ..utils.timer import count_applications, timed_fn

__all__ = ["cg"]


@partial(jax.jit, static_argnames=("maxiter",))
def _cg_impl(A, b, x0, M, tol, maxiter):
    dt = vectors.dtype_of(b)
    rdt = constants.real_dtype_of(dt)

    def precond(r, k, res):
        # iteration-aware interface shared by every preconditioned solver
        # (reference: abstract_precond_*%apply(vec, [iter, current_residual,
        # target_residual]), IterativeSolvers.fypp:80-95)
        if isinstance(M, Preconditioner):
            return M.apply(r, iteration=k, current_residual=res,
                           target_residual=tol)
        return M.matvec(r)

    r0 = vectors.axpby(1.0, b, -1.0, A.matvec(x0))
    res_init = vectors.norm(r0).astype(rdt)
    z0 = precond(r0, jnp.zeros((), jnp.int32), res_init)
    p0 = z0
    rz0 = vectors.dot(r0, z0)
    res0 = res_init
    hist0 = jnp.zeros((maxiter,), rdt)

    def cond(carry):
        x, r, z, p, rz, k, res, hist = carry
        return (k < maxiter) & (res >= tol)

    def body(carry):
        x, r, z, p, rz, k, res, hist = carry
        Ap = A.matvec(p)
        pAp = vectors.dot(p, Ap)
        alpha = rz / jnp.where(pAp == 0, 1.0, pAp)
        x = vectors.axpby(1.0, x, alpha, p)
        r = vectors.axpby(1.0, r, -alpha, Ap)
        res = vectors.norm(r).astype(rdt)
        z = precond(r, k + 1, res)
        rz_new = vectors.dot(r, z)
        beta = rz_new / jnp.where(rz == 0, 1.0, rz)
        p = vectors.axpby(1.0, z, beta, p)
        hist = hist.at[k].set(res)
        return x, r, z, p, rz_new, k + 1, res, hist

    x, r, z, p, rz, k, res, hist = jax.lax.while_loop(
        cond, body, (x0, r0, z0, p0, rz0, jnp.zeros((), jnp.int32), res0, hist0)
    )
    return x, res, hist, k


@timed_fn("cg", "IterativeSolvers")
def cg(A, b, x0=None, rtol=None, atol=None, preconditioner=None,
       options: CGOptions | None = None):
    """Preconditioned CG for SPD/HPD ``A x = b`` -> ``(x, info, metadata)``
    (reference: ``cg``, CG.fypp:106-171; options
    IterativeSolvers.fypp:467-474; ``info = ±n_iter``)."""
    A = aslinop(A)
    dt = vectors.dtype_of(b)
    rdt = constants.real_dtype_of(dt)
    if rtol is None:
        rtol = constants.rtol(rdt)
    if atol is None:
        atol = constants.atol(rdt)
    opts = options or CGOptions()
    M = aslinop(preconditioner) if preconditioner is not None else IdentityOperator()
    if x0 is None:
        x0 = vectors.zero_like(b)
    # tol stays on device; all metadata fetched in ONE device_get (each
    # separate float()/int() would be its own host sync)
    tol = (atol + rtol * vectors.norm(b)).astype(rdt)

    x, res, hist, k = _cg_impl(A, b, x0, M, tol, opts.maxiter)
    res, hist, k, tol = jax.device_get((res, hist, k, tol))
    res, k = float(res), int(k)
    converged = res < float(tol)
    info = k if converged else -k
    # r0 matvec + one matvec per iteration (apply_matvec accounting)
    count_applications(A, k + 1, "matvec")
    if not isinstance(M, IdentityOperator):
        count_applications(M, k + 1, "matvec")
    check_info(info, "cg", "solvers", "cg")
    meta = SolverMetadata(
        converged=converged, n_iter=k, n_inner=k, info=info,
        residuals=np.asarray(hist)[:k],
    )
    if opts.if_print_metadata:
        meta.print()
    return x, info, meta
