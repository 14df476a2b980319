"""GMRES and flexible GMRES with restarts and right preconditioning.

Counterpart of ``src/IterativeSolvers/GMRES/gmres.fypp`` and
``fgmres.fypp``: restarted GMRES(kdim) whose inner loop is an Arnoldi sweep
with CGS2 (gmres.fypp:153-196), incremental Givens-rotation least squares
with the rhs recursion ``e[k+1] = -s * e[k]`` (:177-182), residual estimate
``|e[k+1]|``, right preconditioning applied to each Krylov vector before the
matvec (:155), solution by triangular solve + ``linear_combination`` +
preconditioner (:199-202), and a true-residual recompute per outer cycle
(:204-214).  FGMRES stores the preconditioned directions ``Z`` and builds
the update from them, allowing iteration-varying preconditioners
(fgmres.fypp:158-207).  Defaults kdim=30, maxiter=10 restarts
(IterativeSolvers.fypp:141-151); ``info = ±n_iter`` (gmres.fypp:233-239).

The entire solver — inner Arnoldi sweep, Givens recursion, restart loop —
is one jitted ``lax.while_loop`` nest: zero host synchronisation until the
solution is returned.  All small dense work (rotations, k x k triangular
solve) stays on-chip; the hot path is the operator matvec plus one batched
CGS2 reduction per iteration (a single fused all-reduce on a sharded mesh).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants, vectors
from ..krylov.gram_schmidt import double_gram_schmidt_step
from ..linops import IdentityOperator, Preconditioner, aslinop
from ..utils import linalg
from ..utils.logger import check_info
from ..utils.options import GMRESOptions, SolverMetadata
from ..utils.timer import count_applications, timed_fn

__all__ = ["gmres", "fgmres"]

#: Chunk width for the DCGS2 active-prefix streams (None = monolithic
#: full-buffer reads).  Read at trace time — flip + ``jax.clear_caches()``
#: to experiment (not yet measured on a GPU; ROADMAP A4).
DCGS2_CHUNK: int | None = None


@partial(jax.jit, static_argnames=("kdim", "maxiter", "transpose", "flexible", "sanity_check", "orth"))
def _gmres_impl(A, b, x0, M, tol, kdim, maxiter, transpose, flexible, sanity_check, orth):
    dt = vectors.dtype_of(b)
    rdt = constants.real_dtype_of(dt)

    def matvec(v):
        return A.rmatvec(v) if transpose else A.matvec(v)

    def precond(vk, k, res):
        # right preconditioner (gmres.fypp:155); iteration-aware interface
        # per the reference's abstract_precond (IterativeSolvers.fypp:80-95)
        if isinstance(M, Preconditioner):
            return M.apply(vk, iteration=k, current_residual=res,
                           target_residual=tol)
        return M.matvec(vk)

    def givens_col(h_col, R, c, s, e, j):
        """Rotate finalized Hessenberg column ``j`` into the least-squares
        recursion (gmres.fypp:177-182) -> updated (R, c, s, e, res)."""
        h_col, c, s = linalg.apply_givens_rotation(h_col, c, s, j)
        R = R.at[:, j].set(h_col[:-1])
        cj, sj = c[j], s[j]
        e = e.at[j + 1].set(-sj * e[j])
        e = e.at[j].set(cj.astype(dt) * e[j])
        return R, c, s, e, jnp.abs(e[j + 1]).astype(rdt)

    res_hist0 = jnp.zeros((maxiter * kdim,), rdt)

    def inner_cond(carry):
        V, Z, R, c, s, e, k, res, hist, nin = carry
        return (k < kdim) & (res >= tol)

    def inner_body(carry):
        V, Z, R, c, s, e, k, res, hist, nin = carry
        vk = vectors.get_column(V, k)
        z = precond(vk, k, res)
        if flexible:
            Z = vectors.set_column(Z, k, z)
        w = matvec(z)
        # CGS2 with active-prefix reads: columns 0..k are filled, so only
        # chunks intersecting [0, k+1) stream from HBM (exact by the
        # zero-column buffer invariant)
        w, proj = double_gram_schmidt_step(w, V, k=k + 1)
        beta = vectors.norm(w)
        h_col = proj.astype(dt).at[k + 1].set(beta.astype(dt))
        safe = jnp.where(beta == 0, 1.0, beta)
        V = vectors.set_column(
            V, k + 1, vectors.scal(jnp.where(beta > 0, 1.0 / safe, 0.0).astype(rdt), w)
        )
        R, c, s, e, res = givens_col(h_col, R, c, s, e, k)
        hist = hist.at[nin].set(res)
        return V, Z, R, c, s, e, k + 1, res, hist, nin + 1

    # -- DCGS2: delayed re-orthogonalization (one fused reduce + one fused
    # rank-2 update per iteration -> the basis streams from HBM twice per
    # iteration instead of four times; reference semantics of
    # double_gram_schmidt_step preserved through the delayed correction).
    # Buffer slot k holds the *uncorrected* direction u_k (scaled at
    # creation, see gamma below); slots < k are final orthonormal columns.
    # Iteration k measures, in ONE reduction,
    #   z = Q_k^H u_k   (fresh second CGS pass for u_k),
    #   p = Q_k^H w_k   (first CGS pass for w_k = A u_k),
    # finalizes column k-1 of the true Hessenberg (its entries depend on
    # eta_k = ||u_k - Q z||, known only now), and writes the corrected q_k
    # plus the new direction u_{k+1} = (w - Q p - q_k t)/gamma_k as ONE
    # rank-2 linear combination of the buffer.
    #
    # gamma rescaling: applying A to the unnormalized u compounds ||A||^k
    # into the stored direction — overflow in f32 within ~10 iterations for
    # ||A|| ~ 100.  Any known positive scale is algebraically exact (the
    # Hessenberg correction factor becomes fac_k = gamma_k / eta_k); the
    # Pythagorean estimate gamma^2 = ||w||^2 - ||proj||^2 ~ ||u_next||^2
    # keeps every stored direction at unit scale.

    eps_r = float(np.finfo(np.dtype(rdt)).eps)

    # Active-prefix reads for the dcgs2 streams: at iteration k only
    # columns 0..k are live, so on average ~kdim/2 columns stream per pass
    # instead of kdim+1 (exact by the zero-column buffer invariant).
    chunk = DCGS2_CHUNK

    def _ip_pfx(V, Y, kk):
        if chunk is None:
            return vectors.innerprod(V, Y)
        return vectors.innerprod_prefix(V, Y, kk, chunk)

    def _lincomb_pfx(V, coeff, kk):
        if chunk is None:
            return vectors.linear_combination(V, coeff)
        return vectors.linear_combination_prefix(V, coeff, kk, chunk)

    def dcgs2_measure(V, u_k, w, k):
        """The single fused reduction of iteration k -> (z, p, sigma, tau,
        wTw): buffer^H [u_k, w] plus ||w||^2, as one broadcast-reduce
        stream over the buffer.  Row k of the innerprod
        gives (sigma, tau) because slot k holds u_k itself; rows > k
        vanish by the zero-column invariant."""
        Y2 = jax.tree.map(lambda a, b_: jnp.stack([a, b_]), u_k, w)
        if chunk is None:
            PR = vectors.innerprod_vpu(V, Y2).astype(dt)  # (kdim+1, 2)
        else:
            PR = _ip_pfx(V, Y2, k + 1).astype(dt)
        wTw = jnp.real(vectors.dot(w, w)).astype(rdt)
        zf, pf = PR[:, 0], PR[:, 1]
        sigma = jnp.real(zf[k]).astype(rdt)
        tau = pf[k]
        z = zf.at[k].set(jnp.zeros((), dt))
        p = pf.at[k].set(jnp.zeros((), dt))
        return z, p, sigma, tau, wTw

    def pythag_eta(sigma, z):
        # breakdown (u_k in span Q) gives eta ~ 0 -> inv_eta = 0 writes an
        # exactly-zero column (the same invariant-preserving breakdown
        # handling as arnoldi_step), and the vanishing H[k, k-1] collapses
        # the residual recursion.
        eta2 = sigma - jnp.real(jnp.vdot(z, z)).astype(rdt)
        eta = jnp.sqrt(jnp.maximum(eta2, 0.0))
        ok = eta > 0
        inv_eta = jnp.where(ok, 1.0 / jnp.where(ok, eta, 1.0), 0.0).astype(rdt)
        return eta, inv_eta

    def dcgs2_cond(carry):
        V, Ht, R, c, s, e, hp, fac_prev, k, res, hist, nin = carry
        return (k < kdim) & (res >= tol)

    def dcgs2_body(carry):
        V, Ht, R, c, s, e, hp, fac_prev, k, res, hist, nin = carry
        u_k = vectors.get_column(V, k)
        w = matvec(precond(u_k, k, res))
        z, p, sigma, tau, wTw = dcgs2_measure(V, u_k, w, k)
        eta, inv_eta = pythag_eta(sigma, z)
        t = (tau - jnp.vdot(z, p)) * inv_eta

        # finalize true-H column k-1 (skipped at k = 0: nothing pending)
        def finalize(ops):
            Ht, R, c, s, e, hist, nin = ops
            h_col = (hp + z * fac_prev).at[k].set((eta * fac_prev).astype(dt))
            Ht = Ht.at[:, k - 1].set(h_col)
            R, c, s, e, res_new = givens_col(h_col, R, c, s, e, k - 1)
            hist = hist.at[nin].set(res_new)
            return Ht, R, c, s, e, hist, nin + 1, res_new

        def skip(ops):
            Ht, R, c, s, e, hist, nin = ops
            return Ht, R, c, s, e, hist, nin, res

        Ht, R, c, s, e, hist, nin, res = jax.lax.cond(
            k > 0, finalize, skip, (Ht, R, c, s, e, hist, nin))
        # provisional column k: (q_i^H A q_k) = ([p; t] - (H z)_i) / eta,
        # exact for the *corrected* q_k because A Q z expands through the
        # (now final) Arnoldi columns
        Hz = jnp.matmul(Ht, z[:kdim], precision=jax.lax.Precision.HIGHEST)
        hp_new = (p.at[k].set(t) - Hz) * inv_eta
        # Pythagorean scale of the new direction (any positive value is
        # exact; this one keeps ||u_{k+1}|| ~ 1)
        gamma2 = wTw - jnp.real(jnp.vdot(p, p)).astype(rdt) - jnp.abs(t) ** 2
        gamma = jnp.sqrt(jnp.maximum(gamma2, eps_r * eps_r * wTw))
        inv_gamma = jnp.where(gamma > 0, 1.0 / jnp.where(gamma > 0, gamma, 1.0),
                              0.0).astype(rdt)
        # ONE fused rank-2 update: corrected q_k and new direction u_{k+1}
        # as a single broadcast-sum pass over the buffer (1/gamma folded
        # into the u-coefficients).  Shape discipline matters: the
        # broadcast on the leaf's original 2D shape fuses into one
        # bandwidth-speed stream; the flattened (k, s) form loses the
        # fusion.
        c_q = (-z * inv_eta).at[k].set(inv_eta.astype(dt))
        c_u = ((p - (t * inv_eta) * z) * inv_gamma).at[k].set(
            t * inv_eta * inv_gamma)
        if chunk is None:
            D = vectors.linear_combination_vpu(
                V, jnp.stack([c_q, c_u], axis=1))
            q_k = vectors.get_column(D, 0)
            Vcu = vectors.get_column(D, 1)
        else:
            q_k = _lincomb_pfx(V, c_q, k + 1)
            Vcu = _lincomb_pfx(V, c_u, k + 1)
        u_next = vectors.axpby(inv_gamma, w, -1.0, Vcu)
        V = vectors.set_column(V, k, q_k)
        V = vectors.set_column(V, k + 1, u_next)
        fac = (gamma * inv_eta).astype(rdt)
        return V, Ht, R, c, s, e, hp_new, fac, k + 1, res, hist, nin

    def dcgs2_flush(V, R, c, s, e, hp, fac_prev, k_exit):
        """Finalize the pending column ``k_exit - 1``: one reduce against
        the buffer (no matvec) supplies the missing z/eta, then the final
        Givens rotation yields the residual for the full k_exit-column
        space."""
        u_last = vectors.get_column(V, k_exit)
        zf = vectors.innerprod(V, u_last).astype(dt)
        sigma = jnp.real(zf[k_exit]).astype(rdt)
        z = zf.at[k_exit].set(jnp.zeros((), dt))
        eta, _ = pythag_eta(sigma, z)
        h_col = (hp + z * fac_prev).at[k_exit].set((eta * fac_prev).astype(dt))
        R, c, s, e, res_flush = givens_col(h_col, R, c, s, e, k_exit - 1)
        return R, c, s, e, res_flush

    def outer_cond(carry):
        x, outer, res, hist, nin, n_iter, nmv = carry
        return (outer < maxiter) & (res >= tol)

    def outer_body(carry):
        x, outer, res, hist, nin, n_iter, nmv = carry
        r = vectors.axpby(1.0, b, -1.0, matvec(x))  # r0 = b - A x (:134-143)
        beta = vectors.norm(r)
        V = vectors.zeros_basis(b, kdim + 1)
        safe = jnp.where(beta == 0, 1.0, beta)
        V = vectors.set_column(V, 0, vectors.scal((1.0 / safe).astype(rdt), r))
        # Z (preconditioned directions) is only needed by FGMRES; carrying
        # the unused (kdim+1)-column buffer through the while_loop when not
        # flexible risks a pass-through copy per iteration (1.2 GB at the
        # 10M-DoF scale) — use a scalar placeholder instead (static choice).
        Z = vectors.zero_basis_like(V) if flexible else jnp.zeros((), dt)
        R = jnp.zeros((kdim, kdim), dt)
        c = jnp.zeros((kdim,), rdt)
        s = jnp.zeros((kdim,), dt)
        e = jnp.zeros((kdim + 1,), dt).at[0].set(beta.astype(dt))

        if orth == "dcgs2":
            Ht = jnp.zeros((kdim + 1, kdim), dt)
            hp = jnp.zeros((kdim + 1,), dt)
            (V, Ht, R, c, s, e, hp, fac_prev, k_exit, res_in, hist, nin) = \
                jax.lax.while_loop(
                    dcgs2_cond, dcgs2_body,
                    (V, Ht, R, c, s, e, hp, jnp.ones((), rdt),
                     jnp.zeros((), jnp.int32), beta.astype(rdt), hist, nin))
            converged_pre = res_in < tol
            Rf, cf, sf, ef, res_flush = dcgs2_flush(
                V, R, c, s, e, hp, fac_prev, k_exit)
            # converged mid-loop: solve in the k_exit-1 finalized columns
            # (their residual already beat tol; the flush column is unused).
            # ran to kdim: the flush completes the kdim-column space.
            k = jnp.where(converged_pre, k_exit - 1, k_exit)
            R, c, s, e = jax.tree.map(
                lambda a, bf: jnp.where(converged_pre, a, bf),
                (R, c, s, e), (Rf, cf, sf, ef))
            res_in = jnp.where(converged_pre, res_in, res_flush)
            hist = jnp.where(converged_pre, hist, hist.at[nin].set(res_flush))
            nin = nin + jnp.where(converged_pre, 0, 1)
            mv_inner = k_exit
        else:
            V, Z, R, c, s, e, k, res_in, hist, nin = jax.lax.while_loop(
                inner_cond, inner_body,
                (V, Z, R, c, s, e, jnp.zeros((), jnp.int32),
                 beta.astype(rdt), hist, nin),
            )
            mv_inner = k

        # Back-substitution on the rotated Hessenberg (gmres.fypp:199-202):
        # unfilled diagonal entries are replaced by 1 (their rhs is 0).
        idx = jnp.arange(kdim)
        diag_fix = jnp.where(idx >= k, jnp.ones((), dt), jnp.zeros((), dt))
        Rk = R + jnp.diag(diag_fix)
        rhs = jnp.where(idx < k, e[:kdim], jnp.zeros((), dt))
        y = linalg.solve_triangular(Rk, rhs)
        basis = Z if flexible else V
        lead = jax.tree.map(lambda l: l[:kdim], basis)
        dx = vectors.linear_combination(lead, y)
        if not flexible:
            dx = M.matvec(dx)  # right-preconditioned correction (:201-202)
        x = vectors.add(x, dx)

        if sanity_check:
            true_res = vectors.norm(vectors.axpby(1.0, b, -1.0, matvec(x)))
            res_out = true_res.astype(rdt)  # (:204-214)
            mv_cycle = mv_inner + 2
        else:
            res_out = res_in
            mv_cycle = mv_inner + 1
        return x, outer + 1, res_out, hist, nin, n_iter + k, nmv + mv_cycle

    x, outer, res, hist, nin, n_iter, nmv = jax.lax.while_loop(
        outer_cond, outer_body,
        (x0, jnp.zeros((), jnp.int32), jnp.asarray(np.inf, rdt), res_hist0,
         jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
         jnp.zeros((), jnp.int32)),
    )
    return x, res, hist, nin, n_iter, outer, nmv


def _solve(A, b, x0, rtol, atol, preconditioner, options, transpose, flexible, meta_name):
    A = aslinop(A)
    dt = vectors.dtype_of(b)
    rdt = constants.real_dtype_of(dt)
    if rtol is None:
        rtol = constants.rtol(rdt)
    if atol is None:
        atol = constants.atol(rdt)
    opts = options or GMRESOptions()
    M = aslinop(preconditioner) if preconditioner is not None else IdentityOperator()
    if x0 is None:
        x0 = vectors.zero_like(b)
    orth = opts.orthogonalization
    if flexible and orth == "dcgs2":
        # FGMRES builds the update from the stored preconditioned
        # directions Z = M_k v_k, which requires the FINAL q_k at
        # preconditioning time — incompatible with the delayed scheme's
        # raw-u_k matvecs.  Fall back to classical CGS2.
        orth = "cgs2"
    if orth not in ("cgs2", "dcgs2"):
        raise ValueError(f"unknown orthogonalization {orth!r}")
    # tol stays ON DEVICE (norm is jitted): no host sync before the solve
    tol = (atol + rtol * vectors.norm(b)).astype(rdt)

    x, res, hist, nin, n_iter, outer, nmv = _gmres_impl(
        A, b, x0, M, tol, opts.kdim, opts.maxiter, transpose, flexible,
        opts.sanity_check, orth,
    )
    # ONE batched device_get for all metadata: each separate float()/int()
    # would be its own host sync.
    res, hist, nin, n_iter, outer, nmv, tol = jax.device_get(
        (res, hist, nin, n_iter, outer, nmv, tol))
    res = float(res)
    nin = int(nin)
    converged = res < float(tol)
    info = int(n_iter) if converged else -int(n_iter)
    # Execution-accurate operator accounting (reference: apply_matvec
    # wrappers, AbstractLinops.fypp:390-424): the jitted core returns the
    # executed matvec count (inner iterations + r0 + sanity recomputes; the
    # DCGS2 path can execute one matvec beyond the solved column count).
    n_mv = int(nmv)
    count_applications(A, n_mv, "rmatvec" if transpose else "matvec")
    if not isinstance(M, IdentityOperator):
        n_inner_mv = n_mv - int(outer) * (1 + int(bool(opts.sanity_check)))
        count_applications(M, n_inner_mv + (0 if flexible else int(outer)),
                           "matvec")
    check_info(info, meta_name, "solvers", meta_name)
    meta = SolverMetadata(
        converged=converged,
        n_iter=int(outer),
        n_inner=nin,
        info=info,
        residuals=np.asarray(hist)[:nin],
    )
    if opts.if_print_metadata:
        meta.print()
    return x, info, meta


@timed_fn("gmres", "IterativeSolvers")
def gmres(A, b, x0=None, rtol=None, atol=None, preconditioner=None,
          options: GMRESOptions | None = None, transpose: bool = False):
    """Restarted GMRES(kdim) for ``A x = b`` -> ``(x, info, metadata)``
    (reference: ``gmres``, gmres.fypp:65-258; options
    IterativeSolvers.fypp:141-151).

    ``info = n_inner`` if converged else ``-n_inner``
    (gmres.fypp:233-239).  Arrays are accepted for ``A`` and wrapped in a
    :class:`DenseOperator` (the reference's dense convenience wrapper,
    gmres.fypp:260-271).
    """
    return _solve(A, b, x0, rtol, atol, preconditioner, options, transpose,
                  flexible=False, meta_name="gmres")


@timed_fn("fgmres", "IterativeSolvers")
def fgmres(A, b, x0=None, rtol=None, atol=None, preconditioner=None,
           options: GMRESOptions | None = None, transpose: bool = False):
    """Flexible GMRES: stores preconditioned directions so the
    preconditioner may vary per iteration
    (reference: fgmres.fypp:158-207)."""
    return _solve(A, b, x0, rtol, atol, preconditioner, options, transpose,
                  flexible=True, meta_name="fgmres")
