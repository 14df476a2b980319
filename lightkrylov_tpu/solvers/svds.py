"""Singular value decomposition via Golub-Kahan bidiagonalization, with
thick restart.

Counterpart of ``svds``
(reference: src/IterativeSolvers/SVDS/svd_solvers.fypp): incremental
bidiagonalization plus dense SVD of the projected bidiagonal each check
(svd_solvers.fypp:80-102), residual ``|B[k+1, k] * v_last|`` (:93), and
reconstruction ``U = Uwrk @ umat``, ``V = Vwrk @ vmat`` (:108-119).

The reference has **no restart** (IterativeSolvers.fypp:655-658); here we
add Baglama-Reichel-style thick restart: compress onto the ``n`` best
singular triplets, ``B`` becomes diag(s) with the residual coupling row
``beta * q_last`` at row ``n``, and bidiagonalization continues — the
generalized (non-bidiagonal) projected matrix is handled exactly because
:mod:`krylov.bidiag` stores the full CGS2 projection columns.

Supports rectangular implicit operators (``U`` in the codomain, ``V`` in
the domain).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from functools import partial

import time

from .. import constants, vectors
from ..krylov.bidiag import bidiag_step, bidiagonalization, initialize_bidiag
from ..linops import aslinop
from .eigs import (_AdaptiveStride, _DriverCheckpointer, _device_projected,
                   _reconstruct, _resume_driver_state)
from ..utils import linalg
from ..utils.logger import check_info, log_information, log_warning
from ..utils.options import SVDSOptions, SolverMetadata
from ..utils.timer import count_applications, timed_fn

__all__ = ["svds"]


def _ritz_check_svd(B, k_eff, tol, nsv):
    """Device-side projected SVD + residuals of one svds check
    (svd_solvers.fypp:80-102), dynamic active size.  Zero-padding the
    inactive block keeps its singular values at exactly 0, which sort
    last; inactive slots carry ``res = +inf``."""
    kdim = B.shape[1]
    idx = jnp.arange(kdim)
    active = idx < k_eff
    Bk = jnp.where(active[:, None] & active[None, :], B[:kdim, :kdim], 0.0)
    um, s, vmh = jnp.linalg.svd(Bk)  # descending; padded zeros last
    vm = vmh.T
    km1 = jnp.maximum(k_eff - 1, 0)
    beta = jnp.abs(B[k_eff, km1])
    r = beta * jnp.abs(vm[km1, :])  # (:93)
    res = jnp.where(active, r, jnp.inf)
    n_conv = jnp.sum(jnp.where(idx < nsv, res, jnp.inf) < tol)
    return s, res, um, vm, n_conv.astype(jnp.int32)


@partial(jax.jit, static_argnames=())
def _fused_bidiag_sweep(A, U, V, B, kstart, kend, nsv, tol, btol, stride=1):
    """One Golub-Kahan sweep with per-STEP on-device SVD convergence
    checks in a single jitted ``while_loop`` (see
    :func:`~lightkrylov_tpu.solvers.eigs._fused_sweep`)."""
    kdim = B.shape[1]
    rdt = B.dtype
    kstart = jnp.asarray(kstart, jnp.int32)
    kend = jnp.asarray(kend, jnp.int32)
    nsv = jnp.asarray(nsv, jnp.int32)
    stride = jnp.asarray(stride, jnp.int32)

    def cond(c):
        k, info, n_conv = c[3], c[4], c[5]
        return (k < kend) & (info == 0) & (n_conv < nsv)

    def body(c):
        U, V, B, k, info, n_conv, s, res, um, vm = c
        U, V, B, alpha, beta = bidiag_step(A, U, V, B, k, tol=btol)
        broke = (alpha <= btol) | (beta <= btol)
        info = jnp.where(broke, k + 1, info).astype(jnp.int32)
        nan = jnp.isnan(jnp.real(alpha)) | jnp.isnan(jnp.real(beta))
        info = jnp.where(nan, -(k + 1), info).astype(jnp.int32)
        k_eff = jnp.where(info > 0, info, k + 1).astype(jnp.int32)
        do_check = (((k + 1 - kstart) % stride == 0) | (k + 1 >= kend)
                    | (info != 0))
        s, res, um, vm, n_conv = jax.lax.cond(
            do_check,
            lambda a: _ritz_check_svd(a[0], a[1], tol, nsv),
            lambda a: a[2], (B, k_eff, (s, res, um, vm, n_conv)))
        n_conv = jnp.where(info < 0, jnp.int32(0), n_conv)
        return U, V, B, k + 1, info, n_conv, s, res, um, vm

    init = (U, V, B, kstart - 1, jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.int32), jnp.zeros(kdim, rdt),
            jnp.full((kdim,), jnp.inf, rdt), jnp.zeros((kdim, kdim), rdt),
            jnp.zeros((kdim, kdim), rdt))
    return jax.lax.while_loop(cond, body, init)


@partial(jax.jit, static_argnames=("n",))
def _svds_thick_restart_device(U, V, B, s, um, vm, n: int):
    """Fully on-device Baglama-Reichel thick restart from the fused
    sweep's device outputs — no singular-vector fetch, no host assembly
    (``n`` is static; see the host path below for the algebra)."""
    kdim = B.shape[1]
    idx = jnp.arange(kdim)
    keep = idx < n
    beta = B[kdim, kdim - 1]
    Pk = jnp.where(keep[None, :], um, 0.0)
    Qk = jnp.where(keep[None, :], vm, 0.0)
    U_lead = jax.tree.map(lambda l: l[:kdim], U)
    Uc = vectors.linear_combination(U_lead, Pk)
    Vc = vectors.linear_combination(V, Qk)
    u_res = vectors.get_column(U, kdim)
    U_new = jax.tree.map(
        lambda c, full: jnp.concatenate([c, jnp.zeros_like(full[:1])],
                                        axis=0), Uc, U)
    U_new = vectors.set_column(U_new, n, u_res)
    B_new = jnp.zeros_like(B)
    B_new = B_new.at[idx, idx].set(jnp.where(keep, s, 0.0))
    B_new = B_new.at[n, :].set(jnp.where(keep, beta * vm[kdim - 1, :], 0.0))
    return U_new, Vc, B_new


@timed_fn("svds", "IterativeSolvers")
def svds(A, nsv: int, u0=None, v_template=None, kdim: int | None = None,
         tolerance: float | None = None, options: SVDSOptions | None = None,
         key=None, check_every: int | None = None,
         resume_from: str | None = None):
    """Leading singular triplets -> ``(U, S, V, residuals, info, metadata)``
    with ``U``/``V`` stacked bases of ``nsv`` left/right singular vectors and
    ``S`` descending (reference: ``svds``, svd_solvers.fypp:28-119; restart
    cycles bounded by ``options.maxiter``).

    ``options.checkpoint_every``/``checkpoint_path`` + ``resume_from``:
    persist/restore ``(U, V, B, kstart, cycle, niter)`` at sweep/restart
    boundaries (see :func:`~lightkrylov_tpu.solvers.eigs.eigs`)."""
    A = aslinop(A)
    opts = options or SVDSOptions()
    if kdim is None:
        kdim = opts.kdim or 4 * nsv
    if u0 is None:
        raise ValueError("svds requires u0 (codomain template/seed vector)")
    if v_template is None:
        v_template = u0  # square operator
    dt = vectors.dtype_of(u0)
    rdt = constants.real_dtype_of(dt)
    tol = tolerance if tolerance is not None else constants.rtol(rdt)
    stride = kdim if not check_every else check_every

    seed = u0
    if float(vectors.norm(seed)) == 0.0:
        # lazy key creation: the PRNG is only touched on the zero-seed path
        seed = vectors.rand_like(key if key is not None
                                 else vectors.default_key(), u0)
    U, V, B = initialize_bidiag(seed, v_template, kdim)

    niter = 0
    kstart = 1
    cycle0 = 0
    ckpt = _DriverCheckpointer(opts.checkpoint_every, opts.checkpoint_path)
    if resume_from is not None:
        st = _resume_driver_state(
            {"U": U, "V": V, "B": B, "kstart": np.zeros((), np.int64),
             "cycle": np.zeros((), np.int64), "niter": np.zeros((), np.int64)},
            resume_from)
        U, V, B = st["U"], st["V"], st["B"]
        kstart, cycle0, niter = st["kstart"], st["cycle"], st["niter"]
        log_information(
            f"svds: resumed from {resume_from} (cycle {cycle0}, "
            f"kstart {kstart}, {niter} sweeps done)", "solvers", "svds")
    res_history = []
    invariant = False
    n_conv = 0
    use_device = _device_projected(opts, dt, symmetric=True)
    btol = constants.atol(rdt)
    svecs_device = None  # (um, vm) device pair when the fused path ran last
    adapt = (_AdaptiveStride(kdim, "svds")
             if (use_device and not check_every) else None)
    for cycle in range(cycle0, opts.maxiter):
        if use_device:
            dstride = (check_every if (check_every or 0) >= 1
                       else adapt.next_stride())
            t_cycle0 = time.perf_counter()
            U, V, B, k_dev, binfo_d, nconv_d, s_d, res_d, um_dev, vm_dev = \
                _fused_bidiag_sweep(A, U, V, B, kstart, kdim, nsv, tol,
                                    btol, stride=dstride)
            k_fin, binfo, n_conv, s_h, r_all = jax.device_get(
                (k_dev, binfo_d, nconv_d, s_d, res_d))
            k_fin, binfo, n_conv = int(k_fin), int(binfo), int(n_conv)
            if adapt is not None:
                adapt.record(time.perf_counter() - t_cycle0,
                             k_fin - (kstart - 1), dstride)
            check_info(binfo, "bidiagonalization", "solvers", "svds")
            k_eff = binfo if binfo > 0 else k_fin
            count_applications(A, k_fin - (kstart - 1), "matvec")
            count_applications(A, k_fin - (kstart - 1), "rmatvec")
            niter += k_fin - (kstart - 1)
            s = np.asarray(s_h)[:k_eff]
            r = np.asarray(r_all)[:k_eff]
            if binfo > 0:
                invariant = True  # residuals exactly zero (beta = 0)
            res_history.append(r[: min(nsv, len(r))].copy())
            svals, res, k_final = s, r, k_eff
            svecs_device, umat = (um_dev, vm_dev), None
            vmat = None
            ckpt.check()
            if n_conv >= nsv or invariant:
                break
            if cycle < opts.maxiter - 1 and k_final == kdim:
                # fully on-device thick restart — no fetch, no host math
                n = min(max(nsv + (kdim - nsv) // 2, nsv + 1), kdim - 1)
                U, V, B = _svds_thick_restart_device(
                    U, V, B, s_d, um_dev, vm_dev, n)
                kstart = n + 1
                ckpt.save({"U": U, "V": V, "B": B,
                           "kstart": np.int64(kstart),
                           "cycle": np.int64(cycle + 1),
                           "niter": np.int64(niter)})
                log_information(
                    f"svds: thick restart cycle {cycle + 1}, kept n={n}, "
                    f"{n_conv}/{nsv} converged", "solvers", "svds")
            continue
        else:
            k = kstart
            while k <= kdim:
                kend = min(kdim, k + stride - 1)
                U, V, B, binfo = bidiagonalization(A, U, V, B, kstart=k, kend=kend)
                binfo = int(binfo)
                check_info(binfo, "bidiagonalization", "solvers", "svds")
                k_eff = binfo if binfo > 0 else kend
                count_applications(A, max(k_eff - (k - 1), 0), "matvec")
                count_applications(A, max(k_eff - (k - 1), 0), "rmatvec")
                niter += k_eff - (k - 1)

                Bh = linalg.to_host(B)
                Bk = Bh[:k_eff, :k_eff]
                um, s, vmh = np.linalg.svd(Bk)
                vm = vmh.conj().T
                beta = abs(Bh[k_eff, k_eff - 1])
                r = beta * np.abs(vm[-1, :])  # (:93)
                if binfo > 0:
                    r = np.zeros_like(r)
                    invariant = True
                n_conv = int(np.sum(r[:nsv] < tol))
                res_history.append(r[: min(nsv, len(r))].copy())
                svals, umat, vmat, res, k_final = s, um, vm, r, k_eff
                ckpt.check()
                if n_conv >= nsv or invariant:
                    break
                if kend < kdim:
                    ckpt.save({"U": U, "V": V, "B": B,
                               "kstart": np.int64(kend + 1),
                               "cycle": np.int64(cycle),
                               "niter": np.int64(niter)})
                k = kend + 1
        if n_conv >= nsv or invariant:
            break
        if cycle < opts.maxiter - 1 and k_final == kdim:
            # Thick restart onto the n best triplets (Baglama-Reichel).
            n = min(max(nsv + (kdim - nsv) // 2, nsv + 1), kdim - 1)
            beta = linalg.to_host(B[kdim, kdim - 1])
            Pk = np.zeros((kdim, kdim), dtype=np.dtype(dt))
            Pk[:, :n] = umat[:, :n]
            Qk = np.zeros((kdim, kdim), dtype=np.dtype(dt))
            Qk[:, :n] = vmat[:, :n]
            U_lead = vectors.lead(U, kdim)
            Uc = _reconstruct(U_lead, Pk)
            Vc = _reconstruct(V, Qk)
            u_res = vectors.get_column(U, kdim)
            U = jax.tree.map(
                lambda c, full: jnp.concatenate(
                    [c, jnp.zeros_like(full[:1])], axis=0),
                Uc, U)
            U = vectors.set_column(U, n, u_res)
            V = Vc
            B_new = np.zeros(B.shape, dtype=np.dtype(dt))
            B_new[np.arange(n), np.arange(n)] = svals[:n]
            B_new[n, :n] = beta * vmat[kdim - 1, :n]
            B = jnp.asarray(B_new)
            kstart = n + 1
            ckpt.save({"U": U, "V": V, "B": B, "kstart": np.int64(kstart),
                       "cycle": np.int64(cycle + 1),
                       "niter": np.int64(niter)})
            log_information(
                f"svds: thick restart cycle {cycle + 1}, kept n={n}, "
                f"{n_conv}/{nsv} converged", "solvers", "svds")

    if (n_conv < nsv and not invariant and use_device
            and umat is None and svecs_device is not None):
        # final f64 host recheck of the (tiny, exact) projected problem —
        # settles a working-dtype residual-floor straddle deterministically
        # (the f32 device SVD cannot place |vm[k-1, i]| below ~eps_f32, so
        # residuals floor at ~eps_f32 * sigma_max; the f64 SVD of the SAME
        # stored B measures the factorization's true projected residual —
        # see the eigs driver)
        Bh = linalg.to_host(B).astype(np.float64)
        if k_final > 0:
            um, s, vmh = np.linalg.svd(Bh[:k_final, :k_final])
            vm = vmh.T
            beta = abs(Bh[k_final, k_final - 1])
            r = beta * np.abs(vm[-1, :])
            n_conv2 = int(np.sum(r[:nsv] < tol))
            if n_conv2 > n_conv:
                log_information(
                    f"svds: final f64 host recheck sharpened the converged "
                    f"count {n_conv} -> {n_conv2}", "solvers", "svds")
                svals, umat, vmat, res = s, um, vm, r
                svecs_device = None
                n_conv = n_conv2
                res_history.append(r[: min(nsv, len(r))].copy())

    converged = n_conv >= nsv or invariant
    if not converged:
        log_warning(f"svds: only {n_conv}/{nsv} triplets converged "
                    f"after {opts.maxiter} cycles", "solvers", "svds")

    nsv_out = min(nsv, len(svals))
    cu = np.zeros((kdim + 1, nsv_out), dtype=np.dtype(dt))
    cv = np.zeros((kdim, nsv_out), dtype=np.dtype(dt))
    if umat is None and svecs_device is not None:
        # fused path: singular vectors stayed on device; ONE fetch here
        um_h, vm_h = jax.device_get(svecs_device)
        cu[:kdim, :] = np.asarray(um_h)[:, :nsv_out]
        cv[:, :] = np.asarray(vm_h)[:, :nsv_out]
    else:
        cu[:k_final, :] = umat[:, :nsv_out]
        cv[:k_final, :] = vmat[:, :nsv_out]
    Usv = _reconstruct(U, cu)
    Vsv = _reconstruct(V, cv)

    info = n_conv if converged else -n_conv
    meta = SolverMetadata(
        converged=converged, n_iter=niter, n_inner=niter, info=info,
        residuals=np.concatenate(res_history) if res_history else np.zeros(0),
    )
    return (
        Usv,
        svals[:nsv_out].astype(rdt),
        Vsv,
        res[:nsv_out].astype(rdt),
        info,
        meta,
    )
