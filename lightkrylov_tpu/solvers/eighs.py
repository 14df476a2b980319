"""Hermitian eigenvalue solver: Lanczos + dense eigh, with thick restart.

Counterpart of ``eighs``
(reference: src/IterativeSolvers/EIGHS/eighs.fypp): incremental Lanczos with
full re-orthogonalization plus a dense ``eigh`` of the projected tridiagonal
each check (eighs.fypp:79-101), Ritz residuals ``|beta * v_last|`` (:91-92),
descending sort and Ritz-vector reconstruction (:107-123).

The reference has **no restart** (noted WIP, IterativeSolvers.fypp:743-746);
here we add standard *thick restart* (Wu & Simon): on non-convergence at
``kdim`` the basis is compressed onto the ``n`` best Ritz vectors,
``T`` becomes diag(theta) with the residual coupling row
``beta * v_last`` at row ``n``, and Lanczos continues from column ``n+1`` —
the full CGS2 re-orthogonalization of :mod:`lanczos` keeps the identity
``A X_k = X_{k+1} T_k`` exact for the resulting arrowhead matrix.

Two projected-eigensolve paths (``options.projected``, as in
:mod:`eigs`): ``"device"`` (default on accelerators via ``"auto"``, real dtypes)
fuses ``lanczos_step`` + projected ``eigh`` + convergence check into ONE
jitted ``while_loop`` per cycle and thick-restarts on device too — the
reference's per-step cadence (eighs.fypp:79-101) at zero host
round-trips with early exit on the first converged step.  ``"host"``
(default on the CPU) fetches ``T`` per check for a host ``eigh``;
``check_every = 0`` (default) then checks once per Lanczos sweep and
``check_every = 1`` reproduces the per-step cadence at one sync per step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from functools import partial

import time

from .. import constants, vectors
from ..krylov.lanczos import initialize_lanczos, lanczos, lanczos_step
from ..linops import aslinop
from .eigs import (_AdaptiveStride, _DriverCheckpointer, _device_projected,
                   _reconstruct, _resume_driver_state)
from ..utils import linalg
from ..utils.logger import check_info, log_information, log_warning
from ..utils.options import EigsOptions, SolverMetadata
from ..utils.timer import count_applications, timed_fn

__all__ = ["eighs"]


def _ritz_check_sym(T, k_eff, tol, nev):
    """Device-side projected eigensolve + Ritz residuals of the Lanczos
    buffer (the eighs check, eighs.fypp:79-101), dynamic active size.

    The active ``k_eff x k_eff`` block is embedded with strongly-negative
    dummy diagonal entries so its eigenpairs occupy the LEADING positions
    after the descending sort; inactive slots carry ``res = +inf``.
    Returns ``(w, res, V, n_conv)`` with ``n_conv = count(res[:nev] < tol)``
    (the host/reference convention)."""
    kdim = T.shape[1]
    idx = jnp.arange(kdim)
    active = idx < k_eff
    Tk = T[:kdim, :kdim]
    Tk = (Tk + Tk.T) / 2  # CGS2 fills tiny asymmetric noise
    Tm = jnp.where(active[:, None] & active[None, :], Tk, 0.0)
    norm = jnp.max(jnp.abs(Tm)) + 1.0
    dummy = -norm * (2.0 + idx.astype(T.dtype) / kdim)
    Tm = Tm.at[idx, idx].set(jnp.where(active, jnp.diagonal(Tm), dummy))
    w, V = jnp.linalg.eigh(Tm)  # ascending; dummies are the most negative
    w, V = w[::-1], V[:, ::-1]  # descending: active block leads
    km1 = jnp.maximum(k_eff - 1, 0)
    beta = jnp.abs(T[k_eff, km1])
    r = beta * jnp.abs(V[km1, :])
    res = jnp.where(active, r, jnp.inf)  # post-sort: active = first k_eff
    n_conv = jnp.sum(jnp.where(idx < nev, res, jnp.inf) < tol)
    return w, res, V, n_conv.astype(jnp.int32)


@partial(jax.jit, static_argnames=())
def _fused_lanczos_sweep(A, X, T, kstart, kend, nev, tol, btol, stride=1):
    """One Lanczos sweep with per-STEP on-device convergence checks:
    ``lanczos_step`` + projected ``eigh`` inside a single jitted
    ``while_loop`` — the reference's step-by-step cadence
    (eighs.fypp:79-101) at zero host round-trips, exiting at the first
    converged step (see :func:`~lightkrylov_tpu.solvers.eigs._fused_sweep`
    for the non-Hermitian analogue)."""
    kdim = T.shape[1]
    rdt = T.dtype
    kstart = jnp.asarray(kstart, jnp.int32)
    kend = jnp.asarray(kend, jnp.int32)
    nev = jnp.asarray(nev, jnp.int32)
    stride = jnp.asarray(stride, jnp.int32)

    def cond(c):
        k, info, n_conv = c[2], c[3], c[4]
        return (k < kend) & (info == 0) & (n_conv < nev)

    def body(c):
        X, T, k, info, n_conv, w, res, V = c
        X, T, beta = lanczos_step(A, X, T, k, tol=btol)
        info = jnp.where(beta <= btol, k + 1, info).astype(jnp.int32)
        info = jnp.where(jnp.isnan(jnp.real(beta)), -(k + 1),
                         info).astype(jnp.int32)
        k_eff = jnp.where(info > 0, info, k + 1).astype(jnp.int32)
        do_check = (((k + 1 - kstart) % stride == 0) | (k + 1 >= kend)
                    | (info != 0))
        w, res, V, n_conv = jax.lax.cond(
            do_check,
            lambda a: _ritz_check_sym(a[0], a[1], tol, nev),
            lambda a: a[2], (T, k_eff, (w, res, V, n_conv)))
        n_conv = jnp.where(info < 0, jnp.int32(0), n_conv)
        return X, T, k + 1, info, n_conv, w, res, V

    init = (X, T, kstart - 1, jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.int32), jnp.zeros(kdim, rdt),
            jnp.full((kdim,), jnp.inf, rdt), jnp.zeros((kdim, kdim), rdt))
    return jax.lax.while_loop(cond, body, init)


@partial(jax.jit, static_argnames=("n",))
def _thick_restart_device(X, T, w, V, n: int):
    """Fully on-device thick restart (device-mode counterpart of the host
    assembly below): compress onto the leading ``n`` Ritz pairs of the
    fused sweep's device outputs (``w``/``V`` sorted descending), rebuild
    ``T = diag(w[:n])`` with the coupling row ``beta * V[kdim-1, :n]`` at
    row ``n``, and move the residual vector to column ``n`` — zero host
    round-trips (``n`` is static: the keep count does not depend on the
    spectrum)."""
    kdim = T.shape[1]
    idx = jnp.arange(kdim)
    beta = T[kdim, kdim - 1]
    keep = idx < n
    Vk = jnp.where(keep[None, :], V, 0.0)
    X_lead = jax.tree.map(lambda l: l[:kdim], X)
    Xc = vectors.linear_combination(X_lead, Vk)
    T_new = jnp.zeros_like(T)
    T_new = T_new.at[idx, idx].set(jnp.where(keep, w, 0.0))
    T_new = T_new.at[n, :].set(jnp.where(keep, beta * V[kdim - 1, :], 0.0))
    x_res = vectors.get_column(X, kdim)
    X_new = jax.tree.map(
        lambda c, full: jnp.concatenate([c, jnp.zeros_like(full[:1])],
                                        axis=0), Xc, X)
    X_new = vectors.set_column(X_new, n, x_res)
    return X_new, T_new


@jax.jit
def _thick_restart_compress(X, V_keep, diag_w, coupling):
    """On-device compression: Xc = X[:kdim] @ V_keep (tall-skinny GEMM) and
    rebuild of the (kdim+1, kdim) T buffer with diag + coupling row."""
    kdim = V_keep.shape[0]
    X_lead = jax.tree.map(lambda l: l[:kdim], X)
    Xc = vectors.linear_combination(X_lead, V_keep)
    T_new = jnp.zeros((kdim + 1, kdim), V_keep.dtype)
    T_new = T_new.at[jnp.arange(kdim), jnp.arange(kdim)].set(diag_w)
    return Xc, T_new, coupling


@timed_fn("eighs", "IterativeSolvers")
def eighs(A, nev: int, x0=None, kdim: int | None = None,
          tolerance: float | None = None, options: EigsOptions | None = None,
          key=None, check_every: int | None = None,
          resume_from: str | None = None):
    """Leading eigenpairs of a symmetric/Hermitian operator ->
    ``(eigvals, eigvecs, residuals, info, metadata)``; eigvals real,
    sorted descending (reference: ``eighs``, eighs.fypp:28-123; restart
    cycles bounded by ``options.maxiter``).

    ``options.checkpoint_every``/``checkpoint_path`` + ``resume_from``:
    persist/restore ``(X, T, kstart, cycle, niter)`` at sweep/restart
    boundaries (see :func:`~lightkrylov_tpu.solvers.eigs.eigs`)."""
    A = aslinop(A)
    opts = options or EigsOptions()
    if kdim is None:
        kdim = opts.kdim or 4 * nev
    if x0 is None:
        raise ValueError("eighs requires x0 (a template/seed vector)")
    dt = vectors.dtype_of(x0)
    rdt = constants.real_dtype_of(dt)
    tol = tolerance if tolerance is not None else constants.rtol(rdt)
    stride = kdim if not check_every else check_every

    seed = x0
    if float(vectors.norm(seed)) == 0.0:
        # lazy key creation: the PRNG is only touched on the zero-seed path
        seed = vectors.rand_like(key if key is not None
                                 else vectors.default_key(), x0)
    X, T = initialize_lanczos(seed, kdim)

    niter = 0
    kstart = 1
    cycle0 = 0
    ckpt = _DriverCheckpointer(opts.checkpoint_every, opts.checkpoint_path)
    if resume_from is not None:
        st = _resume_driver_state(
            {"X": X, "H": T, "kstart": np.zeros((), np.int64),
             "cycle": np.zeros((), np.int64), "niter": np.zeros((), np.int64)},
            resume_from)
        X, T = st["X"], st["H"]
        kstart, cycle0, niter = st["kstart"], st["cycle"], st["niter"]
        log_information(
            f"eighs: resumed from {resume_from} (cycle {cycle0}, "
            f"kstart {kstart}, {niter} matvecs done)", "solvers", "eighs")
    res_history = []
    invariant = False
    n_conv = 0
    use_device = _device_projected(opts, dt, symmetric=True)
    btol = constants.atol(rdt)
    evecs_device = None  # device V when the fused path ran last
    adapt = (_AdaptiveStride(kdim, "eighs")
             if (use_device and not check_every) else None)
    for cycle in range(cycle0, opts.maxiter):
        if use_device:
            dstride = (check_every if (check_every or 0) >= 1
                       else adapt.next_stride())
            t_cycle0 = time.perf_counter()
            X, T, k_dev, linfo_d, nconv_d, w_d, res_d, V_dev = \
                _fused_lanczos_sweep(A, X, T, kstart, kdim, nev, tol, btol,
                                     stride=dstride)
            k_fin, linfo, n_conv, w_h, r_all = jax.device_get(
                (k_dev, linfo_d, nconv_d, w_d, res_d))
            k_fin, linfo, n_conv = int(k_fin), int(linfo), int(n_conv)
            if adapt is not None:
                adapt.record(time.perf_counter() - t_cycle0,
                             k_fin - (kstart - 1), dstride)
            check_info(linfo, "lanczos", "solvers", "eighs")
            k_eff = linfo if linfo > 0 else k_fin
            count_applications(A, k_fin - (kstart - 1), "matvec")
            niter += k_fin - (kstart - 1)
            w = np.asarray(w_h)[:k_eff]
            r = np.asarray(r_all)[:k_eff]
            if linfo > 0:
                invariant = True  # residuals exactly zero (beta = 0)
            res_history.append(r[: min(nev, len(r))].copy())
            evals, res, k_final = w, r, k_eff
            evecs_device, evecs = V_dev, None
            ckpt.check()
            if n_conv >= nev or invariant:
                break
            if cycle < opts.maxiter - 1 and k_final == kdim:
                # fully on-device thick restart from the sweep's device
                # outputs — no V fetch, no host assembly
                n = min(max(nev + (kdim - nev) // 2, nev + 1), kdim - 1)
                X, T = _thick_restart_device(X, T, w_d, V_dev, n)
                kstart = n + 1
                ckpt.save({"X": X, "H": T, "kstart": np.int64(kstart),
                           "cycle": np.int64(cycle + 1),
                           "niter": np.int64(niter)})
                log_information(
                    f"eighs: thick restart cycle {cycle + 1}, kept n={n}, "
                    f"{n_conv}/{nev} converged", "solvers", "eighs")
            continue
        else:
            k = kstart
            while k <= kdim:
                kend = min(kdim, k + stride - 1)
                X, T, linfo = lanczos(A, X, T, kstart=k, kend=kend)
                linfo = int(linfo)
                check_info(linfo, "lanczos", "solvers", "eighs")
                k_eff = linfo if linfo > 0 else kend
                count_applications(A, max(k_eff - (k - 1), 0), "matvec")
                niter += k_eff - (k - 1)

                Th = linalg.to_host(T)
                Tk = Th[:k_eff, :k_eff]
                Tk = (Tk + Tk.conj().T) / 2  # CGS2 fills tiny asymmetric noise
                w, V = np.linalg.eigh(Tk)
                beta = abs(Th[k_eff, k_eff - 1])
                r = beta * np.abs(V[-1, :])
                if linfo > 0:
                    r = np.zeros_like(r)
                    invariant = True
                order = np.argsort(-w)  # descending eigenvalue (:107)
                w, V, r = w[order], V[:, order], r[order]
                n_conv = int(np.sum(r[:nev] < tol))
                res_history.append(r[: min(nev, len(r))].copy())
                evals, evecs, res, k_final = w, V, r, k_eff
                ckpt.check()
                if n_conv >= nev or invariant:
                    break
                if kend < kdim:
                    ckpt.save({"X": X, "H": T, "kstart": np.int64(kend + 1),
                               "cycle": np.int64(cycle),
                               "niter": np.int64(niter)})
                k = kend + 1
        if n_conv >= nev or invariant:
            break
        if cycle < opts.maxiter - 1 and k_final == kdim:
            # Thick restart: keep the n best Ritz pairs + residual vector.
            n = min(max(nev + (kdim - nev) // 2, nev + 1), kdim - 1)
            Vk = np.zeros((kdim, kdim), dtype=np.dtype(dt))
            Vk[:, :n] = evecs[:, :n]
            diag_w = np.zeros(kdim, dtype=np.dtype(dt))
            diag_w[:n] = evals[:n]
            beta = linalg.to_host(T[kdim, kdim - 1])
            coupling = np.zeros(kdim, dtype=np.dtype(dt))
            coupling[:n] = beta * evecs[kdim - 1, :n]
            Xc, T_new, coup = _thick_restart_compress(
                X, jnp.asarray(Vk), jnp.asarray(diag_w), jnp.asarray(coupling))
            T_new = T_new.at[n, :].set(coup)
            Xres = vectors.get_column(X, kdim)
            X = jax.tree.map(
                lambda c, full: jnp.concatenate(
                    [c, jnp.zeros_like(full[:1])], axis=0),
                Xc, X)
            X = vectors.set_column(X, n, Xres)
            T = T_new
            kstart = n + 1
            ckpt.save({"X": X, "H": T, "kstart": np.int64(kstart),
                       "cycle": np.int64(cycle + 1),
                       "niter": np.int64(niter)})
            log_information(
                f"eighs: thick restart cycle {cycle + 1}, kept n={n}, "
                f"{n_conv}/{nev} converged", "solvers", "eighs")

    if (n_conv < nev and not invariant and use_device
            and evecs is None and evecs_device is not None):
        # final f64 host recheck of the (tiny, exact) projected problem —
        # settles a working-dtype residual-floor straddle deterministically
        # (see the eigs driver for the rationale)
        Th = linalg.to_host(T).astype(np.float64)
        if k_final > 0:
            Tk = Th[:k_final, :k_final]
            Tk = (Tk + Tk.T) / 2
            w, V = np.linalg.eigh(Tk)
            beta = abs(Th[k_final, k_final - 1])
            r = beta * np.abs(V[-1, :])
            order = np.argsort(-w)
            w, V, r = w[order], V[:, order], r[order]
            n_conv2 = int(np.sum(r[:nev] < tol))
            if n_conv2 > n_conv:
                log_information(
                    f"eighs: final f64 host recheck sharpened the "
                    f"converged count {n_conv} -> {n_conv2}",
                    "solvers", "eighs")
                evals, evecs, res = w, V, r
                evecs_device = None
                n_conv = n_conv2
                res_history.append(r[: min(nev, len(r))].copy())

    converged = n_conv >= nev or invariant
    if not converged:
        log_warning(f"eighs: only {n_conv}/{nev} pairs converged "
                    f"after {opts.maxiter} cycles", "solvers", "eighs")

    nev_out = min(nev, len(evals))
    coeffs = np.zeros((kdim, nev_out), dtype=np.dtype(dt))
    if evecs is None and evecs_device is not None:
        # fused path: eigvecs stayed on device; ONE fetch here (real array)
        coeffs[:, :] = np.asarray(jax.device_get(evecs_device))[:, :nev_out]
    else:
        coeffs[:k_final, :] = evecs[:, :nev_out]
    X_lead = vectors.lead(X, kdim)
    ritz_vecs = _reconstruct(X_lead, coeffs)

    info = n_conv if converged else -n_conv
    meta = SolverMetadata(
        converged=converged, n_iter=niter, n_inner=niter, info=info,
        residuals=np.concatenate(res_history) if res_history else np.zeros(0),
    )
    return (
        evals[:nev_out].real.astype(rdt),
        ritz_vecs,
        res[:nev_out].astype(rdt),
        info,
        meta,
    )
