"""General eigenvalue solver: Arnoldi + Krylov-Schur restart.

Counterpart of ``eigs``
(reference: src/IterativeSolvers/IterativeSolvers.fypp:971-1143): an outer
Krylov-Schur loop growing an Arnoldi factorization, dense eigensolve of the
projected Hessenberg, Ritz residuals ``|beta * (last row of eigvec)|``
(:1069-1083), convergence when ``count(res < tol) >= nev`` (:1087-1092),
restart through ``krylov_schur`` with a median-of-|lambda| selector on
non-convergence at ``kdim`` (:1099-1100,1137-1142), and post-processing that
sorts by ``|lambda|`` descending and reconstructs the Ritz vectors as
``X @ eigvecs`` (:1108-1132).  Defaults: ``kdim = 4*nev``, ``tol = rtol``
(:1023-1024).

Two projected-eigensolve paths (``options.projected``):

- ``"device"`` (opt-in, real dtypes): the Arnoldi
  sweep AND the k x k eigensolve run in ONE jitted ``while_loop``
  (:func:`_fused_sweep`) — ``arnoldi_step`` + the jitted Francis-QR /
  inverse-iteration Ritz analysis of ``utils/hessenberg.py`` per step.
  That is the reference's step-by-step convergence checking
  (IterativeSolvers.fypp:1057-1092) at zero host round-trips and with
  early exit at the first converged check (minimal matvecs — dominant
  when the operator is a time-stepper).  Default in-loop cadence:
  adaptive (``_AdaptiveStride``; ``check_every >= 1`` overrides) — it
  weighs the cost of a projected solve against stride-1 skipped matvecs.
- ``"host"`` (the ``"auto"`` default; complex dtypes always): the sweep between
  checks is one jitted ``while_loop`` (dynamic ``kstart``/``kend`` — a
  single compiled executable serves every restart cycle); the k x k
  eigensolve is host LAPACK GEEV and each check syncs once.  Check cadence
  via ``check_every``: ``0`` (default) checks only at ``kdim``
  (ARPACK-style, minimal round-trips), ``1`` reproduces the reference's
  per-step checking at one sync per step.

Device-mode RESTARTS are device-resident too: the default median selector
uses the exact-shift IRAM filter (``iram_restart`` — zero host traffic),
and custom selectors / the post-restart arrow form use the device
Krylov-Schur path (``krylov_schur_device``: jitted Francis Schur +
dtrexc-style ``ordschur_device`` block swaps; only the kdim-bool selector
mask crosses the wire).  Host LAPACK remains the safety net: two
consecutive truncation-only IRAM restarts reroute to the device Schur
path, and a rejected block swap there reroutes to host (every flag rides
the next cycle's batched fetch).

The driver defaults to single-vector Arnoldi — like the reference's eigs
(blksize-1, IterativeSolvers.fypp:1030).  ``blksize = p > 1`` (beyond the
reference, whose block Arnoldi exists only as a building block,
arnoldi.fypp:34-73) runs the BLOCK driver: a fused device block sweep
(``arnoldi_block_step`` + block-residual :func:`hessenberg_ritz` in one
jitted ``while_loop``) with device Krylov-Schur restarts
(``krylov_schur_device(p=p)`` keeps exactly the selected count; the
continuation is offset-aligned, block starts at ``n, n+p, ...``) — real
dtypes only, and better at clustered/multiple eigenvalues (one matvec
batch of p per step rides a single GEMM).
"""

from __future__ import annotations

import math
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants, vectors
from ..krylov.arnoldi import (arnoldi, arnoldi_block_step, arnoldi_step,
                              initialize_arnoldi, initialize_arnoldi_block)
from ..krylov.krylov_schur import (iram_restart, krylov_schur,
                                   krylov_schur_device, median_selector)
from ..linops import aslinop
from ..utils import linalg
from ..utils.hessenberg import hessenberg_ritz
from ..utils.logger import check_info, log_information, log_warning
from ..utils.options import EigsOptions, SolverMetadata
from ..utils.timer import count_applications, timed_fn

__all__ = ["eigs", "save_eigenspectrum"]


@jax.jit
def _reconstruct_jit(X_lead, coeffs):
    # linear_combination contracts matrix coefficients at HIGHEST
    # precision (no TF32 rounding of f32 Ritz vectors)
    return vectors.linear_combination(X_lead, coeffs)


def _reconstruct(X_lead, coeffs):
    """Ritz-vector reconstruction ``X @ coeffs`` (jitted tall-skinny GEMM).

    When the coefficients are complex over a *real* basis (real-operator
    eigenproblem), the contraction is performed as two real matmuls with
    the real/imag split done *outside* the jit boundary, and the complex
    result is assembled on device.
    """
    coeffs = np.asarray(coeffs)
    basis_real = not any(
        np.issubdtype(l.dtype, np.complexfloating)
        for l in jax.tree_util.tree_leaves(X_lead))
    if np.issubdtype(coeffs.dtype, np.complexfloating) and basis_real:
        rdt = jax.tree_util.tree_leaves(X_lead)[0].dtype
        re = _reconstruct_jit(X_lead, jnp.asarray(coeffs.real.astype(rdt)))
        im = _reconstruct_jit(X_lead, jnp.asarray(coeffs.imag.astype(rdt)))
        return jax.tree.map(jax.lax.complex, re, im)
    return _reconstruct_jit(X_lead, jnp.asarray(coeffs))


def _ritz_residuals(H, evecs, k):
    """Ritz residuals ``res_i = |H[k, k-1]| * |evecs[k-1, i]|``
    (reference: IterativeSolvers.fypp:1069-1083 — with complex eigvecs the
    real-operator conjugate-pair bookkeeping of LAPACK disappears)."""
    beta = abs(H[k, k - 1])
    return beta * np.abs(evecs[-1, :])


def _device_projected(opts: EigsOptions, dt, symmetric: bool,
                      platform: str | None = None) -> bool:
    """Whether the projected k x k problem is solved ON DEVICE, fused into
    the Krylov sweep, instead of on the host with LAPACK per check.

    Real dtypes only (the device path is real-arithmetic by construction;
    complex projected problems keep the host path).  ``"auto"`` selects the
    device path for the ``symmetric`` projected problems of ``eighs`` and
    ``svds`` on any accelerator, where each host check costs a sync and a
    stall of the sweep, and the host path on the CPU.  The non-symmetric
    problem of ``eigs`` takes the host path on every platform: on the H100
    it solved the realified Ginzburg-Landau problem faster, and the device
    restart has an open non-convergence case (PERF.md, ROADMAP A2).
    ``platform`` defaults to ``jax.default_backend()``.
    """
    if np.issubdtype(np.dtype(dt), np.complexfloating):
        return False
    if opts.projected != "auto":
        return opts.projected == "device"
    if platform is None:
        platform = jax.default_backend()
    return symmetric and platform != "cpu"


@partial(jax.jit, static_argnames=("transpose",))
def _fused_sweep(A, X, H, kstart, kend, nev, tol, btol, transpose,
                 stride=1):
    """One Arnoldi sweep with per-STEP on-device Ritz convergence checks:
    ``arnoldi_step`` + :func:`hessenberg_ritz` inside a single jitted
    ``while_loop`` — the reference's step-by-step checking
    (IterativeSolvers.fypp:1057-1092) at zero host round-trips, where the
    host path pays one sync per check.  Exits at the first step where
    ``count(res < tol) >= nev`` (saving matvecs — the dominant cost when
    the operator is a time-stepper), on invariant-subspace breakdown, or at
    ``kend``.

    Returns ``(X, H, k_final, info, n_conv, wr, wi, res, Vr, Vi, ok)`` —
    all device values; ``ok`` False means the QR sweep budget ran out and
    the caller must redo this check on the host.
    """
    kdim = H.shape[1]
    rdt = H.dtype
    kstart = jnp.asarray(kstart, jnp.int32)
    kend = jnp.asarray(kend, jnp.int32)
    nev = jnp.asarray(nev, jnp.int32)
    stride = jnp.asarray(stride, jnp.int32)

    def cond(c):
        _X, _H, k, info, n_conv = c[0], c[1], c[2], c[3], c[4]
        return (k < kend) & (info == 0) & (n_conv < nev)

    def body(c):
        X, H, k, info, n_conv, wr, wi, res, Vr, Vi, ok = c
        X, H, beta = arnoldi_step(A, X, H, k, transpose=transpose, tol=btol)
        info = jnp.where(beta <= btol, k + 1, info).astype(jnp.int32)
        info = jnp.where(jnp.isnan(jnp.real(beta)), -(k + 1),
                         info).astype(jnp.int32)
        k_eff = jnp.where(info > 0, info, k + 1).astype(jnp.int32)
        # ritz only every `stride` steps (and always at the sweep end /
        # on breakdown): the projected solve costs ~20 ms at kdim=40,
        # which dominates when matvecs are cheap
        do_check = (((k + 1 - kstart) % stride == 0) | (k + 1 >= kend)
                    | (info != 0))
        wr, wi, res, Vr, Vi, n_conv, ok = jax.lax.cond(
            do_check,
            lambda a: hessenberg_ritz(a[0], a[1], tol, nev),
            lambda a: a[2], (H, k_eff, (wr, wi, res, Vr, Vi, n_conv, ok)))
        # fatal NaN: n_conv is meaningless — zero it so the caller's
        # convergence logic can't act on it (cond exits via info != 0)
        n_conv = jnp.where(info < 0, jnp.int32(0), n_conv)
        return X, H, k + 1, info, n_conv, wr, wi, res, Vr, Vi, ok

    init = (X, H, kstart - 1, jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.int32), jnp.zeros(kdim, rdt),
            jnp.zeros(kdim, rdt), jnp.full((kdim,), jnp.inf, rdt),
            jnp.zeros((kdim, kdim), rdt), jnp.zeros((kdim, kdim), rdt),
            jnp.asarray(False))
    return jax.lax.while_loop(cond, body, init)


@partial(jax.jit, static_argnames=("transpose", "p"))
def _fused_sweep_block(A, X, H, s0, nev, tol, btol, transpose, p, stride=1):
    """Block counterpart of :func:`_fused_sweep`: ``arnoldi_block_step`` +
    block-residual :func:`hessenberg_ritz` in one jitted ``while_loop``,
    iterating over COLUMN offsets ``s0, s0 + p, ...`` while
    ``s <= kdim - p`` (offset-aligned continuation: a restart keeps
    exactly the selected count, so ``s0`` need not be a block multiple;
    up to ``p - 1`` trailing buffer columns per cycle go unused).

    After the step at offset ``s`` the projected square has ``s + p``
    active columns — that is the ``k_eff`` fed to the Ritz check.
    Breakdown: smallest ``|diag R|`` of the new block below ``btol`` ->
    ``info = s + p`` (processed-column count, as ``arnoldi_block``);
    NaN -> negative.  Returns
    ``(X, H, s_final, info, n_conv, wr, wi, res, Vr, Vi, ok)`` — the
    final active square size is ``info`` on breakdown else ``s_final``,
    and ``s_final - s0`` is the matvec count of the sweep.
    """
    kdim = H.shape[1]
    rdt = H.dtype
    s0 = jnp.asarray(s0, jnp.int32)
    nev = jnp.asarray(nev, jnp.int32)
    stride = jnp.asarray(stride, jnp.int32)

    def cond(c):
        s, info, n_conv = c[2], c[3], c[4]
        return (s <= kdim - p) & (info == 0) & (n_conv < nev)

    def body(c):
        X, H, s, info, n_conv, wr, wi, res, Vr, Vi, ok = c
        X, H, rmin = arnoldi_block_step(A, X, H, s, p, transpose=transpose,
                                        tol=btol)
        info = jnp.where(rmin <= btol, s + p, info).astype(jnp.int32)
        info = jnp.where(jnp.isnan(rmin), -(s + 1), info).astype(jnp.int32)
        k_eff = jnp.where(info > 0, info, s + p).astype(jnp.int32)
        n_steps = (s + p - s0) // p
        do_check = ((n_steps % stride == 0) | (s + p > kdim - p)
                    | (info != 0))
        wr, wi, res, Vr, Vi, n_conv, ok = jax.lax.cond(
            do_check,
            lambda a: hessenberg_ritz(a[0], a[1], tol, nev, p=p),
            lambda a: a[2], (H, k_eff, (wr, wi, res, Vr, Vi, n_conv, ok)))
        n_conv = jnp.where(info < 0, jnp.int32(0), n_conv)
        return X, H, s + p, info, n_conv, wr, wi, res, Vr, Vi, ok

    init = (X, H, s0, jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.int32), jnp.zeros(kdim, rdt),
            jnp.zeros(kdim, rdt), jnp.full((kdim,), jnp.inf, rdt),
            jnp.zeros((kdim, kdim), rdt), jnp.zeros((kdim, kdim), rdt),
            jnp.asarray(False))
    return jax.lax.while_loop(cond, body, init)


class _AdaptiveStride:
    """Device-mode convergence-check cadence (the reference checks every
    step, IterativeSolvers.fypp:1057-1092; on device each in-loop projected
    solve costs ``t_check`` while a skipped check wastes at most
    ``stride - 1`` extra matvecs, so the break-even stride is
    ``t_check / t_step``).

    Neither cost is known a priori — the operator may be anything from a
    5-point stencil to a full time-stepper — so the first cycles measure
    them: cycle 0 runs at the tuned default (its wall time includes the
    compile and is discarded), cycle 1 probes stride 1, cycle 2 probes
    stride 8; the two clean measurements pin ``(t_step, t_check)`` by a
    2x2 linear solve and every later cycle runs at
    ``round(t_check / t_step)`` clamped to ``[1, kdim]``.  Cheap matvecs
    therefore get a long cadence (the projected solve dominates),
    expensive time-steppers get per-step checks (minimal wasted matvecs).
    An explicit ``check_every >= 1`` bypasses adaptation entirely; strides
    are traced arguments of the fused sweep, so no cycle recompiles.
    """

    DEFAULT = 4
    PROBE2 = 8

    def __init__(self, kdim: int, name: str):
        self.kdim = int(kdim)
        self.name = name
        self.stride = self.DEFAULT
        self._phase = 0
        self._obs = []

    def next_stride(self) -> int:
        if self._phase == 0:
            return self.DEFAULT
        if self._phase == 1:
            return 1
        if self._phase == 2:
            return max(2, min(self.PROBE2, self.kdim))
        return self.stride

    def record(self, seconds: float, n_steps: int, stride: int) -> None:
        phase = self._phase
        self._phase += 1
        if n_steps <= 0 or phase == 0 or phase > 2:
            if phase == 0:
                self._phase = 1
            return
        n_checks = max(1, math.ceil(n_steps / max(1, stride)))
        self._obs.append((float(seconds), n_steps, n_checks))
        if phase == 2 and len(self._obs) == 2:
            (T1, n1, m1), (T2, n2, m2) = self._obs
            A = np.array([[n1, m1], [n2, m2]], dtype=np.float64)
            b = np.array([T1, T2], dtype=np.float64)
            try:
                t_step, t_check = np.linalg.solve(A, b)
            except np.linalg.LinAlgError:
                return
            if t_check <= 0:
                self.stride = 1          # checks measured free
            elif t_step <= 0:
                self.stride = self.kdim  # steps measured free
            else:
                self.stride = int(np.clip(round(t_check / t_step),
                                          1, self.kdim))
            log_information(
                f"{self.name}: adaptive check cadence -> every "
                f"{self.stride} steps (t_step {t_step * 1e3:.2f} ms, "
                f"t_check {t_check * 1e3:.2f} ms)", "solvers", self.name)


class _DriverCheckpointer:
    """Checkpoint cadence + persistence shared by the eigen drivers.

    The reference's restart capability is algorithmic only (kstart/kend +
    Krylov-Schur compression; state never serialized —
    BaseKrylov.fypp:714-837, SURVEY.md §5); this adds the serialization so
    an interrupted multi-cycle run (e.g. a lost job) resumes from
    the last safe sweep boundary instead of from scratch.

    ``every`` counts convergence checks; state is written at the next *safe*
    boundary — one where re-entering the driver loop with the stored
    ``(kstart, cycle)`` reproduces the uninterrupted run exactly.  Saves are
    io-rank-gated; multi-host sharded state should use the Orbax backend.
    """

    def __init__(self, every: int, path):
        self.every = int(every or 0)
        self.path = path
        self._since = 0

    def check(self) -> None:
        self._since += 1

    @property
    def due(self) -> bool:
        return (self.every > 0 and self.path is not None
                and self._since >= self.every)

    def save(self, state: dict) -> None:
        if not self.due:
            return
        from ..utils.checkpoint import save_checkpoint

        if constants.io_rank():
            save_checkpoint(state, self.path)
        self._since = 0


def _resume_driver_state(template: dict, path: str) -> dict:
    from ..utils.checkpoint import load_checkpoint

    st = load_checkpoint(template, path)
    for k in ("kstart", "cycle", "niter"):
        st[k] = int(st[k])
    return st


@timed_fn("eigs", "IterativeSolvers")
def eigs(A, nev: int, x0=None, kdim: int | None = None, tolerance: float | None = None,
         transpose: bool = False, select=None, options: EigsOptions | None = None,
         key=None, check_every: int | None = None, resume_from: str | None = None,
         blksize: int = 1):
    """Leading eigenpairs of a general square operator ->
    ``(eigvals, eigvecs, residuals, info, metadata)``.

    ``eigvals`` are sorted by modulus (descending, complex dtype),
    ``eigvecs`` is a stacked basis of ``nev`` Ritz vectors, ``residuals``
    the matching Ritz residual norms, ``info`` the number of converged pairs
    (negative if not converged within ``maxiter`` restart cycles)
    (reference: ``eigs``, IterativeSolvers.fypp:971-1143).

    Documented deviation: convergence counts the LEADING ``nev`` Ritz
    values (modulus-descending — the ones actually returned), where the
    reference counts over the whole spectrum (:1087-1092) and can
    therefore return a leading pair whose residual still exceeds ``tol``
    because a trailing pair made up the count.  Here ``info = nev``
    guarantees every returned pair meets the tolerance.

    ``options.checkpoint_every``/``checkpoint_path`` persist the
    factorization state ``(X, H, kstart, cycle, niter)`` at sweep/restart
    boundaries; ``resume_from=`` restores it and continues the run
    (``x0`` then only supplies the buffer template/shardings).

    ``blksize = p > 1`` switches to the BLOCK Arnoldi driver (beyond the
    reference, whose eigs is blksize-1, IterativeSolvers.fypp:1030): fused
    device block sweeps with device Krylov-Schur restarts.  Real dtypes
    only; ``kdim`` is rounded up to a multiple of ``p``;
    checkpoint/resume is not supported in block mode.
    """
    A = aslinop(A)
    opts = options or EigsOptions()
    if kdim is None:
        kdim = opts.kdim or 4 * nev  # (reference: :1023)
    if x0 is None:
        raise ValueError("eigs requires x0 (a template/seed vector)")
    if blksize > 1:
        return _eigs_block(A, nev, x0, kdim, tolerance, transpose, select,
                           opts, key, check_every, resume_from, blksize)
    dt = vectors.dtype_of(x0)
    rdt = constants.real_dtype_of(dt)
    cdt = np.dtype(np.complex64) if np.dtype(rdt) == np.float32 else np.dtype(np.complex128)
    tol = tolerance if tolerance is not None else constants.rtol(rdt)
    if select is None:
        select = median_selector
    if check_every is None:
        check_every = 0
    stride = kdim if check_every == 0 else check_every

    seed = x0
    if float(vectors.norm(seed)) == 0.0:
        # lazy key creation: the PRNG is only touched on the zero-seed path
        seed = vectors.rand_like(key if key is not None
                                 else vectors.default_key(), x0)
    X, H = initialize_arnoldi(seed, kdim)

    kstart = 1
    cycle0 = 0
    n_conv = 0
    niter = 0
    # IRAM device restarts require (and preserve) a purely Hessenberg H;
    # a host Krylov-Schur restart leaves the arrow form, after which the
    # device restart would be truncation-only — route those to the host
    h_is_hessenberg = True
    ckpt = _DriverCheckpointer(opts.checkpoint_every, opts.checkpoint_path)
    if resume_from is not None:
        st = _resume_driver_state(
            {"X": X, "H": H, "kstart": np.zeros((), np.int64),
             "cycle": np.zeros((), np.int64), "niter": np.zeros((), np.int64)},
            resume_from)
        X, H = st["X"], st["H"]
        kstart, cycle0, niter = st["kstart"], st["cycle"], st["niter"]
        Hh_r = np.asarray(jax.device_get(H))
        h_is_hessenberg = bool(np.all(np.tril(Hh_r[:kdim, :kdim], -2) == 0))
        log_information(
            f"eigs: resumed from {resume_from} (cycle {cycle0}, "
            f"kstart {kstart}, {niter} matvecs done)", "solvers", "eigs")
    res_history = []
    evals = evecs = res = None
    evecs_device = None  # (Vr, Vi) device pair when the fused path ran last
    invariant = False
    use_device = _device_projected(opts, dt, symmetric=False)
    btol = constants.atol(rdt)
    # device-restart health: the restart flags are
    # device scalars; they ride the NEXT cycle's batched fetch instead of
    # costing their own sync
    pending_flags: list = []   # [(kind, device_scalar)]
    iram_fail = 0              # consecutive truncation-only IRAM restarts
    device_ks_ok = True        # device Schur-reorder restarts healthy
    adapt = (_AdaptiveStride(kdim, "eigs")
             if (use_device and check_every == 0) else None)

    for cycle in range(cycle0, opts.maxiter):
        if use_device:
            # whole sweep + per-step Ritz checks in one jitted while_loop;
            # ONE batched fetch per restart cycle.  In-loop check cadence:
            # adaptive by default (see _AdaptiveStride); check_every >= 1
            # pins it.
            dstride = check_every if check_every >= 1 else adapt.next_stride()
            t_cycle0 = time.perf_counter()
            X, H, k_dev, ainfo_d, nconv_d, wr_d, wi_d, res_d, Vr, Vi, dok = \
                _fused_sweep(A, X, H, kstart, kdim, nev, tol, btol,
                             transpose, stride=dstride)
            # ONE batched fetch; kstart may be a device scalar left by the
            # on-device IRAM/Schur restart of the previous cycle
            fetch = [k_dev, ainfo_d, nconv_d, wr_d, wi_d, res_d, dok,
                     kstart] + [f for _, f in pending_flags]
            out = jax.device_get(tuple(fetch))
            (k_fin, ainfo, n_conv, wr_h, wi_h, r_all, dok_h,
             kstart_h) = out[:8]
            k_fin, ainfo, n_conv = int(k_fin), int(ainfo), int(n_conv)
            kstart_h = int(kstart_h)
            if adapt is not None:
                adapt.record(time.perf_counter() - t_cycle0,
                             k_fin - (kstart_h - 1), dstride)
            for (kind, _), v in zip(pending_flags, out[8:]):
                if kind == "iram":
                    if bool(v):
                        iram_fail = 0
                    else:
                        iram_fail += 1
                        log_warning(
                            "eigs: device IRAM filter applied no spectral "
                            "filtering (restart degenerated to a pure "
                            f"truncation; {iram_fail} consecutive)",
                            "solvers", "eigs")
                elif kind == "ks" and not bool(v):
                    device_ks_ok = False
                    log_warning(
                        "eigs: device Schur reordering rejected a block "
                        "swap; routing restarts to host LAPACK",
                        "solvers", "eigs")
            pending_flags = []
            check_info(ainfo, "arnoldi", "solvers", "eigs")
            k_eff = ainfo if ainfo > 0 else k_fin
            niter += k_fin - (kstart_h - 1)
            count_applications(A, k_fin - (kstart_h - 1),
                               "rmatvec" if transpose else "matvec")
            if bool(dok_h) or k_eff == 0:
                w = (np.asarray(wr_h) + 1j * np.asarray(wi_h))[:k_eff]
                r = np.asarray(r_all)[:k_eff]
                evecs_device = (Vr, Vi)
                evecs = None
            else:
                # QR sweep budget ran out (pathological H): redo on host
                log_warning("eigs: device Hessenberg QR did not converge; "
                            "host fallback for this check", "solvers", "eigs")
                Hh = linalg.to_host(H)
                w, V = np.linalg.eig(Hh[:k_eff, :k_eff])
                r = _ritz_residuals(Hh, V, k_eff)
                order = np.argsort(-np.abs(w))
                w, V, r = w[order], V[:, order], r[order]
                n_conv = int(np.sum(r[:nev] < tol))
                evecs, evecs_device = V, None
            if ainfo > 0:
                invariant = True  # residuals are exactly zero (beta = 0)
            res_history.append(r[: min(nev, len(r))].copy())
            if opts.write_intermediate and constants.io_rank():
                _write_intermediate(opts.outpost, w, r)
            evals, res, k_final = w, r, k_eff
            ckpt.check()
            if n_conv >= nev or invariant:
                break
            if cycle < opts.maxiter - 1:
                if (select is median_selector and h_is_hessenberg
                        and iram_fail < 2):
                    # fully on-device IRAM filter restart — no host
                    # round-trip; kstart stays a device scalar and rides
                    # the next cycle's batched fetch (as does the filter's
                    # ok flag — two consecutive truncation-only restarts
                    # reroute to the device Schur path below)
                    X, H, n_dev, rok = iram_restart(X, H, kdim // 2)
                    pending_flags.append(("iram", rok))
                    kstart = n_dev + 1
                    if ckpt.due:  # checkpointing needs concrete indices
                        kstart = int(jax.device_get(n_dev)) + 1
                        ckpt.save({"X": X, "H": H,
                                   "kstart": np.int64(kstart),
                                   "cycle": np.int64(cycle + 1),
                                   "niter": np.int64(niter)})
                elif device_ks_ok and bool(dok_h):
                    # custom selector, arrow-form H, or IRAM-filter
                    # fallback: device Krylov-Schur restart (jitted
                    # schur_real + ordschur_device) — the selector runs on
                    # the host over the eigenvalues the convergence check
                    # already fetched; the only host->device traffic is
                    # the kdim-bool mask
                    w_act = (np.asarray(wr_h) + 1j * np.asarray(wi_h))[:k_eff]
                    mask = np.zeros(kdim, bool)
                    mask[:k_eff] = np.asarray(select(w_act), bool)
                    X, H, n_dev, ksok = krylov_schur_device(
                        X, H, wr_d, wi_d, jnp.asarray(mask))
                    pending_flags.append(("ks", ksok))
                    h_is_hessenberg = False  # arrow form from here on
                    kstart = n_dev + 1
                    if ckpt.due:
                        kstart = int(jax.device_get(n_dev)) + 1
                        ckpt.save({"X": X, "H": H,
                                   "kstart": np.int64(kstart),
                                   "cycle": np.int64(cycle + 1),
                                   "niter": np.int64(niter)})
                    log_information(
                        f"eigs: device Schur restart cycle {cycle + 1}, "
                        f"{n_conv}/{nev} converged", "solvers", "eigs")
                else:
                    # device restart unhealthy (rejected swap / failed QR
                    # check): host Krylov-Schur
                    X, H, n = krylov_schur(X, H, select)
                    h_is_hessenberg = False  # arrow form from here on
                    kstart = n + 1
                    ckpt.save({"X": X, "H": H, "kstart": np.int64(kstart),
                               "cycle": np.int64(cycle + 1),
                               "niter": np.int64(niter)})
                    log_information(
                        f"eigs: host restart cycle {cycle + 1}, compressed "
                        f"to n={n}, {n_conv}/{nev} converged",
                        "solvers", "eigs")
            continue
        k = kstart
        while k <= kdim:
            kend = min(kdim, k + stride - 1)
            X, H, ainfo = arnoldi(A, X, H, kstart=k, kend=kend, transpose=transpose)
            ainfo = int(ainfo)
            check_info(ainfo, "arnoldi", "solvers", "eigs")
            k_eff = ainfo if ainfo > 0 else kend
            niter += k_eff - (k - 1)
            count_applications(A, k_eff - (k - 1),
                               "rmatvec" if transpose else "matvec")

            Hh = linalg.to_host(H)
            Hk = Hh[:k_eff, :k_eff]
            w, V = np.linalg.eig(Hk)
            r = _ritz_residuals(Hh, V, k_eff) if k_eff > 0 else np.zeros(0)
            if ainfo > 0:
                r = np.zeros_like(r)  # invariant subspace: exact (:1099)
                invariant = True
            order = np.argsort(-np.abs(w))
            w, V, r = w[order], V[:, order], r[order]
            n_conv = int(np.sum(r[:nev] < tol))
            res_history.append(r[: min(nev, len(r))].copy())
            if opts.write_intermediate and constants.io_rank():
                _write_intermediate(opts.outpost, w, r)
            evals, evecs, res, k_final = w, V, r, k_eff
            ckpt.check()
            if n_conv >= nev or invariant:
                break
            if kend < kdim:
                # mid-cycle sweep boundary: resuming re-enters this cycle
                # at k = kend + 1
                ckpt.save({"X": X, "H": H,
                           "kstart": np.int64(kend + 1),
                           "cycle": np.int64(cycle),
                           "niter": np.int64(niter)})
            k = kend + 1
        if n_conv >= nev or invariant:
            break
        if cycle < opts.maxiter - 1:
            # Krylov-Schur restart (:1099-1100)
            X, H, n = krylov_schur(X, H, select)
            kstart = n + 1
            # restart boundary: resuming starts the next cycle at n + 1
            ckpt.save({"X": X, "H": H, "kstart": np.int64(kstart),
                       "cycle": np.int64(cycle + 1),
                       "niter": np.int64(niter)})
            log_information(
                f"eigs: restart cycle {cycle + 1}, compressed to n={n}, "
                f"{n_conv}/{nev} converged", "solvers", "eigs")

    if (n_conv < nev and not invariant and use_device
            and evecs is None and evecs_device is not None):
        # Final host recheck at f64: the fused device path measures Ritz
        # residuals in the working dtype, whose floor (~1e-6 at f32 for
        # the realified GL problem) can sit at a tight
        # tolerance and make the converged count flap run-to-run.  The
        # projected problem is exact host data a few kB large: one f64
        # eigensolve of the fetched H settles convergence
        # deterministically (the residual beta*|v_last| is a property of
        # the STORED factorization, so sharper projected eigenvectors are
        # legitimately sharper residuals, not cosmetics).
        Hh = linalg.to_host(H).astype(np.float64)
        if k_final > 0:
            w, V = np.linalg.eig(Hh[:k_final, :k_final])
            r = _ritz_residuals(Hh, V, k_final)
            order = np.argsort(-np.abs(w))
            w, V, r = w[order], V[:, order], r[order]
            n_conv2 = int(np.sum(r[:nev] < tol))
            if n_conv2 > n_conv:
                log_information(
                    f"eigs: final f64 host recheck sharpened the converged "
                    f"count {n_conv} -> {n_conv2}", "solvers", "eigs")
                evals, evecs, res = w, V, r
                evecs_device = None
                n_conv = n_conv2
                res_history.append(r[: min(nev, len(r))].copy())

    converged = n_conv >= nev or invariant
    if not converged:
        log_warning(f"eigs: only {n_conv}/{nev} pairs converged", "solvers", "eigs")

    # Post-processing: reconstruct Ritz vectors X @ eigvecs (:1108-1132).
    nev_out = min(nev, len(evals))
    coeffs = np.zeros((kdim, nev_out), dtype=cdt)
    if evecs is None and evecs_device is not None:
        # fused path: eigvecs stayed on device all run; ONE fetch here
        Vr_h, Vi_h = jax.device_get(evecs_device)
        coeffs[:, :] = (np.asarray(Vr_h)
                        + 1j * np.asarray(Vi_h))[:, :nev_out]
    else:
        coeffs[:k_final, :] = evecs[:, :nev_out]
    # Keep the basis in its native (possibly real) dtype: linear_combination
    # splits complex coefficients over a real basis into two real matmuls
    # + lax.complex.
    X_lead = vectors.lead(X, kdim)
    ritz_vecs = _reconstruct(X_lead, coeffs)

    info = n_conv if converged else -n_conv
    check_info(info if not converged else niter, "eigs", "solvers", "eigs")
    meta = SolverMetadata(
        converged=converged, n_iter=niter, n_inner=niter, info=info,
        residuals=np.concatenate(res_history) if res_history else np.zeros(0),
    )
    # eigenvalues/residuals are host-computed scalars: return them as numpy
    # (avoids a pointless host-to-device round trip).
    return (
        evals[:nev_out].astype(cdt),
        ritz_vecs,
        res[:nev_out].astype(rdt),
        info,
        meta,
    )


def _block_host_ritz(Hh, k_eff, p, nev, tol):
    """Host Ritz analysis of a BLOCK Arnoldi buffer: eig of the active
    square + block residuals ``||B y_last_p||`` with
    ``B = Hh[k:k+p, k-p:k]`` (the safety net when the device QR sweep
    budget runs out, and the final f64 recheck)."""
    w, V = np.linalg.eig(Hh[:k_eff, :k_eff])
    B = Hh[k_eff:k_eff + p, k_eff - p:k_eff]
    r = np.linalg.norm(B @ V[-p:, :], axis=0)
    order = np.argsort(-np.abs(w))
    w, V, r = w[order], V[:, order], r[order]
    n_conv = int(np.sum(r[:nev] < tol))
    return w, V, r, n_conv


def _eigs_block(A, nev, x0, kdim, tolerance, transpose, select, opts, key,
                check_every, resume_from, p):
    """Block-Arnoldi eigs driver (``blksize = p > 1``): the device-fused
    path of :func:`eigs` generalized to blocks — ``_fused_sweep_block``
    per cycle + ``krylov_schur_device(p=p)`` restarts (exact selected
    count, offset-aligned continuation), with an explicit restart (reseed
    from the leading Ritz direction) as the safety net when a Schur block
    swap is rejected.  Runs the same fused machinery on every backend
    (the host projected path has no block form).  Real dtypes only.
    """
    if resume_from is not None or opts.checkpoint_every:
        raise NotImplementedError(
            "eigs(blksize>1): checkpoint/resume is not supported in block "
            "mode — use blksize=1 for checkpointed runs")
    dt = vectors.dtype_of(x0)
    if np.issubdtype(np.dtype(dt), np.complexfloating):
        raise TypeError(
            "eigs(blksize>1) is real-only (the device Schur machinery is "
            "real-arithmetic by construction); realify the operator or "
            "use blksize=1")
    rdt = constants.real_dtype_of(dt)
    cdt = (np.dtype(np.complex64) if np.dtype(rdt) == np.float32
           else np.dtype(np.complex128))
    kdim = int(-(-kdim // p) * p)  # round up to a block multiple
    nblocks = kdim // p  # first-cycle sweep length (cadence probing)
    tol = tolerance if tolerance is not None else constants.rtol(rdt)
    if select is None:
        select = median_selector
    if check_every is None:
        check_every = 0

    seed = x0
    if float(vectors.norm(seed)) == 0.0:
        seed = vectors.rand_like(key if key is not None
                                 else vectors.default_key(), x0)
    init_key = key if key is not None else vectors.default_key(1)
    X, H = initialize_arnoldi_block(seed, kdim, p, key=init_key)

    s0 = 0  # column offset of the newest filled block
    n_conv = 0
    niter = 0
    res_history = []
    evals = evecs = res = None
    evecs_device = None
    invariant = False
    k_final = 0
    btol = constants.atol(rdt)
    pending_flags = []
    device_ks_ok = True
    adapt = (_AdaptiveStride(nblocks, "eigs-block")
             if check_every == 0 else None)

    for cycle in range(opts.maxiter):
        dstride = check_every if check_every >= 1 else adapt.next_stride()
        t_cycle0 = time.perf_counter()
        X, H, s_dev, ainfo_d, nconv_d, wr_d, wi_d, res_d, Vr, Vi, dok = \
            _fused_sweep_block(A, X, H, s0, nev, tol, btol,
                               transpose, p, stride=dstride)
        fetch = [s_dev, ainfo_d, nconv_d, wr_d, wi_d, res_d, dok,
                 s0] + [f for _, f in pending_flags]
        out = jax.device_get(tuple(fetch))
        (s_fin, ainfo, n_conv, wr_h, wi_h, r_all, dok_h, s0_h) = out[:8]
        s_fin, ainfo, n_conv = int(s_fin), int(ainfo), int(n_conv)
        s0_h = int(s0_h)
        if adapt is not None:
            adapt.record(time.perf_counter() - t_cycle0,
                         (s_fin - s0_h) // p, dstride)
        for (kind, _), v in zip(pending_flags, out[8:]):
            if kind == "ks" and not bool(v):
                device_ks_ok = False
                log_warning(
                    "eigs(block): device Schur restart unhealthy (rejected "
                    "block swap); restarting explicitly",
                    "solvers", "eigs")
        pending_flags = []
        check_info(ainfo, "arnoldi", "solvers", "eigs")
        k_eff = ainfo if ainfo > 0 else s_fin
        niter += s_fin - s0_h
        count_applications(A, s_fin - s0_h,
                           "rmatvec" if transpose else "matvec")
        if bool(dok_h) or k_eff == 0:
            w = (np.asarray(wr_h) + 1j * np.asarray(wi_h))[:k_eff]
            r = np.asarray(r_all)[:k_eff]
            evecs_device = (Vr, Vi)
            evecs = None
        else:
            log_warning("eigs(block): device Hessenberg QR did not "
                        "converge; host fallback for this check",
                        "solvers", "eigs")
            Hh = np.asarray(jax.device_get(H))
            w, V, r, n_conv = _block_host_ritz(Hh, k_eff, p, nev, tol)
            evecs, evecs_device = V, None
        if ainfo > 0:
            invariant = True  # block breakdown: subspace (near-)invariant
        res_history.append(r[: min(nev, len(r))].copy())
        if opts.write_intermediate and constants.io_rank():
            _write_intermediate(opts.outpost, w, r)
        evals, res, k_final = w, r, k_eff
        if n_conv >= nev or invariant:
            break
        if cycle < opts.maxiter - 1:
            if device_ks_ok and bool(dok_h):
                w_act = (np.asarray(wr_h) + 1j * np.asarray(wi_h))[:k_eff]
                mask = np.zeros(kdim, bool)
                mask[:k_eff] = np.asarray(select(w_act), bool)
                X, H, n_dev, ksok = krylov_schur_device(
                    X, H, wr_d, wi_d, jnp.asarray(mask), p=p,
                    k_eff=jnp.asarray(k_eff, jnp.int32))
                pending_flags.append(("ks", ksok))
                s0 = n_dev  # continuation is offset-aligned
                log_information(
                    f"eigs(block): device Schur restart cycle {cycle + 1}, "
                    f"{n_conv}/{nev} converged", "solvers", "eigs")
            else:
                # explicit restart: reseed the block buffer from the
                # leading Ritz direction (always exact; loses subspace
                # history — only the safety net lands here)
                if evecs_device is not None:
                    Vr_d, _ = evecs_device
                    lead_basis = vectors.lead(X, kdim)
                    seed_b = vectors.linear_combination(
                        lead_basis, Vr_d[:, :1])
                    v = vectors.get_column(seed_b, 0)
                else:
                    buf = np.zeros((kdim, 1), dtype=np.dtype(rdt))
                    buf[:k_eff, 0] = np.real(evecs[:, 0])
                    seed_b = vectors.linear_combination(
                        vectors.lead(X, kdim), jnp.asarray(buf))
                    v = vectors.get_column(seed_b, 0)
                X, H = initialize_arnoldi_block(v, kdim, p, key=init_key)
                s0 = 0
                device_ks_ok = True  # fresh factorization, try again
                log_information(
                    f"eigs(block): explicit restart cycle {cycle + 1}, "
                    f"{n_conv}/{nev} converged", "solvers", "eigs")

    if (n_conv < nev and not invariant and evecs is None
            and evecs_device is not None):
        # final f64 host recheck (same rationale as the blksize-1 path)
        Hh = np.asarray(jax.device_get(H)).astype(np.float64)
        if k_final > 0:
            w, V, r, n_conv2 = _block_host_ritz(Hh, k_final, p, nev, tol)
            if n_conv2 > n_conv:
                log_information(
                    f"eigs(block): final f64 host recheck sharpened the "
                    f"converged count {n_conv} -> {n_conv2}",
                    "solvers", "eigs")
                evals, evecs, res = w, V, r
                evecs_device = None
                n_conv = n_conv2
                res_history.append(r[: min(nev, len(r))].copy())

    converged = n_conv >= nev or invariant
    if not converged:
        log_warning(f"eigs(block): only {n_conv}/{nev} pairs converged",
                    "solvers", "eigs")

    nev_out = min(nev, len(evals))
    coeffs = np.zeros((kdim, nev_out), dtype=cdt)
    if evecs is None and evecs_device is not None:
        Vr_h, Vi_h = jax.device_get(evecs_device)
        coeffs[:, :] = (np.asarray(Vr_h)
                        + 1j * np.asarray(Vi_h))[:, :nev_out]
    else:
        coeffs[:k_final, :] = evecs[:, :nev_out]
    X_lead = vectors.lead(X, kdim)
    ritz_vecs = _reconstruct(X_lead, coeffs)

    info = n_conv if converged else -n_conv
    check_info(info if not converged else niter, "eigs", "solvers", "eigs")
    meta = SolverMetadata(
        converged=converged, n_iter=niter, n_inner=niter, info=info,
        residuals=np.concatenate(res_history) if res_history else np.zeros(0),
    )
    return (
        evals[:nev_out].astype(cdt),
        ritz_vecs,
        res[:nev_out].astype(rdt),
        info,
        meta,
    )


def _write_intermediate(path, eigvals, residuals):
    """Text dump of the current Ritz values (reference: ``write_results_*``,
    IterativeSolvers.fypp:882-925, IO-rank gated)."""
    with open(path, "w") as f:
        f.write("# re(lambda) im(lambda) residual\n")
        for lam, r in zip(eigvals, residuals):
            f.write(f"{lam.real:+.16e} {lam.imag:+.16e} {r:.16e}\n")


def save_eigenspectrum(eigvals, residuals, path: str) -> None:
    """Persist the spectrum as ``.npy`` (reference: ``save_eigenspectrum``,
    IterativeSolvers.fypp:944-963 — stdlib ``save_npy``)."""
    eigvals = np.asarray(jax.device_get(eigvals))
    residuals = np.asarray(jax.device_get(residuals))
    out = np.zeros((len(eigvals), 3))
    out[:, 0] = eigvals.real
    out[:, 1] = eigvals.imag
    out[:, 2] = residuals
    np.save(path, out)
