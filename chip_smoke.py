#!/usr/bin/env python
"""End-to-end smoke run of the solvers on one NVIDIA GPU.

    python chip_smoke.py           # every one-card phase on jax.devices()[0]
    python chip_smoke.py --four    # only the sharded path, on four GPUs

Drives the public API (``lk.cg/gmres/eighs/eigs/svds/kexpm/newton`` and the
``models`` operators) at realistic sizes and checks every result against an
independent reference: numpy on the host, the analytic spectrum, the
committed Ginzburg-Landau anchors (``gl_direct_spectrum.npy``) or the
reference example's published anchors.  Each check prints its value, its
limit, the precision it ran in and why the limit is what it is; each solve
prints its steady-state time after one warm call and the first call's extra
time (compilation).  Any failed check makes the script exit non-zero without
printing a result; on success the last line is one JSON object naming the
device.  It refuses to run unless JAX's first device is a GPU.

The phase functions take their sizes as arguments, so the CPU test suite
runs them at tiny sizes (``tests/test_chip_smoke.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

import lightkrylov_tpu as lk  # noqa: E402
from lightkrylov_tpu import vectors  # noqa: E402
from lightkrylov_tpu.models import (  # noqa: E402
    BlockJacobiPoisson, ConvectionDiffusion2D, GinzburgLandau,
    GinzburgLandauReal, GLPropagator, Poisson2D, poisson2d_eigvals)
from lightkrylov_tpu.ops import BellMatrix, BellOperator  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))

# Reference anchors of the Roessler example (roessler_OTD.f90:31-32,
# main.f90:87-88; BASELINE.md).
ROESSLER_T = 5.881088456
ROESSLER_LE = (0.149141556, 0.0)
ROESSLER_OTD = 0.097000856


# -- reporting ----------------------------------------------------------------

class Phase:
    """Collects one phase's checks; a failed check marks the phase failed."""

    def __init__(self, name: str):
        self.name = name
        self.failures: list[str] = []

    def log(self, msg: str) -> None:
        print(f"[{self.name}] {msg}", flush=True)

    def check(self, what: str, value: float, limit: float, precision: str,
              why: str) -> bool:
        value = float(value)
        ok = bool(np.isfinite(value) and value <= limit)
        self.log(f"{what} = {value:.3e} (limit {limit:.2e}; {precision}; "
                 f"{why}) {'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(what)
        return ok

    def require(self, what: str, cond: bool, detail: str = "") -> bool:
        self.log(f"{what}: {detail} {'ok' if cond else 'FAIL'}")
        if not cond:
            self.failures.append(what)
        return bool(cond)

    def timed(self, what: str, fn):
        """Run ``fn`` twice; report the steady (second) time and the first
        call's extra time, which is compilation."""
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        t_steady = time.perf_counter() - t0
        self.log(f"{what}: steady {t_steady:.4f} s after one warm call; "
                 f"compile ~{max(t_first - t_steady, 0.0):.2f} s "
                 f"(first call {t_first:.2f} s)")
        return out

    def memory(self, what: str, jitted, *args, **kw) -> None:
        """``compiled.memory_analysis()`` of one jitted step."""
        try:
            m = jitted.lower(*args, **kw).compile().memory_analysis()
            self.log(f"{what} memory_analysis: arguments "
                     f"{m.argument_size_in_bytes / 1e9:.3f} GB, outputs "
                     f"{m.output_size_in_bytes / 1e9:.3f} GB, temporaries "
                     f"{m.temp_size_in_bytes / 1e9:.3f} GB")
        except Exception as e:  # noqa: BLE001 - informational only
            self.log(f"{what} memory_analysis unavailable: {e!r:.120}")

    def peak_memory(self) -> None:
        stats = jax.devices()[0].memory_stats() or {}
        if "peak_bytes_in_use" in stats:
            self.log(f"device peak bytes in use so far: "
                     f"{stats['peak_bytes_in_use'] / 1e9:.3f} GB")


def _apply(method: str):
    """Jitted ``op.<method>(x)`` taking the operator as an argument, so its
    arrays are inputs of the executable and not constants baked into it."""
    return jax.jit(lambda op, x: getattr(op, method)(x))


_MATVEC, _RMATVEC = _apply("matvec"), _apply("rmatvec")


def _rel(a, b) -> float:
    a = np.asarray(a)
    b = np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


# -- independent host references ------------------------------------------------

def host_poisson(u) -> np.ndarray:
    """-Delta with Dirichlet zeros on the unit square, in numpy f64
    (independent of the library's stencil)."""
    u = np.asarray(u, dtype=np.float64)
    ny, nx = u.shape
    ihx2, ihy2 = float(nx + 1) ** 2, float(ny + 1) ** 2
    y = (2.0 * (ihx2 + ihy2)) * u
    y[:, 1:] -= ihx2 * u[:, :-1]
    y[:, :-1] -= ihx2 * u[:, 1:]
    y[1:, :] -= ihy2 * u[:-1, :]
    y[:-1, :] -= ihy2 * u[1:, :]
    return y


def host_bell_matvec(data, cols, x) -> np.ndarray:
    """Block-ELL ``A x`` in numpy f64, chunked over block-rows."""
    nbr, K, bm, bn = data.shape
    xb = np.asarray(x, np.float64).reshape(-1, bn)
    y = np.empty((nbr, bm))
    for r0 in range(0, nbr, 4096):
        d = data[r0:r0 + 4096].astype(np.float64)
        y[r0:r0 + 4096] = np.einsum("rkms,rks->rm", d, xb[cols[r0:r0 + 4096]])
    return y.reshape(-1)


def host_bell_rmatvec(data, cols, y) -> np.ndarray:
    """Block-ELL ``A^T y`` (real data) in numpy f64, square matrix."""
    nbr, K, bm, bn = data.shape
    yb = np.asarray(y, np.float64).reshape(nbr, bm)
    out = np.zeros((nbr * bm // bn, bn))
    for r0 in range(0, nbr, 4096):
        d = data[r0:r0 + 4096].astype(np.float64)
        c = np.einsum("rkms,rm->rks", d, yb[r0:r0 + 4096])
        np.add.at(out, cols[r0:r0 + 4096].reshape(-1), c.reshape(-1, bn))
    return out.reshape(-1)


def make_bell(nbr: int, K: int = 4, bm: int = 8, bn: int = 128,
              dtype=np.float32, seed: int = 0):
    """Seeded irregular, diagonally dominant Block-ELL matrix (square,
    n = nbr * bm).  Slot 0 of every block-row holds the diagonal block;
    the other K-1 slots point at random block-columns.  Off-diagonal
    entries are uniform in +-1/(K bn), so every row's off-diagonal
    absolute sum stays below 1 < 1.5 = the diagonal."""
    rng = np.random.default_rng(seed)
    n = nbr * bm
    nbc = n // bn
    cols = np.empty((nbr, K), np.int32)
    cols[:, 0] = np.arange(nbr) * bm // bn
    cols[:, 1:] = rng.integers(0, nbc, (nbr, K - 1))
    data = rng.uniform(-1.0, 1.0, (nbr, K, bm, bn)).astype(dtype)
    data *= dtype(1.0 / (K * bn))
    rows = np.arange(nbr)[:, None] * bm + np.arange(bm)[None, :]
    data[np.arange(nbr)[:, None], 0, np.arange(bm)[None, :], rows % bn] += dtype(1.5)
    return data, cols


# -- phases ------------------------------------------------------------------

def phase_pcg_poisson(ph: Phase, n: int = 128) -> None:
    """BASELINE config 1: PCG with block Jacobi on the n x n Laplacian."""
    b_host = np.random.default_rng(1).standard_normal((n, n))
    # f64 to 1e-10; f32 to 1e-4 (f32 cannot certify much below
    # eps_f32 * kappa(A) ~ 6e-8 * 0.4 n^2)
    for dt, rtol, limit, why in [
            (jnp.float64, 1e-10, 2e-10,
             "CG stops on its recursive residual; the true one may drift by "
             "eps*kappa ~ 1e-12"),
            (jnp.float32, 1e-4, 1e-3,
             "f32 recursive/true residual gap up to eps*kappa ~ 4e-4 at 128^2")]:
        name = np.dtype(dt).name
        op = Poisson2D(n, dtype=dt)
        M = BlockJacobiPoisson(op)
        b = jnp.asarray(b_host.astype(dt))
        x, info, meta = ph.timed(
            f"cg {name}", lambda: lk.cg(op, b, preconditioner=M, rtol=rtol,
                                        atol=0.0,
                                        options=lk.CGOptions(maxiter=4 * n)))
        relres = _rel(host_poisson(np.asarray(x)), b_host.astype(dt))
        ph.require(f"cg {name} converged", meta.converged, f"info={info}")
        ph.check(f"cg {name} true relative residual (host f64)", relres,
                 limit, name, why)
    from lightkrylov_tpu.linops import IdentityOperator
    from lightkrylov_tpu.solvers.cg import _cg_impl

    ph.memory("cg core f64", _cg_impl, Poisson2D(n), jnp.asarray(b_host),
              jnp.zeros((n, n)), IdentityOperator(), jnp.asarray(1e-10),
              4 * n)


def phase_gmres_poisson_large(ph: Phase, n: int = 8192, n_small: int = 512,
                              cycles: int = 5, kdim: int = 30) -> None:
    """GMRES(kdim) for a fixed number of cycles on the n x n Laplacian
    (rtol = atol = 0: unpreconditioned restarted GMRES does not reach a
    small tolerance here, so none is asked)."""
    opts = lk.GMRESOptions(kdim=kdim, maxiter=cycles)
    for dt, lim in [(jnp.float32, 1e-4), (jnp.float64, 1e-10)]:
        name = np.dtype(dt).name
        op = Poisson2D(n, dtype=dt)
        b = jax.random.normal(jax.random.PRNGKey(2), (n, n), dt)
        x, info, meta = ph.timed(
            f"gmres({kdim}) x {cycles} cycles at {n}^2 {name} "
            f"({n * n * np.dtype(dt).itemsize / 1e6:.0f} MB per vector)",
            lambda: lk.gmres(op, b, rtol=0.0, atol=0.0, options=opts))
        ends = np.asarray(meta.residuals).reshape(cycles, -1)[:, -1]
        ph.log(f"{name} residual at each cycle end: "
               + ", ".join(f"{r:.6e}" for r in ends))
        ph.require(f"{name} residual decreases every cycle",
                   bool(np.all(np.diff(ends) < 0)) and np.all(np.isfinite(ends)))
        true = float(np.linalg.norm(np.asarray(b, np.float64)
                                    - host_poisson(np.asarray(x))))
        ph.check(f"{name} |reported - recomputed ||b - A x|| (host f64)| / "
                 "recomputed", abs(ends[-1] - true) / true, lim, name,
                 "the least-squares residual drifts from the true one by "
                 "rounding in the basis and in 1e8-sized operator entries")
        del x, b
        if dt == jnp.float64:
            from lightkrylov_tpu.linops import IdentityOperator
            from lightkrylov_tpu.solvers.gmres import _gmres_impl

            bb = jnp.zeros((n, n), dt)
            ph.memory(f"gmres core {name} at {n}^2", _gmres_impl, op, bb, bb,
                      IdentityOperator(), jnp.asarray(0.0, dt), kdim, cycles,
                      False, False, True, "dcgs2")
            del bb
    ph.peak_memory()
    # the same cycles at n_small^2 on this device and on the host CPU
    cpu = jax.devices("cpu")[0]
    for dt, lim in [(jnp.float32, 1e-4), (jnp.float64, 1e-9)]:
        name = np.dtype(dt).name
        op = Poisson2D(n_small, dtype=dt)
        b_host = np.random.default_rng(3).standard_normal(
            (n_small, n_small)).astype(dt)
        x_d, _, m_d = lk.gmres(op, jnp.asarray(b_host), rtol=0.0, atol=0.0,
                               options=opts)
        x_c, _, m_c = lk.gmres(op, jax.device_put(b_host, cpu), rtol=0.0,
                               atol=0.0, options=opts)
        ph.check(f"{name} {n_small}^2 residual history, device vs CPU",
                 _rel(m_d.residuals, m_c.residuals), lim, name,
                 "same algorithm, different summation order")
        ph.check(f"{name} {n_small}^2 iterate, device vs CPU",
                 _rel(np.asarray(x_d), np.asarray(x_c)), 10 * lim, name,
                 "same algorithm, different summation order")


def phase_eighs_poisson_large(ph: Phase, n: int = 8192, n_conv: int = 256,
                              nev: int = 4, kdim: int = 32,
                              kdim_conv: int = 64) -> None:
    """One fixed kdim-step Lanczos sweep at n^2 (f32 and f64), then eighs
    to convergence at n_conv^2 in f64."""
    lam_max = 4.0 * (n + 1) ** 2 * 2.0 * np.sin(n * np.pi / (2 * (n + 1))) ** 2
    lam_min = 4.0 * (n + 1) ** 2 * 2.0 * np.sin(np.pi / (2 * (n + 1))) ** 2
    for dt in (jnp.float32, jnp.float64):
        name = np.dtype(dt).name
        eps = float(np.finfo(dt).eps)
        op = Poisson2D(n, dtype=dt)
        x0 = jax.random.normal(jax.random.PRNGKey(4), (n, n), dt)
        w, V, res, info, meta = ph.timed(
            f"eighs one {kdim}-step sweep at {n}^2 {name}",
            lambda: lk.eighs(op, nev, x0=x0, kdim=kdim, tolerance=0.0,
                             options=lk.EigsOptions(maxiter=1)))
        w = np.asarray(w, np.float64)
        ph.log(f"{name} Ritz values {np.array2string(w, precision=10)}; "
               f"analytic spectrum [{lam_min:.6e}, {lam_max:.6e}]")
        outside = max(float(np.max(w - lam_max)), float(np.max(lam_min - w)),
                      0.0) / lam_max
        ph.check(f"{name} Ritz values outside the analytic spectrum "
                 "(relative)", outside, 4 * eps, name,
                 "Ritz values of a symmetric operator lie in its spectrum, "
                 "up to rounding")
        res = np.asarray(res, np.float64)
        worst = 0.0
        for i in range(len(w)):
            v = np.asarray(vectors.get_column(V, i), np.float64)
            r_true = np.linalg.norm(host_poisson(v) - w[i] * v) / np.linalg.norm(v)
            worst = max(worst, abs(res[i] - r_true) / (r_true + 1e3 * eps * lam_max))
            ph.log(f"{name} pair {i}: reported residual {res[i]:.6e}, "
                   f"recomputed ||A v - theta v|| (host f64) {r_true:.6e}")
        ph.check(f"{name} reported vs recomputed Ritz residuals (relative, "
                 "floor 1e3 eps ||A||)", worst, 1e-2 if dt == jnp.float32 else 1e-6,
                 name, "|beta e_k^T y| equals ||A v - theta v|| while the "
                 "Lanczos relation holds to ~eps ||A|| per step")
        del V, x0
    # to convergence at n_conv^2, f64
    op = Poisson2D(n_conv, dtype=jnp.float64)
    x0 = jax.random.normal(jax.random.PRNGKey(5), (n_conv, n_conv), jnp.float64)
    tol = 1e-12 * 8.0 * (n_conv + 1) ** 2
    w, V, res, info, meta = ph.timed(
        f"eighs to convergence at {n_conv}^2 float64 (nev {nev}, kdim "
        f"{kdim_conv})",
        lambda: lk.eighs(op, nev, x0=x0, kdim=kdim_conv, tolerance=tol,
                         options=lk.EigsOptions(maxiter=2000)))
    ph.require("eighs converged", info > 0, f"info={info}, {meta.n_iter} matvecs")
    ev = np.sort(np.asarray(poisson2d_eigvals(n_conv)))[::-1]
    dev = max(float(np.min(np.abs(ev - x)) / x) for x in np.asarray(w))
    ph.check(f"eighs {n_conv}^2 eigenvalues vs analytic (relative)", dev,
             1e-10, "float64", "BASELINE target; Ritz error <= res^2/gap")
    from lightkrylov_tpu.krylov.lanczos import initialize_lanczos
    from lightkrylov_tpu.solvers.eighs import _fused_lanczos_sweep

    X, T = initialize_lanczos(x0, kdim_conv)
    ph.memory(f"fused Lanczos sweep at {n_conv}^2 float64", _fused_lanczos_sweep,
              op, X, T, 1, kdim_conv, nev, tol, 1e-14)
    ph.peak_memory()


def _gl_validate(ph: Phase, name: str, gl_dense_matvec, vecs, realified: bool,
                 r_max: float, floor: float) -> None:
    """Rayleigh quotients on the generator, true eigen-residuals (backward
    error) and the kappa-budgeted anchors of gl_direct_spectrum.npy.  For
    the realified operator R(A) the vectors live in C^(2 nx) and each
    anchor may appear as itself or as its conjugate."""
    ref = np.load(os.path.join(ROOT, "gl_direct_spectrum.npy"))
    lam, r = [], []
    for v in vecs:
        Av = gl_dense_matvec(v)
        lam.append(np.vdot(v, Av) / np.vdot(v, v))
        r.append(np.linalg.norm(Av - lam[-1] * v) / np.linalg.norm(v))
    lam, r = np.array(lam), np.array(r)
    ph.check(f"{name} max true eigen-residual ||A v - lam v|| / ||v||",
             float(r.max()), r_max, name, "backward error of the Ritz pairs")
    worst = 0.0
    for k in range(ref.shape[0]):
        w = ref[k, 0] + 1j * ref[k, 1]
        cand = np.abs(lam - w)
        if realified:
            cand = np.minimum(cand, np.abs(lam - np.conj(w)))
        i = int(np.argmin(cand))
        # first-order bound: |dlam| <= kappa * backward error, plus the
        # anchor's own error (its residual column times kappa)
        budget = max(floor, 2.0 * ref[k, 3] * (r[i] + ref[k, 2]))
        worst = max(worst, cand[i] / budget)
        ph.log(f"{name} anchor {k}: |lam - anchor| {cand[i]:.3e}, kappa "
               f"{ref[k, 3]:.2e}, budget {budget:.3e}")
    ph.check(f"{name} worst anchor deviation / kappa budget", worst, 1.0, name,
             "eigenvalue error of a non-normal operator is bounded by "
             "kappa * backward error")


def phase_gl_eigs_complex(ph: Phase, nx: int = 512, nev: int = 8,
                          kdim: int = 16, maxiter: int = 4000,
                          tau: float = 0.01) -> None:
    """eigs through the RK4 propagator exp(tau A) of the complex
    Ginzburg-Landau operator, not realified, at the reference example's
    settings (nx=512, tau=0.01, nev=8, kdim=16)."""
    for dt, tol, r_max, floor in [(jnp.complex128, 1e-10, 1e-7, 1e-11),
                                  (jnp.complex64, 5e-6, 5e-3, 2e-3)]:
        name = np.dtype(dt).name
        gl = GinzburgLandau(nx, dtype=dt)
        prop = GLPropagator(gl, tau=tau, n_steps=10)
        rng = np.random.default_rng(6)
        x0 = jnp.asarray((rng.standard_normal(nx)
                          + 1j * rng.standard_normal(nx)).astype(dt))
        w, V, res, info, meta = ph.timed(
            f"eigs {name} nx={nx} nev={nev} kdim={kdim}",
            lambda: lk.eigs(prop, nev, x0=x0, kdim=kdim, tolerance=tol,
                            options=lk.EigsOptions(maxiter=maxiter)))
        ph.require(f"eigs {name} converged", info > 0,
                   f"info={info}, {meta.n_iter} matvecs; Ritz residual "
                   f"tolerance {tol:g}")
        A = GinzburgLandau(nx, dtype=np.complex128).dense()
        vecs = [np.asarray(vectors.get_column(V, i), np.complex128)
                for i in range(nev)]
        if nx == 512:
            _gl_validate(ph, name, lambda v: A @ v, vecs, False, r_max, floor)
        else:  # tiny rehearsal sizes: the anchors belong to nx=512
            ev = np.linalg.eigvals(A)
            for v in vecs:
                lam = np.vdot(v, A @ v) / np.vdot(v, v)
                ph.check(f"{name} Rayleigh quotient vs dense eig",
                         float(np.min(np.abs(ev - lam))), 1e3 * r_max, name,
                         "rehearsal size")
        ph.peak_memory()


def phase_gl_eigs_projected(ph: Phase, nx: int = 512, nev: int = 8,
                            kdim: int = 40, tau: float = 0.01) -> None:
    """The realified GL problem in f64, projected eigensolve on the device
    and on the host (data for choosing ``projected="auto"``)."""
    glr = GinzburgLandauReal(nx, dtype=jnp.float64)
    prop = GLPropagator(glr, tau=tau, n_steps=10)
    x0 = jnp.asarray(np.random.default_rng(7).standard_normal((2, nx)))
    R = glr.dense()
    for mode in ("device", "host"):
        w, V, res, info, meta = ph.timed(
            f"eigs realified float64 projected={mode}",
            lambda: lk.eigs(prop, 2 * nev, x0=x0, kdim=kdim, tolerance=1e-10,
                            options=lk.EigsOptions(maxiter=2000,
                                                   projected=mode)))
        ph.require(f"projected={mode} converged", info > 0,
                   f"info={info}, {meta.n_iter} matvecs")
        Vc = np.asarray(jax.tree_util.tree_leaves(V)[0])
        vecs = [Vc[i].reshape(-1) for i in range(Vc.shape[0])]
        if nx == 512:
            _gl_validate(ph, f"float64 projected={mode}", lambda v: R @ v,
                         vecs, True, 1e-7, 1e-11)


def phase_roessler(ph: Phase, n_steps: int = 3000, otd_steps: int = 20000) -> None:
    """Newton-Krylov UPO and OTD modes at the fixed point, in f64."""
    from lightkrylov_tpu.models import (floquet_exponents, flow, otd_evolve,
                                        roessler_rhs, upo_system)
    from lightkrylov_tpu.models.roessler import roessler_fixed_points

    sys_ = upo_system(n_steps=n_steps)
    X0 = {"pos": jnp.asarray(np.array([0.0, 6.1, 1.3])), "T": jnp.asarray(6.0)}
    X, info, meta = ph.timed(
        "newton UPO float64",
        lambda: lk.newton(sys_, X0, rtol=0.0, atol=1e-11,
                          options=lk.NewtonOptions(maxiter=60),
                          linear_solver_options=lk.GMRESOptions(kdim=4,
                                                                maxiter=10)))
    ph.require("newton converged", meta.converged, f"info={info}")
    T = float(X["T"])
    ph.check("|T - 5.881088456|", abs(T - ROESSLER_T), 1e-5, "float64",
             "CPU test tolerance; RK4 with 3000 steps")
    closure = float(jnp.linalg.norm(flow(X["pos"], X["T"], n_steps) - X["pos"]))
    ph.check("orbit closure ||flow_T(x) - x||", closure, 1e-8, "float64",
             "Newton stops at atol 1e-11 on this residual")
    mu, LE = floquet_exponents(X["pos"], X["T"], 4000)
    ph.check("|LE_1 - 0.149141556|", abs(LE[0] - ROESSLER_LE[0]), 1e-6,
             "float64", "CPU test tolerance")
    ph.check("|LE_2|", abs(LE[1] - ROESSLER_LE[1]), 1e-8, "float64",
             "neutral direction of a periodic orbit")
    fp_minus, _ = roessler_fixed_points()
    U0 = jnp.asarray(np.linalg.qr(
        np.random.default_rng(0).standard_normal((3, 2)))[0])
    x, U, Lr, lyap = ph.timed(
        f"OTD evolution {otd_steps} RK4 steps float64",
        lambda: otd_evolve(roessler_rhs, jnp.asarray(fp_minus), U0, 50.0,
                           otd_steps))
    wr = np.sort(np.linalg.eigvals(np.asarray(Lr)).real)
    ph.check("OTD reduced-operator eigenvalue real parts vs 0.097000856",
             float(np.max(np.abs(wr - ROESSLER_OTD))), 1e-7, "float64",
             "CPU test tolerance")


def phase_svds_kexpm(ph: Phase, m: int = 48, n_dense: int = 96) -> None:
    """svds on the convection-diffusion operator and kexpm on a dense
    operator, against numpy's SVD and scipy's expm in f64."""
    import scipy.linalg as sla

    Ad = ConvectionDiffusion2D(m, dtype=jnp.float64).dense()
    s_ref = np.linalg.svd(Ad, compute_uv=False)[:4]
    rng = np.random.default_rng(8)
    Am = rng.standard_normal((n_dense, n_dense)) * 0.25
    v = rng.standard_normal(n_dense)
    e_ref = sla.expm(0.8 * Am) @ v
    for dt, stol, slim, ktol, klim in [
            (jnp.float32, 5e-3, 1e-4, 1e-6, 1e-4),
            (jnp.float64, 1e-7, 1e-9, 1e-12, 1e-10)]:
        name = np.dtype(dt).name
        cd = ConvectionDiffusion2D(m, dtype=dt)
        U, S, V, sres, sinfo, _ = ph.timed(
            f"svds {name} {m}^2",
            lambda: lk.svds(cd, 4, u0=jnp.ones((m, m), dt), kdim=30,
                            tolerance=stol, options=lk.SVDSOptions(maxiter=200)))
        ph.require(f"svds {name} converged", sinfo > 0, f"info={sinfo}")
        ph.check(f"svds {name} singular values vs numpy SVD (max relative)",
                 float(np.max(np.abs(np.asarray(S) - s_ref) / s_ref)), slim,
                 name, f"Ritz residual tolerance {stol:g} on sigma ~ "
                 f"{s_ref[0]:.0f}, plus rounding")
        op = lk.DenseOperator(jnp.asarray(Am.astype(dt)))
        c, kinfo = ph.timed(f"kexpm {name} {n_dense}x{n_dense}",
                            lambda: lk.kexpm(op, jnp.asarray(v.astype(dt)),
                                             tau=0.8, tol=ktol))
        ph.check(f"kexpm {name} vs scipy expm (relative)",
                 _rel(np.asarray(c), e_ref), klim, name,
                 f"Krylov error estimate tolerance {ktol:g}, HIGHEST-precision "
                 "products")


def phase_bell_spmv(ph: Phase, nbr: int = 32768, K: int = 4, bm: int = 8,
                    bn: int = 128, cycles: int = 3) -> None:
    """Block-ELL products and GMRES(30) on a seeded irregular, diagonally
    dominant block pattern (>= 0.5 GB of data in f32 at the default size)."""
    for dt, lim, rtol in [(np.float32, 1e-5, 1e-5), (np.float64, 1e-13, 1e-12)]:
        name = np.dtype(dt).name
        data, cols = make_bell(nbr, K, bm, bn, dt, seed=9)
        n = nbr * bm
        ph.log(f"{name} Block-ELL: n={n}, K={K}, {bm}x{bn} blocks, data "
               f"{data.nbytes / 1e9:.3f} GB")
        bell = BellMatrix(jnp.asarray(data), jnp.asarray(cols), (n, n),
                          nnz=data.size)
        op = BellOperator(bell)
        x = np.random.default_rng(10).standard_normal(n).astype(dt)
        xd = jnp.asarray(x)
        y = ph.timed(f"matvec {name}", lambda: _MATVEC(op, xd))
        ph.check(f"{name} matvec vs host f64 blocks (relative)",
                 _rel(np.asarray(y), host_bell_matvec(data, cols, x)), lim, name,
                 "HIGHEST-precision contraction over K*bn terms")
        z = ph.timed(f"rmatvec {name}", lambda: _RMATVEC(op, xd))
        ph.check(f"{name} rmatvec vs host f64 blocks (relative)",
                 _rel(np.asarray(z), host_bell_rmatvec(data, cols, x)), lim,
                 name, "HIGHEST-precision contraction; scatter-add order varies")
        xs, info, meta = ph.timed(
            f"gmres(30) x {cycles} cycles {name}",
            lambda: lk.gmres(op, xd, rtol=rtol, atol=0.0,
                             options=lk.GMRESOptions(kdim=30, maxiter=cycles)))
        ph.require(f"gmres {name} converged within {cycles} cycles",
                   meta.converged, f"info={info}")
        relres = _rel(host_bell_matvec(data, cols, np.asarray(xs)), x)
        ph.check(f"{name} gmres true relative residual (host f64)", relres,
                 10 * rtol, name, "GMRES stops on its least-squares residual; "
                 "the true one may exceed it by rounding")
        if dt == np.float32:
            from lightkrylov_tpu.linops import IdentityOperator
            from lightkrylov_tpu.solvers.gmres import _gmres_impl

            ph.memory(f"gmres core {name}", _gmres_impl, op, xd, xd,
                      IdentityOperator(), jnp.asarray(0.0, dt), 30, cycles,
                      False, False, True, "dcgs2")
        del bell, op, xd, y, z, xs
    ph.peak_memory()


def _gbs(nbytes: float, fn, *args, reps: int = 20) -> float:
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return nbytes / ((time.perf_counter() - t0) / reps) / 1e9


def phase_kernels(ph: Phase, n: int = 8192, nbr: int = 32768) -> None:
    """Bandwidth of the operator products that remain (XLA; no hand-written
    kernel stays) against a copy anchor ``y = x + 1`` over the same bytes,
    and each checked once against its independent reference."""
    copy = jax.jit(lambda a: a + 1)
    for dt in (jnp.float32, jnp.float64):
        name = np.dtype(dt).name
        op = Poisson2D(n, dtype=dt)
        u = jax.random.normal(jax.random.PRNGKey(11), (n, n), dt)
        nbytes = 2 * u.size * u.dtype.itemsize
        g_copy = _gbs(nbytes, copy, u)
        g_st = _gbs(nbytes, _MATVEC, op, u)
        ph.log(f"stencil {name} {n}^2: {g_st:.1f} GB/s (read u + write y) vs "
               f"copy anchor {g_copy:.1f} GB/s = {g_st / g_copy:.3f}")
        ph.check(f"stencil {name} {n}^2 vs host f64 stencil (relative)",
                 _rel(np.asarray(_MATVEC(op, u)), host_poisson(np.asarray(u))),
                 1e-6 if dt == jnp.float32 else 1e-14, name,
                 "five-term sum, no cancellation on random data")
        del u
    data, cols = make_bell(nbr, 4, 8, 128, np.float32, seed=12)
    bell = BellMatrix(jnp.asarray(data), jnp.asarray(cols),
                      (nbr * 8, nbr * 8), nnz=data.size)
    op = BellOperator(bell)
    x = jnp.asarray(np.random.default_rng(13).standard_normal(nbr * 8)
                    .astype(np.float32))
    g_copy = _gbs(2 * data.nbytes, copy, bell.data)
    g_b = _gbs(data.nbytes, _MATVEC, op, x)
    ph.log(f"Block-ELL float32 ({data.nbytes / 1e9:.3f} GB of data): "
           f"{g_b:.1f} GB/s of data vs copy anchor {g_copy:.1f} GB/s = "
           f"{g_b / g_copy:.3f}")
    ph.check("Block-ELL float32 vs host f64 blocks (relative)",
             _rel(np.asarray(_MATVEC(op, x)),
                  host_bell_matvec(data, cols, np.asarray(x))),
             1e-5, "float32", "HIGHEST-precision contraction")


PHASES = {
    "pcg_poisson": phase_pcg_poisson,
    "gmres_poisson_large": phase_gmres_poisson_large,
    "eighs_poisson_large": phase_eighs_poisson_large,
    "gl_eigs_complex": phase_gl_eigs_complex,
    "gl_eigs_projected": phase_gl_eigs_projected,
    "roessler": phase_roessler,
    "svds_kexpm": phase_svds_kexpm,
    "bell_spmv": phase_bell_spmv,
    "kernels": phase_kernels,
}


# -- four cards ----------------------------------------------------------------

def four_sharded(ph: Phase, n: int = 8192, nbr: int = 32768, gl_nx: int = 512,
                 n_dev: int = 4) -> None:
    """The sharded path on n_dev devices, each solve compared with the same
    solve on one device (f64, so the comparison limits can be tight)."""
    from jax.sharding import PartitionSpec as P

    from lightkrylov_tpu.parallel import (ShardedBellOperator,
                                          ShardedGinzburgLandau,
                                          ShardedPoisson2D, distribute,
                                          make_mesh)

    mesh = make_mesh(n_dev)
    ax = mesh.axis_names[0]
    dev0 = jax.devices()[0]
    f64 = jnp.float64
    b_host = np.random.default_rng(14).standard_normal((n, n))
    b_one = jax.device_put(b_host, dev0)
    b_sh = distribute(jnp.asarray(b_host), mesh, P(ax, None))
    ph.require("state spread over the mesh",
               len(b_sh.sharding.device_set) == n_dev,
               f"{len(b_sh.sharding.device_set)} devices hold the state")
    one, sh = Poisson2D(n, dtype=f64), ShardedPoisson2D(n, n, mesh=mesh, dtype=f64)

    def compare(what, r_one, r_sh, lim, why):
        ph.check(what, _rel(r_sh, r_one), lim, "float64", why)

    why = "same algorithm; the mesh changes only the summation order"
    x1, _, m1 = ph.timed("cg 200 iterations, one device", lambda: lk.cg(
        one, b_one, rtol=0.0, atol=0.0, options=lk.CGOptions(maxiter=200)))
    x4, _, m4 = ph.timed(f"cg 200 iterations, {n_dev} devices", lambda: lk.cg(
        sh, b_sh, rtol=0.0, atol=0.0, options=lk.CGOptions(maxiter=200)))
    ph.require("cg iterate sharded", len(x4.sharding.device_set) == n_dev)
    compare("cg residual history", m1.residuals, m4.residuals, 1e-8, why)
    compare("cg iterate", np.asarray(x1), np.asarray(x4), 1e-8, why)
    del x1, x4
    g = lk.GMRESOptions(kdim=30, maxiter=2)
    x1, _, m1 = ph.timed("gmres(30) x 2 cycles, one device", lambda: lk.gmres(
        one, b_one, rtol=0.0, atol=0.0, options=g))
    x4, _, m4 = ph.timed(f"gmres(30) x 2 cycles, {n_dev} devices",
                         lambda: lk.gmres(sh, b_sh, rtol=0.0, atol=0.0, options=g))
    ph.require("gmres iterate sharded", len(x4.sharding.device_set) == n_dev)
    compare("gmres residual history", m1.residuals, m4.residuals, 1e-8, why)
    compare("gmres iterate", np.asarray(x1), np.asarray(x4), 1e-8, why)
    del x1, x4
    e = lk.EigsOptions(maxiter=1)
    w1, _, r1, _, _ = ph.timed("eighs one 32-step sweep, one device",
                               lambda: lk.eighs(one, 4, x0=b_one, kdim=32,
                                                tolerance=0.0, options=e))
    w4, _, r4, _, _ = ph.timed(f"eighs one 32-step sweep, {n_dev} devices",
                               lambda: lk.eighs(sh, 4, x0=b_sh, kdim=32,
                                                tolerance=0.0, options=e))
    compare("eighs Ritz values", w1, w4, 1e-10, why)
    compare("eighs Ritz residuals", r1, r4, 1e-6, why)
    del b_one, b_sh

    data, cols = make_bell(nbr, 4, 8, 128, np.float64, seed=15)
    nn = nbr * 8
    bell = BellMatrix(jnp.asarray(data), jnp.asarray(cols), (nn, nn), data.size)
    op1 = BellOperator(bell)
    op4 = ShardedBellOperator(bell, mesh=mesh)
    x_host = np.random.default_rng(16).standard_normal(nn)
    xs = distribute(jnp.asarray(x_host), mesh, P(ax))
    x1 = jax.device_put(x_host, dev0)
    y4 = ph.timed(f"Block-ELL matvec, {n_dev} devices", lambda: _MATVEC(op4, xs))
    ph.require("Block-ELL product sharded", len(y4.sharding.device_set) == n_dev)
    compare("Block-ELL matvec", np.asarray(op1.matvec(x1)), np.asarray(y4),
            1e-14, "same products, gathered x")
    z4 = _RMATVEC(op4, xs)
    compare("Block-ELL rmatvec", np.asarray(op1.rmatvec(x1)), np.asarray(z4),
            1e-13, "scatter-add and psum order")
    go = lk.GMRESOptions(kdim=30, maxiter=3)
    s1, _, m1 = ph.timed("Block-ELL gmres, one device", lambda: lk.gmres(
        op1, x1, rtol=1e-12, atol=0.0, options=go))
    s4, _, m4 = ph.timed(f"Block-ELL gmres, {n_dev} devices", lambda: lk.gmres(
        op4, xs, rtol=1e-12, atol=0.0, options=go))
    ph.require("Block-ELL gmres converged", m1.converged and m4.converged)
    compare("Block-ELL gmres iterate", np.asarray(s1), np.asarray(s4), 1e-10, why)
    del bell, op1, op4

    gl1 = GLPropagator(GinzburgLandau(gl_nx, dtype=jnp.complex128), tau=0.01,
                       n_steps=10)
    gl4 = GLPropagator(ShardedGinzburgLandau(gl_nx, mesh=mesh,
                                             dtype=jnp.complex128),
                       tau=0.01, n_steps=10)
    rng = np.random.default_rng(17)
    v0 = rng.standard_normal(gl_nx) + 1j * rng.standard_normal(gl_nx)
    eo = lk.EigsOptions(maxiter=4000)
    nev = 4
    # one call per side (latency-bound; the one-card phases time it warm)
    t0 = time.perf_counter()
    w1, _, r1, i1, _ = lk.eigs(gl1, nev, x0=jax.device_put(v0, dev0), kdim=16,
                               tolerance=1e-10, options=eo)
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    w4, _, r4, i4, _ = lk.eigs(gl4, nev, x0=distribute(jnp.asarray(v0), mesh,
                                                         P(ax)),
                               kdim=16, tolerance=1e-10, options=eo)
    t4 = time.perf_counter() - t0
    ph.log(f"GL eigs c128 nev={nev}: one device {t1:.2f} s, {n_dev} devices "
           f"{t4:.2f} s (single calls, compile included)")
    ph.require("GL eigs converged on both", i1 > 0 and i4 > 0, f"{i1}, {i4}")
    kappa = (np.load(os.path.join(ROOT, "gl_direct_spectrum.npy"))[:nev, 3]
             if gl_nx == 512 else np.full(nev, 1e6))
    dev = np.abs(np.asarray(w1) - np.asarray(w4)) / (
        2.0 * kappa * (np.asarray(r1) + np.asarray(r4)) + 1e-12)
    ph.check("GL eigenvalues one vs four devices / kappa budget",
             float(dev.max()), 1.0, "complex128",
             "both converged to a 1e-10 Ritz residual; a non-normal "
             "eigenvalue moves by up to kappa * residual")


# -- driver --------------------------------------------------------------------

def _smi() -> list[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi unavailable: {e!r}"]
    return [l for l in out.splitlines() if l.strip()]


def run_phases(phases: dict, stop_on_error: bool = False) -> list[str]:
    """Run each phase; returns the names of the failed ones."""
    failed = []
    for name, fn in phases.items():
        ph = Phase(name)
        t0 = time.perf_counter()
        try:
            fn(ph)
        except Exception as e:  # noqa: BLE001 - a phase failure is reported
            ph.failures.append(f"{type(e).__name__}: {e}")
            ph.log(f"ERROR {type(e).__name__}: {str(e)[:2000]}")
            if stop_on_error:
                raise
        ph.log(f"phase {'ok' if not ph.failures else 'FAILED'} in "
               f"{time.perf_counter() - t0:.1f} s")
        if ph.failures:
            failed.append(name)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's first device is "
              f"{devs[0].platform} ({devs[0].device_kind})", file=sys.stderr)
        return 2
    n_dev = 4 if args.four else 1
    if len(devs) < n_dev:
        print(f"chip_smoke: --four needs 4 GPUs, found {len(devs)}",
              file=sys.stderr)
        return 2

    from lightkrylov_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    for line in _smi():
        print(line)
    print(f"jax {jax.__version__} devices: {devs}")
    print(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compile cache: {cache}")
    sys.stdout.flush()

    t0 = time.perf_counter()
    if args.four:
        failed = run_phases({"four_sharded": four_sharded})
    else:
        failed = run_phases(PHASES)
    print(f"total {time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"FAILED phases: {', '.join(failed)}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": n_dev}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
