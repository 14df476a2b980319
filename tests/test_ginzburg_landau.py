"""Ginzburg-Landau eigenanalysis via time-stepper matvec — BASELINE
config 3 (reference: example/ginzburg_landau — eigs of the exponential
propagator exp(tau A) with Arnoldi + Krylov-Schur, the reference's flagship
example, SURVEY.md §3.1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lightkrylov_tpu as lk
from lightkrylov_tpu import vectors
from lightkrylov_tpu.models import (
    GinzburgLandau,
    GLPropagator,
    gl_analytic_eigvals,
)

NX = 128


def test_gl_operator_adjoint_consistency():
    """<A u, v> == <u, A^H v> for the discretized operator
    (reference: adjoint_rhs, Ginzburg_Landau.f90:171-181)."""
    gl = GinzburgLandau(nx=NX)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(NX) + 1j * rng.standard_normal(NX))
    v = jnp.asarray(rng.standard_normal(NX) + 1j * rng.standard_normal(NX))
    lhs = complex(vectors.dot(gl.matvec(u), v))
    rhs = complex(vectors.dot(u, gl.rmatvec(v)))
    assert abs(lhs - rhs) < 1e-10 * abs(lhs)


def test_gl_dense_matches_matvec():
    gl = GinzburgLandau(nx=NX)
    rng = np.random.default_rng(1)
    u = rng.standard_normal(NX) + 1j * rng.standard_normal(NX)
    assert np.allclose(np.asarray(gl.matvec(jnp.asarray(u))), gl.dense() @ u,
                       rtol=1e-12)


def test_gl_eigs_via_time_stepper():
    """Leading eigenvalues of A recovered through eigs on exp(tau A), the
    time-stepper matvec, validated against dense eig of the same FD operator
    (reference: example/ginzburg_landau/main.f90:68; config tau/nev/kdim
    scaled for the CPU suite)."""
    gl = GinzburgLandau(nx=NX)
    tau = 1.0
    prop = GLPropagator(gl, tau=tau, n_steps=400)
    nev, kdim = 4, 16
    rng = np.random.default_rng(2)
    x0 = jnp.asarray(rng.standard_normal(NX) + 1j * rng.standard_normal(NX))
    evals, evecs, res, info, meta = lk.eigs(
        prop, nev, x0=x0, kdim=kdim, tolerance=1e-8,
        options=lk.EigsOptions(maxiter=30))
    assert meta.converged, f"residuals {np.asarray(res)}"

    # Rayleigh quotients of the Ritz vectors against the generator A
    # (avoids the log-branch ambiguity of mapping exp-eigenvalues back).
    dense_ev = np.linalg.eigvals(gl.dense())
    dense_ev = dense_ev[np.argsort(-dense_ev.real)]
    for i in range(nev):
        v = vectors.get_column(evecs, i)
        lam = complex(vectors.dot(v, gl.matvec(v)) / vectors.dot(v, v))
        assert np.min(np.abs(dense_ev[:10] - lam)) < 1e-6, (i, lam)


def test_gl_analytic_branch_spectrum():
    """The discrete leading eigenvalues approach the continuous branch
    formula as nx grows (loose oracle)."""
    gl = GinzburgLandau(nx=512)
    dense_ev = np.linalg.eigvals(gl.dense())
    dense_ev = dense_ev[np.argsort(-dense_ev.real)]
    analytic = gl_analytic_eigvals(3)
    for n in range(3):
        assert abs(dense_ev[n] - analytic[n]) < 2e-2  # second-order FD error at dx ~ 0.39, (n, dense_ev[n], analytic[n])


def test_realified_gl_matches_complex_spectrum():
    """GinzburgLandauReal (f32/f64 real (2, nx) state) is the exact
    realification of the complex operator: R(A) spectrum = spec(A) U
    conj(spec(A)).  It lets the real-only device projected eigensolve
    serve the complex problem."""
    from lightkrylov_tpu.models import (GinzburgLandau, GinzburgLandauReal,
                                        GLPropagator)

    nx = 48
    glr = GinzburgLandauReal(nx=nx, dtype=jnp.float64)
    # realified matvec == realified dense oracle
    rng = np.random.default_rng(0)
    u = rng.standard_normal((2, nx))
    y = np.asarray(glr.matvec(jnp.asarray(u)))
    yref = (glr.dense() @ u.reshape(-1)).reshape(2, nx)
    assert np.abs(y - yref).max() < 1e-12

    # eigs on the realified propagator recovers the complex spectrum
    wc = np.linalg.eigvals(GinzburgLandau(nx, dtype=jnp.complex128).dense())
    wc = wc[np.argsort(-wc.real)][:4]
    prop = GLPropagator(glr, tau=0.01, n_steps=10)
    x0 = jnp.asarray(rng.standard_normal((2, nx)))
    evals, evecs, res, info, meta = lk.eigs(
        prop, 8, x0=x0, kdim=24, tolerance=1e-8,
        options=lk.EigsOptions(maxiter=100))
    lam = np.log(np.asarray(evals).astype(complex)) / 0.01
    for w in wc:
        d = min(np.abs(lam - w).min(), np.abs(lam - np.conj(w)).min())
        assert d < 1e-6, f"eigenvalue {w} missing from realified Ritz set"
