"""Linearized complex Ginzburg-Landau operator and its time-stepper
exponential propagator.

Reproduces the reference's flagship eigenanalysis example
(reference: example/ginzburg_landau/Ginzburg_Landau.f90): the linearized
CGL equation ``du/dt = -nu u_x + gamma u_xx + mu(x) u`` on a 1D grid with
homogeneous Dirichlet BCs, parameters ``nu = 2 + 0.2i``,
``gamma = 1 - 1i``, ``mu(x) = (mu_0 - c_mu^2) + (mu_2/2) x^2`` with
``mu_0 = 0.38``, ``c_mu = 0.2``, ``mu_2 = -0.01``, domain ``L = 200``,
``nx = 512`` (Ginzburg_Landau.f90:24-33,96-97); eigs setup ``tau = 0.01``,
``nev = 8``, ``kdim = 16`` (main.f90:20-27,68).

Interior-point centered finite differences (Ginzburg_Landau.f90:127-137;
we use the standard ``1/dx^2`` second-difference at both boundary-adjacent
points).  The continuous operator has the closed-form spectrum
``lambda_n = (mu_0 - c_mu^2) - nu^2/(4 gamma) - (n + 1/2) sqrt(-2 mu_2 gamma)``
(Cossu & Chomaz branch formula), used as a loose analytic oracle.

The *time-stepper matvec* — the reference's dominant cost (SURVEY.md §3.1) —
is a jitted RK4 ``lax.scan`` over the linear RHS: an exponential-propagator
operator ``exp(tau A)`` whose eigenvalues map as ``exp(tau lambda)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..linops import LinearOperator

__all__ = ["GinzburgLandau", "GinzburgLandauReal", "GLPropagator",
           "gl_analytic_eigvals", "NU", "GAMMA", "MU0", "C_MU", "MU2"]

NU = 2.0 + 0.2j
GAMMA = 1.0 - 1.0j
MU0 = 0.38
C_MU = 0.2
MU2 = -0.01


class GinzburgLandau(LinearOperator):
    """Linearized CGL operator on ``nx`` interior points of ``[-L/2, L/2]``
    (complex state vector of shape ``(nx,)``)."""

    _children = ("mu",)
    _static = ("nx", "L", "dtype_")

    def __init__(self, nx: int = 512, L: float = 200.0, dtype=jnp.complex128):
        self.nx = nx
        self.L = float(L)
        self.dtype_ = np.dtype(dtype)
        x = np.linspace(-L / 2, L / 2, nx + 2)[1:-1]  # interior nodes
        mu = (MU0 - C_MU**2) + (MU2 / 2.0) * x**2  # (Ginzburg_Landau.f90:96-97)
        self.mu = jnp.asarray(mu, np.dtype(dtype))

    @property
    def dx(self):
        return self.L / (self.nx + 1)

    def template(self):
        return jnp.zeros((self.nx,), self.dtype_)

    def _shifts(self, u):
        um = jnp.concatenate([jnp.zeros_like(u[:1]), u[:-1]])  # u_{i-1}
        up = jnp.concatenate([u[1:], jnp.zeros_like(u[:1])])   # u_{i+1}
        return um, up

    def matvec(self, u):
        """(Ginzburg_Landau.f90:127-137 ``rhs``)."""
        dt = self.dtype_
        um, up = self._shifts(u)
        ux = (up - um) / (2.0 * self.dx)
        uxx = (up - 2.0 * u + um) / self.dx**2
        return (-jnp.asarray(NU, dt)) * ux + jnp.asarray(GAMMA, dt) * uxx + self.mu * u

    def rmatvec(self, u):
        """Adjoint: conjugate coefficients, flipped convection sign
        (Ginzburg_Landau.f90:171-181 ``adjoint_rhs``)."""
        dt = self.dtype_
        um, up = self._shifts(u)
        ux = (up - um) / (2.0 * self.dx)
        uxx = (up - 2.0 * u + um) / self.dx**2
        return jnp.conj(jnp.asarray(NU, dt)) * ux + jnp.conj(jnp.asarray(GAMMA, dt)) * uxx + self.mu * u

    def dense(self):
        n = self.nx
        dx = self.dx
        A = np.zeros((n, n), complex)
        mu = np.asarray(self.mu)
        for i in range(n):
            A[i, i] = -2.0 * GAMMA / dx**2 + mu[i]
            if i > 0:
                A[i, i - 1] = NU / (2 * dx) + GAMMA / dx**2
            if i < n - 1:
                A[i, i + 1] = -NU / (2 * dx) + GAMMA / dx**2
        return A


class GinzburgLandauReal(LinearOperator):
    """REALIFIED linearized CGL operator: the complex state ``u = a + ib``
    is carried as a real ``(2, nx)`` array ``[a; b]`` and the complex
    coefficients are expanded into real arithmetic, so the entire Krylov
    solve runs in a real dtype with no complex array anywhere.

    Realification lets the real-only device projected eigensolve
    (``projected="device"``) serve the complex problem, and costs nothing
    in arithmetic: a complex multiply IS four real multiplies, and XLA
    fuses the expanded form identically.  The realified operator ``R(A) = [[Ar, -Ai], [Ai, Ar]]`` has spectrum
    ``{lambda} ∪ {conj(lambda)}`` — each complex eigenvalue of ``A``
    appears with its conjugate, so ``nev`` complex pairs are requested as
    ``2 nev`` real-operator Ritz values.

    Same grid/parameters as :class:`GinzburgLandau`
    (reference: example/ginzburg_landau/Ginzburg_Landau.f90:24-33,96-97,
    rhs :127-137).  ``rmatvec`` is the autodiff transpose, which for the
    real form equals the realified complex adjoint ``R(A^H)``.
    """

    _children = ("mu",)
    _static = ("nx", "L", "dtype_")

    def __init__(self, nx: int = 512, L: float = 200.0, dtype=jnp.float32):
        self.nx = nx
        self.L = float(L)
        self.dtype_ = np.dtype(dtype)
        x = np.linspace(-L / 2, L / 2, nx + 2)[1:-1]
        mu = (MU0 - C_MU**2) + (MU2 / 2.0) * x**2
        self.mu = jnp.asarray(mu, self.dtype_)

    @property
    def dx(self):
        return self.L / (self.nx + 1)

    def template(self):
        return jnp.zeros((2, self.nx), self.dtype_)

    def matvec(self, u):
        """Realified rhs: rows ``u[0] = Re``, ``u[1] = Im``."""
        a, b = u[0], u[1]
        dx = self.dx
        nur, nui = float(NU.real), float(NU.imag)
        gr, gi = float(GAMMA.real), float(GAMMA.imag)

        def shifts(f):
            fm = jnp.concatenate([jnp.zeros_like(f[:1]), f[:-1]])
            fp = jnp.concatenate([f[1:], jnp.zeros_like(f[:1])])
            return fm, fp

        am, ap = shifts(a)
        bm, bp = shifts(b)
        ax = (ap - am) / (2.0 * dx)
        bx = (bp - bm) / (2.0 * dx)
        axx = (ap - 2.0 * a + am) / dx**2
        bxx = (bp - 2.0 * b + bm) / dx**2
        # -nu*u_x + gamma*u_xx + mu*u, expanded over (re, im)
        re = -(nur * ax - nui * bx) + (gr * axx - gi * bxx) + self.mu * a
        im = -(nui * ax + nur * bx) + (gi * axx + gr * bxx) + self.mu * b
        return jnp.stack([re, im])

    def dense(self):
        """Real 2nx x 2nx dense form (for small-nx oracles)."""
        Ac = GinzburgLandau(self.nx, self.L, dtype=np.complex128).dense()
        n = self.nx
        R = np.zeros((2 * n, 2 * n))
        R[:n, :n] = Ac.real
        R[:n, n:] = -Ac.imag
        R[n:, :n] = Ac.imag
        R[n:, n:] = Ac.real
        return R


def gl_analytic_eigvals(n_modes: int = 8):
    """Continuous-operator branch spectrum (loose oracle; the discrete
    operator converges to it as nx grows)."""
    h = np.sqrt(-2.0 * MU2 * GAMMA)
    n = np.arange(n_modes)
    return (MU0 - C_MU**2) - NU**2 / (4.0 * GAMMA) - (n + 0.5) * h


class GLPropagator(LinearOperator):
    """Exponential propagator ``exp(tau A)`` via jitted RK4 time integration
    — the reference's time-stepper matvec
    (Ginzburg_Landau.f90:259-293 ``direct_solver``/``adjoint_solver``,
    SURVEY.md §3.1 hot path)."""

    _children = ("A",)
    _static = ("tau", "n_steps")

    def __init__(self, A: GinzburgLandau, tau: float = 0.01, n_steps: int = 10):
        self.A = A
        self.tau = float(tau)
        self.n_steps = n_steps

    def _integrate(self, u, rhs):
        dt = self.tau / self.n_steps

        def step(u, _):
            k1 = rhs(u)
            k2 = rhs(u + 0.5 * dt * k1)
            k3 = rhs(u + 0.5 * dt * k2)
            k4 = rhs(u + dt * k3)
            return u + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4), None

        u, _ = jax.lax.scan(step, u, None, length=self.n_steps)
        return u

    def matvec(self, x):
        return self._integrate(x, self.A.matvec)

    def rmatvec(self, y):
        return self._integrate(y, self.A.rmatvec)
