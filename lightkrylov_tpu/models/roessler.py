"""Roessler system: fixed points, periodic orbits, Newton-Krylov fixtures.

Reproduces the reference's nonlinear fixtures
(reference: example/roessler/roessler.f90 and
src/Utilities/TestUtils.fypp:110-165,674-690): the Roessler ODE with
``a = b = 0.2``, ``c = 5.7`` (roessler.f90:22-25), its closed-form fixed
points ``x = (c -+ sqrt(c^2 - 4ab))/2, y = -x/a, z = x/a`` (:674-690 of
TestUtils), and the unstable-periodic-orbit (UPO) shooting system whose
state is ``(x, y, z, T)``: residual ``F(X) = flow_T(X) - X`` with zero
period-residual row (roessler.f90:240-280 ``nonlinear_map``), and whose
Jacobian action is ``[exp(TJ) - I] dx + f(X(T)) dT`` with the phase
condition ``<dx, f(X(0))>`` in the period row (roessler.f90:282-330
``linear_map``).

Design: the flow map is a jitted fixed-step RK4 ``lax.scan`` with
``dt = T/n_steps`` — *differentiable in both the state and the period* — so
the tangent propagation ``exp(TJ) dx + f(X(T)) dT`` is one exact ``jax.jvp``
through the integrator rather than the reference's hand-coded coupled
(nonlinear + tangent) ODE (roessler.f90:combined_rhs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..linops import LinearOperator
from ..systems import System

__all__ = [
    "roessler_rhs",
    "roessler_fixed_points",
    "flow",
    "fixed_point_system",
    "upo_system",
    "UPOJacobian",
    "monodromy",
    "floquet_exponents",
    "A_PARAM",
    "B_PARAM",
    "C_PARAM",
]

A_PARAM = 0.2
B_PARAM = 0.2
C_PARAM = 5.7


def roessler_rhs(p):
    """Roessler vector field on ``p = (x, y, z)``
    (reference: roessler.f90 ``nonlinear_roessler``)."""
    x, y, z = p[0], p[1], p[2]
    return jnp.stack([-y - z, x + A_PARAM * y, B_PARAM + z * (x - C_PARAM)])


def roessler_fixed_points():
    """Closed-form fixed points (reference: TestUtils.fypp:674-690
    ``roessler_analytical_fp``)."""
    d = np.sqrt(C_PARAM**2 - 4 * A_PARAM * B_PARAM)
    fps = []
    for s in (-1.0, +1.0):
        x = (C_PARAM + s * d) / 2.0
        fps.append(np.array([x, -x / A_PARAM, x / A_PARAM]))
    return fps[0], fps[1]  # (minus branch, plus branch)


def flow(p0, T, n_steps: int = 1000):
    """RK4 flow map over period ``T`` with ``dt = T/n_steps`` —
    differentiable in ``(p0, T)``."""
    dt = T / n_steps

    def step(p, _):
        k1 = roessler_rhs(p)
        k2 = roessler_rhs(p + 0.5 * dt * k1)
        k3 = roessler_rhs(p + 0.5 * dt * k2)
        k4 = roessler_rhs(p + dt * k3)
        return p + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4), None

    p, _ = jax.lax.scan(step, p0, None, length=n_steps)
    return p


def fixed_point_system() -> System:
    """``F(X) = f(X) = 0`` fixture for Newton fixed-point tests
    (reference: TestUtils.fypp:110-165 ``roessler`` system + analytical
    Jacobian — here the Jacobian is exact autodiff)."""
    return System(roessler_rhs)


class UPOJacobian(LinearOperator):
    """Jacobian of the UPO shooting residual at ``(pos, T)``:
    position rows ``[d flow/d(pos,T)](dx, dT) - dx``, period row
    ``<dx, f(X(0))>`` (phase condition)
    (reference: roessler.f90:282-330 ``linear_map``)."""

    _children = ("state",)
    _static = ("n_steps",)

    def __init__(self, state, n_steps: int = 1000):
        self.state = state
        self.n_steps = n_steps

    def matvec(self, v):
        pos, T = self.state["pos"], self.state["T"]
        dx, dT = v["pos"], v["T"]

        def phi(p, t):
            return flow(p, t, self.n_steps)

        _, dflow = jax.jvp(phi, (pos, T), (dx, dT))
        # [exp(TJ) - I] dx + f(X(T)) dT   (dflow already includes both terms)
        dpos = dflow - dx
        # phase condition <dx, f(X(0))>
        dT_out = jnp.vdot(roessler_rhs(pos), dx).real.astype(dT.dtype)
        return {"pos": dpos, "T": dT_out}

    def rmatvec(self, v):
        # The reference uses a dummy adjoint (roessler.f90: "we do not need
        # the adjoint of the jacobian"); we provide the exact transpose via
        # autodiff for completeness.
        pos, T = self.state["pos"], self.state["T"]
        dy, dT_in = v["pos"], v["T"]

        def phi(p, t):
            return flow(p, t, self.n_steps)

        _, vjp = jax.vjp(phi, pos, T)
        gpos, gT = vjp(dy)
        dpos = gpos - dy + dT_in * roessler_rhs(pos)
        return {"pos": dpos, "T": gT.astype(v["T"].dtype)}


def monodromy(pos, T, n_steps: int = 4000):
    """Monodromy matrix ``M = d flow_T / d x`` at a point of a periodic
    orbit (reference: ``monodromy_map``/``floquet_operator``,
    example/roessler/roessler.f90) — exact autodiff of the RK4 flow."""
    return jax.jacobian(lambda p: flow(p, T, n_steps))(pos)


def floquet_exponents(pos, T, n_steps: int = 4000):
    """Floquet multipliers and Lyapunov exponents ``ln|mu| / T`` of the
    orbit through ``pos`` (validation anchors: LE = (0.149141556, 0.0) on
    the period-1 UPO, reference: roessler_OTD.f90:32)."""
    import numpy as np

    M = np.asarray(monodromy(pos, T, n_steps))
    mu = np.linalg.eigvals(M)
    mu = mu[np.argsort(-np.abs(mu))]
    return mu, np.log(np.abs(mu)) / float(T)


def upo_system(n_steps: int = 1000) -> System:
    """Shooting system for unstable periodic orbits: state
    ``{"pos": (3,), "T": ()}``; residual ``[flow_T(pos) - pos, 0]``
    (reference: roessler.f90:240-280 ``nonlinear_map``)."""

    def response(state):
        pos, T = state["pos"], state["T"]
        out = flow(pos, T, n_steps) - pos
        return {"pos": out, "T": jnp.zeros((), T.dtype)}

    def jacobian(state):
        return UPOJacobian(state, n_steps)

    return System(response, jacobian=jacobian)
