"""Optimally time-dependent (OTD) modes along a trajectory.

Counterpart of the reference's Roessler OTD example
(reference: example/roessler/roessler_OTD.f90): co-evolve an orthonormal
basis ``U`` of r perturbation directions with the nonlinear trajectory,

    dx/dt = f(x)
    dU/dt = J(x) U - U (U^T J(x) U) + U A,   A antisymmetric gauge (0 here)

so ``U`` tracks the most unstable subspace; the reduced operator
``Lr = U^T J U`` carries the instantaneous stability eigenvalues, and the
time averages of ``diag(Lr)`` along an orbit are the Lyapunov exponents.
Validation anchors (BASELINE.md): instantaneous eigenvalue real part
0.097000856 (x2) at the Roessler fixed point; Lyapunov exponents
(0.0, 0.149141556) on the period-1 UPO
(reference: roessler_OTD.f90:31-32).

Generic implementation: the Jacobian action is exact ``jax.jvp``
of any user ``rhs`` (the reference hand-codes it), the whole propagation is
one ``lax.scan`` of fused RK4 steps over the combined (x, U) state, and the
basis is kept orthonormal by a QR-free Gram-Schmidt projection built into
the dynamics plus a cheap re-orthonormalization every step.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["otd_rhs", "otd_evolve", "lyapunov_exponents"]


def _jac_apply(rhs, x, U):
    """J(x) @ U column-wise via jvp (exact, no hand-coded Jacobian)."""
    return jax.vmap(lambda u: jax.jvp(rhs, (x,), (u,))[1], in_axes=1,
                    out_axes=1)(U)


def otd_rhs(rhs, x, U):
    """Right-hand side of the coupled (x, U) OTD system (gauge A = 0).

    The tiny reduced-operator contractions run at HIGHEST precision: a
    default-precision f32 matmul may round to TF32 on a GPU, and that
    per-step error compounds over the 10^4-step integrations."""
    P = jax.lax.Precision.HIGHEST
    fx = rhs(x)
    JU = _jac_apply(rhs, x, U)
    Lr = jnp.matmul(U.T, JU, precision=P)
    dU = JU - jnp.matmul(U, Lr, precision=P)
    return fx, dU, Lr


def _reorthonormalize(U):
    """Explicit modified Gram-Schmidt over the r (static, tiny) columns.

    vdot/axpy are elementwise ops at full f32 — unlike
    ``jnp.linalg.qr``, whose internal matmuls run at the default matmul
    precision (TF32 on a GPU) and drift over long integrations.  Classical direction-keeping
    also preserves basis continuity without a sign fix."""
    r = U.shape[1]
    cols = []
    for j in range(r):
        v = U[:, j]
        for q in cols:
            v = v - q * jnp.vdot(q, v)
        nv = jnp.linalg.norm(v)
        cols.append(v / jnp.where(nv == 0, 1.0, nv))
    return jnp.stack(cols, axis=1)


@partial(jax.jit, static_argnames=("rhs", "n_steps"))
def otd_evolve(rhs, x0, U0, T, n_steps: int = 2000):
    """Integrate the coupled system over ``[0, T]`` with RK4.

    Returns ``(x_T, U_T, Lr_T, lyap)`` where ``lyap`` are the
    time-averaged ``diag(Lr)`` — the finite-time Lyapunov exponents.
    """
    dt = T / n_steps

    def f(state):
        x, U = state
        fx, dU, _ = otd_rhs(rhs, x, U)
        return fx, dU

    def step(carry, _):
        x, U, acc = carry
        k1 = f((x, U))
        k2 = f((x + 0.5 * dt * k1[0], U + 0.5 * dt * k1[1]))
        k3 = f((x + 0.5 * dt * k2[0], U + 0.5 * dt * k2[1]))
        k4 = f((x + dt * k3[0], U + dt * k3[1]))
        x = x + (dt / 6.0) * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
        U = U + (dt / 6.0) * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
        U = _reorthonormalize(U)
        # accumulate instantaneous growth rates diag(U^T J U)
        _, _, Lr = otd_rhs(rhs, x, U)
        acc = acc + jnp.real(jnp.diagonal(Lr)) * dt
        return (x, U, acc), None

    acc0 = jnp.zeros(U0.shape[1], jnp.result_type(x0.dtype, jnp.float32))
    (x, U, acc), _ = jax.lax.scan(step, (x0, U0, acc0), None, length=n_steps)
    _, _, Lr = otd_rhs(rhs, x, U)
    return x, U, Lr, acc / T


def lyapunov_exponents(rhs, x0, U0, T, n_steps: int = 2000, n_transient: int = 0,
                       T_transient: float = 0.0):
    """Leading Lyapunov exponents via OTD averaging, after an optional
    transient to let the basis align
    (reference: roessler_OTD.f90 Lyapunov-exponent run)."""
    x, U = x0, U0
    if n_transient:
        x, U, _, _ = otd_evolve(rhs, x, U, T_transient, n_transient)
    _, _, _, lyap = otd_evolve(rhs, x, U, T, n_steps)
    return lyap
