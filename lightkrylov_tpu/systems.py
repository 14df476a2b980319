"""Nonlinear systems F(X) and their Jacobian operators.

Counterpart of ``src/AbstractTypes/AbstractSystems.fypp``.
The reference defines an abstract system with deferred
``response(vec_in, vec_out, atol)`` (AbstractSystems.fypp:64-86) — note the
*tolerance* argument so time-stepper responses can integrate adaptively —
and an ``abstract_jacobian_linop`` which is a linear operator carrying the
linearization state ``X`` (AbstractSystems.fypp:48-54).

Here a system wraps a response callable; the Jacobian defaults to the exact
autodiff linearization ``jax.jvp`` (forward) / transpose (adjoint), which the
Fortran reference cannot provide — users may still override with an
analytical or time-stepper Jacobian.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .linops import LinearOperator, aslinop

__all__ = ["System", "JacobianOperator"]


class JacobianOperator(LinearOperator):
    """Exact Jacobian ``dF/dX`` at state ``X`` as a linear operator.

    (reference: ``abstract_jacobian_linop``, AbstractSystems.fypp:48-54 —
    there the user hand-codes the tangent map; here it is derived with
    ``jax.jvp`` and its transpose unless overridden.)
    """

    _children = ("X", "params")
    _static = ("_response",)

    def __init__(self, response, X, params=None):
        self._response = response
        self.X = X
        self.params = params

    def _f(self, x):
        if self.params is not None:
            return self._response(self.params, x)
        return self._response(x)

    def matvec(self, dx):
        _, jvp = jax.jvp(self._f, (self.X,), (dx,))
        return jvp

    def rmatvec(self, dy):
        _, vjp = jax.vjp(self._f, self.X)
        # jax.vjp yields the conjugate-transpose action for C->C maps when
        # fed a conjugated cotangent: A^H y = conj(vjp(conj(y))).
        dyc = jax.tree.map(jnp.conj, dy)
        (xt,) = vjp(dyc)
        return jax.tree.map(jnp.conj, xt)

    def with_state(self, X):
        """Re-linearize about a new state (reference: ``jacobian%X = X``,
        NewtonKrylov.fypp:346)."""
        return JacobianOperator(self._response, X, self.params)


class System:
    """Nonlinear system ``F(X)`` (reference: ``abstract_system``,
    AbstractSystems.fypp:19-40).

    Parameters
    ----------
    response:
        Either ``response(x)`` or ``response(x, atol)`` — the extra
        tolerance argument mirrors the reference's adaptive time-stepper
        hook (AbstractSystems.fypp:64-86).
    jacobian:
        Optional callable ``jacobian(x) -> LinearOperator``. Defaults to the
        autodiff :class:`JacobianOperator`.
    """

    def __init__(self, response, jacobian=None, takes_atol: bool = False):
        self._response = response
        self._jacobian = jacobian
        self._takes_atol = takes_atol

    def eval(self, x, atol: float = 0.0):
        """Evaluate F(X) (reference: counting wrapper ``eval``,
        AbstractSystems.fypp:163-180)."""
        if self._takes_atol:
            return self._response(x, atol)
        return self._response(x)

    def jacobian(self, x, atol: float = 0.0) -> LinearOperator:
        """The Jacobian linear operator at ``x``."""
        if self._jacobian is not None:
            return aslinop(self._jacobian(x))
        if self._takes_atol:
            return JacobianOperator(lambda xx: self._response(xx, atol), x)
        return JacobianOperator(self._response, x)
