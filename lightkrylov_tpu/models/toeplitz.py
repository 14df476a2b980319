"""Tridiagonal Toeplitz test operators with closed-form spectra.

These reproduce the reference test fixtures: eigs is validated on a
tridiagonal Toeplitz matrix with closed-form complex eigenvalues
(reference: test/TestIterativeSolvers.fypp:135-225) and eighs on an SPD
Toeplitz with ``lambda_i = a + 2|b| cos(i pi / (n+1))``
(reference: test/TestIterativeSolvers.fypp:228-310).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..linops import LinearOperator

__all__ = ["TridiagToeplitz", "toeplitz_eigvals"]


class TridiagToeplitz(LinearOperator):
    """Tridiagonal Toeplitz operator: ``a`` on the diagonal, ``b`` on the
    subdiagonal, ``c`` on the superdiagonal, applied matrix-free with
    shifts (elementwise; no materialized matrix)."""

    _children = ("a", "b", "c")
    _static = ("n", "is_hermitian")

    def __init__(self, n: int, a, b, c=None, dtype=jnp.float64):
        if c is None:
            c = b
        self.n = n
        self.a = jnp.asarray(a, dtype)
        self.b = jnp.asarray(b, dtype)
        self.c = jnp.asarray(c, dtype)
        self.is_hermitian = bool(np.isreal(a) and np.conj(b) == c)

    def matvec(self, x):
        lower = jnp.concatenate([jnp.zeros_like(x[:1]), x[:-1]])  # x_{i-1}
        upper = jnp.concatenate([x[1:], jnp.zeros_like(x[:1])])   # x_{i+1}
        return self.a * x + self.b * lower + self.c * upper

    def rmatvec(self, y):
        lower = jnp.concatenate([jnp.zeros_like(y[:1]), y[:-1]])
        upper = jnp.concatenate([y[1:], jnp.zeros_like(y[:1])])
        return jnp.conj(self.a) * y + jnp.conj(self.c) * lower + jnp.conj(self.b) * upper

    def dense(self):
        n = self.n
        A = np.zeros((n, n), dtype=np.asarray(self.a).dtype)
        np.fill_diagonal(A, np.asarray(self.a))
        idx = np.arange(n - 1)
        A[idx + 1, idx] = np.asarray(self.b)
        A[idx, idx + 1] = np.asarray(self.c)
        return A


def toeplitz_eigvals(n: int, a, b, c=None):
    """Closed-form spectrum ``lambda_k = a + 2 sqrt(b c) cos(k pi/(n+1))``
    (complex for b*c < 0; reference: TestIterativeSolvers.fypp:135-310)."""
    if c is None:
        c = b
    k = np.arange(1, n + 1)
    return a + 2.0 * np.sqrt(complex(b * c)) * np.cos(k * np.pi / (n + 1))
