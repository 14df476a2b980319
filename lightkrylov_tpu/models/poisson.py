"""2D Poisson (5-point Laplacian) operators and preconditioners.

The reference exercises CG on a 2D Poisson operator with a block-Jacobi
(tridiagonal-solve) preconditioner (reference: test/TestSpecialMatrices.f90:
29-159, 16x8 grid) and BASELINE.json config 1 prescribes CG on the 128x128
unit-square 5-point Laplacian to 1e-10.

The state vector is the 2D interior grid array ``(ny, nx)`` — the natural
layout for the stencil and for row-partitioned sharding over a device mesh
(halo exchange along the leading axis).  ``matvec`` here is the pad/slice
formulation, which XLA fuses into one pass that reads ``u`` once and writes
the result once; :mod:`lightkrylov_tpu.parallel.stencil` has the
multi-device halo-exchange version with identical semantics.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..linops import LinearOperator

__all__ = ["Poisson2D", "poisson2d_eigvals", "BlockJacobiPoisson"]


class Poisson2D(LinearOperator):
    """Negative 5-point Laplacian ``-Delta`` with homogeneous Dirichlet BCs
    on the unit square; SPD.  Interior grid ``(ny, nx)``, spacing
    ``hx = 1/(nx+1)``, ``hy = 1/(ny+1)``."""

    _children = ()
    _static = ("nx", "ny", "dtype_")

    is_hermitian = True

    def __init__(self, nx: int, ny: int | None = None, dtype=jnp.float64):
        self.nx = nx
        self.ny = ny if ny is not None else nx
        self.dtype_ = np.dtype(dtype)

    @property
    def hx(self):
        return 1.0 / (self.nx + 1)

    @property
    def hy(self):
        return 1.0 / (self.ny + 1)

    def matvec(self, u):
        ihx2 = 1.0 / self.hx**2
        ihy2 = 1.0 / self.hy**2
        # shifted neighbours with zero (Dirichlet) padding
        un = jnp.pad(u, ((0, 0), (1, 1)))  # pad x
        left, right = un[:, :-2], un[:, 2:]
        um = jnp.pad(u, ((1, 1), (0, 0)))  # pad y
        down, up = um[:-2, :], um[2:, :]
        return (2.0 * (ihx2 + ihy2)) * u - ihx2 * (left + right) - ihy2 * (down + up)

    def rmatvec(self, u):
        return self.matvec(u)

    def template(self):
        return jnp.zeros((self.ny, self.nx), self.dtype_)

    def dense(self):
        """Dense oracle (small grids only)."""
        nx, ny = self.nx, self.ny
        n = nx * ny
        A = np.zeros((n, n))
        ihx2, ihy2 = 1.0 / self.hx**2, 1.0 / self.hy**2

        def idx(j, i):
            return j * nx + i

        for j in range(ny):
            for i in range(nx):
                k = idx(j, i)
                A[k, k] = 2.0 * (ihx2 + ihy2)
                if i > 0:
                    A[k, idx(j, i - 1)] = -ihx2
                if i < nx - 1:
                    A[k, idx(j, i + 1)] = -ihx2
                if j > 0:
                    A[k, idx(j - 1, i)] = -ihy2
                if j < ny - 1:
                    A[k, idx(j + 1, i)] = -ihy2
        return A


def poisson2d_eigvals(nx: int, ny: int | None = None):
    """Closed-form spectrum of the 5-point ``-Delta``:
    ``lambda_{ij} = (2 - 2 cos(i pi hx))/hx^2 + (2 - 2 cos(j pi hy))/hy^2``."""
    ny = ny if ny is not None else nx
    hx, hy = 1.0 / (nx + 1), 1.0 / (ny + 1)
    i = np.arange(1, nx + 1)
    j = np.arange(1, ny + 1)
    lx = (2.0 - 2.0 * np.cos(i * np.pi * hx)) / hx**2
    ly = (2.0 - 2.0 * np.cos(j * np.pi * hy)) / hy**2
    return np.sort((lx[None, :] + ly[:, None]).ravel())


class BlockJacobiPoisson(LinearOperator):
    """Block-Jacobi preconditioner: exact solve of the 1D tridiagonal
    x-line blocks ``(2/hx^2 + 2/hy^2) I + tridiag(-1/hx^2)``
    (reference: the tridiagonal block-Jacobi preconditioner of the Poisson
    PCG test, test/TestSpecialMatrices.f90:29-159).

    The block inverse is precomputed once (nx x nx) and applied to all ny
    rows as one batched matmul instead of ny sequential Thomas solves."""

    _children = ("Binv",)
    _static = ()

    is_hermitian = True

    def __init__(self, op: Poisson2D):
        nx = op.nx
        ihx2 = 1.0 / op.hx**2
        ihy2 = 1.0 / op.hy**2
        B = np.zeros((nx, nx))
        np.fill_diagonal(B, 2.0 * (ihx2 + ihy2))
        i = np.arange(nx - 1)
        B[i + 1, i] = -ihx2
        B[i, i + 1] = -ihx2
        self.Binv = jnp.asarray(np.linalg.inv(B), op.dtype_)

    def matvec(self, r):
        # HIGHEST: a TF32-rounded preconditioner would stop being symmetric
        # to f32 accuracy, which PCG relies on
        return jnp.matmul(r, self.Binv.T, precision=jax.lax.Precision.HIGHEST)

    def rmatvec(self, r):
        return self.matvec(r)
