"""Row-partitioned 2D stencil operators with halo exchange.

This is the multi-chip operator tier of SURVEY.md §2 item 2 (and BASELINE
config 5: 10M-DoF partitioned Poisson eigs): the interior grid is sharded
along its leading (row) axis over a 1D device mesh; the 5-point matvec runs
under ``shard_map`` with a one-row halo exchange between neighbouring shards
expressed as two ``ppermute`` collectives between neighbouring devices.

Overlap: the kernel computes the x-direction (halo-free) part of the
stencil while the halo rows are in flight, then adds the y-direction
neighbour contributions — XLA schedules the ppermutes concurrently with the
interior compute.  Non-cyclic ``ppermute`` delivers zeros at the slice
boundaries, which is exactly the homogeneous Dirichlet condition.

The reference has no counterpart: it delegates distribution entirely to the
user's MPI code (paper/paper.md:97-101; the MPI Poisson example lives in a
separate repo, README.md:61).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..linops import LinearOperator
from .mesh import distribute

__all__ = ["ShardedPoisson2D", "ShardedGinzburgLandau"]


def _halo_exchange(u, axis):
    """One-row halo exchange over the 1D mesh: returns the row above my
    block (from the previous shard) and the row below (from the next).
    Non-cyclic ``ppermute`` delivers zeros at the slice boundaries — exactly
    the homogeneous Dirichlet condition."""
    n = jax.lax.axis_size(axis)
    down_perm = [(i, i + 1) for i in range(n - 1)]   # send towards larger idx
    up_perm = [(i + 1, i) for i in range(n - 1)]     # send towards smaller idx
    halo_from_above = jax.lax.ppermute(u[-1:, :], axis, down_perm)
    halo_from_below = jax.lax.ppermute(u[:1, :], axis, up_perm)
    return halo_from_above, halo_from_below


def _stencil_shard(u, *, ihx2, ihy2, axis):
    """Per-shard 5-point matvec body with halo exchange (runs inside
    shard_map; ``u`` is the local (ny_local, nx) row block)."""
    halo_from_above, halo_from_below = _halo_exchange(u, axis)

    # Interior (x-direction + diagonal) part — no halo dependency; XLA
    # overlaps this with the ppermutes above.
    un = jnp.pad(u, ((0, 0), (1, 1)))
    left, right = un[:, :-2], un[:, 2:]
    out = (2.0 * (ihx2 + ihy2)) * u - ihx2 * (left + right)

    # y-direction neighbours: shift within the block, splice halo rows.
    um = jnp.pad(u, ((1, 1), (0, 0)))
    down_nb = um[:-2, :].at[0:1, :].set(halo_from_above)   # u_{j-1}
    up_nb = um[2:, :].at[-1:, :].set(halo_from_below)      # u_{j+1}
    out = out - ihy2 * (down_nb + up_nb)
    return out


class ShardedPoisson2D(LinearOperator):
    """Negative 5-point Laplacian, row-partitioned over a 1D mesh.

    Semantically identical to :class:`lightkrylov_tpu.models.Poisson2D`
    (same grid, spacing, SPD); the state vector is the globally-shaped
    ``(ny, nx)`` array carrying a ``NamedSharding`` that partitions rows
    over the mesh.  ``ny`` must be divisible by the mesh size.
    """

    _children = ()
    _static = ("nx", "ny", "dtype_", "mesh", "axis")

    is_hermitian = True

    def __init__(self, nx: int, ny: int | None = None, *, mesh: Mesh,
                 dtype=jnp.float32):
        self.nx = nx
        self.ny = ny if ny is not None else nx
        self.dtype_ = np.dtype(dtype)
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        if self.ny % mesh.devices.size != 0:
            raise ValueError(
                f"ny={self.ny} must be divisible by mesh size {mesh.devices.size}")

    @property
    def hx(self):
        return 1.0 / (self.nx + 1)

    @property
    def hy(self):
        return 1.0 / (self.ny + 1)

    def template(self):
        """A distributed zero state vector."""
        u = jnp.zeros((self.ny, self.nx), self.dtype_)
        return distribute(u, self.mesh, P(self.axis, None))

    def matvec(self, u):
        body = partial(
            _stencil_shard,
            ihx2=1.0 / self.hx**2,
            ihy2=1.0 / self.hy**2,
            axis=self.axis,
        )
        mv = jax.shard_map(
            body,
            mesh=self.mesh,
            in_specs=P(self.axis, None),
            out_specs=P(self.axis, None),
        )
        return mv(u)

    def rmatvec(self, u):
        return self.matvec(u)


def _gl_shard(u, mu_local, *, dx, nu, gamma, adjoint, axis):
    """Per-shard linearized CGL RHS with single-point halo exchange
    (runs inside shard_map; ``u`` is the local 1D chunk)."""
    n = jax.lax.axis_size(axis)
    fwd = [(i, i + 1) for i in range(n - 1)]
    bwd = [(i + 1, i) for i in range(n - 1)]
    left_halo = jax.lax.ppermute(u[-1:], axis, fwd)   # u_{i-1} for local 0
    right_halo = jax.lax.ppermute(u[:1], axis, bwd)   # u_{i+1} for local -1

    um = jnp.concatenate([left_halo, u[:-1]])
    up = jnp.concatenate([u[1:], right_halo])
    ux = (up - um) / (2.0 * dx)
    uxx = (up - 2.0 * u + um) / dx**2
    nu_ = jnp.conj(nu) if adjoint else -nu
    gamma_ = jnp.conj(gamma) if adjoint else gamma
    return nu_ * ux + gamma_ * uxx + mu_local * u


class ShardedGinzburgLandau(LinearOperator):
    """Linearized complex Ginzburg-Landau operator, 1D-partitioned over the
    mesh with single-point ppermute halo exchange — the multi-host variant
    of :class:`lightkrylov_tpu.models.GinzburgLandau` (same physics/FD:
    Ginzburg_Landau.f90:24-33,127-181)."""

    _children = ("mu",)
    _static = ("nx", "L", "dtype_", "mesh", "axis")

    def __init__(self, nx: int, L: float = 200.0, *, mesh: Mesh,
                 dtype=jnp.complex64):
        from ..models.ginzburg_landau import C_MU, MU0, MU2

        self.nx = nx
        self.L = float(L)
        self.dtype_ = np.dtype(dtype)
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        if nx % mesh.devices.size != 0:
            raise ValueError(
                f"nx={nx} must be divisible by mesh size {mesh.devices.size}")
        x = np.linspace(-L / 2, L / 2, nx + 2)[1:-1]
        mu = (MU0 - C_MU**2) + (MU2 / 2.0) * x**2
        self.mu = distribute(jnp.asarray(mu, self.dtype_), mesh, P(self.axis))

    @property
    def dx(self):
        return self.L / (self.nx + 1)

    def template(self):
        u = jnp.zeros((self.nx,), self.dtype_)
        return distribute(u, self.mesh, P(self.axis))

    def _apply(self, u, adjoint):
        from ..models.ginzburg_landau import GAMMA, NU

        body = partial(
            _gl_shard, dx=self.dx,
            nu=jnp.asarray(NU, self.dtype_),
            gamma=jnp.asarray(GAMMA, self.dtype_),
            adjoint=adjoint, axis=self.axis,
        )
        mv = jax.shard_map(
            body,
            mesh=self.mesh,
            in_specs=(P(self.axis), P(self.axis)),
            out_specs=P(self.axis),
        )
        return mv(u, self.mu)

    def matvec(self, u):
        return self._apply(u, False)

    def rmatvec(self, u):
        return self._apply(u, True)
