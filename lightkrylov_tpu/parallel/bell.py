"""Row-partitioned Block-ELL SpMV over a 1D device mesh.

The general-sparse half of SURVEY.md §2 parallelism item 2 ("row/block-
partitioned CSR/BSR SpMV ... with halo exchange"): block-rows of the
Block-ELL matrix (see :mod:`lightkrylov_tpu.ops.bell`) are partitioned over
the mesh; the input vector is row-partitioned the same way and
all-gathered inside ``shard_map`` (a general sparse matrix has unbounded
column reach, so the "halo" is the full vector — for bounded-bandwidth
operators use the stencil operators, whose halo is one row), and each
device runs the Block-ELL product on its local block rows.  The output rows come out naturally partitioned, so Krylov solvers
compose without any resharding.

The reference delegates all of this to user MPI code
(paper/paper.md:97-101); this layer is the framework-owned replacement.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..linops import LinearOperator
from ..ops.bell import BellMatrix, bell_rspmv, bell_spmv
from .mesh import distribute

__all__ = ["ShardedBellOperator"]


def _bell_shard(data, cols, x_local, *, axis, n_logical):
    """Per-shard body: all-gather x, run the local Block-ELL product on
    this shard's block-rows (column indices stay GLOBAL — the gathered x
    covers the full column space)."""
    x_full = jax.lax.all_gather(x_local, axis, tiled=True)
    bn = data.shape[3]
    n_p = -(-n_logical // bn) * bn
    if n_p != x_full.shape[0]:
        x_full = jnp.pad(x_full, (0, n_p - x_full.shape[0]))
    return bell_spmv(data, cols, x_full)


class ShardedBellOperator(LinearOperator):
    """Square Block-ELL operator with block-rows partitioned over a 1D mesh.

    Built from a host-side :class:`BellMatrix` whose global shape is
    square and whose row count divides evenly over the mesh (pad the
    block-row count to a multiple of the mesh size at assembly time).
    The state vector is the global ``(n,)`` array row-partitioned over the
    mesh; ``matvec`` is one ``all_gather`` + the local Block-ELL product.
    """

    _children = ("data", "cols")
    _static = ("shape", "nnz", "is_hermitian", "mesh", "axis")

    def __init__(self, bell: BellMatrix, *, mesh: Mesh,
                 is_hermitian: bool = False):
        m, n = bell.shape
        nbr, K, bm, bn = bell.data.shape
        nd = mesh.devices.size
        if m != n:
            raise ValueError(f"ShardedBellOperator requires a square operator, got {bell.shape}")
        if nbr % nd:
            raise ValueError(
                f"block-row count {nbr} must divide over {nd} devices; "
                "pad at assembly")
        if m != nbr * bm or n % bn or n % nd:
            raise ValueError(
                "ShardedBellOperator requires the logical shape to equal the "
                "block grid (pad the matrix to multiples of the block size "
                "at assembly time)")
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.shape = bell.shape
        self.nnz = bell.nnz
        self.is_hermitian = is_hermitian
        self.data = distribute(bell.data, mesh, P(self.axis, None, None, None))
        self.cols = distribute(bell.cols, mesh, P(self.axis, None))

    def template(self):
        x = jnp.zeros((self.shape[1],), self.data.dtype)
        return distribute(x, self.mesh, P(self.axis))

    def matvec(self, x):
        body = partial(_bell_shard, axis=self.axis, n_logical=self.shape[1])
        mv = jax.shard_map(
            body,
            mesh=self.mesh,
            in_specs=(P(self.axis, None, None, None), P(self.axis, None),
                      P(self.axis)),
            out_specs=P(self.axis),
        )
        y = mv(self.data, self.cols, x)
        return y[: self.shape[0]] if y.shape[0] != self.shape[0] else y

    def rmatvec(self, y):
        if self.is_hermitian:
            return self.matvec(y)
        # A^H y: each shard owns block-ROWS of A, i.e. block-columns of A^H;
        # local transpose contributions are scattered into the full output
        # and summed over shards with one psum, then re-partitioned.
        bn = self.data.shape[3]
        n_p = -(-self.shape[1] // bn) * bn

        def body(data, cols, y_local):
            out = jax.lax.psum(bell_rspmv(data, cols, y_local, n_p),
                               self.axis)
            # keep my row slice of the summed result (output partitioned)
            nd = jax.lax.axis_size(self.axis)
            idx = jax.lax.axis_index(self.axis)
            chunk = n_p // nd
            return jax.lax.dynamic_slice(out, (idx * chunk,), (chunk,))

        mv = jax.shard_map(
            body,
            mesh=self.mesh,
            in_specs=(P(self.axis, None, None, None), P(self.axis, None),
                      P(self.axis)),
            out_specs=P(self.axis),
        )
        x = mv(self.data, self.cols, y)
        return x[: self.shape[1]] if x.shape[0] != self.shape[1] else x
