"""Child process for the true multi-process test (tests/test_multiprocess.py).

Runs as ``python _mp_child.py <process_id> <num_processes> <port>`` with a
clean environment: 2 virtual CPU devices per process, x64 on, and the CPU
backend forced (no child may open an accelerator).

Exercises the full distributed stack across real process boundaries — the
path no single-process test executes (`comm_setup` wraps
``jax.distributed.initialize``, reference Logger.f90:245-276):

1. ``comm_setup`` + rank/io-rank capture (reference Constants.f90:60-100).
2. Sharded stencil matvec (cross-process ``ppermute`` halo) vs dense oracle.
3. CGS2 batched projection (cross-process fused all-reduce over gloo).
4. A full GMRES solve on the 2-process mesh, residual checked on a gathered
   replica.

Prints ``ALL-OK`` on success; any assertion failure exits nonzero.
"""

import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=2")
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

import lightkrylov_tpu as lk
from lightkrylov_tpu import constants
from lightkrylov_tpu.krylov.gram_schmidt import double_gram_schmidt_step
from lightkrylov_tpu.parallel import comm_setup, make_mesh, shard_rows
from lightkrylov_tpu.parallel.stencil import ShardedPoisson2D

comm_setup(f"localhost:{port}", num_processes=nproc, process_id=pid)
assert constants.get_rank() == pid and constants.get_comm_size() == nproc
assert constants.io_rank() == (pid == 0)
mesh = make_mesh()
assert mesh.devices.size == 2 * nproc, mesh


def gather(x):
    """Replicate a global array and read it from a local shard."""
    rep = jax.jit(lambda a: a, out_shardings=NamedSharding(mesh, P()))(x)
    return np.asarray(jax.device_get(rep.addressable_shards[0].data))


nx = 64
sh = shard_rows(mesh)
rng = np.random.default_rng(42)
b_host = rng.standard_normal((nx, nx))
b = jax.make_array_from_callback((nx, nx), sh, lambda idx: b_host[idx])

# 1. sharded matvec (cross-process ppermute halo) vs dense oracle
op = ShardedPoisson2D(nx, mesh=mesh, dtype=jnp.float64)
ihx2, ihy2 = 1.0 / op.hx**2, 1.0 / op.hy**2
up = np.pad(b_host, 1)
y_ref = ((2 * (ihx2 + ihy2)) * b_host
         - ihx2 * (up[1:-1, :-2] + up[1:-1, 2:])
         - ihy2 * (up[:-2, 1:-1] + up[2:, 1:-1]))
err = np.abs(gather(op.matvec(b)) - y_ref).max() / np.abs(y_ref).max()
assert err < 1e-12, f"matvec parity: {err}"
print(pid, "matvec parity ok", err, flush=True)

# 2. CGS2 batched projection: the fused all-reduce crosses processes
k = 4
q, _ = np.linalg.qr(rng.standard_normal((nx * nx, k)))
X_host = np.ascontiguousarray(q.T.reshape(k, nx, nx))
X = jax.make_array_from_callback(
    (k, nx, nx), NamedSharding(mesh, P(None, "i")), lambda idx: X_host[idx])
_, beta = jax.jit(double_gram_schmidt_step)(b, X)
beta_ref = X_host.reshape(k, -1) @ b_host.reshape(-1)
err = np.abs(gather(beta) - beta_ref).max()
assert err < 1e-10 * max(1.0, np.abs(beta_ref).max()), f"CGS2: {err}"
print(pid, "CGS2 parity ok", flush=True)

# 3. end-to-end GMRES on the 2-process mesh
x, info, meta = lk.gmres(op, b, rtol=1e-8,
                         options=lk.GMRESOptions(kdim=30, maxiter=20))
relres = np.linalg.norm(gather(op.matvec(x)) - b_host) / np.linalg.norm(b_host)
assert relres < 1e-7, f"gmres relres: {relres}"
assert int(info) > 0, f"gmres info: {info}"
print(pid, "gmres ok relres", relres, "info", int(info), flush=True)

print(pid, "ALL-OK", flush=True)
