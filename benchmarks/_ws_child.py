"""Child process for the TRUE multi-process weak-scaling measurement
(benchmarks/weak_scaling_mp.py).

Runs as ``python _ws_child.py <pid> <nproc> <port> <rows_per_proc> <nx>
<solver>`` with one virtual CPU device per process, joined over gloo
collectives via ``comm_setup``.  Fixed work per process: the global grid is
``(rows_per_proc * nproc, nx)`` row-partitioned over the process mesh.

Process 0 prints one line ``WS-RESULT {json}`` with the best-of-3 wall time
of the fixed-work solve (everything is collectively synchronized, so one
process's timing is the job's).
"""

import json
import os
import sys
import time

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
rows, nx, solver = int(sys.argv[4]), int(sys.argv[5]), sys.argv[6]

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import lightkrylov_tpu as lk
from lightkrylov_tpu.parallel import comm_setup, make_mesh, shard_rows
from lightkrylov_tpu.parallel.stencil import ShardedPoisson2D

if nproc > 1:
    comm_setup(f"localhost:{port}", num_processes=nproc, process_id=pid)
mesh = make_mesh()
assert mesh.devices.size == nproc, mesh

ny = rows * nproc
sh = shard_rows(mesh)
rng = np.random.default_rng(0)


def local_rows(idx):
    # generate only this process's rows (avoid building the global array
    # on every host at large sizes)
    r0 = idx[0].start or 0
    r1 = idx[0].stop if idx[0].stop is not None else ny
    block_rng = np.random.default_rng(1000 + r0)
    return block_rng.standard_normal((r1 - r0, nx)).astype(np.float32)


b = jax.make_array_from_callback((ny, nx), sh, local_rows)
op = ShardedPoisson2D(nx, ny, mesh=mesh, dtype=jnp.float32)


def run():
    if solver == "gmres":
        # fixed work: exactly one GMRES(30) cycle, no early exit
        return lk.gmres(op, b, rtol=0.0, atol=0.0,
                        options=lk.GMRESOptions(kdim=30, maxiter=1))
    # eighs: one fixed 32-step Lanczos sweep + projected solve
    return lk.eighs(op, 4, x0=b, kdim=32, tolerance=0.0,
                    options=lk.EigsOptions(maxiter=1))


repeats = int(os.environ.get("WS_REPEATS", "5"))
out = run()  # compile + warm
jax.block_until_ready(jax.tree_util.tree_leaves(out[0]))
times = []
for _ in range(repeats):
    t0 = time.perf_counter()
    out = run()
    jax.block_until_ready(jax.tree_util.tree_leaves(out[0]))
    times.append(time.perf_counter() - t0)

if pid == 0:
    srt = sorted(times)
    print("WS-RESULT " + json.dumps(
        {"nproc": nproc, "rows_per_proc": rows, "nx": nx, "solver": solver,
         "dof": ny * nx, "time_s": round(min(times), 4),
         "median_s": round(srt[len(srt) // 2], 4),
         "times": [round(t, 4) for t in times]}), flush=True)
