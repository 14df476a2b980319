#!/usr/bin/env python
"""Weak-scaling harness: GMRES / eighs on the row-partitioned Poisson
operator at fixed DoF per device (BASELINE: >= 75% weak-scaling efficiency
for GMRES/eigs on a 10M-DoF partitioned Poisson at >= 2 hosts).

Runs on whatever devices are visible (several GPUs, or a virtual CPU mesh
via XLA_FLAGS=--xla_force_host_platform_device_count=N for plumbing checks).
Prints per-device-count timings and parallel efficiency.
"""

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows-per-device", type=int, default=1024)
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--solver", choices=["gmres", "cg", "eighs"], default="gmres")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import lightkrylov_tpu as lk
    from lightkrylov_tpu.parallel import ShardedPoisson2D, distribute, make_mesh, P

    n_all = jax.device_count()
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_all]
    base_time = None
    for nd in sizes:
        mesh = make_mesh(nd)
        ny = args.rows_per_device * nd
        op = ShardedPoisson2D(args.nx, ny, mesh=mesh, dtype=jnp.float32)
        rng = np.random.default_rng(0)
        b = distribute(
            jnp.asarray(rng.standard_normal((ny, args.nx)).astype(np.float32)),
            mesh, P(mesh.axis_names[0], None))

        def run():
            if args.solver == "gmres":
                return lk.gmres(op, b, options=lk.GMRESOptions(kdim=30, maxiter=1),
                                rtol=0.0, atol=0.0)  # fixed work: one full cycle
            if args.solver == "cg":
                return lk.cg(op, b, rtol=0.0, atol=0.0,
                             options=lk.CGOptions(maxiter=50))
            x0 = b
            return lk.eighs(op, 4, x0=x0, kdim=32, tolerance=0.0,
                            options=lk.EigsOptions(maxiter=1))

        run()  # compile
        t0 = time.perf_counter()
        out = run()
        jax.block_until_ready(jax.tree_util.tree_leaves(out[0]))
        dt = time.perf_counter() - t0
        if base_time is None:
            base_time = dt
        eff = base_time / dt
        print(f"devices={nd:3d}  dof={ny * args.nx / 1e6:8.2f}M  "
              f"time={dt:.3f}s  weak-eff={eff:5.1%}")


if __name__ == "__main__":
    main()
