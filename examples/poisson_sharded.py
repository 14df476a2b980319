#!/usr/bin/env python
"""Partitioned-Poisson eigenanalysis — BASELINE config 5.

Row-shards the 2D Poisson operator over all visible devices (halo exchange
between neighbouring devices via ppermute), runs thick-restart Lanczos (``eighs``) for the
leading eigenvalues, and validates against the closed-form spectrum.
At full scale (--n 3162) this is the 10M-DoF configuration.

Run:  PYTHONPATH=. python examples/poisson_sharded.py --n 1024
      XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
          PYTHONPATH=. python examples/poisson_sharded.py --cpu --n 256
"""

import argparse
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--nev", type=int, default=4)
    ap.add_argument("--kdim", type=int, default=48)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from lightkrylov_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import lightkrylov_tpu as lk
    from lightkrylov_tpu.models import poisson2d_eigvals
    from lightkrylov_tpu.parallel import (
        P,
        ShardedPoisson2D,
        distribute,
        make_mesh,
    )

    lk.logger_setup()
    mesh = make_mesh()
    n = args.n - args.n % mesh.devices.size  # divisible rows
    dtype = jnp.float64
    op = ShardedPoisson2D(n, n, mesh=mesh, dtype=dtype)
    print(f"devices={mesh.devices.size}  grid={n}x{n}  dof={n * n / 1e6:.2f}M  "
          f"dtype={np.dtype(dtype).name}")

    rng = np.random.default_rng(0)
    x0 = distribute(
        jnp.asarray(rng.standard_normal((n, n)).astype(dtype)),
        mesh, P(mesh.axis_names[0], None))

    # Ritz residuals are absolute; scale the tolerance by the spectral
    # magnitude lambda_max ~ 4/hx^2 + 4/hy^2 (the reference's O(1)-normed
    # fixtures hide this; a 1/h^2-scaled Laplacian does not).
    lam_max = 4.0 * (n + 1) ** 2 + 4.0 * (n + 1) ** 2
    tol = (1e-6 if dtype == jnp.float32 else 1e-9) * lam_max
    t0 = time.perf_counter()
    evals, evecs, res, info, meta = lk.eighs(
        op, args.nev, x0=x0, kdim=args.kdim, tolerance=tol,
        options=lk.EigsOptions(maxiter=40))
    dt = time.perf_counter() - t0

    exact = np.sort(poisson2d_eigvals(n, n))[::-1]
    print(f"eighs: converged={meta.converged}  {meta.n_iter} Lanczos steps  "
          f"wall={dt:.1f}s")
    for i, (lam, r) in enumerate(zip(np.asarray(evals), np.asarray(res))):
        rel = abs(lam - exact[i]) / exact[i]
        print(f"  lambda_{i} = {lam:.10e}   exact-rel-err={rel:.2e}   ritz-res={r:.1e}")


if __name__ == "__main__":
    sys.exit(main())
