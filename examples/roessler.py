#!/usr/bin/env python
"""Roessler system: chaotic attractor, Newton-Krylov UPO search, OTD modes.

Counterpart of the reference example
(reference: example/roessler/main.f90 + roessler_OTD.f90):
1. integrate the chaotic attractor,
2. converge the period-1 unstable periodic orbit by Newton-GMRES shooting
   from the reference initial guess (0, 6.1, 1.3), T0 = 6 (main.f90:87-88),
3. validate the OTD instantaneous eigenvalues at the fixed point
   (0.097000856 x2, roessler_OTD.f90:31) and the orbit's Lyapunov
   exponents (0.0, 0.149141556, roessler_OTD.f90:32).

Run: PYTHONPATH=. python examples/roessler.py [--cpu]
"""

import argparse
import sys

import numpy as np


def main():
    ap = argparse.ArgumentParser()
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
    from lightkrylov_tpu.models import (
        floquet_exponents,
        flow,
        otd_evolve,
        roessler_fixed_points,
        roessler_rhs,
        upo_system,
    )

    lk.logger_setup()
    lk.greetings()

    # 1. chaotic attractor (main.f90:66-71)
    p = jnp.asarray(np.array([0.0, -5.0, 0.05]))
    p_end = flow(p, 300.0, 60000)
    print(f"attractor: start {np.asarray(p)}, end {np.asarray(p_end)}")

    # 2. Newton-Krylov UPO (main.f90:87-108)
    sysm = upo_system(n_steps=3000)
    X0 = {"pos": jnp.asarray(np.array([0.0, 6.1, 1.3])), "T": jnp.asarray(6.0)}
    X, info, meta = lk.newton(
        sysm, X0, rtol=0.0, atol=1e-11,
        linear_solver_options=lk.GMRESOptions(kdim=4, maxiter=10))
    T = float(X["T"])
    print(f"UPO: pos = {np.asarray(X['pos'])}, T = {T:.9f} "
          f"(converged={meta.converged}, {meta.n_iter} Newton steps)")

    # 3. validation anchors
    fp_minus, _ = roessler_fixed_points()
    U0 = jnp.asarray(np.linalg.qr(
        np.random.default_rng(0).standard_normal((3, 2)))[0])
    _, _, Lr, _ = otd_evolve(roessler_rhs, jnp.asarray(fp_minus), U0, 50.0, 20000)
    w = np.linalg.eigvals(np.asarray(Lr))
    print(f"OTD instantaneous eigs at fixed point: {np.sort(w.real)} "
          "(ref 0.097000856 x2)")

    mu, LE = floquet_exponents(X["pos"], X["T"], 4000)
    print(f"Floquet multipliers: {mu}")
    print(f"Lyapunov exponents:  {LE[:2]} (ref 0.149141556, 0.0)")


if __name__ == "__main__":
    sys.exit(main())
