#!/usr/bin/env python
"""Linearized Ginzburg-Landau: leading eigenpairs of the exponential
propagator via time-stepper Arnoldi + Krylov-Schur.

Counterpart of the reference's flagship example
(reference: example/ginzburg_landau/main.f90): nx = 512, L = 200,
tau time horizon, direct and adjoint spectra, spectrum saved as ``.npy``
(``save_eigenspectrum``).

Run: PYTHONPATH=. python examples/ginzburg_landau.py [--nx 512] [--tau 1.0]
"""

import argparse
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=512)
    ap.add_argument("--tau", type=float, default=1.0)
    ap.add_argument("--nev", type=int, default=8)
    ap.add_argument("--kdim", type=int, default=32)
    ap.add_argument("--n-steps", type=int, default=2000)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import lightkrylov_tpu as lk
    from lightkrylov_tpu.models import GinzburgLandau, GLPropagator
    from lightkrylov_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    lk.logger_setup()
    lk.greetings()
    lk.set_timing(True)

    gl = GinzburgLandau(nx=args.nx)
    prop = GLPropagator(gl, tau=args.tau, n_steps=args.n_steps)
    rng = np.random.default_rng(0)
    x0 = jnp.asarray(rng.standard_normal(args.nx)
                     + 1j * rng.standard_normal(args.nx))

    with lk.timed("gl_direct_eigs"):
        evals, evecs, res, info, meta = lk.eigs(
            prop, args.nev, x0=x0, kdim=args.kdim, tolerance=1e-8,
            options=lk.EigsOptions(maxiter=30))
    # map exp-eigenvalues back to generator eigenvalues via Rayleigh quotients
    lam_A = []
    for i in range(len(np.asarray(evals))):
        v = lk.get_column(evecs, i)
        lam_A.append(complex(lk.dot(v, gl.matvec(v)) / lk.dot(v, v)))
    print(f"\ndirect spectrum (converged={meta.converged}, n_matvec~{meta.n_iter}):")
    for lam, r in zip(lam_A, np.asarray(res)):
        print(f"  lambda = {lam.real:+.8f} {lam.imag:+.8f}i   (ritz res {r:.1e})")
    lk.save_eigenspectrum(np.asarray(lam_A), np.asarray(res),
                          "gl_spectrum_out.npy")

    with lk.timed("gl_adjoint_eigs"):
        evals_a, _, res_a, _, meta_a = lk.eigs(
            prop, args.nev, x0=x0, kdim=args.kdim, tolerance=1e-8,
            transpose=True, options=lk.EigsOptions(maxiter=30))
    print(f"\nadjoint propagator converged={meta_a.converged}")
    lk.global_watch.print_summary()


if __name__ == "__main__":
    sys.exit(main())
