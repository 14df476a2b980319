#!/usr/bin/env python
"""Headline benchmark: 5-point Poisson SpMV (stencil matvec) throughput.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

The BASELINE target is ">= 80% of roofline SpMV nnz/s per chip"
(BASELINE.md).  The 5-point stencil matvec is the SpMV of the partitioned
Poisson configs; it is memory-bound, so the roofline is the device memory
bandwidth divided by the bytes moved per nonzero (read u + write y = 8 B
per point / 5 nnz per point = 1.6 B/nnz).  ``vs_baseline`` = achieved /
(0.8 * roofline): >= 1.0 beats the target.

The roofline denominator is the datasheet bandwidth of the detected device
(``PEAK_BW``, keyed by ``jax.devices()[0].device_kind``); a device missing
from the table is an error.  A streaming copy (``a + 1``) is measured in the
same run as a cross-check.

The field is 8192^2 f32 (268 MB per array, over 4x the H100's 50 MB L2),
and the headline is the COLD-input regime: each matvec reads its input
from a rotating 31-column basis, the memory pattern a Krylov solver has.

Timing: K matvecs chained inside ONE jitted ``fori_loop``; the difference
(t(2K) - t(K)) / K cancels the fixed launch and synchronisation cost, and a
measurement whose difference is not a dominant part of the longer run is
declared invalid (never clamped).
"""

import json
import os
import sys
import time

#: Datasheet device-memory bandwidth (bytes/s) by ``device_kind``.
#: Source: NVIDIA H100 Tensor Core GPU datasheet (SXM5 80 GB HBM3:
#: 3.35 TB/s; PCIe 80 GB HBM2e: 2.0 TB/s).
PEAK_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}


def datasheet_bw(device_kind: str) -> float:
    try:
        return PEAK_BW[device_kind]
    except KeyError:
        raise KeyError(f"no datasheet bandwidth for device kind "
                       f"{device_kind!r}; add it to bench.PEAK_BW") from None


def timed_loop(make_step, x, min_diff=0.25, iters0=64, repeats=3):
    """Per-iteration time of a jitted chained loop, differential method.

    Times loops of ``K`` and ``2K`` steps and returns
    ``((t2 - t1) / K, diagnostics)``: the constant per-call cost cancels.
    ``K`` is estimated from a pilot run so that ``t2 - t1 >= min_diff``
    seconds.  If the difference is not at least 20% of ``t2`` the
    measurement is flagged invalid.
    """
    import jax

    def make(n):
        @jax.jit
        def loop(v):
            return jax.lax.fori_loop(0, n, lambda i, w: make_step(w), v)
        return loop

    pilot = make(iters0)
    jax.block_until_ready(pilot(x))  # compile + warm
    t0 = time.perf_counter()
    jax.block_until_ready(pilot(x))
    per_est = (time.perf_counter() - t0) / iters0

    for attempt in range(3):
        iters = max(iters0, int(min_diff / max(per_est, 1e-9)) + 1)
        loop1, loop2 = make(iters), make(2 * iters)
        jax.block_until_ready(loop1(x))
        jax.block_until_ready(loop2(x))
        t1 = t2 = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(loop1(x))
            t1 = min(t1, time.perf_counter() - t0)
            t0 = time.perf_counter()
            jax.block_until_ready(loop2(x))
            t2 = min(t2, time.perf_counter() - t0)
        diff = t2 - t1
        if diff >= 0.2 * t2 and diff > 0:
            return diff / iters, {"iters": iters, "t1": t1, "t2": t2,
                                  "valid": True, "attempt": attempt}
        per_est = max(per_est / 4, diff / iters if diff > 0 else per_est / 4)
        min_diff *= 2
    return diff / iters, {"iters": iters, "t1": t1, "t2": t2,
                          "valid": False, "attempt": attempt}


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax
    import jax.numpy as jnp

    from lightkrylov_tpu.models import Poisson2D
    from lightkrylov_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    bw = datasheet_bw(dev.device_kind)

    n = 8192
    nnz = 5 * n * n - 4 * n  # true stencil nonzeros
    op = Poisson2D(n, dtype=jnp.float32)

    big = jnp.zeros((n, n), jnp.float32)
    t_stream, sdiag = timed_loop(lambda a: a + 1.0, big)
    bw_meas = 2 * big.size * 4 / t_stream
    del big

    nbasis = 31
    Xsrc = jax.random.normal(jax.random.PRNGKey(0), (nbasis, n, n), jnp.float32)

    def cold_step(carry):
        # the product is carried, so every step writes y as a solver would
        i, _, Xc = carry
        v = jax.lax.dynamic_index_in_dim(
            Xc, jax.lax.rem(i, jnp.int32(nbasis)), keepdims=False)
        return i + 1, op.matvec(v), Xc

    t, kdiag = timed_loop(cold_step, (jnp.int32(0), Xsrc[0], Xsrc))
    if not kdiag["valid"]:
        print(json.dumps({"metric": "poisson_spmv_invalid_timing",
                          "value": 0.0, "unit": "Gnnz/s", "vs_baseline": 0.0}))
        return

    bytes_per_nnz = 8.0 / 5.0
    target = 0.8 * bw / bytes_per_nnz
    nnz_per_s = nnz / t
    print(f"# device={dev.device_kind} datasheet {bw / 1e9:.0f} GB/s; copy "
          f"{bw_meas / 1e9:.0f} GB/s (valid={sdiag['valid']}); cold matvec "
          f"{t * 1e6:.1f} us, {nnz_per_s * bytes_per_nnz / 1e9:.0f} GB/s, "
          f"iters={kdiag['iters']}", file=sys.stderr)
    print(json.dumps({
        "metric": f"poisson_spmv_cold_{dev.platform}_{n}x{n}",
        "value": round(nnz_per_s / 1e9, 4),
        "unit": "Gnnz/s",
        "vs_baseline": round(nnz_per_s / target, 4),
    }))


if __name__ == "__main__":
    main()
