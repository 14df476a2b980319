"""Machine-precision tolerances and process-level context.

Counterpart of the reference's ``LightKrylov_Constants``
(reference: src/Constants.f90:16-56). The reference defines, per scalar kind,

    atol = 10 ** (-precision(1.0))      # 1e-6 single / 1e-15 double
    rtol = sqrt(atol)

and module-level MPI rank / communicator-size state used solely to gate
logging and IO (src/Constants.f90:60-100).  Here the "rank" is the JAX
process index over a multi-host deployment.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "atol",
    "rtol",
    "eps",
    "get_rank",
    "get_comm_size",
    "io_rank",
    "set_io_rank",
    "real_dtype_of",
    "is_complex_dtype",
]

# Decimal precision per real dtype, matching Fortran ``precision()``
# (reference: src/Constants.f90:18-37): 6 for binary32, 15 for binary64.
_PRECISION = {
    np.dtype(np.float32): 6,
    np.dtype(np.float64): 15,
    np.dtype(np.complex64): 6,
    np.dtype(np.complex128): 15,
}

# bfloat16 has ~2.4 decimal digits; we register it so utilities degrade
# gracefully, although the solver contracts target f32/f64 (the reference
# has no half-precision kinds).
try:
    _PRECISION[np.dtype(jnp.bfloat16)] = 2
except TypeError:  # pragma: no cover
    pass


def real_dtype_of(dtype) -> np.dtype:
    """The real dtype underlying ``dtype`` (c64 -> f32, c128 -> f64)."""
    return np.dtype(np.finfo(np.dtype(dtype)).dtype)


def is_complex_dtype(dtype) -> bool:
    return np.issubdtype(np.dtype(dtype), np.complexfloating)


def atol(dtype) -> float:
    """Absolute tolerance ``10**-precision`` for ``dtype``.

    Matches ``atol_sp = 1e-6`` / ``atol_dp = 1e-15``
    (reference: src/Constants.f90:18-37).
    """
    key = np.dtype(dtype)
    if key not in _PRECISION:
        key = real_dtype_of(key)
    return 10.0 ** (-_PRECISION[key])


def rtol(dtype) -> float:
    """Relative tolerance ``sqrt(atol)`` (reference: src/Constants.f90:20-39)."""
    return math.sqrt(atol(dtype))


def eps(dtype) -> float:
    """Machine epsilon of the real dtype underlying ``dtype``."""
    return float(np.finfo(real_dtype_of(dtype)).eps)


# -- Process context ---------------------------------------------------------
#
# The reference stores an MPI rank/comm size set by the user or by
# ``comm_setup`` (src/Constants.f90:60-100).  In JAX the runtime already
# knows: ``jax.process_index()`` / ``jax.process_count()``.  Only the IO rank
# remains user-settable state.

_io_rank = 0


def get_rank() -> int:
    """Index of the current process (reference: src/Constants.f90 ``get_rank``)."""
    return jax.process_index()


def get_comm_size() -> int:
    """Number of processes (reference: src/Constants.f90 ``get_comm_size``)."""
    return jax.process_count()


def set_io_rank(rank: int) -> None:
    """Choose which process performs logging/IO (reference: ``set_io_rank``)."""
    global _io_rank
    if 0 <= rank < get_comm_size():
        _io_rank = rank


def io_rank() -> bool:
    """True on the process responsible for logging/IO (reference: ``io_rank``)."""
    return get_rank() == _io_rank
