"""Krylov processes: orthogonalization, QR, Arnoldi/Lanczos/Golub-Kahan
factorizations and the Krylov-Schur restart
(counterpart of ``src/Krylov/`` — BaseKrylov.fypp:38-52)."""

from .gram_schmidt import double_gram_schmidt_step, orthogonalize_against_basis
from .qr import qr, qr_pivoted, cholesky_qr2
from .arnoldi import arnoldi, arnoldi_block, arnoldi_step, initialize_arnoldi
from .lanczos import lanczos, lanczos_step, initialize_lanczos
from .bidiag import bidiagonalization, initialize_bidiag
from .krylov_schur import krylov_schur, median_selector
from .utilities import (
    permcols,
    invperm,
    initialize_krylov_subspace,
    initialize_random_orthonormal_basis,
    orthonormalize_basis,
    is_orthonormal,
)

__all__ = [
    "double_gram_schmidt_step",
    "orthogonalize_against_basis",
    "qr",
    "qr_pivoted",
    "cholesky_qr2",
    "arnoldi",
    "arnoldi_block",
    "arnoldi_step",
    "initialize_arnoldi",
    "lanczos",
    "lanczos_step",
    "initialize_lanczos",
    "bidiagonalization",
    "initialize_bidiag",
    "krylov_schur",
    "median_selector",
    "permcols",
    "invperm",
    "initialize_krylov_subspace",
    "initialize_random_orthonormal_basis",
    "orthonormalize_basis",
    "is_orthonormal",
]
