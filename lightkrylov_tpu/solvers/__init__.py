"""Iterative solvers: eigs/eighs/svds, gmres/fgmres/cg, kexpm, newton
(counterpart of ``src/IterativeSolvers/`` + ``src/Expm/`` +
``src/Newton/``)."""

from .gmres import gmres, fgmres
from .cg import cg
from .eigs import eigs, save_eigenspectrum
from .eighs import eighs
from .svds import svds
from .expm import kexpm, kexpm_mat, krylov_exptA, ExponentialPropagator
from .newton import newton, constant_tol, dynamic_tol

__all__ = [
    "gmres",
    "fgmres",
    "cg",
    "eigs",
    "eighs",
    "svds",
    "save_eigenspectrum",
    "kexpm",
    "kexpm_mat",
    "krylov_exptA",
    "ExponentialPropagator",
    "newton",
    "constant_tol",
    "dynamic_tol",
]
