"""Model operator families: the reference's example/test physics rebuilt
as pytree operators (Toeplitz fixtures, 2D Poisson + block-Jacobi, convection-
diffusion, linearized Ginzburg-Landau + time-stepper propagator, Roessler
fixed-point/UPO systems)."""

from .toeplitz import TridiagToeplitz, toeplitz_eigvals
from .poisson import Poisson2D, poisson2d_eigvals, BlockJacobiPoisson
from .convdiff import ConvectionDiffusion2D
from .ginzburg_landau import (GinzburgLandau, GinzburgLandauReal,
                              GLPropagator, gl_analytic_eigvals)
from .otd import otd_evolve, otd_rhs, lyapunov_exponents
from .roessler import (
    roessler_rhs,
    roessler_fixed_points,
    flow,
    fixed_point_system,
    upo_system,
    UPOJacobian,
    monodromy,
    floquet_exponents,
)

__all__ = [
    "TridiagToeplitz",
    "toeplitz_eigvals",
    "Poisson2D",
    "poisson2d_eigvals",
    "BlockJacobiPoisson",
    "ConvectionDiffusion2D",
    "GinzburgLandau",
    "GinzburgLandauReal",
    "GLPropagator",
    "gl_analytic_eigvals",
    "roessler_rhs",
    "roessler_fixed_points",
    "flow",
    "fixed_point_system",
    "upo_system",
    "UPOJacobian",
    "monodromy",
    "floquet_exponents",
    "otd_evolve",
    "otd_rhs",
    "lyapunov_exponents",
]
