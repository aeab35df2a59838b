"""nllstpu — a robustified non-linear least-squares framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of NLLSsolver.jl
(Ceres-style robustified NLLS): manifold-valued variable blocks, type-batched
residual blocks with fixed or adaptive robust kernels, Jacobians by forward
autodiff through the retraction, Newton / Levenberg-Marquardt / dogleg /
gradient-descent iterations over dense or Schur-reduced normal equations, and
mesh-sharded assembly for multi-device scaling.  See SURVEY.md for the
structural map of the reference and the design translation.
"""

from . import config  # noqa: F401  (enables x64 before anything else)

from .core.manifolds import (
    BarronManifold,
    ContaminatedGaussianManifold,
    Euclidean,
    Manifold,
    SE3,
    SO3,
    Scalar,
    ZeroToInf,
    ZeroToOne,
    so3_exp,
)
from .core.robust import (
    AdaptiveRobustifier,
    Barron,
    Cauchy,
    ContaminatedGaussian,
    GemanMcclure,
    Huber,
    Huber2o,
    NoRobust,
    Robustifier,
    Scaled,
    ScaledAdaptive,
    Tukey,
    Welsch,
    em_fit,
)
from .core.problem import Problem, VarHandle, family_name
from .core.structs import (
    DOGLEG,
    GRADIENT_DESCENT,
    LEVENBERG_MARQUARDT,
    NEWTON,
    CostTrajectory,
    Options,
    Result,
)
from .core.optimize import (
    CompiledProblem,
    SubproblemView,
    compile_problem,
    cost,
    optimize,
)
from .core.singles import optimize_singles
from .core.callbacks import null_callback, printout_callback, store_costs_callback

__version__ = "0.1.0"

__all__ = [
    "Manifold",
    "Euclidean",
    "Scalar",
    "ZeroToInf",
    "ZeroToOne",
    "SO3",
    "SE3",
    "ContaminatedGaussianManifold",
    "BarronManifold",
    "so3_exp",
    "Robustifier",
    "NoRobust",
    "Scaled",
    "ScaledAdaptive",
    "Huber",
    "Huber2o",
    "GemanMcclure",
    "Cauchy",
    "Welsch",
    "Tukey",
    "Barron",
    "AdaptiveRobustifier",
    "ContaminatedGaussian",
    "em_fit",
    "Problem",
    "VarHandle",
    "family_name",
    "Options",
    "Result",
    "CostTrajectory",
    "NEWTON",
    "LEVENBERG_MARQUARDT",
    "DOGLEG",
    "GRADIENT_DESCENT",
    "optimize",
    "SubproblemView",
    "optimize_singles",
    "cost",
    "compile_problem",
    "CompiledProblem",
    "null_callback",
    "printout_callback",
    "store_costs_callback",
]
