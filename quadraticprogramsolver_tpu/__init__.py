"""quadraticprogramsolver_tpu — a batched QP solver framework for accelerators.

Ground-up JAX/XLA re-design of the capabilities of
RoyiAvital/QuadraticProgramSolver (OSQP-style ADMM + ProxQP-style prox-ALM,
pluggable KKT backends, 9-class benchmark generator) for fleets of QPs on
one GPU or a mesh of them.
See SURVEY.md at the repo root for the structural map of the reference.
"""

from .core.problem import (
    QP, ProxQPProblem, make_proxqp, make_qp, pad_qp, stack_qps, validate_qp,
)
from .core.settings import KKTBackendKind, ProxQPSettings, Settings
from .core.sparse_problem import (
    SparseProxQP, SparseQP, make_sparse_proxqp, make_sparse_qp,
)
from .core.state import SolveInfo, Solution, Status
from .frontends.reuse import CachedQPSolver
from .models.admm import PreparedFactor, prepare, prepare_jit, solve, solve_jit
from .models.plan import SolvePlan, plan, plan_proxqp
from .models.proxqp import (
    PreparedProxFactor, ProxQPSolution, prepare as prepare_proxqp,
    solve as solve_proxqp,
)
from .models.proxqp import solve_jit as solve_proxqp_jit
from .problems.generator import ALL_CLASSES, ProblemClass, generate_batch, generate_random_qp

__version__ = "0.1.0"

__all__ = [
    "QP",
    "ProxQPProblem",
    "SparseProxQP",
    "SparseQP",
    "make_qp",
    "make_proxqp",
    "make_sparse_proxqp",
    "make_sparse_qp",
    "pad_qp",
    "stack_qps",
    "validate_qp",
    "Settings",
    "ProxQPSettings",
    "KKTBackendKind",
    "SolveInfo",
    "Solution",
    "Status",
    "solve",
    "solve_jit",
    "SolvePlan",
    "plan",
    "plan_proxqp",
    "PreparedFactor",
    "prepare",
    "prepare_jit",
    "PreparedProxFactor",
    "prepare_proxqp",
    "CachedQPSolver",
    "solve_proxqp",
    "solve_proxqp_jit",
    "ProxQPSolution",
    "ProblemClass",
    "ALL_CLASSES",
    "generate_random_qp",
    "generate_batch",
    "__version__",
]
