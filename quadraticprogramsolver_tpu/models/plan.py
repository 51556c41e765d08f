"""Static execution-plan introspection: which factor and cache will a solve use?

Every path choice in the solvers is STATIC (shapes, dtype, settings), so the
executed path is fully determined before tracing — this module computes it
without allocating or tracing anything. The reference's analogue is its
benchmark schema guard (`/root/reference/RunBenchmarks.jl:123-137`):
artifacts must be able to say what produced them.

Usage::

    from quadraticprogramsolver_tpu.models import plan as plan_mod
    p = plan_mod.plan(qp, settings)   # box-form ADMM family
    p.backend   # "cholesky" | "kkt_ldl" | "cg" | "kkt_minres"
    p.factor    # "cholesky_solve" | "inverse" | "ldl_scan" | ...
    p.cache     # "G_g" | "M_inv" | "L_d" | "diag" | "P_inv"

``plan_proxqp(prob, settings)`` is the prox-ALM twin.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SolvePlan:
    """Static description of the paths one solve will execute."""

    #: Resolved KKT backend (KKTBackendKind.value, e.g. "cholesky");
    #: "prox_alm" for the prox family.
    backend: str
    #: Factor/setup implementation: "cholesky_solve" (sigma-free Cholesky
    #: multi-RHS solve for [G g]), "inverse" (explicit M^{-1}), "ldl_scan",
    #: "jacobi_diag" or "minres_precond".
    factor: str
    #: KKT cache layout: "G_g", "M_inv", "L_d", "diag", "P_inv", "Ga_Gc_g".
    cache: str


def plan(qp, settings) -> SolvePlan:
    """Execution plan for :func:`models.admm.solve` on this (qp, settings).

    Purely static — inspects shapes/dtype/settings, allocates nothing,
    traces nothing, and uses the solver's own backend resolution.
    """
    from ..core.settings import KKTBackendKind
    from . import kkt as kkt_mod

    kind = kkt_mod.resolve_backend(settings.kkt_backend, qp)
    if kind is KKTBackendKind.CHOLESKY:
        factor, cache = (("cholesky_solve", "G_g") if settings.sigma_free_rhs
                         else ("inverse", "M_inv"))
    elif kind is KKTBackendKind.KKT_LDL:
        factor, cache = "ldl_scan", "L_d"
    elif kind is KKTBackendKind.KKT_MINRES:
        factor = "minres_precond"
        cache = "P_inv" if qp.is_dense else "diag"
    else:  # CG
        factor, cache = "jacobi_diag", "diag"
    return SolvePlan(backend=kind.value, factor=factor, cache=cache)


def plan_proxqp(prob, settings) -> SolvePlan:
    """Execution plan for :func:`models.proxqp.solve` (prox-ALM family)."""
    if settings.sigma_free_rhs:
        factor, cache = "cholesky_solve", "Ga_Gc_g"
    elif prob.is_dense:
        factor, cache = "inverse", "M_inv"
    else:
        factor, cache = "jacobi_diag", "diag"
    return SolvePlan(backend="prox_alm", factor=factor, cache=cache)
