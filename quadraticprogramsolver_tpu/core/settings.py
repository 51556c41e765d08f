"""Solver settings — static (hashable) configuration pytree-free dataclass.

Parameter names and defaults follow the reference so its configs translate
1:1 (`/root/reference/SolveQuadraticProgram.jl:14-17` for the Julia defaults,
`/root/reference/SolveQuadraticProgram.m:84-107` for the MATLAB ones; where the
two disagree we take the Julia values, which the reference's own test/bench
drivers use).

Being a frozen dataclass, ``Settings`` is passed as a *static* argument to the
jitted solve, so every distinct configuration compiles once and the hot loop
contains no setting-dependent branches at runtime.

NOTE (reference bug, not replicated): `SolveQuadraticProgram.m:141` reads
``fctrRho`` from ``sSolverParams.adaptRho`` — a copy-paste bug that silently
pins the refactor hysteresis to 1. We use the declared default of 5.
"""

from __future__ import annotations

import dataclasses
import enum


class KKTBackendKind(enum.Enum):
    """KKT linear-system strategy, mirroring the reference's pluggable
    (init, solve!) handle pairs (`/root/reference/LinearSystemSolvers.jl:16-229`)
    and its auto direct/iterative switch (`SolveQuadraticProgram.m:190-204`)."""

    AUTO = "auto"
    #: Batched dense Cholesky of the SPD normal matrix P + sigma*I + rho*A'A,
    #: cached inverse (or sigma-free G = M^{-1}A') so per-iteration solves
    #: are batched matvecs.
    CHOLESKY = "cholesky"
    #: Batched dense signed-LDL' of the quasi-definite 2x2 KKT matrix
    #: [[P+sigma*I, A'], [A, -I/rho]] — the OSQP-paper factorization.
    KKT_LDL = "kkt_ldl"
    #: Matrix-free conjugate gradient on the normal matrix (large problems).
    CG = "cg"
    #: Batched preconditioned MINRES on the quasi-definite 2x2 KKT system —
    #: the iterative option that does NOT square the condition number
    #: (re-imagines the reference's TriCG/TriMR exploration,
    #: `LinearSystemSolversFun.jl:191-234`). Works for dense and sparse QPs;
    #: the dense preconditioner (P+sigma*I)^{-1} is rho-independent, so
    #: adaptive-rho refactor events are free.
    KKT_MINRES = "kkt_minres"


# Auto-switch thresholds, as in the reference (`SolveQuadraticProgram.m:126-128`).
MAX_DIRECT_KKT_DIM = 5000
MAX_DIRECT_DENSITY = 0.4

# Adaptive-rho clipping (`SolveQuadraticProgram.m:130-131`, jl:81-82).
RHO_MIN = 1e-3
RHO_MAX = 1e6

# ADMM fixed-point tolerance factor (`SolveQuadraticProgram.m:124,208`).
EPS_ADMM_FACTOR = 1e-2

#: f32 floor for the proximal regularization sigma. The reference's
#: sigma=1e-6 is an f64-era constant: on QPs with zero-cost flat directions
#: (huber/lasso: singular P, one-sided rows) lambda_min(P+sigma*I+rho*A'A)
#: collapses to sigma, so cond(M) ~ lambda_max/sigma can exceed 1/eps_f32 —
#: at that point the f32 KKT solve is garbage AND iterative refinement
#: diverges (contraction factor cond*eps > 1), which surfaced as bounded
#: residual oscillation on ~5/64 huber instances (f64 trajectories
#: identical until rho adapts upward). Flooring sigma at 1e-4 caps cond(M)
#: within f32's refinement-convergent range; the QP's solution is
#: sigma-independent (prox term vanishes at the fixed point), and the
#: measured effect is 64/64 huber solved with no regression elsewhere.
SIGMA_F32_FLOOR = 1e-4


def sigma_for(sigma: float, dtype) -> float:
    """Dtype-aware effective sigma: the f64 value, floored in f32."""
    import numpy as np

    if np.dtype(dtype) == np.float32:
        return max(sigma, SIGMA_F32_FLOOR)
    return sigma


@dataclasses.dataclass(frozen=True)
class Settings:
    """OSQP-ADMM solver settings (static / hashable)."""

    max_iterations: int = 5000          # jl:15 numIterations
    eps_abs: float = 1e-6               # jl:15
    eps_rel: float = 1e-6               # jl:15
    rho: float = 1.0                    # jl:16 (MATLAB default is 1e6, m:94)
    sigma: float = 1e-6                 # jl:16
    alpha: float = 1.6                  # jl:16 relaxation
    delta: float = 1e-6                 # jl:16 polish regularization
    adaptive_rho: bool = True           # jl:16 adptP (ref default false; tests use true)
    rho_factor: float = 5.0             # jl:17 fctrP refactor hysteresis
    check_interval: int = 25            # jl:17 numItrConv (MATLAB: 50)
    polish_iterations: int = 0          # m:100 numPolishItr (Julia path has none)
    polish_eps: float = 1e-6            # m:104 minresEps
    polish_max_krylov: int = 500        # m:105 minresItr
    cg_eps: float = 1e-9                # m:102 pcgEps
    cg_max_iterations: int = 200        # m:103 pcgItr (static bound, see kkt.py)
    #: Relative inner tolerance for the CG KKT backend: stop at
    #: cg_rel_eps * ||r0|| as well as cg_eps (inexact-ADMM forcing term;
    #: with the warm-started solution carry the inner accuracy tightens
    #: automatically as the outer iteration converges). 0 disables — the
    #: reference's fixed-abstol behavior (m:102).
    cg_rel_eps: float = 0.0
    kkt_backend: KKTBackendKind = KKTBackendKind.AUTO
    #: Extra iterative-refinement passes on each KKT solve. In f32 the
    #: cached factor loses digits; one refinement step restores most of the
    #: accuracy the f64 reference gets for free. 0 disables.
    kkt_refinement_steps: int = 1
    #: Record per-check residuals/rho into SolveInfo.history (device-side
    #: trace buffers of shape (num_checks, *B)).
    record_history: bool = False
    #: Detect primal/dual infeasibility from iterate-difference certificates
    #: (OSQP paper §3.4; not in the reference — README.md To-Do). Checked at
    #: the same cadence as convergence; costs ~2 extra matvec sweeps/check.
    check_infeasibility: bool = True
    #: Certificate tolerances (OSQP defaults).
    eps_prim_inf: float = 1e-4
    eps_dual_inf: float = 1e-4
    #: Modified-Ruiz equilibration sweeps before solving (OSQP §5.1; the
    #: reference's unimplemented To-Do #2). 0 disables. Termination tests run
    #: on UNSCALED residuals (OSQP's discipline; rho adaptation uses scaled
    #: residuals); reported residuals/objective are unscaled.
    scaling_iters: int = 0
    #: Matmul precision for f32 solves (jax.default_matmul_precision).
    #: "highest" = full FP32 (on the GPU: outside the tensor cores);
    #: "default" lets XLA use TF32, which keeps about three decimal digits
    #: and stalls ADMM well above a 1e-4 tolerance. Irrelevant on CPU/f64.
    matmul_precision: str = "highest"
    #: Matmul precision for the normal-matrix build + factor only (the
    #: setup cost). "default" (TF32 on the GPU) turns the cached M^{-1}
    #: into an approximate inverse; pair it with kkt_refinement_steps >= 1,
    #: whose residual is computed against the TRUE M from P and A at the
    #: solve's matmul_precision, so the KKT solves still converge to
    #: full-f32 solutions. None inherits matmul_precision.
    factor_precision: str | None = None
    #: Sigma-free right-hand side for the dense CHOLESKY backend: drop the
    #: proximal sigma*x term from the KKT RHS, so the x-update becomes
    #:     xx = G (rho z - y) - g,   G = M^{-1} A',  g = M^{-1} q,
    #: i.e. exact (non-proximal) ADMM on P + sigma*I. G and g are computed
    #: ONCE per factorization by a Cholesky multi-RHS solve that never
    #: materializes M^{-1} (ops/linalg.spd_solve), and the hot loop shrinks
    #: from 3 dependent matvecs to 2.
    #: SEMANTICS: the fixed point solves the QP with P replaced by
    #: P + sigma*I, so sigma_for() does NOT apply the f32 floor here — keep
    #: sigma at (or below) its 1e-6 default and only use this on problems
    #: where M = P + sigma*I + rho*A'A stays f32-invertible (e.g. P with a
    #: positive-definite part, like the randomQp/portfolio families). The
    #: termination tests still evaluate TRUE-problem residuals, so a lane
    #: reports SOLVED only when the original QP's residuals pass eps.
    #: Requires kkt_refinement_steps == 0 (refinement needs M^{-1}) and the
    #: CHOLESKY (or AUTO-dense) backend.
    sigma_free_rhs: bool = False
    #: Per-constraint penalty weighting: equality rows (l == u) get
    #: rho * rho_eq_scale (OSQP's vector-rho scheme — the reference's To-Do
    #: #1 "paramRho as a matrix"). 1.0 reproduces the reference's scalar rho.
    rho_eq_scale: float = 1.0
    #: Safeguarded Anderson acceleration of the ADMM fixed point (history
    #: depth M; 0 disables). Applied at check boundaries to the chunk map,
    #: guarded by a per-lane residual-decrease test, so it composes with
    #: every backend (incl. the matrix-free sparse path) and never degrades
    #: a check. Costs ~3 matvecs + an MxM
    #: solve per check, plus 2*M*(n+m) floats of per-lane history. See
    #: models/anderson.py. Not in the reference (single-problem plain
    #: iteration); biggest wins on slow-converging / tight-tolerance solves.
    anderson_memory: int = 0
    #: Relative Tikhonov damping of the AA least-squares.
    anderson_reg: float = 1e-8

    def __post_init__(self):
        if self.max_iterations < 1:
            raise ValueError("max_iterations must be positive")
        if self.check_interval < 1:
            raise ValueError("check_interval must be positive")
        if not (0.0 < self.alpha < 2.0):
            raise ValueError("alpha must be in (0, 2)")
        for name in ("eps_abs", "eps_rel", "rho", "sigma", "delta"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive")
        if self.sigma_free_rhs and self.kkt_refinement_steps > 0:
            raise ValueError(
                "sigma_free_rhs caches only G = M^{-1}A' and g = M^{-1}q — "
                "iterative refinement needs M^{-1}; set kkt_refinement_steps=0")

    @property
    def eps_admm(self) -> float:
        """Fixed-point termination tolerance (`SolveQuadraticProgram.jl:34`)."""
        return min(self.eps_abs, self.eps_rel) * EPS_ADMM_FACTOR

    @property
    def num_checks(self) -> int:
        """Number of convergence-check chunks covering max_iterations."""
        return -(-self.max_iterations // self.check_interval)

    def sigma_for(self, dtype) -> float:
        """Proximal sigma with a dtype-aware floor (see SIGMA_F32_FLOOR).

        With ``sigma_free_rhs`` the floor is NOT applied: there sigma
        perturbs the SOLUTION (P becomes P + sigma*I at the fixed point),
        not just the proximal step, so it must stay at the user's small
        value; the floor's refinement-conditioning rationale is moot because
        sigma_free_rhs excludes refinement."""
        if self.sigma_free_rhs:
            return self.sigma
        return sigma_for(self.sigma, dtype)


@dataclasses.dataclass(frozen=True)
class ProxQPSettings:
    """Prox-ALM (ProxQP-style) solver settings (`/root/reference/ProxQP.jl:118`)."""

    max_iterations: int = 2000          # ProxQP.jl:118 numIterations
    eps_abs: float = 1e-7
    eps_rel: float = 1e-6
    check_interval: int = 50            # numItrConv
    rho: float = 1e2
    sigma: float = 1e-2
    adaptive_rho: bool = True
    tau: float = 10.0                   # residual-ratio trigger
    rho_min: float = 1e-5               # ProxQP.jl:255
    rho_max: float = 1e5                # ProxQP.jl:256
    kkt_refinement_steps: int = 1
    #: Inner-CG controls for the matrix-free SparseProxQP path (Jacobi-
    #: preconditioned CG on M = P + sigma*I + rho*(A'A + C'C), warm-started
    #: from the previous iterate). Ignored for dense problems.
    cg_eps: float = 1e-9
    cg_max_iterations: int = 200
    #: Relative inner tolerance: stop CG at cg_rel_eps * ||r0|| as well
    #: (inexact prox-ALM forcing term — with the warm-started carry the
    #: inner accuracy tightens as the outer iteration converges). 0
    #: disables. On ill-conditioned operators (e.g. squared difference
    #: matrices) an absolute f32 tolerance is unreachable and every outer
    #: iteration burns the full cg_max_iterations without this.
    cg_rel_eps: float = 0.0
    #: Stop iterating once every lane has converged. The reference keeps
    #: looping after convergence (`ProxQP.jl:157` has its break commented
    #: out); False runs the full budget like the reference, with one
    #: difference: this solver latches converged-once-seen, while the
    #: reference recomputes its flag fresh at the final check.
    early_exit: bool = True
    #: Initialize from the equality-KKT solve as the reference does
    #: (ProxQP.jl:80-90). False starts from zeros — at loose tolerances on
    #: large fleets the batched LU can cost more than the iterations it
    #: saves, but at tight tolerances on equality-rich problems the warm
    #: start is load-bearing (25 vs 4000+ iterations at eps 1e-5 with
    #: n_eq = n). Keep the default unless profiling says otherwise.
    kkt_warm_start: bool = True
    #: Safeguarded Anderson acceleration of the prox-ALM fixed point in
    #: (x, y, s - z/rho) coordinates (see Settings.anderson_memory and
    #: models/anderson.py; 0 disables).
    anderson_memory: int = 0
    anderson_reg: float = 1e-8
    #: Exact (non-proximal, sigma-dropped) ALM with the cached columns
    #: {Ga = M^{-1}A', Gc = M^{-1}C', g = M^{-1}q} instead of the explicit
    #: (n, n) M^{-1} — the prox-ALM analogue of Settings.sigma_free_rhs.
    #: The x-update becomes Ga(rho b - y) + Gc(rho(d-s) - z) - g: fewer
    #: dots per iteration AND the per-lane cache shrinks from n^2 to
    #: (n_eq + n_ineq) n floats. Requires a dense problem,
    #: kkt_refinement_steps == 0 (refinement needs M^{-1}), and
    #: M = P + rho(A'A + C'C) invertible WITHOUT the sigma shift (P with a
    #: PD part). The factor is a Cholesky solve for [A' C' q]
    #: (ops/linalg.spd_solve).
    sigma_free_rhs: bool = False
    #: Detect primal/dual infeasibility from iterate-difference Farkas
    #: certificates in the split form (Ax=b, Cx<=d): primal-infeasible when
    #: the diverging dual direction (dy, dz) satisfies A'dy + C'dz ~ 0,
    #: b'dy + d'dz < 0, dz >= 0; dual-infeasible (unbounded) when dx
    #: satisfies P dx ~ 0, A dx ~ 0, C dx <~ 0, q'dx < 0. Mirrors the box
    #: form's OSQP §3.4 certificates (Settings.check_infeasibility); not in
    #: the reference (ProxQP.jl loops its full budget on infeasible input).
    check_infeasibility: bool = True
    eps_prim_inf: float = 1e-4
    eps_dual_inf: float = 1e-4
    #: Record per-check residuals/rho into ProxQPInfo.history (device-side
    #: trace buffers of shape (num_checks, *B)) — the role of the
    #: reference's commented @printf residual trace (ProxQP.jl:272).
    record_history: bool = False

    def __post_init__(self):
        if self.max_iterations < 1:
            raise ValueError("max_iterations must be positive")
        if self.check_interval < 1:
            raise ValueError("check_interval must be positive")

    @property
    def num_checks(self) -> int:
        return -(-self.max_iterations // self.check_interval)
