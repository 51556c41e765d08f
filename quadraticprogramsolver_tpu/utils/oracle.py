"""Host-side float64 reference solver and KKT optimality checker (test oracles).

The reference validates against external solvers — OSQP/Gurobi
(`/root/reference/RunTests.jl:74-83`), quadprog/CVX
(`SolveQuadraticProgramUnitTest.m:106-130`). Those are unavailable here, so the
oracle discipline becomes:

1. :func:`solve_qp_reference` — an independent, scalar, float64 NumPy/SciPy
   implementation of the same OSQP iteration (sparse LU of the quasi-definite
   KKT matrix — a *different* linear-algebra path than the device solver's
   batched normal-equations Cholesky), run at tight tolerance. Math follows
   `SolveQuadraticProgram.jl:45-112`.
2. :func:`kkt_optimality` — direct verification of the KKT conditions of a
   box-constrained QP at a candidate (x, z, y): primal/dual residuals and
   complementary slackness. A solution passing this at tolerance eps is
   optimal regardless of which solver produced it.

Both run on host in float64 and never enter the device compute path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

RHO_MIN, RHO_MAX = 1e-3, 1e6  # SolveQuadraticProgram.jl:81-82


@dataclasses.dataclass
class OracleResult:
    x: np.ndarray
    z: np.ndarray
    y: np.ndarray
    status: int           # 1 = max-iters, 2 = admm fixed point, 3 = primal+dual
    iterations: int
    res_prim: float
    res_dual: float
    rho: float


def _inf_norm(v: np.ndarray) -> float:
    return float(np.abs(v).max()) if v.size else 0.0


def solve_qp_reference(
    P, q, A, l, u,
    x0=None,
    max_iterations: int = 50_000,
    eps_abs: float = 1e-9,
    eps_rel: float = 1e-9,
    rho: float = 0.1,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    adaptive_rho: bool = True,
    rho_factor: float = 5.0,
    check_interval: int = 25,
    linsys: str = "ldl",
) -> OracleResult:
    """Scalar f64 OSQP-ADMM with sparse direct KKT solves.

    Same iteration as `SolveQuadraticProgram.jl:45-71`; KKT system
    [[P+sigma*I, A'], [A, -I/rho]] factored by the native quasi-definite
    LDL' (utils/native.py, linsys="ldl" — the role QDLDL plays for the
    reference) or scipy splu (linsys="splu"), re-factored on rho hysteresis
    trips (:47-52). Defaults run an order of magnitude tighter than the
    acceptance threshold, mirroring RunTests.jl:50-58 (oracle at 1e-7,
    accept at 1e-5).
    """
    P = sp.csc_matrix(P)
    A = sp.csc_matrix(A)
    q = np.asarray(q, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    n, m = q.size, l.size

    if linsys == "ldl":
        from .native import kkt_factorization

        def factor(rho_val: float):
            return kkt_factorization(P, A, rho_val, sigma)

    elif linsys == "splu":

        def factor(rho_val: float):
            K = sp.bmat(
                [
                    [P + sigma * sp.identity(n), A.T],
                    [A, -sp.identity(m) / rho_val],
                ],
                format="csc",
            )
            return spla.splu(K)

    else:
        raise ValueError(f"unknown linsys {linsys!r} (use 'ldl' or 'splu')")

    x = np.zeros(n) if x0 is None else np.asarray(x0, dtype=np.float64).copy()
    z = np.zeros(m)
    y = np.zeros(m)
    eps_admm = min(eps_abs, eps_rel) * 1e-2
    rho_cand = rho
    lu = factor(rho)
    status, res_prim, res_dual = 1, np.inf, np.inf
    it = 0
    norm_q = _inf_norm(q)

    for it in range(1, max_iterations + 1):
        if adaptive_rho and (rho_cand * rho_factor < rho or rho_cand > rho_factor * rho):
            rho = rho_cand
            lu = factor(rho)
        rhs = np.concatenate([sigma * x - q, z - y / rho])
        v = lu.solve(rhs)
        xx = v[:n]
        zz = z + (v[n:] - y) / rho

        x_prev, z_prev = x, z
        x = alpha * xx + (1 - alpha) * x_prev
        z = np.clip(alpha * zz + (1 - alpha) * z_prev + y / rho, l, u)
        y = y + rho * (alpha * zz + (1 - alpha) * z_prev - z)

        if it % check_interval == 0:
            Ax = A @ x
            Px = P @ x
            ATy = A.T @ y
            res_prim = _inf_norm(Ax - z)
            res_dual = _inf_norm(Px + q + ATy)
            max_prim = max(_inf_norm(Ax), _inf_norm(z))
            max_dual = max(_inf_norm(Px), _inf_norm(ATy), norm_q)
            if adaptive_rho and res_dual * max_prim > 0:
                rho_cand = float(
                    np.clip(
                        rho * np.sqrt((res_prim * max_dual) / (res_dual * max_prim)),
                        RHO_MIN, RHO_MAX,
                    )
                )
            if res_prim < eps_abs + eps_rel * max_prim and res_dual < eps_abs + eps_rel * max_dual:
                status = 3
                break
            if _inf_norm(x - x_prev) <= eps_admm and _inf_norm(z - z_prev) <= eps_admm:
                status = 2
                break

    return OracleResult(x, z, y, status, it, res_prim, res_dual, rho)


@dataclasses.dataclass
class KKTReport:
    res_prim: float        # ||clip(Ax,l,u) - Ax||_inf  (bound violation)
    res_dual: float        # ||Px + q + A'y||_inf
    res_comp: float        # complementary-slackness violation
    res_z: float           # ||Ax - z||_inf

    def optimal(self, eps: float) -> bool:
        return max(self.res_prim, self.res_dual, self.res_comp) <= eps


def kkt_optimality(P, q, A, l, u, x, z=None, y=None) -> KKTReport:
    """Check KKT conditions of `min 0.5x'Px+q'x s.t. l<=Ax<=u` at (x, z, y).

    Stationarity: Px + q + A'y = 0.
    Primal feasibility: l <= Ax <= u.
    Complementarity: y+ (u - Ax) = 0 and y- (Ax - l) = 0 elementwise
    (y > 0 only at the upper bound, y < 0 only at the lower — the same sign
    convention the reference's polish step keys on, SolveQuadraticProgram.m:293-294).
    """
    P = sp.csc_matrix(P)
    A = sp.csc_matrix(A)
    q, l, u = (np.asarray(v, dtype=np.float64) for v in (q, l, u))
    x = np.asarray(x, dtype=np.float64)
    Ax = A @ x
    res_prim = _inf_norm(Ax - np.clip(Ax, l, u))
    if y is None:
        return KKTReport(res_prim, np.inf, np.inf, np.inf)
    y = np.asarray(y, dtype=np.float64)
    res_dual = _inf_norm(P @ x + q + A.T @ y)
    y_pos = np.maximum(y, 0.0)
    y_neg = np.minimum(y, 0.0)
    # On infinite-bound rows the dual must simply have the right sign; a
    # wrong-sign dual there is a sign violation measured by |y| itself
    # (multiplying by a huge gap surrogate would blow tiny f32 noise up to
    # ~1e21 and fail optimal(eps) spuriously).
    gap_u = np.where(np.isfinite(u), u - Ax, 0.0)   # 0 avoids 0*inf=nan
    gap_l = np.where(np.isfinite(l), Ax - l, 0.0)
    comp_u = np.where(np.isfinite(u), y_pos * gap_u, y_pos)
    comp_l = np.where(np.isfinite(l), -y_neg * gap_l, -y_neg)
    comp = max(
        _inf_norm(np.where(y_pos > 0, comp_u, 0.0)),
        _inf_norm(np.where(y_neg < 0, comp_l, 0.0)),
    )
    res_z = _inf_norm(Ax - z) if z is not None else np.inf
    return KKTReport(res_prim, res_dual, comp, res_z)
