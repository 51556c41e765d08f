"""Pluggable KKT linear-system backends (the per-iteration hot kernel).

Re-imagines the reference's strategy pairs ``(LinSysSolInit, LinSysSol!)``
(`/root/reference/LinearSystemSolvers.jl:16-229`) as stateless functions over
an explicit cache pytree:

    init(qp, rho, sigma, settings)            -> cache
    refactor(cache, qp, rho, sigma, settings) -> cache     (rho drifted)
    solve(cache, qp, x, z, y, rho, settings)  -> (xx, zz[, cache])

All backends solve the same reduced system each ADMM iteration: with
M = P + sigma*I + rho*A'A (SPD),

    xx = M^{-1} (sigma*x - q + A'(rho*z - y)),      zz = A @ xx,

which is algebraically identical to the quasi-definite 2x2 KKT solve the
reference's direct backends perform (LinearSystemSolvers.jl:30-44) — the
Schur complement of the (2,2) block — and exactly what its CG backends build
(LinearSystemSolvers.jl:125-142). ``rho`` is per-instance (*B,), so a fleet
of QPs adapts penalties independently under one compiled program.

Design choices:
* CHOLESKY caches the **explicit inverse** M^{-1}: each iteration's solve is
  then a single batched matvec instead of two sequential triangular
  solves. Iterative refinement (matvec residual + one more matvec)
  recovers the accuracy lost to the explicit inverse in f32. With
  ``sigma_free_rhs`` it caches G = M^{-1}A' and g = M^{-1}q instead, from
  one Cholesky multi-RHS solve.
* CG is matrix-free with a Jacobi preconditioner under `lax.while_loop`,
  with per-lane convergence masking — the large-problem path where O(n^2)
  storage of M^{-1} is unaffordable (the regime the reference routes to PCG,
  SolveQuadraticProgram.m:190-204).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ..core.problem import QP
from ..core.settings import (
    MAX_DIRECT_KKT_DIM,
    KKTBackendKind,
    Settings,
)
from ..ops.linalg import add_scaled_identity, matvec, spd_inverse, spd_solve, sym


def resolve_backend(kind: KKTBackendKind, qp) -> KKTBackendKind:
    """Static auto-selection, mirroring the reference's direct/iterative switch
    on KKT dimension and density (`SolveQuadraticProgram.m:190-204`): sparse
    problems always take the matrix-free CG path (never factorized — the
    regime the reference routes to PCG); dense problems go direct below the
    size threshold."""
    if kind is not KKTBackendKind.AUTO:
        if kind in (KKTBackendKind.CHOLESKY, KKTBackendKind.KKT_LDL) and not qp.is_dense:
            raise ValueError(f"{kind} requires a dense QP; use CG for SparseQP")
        return kind
    if qp.is_dense and qp.n + qp.m <= MAX_DIRECT_KKT_DIM:
        return KKTBackendKind.CHOLESKY
    return KKTBackendKind.CG


def row_weights(qp, settings: Settings):
    """Per-constraint penalty weights w: rho_i = rho * w_i.

    Equality rows (finite l == u) get settings.rho_eq_scale (OSQP's
    vector-rho policy; 1.0 = reference scalar-rho semantics). Static data —
    derived from the bounds only."""
    if settings.rho_eq_scale == 1.0:
        return None
    tol = 1e-9 * jnp.maximum(1.0, jnp.abs(qp.u))
    is_eq = jnp.isfinite(qp.l) & jnp.isfinite(qp.u) & (jnp.abs(qp.u - qp.l) <= tol)
    return jnp.where(is_eq, jnp.asarray(settings.rho_eq_scale, qp.dtype), 1.0)


def rho_rows(qp, rho, settings: Settings):
    """(rho * w) as a (*B, m) vector (w=1 when rho_eq_scale is 1)."""
    w = row_weights(qp, settings)
    r = rho[..., None]
    return r if w is None else r * w


def _normal_rhs(qp, x, z, y, rho_row, sigma):
    """sigma*x - q + A'(rho_row*z - y) — the reduced-KKT right-hand side."""
    return sigma * x - qp.q + qp.matvec_At(rho_row * z - y)


def _apply_normal(qp, rho_row, sigma, v):
    """Matrix-free M @ v = P v + sigma v + A'(rho_row * (A v)).

    Same operator the reference's matrix-free backends wrap
    (LinearSystemSolvers.jl:152-157), generalized to per-row penalties."""
    return qp.matvec_P(v) + sigma * v + qp.matvec_At(rho_row * qp.matvec_A(v))


# --------------------------------------------------------------------------
# Dense Cholesky backend (direct path)
# --------------------------------------------------------------------------

def _build_normal_matrix(qp: QP, rho_row, sigma):
    """P + sigma*I + A' diag(rho_row) A (rho_row broadcasts a scalar rho).

    No explicit symmetrization: P is validated symmetric at construction
    (core/problem.py:validate_qp) and A'WA is symmetric up to f32 rounding
    (~1e-7 relative), and jnp.linalg.cholesky symmetrizes its input
    itself; a `sym()` here would add two more full passes over the
    (B, n, n) matrix."""
    AtWA = jnp.einsum("...ki,...k,...kj->...ij", qp.A, rho_row, qp.A)
    return add_scaled_identity(qp.P + AtWA, sigma)


def cholesky_init(qp: QP, rho, sigma, settings: Settings):
    rho_row = jnp.broadcast_to(rho_rows(qp, rho, settings),
                               qp.batch_shape + (qp.m,))
    with jax.named_scope("factor"):
        return _cholesky_factor(qp, rho_row, sigma, settings)


def _cholesky_factor(qp: QP, rho_row, sigma, settings: Settings):
    # The factor path may run at a lower matmul precision than the rest of
    # the solve (Settings.factor_precision): M^{-1} only needs to be a good
    # preconditioner when refinement is on, and the refinement residual is
    # evaluated against the true M at the solve's precision.
    prec = settings.factor_precision or settings.matmul_precision
    with jax.default_matmul_precision(prec):
        M = _build_normal_matrix(qp, rho_row, sigma)
        if settings.sigma_free_rhs:
            # Only M^{-1}[A' q] is ever needed: the sigma-free x-update is
            # xx = G(rho z - y) - g. Solve for both column blocks in one
            # Cholesky multi-RHS solve without materializing M^{-1}.
            At = jnp.broadcast_to(jnp.swapaxes(qp.A, -1, -2),
                                  qp.batch_shape + (qp.n, qp.m))
            R = jnp.concatenate([At, qp.q[..., :, None]], axis=-1)
            X = spd_solve(M, R)
            # G stays (n, m) — the consumers contract its last axis directly
            # (dot_general ((1,), (1,))), so no transpose is materialized.
            return {"G": X[..., :, : qp.m], "g": X[..., :, qp.m]}
        return {"M_inv": spd_inverse(M)}


def cholesky_refactor(cache, qp: QP, rho, sigma, settings: Settings):
    return cholesky_init(qp, rho, sigma, settings)


def cholesky_solve(cache, qp: QP, x, z, y, rho, settings: Settings):
    sigma = jnp.asarray(settings.sigma_for(qp.dtype), qp.dtype)
    rho_row = rho_rows(qp, rho, settings)
    if settings.sigma_free_rhs:
        G, g = cache["G"], cache["g"]
        t = rho_row * z - y
        xx = jnp.einsum("...k,...nk->...n", t, G) - g
        return xx, qp.matvec_A(xx), cache
    b = _normal_rhs(qp, x, z, y, rho_row, sigma)
    M_inv = cache["M_inv"]
    xx = matvec(M_inv, b)
    for _ in range(settings.kkt_refinement_steps):
        r = b - _apply_normal(qp, rho_row, sigma, xx)
        xx = xx + matvec(M_inv, r)
    zz = qp.matvec_A(xx)
    return xx, zz, cache


# --------------------------------------------------------------------------
# Quasi-definite KKT LDL' backend (the OSQP-paper factorization)
# --------------------------------------------------------------------------
#
# Factors the 2x2 quasi-definite KKT matrix
#     K = [[P + sigma*I, A'], [A, -I/rho]]
# as L D L' with unit-lower L and signed diagonal D — no pivoting needed for
# quasi-definite matrices (the property QDLDL relies on; reference backends
# QDLdl!/LaLdl!/FacLdl!, LinearSystemSolvers.jl:16-107). Batched over lanes;
# the factorization is a lax.scan over columns (a rare event under the rho
# hysteresis), the per-iteration solve is two batched triangular solves.
# The default CHOLESKY backend is the fast path for fleets; this one exists
# for parity with the reference's direct KKT path and as the delta-accurate option when
# the normal equations' squared conditioning bites.


def _build_kkt_matrix(qp: QP, rho_row, sigma):
    n, m = qp.n, qp.m
    dt = qp.dtype
    batch = qp.batch_shape
    At = jnp.swapaxes(qp.A, -1, -2)
    Pn = add_scaled_identity(sym(qp.P), sigma)
    top = jnp.concatenate([Pn, jnp.broadcast_to(At, batch + (n, m))], axis=-1)
    neg = (-1.0 / rho_row)[..., None] * jnp.eye(m, dtype=dt)
    bot = jnp.concatenate(
        [jnp.broadcast_to(qp.A, batch + (m, n)),
         jnp.broadcast_to(neg, batch + (m, m))], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _ldl_factor(K):
    """Batched dense LDL' without pivoting: K (*B, N, N) -> (L unit-lower, d)."""
    N = K.shape[-1]
    idx = jnp.arange(N)

    def step(W, j):
        dj = W[..., j, j]
        below = (idx > j).astype(K.dtype)
        c = W[..., :, j] * below
        lcol = c / dj[..., None]
        W = W - lcol[..., :, None] * c[..., None, :]
        return W, (lcol, dj)

    _, (cols, ds) = jax.lax.scan(step, K, idx)
    L = jnp.moveaxis(cols, 0, -1)  # (*B, N, N), column j in last axis
    L = L + jnp.eye(N, dtype=K.dtype)
    d = jnp.moveaxis(ds, 0, -1)    # (*B, N)
    return L, d


def _ldl_apply_kkt(qp: QP, rho_row, sigma, v):
    """K @ v for the refinement residual, matrix-free."""
    n = qp.n
    v1, v2 = v[..., :n], v[..., n:]
    top = qp.matvec_P(v1) + sigma * v1 + qp.matvec_At(v2)
    bot = qp.matvec_A(v1) - v2 / rho_row
    return jnp.concatenate([top, bot], axis=-1)


def kkt_ldl_init(qp: QP, rho, sigma, settings: Settings):
    rho_row = jnp.broadcast_to(rho_rows(qp, rho, settings),
                               qp.batch_shape + (qp.m,))
    L, d = _ldl_factor(_build_kkt_matrix(qp, rho_row, sigma))
    return {"L": L, "d": d}


def kkt_ldl_refactor(cache, qp: QP, rho, sigma, settings: Settings):
    return kkt_ldl_init(qp, rho, sigma, settings)


def _ldl_solve_vec(cache, b):
    from jax.scipy.linalg import solve_triangular

    L, d = cache["L"], cache["d"]
    w = solve_triangular(L, b[..., None], lower=True, unit_diagonal=True)[..., 0]
    w = w / d
    v = solve_triangular(
        jnp.swapaxes(L, -1, -2), w[..., None], lower=False, unit_diagonal=True)[..., 0]
    return v


def kkt_ldl_solve(cache, qp: QP, x, z, y, rho, settings: Settings):
    """Direct-path solve exactly as the reference (jl:205-210): solve the
    full KKT, then zz = z + (v2 - y)/rho (per-row rho generalization)."""
    dt = qp.dtype
    sigma = jnp.asarray(settings.sigma_for(dt), dt)
    rho_row = rho_rows(qp, rho, settings)
    rhs = jnp.concatenate([sigma * x - qp.q, z - y / rho_row], axis=-1)
    v = _ldl_solve_vec(cache, rhs)
    for _ in range(settings.kkt_refinement_steps):
        v = v + _ldl_solve_vec(cache, rhs - _ldl_apply_kkt(qp, rho_row, sigma, v))
    xx = v[..., : qp.n]
    zz = z + (v[..., qp.n:] - y) / rho_row
    return xx, zz, cache


# --------------------------------------------------------------------------
# Quasi-definite MINRES backend (iterative path on the 2x2 KKT)
# --------------------------------------------------------------------------
#
# The CG backend iterates on the normal matrix P + sigma*I + rho*A'A, whose
# condition number is the SQUARE of the KKT system's — on ill-conditioned
# families (portfolio, huber) the iteration count explodes. The reference
# explores exactly this alternative: Krylov methods on the indefinite-but-
# symmetric quasi-definite KKT with a block preconditioner built from
# P + sigma*I (`/root/reference/LinearSystemSolversFun.jl:191-234`, TriCG /
# TriMR with opCholesky(P+sigma*I)). Re-designed as batched MINRES under
# `lax.while_loop` with per-lane masking, preconditioned by the SPD
# block-diagonal [ (P+sigma*I)^{-1}, diag(rho_row) ].
#
# The dense preconditioner caches (P+sigma*I)^{-1} once: it is
# rho-INDEPENDENT, so adaptive-rho refactor events are free (vs the Cholesky
# backend's full rebuild). Sparse problems use the Jacobi diagonal instead.


def kkt_minres_init(qp, rho, sigma, settings: Settings):
    batch = qp.batch_shape
    cache = {"v": jnp.zeros(batch + (qp.n + qp.m,), qp.dtype)}
    if qp.is_dense:
        cache["P_inv"] = spd_inverse(add_scaled_identity(sym(qp.P), sigma))
        if qp.P.ndim == 2 and batch:
            cache["P_inv"] = jnp.broadcast_to(
                cache["P_inv"], batch + (qp.n, qp.n))
    else:
        cache["d1_inv"] = 1.0 / (qp.diag_P() + sigma)
    return cache


def kkt_minres_refactor(cache, qp, rho, sigma, settings: Settings):
    # The preconditioner depends only on P and sigma — rho drift is free.
    return cache


def _kkt_precond(cache, qp, rho_row):
    """Apply the SPD block-diagonal preconditioner inverse."""
    n = qp.n

    def apply(v):
        v1, v2 = v[..., :n], v[..., n:]
        if "P_inv" in cache:
            u1 = matvec(cache["P_inv"], v1)
        else:
            u1 = cache["d1_inv"] * v1
        return jnp.concatenate([u1, rho_row * v2], axis=-1)

    return apply


def kkt_minres_solve(cache, qp, x, z, y, rho, settings: Settings):
    sigma = jnp.asarray(settings.sigma_for(qp.dtype), qp.dtype)
    rho_row = rho_rows(qp, rho, settings)
    rhs = jnp.concatenate([sigma * x - qp.q, z - y / rho_row], axis=-1)
    v = _minres(
        lambda w: _ldl_apply_kkt(qp, rho_row, sigma, w),
        _kkt_precond(cache, qp, rho_row),
        rhs,
        cache["v"],
        abs_tol=settings.cg_eps,
        max_iterations=settings.cg_max_iterations,
    )
    xx = v[..., : qp.n]
    zz = z + (v[..., qp.n:] - y) / rho_row
    return xx, zz, {**cache, "v": v}


def _minres(apply_K, precond, b, x0, abs_tol: float, max_iterations: int,
            vdot=None, rel_tol: float = 0.0):
    """Batched preconditioned MINRES (Paige & Saunders) with lane masking.

    Solves K v = b for symmetric (indefinite) K with SPD preconditioner M;
    ``phibar`` tracks the M^{-1}-norm of the residual, and lanes stop when it
    falls under max(abs_tol, 10 ulp of ||b||) — the same floor as `_pcg` so
    f32 lanes terminate. Lanczos breakdown (beta -> 0: exact solution found)
    also stops the lane; all divisions are guarded so frozen lanes stay
    finite.

    ``vdot(a, b) -> (*batch,)`` overrides the inner product — a distributed
    caller (parallel/consensus.py polish) passes a psum-reducing dot over its
    row-sharded vector segment so every shard sees the global Lanczos
    scalars and iterates bitwise-identically.
    """
    if vdot is None:
        vdot = lambda a, c: jnp.sum(a * c, axis=-1)
    dtype = b.dtype
    eps = jnp.finfo(dtype).eps
    b_norm = jnp.sqrt(jnp.maximum(vdot(b, b), 0.0))
    tol = jnp.maximum(jnp.asarray(abs_tol, dtype),
                      jnp.maximum(rel_tol, 10 * eps) * b_norm)

    r1 = b - apply_K(x0)
    y0 = precond(r1)
    beta1 = jnp.sqrt(jnp.maximum(vdot(r1, y0), 0.0))
    zeros_like_b = jnp.zeros_like(b)

    def guard(d):
        return jnp.where(d == 0, 1.0, d)

    # carry: it, x, r1, r2, y, oldb, beta, dbar, epsln, phibar, cs, sn,
    #        w, w2, done
    init = (jnp.zeros((), jnp.int32), x0, r1, r1, y0,
            jnp.zeros_like(beta1), beta1,
            jnp.zeros_like(beta1), jnp.zeros_like(beta1), beta1,
            -jnp.ones_like(beta1), jnp.zeros_like(beta1),
            zeros_like_b, zeros_like_b,
            beta1 <= tol)

    def cond(c):
        return (c[0] < max_iterations) & ~jnp.all(c[-1])

    def body(c):
        (it, xk, r1k, r2k, yk, oldb, beta, dbar, epsln, phibar,
         cs, sn, w, w2, done) = c
        v = yk / guard(beta)[..., None]
        yn = apply_K(v)
        coef = jnp.where(it >= 1, beta / guard(oldb), 0.0)
        yn = yn - coef[..., None] * r1k
        alfa = vdot(v, yn)
        yn = yn - (alfa / guard(beta))[..., None] * r2k
        r1n, r2n = r2k, yn
        yn = precond(r2n)
        oldb_n = beta
        beta_n = jnp.sqrt(jnp.maximum(vdot(r2n, yn), 0.0))
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln_n = sn * beta_n
        dbar_n = -cs * beta_n
        gamma = jnp.maximum(jnp.sqrt(gbar**2 + beta_n**2), eps)
        cs_n = gbar / gamma
        sn_n = beta_n / gamma
        phi = cs_n * phibar
        phibar_n = sn_n * phibar
        w1 = w2
        w2_n = w
        w_n = (v - oldeps[..., None] * w1 - delta[..., None] * w2_n) \
            / gamma[..., None]
        xk = xk + jnp.where(done, 0.0, phi)[..., None] * w_n
        done_n = done | (phibar_n <= tol) | (beta_n <= eps * beta1)
        return (it + 1, xk, r1n, r2n, yn, oldb_n, beta_n, dbar_n, epsln_n,
                phibar_n, cs_n, sn_n, w_n, w2_n, done_n)

    out = jax.lax.while_loop(cond, body, init)
    return out[1]


# --------------------------------------------------------------------------
# Matrix-free PCG backend (iterative path)
# --------------------------------------------------------------------------

def _jacobi_diag_inv(qp, rho, sigma, settings: Settings):
    w = row_weights(qp, settings)
    if w is None:
        d = qp.diag_P() + sigma + rho[..., None] * qp.diag_AtA()
    else:
        d = qp.diag_P() + sigma + rho[..., None] * qp.diag_AtWA(w)
    return jnp.where(d > 0, 1.0 / d, 1.0)


def cg_init(qp, rho, sigma, settings: Settings):
    batch = qp.batch_shape
    return {
        "diag_inv": _jacobi_diag_inv(qp, rho, sigma, settings),
        # Warm start from the previous iteration's solution — the reference's
        # CG backends reuse vXX across iterations the same way
        # (LinearSystemSolvers.jl:135, cg! mutates the previous iterate).
        "xx": jnp.zeros(batch + (qp.n,), qp.dtype),
    }


def cg_refactor(cache, qp, rho, sigma, settings: Settings):
    return {"diag_inv": _jacobi_diag_inv(qp, rho, sigma, settings),
            "xx": cache["xx"]}


def cg_solve(cache, qp, x, z, y, rho, settings: Settings):
    sigma = jnp.asarray(settings.sigma_for(qp.dtype), qp.dtype)
    rho_row = rho_rows(qp, rho, settings)
    b = _normal_rhs(qp, x, z, y, rho_row, sigma)
    xx = _pcg(
        lambda v: _apply_normal(qp, rho_row, sigma, v),
        b,
        cache["xx"],
        cache["diag_inv"],
        abs_tol=settings.cg_eps,
        max_iterations=settings.cg_max_iterations,
        rel_tol=settings.cg_rel_eps,
    )
    zz = qp.matvec_A(xx)
    return xx, zz, {**cache, "xx": xx}


def _pcg(apply_M, b, x0, diag_inv, abs_tol: float, max_iterations: int,
         rel_tol: float = 0.0):
    """Batched Jacobi-preconditioned CG with per-lane convergence masking.

    The tolerance floors at ~10 ulps of ||b|| so float32 lanes terminate
    instead of stalling at the reference's f64-era abstol (m:102, 1e-9).

    ``rel_tol`` > 0 additionally stops at rel_tol * ||r0|| (inexact-ADMM
    forcing term): with the warm-started xx carry, ||r0|| contracts as the
    outer iteration converges, so the inner accuracy tightens automatically
    — early outer iterations stop wasting Krylov steps polishing a KKT
    solve whose rhs is still far from the fixed point.
    """
    dtype = b.dtype
    eps = jnp.finfo(dtype).eps
    b_norm = jnp.linalg.norm(b, axis=-1)
    tol2 = jnp.maximum(jnp.asarray(abs_tol, dtype), 10 * eps * b_norm) ** 2

    r0 = b - apply_M(x0)
    if rel_tol > 0.0:
        r0n2 = jnp.sum(r0 * r0, axis=-1)
        tol2 = jnp.maximum(tol2, jnp.asarray(rel_tol, dtype) ** 2 * r0n2)
    z0 = diag_inv * r0
    p0 = z0
    rz0 = jnp.sum(r0 * z0, axis=-1)
    done0 = jnp.sum(r0 * r0, axis=-1) <= tol2

    def cond(carry):
        it, _, _, _, _, done = carry
        return (it < max_iterations) & ~jnp.all(done)

    def body(carry):
        it, xk, rk, pk, rzk, done = carry
        Ap = apply_M(pk)
        pAp = jnp.sum(pk * Ap, axis=-1)
        alpha = jnp.where(done | (pAp <= 0), 0.0, rzk / jnp.where(pAp == 0, 1.0, pAp))
        xk = xk + alpha[..., None] * pk
        rk = rk - alpha[..., None] * Ap
        zk = diag_inv * rk
        rzk1 = jnp.sum(rk * zk, axis=-1)
        beta = jnp.where(done | (rzk == 0), 0.0, rzk1 / jnp.where(rzk == 0, 1.0, rzk))
        pk = zk + beta[..., None] * pk
        done = done | (jnp.sum(rk * rk, axis=-1) <= tol2)
        return it + 1, xk, rk, pk, rzk1, done

    _, x, _, _, _, _ = jax.lax.while_loop(cond, body, (0, x0, r0, p0, rz0, done0))
    return x


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Backend:
    init: Any
    refactor: Any
    solve: Any
    #: True when refactor is O(n) or free (iterative backends): the solver
    #: then calls it unconditionally each chunk instead of under `lax.cond`,
    #: which for a cheap refactor would only add a branch to the loop.
    cheap_refactor: bool = False


BACKENDS = {
    KKTBackendKind.CHOLESKY: Backend(cholesky_init, cholesky_refactor, cholesky_solve),
    KKTBackendKind.KKT_LDL: Backend(kkt_ldl_init, kkt_ldl_refactor, kkt_ldl_solve),
    KKTBackendKind.CG: Backend(cg_init, cg_refactor, cg_solve,
                               cheap_refactor=True),
    KKTBackendKind.KKT_MINRES: Backend(
        kkt_minres_init, kkt_minres_refactor, kkt_minres_solve,
        cheap_refactor=True),
}


def get_backend(kind: KKTBackendKind, qp: QP) -> Backend:
    kind = resolve_backend(kind, qp)
    if kind not in BACKENDS:
        raise NotImplementedError(f"KKT backend {kind} not implemented yet")
    return BACKENDS[kind]
