"""Batched OSQP-style ADMM solver — the framework's flagship model.

Solves (fleets of) box-constrained QPs

    min 0.5 x'Px + q'x   s.t.   l <= Ax <= u

with the operator-splitting iteration of the reference
(`/root/reference/SolveQuadraticProgram.jl:45-71`, `SolveQuadraticProgram.m:233-287`):

    (xx, zz) <- KKT solve                 (pluggable backend, kkt.py)
    x <- alpha*xx + (1-alpha)*x           (relaxation)
    z <- clip(alpha*zz + (1-alpha)*z + y/rho, l, u)
    y <- y + rho*(alpha*zz + (1-alpha)*z_prev - z)

with adaptive rho (sqrt residual-ratio rule, clipped to [1e-3, 1e6], 5x
refactor hysteresis — jl:47-52, :91-96) and the dual termination test
(primal+dual residuals, or the ADMM fixed point — jl:98-107).

Accelerator-first structure (not a port):
* **Whole-fleet batching.** Every array carries leading batch axes; the hot
  loop is one XLA program of batched matmuls over thousands of QPs. The
  reference's per-problem early ``break`` (jl:66-68) becomes per-lane status
  masking: converged lanes freeze while the `lax.while_loop` runs until all
  lanes finish or the budget is exhausted.
* **Chunked checking.** The loop is `while_loop(num_chunks){ refactor?;
  fori_loop(check_interval){ step }; check }` — residuals are evaluated every
  `check_interval` iterations exactly like the reference (jl:63), and the
  check cadence doubles as the rho-refactor boundary. (rho candidates only
  change at checks, so checking hysteresis per-chunk is *exactly* the
  reference's per-iteration check.)
* **No data-dependent shapes.** max_iterations rounds up to a whole number
  of chunks; rho is a per-lane vector baked into the batched factorization.
"""

from __future__ import annotations

import dataclasses
from dataclasses import replace as dataclasses_replace

import jax
import jax.numpy as jnp
import numpy as np

from ..core.problem import QP
from ..core.pytree import pytree_dataclass as _pytree_dataclass
from ..core.settings import RHO_MAX, RHO_MIN, Settings
from ..core.state import SolveInfo, Solution, SolverState, Status
from ..ops.linalg import inf_norm
from . import anderson as anderson_mod
from . import kkt as kkt_mod
from .polish import polish as polish_fn


def _init_state(qp: QP, settings: Settings, x0, backend, z0=None, y0=None,
                rho0=None, aa0=None, prepared=None) -> SolverState:
    batch = qp.batch_shape
    dt = qp.dtype
    # lane0: per-lane zeros DERIVED from the problem data, so that under
    # shard_map (a caller wrapping the solve to localize the convergence
    # predicate, e.g. benchmarks/weak_scaling.py --ablate) every per-lane
    # state leaf inherits the shard axis's varying type — a plain
    # jnp.zeros(batch) is axis-invariant and the while-loop carry would
    # type-mismatch against its varying updates. Outside shard_map this is
    # just zeros (q is finite by contract).
    lane0 = jnp.sum(qp.q * 0, axis=-1)
    x = (lane0[..., None] + jnp.zeros(batch + (qp.n,), dt) if x0 is None
         else jnp.asarray(x0, dt))
    if prepared is not None:
        # Factor-reuse path (models/admm.prepare): adopt the prepared cache
        # and ITS rho — the factor is only valid for the rho it was built
        # at. q-dependent cache pieces are refreshed here (one matvec).
        rho = lane0 + jnp.broadcast_to(jnp.asarray(prepared.rho, dt), batch)
        cache = prepared.materialize(qp)
    else:
        rho = lane0 + (jnp.full(batch, settings.rho, dt) if rho0 is None
                       else jnp.broadcast_to(jnp.asarray(rho0, dt), batch))
        sigma = jnp.asarray(settings.sigma_for(dt), dt)
        cache = backend.init(qp, rho, sigma, settings)
    history = None
    if settings.record_history:
        buf = lambda: lane0 + jnp.full((settings.num_checks,) + batch,
                                       jnp.inf, dt)
        history = {"res_prim": buf(), "res_dual": buf(), "rho": buf()}
    z = (lane0[..., None] + jnp.zeros(batch + (qp.m,), dt) if z0 is None
         else jnp.asarray(z0, dt))
    y = (lane0[..., None] + jnp.zeros(batch + (qp.m,), dt) if y0 is None
         else jnp.asarray(y0, dt))
    products = None
    if settings.check_infeasibility:
        # Products at the start iterate, so the first check's certificate
        # deltas (P dx = Px - Px_prev etc.) have a correct base point.
        products = {"Px": qp.matvec_P(x), "Ax": qp.matvec_A(x),
                    "ATy": qp.matvec_At(y)}
    aa = None
    if settings.anderson_memory > 0:
        aa = aa0 if aa0 is not None else anderson_mod.init_aa(qp, settings)
    lane0_i = lane0.astype(jnp.int32)
    return SolverState(
        x=x,
        z=z,
        y=y,
        rho=rho,
        rho_cand=rho,
        status=lane0_i + jnp.zeros(batch, jnp.int32),
        iterations=lane0_i + jnp.zeros(batch, jnp.int32),
        res_prim=lane0 + jnp.full(batch, jnp.inf, dt),
        res_dual=lane0 + jnp.full(batch, jnp.inf, dt),
        iteration=jnp.zeros((), jnp.int32),
        kkt_cache=cache,
        history=history,
        products=products,
        aa=aa,
    )


@_pytree_dataclass
@dataclasses.dataclass(frozen=True)
class PreparedFactor:
    """A KKT factorization prepared once for repeated solves (factor reuse).

    The reference's ProxQP separates construction (factor once,
    `/root/reference/ProxQP.jl:73-115`) from solving (`:118-173` reuses the
    Cholesky across calls), and real OSQP's API is setup -> update_lin_cost /
    update_bounds -> solve. This is that contract for the box-form family:
    :func:`prepare` factors the KKT system for (P, A, rho) once; passing the
    result to :func:`solve` skips the per-solve factor entirely — the
    dominant cost of short warm-started solves — while q, l, u may change
    freely between calls.

    Validity contract: P, A, the batch shape, and the settings' rho
    structure (rho_eq_scale) must match the prepare-time problem; q/l/u are
    free. The solve adopts ``rho`` (the factor is only valid at its own
    rho); with ``adaptive_rho`` on, a lane whose rho then drifts refactors
    in-loop as usual — reuse pays until the first drift, so the typical
    prepared workload pins rho (MPC fleets with a tuned static penalty).

    ``M_inv`` is carried only on the sigma-free path, where the cached
    ``g = M^{-1} q`` is q-dependent: :meth:`materialize` refreshes it with
    one batched matvec per solve (G = M^{-1}A' is q-independent).
    """

    cache: object            # backend cache pytree (q-independent pieces)
    rho: jax.Array           # (*B,) penalty the factor was built at
    M_inv: object = None     # (*B, n, n) only when sigma_free_rhs

    def materialize(self, qp: QP):
        """Per-solve cache: refresh the q-dependent pieces (if any)."""
        if self.M_inv is not None:
            from ..ops.linalg import matvec

            return {"G": self.cache["G"], "g": matvec(self.M_inv, qp.q)}
        return self.cache


def prepare(qp: QP, settings: Settings = Settings(),
            rho0=None) -> PreparedFactor:
    """Factor the KKT system once for repeated :func:`solve` calls.

    Jittable. See :class:`PreparedFactor` for the reuse contract. For the
    dense CHOLESKY backend with ``sigma_free_rhs`` the factor additionally
    materializes M^{-1} (so each solve can refresh g for its own q); the
    plain path's cache (M^{-1}, or L/d, or the CG diagonal) is q-independent
    as-is.
    """
    if settings.scaling_iters > 0:
        raise ValueError(
            "prepare() with scaling_iters is unsupported: equilibration "
            "rescales P/A per solve, invalidating the factor; pre-scale "
            "the problem once instead")
    backend = kkt_mod.get_backend(settings.kkt_backend, qp)
    dt = qp.dtype
    batch = qp.batch_shape
    rho = (jnp.full(batch, settings.rho, dt) if rho0 is None
           else jnp.broadcast_to(jnp.asarray(rho0, dt), batch))
    sigma = jnp.asarray(settings.sigma_for(dt), dt)
    kind = kkt_mod.resolve_backend(settings.kkt_backend, qp)
    with jax.default_matmul_precision(settings.matmul_precision):
        if kind is kkt_mod.KKTBackendKind.CHOLESKY and settings.sigma_free_rhs:
            from ..ops.linalg import spd_inverse

            prec = settings.factor_precision or settings.matmul_precision
            with jax.default_matmul_precision(prec):
                rho_row = jnp.broadcast_to(
                    kkt_mod.rho_rows(qp, rho, settings), batch + (qp.m,))
                M_inv = spd_inverse(
                    kkt_mod._build_normal_matrix(qp, rho_row, sigma))
                # G = M^{-1} A' as (n, m) — same layout cholesky_init emits.
                G = jnp.einsum("...ij,...kj->...ik", M_inv, qp.A)
            return PreparedFactor(cache={"G": G}, rho=rho, M_inv=M_inv)
        cache = backend.init(qp, rho, sigma, settings)
        return PreparedFactor(cache=cache, rho=rho)


prepare_jit = jax.jit(prepare, static_argnames=("settings",))


def _run_chunk(qp: QP, settings: Settings, backend, state: SolverState):
    """check_interval masked ADMM iterations -> (x, z, y, xp, zp, cache)."""
    rho_row = jnp.broadcast_to(
        kkt_mod.rho_rows(qp, state.rho, settings),
        qp.batch_shape + (qp.m,))
    dt = qp.dtype
    alpha = jnp.asarray(settings.alpha, dt)
    alpha1 = jnp.asarray(1.0 - settings.alpha, dt)
    active = (state.status == Status.RUNNING)[..., None]
    rho = state.rho

    def step(_, carry):
        x, z, y, _, _, cache = carry
        xx, zz, cache = backend.solve(cache, qp, x, z, y, rho, settings)
        xp, zp = x, z
        x_new = alpha * xx + alpha1 * xp
        z_new = jnp.clip(alpha * zz + alpha1 * zp + y / rho_row, qp.l, qp.u)
        y_new = y + rho_row * (alpha * zz + alpha1 * zp - z_new)
        # Converged lanes freeze (replaces the reference's early break, jl:66-68).
        x = jnp.where(active, x_new, xp)
        z = jnp.where(active, z_new, zp)
        y = jnp.where(active, y_new, y)
        return x, z, y, xp, zp, cache

    init = (state.x, state.z, state.y, state.x, state.z, state.kkt_cache)
    with jax.named_scope("chunk"):
        return jax.lax.fori_loop(0, settings.check_interval, step, init)


def _infeasibility_certificates(qp: QP, settings: Settings, dx, dy,
                                Pdx, Adx, ATdy):
    """OSQP §3.4 iterate-difference infeasibility certificates.

    Primal infeasible: A'dy ~ 0 and u'(dy)+ + l'(dy)- < 0 (Farkas direction
    in the duals). Dual infeasible (primal unbounded): P dx ~ 0, q'dx < 0,
    and A dx compatible with the finite bounds. Infinite bounds require the
    corresponding certificate component to vanish. dx/dy here are the
    per-chunk iterate differences (any nonzero multiple certifies);
    Pdx/Adx/ATdy are their matvec products, formed by the caller as deltas
    of cached per-check products (linearity: P dx = Px - Px_prev) rather
    than three fresh matvecs. The f32 cancellation error in a delta is
    ~eps*|Px|, far below the certificate thresholds on genuinely divergent
    iterates (and the noise gates below reject near-converged lanes anyway).
    """
    dt = qp.dtype
    eps_p = jnp.asarray(settings.eps_prim_inf, dt)
    eps_d = jnp.asarray(settings.eps_dual_inf, dt)

    # --- primal infeasibility from dy ---
    ndy = inf_norm(dy)
    pos = jnp.maximum(dy, 0.0)
    neg = jnp.minimum(dy, 0.0)
    tol = (eps_p * ndy)[..., None]
    term_u = jnp.where(
        jnp.isfinite(qp.u), qp.u * pos, jnp.where(pos > tol, jnp.inf, 0.0))
    term_l = jnp.where(
        jnp.isfinite(qp.l), qp.l * neg, jnp.where(neg < -tol, jnp.inf, 0.0))
    support = jnp.sum(term_u + term_l, axis=-1)
    prim_inf = (
        (ndy > 0)
        & (inf_norm(ATdy) <= eps_p * ndy)
        & (support <= -eps_p * ndy)
    )

    # --- dual infeasibility from dx ---
    ndx = inf_norm(dx)
    tol_d = (eps_d * ndx)[..., None]
    fin_l = jnp.isfinite(qp.l)
    fin_u = jnp.isfinite(qp.u)
    ok_rows = jnp.where(
        fin_l & fin_u, jnp.abs(Adx) <= tol_d,
        jnp.where(fin_l, Adx >= -tol_d,            # u = +inf
                  jnp.where(fin_u, Adx <= tol_d,   # l = -inf
                            True)))
    dual_inf = (
        (ndx > 0)
        & (inf_norm(Pdx) <= eps_d * ndx)
        & (jnp.sum(qp.q * dx, axis=-1) <= -eps_d * ndx)
        & jnp.all(ok_rows, axis=-1)
    )
    return prim_inf, dual_inf


@jax.named_scope("check")
def _check_convergence(qp: QP, settings: Settings, state: SolverState, x, z, y, xp, zp,
                       term_scale=None, chunk_prods=None, aa_accept=None):
    """Residuals, adaptive-rho candidate, and termination flags.

    Math follows `CheckConvergence` (SolveQuadraticProgram.jl:79-112),
    including its flag precedence: when both the primal/dual test and the
    ADMM fixed-point test pass in the same check, the fixed-point flag wins
    (jl:102-107 assigns convPrimDual then overwrites with convAdmm).

    When ``term_scale`` (a ScalingData from Ruiz equilibration) is given,
    every residual/norm is mapped back to the **unscaled** problem before the
    tests — OSQP's own termination discipline. With P' = cDPD, A' = EAD,
    x = Dx', y = Ey'/c the unscaled residual vectors are
    E^{-1}(A'x' - z') and D^{-1}(P'x' + q' + A''y')/c.
    """
    dt = qp.dtype
    if chunk_prods is None:
        Ax = qp.matvec_A(x)
        ATy = qp.matvec_At(y)
        Px = qp.matvec_P(x)
    else:                        # selected by the Anderson step
        Ax, ATy, Px = chunk_prods

    if term_scale is None:
        unsc_p = unsc_d = lambda v: v          # already unscaled
        unsc_x = lambda v: v
    else:
        e_inv = 1.0 / term_scale.e
        dc_inv = 1.0 / (term_scale.d * term_scale.c[..., None])
        unsc_p = lambda v: v * e_inv           # row-space (primal) vectors
        unsc_d = lambda v: v * dc_inv          # variable-space (dual) vectors
        unsc_x = lambda v: v * term_scale.d    # primal iterate deltas

    res_prim = inf_norm(unsc_p(Ax - z))
    res_dual = inf_norm(unsc_d(Px + qp.q + ATy))
    max_prim = jnp.maximum(inf_norm(unsc_p(Ax)), inf_norm(unsc_p(z)))
    max_dual = jnp.maximum(
        jnp.maximum(inf_norm(unsc_d(Px)), inf_norm(unsc_d(ATy))),
        inf_norm(unsc_d(qp.q)))

    active = state.status == Status.RUNNING

    rho_cand = state.rho_cand
    if settings.adaptive_rho:
        # rho adapts on residuals of the space the ITERATION runs in — the
        # scaled space when Ruiz scaling is on (OSQP's discipline: terminate
        # unscaled, adapt scaled). Feeding unscaled ratios to a scaled
        # iteration drives rho to values wrong for the scaled problem; on the
        # huber family this stalls lanes for the full budget (f32 AND f64)
        # that otherwise converge in ~50 iterations.
        if term_scale is None:
            rp_s, rd_s, mp_s, md_s = res_prim, res_dual, max_prim, max_dual
        else:
            rp_s = inf_norm(Ax - z)
            rd_s = inf_norm(Px + qp.q + ATy)
            mp_s = jnp.maximum(inf_norm(Ax), inf_norm(z))
            md_s = jnp.maximum(
                jnp.maximum(inf_norm(Px), inf_norm(ATy)), inf_norm(qp.q))
        num = rp_s * md_s
        den = rd_s * mp_s
        ratio = jnp.sqrt(num / jnp.where(den == 0, 1.0, den))
        cand = jnp.clip(state.rho * ratio, RHO_MIN, RHO_MAX)
        ok = jnp.isfinite(cand) & (den != 0) & (cand > 0)
        rho_cand = jnp.where(active & ok, cand.astype(dt), rho_cand)

    eps_prim = settings.eps_abs + settings.eps_rel * max_prim
    eps_dual = settings.eps_abs + settings.eps_rel * max_dual
    solved = (res_prim < eps_prim) & (res_dual < eps_dual)
    # Fixed-point threshold with a dtype-aware relative floor: the reference's
    # absolute eps_admm (min(eps)*1e-2, jl:34) can sit below f32 iterate
    # noise, leaving lanes jittering forever (seen on the huber family);
    # 8 ulps of the iterate scale is invisible in f64 and the honest floor
    # in f32.
    ulp = jnp.asarray(8 * jnp.finfo(dt).eps, dt)
    eps_admm = jnp.asarray(settings.eps_admm, dt)
    eps_x = eps_admm + ulp * jnp.maximum(inf_norm(unsc_x(x)), 1.0)
    eps_z = eps_admm + ulp * jnp.maximum(inf_norm(unsc_p(z)), 1.0)
    admm_fp = (inf_norm(unsc_x(x - xp)) <= eps_x) & (inf_norm(unsc_p(z - zp)) <= eps_z)
    if aa_accept is not None:
        # Lanes that took an Anderson step this check compare x against the
        # plain chunk's penultimate iterate — a different map's point — so
        # the fixed-point test is meaningless (and could fire spuriously).
        admm_fp &= ~aa_accept

    status = state.status
    status = jnp.where(active & solved, Status.SOLVED, status)
    status = jnp.where(active & admm_fp, Status.SOLVED_ADMM, status)  # jl:105-107 precedence
    if settings.check_infeasibility:
        # (Certificates are evaluated in the solve space — scaled when Ruiz
        # scaling is on. Infeasibility is invariant under diagonal scaling,
        # so a certificate for the scaled problem certifies the original;
        # only the detection thresholds see scaled magnitudes.)
        # Per-chunk iterate differences serve as certificate candidates. A
        # certificate outranks the x/z fixed-point flag: on infeasible
        # problems x and z stall exactly while y diverges, which the
        # reference's flag-2 test misreads as convergence. True primal+dual
        # convergence (SOLVED) still wins — residuals cannot pass on an
        # infeasible problem.
        dx = x - state.x
        dy = y - state.y
        # Delta products by linearity against the products cached at the
        # previous check (state.x/state.y are exactly that iterate).
        prev = state.products
        prim_inf, dual_inf = _infeasibility_certificates(
            qp, settings, dx, dy,
            Px - prev["Px"], Ax - prev["Ax"], ATy - prev["ATy"])
        # Anti-false-positive gates: near convergence the chunk deltas are
        # numerical noise, and on problems with near-degenerate rows noise
        # can satisfy the Farkas conditions. Require (a) the lane to be far
        # from its convergence threshold and (b) deltas above the iterate
        # noise floor. Genuinely infeasible/unbounded problems keep large
        # residuals and structured deltas, so the gates cost nothing there.
        noise = 16 * jnp.finfo(dt).eps
        prim_inf &= (res_prim > 10 * eps_prim) & (
            inf_norm(dy) > noise * jnp.maximum(inf_norm(y), 1.0))
        dual_inf &= (res_dual > 10 * eps_dual) & (
            inf_norm(dx) > noise * jnp.maximum(inf_norm(x), 1.0))
        overridable = active & (status != Status.SOLVED)
        status = jnp.where(overridable & prim_inf, Status.PRIMAL_INFEASIBLE, status)
        status = jnp.where(overridable & dual_inf & ~prim_inf,
                           Status.DUAL_INFEASIBLE, status)
    newly_done = active & (status != Status.RUNNING)
    iteration = state.iteration + settings.check_interval
    iterations = jnp.where(newly_done, iteration, state.iterations)
    history = state.history
    if settings.record_history:
        idx = state.iteration // settings.check_interval
        history = {
            "res_prim": history["res_prim"].at[idx].set(res_prim),
            "res_dual": history["res_dual"].at[idx].set(res_dual),
            "rho": history["rho"].at[idx].set(state.rho),
        }
    products = state.products
    if products is not None:
        products = {"Px": Px, "Ax": Ax, "ATy": ATy}
    return SolverState(
        x=x,
        z=z,
        y=y,
        rho=state.rho,
        rho_cand=rho_cand,
        status=status.astype(jnp.int32),
        iterations=iterations,
        res_prim=jnp.where(active, res_prim, state.res_prim),
        res_dual=jnp.where(active, res_dual, state.res_dual),
        iteration=iteration,
        kkt_cache=state.kkt_cache,
        history=history,
        products=products,
        aa=state.aa,
    )


def _maybe_refactor(qp: QP, settings: Settings, backend, state: SolverState) -> SolverState:
    """Adopt drifted rho candidates and refresh the cached factorization.

    Hysteresis rule from jl:47-52: refactor lane when rho_cand*f < rho or
    rho_cand > f*rho. Lanes that did not trip keep their rho, so re-running
    the batched factorization leaves their factor numerically unchanged —
    the whole-batch refactor under `lax.cond` is semantically per-lane.
    """
    if not settings.adaptive_rho:
        return state
    f = settings.rho_factor
    active = state.status == Status.RUNNING
    tripped = active & (
        (state.rho_cand * f < state.rho) | (state.rho_cand > f * state.rho)
    )
    rho = jnp.where(tripped, state.rho_cand, state.rho)
    sigma = jnp.asarray(settings.sigma_for(qp.dtype), qp.dtype)

    def do_refactor(cache):
        return backend.refactor(cache, qp, rho, sigma, settings)

    if backend.cheap_refactor:
        # Iterative backends: refactor is an O(n) diagonal refresh, so run it
        # unconditionally (see Backend.cheap_refactor in kkt.py).
        cache = do_refactor(state.kkt_cache)
    else:
        cache = jax.lax.cond(
            jnp.any(tripped), do_refactor, lambda c: c, state.kkt_cache)
    # A re-adopted rho changes the fixed-point encoding w = z + y/rho (and
    # the map itself) — the lane's Anderson history is stale; restart it.
    aa = anderson_mod.reset_aa(state.aa, tripped)
    return SolverState(
        x=state.x, z=state.z, y=state.y, rho=rho, rho_cand=state.rho_cand,
        status=state.status, iterations=state.iterations,
        res_prim=state.res_prim, res_dual=state.res_dual,
        iteration=state.iteration, kkt_cache=cache, history=state.history,
        products=state.products, aa=aa,
    )


def solve(qp: QP, settings: Settings = Settings(), x0=None, z0=None, y0=None,
          rho0=None, scaling=None, prepared=None) -> Solution:
    """Solve a (batched) box-constrained QP. Fully jittable; `settings` static.

    ``qp`` may be a dense batched :class:`QP` or a single large
    :class:`~..core.sparse_problem.SparseQP` (matrix-free CG path).
    ``x0``/``z0``/``y0`` warm-start the primal, split, and dual iterates —
    the reference warm-starts x only (jl:14 takes vX; z, y start at zero,
    jl:39-41). ``rho0`` (scalar or per-lane) warm-starts the penalty; for
    MPC-style sequences carrying duals *and* the adapted rho is what saves
    iterations — re-adapting rho from scratch can cost more than the warm
    primal saves.

    ``scaling``: a :class:`~.scaling.ScalingData` when ``qp`` holds a
    problem PRE-scaled by Ruiz equilibration (the sparse path:
    ``equilibrate_sparse_host`` + ``make_sparse_qp`` store the scaled
    values). Warm starts and the returned solution are in the ORIGINAL
    (unscaled) space; termination tests run on unscaled residuals, exactly
    like the dense ``Settings.scaling_iters`` path. Mutually exclusive with
    ``scaling_iters > 0``.

    ``prepared``: a :class:`PreparedFactor` from :func:`prepare` — skips the
    per-solve KKT factorization entirely (P, A must match the prepare-time
    problem; q, l, u may differ; the solve starts at the prepared rho,
    overriding ``rho0``). The setup/update/solve contract of the reference's
    ProxQP constructors (`/root/reference/ProxQP.jl:73-115`) and of real
    OSQP. Incompatible with ``scaling``.
    Returns a :class:`Solution` whose leaves carry the problem's batch shape.
    """
    if prepared is not None and (scaling is not None or settings.scaling_iters):
        raise ValueError("prepared factors cannot be combined with scaling "
                         "(equilibration rescales P/A, invalidating them)")
    # f32 matmuls may otherwise run at reduced precision (TF32 on the GPU,
    # about three decimal digits), which floors the KKT-solve accuracy and
    # stalls convergence well above a 1e-4 tolerance. The per-iteration
    # matvecs are memory-bound, so full FP32 costs them little; the factor
    # pays, which Settings.factor_precision lets callers trade.
    with jax.default_matmul_precision(settings.matmul_precision):
        return _solve_impl(qp, settings, x0, z0, y0, rho0, scaling,
                           prepared=prepared)


def _solve_impl(qp: QP, settings: Settings, x0, z0=None, y0=None, rho0=None,
                scaling=None, aa0=None, return_aa=False, prepared=None):
    if scaling is not None:
        if settings.scaling_iters > 0:
            raise ValueError(
                "pass either a pre-scaled problem (scaling=...) or "
                "scaling_iters > 0, not both")
        from .scaling import scale_iterates, unscale_iterates

        # Host-built scaling vectors are float64 under enable_x64; keep the
        # loop carry in the problem's dtype.
        scaling = jax.tree.map(lambda v: jnp.asarray(v, qp.dtype), scaling)
        xs, zs, ys = scale_iterates(scaling, x0, z0, y0)
        sol, aa = _solve_core(qp, settings, xs, zs, ys, rho0,
                              term_scale=scaling, aa0=aa0)
        x, z, y = unscale_iterates(scaling, sol.x, sol.z, sol.y)
        # In-loop residuals are already unscaled (term_scale); the objective
        # of the scaled problem is c times the original's.
        info = SolveInfo(
            status=sol.info.status, iterations=sol.info.iterations,
            res_prim=sol.info.res_prim, res_dual=sol.info.res_dual,
            rho=sol.info.rho, objective=sol.info.objective / scaling.c,
            history=sol.info.history)
        out = Solution(x=x, z=z, y=y, info=info)
        return (out, aa) if return_aa else out
    if settings.scaling_iters > 0:
        if not qp.is_dense:
            raise ValueError("scaling_iters requires a dense QP")
        from .scaling import equilibrate, scale_iterates, unscale_iterates

        qp_s, scal = equilibrate(qp, settings.scaling_iters)
        xs, zs, ys = scale_iterates(scal, x0, z0, y0)
        # Termination tests inside the loop run on UNSCALED residuals
        # (term_scale maps them back) — OSQP's own discipline, so a lane
        # reports SOLVED only when the original problem's residuals pass eps.
        sol, aa = _solve_core(qp_s, settings, xs, zs, ys, rho0,
                              term_scale=scal, aa0=aa0)
        x, z, y = unscale_iterates(scal, sol.x, sol.z, sol.y)
        # Recompute residuals/objective at the final unscaled iterates (the
        # in-loop values already are unscaled; this re-evaluates after the
        # f-p unscale rounding and any polish).
        Ax = qp.matvec_A(x)
        res_prim = inf_norm(Ax - z)
        res_dual = inf_norm(qp.matvec_P(x) + qp.q + qp.matvec_At(y))
        info = SolveInfo(
            status=sol.info.status, iterations=sol.info.iterations,
            res_prim=res_prim, res_dual=res_dual, rho=sol.info.rho,
            objective=qp.objective(x), history=sol.info.history)
        out = Solution(x=x, z=z, y=y, info=info)
        return (out, aa) if return_aa else out
    sol, aa = _solve_core(qp, settings, x0, z0, y0, rho0, aa0=aa0,
                          prepared=prepared)
    return (sol, aa) if return_aa else sol


def _solve_core(qp: QP, settings: Settings, x0, z0=None, y0=None, rho0=None,
                term_scale=None, aa0=None, prepared=None):
    if settings.sigma_free_rhs:
        from ..core.settings import KKTBackendKind

        if kkt_mod.resolve_backend(settings.kkt_backend, qp) is not \
                KKTBackendKind.CHOLESKY:
            raise ValueError(
                "sigma_free_rhs is a dense CHOLESKY-backend optimization; "
                "other backends build the RHS per-solve anyway")
    backend = kkt_mod.get_backend(settings.kkt_backend, qp)
    state = _init_state(qp, settings, x0, backend, z0, y0, rho0, aa0,
                        prepared=prepared)
    max_chunks = settings.num_checks

    def cond(st: SolverState):
        return (st.iteration < max_chunks * settings.check_interval) & jnp.any(
            st.status == Status.RUNNING)

    def body(st: SolverState):
        st = _maybe_refactor(qp, settings, backend, st)
        x, z, y, xp, zp, cache = _run_chunk(qp, settings, backend, st)
        prods = aa_accept = None
        aa = st.aa
        if settings.anderson_memory > 0:
            x, z, y, prods, aa, aa_accept = anderson_mod.aa_step(
                qp, settings, st, x, z, y, term_scale)
        st = SolverState(
            x=st.x, z=st.z, y=st.y, rho=st.rho, rho_cand=st.rho_cand,
            status=st.status, iterations=st.iterations, res_prim=st.res_prim,
            res_dual=st.res_dual, iteration=st.iteration, kkt_cache=cache,
            history=st.history, products=st.products, aa=aa)
        return _check_convergence(qp, settings, st, x, z, y, xp, zp, term_scale,
                                  chunk_prods=prods, aa_accept=aa_accept)

    state = jax.lax.while_loop(cond, body, state)

    exhausted = state.status == Status.RUNNING
    status = jnp.where(exhausted, Status.MAX_ITERATIONS, state.status).astype(jnp.int32)
    iterations = jnp.where(exhausted, state.iteration, state.iterations)

    x, y = state.x, state.y
    if settings.polish_iterations > 0:
        x, y = polish_fn(qp, settings, x, state.z, y, state.rho)
        objective = qp.objective(x)
    elif state.products is not None:
        # Px was already computed at the final check for this exact x —
        # reuse it instead of re-reading P for the whole fleet.
        objective = 0.5 * jnp.sum(x * state.products["Px"], axis=-1) + jnp.sum(
            qp.q * x, axis=-1)
    else:
        objective = qp.objective(x)

    info = SolveInfo(
        status=status,
        iterations=iterations,
        res_prim=state.res_prim,
        res_dual=state.res_dual,
        rho=state.rho,
        objective=objective,
        history=state.history,
    )
    return Solution(x=x, z=state.z, y=y, info=info), state.aa


solve_jit = jax.jit(solve, static_argnames=("settings",))


def _solve_carry_aa(qp: QP, settings: Settings, x0, z0, y0, rho0, scaling, aa0):
    """solve() variant that threads the Anderson history in and out — the
    segment worker for :func:`solve_segmented` (histories would otherwise
    restart every segment, wasting AA exactly where iterations dominate)."""
    with jax.default_matmul_precision(settings.matmul_precision):
        return _solve_impl(qp, settings, x0, z0, y0, rho0, scaling,
                           aa0=aa0, return_aa=True)


_solve_carry_aa_jit = jax.jit(_solve_carry_aa, static_argnames=("settings",))


def _rho_candidate_jit(qp: QP, x, z, y, rho):
    """OSQP rho candidate (m:268-272) evaluated in one small device program."""
    Ax = qp.matvec_A(x)
    Px = qp.matvec_P(x)
    ATy = qp.matvec_At(y)
    rp = inf_norm(Ax - z)
    rd = inf_norm(Px + qp.q + ATy)
    max_prim = jnp.maximum(inf_norm(Ax), inf_norm(z))
    max_dual = jnp.maximum(jnp.maximum(inf_norm(Px), inf_norm(ATy)),
                           inf_norm(qp.q))
    den = rd * max_prim
    cand = jnp.clip(rho * jnp.sqrt(rp * max_dual / jnp.where(den == 0, 1.0, den)),
                    RHO_MIN, RHO_MAX)
    ok = jnp.isfinite(cand) & (den != 0) & (cand > 0)
    return jnp.where(ok, cand, rho).astype(qp.dtype)


_rho_candidate_jit = jax.jit(_rho_candidate_jit)


def solve_segmented(qp: QP, settings: Settings = Settings(),
                    segment_iterations: int = 100,
                    x0=None, z0=None, y0=None,
                    host_rho_adaptation: bool = False,
                    scaling=None) -> Solution:
    """Host-driven segmented solve: run the device program in bounded
    segments, carrying (x, z, y, rho) between them.

    Equivalent math to :func:`solve` (a segment boundary is just another
    check boundary), with two uses: (a) very long solves on backends that
    limit single-program runtime, and (b) checkpointable long solves — each
    segment's Solution can be persisted (utils/checkpoint.py) and resumed.

    ``host_rho_adaptation`` moves the adaptive-rho update out of the device
    program to the segment boundary: segments run with ``adaptive_rho=False``
    and the host applies the reference's candidate + hysteresis rule
    (m:268-272, jl:47-52) between them, at segment rather than
    check-interval cadence — useful when a backend limits single-program
    runtime; the coarser adaptation loses little, since rho retuning
    matters on the hundreds-of-iterations scale, not tens.

    Note: per-lane iteration counts are exact for lanes that finish in the
    final segment; lanes that converged in an earlier segment re-verify on
    re-entry, so their counts are accurate to within one check interval per
    extra segment.

    ``scaling`` is forwarded to :func:`solve` (pre-scaled problems; iterates
    cross segment boundaries in the unscaled space).

    ``record_history``: each segment records its own per-segment trace and
    the segments are stitched into one (num_checks, *B) history (a segment
    boundary is just another check boundary, so concatenation along the
    check axis is exact). Checks never run (early all-lane exit) stay inf.
    """
    seg_settings = settings
    if host_rho_adaptation:
        seg_settings = dataclasses_replace(settings, adaptive_rho=False)
    seg = -(-segment_iterations // settings.check_interval) * settings.check_interval
    total = settings.num_checks * settings.check_interval
    done_iters = 0
    sol = None
    rho0 = None
    aa0 = None  # Anderson history, carried across segment boundaries
    histories = [] if settings.record_history else None
    while done_iters < total:
        # Clamp the last segment so the total never exceeds the budget
        # (at most two compiled segment sizes).
        this_seg = min(seg, total - done_iters)
        seg_s = dataclasses_replace(seg_settings, max_iterations=this_seg)
        if settings.anderson_memory > 0:
            sol, aa0 = _solve_carry_aa_jit(qp, seg_s, x0, z0, y0, rho0,
                                           scaling, aa0)
        else:
            sol = solve_jit(qp, seg_s, x0, z0, y0, rho0, scaling)
        status = np.asarray(sol.info.status)
        done_iters += this_seg
        if histories is not None:
            histories.append(sol.info.history)
        if (status != Status.MAX_ITERATIONS).all():
            break
        x0, z0, y0, rho0 = sol.x, sol.z, sol.y, sol.info.rho
        if host_rho_adaptation and settings.adaptive_rho:
            # The rho candidate is evaluated in the space the iteration runs
            # in (the scaled space when the problem is pre-scaled) — same
            # discipline as the in-loop adaptive rho.
            if scaling is not None:
                from .scaling import scale_iterates

                cx, cz, cy = scale_iterates(scaling, x0, z0, y0)
            else:
                cx, cz, cy = x0, z0, y0
            cand = np.asarray(
                _rho_candidate_jit(qp, cx, cz, cy, sol.info.rho))
            rho = np.asarray(sol.info.rho)
            f = settings.rho_factor
            trip = (cand * f < rho) | (cand > f * rho)
            rho0 = jnp.asarray(np.where(trip, cand, rho), qp.dtype)
            if aa0 is not None:
                # Host-adopted rho changes the AA encoding w = z + y/rho —
                # same reset discipline as the in-device refactor path.
                from .anderson import reset_aa

                aa0 = reset_aa(aa0, jnp.asarray(trip))
    if histories is not None:
        from .proxqp import _concat_histories

        history = _concat_histories(histories, settings.num_checks)
    else:
        history = sol.info.history
    info = SolveInfo(
        status=sol.info.status,
        iterations=jnp.minimum(
            sol.info.iterations + (done_iters - this_seg), total).astype(jnp.int32),
        res_prim=sol.info.res_prim, res_dual=sol.info.res_dual,
        rho=sol.info.rho, objective=sol.info.objective,
        history=history)
    return Solution(x=sol.x, z=sol.z, y=sol.y, info=info)
