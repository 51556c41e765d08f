"""Batched ProxQP-style proximal-ALM solver (second algorithm family).

Solves (fleets of) equality/inequality-split QPs

    min 0.5 x'Px + q'x   s.t.   Ax = b,  Cx <= d

with the proximal augmented-Lagrangian iteration of the reference
(`/root/reference/ProxQP.jl:118-298`): slack s >= 0, a single SPD matrix

    M = P + rho*(A'A + C'C) + sigma*I

factored once and refreshed only on rho updates (UpdateDecomposition!,
ProxQP.jl:193-206), updates

    r = -q + sigma*x + A'(rho*b - y) + C'(rho*(d - s) - z)     (:208-219)
    x = M^{-1} r                                               (:221-225)
    s = max(d - Cx - z/rho, 0)                                 (:227-233)
    y = y + rho*(Ax - b)                                       (:235-240)
    z = max(z + rho*(Cx - d + s), 0)                           (:242-249)

and the PIQP convergence criteria (arXiv:2304.00290 eqs. 13a-c) with the
tau-triggered double-sqrt adaptive rho (:277-286).

Design: dense batched pytrees, cached explicit M^{-1} (per-iteration solve
is one batched matvec + refinement), `lax.while_loop` over check-interval chunks
with per-lane convergence masking. The reference never early-exits (its break
is commented out, :157); we do by default (ProxQPSettings.early_exit).

Sparse/matrix-free path: a :class:`~..core.sparse_problem.SparseProxQP`
(operator protocol) routes the inner solve to Jacobi-preconditioned CG on
M = P + sigma*I + rho*(A'A + C'C), warm-started from the previous iterate —
the batched answer to the reference's sparse constructor + CHOLMOD in-place
refactorization (ProxQP.jl:95-115, 201-206): never factorize, and a rho
update only refreshes the preconditioner diagonal.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..core.problem import ProxQPProblem
from ..core.settings import ProxQPSettings
from ..core.state import Status
from ..core.pytree import pytree_dataclass as _pytree_dataclass
from ..ops.linalg import add_scaled_identity, inf_norm, matvec, spd_inverse


@_pytree_dataclass
@dataclasses.dataclass(frozen=True)
class ProxQPInfo:
    """Batched analogue of the reference's report Dict (ProxQP.jl:127),
    plus a Status code the reference lacks (it has only a converged bool
    and loops its full budget on infeasible input)."""

    converged: jax.Array     # (*B,) bool
    iterations: jax.Array    # (*B,) int32
    res_prim: jax.Array      # (*B,)
    res_dual: jax.Array      # (*B,)
    rho: jax.Array           # (*B,)
    #: (*B,) int32 — core.state.Status codes: MAX_ITERATIONS(1), SOLVED(3),
    #: PRIMAL_INFEASIBLE(4), DUAL_INFEASIBLE(5).
    status: jax.Array = None
    #: dict of (num_checks, *B) per-check traces {res_prim, res_dual, rho};
    #: None unless ProxQPSettings.record_history (the reference's commented
    #: @printf trace, ProxQP.jl:272, as device buffers).
    history: object = None


@_pytree_dataclass
@dataclasses.dataclass(frozen=True)
class ProxQPSolution:
    x: jax.Array             # (*B, n)
    s: jax.Array             # (*B, mi) slack for Cx <= d
    y: jax.Array             # (*B, me) equality duals
    z: jax.Array             # (*B, mi) inequality duals (>= 0)
    info: ProxQPInfo


def warm_start(prob: ProxQPProblem, reg: float = 0.0):
    """Equality-only KKT warm start (ProxQP.jl:80-90, 102-111). Dense only.

    Solves [[P, A'], [A, -reg*I]] [x; y] = [-q; b] (reg=0 reproduces the
    reference's plain `\\`; a tiny reg guards rank-deficient A under f32)
    and sets s = max(d - Cx, 0), z = 0.
    """
    dt = prob.P.dtype
    n, me = prob.n, prob.n_eq
    batch = prob.batch_shape
    At = jnp.swapaxes(prob.A, -1, -2)
    top = jnp.concatenate([prob.P, At], axis=-1)
    reg_blk = -reg * jnp.eye(me, dtype=dt)
    bot = jnp.concatenate(
        [prob.A, jnp.broadcast_to(reg_blk, batch + (me, me))], axis=-1)
    K = jnp.concatenate([top, bot], axis=-2)
    rhs = jnp.concatenate([-prob.q, prob.b], axis=-1)
    k = jnp.linalg.solve(K, rhs[..., None])[..., 0]
    x = k[..., :n]
    y = k[..., n:]
    s = jnp.maximum(prob.d - prob.matvec_C(x), 0.0)
    z = jnp.zeros(batch + (prob.n_ineq,), dt)
    return x, y, s, z


def warm_start_operator(prob, settings: ProxQPSettings):
    """Matrix-free warm start: x0 = (P + sigma*I)^{-1}(-q) via Jacobi-CG.

    The dense path warm-starts from the equality-KKT solve (ProxQP.jl:80-90);
    at operator scale that factorization is exactly what we refuse to pay, so
    start from the unconstrained minimizer instead — for lightly-constrained
    applications (smoothing with a handful of pinned samples) it lands with a
    near-zero dual residual and the ALM only has to enforce the constraints.
    """
    from .kkt import _pcg

    dt = prob.dtype
    sigma = jnp.asarray(settings.sigma, dt)
    dP = prob.diag_P() + sigma
    diag_inv = jnp.where(dP > 0, 1.0 / dP, 1.0)
    x = _pcg(lambda v: prob.matvec_P(v) + sigma * v, -prob.q,
             jnp.zeros_like(prob.q), diag_inv,
             abs_tol=settings.cg_eps,
             max_iterations=settings.cg_max_iterations)
    y = jnp.zeros(prob.batch_shape + (prob.n_eq,), dt)
    s = jnp.maximum(prob.d - prob.matvec_C(x), 0.0)
    z = jnp.zeros(prob.batch_shape + (prob.n_ineq,), dt)
    return x, y, s, z


def _build_M_inv(prob: ProxQPProblem, rho, sigma):
    # No explicit symmetrization: gram products are symmetric to f32
    # rounding and P is validated at construction; a sym() here costs two
    # extra full passes over the (B, n, n) matrix (see
    # models/kkt.py:_build_normal_matrix).
    AtA = jnp.einsum("...ki,...kj->...ij", prob.A, prob.A)
    CtC = jnp.einsum("...ki,...kj->...ij", prob.C, prob.C)
    M = prob.P + rho[..., None, None] * (AtA + CtC)
    return spd_inverse(add_scaled_identity(M, sigma))


def _build_sigma_free_cache(prob, rho, settings):
    """{Ga, Gc, g} = M^{-1}[A' C' q] with M = P + rho(A'A + C'C) — the
    prox-ALM analogue of kkt.cholesky_init's sigma-free branch (see
    ProxQPSettings.sigma_free_rhs). The proximal sigma is DROPPED entirely
    (exact ALM): unlike the OSQP family's 1e-6, prox-ALM's default sigma
    (1e-2) is a real perturbation of P, so solving against P + sigma*I
    would bias the fixed point measurably. M must be invertible on its
    own (P with a PD part). The factor is the XLA build plus a Cholesky
    multi-RHS solve, exactly like the ADMM path.
    """
    n, me, mi = prob.n, prob.n_eq, prob.n_ineq
    batch = prob.batch_shape
    from ..ops.linalg import spd_solve

    K = (jnp.einsum("...ki,...kj->...ij", prob.A, prob.A)
         + jnp.einsum("...ki,...kj->...ij", prob.C, prob.C))
    M = prob.P + rho[..., None, None] * K
    At = jnp.broadcast_to(jnp.swapaxes(prob.A, -1, -2), batch + (n, me))
    Ct = jnp.broadcast_to(jnp.swapaxes(prob.C, -1, -2), batch + (n, mi))
    R = jnp.concatenate(
        [At, Ct, jnp.broadcast_to(prob.q, batch + (n,))[..., :, None]],
        axis=-1)
    X = spd_solve(M, R)
    return {"Ga": X[..., :, :me], "Gc": X[..., :, me:me + mi],
            "g": X[..., :, me + mi]}


def _apply_M(prob, rho, sigma, v):
    """Matrix-free M @ v through the operator protocol."""
    return (
        prob.matvec_P(v)
        + sigma * v
        + rho[..., None] * (
            prob.matvec_At(prob.matvec_A(v))
            + prob.matvec_Ct(prob.matvec_C(v))
        )
    )


def _jacobi_inv(prob, rho, sigma):
    """1 / diag(M) — the matrix-free path's whole "factorization"."""
    d = prob.diag_P() + sigma + rho[..., None] * (prob.diag_AtA()
                                                  + prob.diag_CtC())
    return jnp.where(d > 0, 1.0 / d, 1.0)


@_pytree_dataclass
@dataclasses.dataclass(frozen=True)
class PreparedProxFactor:
    """Prox-ALM factor prepared once for repeated solves.

    The reference ProxQP's own contract: the constructor factors M
    (`/root/reference/ProxQP.jl:73-115`) and `SolveQuadraticProgram!`
    reuses the Cholesky across calls (`:118-173`). Here: P, A, C fixed;
    q, b, d free between solves; the solve starts at the prepared rho
    (adaptive rho then refactors in-loop on trips as usual). ``M_inv`` is
    carried only on the sigma-free path to refresh the q-dependent
    ``g = M^{-1}q`` per solve (Ga/Gc are q-independent).
    """

    cache: object            # {Ga, Gc} (sigma-free), M_inv (dense), or diag
    rho: jax.Array
    M_inv: object = None

    def materialize(self, prob):
        if self.M_inv is not None:
            return {"Ga": self.cache["Ga"], "Gc": self.cache["Gc"],
                    "g": matvec(self.M_inv, prob.q)}
        return self.cache


def prepare(prob, settings: ProxQPSettings = ProxQPSettings(),
            rho0=None) -> PreparedProxFactor:
    """Factor M = P + rho(A'A + C'C) (+ sigma I) once for repeated solves.

    Jittable. Covers all three factor paths: dense explicit M^{-1},
    sigma-free {Ga, Gc} (+ internal M^{-1} for per-q g refresh), and the
    matrix-free Jacobi diagonal.
    """
    dt = prob.dtype
    batch = prob.batch_shape
    rho = (jnp.full(batch, settings.rho, dt) if rho0 is None
           else jnp.broadcast_to(jnp.asarray(rho0, dt), batch))
    sigma = jnp.asarray(settings.sigma, dt)
    with jax.default_matmul_precision("highest"):
        if settings.sigma_free_rhs:
            if not prob.is_dense:
                raise ValueError("sigma_free_rhs needs a dense ProxQP problem")
            from ..ops.linalg import spd_inverse

            K = (jnp.einsum("...ki,...kj->...ij", prob.A, prob.A)
                 + jnp.einsum("...ki,...kj->...ij", prob.C, prob.C))
            M_inv = spd_inverse(prob.P + rho[..., None, None] * K)
            Ga = jnp.einsum("...ij,...kj->...ik", M_inv, prob.A)
            Gc = jnp.einsum("...ij,...kj->...ik", M_inv, prob.C)
            return PreparedProxFactor(cache={"Ga": Ga, "Gc": Gc}, rho=rho,
                                      M_inv=M_inv)
        if prob.is_dense:
            return PreparedProxFactor(cache=_build_M_inv(prob, rho, sigma),
                                      rho=rho)
        return PreparedProxFactor(cache=_jacobi_inv(prob, rho, sigma), rho=rho)


prepare_jit = jax.jit(prepare, static_argnames=("settings",))


def solve(prob, settings: ProxQPSettings = ProxQPSettings(),
          init=None, rho0=None, prepared=None) -> ProxQPSolution:
    """Solve a (batched) split-form QP (dense ProxQPProblem or matrix-free
    SparseProxQP). Jittable; `settings` static.

    ``init`` optionally provides (x, y, s, z); by default the equality-KKT
    warm start of the reference is used. ``rho0`` (scalar or per-lane)
    warm-starts the penalty — segmented/warm-started solves carry the
    adapted rho through it.
    """
    # Full-FP32 matmuls, no TF32 (see the models/admm.py rationale).
    with jax.default_matmul_precision("highest"):
        return _solve_impl(prob, settings, init, rho0, prepared)


def _solve_impl(prob, settings: ProxQPSettings, init,
                rho0=None, prepared=None) -> ProxQPSolution:
    dt = prob.dtype
    batch = prob.batch_shape
    sigma = jnp.asarray(settings.sigma, dt)

    if init is not None:
        x, y, s, z = init
    elif settings.kkt_warm_start and prob.is_dense:
        x, y, s, z = warm_start(prob)
    elif settings.kkt_warm_start:
        x, y, s, z = warm_start_operator(prob, settings)
    else:
        x = jnp.zeros(batch + (prob.n,), dt)
        y = jnp.zeros(batch + (prob.n_eq,), dt)
        s = jnp.maximum(prob.d, 0.0)
        z = jnp.zeros(batch + (prob.n_ineq,), dt)

    if prepared is not None:
        # Factor reuse (see prepare): adopt the prepared rho — the factor
        # is only valid at its own rho.
        rho = jnp.broadcast_to(jnp.asarray(prepared.rho, dt), batch)
    else:
        rho = (jnp.full(batch, settings.rho, dt) if rho0 is None
               else jnp.broadcast_to(jnp.asarray(rho0, dt), batch))
    sigma_free = settings.sigma_free_rhs
    if sigma_free:
        if not prob.is_dense:
            raise ValueError("sigma_free_rhs needs a dense ProxQP problem")
        if settings.kkt_refinement_steps:
            raise ValueError("sigma_free_rhs excludes kkt_refinement_steps "
                             "(refinement needs the explicit M^{-1})")
    # "factor": cached explicit inverse (dense), the {Ga, Gc, g} column
    # cache (sigma_free), or the Jacobi diagonal (matrix-free CG) —
    # refreshed only on rho updates.
    def refresh_factor(rho):
        with jax.named_scope("factor"):
            if sigma_free:
                return _build_sigma_free_cache(prob, rho, settings)
            return (_build_M_inv(prob, rho, sigma) if prob.is_dense
                    else _jacobi_inv(prob, rho, sigma))

    factor = (prepared.materialize(prob) if prepared is not None
              else refresh_factor(rho))

    def ldiv(factor, rho, r, x0):
        if prob.is_dense:
            v = matvec(factor, r)
            for _ in range(settings.kkt_refinement_steps):
                v = v + matvec(factor, r - _apply_M(prob, rho, sigma, v))
        else:
            from .kkt import _pcg

            v = _pcg(lambda w: _apply_M(prob, rho, sigma, w), r, x0, factor,
                     abs_tol=settings.cg_eps,
                     max_iterations=settings.cg_max_iterations,
                     rel_tol=settings.cg_rel_eps)
        return v

    def chunk_step(carry, _):
        # aa is None when anderson_memory == 0 (a leafless pytree node, so
        # aa/prods are None when their features are off (leafless pytree
        # nodes, so the carry structure is stable either way).
        (x, y, s, z, rho, factor, status, iters_done, res_p, res_d, it,
         aa, prods_prev, history) = carry
        x_in, s_in_, y_in, z_in = x, s, y, z      # chunk input point
        running = status == Status.RUNNING
        # early_exit freezes every finished lane; reference mode (no early
        # exit, ProxQP.jl:157) keeps iterating converged lanes but still
        # freezes infeasible ones — their iterates diverge by design.
        if settings.early_exit:
            active = running
        else:
            active = status < Status.PRIMAL_INFEASIBLE
        act = active[..., None]
        rho_col = rho[..., None]

        def one_iter(_, state):
            x, s, y, z = state
            if sigma_free:
                # Exact-ALM x-update from the column cache: no sigma*x, no
                # q (it lives in g) — see ProxQPSettings.sigma_free_rhs.
                x_new = (
                    jnp.einsum("...k,...nk->...n", rho_col * prob.b - y,
                               factor["Ga"])
                    + jnp.einsum("...k,...nk->...n",
                                 rho_col * (prob.d - s) - z, factor["Gc"])
                    - factor["g"])
            else:
                r = (-prob.q + sigma * x
                     + prob.matvec_At(rho_col * prob.b - y)
                     + prob.matvec_Ct(rho_col * (prob.d - s) - z))
                x_new = ldiv(factor, rho, r, x)
            Cx = prob.matvec_C(x_new)
            s_new = jnp.maximum(prob.d - Cx - z / rho_col, 0.0)
            y_new = y + rho_col * (prob.matvec_A(x_new) - prob.b)
            z_new = jnp.maximum(z + rho_col * (Cx - prob.d + s_new), 0.0)
            return (
                jnp.where(act, x_new, x),
                jnp.where(act, s_new, s),
                jnp.where(act, y_new, y),
                jnp.where(act, z_new, z),
            )

        with jax.named_scope("chunk"):
            x, s, y, z = jax.lax.fori_loop(
                0, settings.check_interval, one_iter, (x, s, y, z))
        it = it + settings.check_interval

        with jax.named_scope("check"):
            if settings.anderson_memory > 0:
                from . import anderson as anderson_mod

                x, s, y, z, prods, aa, _ = anderson_mod.aa_step_proxqp(
                    prob, settings, aa, rho, active,
                    x_in, s_in_, y_in, z_in, x, s, y, z)
                Px, Aty, Ctz = prods["Px"], prods["Aty"], prods["Ctz"]
                Ax, Cx = prods["Ax"], prods["Cx"]
            else:
                # CheckConvergence! (ProxQP.jl:252-298), PIQP criteria 13a-c.
                Px = prob.matvec_P(x)
                Aty = prob.matvec_At(y)
                Ctz = prob.matvec_Ct(z)
                Ax = prob.matvec_A(x)
                Cx = prob.matvec_C(x)
            res_prim = jnp.maximum(inf_norm(Ax - prob.b),
                                   inf_norm(Cx - prob.d + s))
            res_dual = inf_norm(Px + Aty + Ctz + prob.q)
            max_prim = jnp.max(
                jnp.stack([inf_norm(Ax), inf_norm(prob.b), inf_norm(Cx),
                           inf_norm(prob.d), inf_norm(s)]), axis=0)
            max_dual = jnp.max(
                jnp.stack([inf_norm(Px), inf_norm(Aty), inf_norm(Ctz),
                           inf_norm(prob.q)]), axis=0)

            eps_prim_t = settings.eps_abs + settings.eps_rel * max_prim
            eps_dual_t = settings.eps_abs + settings.eps_rel * max_dual
            now_conv = (res_prim < eps_prim_t) & (res_dual < eps_dual_t)
            status = jnp.where(running & now_conv, Status.SOLVED, status)
            if settings.check_infeasibility:
                # Farkas certificates from the chunk's iterate differences
                # (mirrors models/admm.py:_infeasibility_certificates for the
                # split form). Products of the chunk-input point were cached at
                # the previous check, so the deltas cost no extra matvecs.
                eps_pi = jnp.asarray(settings.eps_prim_inf, dt)
                eps_di = jnp.asarray(settings.eps_dual_inf, dt)
                dy = y - y_in
                dz = z - z_in
                dx = x - x_in
                ndyz = jnp.maximum(inf_norm(dy), inf_norm(dz))
                stat = inf_norm((Aty - prods_prev["Aty"])
                                + (Ctz - prods_prev["Ctz"]))
                gap = jnp.sum(prob.b * dy, axis=-1) + jnp.sum(prob.d * dz, axis=-1)
                sign_ok = jnp.all(dz >= -(eps_pi * ndyz)[..., None], axis=-1)
                prim_inf = ((ndyz > 0)
                            & (stat <= eps_pi * ndyz)
                            & (gap <= -eps_pi * ndyz)
                            & sign_ok)
                ndx = inf_norm(dx)
                Cdx = Cx - prods_prev["Cx"]
                dual_inf = ((ndx > 0)
                            & (inf_norm(Px - prods_prev["Px"]) <= eps_di * ndx)
                            & (inf_norm(Ax - prods_prev["Ax"]) <= eps_di * ndx)
                            & jnp.all(Cdx <= (eps_di * ndx)[..., None], axis=-1)
                            & (jnp.sum(prob.q * dx, axis=-1) <= -eps_di * ndx))
                # Anti-false-positive gates (see admm.py): the lane must be far
                # from convergence and the deltas above the iterate noise floor.
                noise = 16 * jnp.finfo(dt).eps
                yz_scale = jnp.maximum(jnp.maximum(inf_norm(y), inf_norm(z)), 1.0)
                prim_inf &= (res_prim > 10 * eps_prim_t) & (ndyz > noise * yz_scale)
                dual_inf &= (res_dual > 10 * eps_dual_t) & (
                    ndx > noise * jnp.maximum(inf_norm(x), 1.0))
                overridable = running & (status == Status.RUNNING)
                status = jnp.where(overridable & prim_inf,
                                   Status.PRIMAL_INFEASIBLE, status)
                status = jnp.where(overridable & dual_inf & ~prim_inf,
                                   Status.DUAL_INFEASIBLE, status)
                prods_prev = {"Px": Px, "Aty": Aty, "Ctz": Ctz, "Ax": Ax, "Cx": Cx}
            status = status.astype(jnp.int32)
            newly = running & (status != Status.RUNNING)
            iters_done = jnp.where(newly, it, iters_done)
            res_p = jnp.where(active, res_prim, res_p)
            res_d = jnp.where(active, res_dual, res_d)

        if settings.record_history:
            # rho recorded is the value the chunk RAN with (pre-adaptation) —
            # same convention as models/admm.py's trace.
            idx = it // settings.check_interval - 1
            history = {
                "res_prim": history["res_prim"].at[idx].set(res_prim),
                "res_dual": history["res_dual"].at[idx].set(res_dual),
                "rho": history["rho"].at[idx].set(rho),
            }

        if settings.adaptive_rho:
            num = res_prim * max_dual
            den = res_dual * max_prim
            ratio = num / jnp.where(den == 0, 1.0, den)
            trip = active & jnp.isfinite(ratio) & (den != 0) & (
                (ratio > settings.tau) | (1.0 / jnp.where(ratio == 0, 1.0, ratio) > settings.tau))
            # Double square root for smoother updates (ProxQP.jl:282).
            rho_new = jnp.clip(
                rho * jnp.sqrt(jnp.sqrt(jnp.where(trip, ratio, 1.0))),
                settings.rho_min, settings.rho_max).astype(dt)
            rho_next = jnp.where(trip, rho_new, rho)
            if prob.is_dense:
                factor = jax.lax.cond(
                    jnp.any(trip),
                    lambda _: refresh_factor(rho_next),
                    lambda f: f,
                    factor)
            else:
                # Matrix-free: the "factor" is the O(n) Jacobi diagonal —
                # refresh unconditionally (see kkt.Backend.cheap_refactor).
                factor = refresh_factor(rho_next)
            rho = rho_next
            if aa is not None:
                # rho changes the AA encoding u = s - z/rho and the map.
                from . import anderson as anderson_mod

                aa = anderson_mod.reset_aa(aa, trip)

        return (x, y, s, z, rho, factor, status, iters_done,
                res_p, res_d, it, aa, prods_prev, history), None

    status0 = jnp.zeros(batch, jnp.int32)
    if settings.anderson_memory > 0:
        from . import anderson as anderson_mod

        aa0 = anderson_mod.init_aa_proxqp(prob, settings)
    else:
        aa0 = None
    prods0 = None
    if settings.check_infeasibility:
        # Products at the start iterate so the first check's certificate
        # deltas have a correct base point (same discipline as admm.py).
        prods0 = {"Px": prob.matvec_P(x), "Aty": prob.matvec_At(y),
                  "Ctz": prob.matvec_Ct(z), "Ax": prob.matvec_A(x),
                  "Cx": prob.matvec_C(x)}
    history0 = None
    if settings.record_history:
        buf = lambda: jnp.full((settings.num_checks,) + batch, jnp.inf, dt)
        history0 = {"res_prim": buf(), "res_dual": buf(), "rho": buf()}
    carry = (
        x, y, s, z, rho, factor, status0,
        jnp.full(batch, settings.num_checks * settings.check_interval, jnp.int32),
        jnp.full(batch, jnp.inf, dt), jnp.full(batch, jnp.inf, dt),
        jnp.zeros((), jnp.int32), aa0, prods0, history0)

    if settings.early_exit:
        def cond(c):
            it = c[10]
            return ((it < settings.num_checks * settings.check_interval)
                    & jnp.any(c[6] == Status.RUNNING))

        carry = jax.lax.while_loop(cond, lambda c: chunk_step(c, None)[0], carry)
    else:
        carry, _ = jax.lax.scan(chunk_step, carry, None, length=settings.num_checks)

    (x, y, s, z, rho, _, status, iters_done, res_p, res_d, _, _, _,
     history) = carry
    status = jnp.where(status == Status.RUNNING, Status.MAX_ITERATIONS,
                       status).astype(jnp.int32)
    info = ProxQPInfo(
        converged=status == Status.SOLVED, iterations=iters_done,
        res_prim=res_p, res_dual=res_d, rho=rho, status=status,
        history=history)
    return ProxQPSolution(x=x, s=s, y=y, z=z, info=info)


solve_jit = jax.jit(solve, static_argnames=("settings",))


def solve_segmented(prob, settings: ProxQPSettings = ProxQPSettings(),
                    segment_iterations: int = 250,
                    init=None) -> ProxQPSolution:
    """Host-driven segmented prox-ALM solve: bounded device programs with
    the (x, y, s, z, rho) carry between them.

    Prox-ALM analogue of :func:`~.admm.solve_segmented` — a segment boundary
    is just another check boundary, so the math is unchanged. Uses: (a)
    backends that limit single-program runtime, and (b) checkpointable
    long solves.

    Per-lane iteration counts are exact for lanes finishing in the final
    segment; earlier finishers re-verify on re-entry (accurate to one check
    interval per extra segment). Anderson history restarts at segment
    boundaries (unlike the box-form solver's carry) — acceptable because AA
    re-fills its window within `anderson_memory` checks.

    ``init`` forwards to :func:`solve` for the FIRST segment only (later
    segments warm-start from the previous segment's iterates); note
    ``early_exit=False`` (reference full-budget mode) makes every segment
    run its full length, so segmentation only bounds program size there.
    """
    from dataclasses import replace as dataclasses_replace

    import numpy as np

    seg = -(-segment_iterations // settings.check_interval) * settings.check_interval
    total = settings.num_checks * settings.check_interval
    done_iters = 0
    sol = None
    rho0 = None
    histories = [] if settings.record_history else None
    while done_iters < total:
        this_seg = min(seg, total - done_iters)
        seg_s = dataclasses_replace(settings, max_iterations=this_seg)
        sol = solve_jit(prob, seg_s, init, rho0)
        status = np.asarray(sol.info.status)
        done_iters += this_seg
        if histories is not None:
            histories.append(sol.info.history)
        if (status != Status.MAX_ITERATIONS).all():
            break
        init = (sol.x, sol.y, sol.s, sol.z)
        rho0 = sol.info.rho
    info = ProxQPInfo(
        converged=sol.info.converged,
        iterations=jnp.minimum(
            sol.info.iterations + (done_iters - this_seg), total).astype(jnp.int32),
        res_prim=sol.info.res_prim, res_dual=sol.info.res_dual,
        rho=sol.info.rho, status=sol.info.status,
        history=_concat_histories(histories, settings.num_checks))
    return ProxQPSolution(x=sol.x, s=sol.s, y=sol.y, z=sol.z, info=info)


def _concat_histories(histories, num_checks: int):
    """Stitch per-segment trace buffers into one (num_checks, *B) trace.

    Segments cover disjoint check windows (a segment boundary is just
    another check boundary), so concatenation along the check axis IS the
    full trace; checks never run (early all-lane exit) stay at the inf
    fill. Shared by both solver families' segmented drivers."""
    if not histories:
        return None
    out = {k: jnp.concatenate([h[k] for h in histories], axis=0)
           for k in histories[0]}
    got = out["res_prim"].shape[0]
    if got < num_checks:
        pad = [(0, num_checks - got)] + [(0, 0)] * (out["res_prim"].ndim - 1)
        out = {k: jnp.pad(v, pad, constant_values=jnp.inf)
               for k, v in out.items()}
    return out
