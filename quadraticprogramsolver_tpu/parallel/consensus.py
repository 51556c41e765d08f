"""Block-split distributed solve (model-parallel axis), optionally combined
with fleet sharding (data-parallel axis) on a 2-D mesh.

The reference is single-process; SURVEY.md §2 designates constraint-block
splitting with collective reductions as the framework's model-parallel
axis, and BASELINE.md config 5 is the combined case: an MPC/scenario fleet
sharded over one mesh axis with each problem's constraint rows split over
the other. This module runs the *exact* OSQP iteration of models/admm.py
under `shard_map` with explicit collectives:

  * KKT normal matrix:  M = P + sigma*I + rho * psum_blocks(A_d' A_d)
  * KKT right-hand side: sigma*x - q + psum_blocks(A_d'(rho*z_d - y_d))
  * dual residual:       ||Px + q + psum_blocks(A_d' y_d)||_inf
  * primal residual / norms: per-lane inf-norms reduced with pmax

x stays replicated across the block axis; every block shard computes the
identical x-update, so the distributed iterates match the single-device
solver exactly (tested to ~1e-9). Per-iteration communication is two
n-vector psums + a handful of per-lane pmaxes, riding ICI.

Math per iteration: SolveQuadraticProgram.jl:45-71, residuals :79-112.
Polish (m:289-325) runs distributed: matrix-free MINRES on the masked KKT
with psum'd inner products, so every shard iterates on identical global
Lanczos scalars. Vector-rho weights equality rows locally (weights derive
from the row's own l/u — no communication). Infeasibility certificates
(OSQP §3.4, statuses 4/5) run distributed too: the row-space pieces of the
Farkas tests (norms, bound-support function, the per-row compatibility
test) reduce over the block axis. Anderson acceleration
(Settings.anderson_memory) runs distributed as well: history buffers are
stored split (x-part replicated, w-part row-sharded) and the MxM mixing
system is built from psum'd Gram products, so every shard takes the
identical accelerated step — tested to match the single-device accelerated
solver iteration-for-iteration.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.problem import QP
from ..core.settings import RHO_MAX, RHO_MIN, Settings
from ..core.state import SolveInfo, Solution, Status
from ..ops.linalg import add_scaled_identity, inf_norm, matvec, matvec_t, spd_inverse, sym

BLOCK_AXIS = "blocks"
FLEET_AXIS = "qp"


def _aa_reset(aa, mask):
    """Restart the Anderson history for masked lanes (split-buffer layout)."""
    m3 = mask[:, None, None]
    return {
        "Sx": jnp.where(m3, 0.0, aa["Sx"]), "Fx": jnp.where(m3, 0.0, aa["Fx"]),
        "Sw": jnp.where(m3, 0.0, aa["Sw"]), "Fw": jnp.where(m3, 0.0, aa["Fw"]),
        "px": aa["px"], "fx": aa["fx"], "pw": aa["pw"], "fw": aa["fw"],
        "count": jnp.where(mask, 0, aa["count"]),
    }


def pad_rows_for_mesh(qp: QP, n_shards: int) -> QP:
    """Pad constraint rows to a multiple of the block-mesh axis with
    inactive rows."""
    from ..core.problem import pad_qp

    m_pad = -(-qp.m // n_shards) * n_shards
    return qp if m_pad == qp.m else pad_qp(qp, qp.n, m_pad)


def solve_block_split(qp: QP, settings: Settings = Settings(),
                      mesh: Mesh | None = None) -> Solution:
    """Solve one large dense QP with constraint rows sharded over a 1-D mesh."""
    if qp.batch_shape:
        raise ValueError(
            "solve_block_split takes a single (unbatched) QP; use "
            "solve_fleet_block_split for a fleet on a 2-D mesh")
    if mesh is None:
        mesh = Mesh(np.asarray(jax.devices()), (BLOCK_AXIS,))
    batched = jax.tree.map(lambda x: x[None], qp)
    sol = _solve_impl(batched, settings, mesh, fleet_axis=None,
                      block_axis=mesh.axis_names[0])
    # History leaves are (num_checks, B=1) — batch on axis 1, unlike every
    # other Solution leaf; drop their batch axis separately.
    history = sol.info.history
    if history is not None:
        history = {k: v[:, 0] for k, v in history.items()}
    sol = Solution(
        x=sol.x[0], z=sol.z[0], y=sol.y[0],
        info=SolveInfo(
            status=sol.info.status[0], iterations=sol.info.iterations[0],
            res_prim=sol.info.res_prim[0], res_dual=sol.info.res_dual[0],
            rho=sol.info.rho[0], objective=sol.info.objective[0],
            history=history))
    return sol


def solve_fleet_block_split(qp: QP, settings: Settings = Settings(),
                            mesh: Mesh | None = None) -> Solution:
    """BASELINE config 5: fleet axis sharded over mesh axis 0 (data
    parallel), constraint rows split over mesh axis 1 (model parallel)."""
    if len(qp.batch_shape) != 1:
        raise ValueError("expected one fleet axis; got batch shape "
                         f"{qp.batch_shape}")
    if mesh is None:
        devs = np.asarray(jax.devices())
        mesh = Mesh(devs.reshape(-1, 1), (FLEET_AXIS, BLOCK_AXIS))
    fa, ba = mesh.axis_names
    if qp.batch_shape[0] % mesh.shape[fa]:
        raise ValueError(
            f"fleet size {qp.batch_shape[0]} not divisible by mesh axis "
            f"{mesh.shape[fa]}")
    return _solve_impl(qp, settings, mesh, fleet_axis=fa, block_axis=ba)


def _solve_impl(qp: QP, settings: Settings, mesh: Mesh,
                fleet_axis: str | None, block_axis: str) -> Solution:
    n_shards = mesh.shape[block_axis]
    m_orig = qp.m
    qp = pad_rows_for_mesh(qp, n_shards)

    fa = fleet_axis  # None => fleet axis unsharded (replicated batch of 1)
    rep = P(fa)
    row = P(fa, block_axis)
    in_specs = (P(fa), rep, P(fa, block_axis, None), row, row)
    # Trace buffers (num_checks, B): batch on axis 1, replicated over blocks
    # (their entries are post-reduction residuals every shard agrees on).
    trace = P(None, fa)
    out_specs = (rep, row, row, rep, rep, rep, rep, rep) + (
        (trace, trace, trace) if settings.record_history else ())

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    def run(Pm, q, A, l, u):
        dt = Pm.dtype
        Bb = Pm.shape[0]
        m_loc = A.shape[-2]
        sigma = jnp.asarray(settings.sigma_for(dt), dt)
        alpha = jnp.asarray(settings.alpha, dt)
        alpha1 = jnp.asarray(1.0 - settings.alpha, dt)

        def psum(v):
            return jax.lax.psum(v, block_axis)

        def pmax(v):
            return jax.lax.pmax(v, block_axis)

        # Vector-rho (OSQP's scheme, models/kkt.py:row_weights): equality
        # rows get rho * rho_eq_scale. Weights derive from the row's own
        # bounds, so each shard computes its slice with no communication.
        if settings.rho_eq_scale != 1.0:
            tol_eq = 1e-9 * jnp.maximum(1.0, jnp.abs(u))
            w = jnp.where(
                jnp.isfinite(l) & jnp.isfinite(u) & (jnp.abs(u - l) <= tol_eq),
                jnp.asarray(settings.rho_eq_scale, dt), jnp.asarray(1.0, dt))
        else:
            w = None

        def rho_rows(rho):
            r = rho[:, None]
            return r if w is None else r * w

        def factor(rho):
            Aw = A if w is None else A * w[..., None]
            AtA = psum(jnp.einsum("bki,bkj->bij", Aw, A))
            M = add_scaled_identity(
                sym(Pm) + rho[:, None, None] * sym(AtA), sigma)
            return spd_inverse(M)

        def kkt_solve(M_inv, rho, x, z, y):
            rho_row = rho_rows(rho)
            b = sigma * x - q + psum(matvec_t(A, rho_row * z - y))
            xx = matvec(M_inv, b)
            for _ in range(settings.kkt_refinement_steps):
                Mxx = (matvec(Pm, xx) + sigma * xx
                       + psum(matvec_t(A, rho_row * matvec(A, xx))))
                xx = xx + matvec(M_inv, b - Mxx)
            return xx, matvec(A, xx)

        def polish_block(x, z, y):
            """Distributed polish: models/polish.py:polish_minres with the
            constraint rows sharded — A is applied locally, A' contributions
            and every MINRES inner product psum over the block axis, and the
            acceptance metric pmaxes the local bound violations. The Lanczos
            recurrence sees only globally-reduced scalars, so all shards
            compute the identical (replicated) polished x."""
            from ..models.kkt import _minres

            n = Pm.shape[-1]
            delta = jnp.asarray(settings.delta, dt)
            Ax = matvec(A, x)
            # Active set: dual sign + primal proximity (polish.py:_active_set).
            c = 10.0 * jnp.maximum(pmax(inf_norm(Ax - z))[:, None],
                                   jnp.asarray(settings.eps_abs, dt))
            low_active = ((y < 0) & jnp.isfinite(l)
                          & (z - l <= c * (1.0 + jnp.abs(l))))
            up_active = ((y > 0) & jnp.isfinite(u)
                         & (u - z <= c * (1.0 + jnp.abs(u))))
            act_rows = low_active | up_active
            g = (jnp.where(low_active, l, 0.0)
                 + jnp.where(up_active, u, 0.0)).astype(dt)
            r_diag = jnp.where(act_rows, delta, jnp.asarray(1.0, dt))

            def apply_K(v):
                v1, v2 = v[..., :n], v[..., n:]
                top = (matvec(Pm, v1) + delta * v1
                       + psum(matvec_t(A, jnp.where(act_rows, v2, 0.0))))
                bot = jnp.where(act_rows, matvec(A, v1), 0.0) - r_diag * v2
                return jnp.concatenate([top, bot], axis=-1)

            def apply_K_exact(v):
                v1, v2 = v[..., :n], v[..., n:]
                top = (matvec(Pm, v1)
                       + psum(matvec_t(A, jnp.where(act_rows, v2, 0.0))))
                bot = (jnp.where(act_rows, matvec(A, v1), 0.0)
                       - jnp.where(act_rows, 0.0, v2))
                return jnp.concatenate([top, bot], axis=-1)

            d1 = jnp.diagonal(Pm, axis1=-2, axis2=-1) + delta
            d1_inv = jnp.where(d1 > 0, 1.0 / d1, 1.0)

            def precond(v):
                return jnp.concatenate(
                    [d1_inv * v[..., :n], v[..., n:] / r_diag], axis=-1)

            def vdot(a, b):
                return (jnp.sum(a[..., :n] * b[..., :n], axis=-1)
                        + psum(jnp.sum(a[..., n:] * b[..., n:], axis=-1)))

            def kkt_err(xv, yv):
                Axv = matvec(A, xv)
                dual = inf_norm(matvec(Pm, xv) + q + psum(matvec_t(A, yv)))
                viol = pmax(inf_norm(Axv - jnp.clip(Axv, l, u)))
                return jnp.maximum(dual, viol)

            b = jnp.concatenate([-q, g], axis=-1)
            v0 = jnp.concatenate([x, jnp.where(act_rows, y, 0.0)], axis=-1)

            # Refinement sweeps against the unregularized system, exactly as
            # models/polish.py:polish_minres (m:314-320).
            def sweep(_, v):
                r = b - apply_K_exact(v)
                dv = _minres(apply_K, precond, r, jnp.zeros_like(b),
                             abs_tol=0.0, rel_tol=settings.polish_eps,
                             max_iterations=settings.polish_max_krylov,
                             vdot=vdot)
                return v + dv

            v = jax.lax.fori_loop(0, max(1, settings.polish_iterations),
                                  sweep, v0)
            px, pn = v[..., :n], v[..., n:]
            # Every shard computed the identical px (all Lanczos scalars are
            # psum'd), but the concat with the row-sharded nu segment makes
            # it *varying* to the vma checker; this pmax is a numerical no-op
            # that re-establishes the replication certificate.
            px = pmax(px)
            finite = (jnp.all(jnp.isfinite(px), axis=-1)
                      & (psum(jnp.sum((~jnp.isfinite(pn)).astype(dt), axis=-1))
                         == 0))
            accept = (kkt_err(px, pn) < kkt_err(x, y)) & finite
            return (jnp.where(accept[:, None], px, x),
                    jnp.where(accept[:, None], pn, y))

        # Loop-carried state must be pre-marked varying over the axes its
        # updates depend on (fleet-sharded inputs make everything vary over
        # the fleet axis; z/y additionally vary over the block axis).
        fleet_axes = (fleet_axis,) if fleet_axis else ()

        def mark(v, axes):
            for a in axes:
                v = jax.lax.pcast(v, a, to="varying")
            return v

        rho0 = mark(jnp.full((Bb,), settings.rho, dt), fleet_axes)
        z0 = mark(jnp.zeros((Bb, m_loc), dt), fleet_axes + (block_axis,))
        y0 = mark(jnp.zeros((Bb, m_loc), dt), fleet_axes + (block_axis,))
        n_dim = Pm.shape[-1]
        mem = settings.anderson_memory
        aa0 = None
        if mem > 0:
            # Anderson history, stored split to respect the shardings: the
            # x-part replicated over blocks, the w = z + y/rho part
            # row-sharded (see models/anderson.py for the math; the Gram
            # matrix below psums the w contribution so every shard solves
            # the identical MxM system).
            rep_leaf = lambda shape: mark(jnp.zeros(shape, dt), fleet_axes)
            row_leaf = lambda shape: mark(jnp.zeros(shape, dt),
                                          fleet_axes + (block_axis,))
            aa0 = {
                "Sx": rep_leaf((Bb, mem, n_dim)), "Fx": rep_leaf((Bb, mem, n_dim)),
                "Sw": row_leaf((Bb, mem, m_loc)), "Fw": row_leaf((Bb, mem, m_loc)),
                "px": rep_leaf((Bb, n_dim)), "fx": rep_leaf((Bb, n_dim)),
                "pw": row_leaf((Bb, m_loc)), "fw": row_leaf((Bb, m_loc)),
                "count": mark(jnp.zeros((Bb,), jnp.int32), fleet_axes),
            }
        hist0 = None
        if settings.record_history:
            tbuf = lambda: mark(
                jnp.full((settings.num_checks, Bb), jnp.inf, dt), fleet_axes)
            hist0 = {"res_prim": tbuf(), "res_dual": tbuf(), "rho": tbuf()}
        state0 = (
            mark(jnp.zeros((Bb, n_dim), dt), fleet_axes), z0, y0,
            rho0, rho0, factor(rho0),
            mark(jnp.zeros((Bb,), jnp.int32), fleet_axes),   # status
            mark(jnp.zeros((Bb,), jnp.int32), fleet_axes),   # per-lane iters
            jnp.zeros((), jnp.int32),                        # global iteration
            mark(jnp.full((Bb,), jnp.inf, dt), fleet_axes),
            mark(jnp.full((Bb,), jnp.inf, dt), fleet_axes),
            aa0,   # None when anderson_memory == 0 (leafless pytree node)
            hist0,  # None unless record_history (leafless pytree node)
        )
        max_total = settings.num_checks * settings.check_interval

        def cond(st):
            return (st[8] < max_total) & jnp.any(st[6] == Status.RUNNING)

        def body(st):
            (x, z, y, rho, rho_cand, M_inv, status, iters, it, rp, rd, aa,
             hist) = st
            if settings.adaptive_rho:
                f = settings.rho_factor
                trip = ((status == Status.RUNNING)
                        & ((rho_cand * f < rho) | (rho_cand > f * rho)))
                rho = jnp.where(trip, rho_cand, rho)
                M_inv = jax.lax.cond(
                    jnp.any(trip), lambda _: factor(rho), lambda mi: mi, M_inv)
                if aa is not None:
                    # Re-adopted rho changes the w = z + y/rho encoding —
                    # restart the lane's history (models/anderson.py).
                    aa = _aa_reset(aa, trip)

            active = (status == Status.RUNNING)[:, None]
            rho_row = rho_rows(rho)

            def step(_, carry):
                x, z, y, xp, zp = carry
                xx, zz = kkt_solve(M_inv, rho, x, z, y)
                xp, zp = x, z
                x_new = alpha * xx + alpha1 * xp
                z_new = jnp.clip(alpha * zz + alpha1 * zp + y / rho_row, l, u)
                y_new = y + rho_row * (alpha * zz + alpha1 * zp - z_new)
                x = jnp.where(active, x_new, xp)
                z = jnp.where(active, z_new, zp)
                y = jnp.where(active, y_new, y)
                return x, z, y, xp, zp

            x_start, z_start, y_start = x, z, y  # chunk-start (certificates + AA)
            x, z, y, xp, zp = jax.lax.fori_loop(
                0, settings.check_interval, step, (x, z, y, x, z))
            it = it + settings.check_interval

            aa_accept = None
            if aa is not None:
                # Anderson step in the sharded coordinates: the x-part of
                # the fixed-point vector is replicated over blocks, the
                # w = z + y/rho part row-sharded; Gram/inner products psum
                # the w contribution so every shard solves the identical
                # MxM mixing system (math: models/anderson.py).
                act_vec = status == Status.RUNNING
                w_in = z_start + y_start / rho_row
                w_pl = z + y / rho_row
                fx = x - x_start
                fw = w_pl - w_in
                have = aa["count"] >= 1
                slot = jnp.where(have, (aa["count"] - 1) % mem, 0)
                onehot = jnp.arange(mem)[None, :] == slot[:, None]
                push = (onehot & have[:, None])[..., None]
                Sx = jnp.where(push, (x_start - aa["px"])[:, None, :], aa["Sx"])
                Fx = jnp.where(push, (fx - aa["fx"])[:, None, :], aa["Fx"])
                Sw = jnp.where(push, (w_in - aa["pw"])[:, None, :], aa["Sw"])
                Fw = jnp.where(push, (fw - aa["fw"])[:, None, :], aa["Fw"])
                from ..models.anderson import aa_gamma

                G = (jnp.einsum("bid,bjd->bij", Fx, Fx)
                     + psum(jnp.einsum("bid,bjd->bij", Fw, Fw)))
                rhs_g = (jnp.einsum("bid,bd->bi", Fx, fx)
                         + psum(jnp.einsum("bid,bd->bi", Fw, fw)))
                gamma = aa_gamma(G, rhs_g, mem, settings.anderson_reg, dt)
                x_a = x - jnp.einsum("bi,bid->bd", gamma, Sx + Fx)
                w_a = w_pl - jnp.einsum("bi,bid->bd", gamma, Sw + Fw)
                z_a = jnp.clip(w_a, l, u)
                y_a = rho_row * (w_a - z_a)

                def _margin(xv, zv, yv):
                    Axv = matvec(A, xv)
                    Pxv = matvec(Pm, xv)
                    ATyv = psum(matvec_t(A, yv))
                    rpv = pmax(inf_norm(Axv - zv))
                    rdv = inf_norm(Pxv + q + ATyv)
                    mpv = jnp.maximum(pmax(inf_norm(Axv)), pmax(inf_norm(zv)))
                    mdv = jnp.maximum(jnp.maximum(inf_norm(Pxv), inf_norm(ATyv)),
                                      inf_norm(q))
                    marg = jnp.maximum(
                        rpv / (settings.eps_abs + settings.eps_rel * mpv),
                        rdv / (settings.eps_abs + settings.eps_rel * mdv))
                    return marg, (Axv, Pxv, ATyv)

                m_p, pr_p = _margin(x, z, y)
                m_a, pr_a = _margin(x_a, z_a, y_a)
                aa_accept = act_vec & have & jnp.isfinite(m_a) & (m_a < m_p)
                rejected = act_vec & have & ~aa_accept
                sel = aa_accept[:, None]
                x = jnp.where(sel, x_a, x)
                z = jnp.where(sel, z_a, z)
                y = jnp.where(sel, y_a, y)
                Ax = jnp.where(sel, pr_a[0], pr_p[0])
                Px = jnp.where(sel, pr_a[1], pr_p[1])
                ATy = jnp.where(sel, pr_a[2], pr_p[2])
                r3 = rejected[:, None, None]
                a2 = act_vec[:, None]
                aa = {
                    "Sx": jnp.where(r3, 0.0, Sx), "Fx": jnp.where(r3, 0.0, Fx),
                    "Sw": jnp.where(r3, 0.0, Sw), "Fw": jnp.where(r3, 0.0, Fw),
                    "px": jnp.where(a2, x_start, aa["px"]),
                    "fx": jnp.where(a2, fx, aa["fx"]),
                    "pw": jnp.where(a2, w_in, aa["pw"]),
                    "fw": jnp.where(a2, fw, aa["fw"]),
                    "count": jnp.where(rejected, 1,
                                       jnp.where(act_vec, aa["count"] + 1,
                                                 aa["count"])),
                }
            else:
                Ax = matvec(A, x)
                Px = matvec(Pm, x)
                ATy = psum(matvec_t(A, y))
            res_prim = pmax(inf_norm(Ax - z))
            res_dual = inf_norm(Px + q + ATy)
            max_prim = jnp.maximum(pmax(inf_norm(Ax)), pmax(inf_norm(z)))
            max_dual = jnp.maximum(
                jnp.maximum(inf_norm(Px), inf_norm(ATy)), inf_norm(q))
            act = status == Status.RUNNING

            if settings.adaptive_rho:
                den = res_dual * max_prim
                cand = jnp.clip(
                    rho * jnp.sqrt(res_prim * max_dual
                                   / jnp.where(den == 0, 1.0, den)),
                    RHO_MIN, RHO_MAX).astype(dt)
                ok = jnp.isfinite(cand) & (den != 0) & (cand > 0)
                rho_cand = jnp.where(act & ok, cand, rho_cand)

            solved = ((res_prim < settings.eps_abs + settings.eps_rel * max_prim)
                      & (res_dual < settings.eps_abs + settings.eps_rel * max_dual))
            ulp = jnp.asarray(8 * jnp.finfo(dt).eps, dt)
            eps_admm = jnp.asarray(settings.eps_admm, dt)
            fp = ((pmax(inf_norm(x - xp))
                   <= eps_admm + ulp * jnp.maximum(inf_norm(x), 1.0))
                  & (pmax(inf_norm(z - zp))
                     <= eps_admm + ulp * jnp.maximum(pmax(inf_norm(z)), 1.0)))
            if aa_accept is not None:
                # Accepted AA lanes compare x against the plain chunk's
                # penultimate iterate — a different map's point; veto the
                # fixed-point flag for them (models/admm.py discipline).
                fp &= ~aa_accept
            status = jnp.where(act & solved, Status.SOLVED, status)
            status = jnp.where(act & fp, Status.SOLVED_ADMM, status)
            if settings.check_infeasibility:
                # OSQP §3.4 iterate-difference certificates, distributed:
                # same math and anti-false-positive gates as
                # models/admm.py:_infeasibility_certificates, with the
                # row-space reductions (norms, support function, the
                # every-row test) psum/pmax'd over the block axis. A
                # certificate outranks the fixed-point flag but not SOLVED.
                eps_p = jnp.asarray(settings.eps_prim_inf, dt)
                eps_d = jnp.asarray(settings.eps_dual_inf, dt)
                dy = y - y_start                     # row-sharded
                dx = x - x_start                     # replicated
                ndy = pmax(inf_norm(dy))
                pos = jnp.maximum(dy, 0.0)
                neg = jnp.minimum(dy, 0.0)
                tol = (eps_p * ndy)[:, None]
                term_u = jnp.where(jnp.isfinite(u), u * pos,
                                   jnp.where(pos > tol, jnp.inf, 0.0))
                term_l = jnp.where(jnp.isfinite(l), l * neg,
                                   jnp.where(neg < -tol, jnp.inf, 0.0))
                support = psum(jnp.sum(term_u + term_l, axis=-1))
                Atdy = psum(matvec_t(A, dy))
                prim_inf = ((ndy > 0)
                            & (inf_norm(Atdy) <= eps_p * ndy)
                            & (support <= -eps_p * ndy))
                ndx = inf_norm(dx)
                Adx = matvec(A, dx)
                tol_d = (eps_d * ndx)[:, None]
                fin_l = jnp.isfinite(l)
                fin_u = jnp.isfinite(u)
                ok_rows = jnp.where(
                    fin_l & fin_u, jnp.abs(Adx) <= tol_d,
                    jnp.where(fin_l, Adx >= -tol_d,
                              jnp.where(fin_u, Adx <= tol_d, True)))
                all_ok = psum(jnp.sum((~ok_rows).astype(jnp.int32),
                                      axis=-1)) == 0
                dual_inf = ((ndx > 0)
                            & (inf_norm(matvec(Pm, dx)) <= eps_d * ndx)
                            & (jnp.sum(q * dx, axis=-1) <= -eps_d * ndx)
                            & all_ok)
                noise = 16 * jnp.finfo(dt).eps
                eps_prim = settings.eps_abs + settings.eps_rel * max_prim
                eps_dual = settings.eps_abs + settings.eps_rel * max_dual
                prim_inf &= (res_prim > 10 * eps_prim) & (
                    ndy > noise * jnp.maximum(pmax(inf_norm(y)), 1.0))
                dual_inf &= (res_dual > 10 * eps_dual) & (
                    ndx > noise * jnp.maximum(inf_norm(x), 1.0))
                overridable = act & (status != Status.SOLVED)
                status = jnp.where(overridable & prim_inf,
                                   Status.PRIMAL_INFEASIBLE, status)
                status = jnp.where(overridable & dual_inf & ~prim_inf,
                                   Status.DUAL_INFEASIBLE, status)
            status = status.astype(jnp.int32)
            newly = act & (status != Status.RUNNING)
            iters = jnp.where(newly, it, iters)
            rp = jnp.where(act, res_prim, rp)
            rd = jnp.where(act, res_dual, rd)
            if settings.record_history:
                # rho recorded is the chunk's (post-adoption) value; the
                # residuals are the globally-reduced ones every shard holds.
                idx = it // settings.check_interval - 1
                hist = {
                    "res_prim": hist["res_prim"].at[idx].set(res_prim),
                    "res_dual": hist["res_dual"].at[idx].set(res_dual),
                    "rho": hist["rho"].at[idx].set(rho),
                }
            return (x, z, y, rho, rho_cand, M_inv, status, iters, it, rp, rd,
                    aa, hist)

        final = jax.lax.while_loop(cond, body, state0)
        (x, z, y, rho, _, _, status, iters, it, rp, rd, _, hist) = final
        exhausted = status == Status.RUNNING
        status = jnp.where(exhausted, Status.MAX_ITERATIONS, status).astype(jnp.int32)
        iters = jnp.where(exhausted, it, iters)

        if settings.polish_iterations > 0:
            x, y = polish_block(x, z, y)
        out = (x, z, y, status, iters, rp, rd, rho)
        if settings.record_history:
            out += (hist["res_prim"], hist["res_dual"], hist["rho"])
        return out

    sharding = lambda spec: NamedSharding(mesh, spec)
    Pm = jax.device_put(qp.P, sharding(P(fa, None, None)))
    q = jax.device_put(qp.q, sharding(P(fa, None)))
    A = jax.device_put(qp.A, sharding(P(fa, block_axis, None)))
    l = jax.device_put(qp.l, sharding(P(fa, block_axis)))
    u = jax.device_put(qp.u, sharding(P(fa, block_axis)))

    # Full-FP32 matmuls, no TF32 (see the models/admm.py rationale);
    # the context is trace-time, so wrapping the first (tracing) call suffices.
    with jax.default_matmul_precision("highest"):
        out = run(Pm, q, A, l, u)
    x, z, y, status, iters, rp, rd, rho = out[:8]
    history = None
    if settings.record_history:
        history = {"res_prim": out[8], "res_dual": out[9], "rho": out[10]}
    # Return duals/splits at the caller's constraint count, not the
    # mesh-padded one (padded rows carry z = y = 0 and never bind).
    z = z[..., :m_orig]
    y = y[..., :m_orig]
    info = SolveInfo(
        status=status, iterations=iters, res_prim=rp, res_dual=rd, rho=rho,
        objective=qp.objective(x), history=history)
    return Solution(x=x, z=z, y=y, info=info)
