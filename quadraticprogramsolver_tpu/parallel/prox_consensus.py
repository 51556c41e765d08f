"""Block-split distributed prox-ALM: one large split-form QP with its
constraint rows sharded over a device mesh.

The model-parallel axis for the SECOND solver family
(`/root/reference/ProxQP.jl:118-298`), mirroring parallel/consensus.py's
design for the box form: x stays replicated across the block axis; the
equality rows (A, b, y) and inequality rows (C, d, s, z) are row-sharded;
every shard computes the identical x-update because all x-space quantities
are psum-reduced:

  * M = P + rho * psum_blocks(A_d'A_d + C_d'C_d) + sigma*I   (SPD — the
    single-matrix structure that makes prox-ALM split so cleanly)
  * rhs r = -q + sigma*x + psum_blocks(A_d'(rho b_d - y_d)
                                       + C_d'(rho(d_d - s_d) - z_d))
  * dual residual ||Px + q + psum(A'y) + psum(C'z)||_inf
  * primal residual / norms: per-shard inf-norms reduced with pmax

s/y/z updates are purely row-local (no communication). Per-iteration
traffic: one n-vector psum for the rhs — less than the box form's two,
because zz is never formed. The PIQP convergence criteria and the
tau-triggered double-sqrt adaptive rho follow models/proxqp.py exactly
(ProxQP.jl:252-298, :277-286), with the refactor running as a psum'd gram
rebuild under `lax.cond`.

Not supported here: the equality-KKT warm start (it would need the full A
gathered on every shard — start is zeros, the `kkt_warm_start=False`
semantics; compare against the single-device solve with the same flag),
and Anderson acceleration.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.problem import ProxQPProblem
from ..core.settings import ProxQPSettings
from ..core.state import Status
from ..models.proxqp import ProxQPInfo, ProxQPSolution
from ..ops.linalg import add_scaled_identity, inf_norm, matvec, matvec_t, spd_inverse
from .consensus import BLOCK_AXIS


def _pad_rows(prob: ProxQPProblem, n_shards: int) -> ProxQPProblem:
    """Pad equality/inequality rows to multiples of the block axis.

    Padded equality rows are 0 = 0 (y stays at its 0 init); padded
    inequality rows are 0 <= 0 (s = z = 0 are fixed points of the updates).
    Neither contributes to residuals or reductions.
    """
    me_pad = -(-prob.n_eq // n_shards) * n_shards
    mi_pad = -(-prob.n_ineq // n_shards) * n_shards
    if (me_pad, mi_pad) == (prob.n_eq, prob.n_ineq):
        return prob
    de, di = me_pad - prob.n_eq, mi_pad - prob.n_ineq
    pad = lambda x, k: jnp.pad(x, [(0, k)] + [(0, 0)] * (x.ndim - 1))
    return ProxQPProblem(
        P=prob.P, q=prob.q,
        A=pad(prob.A, de), b=pad(prob.b, de),
        C=pad(prob.C, di), d=pad(prob.d, di))


def solve_prox_block_split(prob: ProxQPProblem,
                           settings: ProxQPSettings = ProxQPSettings(),
                           mesh: Mesh | None = None) -> ProxQPSolution:
    """Solve one large dense split-form QP with constraint rows sharded
    over a 1-D mesh. Matches the single-device solve run with
    ``kkt_warm_start=False`` (tested to ~1e-9 on the CPU mesh)."""
    if prob.batch_shape:
        raise ValueError("solve_prox_block_split takes a single (unbatched) "
                         "ProxQPProblem; fleets shard with solve_prox_fleet")
    if settings.anderson_memory > 0:
        raise ValueError("Anderson acceleration is not supported in the "
                         "block-split prox solver (single-device layouts)")
    if settings.sigma_free_rhs:
        raise ValueError("sigma_free_rhs caches are single-device layouts; "
                         "the block-split solver builds M^{-1} via psum'd "
                         "gram blocks instead")
    if mesh is None:
        mesh = Mesh(np.asarray(jax.devices()), (BLOCK_AXIS,))
    block_axis = mesh.axis_names[0]
    n_shards = mesh.shape[block_axis]
    me_orig, mi_orig = prob.n_eq, prob.n_ineq
    prob = _pad_rows(prob, n_shards)

    rep = P()
    row = P(block_axis)
    in_specs = (rep, rep, P(block_axis, None), row, P(block_axis, None), row)
    out_specs = (rep, row, row, row, rep, rep, rep, rep, rep) + (
        (P(None), P(None), P(None)) if settings.record_history else ())

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    def run(Pm, q, A, b, C, d):
        dt = Pm.dtype
        n = Pm.shape[-1]
        sigma = jnp.asarray(settings.sigma, dt)

        def psum(v):
            return jax.lax.psum(v, block_axis)

        def pmax(v):
            return jax.lax.pmax(v, block_axis)

        def factor(rho):
            K = psum(jnp.einsum("ki,kj->ij", A, A)
                     + jnp.einsum("ki,kj->ij", C, C))
            return spd_inverse(add_scaled_identity(Pm + rho * K, sigma))

        def mark(v):
            return jax.lax.pcast(v, block_axis, to="varying")

        rho0 = jnp.asarray(settings.rho, dt)
        x0 = jnp.zeros((n,), dt)
        y0 = mark(jnp.zeros((A.shape[0],), dt))
        s0 = jnp.maximum(d, 0.0)        # d is row-sharded: already varying
        z0 = mark(jnp.zeros((C.shape[0],), dt))
        hist0 = None
        if settings.record_history:
            tbuf = lambda: jnp.full((settings.num_checks,), jnp.inf, dt)
            hist0 = {"res_prim": tbuf(), "res_dual": tbuf(), "rho": tbuf()}
        prods0 = None
        if settings.check_infeasibility:
            # Start-point products for the certificate deltas (the x-space
            # pieces replicated via psum, row pieces local).
            prods0 = {"Px": matvec(Pm, x0),
                      "Aty": psum(matvec_t(A, y0)),
                      "Ctz": psum(matvec_t(C, z0)),
                      "Ax": matvec(A, x0), "Cx": matvec(C, x0)}
        state0 = (x0, y0, s0, z0, rho0, factor(rho0),
                  jnp.zeros((), jnp.int32),                      # status
                  jnp.asarray(settings.num_checks
                              * settings.check_interval, jnp.int32),
                  jnp.asarray(jnp.inf, dt), jnp.asarray(jnp.inf, dt),
                  jnp.zeros((), jnp.int32),                      # iteration
                  prods0, hist0)
        max_total = settings.num_checks * settings.check_interval

        def cond(st):
            return (st[10] < max_total) & (st[6] == Status.RUNNING)

        def body(st):
            (x, y, s, z, rho, M_inv, status, iters, rp_out, rd_out, it,
             prods_prev, hist) = st
            running = status == Status.RUNNING

            def one_iter(_, state):
                x, s, y, z = state
                r = (-q + sigma * x
                     + psum(matvec_t(A, rho * b - y)
                            + matvec_t(C, rho * (d - s) - z)))
                x = matvec(M_inv, r)
                for _ in range(settings.kkt_refinement_steps):
                    Mx = (matvec(Pm, x) + sigma * x
                          + rho * psum(matvec_t(A, matvec(A, x))
                                       + matvec_t(C, matvec(C, x))))
                    x = x + matvec(M_inv, r - Mx)
                Cx = matvec(C, x)
                s = jnp.maximum(d - Cx - z / rho, 0.0)
                y = y + rho * (matvec(A, x) - b)
                z = jnp.maximum(z + rho * (Cx - d + s), 0.0)
                return x, s, y, z

            x_in, s_in, y_in, z_in = x, s, y, z
            x, s, y, z = jax.lax.fori_loop(
                0, settings.check_interval, one_iter, (x, s, y, z))
            it = it + settings.check_interval

            # PIQP criteria 13a-c, globally reduced (ProxQP.jl:252-298).
            Px = matvec(Pm, x)
            Aty = psum(matvec_t(A, y))
            Ctz = psum(matvec_t(C, z))
            Ax = matvec(A, x)
            Cx = matvec(C, x)
            res_prim = jnp.maximum(pmax(inf_norm(Ax - b)),
                                   pmax(inf_norm(Cx - d + s)))
            res_dual = inf_norm(Px + Aty + Ctz + q)
            max_prim = jnp.max(jnp.stack(
                [pmax(inf_norm(Ax)), pmax(inf_norm(b)), pmax(inf_norm(Cx)),
                 pmax(inf_norm(d)), pmax(inf_norm(s))]))
            max_dual = jnp.max(jnp.stack(
                [inf_norm(Px), inf_norm(Aty), inf_norm(Ctz), inf_norm(q)]))
            eps_prim_t = settings.eps_abs + settings.eps_rel * max_prim
            eps_dual_t = settings.eps_abs + settings.eps_rel * max_dual
            now_conv = (res_prim < eps_prim_t) & (res_dual < eps_dual_t)
            status = jnp.where(running & now_conv, Status.SOLVED, status)

            if settings.check_infeasibility:
                # Split-form Farkas certificates, distributed (math:
                # models/proxqp.py check_infeasibility block; row-space
                # reductions psum/pmax over the block axis).
                eps_pi = jnp.asarray(settings.eps_prim_inf, dt)
                eps_di = jnp.asarray(settings.eps_dual_inf, dt)
                dy = y - y_in
                dz = z - z_in
                dx = x - x_in
                ndyz = jnp.maximum(pmax(inf_norm(dy)), pmax(inf_norm(dz)))
                stat = inf_norm((Aty - prods_prev["Aty"])
                                + (Ctz - prods_prev["Ctz"]))
                gap = psum(jnp.sum(b * dy) + jnp.sum(d * dz))
                sign_bad = psum(jnp.sum(
                    (dz < -(eps_pi * ndyz)).astype(jnp.int32)))
                prim_inf = ((ndyz > 0) & (stat <= eps_pi * ndyz)
                            & (gap <= -eps_pi * ndyz) & (sign_bad == 0))
                ndx = inf_norm(dx)
                Cdx = Cx - prods_prev["Cx"]
                cdx_bad = psum(jnp.sum((Cdx > eps_di * ndx).astype(jnp.int32)))
                dual_inf = ((ndx > 0)
                            & (inf_norm(Px - prods_prev["Px"]) <= eps_di * ndx)
                            & (pmax(inf_norm(Ax - prods_prev["Ax"]))
                               <= eps_di * ndx)
                            & (cdx_bad == 0)
                            & (jnp.sum(q * dx) <= -eps_di * ndx))
                noise = 16 * jnp.finfo(dt).eps
                yz_scale = jnp.maximum(
                    jnp.maximum(pmax(inf_norm(y)), pmax(inf_norm(z))), 1.0)
                prim_inf &= (res_prim > 10 * eps_prim_t) & (ndyz > noise * yz_scale)
                dual_inf &= (res_dual > 10 * eps_dual_t) & (
                    ndx > noise * jnp.maximum(inf_norm(x), 1.0))
                overridable = running & (status == Status.RUNNING)
                status = jnp.where(overridable & prim_inf,
                                   Status.PRIMAL_INFEASIBLE, status)
                status = jnp.where(overridable & dual_inf & ~prim_inf,
                                   Status.DUAL_INFEASIBLE, status)
                prods_prev = {"Px": Px, "Aty": Aty, "Ctz": Ctz,
                              "Ax": Ax, "Cx": Cx}
            status = status.astype(jnp.int32)
            newly = running & (status != Status.RUNNING)
            iters = jnp.where(newly, it, iters)
            rp_out = jnp.where(running, res_prim, rp_out)
            rd_out = jnp.where(running, res_dual, rd_out)
            if settings.record_history:
                idx = it // settings.check_interval - 1
                hist = {
                    "res_prim": hist["res_prim"].at[idx].set(res_prim),
                    "res_dual": hist["res_dual"].at[idx].set(res_dual),
                    "rho": hist["rho"].at[idx].set(rho),
                }

            if settings.adaptive_rho:
                num = res_prim * max_dual
                den = res_dual * max_prim
                ratio = num / jnp.where(den == 0, 1.0, den)
                trip = (running & jnp.isfinite(ratio) & (den != 0)
                        & ((ratio > settings.tau)
                           | (1.0 / jnp.where(ratio == 0, 1.0, ratio)
                              > settings.tau)))
                rho_new = jnp.clip(
                    rho * jnp.sqrt(jnp.sqrt(jnp.where(trip, ratio, 1.0))),
                    settings.rho_min, settings.rho_max).astype(dt)
                rho = jnp.where(trip, rho_new, rho)
                M_inv = jax.lax.cond(trip, lambda _: factor(rho),
                                     lambda mi: mi, M_inv)

            return (x, y, s, z, rho, M_inv, status, iters, rp_out, rd_out,
                    it, prods_prev, hist)

        final = jax.lax.while_loop(cond, body, state0)
        (x, y, s, z, rho, _, status, iters, rp_out, rd_out, it, _, hist) = final
        status = jnp.where(status == Status.RUNNING, Status.MAX_ITERATIONS,
                           status).astype(jnp.int32)
        out = (x, y, s, z, status, iters, rp_out, rd_out, rho)
        if settings.record_history:
            out += (hist["res_prim"], hist["res_dual"], hist["rho"])
        return out

    sharding = lambda spec: NamedSharding(mesh, spec)
    Pm = jax.device_put(prob.P, sharding(P(None, None)))
    q = jax.device_put(prob.q, sharding(P(None)))
    A = jax.device_put(prob.A, sharding(P(block_axis, None)))
    b = jax.device_put(prob.b, sharding(P(block_axis)))
    C = jax.device_put(prob.C, sharding(P(block_axis, None)))
    d = jax.device_put(prob.d, sharding(P(block_axis)))

    with jax.default_matmul_precision("highest"):
        out = run(Pm, q, A, b, C, d)
    x, y, s, z, status, iters, rp, rd, rho = out[:9]
    history = None
    if settings.record_history:
        history = {"res_prim": out[9], "res_dual": out[10], "rho": out[11]}
    info = ProxQPInfo(
        converged=status == Status.SOLVED, iterations=iters,
        res_prim=rp, res_dual=rd, rho=rho, status=status, history=history)
    return ProxQPSolution(x=x, s=s[:mi_orig], y=y[:me_orig], z=z[:mi_orig],
                          info=info)
