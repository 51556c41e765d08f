"""One huge sparse QP row-sharded over a device mesh (matrix-free PCG path).

The reference routes large/sparse problems to PCG instead of factorizing
(`/root/reference/SolveQuadraticProgram.m:190-204`); SURVEY §5's scale-axes
row mandates the distributed version: "matrix-free PCG so A never
materializes per-chip". This module is that axis — the sparse sibling of
parallel/consensus.py's dense block-split:

  * A's rows are sharded: shard d holds the ELL row block A_d (m_loc, kA)
    with global column indices into the replicated x.
  * A' lives as per-shard COLUMN partials: shard d stores (A_d)' as its own
    row-ELL (n, kAt_d) with columns indexing the LOCAL w_d — so
    A'w = psum_d((A_d)' w_d) is one gather-matvec plus one psum.
  * P is sharded the same way (P symmetric: column block d = row block d
    transposed), stored as per-shard column partials with global indices, so
    P v = psum_d((P_d)' v) — every n-space result flows through psum, which
    keeps it vma-invariant (replicated) across shards.
  * Row-space vectors (z, y, l, u) are sharded; n-space vectors replicated.

The inner Jacobi-PCG runs on replicated (n,) vectors — all its inner
products are computed identically on every shard (the only cross-shard data
flows through deterministic psum/all_gather), so the distributed iterates
are bitwise-reproducible and match the single-device SparseQP solve.
Residual checks pmax/psum their row-space pieces exactly like consensus.py;
adaptive rho, Ruiz-scaled termination (host pre-scaling), and the OSQP §3.4
infeasibility certificates all run distributed, with no feature gaps vs
the single-device solver:

  * **Vector-rho** (Settings.rho_eq_scale): weights derive from each row's
    own l/u, so every shard computes its slice locally; the weighted Jacobi
    diagonal of A'WA is one scatter-add + psum per solve.
  * **Anderson acceleration** (Settings.anderson_memory): history buffers
    split like the iterates (x-part replicated, w = z + y/rho row-sharded);
    the M x M mixing Gram psums its row contribution so every shard solves
    the identical system; safeguard margins are evaluated on UNSCALED
    residuals (the termination space) exactly like models/anderson.py.
  * **Polish** (Settings.polish_iterations): matrix-free MINRES on the
    masked active-set KKT (models/polish.py:polish_minres math,
    reference m:289-325) with psum'd Lanczos inner products and pmax'd
    acceptance metrics — the sparse sibling of consensus.py:polish_block.

All three are tested to match the single-device SparseQP solve
iterate-for-iterate (tests/test_sparse_mesh.py).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.pytree import pytree_dataclass as _pytree_dataclass
from ..core.settings import RHO_MAX, RHO_MIN, Settings
from ..core.state import SolveInfo, Solution, Status
from ..models.kkt import _pcg
from ..ops.linalg import inf_norm

SPARSE_AXIS = "rows"


def _ell(vals, cols, v):
    return jnp.sum(vals * v[cols], axis=-1)


@_pytree_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedSparseQP:
    """Host-prepared shards, stacked on a leading (n_shards,) axis."""

    A_vals: jax.Array    # (D, m_loc, kA)   row block of A, global cols
    A_cols: jax.Array
    Atp_vals: jax.Array  # (D, n, kAt)      (A_d)' partial, LOCAL cols
    Atp_cols: jax.Array
    Ptp_vals: jax.Array  # (D, n, kP)       (P rows d)' partial, GLOBAL cols
    Ptp_cols: jax.Array
    q: jax.Array         # (n,) replicated
    l: jax.Array         # (D, m_loc)
    u: jax.Array         # (D, m_loc)
    dP: jax.Array        # (n,) replicated
    dAtA: jax.Array      # (n,) replicated
    e_scale: jax.Array   # (D, m_loc) Ruiz row scales (ones when unscaled)

    @property
    def n(self) -> int:
        return self.q.shape[0]

    @property
    def n_shards(self) -> int:
        return self.A_vals.shape[0]

    @property
    def dtype(self):
        return self.q.dtype


def shard_sparse_qp(P, q, A, l, u, n_shards: int, dtype=np.float32,
                    scaling=None) -> ShardedSparseQP:
    """Partition scipy-sparse (P, q, A, l, u) into row shards (host-side).

    Constraint rows pad to a multiple of ``n_shards`` with inert rows
    (all-zero, l = -inf, u = +inf); P's rows pad with zeros (the all_gather
    result is sliced back to n). ``scaling``: an optional
    :class:`~..models.scaling.ScalingData` from ``equilibrate_sparse_host``
    whose row scales ``e`` are sharded alongside (pass the SCALED matrices
    here, exactly like the single-device pre-scaled path).
    """
    import scipy.sparse as sp

    from ..core.sparse_problem import _to_ell

    P = sp.csr_matrix(P).astype(dtype)
    A = sp.csr_matrix(A).astype(dtype)
    m, n = A.shape
    D = n_shards
    m_loc = -(-m // D) * D // D
    n_loc = -(-n // D) * D // D

    l = np.asarray(l, np.float64)
    u = np.asarray(u, np.float64)
    l_pad = np.full(D * m_loc, -np.inf)
    u_pad = np.full(D * m_loc, np.inf)
    l_pad[:m] = l
    u_pad[:m] = u
    e = np.ones(D * m_loc, dtype)
    if scaling is not None:
        e[:m] = np.asarray(scaling.e, dtype)

    A_pad = sp.vstack(
        [A, sp.csr_matrix((D * m_loc - m, n), dtype=dtype)], format="csr")
    P_pad = sp.vstack(
        [P, sp.csr_matrix((D * n_loc - n, n), dtype=dtype)], format="csr")

    Av, Ac, Atv, Atc, Pv, Pc = [], [], [], [], [], []
    for d in range(D):
        Ad = A_pad[d * m_loc:(d + 1) * m_loc]
        v, c = _to_ell(Ad, dtype)
        Av.append(v)
        Ac.append(c)
        v, c = _to_ell(Ad.T.tocsr(), dtype)   # (n, kAt_d), cols in [0, m_loc)
        Atv.append(v)
        Atc.append(c)
        # (P rows d)' = P's column block d (n, n_loc), applied to the FULL
        # replicated v: shift its local column indices to global.
        v, c = _to_ell(P_pad[d * n_loc:(d + 1) * n_loc].T.tocsr(), dtype)
        c = np.where(v != 0, c + d * n_loc, 0).astype(np.int32)
        Pv.append(v)
        Pc.append(c)

    def stack_pad(blocks, fill):
        k = max(b.shape[-1] for b in blocks)
        out = [np.pad(b, [(0, 0), (0, k - b.shape[-1])],
                      constant_values=fill) for b in blocks]
        return jnp.asarray(np.stack(out))

    dAtA = np.asarray(A.multiply(A).sum(axis=0)).ravel().astype(dtype)
    return ShardedSparseQP(
        A_vals=stack_pad(Av, 0), A_cols=stack_pad(Ac, 0),
        Atp_vals=stack_pad(Atv, 0), Atp_cols=stack_pad(Atc, 0),
        Ptp_vals=stack_pad(Pv, 0), Ptp_cols=stack_pad(Pc, 0),
        q=jnp.asarray(np.asarray(q, dtype)),
        l=jnp.asarray(l_pad.astype(dtype).reshape(D, m_loc)),
        u=jnp.asarray(u_pad.astype(dtype).reshape(D, m_loc)),
        dP=jnp.asarray(np.asarray(P.diagonal(), dtype)),
        dAtA=jnp.asarray(dAtA),
        e_scale=jnp.asarray(e.reshape(D, m_loc)),
    )


def _zero_carry(sq: ShardedSparseQP, settings: Settings):
    """Fresh solve-space carry (x, z, y, rho, rho_cand[, aa]) — the state a
    cold solve starts from and a segment boundary hands forward."""
    n, D, m_loc = sq.n, sq.n_shards, sq.l.shape[-1]
    dt = sq.dtype
    rho = jnp.asarray(settings.rho, dt)
    carry = {
        "x": jnp.zeros((n,), dt),
        "z": jnp.zeros((D, m_loc), dt),
        "y": jnp.zeros((D, m_loc), dt),
        "rho": rho,
        "rho_cand": rho,
    }
    mem = settings.anderson_memory
    if mem > 0:
        carry["aa"] = {
            "Sx": jnp.zeros((mem, n), dt), "Fx": jnp.zeros((mem, n), dt),
            "Sw": jnp.zeros((D, mem, m_loc), dt),
            "Fw": jnp.zeros((D, mem, m_loc), dt),
            "px": jnp.zeros((n,), dt), "fx": jnp.zeros((n,), dt),
            "pw": jnp.zeros((D, m_loc), dt), "fw": jnp.zeros((D, m_loc), dt),
            "count": jnp.zeros((), jnp.int32),
        }
    return carry


def solve_sparse_mesh(sq: ShardedSparseQP, settings: Settings = Settings(),
                      mesh: Mesh | None = None, m_orig: int | None = None,
                      scaling=None, carry=None, return_carry: bool = False):
    """Solve the row-sharded sparse QP. Same math as models/admm.py's CG
    path; iterates match the single-device SparseQP solve check-for-check.

    ``scaling``: the ScalingData whose matrices ``sq`` was built from
    (termination then runs on UNSCALED residuals and the returned solution
    is unscaled, exactly like solve(scaling=...)).

    ``carry``/``return_carry``: warm-start from / hand back the raw
    solve-space state (x, z, y, rho, rho_cand[, aa]) — the segment
    interface :func:`solve_sparse_mesh_segmented` builds on (the mesh
    sibling of models/admm.py:solve_segmented's carry). The carry is
    PRE-polish: polish refines only the returned Solution.
    """
    if mesh is None:
        mesh = Mesh(np.asarray(jax.devices()[:sq.n_shards]), (SPARSE_AXIS,))
    ax = mesh.axis_names[0]
    if mesh.shape[ax] != sq.n_shards:
        raise ValueError(f"mesh has {mesh.shape[ax]} devices, data has "
                         f"{sq.n_shards} shards")
    n = sq.n
    D = sq.n_shards
    m_pad = sq.l.shape[-1] * D
    m_out = m_pad if m_orig is None else m_orig
    dt = sq.dtype
    if carry is None:
        carry = _zero_carry(sq, settings)

    if scaling is not None:
        d_scale = jnp.asarray(scaling.d, dt)
        c_scale = jnp.asarray(scaling.c, dt)
    else:
        d_scale = jnp.ones((n,), dt)
        c_scale = jnp.ones((), dt)

    shard = P(ax)
    rep = P(None)
    carry_spec = {"x": rep, "z": shard, "y": shard, "rho": P(),
                  "rho_cand": P()}
    if settings.anderson_memory > 0:
        carry_spec["aa"] = {"Sx": rep, "Fx": rep, "Sw": shard, "Fw": shard,
                            "px": rep, "fx": rep, "pw": shard, "fw": shard,
                            "count": P()}
    in_specs = (shard, rep, rep, rep, carry_spec)
    out_specs = ((rep, shard, shard) + (P(),) * 6
                 + (carry_spec,) if return_carry else
                 (rep, shard, shard) + (P(),) * 6)

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=in_specs,
             out_specs=out_specs)
    def run(blk, q, dP, dAtA, carry_in):
        (A_vals, A_cols, Atp_vals, Atp_cols, Ptp_vals, Ptp_cols, l, u,
         e_scale) = (x[0] for x in blk)
        sigma = jnp.asarray(settings.sigma_for(dt), dt)
        alpha = jnp.asarray(settings.alpha, dt)
        alpha1 = jnp.asarray(1.0 - settings.alpha, dt)

        psum = lambda v: jax.lax.psum(v, ax)
        pmax = lambda v: jax.lax.pmax(v, ax)

        def matvec_A(v):
            return _ell(A_vals, A_cols, v)                 # (m_loc,) local

        def matvec_At(w):
            return psum(_ell(Atp_vals, Atp_cols, w))       # (n,) replicated

        def matvec_P(v):
            return psum(_ell(Ptp_vals, Ptp_cols, v))       # (n,) replicated

        # Vector-rho (OSQP's scheme, models/kkt.py:row_weights): equality
        # rows get rho * rho_eq_scale. Weights derive from the row's own
        # bounds — shard-local, no communication. The weighted Jacobi
        # diagonal diag(A'WA) needs one scatter-add over the local ELL block
        # plus a psum, once per solve.
        if settings.rho_eq_scale != 1.0:
            tol_eq = 1e-9 * jnp.maximum(1.0, jnp.abs(u))
            w = jnp.where(
                jnp.isfinite(l) & jnp.isfinite(u) & (jnp.abs(u - l) <= tol_eq),
                jnp.asarray(settings.rho_eq_scale, dt), jnp.asarray(1.0, dt))
            # Padded ELL slots hold vals=0/cols=0 — they add zeros to col 0.
            dAtA_w = psum(jnp.zeros((n,), dt).at[A_cols.reshape(-1)].add(
                (A_vals * A_vals * w[:, None]).reshape(-1)))
        else:
            w = None
            dAtA_w = dAtA

        def rho_rows(rho):
            return rho if w is None else rho * w           # scalar | (m_loc,)

        def apply_M(rho):
            rr = rho_rows(rho)
            return lambda v: (matvec_P(v) + sigma * v
                              + matvec_At(rr * matvec_A(v)))

        def diag_inv(rho):
            dvec = dP + sigma + rho * dAtA_w
            return jnp.where(dvec > 0, 1.0 / dvec, 1.0)

        # Unscaled-residual maps (identity when unscaled) — row-space vectors
        # are local shards, so e_scale is the local slice.
        e_inv = 1.0 / e_scale
        dc_inv = 1.0 / (d_scale * c_scale)
        unsc_p = lambda v: v * e_inv
        unsc_d = lambda v: v * dc_inv
        unsc_x = lambda v: v * d_scale

        # vma discipline: row-sharded carries (z, y, Ax cache) arrive varying
        # (sharded operands); every n-space/scalar carry stays invariant
        # because all its cross-shard data flows through psum/pmax (whose
        # outputs the checker treats as replicated).
        mark = lambda v: jax.lax.pcast(v, ax, to="varying")
        zeros_m = mark(jnp.zeros(l.shape, dt))
        mem = settings.anderson_memory
        aa0 = None
        if mem > 0:
            # Anderson history, split like the iterates: the x-part
            # replicated over shards, the w = z + y/rho part row-sharded.
            # The Gram below psums the w contribution so every shard solves
            # the identical MxM mixing system (math: models/anderson.py;
            # layout: consensus.py's sharded variant, unbatched here).
            a_in = carry_in["aa"]
            aa0 = {
                "Sx": a_in["Sx"], "Fx": a_in["Fx"],
                "Sw": a_in["Sw"][0], "Fw": a_in["Fw"][0],
                "px": a_in["px"], "fx": a_in["fx"],
                "pw": a_in["pw"][0], "fw": a_in["fw"][0],
                "count": a_in["count"],
            }
        state0 = (
            carry_in["x"],                  # x (replicated)
            carry_in["z"][0],               # z (row-sharded, (1, m_loc)[0])
            carry_in["y"][0],               # y (row-sharded)
            jnp.zeros((n,), dt),            # xx carry (CG warm start)
            carry_in["rho"],                # rho
            carry_in["rho_cand"],           # rho_cand
            jnp.zeros((), jnp.int32),       # status
            jnp.zeros((), jnp.int32),       # iterations at finish
            jnp.zeros((), jnp.int32),       # global iteration
            jnp.full((), jnp.inf, dt),      # res_prim
            jnp.full((), jnp.inf, dt),      # res_dual
            # products cache for certificate deltas (Px, Ax, ATy at the
            # previous check; Ax row-sharded, others replicated). Computed
            # from the carry so warm-started segments see correct deltas
            # (for a cold start these are the same zeros as before).
            matvec_P(carry_in["x"]),
            matvec_A(carry_in["x"]),  # already varying (A_vals is sharded)
            matvec_At(carry_in["y"][0]),
            aa0,  # None when anderson_memory == 0 (leafless pytree node)
        )
        max_total = settings.num_checks * settings.check_interval

        def cond(st):
            return (st[8] < max_total) & (st[6] == Status.RUNNING)

        def body(st):
            (x, z, y, xx_c, rho, rho_cand, status, iters, it, rp, rd,
             Px_p, Ax_p, ATy_p, aa) = st
            if settings.adaptive_rho:
                f = settings.rho_factor
                trip = (rho_cand * f < rho) | (rho_cand > f * rho)
                rho = jnp.where(trip, rho_cand, rho)
                if aa is not None:
                    # Re-adopted rho changes the w = z + y/rho encoding —
                    # restart the history (models/anderson.py discipline).
                    aa = {
                        "Sx": jnp.where(trip, 0.0, aa["Sx"]),
                        "Fx": jnp.where(trip, 0.0, aa["Fx"]),
                        "Sw": jnp.where(trip, 0.0, aa["Sw"]),
                        "Fw": jnp.where(trip, 0.0, aa["Fw"]),
                        "px": aa["px"], "fx": aa["fx"],
                        "pw": aa["pw"], "fw": aa["fw"],
                        "count": jnp.where(trip, 0, aa["count"]),
                    }
            dinv = diag_inv(rho)
            rho_row = rho_rows(rho)
            x_start, z_start, y_start = x, z, y

            def step(_, carry):
                x, z, y, xx_c = carry
                b = sigma * x - q + matvec_At(rho_row * z - y)
                xx = _pcg(apply_M(rho), b, xx_c, dinv,
                          abs_tol=settings.cg_eps,
                          max_iterations=settings.cg_max_iterations,
                          rel_tol=settings.cg_rel_eps)
                zz = matvec_A(xx)
                xp, zp = x, z
                x = alpha * xx + alpha1 * xp
                z = jnp.clip(alpha * zz + alpha1 * zp + y / rho_row, l, u)
                y = y + rho_row * (alpha * zz + alpha1 * zp - z)
                return x, z, y, xx

            x, z, y, xx_c = jax.lax.fori_loop(
                0, settings.check_interval, step, (x, z, y, xx_c))
            it = it + settings.check_interval

            aa_accept = None
            if aa is not None:
                # Guarded Anderson step at the check boundary, in the split
                # coordinates (x replicated, w = z + y/rho row-sharded). The
                # safeguard margins are evaluated on UNSCALED residuals —
                # the space the termination tests run in — exactly like
                # models/anderson.py:aa_step with term_scale.
                from ..models.anderson import aa_gamma

                act_s = status == Status.RUNNING
                w_in = z_start + y_start / rho_row
                w_pl = z + y / rho_row
                fx = x - x_start
                fw = w_pl - w_in
                have = aa["count"] >= 1
                slot = jnp.where(have, (aa["count"] - 1) % mem, 0)
                push = ((jnp.arange(mem) == slot) & have)[:, None]
                Sx = jnp.where(push, (x_start - aa["px"])[None, :], aa["Sx"])
                Fx = jnp.where(push, (fx - aa["fx"])[None, :], aa["Fx"])
                Sw = jnp.where(push, (w_in - aa["pw"])[None, :], aa["Sw"])
                Fw = jnp.where(push, (fw - aa["fw"])[None, :], aa["Fw"])
                G = (jnp.einsum("id,jd->ij", Fx, Fx)
                     + psum(jnp.einsum("id,jd->ij", Fw, Fw)))
                rhs_g = (jnp.einsum("id,d->i", Fx, fx)
                         + psum(jnp.einsum("id,d->i", Fw, fw)))
                gamma = aa_gamma(G, rhs_g, mem, settings.anderson_reg, dt)
                x_a = x - jnp.einsum("i,id->d", gamma, Sx + Fx)
                w_a = w_pl - jnp.einsum("i,id->d", gamma, Sw + Fw)
                z_a = jnp.clip(w_a, l, u)
                y_a = rho_row * (w_a - z_a)

                def _margin(xv, zv, yv):
                    Axv = matvec_A(xv)
                    Pxv = matvec_P(xv)
                    ATyv = matvec_At(yv)
                    rpv = pmax(inf_norm(unsc_p(Axv - zv)))
                    rdv = inf_norm(unsc_d(Pxv + q + ATyv))
                    mpv = jnp.maximum(pmax(inf_norm(unsc_p(Axv))),
                                      pmax(inf_norm(unsc_p(zv))))
                    mdv = jnp.maximum(
                        jnp.maximum(inf_norm(unsc_d(Pxv)),
                                    inf_norm(unsc_d(ATyv))),
                        inf_norm(unsc_d(q)))
                    marg = jnp.maximum(
                        rpv / (settings.eps_abs + settings.eps_rel * mpv),
                        rdv / (settings.eps_abs + settings.eps_rel * mdv))
                    return marg, (Axv, Pxv, ATyv)

                m_p, pr_p = _margin(x, z, y)
                m_a, pr_a = _margin(x_a, z_a, y_a)
                aa_accept = act_s & have & jnp.isfinite(m_a) & (m_a < m_p)
                rejected = act_s & have & ~aa_accept
                x = jnp.where(aa_accept, x_a, x)
                z = jnp.where(aa_accept, z_a, z)
                y = jnp.where(aa_accept, y_a, y)
                Ax = jnp.where(aa_accept, pr_a[0], pr_p[0])
                Px = jnp.where(aa_accept, pr_a[1], pr_p[1])
                ATy = jnp.where(aa_accept, pr_a[2], pr_p[2])
                aa = {
                    "Sx": jnp.where(rejected, 0.0, Sx),
                    "Fx": jnp.where(rejected, 0.0, Fx),
                    "Sw": jnp.where(rejected, 0.0, Sw),
                    "Fw": jnp.where(rejected, 0.0, Fw),
                    "px": jnp.where(act_s, x_start, aa["px"]),
                    "fx": jnp.where(act_s, fx, aa["fx"]),
                    "pw": jnp.where(act_s, w_in, aa["pw"]),
                    "fw": jnp.where(act_s, fw, aa["fw"]),
                    "count": jnp.where(rejected, 1,
                                       jnp.where(act_s, aa["count"] + 1,
                                                 aa["count"])),
                }
            else:
                Ax = matvec_A(x)
                Px = matvec_P(x)
                ATy = matvec_At(y)
            res_prim = pmax(inf_norm(unsc_p(Ax - z)))
            res_dual = inf_norm(unsc_d(Px + q + ATy))
            max_prim = jnp.maximum(pmax(inf_norm(unsc_p(Ax))),
                                   pmax(inf_norm(unsc_p(z))))
            max_dual = jnp.maximum(
                jnp.maximum(inf_norm(unsc_d(Px)), inf_norm(unsc_d(ATy))),
                inf_norm(unsc_d(q)))

            if settings.adaptive_rho:
                # rho adapts on the solve-space residuals (OSQP discipline;
                # see models/admm.py:_check_convergence).
                rp_s = pmax(inf_norm(Ax - z))
                rd_s = inf_norm(Px + q + ATy)
                mp_s = jnp.maximum(pmax(inf_norm(Ax)), pmax(inf_norm(z)))
                md_s = jnp.maximum(
                    jnp.maximum(inf_norm(Px), inf_norm(ATy)), inf_norm(q))
                den = rd_s * mp_s
                cand = jnp.clip(
                    rho * jnp.sqrt(rp_s * md_s / jnp.where(den == 0, 1.0, den)),
                    RHO_MIN, RHO_MAX).astype(dt)
                ok = jnp.isfinite(cand) & (den != 0) & (cand > 0)
                rho_cand = jnp.where((status == Status.RUNNING) & ok,
                                     cand, rho_cand)

            eps_prim = settings.eps_abs + settings.eps_rel * max_prim
            eps_dual = settings.eps_abs + settings.eps_rel * max_dual
            solved = (res_prim < eps_prim) & (res_dual < eps_dual)
            ulp = jnp.asarray(8 * jnp.finfo(dt).eps, dt)
            eps_admm = jnp.asarray(settings.eps_admm, dt)
            fp = ((inf_norm(unsc_x(x - x_start))
                   <= eps_admm + ulp * jnp.maximum(inf_norm(unsc_x(x)), 1.0))
                  & (pmax(inf_norm(unsc_p(z - z_start)))
                     <= eps_admm
                     + ulp * jnp.maximum(pmax(inf_norm(unsc_p(z))), 1.0)))
            if aa_accept is not None:
                # An accepted AA step compares x against a different map's
                # point — the fixed-point test is meaningless for it.
                fp &= ~aa_accept
            act = status == Status.RUNNING
            status = jnp.where(act & solved, Status.SOLVED, status)
            status = jnp.where(act & fp, Status.SOLVED_ADMM, status)
            if settings.check_infeasibility:
                # OSQP §3.4 certificates, row-space pieces reduced over the
                # mesh (same math as consensus.py / models/admm.py).
                eps_p = jnp.asarray(settings.eps_prim_inf, dt)
                eps_d = jnp.asarray(settings.eps_dual_inf, dt)
                dy = y - y_start
                dx = x - x_start
                ndy = pmax(inf_norm(dy))
                pos = jnp.maximum(dy, 0.0)
                neg = jnp.minimum(dy, 0.0)
                tol = eps_p * ndy
                term_u = jnp.where(jnp.isfinite(u), u * pos,
                                   jnp.where(pos > tol, jnp.inf, 0.0))
                term_l = jnp.where(jnp.isfinite(l), l * neg,
                                   jnp.where(neg < -tol, jnp.inf, 0.0))
                support = psum(jnp.sum(term_u + term_l))
                prim_inf = ((ndy > 0)
                            & (inf_norm(ATy - ATy_p) <= eps_p * ndy)
                            & (support <= -eps_p * ndy))
                ndx = inf_norm(dx)
                Adx = Ax - Ax_p
                tol_d = eps_d * ndx
                fin_l = jnp.isfinite(l)
                fin_u = jnp.isfinite(u)
                ok_rows = jnp.where(
                    fin_l & fin_u, jnp.abs(Adx) <= tol_d,
                    jnp.where(fin_l, Adx >= -tol_d,
                              jnp.where(fin_u, Adx <= tol_d, True)))
                all_ok = psum(jnp.sum((~ok_rows).astype(jnp.int32))) == 0
                dual_inf = ((ndx > 0)
                            & (inf_norm(Px - Px_p) <= eps_d * ndx)
                            & (jnp.sum(q * dx) <= -eps_d * ndx)
                            & all_ok)
                noise = 16 * jnp.finfo(dt).eps
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
            iters = jnp.where(act & (status != Status.RUNNING), it, iters)
            rp = jnp.where(act, res_prim, rp)
            rd = jnp.where(act, res_dual, rd)
            return (x, z, y, xx_c, rho, rho_cand, status, iters, it, rp, rd,
                    Px, Ax, ATy, aa)

        st = jax.lax.while_loop(cond, body, state0)
        x, z, y, _, rho, rho_cand_f, status, iters, it, rp, rd = st[:11]
        aa_f = st[14]
        # Raw solve-space carry for segment continuation — captured BEFORE
        # polish (polish refines the reported solution, not the iteration).
        carry_out = {"x": x, "z": z[None], "y": y[None], "rho": rho,
                     "rho_cand": rho_cand_f}
        if aa_f is not None:
            carry_out["aa"] = {
                "Sx": aa_f["Sx"], "Fx": aa_f["Fx"],
                "Sw": aa_f["Sw"][None], "Fw": aa_f["Fw"][None],
                "px": aa_f["px"], "fx": aa_f["fx"],
                "pw": aa_f["pw"][None], "fw": aa_f["fw"][None],
                "count": aa_f["count"],
            }
        exhausted = status == Status.RUNNING
        status = jnp.where(exhausted, Status.MAX_ITERATIONS,
                           status).astype(jnp.int32)
        iters = jnp.where(exhausted, it, iters)

        if settings.polish_iterations > 0:
            # Distributed polish in the SOLVE space (exactly where the
            # single-device path runs it: admm._solve_core polishes the
            # scaled problem before unscaling). Matrix-free MINRES on the
            # masked active-set KKT (models/polish.py:polish_minres math,
            # reference m:289-325) with psum'd Lanczos inner products — the
            # sparse sibling of consensus.py:polish_block.
            from ..models.kkt import _minres

            delta = jnp.asarray(settings.delta, dt)
            Ax_f = matvec_A(x)
            cprox = 10.0 * jnp.maximum(pmax(inf_norm(Ax_f - z)),
                                       jnp.asarray(settings.eps_abs, dt))
            low_active = ((y < 0) & jnp.isfinite(l)
                          & (z - l <= cprox * (1.0 + jnp.abs(l))))
            up_active = ((y > 0) & jnp.isfinite(u)
                         & (u - z <= cprox * (1.0 + jnp.abs(u))))
            act_rows = low_active | up_active
            g = (jnp.where(low_active, l, 0.0)
                 + jnp.where(up_active, u, 0.0)).astype(dt)
            r_diag = jnp.where(act_rows, delta, jnp.asarray(1.0, dt))

            def apply_K(v):
                v1, v2 = v[:n], v[n:]
                top = (matvec_P(v1) + delta * v1
                       + matvec_At(jnp.where(act_rows, v2, 0.0)))
                bot = jnp.where(act_rows, matvec_A(v1), 0.0) - r_diag * v2
                return jnp.concatenate([top, bot])

            def apply_K_exact(v):
                v1, v2 = v[:n], v[n:]
                top = matvec_P(v1) + matvec_At(jnp.where(act_rows, v2, 0.0))
                bot = (jnp.where(act_rows, matvec_A(v1), 0.0)
                       - jnp.where(act_rows, 0.0, v2))
                return jnp.concatenate([top, bot])

            d1 = dP + delta
            d1_inv = jnp.where(d1 > 0, 1.0 / d1, 1.0)

            def precond(v):
                return jnp.concatenate([d1_inv * v[:n], v[n:] / r_diag])

            def vdot(a, b):
                # x-part replicated (identical on every shard), nu-part
                # row-sharded: psum only the sharded contribution so the
                # Lanczos scalars are the global inner products.
                return (jnp.sum(a[:n] * b[:n])
                        + psum(jnp.sum(a[n:] * b[n:])))

            def kkt_err(xv, yv):
                Axv = matvec_A(xv)
                dual = inf_norm(matvec_P(xv) + q + matvec_At(yv))
                viol = pmax(inf_norm(Axv - jnp.clip(Axv, l, u)))
                return jnp.maximum(dual, viol)

            b_rhs = jnp.concatenate([-q, g])
            v0 = jnp.concatenate([x, jnp.where(act_rows, y, 0.0)])

            def sweep(_, v):
                r = b_rhs - apply_K_exact(v)
                dv = _minres(apply_K, precond, r, jnp.zeros_like(b_rhs),
                             abs_tol=0.0, rel_tol=settings.polish_eps,
                             max_iterations=settings.polish_max_krylov,
                             vdot=vdot)
                return v + dv

            v = jax.lax.fori_loop(0, max(1, settings.polish_iterations),
                                  sweep, v0)
            px, pn = v[:n], v[n:]
            # Every shard computed the identical px (all Lanczos scalars are
            # psum'd), but the concat with the row-sharded nu segment makes
            # it *varying* to the vma checker; this pmax is a numerical no-op
            # that re-establishes the replication certificate.
            px = pmax(px)
            finite = (jnp.all(jnp.isfinite(px))
                      & (psum(jnp.sum((~jnp.isfinite(pn)).astype(jnp.int32)))
                         == 0))
            accept = (kkt_err(px, pn) < kkt_err(x, y)) & finite
            x = jnp.where(accept, px, x)
            y = jnp.where(accept, pn, y)

        # Unscale the returned iterates (solve(scaling=...) semantics).
        x_u = x * d_scale
        z_u = z * e_inv
        y_u = y * e_scale / c_scale
        obj = 0.5 * jnp.sum(x_u * (matvec_P(x) / (d_scale * c_scale))) \
            + jnp.sum((q / (d_scale * c_scale)) * x_u)
        out = (x_u, z_u[None], y_u[None], status, iters, rp, rd,
               rho * jnp.ones((), dt), obj)
        return out + (carry_out,) if return_carry else out

    blk = (sq.A_vals, sq.A_cols, sq.Atp_vals, sq.Atp_cols, sq.Ptp_vals,
           sq.Ptp_cols, sq.l, sq.u, sq.e_scale)
    blk = tuple(jax.device_put(b, NamedSharding(mesh, P(ax)))
                for b in blk)
    rep_sh = NamedSharding(mesh, P())
    args = tuple(jax.device_put(v, rep_sh) for v in (sq.q, sq.dP, sq.dAtA))
    with jax.default_matmul_precision(settings.matmul_precision):
        out = run(blk, *args, carry)
    x, z, y, status, iters, rp, rd, rho, obj = out[:9]
    z = z.reshape(-1)[:m_out]
    y = y.reshape(-1)[:m_out]
    info = SolveInfo(status=status, iterations=iters, res_prim=rp,
                     res_dual=rd, rho=rho, objective=obj)
    sol = Solution(x=x, z=z, y=y, info=info)
    return (sol, out[9]) if return_carry else sol


def solve_sparse_mesh_segmented(sq: ShardedSparseQP,
                                settings: Settings = Settings(),
                                mesh: Mesh | None = None,
                                m_orig: int | None = None, scaling=None,
                                segment_iterations: int = 100,
                                callback=None) -> Solution:
    """Bounded device programs over the mesh with a warm-start carry —
    the distributed sibling of models/admm.py:solve_segmented.

    Why it exists: a backend may limit how long one program runs, and a
    segment boundary is a natural checkpoint (the carry is a host-visible
    pytree — save it with utils/checkpoint-style np round-trips). Anderson
    history, adaptive-rho state, and the certificate product caches all
    ride the carry, so the segmented trajectory matches the monolithic one
    check-for-check when segment_iterations is a multiple of
    check_interval (tests/test_sparse_mesh.py pins this).

    ``callback(segment_index, solution, carry)``: optional per-segment
    hook (checkpointing, logging); returning False stops early.
    """
    import dataclasses as _dc

    total_budget = settings.max_iterations
    carry = None
    total_iters = 0
    seg_idx = 0
    sol = None
    while total_budget > 0:
        seg = _dc.replace(settings,
                          max_iterations=min(segment_iterations, total_budget))
        sol, carry = solve_sparse_mesh(sq, seg, mesh, m_orig, scaling,
                                       carry=carry, return_carry=True)
        total_iters += int(sol.info.iterations)
        total_budget -= seg.max_iterations
        if callback is not None and callback(seg_idx, sol, carry) is False:
            break
        seg_idx += 1
        if int(sol.info.status) != Status.MAX_ITERATIONS:
            break
    info = SolveInfo(status=sol.info.status,
                     iterations=jnp.asarray(total_iters, jnp.int32),
                     res_prim=sol.info.res_prim, res_dual=sol.info.res_dual,
                     rho=sol.info.rho, objective=sol.info.objective)
    return Solution(x=sol.x, z=sol.z, y=sol.y, info=info)
