"""Safeguarded Anderson acceleration of the ADMM fixed point.

The OSQP iteration is Douglas-Rachford splitting in the variables
``s = (x, w)`` with ``w = z + y/rho``: given ``s``, the constrained iterates
are recovered as ``z = clip(w, l, u)`` and ``y = rho*(w - z)`` — every chunk
output satisfies this by construction (``z <- clip(alpha*zz + (1-alpha)*z +
y/rho, l, u)``, ``y <- y + rho*(...) ``, so ``z + y/rho`` is exactly the
pre-projection point). Anderson acceleration (AA) extrapolates this
fixed-point sequence from a short history of iterate/residual differences
(type-II AA, per the A2DR line of work — arXiv:1908.11482 / PAPERS.md — and
SCS 3.0's accelerated DR). The reference has no analogue (single problem,
plain iteration); on large fleets the win is iteration count: the per-check
cost of AA is a handful of matvecs + an M x M solve, amortized over
``check_interval`` iterations.

Shape discipline (everything static, fully batched):

* AA operates at **check boundaries** on the chunk map ``g = T^K`` (K =
  check_interval): the residual ``f_j = g(s_j) - s_j`` is free — ``s_j`` is
  the state entering the chunk and ``g(s_j)`` its output — so the hot chunk
  is untouched.
* History is a per-lane ring buffer of the last M difference pairs
  (``anderson_memory``); the mixing weights solve a batched M x M
  Tikhonov-regularized least-squares (``anderson_reg``) — one tiny batched
  ``linalg.solve`` per check.
* **Safeguard**: the candidate is accepted per lane only when its combined
  (primal, dual) residual margin improves on the plain chunk output; on
  rejection the lane's history restarts (the standard guarded-AA discipline,
  e.g. SCS 3.0) and the plain iterate proceeds — AA can therefore never
  make a check worse than the unaccelerated solver.
* A lane's history resets when its rho is re-adopted (the encoding
  ``w = z + y/rho`` and the map itself change), and accepted AA steps mask
  the ADMM fixed-point test for that check (``x - xp`` would compare points
  of different maps).

Works with every KKT backend (the map is a black box), dense or matrix-free
sparse problems, Ruiz-scaled solves (the safeguard compares UNSCALED
residual margins, the same space admm._check_convergence terminates in).
The history is carried across solve_segmented
boundaries (admm._solve_carry_aa), and the consensus block-split solver
runs its own sharded variant of the same math (parallel/consensus.py:
split history buffers, psum'd Gram) tested to match this one
iteration-for-iteration. The prox-ALM family's variant lives at the bottom
of this module. MPC sequences (frontends/sequence.py) intentionally do NOT
carry history between ticks — the QP (and therefore the map) changes, so
stale secant pairs would only feed the safeguard rejections.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.state import SolverState, Status
from . import kkt as kkt_mod


def init_aa(qp, settings):
    """Zeroed AA carry: ring buffers of iterate/residual differences."""
    return init_aa_vec(qp.batch_shape, qp.n + qp.m,
                       settings.anderson_memory, qp.dtype)


def reset_aa(aa, mask):
    """Clear history (and the stored previous point) for masked lanes."""
    if aa is None:
        return None
    m3 = mask[..., None, None]
    return {
        "S": jnp.where(m3, 0.0, aa["S"]),
        "F": jnp.where(m3, 0.0, aa["F"]),
        "prev_s": aa["prev_s"],
        "prev_f": aa["prev_f"],
        "count": jnp.where(mask, 0, aa["count"]),
    }


def init_aa_vec(batch, d, mem, dt):
    """Zeroed AA carry for a generic fixed-point vector of width d."""
    return {
        "S": jnp.zeros(batch + (mem, d), dt),
        "F": jnp.zeros(batch + (mem, d), dt),
        "prev_s": jnp.zeros(batch + (d,), dt),
        "prev_f": jnp.zeros(batch + (d,), dt),
        "count": jnp.zeros(batch, jnp.int32),
    }


def aa_mix(aa, s_in, s_plain, mem, reg):
    """Solver-agnostic AA core: push the new difference pair and return the
    type-II candidate.

    ``s_in`` is the point the fixed-point map was applied AT (the chunk
    input), ``s_plain`` its image. Returns ``(s_aa, S, F, have_prev)`` —
    the caller decides acceptance and commits via :func:`aa_commit`.
    """
    dt = s_in.dtype
    f = s_plain - s_in
    have_prev = aa["count"] >= 1
    ds = s_in - aa["prev_s"]
    df = f - aa["prev_f"]
    # Ring-buffer push (per-lane slot -> one-hot write; slots hold either
    # valid differences or the zeros they were reset to, so no separate
    # validity mask is needed in the least-squares below).
    slot = jnp.where(have_prev, (aa["count"] - 1) % mem, 0)
    onehot = jnp.arange(mem) == slot[..., None]                  # (*B, mem)
    push = (onehot & have_prev[..., None])[..., None]            # (*B, mem, 1)
    S = jnp.where(push, ds[..., None, :], aa["S"])
    F = jnp.where(push, df[..., None, :], aa["F"])

    G = jnp.einsum("...id,...jd->...ij", F, F)
    rhs = jnp.einsum("...id,...d->...i", F, f)
    gamma = aa_gamma(G, rhs, mem, reg, dt)
    s_aa = s_plain - jnp.einsum("...i,...id->...d", gamma, S + F)
    return s_aa, S, F, f, have_prev


def aa_gamma(G, rhs, mem, reg, dt):
    """Type-II AA mixing weights: gamma = argmin ||f - F' gamma||,
    Tikhonov-damped relative to the Gram trace. Zero history rows
    contribute nothing, and an all-zero history yields gamma = 0, i.e.
    the plain iterate. Shared by the single-device, prox-ALM, and
    block-split (psum'd Gram) variants — keep the damping rule here only.
    """
    tr = jnp.trace(G, axis1=-2, axis2=-1) / mem
    lam = reg * tr + jnp.asarray(1e-30, dt)
    Greg = G + lam[..., None, None] * jnp.eye(mem, dtype=dt)
    return jnp.linalg.solve(Greg, rhs[..., None])[..., 0]


def aa_commit(aa, S, F, s_in, f, active, rejected):
    """Post-selection bookkeeping: rejected lanes restart (clear differences,
    keep this check's point as the fresh base); everyone active records
    (s_j, f_j) and advances."""
    r3 = rejected[..., None, None]
    a2 = active[..., None]
    return {
        "S": jnp.where(r3, 0.0, S),
        "F": jnp.where(r3, 0.0, F),
        "prev_s": jnp.where(a2, s_in, aa["prev_s"]),
        "prev_f": jnp.where(a2, f, aa["prev_f"]),
        "count": jnp.where(rejected, 1,
                           jnp.where(active, aa["count"] + 1, aa["count"])),
    }


def _encode(qp, settings, x, z, y, rho):
    rho_row = jnp.broadcast_to(
        kkt_mod.rho_rows(qp, rho, settings), qp.batch_shape + (qp.m,))
    return jnp.concatenate([x, z + y / rho_row], axis=-1)


def _decode(qp, settings, s, rho):
    rho_row = jnp.broadcast_to(
        kkt_mod.rho_rows(qp, rho, settings), qp.batch_shape + (qp.m,))
    x = s[..., : qp.n]
    w = s[..., qp.n:]
    z = jnp.clip(w, qp.l, qp.u)
    y = rho_row * (w - z)
    return x, z, y


def _residual_margin(qp, settings, Ax, z, Px, ATy, term_scale=None):
    """max(res_prim/eps_prim, res_dual/eps_dual), collapsed to one
    comparable scalar per lane — the same relative-termination scaling as
    the convergence test (SolveQuadraticProgram.jl:84-96).

    With ``term_scale`` (Ruiz equilibration) the margins are evaluated on
    the UNSCALED residuals, exactly like _check_convergence's termination
    tests — so the safeguard's "never degrades a check" guarantee holds in
    the space the eps tests actually run in.
    """
    from ..ops.linalg import inf_norm

    if term_scale is None:
        unsc_p = unsc_d = lambda v: v
    else:
        e_inv = 1.0 / term_scale.e
        dc_inv = 1.0 / (term_scale.d * term_scale.c[..., None])
        unsc_p = lambda v: v * e_inv
        unsc_d = lambda v: v * dc_inv
    res_prim = inf_norm(unsc_p(Ax - z))
    res_dual = inf_norm(unsc_d(Px + qp.q + ATy))
    max_prim = jnp.maximum(inf_norm(unsc_p(Ax)), inf_norm(unsc_p(z)))
    max_dual = jnp.maximum(
        jnp.maximum(inf_norm(unsc_d(Px)), inf_norm(unsc_d(ATy))),
        inf_norm(unsc_d(qp.q)))
    eps_p = settings.eps_abs + settings.eps_rel * max_prim
    eps_d = settings.eps_abs + settings.eps_rel * max_dual
    return jnp.maximum(res_prim / eps_p, res_dual / eps_d)


def aa_step(qp, settings, state: SolverState, x, z, y, term_scale=None):
    """One guarded AA update at a check boundary.

    Inputs: the pre-chunk ``state`` (whose x/z/y are the chunk's input
    point ``s_j``) and the chunk output ``(x, z, y)`` (= ``g(s_j)``).
    Returns ``(x, z, y, (Ax, ATy, Px), aa_new, accepted)`` with the
    per-lane-selected iterates and their convergence-check products.
    """
    mem = settings.anderson_memory
    dt = qp.dtype
    aa = state.aa
    active = state.status == Status.RUNNING

    s_in = _encode(qp, settings, state.x, state.z, state.y, state.rho)
    s_plain = _encode(qp, settings, x, z, y, state.rho)
    s_aa, S, F, f, have_prev = aa_mix(aa, s_in, s_plain, mem,
                                      settings.anderson_reg)
    x_a, z_a, y_a = _decode(qp, settings, s_aa, state.rho)

    # Safeguard: residual margins of both candidates (unscaled when Ruiz
    # scaling is active — the same space the termination tests run in).
    Ax_p, ATy_p, Px_p = qp.matvec_A(x), qp.matvec_At(y), qp.matvec_P(x)
    Ax_a, ATy_a, Px_a = qp.matvec_A(x_a), qp.matvec_At(y_a), qp.matvec_P(x_a)
    m_plain = _residual_margin(qp, settings, Ax_p, z, Px_p, ATy_p, term_scale)
    m_aa = _residual_margin(qp, settings, Ax_a, z_a, Px_a, ATy_a, term_scale)
    accepted = active & have_prev & jnp.isfinite(m_aa) & (m_aa < m_plain)
    rejected = active & have_prev & ~accepted

    sel = accepted[..., None]
    x = jnp.where(sel, x_a, x)
    z = jnp.where(sel, z_a, z)
    y = jnp.where(sel, y_a, y)
    Ax = jnp.where(sel, Ax_a, Ax_p)
    ATy = jnp.where(sel, ATy_a, ATy_p)
    Px = jnp.where(sel, Px_a, Px_p)

    aa_new = aa_commit(aa, S, F, s_in, f, active, rejected)
    return x, z, y, (Ax, ATy, Px), aa_new, accepted


# --- ProxQP (prox-ALM) variant ------------------------------------------
#
# The ALM iteration's (s, z) pair is, after any full iteration, exactly the
# projection split of u = s - z/rho (s = max(u,0), z = rho*max(-u,0)): with
# vv = d - Cx - z/rho the updates give (s+, z+) = (max(vv,0), -rho*min(vv,0))
# (ProxQP.jl:227-249). So the fixed point lives in (x, y, u) and decoding
# re-imposes the split exactly — mixed iterates stay dual-feasible (z >= 0).


def init_aa_proxqp(prob, settings):
    return init_aa_vec(prob.batch_shape, prob.n + prob.n_eq + prob.n_ineq,
                       settings.anderson_memory, prob.dtype)


def _encode_proxqp(x, y, s, z, rho):
    return jnp.concatenate([x, y, s - z / rho[..., None]], axis=-1)


def _decode_proxqp(prob, v, rho):
    n, me = prob.n, prob.n_eq
    x = v[..., :n]
    y = v[..., n:n + me]
    u = v[..., n + me:]
    s = jnp.maximum(u, 0.0)
    z = rho[..., None] * jnp.maximum(-u, 0.0)
    return x, y, s, z


def _proxqp_products(prob, x, y, z):
    return {"Px": prob.matvec_P(x), "Aty": prob.matvec_At(y),
            "Ctz": prob.matvec_Ct(z), "Ax": prob.matvec_A(x),
            "Cx": prob.matvec_C(x)}


def _proxqp_margin(prob, settings, pr, s):
    """PIQP 13a-c residuals collapsed to one relative margin per lane."""
    from ..ops.linalg import inf_norm

    res_prim = jnp.maximum(inf_norm(pr["Ax"] - prob.b),
                           inf_norm(pr["Cx"] - prob.d + s))
    res_dual = inf_norm(pr["Px"] + pr["Aty"] + pr["Ctz"] + prob.q)
    max_prim = jnp.max(
        jnp.stack([inf_norm(pr["Ax"]), inf_norm(prob.b), inf_norm(pr["Cx"]),
                   inf_norm(prob.d), inf_norm(s)]), axis=0)
    max_dual = jnp.max(
        jnp.stack([inf_norm(pr["Px"]), inf_norm(pr["Aty"]),
                   inf_norm(pr["Ctz"]), inf_norm(prob.q)]), axis=0)
    eps_p = settings.eps_abs + settings.eps_rel * max_prim
    eps_d = settings.eps_abs + settings.eps_rel * max_dual
    return jnp.maximum(res_prim / eps_p, res_dual / eps_d)


def aa_step_proxqp(prob, settings, aa, rho, active,
                   x_in, s_in_, y_in, z_in, x, s, y, z):
    """Guarded AA update for the prox-ALM chunk map.

    ``*_in`` is the chunk's input point, ``(x, s, y, z)`` its output.
    Returns the per-lane-selected iterates, their convergence-check products
    (reused by the caller's check), the new carry, and the accept mask.
    """
    v_in = _encode_proxqp(x_in, y_in, s_in_, z_in, rho)
    v_plain = _encode_proxqp(x, y, s, z, rho)
    v_aa, S, F, f, have_prev = aa_mix(aa, v_in, v_plain,
                                      settings.anderson_memory,
                                      settings.anderson_reg)
    x_a, y_a, s_a, z_a = _decode_proxqp(prob, v_aa, rho)

    pr_p = _proxqp_products(prob, x, y, z)
    pr_a = _proxqp_products(prob, x_a, y_a, z_a)
    m_plain = _proxqp_margin(prob, settings, pr_p, s)
    m_aa = _proxqp_margin(prob, settings, pr_a, s_a)
    accepted = active & have_prev & jnp.isfinite(m_aa) & (m_aa < m_plain)
    rejected = active & have_prev & ~accepted

    sel = accepted[..., None]
    x = jnp.where(sel, x_a, x)
    s = jnp.where(sel, s_a, s)
    y = jnp.where(sel, y_a, y)
    z = jnp.where(sel, z_a, z)
    prods = {k: jnp.where(sel, pr_a[k], pr_p[k]) for k in pr_p}
    aa_new = aa_commit(aa, S, F, v_in, f, active, rejected)
    return x, s, y, z, prods, aa_new, accepted
