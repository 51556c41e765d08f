"""Solution polishing — masked active-set refinement with static shapes.

Re-designs the reference polish step (`/root/reference/SolveQuadraticProgram.m:289-325`):
there, rows of A with y<0 (lower-active) / y>0 (upper-active) are *sliced out*
to form a reduced KKT system, delta-regularized, and solved by repeated MINRES
refinement, accepted only on convergence.

Row slicing means dynamic shapes — a non-starter under XLA. Instead we keep
the full (m)-row system and *mask*: inactive rows of A are zeroed and their
dual equations replaced by nu_i = 0, so the polished system is

    [[P + delta*I,  E'], [E,  -R]] [x; nu] = [-q; g],
    E = diag(active) A,  R = diag(active ? delta : 1),  g = l or u on active rows,

which has the same solution as the reference's reduced system on active rows
and pins nu = 0 elsewhere. Infinite bounds are never active (SURVEY.md §7).

Two solve paths behind one dispatch:

* **Dense, m <= n** — Schur complement on the SPD block: two batched
  Cholesky-style solves, then iterative refinement against the
  full KKT operator `polish_iterations` times (the analogue of the
  reference's numPolishItr MINRES sweeps, m:314-320).
* **Everything else** (dense m >> n, where the m x m Schur complement would
  cost O(m^3); sparse/operator QPs, which have no dense A at all) —
  batched matrix-free MINRES on the masked KKT, which is *literally* the
  reference's polish solver (`minres(mKK, ...)`, m:315), preconditioned by
  the SPD block-Jacobi diagonal. The masked-E operator needs only
  matvec_A/matvec_At — no dense Schur.

Acceptance is per-lane either way: the polished x replaces the ADMM x only
where it reduces the measured KKT error, mirroring the reference's
accept-only-if-converged guard (m:322-325).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.problem import QP
from ..core.settings import Settings
from ..ops.linalg import add_scaled_identity, inf_norm, matvec, matvec_t, spd_inverse, sym


def _kkt_error(qp, x, y):
    """max(dual residual, bound violation) — the polish acceptance metric."""
    Ax = qp.matvec_A(x)
    res_dual = inf_norm(qp.matvec_P(x) + qp.q + qp.matvec_At(y))
    viol = inf_norm(Ax - jnp.clip(Ax, qp.l, qp.u))
    return jnp.maximum(res_dual, viol)


def _active_set(qp, settings: Settings, x, z, y):
    """Active rows from dual sign AND primal proximity to the bound.

    The reference takes sign(y) alone (m:293-294), which at a loose solve
    tags every row whose dual carries noise: measured 88-95 active rows vs
    the oracle's 61 on random_qp n=200 fleets (~30 misidentifications), and
    the wrong set makes polish a rejected no-op. Requiring z within
    O(res_prim)-scaled distance of the bound recovers the oracle active set
    exactly on the same instances. Infinite bounds never bind.
    """
    rp = inf_norm(qp.matvec_A(x) - z)[..., None]
    c = 10.0 * jnp.maximum(rp, jnp.asarray(settings.eps_abs, qp.dtype))
    low_active = ((y < 0) & jnp.isfinite(qp.l)
                  & (z - qp.l <= c * (1.0 + jnp.abs(qp.l))))
    up_active = ((y > 0) & jnp.isfinite(qp.u)
                 & (qp.u - z <= c * (1.0 + jnp.abs(qp.u))))
    active = low_active | up_active
    g = (jnp.where(low_active, qp.l, 0.0)
         + jnp.where(up_active, qp.u, 0.0)).astype(qp.dtype)
    return active, g


def polish_minres(qp, settings: Settings, x, z, y, rho):
    """Matrix-free masked-KKT polish via batched MINRES.

    Solves [[P + delta*I, E'], [E, -R]] [px; pn] = [-q; g] with
    E = diag(active) A applied through the operator protocol, preconditioned
    by the block-Jacobi diagonal [1/(diag P + delta), 1/r]. Works for any QP
    exposing matvec_P/matvec_A/matvec_At/diag_P — dense, sparse, or
    consensus-sharded (the reference's own polish solver is MINRES, m:315).
    """
    from .kkt import _minres

    dt = qp.dtype
    n = qp.n
    delta = jnp.asarray(settings.delta, dt)
    active, g = _active_set(qp, settings, x, z, y)
    r_diag = jnp.where(active, delta, jnp.asarray(1.0, dt))

    def apply_K(v):
        v1, v2 = v[..., :n], v[..., n:]
        top = (qp.matvec_P(v1) + delta * v1
               + qp.matvec_At(jnp.where(active, v2, 0.0)))
        bot = jnp.where(active, qp.matvec_A(v1), 0.0) - r_diag * v2
        return jnp.concatenate([top, bot], axis=-1)

    def apply_K_exact(v):
        # The unregularized target system (delta appears only in the solver
        # operator): [[P, E'], [E, 0]] on active rows, nu = 0 elsewhere.
        v1, v2 = v[..., :n], v[..., n:]
        top = qp.matvec_P(v1) + qp.matvec_At(jnp.where(active, v2, 0.0))
        bot = (jnp.where(active, qp.matvec_A(v1), 0.0)
               - jnp.where(active, 0.0, v2))
        return jnp.concatenate([top, bot], axis=-1)

    d1 = qp.diag_P() + delta
    d1_inv = jnp.where(d1 > 0, 1.0 / d1, 1.0)
    d1_inv = jnp.broadcast_to(d1_inv, x.shape)

    def precond(v):
        v1, v2 = v[..., :n], v[..., n:]
        return jnp.concatenate([d1_inv * v1, v2 / r_diag], axis=-1)

    b = jnp.concatenate([-qp.q + jnp.zeros_like(x), g], axis=-1)
    v = jnp.concatenate([x, jnp.where(active, y, 0.0)], axis=-1)
    # Repeated regularized-MINRES correction of the exact residual — the
    # reference's refinement loop vT += minres(mKK, vG - mK*vT) repeated
    # numPolishItr times (m:314-320). Each sweep removes the O(delta) bias of
    # the regularized solve; once the exact residual is below the (relative)
    # MINRES tolerance the inner solver exits immediately, so extra sweeps
    # are near-free.
    def sweep(_, v):
        r = b - apply_K_exact(v)
        dv = _minres(apply_K, precond, r, jnp.zeros_like(b),
                     abs_tol=0.0, rel_tol=settings.polish_eps,
                     max_iterations=settings.polish_max_krylov)
        return v + dv
    v = jax.lax.fori_loop(0, max(1, settings.polish_iterations), sweep, v)
    px, pn = v[..., :n], v[..., n:]

    err_before = _kkt_error(qp, x, y)
    err_after = _kkt_error(qp, px, pn)
    accept = (err_after < err_before) & jnp.all(jnp.isfinite(px), axis=-1)
    x_out = jnp.where(accept[..., None], px, x)
    y_out = jnp.where(accept[..., None], pn, y)
    return x_out, y_out


def polish(qp, settings: Settings, x, z, y, rho):
    """Refine (x, y) on the active set identified by sign(y). Batched.

    Returns (x, y) with per-lane acceptance. Dispatches to the dense Schur
    path (m <= n) or matrix-free MINRES (see module docstring).
    """
    if not qp.is_dense or qp.m > qp.n:
        return polish_minres(qp, settings, x, z, y, rho)
    dt = qp.dtype
    delta = jnp.asarray(settings.delta, dt)
    active, g = _active_set(qp, settings, x, z, y)
    E = jnp.where(active[..., None], qp.A, 0.0)
    r_diag = jnp.where(active, delta, jnp.asarray(1.0, dt))

    # Schur-complement direct solve of [[H, E'], [E, -R]].
    H_inv = spd_inverse(add_scaled_identity(sym(qp.P), delta))
    EHiEt = jnp.einsum("...ik,...kl,...jl->...ij", E, H_inv, E)
    S = sym(EHiEt) + r_diag[..., None] * jnp.eye(qp.m, dtype=dt)
    S_inv = spd_inverse(S)

    def kkt_solve(rx, rn):
        """Solve [[H, E'], [E, -R]] [dx; dn] = [rx; rn] via cached inverses."""
        w = matvec(H_inv, rx)
        dn = matvec(S_inv, matvec(E, w) - rn)
        dx = w - matvec(H_inv, matvec_t(E, dn))
        return dx, dn

    def kkt_apply_exact(px, pn):
        # Unregularized target: [[P, E'], [E, 0]] on active rows, nu = 0
        # elsewhere — refinement against it removes the O(delta) bias of the
        # regularized solve (the reference's m:314-320 scheme).
        return (
            matvec(qp.P, px) + matvec_t(E, pn),
            matvec(E, px) - jnp.where(active, 0.0, pn),
        )

    bx, bn = -qp.q, g
    px, pn = kkt_solve(bx, bn)
    for _ in range(max(1, settings.polish_iterations) - 1):
        ax, an = kkt_apply_exact(px, pn)
        dx, dn = kkt_solve(bx - ax, bn - an)
        px, pn = px + dx, pn + dn

    err_before = _kkt_error(qp, x, y)
    err_after = _kkt_error(qp, px, pn)
    accept = (err_after < err_before) & jnp.all(jnp.isfinite(px), axis=-1)

    x_out = jnp.where(accept[..., None], px, x)
    y_out = jnp.where(accept[..., None], pn, y)
    return x_out, y_out
