"""Warm-started QP sequences (MPC / tracking workloads) under one jit.

The reference's only warm-start facility is the initial ``vX`` argument
(`SolveQuadraticProgram.jl:14`; ProxQP warm-starts from the equality KKT,
`ProxQP.jl:80-90`). For receding-horizon control the same QP is re-solved at
every tick with slowly-drifting data — the canonical batched formulation
is a `lax.scan` over the time axis carrying (x, z, y) between solves, so an
entire horizon of warm-started solves (optionally batched over scenarios)
compiles to a single XLA program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.problem import QP
from ..core.settings import Settings
from ..core.state import Solution
from ..models import admm


def warm_start_from(sol: Solution):
    """Extract (x0, z0, y0) to warm-start the next solve in a sequence."""
    return sol.x, sol.z, sol.y


def solve_sequence(qp_seq: QP, settings: Settings = Settings(),
                   init=None, carry_rho: bool = True,
                   static_matrices: bool = False) -> Solution:
    """Solve a time sequence of QPs, warm-starting each from its predecessor.

    ``qp_seq`` leaves carry a leading time axis: P (T, *B, n, n), etc. The
    scan carries (x, z, y); returned Solution leaves carry (T, *B, ...).
    Fully jittable — an MPC horizon (or a sliding benchmark sweep) runs as
    one compiled program with no host round-trips.

    ``carry_rho`` additionally carries the adapted per-lane rho between
    ticks. Whether that pays is workload-dependent: when consecutive QPs
    are near-identical the adapted rho skips the re-adaptation transient,
    but the ratio-based update is noisy near convergence, and on the
    examples/mpc_fleet.py tracking problem carrying it costs ~30% MORE
    total iterations than carrying the iterates alone (measured: 21015 vs
    15795 over 40x32 solves). Measure per workload.

    ``static_matrices=True`` declares P and A time-invariant (the canonical
    MPC shape: fixed dynamics/costs, drifting q/l/u) and factors the KKT
    system ONCE before the scan (:func:`models.admm.prepare`) — every tick
    then skips the per-solve factorization, the dominant cost of short
    warm-started solves (64% of the r4 headline solve). Each tick starts at
    the prepared rho, so ``carry_rho`` is ignored (a carried rho would
    silently mismatch the cached factor); with ``adaptive_rho`` on, a lane
    that drifts refactors in-loop for that tick only. The caller is
    responsible for P/A actually being constant along the time axis — pass
    broadcast-shaped leaves (P of shape (*B, n, n) broadcast to (T, ...))
    or simply the t=0 matrices repeated; only index 0 is factored.
    """
    T = qp_seq.q.shape[0]
    batch = qp_seq.q.shape[1:-1]
    dt = qp_seq.dtype
    n, m = qp_seq.P.shape[-1], qp_seq.A.shape[-2]

    if init is None:
        x0 = jnp.zeros(batch + (n,), dt)
        z0 = jnp.zeros(batch + (m,), dt)
        y0 = jnp.zeros(batch + (m,), dt)
    else:
        x0, z0, y0 = (jnp.asarray(v, dt) for v in init)
    rho0 = jnp.full(batch, settings.rho, dt)

    if static_matrices:
        qp0 = QP(P=qp_seq.P[0], q=qp_seq.q[0], A=qp_seq.A[0],
                 l=qp_seq.l[0], u=qp_seq.u[0])
        prepared = admm.prepare(qp0, settings)

        def step(carry, qp_t):
            x, z, y = carry
            sol = admm.solve(qp_t, settings, x0=x, z0=z, y0=y,
                             prepared=prepared)
            return (sol.x, sol.z, sol.y), sol

        _, sols = jax.lax.scan(step, (x0, z0, y0), qp_seq)
        return sols

    def step(carry, qp_t):
        x, z, y, rho = carry
        sol = admm.solve(qp_t, settings, x0=x, z0=z, y0=y,
                         rho0=rho if carry_rho else None)
        return (sol.x, sol.z, sol.y, sol.info.rho), sol

    _, sols = jax.lax.scan(step, (x0, z0, y0, rho0), qp_seq)
    return sols


solve_sequence_jit = jax.jit(
    solve_sequence,
    static_argnames=("settings", "carry_rho", "static_matrices"))


def solve_sequence_vectors(qp0: QP, q_seq, l_seq=None, u_seq=None,
                           settings: Settings = Settings(),
                           init=None, reuse_factor: bool = True) -> Solution:
    """Static-matrix MPC sequence with per-tick VECTORS only.

    The memory-right form of ``solve_sequence(static_matrices=True)``: P and
    A are stored ONCE at the fleet shape (*B, ...) instead of being tiled T
    times along the scan axis — at headline scale (B=4096, n=512) the tiled
    P alone would be T x 4 GiB. ``q_seq`` carries (T, *B, n); ``l_seq`` /
    ``u_seq`` optionally carry (T, *B, m) (default: qp0's bounds reused
    every tick). The KKT factor is built once (:func:`models.admm.prepare`)
    and every tick reuses it (``reuse_factor=False`` re-pays it per tick —
    the A/B baseline). Warm-starts (x, z, y) between ticks.
    """
    T = q_seq.shape[0]
    batch = qp0.batch_shape
    dt = qp0.dtype
    n, m = qp0.n, qp0.m

    if init is None:
        x0 = jnp.zeros(batch + (n,), dt)
        z0 = jnp.zeros(batch + (m,), dt)
        y0 = jnp.zeros(batch + (m,), dt)
    else:
        x0, z0, y0 = (jnp.asarray(v, dt) for v in init)

    if l_seq is None:
        l_seq = jnp.broadcast_to(qp0.l, (T,) + qp0.l.shape)
    if u_seq is None:
        u_seq = jnp.broadcast_to(qp0.u, (T,) + qp0.u.shape)
    # The prepared factor rides the scan CARRY, not the closure: a captured
    # multi-GiB M_inv constant gets a parameter layout XLA then relayouts
    # inside every while iteration (the reuse program ran 4x SLOWER than
    # re-factoring until the cache moved into the carry).
    prepared = admm.prepare(qp0, settings) if reuse_factor else None

    def step(carry, tick):
        x, z, y, prep = carry
        q_t, l_t, u_t = tick
        qp_t = QP(P=qp0.P, q=q_t, A=qp0.A, l=l_t, u=u_t)
        sol = admm.solve(qp_t, settings, x0=x, z0=z, y0=y, prepared=prep)
        return (sol.x, sol.z, sol.y, prep), sol

    _, sols = jax.lax.scan(step, (x0, z0, y0, prepared),
                           (q_seq, l_seq, u_seq))
    return sols


solve_sequence_vectors_jit = jax.jit(
    solve_sequence_vectors, static_argnames=("settings", "reuse_factor"))
