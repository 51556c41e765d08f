"""OSQP-style setup / update / solve front-end with factor reuse.

Real OSQP's workflow API is ``setup(P, q, A, l, u) -> update_lin_cost /
update_bounds -> solve``, re-solving the same structure with drifting data
without re-paying the setup; the reference's ProxQP constructors embody the
same split (factor at construction, `/root/reference/ProxQP.jl:73-115`;
solve reuses it, `:118-173`). This module provides that contract for the
fleets: :class:`CachedQPSolver` factors the KKT system once at
construction and every subsequent :meth:`solve` skips it — on the headline
workload the factor is about half of a solve, so static-matrix re-solves
(MPC ticks, sweeps over q) run about twice as fast.

The heavy lifting lives in :func:`models.admm.prepare` /
:class:`models.admm.PreparedFactor`; this class just owns the handle, the
vector updates, and optional warm starting from the previous solution.
"""

from __future__ import annotations

import dataclasses

import jax

from ..core.problem import QP
from ..core.settings import Settings
from ..core.state import Solution
from ..models import admm


def _jit_prepared_solve(qp, settings, x0, z0, y0, prepared):
    return admm.solve(qp, settings, x0=x0, z0=z0, y0=y0, prepared=prepared)


_jit_prepared_solve = jax.jit(_jit_prepared_solve,
                              static_argnames=("settings",))


class CachedQPSolver:
    """Factor once, solve many: the setup/update/solve contract.

    ::

        solver = CachedQPSolver(qp, settings)     # setup: factors KKT once
        sol = solver.solve()
        solver.update(q=new_q, l=new_l)           # cheap: no refactor
        sol = solver.solve(warm_start=True)       # reuses factor + iterates

    Validity: P and A are fixed at construction (changing them means
    constructing a new solver — same rule as OSQP's ``update`` vs
    ``setup``). q, l, u update freely. The solve runs at the prepared rho;
    with ``adaptive_rho`` on, lanes whose rho drifts refactor in-loop for
    that solve only (the prepared factor itself is immutable).

    Not a pytree — this is a host-side convenience owning device buffers;
    inside jitted code use :func:`models.admm.prepare` +
    ``solve(..., prepared=...)`` directly.
    """

    def __init__(self, qp: QP, settings: Settings = Settings(), rho0=None,
                 mesh=None):
        """``mesh``: optionally shard the fleet (and therefore the cached
        factor and every solve) over a device mesh at setup —
        :func:`parallel.mesh.shard_fleet` + GSPMD; updates and warm starts
        keep the sharding."""
        if settings.scaling_iters:
            raise ValueError(
                "CachedQPSolver does not support scaling_iters (the "
                "equilibration would be refit per solve, invalidating the "
                "cached factor); pre-scale the problem once instead")
        if mesh is not None:
            from ..parallel.mesh import shard_fleet

            qp = shard_fleet(qp, mesh)
        self._qp = qp
        self._settings = settings
        self._prepared = admm.prepare_jit(qp, settings, rho0)
        self._last: Solution | None = None

    @property
    def qp(self) -> QP:
        return self._qp

    @property
    def prepared(self) -> admm.PreparedFactor:
        return self._prepared

    def update(self, q=None, l=None, u=None) -> None:
        """Replace cost/bound vectors without refactoring (shapes fixed)."""
        import jax.numpy as jnp

        qp = self._qp
        upd = {}
        for name, new in (("q", q), ("l", l), ("u", u)):
            if new is not None:
                new = jnp.asarray(new, qp.dtype)
                old = getattr(qp, name)
                if new.shape != old.shape:
                    raise ValueError(
                        f"update({name}): shape {new.shape} != {old.shape} "
                        "(structure changes need a new CachedQPSolver)")
                # Keep the old leaf's placement (mesh-sharded solvers):
                # otherwise each update arrives default-placed and the jit
                # re-lays-out its inputs (or recompiles) every tick.
                if hasattr(old, "sharding"):
                    import jax

                    new = jax.device_put(new, old.sharding)
                upd[name] = new
        if upd:
            self._qp = dataclasses.replace(qp, **upd)

    def refactor(self, P=None, A=None, rho0=None) -> None:
        """Replace P and/or A and re-factor — OSQP's update_P/update_A.

        Unlike :meth:`update` this PAYS the factorization again (the cache
        is P/A-dependent); the warm-start state from previous solves is
        kept (the previous solution remains a good start when the matrix
        perturbation is small — the SQP/trust-region update pattern).
        Shapes and placement must match the originals.
        """
        import jax
        import jax.numpy as jnp

        qp = self._qp
        upd = {}
        for name, new in (("P", P), ("A", A)):
            if new is not None:
                new = jnp.asarray(new, qp.dtype)
                old = getattr(qp, name)
                if new.shape != old.shape:
                    raise ValueError(
                        f"refactor({name}): shape {new.shape} != {old.shape} "
                        "(structure changes need a new CachedQPSolver)")
                if hasattr(old, "sharding"):
                    new = jax.device_put(new, old.sharding)
                upd[name] = new
        if upd:
            self._qp = dataclasses.replace(qp, **upd)
        self._prepared = admm.prepare_jit(self._qp, self._settings, rho0)

    def solve(self, x0=None, z0=None, y0=None,
              warm_start: bool = False) -> Solution:
        """Solve with the cached factor.

        ``warm_start=True`` starts from the previous solve's (x, z, y) —
        the MPC-tick pattern; explicit ``x0``/``z0``/``y0`` override it.
        """
        if warm_start and self._last is not None:
            x0 = self._last.x if x0 is None else x0
            z0 = self._last.z if z0 is None else z0
            y0 = self._last.y if y0 is None else y0
        sol = _jit_prepared_solve(self._qp, self._settings, x0, z0, y0,
                                  self._prepared)
        self._last = sol
        return sol
