"""Device-mesh utilities and fleet-sharded solving.

The reference is single-process (SURVEY.md §2: no distributed components).
On an accelerator the first-class scaling axis is **data parallelism over QP
instances**: a fleet of independent QPs is sharded over the mesh's ``qp``
axis with `NamedSharding`, and the one jitted solve runs SPMD — XLA inserts
the only collective needed (the all-reduce behind ``jnp.any(status ==
RUNNING)`` in the while-loop predicate), which NCCL runs over NVLink
between the cards of one host. The mesh is 1-D: every card reaches every
other at the same rate, so nothing is shaped for a torus.

Consensus-ADMM block splitting of a single large QP (the model-parallel
analogue) lives in parallel/consensus.py.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.problem import QP
from ..core.settings import ProxQPSettings, Settings
from ..core.state import Solution
from ..models.admm import solve_jit
from ..models.proxqp import ProxQPSolution
from ..models.proxqp import solve_jit as proxqp_solve_jit

BATCH_AXIS = "qp"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-host initialization (one JAX process per host).

    Thin wrapper over `jax.distributed.initialize`. Pass the coordinator's
    ``host:port``, the number of processes and this process's id: a plain
    GPU cluster announces none of them. After this, `jax.devices()` spans
    every host's cards and the fleet/consensus solvers shard across hosts
    with the same code, per the SURVEY §5 distributed-backend plan.
    No-ops when already initialized (safe to call from every entry point).
    """
    import jax

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise


def make_fleet_mesh(devices=None, axis_name: str = BATCH_AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices for fleet data-parallelism."""
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (axis_name,))


def shard_fleet(problem, mesh: Mesh, axis_name: str = BATCH_AXIS):
    """Place a batched problem pytree with its leading (fleet) axis split
    over the mesh.

    Works for any fleet-batched problem type whose leaves all carry the
    fleet as their leading axis — :class:`QP` and
    :class:`~..core.problem.ProxQPProblem` both do.
    """
    if not problem.batch_shape:
        raise ValueError("shard_fleet requires a batched problem "
                         "(leading fleet axis)")
    n_dev = mesh.shape[axis_name]
    if problem.batch_shape[0] % n_dev != 0:
        raise ValueError(
            f"fleet size {problem.batch_shape[0]} not divisible by "
            f"mesh axis {n_dev}")

    def put(x):
        spec = P(axis_name, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(put, problem)


def solve_fleet(qp: QP, settings: Settings, mesh: Mesh | None = None,
                axis_name: str = BATCH_AXIS) -> Solution:
    """Shard the fleet over the mesh and run the jitted batched solve.

    The solver body is written in batched form, so under GSPMD each device
    factors and iterates only its shard; the convergence predicate reduces
    across devices automatically.
    """
    mesh = make_fleet_mesh() if mesh is None else mesh
    qp = shard_fleet(qp, mesh, axis_name)
    # Module-level jit wrapper: a per-call jax.jit would own a fresh trace
    # cache and re-trace/compile on every call.
    return solve_jit(qp, settings)


def solve_prox_fleet(prob, settings: ProxQPSettings,
                     mesh: Mesh | None = None,
                     axis_name: str = BATCH_AXIS) -> ProxQPSolution:
    """Fleet data-parallelism for the prox-ALM family.

    The second solver family (`/root/reference/ProxQP.jl:118-173`) gets the
    same dominant scaling axis as the box form: a fleet of independent
    split-form QPs sharded over the mesh's ``qp`` axis, one jitted SPMD
    program, per-device factor + iterate over the local shard. Every state
    leaf of the prox solver (x/y/s/z, the {Ga, Gc, g} or M^{-1} factor
    cache, Anderson histories, infeasibility product caches) carries the
    fleet as its leading axis, so GSPMD splits the whole carry cleanly; the
    only cross-device traffic is the all-reduce behind the early-exit
    predicate.

    The equality-KKT warm start (ProxQP.jl:80-90) runs sharded too — each
    device LU-solves only its shard's KKT systems.
    """
    mesh = make_fleet_mesh() if mesh is None else mesh
    prob = shard_fleet(prob, mesh, axis_name)
    return proxqp_solve_jit(prob, settings)
