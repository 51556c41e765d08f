"""Trace reduction (utils/profiling.py): device time per solver scope."""

import gzip
import os
import shutil

import jax
import numpy as np
import pytest

import quadraticprogramsolver_tpu as qps
from quadraticprogramsolver_tpu.utils import profiling

DATA = os.path.join(os.path.dirname(__file__), "data", "h100_trace_b1024")


def test_scope_of_picks_innermost_scope():
    assert profiling.scope_of(
        "jit(solve)/while/body/chunk/while/body/closed_call/mul") == "chunk"
    # A refactor inside the loop body is factor time, not chunk time.
    assert profiling.scope_of(
        "jit(solve)/while/body/factor/jit(cholesky)/cholesky") == "factor"
    assert profiling.scope_of("jit(solve)/while/cond/and") == "other"
    assert profiling.scope_of("") == "other"


def test_scope_device_times_on_recorded_gpu_trace(tmp_path):
    """The recorded H100 trace: cuSOLVER/cuBLAS calls carry their own
    instruction names, kernels inside CUDA graphs are matched by kernel
    name, and the graph's GEMM goes to its graph's scope."""
    run = tmp_path / "plugins" / "profile" / "run"
    run.mkdir(parents=True)
    with gzip.open(os.path.join(DATA, "solve.xplane.pb.gz")) as src, \
            open(run / "solve.xplane.pb", "wb") as dst:
        shutil.copyfileobj(src, dst)
    with gzip.open(os.path.join(DATA, "solve_hlo.txt.gz"), "rt") as f:
        hlo = f.read()
    t = profiling.scope_device_times(str(tmp_path), hlo)
    want = {"factor": 0.023587061, "chunk": 0.012600212,
            "check": 0.001644588, "other": 0.001320785}
    for k, v in want.items():
        assert t[k] == pytest.approx(v, rel=1e-6), (k, t)
    assert t["total"] == pytest.approx(sum(want.values()), rel=1e-6)


def test_scope_device_times_on_cpu_trace(tmp_path):
    """A live trace of a small fleet solve on the CPU: every scope the
    solver names gets time, on the host plane XLA:CPU runs ops on."""
    from quadraticprogramsolver_tpu.problems.generator import (
        device_random_qp_fleet)

    qp = device_random_qp_fleet(4, 32, 16, 0)
    st = qps.Settings(eps_abs=1e-4, eps_rel=1e-4, rho=0.4,
                      kkt_refinement_steps=0, sigma_free_rhs=True)
    hlo = qps.solve_jit.lower(qp, st).compile().as_text()
    jax.block_until_ready(qps.solve_jit(qp, st))
    with profiling.trace(str(tmp_path)):
        jax.block_until_ready(qps.solve_jit(qp, st))
    t = profiling.scope_device_times(str(tmp_path), hlo, "/host:CPU")
    assert all(t[s] > 0 for s in profiling.SOLVER_SCOPES), t
    assert np.isclose(t["total"], sum(v for k, v in t.items()
                                      if k != "total"))
