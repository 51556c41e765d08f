"""chip_smoke.py on the CPU: every phase at a small size, the four-card
phase on 4 of the 8 virtual devices, and the refusal to run without a GPU.

The full-size phases run on the card (``python chip_smoke.py``); these
tests keep its control flow and checks honest where there is no card.
"""

import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import quadraticprogramsolver_tpu as qps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase_precision(smoke):
    assert smoke.phase_precision(128) <= 1e-5


def test_phase_box_headline(smoke):
    r = smoke.phase_box("box headline", 8, 256, 128,
                        smoke.headline_settings(), spread=2, slowest=2)
    assert r["converged"] == 1.0 and r["audit"] <= smoke.AUDIT_TOL
    assert r["lanes"] >= 2 and r["scopes"] is None


def test_phase_box_defaults(smoke):
    st = qps.Settings(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4)
    r = smoke.phase_box("box defaults", 8, 256, 128, st, spread=2,
                        slowest=2)
    assert r["converged"] == 1.0 and r["audit"] <= smoke.AUDIT_TOL


def test_phase_box_traced(smoke, tmp_path):
    r = smoke.phase_box("box headline", 4, 128, 64,
                        smoke.headline_settings(), spread=1, slowest=1,
                        trace_dir=str(tmp_path))
    assert all(r["scopes"][s] > 0 for s in ("factor", "chunk", "check"))


def test_phase_prox(smoke):
    r = smoke.phase_prox(8, 128, 32, 32, spread=2, slowest=2)
    assert r["converged"] == 1.0 and r["audit"] <= smoke.AUDIT_TOL


def test_phase_reuse(smoke):
    r = smoke.phase_reuse(8, 256, 128, ticks=2, oracle_lanes=2)
    assert r["vs_fresh"] <= smoke.AUDIT_TOL and r["audit"] <= smoke.AUDIT_TOL


def test_phase_sparse(smoke):
    r = smoke.phase_sparse(2000)
    assert r["status"] in (2, 3) and r["storage"] == "bcoo"


def test_phase_mesh_on_four_virtual_devices(smoke):
    devs = jax.devices()[:4]
    r = smoke.phase_mesh(devs, 8, 256, 128, (128, 32, 32), 100)
    assert max(r.values()) <= smoke.MESH_TOL
    assert set(r) == {"box", "prox", "block"}


def test_audit_rejects_a_wrong_solution(smoke):
    """The oracle audit is what fails a phase: a solution moved by 1e-3
    must not pass it."""
    from quadraticprogramsolver_tpu.problems.generator import (
        device_random_qp_fleet)

    qp = device_random_qp_fleet(2, 256, 128, 0)
    sol = qps.solve_jit(qp, smoke.headline_settings())
    good = smoke.audit_box(qp, sol.x, [0, 1])
    bad = smoke.audit_box(qp, np.asarray(sol.x) + 1e-3, [0, 1])
    assert good <= smoke.AUDIT_TOL < bad
    with pytest.raises(smoke.SmokeFailure):
        smoke.check(bad <= smoke.AUDIT_TOL, "audit")


def test_main_exits_nonzero_without_gpu(smoke, capsys):
    assert jax.devices()[0].platform != "gpu"
    assert smoke.main([]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out and "no GPU" in out.err


def test_script_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script exits non-zero and prints no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
