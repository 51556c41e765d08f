"""Bench harness tests: timing path, CSV/JSONL emission, schema guard."""

import csv
import json

import numpy as np
import pytest

import quadraticprogramsolver_tpu as qps
from quadraticprogramsolver_tpu.bench.harness import (
    CSV_COLUMNS,
    BenchCase,
    emit_results,
    run_case,
    run_sweep,
)

FAST = qps.Settings(max_iterations=500, eps_abs=1e-4, eps_rel=1e-4, rho=0.1,
                    adaptive_rho=True)


def test_run_case_and_emit(tmp_path):
    case = BenchCase(qps.ProblemClass.RANDOM_QP, num_elements=16, batch=8)
    r = run_case(case, FAST, samples=2, dtype=np.float64)
    assert r.total == 8 and 0 <= r.solved <= 8
    assert r.best_time_sec > 0
    assert r.solves_per_sec > 0

    csv_path = tmp_path / "bench.csv"
    jsonl_path = tmp_path / "bench.jsonl"
    emit_results([r], str(csv_path), str(jsonl_path))
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    assert rows[0]["problem_class"] == "random_qp"
    assert rows[0]["version"] == qps.__version__
    with open(jsonl_path) as f:
        rec = json.loads(f.readline())
    assert rec["batch"] == 8

    # Append keeps the schema; a drifted schema must be refused.
    emit_results([r], str(csv_path))
    with open(csv_path) as f:
        assert len(list(csv.DictReader(f))) == 2
    bad = tmp_path / "bad.csv"
    with open(bad, "w") as f:
        f.write("wrong,schema\n1,2\n")
    with pytest.raises(ValueError, match="schema"):
        emit_results([r], str(bad))


def test_small_sweep(tmp_path):
    cases = [
        BenchCase(qps.ProblemClass.RANDOM_QP, 12, batch=4),
        BenchCase(qps.ProblemClass.ISOTONIC, 12, batch=4),
    ]
    results = run_sweep(cases, FAST, samples=1, dtype=np.float64,
                        jsonl_path=str(tmp_path / "s.jsonl"), verbose=False)
    assert len(results) == 2
    assert all(r.best_time_sec > 0 for r in results)


def test_headline_record_schema_guard(tmp_path):
    """append_headline_record keeps headline configs in artifacts and
    refuses appends whose key set drifts — the
    JSONL analogue of the CSV header guard (RunBenchmarks.jl:123-137)."""
    import json

    import pytest

    from quadraticprogramsolver_tpu.bench.harness import append_headline_record

    path = str(tmp_path / "headline.jsonl")
    rec = append_headline_record(path, {"batch": 4096, "value": 11490.0})
    assert rec["batch"] == 4096
    assert {"label", "version", "device", "date_utc"} <= set(rec)
    append_headline_record(path, {"batch": 3072, "value": 10651.0})
    with open(path) as f:
        rows = [json.loads(ln) for ln in f]
    assert [r["batch"] for r in rows] == [4096, 3072]
    with pytest.raises(ValueError, match="schema guard"):
        append_headline_record(path, {"batch": 2048, "extra_key": 1.0})
    # Additive columns (strict superset) are a deliberate schema extension
    # and allowed; the guard still refuses dropped columns (above).
    append_headline_record(path, {"batch": 1024, "value": 1.0,
                                  "new_diag": 2.0})
    # Rows of a DIFFERENT bench family in the same file are guarded
    # independently of the headline family's schema.
    append_headline_record(path, {"bench": "defaults", "value": 3.0})
    append_headline_record(path, {"bench": "defaults", "value": 4.0})
    with pytest.raises(ValueError, match="schema guard"):
        append_headline_record(path, {"bench": "defaults", "other": 5.0})
