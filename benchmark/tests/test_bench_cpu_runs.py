"""Whole runs of tiny cells on the CPU (the node's plain twins, f32),
through the harness's own run.main with the look for a card skipped: a
sound node comes out correct, and a node with a fault planted where its
answers are made comes out not correct, once for each fault a cell of
that kind can have."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.tests.conftest import HERE, ROOT


def _run(tiny_spec, cell: str, seconds: int, fault: str | None = None,
         trace: int = 0, env_extra: dict | None = None) -> dict:
    env = dict(os.environ, PYTHONPATH=ROOT)
    node_env = {"DAWNSEARCH_INGEST_BATCH_SIZE": "32", **(env_extra or {})}
    if fault:
        env["TINY_NODE_CMD"] = json.dumps(
            [sys.executable, os.path.join(HERE, "faulty_node.py")])
        node_env["BENCH_FAULT"] = fault
    env["TINY_NODE_ENV"] = json.dumps(node_env)
    p = subprocess.run(
        [sys.executable, str(tiny_spec / "driver.py"), "--workload", cell,
         "--seed", "3000000007", "--seconds", str(seconds), "--trace",
         str(trace)], capture_output=True, text=True, env=env, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("fault", [None, "answer", "half"])
def test_open_loop_search(tiny_spec, fault):
    out = _run(tiny_spec, "tiny-open", 4, fault)
    assert out["correct"] is (fault is None), out["checks"]
    assert out["metrics"]["search_p95_ms"]["value"] > 0
    assert out["attempted"] == 80 and out["failed"] == 0
    assert list(out)[-1] == "checks"


def test_closed_loop_search_traced(tiny_spec):
    out = _run(tiny_spec, "tiny-closed", 4, trace=1)
    assert out["correct"], out["checks"]
    assert out["metrics"]["query_batch.steady"]["value"] >= 1


@pytest.mark.parametrize("fault", [None, "embedding", "text", "lang"])
def test_warc_ingest(tiny_spec, fault):
    out = _run(tiny_spec, "tiny-ingest", 20, fault)
    assert out["correct"] is (fault is None), out["checks"]
    assert out["metrics"]["ingest_pages_s"]["value"] > 0
