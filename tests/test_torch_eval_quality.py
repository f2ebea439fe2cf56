"""The port's weights-drop quality harness (dawnsearch_tpu_torch/
eval_quality.py, `python -m dawnsearch_tpu_torch eval-quality`), the 3
cases of tests/test_eval_quality.py on the port's encoder (on the CPU)
and the synthesized all-MiniLM-L6-v2 checkpoint layout.

Random weights cannot pass the semantic gates, so --allow-random runs
check the mechanics: every stage runs, parity against the HF transformers
pipeline on the shared checkpoint holds (max cosine deviation <= 1e-3),
and strict mode fails random weights (the gate gates).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

transformers = pytest.importorskip("transformers")

from tests.test_real_checkpoint_layout import model_dir  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


def run_eval(model_dir, capsys, monkeypatch, *extra):
    from dawnsearch_tpu_torch import eval_quality
    monkeypatch.setenv("DAWNSEARCH_DEVICE", "cpu")
    rc = eval_quality.main([model_dir, *extra])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    return rc, {o["stage"]: o for o in lines}


def test_harness_mechanics_allow_random(model_dir, capsys,  # noqa: F811
                                        monkeypatch):
    rc, stages = run_eval(model_dir, capsys, monkeypatch, "--allow-random")
    assert rc == 0
    assert set(stages) == {"parity", "separation", "retrieval", "summary"}
    # parity runs for real on random weights: the checkpoint is shared
    # with HF, so the pipelines must agree
    assert stages["parity"]["status"] == "ok", stages["parity"]
    assert stages["summary"]["semantic_gates"] == "skipped"


def test_strict_mode_fails_random_weights(model_dir, capsys,  # noqa: F811
                                          monkeypatch):
    rc, stages = run_eval(model_dir, capsys, monkeypatch)
    assert rc == 1
    assert stages["summary"]["status"] == "FAIL"


def test_cli_evalq_subcommand(model_dir):  # noqa: F811
    """`python -m dawnsearch_tpu_torch evalq <model_dir>` runs the same
    harness and exits 0 with --allow-random."""
    env = dict(os.environ, DAWNSEARCH_DEVICE="cpu", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "dawnsearch_tpu_torch", "evalq", model_dir,
         "--allow-random"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    stages = {o["stage"]: o for o in
              (json.loads(s) for s in out.stdout.splitlines()
               if s.startswith("{"))}
    assert stages["summary"]["status"] == "ok"
    assert stages["parity"]["status"] == "ok"
