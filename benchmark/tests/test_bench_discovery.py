"""A configuration, a traffic mix, a cell's limits and a per-layer metric
are each a file found by name: adding one edits no file that is there."""

import json
import os
import shutil

from benchmark import spec
from benchmark.tests.conftest import BENCH, ROOT


def _snapshot(d):
    out = {}
    for dirpath, _, files in os.walk(d):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    here = tmp_path / "benchmark"
    shutil.copytree(BENCH, here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = _snapshot(here)
    cfg = json.loads((here / "configs" / "minilm-l6-i8-1m.json").read_text())
    cfg["num_hidden_layers"] = 3
    (here / "configs" / "dummy-config.json").write_text(json.dumps(cfg))
    tr = json.loads((here / "traffic" / "search-steady.json").read_text())
    tr["rate"] = 7
    (here / "traffic" / "dummy-mix.json").write_text(json.dumps(tr))
    (here / "limits" / "dummy-cell.json").write_text(
        json.dumps({"score_gap": 1, "rank_gap": 1, "min_judged": 1}))
    (here / "metrics" / "dummy_metric.x.py").write_text(
        "def read(w):\n    return w.seconds * 2\n")
    monkeypatch.setattr(spec, "HERE", str(here))
    bench = {"workloads": [{"name": "dummy-cell", "config": "dummy-config",
                            "traffic": "dummy-mix", "chips": 1}],
             "per_layer": [{"name": "dummy_metric.x",
                            "workloads": ["dummy-cell"]}]}
    cell = spec.cell(bench, "dummy-cell")
    assert spec.config(cell["config"])["num_hidden_layers"] == 3
    assert spec.config(cell["config"])["published"]["num_hidden_layers"] == 3
    mix = spec.traffic(cell["traffic"])
    assert mix["rate"] == 7
    assert spec.kind(mix["kind"]).run
    assert spec.limits("dummy-cell")["min_judged"] == 1
    names = [m["name"] for m in spec.metrics_of(bench, "dummy-cell",
                                                "per_layer")]

    class W:
        seconds = 1.5
    assert [spec.metric_reader(n)(W) for n in names] == [3.0]
    after = _snapshot(here)
    assert {k: v for k, v in after.items() if k in before} == before


def test_every_name_in_the_benchmark_has_its_files():
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    for w in bench["workloads"]:
        spec.config(w["config"])
        spec.kind(spec.traffic(w["traffic"])["kind"])
        assert spec.limits(w["name"])
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
        for w in m["workloads"]:
            assert m["moves"] in [e["name"] for e in spec.metrics_of(
                bench, w, "end_to_end")]
