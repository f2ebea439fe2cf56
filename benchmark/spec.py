"""What a run reads: BENCHMARK.json and the files it names.

A cell (an entry of `workloads`) names a configuration and a traffic mix;
each is found by name: `configs/<config>.json`, `traffic/<traffic>.json`,
whose `kind` names the generator `kinds/<kind>.py`, and
`limits/<cell>.json`, the limits of the comparison that decides
`correct`. A per-layer metric `<name>` is read by `metrics/<name>.py`.
Adding any of these is adding a file: no file here needs an edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def config(name: str) -> dict:
    """A configuration file, with `published`: its model's config.json
    (the keys named by `published_keys`)."""
    c = _json(os.path.join(HERE, "configs", name + ".json"))
    c["published"] = {k: c[k] for k in c["published_keys"]}
    return c


def traffic(name: str) -> dict:
    return _json(os.path.join(HERE, "traffic", name + ".json"))


def limits(cell: str) -> dict:
    return _json(os.path.join(HERE, "limits", cell + ".json"))


def kind(name: str):
    """The generator module of a traffic kind."""
    return importlib.import_module(f"benchmark.kinds.{name}")


def metric_reader(name: str):
    """`read(ctx) -> float | None` of per-layer metric `name`."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell_name: str, group: str) -> list[dict]:
    """The `group` ("end_to_end" or "per_layer") metrics a cell reports:
    those that list it, or list no cells at all."""
    return [m for m in bench[group]
            if cell_name in m.get("workloads", [cell_name])]
