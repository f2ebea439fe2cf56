"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (timed as `setup_s`): the cell's inputs are made from the seed on
the card (benchmark/prepare.py: checkpoint, page store, queries or WARC
files), the node starts as a user starts it and fills its index from the
store, and the cell's own traffic warms it. Then the window: `--seconds`
of the cell's traffic, end-to-end metrics from the client's side
(`--trace 0`), or per-layer metrics from /api/metrics and an /api/profile
trace (`--trace 1`). Then the node is killed, and the plain reference
(benchmark/reference/) judges what the node answered in the window. The
numbers compared, each beside its limit, are the last lines on standard
error and the last key of the result line, the last line on standard
output.

Exits 2 without a result when torch sees no card or fewer than the cell
asks for, and 1 when the run fails, or when JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

if __package__ in (None, ""):  # run as a script: the checkout's root
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from benchmark import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "dawnsearch_tpu")


@dataclasses.dataclass
class Run:
    """What every stage of a run reads. Written to the work directory as
    run.json for the prepare process."""
    workload: str
    seed: int
    seconds: int
    trace: bool
    work: str
    device: str
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    node_env: dict = dataclasses.field(default_factory=dict)

    @property
    def model_dir(self) -> str:
        return os.path.join(self.work, "model")

    @property
    def data_dir(self) -> str:
        return os.path.join(self.work, "data")

    def save(self) -> str:
        path = os.path.join(self.work, "run.json")
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f)
        return path

    @classmethod
    def load(cls, path: str) -> "Run":
        with open(path) as f:
            return cls(**json.load(f))


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def check_card(chips: int) -> str | None:
    """Why the run cannot go on, or None."""
    os.environ.setdefault("PYTORCH_NVML_BASED_CUDA_CHECK", "1")
    import torch
    if not torch.cuda.is_available():
        return "torch sees no CUDA card"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} cards, torch sees "
                f"{torch.cuda.device_count()}")
    return None


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="serve on the node's W8A8 encoder (K4, "
                        "layer_impl=layer_i8): the control that the "
                        "comparison deciding `correct` must fail")
    return p.parse_args(argv)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None, device: str = "cuda", node_cmd=None,
         node_env: dict | None = None, drive=None) -> int:
    """`device="cpu"` (tests) skips the look for a card and runs the
    node's plain twins; `node_cmd` replaces the interpreter command that
    runs the node (tests plant faults with it); `drive` replaces the
    kind's warm-up and window (benchmark/sweep.py)."""
    args = parse(argv)
    # a SIGTERM unwinds through the finally below, which kills the node
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    if device == "cuda":
        why = check_card(cell["chips"])
        if why:
            say(f"no run: {why}")
            return 2
    if not os.path.isdir(os.path.join(spec.ROOT, "dawnsearch_tpu_torch")):
        say(f"no run: dawnsearch_tpu_torch is not in {spec.ROOT}")
        return 1
    config = spec.config(cell["config"])
    if args.control:
        config["layer_impl"] = "layer_i8"
    traffic = spec.traffic(cell["traffic"])
    kind = spec.kind(traffic["kind"])
    work = tempfile.mkdtemp(prefix="dawnbench-")
    run = Run(args.workload, args.seed, args.seconds, bool(args.trace), work,
              device, cell, config, traffic, spec.limits(args.workload),
              dict(node_env or {}))
    node = mem = None
    try:
        env = dict(os.environ, PYTHONPATH=spec.ROOT)
        subprocess.run([sys.executable, "-m", "benchmark.prepare",
                        run.save()], cwd=spec.ROOT, env=env, check=True)
        with open(os.path.join(work, "manifest.json")) as f:
            manifest = json.load(f)
        from benchmark.node import MemorySampler, Node, node_env as ne
        settings = {"DAWNSEARCH_MODEL_DIR": run.model_dir,
                    "DAWNSEARCH_DEVICE": device,
                    **kind.node_settings(run), **run.node_env}
        if device == "cuda":
            mem = MemorySampler()
        node = Node(work, run.data_dir, ne(config, settings), cmd=node_cmd)
        stats = node.wait_up()
        say(f"node up at {time.monotonic() - T_START:.1f} s: "
            f"{stats['pages_indexed']} pages, capacity "
            f"{stats['index_capacity']}")
        window = (drive or kind.run)(run, node, manifest, T_START)
        peak = mem.stop() if mem is not None else 0
        mem = None
        node.kill()
        node = None
        checks = kind.judge(run, window, manifest)
        return report(run, bench, window, checks, peak)
    except BaseException:
        if node is not None:
            say(f"--- node log (end) ---\n{node.tail()}")
        raise
    finally:
        if mem is not None:
            mem.stop()
        if node is not None:
            node.kill()
        shutil.rmtree(work, ignore_errors=True)


def report(run: Run, bench: dict, window, checks: dict, peak: int) -> int:
    """Print the readings and the result line."""
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    for line in window.lines:
        say(line)
    metrics = {}
    group = "per_layer" if run.trace else "end_to_end"
    for m in spec.metrics_of(bench, run.workload, group):
        if run.trace:
            value = spec.metric_reader(m["name"])(window)
        else:
            value = window.e2e.get(m["name"])
        if value is None or (isinstance(value, float) and math.isnan(value)):
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    from benchmark.node import card
    info = card() if run.device == "cuda" else {"name": "cpu",
                                                "power_limit": "none"}
    device = {"platform": "gpu" if run.device == "cuda" else "cpu",
              "kind": info["name"], "count": run.cell["chips"],
              "memory_peak_bytes": peak}
    if run.trace and window.trace is not None:
        device["busy_s"] = window.trace.busy_s
        device["window_s"] = window.trace.span
    say(f"card: {info['name']}, power limit {info['power_limit']}")
    for name, c in checks.items():
        say(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    out = {"correct": correct, "attempted": window.attempted,
           "failed": window.failed, "metrics": metrics, "device": device}
    if run.trace and window.trace is not None:
        out["breakdown"] = {"device_ops": window.trace.top_ops(),
                            "idle_gaps": window.trace.idle_gaps()}
    out["checks"] = checks
    bad = loaded_forbidden()
    if bad:
        say(f"no result: this process loaded {bad}")
        return 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
