"""The inputs of one run, made from its seed on the card in a process of
their own (so the node, started next, is the one process on the card):
`python -m benchmark.prepare <run.json>`, where run.json is the Run the
harness wrote. The traffic kind's `prepare` writes the checkpoint, the
store and its own files into the work directory and returns what the
harness needs later; that goes to manifest.json."""

from __future__ import annotations

import json
import os
import sys
import time


def main(path: str) -> int:
    from benchmark import spec
    from benchmark.run import Run
    run = Run.load(path)
    t0 = time.monotonic()
    manifest = spec.kind(run.traffic["kind"]).prepare(run)
    manifest["prepare_s"] = time.monotonic() - t0
    with open(os.path.join(run.work, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1]))
