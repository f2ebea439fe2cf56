"""The system under test: `python -m dawnsearch_tpu_torch --web`, started
as a user starts it, in its own process group, on a free port, with its
data and log under the run's work directory. Also the HTTP helpers the
harness reads it with, and a sampler of the card's memory."""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

from benchmark.spec import ROOT

PACKAGE = "dawnsearch_tpu_torch"


def _die_with_parent() -> None:
    """In the node's child: SIGKILL it when the harness dies."""
    import ctypes
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def get_json(url: str, timeout: float = 60.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def node_env(config: dict, extra: dict) -> dict:
    """The node's settings from the configuration file, as DAWNSEARCH_*
    variables. The node builds its kernels and native libraries into
    dawnsearch_tpu_torch/_build/, a fixed path in the checkout."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update({
        "PYTHONPATH": ROOT,
        "USE_FLAX": "0", "USE_JAX": "0",
        "DAWNSEARCH_INDEX_CAPACITY": str(config["index_capacity"]),
        "DAWNSEARCH_INDEX_DTYPE": config["index_dtype"],
        "DAWNSEARCH_INDEX_RERANK": config["index_rerank"],
        "DAWNSEARCH_LAYER_IMPL": config["layer_impl"],
        "DAWNSEARCH_COMPUTE_DTYPE": config["compute_dtype"],
        "DAWNSEARCH_SEARCH_K": str(config["search_k"]),
        "DAWNSEARCH_WARMUP": "false",
    })
    env.update(extra)
    return env


class Node:
    """One node process. `cmd` is the interpreter command that runs the
    package (tests put a wrapper in its place)."""

    def __init__(self, work: str, data_dir: str, env: dict,
                 cmd: list[str] | None = None):
        if not os.path.isdir(os.path.join(ROOT, PACKAGE)):
            raise RuntimeError(f"{PACKAGE} is not in {ROOT}: nothing to run")
        self.port = free_port()
        self.base = f"http://127.0.0.1:{self.port}"
        self.log_path = os.path.join(work, "node.log")
        self._log = open(self.log_path, "w")
        cmd = cmd or [sys.executable, "-m", PACKAGE]
        self.proc = subprocess.Popen(
            [*cmd, "--config", os.path.join(work, "absent.toml"), "--web",
             "--data-dir", data_dir, "--listen", f"127.0.0.1:{self.port}"],
            cwd=work, env=env, stdout=self._log, stderr=subprocess.STDOUT,
            start_new_session=True, preexec_fn=_die_with_parent)

    def get(self, path: str, timeout: float = 60.0) -> dict:
        return get_json(self.base + path, timeout)

    def wait_up(self, timeout: float = 600.0) -> dict:
        deadline = time.monotonic() + timeout
        while True:
            if self.proc.poll() is not None:
                raise RuntimeError(f"node exited with {self.proc.returncode}"
                                   f":\n{self.tail()}")
            try:
                return self.get("/api/stats", timeout=5)
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)

    def tail(self, n: int = 4000) -> str:
        self._log.flush()
        with open(self.log_path, encoding="utf-8", errors="replace") as f:
            return f.read()[-n:]

    def kill(self) -> None:
        """SIGKILL the node and every process it started (its extraction
        workers); wait until each has ended."""
        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        self.proc.wait(timeout=60)
        try:  # workers left in the group after the leader died
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                os.killpg(self.proc.pid, 0)
            except ProcessLookupError:
                break
            time.sleep(0.05)
        self._log.close()


class MemorySampler:
    """The card's used memory, streamed by one `nvidia-smi -lms` process
    once a second; `stop()` ends it and returns the most seen, in bytes."""

    def __init__(self, period_ms: int = 1000, index: int = 0):
        self.peak = 0
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=memory.used",
             "--format=csv,noheader,nounits", "-i", str(index),
             "-lms", str(period_ms)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        for line in self.proc.stdout:
            try:
                self.peak = max(self.peak, int(float(line.split()[0])) << 20)
            except (ValueError, IndexError):
                pass

    def stop(self) -> int:
        self.proc.terminate()
        self.proc.wait(timeout=30)
        self._thread.join(timeout=30)
        return self.peak


def card() -> dict:
    """Name and power limit of card 0 (nvidia-smi), for the record."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout.strip()
        name, limit = (s.strip() for s in out.split(",", 1))
        return {"name": name, "power_limit": limit}
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return {"name": "unknown", "power_limit": "unknown"}
