"""`/api/profile` on the port's node (reference serving/http_service.py's
jax.profiler capture, here torch.profiler): loopback only (403 from
elsewhere), `seconds` capped at 30, a Chrome trace under data_dir/profile
that holds the ops other threads ran meanwhile (CPU activity here; CUDA
activity too on a card), and 500 with the error when the capture fails,
never 200 with an empty directory."""

import hashlib
import json
import os
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from dawnsearch_tpu_torch.config import Config
from dawnsearch_tpu_torch.node import DawnNode
from dawnsearch_tpu_torch.serving import http_service

torch.set_num_threads(2)


class HashEncoder:
    dim = 384

    def encode(self, texts):
        out = []
        for t in texts:
            seed = int.from_bytes(hashlib.md5(t.encode()).digest()[:4],
                                  "little")
            v = np.random.default_rng(seed).standard_normal(384)
            out.append((v / np.linalg.norm(v)).astype(np.float32))
        return np.stack(out)


@pytest.fixture
def node(tmp_path):
    cfg = Config(device="cpu", web=True, web_listen_address="127.0.0.1:0",
                 accept_insert=True, data_dir=str(tmp_path), index_dtype="f32")
    n = DawnNode(cfg, encoder=HashEncoder()).start()
    try:
        yield n, f"http://127.0.0.1:{n.http_port}"
    finally:
        n.stop()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def test_profile_writes_a_trace_of_the_searches_meanwhile(node, tmp_path):
    n, base = node
    n.service.insert_pages([(f"https://p/{i}", "", f"page {i}")
                            for i in range(32)])
    done = threading.Event()

    def search():
        while not done.is_set():
            n.service.text_search("page 3", search_remote=False)

    t = threading.Thread(target=search)
    t.start()
    try:
        got = _get(base + "/api/profile?seconds=0.5")
    finally:
        done.set()
        t.join(30)
    assert got["trace_dir"] == os.path.join(str(tmp_path), "profile")
    assert os.path.dirname(got["trace"]) == got["trace_dir"]
    with open(got["trace"]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(name.startswith("aten::") for name in names)


def test_profile_is_loopback_only(node, monkeypatch):
    _, base = node
    monkeypatch.setattr(http_service._Handler, "_is_local", lambda self: False)
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base + "/api/profile?seconds=0.1")
    assert e.value.code == 403


def test_profile_answers_500_when_the_capture_raises(node, monkeypatch):
    _, base = node

    def broken(out_dir, seconds):
        raise RuntimeError("CUPTI unavailable")

    monkeypatch.setattr(http_service, "capture_profile", broken)
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base + "/api/profile?seconds=0.1")
    assert e.value.code == 500
    assert "CUPTI unavailable" in json.loads(e.value.read())["error"]


def test_profile_answers_500_when_no_trace_is_written(node, monkeypatch,
                                                      tmp_path):
    _, base = node
    monkeypatch.setattr(torch.profiler.profile, "export_chrome_trace",
                        lambda self, path: None)
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base + "/api/profile?seconds=0.1")
    assert e.value.code == 500
    assert "no trace" in json.loads(e.value.read())["error"]
    assert os.listdir(tmp_path / "profile") == []
