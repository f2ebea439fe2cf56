"""The port's `track` and `sidecar` subcommands, run as a user runs them.

- `python -m dawnsearch_tpu_torch track` answers an Announce with Peers
  and exits 0 on SIGTERM.
- `python -m dawnsearch_tpu_torch sidecar <warc>` writes the embeddings
  the node's own encoder gives the file's pages (the same seeded weights,
  on the CPU here), and `sidecar --load` puts them into a data dir's store
  and index.
"""

import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from dawnsearch_tpu_torch.config import Config
from dawnsearch_tpu_torch.index.provider import SearchProvider
from dawnsearch_tpu_torch.ingest.pages import iter_pages
from dawnsearch_tpu_torch.ingest.sidecar import load_sidecar
from dawnsearch_tpu_torch.ingest.warc import write_warc
from dawnsearch_tpu_torch.net import packets
from dawnsearch_tpu_torch.node import make_encoder
from tests.test_torch_ingest import ENGLISH, page_html

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(tmp_path, *args, **env):
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("DAWNSEARCH_")}
    return [sys.executable, "-m", "dawnsearch_tpu_torch", "--config",
            str(tmp_path / "absent.toml"), *args], \
        dict(base, PYTHONPATH=REPO, **env)


def test_track_answers_and_stops_on_sigterm(tmp_path):
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd, env = _cli(tmp_path, "track", "--listen", f"127.0.0.1:{port}")
    log = open(tmp_path / "track.log", "w")
    proc = subprocess.Popen(cmd, env=env, stdout=log,
                            stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 60
        while "tracker on" not in (tmp_path / "track.log").read_text():
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.1)
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as peer:
            peer.settimeout(10)
            peer.sendto(packets.encode(packets.Announce("cli-peer-0000000",
                                                        False, 3)),
                        ("127.0.0.1", port))
            reply = packets.decode(peer.recvfrom(65536)[0])
        assert isinstance(reply, packets.Peers) and reply.peers == []
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        log.close()


def test_sidecar_writes_the_encoders_embeddings_and_loads(tmp_path):
    warc = str(tmp_path / "crawl.warc.gz")
    write_warc(warc, [(f"https://s.example/{i}",
                       page_html(f"Story {i}", f"chapter {i} " + ENGLISH))
                      for i in range(5)])
    env = dict(DAWNSEARCH_DEVICE="cpu", DAWNSEARCH_SEQ_BUCKETS="16,32")
    cmd, env = _cli(tmp_path, "sidecar", warc, **env)
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    path = str(tmp_path / "crawl.sidecar.npz")
    assert f"5 pages -> {path}" in out.stdout
    emb, urls, titles, texts = load_sidecar(path)
    pages = list(iter_pages(warc))
    assert list(urls) == [p.url for p in pages]
    enc = make_encoder(Config(device="cpu", seq_buckets=(16, 32)))
    np.testing.assert_allclose(emb, enc.encode([p.combined for p in pages]),
                               atol=1e-6)
    data = tmp_path / "data"
    cmd, env = _cli(tmp_path, "--data-dir", str(data), "sidecar", "--load",
                    path, DAWNSEARCH_DEVICE="cpu")
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"indexed 5 pages into {data}" in out.stdout
    provider = SearchProvider(data_dir=str(data), device="cpu")
    try:
        assert len(provider.store) == len(provider.index) == 5
        rec, e = provider.store.get(2)
        assert rec.url == urls[1]
        np.testing.assert_array_equal(e, emb[1])
    finally:
        provider.shutdown()
