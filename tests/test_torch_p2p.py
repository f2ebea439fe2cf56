"""P2P integration: tracker rendezvous, two-node search fan-out,
insert replication, remote more-like-this — all over loopback UDP
(the TPU-native analog of the reference's multi-node story, SURVEY §4).
The port's copy of tests/test_p2p.py."""

import hashlib
import time

import numpy as np
import pytest
import torch

from dawnsearch_tpu_torch.config import Config
from dawnsearch_tpu_torch.net.tracker import Tracker
from dawnsearch_tpu_torch.node import DawnNode

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


def node_cfg(tmp_path, name, tracker_port, **kw):
    cfg = Config(device="cpu")
    cfg.data_dir = str(tmp_path / name)
    cfg.udp = True
    cfg.udp_listen_address = "127.0.0.1:0"
    cfg.trackers = [f"127.0.0.1:{tracker_port}"]
    cfg.accept_insert = True
    cfg.announce_interval_s = 0.15
    cfg.search_deadline_ms = 500.0
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def wait_until(pred, timeout=5.0, step=0.05):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(step)
    return False


@pytest.fixture
def duo(tmp_path):
    tracker = Tracker("127.0.0.1:0").start()
    a = DawnNode(node_cfg(tmp_path, "a", tracker.port),
                 encoder=HashEncoder()).start()
    b = DawnNode(node_cfg(tmp_path, "b", tracker.port),
                 encoder=HashEncoder()).start()
    assert wait_until(lambda: a.udp.fresh_peers() and b.udp.fresh_peers())
    yield a, b, tracker
    a.stop()
    b.stop()
    tracker.stop()


def test_tracker_membership(duo):
    a, b, tracker = duo
    assert {p.instance_id for p in a.udp.fresh_peers()} == {b.instance_id}
    assert {p.instance_id for p in b.udp.fresh_peers()} == {a.instance_id}
    assert set(tracker.peers) == {a.instance_id, b.instance_id}
    # tracker records accept_insert and (eventually) page counts
    assert all(p.accept_insert for p in tracker.peers.values())


def test_remote_search_fanout(tmp_path):
    # accept_insert OFF so pages live ONLY on node a; b must find them
    # via the UDP fan-out, not replication.
    tracker = Tracker("127.0.0.1:0").start()
    a = DawnNode(node_cfg(tmp_path, "a", tracker.port, accept_insert=False),
                 encoder=HashEncoder()).start()
    b = DawnNode(node_cfg(tmp_path, "b", tracker.port, accept_insert=False),
                 encoder=HashEncoder()).start()
    assert wait_until(lambda: a.udp.fresh_peers() and b.udp.fresh_peers())
    a.service.insert_pages(
        [(f"https://a.example/{i}", f"Title {i}", f"text {i}")
         for i in range(5)])
    try:
        # let b learn a's updated page count (optimistic pages_searched)
        wait_until(
            lambda: any(p.pages_indexed == 5 for p in b.udp.fresh_peers()))
        res = b.service.text_search("Title 2\ntext 2")
        assert res.pages, "no remote results arrived before the deadline"
        assert res.pages[0].url == "https://a.example/2"
        assert res.pages[0].instance_id == a.instance_id
        assert res.instances_contacted == 2  # self + one peer
        assert res.pages_searched == 5  # a's page count (b has none)
        assert len(b.provider.store) == 0  # nothing replicated
    finally:
        a.stop()
        b.stop()
        tracker.stop()


def test_insert_replication(duo):
    a, b, _ = duo
    a.service.insert_pages([("https://a.example/r", "Replicated", "body")])
    # replication is fire-and-forget; b applies it as a network insert
    assert wait_until(lambda: len(b.provider.store) == 1)
    res = b.service.text_search("Replicated\nbody", search_remote=False)
    assert res.pages[0].url == "https://a.example/r"
    # network-originated insert must NOT re-replicate back (no ping-pong)
    time.sleep(0.3)
    assert len(a.provider.store) == 1


def test_remote_more_like(duo):
    a, b, _ = duo
    ids = a.service.insert_pages(
        [("https://a.example/m", "Find me", "similar content")])
    wait_until(lambda: len(b.provider.store) >= 1)  # replication lands
    # b explores a's page by (instance, page) — needs GetEmbedding RTT
    res = b.service.more_like_search(a.instance_id, ids[0])
    assert res is not None and res.pages
    assert any(p.url == "https://a.example/m" for p in res.pages)


def test_distance_limit_prunes(duo):
    a, b, _ = duo
    # a holds pages unrelated to the query (random embeddings, distance ~1)
    a.service.insert_pages(
        [(f"https://a.example/{i}", f"Other {i}", f"junk {i}")
         for i in range(3)])
    # b holds k copies of the query text -> its top-k distances are ~0,
    # so the advertised distance_limit prunes every a-side hit
    # (udp_service.rs:195-199).
    b.service.insert_pages(
        [(f"https://b.example/{i}", "T", "x") for i in range(3)],
        from_network=True)  # avoid replicating to a
    b.service.k = 3
    res = b.service.text_search("T\nx")
    assert len(res.pages) == 3
    assert all(p.instance_id == b.instance_id for p in res.pages)
    assert res.instances_contacted == 2  # a was asked, its hits were pruned


def test_search_with_no_peers(tmp_path):
    tracker = Tracker("127.0.0.1:0").start()
    solo = DawnNode(node_cfg(tmp_path, "solo", tracker.port),
                    encoder=HashEncoder()).start()
    try:
        solo.service.insert_pages([("https://s/1", "Solo", "alone")])
        t0 = time.time()
        res = solo.service.text_search("Solo\nalone")
        # no peers -> no deadline wait (udp_service.rs:301-312)
        assert time.time() - t0 < solo.cfg.search_deadline_ms / 1000.0
        assert res.pages[0].url == "https://s/1"
        assert res.instances_contacted == 1
    finally:
        solo.stop()
        tracker.stop()


def test_peer_expiry(tmp_path):
    tracker = Tracker("127.0.0.1:0").start()
    a = DawnNode(node_cfg(tmp_path, "a", tracker.port),
                 encoder=HashEncoder()).start()
    b = DawnNode(node_cfg(tmp_path, "b", tracker.port),
                 encoder=HashEncoder()).start()
    try:
        assert wait_until(lambda: a.udp.fresh_peers())
        # simulate b going dark long ago
        with a.udp._peers_lock:
            for p in a.udp.peers.values():
                p.last_seen -= 10_000
        a.udp._expire_peers()
        assert a.udp.fresh_peers() == []
    finally:
        a.stop()
        b.stop()
        tracker.stop()


def test_dead_peer_partial_results(tmp_path):
    """Fault injection: a peer that never answers. The searcher must
    return its local hits at the deadline — silent partial results are
    the failure model (SURVEY.md par.5, udp_service.rs:332-341)."""
    tracker = Tracker("127.0.0.1:0").start()
    a = DawnNode(node_cfg(tmp_path, "a", tracker.port,
                          search_deadline_ms=250.0),
                 encoder=HashEncoder()).start()
    b = DawnNode(node_cfg(tmp_path, "b", tracker.port),
                 encoder=HashEncoder()).start()
    try:
        assert wait_until(lambda: a.udp.fresh_peers())
        a.service.insert_pages([("https://a/1", "Local hit", "text")],
                               from_network=True)
        # kill b's receiver so Search datagrams vanish into the void
        b.udp._stop.set()
        time.sleep(0.3)
        t0 = time.time()
        res = a.service.text_search("Local hit\ntext")
        elapsed = time.time() - t0
        assert res.pages and res.pages[0].url == "https://a/1"
        assert res.instances_contacted == 2  # b was asked, never answered
        assert 0.2 <= elapsed < 2.0  # waited the deadline, not forever
    finally:
        a.stop()
        b.stop()
        tracker.stop()


def test_tracker_down_node_survives(tmp_path):
    """Announce to a dead tracker fails silently; local serving works."""
    cfg = node_cfg(tmp_path, "solo", tracker_port=1)  # nothing listens
    node = DawnNode(cfg, encoder=HashEncoder()).start()
    try:
        node.udp.announce_now()  # must not raise
        node.service.insert_pages([("https://s/1", "T", "x")])
        res = node.service.text_search("T\nx")
        assert res.pages[0].url == "https://s/1"
        assert node.udp.fresh_peers() == []
    finally:
        node.stop()


def test_corrupt_snapshot_recovers(tmp_path):
    """Fault injection: truncate index.dawn.npz; provider rebuilds from
    SQLite (search_provider.rs:111-153 recovery semantics)."""
    import os
    from dawnsearch_tpu_torch.index.provider import INDEX_FILE
    cfg = node_cfg(tmp_path, "c", tracker_port=1)
    cfg.udp = False
    with DawnNode(cfg, encoder=HashEncoder()) as node:
        node.service.insert_pages([("https://c/1", "Keep", "me")])
    snap = os.path.join(cfg.data_dir, INDEX_FILE)
    with open(snap, "wb") as f:
        f.write(b"\x00garbage")
    with DawnNode(cfg, encoder=HashEncoder()) as node2:
        res = node2.service.text_search("Keep\nme", search_remote=False)
        assert res.pages[0].url == "https://c/1"


def test_tracker_chunks_large_peer_sets(tmp_path):
    """>25 fresh peers split across multiple Peers packets
    (dawntrack.rs:93-109); a node merges all chunks."""
    import socket as socket_mod

    from dawnsearch_tpu_torch.net import packets
    from dawnsearch_tpu_torch.net.packets import Announce, Peers

    tracker = Tracker("127.0.0.1:0").start()
    try:
        # register 60 fake peers straight at the tracker socket
        socks = []
        for i in range(60):
            s = socket_mod.socket(socket_mod.AF_INET, socket_mod.SOCK_DGRAM)
            s.bind(("127.0.0.1", 0))
            s.sendto(packets.encode(Announce(f"peer{i:012d}", False, i)),
                     ("127.0.0.1", tracker.port))
            socks.append(s)
        assert wait_until(lambda: len(tracker.peers) == 60)
        # the 61st announcer should get 60 peers back in 3 chunks
        probe = socket_mod.socket(socket_mod.AF_INET, socket_mod.SOCK_DGRAM)
        probe.bind(("127.0.0.1", 0))
        probe.settimeout(2.0)
        probe.sendto(packets.encode(Announce("probe" + "x" * 11, False, 0)),
                     ("127.0.0.1", tracker.port))
        got: set[str] = set()
        chunks = 0
        while len(got) < 60:
            data, _ = probe.recvfrom(65536)
            pkt = packets.decode(data)
            assert isinstance(pkt, Peers) and len(pkt.peers) <= 25
            got.update(p.instance_id for p in pkt.peers)
            chunks += 1
        assert chunks == 3 and len(got) == 60
        assert "probe" + "x" * 11 not in got  # never your own entry
        for s in socks + [probe]:
            s.close()
    finally:
        tracker.stop()


def test_reference_wire_swarm(tmp_path):
    # Full two-node + tracker flow over the rmp-serde-compatible wire
    # format (wire_format="reference"): rendezvous, fan-out search,
    # smaz-compressed insert replication — the byte layout a reference
    # node speaks (udp_packets.rs:27-104).
    tracker = Tracker("127.0.0.1:0", wire_format="reference").start()
    a = DawnNode(node_cfg(tmp_path, "a", tracker.port,
                          wire_format="reference"),
                 encoder=HashEncoder()).start()
    b = DawnNode(node_cfg(tmp_path, "b", tracker.port,
                          wire_format="reference"),
                 encoder=HashEncoder()).start()
    try:
        assert wait_until(lambda: a.udp.fresh_peers() and b.udp.fresh_peers())
        a.service.insert_pages(
            [(f"https://ref.example/{i}", f"Title {i}", f"text {i}")
             for i in range(3)])
        # replication (Insert packets are per-field smaz in this format)
        assert wait_until(lambda: len(b.provider.store) == 3)
        res = b.service.text_search("Title 1\ntext 1")
        assert res.pages and res.pages[0].url == "https://ref.example/1"
    finally:
        a.stop()
        b.stop()
        tracker.stop()


def test_mixed_wire_swarm(tmp_path):
    # decode() sniffs both frames, so a dawn-format node and a
    # reference-format node interoperate through one tracker.
    tracker = Tracker("127.0.0.1:0").start()
    a = DawnNode(node_cfg(tmp_path, "a", tracker.port,
                          wire_format="reference", accept_insert=False),
                 encoder=HashEncoder()).start()
    b = DawnNode(node_cfg(tmp_path, "b", tracker.port,
                          wire_format="dawn", accept_insert=False),
                 encoder=HashEncoder()).start()
    try:
        assert wait_until(lambda: a.udp.fresh_peers() and b.udp.fresh_peers())
        a.service.insert_pages([("https://mix.example/x", "Mixed", "wire")])
        wait_until(
            lambda: any(p.pages_indexed == 1 for p in b.udp.fresh_peers()))
        res = b.service.text_search("Mixed\nwire")
        assert res.pages and res.pages[0].url == "https://mix.example/x"
        assert res.pages[0].instance_id == a.instance_id
    finally:
        a.stop()
        b.stop()
        tracker.stop()


def test_i8_wire_embedding_swarm(tmp_path):
    # A wire_embedding="i8" node (420 B Search frames) fans out to a
    # default i24 node and gets its remote hits back: decode() keys on
    # the field, so mixed i8/i24 dawn swarms just work.
    tracker = Tracker("127.0.0.1:0").start()
    a = DawnNode(node_cfg(tmp_path, "a", tracker.port, accept_insert=False),
                 encoder=HashEncoder()).start()
    b = DawnNode(node_cfg(tmp_path, "b", tracker.port, accept_insert=False,
                          wire_embedding="i8"),
                 encoder=HashEncoder()).start()
    try:
        assert wait_until(lambda: a.udp.fresh_peers() and b.udp.fresh_peers())
        a.service.insert_pages([("https://q.example/x", "Quantized", "wire")])
        wait_until(
            lambda: any(p.pages_indexed == 1 for p in b.udp.fresh_peers()))
        res = b.service.text_search("Quantized\nwire")  # b queries with i8
        assert res.pages and res.pages[0].url == "https://q.example/x"
        assert res.pages[0].instance_id == a.instance_id
        # and the remote more-like path exercises the i8 Embedding reply
        res2 = a.service.text_search("Quantized\nwire")  # a queries with i24
        assert res2.pages and res2.pages[0].instance_id == a.instance_id
    finally:
        a.stop()
        b.stop()
        tracker.stop()


@pytest.mark.parametrize("wire", ["dawn", "reference"])
def test_raw_udp_client_example(tmp_path, wire):
    """examples/search_udp.py (the search_udp.rs twin): a raw client
    datagram — in either wire format — gets Page replies from a live
    node, sorted by distance."""
    import sys

    sys.path.insert(0, "examples")
    try:
        from search_udp import search_once
    finally:
        sys.path.pop(0)

    tracker = Tracker("127.0.0.1:0").start()
    enc = HashEncoder()
    node = DawnNode(node_cfg(tmp_path, "solo", tracker.port),
                    encoder=enc).start()
    try:
        node.service.insert_pages(
            [(f"https://u.com/{i}", f"T{i}", f"page body {i}")
             for i in range(8)])
        q = enc.encode(["T3. page body 3"])[0]
        hits = search_once(q, ("127.0.0.1", node.udp.port), wire=wire,
                           deadline=1.0)
        assert hits and hits[0].url == "https://u.com/3"
        ds = [p.distance for p in hits]
        assert ds == sorted(ds)
    finally:
        node.stop()
        tracker.stop()
