"""The port's P2P wire and swarm held against the reference's.

- Packets: every packet type, in both wire formats ("dawn" and the
  reference's rmp-serde layout) and both wire embeddings (i24, i8),
  encodes to the same bytes in both packages, and each package decodes
  the other's bytes to the same packet. The two-phase packets (Summary,
  PageRequest) have no reference layout: both packages refuse them there.
- A mixed swarm over loopback UDP: one tracker, one reference DawnNode
  and one port DawnNode (HashEncoder embeddings), on the dawn wire and on
  the reference wire. Each node's text search returns the other node's
  page at rank 1, and an insert on either node replicates to the other.
"""

import dataclasses
import hashlib
import time

import numpy as np
import pytest
import torch

from dawnsearch_tpu.config import Config as RefConfig
from dawnsearch_tpu.net import packets as ref_packets
from dawnsearch_tpu.node import DawnNode as RefNode
from dawnsearch_tpu_torch.config import Config
from dawnsearch_tpu_torch.net import packets
from dawnsearch_tpu_torch.net.tracker import Tracker
from dawnsearch_tpu_torch.node import DawnNode

torch.set_num_threads(2)


def _unit(rng: np.random.Generator) -> np.ndarray:
    v = rng.standard_normal(384).astype(np.float32)
    return v / np.linalg.norm(v)


def _packets(mod, seed: int) -> list:
    """One of each packet type of package `mod`, from a seeded generator
    (the same values for both packages)."""
    rng = np.random.default_rng(seed)
    emb = _unit(rng)
    text = " ".join(rng.choice(["sea", "light", "the", "ünïcode", "of",
                                "keeper", "storm"], 60))
    peers = [mod.PeerInfo(f"peer{i:012d}", f"10.0.0.{i}:{7000 + i}",
                          bool(i % 2), int(rng.integers(0, 1 << 40)),
                          last_seen=int(rng.integers(0, 1 << 31)))
             for i in range(3)]
    sid = int(rng.integers(0, 1 << 63))
    return [
        mod.Search(sid, None, emb),
        mod.Search(sid, float(rng.random()), emb, two_phase=True),
        mod.Page(sid, float(rng.random()), "https://a.example/x", "Title",
                 text[:300], "instance00000000", 42),
        mod.Insert("https://a.example/y", "A title", text),
        mod.GetEmbedding(sid, 7),
        mod.Embedding(sid, emb),
        mod.Announce("instance00000001", True, 123456),
        mod.Peers(peers),
        mod.Peers([]),
        mod.Summary(sid, "instance00000002", [1, 5, 9],
                    [0.1, 0.25, float(rng.random())]),
        mod.PageRequest(sid, [5, 9]),
    ]


def _same(a, b) -> None:
    assert type(a).__name__ == type(b).__name__
    for fa, fb in zip(dataclasses.astuple(a), dataclasses.astuple(b)):
        if isinstance(fa, np.ndarray):
            np.testing.assert_array_equal(fa, fb)
        elif isinstance(fa, list):
            assert [dataclasses.astuple(x) if dataclasses.is_dataclass(x)
                    else x for x in fa] == \
                [dataclasses.astuple(x) if dataclasses.is_dataclass(x)
                 else x for x in fb]
        else:
            assert fa == fb


@pytest.mark.parametrize("wire_embedding", ["i24", "i8"])
@pytest.mark.parametrize("wire", ["dawn", "reference"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_every_packet_encodes_to_the_references_bytes(wire, wire_embedding,
                                                      seed):
    for mine, theirs in zip(_packets(packets, seed),
                            _packets(ref_packets, seed)):
        if wire == "reference" and type(mine).__name__ in ("Summary",
                                                           "PageRequest"):
            for mod, p in ((packets, mine), (ref_packets, theirs)):
                with pytest.raises(ValueError, match="no reference wire"):
                    mod.encode(p, wire, wire_embedding)
            continue
        got = packets.encode(mine, wire, wire_embedding)
        want = ref_packets.encode(theirs, wire, wire_embedding)
        assert got == want, type(mine).__name__
        # each decodes the other's bytes to the same packet
        _same(packets.decode(want), ref_packets.decode(got))
        _same(packets.decode(want), packets.decode(got))


def test_clipped_packets_match_the_reference():
    rng = np.random.default_rng(3)
    text = " ".join(rng.choice(["lighthouse", "ünïcode", "sea", "of"], 2000))
    for wire in ("dawn", "reference"):
        a = packets.clip_insert("https://c.example/", "T", text,
                                wire_format=wire)
        b = ref_packets.clip_insert("https://c.example/", "T", text,
                                    wire_format=wire)
        assert packets.encode(a, wire) == ref_packets.encode(b, wire)
    assert packets.clip_page_text("u", "t", text) == \
        ref_packets.clip_page_text("u", "t", text)


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


def _cfg(cls, tmp_path, name, tracker_port, **kw):
    cfg = cls(data_dir=str(tmp_path / name), udp=True,
              udp_listen_address="127.0.0.1:0",
              trackers=[f"127.0.0.1:{tracker_port}"], announce_interval_s=0.15,
              search_deadline_ms=500.0, **kw)
    return cfg


def _wait(pred, timeout=10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


@pytest.fixture(params=["dawn", "reference"])
def mixed(request, tmp_path):
    """A tracker, a reference node and a port node on one wire."""
    def make(accept_insert: bool):
        wire = request.param
        tracker = Tracker("127.0.0.1:0", wire_format=wire).start()
        ref = RefNode(_cfg(RefConfig, tmp_path, "ref", tracker.port,
                           wire_format=wire, accept_insert=accept_insert),
                      encoder=HashEncoder()).start()
        port = DawnNode(_cfg(Config, tmp_path, "port", tracker.port,
                             device="cpu", wire_format=wire,
                             accept_insert=accept_insert),
                        encoder=HashEncoder()).start()
        made.append((tracker, ref, port))
        assert _wait(lambda: ref.udp.fresh_peers() and port.udp.fresh_peers())
        return ref, port

    made = []
    yield make
    for tracker, ref, port in made:
        ref.stop()
        port.stop()
        tracker.stop()


def test_mixed_swarm_finds_each_others_pages(mixed):
    ref, port = mixed(accept_insert=False)
    ref.service.insert_pages([("https://ref.example/1", "Reference page",
                               "held by the reference node")])
    port.service.insert_pages([("https://port.example/1", "Port page",
                                "held by the port node")])
    assert _wait(lambda: any(p.pages_indexed == 1
                             for p in port.udp.fresh_peers()))
    assert _wait(lambda: any(p.pages_indexed == 1
                             for p in ref.udp.fresh_peers()))
    for searcher, owner, q, url in (
            (port, ref, "Reference page\nheld by the reference node",
             "https://ref.example/1"),
            (ref, port, "Port page\nheld by the port node",
             "https://port.example/1")):
        res = searcher.service.text_search(q)
        assert res.pages and res.pages[0].url == url
        assert res.pages[0].instance_id == owner.instance_id
        assert res.instances_contacted == 2
    assert len(ref.provider.store) == len(port.provider.store) == 1


def test_mixed_swarm_replicates_inserts_both_ways(mixed):
    ref, port = mixed(accept_insert=True)
    ref.service.insert_pages([("https://ref.example/r", "From the reference",
                               "replicated body one")])
    assert _wait(lambda: len(port.provider.store) == 1)
    port.service.insert_pages([("https://port.example/r", "From the port",
                                "replicated body two")])
    assert _wait(lambda: len(ref.provider.store) == 2)
    for node in (ref, port):
        for q, url in (("From the reference\nreplicated body one",
                        "https://ref.example/r"),
                       ("From the port\nreplicated body two",
                        "https://port.example/r")):
            res = node.service.text_search(q, search_remote=False)
            assert res.pages[0].url == url
    time.sleep(0.3)  # network inserts do not echo back
    assert len(ref.provider.store) == len(port.provider.store) == 2
