"""Adversarial robustness of the UDP surface (round-2 VERDICT item 7).

packets.decode must raise ValueError — never any other exception — on
arbitrary hostile bytes (truncations, mutations, type confusion, zlib
bombs), and the recv loop must survive a garbage flood and keep serving
(the reference trusts the network outright, udp_service.rs:159-174;
exceeding it is this repo's robustness pattern).
The port's copy of tests/test_packet_fuzz.py.
"""

import random
import socket
import time
import zlib

import msgpack
import numpy as np
import pytest
import torch

from dawnsearch_tpu_torch.net import packets
from dawnsearch_tpu_torch.net.packets import (
    Announce, Embedding, GetEmbedding, Insert, MAX_DATAGRAM,
    MAX_INSERT_BODY, Page, PeerInfo, Peers, Search, decode, encode)

torch.set_num_threads(2)


def unit(seed=0, dim=384):
    v = np.random.default_rng(seed).standard_normal(dim)
    return (v / np.linalg.norm(v)).astype(np.float32)


def sample_packets(wire):
    return [
        Search(7, 0.5, unit(1)),
        Page(7, 0.25, "http://x", "t", "body", "iid", 3),
        Insert("http://y", "title", "text " * 50),
        GetEmbedding(8, 44),
        Embedding(8, unit(2)),
        Announce("iid", True, 123),
        Peers([PeerInfo("a", "10.0.0.1:9000", True, 5, 1)]),
    ]


def assert_value_error_only(data: bytes):
    """decode(data) -> Packet or ValueError; anything else is a bug."""
    try:
        decode(data)
    except ValueError:
        pass


@pytest.mark.parametrize("wire", [packets.WIRE_DAWN, packets.WIRE_REFERENCE])
def test_truncations_never_crash(wire):
    for pkt in sample_packets(wire):
        data = encode(pkt, wire)
        for cut in range(0, len(data), max(1, len(data) // 37)):
            assert_value_error_only(data[:cut])
            assert_value_error_only(data[cut:])


@pytest.mark.parametrize("wire", [packets.WIRE_DAWN, packets.WIRE_REFERENCE])
def test_random_mutations_never_crash(wire):
    rng = random.Random(1234)
    for pkt in sample_packets(wire):
        data = bytearray(encode(pkt, wire))
        for _ in range(400):
            mutated = bytearray(data)
            for _ in range(rng.randint(1, 8)):
                mutated[rng.randrange(len(mutated))] = rng.randrange(256)
            assert_value_error_only(bytes(mutated))


def test_pure_garbage_never_crashes():
    rng = random.Random(99)
    for _ in range(500):
        n = rng.randint(0, 200)
        assert_value_error_only(bytes(rng.randrange(256) for _ in range(n)))


def test_oversized_datagram_rejected():
    with pytest.raises(ValueError, match="exceeds"):
        decode(b"\x00" * (MAX_DATAGRAM + 1))


def test_zlib_bomb_rejected():
    # ~1 KB frame inflating to 40 MB of text must hit the cap, not
    # allocate it
    bomb = zlib.compress(msgpack.packb(["u", "t", "A" * 40_000_000]), 9)
    frame = msgpack.packb([packets.INSERT, {"z": bomb}])
    with pytest.raises(ValueError):
        decode(frame)


def test_type_confusion_rejected():
    hostile = [
        # embedding as a string
        msgpack.packb([packets.SEARCH,
                       {"si": 1, "dl": None, "em": "not-bytes"}]),
        # string ids where ints belong
        msgpack.packb([packets.GET_EMBEDDING, {"si": "a", "pi": "b"}]),
        # Page with numeric url
        msgpack.packb([packets.PAGE,
                       {"si": 1, "di": 0.2, "ur": 5, "ti": "t",
                        "tx": "x", "ii": "i", "pi": 1}]),
        # Announce with non-bool accept_insert
        msgpack.packb([packets.ANNOUNCE,
                       {"ii": "x", "ai": "yes", "px": 1}]),
        # Peers entries with wrong arity/types
        msgpack.packb([packets.PEERS, {"ps": [[1, 2]]}]),
        # reference variant with non-array body
        msgpack.packb({"s": {"x": 1}}),
        # unknown reference variant
        msgpack.packb({"zz": []}),
        # wrong-length embedding bytes
        msgpack.packb([packets.SEARCH,
                       {"si": 1, "dl": None, "em": b"\x01\x02\x03"}]),
        # non-normalized embedding (reference rejects too, vector.rs:70)
        msgpack.packb([packets.SEARCH,
                       {"si": 1, "dl": None, "em": b"\x00" * 1152}]),
    ]
    for frame in hostile:
        with pytest.raises(ValueError):
            decode(frame)


def test_round_trip_survives_hardening():
    """The legit path still round-trips after all the bounds."""
    for wire in (packets.WIRE_DAWN, packets.WIRE_REFERENCE):
        for pkt in sample_packets(wire):
            out = decode(encode(pkt, wire))
            assert type(out) is type(pkt)


def test_recv_loop_survives_garbage_flood(tmp_path):
    """Blast a live node's UDP socket with hostile frames, then confirm
    it still answers a real search."""
    from tests.test_torch_p2p import (
        DawnNode, HashEncoder, Tracker, node_cfg, wait_until)

    tracker = Tracker("127.0.0.1:0").start()
    a = DawnNode(node_cfg(tmp_path, "a", tracker.port),
                 encoder=HashEncoder()).start()
    b = DawnNode(node_cfg(tmp_path, "b", tracker.port),
                 encoder=HashEncoder()).start()
    try:
        assert wait_until(lambda: a.udp.fresh_peers()
                          and b.udp.fresh_peers())
        b.service.insert_pages(
            [("http://known", "known title", "a page about lighthouses")])
        rng = random.Random(7)
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        target = ("127.0.0.1", b.udp.port)
        bomb = zlib.compress(msgpack.packb(["u", "t", "A" * 10_000_000]), 9)
        hostile = [
            msgpack.packb([packets.INSERT, {"z": bomb}]),
            msgpack.packb({"s": {"bad": 1}}),
            msgpack.packb([packets.SEARCH, {"si": "x"}]),
        ]
        for i in range(300):
            if i % 3 == 0:
                sock.sendto(hostile[(i // 3) % len(hostile)], target)
            else:
                n = rng.randint(1, 1400)
                sock.sendto(bytes(rng.randrange(256) for _ in range(n)),
                            target)
        # query IMMEDIATELY, inside the same 1 s rate window as the
        # flood (loopback shares 127.0.0.1 between attacker and peer):
        # malformed packets must not gate well-formed traffic, or an
        # off-path attacker spoofing a peer's address could evict it
        # with a trickle of garbage (round-3 review). 300 datagrams is
        # also far under RATE_LIMIT_PPS, so nothing here may drop.
        res = a.service.text_search("lighthouses", k=5)
        assert any(p.url == "http://known" for p in res.pages)
    finally:
        a.stop()
        b.stop()
        tracker.stop()


def test_hostile_peers_packet_cannot_poison_peer_table(tmp_path):
    """A forged Peers packet with unparseable/out-of-range addrs must
    not enter the peer table: a poisoned entry would raise
    ValueError/OverflowError out of parse_addr/sendto on every remote
    search and replication for PEER_EXPIRY_S (round-3 review)."""
    from tests.test_torch_p2p import (
        DawnNode, HashEncoder, Tracker, node_cfg, wait_until)

    tracker = Tracker("127.0.0.1:0").start()
    a = DawnNode(node_cfg(tmp_path, "a", tracker.port),
                 encoder=HashEncoder()).start()
    b = DawnNode(node_cfg(tmp_path, "b", tracker.port),
                 encoder=HashEncoder()).start()
    try:
        assert wait_until(lambda: a.udp.fresh_peers()
                          and b.udp.fresh_peers())
        b.service.insert_pages(
            [("http://known", "known title", "a page about lighthouses")])
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.sendto(encode(Peers([
            PeerInfo("evil1", "garbage", True, 5, 1),
            PeerInfo("evil2", "1.2.3.4:99999", True, 5, 1),
            PeerInfo("evil3", "1.2.3.4:-1", True, 5, 1),
        ]), packets.WIRE_DAWN), ("127.0.0.1", a.udp.port))
        time.sleep(0.3)  # let the recv loop process the forged packet
        ids = {p.instance_id for p in a.udp.fresh_peers()}
        assert not ids & {"evil1", "evil2", "evil3"}
        # remote search still works end-to-end (no crash on caller
        # threads, the legit peer still answers)
        res = a.service.text_search("lighthouses", k=5)
        assert any(p.url == "http://known" for p in res.pages)
        a.service.insert_pages([("http://new", "t", "more lighthouses")])
    finally:
        a.stop()
        b.stop()
        tracker.stop()


def test_summary_cache_sweep_is_bounded(tmp_path):
    """The responder's summary cache evicts oldest-first past its cap
    and pops expired entries from the front — never a full scan per
    packet (round-3 review: O(search_rate x 30 s) per inbound Search)."""
    from dawnsearch_tpu_torch.config import Config
    from dawnsearch_tpu_torch.net.udp_service import UdpService

    cfg = Config()
    cfg.udp_listen_address = "127.0.0.1:0"
    cfg.trackers = []
    svc = UdpService(cfg, "iid-test")
    try:
        now = time.monotonic()
        # one long-expired entry at the front, then a full cap of live
        # ones
        svc._summary_cache[0] = (now - 1.0, {1: 0.5})
        for sid in range(1, svc.SUMMARY_CACHE_MAX + 8):
            svc._summary_cache[sid] = (now + 30.0, {1: 0.5})
        svc._sweep_summary_cache()
        assert 0 not in svc._summary_cache          # expired: popped
        assert len(svc._summary_cache) <= svc.SUMMARY_CACHE_MAX
        # oldest live entries were evicted to meet the cap, newest kept
        assert svc.SUMMARY_CACHE_MAX + 7 in svc._summary_cache
    finally:
        svc._sock.close()


def test_nonfinite_distances_rejected():
    """NaN/Inf distances must not reach the merge: NaN comparisons are
    all False, so sorted() would let a hostile peer's entries occupy
    top-k slots ahead of genuinely closer hits (round-3 review)."""
    import math

    from dawnsearch_tpu_torch.net.packets import Summary

    nan = float("nan")
    for wire in (packets.WIRE_DAWN,):
        for bad in (
            Search(7, nan, unit(1)),
            Page(7, nan, "http://x", "t", "b", "iid", 3),
            Page(7, math.inf, "http://x", "t", "b", "iid", 3),
            Summary(7, "iid", [1, 2], [0.1, nan]),
        ):
            with pytest.raises(ValueError):
                decode(encode(bad, wire))


def test_smaz_truncated_verbatim_run_raises():
    """A truncated verbatim run must raise, not silently decode short
    (a corrupted Insert would otherwise index a quietly-wrong page)."""
    from dawnsearch_tpu_torch.net import smaz

    with pytest.raises(ValueError, match="truncated"):
        smaz.decompress(b"\xff\x05ab")
    # healthy run still round-trips
    assert smaz.decompress(smaz.compress(b"\x00\x01binary!")) == \
        b"\x00\x01binary!"
