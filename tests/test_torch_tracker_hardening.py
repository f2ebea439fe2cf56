"""Tracker hardening (round-4 VERDICT item 5): the tracker was the one
guard-free network surface left after round 3 hardened the node side
(udp_service.py flood guard / decode bounds / poisoning defenses).
Reference behavior being hardened: dawntrack.rs:65 (unbounded peer
map), dawntrack.rs:93-109 (uncapped ceil(N/25)-packet replies to an
unauthenticated, spoofable source address).

These tests drive Tracker._handle directly with a recording socket so
egress is counted exactly, plus one real-socket flood smoke test.
The port's copy of tests/test_tracker_hardening.py.
"""

from __future__ import annotations

import socket
import time

import torch

from dawnsearch_tpu_torch.net import packets
from dawnsearch_tpu_torch.net.packets import Announce, PeerInfo, Peers
from dawnsearch_tpu_torch.net.tracker import (
    ENDPOINT_ANNOUNCES_PER_WINDOW, PEERS_PER_PACKET, Tracker)

torch.set_num_threads(2)


class _RecordingSock:
    """Counts (payload, dest) pairs instead of touching the network."""

    def __init__(self):
        self.sent: list[tuple[bytes, tuple]] = []

    def sendto(self, data: bytes, dest) -> None:
        self.sent.append((data, dest))


def _tracker(**kw) -> tuple[Tracker, _RecordingSock]:
    t = Tracker("127.0.0.1:0", **kw)
    rec = _RecordingSock()
    t._sock.close()  # never started; replace with the recorder
    t._sock = rec
    return t, rec


def _announce(iid: str, pages: int = 0) -> bytes:
    return packets.encode(Announce(iid, False, pages))


def test_one_endpoint_flood_is_rate_capped():
    """10k spoofed instance_ids from ONE source endpoint: processing
    and egress are bounded by the per-endpoint window, not by attacker
    send rate (memory stays far under the map bound too)."""
    t, rec = _tracker()
    src = ("9.9.9.9", 4444)
    for i in range(10_000):
        t._handle(_announce(f"spoof{i:011d}"), src)
    # only the window budget was processed...
    assert len(t.peers) <= ENDPOINT_ANNOUNCES_PER_WINDOW
    # ...and egress toward the (spoofable) source is bounded: <= 4
    # reply packets per processed announce
    assert len(rec.sent) <= ENDPOINT_ANNOUNCES_PER_WINDOW * 4
    assert all(dest == src for _, dest in rec.sent)


def test_peer_map_bound_keeps_live_peers():
    """At capacity, a flood of NEW ids from many spoofed IPs cannot
    evict fresh peers or grow the map (first-come-first-served)."""
    t, _ = _tracker(max_peers=50)
    for i in range(200):
        t._handle(_announce(f"peer{i:012d}"), (f"10.1.{i // 250}.{i % 250}", 7))
    assert len(t.peers) == 50
    # the first 50 (the "live swarm") are exactly the survivors
    assert set(t.peers) == {f"peer{i:012d}" for i in range(50)}
    # a RE-announce from a recorded peer still updates in place
    t._handle(_announce("peer" + "0" * 9 + "007", pages=99),
              ("10.9.9.9", 7))
    assert len(t.peers) == 50
    assert t.peers["peer" + "0" * 9 + "007"].pages_indexed == 99


def test_stale_entry_evicted_for_newcomer():
    """A full map still admits newcomers by evicting entries that are
    no longer advertisable (older than fresh_s) — bounded memory
    without freezing membership."""
    t, _ = _tracker(max_peers=3, fresh_s=600)
    now = int(time.time())
    for i in range(3):
        t._handle(_announce(f"old{i:013d}"), (f"10.2.0.{i}", 7))
    t.peers["old" + "0" * 12 + "1"] = PeerInfo(
        "old" + "0" * 12 + "1", "10.2.0.1:7", False, 0,
        last_seen=now - 700)  # stale: past fresh_s
    t._handle(_announce("new" + "x" * 13), ("10.2.1.0", 7))
    assert len(t.peers) == 3
    assert "new" + "x" * 13 in t.peers
    assert "old" + "0" * 12 + "1" not in t.peers


def test_reply_fanout_is_capped_and_sampled():
    """One announce never triggers more than max_reply_peers peers /
    4 packets of reply, however large the swarm (the reference sends
    ceil(N/25) packets — an amplification vector); the capped reply is
    a random sample so repeated announces mix the swarm."""
    t, rec = _tracker(max_reply_peers=100)
    now = int(time.time())
    for i in range(300):
        t.peers[f"swarm{i:011d}"] = PeerInfo(
            f"swarm{i:011d}", f"10.3.{i // 250}.{i % 250}:7", False, i,
            last_seen=now)
    t._handle(_announce("querier" + "q" * 9), ("10.4.0.1", 7))
    assert len(rec.sent) == 4  # 100 peers / 25 per packet
    got = set()
    for data, _ in rec.sent:
        pkt = packets.decode(data)
        assert isinstance(pkt, Peers) and len(pkt.peers) <= PEERS_PER_PACKET
        got.update(p.instance_id for p in pkt.peers)
    assert len(got) == 100
    # sampled: two announces from different endpoints won't always see
    # the same 100 of 300 (probability of identical samples ~ 0)
    rec.sent.clear()
    t._handle(_announce("querier" + "r" * 9), ("10.4.0.2", 7))
    got2 = {p.instance_id for data, _ in rec.sent
            for p in packets.decode(data).peers}
    assert len(got2) == 100 and got2 != got


def test_window_map_bounded_under_spoofed_sources():
    """The rate-window bookkeeping itself cannot be ballooned by
    spraying spoofed source addresses."""
    t, _ = _tracker(max_peers=10)
    for i in range(20_000):
        t._handle(_announce(f"w{i:015d}"),
                  (f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}",
                   i % 60_000))
    assert len(t._src_windows) <= 2 * 8192 + 2  # pruned at the bound
    assert len(t.peers) == 10


def _settled(read, timeout: float = 30.0) -> int:
    """read() once it has stopped changing for 0.3 s."""
    deadline = time.monotonic() + timeout
    last, since = read(), time.monotonic()
    while time.monotonic() < deadline:
        time.sleep(0.02)
        now = read()
        if now != last:
            last, since = now, time.monotonic()
        elif time.monotonic() - since >= 0.3:
            break
    return last


def test_real_socket_flood_smoke(monkeypatch):
    """End-to-end over a real socket: a one-endpoint spoofed-id flood
    gets bounded replies, and the tracker still serves a legitimate
    announcer afterwards.

    The bounds hold per rate window, so the check must not depend on how
    a loaded host schedules the flood: the tracker's monotonic clock is
    held still, so every flood datagram falls in one window, and the flood
    is paced against the tracker's own per-window counts (each burst is
    sent once the tracker has counted the last), so the kernel drops none
    of it. The legitimate announcer sends from another loopback address,
    as a real peer would: the flood spends 127.0.0.1's per-ip budget,
    which is part of the hardening, not a fault."""
    import types

    from dawnsearch_tpu_torch.net import tracker as tracker_mod

    t0 = time.monotonic()
    monkeypatch.setattr(tracker_mod, "time", types.SimpleNamespace(
        monotonic=lambda: t0, time=time.time, sleep=time.sleep))
    tracker = Tracker("127.0.0.1:0").start()
    try:
        flood = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        flood.bind(("127.0.0.1", 0))
        flood.setblocking(False)
        src = flood.getsockname()

        def counted() -> int:
            w = tracker._src_windows.get(src)
            return 0 if w is None else w.count

        replies = 0

        def drain() -> None:
            nonlocal replies
            while True:
                try:
                    flood.recvfrom(65536)
                except BlockingIOError:
                    return
                replies += 1

        sent = 0
        for burst in range(40):
            for _ in range(50):
                flood.sendto(_announce(f"flood{sent:011d}"),
                             ("127.0.0.1", tracker.port))
                sent += 1
            deadline = time.monotonic() + 30.0
            while counted() < sent and time.monotonic() < deadline:
                drain()
                time.sleep(0.002)
        assert _settled(counted) == sent == 2000  # one window saw them all
        time.sleep(0.3)
        drain()
        assert 0 < replies <= ENDPOINT_ANNOUNCES_PER_WINDOW * 4
        assert len(tracker.peers) == ENDPOINT_ANNOUNCES_PER_WINDOW

        legit = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        legit.bind(("127.0.0.2", 0))
        legit.settimeout(5.0)
        legit.sendto(_announce("legit" + "l" * 11), ("127.0.0.1", tracker.port))
        data, _ = legit.recvfrom(65536)
        assert isinstance(packets.decode(data), Peers)
        assert "legit" + "l" * 11 in tracker.peers
        flood.close()
        legit.close()
    finally:
        tracker.stop()
