"""Tracker: UDP rendezvous server for open-network membership.

Rebuild of the reference's `dawntrack` binary
(the reference's src/bin/dawntrack.rs:31-116): keeps an in-memory peer
map; on Announce records the peer's source address + last_seen
(dawntrack.rs:71-92), rewrites a loopback source to the configured
external address so a tracker co-hosted with a node advertises a
reachable addr (dawntrack.rs:77-82), and replies with *other* peers
seen in the last 10 minutes, chunked 25 per packet
(dawntrack.rs:93-109). All other packet types are ignored
(dawntrack.rs:111).

Hardening beyond the reference (the reference trusts the network; the
node side got the same treatment in net/udp_service.py):

- Two-level per-source announce rate cap (sliding ANNOUNCE_WINDOW_S
  windows, checked before decode). Fine level, per (ip, port):
  Announce sources are unauthenticated and spoofable, and replies go
  to the exact source address — this cap bounds the reflection
  bandwidth any single victim endpoint can be made to receive. Coarse
  level, per ip, much higher: bounds decode/handle CPU per real
  source while leaving room for many NAT'd nodes (and test swarms)
  sharing one address. Legitimate cadence is one announce per 60 s
  (udp_service.rs ANNOUNCE_INTERVAL).
- Bounded peer map (max_peers). At capacity a NEW instance_id evicts
  the stalest entry only if that entry is no longer advertisable
  (older than fresh_s); a map full of FRESH peers refuses newcomers
  instead — first-come-first-served means a spoofed-id flood cannot
  evict live peers, and memory is bounded either way (the reference
  grows without bound, dawntrack.rs:65).
- Capped reply fan-out (max_reply_peers, default 100 = 4 packets).
  The reference answers one announce with ceil(N/25) packets to an
  unauthenticated address — an amplification vector. The capped reply
  samples RANDOM fresh peers so a large swarm still mixes across
  repeated announces.

Flood behavior is pinned by tests/test_torch_tracker_hardening.py (10k
spoofed instance_ids: bounded memory, bounded egress, live peers kept).
Port of dawnsearch_tpu/net/tracker.py; `python -m dawnsearch_tpu_torch
track` runs it.
"""

from __future__ import annotations

import random
import socket
import threading
import time

from dawnsearch_tpu_torch.net import packets
from dawnsearch_tpu_torch.net.packets import Announce, PeerInfo, Peers
from dawnsearch_tpu_torch.utils.logging import METRICS, service_logger

log = service_logger("Tracker")

PEER_FRESH_S = 600.0  # advertise peers seen in the last 10 min (dawntrack.rs:95)
PEERS_PER_PACKET = 25  # dawntrack.rs:99-109
MAX_PEERS = 4096  # peer-map bound (~0.5 MB; the reference is unbounded)
MAX_REPLY_PEERS = 100  # reply fan-out cap: 4 packets per announce
ANNOUNCE_WINDOW_S = 10.0  # sliding rate window for both cap levels
# per (ip, port): bounds reflection toward one spoofed victim endpoint
# to <= 12 replies/s (each <= 4 packets); 80x the legit 1-per-60s
# cadence, so only abuse hits it
ENDPOINT_ANNOUNCES_PER_WINDOW = 120
# per ip: bounds decode/handle CPU per real source; generous enough
# for hundreds of NAT'd nodes behind one address
IP_ANNOUNCES_PER_WINDOW = 2000


def parse_addr(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host or "0.0.0.0", int(port)


class _SrcWindow:
    __slots__ = ("start", "count")

    def __init__(self, now: float):
        self.start = now
        self.count = 0


class Tracker:
    def __init__(self, listen: str = "0.0.0.0:7230",
                 external_address: str | None = None,
                 fresh_s: float = PEER_FRESH_S,
                 wire_format: str = packets.WIRE_DAWN,
                 max_peers: int = MAX_PEERS,
                 max_reply_peers: int = MAX_REPLY_PEERS):
        self.listen = listen
        self.external_address = external_address
        self.wire = wire_format
        self.fresh_s = fresh_s
        self.max_peers = max_peers
        self.max_reply_peers = max_reply_peers
        self.peers: dict[str, PeerInfo] = {}  # instance_id -> info
        self._lock = threading.Lock()
        self._src_windows: dict[str, _SrcWindow] = {}
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(parse_addr(listen))
        self._sock.settimeout(0.25)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def _window_ok(self, key, now: float, budget: int) -> bool:
        w = self._src_windows.get(key)
        if w is None or now - w.start >= ANNOUNCE_WINDOW_S:
            if len(self._src_windows) > 8192:  # spoofed-src flood
                self._src_windows.clear()
            w = self._src_windows[key] = _SrcWindow(now)
        w.count += 1
        return w.count <= budget

    def _rate_ok(self, src: tuple[str, int], now: float) -> bool:
        """Two-level sliding-window cap, checked BEFORE decode (same
        discipline as udp_service._rate_ok: monotonic clock; window map
        bounded even under spoofed-src floods). Both levels are
        counted, so a port-spraying source pays the coarse ip budget
        no matter how it spreads the fine one."""
        ep_ok = self._window_ok(src, now, ENDPOINT_ANNOUNCES_PER_WINDOW)
        ip_ok = self._window_ok(src[0], now, IP_ANNOUNCES_PER_WINDOW)
        return ep_ok and ip_ok

    def _upsert(self, pkt: Announce, info: PeerInfo, now: int) -> bool:
        """Record the announce under the map bound; True if recorded.
        Caller holds the lock."""
        if pkt.instance_id in self.peers or len(self.peers) < self.max_peers:
            self.peers[pkt.instance_id] = info
            return True
        # at capacity: evict the stalest entry only if it's already
        # unadvertisable — live peers are never evicted by newcomers
        stalest = min(self.peers, key=lambda i: self.peers[i].last_seen)
        if now - self.peers[stalest].last_seen >= self.fresh_s:
            del self.peers[stalest]
            self.peers[pkt.instance_id] = info
            return True
        METRICS.inc("tracker_announce_refused", 1)
        return False

    def _handle(self, data: bytes, src: tuple[str, int]) -> None:
        if not self._rate_ok(src, time.monotonic()):
            METRICS.inc("tracker_rate_dropped", 1)
            return
        try:
            pkt = packets.decode(data)
        except Exception:
            log.debug("undecodable %d B from %s", len(data), src)
            return
        if not isinstance(pkt, Announce):
            return  # dawntrack.rs:111
        host, port = src
        if host in ("127.0.0.1", "::1") and self.external_address:
            host = self.external_address  # dawntrack.rs:77-82
        now = int(time.time())
        info = PeerInfo(pkt.instance_id, f"{host}:{port}",
                        pkt.accept_insert, pkt.pages_indexed, last_seen=now)
        with self._lock:
            recorded = self._upsert(pkt, info, now)
            # prune stale entries while already scanning (the reference
            # only FILTERS at reply time, dawntrack.rs:95)
            stale = [iid for iid, p in self.peers.items()
                     if now - p.last_seen >= 2 * self.fresh_s]
            for iid in stale:
                del self.peers[iid]
            fresh = [p for iid, p in self.peers.items()
                     if iid != pkt.instance_id
                     and now - p.last_seen < self.fresh_s]
        if len(fresh) > self.max_reply_peers:
            # random sample under the fan-out cap: bounded amplification,
            # and repeated announces still see the whole swarm over time
            fresh = random.sample(fresh, self.max_reply_peers)
        log.debug("announce %s @%s (%d pages, recorded=%s); %d peers in reply",
                  pkt.instance_id, info.addr, pkt.pages_indexed, recorded,
                  len(fresh))
        for i in range(0, len(fresh), PEERS_PER_PACKET):
            chunk = fresh[i: i + PEERS_PER_PACKET]
            self._sock.sendto(packets.encode(Peers(chunk), self.wire), src)
        if not fresh:  # always ack so nodes learn the tracker is alive
            self._sock.sendto(packets.encode(Peers([]), self.wire), src)

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                data, src = self._sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                self._handle(data, src)
            except Exception:
                log.exception("tracker handler failed")

    def start(self) -> "Tracker":
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="tracker")
        self._thread.start()
        log.info("tracker on %s", self.listen)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self._sock.close()

    def run_forever(self) -> None:
        """Serve until SIGINT or SIGTERM, then stop and return, so the
        process exits 0 (the reference stops on SIGINT alone; a SIGTERM
        from a service manager killed it)."""
        import signal

        done = threading.Event()

        def handler(signum, frame):
            log.info("signal %d — shutting down", signum)
            done.set()

        signal.signal(signal.SIGINT, handler)
        signal.signal(signal.SIGTERM, handler)
        self.start()
        done.wait()
        self.stop()
