"""UdpService: the P2P runtime — peer table, query fan-out, replication.

Rebuild of the reference's src/net/udp_service.rs (the reference's
distributed backend). Same semantics, threaded instead of a tokio
select loop:

- random 16-char instance id (udp_service.rs:150-154)
- outbound search: random u64 search id, quantize query to i24, send to
  ALL known peers, optimistically count their pages_indexed, collect
  Page replies until the fixed deadline — 200 ms default —
  then return whatever arrived (udp_service.rs:297-341); silent partial
  results are the failure model (SURVEY.md §5).
- inbound search: self-echo guard on own active ids
  (udp_service.rs:177-179), local-only search, one Page packet per hit
  under the sender's distance_limit (udp_service.rs:195-214).
- insert replication to 3 random accept-insert peers
  (udp_service.rs:376-394), applied only if we accept inserts.
- GetEmbedding/Embedding round-trip for remote more-like-this
  (udp_service.rs:254-283, 395-412).
- tracker announce every 60 s; peers unseen for 300 s expire
  (udp_service.rs:343-374).

The service implements the SearchService RemoteBackend protocol, so the
orchestrator is agnostic to whether peers exist. Port of
dawnsearch_tpu/net/udp_service.py: a peer's Search runs the node's
embedding_search, which on a card is the fused select kernel (K2, or K3
for an i4 index) over the node's own index.
"""

from __future__ import annotations

import random
import socket
import threading
import time

import numpy as np

from dawnsearch_tpu_torch.index.provider import FoundPage
from dawnsearch_tpu_torch.net import packets
from dawnsearch_tpu_torch.net.packets import (
    Announce, Embedding, GetEmbedding, Insert, Page, PageRequest, PeerInfo,
    Peers, Search, Summary, clip_insert, clip_page_text,
)
from dawnsearch_tpu_torch.net.tracker import parse_addr
from dawnsearch_tpu_torch.utils.logging import METRICS, service_logger

log = service_logger("Udp")

PEER_EXPIRY_S = 300.0  # udp_service.rs:343
ANNOUNCE_INTERVAL_S = 60.0  # dawnsearch.rs:122-128
INSERT_REPLICATION = 3  # udp_service.rs:389-390

# Per-source flood guard (the reference trusts the network,
# udp_service.rs:159-174; exceeding it is this repo's robustness
# pattern). Sliding 1 s window per source IP: beyond RATE_LIMIT_PPS
# datagrams (well-formed or not — the count is taken before decode),
# the rest of that window's traffic from the source is dropped and
# counted. The cap sits well above a node's own traffic (bulk ingest
# replicates thousands of Inserts/s to each acceptor from one source; a
# batch of remote searches returns k Page replies each). Malformed
# packets are counted for metrics but do NOT gate well-formed traffic
# from the same IP: source addresses are unauthenticated, so a
# malformed-based block would let an off-path attacker spoof a peer's
# address and evict it with a trickle of garbage (decode's fail-fast
# size/type checks make garbage cheap enough that the pps cap alone
# bounds the CPU).
RATE_LIMIT_PPS = 20_000


class _SrcWindow:
    __slots__ = ("start", "count")

    def __init__(self, now: float):
        self.start = now
        self.count = 0


class _ActiveSearch:
    __slots__ = ("pages", "summaries", "responded", "expected",
                 "contacted", "event", "lock")

    def __init__(self):
        self.pages: list[FoundPage] = []
        # two-phase: (instance_id, src_addr, page_id, distance) tuples
        self.summaries: list[tuple[str, tuple, int, float]] = []
        # iids that sent a Summary. Legacy peers (full Pages, no
        # Summary) deliberately never count toward the early wake: a
        # Page STREAM has no completion marker, so counting the first
        # Page would truncate that peer's remaining hits — mixed
        # swarms degrade to the reference's full-deadline collection
        # instead (the mixed-swarm cost of two_phase_search).
        self.responded: set[str] = set()
        # phase 2: the exact (instance_id, page_id) keys still awaited;
        # keyed (not a count) so a straggling phase-1 Page from a
        # legacy peer can't wake the searcher before the requested
        # winners arrive
        self.expected: set[tuple[str, int]] | None = None
        # phase 1: fan-out size; when every contacted peer has
        # summarized, phase 1 ends early instead of burning the deadline
        self.contacted: int = 0
        self.event = threading.Event()
        self.lock = threading.Lock()


class UdpService:
    def __init__(self, cfg, instance_id: str):
        self.cfg = cfg
        self.instance_id = instance_id
        self.deadline_s = cfg.search_deadline_ms / 1000.0
        self.wire = getattr(cfg, "wire_format", packets.WIRE_DAWN)
        self.wire_emb = getattr(cfg, "wire_embedding", "auto")
        if self.wire_emb not in ("auto", "i24", "i8"):
            raise ValueError(
                f"wire_embedding={self.wire_emb!r}: must be 'auto', "
                "'i24' or 'i8'")
        if self.wire_emb == "auto":
            # the measured win (2.8x query bytes at equal results) where
            # the format supports it; reference wire is fixed i24
            self.wire_emb = ("i8" if self.wire == packets.WIRE_DAWN
                             else "i24")
        if self.wire_emb == "i8" and self.wire == packets.WIRE_REFERENCE:
            # refuse silently-ignored config: the reference layout is
            # fixed i24 (vector.rs:48-87), there is nothing to honor
            raise ValueError(
                "wire_embedding='i8' requires wire_format='dawn' "
                "(the reference wire layout is i24-only)")
        self.trackers: list[tuple[str, int]] = [
            parse_addr(t) for t in cfg.trackers]
        self.peers: dict[str, PeerInfo] = {}  # instance_id -> info
        self._peers_lock = threading.Lock()
        self._active: dict[int, _ActiveSearch] = {}
        self._active_lock = threading.Lock()
        self._emb_waiters: dict[int, tuple[threading.Event, list]] = {}
        self._emb_lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(parse_addr(cfg.udp_listen_address))
        self._sock.settimeout(0.25)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._src_windows: dict[str, _SrcWindow] = {}
        # Two-phase search (config flag; dawn wire only — the reference
        # format has no Summary/PageRequest layout, udp_packets.rs:40-43)
        self.two_phase = (getattr(cfg, "two_phase_search", False)
                          and self.wire == packets.WIRE_DAWN)
        # responder-side: search_id -> (expiry_ts, {page_id: distance})
        # so a PageRequest can be answered with the distances the
        # Summary promised, without re-running the search
        self._summary_cache: dict[int, tuple[float, dict[int, float]]] = {}
        self._summary_lock = threading.Lock()
        self.service = None  # SearchService, attached after construction

    def attach(self, service) -> None:
        self.service = service

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "UdpService":
        for name, target in (("udp-recv", self._recv_loop),
                             ("udp-announce", self._announce_loop)):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)
        log.info("UDP on %s (trackers: %s)", self.cfg.udp_listen_address,
                 self.cfg.trackers or "none")
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        self._sock.close()

    # -- RemoteBackend protocol ----------------------------------------------

    def fresh_peers(self) -> list[PeerInfo]:
        now = time.time()
        with self._peers_lock:
            return [p for p in self.peers.values()
                    if now - p.last_seen < PEER_EXPIRY_S
                    and p.instance_id != self.instance_id]

    def search(self, embedding: np.ndarray, distance_limit: float | None,
               k: int) -> tuple[list[FoundPage], int, int]:
        peers = self.fresh_peers()
        if not peers:
            return [], 0, 0  # no deadline when alone (udp_service.rs:301-312)
        sid = random.getrandbits(63)
        st = _ActiveSearch()
        with self._active_lock:
            self._active[sid] = st
        pkt = packets.encode(
            Search(sid, distance_limit, embedding,
                   two_phase=self.two_phase), self.wire, self.wire_emb)
        estimated = 0
        reached = 0
        for p in peers:
            try:
                self._sock.sendto(pkt, parse_addr(p.addr))
                METRICS.inc("query_bytes", len(pkt))
                estimated += p.pages_indexed  # optimistic (udp_service.rs:320)
                reached += 1
            except (OSError, ValueError, OverflowError):
                log.debug("send to %s failed", p.addr)
        # phase-1 early-wake threshold = peers the send actually
        # REACHED (an unreachable peer must not force every search to
        # burn the whole deadline); set after the loop, so check once
        # for replies that raced ahead of it
        with st.lock:
            st.contacted = reached
            if reached and len(st.responded) >= reached:
                st.event.set()
        st.event.wait(self.deadline_s)  # phase 1: collect until deadline
        if self.two_phase:
            self._request_winning_pages(sid, st, k)
        with self._active_lock:
            st = self._active.pop(sid)
        with st.lock:
            pages = list(st.pages)
        METRICS.inc("remote_searches", 1)
        return pages, estimated, len(peers)

    def _request_winning_pages(self, sid: int, st: _ActiveSearch,
                               k: int) -> None:
        """Two-phase phase 2: merge the Summary distances globally, ask
        each responder only for its winners, and wait (early-waking) for
        the full Pages. Legacy peers that already sent full Pages
        participate in the merge for free."""
        with st.lock:
            summaries = list(st.summaries)
            have = {(p.instance_id, p.page_id) for p in st.pages}
        if not summaries:
            return
        ranked = sorted(summaries, key=lambda s: s[3])[:k]
        wanted: dict[tuple, tuple[str, list[int]]] = {}
        awaiting: set[tuple[str, int]] = set()
        for iid, src, pid, _d in ranked:
            if (iid, pid) in have:
                continue  # a legacy peer already sent the full page
            wanted.setdefault(src, (iid, []))[1].append(pid)
            awaiting.add((iid, pid))
        if not awaiting:
            return
        with st.lock:
            st.expected = awaiting  # keyed: stragglers can't satisfy it
            st.event.clear()
        unreachable: set[tuple[str, int]] = set()
        for src, (iid, pids) in wanted.items():
            # chunk at the wire cap so search_k > SUMMARY_MAX still
            # round-trips instead of tripping the peer's validator
            for c in range(0, len(pids), packets.SUMMARY_MAX):
                chunk = pids[c: c + packets.SUMMARY_MAX]
                try:
                    self._sock.sendto(packets.encode(
                        PageRequest(sid, chunk), self.wire), src)
                except OSError:
                    # a failed send can never be answered: shrink the
                    # awaited set so one dead responder between phases
                    # doesn't burn the whole second deadline for pages
                    # that already arrived
                    unreachable.update((iid, pid) for pid in chunk)
        if unreachable:
            with st.lock:
                if st.expected is not None:
                    st.expected -= unreachable
                    if not st.expected:
                        st.event.set()
        st.event.wait(self.deadline_s)  # phase 2, same silent-partial model

    def replicate(self, url: str, title: str, text: str) -> None:
        acceptors = [p for p in self.fresh_peers() if p.accept_insert]
        if not acceptors:
            return
        chosen = random.sample(acceptors,
                               min(INSERT_REPLICATION, len(acceptors)))
        pkt = packets.encode(
            clip_insert(url, title, text, wire_format=self.wire), self.wire)
        for p in chosen:
            try:
                self._sock.sendto(pkt, parse_addr(p.addr))
            except (OSError, ValueError, OverflowError):
                pass
        METRICS.inc("inserts_replicated", len(chosen))

    def fetch_embedding(self, instance_id: str, page_id: int
                        ) -> np.ndarray | None:
        with self._peers_lock:
            peer = self.peers.get(instance_id)
        if peer is None:
            return None
        sid = random.getrandbits(63)
        event, slot = threading.Event(), []
        with self._emb_lock:
            self._emb_waiters[sid] = (event, slot)
        try:
            try:
                self._sock.sendto(packets.encode(GetEmbedding(sid, page_id),
                                                 self.wire),
                                  parse_addr(peer.addr))
            except (OSError, ValueError, OverflowError):
                return None
            event.wait(self.deadline_s * 5)  # round-trip, not fan-out
            return slot[0] if slot else None
        finally:
            with self._emb_lock:
                self._emb_waiters.pop(sid, None)

    # -- inbound ------------------------------------------------------------

    def _rate_ok(self, ip: str, now: float) -> bool:
        """Sliding-window flood guard; True = keep processing this src.
        Windows are pruned opportunistically (bounded memory even under
        address-spoofed floods). `now` is time.monotonic(): a wall-clock
        step backwards must not freeze every window and blackhole
        legitimate peers. Malformed packets count here like any other
        datagram but carry no extra penalty (see RATE_LIMIT_PPS)."""
        w = self._src_windows.get(ip)
        if w is None or now - w.start >= 1.0:
            if len(self._src_windows) > 4096:  # spoofed-src flood
                self._src_windows.clear()
            w = self._src_windows[ip] = _SrcWindow(now)
        w.count += 1
        return w.count <= RATE_LIMIT_PPS

    def _recv_loop(self) -> None:
        """Survives arbitrary bytes: packets.decode raises ValueError on
        ANY hostile frame (size caps, type checks, zlib bounds —
        tests/test_packet_fuzz.py), malformed sources are rate-limited,
        and handler bugs are logged without killing the loop."""
        while not self._stop.is_set():
            try:
                data, src = self._sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            now = time.monotonic()
            if not self._rate_ok(src[0], now):
                METRICS.inc("packets_rate_dropped", 1)
                continue
            try:
                pkt = packets.decode(data)
            except ValueError as e:
                # hostile/garbage frame: count and debug-log (exception
                # spam at info+ would itself be a log-flood DoS)
                METRICS.inc("packets_malformed", 1)
                log.debug("malformed packet from %s: %s", src, e)
                continue
            try:
                self._handle(pkt, src)
            except Exception:
                log.exception("packet from %s failed", src)

    def _handle(self, pkt, src: tuple[str, int]) -> None:
        if isinstance(pkt, Search):
            self._handle_search(pkt, src)
        elif isinstance(pkt, Page):
            with self._active_lock:
                st = self._active.get(pkt.search_id)
            if st is not None:
                with st.lock:
                    st.pages.append(FoundPage(
                        page_id=pkt.page_id, distance=pkt.distance,
                        url=pkt.url, title=pkt.title, text=pkt.text,
                        instance_id=pkt.instance_id))
                    if st.expected is not None:
                        st.expected.discard(
                            (pkt.instance_id, pkt.page_id))
                        if not st.expected:
                            st.event.set()  # every winner arrived
        elif isinstance(pkt, Summary):
            with self._active_lock:
                st = self._active.get(pkt.search_id)
            if st is not None:
                with st.lock:
                    st.summaries.extend(
                        (pkt.instance_id, src, int(i), float(d))
                        for i, d in zip(pkt.page_ids, pkt.distances))
                    st.responded.add(pkt.instance_id)
                    # phase-1 early wake: every contacted peer answered
                    # (empty summaries count — no-hit peers reply too)
                    if (st.expected is None and st.contacted
                            and len(st.responded) >= st.contacted):
                        st.event.set()
        elif isinstance(pkt, PageRequest):
            self._handle_page_request(pkt, src)
        elif isinstance(pkt, Insert):
            if self.cfg.accept_insert and self.service is not None:
                self.service.insert_pages(
                    [(pkt.url, pkt.title, pkt.text)], from_network=True)
        elif isinstance(pkt, GetEmbedding):
            if self.service is not None:
                emb = self.service.provider.embedding_for_page(pkt.page_id)
                if emb is not None:
                    self._sock.sendto(
                        packets.encode(Embedding(pkt.search_id, emb),
                                       self.wire, self.wire_emb), src)
        elif isinstance(pkt, Embedding):
            with self._emb_lock:
                waiter = self._emb_waiters.get(pkt.search_id)
            if waiter is not None:
                waiter[1].append(pkt.embedding)
                waiter[0].set()
        elif isinstance(pkt, Peers):
            now = time.time()
            learned = 0
            with self._peers_lock:
                for p in pkt.peers:
                    if p.instance_id == self.instance_id:
                        continue
                    # A hostile Peers payload must not poison the
                    # table: an unparseable addr would later raise
                    # ValueError/OverflowError out of parse_addr/sendto
                    # on the CALLER threads (every remote search and
                    # replication) until the entry expired.
                    try:
                        _, port = parse_addr(p.addr)
                        if not 0 < port < 65536:
                            raise ValueError(p.addr)
                    except (ValueError, OverflowError):
                        METRICS.inc("peers_rejected", 1)
                        continue
                    p.last_seen = now
                    self.peers[p.instance_id] = p
                    learned += 1
            if learned:
                log.debug("learned %d peers", learned)
        # Announce packets are tracker business; nodes ignore them.

    def _handle_search(self, pkt: Search, src: tuple[str, int]) -> None:
        with self._active_lock:
            if pkt.search_id in self._active:
                return  # own broadcast echoed back (udp_service.rs:177-179)
        if self.service is None:
            return
        result = self.service.embedding_search(pkt.embedding,
                                               search_remote=False)
        hits = [h for h in result.pages
                if pkt.distance_limit is None
                or h.distance < pkt.distance_limit]  # udp_service.rs:195-199
        if pkt.two_phase and self.wire == packets.WIRE_DAWN:
            # phase 1: one tiny Summary instead of k full Pages; cache
            # the promised distances for the PageRequest that follows.
            # Clamped at the wire cap (best SUMMARY_MAX by distance) so
            # a large search_k can't make this reply look malformed.
            hits = hits[: packets.SUMMARY_MAX]
            self._sweep_summary_cache()
            with self._summary_lock:
                # monotonic, like the rate windows: a wall-clock step
                # must not expire promised summaries (or keep dead
                # ones alive)
                self._summary_cache[pkt.search_id] = (
                    time.monotonic() + 30.0,
                    {h.page_id: h.distance for h in hits})
            reply = Summary(pkt.search_id, self.instance_id,
                            [h.page_id for h in hits],
                            [h.distance for h in hits])
            try:
                data = packets.encode(reply, self.wire)
                self._sock.sendto(data, src)
                METRICS.inc("reply_bytes", len(data))
            except (OSError, ValueError):
                pass
            METRICS.inc("searches_served", 1)
            log.debug("served search %x: summary of %d to %s",
                      pkt.search_id, len(hits), src)
            return
        sent = 0
        for hit in hits:
            reply = Page(pkt.search_id, hit.distance, hit.url, hit.title,
                         clip_page_text(hit.url, hit.title, hit.text),
                         self.instance_id, hit.page_id)
            try:
                data = packets.encode(reply, self.wire)
                self._sock.sendto(data, src)
                METRICS.inc("reply_bytes", len(data))
                sent += 1
            except (OSError, ValueError):
                pass
        METRICS.inc("searches_served", 1)
        log.debug("served search %x: %d pages to %s", pkt.search_id, sent, src)

    # Hard cap on cached summary promises (~100 B each). Oldest-first
    # eviction past the cap keeps memory bounded even when a Search
    # flood creates fresh entries faster than the 30 s expiry (the
    # evicted searchers lose phase 2 — the silent-partial model).
    SUMMARY_CACHE_MAX = 8192

    def _sweep_summary_cache(self) -> None:
        """O(evicted) per call, NOT a full scan per inbound Search (a
        scan would make the recv thread O(search_rate x 30 s) per
        packet): entries expire in insertion order, so expired/excess
        ones are popped from the front until a live entry under the
        cap is reached."""
        with self._summary_lock:
            cache = self._summary_cache
            now = time.monotonic()
            while cache:
                sid = next(iter(cache))
                if (cache[sid][0] >= now
                        and len(cache) <= self.SUMMARY_CACHE_MAX):
                    break
                del cache[sid]

    def _handle_page_request(self, pkt: PageRequest,
                             src: tuple[str, int]) -> None:
        """Phase 2: send full Pages for the ids the searcher's global
        merge selected (the reference's sketched PageRequest flow,
        udp_packets.rs:40-43)."""
        if self.service is None:
            return
        with self._summary_lock:
            entry = self._summary_cache.get(pkt.search_id)
        if entry is None:
            return  # expired or never summarized: searcher times out
        _, dist_by_id = entry
        store = self.service.provider.store
        # FoundPage.page_id is the store id (1-based sqlite rowid), the
        # same id space GetEmbedding uses
        meta = store.get_many([int(i) for i in pkt.page_ids
                               if int(i) in dist_by_id])
        sent = 0
        for pid in pkt.page_ids:
            pid = int(pid)
            rec = meta.get(pid)
            if rec is None or pid not in dist_by_id:
                continue
            reply = Page(pkt.search_id, dist_by_id[pid], rec.url,
                         rec.title,
                         clip_page_text(rec.url, rec.title, rec.text),
                         self.instance_id, pid)
            try:
                data = packets.encode(reply, self.wire)
                self._sock.sendto(data, src)
                METRICS.inc("reply_bytes", len(data))
                sent += 1
            except (OSError, ValueError):
                pass
        log.debug("page-request %x: %d pages to %s",
                  pkt.search_id, sent, src)

    # -- membership -----------------------------------------------------------

    def announce_now(self) -> None:
        """One announce round (test hook; timer calls this too)."""
        self._expire_peers()
        if self.cfg.upnp:  # refresh gateway mapping (udp_service.rs:345-349)
            try:
                from dawnsearch_tpu_torch.net.upnp import add_port_mapping
                add_port_mapping(self.port)
            except Exception:
                log.debug("UPnP refresh failed", exc_info=True)
        pages = 0
        if self.service is not None:
            try:
                pages = self.service.stats().get("pages_indexed", 0)
            except Exception:
                pass
        pkt = packets.encode(Announce(self.instance_id,
                                      self.cfg.accept_insert, pages),
                             self.wire)
        for addr in self.trackers:
            try:
                self._sock.sendto(pkt, addr)
            except OSError:
                log.debug("announce to %s failed", addr)

    def _expire_peers(self) -> None:
        now = time.time()
        with self._peers_lock:
            stale = [iid for iid, p in self.peers.items()
                     if now - p.last_seen > PEER_EXPIRY_S]
            for iid in stale:
                del self.peers[iid]
        if stale:
            log.info("expired %d peers", len(stale))

    def _announce_loop(self) -> None:
        interval = getattr(self.cfg, "announce_interval_s",
                           ANNOUNCE_INTERVAL_S)
        while not self._stop.is_set():
            try:
                self.announce_now()
            except Exception:
                log.exception("announce failed")
            self._stop.wait(interval)
