"""Two-phase remote search (Summary/PageRequest), the reference's own
sketched protocol evolution (udp_packets.rs:40-43, commented out there,
built here under wire_format="dawn"; round-2 VERDICT item 8).

Phase 1 returns ~16 B/hit summaries instead of ~full-page packets;
the searcher merges globally and requests only the winners. The A/B
below measures the reply-byte reduction at equal result quality on a
1-searcher + 3-responder loopback swarm.
The port's copy of tests/test_two_phase.py.
"""

import numpy as np
import pytest
import torch

from dawnsearch_tpu_torch.net import packets
from dawnsearch_tpu_torch.net.packets import PageRequest, Search, Summary
from dawnsearch_tpu_torch.net.tracker import Tracker
from dawnsearch_tpu_torch.node import DawnNode
from dawnsearch_tpu_torch.utils.logging import METRICS
from tests.test_torch_p2p import HashEncoder, node_cfg, wait_until

torch.set_num_threads(2)


def test_packet_round_trips():
    s = Summary(7, "iid", [1, 2, 3], [0.1, 0.2, 0.3])
    out = packets.decode(packets.encode(s, packets.WIRE_DAWN))
    assert out == s
    r = PageRequest(7, [2, 3])
    assert packets.decode(packets.encode(r, packets.WIRE_DAWN)) == r
    # two-phase flag rides the Search packet, default-off stays
    # byte-identical for old peers
    v = np.zeros(384, np.float32)
    v[0] = 1.0
    plain = packets.encode(Search(1, None, v), packets.WIRE_DAWN)
    tp = packets.encode(Search(1, None, v, two_phase=True),
                        packets.WIRE_DAWN)
    assert len(tp) > len(plain)
    assert packets.decode(tp).two_phase
    assert not packets.decode(plain).two_phase


def test_no_reference_wire_layout():
    with pytest.raises(ValueError, match="dawn-format only"):
        packets.encode(Summary(1, "i", [], []), packets.WIRE_REFERENCE)
    with pytest.raises(ValueError, match="dawn-format only"):
        packets.encode(PageRequest(1, [1]), packets.WIRE_REFERENCE)


def _swarm(tmp_path, tracker_port, two_phase: bool, n_resp: int = 3,
           wire_embedding: str = "i24"):
    searcher = DawnNode(
        node_cfg(tmp_path, f"s{two_phase}", tracker_port,
                 two_phase_search=two_phase,
                 wire_embedding=wire_embedding),
        encoder=HashEncoder()).start()
    responders = [
        DawnNode(node_cfg(tmp_path, f"r{two_phase}{i}", tracker_port),
                 encoder=HashEncoder()).start()
        for i in range(n_resp)]
    assert wait_until(
        lambda: len(searcher.udp.fresh_peers()) == n_resp
        and all(r.udp.fresh_peers() for r in responders), timeout=8.0)
    return searcher, responders


def _fill(responders, body: str):
    for ri, r in enumerate(responders):
        r.service.insert_pages(
            [(f"https://r{ri}.example/{i}", f"doc {ri}-{i}",
              body + f" variant {ri} {i}") for i in range(25)],
            from_network=True)  # no replication: keep corpora disjoint


def _reply_bytes_for_search(searcher, query):
    before = METRICS.snapshot()
    res = searcher.service.text_search(query, k=20)
    after = METRICS.snapshot()
    return (res,
            after.get("reply_bytes", 0) - before.get("reply_bytes", 0),
            after.get("query_bytes", 0) - before.get("query_bytes", 0))


def _run_mode(tmp_path, two_phase: bool, wire_embedding: str = "i24"):
    """Isolated swarm (own tracker) -> (result, reply bytes, query bytes)."""
    body = "the lighthouse keeper watched the winter storm roll in " * 20
    tracker = Tracker("127.0.0.1:0").start()
    nodes = []
    try:
        s, rs = _swarm(tmp_path, tracker.port, two_phase=two_phase,
                       wire_embedding=wire_embedding)
        nodes += [s, *rs]
        _fill(rs, body)
        assert s.udp.two_phase == two_phase
        if two_phase:
            # phase-1 early wake: with every peer answering on loopback,
            # the search must not burn both full deadlines (round-3
            # review: it used to sleep the whole phase-1 window)
            import time
            t0 = time.perf_counter()
            res = s.service.text_search("doc 0-1\n" + body
                                        + " variant 0 1", k=20)
            dt = time.perf_counter() - t0
            assert any(p.url == "https://r0.example/1" for p in res.pages)
            assert dt < 2 * s.cfg.search_deadline_ms / 1000.0, dt
            # search_k above the wire cap still round-trips (summary
            # clamped, PageRequest chunked at SUMMARY_MAX)
            res = s.service.text_search("doc 2-4\n" + body
                                        + " variant 2 4", k=80)
            assert any(p.url == "https://r2.example/4" for p in res.pages)
        return _reply_bytes_for_search(
            s, "doc 1-3\n" + body + " variant 1 3")
    finally:
        for n in nodes:
            n.stop()
        tracker.stop()


def test_two_phase_cuts_reply_bytes_at_fanout(tmp_path):
    res1, bytes1, _ = _run_mode(tmp_path / "one", two_phase=False)
    assert any(p.url == "https://r1.example/3" for p in res1.pages)

    res2, bytes2, _ = _run_mode(tmp_path / "two", two_phase=True)
    assert any(p.url == "https://r1.example/3" for p in res2.pages)
    # equal quality above; fewer bytes: each responder sent one tiny
    # summary and only globally-winning pages crossed as full packets
    assert bytes2 < bytes1 * 0.7, (bytes1, bytes2)


def test_dead_phase2_responder_does_not_burn_deadline(tmp_path):
    """Phase-2 deadline hygiene (round-3 VERDICT item 7): when the
    PageRequest send to one summary-winning responder FAILS, its keys
    leave the awaited set immediately — the search wakes as soon as
    the live responders' pages arrive instead of burning the whole
    second deadline, and still returns the live peers' results."""
    import time

    from dawnsearch_tpu_torch.net.packets import PageRequest as PR

    body = "the observatory dome turned slowly under the summer stars " * 20
    tracker = Tracker("127.0.0.1:0").start()
    nodes = []
    try:
        s, rs = _swarm(tmp_path, tracker.port, two_phase=True)
        nodes += [s, *rs]
        _fill(rs, body)
        dead = rs[0]
        dead_addr = dead.udp._sock.getsockname()

        class FlakySock:
            """Delegating proxy: only phase-2 PageRequests to the
            "dead" responder fail at send time; phase 1 reaches all."""

            def __init__(self, sock):
                self._s = sock

            def __getattr__(self, a):
                return getattr(self._s, a)

            def sendto(self, data, dest):
                if dest[1] == dead_addr[1]:
                    try:
                        if isinstance(packets.decode(data), PR):
                            raise OSError("responder died between phases")
                    except ValueError:
                        pass
                return self._s.sendto(data, dest)

        s.udp._sock = FlakySock(s.udp._sock)
        t0 = time.perf_counter()
        res = s.service.text_search("doc 1-2\n" + body + " variant 1 2",
                                    k=20)
        dt = time.perf_counter() - t0
        # live responders' pages still came back...
        assert any(p.url == "https://r1.example/2" for p in res.pages)
        # ...and phase 2 did not sleep its full deadline on the dead
        # peer (phase 1 early-wakes; the 1.5x bound leaves phase 2 only
        # a fraction of its 500 ms window)
        assert dt < 1.5 * s.cfg.search_deadline_ms / 1000.0, dt
        # the dead responder's pages are absent (summaries won slots,
        # but the page requests never reached it)
        assert not any(p.url.startswith("https://r0.example/")
                       for p in res.pages)
    finally:
        for n in nodes:
            n.stop()
        tracker.stop()


def test_i8_wire_cuts_query_bytes_at_equal_quality(tmp_path):
    """i8 wire embeddings (packets.py:69-77) x two-phase: Search packets
    shrink ~1180 -> ~420 B at no ranking cost (round-3 i8-wire tier)."""
    res24, _, qbytes24 = _run_mode(tmp_path / "q24", two_phase=True,
                                   wire_embedding="i24")
    assert any(p.url == "https://r1.example/3" for p in res24.pages)

    res8, _, qbytes8 = _run_mode(tmp_path / "q8", two_phase=True,
                                 wire_embedding="i8")
    assert any(p.url == "https://r1.example/3" for p in res8.pages)
    # same winning URLs both ways (equal result quality on this corpus)
    assert ({p.url for p in res8.pages[:10]}
            == {p.url for p in res24.pages[:10]})
    # ~2.8x fewer query bytes (420 vs 1180 B per Search packet)
    assert 0 < qbytes8 < qbytes24 * 0.45, (qbytes24, qbytes8)
