"""Wire protocol: roundtrips, MTU budget, i24 fidelity, clipping.

The port's copy of tests/test_packets.py."""

import numpy as np
import pytest
import torch

from dawnsearch_tpu_torch.net import packets
from dawnsearch_tpu_torch.net.packets import (
    MAX_PACKET, Announce, Embedding, GetEmbedding, Insert, Page, PeerInfo,
    Peers, Search, clip_insert, clip_page_text,
)

torch.set_num_threads(2)


def unit(seed=0):
    v = np.random.default_rng(seed).standard_normal(384).astype(np.float32)
    return v / np.linalg.norm(v)


def roundtrip(pkt):
    data = packets.encode(pkt)
    assert len(data) <= MAX_PACKET
    return packets.decode(data), len(data)


def test_search_roundtrip():
    p, size = roundtrip(Search(12345678901234, 0.42, unit()))
    assert p.search_id == 12345678901234
    assert p.distance_limit == pytest.approx(0.42)
    # i24 wire codec: ~7 decimal digits of precision per dim
    np.testing.assert_allclose(p.embedding, unit(), atol=5e-7)
    assert size < 1200  # 1152 B embedding + envelope


def test_search_no_limit():
    p, _ = roundtrip(Search(1, None, unit()))
    assert p.distance_limit is None


def test_page_roundtrip():
    p, _ = roundtrip(Page(7, 0.3, "https://e.com/x", "Title", "body " * 50,
                          "inst123", 42))
    assert (p.url, p.page_id, p.instance_id) == ("https://e.com/x", 42,
                                                 "inst123")
    assert p.distance == pytest.approx(0.3)


def test_page_text_clipping():
    url, title = "https://e.com/" + "a" * 100, "T" * 200
    text = "word " * 2000  # way over budget
    clipped = clip_page_text(url, title, text)
    pkt, size = roundtrip(Page(1, 0.1, url, title, clipped, "i" * 16, 1))
    assert size <= MAX_PACKET
    assert len(pkt.text) > 200  # still useful content


def test_insert_compression_and_clip():
    text = ("the quick brown fox jumps over the lazy dog and keeps "
            "running through the meadow ") * 40  # ~3 KB, compressible
    p, size = roundtrip(clip_insert("https://e.com/fox", "Fox", text))
    assert p.url == "https://e.com/fox"
    assert p.text.startswith("the quick brown fox")
    # zlib beats the raw size comfortably on natural text
    assert size < len(text.encode())


def test_insert_incompressible_clips():
    rng = np.random.default_rng(0)
    junk = "".join(chr(33 + int(c)) for c in rng.integers(0, 90, 4000))
    p = clip_insert("https://e.com/junk", "J", junk)
    assert len(packets.encode(p)) <= MAX_PACKET
    assert junk.startswith(p.text)  # prefix preserved


def test_get_embedding_and_reply():
    p, _ = roundtrip(GetEmbedding(9, 77))
    assert (p.search_id, p.page_id) == (9, 77)
    e, _ = roundtrip(Embedding(9, unit(3)))
    np.testing.assert_allclose(e.embedding, unit(3), atol=5e-7)


def test_announce_and_peers():
    a, size = roundtrip(Announce("node" + "x" * 12, True, 123456))
    assert a.accept_insert and a.pages_indexed == 123456
    peers = [PeerInfo(f"inst{i:012d}", f"10.0.0.{i}:7231", i % 2 == 0, i * 10)
             for i in range(25)]
    p, size = roundtrip(Peers(peers))
    assert len(p.peers) == 25 and size <= MAX_PACKET  # dawntrack chunk of 25
    assert p.peers[3].addr == "10.0.0.3:7231"


def test_unknown_tag_rejected():
    import msgpack
    with pytest.raises(ValueError):
        packets.decode(msgpack.packb([99, {}]))


def test_oversized_packet_rejected():
    with pytest.raises(ValueError):
        packets.encode(Page(1, 0.1, "https://e.com", "t", "x" * 3000, "i", 1))


def test_fuzz_decode_never_hangs():
    """Malformed datagrams raise cleanly (the recv loop catches)."""
    import random
    rng = random.Random(0)
    for _ in range(300):
        junk = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 64)))
        try:
            packets.decode(junk)
        except Exception:
            pass  # any exception is fine; hangs/segfaults are not


def test_truncated_real_packet():
    import pytest as _pytest
    data = packets.encode(Announce("x" * 16, True, 5))
    for cut in (1, len(data) // 2, len(data) - 1):
        with _pytest.raises(Exception):
            packets.decode(data[:cut])


# --- i8 wire embeddings (dawn format option, Config.wire_embedding) ---------


def test_i8_search_roundtrip_small_and_accurate():
    q = unit(7)
    data = packets.encode(Search(42, 0.3, q), wire_embedding="i8")
    assert len(data) < 450  # vs ~1180 B with i24
    p = packets.decode(data)
    assert isinstance(p, Search) and p.search_id == 42
    # cosine perturbation of i8+scale is ~4e-5 — far below the 1%
    # normalization tolerance and the selector's re-rank floor
    assert float(p.embedding @ q) > 1.0 - 1e-4
    assert abs(float(np.linalg.norm(p.embedding)) - 1.0) < 0.01


def test_i8_embedding_roundtrip():
    q = unit(11)
    data = packets.encode(Embedding(9, q), wire_embedding="i8")
    assert len(data) < 420
    e = packets.decode(data)
    assert isinstance(e, Embedding) and float(e.embedding @ q) > 1.0 - 1e-4


def test_i8_and_i24_nodes_interoperate_per_frame():
    """decode() keys on the field, not the node config: an i8 frame and
    an i24 frame of the same query decode to ~the same vector."""
    q = unit(13)
    a = packets.decode(packets.encode(Search(1, None, q),
                                      wire_embedding="i8"))
    b = packets.decode(packets.encode(Search(1, None, q)))
    assert float(a.embedding @ b.embedding) > 1.0 - 1e-4


def test_i8_ranking_parity():
    """Top-10 over a corpus with the i8-roundtripped query matches the
    f32 query's ranking (the claim behind shipping 3x fewer bytes)."""
    rng = np.random.default_rng(5)
    corpus = rng.standard_normal((2000, 384)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    overlaps = []
    for seed in range(16):
        q = unit(100 + seed)
        qd = packets.decode(packets.encode(Search(1, None, q),
                                           wire_embedding="i8")).embedding
        exact = set(np.argsort(corpus @ q)[-10:].tolist())
        got = set(np.argsort(corpus @ qd)[-10:].tolist())
        overlaps.append(len(exact & got) / 10)
    assert float(np.mean(overlaps)) >= 0.99


def test_i8_hostile_frames_rejected():
    import msgpack

    from dawnsearch_tpu_torch.ops.quant import to_i8_wire_bytes

    good = to_i8_wire_bytes(unit(3))

    def frame(e8):
        return msgpack.packb([Search.TAG, {"si": 1, "dl": None, "e8": e8}],
                             use_bin_type=True)

    for bad in (
        good[:-1],                      # truncated
        good + b"\x00",                 # oversized
        good[:384] + b"\x00\x00\x00\x00",   # scale == 0
        good[:384] + np.float32(2.0).tobytes(),  # scale > 1+tol
        good[:384] + np.float32(np.nan).tobytes(),  # non-finite scale
        (np.zeros(384, np.int8).tobytes()
         + np.float32(0.5).tobytes()),  # decodes to all-zero: not unit
    ):
        with pytest.raises(ValueError):
            packets.decode(frame(bad))


def test_i8_on_reference_wire_is_refused_at_boot():
    """The reference layout is fixed i24; a config asking for i8 there
    must fail fast, not be silently ignored."""
    from dawnsearch_tpu_torch.config import Config
    from dawnsearch_tpu_torch.net.udp_service import UdpService

    cfg = Config()
    cfg.wire_format = "reference"
    cfg.wire_embedding = "i8"
    cfg.udp_listen_address = "127.0.0.1:0"
    with pytest.raises(ValueError, match="i24-only"):
        UdpService(cfg, "testinstance0000")
    cfg.wire_embedding = "bogus"
    cfg.wire_format = "dawn"
    with pytest.raises(ValueError, match="i24"):
        UdpService(cfg, "testinstance0000")
