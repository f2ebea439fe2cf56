"""Reference wire-format compat: rmp-serde 1.1.2 enum layout + smaz.

Golden byte vectors are hand-derived from the reference's serde
declarations (the reference's src/net/udp_packets.rs:27-118) and
rmp-serde 1.1.2's default encoding rules:

- enum struct variants -> one-entry msgpack map
  {variant_name: [field values in declaration order]}
  with #[serde(rename)] variant names ("s", "pg", "a", "p"; Insert /
  GetEmbedding / Embedding keep their full names);
- plain structs (PeerInfo) -> positional fixarray;
- Option<f32>: None -> nil, Some(x) -> float32 (0xca);
- serde_bytes Vec<u8> -> bin8/bin16;
- integers -> minimal msgpack uints.

smaz is antirez's public 253-entry codebook (the smaz 0.1.0 crate the
reference links, udp_service.rs:377-381).
The port's copy of tests/test_wire_reference.py.
"""

import numpy as np
import pytest
import torch

from dawnsearch_tpu_torch.net import packets, smaz
from dawnsearch_tpu_torch.net.packets import (
    WIRE_REFERENCE, Announce, Embedding, GetEmbedding, Insert, Page,
    PeerInfo, Peers, Search)
from dawnsearch_tpu_torch.ops.quant import to_i24_bytes

torch.set_num_threads(2)


def unit(seed=0):
    v = np.random.default_rng(seed).standard_normal(384).astype(np.float32)
    return v / np.linalg.norm(v)


# --- golden byte vectors ------------------------------------------------------


def test_announce_golden():
    data = packets.encode(Announce("abc", True, 7), WIRE_REFERENCE)
    assert data == bytes([
        0x81,                    # fixmap(1)
        0xA1, ord("a"),          # variant "a" (serde rename, udp_packets.rs:89)
        0x93,                    # fixarray(3) fields
        0xA3, *b"abc",           # instance_id
        0xC3,                    # accept_insert = true
        0x07,                    # pages_indexed = 7
    ])


def test_get_embedding_golden():
    data = packets.encode(GetEmbedding(300, 2), WIRE_REFERENCE)
    assert data == bytes([
        0x81,
        0xAC, *b"GetEmbedding",  # no serde rename on this variant
        0x92,
        0xCD, 0x01, 0x2C,        # search_id 300 -> uint16
        0x02,                    # page_id
    ])


def test_search_golden_prefix():
    emb = unit()
    data = packets.encode(Search(1, None, emb), WIRE_REFERENCE)
    body = to_i24_bytes(emb)
    assert len(body) == 1152     # i24 wire codec (vector.rs:48-87)
    assert data == bytes([
        0x81,
        0xA1, ord("s"),
        0x93,
        0x01,                    # search_id
        0xC0,                    # distance_limit None -> nil
        0xC5, 0x04, 0x80,        # bin16, 1152 bytes
    ]) + body


def test_search_distance_limit_is_f32():
    data = packets.encode(Search(1, 0.25, unit()), WIRE_REFERENCE)
    # Some(0.25f32) -> 0xca 3e 80 00 00 right after the search_id
    i = data.index(0xCA)
    assert data[i: i + 5] == bytes([0xCA, 0x3E, 0x80, 0x00, 0x00])


def test_page_golden():
    data = packets.encode(
        Page(5, 0.5, "u", "t", "x", "ii16", 9), WIRE_REFERENCE)
    assert data == bytes([
        0x81,
        0xA2, *b"pg",
        0x97,                    # 7 fields, declaration order
        0x05,
        0xCA, 0x3F, 0x00, 0x00, 0x00,  # distance f32 0.5
        0xA1, ord("u"), 0xA1, ord("t"), 0xA1, ord("x"),
        0xA4, *b"ii16",
        0x09,
    ])


def test_peers_golden():
    p = PeerInfo("id", "1.2.3.4:7231", accept_insert=False,
                 pages_indexed=3, last_seen=100)
    data = packets.encode(Peers([p]), WIRE_REFERENCE)
    assert data == bytes([
        0x81,
        0xA1, ord("p"),
        0x91,                    # fixarray(1): the single `peers` field
        0x91,                    # 1 peer
        0x95,                    # PeerInfo struct -> fixarray(5)
        0xA2, *b"id",
        0xAC, *b"1.2.3.4:7231",
        0x64,                    # last_seen = 100
        0xC2,                    # accept_insert = false
        0x03,                    # pages_indexed
    ])


def test_insert_golden_smaz():
    data = packets.encode(Insert("the ", "Z", ""), WIRE_REFERENCE)
    assert data == bytes([
        0x81,
        0xA6, *b"Insert",
        0x93,
        0xC4, 0x02, 0x01, 0x00,  # smaz("the ") = codes [1, 0] (bin8)
        0xC4, 0x02, 0xFE, ord("Z"),  # verbatim single byte marker 254
        0xC4, 0x00,              # empty
    ])


# --- smaz codec ---------------------------------------------------------------


def test_smaz_roundtrip_ascii():
    for s in ("", "the quick brown fox", "http://example.com/",
              "This is a small string", "foobar", "1000 numbers 2000",
              "and why not have some unicode: éàü",
              "A" * 300):  # forces chunked verbatim runs (255-framing)
        assert smaz.decompress(smaz.compress(s)) == s.encode("utf-8")


def test_smaz_compresses_english():
    s = "this is a simple english sentence that should compress well"
    assert len(smaz.compress(s)) < len(s) * 0.6


def test_smaz_known_codes():
    assert smaz.compress("the") == b"\x01"
    assert smaz.compress(" ") == b"\x00"
    http = smaz.CODEBOOK.index(b"http://")
    assert smaz.compress("http://") == bytes([http])
    assert smaz.decompress(bytes([http])) == b"http://"
    assert smaz.compress("Z") == bytes([254, ord("Z")])
    assert smaz.compress("ZZ") == bytes([255, 1, ord("Z"), ord("Z")])


# --- both formats decode through the same sniffing decode() -------------------


@pytest.mark.parametrize("wire", ["dawn", "reference"])
def test_all_packets_roundtrip(wire):
    emb = unit(1)
    pkts = [
        Search(12345, 0.75, emb),
        Search(1, None, emb),
        Page(7, 0.125, "https://e.com/a", "Title", "body text", "inst", 3),
        Insert("https://e.com/a", "A Title", "some text to replicate"),
        GetEmbedding(99, 4),
        Embedding(99, emb),
        Announce("inst0123", True, 42),
        Peers([PeerInfo("p1", "10.0.0.1:7231", True, 10, last_seen=5),
               PeerInfo("p2", "10.0.0.2:7231", False, 0, last_seen=6)]),
    ]
    for p in pkts:
        data = packets.encode(p, wire)
        assert len(data) <= packets.MAX_PACKET
        q = packets.decode(data)
        assert type(q) is type(p)
        for f in ("search_id", "distance_limit", "url", "title", "text",
                  "instance_id", "page_id", "accept_insert",
                  "pages_indexed"):
            if hasattr(p, f):
                a, b = getattr(p, f), getattr(q, f)
                if isinstance(a, float):
                    assert abs(a - b) < 1e-6
                else:
                    assert a == b
        if hasattr(p, "embedding"):
            # i24 wire quantization: 1 lsb over [-1,1] is ~1.2e-7
            np.testing.assert_allclose(p.embedding, q.embedding, atol=5e-7)
        if isinstance(p, Peers):
            assert [x.instance_id for x in q.peers] == ["p1", "p2"]
            if wire == "reference":  # rmp PeerInfo carries last_seen
                assert q.peers[0].last_seen == 5


def test_mixed_format_nodes_interoperate():
    # a dawn-format encoder's packet and a reference-format encoder's
    # packet decode through the same decode() — mixed swarms work
    a = packets.encode(Announce("n1", False, 1), "dawn")
    b = packets.encode(Announce("n2", True, 2), "reference")
    pa, pb = packets.decode(a), packets.decode(b)
    assert (pa.instance_id, pb.instance_id) == ("n1", "n2")
    assert pb.accept_insert is True
