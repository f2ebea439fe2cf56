"""UDP wire protocol: msgpack packets under the 1472-byte MTU budget.

Rebuild of the reference's src/net/udp_packets.rs. Same seven packet
types and the same design constraints — short field names to shrink
packets (udp_packets.rs:28-39), payloads under 1472 B to dodge IP
fragmentation (udp_packets.rs:22-24), embeddings quantized to the i24
wire codec (3 B/dim, 1152 B/vector, vector.rs:48-87), inserts
compressed (udp_service.rs:377-381).

Two wire formats, selected per node (`Config.wire_format`), with
decode() auto-detecting either:

- "dawn" (default): `[tag, {fields}]` msgpack — self-describing and
  versionable. Insert compression is zlib over the msgpack'd
  (url, title, text) triple instead of per-field smaz: smaz targets
  very short strings, while replicated pages are ~2 KB of natural
  language where zlib compresses ~2x better, fitting more text under
  the MTU budget. `Config.wire_embedding="i8"` additionally ships
  Search/Embedding vectors as int8+scale (~420 B packets instead of
  ~1180 B); decode() accepts either field, so i8 and i24 dawn nodes
  interoperate frame-by-frame.
- "reference": byte-compatible with the reference's rmp-serde 1.1.2
  enum layout — a single-entry msgpack map {variant_name: [fields in
  declaration order]} with serde-renamed variant names
  (udp_packets.rs:27-104), f32 floats, bin-typed byte fields, structs
  as positional arrays (PeerInfo, udp_packets.rs:107-118), and
  per-field smaz compression of Insert (udp_service.rs:377-381). A
  rebuilt node configured with this format can join a reference swarm.

Port of dawnsearch_tpu/net/packets.py: every packet encodes to the same
bytes in both packages, in both formats, and each decodes the other's
(tests/test_torch_wire_parity.py).
"""

from __future__ import annotations

import dataclasses
import math
import zlib

import msgpack
import numpy as np

from dawnsearch_tpu_torch.net import smaz
from dawnsearch_tpu_torch.ops.quant import (from_i8_wire_bytes, from_i24_bytes,
                                      to_i8_wire_bytes, to_i24_bytes)

MAX_PACKET = 1472  # stay under typical MTU (udp_packets.rs:22-24)

WIRE_DAWN = "dawn"
WIRE_REFERENCE = "reference"

# packet tags (8/9: the reference's own sketched two-phase evolution,
# udp_packets.rs:40-43 commented-out SearchSummary/PageRequest — dawn
# wire format only)
(SEARCH, PAGE, INSERT, GET_EMBEDDING, EMBEDDING, ANNOUNCE, PEERS,
 SUMMARY, PAGE_REQUEST) = range(1, 10)


@dataclasses.dataclass
class Search:
    """Query fan-out (udp_packets.rs:28-39). `two_phase` asks the
    responder for a Summary instead of full Pages; peers that predate
    the flag ignore it and reply with Pages (the searcher merges
    both)."""
    search_id: int
    distance_limit: float | None
    embedding: np.ndarray  # f32[384] unit vector
    two_phase: bool = False

    TAG = SEARCH

    def fields(self, wire_embedding: str = "i24") -> dict:
        f = {"si": self.search_id, "dl": self.distance_limit}
        if wire_embedding == "i8":  # 1 B/dim + scale: ~420 B packet
            f["e8"] = to_i8_wire_bytes(self.embedding)
        else:
            f["em"] = to_i24_bytes(self.embedding)
        if self.two_phase:  # absent = False keeps old peers byte-stable
            f["tp"] = True
        return f

    @classmethod
    def from_fields(cls, f: dict) -> "Search":
        emb = (from_i8_wire_bytes(f["e8"]) if "e8" in f
               else from_i24_bytes(f["em"]))
        return cls(f["si"], f.get("dl"), emb, bool(f.get("tp", False)))


@dataclasses.dataclass
class Page:
    """One search hit flowing back (udp_packets.rs:45-62)."""
    search_id: int
    distance: float
    url: str
    title: str
    text: str
    instance_id: str
    page_id: int

    TAG = PAGE

    def fields(self) -> dict:
        return {"si": self.search_id, "di": self.distance, "ur": self.url,
                "ti": self.title, "tx": self.text, "ii": self.instance_id,
                "pi": self.page_id}

    @classmethod
    def from_fields(cls, f: dict) -> "Page":
        return cls(f["si"], f["di"], f["ur"], f["ti"], f["tx"], f["ii"],
                   f["pi"])


@dataclasses.dataclass
class Insert:
    """Replicated page (udp_packets.rs:63-73); (url, title, text) zlib'd."""
    url: str
    title: str
    text: str

    TAG = INSERT

    def fields(self) -> dict:
        body = msgpack.packb([self.url, self.title, self.text])
        return {"z": zlib.compress(body, 6)}

    @classmethod
    def from_fields(cls, f: dict) -> "Insert":
        # bounded decompress: a 1.4 KB datagram must not be allowed to
        # inflate without limit (zlib bombs reach ~1000x)
        d = zlib.decompressobj()
        body = d.decompress(f["z"], MAX_INSERT_BODY + 1)
        if len(body) > MAX_INSERT_BODY or d.unconsumed_tail:
            raise ValueError("Insert payload exceeds decompression cap")
        url, title, text = msgpack.unpackb(body, raw=False,
                                           max_str_len=MAX_INSERT_BODY)
        return cls(url, title, text)


@dataclasses.dataclass
class GetEmbedding:
    """Remote more-like-this request (udp_packets.rs:74-79)."""
    search_id: int
    page_id: int

    TAG = GET_EMBEDDING

    def fields(self) -> dict:
        return {"si": self.search_id, "pi": self.page_id}

    @classmethod
    def from_fields(cls, f: dict) -> "GetEmbedding":
        return cls(f["si"], f["pi"])


@dataclasses.dataclass
class Embedding:
    """GetEmbedding reply (udp_packets.rs:80-86)."""
    search_id: int
    embedding: np.ndarray

    TAG = EMBEDDING

    def fields(self, wire_embedding: str = "i24") -> dict:
        if wire_embedding == "i8":
            return {"si": self.search_id,
                    "e8": to_i8_wire_bytes(self.embedding)}
        return {"si": self.search_id, "em": to_i24_bytes(self.embedding)}

    @classmethod
    def from_fields(cls, f: dict) -> "Embedding":
        emb = (from_i8_wire_bytes(f["e8"]) if "e8" in f
               else from_i24_bytes(f["em"]))
        return cls(f["si"], emb)


@dataclasses.dataclass
class Announce:
    """Node -> tracker heartbeat (udp_packets.rs:89-98)."""
    instance_id: str
    accept_insert: bool
    pages_indexed: int

    TAG = ANNOUNCE

    def fields(self) -> dict:
        return {"ii": self.instance_id, "ai": self.accept_insert,
                "px": self.pages_indexed}

    @classmethod
    def from_fields(cls, f: dict) -> "Announce":
        return cls(f["ii"], f["ai"], f["px"])


@dataclasses.dataclass
class PeerInfo:
    """Tracker-advertised peer (udp_packets.rs:107-118)."""
    instance_id: str
    addr: str  # "host:port"
    accept_insert: bool
    pages_indexed: int
    last_seen: int = 0  # unix secs, tracker-side bookkeeping

    def to_wire(self) -> list:
        return [self.instance_id, self.addr, self.accept_insert,
                self.pages_indexed]

    @classmethod
    def from_wire(cls, w: list) -> "PeerInfo":
        return cls(w[0], w[1], w[2], w[3])


@dataclasses.dataclass
class Peers:
    """Tracker -> node membership reply, chunked 25/packet by the
    tracker (dawntrack.rs:93-109)."""
    peers: list[PeerInfo]

    TAG = PEERS

    def fields(self) -> dict:
        return {"ps": [p.to_wire() for p in self.peers]}

    @classmethod
    def from_fields(cls, f: dict) -> "Peers":
        return cls([PeerInfo.from_wire(w) for w in f["ps"]])


# Hard cap on Summary pairs / PageRequest ids per packet: bounds a
# hostile frame AND keeps both under the MTU budget (~16 B/pair).
# SENDERS must clamp to this (udp_service clamps hits and chunks
# requests) — a bigger search_k must not make a legit peer look
# malformed to the receiver's validator.
SUMMARY_MAX = 64


@dataclasses.dataclass
class Summary:
    """Two-phase search, phase-1 reply: the responder's local top-k as
    (page_id, distance) pairs — ~16 B/hit instead of a ~1.4 KB Page.
    The reference sketched exactly this (udp_packets.rs:40-43,
    SearchSummary) but never built it. Dawn wire format only."""
    search_id: int
    instance_id: str
    page_ids: list[int]
    distances: list[float]

    TAG = SUMMARY

    def fields(self) -> dict:
        return {"si": self.search_id, "ii": self.instance_id,
                "pi": list(self.page_ids),
                "di": [float(d) for d in self.distances]}

    @classmethod
    def from_fields(cls, f: dict) -> "Summary":
        return cls(f["si"], f["ii"], list(f["pi"]), list(f["di"]))


@dataclasses.dataclass
class PageRequest:
    """Two-phase search, phase 2: the searcher asks one responder for
    the specific pages that survived the global merge
    (udp_packets.rs:40-43, sketched PageRequest)."""
    search_id: int
    page_ids: list[int]

    TAG = PAGE_REQUEST

    def fields(self) -> dict:
        return {"si": self.search_id, "pi": list(self.page_ids)}

    @classmethod
    def from_fields(cls, f: dict) -> "PageRequest":
        return cls(f["si"], list(f["pi"]))


_TYPES = {cls.TAG: cls
          for cls in (Search, Page, Insert, GetEmbedding, Embedding,
                      Announce, Peers, Summary, PageRequest)}

Packet = (Search | Page | Insert | GetEmbedding | Embedding | Announce
          | Peers | Summary | PageRequest)


# --- reference wire format (rmp-serde 1.1.2 enum layout) --------------------

# serde variant renames (udp_packets.rs:28,45,89,99; Insert/GetEmbedding/
# Embedding keep their full names — no #[serde(rename)] on those variants)
_REF_VARIANT = {Search: "s", Page: "pg", Insert: "Insert",
                GetEmbedding: "GetEmbedding", Embedding: "Embedding",
                Announce: "a", Peers: "p"}
_REF_BY_NAME = {v: k for k, v in _REF_VARIANT.items()}


def _ref_values(p: Packet) -> list:
    """Field values in Rust declaration order (rmp-serde serializes
    struct variants as positional arrays). Summary/PageRequest never
    reach here (_encode_unchecked rejects them: no reference layout
    exists, udp_packets.rs:40-43)."""
    if isinstance(p, Search):
        return [p.search_id, p.distance_limit, to_i24_bytes(p.embedding)]
    if isinstance(p, Page):
        return [p.search_id, float(p.distance), p.url, p.title, p.text,
                p.instance_id, p.page_id]
    if isinstance(p, Insert):
        return [smaz.compress(p.url), smaz.compress(p.title),
                smaz.compress(p.text)]
    if isinstance(p, GetEmbedding):
        return [p.search_id, p.page_id]
    if isinstance(p, Embedding):
        return [p.search_id, to_i24_bytes(p.embedding)]
    if isinstance(p, Announce):
        return [p.instance_id, p.accept_insert, p.pages_indexed]
    if isinstance(p, Peers):
        return [[[q.instance_id, q.addr, q.last_seen, q.accept_insert,
                  q.pages_indexed] for q in p.peers]]
    raise TypeError(type(p))


def _ref_packet(name: str, v: list) -> Packet:
    cls = _REF_BY_NAME.get(name)
    if cls is None:
        raise ValueError(f"unknown reference packet variant {name!r}")
    if cls is Search:
        return Search(v[0], v[1], from_i24_bytes(v[2]))
    if cls is Page:
        return Page(v[0], v[1], v[2], v[3], v[4], v[5], v[6])
    if cls is Insert:
        return Insert(*(smaz.decompress(x).decode("utf-8", "replace")
                        for x in v[:3]))
    if cls is GetEmbedding:
        return GetEmbedding(v[0], v[1])
    if cls is Embedding:
        return Embedding(v[0], from_i24_bytes(v[1]))
    if cls is Announce:
        return Announce(v[0], v[1], v[2])
    return Peers([PeerInfo(instance_id=w[0], addr=w[1], last_seen=w[2],
                           accept_insert=w[3], pages_indexed=w[4])
                  for w in v[0]])


def _encode_unchecked(packet: Packet, wire_format: str,
                      wire_embedding: str = "i24") -> bytes:
    if wire_format == WIRE_REFERENCE:
        if type(packet) not in _REF_VARIANT:
            # the reference never shipped its SearchSummary/PageRequest
            # sketch (udp_packets.rs:40-43): no byte layout exists
            raise ValueError(
                f"{type(packet).__name__} has no reference wire layout "
                "(two-phase search is dawn-format only)")
        # f32 floats (0xca) and bin-typed bytes, exactly as rmp writes
        # them; wire_embedding is ignored — the reference layout is
        # i24-only (vector.rs:48-87), interop wins over bytes
        return msgpack.packb({_REF_VARIANT[type(packet)]:
                              _ref_values(packet)},
                             use_bin_type=True, use_single_float=True)
    if isinstance(packet, (Search, Embedding)):
        fields = packet.fields(wire_embedding)
    else:
        fields = packet.fields()
    return msgpack.packb([packet.TAG, fields], use_bin_type=True)


def encode(packet: Packet, wire_format: str = WIRE_DAWN,
           wire_embedding: str = "i24") -> bytes:
    data = _encode_unchecked(packet, wire_format, wire_embedding)
    if len(data) > MAX_PACKET:
        raise ValueError(
            f"{type(packet).__name__} packet {len(data)} B exceeds "
            f"{MAX_PACKET} B budget")
    return data


# Hostile-input bounds for decode(). Legitimate frames are <= 1472 B
# (MAX_PACKET); these caps leave slack for future growth while keeping
# a crafted datagram from allocating unbounded memory. The reference
# trusts the network outright (udp_service.rs:159-174) — the recv loop
# here must survive arbitrary bytes.
MAX_DATAGRAM = 8 * MAX_PACKET
_UNPACK_LIMITS = dict(max_str_len=8192, max_bin_len=8192,
                      max_array_len=256, max_map_len=16)
MAX_INSERT_BODY = 65536  # zlib-bomb cap: Insert text expands to <=64 KiB


def decode(data: bytes) -> Packet:
    """Decode either wire format (sniffed from the frame shape: dawn is
    a 2-array with an int tag, reference a 1-map with a str key).

    Raises ValueError on ANY malformed/hostile frame — oversized,
    truncated, wrong field types, zlib bombs, non-normalized
    embeddings — never an uncaught decoder exception: the UDP recv
    loop treats ValueError as "drop and count", anything else would be
    a bug."""
    if len(data) > MAX_DATAGRAM:
        raise ValueError(f"datagram {len(data)} B exceeds {MAX_DATAGRAM}")
    try:
        obj = msgpack.unpackb(data, raw=False, **_UNPACK_LIMITS)
    except Exception as e:
        raise ValueError(f"undecodable msgpack frame: {e}") from None
    try:
        if isinstance(obj, dict) and len(obj) == 1:
            ((name, values),) = obj.items()
            if isinstance(name, str):
                if not isinstance(values, (list, tuple)):
                    raise ValueError("reference variant body not an array")
                return _validate(_ref_packet(name, values))
        if isinstance(obj, (list, tuple)) and len(obj) == 2:
            tag, fields = obj
            cls = _TYPES.get(tag) if isinstance(tag, int) else None
            if cls is not None:
                if not isinstance(fields, dict):
                    raise ValueError("dawn packet fields not a map")
                return _validate(cls.from_fields(fields))
    except ValueError:
        raise
    except Exception as e:
        # KeyError / IndexError / TypeError / zlib.error / unicode
        # errors from hostile field contents all mean the same thing
        raise ValueError(f"malformed packet: {type(e).__name__}: {e}"
                         ) from None
    raise ValueError("unrecognized packet frame")


def _validate(p: Packet) -> Packet:
    """Post-construction type/shape checks — a frame that parses but
    carries wrong-typed fields must not reach the handlers."""
    def req(cond: bool, what: str) -> None:
        if not cond:
            raise ValueError(f"malformed {type(p).__name__}: {what}")

    _int = (int,)

    def _finite(x) -> bool:
        # NaN/Inf distances must not reach the merge: every NaN
        # comparison is False, so a hostile peer's NaN entries would
        # occupy top-k slots in sorted() ahead of genuinely closer
        # hits (and a NaN distance_limit silences all replies)
        return isinstance(x, (int, float)) and math.isfinite(x)

    if isinstance(p, Search):
        req(isinstance(p.search_id, _int), "search_id")
        req(p.distance_limit is None or _finite(p.distance_limit),
            "distance_limit")
    elif isinstance(p, Page):
        req(isinstance(p.search_id, _int), "search_id")
        req(_finite(p.distance), "distance")
        req(all(isinstance(s, str)
                for s in (p.url, p.title, p.text, p.instance_id)),
            "string fields")
        req(isinstance(p.page_id, _int), "page_id")
    elif isinstance(p, Insert):
        req(all(isinstance(s, str) for s in (p.url, p.title, p.text)),
            "string fields")
        req(len(p.url) + len(p.title) + len(p.text) <= MAX_INSERT_BODY,
            "body too large")
    elif isinstance(p, GetEmbedding):
        req(isinstance(p.search_id, _int) and isinstance(p.page_id, _int),
            "ids")
    elif isinstance(p, Embedding):
        req(isinstance(p.search_id, _int), "search_id")
    elif isinstance(p, Announce):
        req(isinstance(p.instance_id, str), "instance_id")
        req(isinstance(p.accept_insert, bool), "accept_insert")
        req(isinstance(p.pages_indexed, _int), "pages_indexed")
    elif isinstance(p, Peers):
        for q in p.peers:
            req(isinstance(q.instance_id, str)
                and isinstance(q.addr, str)
                and isinstance(q.accept_insert, bool)
                and isinstance(q.pages_indexed, int), "peer entry")
    elif isinstance(p, Summary):
        req(isinstance(p.search_id, _int), "search_id")
        req(isinstance(p.instance_id, str), "instance_id")
        req(len(p.page_ids) == len(p.distances) <= SUMMARY_MAX,
            "pair arity")
        req(all(isinstance(i, _int) for i in p.page_ids), "page_ids")
        req(all(_finite(d) for d in p.distances), "distances")
    elif isinstance(p, PageRequest):
        req(isinstance(p.search_id, _int), "search_id")
        req(len(p.page_ids) <= SUMMARY_MAX
            and all(isinstance(i, _int) for i in p.page_ids), "page_ids")
    return p


def clip_page_text(url: str, title: str, text: str,
                   budget: int = MAX_PACKET) -> str:
    """Longest text that keeps a Page packet under budget (the reference
    just hopes; we enforce). Conservative: bytes, not chars."""
    overhead = 120 + len(url.encode()) + len(title.encode())
    return _clip_utf8(text, max(0, budget - overhead))


def clip_insert(url: str, title: str, text: str,
                budget: int = MAX_PACKET,
                wire_format: str = WIRE_DAWN) -> Insert:
    """Insert packet that fits: shrink text until the compressed payload
    is under budget (reference smaz-compresses and hopes,
    udp_service.rs:377-388)."""
    while True:
        pkt = Insert(url, title, text)
        if len(_encode_unchecked(pkt, wire_format)) <= budget:
            return pkt
        if not text:
            raise ValueError("url+title alone exceed packet budget")
        text = _clip_utf8(text, int(len(text.encode()) * 0.8))


def _clip_utf8(s: str, max_bytes: int) -> str:
    """UTF-8-safe truncation (reference util.rs slice_up_to:18-27)."""
    b = s.encode("utf-8")
    if len(b) <= max_bytes:
        return s
    return b[:max_bytes].decode("utf-8", errors="ignore")
