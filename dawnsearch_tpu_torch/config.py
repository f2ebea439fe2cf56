"""Layered config: TOML file + DAWNSEARCH_* env-var overrides.

Port of dawnsearch_tpu/config.py (the reference config system,
the reference's src/config.rs:23-88): the same names in the file and the
environment and the same layering (file then env, env wins), so one
DawnSearch.toml configures either package. Only the fields this port
reads are kept (unknown keys are ignored on load, as in the reference),
plus `device`, with the reference's defaults. The reference's IVF,
JAX-platform and compilation-cache fields are left out (those features
stay behind); a file that sets them loads, and they are ignored.
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
from typing import Any

ENV_PREFIX = "DAWNSEARCH_"


@dataclasses.dataclass
class Config:
    # --- reference flags (config.rs:54-71, DawnSearch.toml.example) ---
    index_cc: bool = False
    web: bool = False
    web_listen_address: str = "0.0.0.0:8080"
    udp: bool = False
    udp_listen_address: str = "0.0.0.0:7231"
    accept_insert: bool = False
    upnp: bool = False
    trackers: list[str] = dataclasses.field(default_factory=list)
    data_dir: str = "data"
    debug: int = 0

    # --- engine section ---
    # torch device the encoder and index live on; "cuda" needs a GPU
    device: str = "cuda"
    # a bert-, mpnet- or roberta-family HF checkpoint: config.json +
    # model.safetensors + vocab.txt, or vocab.json + merges.txt for
    # roberta (none: MiniLM width, seeded weights)
    model_dir: str | None = None
    embed_batch_size: int = 64  # cross-request batching cap
    # pages per ingest batch (tokenize + one fused encode + index write +
    # one store transaction); while no query ran in the last
    # ingest_query_idle_s, the insert thread merges waiting batches up to
    # two of the encoder's top batch buckets (ingest/extraction_service.py)
    ingest_batch_size: int = 512
    # extraction worker processes (0 = in-thread). Workers are spawned
    # fresh interpreters: a script embedding DawnNode guards its entry
    # point with `if __name__ == "__main__":`
    ingest_workers: int = 0
    ingest_rate_limit: float = 0.0  # pages/s ceiling of ingest, 0 = none
    # how recently a query must have run (seconds) to stop the merge above
    ingest_query_idle_s: float = 2.0
    warc_source: str = ""  # glob of local WARC files; "" = Common Crawl
    embed_max_wait_ms: float = 5.0  # batcher flush deadline
    # 512 matches the reference's full BERT window (model.rs:123,147)
    seq_buckets: tuple[int, ...] = (16, 32, 64, 128, 256, 512)
    compute_dtype: str = "bf16"  # encoder matmul dtype: "bf16" | "f32"
    attn_impl: str = "fused"  # "fused" (K5 / K6) | "xla" (einsum + K7)
    # "layer" (whole-layer kernel K1) | "layer_i8" (K4, W8A8 projections) |
    # "ops" (per-op kernels K5 or K6, and K7)
    layer_impl: str = "layer"
    pool_impl: str = "xla"  # "xla" | "fused" (K8)
    index_capacity: int = 1_000_000  # page cap (search_provider.rs:164-166)
    index_dtype: str = "i8"  # "f32" | "bf16" | "i8" | "i4"
    index_kind: str = "flat"  # "flat" | "sharded"
    # shards of a sharded index: 0 = one per visible card (on the CPU, one
    # per process); more than the cards are refused, and on the CPU
    # mesh_shards shards share the CPU
    mesh_shards: int = 0
    # "host" re-ranks quantized candidates with the store's f32 rows;
    # "device" keeps an f16 shadow buffer on the device and re-ranks in
    # the search itself (+2 bytes/dim, no host round-trip)
    index_rerank: str = "host"
    search_k: int = 20  # results per query (search_provider.rs:214)
    # "dawn" (versionable msgpack) | "reference" (rmp-serde byte-compat,
    # joins a reference swarm; decode always accepts both)
    wire_format: str = "dawn"
    # "auto" (i8 on the dawn wire, i24 on the reference wire) | "i24"
    # (3 B/dim, reference parity) | "i8" (1 B/dim + scale, dawn wire only)
    wire_embedding: str = "auto"
    # P2P collection deadline (udp_service.rs:301)
    search_deadline_ms: float = 200.0
    # responders reply with (page id, distance) summaries and the searcher
    # asks only for the winning pages (dawn wire only)
    two_phase_search: bool = True
    # tracker heartbeat (dawnsearch.rs:122-128)
    announce_interval_s: float = 60.0
    # run the encoder once on every (seq, batch <= 256) bucket at start, so
    # the first request pays no kernel build, module load or allocator growth
    warmup: bool = False
    # --- multi-process tier (parallel/multihost.py) ---
    # One sharded index spanning several processes: process 0 runs the
    # node, the others run followers. Needs index_kind="sharded" and a
    # shared data_dir. "" = one process.
    dist_coordinator: str = ""  # torch.distributed TCP store host:port
    dist_num_processes: int = 1
    dist_process_id: int = 0
    dist_ping_interval: float = 60.0  # leader's keepalive frame, seconds
    # the leader's control-stream TCP port (0 = coordinator port + 1)
    dist_control_port: int = 0
    # the leader queues adds and sends one combined plan at this many rows
    # (or before any search or save); 1 sends each add at once
    dist_add_flush_rows: int = 8192

    @classmethod
    def load(cls, path: str | None = "DawnSearch.toml", env: dict | None = None) -> "Config":
        """File (if present) then DAWNSEARCH_* env overrides (config.rs:42-73)."""
        raw: dict[str, Any] = {}
        if path and os.path.exists(path):
            with open(path, "rb") as f:
                raw.update(tomllib.load(f))
        env = dict(os.environ if env is None else env)
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for key, val in env.items():
            if not key.startswith(ENV_PREFIX):
                continue
            name = key[len(ENV_PREFIX):].lower()
            if name in fields:
                raw[name] = _coerce(val, fields[name].type)
        known = {k: v for k, v in raw.items() if k in fields}
        cfg = cls(**known)
        if isinstance(cfg.seq_buckets, list):
            cfg.seq_buckets = tuple(cfg.seq_buckets)
        return cfg

    def summary(self) -> str:
        """Printable flag summary (reference config.rs:75-88)."""
        lines = [f"[Config] {f.name} = {getattr(self, f.name)!r}"
                 for f in dataclasses.fields(self)]
        return "\n".join(lines)


def _coerce(val: str, typ: Any) -> Any:
    t = str(typ)
    if "bool" in t:
        return val.strip().lower() in ("1", "true", "yes", "on")
    if "int" in t and "tuple" not in t and "list" not in t:
        return int(val)
    if "float" in t:
        return float(val)
    if "list" in t or "tuple" in t:
        items = [x.strip() for x in val.split(",") if x.strip()]
        if "int" in t:
            return tuple(int(x) for x in items)
        return items
    return val
