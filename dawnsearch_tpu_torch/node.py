"""DawnNode: process bootstrap — config -> encoder, index, services, HTTP.

Port of dawnsearch_tpu/node.py (the reference's main-binary bootstrap,
the reference's src/bin/dawnsearch.rs:37-154) for what this package
serves on one device: text search and page insert over HTTP, the
Common Crawl extractor with `index_cc` (WARC files from `warc_source`, or
Common Crawl itself, through the extraction workers and the fused ingest
path), and the UDP P2P service with `udp` (tracker membership, query
fan-out to peers, answers to their searches, insert replication). The
encoder is the checkpoint in model_dir (a `bert`-, `roberta`- or
`mpnet`-family HF checkpoint: config.json, model.safetensors, and vocab.txt
or, for RoBERTa, vocab.json + merges.txt) or seeded MiniLM-width weights, in bf16 or, for compute_dtype="f32", in f32 (the
f32 instance of every encoder kernel). It runs the whole-layer kernel
(K1) by default, its W8A8 twin (K4) for layer_impl="layer_i8", or the
per-op path
(layer_impl="ops": attention K5 or K6 and the fused FFN K7 in every layer;
attn_impl="xla": einsum attention and K7), and pools with K8 when
pool_impl="fused". An MPNet checkpoint takes the same routes with its
relative-position bias: K1's or K4's rel_bias operand, or einsum attention
on the per-op path (K5 and K6 take no such bias, as in the reference). The
score+select kernels are K2 for an i8 or bf16 index and K3 for the i4
capacity tier; the index is as wide as the encoder.
With warmup = true the encoder runs its bucket grid once before the front
end opens. The 10-minute save timer and the save on shutdown are kept.

With index_kind = "sharded" the index is a ShardedFlatIndex over
mesh_shards shards (K2 or K3 in each, an exact merge across them), and
text ingest takes the sharded fused path (K1, then each shard's rows
written on its device). With dist_num_processes > 1 this node is the
leader of a crew of processes over one sharded index
(parallel/multihost.py); the followers run `python -m
dawnsearch_tpu_torch` with dist_process_id > 0.

The node never serves something other than what its config asked for:
a value outside a setting's table makes the constructor raise, and a
CUDA device without a GPU raises instead of running on the CPU.
"""

from __future__ import annotations

import os
import random
import string
import threading

from dawnsearch_tpu_torch.config import Config
from dawnsearch_tpu_torch.utils.logging import service_logger, set_debug

log = service_logger("Node")

SAVE_INTERVAL_S = 600.0  # reference: 10-minute save timer (dawnsearch.rs:84)
WEIGHT_SEED = 0          # random weights when model_dir has no checkpoint


def random_instance_id(n: int = 16) -> str:
    """16 random alphanumerics (udp_service.rs:150-154)."""
    alphabet = string.ascii_letters + string.digits
    return "".join(random.choice(alphabet) for _ in range(n))


def check_config(cfg: Config) -> None:
    """Raise ValueError for a value outside a setting's table,
    RuntimeError for a CUDA device with no GPU."""
    problems = []
    for name, allowed in (("index_dtype", ("f32", "bf16", "i8", "i4")),
                          ("index_kind", ("flat", "sharded")),
                          ("compute_dtype", ("bf16", "f32")),
                          ("attn_impl", ("fused", "xla")),
                          ("layer_impl", ("layer", "layer_i8", "ops")),
                          ("pool_impl", ("xla", "fused")),
                          ("index_rerank", ("host", "device")),
                          ("wire_format", ("dawn", "reference")),
                          ("wire_embedding", ("auto", "i24", "i8"))):
        if getattr(cfg, name) not in allowed:
            problems.append(f"unknown {name} {getattr(cfg, name)!r}")
    if problems:
        raise ValueError("; ".join(problems))
    import torch
    if torch.device(cfg.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {cfg.device!r} asked for, but torch sees "
                           "no CUDA GPU; set device = \"cpu\" to run the plain "
                           "kernels on the CPU")


def make_encoder(cfg: Config):
    """SentenceEncoder on cfg.device, on the layer, attention and pool
    routes of the config (dawnsearch_tpu/node.py:33-97): the family and
    shape from model_dir/config.json, the weights from model.safetensors,
    and the tokenizer from vocab.json + merges.txt (byte-level BPE,
    RoBERTa) or else vocab.txt (WordPiece: BERT's [PAD]/[CLS]/[SEP] or
    MPNet's <pad>/<s>/</s>); without model_dir (or without those files)
    MiniLM width, weights from a seeded generator and a self-contained
    vocab. Each tokenizer is the native one when the library builds
    (models/tokenizer_native.py, tokenizer_bpe_native.py)."""
    import torch

    from dawnsearch_tpu_torch.models.bert import BertConfig
    from dawnsearch_tpu_torch.models.encoder import SentenceEncoder
    from dawnsearch_tpu_torch.models.tokenizer import (build_vocab_from_corpus,
                                                       read_vocab)
    from dawnsearch_tpu_torch.models.tokenizer_bpe_native import \
        best_bpe_tokenizer
    from dawnsearch_tpu_torch.models.tokenizer_native import best_tokenizer
    from dawnsearch_tpu_torch.models.weights import load_params

    base_cfg = BertConfig(
        dtype=torch.bfloat16 if cfg.compute_dtype == "bf16" else torch.float32,
        attn_impl=cfg.attn_impl, pool_impl=cfg.pool_impl,
        layer_impl=cfg.layer_impl)
    params, pretrained, bert_cfg = load_params(cfg.model_dir, cfg=base_cfg,
                                               seed=WEIGHT_SEED)
    def in_model_dir(name: str) -> str | None:
        path = os.path.join(cfg.model_dir, name) if cfg.model_dir else None
        return path if path and os.path.exists(path) else None

    bpe_files = (in_model_dir("vocab.json"), in_model_dir("merges.txt"))
    vocab_path = in_model_dir("vocab.txt")
    if all(bpe_files):
        tok = best_bpe_tokenizer(*bpe_files)
    elif vocab_path:
        tok = best_tokenizer(read_vocab(vocab_path))
    else:
        corpus = [string.ascii_lowercase, string.digits,
                  "the quick brown fox jumps over the lazy dog"]
        tok = best_tokenizer(build_vocab_from_corpus(corpus, size=4096))
        if pretrained:
            log.warning("pretrained weights but no vocab.txt or vocab.json + "
                        "merges.txt: tokenization will not match the "
                        "checkpoint")
    if pretrained and (all(bpe_files) or vocab_path) and \
            tok.pad_id != bert_cfg.pad_token_id:
        # the encoder pads with the tokenizer's pad id, and RoBERTa's and
        # MPNet's position ids are offset from config.json's: a checkpoint
        # whose files disagree is refused
        raise ValueError(
            f"tokenizer pad id {tok.pad_id} != config.json pad_token_id "
            f"{bert_cfg.pad_token_id}: mismatched checkpoint files in "
            f"{cfg.model_dir}")
    log.info("encoder ready (%s, pretrained=%s, device=%s, hidden=%d, "
             "layers=%d, layer_impl=%s, attn_impl=%s, pool_impl=%s, "
             "tokenizer=%s)",
             bert_cfg.model_type, pretrained, cfg.device,
             bert_cfg.hidden_size, bert_cfg.num_layers,
             bert_cfg.layer_impl, bert_cfg.attn_impl, bert_cfg.pool_impl,
             type(tok).__name__)
    return SentenceEncoder(params, tok, cfg=bert_cfg,
                           seq_buckets=tuple(cfg.seq_buckets),
                           device=cfg.device)


def _sharded_mesh(cfg: Config):
    """The mesh of a sharded index (reference node.py::_sharded_mesh).
    On "cuda" each shard is a visible card (mesh_shards = 0: every
    card; more shards than cards are refused); on a named card
    ("cuda:i") or the CPU, mesh_shards shards share it. With
    dist_num_processes > 1 the "shard" axis spans the crew: each process
    holds one shard a visible card, or on the CPU mesh_shards / N
    shards (0: one), and mesh_shards must be 0 or that total."""
    import torch

    from dawnsearch_tpu_torch.parallel.mesh import make_mesh
    procs = max(1, cfg.dist_num_processes)
    dev = torch.device(cfg.device)
    if dev.type == "cuda" and dev.index is None:
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        if not cards:
            raise RuntimeError(f"device {cfg.device!r} asked for, but torch "
                               "sees no CUDA GPU to hold a shard")
        n = cfg.mesh_shards or len(cards) * procs
        if procs > 1 and n != len(cards) * procs:
            raise ValueError(
                f"multihost mode shards over every card of the crew "
                f"({len(cards)} a process); leave mesh_shards = 0")
        if n > len(cards) * procs:
            raise ValueError(f"mesh_shards = {n} asks for more shards than "
                             f"the {len(cards)} visible cards")
        local = cards[:n // procs]
    else:
        n = cfg.mesh_shards or procs
        if n % procs:
            raise ValueError(
                f"multihost mode splits mesh_shards = {n} evenly over "
                f"{procs} processes; leave mesh_shards = 0 or use a "
                "multiple")
        if dev.type == "cuda" and n > procs:
            raise ValueError(f"mesh_shards = {n} asks for more shards than "
                             f"the one card {cfg.device!r}")
        local = [dev] * (n // procs)
    return make_mesh({"shard": n}, devices=local, process_count=procs,
                     process_index=cfg.dist_process_id if procs > 1 else 0)


def make_index_factory(cfg: Config, dim: int = 384, crew=None):
    """Index per config: a FlatIndex, or a ShardedFlatIndex over
    _sharded_mesh(cfg). The factory carries `.load_kwargs`, the
    configuration a snapshot reload re-applies (snapshots store data,
    not policy). With `crew` (a multihost.MultihostCrew on the leader)
    the sharded index is wrapped so every operation reaches the
    followers first (parallel/multihost.py). The kind and the mesh are
    checked here, at boot, not when a rebuild first calls the factory."""
    exact = ("f16" if cfg.index_rerank == "device" and cfg.index_dtype != "f32"
             else None)
    if cfg.index_kind not in ("flat", "sharded"):
        raise ValueError(f"unknown index_kind {cfg.index_kind}")
    if cfg.dist_num_processes > 1 and cfg.index_kind != "sharded":
        # checked on leader and follower alike (run_follower builds its
        # replica through this factory too)
        raise ValueError('multihost mode (dist_num_processes > 1) '
                         'requires index_kind="sharded"')
    if cfg.index_kind == "sharded":
        _sharded_mesh(cfg)

    def make_inner():
        from dawnsearch_tpu_torch.parallel.sharded_index import \
            ShardedFlatIndex
        return ShardedFlatIndex(mesh=_sharded_mesh(cfg), dim=dim,
                                dtype=cfg.index_dtype,
                                max_capacity=cfg.index_capacity, exact=exact)

    def factory():
        if cfg.index_kind == "flat":
            from dawnsearch_tpu_torch.index.flat import FlatIndex
            return FlatIndex(dim=dim, dtype=cfg.index_dtype,
                             max_capacity=cfg.index_capacity, exact=exact,
                             device=cfg.device)
        if crew is not None:
            from dawnsearch_tpu_torch.parallel import multihost
            return multihost.build_fresh(crew, make_inner, dim,
                                         flush_rows=cfg.dist_add_flush_rows)
        return make_inner()

    def load_kwargs() -> dict:
        kw = {"max_capacity": cfg.index_capacity, "exact": exact,
              "device": cfg.device}
        if cfg.index_kind == "sharded":
            kw["mesh"] = _sharded_mesh(cfg)
        if crew is not None:
            from dawnsearch_tpu_torch.parallel import multihost
            kw["_sharded_loader"] = multihost.crew_sharded_loader(
                crew, flush_rows=cfg.dist_add_flush_rows)
        return kw

    factory.load_kwargs = load_kwargs
    return factory


class DawnNode:
    """One running node. Use as a context manager or call start()/stop()."""

    def __init__(self, cfg: Config, encoder=None):
        check_config(cfg)
        self.cfg = cfg
        set_debug(cfg.debug)
        self.instance_id = random_instance_id()
        os.makedirs(cfg.data_dir, exist_ok=True)

        from dawnsearch_tpu_torch.index.provider import SearchProvider
        from dawnsearch_tpu_torch.serving.batcher import EmbeddingBatcher
        from dawnsearch_tpu_torch.serving.search_service import SearchService

        self.crew = None
        if cfg.dist_num_processes > 1:
            # the crew's leader: join the process group before the
            # encoder's first device use, and send every index operation
            # to the followers (parallel/multihost.py)
            from dawnsearch_tpu_torch.parallel import multihost
            if cfg.dist_process_id != 0:
                raise ValueError(
                    "DawnNode is the leader; run followers with `python -m "
                    "dawnsearch_tpu_torch` and dist_process_id > 0")
            multihost.init_distributed(cfg.dist_coordinator,
                                       cfg.dist_num_processes,
                                       cfg.dist_process_id)
            self.crew = multihost.MultihostCrew(
                ping_interval=cfg.dist_ping_interval,
                coordinator=cfg.dist_coordinator,
                control_port=cfg.dist_control_port)
        self.encoder = encoder if encoder is not None else make_encoder(cfg)
        self.batcher = EmbeddingBatcher(
            self.encoder.encode, max_batch=cfg.embed_batch_size,
            max_wait_ms=cfg.embed_max_wait_ms)
        dim = self.encoder.dim
        self.provider = SearchProvider(
            data_dir=cfg.data_dir, dim=dim, index_dtype=cfg.index_dtype,
            max_pages=cfg.index_capacity,
            index_factory=make_index_factory(cfg, dim=dim, crew=self.crew),
            device=cfg.device)
        self.udp = None
        if cfg.udp:
            from dawnsearch_tpu_torch.net.udp_service import UdpService
            self.udp = UdpService(cfg, self.instance_id)
        self.service = SearchService(
            self.provider, self.batcher, instance_id=self.instance_id,
            k=cfg.search_k, remote=self.udp)
        if self.udp is not None:
            self.udp.attach(self.service)

        self.http_server = None
        self._http_thread = None
        self.extractor = None
        self._save_timer: threading.Timer | None = None
        self._timer_lock = threading.Lock()
        self._stopped = threading.Event()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "DawnNode":
        if self.cfg.warmup:
            # before the front end opens, as dawnsearch_tpu/node.py:261-262
            self.encoder.warmup()
        if self.cfg.web:
            from dawnsearch_tpu_torch.serving.http_service import \
                start_http_service
            self.http_server, self._http_thread = start_http_service(
                self.service, self.cfg.web_listen_address,
                accept_insert=self.cfg.accept_insert)
        if self.udp is not None:
            self.udp.start()
        if self.cfg.index_cc:
            self._start_extractor()
        self._schedule_save()
        log.info("node %s up (web=%s udp=%s index_cc=%s, device=%s, "
                 "%d pages)", self.instance_id, self.cfg.web, self.cfg.udp,
                 self.cfg.index_cc, self.cfg.device,
                 len(self.provider.store))
        return self

    def _start_extractor(self) -> None:
        """The Common Crawl extractor (dawnsearch_tpu/node.py:270-285),
        after logging the WARC reader, HTML extractor and language filter
        it takes (native or Python, and why a native library is missing)."""
        from dawnsearch_tpu_torch.ingest import native
        from dawnsearch_tpu_torch.ingest.extraction_service import (
            CommonCrawlSource, ExtractionService, LocalWarcSource, WarcLedger)
        readers = native.readers()
        log.info("ingest ready (warc=%s, extract=%s, lang=%s, workers=%d, "
                 "batch=%d, source=%s)", readers["warc"], readers["extract"],
                 readers["lang"], self.cfg.ingest_workers,
                 self.cfg.ingest_batch_size,
                 self.cfg.warc_source or "Common Crawl")
        for key in ("native_error", "warc_error"):
            if key in readers:
                log.warning("ingest: %s: %s", key, readers[key])
        ledger = WarcLedger(os.path.join(self.cfg.data_dir,
                                         "ingested_warcs.txt"))
        source = (LocalWarcSource(self.cfg.warc_source)
                  if self.cfg.warc_source
                  else CommonCrawlSource(ledger=ledger))
        self.extractor = ExtractionService(
            self.service, source=source,
            batch_size=self.cfg.ingest_batch_size, ledger=ledger,
            workers=self.cfg.ingest_workers,
            rate_limit=self.cfg.ingest_rate_limit,
            query_idle_s=self.cfg.ingest_query_idle_s)
        self.extractor.start()

    def _schedule_save(self) -> None:
        # under _timer_lock with a re-check: without it, stop() could
        # cancel the already-fired old timer while this thread was past
        # its own _stopped check, leaving a stray timer that saves the
        # closed provider after shutdown
        with self._timer_lock:
            if self._stopped.is_set():
                return
            self._save_timer = threading.Timer(SAVE_INTERVAL_S,
                                               self._save_tick)
            self._save_timer.daemon = True
            self._save_timer.start()

    def _save_tick(self) -> None:
        if self._stopped.is_set():
            return
        try:
            self.service.save()
        except Exception:
            log.exception("periodic save failed")
        self._schedule_save()

    def stop(self) -> None:
        """SIGTERM path: cancel timers, stop the extractor and the
        frontends, save, close (dawnsearch.rs:141-152)."""
        if self._stopped.is_set():
            return
        self._stopped.set()
        with self._timer_lock:  # pairs with _schedule_save's re-check
            if self._save_timer is not None:
                self._save_timer.cancel()
        if self.extractor is not None:
            self.extractor.stop()
        if self.http_server is not None:
            self.http_server.shutdown()
            self.http_server.server_close()
        if self.udp is not None:
            self.udp.stop()
        self.batcher.stop()
        self.service.shutdown()
        if self.crew is not None:
            # after the final save (which gathers through the crew):
            # releases the followers with OP_STOP
            self.crew.shutdown()
        log.info("node %s stopped", self.instance_id)

    def __enter__(self) -> "DawnNode":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def http_port(self) -> int | None:
        return None if self.http_server is None else \
            self.http_server.server_address[1]

    def run_forever(self) -> None:
        """Block until SIGINT/SIGTERM."""
        import signal

        done = threading.Event()

        def handler(signum, frame):
            log.info("signal %d — shutting down", signum)
            done.set()

        signal.signal(signal.SIGINT, handler)
        signal.signal(signal.SIGTERM, handler)
        done.wait()
        self.stop()
