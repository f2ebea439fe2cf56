"""CPU tests of the harness. Tests marked `gpu` need the card and skip
here, deciding inside the test; run them on the card with
`python -m pytest -q benchmark/tests -m gpu`."""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# A tiny cell of each kind, run on the CPU: a 2-layer, 128-wide BERT over
# a 4,096-page store.
TINY_CONFIG = {
    "architectures": ["BertModel"], "hidden_act": "gelu", "hidden_size": 128,
    "intermediate_size": 512, "layer_norm_eps": 1e-12,
    "max_position_embeddings": 512, "model_type": "bert",
    "num_attention_heads": 2, "num_hidden_layers": 2, "pad_token_id": 0,
    "type_vocab_size": 2, "vocab_size": 30522}
SHARE = [0.07, 0.36, 0.30, 0.13, 0.06, 0.035, 0.02, 0.01, 0.007, 0.004,
         0.0025, 0.0015]
LANGUAGES = {"en": 0.45, "latin": 0.31, "cyrillic": 0.07, "cjk": 0.11,
             "other": 0.06}
SEARCH = {"pool": 256, "query_words": SHARE, "zipf_exponent": 0.8,
          "store_share": 1.0, "planted_per_query": 8,
          "planted_cos": [0.9, 0.99], "client_processes": 2, "timeout_s": 20,
          "long_words": 8, "trace_s": 2}
TRAFFIC = {
    "tiny-open": {"kind": "search_open", "rate": 20, "warmup_s": 2,
                  "connections": 8, "judged": 32, **SEARCH},
    "tiny-closed": {"kind": "search_closed", "clients": 8, "warmup_s": 2,
                    "requests_per_process": 5000, "keep_every": 5, **SEARCH},
    "tiny-ingest": {"kind": "warc_ingest", "seeded_share": 0.5, "files": 2,
                    "writers": 2, "pages_per_s": 100, "ramp_s": 10,
                    "ramp_batches": 2, "ramp_timeout_s": 300,
                    "languages": LANGUAGES, "text_mean_chars": 2055,
                    "text_sigma": 0.9, "html_mean_bytes": 20000,
                    "html_sigma": 1.0, "html_max_bytes": 262144,
                    "min_left": 64, "judged": 16, "searched": 4,
                    "trace_s": 2}}
LIMITS = {"tiny-open": {"score_gap": 1e-4, "rank_gap": 1e-4, "min_judged": 10},
          "tiny-closed": {"score_gap": 1e-4, "rank_gap": 1e-4,
                          "min_judged": 10},
          "tiny-ingest": {"emb_gap": 1e-4, "min_judged": 8}}

DRIVER = """
import json, os, sys
sys.path.insert(0, {root!r})
from benchmark import spec, run
spec.HERE = {here!r}
spec.benchmark = lambda: json.load(open(os.path.join({here!r}, "bench.json")))
if __name__ == "__main__":
    cmd = json.loads(os.environ.get("TINY_NODE_CMD", "null"))
    env = json.loads(os.environ.get("TINY_NODE_ENV", "{{}}"))
    sys.exit(run.main(sys.argv[1:], device="cpu", node_cmd=cmd, node_env=env))
"""


@pytest.fixture(scope="session")
def tiny_spec(tmp_path_factory):
    """A benchmark folder of tiny CPU cells beside the real metric
    readers; returns its path (driver.py runs a cell of it)."""
    d = tmp_path_factory.mktemp("tinybench")
    for sub in ("configs", "traffic", "limits"):
        (d / sub).mkdir()
    shutil.copytree(os.path.join(BENCH, "metrics"), d / "metrics")
    cfg = dict(TINY_CONFIG, published_keys=list(TINY_CONFIG),
               index_capacity=4096, index_dtype="i8", index_rerank="host",
               search_k=20, layer_impl="layer", compute_dtype="f32",
               ingest_workers=1)
    (d / "configs" / "tiny.json").write_text(json.dumps(cfg))
    for name, t in TRAFFIC.items():
        (d / "traffic" / f"{name}.json").write_text(json.dumps(t))
        (d / "limits" / f"{name}.json").write_text(json.dumps(LIMITS[name]))
    bench = {
        "workloads": [{"name": n, "config": "tiny", "traffic": n,
                       "chips": 1, "why": "CPU test"} for n in TRAFFIC],
        "end_to_end": [
            {"name": "search_p95_ms", "unit": "ms",
             "workloads": ["tiny-open"]},
            {"name": "search_qps", "unit": "queries/s",
             "workloads": ["tiny-closed"]},
            {"name": "ingest_pages_s", "unit": "pages/s",
             "workloads": ["tiny-ingest"]},
            {"name": "setup_s", "unit": "s"}],
        "per_layer": [
            {"name": "http_gap_ms.steady", "unit": "ms",
             "workloads": ["tiny-open"]},
            {"name": "query_batch.steady", "unit": "queries",
             "workloads": ["tiny-open", "tiny-closed"]},
            {"name": "mfu.steady", "unit": "%", "workloads": ["tiny-open"]}]}
    (d / "bench.json").write_text(json.dumps(bench))
    (d / "driver.py").write_text(DRIVER.format(root=ROOT, here=str(d)))
    return d


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs the card (skips without)")
