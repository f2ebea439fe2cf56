"""The `warmup` setting: kept by Config.load, run by the node before it
serves, over exactly the reference's bucket grid.

The reference (dawnsearch_tpu/node.py:261-262, models/encoder.py:146-163)
runs its encoder once on every (seq bucket, batch bucket <= 256) of bare
[CLS][SEP] rows when `warmup = true`. The port's SentenceEncoder.warmup
must hand its forward the same (input_ids, mask) arrays in the same order,
and DawnNode.start must call it once, before the front end opens, only
when asked.
"""

import numpy as np
import pytest
import torch

from dawnsearch_tpu.models.encoder import SentenceEncoder as RefEncoder
from dawnsearch_tpu.models.tokenizer import WordPieceTokenizer as RefTokenizer
from dawnsearch_tpu_torch.config import Config
from dawnsearch_tpu_torch.models.bert import BertConfig
from dawnsearch_tpu_torch.models.encoder import SentenceEncoder
from dawnsearch_tpu_torch.models.tokenizer import (WordPieceTokenizer,
                                                   build_vocab_from_corpus)
from dawnsearch_tpu_torch.models.weights import init_params
from dawnsearch_tpu_torch.node import DawnNode

torch.set_num_threads(2)

VOCAB = build_vocab_from_corpus(["alpha beta gamma delta epsilon"], size=64)
CFG = BertConfig(vocab_size=len(VOCAB), hidden_size=128, num_layers=1,
                 num_heads=4, intermediate_size=256, max_position_embeddings=64)


def _encoder(**buckets) -> SentenceEncoder:
    return SentenceEncoder(init_params(torch.Generator().manual_seed(0), CFG),
                           WordPieceTokenizer(VOCAB), cfg=CFG, device="cpu",
                           **buckets)


def test_config_load_keeps_warmup(tmp_path):
    path = tmp_path / "DawnSearch.toml"
    path.write_text("warmup = true\ncompute_dtype = \"f32\"\n")
    cfg = Config.load(str(path), env={})
    assert cfg.warmup is True and cfg.compute_dtype == "f32"
    assert Config.load(str(tmp_path / "absent.toml"), env={}).warmup is False
    assert Config.load(None, env={"DAWNSEARCH_WARMUP": "true"}).warmup is True


@pytest.mark.parametrize("buckets", [
    dict(seq_buckets=(16, 32), batch_buckets=(1, 8, 32, 64)),
    dict(seq_buckets=(16, 64), batch_buckets=(1, 8, 32, 64, 128, 256, 512,
                                              1024))])
def test_warmup_runs_the_references_shapes(buckets):
    """The same (input_ids, mask) arrays, in the same order, as the
    reference's warmup: len(seq_buckets) x #(batch buckets <= 256)."""
    port = _encoder(**buckets)
    seen = []
    forward = port.forward

    def record(ids, mask):
        seen.append((ids.copy(), mask.copy()))
        return forward(ids, mask)
    port.forward = record
    n = port.warmup()

    ref = RefEncoder({}, RefTokenizer(VOCAB), **buckets)
    ref_seen = []

    def ref_record(params, ids, mask):
        ref_seen.append((np.asarray(ids), np.asarray(mask)))
        return ids
    ref.__dict__["_jitted"] = ref_record     # replaces the jitted forward
    ref.warmup()

    want = len(buckets["seq_buckets"]) * sum(
        1 for b in buckets["batch_buckets"] if b <= 256)
    assert n == len(seen) == len(ref_seen) == want
    for (ids, mask), (rids, rmask) in zip(seen, ref_seen):
        np.testing.assert_array_equal(ids, rids)
        np.testing.assert_array_equal(mask, rmask)
        assert ids.dtype == rids.dtype and mask.dtype == rmask.dtype


@pytest.mark.parametrize("warmup", [True, False])
def test_node_warms_up_before_serving_only_when_asked(tmp_path, warmup):
    enc = _encoder(seq_buckets=(16,), batch_buckets=(1, 8))
    calls = []
    node = None
    real = enc.warmup

    def spy(*args, **kwargs):
        calls.append(node.http_server is None)   # the front end is not up
        return real(*args, **kwargs)
    enc.warmup = spy
    cfg = Config(device="cpu", web=True, web_listen_address="127.0.0.1:0",
                 data_dir=str(tmp_path), warmup=warmup)
    node = DawnNode(cfg, encoder=enc)
    node.start()
    try:
        assert node.http_port is not None
        assert calls == ([True] if warmup else [])
    finally:
        node.stop()
