"""An all-mpnet-base-v2 checkpoint layout through the port's make_encoder:
the port's counterpart of tests/test_mpnet_checkpoint_layout.py.

The model_dir holds the real model's key set (separate q/k/v/o linears,
the encoder-level relative_attention_bias table, the `position_ids`
buffer and the pooler, both ignored) at full width (H=768, 12 layers, 12
heads, I=3072) with seeded values, written by the port's own safetensors
writer; the real config.json (pad_token_id 1, layer_norm_eps 1e-5,
max_position_embeddings 514); and a 30527-line vocab.txt with `<s> <pad>
</s> <unk>` first, BERT's whole vocab (its literal [PAD]/[CLS]/[SEP]/[UNK]
included) after them and `<mask>` last. The port's make_encoder must load
it bit-equal to the reference's loader, reproduce the reference's
make_encoder and HF AutoModel with masked mean-pool, carry eps 1e-5 into
every LayerNorm, and refuse a vocab whose pad line disagrees with the
config.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from dawnsearch_tpu.config import Config as RefConfig
from dawnsearch_tpu.models import weights as ref_weights
from dawnsearch_tpu.node import make_encoder as ref_make_encoder
from dawnsearch_tpu_torch.config import Config
from dawnsearch_tpu_torch.models import bert, weights
from dawnsearch_tpu_torch.models.tokenizer import WordPieceTokenizer
from dawnsearch_tpu_torch.node import make_encoder
from tests.test_mpnet_checkpoint_layout import (MPNET_CONFIG, TEXTS,
                                                mpnet_key_set, synth_tensor,
                                                write_vocab)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("all-mpnet-base-v2")
    with open(d / "config.json", "w") as f:
        json.dump(MPNET_CONFIG, f)
    write_vocab(d / "vocab.txt")
    rng = np.random.default_rng(13)
    weights.write_safetensors({k: synth_tensor(k, rng)
                               for k in mpnet_key_set()},
                              str(d / "model.safetensors"))
    return str(d)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def test_loads_the_real_key_set_bit_equal_to_reference(model_dir):
    got, pretrained, cfg = weights.load_params(model_dir)
    assert pretrained
    assert (cfg.model_type, cfg.pad_token_id, cfg.layer_norm_eps,
            cfg.max_position_embeddings, cfg.vocab_size, cfg.hidden_size,
            cfg.num_layers, cfg.relative_attention_num_buckets) == \
        ("mpnet", 1, 1e-05, 514, 30527, 768, 12, 32)
    assert "token_type" not in got["embeddings"]
    assert tuple(got["rel_bias"].shape) == (32, 12)
    want, _, _ = ref_weights.load_params(model_dir)
    got, want = _flat(got), _flat(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _hf_sentence_embeddings(model_dir, texts):
    transformers = pytest.importorskip("transformers")
    tok = transformers.AutoTokenizer.from_pretrained(model_dir)
    model = transformers.AutoModel.from_pretrained(model_dir).eval()
    enc = tok(texts, padding=True, return_tensors="pt")
    with torch.no_grad():
        h = model(input_ids=enc["input_ids"],
                  attention_mask=enc["attention_mask"]).last_hidden_state
    mask = enc["attention_mask"].unsqueeze(-1).float()
    pooled = (h * mask).sum(1) / mask.sum(1).clamp(min=1e-9)
    return torch.nn.functional.normalize(pooled, dim=-1).numpy()


def test_make_encoder_reproduces_reference_and_hf(model_dir):
    """In f32 against HF AutoModel + masked mean-pool (atol 2e-4, the
    MPNet forward's bound in tests/test_mpnet.py); in the node's bf16 on
    K1's route against the reference's make_encoder on its whole-layer
    kernel (per-row cosine > 0.999, the reference's bf16 bound)."""
    enc = make_encoder(Config(device="cpu", model_dir=model_dir,
                              compute_dtype="f32"))
    assert enc.cfg.model_type == "mpnet" and enc.cfg.pad_token_id == 1
    assert enc.cfg.layer_norm_eps == 1e-05
    assert type(enc.model).__name__ == "MPNetModel"
    tok = enc.tokenizer
    assert (tok.cls_id, tok.pad_id, tok.sep_id, tok.unk_id) == (0, 1, 2, 5)
    ours = enc.encode(TEXTS)
    del enc
    theirs = _hf_sentence_embeddings(model_dir, TEXTS)
    assert ours.shape == theirs.shape == (4, 768)
    np.testing.assert_allclose(ours, theirs, atol=2e-4)

    enc16 = make_encoder(Config(device="cpu", model_dir=model_dir))
    assert enc16.cfg.dtype == torch.bfloat16
    assert bert.layer_route(enc16.cfg) == "layer"
    port16 = enc16.encode(TEXTS)
    del enc16
    ref = np.asarray(ref_make_encoder(RefConfig(model_dir=model_dir)
                                      ).encode(TEXTS), np.float32)
    assert np.sum(port16 * ref, axis=1).min() > 0.999
    assert np.sum(port16 * theirs, axis=1).min() > 0.999


def test_eps_reaches_every_layer_norm(model_dir, monkeypatch):
    """config.json's 1e-5 (not BERT's 1e-12) reaches the embedding
    LayerNorm and every layer kernel's eps."""
    seen = []
    real_ln, real_k1 = bert._layer_norm, bert.fused_bert_layer
    monkeypatch.setattr(bert, "_layer_norm", lambda *a: seen.append(
        ("embeddings", a[3])) or real_ln(*a))
    monkeypatch.setattr(bert, "fused_bert_layer", lambda *a, **kw: seen.append(
        ("layer", kw["eps"])) or real_k1(*a, **kw))
    enc = make_encoder(Config(device="cpu", model_dir=model_dir,
                              seq_buckets=(16,)))
    enc.encode(TEXTS[:1])
    assert seen == [("embeddings", 1e-05)] + [("layer", 1e-05)] * 12


def test_pad_id_mismatch_refused(model_dir, tmp_path):
    """A vocab whose <pad> line is not config.json's pad_token_id would
    shift every MPNet position id: make_encoder refuses it."""
    d = tmp_path / "bad"
    shutil.copytree(model_dir, d)
    lines = (d / "vocab.txt").read_text(encoding="utf-8").splitlines()
    lines[0], lines[1] = lines[1], lines[0]      # <pad> at 0, config says 1
    (d / "vocab.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")
    with pytest.raises(ValueError, match="pad id 0 != config.json "
                                         "pad_token_id 1"):
        make_encoder(Config(device="cpu", model_dir=str(d)))


def test_mpnet_vocab_special_aliases(model_dir):
    """<s>/<pad>/</s> win over the BERT body's [CLS]/[PAD]/[SEP]; unk stays
    [UNK] (HF MPNetTokenizer's unk_token), in a small vocab and in the
    full one."""
    from dawnsearch_tpu.models.tokenizer import WordPieceTokenizer as RefTok
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "<mask>": 4}
    for i, w in enumerate(["hello", "world", "##ing", "search"]):
        vocab[w] = 5 + i
    tok = WordPieceTokenizer(vocab)
    assert (tok.cls_id, tok.pad_id, tok.sep_id, tok.unk_id) == (0, 1, 2, 3)
    ids = tok.encode("hello searching")
    assert ids[0] == 0 and ids[-1] == 2 and 3 not in ids
    assert ids == RefTok(vocab).encode("hello searching")
    full = WordPieceTokenizer.from_vocab_file(
        os.path.join(model_dir, "vocab.txt"))
    assert (full.cls_id, full.pad_id, full.sep_id, full.unk_id) == (0, 1, 2, 5)
