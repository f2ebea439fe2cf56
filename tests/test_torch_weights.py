"""HF checkpoints in the port: the safetensors reader and writer, the HF
tensor naming, config.json, load_params and make_encoder, against the
reference's loader, the `safetensors` package and HF transformers.

- to_hf_tensors / from_hf_tensors round-trip bit for bit;
- a checkpoint the reference's save_safetensors writes loads through the
  port's load_params into a tree bit-equal to the reference's own load;
- one the port writes loads through safetensors.numpy.load_file (skipped
  where that package is absent) and through transformers.BertModel;
- every dtype the reference's numpy reader reads round-trips; BF16 is
  refused by the tensor's name;
- the reference's refusals hold (hidden_act, an unknown model_type, a
  checkpoint deeper than its config.json); a roberta config.json loads
  (mpnet and roberta end to end: tests/test_torch_mpnet*.py,
  tests/test_torch_roberta.py);
- HF's BertModel stays the third oracle: the port's make_encoder on a
  synthesized MiniLM-shape model_dir in f32 gives HF's sentence embeddings
  within atol 2e-5 (tests/test_real_checkpoint_layout.py:170).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from dawnsearch_tpu.models import bert as ref_bert
from dawnsearch_tpu.models import weights as ref_weights
from dawnsearch_tpu_torch.config import Config
from dawnsearch_tpu_torch.models import weights
from dawnsearch_tpu_torch.models.bert import BertConfig
from dawnsearch_tpu_torch.node import make_encoder

torch.set_num_threads(2)

SMALL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
             intermediate_size=256, max_position_embeddings=64)
MINILM = dict(vocab_size=30522, hidden_size=384, num_layers=6, num_heads=12,
              intermediate_size=1536, max_position_embeddings=512)
WORDS = ("the quick brown fox jumps over a lazy dog search engine semantic "
         "web page index query hello world fast model transformer sentence "
         "embedding vector distributed network ##ing ##ed ##er ##s ##ly").split()
TEXTS = ["The quick brown fox jumps over the lazy dog",
         "semantic web search engine", "a distributed network index",
         "hello world"]


def _hf_config(shape: dict, **extra) -> dict:
    return {"architectures": ["BertModel"], "model_type": "bert",
            "hidden_act": "gelu", "hidden_size": shape["hidden_size"],
            "num_hidden_layers": shape["num_layers"],
            "num_attention_heads": shape["num_heads"],
            "intermediate_size": shape["intermediate_size"],
            "vocab_size": shape["vocab_size"],
            "max_position_embeddings": shape["max_position_embeddings"],
            "type_vocab_size": 2, "layer_norm_eps": 1e-12, "pad_token_id": 0,
            "position_embedding_type": "absolute", **extra}


def _tree(rng: np.random.Generator, shape: dict) -> dict:
    """A stacked numpy tree with non-trivial biases and LN parameters."""
    H, I, L = shape["hidden_size"], shape["intermediate_size"], shape["num_layers"]

    def w(*s):
        return (rng.standard_normal(s) * 0.05).astype(np.float32)

    def v(*s, base=0.0):
        return (base + rng.standard_normal(s) * 0.02).astype(np.float32)

    return {
        "embeddings": {"word": w(shape["vocab_size"], H),
                       "position": w(shape["max_position_embeddings"], H),
                       "token_type": w(2, H), "ln_scale": v(H, base=1.0),
                       "ln_bias": v(H)},
        "layers": {"qkv_w": w(L, H, 3 * H), "qkv_b": v(L, 3 * H),
                   "attn_out_w": w(L, H, H), "attn_out_b": v(L, H),
                   "attn_ln_scale": v(L, H, base=1.0), "attn_ln_bias": v(L, H),
                   "ffn_in_w": w(L, H, I), "ffn_in_b": v(L, I),
                   "ffn_out_w": w(L, I, H), "ffn_out_b": v(L, H),
                   "ffn_ln_scale": v(L, H, base=1.0), "ffn_ln_bias": v(L, H)},
    }


def _write_model_dir(d, shape: dict, seed: int, **config_extra) -> dict:
    """config.json, model.safetensors (the port's writer, with the
    position_ids buffer and pooler of a real BERT export) and a vocab.txt
    with the specials at BERT's positions. Returns the numpy tree."""
    os.makedirs(d, exist_ok=True)
    tree = _tree(np.random.default_rng(seed), shape)
    tensors = weights.to_hf_tensors(weights.params_from_numpy(tree),
                                    BertConfig(**shape))
    H = shape["hidden_size"]
    tensors["embeddings.position_ids"] = np.arange(
        shape["max_position_embeddings"], dtype=np.int64)[None]
    tensors["pooler.dense.weight"] = np.zeros((H, H), np.float32)
    tensors["pooler.dense.bias"] = np.zeros(H, np.float32)
    weights.write_safetensors(tensors, os.path.join(d, "model.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(_hf_config(shape, **config_extra), f)
    vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS)
    vocab += [f"tok{i}" for i in range(shape["vocab_size"] - len(vocab))]
    with open(os.path.join(d, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    return tree


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree.numpy() if torch.is_tensor(tree)
                                    else tree)}


def _assert_trees_bit_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k].view(np.int32),
                                      want[k].view(np.int32), err_msg=k)


def test_hf_tensors_round_trip():
    cfg = BertConfig(**SMALL)
    tree = weights.params_from_numpy(_tree(np.random.default_rng(0), SMALL))
    hf = weights.to_hf_tensors(tree, cfg)
    assert hf["encoder.layer.1.attention.self.key.weight"].shape == (128, 128)
    assert hf["encoder.layer.0.intermediate.dense.weight"].shape == (256, 128)
    _assert_trees_bit_equal(weights.from_hf_tensors(hf, cfg), tree)
    again = weights.to_hf_tensors(weights.from_hf_tensors(hf, cfg), cfg)
    assert sorted(again) == sorted(hf)
    for k in hf:
        np.testing.assert_array_equal(again[k], hf[k])


def test_reference_checkpoint_loads_bit_equal(tmp_path):
    """The reference's init_params + save_safetensors (the `safetensors`
    package) -> the port's load_params == the reference's load_params."""
    ref_cfg = ref_bert.BertConfig(**SMALL)
    params = ref_weights.init_params(jax.random.PRNGKey(3), ref_cfg)
    ref_weights.save_safetensors(params, str(tmp_path / "model.safetensors"),
                                 ref_cfg)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(_hf_config(SMALL), f)
    want, ref_pretrained, _ = ref_weights.load_params(str(tmp_path))
    got, pretrained, cfg = weights.load_params(str(tmp_path))
    assert pretrained and ref_pretrained
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads,
            cfg.intermediate_size, cfg.vocab_size) == (128, 2, 4, 256, 512)
    _assert_trees_bit_equal(got, jax.tree.map(np.asarray, want))


def test_port_checkpoint_loads_in_safetensors(tmp_path):
    st = pytest.importorskip("safetensors.numpy")
    cfg = BertConfig(**SMALL)
    tree = weights.params_from_numpy(_tree(np.random.default_rng(1), SMALL))
    path = str(tmp_path / "model.safetensors")
    weights.save_safetensors(tree, path, cfg)
    got = st.load_file(path)
    want = weights.to_hf_tensors(tree, cfg)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # and the reference's loader reads it into the same tree
    ref_tree = ref_weights.load_safetensors(path, ref_bert.BertConfig(**SMALL))
    _assert_trees_bit_equal(tree, jax.tree.map(np.asarray, ref_tree))


@pytest.mark.parametrize("dtype", ["<f8", "<f4", "<f2", "<i8", "<i4", "<i2",
                                   "i1", "<u8", "<u4", "<u2", "u1", "?"])
def test_every_numpy_dtype_round_trips(tmp_path, dtype):
    a = (np.arange(24).reshape(2, 3, 4) % 7 - 3).astype(dtype)
    path = str(tmp_path / "t.safetensors")
    weights.write_safetensors({"t": a, "scalar": np.float32(2.5)}, path)
    got = weights.read_safetensors(path)
    assert got["t"].dtype == a.dtype and got["t"].shape == a.shape
    np.testing.assert_array_equal(got["t"], a)
    assert got["scalar"].shape == () and float(got["scalar"]) == 2.5
    st = pytest.importorskip("safetensors.numpy")
    np.testing.assert_array_equal(st.load_file(path)["t"], a)


def test_bf16_tensor_is_refused_by_name(tmp_path):
    header = json.dumps({"encoder.w": {"dtype": "BF16", "shape": [2],
                                       "data_offsets": [0, 4]}}).encode()
    path = tmp_path / "bf16.safetensors"
    path.write_bytes(len(header).to_bytes(8, "little") + header + b"\0" * 4)
    with pytest.raises(ValueError, match="'encoder.w' has dtype BF16"):
        weights.read_safetensors(str(path))


@pytest.mark.parametrize("change,match", [
    (dict(hidden_act="gelu_new"), "hidden_act"),
    (dict(model_type="gpt2"), "not a supported encoder family"),
    (dict(num_hidden_layers=1), "layers beyond the configured 1")])
def test_loader_refusals(tmp_path, change, match):
    _write_model_dir(tmp_path, SMALL, seed=2, **change)
    with pytest.raises(ValueError, match=match):
        weights.load_params(str(tmp_path))


def test_roberta_config_loads(tmp_path):
    """model_type="roberta" loads: its pad id 1 and eps 1e-5, BERT's
    tensor names, the tree bit-equal to what was written."""
    tree = _write_model_dir(tmp_path, SMALL, seed=2, model_type="roberta",
                            pad_token_id=1, layer_norm_eps=1e-5)
    params, pretrained, cfg = weights.load_params(str(tmp_path))
    assert pretrained and cfg.model_type == "roberta"
    assert (cfg.pad_token_id, cfg.layer_norm_eps) == (1, 1e-5)
    _assert_trees_bit_equal(params, tree)


def test_compute_policy_survives_config_json(tmp_path):
    """config.json owns the shape; the caller's dtype and routes stay."""
    _write_model_dir(tmp_path, SMALL, seed=3)
    ask = BertConfig(dtype=torch.bfloat16, attn_impl="xla", pool_impl="fused",
                     layer_impl="layer_i8")
    _, pretrained, cfg = weights.load_params(str(tmp_path), cfg=ask)
    assert pretrained and cfg.hidden_size == 128 and cfg.num_layers == 2
    assert (cfg.dtype, cfg.attn_impl, cfg.pool_impl, cfg.layer_impl) == \
        (torch.bfloat16, "xla", "fused", "layer_i8")


def test_no_checkpoint_gives_seeded_weights(tmp_path):
    a, pretrained, cfg = weights.load_params(None, BertConfig(**SMALL), seed=4)
    b, _, _ = weights.load_params(str(tmp_path), BertConfig(**SMALL), seed=4)
    assert not pretrained and cfg.hidden_size == 128
    _assert_trees_bit_equal(a, b)


def _hf_sentence_embeddings(model_dir, texts):
    transformers = pytest.importorskip("transformers")
    tok = transformers.BertTokenizerFast(
        vocab_file=os.path.join(model_dir, "vocab.txt"), do_lower_case=True)
    model = transformers.BertModel.from_pretrained(model_dir).eval()
    enc = tok(texts, padding=True, return_tensors="pt")
    with torch.no_grad():
        out = model(input_ids=enc["input_ids"],
                    attention_mask=enc["attention_mask"],
                    token_type_ids=torch.zeros_like(enc["input_ids"]))
    mask = enc["attention_mask"].unsqueeze(-1).float()
    pooled = (out.last_hidden_state * mask).sum(1) / mask.sum(1).clamp(min=1e-9)
    return torch.nn.functional.normalize(pooled, dim=-1).numpy()


def test_make_encoder_matches_hf_bert(tmp_path):
    """The port's node encoder on a MiniLM-shape checkpoint its own writer
    produced, in f32 on the CPU, against HF transformers' BertModel +
    masked mean-pool + normalize."""
    _write_model_dir(str(tmp_path), MINILM, seed=7)
    enc = make_encoder(Config(device="cpu", model_dir=str(tmp_path),
                              compute_dtype="f32"))
    assert (enc.cfg.vocab_size, enc.cfg.num_layers, enc.dim) == (30522, 6, 384)
    ours = enc.encode(TEXTS)
    theirs = _hf_sentence_embeddings(str(tmp_path), TEXTS)
    assert ours.shape == theirs.shape == (4, 384)
    np.testing.assert_allclose(ours, theirs, atol=2e-5)


def test_make_encoder_refuses_a_mismatched_pad_id(tmp_path):
    _write_model_dir(str(tmp_path), SMALL, seed=8, pad_token_id=1)
    with pytest.raises(ValueError, match="pad id 0 != config.json pad_token_id 1"):
        make_encoder(Config(device="cpu", model_dir=str(tmp_path),
                            seq_buckets=(16, 32)))
