"""ModernBERT (models/modernbert.py) on the port's CPU route, at a small
size with seeded weights: H 64, 4 heads of 16, I 96, 6 layers (two
periods of global, local, local), a window of ±4, S up to 40 with ragged
lengths.

- reference/modernbert_plain.py against HF's ModernBertModel (eager
  attention, the same weights): the last hidden state within 1e-5, so the
  reference is held to the published code;
- the port's CPU route (the plain twins, f32) against the reference: the
  embeddings within 1e-5 (both f32; the port's GELU is the A&S erf
  polynomial, |err| <= 1.5e-7, and its sums run in another order);
- a page alone gives its embedding in a padded batch; the windowed twin is
  full attention masked to the band; the window turned off, the two θ
  swapped and the GeGLU halves swapped each miss the reference by more
  than 100x the bound;
- the weights loader with and without HF's `model.` prefix, from F32 and
  BF16 files; the configs it refuses;
- the encoder's dispatch plan (a 512-token grid exactly as before, a long
  one sorted and cut by padded tokens), which the fused ingest path
  dispatches as planned, its attention spans' real tokens and keys from
  the host lengths, the truncation counters, the prompts, and a node
  serving a ModernBERT model_dir over HTTP.
"""

import dataclasses
import json
import os
import struct
import sys
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from dawnsearch_tpu_torch.config import Config
from dawnsearch_tpu_torch.models import modernbert as M
from dawnsearch_tpu_torch.models.bert import encode_batch
from dawnsearch_tpu_torch.models.weights import config_from_hf, load_params
from dawnsearch_tpu_torch.ops import modernbert as mb

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from reference import modernbert_plain as R  # noqa: E402

torch.set_num_threads(2)
BOUND = 1e-5
HF = dict(vocab_size=300, hidden_size=64, num_hidden_layers=6,
          num_attention_heads=4, intermediate_size=96, local_attention=8,
          max_position_embeddings=64, pad_token_id=0,
          global_rope_theta=160000.0, local_rope_theta=10000.0,
          global_attn_every_n_layers=3, norm_eps=1e-5)
LENS = (40, 17, 3)


def _weights(seed: int = 0) -> dict:
    """HF-named tensors (bare): matrices std 0.3 (so each layer moves the
    state), norm scales 1 + N(0, 0.1)."""
    g = torch.Generator().manual_seed(seed)
    H, I, V = HF["hidden_size"], HF["intermediate_size"], HF["vocab_size"]
    W = {"embeddings.tok_embeddings.weight": torch.randn(V, H, generator=g),
         "embeddings.norm.weight": 1 + 0.1 * torch.randn(H, generator=g),
         "final_norm.weight": 1 + 0.1 * torch.randn(H, generator=g)}
    for i in range(HF["num_hidden_layers"]):
        p = f"layers.{i}."
        for name, shape in (("attn.Wqkv", (3 * H, H)), ("attn.Wo", (H, H)),
                            ("mlp.Wi", (2 * I, H)), ("mlp.Wo", (H, I))):
            W[p + name + ".weight"] = 0.3 * torch.randn(shape, generator=g)
        for norm in (["attn_norm"] if i else []) + ["mlp_norm"]:
            W[p + norm + ".weight"] = 1 + 0.1 * torch.randn(H, generator=g)
    return W


def _batch(seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    S = max(LENS)
    mask = (torch.arange(S)[None] < torch.tensor(LENS)[:, None]).long()
    ids = torch.randint(5, HF["vocab_size"], (len(LENS), S), generator=g)
    return torch.where(mask.bool(), ids, 0), mask


def _port(W, **cfg_over):
    cfg = dataclasses.replace(M.config_from_hf(HF, "test"), **cfg_over)
    params = M.from_hf_tensors({k: v.numpy() for k, v in W.items()}, cfg)
    return M.ModernBertModel(cfg, params, device="cpu")


def _real(t, mask):
    return torch.where(mask.bool()[..., None], t, 0.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_matches_hf(seed):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.ModernBertConfig(**HF, attn_implementation="eager",
                                        reference_compile=False)
    hf = transformers.ModernBertModel(cfg).eval()
    W = _weights(seed)
    hf.load_state_dict(W)
    ids, mask = _batch(seed)
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask).last_hidden_state
    got = R.hidden_states(W, HF, ids, mask)
    assert float((_real(got, mask) - _real(want, mask)).abs().max()) <= BOUND


@pytest.mark.parametrize("seed", [0, 1])
def test_port_cpu_route_matches_reference(seed):
    W = _weights(seed)
    ids, mask = _batch(seed)
    model = _port(W)
    got = model(ids, mask)
    want = R.hidden_states(W, HF, ids, mask)
    assert got.dtype == torch.float32
    assert float((_real(got, mask) - _real(want, mask)).abs().max()) <= 1e-4
    emb = encode_batch(model, ids, mask)
    assert float((emb - R.embed(W, HF, ids, mask)).abs().max()) <= BOUND


def test_a_page_alone_equals_it_in_a_padded_batch():
    W = _weights()
    ids, mask = _batch()
    model = _port(W)
    batch = encode_batch(model, ids, mask)
    for r, n in enumerate(LENS):
        alone = encode_batch(model, ids[r:r + 1, :n], mask[r:r + 1, :n])
        assert float((alone[0] - batch[r]).abs().max()) <= 1e-6


@pytest.mark.parametrize("window", [0, 3, 8, 50])
def test_windowed_twin_is_full_attention_masked_to_the_band(window):
    B, S, nh, hd = 2, 24, 2, 16
    g = torch.Generator().manual_seed(window)
    qkv = torch.randn(B * S, 3 * nh * hd, generator=g)
    lens = torch.tensor([24, 13], dtype=torch.int32)
    got = mb.attention_plain(qkv, lens, B, S, nh, window)
    q, k, v = (t.view(B, S, nh, hd).transpose(1, 2)
               for t in qkv.split(nh * hd, dim=1))
    i = torch.arange(S)
    keep = ((i[None, None] < lens[:, None, None])
            & ((i[:, None] - i[None]).abs() <= window)[None])
    s = (q @ k.transpose(-1, -2)) / hd ** 0.5
    s = s.masked_fill(~keep[:, None], float("-inf"))
    want = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(B * S, -1)
    live = (i[None] < lens[:, None]).reshape(-1)
    assert torch.allclose(got[live], want[live], atol=1e-6)
    assert not got[~live].any()
    assert mb.band_keys(13, window) == int(keep[1, :13].sum())


@pytest.mark.parametrize("fault", ["window", "theta", "ffn_halves"])
def test_planted_faults_miss_the_reference(fault, monkeypatch):
    W = _weights()
    ids, mask = _batch()
    if fault == "window":
        attention = mb.attention
        monkeypatch.setattr(mb, "attention", lambda q, l, B, S, nh, w:
                            attention(q, l, B, S, nh, None))
        model = _port(W)
    elif fault == "theta":
        model = _port(W, global_rope_theta=HF["local_rope_theta"],
                      local_rope_theta=HF["global_rope_theta"])
    else:
        I = HF["intermediate_size"]
        W = dict(W)
        for i in range(HF["num_hidden_layers"]):
            w = W[f"layers.{i}.mlp.Wi.weight"]
            W[f"layers.{i}.mlp.Wi.weight"] = torch.cat((w[I:], w[:I]))
        model = _port(W)
        W = _weights()
    emb = encode_batch(model, ids, mask)
    assert float((emb - R.embed(W, HF, ids, mask)).abs().max()) > 100 * BOUND


def _write_safetensors(tensors: dict, path, bf16: bool) -> None:
    header, blobs, off = {}, [], 0
    for name, t in tensors.items():
        if bf16:
            raw = (t.float().contiguous().view(torch.int32) >> 16).to(
                torch.int16).numpy().tobytes()
        else:
            raw = t.float().contiguous().numpy().tobytes()
        header[name] = {"dtype": "BF16" if bf16 else "F32",
                        "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


def _model_dir(tmp_path, prefix: str = "", bf16: bool = False):
    W = _weights()
    if bf16:
        W = {k: v.bfloat16().float() for k, v in W.items()}
    d = tmp_path / "model"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(dict(
        HF, model_type="modernbert", hidden_activation="gelu")))
    _write_safetensors({prefix + k: v for k, v in W.items()},
                       d / "model.safetensors", bf16)
    return d, W


@pytest.mark.parametrize("prefix,bf16", [("", False), ("model.", False),
                                         ("model.", True)])
def test_loader_reads_hf_names(tmp_path, prefix, bf16):
    d, W = _model_dir(tmp_path, prefix, bf16)
    params, pretrained, cfg = load_params(str(d))
    assert pretrained and cfg.model_type == "modernbert"
    assert (cfg.num_layers, cfg.local_attention) == (6, 8)
    L = params["layers"]
    for i in range(cfg.num_layers):
        for name, hf in M._HF.items():
            assert torch.equal(L[name][i], W[f"layers.{i}.{hf}.weight"].T)
        assert torch.equal(L["ffn_ln_scale"][i],
                           W[f"layers.{i}.mlp_norm.weight"])
        assert torch.equal(L["attn_ln_scale"][i], W[
            f"layers.{i}.attn_norm.weight"] if i else torch.ones(64))
    assert torch.equal(params["embeddings"]["word"],
                       W["embeddings.tok_embeddings.weight"])
    assert torch.equal(params["final_ln_scale"], W["final_norm.weight"])


@pytest.mark.parametrize("bad", [{"attention_bias": True},
                                 {"norm_bias": True},
                                 {"hidden_activation": "silu"}])
def test_config_refuses_what_the_port_does_not_compute(tmp_path, bad):
    (tmp_path / "config.json").write_text(json.dumps(dict(
        HF, model_type="modernbert", **bad)))
    with pytest.raises(ValueError, match="ModernBERT|supported"):
        config_from_hf(str(tmp_path))


def test_card_routes_refuse_f32_and_the_per_op_path():
    cfg = M.config_from_hf(HF, "test")
    with pytest.raises(ValueError, match="bf16"):
        M.route(cfg, "cuda")
    with pytest.raises(ValueError, match="layer_impl"):
        M.route(dataclasses.replace(cfg, layer_impl="ops",
                                    dtype=torch.bfloat16), "cuda")
    assert M.route(cfg, "cpu") == "plain"


class _Tok:
    pad_id, cls_id, sep_id = 0, 1, 2

    def encode(self, text, max_len=None):
        return self.encode_counted(text, max_len)[0]

    def encode_counted(self, text, max_len=None):
        ids = [5 + (hash(w) % 200) for w in text.split()]
        n = len(ids) + 2
        ids = ids if max_len is None else ids[:max_len - 2]
        return [1, *ids, 2], n


def _encoder(buckets, **kw):
    from dawnsearch_tpu_torch.models.encoder import SentenceEncoder
    cfg = dataclasses.replace(M.config_from_hf(
        dict(HF, max_position_embeddings=8192), "t"))
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    return SentenceEncoder(params, _Tok(), cfg=cfg, seq_buckets=buckets,
                           device="cpu", **kw)


def test_dispatch_plan_short_grid_is_unchanged():
    enc = _encoder((16, 32, 64, 128, 256, 512))
    rows = list(range(2500))
    lengths = [int(x) for x in np.random.default_rng(0).integers(3, 512,
                                                                 2500)]
    plan = enc.plan_dispatches(rows, lengths, 1024)
    assert plan == [rows[0:1024], rows[1024:2048], rows[2048:2500]]


def test_dispatch_plan_long_grid_sorts_and_keeps_the_budget():
    from dawnsearch_tpu_torch.models.encoder import TOKEN_BUDGET
    enc = _encoder((16, 64, 512, 1024, 2048, 4096, 8192))
    rng = np.random.default_rng(1)
    lengths = [int(x) for x in np.minimum(8192, rng.lognormal(7.8, 0.9,
                                                              700)) + 2]
    rows = list(range(700))
    plan = enc.plan_dispatches(rows, lengths, 1024)
    assert sorted(r for p in plan for r in p) == rows
    flat = [r for p in plan for r in p]
    assert [lengths[r] for r in flat] == sorted(lengths)
    for p in plan:
        S = enc._bucket(enc.seq_buckets, max(lengths[r] for r in p))
        assert enc._bucket(enc.batch_buckets, len(p)) * S <= TOKEN_BUDGET
    assert any(len(p) == 64 for p in plan)  # 64 pages at S 8,192


def test_fused_ingest_dispatches_the_encoders_plan(monkeypatch):
    """FusedIngestPath.ingest on a long grid dispatches exactly the
    encoder's plan (TOKEN_BUDGET lowered so that it cuts many times, as
    the top batch bucket alone never would) and returns the embeddings in
    input order."""
    from dawnsearch_tpu_torch.index.flat import FlatIndex
    from dawnsearch_tpu_torch.models import encoder as E
    from dawnsearch_tpu_torch.serving.fused import FusedIngestPath
    monkeypatch.setattr(E, "TOKEN_BUDGET", 256)
    enc = _encoder((16, 32, 64, 1024))
    rng = np.random.default_rng(2)
    texts = [" ".join(f"w{j}" for j in rng.integers(0, 999, n))
             for n in rng.integers(1, 60, 24)]
    ids = enc.tokenize_texts(texts)
    plan = enc.plan_dispatches(list(range(len(texts))),
                               [len(i) for i in ids], enc.batch_buckets[-1])
    assert len(plan) > 2
    path = FusedIngestPath(enc, FlatIndex(dim=enc.dim, device="cpu"))
    seen = []
    dispatch = path.dispatch

    def spy(ids_list):
        seen.append(ids_list)
        return dispatch(ids_list)
    monkeypatch.setattr(path, "dispatch", spy)
    emb = path.ingest(texts)
    assert seen == [[ids[r] for r in sub] for sub in plan]
    assert path.index.count == len(texts)
    np.testing.assert_allclose(emb, enc.encode_documents(texts), atol=1e-5)


def test_fused_ingest_spans_carry_the_host_lengths():
    """A ModernBERT encoder through the fused ingest path while spans are
    recorded: each layer's encoder.attn span carries `real` and `keys`
    summed from the batch's host lengths (ops.modernbert.band_keys)."""
    from dawnsearch_tpu_torch.index.flat import FlatIndex
    from dawnsearch_tpu_torch.serving.fused import FusedIngestPath
    from dawnsearch_tpu_torch.utils.logging import SPANS
    enc = _encoder((16, 32, 64, 1024))
    texts = [" ".join(["w"] * n) for n in (40, 17, 3, 9, 25, 1, 60, 12)]
    lengths = [len(i) for i in enc.tokenize_texts(texts)]
    path = FusedIngestPath(enc, FlatIndex(dim=enc.dim, device="cpu"))
    SPANS.start()
    try:
        path.ingest(texts)
    finally:
        SPANS.stop()
        events, _ = SPANS.take()
    args = {}
    for name, *_, a, _ph in events:
        args.setdefault(name, []).append(a)
    # eight pages: one dispatch at batch bucket 8, no padding rows
    assert args["encoder.forward"] == [{"B": 8, "S": 64,
                                        "real": sum(lengths)}]
    attn = args["encoder.attn"]
    assert [a["kind"] for a in attn] == [
        "global" if enc.model.is_global(i) else "local"
        for i in range(HF["num_hidden_layers"])]
    for a in attn:
        window = None if a["kind"] == "global" else a["window"]
        assert a["real"] == sum(lengths)
        assert a["keys"] == sum(mb.band_keys(n, window) for n in lengths)


def test_truncation_counters_and_prompts():
    from dawnsearch_tpu_torch.utils.logging import METRICS
    enc = _encoder((16, 32), document_prompt="d: ", query_prompt="q: ")
    before = METRICS.snapshot()
    ids = enc.tokenize_texts(["a " * 40, "b c"], "d: ")
    assert [len(i) for i in ids] == [32, 5]
    after = METRICS.snapshot()
    for name, want in (("encoder_texts_truncated", 1),
                       ("encoder_tokens_truncated", 43 - 32)):
        assert after[name] - before.get(name, 0) == want
    assert not np.allclose(enc.encode(["b c"]), enc.encode_documents(["b c"]))


def _http(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _tokenizer_json(path) -> None:
    """A byte-level BPE tokenizer.json of 300 ids: bytes, merges for a
    space and a few words, [CLS] 297 / [SEP] 298 / [PAD] 0 as specials."""
    from dawnsearch_tpu_torch.models.tokenizer_bpe import byte_to_unicode
    b2u = byte_to_unicode()
    vocab = {b2u[b]: b + 1 for b in range(256)}
    merges = []
    for w in ("the", "cat", "dog", "sat", "on", "mat", "log", "ran"):
        prev = b2u[32]
        for ch in w:
            if prev + ch not in vocab:
                merges.append(f"{prev} {ch}")
                vocab[prev + ch] = len(vocab) + 1
            prev += ch
    added = [{"id": 0, "content": "[PAD]", "special": True},
             {"id": 296, "content": "[UNK]", "special": True},
             {"id": 297, "content": "[CLS]", "special": True},
             {"id": 298, "content": "[SEP]", "special": True}]
    path.write_text(json.dumps({
        "added_tokens": added, "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "[SEP]", "type_id": 0}}],
            "special_tokens": {"[CLS]": {"id": "[CLS]", "ids": [297]},
                               "[SEP]": {"id": "[SEP]", "ids": [298]}}},
        "model": {"type": "BPE", "vocab": vocab, "merges": merges}}))


def test_node_serves_a_modernbert_model_dir(tmp_path):
    """A node on a model_dir of config.json (model_type modernbert),
    model.safetensors (BF16) and tokenizer.json, with the prompts set:
    make_encoder builds ModernBertModel and the tokenizer.json BPE, and an
    inserted page comes back at rank 1 for its own text."""
    from dawnsearch_tpu_torch.node import DawnNode
    d, _ = _model_dir(tmp_path, "model.", bf16=True)
    _tokenizer_json(d / "tokenizer.json")
    cfg = Config(device="cpu", web=True, web_listen_address="127.0.0.1:0",
                 accept_insert=True, data_dir=str(tmp_path / "data"),
                 model_dir=str(d), compute_dtype="f32",
                 seq_buckets=(16, 32, 64), document_prompt="the dog: ",
                 query_prompt="the cat: ")
    texts = ["the cat sat on the mat " * (k + 1) + "ran" * k
             for k in range(6)] + ["dog log ran " * 5, "mat on log sat"]
    node = DawnNode(cfg).start()
    try:
        assert isinstance(node.encoder.model, M.ModernBertModel)
        assert node.encoder.tokenizer.cls_id == 297
        base = f"http://127.0.0.1:{node.http_port}"
        pages = [{"url": f"https://m/{i}", "title": "", "text": t}
                 for i, t in enumerate(texts)]
        assert len(_http(base + "/api/insert",
                         {"pages": pages})["inserted"]) == len(texts)
        got = _http(base + "/api/search?q=" + urllib.parse.quote(texts[6]))
        assert got["results"][0]["url"] == "https://m/6"
    finally:
        node.stop()


def test_ingest_text_cap_is_a_setting(tmp_path):
    """iter_pages keeps `max_text` characters of a page's text and counts
    the pages it cut (Stages.truncated, ingest_text_truncated)."""
    from dawnsearch_tpu_torch.ingest.pages import Stages, iter_pages
    from dawnsearch_tpu_torch.ingest.warc import write_warc
    text = " ".join(f"word{i % 97} and more" for i in range(2000))
    html = ("<html><head><title>t</title></head><body><article><p>" + text
            + "</p></article></body></html>").encode()
    path = str(tmp_path / "x.warc.gz")
    write_warc(path, [("https://x/1", html)])
    for cap, cut in ((2048, 1), (65536, 0)):
        st = Stages()
        pages = list(iter_pages(path, st, max_text=cap))
        assert len(pages) == 1 and pages[0].text == text[:cap]
        assert st.truncated == cut
