"""Weights-drop quality gate: one command between "real weights arrived
in model_dir" and "retrieval quality verified".

Port of the reference package's examples/eval_quality.py, run on this
package's encoder and index:

    python -m dawnsearch_tpu_torch eval-quality /path/to/all-MiniLM-L6-v2

The encoder runs on the config's device (DAWNSEARCH_DEVICE, default
"cuda"). Stages (each prints a JSON line; the exit
code is 1 on a failure):
 1. parity    — our encoder vs the HF transformers pipeline on the same
                checkpoint (masked mean-pool + L2 normalize), max
                cosine deviation <= 1e-3 (skipped without transformers,
                which only this stage imports).
 2. separation — built-in labeled set: paraphrase-pair cosine must beat
                unrelated-pair cosine by a margin (gate: mean margin
                >= 0.2).
 3. retrieval — embed the corpus into the serving-default i8 FlatIndex
                and query with the paraphrases; recall@1 >= 0.9,
                recall@3 >= 0.97.

--allow-random skips the semantic gates (2, 3) so the harness itself
can be smoke-tested against a checkpoint of random weights.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

# Original labeled set: (query, paraphrase) pairs across distinct
# topics — every non-partner sentence is a distractor for retrieval.
PAIRS: list[tuple[str, str]] = [
    ("how do I fix a flat bicycle tire",
     "repairing a punctured bike wheel"),
    ("best way to cook rice on a stove",
     "preparing rice in a pot over heat"),
    ("the weather forecast says rain tomorrow",
     "meteorologists predict showers for the next day"),
    ("my laptop battery drains too quickly",
     "notebook computer loses charge fast"),
    ("planting tomatoes in early spring",
     "when to sow tomato seedlings in the garden"),
    ("the stock market fell sharply today",
     "share prices dropped steeply this session"),
    ("teaching a dog to sit and stay",
     "training your puppy basic obedience commands"),
    ("symptoms of the common cold include coughing",
     "a runny nose and cough are signs of a cold"),
    ("the train to the airport leaves at noon",
     "the airport express departs at twelve"),
    ("installing a ceiling fan safely",
     "how to mount a fan on the ceiling without risk"),
    ("ancient Rome built roads across Europe",
     "the Roman empire constructed a continental road network"),
    ("saving money on monthly groceries",
     "cutting your food shopping budget"),
    ("the movie begins with a car chase",
     "the film opens on a high-speed pursuit"),
    ("whales migrate thousands of miles each year",
     "the annual long-distance journey of whales"),
    ("learning to play the guitar as an adult",
     "picking up guitar lessons later in life"),
    ("the bridge was closed for repairs",
     "maintenance work shut down the bridge"),
]

PARITY_TEXTS = [
    "The quick brown fox jumps over the lazy dog",
    "a distributed semantic search engine",
    "hello world",
    "Sentence embeddings map text to vectors.",
]


def log(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def hf_embed(model_dir: str, texts: list[str]) -> np.ndarray | None:
    """The sentence-transformers recipe via raw HF transformers
    (tokenize -> AutoModel -> masked mean-pool -> L2 normalize), the
    pipeline the reference implements in candle
    (embedding_service.rs:97-139). None without transformers, which is
    imported here only."""
    import torch
    try:
        from transformers import AutoModel, AutoTokenizer
    except Exception:
        return None
    tok = AutoTokenizer.from_pretrained(model_dir)
    # AutoModel follows config.json's model_type — the same dispatch
    # make_encoder does (BERT/MiniLM and MPNet families)
    model = AutoModel.from_pretrained(model_dir)
    model.eval()
    with torch.no_grad():
        batch = tok(texts, padding=True, truncation=True, max_length=256,
                    return_tensors="pt")
        out = model(**batch).last_hidden_state
        mask = batch["attention_mask"].unsqueeze(-1).float()
        emb = (out * mask).sum(1) / mask.sum(1).clamp(min=1e-9)
        emb = torch.nn.functional.normalize(emb, dim=1)
    return emb.numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dawnsearch_tpu_torch eval-quality")
    ap.add_argument("model_dir", help="HF checkpoint dir "
                    "(config.json + model.safetensors + vocab.txt)")
    ap.add_argument("--allow-random", action="store_true",
                    help="skip semantic gates (harness smoke test "
                    "against synthesized weights)")
    ap.add_argument("--parity-tol", type=float, default=1e-3)
    args = ap.parse_args(argv)

    from dawnsearch_tpu_torch.config import Config
    from dawnsearch_tpu_torch.index.flat import FlatIndex
    from dawnsearch_tpu_torch.node import check_config, make_encoder

    cfg = Config.load(None)
    cfg.model_dir = args.model_dir
    check_config(cfg)
    enc = make_encoder(cfg)
    failures = 0

    # -- 1. parity ---------------------------------------------------------
    ours = np.asarray(enc.encode(PARITY_TEXTS), np.float32)
    ref = hf_embed(args.model_dir, PARITY_TEXTS)
    if ref is None:
        log({"stage": "parity", "status": "skipped",
             "reason": "transformers unavailable"})
    else:
        # cosine deviation per text (embeddings are unit vectors)
        dev = 1.0 - np.sum(ours * ref, axis=1)
        ok = bool(np.max(dev) <= args.parity_tol)
        log({"stage": "parity", "status": "ok" if ok else "FAIL",
             "max_cos_deviation": float(np.max(dev)),
             "tol": args.parity_tol})
        if not ok:
            failures += 1

    # -- 2. separation -----------------------------------------------------
    queries = [q for q, _ in PAIRS]
    partners = [p for _, p in PAIRS]
    qe = np.asarray(enc.encode(queries), np.float32)
    pe = np.asarray(enc.encode(partners), np.float32)
    pos = np.sum(qe * pe, axis=1)                      # (N,) pair cosine
    cross = qe @ pe.T                                  # (N, N)
    neg = (cross.sum(axis=1) - pos) / (len(PAIRS) - 1)  # mean distractor
    margin = float(np.mean(pos - neg))
    sep_ok = margin >= 0.2
    log({"stage": "separation", "status": ("ok" if sep_ok else
         ("skipped(random)" if args.allow_random else "FAIL")),
         "mean_pair_cos": round(float(pos.mean()), 4),
         "mean_distractor_cos": round(float(neg.mean()), 4),
         "mean_margin": round(margin, 4), "gate": 0.2})
    if not sep_ok and not args.allow_random:
        failures += 1

    # -- 3. retrieval through the serving-default index --------------------
    ix = FlatIndex(dim=qe.shape[1], dtype="i8", device=cfg.device)
    ix.add(pe)
    d, ids = ix.search(qe, k=3)
    want = np.arange(len(PAIRS))
    r1 = float(np.mean(ids[:, 0] == want))
    r3 = float(np.mean([w in row for w, row in zip(want, ids)]))
    ret_ok = r1 >= 0.9 and r3 >= 0.97
    log({"stage": "retrieval", "status": ("ok" if ret_ok else
         ("skipped(random)" if args.allow_random else "FAIL")),
         "recall_at_1": r1, "recall_at_3": r3,
         "gates": [0.9, 0.97], "index_dtype": "i8"})
    if not ret_ok and not args.allow_random:
        failures += 1

    log({"stage": "summary",
         "status": "ok" if failures == 0 else "FAIL",
         "failures": failures,
         "semantic_gates": "skipped" if args.allow_random else "enforced"})
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
