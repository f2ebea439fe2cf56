"""The port's native WordPiece tokenizer and its library loader.

The port's NativeWordPieceTokenizer (native/tokenizer.cpp, built by
utils/nativelib.py with g++) against the reference: its ids equal the
reference's pure-Python WordPieceTokenizer's and the reference's native
tokenizer's on tests/test_tokenizer_native.py's CORPUS + TRICKY cases, with
truncation at several max_len, over a seeded fuzz and through encode_batch.
Also: one handle shared by many threads gives each text its ids; a cased
vocab keeps the Python tokenizer; the port's node tokenizes natively and
says so in its log; the library's build key follows its sources; a build
that fails is reported with the compiler's message and the Python
tokenizer takes over; the checked-in unicode_tables.h is what
gen_unicode_tables.py writes here.
"""

import logging
import os
import random
import subprocess
import sys
import threading

import pytest

from dawnsearch_tpu.models import tokenizer_native as ref_tn
from dawnsearch_tpu.models.tokenizer import WordPieceTokenizer as RefTokenizer
from dawnsearch_tpu_torch.config import Config
from dawnsearch_tpu_torch.models import tokenizer_native as tn
from dawnsearch_tpu_torch.models.tokenizer import (WordPieceTokenizer,
                                                   build_vocab_from_corpus,
                                                   read_vocab)
from dawnsearch_tpu_torch.node import make_encoder
from dawnsearch_tpu_torch.utils import nativelib
from tests.test_tokenizer_native import CORPUS, TRICKY

FUZZ_ALPHABET = ("abcdefghij .,!?-'\"0123456789"
                 "éüñ中日¡«—​\tZQ")


def _fuzz(seed: int, n: int = 200) -> list[str]:
    rng = random.Random(seed)
    return ["".join(rng.choice(FUZZ_ALPHABET) for _ in range(rng.randrange(80)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def vocab():
    return build_vocab_from_corpus(CORPUS + TRICKY, size=8000)


@pytest.fixture(scope="module")
def port(vocab):
    return tn.NativeWordPieceTokenizer(vocab)


@pytest.fixture(scope="module")
def ref(vocab):
    return RefTokenizer(vocab)


@pytest.mark.parametrize("text", CORPUS + TRICKY)
def test_encode_matches_reference(port, ref, vocab, text):
    assert port.encode(text) == ref.encode(text), text
    assert port.encode(text) == ref_tn.NativeWordPieceTokenizer(vocab).encode(
        text), text


@pytest.mark.parametrize("max_len", [2, 4, 8, 16, 64, 512])
def test_truncation_matches_reference(port, ref, max_len):
    text = " ".join(CORPUS + TRICKY) * 6
    got = port.encode(text, max_len=max_len)
    assert got == ref.encode(text, max_len=max_len)
    assert len(got) == max_len and got[-1] == port.sep_id


@pytest.mark.parametrize("seed", [0, 1])
def test_fuzz_matches_reference(port, ref, seed):
    for text in _fuzz(seed):
        assert port.encode(text, max_len=32) == ref.encode(text, max_len=32), \
            repr(text)


@pytest.mark.parametrize("native", [False, True])
def test_encode_counted_gives_the_cut_ids_and_the_uncut_length(port, vocab,
                                                               native):
    tok = port if native else WordPieceTokenizer(vocab)
    for text in _fuzz(2, 40) + [" ".join(CORPUS + TRICKY) * 6]:
        whole = len(tok.encode(text))
        for max_len in (2, 8, 32, 512):
            ids, n = tok.encode_counted(text, max_len)
            assert ids == tok.encode(text, max_len=max_len), repr(text)
            assert n == whole


def test_encode_batch_matches_reference(port, ref):
    assert port.encode_batch(CORPUS + TRICKY, seq_len=24) == \
        ref.encode_batch(CORPUS + TRICKY, seq_len=24)


def test_specials_match_the_python_tokenizer(port, vocab):
    py = WordPieceTokenizer(vocab)
    assert (port.pad_id, port.unk_id, port.cls_id, port.sep_id) == \
        (py.pad_id, py.unk_id, py.cls_id, py.sep_id)


def test_one_handle_serves_many_threads(port, ref):
    """The batcher and ingest threads share one tokenizer: 16 threads
    encode the same texts through one handle, each gets the reference's
    ids (the C++ encode is const; a data race would garble ids)."""
    texts = _fuzz(2, n=100) + CORPUS + TRICKY
    want = [ref.encode(t, max_len=64) for t in texts]
    errors: list = []

    def work(k: int):
        for _ in range(5):
            for j in range(len(texts)):
                i = (j + k) % len(texts)
                if port.encode(texts[i], max_len=64) != want[i]:
                    errors.append(texts[i])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


def test_best_tokenizer_is_native_for_a_lowercase_vocab_only(vocab):
    assert isinstance(tn.best_tokenizer(vocab), tn.NativeWordPieceTokenizer)
    cased = tn.best_tokenizer(vocab, lowercase=False)
    assert type(cased) is WordPieceTokenizer and not cased.lowercase
    with pytest.raises(ValueError, match="lowercase-only"):
        tn.NativeWordPieceTokenizer(vocab, lowercase=False)


def test_vocab_file_loads_into_the_native_tokenizer(tmp_path, vocab):
    path = str(tmp_path / "vocab.txt")
    WordPieceTokenizer(vocab).save_vocab(path)
    assert read_vocab(path) == vocab
    assert tn.NativeWordPieceTokenizer.from_vocab_file(path).encode(
        CORPUS[3]) == WordPieceTokenizer(vocab).encode(CORPUS[3])


def test_node_tokenizes_natively_and_logs_it(caplog):
    """make_encoder takes the native tokenizer for the node's lowercase
    vocab and names its class on the "encoder ready" line."""
    with caplog.at_level(logging.INFO, logger="dawnsearch"):
        enc = make_encoder(Config(device="cpu", seq_buckets=(16, 32)))
    assert isinstance(enc.tokenizer, tn.NativeWordPieceTokenizer)
    ready = [r.getMessage() for r in caplog.records
             if "encoder ready" in r.getMessage()]
    assert len(ready) == 1 and "tokenizer=NativeWordPieceTokenizer)" in ready[0]
    py = WordPieceTokenizer(enc.tokenizer.vocab)
    assert enc.tokenize_texts(CORPUS) == [py.encode(t, max_len=32)
                                          for t in CORPUS]


def _source_tree(dest, edit: str | None = None) -> str:
    """A copy of native/'s sources in dest (optionally with `edit`
    appended to tokenizer.cpp)."""
    src = dest / "native"
    src.mkdir(parents=True)
    for name in os.listdir(nativelib.SRC_DIR):
        if name.endswith((".cpp", ".h")):
            data = open(os.path.join(nativelib.SRC_DIR, name), "rb").read()
            if edit and name == "tokenizer.cpp":
                data += edit.encode()
            (src / name).write_bytes(data)
    return str(src)


def test_build_key_follows_the_sources(tmp_path, monkeypatch):
    same = nativelib.library_path()
    monkeypatch.setattr(nativelib, "SRC_DIR", _source_tree(tmp_path / "a"))
    assert nativelib.library_path().endswith(os.path.basename(same))
    monkeypatch.setattr(nativelib, "SRC_DIR", _source_tree(
        tmp_path / "b", edit="\n// an edit\n"))
    assert os.path.basename(nativelib.library_path()) != os.path.basename(same)


def test_failed_build_is_reported_and_python_takes_over(tmp_path, monkeypatch,
                                                        vocab, caplog):
    """A source g++ refuses: get() returns None, logs the compiler's
    message, build_error() keeps it, best_tokenizer gives the Python
    tokenizer, and the native tokenizer refuses to construct."""
    monkeypatch.setattr(nativelib, "SRC_DIR", _source_tree(
        tmp_path, edit="\nint broken_on_purpose = ;\n"))
    monkeypatch.setattr(nativelib, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(nativelib, "_lib", None)
    monkeypatch.setattr(nativelib, "_tried", False)
    monkeypatch.setattr(nativelib, "_error", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        nativelib.build()
    with caplog.at_level(logging.WARNING, logger="dawnsearch"):
        assert nativelib.get() is None
    assert "broken_on_purpose" in nativelib.build_error()
    assert any("broken_on_purpose" in r.getMessage() for r in caplog.records)
    assert type(tn.best_tokenizer(vocab)) is WordPieceTokenizer
    with pytest.raises(RuntimeError, match="broken_on_purpose"):
        tn.NativeWordPieceTokenizer(vocab)
    assert not [f for f in os.listdir(tmp_path / "_build")
                if f.endswith((".so", ".tmp"))]


def test_unicode_tables_are_what_the_generator_writes():
    """native/unicode_tables.h is checked in as generated, never rebuilt
    (the generator needs `regex`); here, where `regex` is installed, the
    generator's output must equal it byte for byte."""
    pytest.importorskip("regex")
    gen = os.path.join(nativelib.SRC_DIR, "gen_unicode_tables.py")
    out = subprocess.run([sys.executable, gen], capture_output=True,
                         timeout=300, check=True).stdout
    with open(os.path.join(nativelib.SRC_DIR, "unicode_tables.h"), "rb") as f:
        assert out == f.read()
