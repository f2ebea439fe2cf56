"""The port's byte-level BPE tokenizers (Python and native) vs the reference.

- the port's train_bpe gives the reference's vocab and merges on
  tests/test_bpe_tokenizer.py's CORPUS;
- the port's ByteLevelBPETokenizer and NativeByteLevelBPETokenizer
  (native/bpe.cpp) give the reference's Python BPE ids on
  tests/test_bpe_native.py's cases (every pre-tokenizer alternation,
  mixed scripts, random codepoints), with truncation down to max_len = 0,
  and through encode_batch; the native one drops unpaired surrogates;
- one native handle (whose merge cache is mutex-guarded) serves many
  threads;
- best_bpe_tokenizer prefers the native tokenizer, and without the
  library and without `regex` it raises at once, naming both;
- chip_smoke.py's RoBERTa vocab (built by construction, no `regex`) loads
  into the port's Python and native BPE and the reference's with the same
  ids on the smoke texts;
- no module of the port, and not chip_smoke.py, imports `regex`, `jax` or
  the reference when it is imported.
"""

import os
import random
import subprocess
import sys
import threading

import pytest

import chip_smoke
from dawnsearch_tpu.models import tokenizer_bpe as ref_bpe
from dawnsearch_tpu_torch.models import tokenizer_bpe as bpe
from dawnsearch_tpu_torch.models import tokenizer_bpe_native as nat
from dawnsearch_tpu_torch.utils import nativelib
from tests.test_bpe_native import CORPUS as NATIVE_CORPUS
from tests.test_bpe_native import TEXTS
from tests.test_bpe_tokenizer import CORPUS

POOLS = ["abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ",
         "0123456789½²①", " \t\n\r  　", "!?.,;:'\"-_()[]{}$%&…",
         "éüñßçàø東京中文камніهل🚀☃"]


def _mixed(seed: int, n: int = 200) -> list[str]:
    rng = random.Random(seed)
    return ["".join(rng.choice(rng.choice(POOLS))
                    for _ in range(rng.randrange(40))) for _ in range(n)]


def _codepoints(seed: int, n: int = 200) -> list[str]:
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        chars: list[str] = []
        target = rng.randrange(24)
        while len(chars) < target:
            cp = rng.randrange(1, 0x110000)
            if not 0xD800 <= cp <= 0xDFFF:
                chars.append(chr(cp))
        out.append("".join(chars))
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The reference's trainer on test_bpe_native.py's corpus, saved in
    the HF layout; every tokenizer below loads these files."""
    d = tmp_path_factory.mktemp("bpe")
    return ref_bpe.train_bpe(NATIVE_CORPUS, size=600).save(str(d))


@pytest.fixture(scope="module")
def ref(files):
    return ref_bpe.ByteLevelBPETokenizer.from_files(*files)


@pytest.fixture(scope="module", params=["python", "native"])
def port(request, files):
    cls = {"python": bpe.ByteLevelBPETokenizer,
           "native": nat.NativeByteLevelBPETokenizer}[request.param]
    return cls.from_files(*files)


@pytest.mark.parametrize("size", [300, 600])
def test_train_bpe_matches_reference(size):
    got, want = bpe.train_bpe(CORPUS, size=size), ref_bpe.train_bpe(
        CORPUS, size=size)
    assert got.vocab == want.vocab
    assert got.ranks == want.ranks
    assert len(got.vocab) <= size


def test_byte_table_matches_reference():
    assert bpe.byte_to_unicode() == ref_bpe.byte_to_unicode()
    assert bpe.unicode_to_byte() == ref_bpe.unicode_to_byte()


def test_specials_match_reference(port, ref):
    assert (port.pad_id, port.unk_id, port.cls_id, port.sep_id) == \
        (ref.pad_id, ref.unk_id, ref.cls_id, ref.sep_id)


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_encode_matches_reference(port, ref, i):
    assert port.encode(TEXTS[i], max_len=512) == ref.encode(TEXTS[i],
                                                            max_len=512)


@pytest.mark.parametrize("max_len", [0, 1, 2, 3, 8, 16, 128, None])
def test_truncation_matches_reference(port, ref, max_len):
    text = "the quick brown fox jumps over the lazy dog " * 10
    got = port.encode(text, max_len=max_len)
    assert got == ref.encode(text, max_len=max_len)
    assert got[0] == ref.cls_id and got[-1] == ref.sep_id


def test_encode_batch_matches_reference(port, ref):
    assert port.encode_batch(TEXTS, 64) == ref.encode_batch(TEXTS, 64)


@pytest.mark.parametrize("seed", [0, 1])
def test_fuzz_mixed_scripts(port, ref, seed):
    for s in _mixed(seed):
        assert port.encode(s, max_len=128) == ref.encode(s, max_len=128), \
            repr(s)


@pytest.mark.parametrize("seed", [1, 2])
def test_fuzz_random_codepoints(port, ref, seed):
    """Arbitrary non-surrogate codepoints: every segment of the \\p{L} /
    \\p{N} / \\s table generated from `regex`."""
    for s in _codepoints(seed):
        assert port.encode(s, max_len=128) == ref.encode(s, max_len=128), \
            repr(s)


def test_native_drops_unpaired_surrogates(files):
    tok = nat.NativeByteLevelBPETokenizer.from_files(*files)
    assert tok.encode("abc\ud800def", max_len=32) == tok.encode("abcdef",
                                                                 max_len=32)


def test_one_native_handle_serves_many_threads(files, ref):
    """16 threads share one native handle, whose merge cache is filled
    and read under its mutex; each text keeps the reference's ids."""
    tok = nat.NativeByteLevelBPETokenizer.from_files(*files)
    texts = _mixed(3, n=100) + TEXTS
    want = [ref.encode(t, max_len=64) for t in texts]
    errors: list = []

    def work(k: int):
        for _ in range(5):
            for j in range(len(texts)):
                i = (j + k) % len(texts)
                if tok.encode(texts[i], max_len=64) != want[i]:
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


def test_best_bpe_tokenizer_prefers_native(files, ref):
    tok = nat.best_bpe_tokenizer(*files)
    assert isinstance(tok, nat.NativeByteLevelBPETokenizer)
    assert tok.encode("a quick test", max_len=32) == ref.encode(
        "a quick test", max_len=32)


def test_best_bpe_tokenizer_without_library_or_regex_raises(files,
                                                            monkeypatch):
    """Without the library the Python twin takes over where `regex` is
    installed; where it is not, start-up fails naming both causes (the
    Python twin would fail only at its first text)."""
    monkeypatch.setattr(nativelib, "_lib", None)
    monkeypatch.setattr(nativelib, "_tried", True)
    monkeypatch.setattr(nativelib, "_error", "g++ failed (1): no compiler")
    tok = nat.best_bpe_tokenizer(*files)
    assert type(tok) is bpe.ByteLevelBPETokenizer
    real = nat.importlib.util.find_spec
    monkeypatch.setattr(nat.importlib.util, "find_spec",
                        lambda name, *a: None if name == "regex"
                        else real(name, *a))
    with pytest.raises(RuntimeError, match="no compiler.*`regex`"):
        nat.best_bpe_tokenizer(*files)


def test_smoke_vocab_gives_the_references_ids(tmp_path):
    """chip_smoke.py's RoBERTa vocab and merges (by construction: the card
    has no `regex`) in the HF layout: the port's Python and native BPE and
    the reference's Python BPE give the same ids on the smoke texts, each
    word after a space one token, none <unk>."""
    files = bpe.ByteLevelBPETokenizer(*chip_smoke.bpe_vocab(
        chip_smoke.TEXTS)).save(str(tmp_path))
    ref = ref_bpe.ByteLevelBPETokenizer.from_files(*files)
    py = bpe.ByteLevelBPETokenizer.from_files(*files)
    cc = nat.NativeByteLevelBPETokenizer.from_files(*files)
    assert (ref.pad_id, ref.cls_id, ref.sep_id, ref.unk_id) == (1, 0, 2, 3)
    assert ref.vocab["<mask>"] == len(ref.vocab) - 1
    for text in chip_smoke.TEXTS:
        want = ref.encode(text, max_len=512)
        assert py.encode(text, max_len=512) == want
        assert cc.encode(text, max_len=512) == want
        words = text.split(" ")
        pieces = [ref.inv_vocab[i] for i in want[1:-1]]
        n = len(pieces) - (len(words) - 1)
        assert "".join(pieces[:n]) == words[0]
        assert pieces[n:] == ["\u0120" + w for w in words[1:]]
    with pytest.raises(ValueError, match="single spaces"):
        chip_smoke.bpe_vocab(["Two  spaces"])


def test_port_and_smoke_script_import_no_regex_jax_or_reference():
    code = ("import importlib, pkgutil, sys\n"
            "import dawnsearch_tpu_torch as p\n"
            "import chip_smoke\n"
            "mods = [m.name for m in pkgutil.walk_packages(\n"
            "    p.__path__, p.__name__ + '.')]\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('regex', 'jax', 'jaxlib', 'dawnsearch_tpu'))\n"
            "print(len(mods), bad)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) > 20 and bad.strip() == "[]", out.stdout
