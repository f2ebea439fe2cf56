"""Each generator gives the same inputs for one seed and other inputs for
another, and every seed sends the same sizes and arrivals in its own
order."""

import numpy as np
import torch

from benchmark import seeds, spec, store, texts, warc, weights
from benchmark.kinds import warc_ingest
from benchmark.tests.conftest import SHARE, TINY_CONFIG, TRAFFIC


def test_query_pool():
    a = texts.query_pool(seeds.rng(1, seeds.QUERIES), 2000, SHARE)
    b = texts.query_pool(seeds.rng(1, seeds.QUERIES), 2000, SHARE)
    c = texts.query_pool(seeds.rng(2, seeds.QUERIES), 2000, SHARE)
    assert a == b and a != c and len(set(a)) == 2000
    lengths = lambda p: sorted(len(q.split()) for q in p)  # noqa: E731
    assert lengths(a) == lengths(c)
    assert 2.8 < np.mean(lengths(a)) < 3.3 and max(lengths(a)) <= 12


def test_zipf_and_poisson():
    z1 = texts.zipf_ranks(seeds.rng(1, 4), 5000, 16384, 0.8)
    z2 = texts.zipf_ranks(seeds.rng(2, 4), 5000, 16384, 0.8)
    assert not np.array_equal(z1, z2)
    assert np.array_equal(np.sort(z1), np.sort(z2))
    assert (z1 == 0).sum() > (z1 == 100).sum()
    d1 = texts.poisson_due(seeds.rng(1, 4), 4000, 400.0)
    d2 = texts.poisson_due(seeds.rng(2, 4), 4000, 400.0)
    assert not np.array_equal(d1, d2) and np.all(np.diff(d1) > 0)
    mean = np.mean(-np.log1p(-(np.arange(4000) + 0.5) / 4000) / 400.0)
    gaps = [np.sort(np.r_[d[0] + mean, np.diff(d)]) for d in (d1, d2)]
    assert np.allclose(gaps[0], gaps[1])
    assert abs(d1[-1] - 10.0) < 0.05  # 4000 arrivals at 400/s span 10 s


MIX = {k: TRAFFIC["tiny-ingest"][k] for k in warc_ingest.PAGE_KEYS}


def test_pages():
    a, b, c = (texts.Pages(s, 300, **MIX) for s in (1, 1, 2))
    assert [a.html(i) for i in range(300)] == [b.html(i) for i in range(300)]
    assert a.html(5) != c.html(5)
    urls = {a.url(i) for i in range(300)}
    assert len(urls) == 300 and all(texts.Pages.index_of(a.url(i)) == i
                                    for i in range(300))
    # every seed deals out the same lengths, sizes and languages
    for key in ("lengths", "sizes", "lang"):
        assert np.array_equal(np.sort(getattr(a, key)),
                              np.sort(getattr(c, key)))
        assert not np.array_equal(getattr(a, key), getattr(c, key))
    assert abs(np.mean(a.lang == 0) - 0.45) < 0.01
    real = spec.traffic("warc-ingest")  # the committed mix's sizes
    d = texts.Pages(1, 400, **{k: real[k] for k in warc_ingest.PAGE_KEYS})
    size = np.mean([len(d.html(i).encode()) for i in range(400)])
    assert 0.95 < size / real["html_mean_bytes"] < 1.05
    kept = a.kept()
    assert all(len(a.stored(i)[2]) >= texts.MIN_CLEAN_TEXT
               for i in np.flatnonzero(kept))


def test_pages_as_the_node_keeps_them(tmp_path):
    """The port's own WARC reader, extractor and filters keep exactly the
    pages that Pages.kept() names, each as Pages.stored() has it."""
    from dawnsearch_tpu_torch.ingest.pages import iter_pages
    pages = texts.Pages(7, 400, **MIX)
    path = str(tmp_path / "t.warc.gz")
    warc.write(path, pages, range(400))
    got = list(iter_pages(path))
    want = np.flatnonzero(pages.kept()).tolist()
    assert [texts.Pages.index_of(p.url) for p in got] == want
    assert all((p.url, p.title, p.text) == pages.stored(
        texts.Pages.index_of(p.url)) for p in got)
    assert len(set(pages.lang[want])) == 1 and len(set(pages.lang)) == 5


def test_weights_and_store():
    cfg = TINY_CONFIG
    w1 = weights.make(cfg, 5, "cpu")
    w2 = weights.make(cfg, 5, "cpu")
    w3 = weights.make(cfg, 6, "cpu")
    name = "encoder.layer.1.output.dense.weight"
    assert torch.equal(w1[name], w2[name]) and not torch.equal(w1[name],
                                                               w3[name])
    assert torch.equal(w1[name], w1[name].bfloat16().float())
    anchors = torch.nn.functional.normalize(torch.randn(10, 128), dim=1)
    r1 = store.planted(500, anchors, 8, 0.9, 0.99, 3, "cpu")
    r2 = store.planted(500, anchors, 8, 0.9, 0.99, 3, "cpu")
    assert torch.equal(r1, r2)
    cos = (r1 @ anchors.T).max(0).values
    assert torch.all(cos > 0.9 - 1e-5)
    assert torch.allclose(r1.norm(dim=1), torch.ones(500), atol=1e-5)
    best = torch.topk(r1 @ anchors.T, 8, dim=0).values
    assert torch.all(best >= 0.9 - 1e-5) and torch.all(best <= 0.99 + 1e-5)
