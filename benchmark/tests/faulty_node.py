"""The port's node with one fault planted where its answers are made,
picked by BENCH_FAULT; a CPU test runs a cell on it and sees `correct`
come out false.

- `answer`: the first result of every query has its distance altered.
- `half`: each query batch answers its second half with the first half's
  results (half the batch left out).
- `embedding`: every stored page embedding is turned a little.
- `text`: every stored page text loses its last word.
- `lang`: the English filter keeps every page. It runs in the spawned
  extraction workers, which import this module again, so it is planted
  at import.
"""

import os
import sys

import numpy as np

if os.environ.get("BENCH_FAULT") == "lang":
    from dawnsearch_tpu_torch.ingest import pages as _pages
    _pages._is_english = lambda text: True


def plant(fault: str) -> None:
    from dawnsearch_tpu_torch.index import provider
    from dawnsearch_tpu_torch.serving import search_service
    svc = search_service.SearchService
    if fault in ("answer", "half"):
        orig = svc._fused_text_batch

        def batch(self, payloads):
            if fault == "half" and len(payloads) > 1:
                keep = payloads[: (len(payloads) + 1) // 2]
                out = orig(self, keep)
                return [out[i % len(out)] for i in range(len(payloads))]
            out = orig(self, payloads)
            for _, res in out:
                if res.pages:
                    res.pages[0].distance += 0.05
            return out
        svc._fused_text_batch = batch
    elif fault in ("embedding", "text"):
        orig = provider.SearchProvider.store_pages

        def store(self, urls, titles, texts, embeddings, base=None):
            if fault == "text":
                texts = [t.rsplit(" ", 1)[0] for t in texts]
            else:
                e = np.asarray(embeddings, np.float32).copy()
                e[:, 0] += 0.05
                embeddings = e / np.linalg.norm(e, axis=1, keepdims=True)
            return orig(self, urls, titles, texts, embeddings, base=base)
        provider.SearchProvider.store_pages = store
    elif fault != "lang":
        raise ValueError(f"unknown fault {fault!r}")


if __name__ == "__main__":
    plant(os.environ["BENCH_FAULT"])
    from dawnsearch_tpu_torch.__main__ import main
    sys.exit(main(sys.argv[1:]))
