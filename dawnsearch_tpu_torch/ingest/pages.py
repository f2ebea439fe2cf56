"""PageSource: WARC records -> filtered ExtractedPage stream.

Rebuild of the reference's src/search/page_source.rs:52-132 — the
post-extraction filters on top of the WARC-level ones in
dawnsearch_tpu_torch.ingest.warc:

- readability-cleaned text >= 400 chars   (page_source.rs:108-110)
- title truncated to 200, text to 2048    (page_source.rs:112-113)
- English only                            (page_source.rs:119-121)

Emits ExtractedPage{url,title,text,combined} (page_source.rs:44-50);
`combined` is what gets embedded. Port of dawnsearch_tpu/ingest/pages.py,
unchanged: the same WARC files give the same (url, title, text) triples in
both packages (tests/test_torch_ingest_parity.py).
"""

from __future__ import annotations

import dataclasses
from typing import BinaryIO, Iterator

from dawnsearch_tpu_torch.ingest.warc import iter_warc_records
from dawnsearch_tpu_torch.utils.text import slice_up_to

MIN_CLEAN_TEXT = 400  # page_source.rs:108-110
MAX_TITLE = 200  # page_source.rs:112
MAX_TEXT = 2048  # page_source.rs:113


@dataclasses.dataclass
class ExtractedPage:
    """page_source.rs:44-50."""
    url: str
    title: str
    text: str

    @property
    def combined(self) -> str:
        return f"{self.title}\n{self.text}"


def _extract(html: str):
    """C++ fast path when built, Python fallback otherwise."""
    from dawnsearch_tpu_torch.ingest import native
    return native.extract(html)


def _is_english(text: str) -> bool:
    """C++ fast path when built, Python fallback otherwise."""
    from dawnsearch_tpu_torch.ingest import native
    return native.is_english(text)


def iter_pages(source: str | BinaryIO) -> Iterator[ExtractedPage]:
    """WARC path/stream -> filtered pages ready to embed+index."""
    for rec in iter_warc_records(source):
        if rec.payload_type.startswith("text/plain"):
            # .wet conversion records are pre-extracted text
            title, text = "", rec.body.decode("utf-8", errors="ignore")
        else:
            doc = _extract(rec.body.decode("utf-8", errors="ignore"))
            title, text = doc.title, doc.text
        text = " ".join(text.split())
        if len(text) < MIN_CLEAN_TEXT:
            continue  # page_source.rs:108-110
        if not _is_english(text):
            continue  # page_source.rs:119-121
        yield ExtractedPage(
            url=rec.url,
            title=slice_up_to(title, MAX_TITLE),
            text=slice_up_to(text, MAX_TEXT),
        )
