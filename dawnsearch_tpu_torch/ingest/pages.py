"""PageSource: WARC records -> filtered ExtractedPage stream.

Rebuild of the reference's src/search/page_source.rs:52-132 — the
post-extraction filters on top of the WARC-level ones in
dawnsearch_tpu_torch.ingest.warc:

- readability-cleaned text >= 400 chars   (page_source.rs:108-110)
- title truncated to 200, text to 2048    (page_source.rs:112-113; the
                                          text cap is the node's
                                          ingest_max_text_chars)
- English only                            (page_source.rs:119-121)

Emits ExtractedPage{url,title,text,combined} (page_source.rs:44-50);
`combined` is what gets embedded. Port of dawnsearch_tpu/ingest/pages.py:
the same WARC files give the same (url, title, text) triples in both
packages (tests/test_torch_ingest_parity.py), though here an HTML body
goes to the extractor as bytes, with no str made of it
(native.extract_page).
"""

from __future__ import annotations

import dataclasses
import time
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


def _extract_page(body: bytes) -> tuple[str, str, bool]:
    """C++ fast path when built, Python fallback otherwise."""
    from dawnsearch_tpu_torch.ingest import native
    return native.extract_page(body)


def _is_english(text: str) -> bool:
    """C++ fast path when built, Python fallback otherwise."""
    from dawnsearch_tpu_torch.ingest import native
    return native.is_english(text)


class Stages:
    """What iter_pages spent on its records: seconds in each stage (read:
    inflate and parse, inside iter_warc_records; decode: a text/plain
    body to str; html: an HTML body's bytes to title and text; filter:
    whitespace, length and language), the records read, the pages kept,
    the HTML bodies that held invalid UTF-8 (`repaired`) and the kept
    pages whose text the cap cut (`truncated`). While
    `spans` is a list, each record appends an ("extract.record", t0_ns,
    t1_ns, args, "X") span on the wall clock
    (utils/logging.py::SpanRecorder.extend)."""

    __slots__ = ("read", "decode", "html", "filter", "records", "kept",
                 "repaired", "truncated", "spans")

    def __init__(self):
        self.spans: list | None = None
        self.reset()

    def reset(self) -> None:
        """Zero the sums (not `spans`)."""
        self.read = self.decode = self.html = self.filter = 0.0
        self.records = self.kept = self.repaired = self.truncated = 0

    def sums(self) -> tuple:
        """(read, decode, html, filter, records, kept, repaired,
        truncated)."""
        return (self.read, self.decode, self.html, self.filter,
                self.records, self.kept, self.repaired, self.truncated)


def iter_pages(source: str | BinaryIO, stages: Stages | None = None,
               max_text: int = MAX_TEXT) -> Iterator[ExtractedPage]:
    """WARC path/stream -> filtered pages ready to embed+index, each text
    cut at `max_text` characters; `stages` gathers the time each stage
    took."""
    st = stages if stages is not None else Stages()
    clock = time.perf_counter
    records = iter_warc_records(source)
    try:
        while True:
            w0 = time.time_ns()
            t0 = clock()
            rec = next(records, None)
            t1 = clock()
            st.read += t1 - t0
            if rec is None:
                return
            st.records += 1
            if rec.payload_type.startswith("text/plain"):
                # .wet conversion records are pre-extracted text
                title, text = "", rec.body.decode("utf-8", errors="ignore")
                t3 = t2 = clock()
            else:
                t2 = t1
                title, text, repaired = _extract_page(rec.body)
                st.repaired += repaired
                t3 = clock()
            text = " ".join(text.split())
            # page_source.rs:108-110, then :119-121
            keep = len(text) >= MIN_CLEAN_TEXT and _is_english(text)
            t4 = clock()
            st.decode += t2 - t1
            st.html += t3 - t2
            st.filter += t4 - t3
            if st.spans is not None:
                st.spans.append(("extract.record", w0, time.time_ns(),
                                 {"bytes": len(rec.body), "kept": keep},
                                 "X"))
            if keep:
                st.kept += 1
                st.truncated += len(text) > max_text
                yield ExtractedPage(
                    url=rec.url,
                    title=slice_up_to(title, MAX_TITLE),
                    text=slice_up_to(text, max_text),
                )
    finally:
        records.close()
