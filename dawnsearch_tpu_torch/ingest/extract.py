"""HTML main-content extraction (readability-style), pure Python tier.

Rebuild of the reference's src/index/extract.rs: the reference runs a
readability port — preprocess, score candidate blocks, penalize link
density, keep the best content (extract.rs:86-117) — plus recursive
text flattening (extract.rs:32-51) and link harvesting (extract.rs:59-84).

Here: one stdlib html.parser pass collects block-level text runs with
per-block link-character counts; blocks dominated by link text
(navigation, footers) are dropped, the rest joins into the page text.
`dawnsearch_tpu_torch.ingest.native` provides the C++ fast path with
identical semantics; this module is the reference implementation and
fallback. Port of dawnsearch_tpu/ingest/extract.py, unchanged.
"""

from __future__ import annotations

import dataclasses
from html.parser import HTMLParser

# Content never lives inside these (extract.rs preprocessing).
_SKIP = {"script", "style", "noscript", "template", "svg", "iframe",
         "head"}
# Boilerplate containers readability strips.
_BOILERPLATE = {"nav", "header", "footer", "aside", "form", "button",
                "select", "option", "label"}
# Elements that delimit text blocks.
_BLOCK = {"p", "div", "article", "section", "main", "li", "td", "th",
          "blockquote", "pre", "h1", "h2", "h3", "h4", "h5", "h6", "br",
          "tr", "ul", "ol", "table", "body"}

MAX_LINK_DENSITY = 0.5  # drop blocks mostly made of anchor text
MIN_BLOCK_CHARS = 20    # ignore crumbs (readability's minimum candidates)


@dataclasses.dataclass
class ExtractedDoc:
    title: str
    text: str
    links: list[str]


class _Extractor(HTMLParser):
    def __init__(self):
        super().__init__(convert_charrefs=True)
        self.blocks: list[tuple[str, int]] = []  # (text, link_chars)
        self._buf: list[str] = []
        self._link_chars = 0
        self._skip_depth = 0
        self._boiler_depth = 0
        self._anchor_depth = 0
        self._in_title = False
        self.title = ""
        self.links: list[str] = []

    # -- tag walk -------------------------------------------------------

    def handle_starttag(self, tag, attrs):
        if tag == "title":
            self._in_title = True
        if tag in _SKIP:
            self._skip_depth += 1
        elif tag in _BOILERPLATE:
            self._boiler_depth += 1
        if tag == "a":
            self._anchor_depth += 1
            for k, v in attrs:
                if k == "href" and v:
                    self.links.append(v)
        if tag in _BLOCK:
            self._flush()

    def handle_endtag(self, tag):
        if tag == "title":
            self._in_title = False
        if tag in _SKIP and self._skip_depth:
            self._skip_depth -= 1
        elif tag in _BOILERPLATE and self._boiler_depth:
            self._boiler_depth -= 1
        if tag == "a" and self._anchor_depth:
            self._anchor_depth -= 1
        if tag in _BLOCK:
            self._flush()

    def handle_data(self, data):
        if self._in_title:
            self.title += data
            return
        if self._skip_depth or self._boiler_depth:
            return
        if data.strip():
            self._buf.append(data)
            if self._anchor_depth:
                self._link_chars += len(data.strip())

    def _flush(self):
        if self._buf:
            text = " ".join(" ".join(self._buf).split())
            if text:
                self.blocks.append((text, self._link_chars))
        self._buf = []
        self._link_chars = 0


def extract(html: str) -> ExtractedDoc:
    """HTML -> (title, main text, links). Link-dense blocks (menus,
    footers) are dropped like readability's link-density penalty
    (extract.rs:98-108)."""
    p = _Extractor()
    try:
        p.feed(html)
        p.close()
    except Exception:
        pass  # salvage whatever parsed
    p._flush()
    kept = []
    for text, link_chars in p.blocks:
        if len(text) < MIN_BLOCK_CHARS:
            continue
        if link_chars / max(len(text), 1) > MAX_LINK_DENSITY:
            continue
        kept.append(text)
    title = " ".join(p.title.split())
    return ExtractedDoc(title=title, text="\n".join(kept), links=p.links)


def extract_text(html: str) -> str:
    """Flatten ALL text with space separation (extract.rs:32-51) —
    no content scoring; used where recall beats precision."""
    p = _Extractor()
    try:
        p.feed(html)
        p.close()
    except Exception:
        pass
    p._flush()
    return " ".join(t for t, _ in p.blocks)


def find_links(html: str) -> list[str]:
    """Harvest hrefs for crawling (extract.rs:59-84)."""
    return extract(html).links
