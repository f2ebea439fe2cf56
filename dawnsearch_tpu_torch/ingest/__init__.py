"""Ingestion: Common Crawl WARC streaming -> extraction -> batched embed+index.

Rebuild of the reference's ingestion tier
(the reference's src/index/{extraction_service,warc,extract}.rs and
src/search/page_source.rs). The pipeline stages are the same — WARC
record streaming, HTML main-content extraction, size/language/URL
filters — but pages flow to the index in device-sized embed batches
instead of one SearchMsg per page (the reference's throughput
bottleneck, search_service.rs:158-181). The HTML extraction hot loop
(the reference notes minutes per WARC file, page_source.rs:85,106) has
a C++ fast path (native/) with a pure-Python fallback. Port of
dawnsearch_tpu/ingest/.
"""
