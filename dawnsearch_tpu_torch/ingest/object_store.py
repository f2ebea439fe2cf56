"""Object-store seam for WARC ingestion (the reference's S3 path).

The reference can fetch Common Crawl WARCs from the `commoncrawl` S3
bucket behind a feature flag (the reference's src/index/
extraction_service.rs:105-122) instead of HTTPS. This module is that
capability as an interface: `ObjectStore` is the minimal list/open
surface, `S3ObjectStore` binds it to boto3 (imported only when a store
is built without a client, so the package imports without boto3; it
gates with a clear error and accepts an injected client for tests), and
`LocalObjectStore` serves directories of objects — enough to exercise
the full code path offline. Port of dawnsearch_tpu/ingest/object_store.py.

`ObjectStoreWarcSource` adapts any store to the ExtractionService
source contract (yields (name, stream) pairs), with the reference's
random-pick behavior (extraction_service.rs:52) or sequential order,
and optional ledger filtering for restart-safe ingest.
"""

from __future__ import annotations

import io
import os
import random
from typing import Iterator, Protocol

from dawnsearch_tpu_torch.utils.logging import service_logger

log = service_logger("ObjectStore")


class ObjectStore(Protocol):
    def list(self, prefix: str = "") -> list[str]:
        """Keys under prefix, sorted."""
        ...

    def open(self, key: str) -> io.BufferedIOBase:
        """Streaming reader for one object."""
        ...


class LocalObjectStore:
    """Directory tree as an object store (keys are relative paths)."""

    def __init__(self, root: str):
        self.root = root

    def list(self, prefix: str = "") -> list[str]:
        # True S3 prefix semantics (plain string prefix over the full
        # key, always recursive) — a glob would treat 'crawl' as
        # non-recursive 'crawl*' and interpret metacharacters, so the
        # offline path would see different listings than S3ObjectStore.
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in files:
                key = os.path.relpath(os.path.join(dirpath, fn), self.root)
                key = key.replace(os.sep, "/")
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def open(self, key: str) -> io.BufferedIOBase:
        return open(os.path.join(self.root, key), "rb")


class S3ObjectStore:
    """S3-backed store (reference extraction_service.rs:105-122 uses
    bucket "commoncrawl"). Requires boto3 or an injected client
    implementing list_objects_v2/get_object."""

    def __init__(self, bucket: str, region: str = "us-east-1", client=None):
        self.bucket = bucket
        if client is None:
            try:
                import boto3  # type: ignore[import-not-found]
            except ImportError as e:
                raise RuntimeError(
                    "S3ObjectStore needs boto3 (not installed); use "
                    "LocalObjectStore or the HTTPS CommonCrawlSource"
                ) from e
            client = boto3.client("s3", region_name=region)
        self.client = client

    def list(self, prefix: str = "") -> list[str]:
        keys: list[str] = []
        token = None
        while True:
            kw = {"Bucket": self.bucket, "Prefix": prefix}
            if token:
                kw["ContinuationToken"] = token
            resp = self.client.list_objects_v2(**kw)
            keys += [o["Key"] for o in resp.get("Contents", [])]
            if not resp.get("IsTruncated"):
                return sorted(keys)
            token = resp.get("NextContinuationToken")

    def open(self, key: str) -> io.BufferedIOBase:
        body = self.client.get_object(Bucket=self.bucket, Key=key)["Body"]
        # boto3 StreamingBody is unbuffered and lacks peek(); wrap it
        return io.BufferedReader(_RawAdapter(body))


class _RawAdapter(io.RawIOBase):
    def __init__(self, body):
        self._body = body

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        chunk = self._body.read(len(b))
        b[: len(chunk)] = chunk
        return len(chunk)

    def close(self) -> None:
        # forward to the StreamingBody, or every opened object (incl.
        # streams skip-closed by the ledger check) leaks its pooled
        # HTTP connection
        try:
            self._body.close()
        finally:
            super().close()


class ObjectStoreWarcSource:
    """ExtractionService source over any ObjectStore.

    random_pick=True mirrors the reference's random WARC choice
    (extraction_service.rs:52); with a ledger, already-ingested files
    are excluded so a restarted indexer never re-reads a WARC."""

    def __init__(self, store: ObjectStore, prefix: str = "",
                 random_pick: bool = False, ledger=None,
                 loop: bool = False):
        self.store = store
        self.prefix = prefix
        self.random_pick = random_pick
        self.ledger = ledger
        self.loop = loop

    @property
    def one_shot(self) -> bool:
        # random_pick with a ledger still terminates: files() stops once
        # every key is marked; without a ledger it streams forever (the
        # reference's endless random-WARC loop)
        return not (self.loop or self.random_pick)

    def files(self) -> Iterator[tuple[str, io.BufferedIOBase]]:
        while True:
            keys = self.store.list(self.prefix)
            if self.ledger is not None:
                keys = [k for k in keys if not self.ledger.seen(k)]
            if not keys:
                return
            if self.random_pick:
                keys = [random.choice(keys)]
            for key in keys:
                yield key, self.store.open(key)
            if not (self.loop or self.random_pick):
                return
