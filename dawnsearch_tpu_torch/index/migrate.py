"""Migrate a reference DawnSearch data_dir into this node's store.

Port of dawnsearch_tpu/index/migrate.py, unchanged but for its imports:
both packages write the same pages.sqlite from the same source.

The reference persists `dawnsearch.sqlite` (schema at
the reference's src/search/search_provider.rs:84-99 — identical to ours
modulo the `text` column's declared affinity, which SQLite ignores) and
`index.usearch` (a USearch HNSW snapshot we never read: the device
index rebuilds from the store, the same recovery path the reference
uses when its index file is missing, search_provider.rs:111-153).

Normally no migration step is needed: SearchProvider adopts
`dawnsearch.sqlite` in place when `pages.sqlite` is absent. This tool
covers the stores adoption cannot serve directly:

- ids with gaps (the row_id = store_id - 1 join contract requires ids
  contiguous from 1; the reference never deletes rows, but hand-edited
  or vacuumed-and-trimmed stores exist in the wild),
- corrupt or denormalized embedding blobs (skipped, counted),
- duplicate URLs (first one wins, matching the insert-time guard).

Output is a fresh `pages.sqlite` written row-by-row in id order; the
source store is left untouched.
"""

from __future__ import annotations

import os
import sqlite3

import numpy as np

from dawnsearch_tpu_torch.index.provider import DB_FILE, REFERENCE_DB_FILE
from dawnsearch_tpu_torch.index.store import PageStore
from dawnsearch_tpu_torch.ops.vector import bytes_to_embedding
from dawnsearch_tpu_torch.utils.logging import service_logger

log = service_logger("Migrate")


def migrate_store(src_db: str, dst_db: str, dim: int | None = None,
                  batch: int = 4096) -> dict:
    """Copy `src_db` (reference or legacy store) into a fresh `dst_db`
    with contiguous ids from 1. Returns counts. Raises if dst exists.

    dim=None infers the dimension from the first row's blob length —
    a hard-coded 384 against a 768-dim (MPNet) store would count every
    row corrupt and swap in an empty pages.sqlite."""
    if os.path.exists(dst_db):
        raise FileExistsError(
            f"{dst_db} already exists; refusing to overwrite")
    # plain open (not mode=ro): lets SQLite recover a leftover WAL/journal
    # from an uncleanly stopped source node; we only ever SELECT from it
    src = sqlite3.connect(src_db)
    try:
        (total,) = src.execute("SELECT COUNT(*) FROM page").fetchone()
        if dim is None:
            row = src.execute(
                "SELECT embedding FROM page ORDER BY id LIMIT 1").fetchone()
            dim = len(row[0]) // 4 if row and row[0] is not None else 384
            log.info("inferred dim=%d from the first stored blob", dim)
        dst = PageStore(dst_db, dim=dim)
        copied = skipped_bad = skipped_dup = 0
        cur = src.execute(
            "SELECT id, url, title, text, embedding FROM page ORDER BY id")
        while True:
            rows = cur.fetchmany(batch)
            if not rows:
                break
            # One transaction per batch, not per store: the destination
            # is fresh and private, so partial progress is harmless
            # (callers write to a staging file), and a store-sized
            # transaction would balloon the WAL to ~source size.
            with dst.transaction():
                for row_id, url, title, text, blob in rows:
                    try:
                        emb = bytes_to_embedding(blob, dim)
                    except (ValueError, TypeError) as e:
                        log.warning("skipping page %s (%r): %s",
                                    row_id, url, e)
                        skipped_bad += 1
                        continue
                    # SQLite's dynamic typing means an adopted store can
                    # hold non-text values in text columns (the
                    # reference even declares `text INTEGER`).
                    sid = dst.insert(str(url), str(title), str(text),
                                     np.asarray(emb, np.float32))
                    if sid is None:
                        skipped_dup += 1
                    else:
                        copied += 1
        dst.close()
    finally:
        src.close()
    summary = {"source_rows": int(total), "copied": copied,
               "skipped_corrupt": skipped_bad,
               "skipped_duplicate_url": skipped_dup}
    log.info("migrated %s -> %s: %s", src_db, dst_db, summary)
    return summary


def migrate_data_dir(data_dir: str, dim: int | None = None) -> dict:
    """Migrate `data_dir`'s reference store to `pages.sqlite`.
    dim=None infers it from the source store (migrate_store).

    Prefers `dawnsearch.sqlite` as the source; with only a
    `pages.sqlite` present (e.g. one that fails the contiguity check),
    compacts it in place, keeping the original at
    `pages.sqlite.pre-migrate`. Either way the copy lands in a
    `pages.sqlite.migrating` staging file first and is moved into place
    by one atomic rename. `index.usearch` / stale snapshots are left in
    place — they are never read and a fresh snapshot lands beside them
    on the first save.
    """
    ref = os.path.join(data_dir, REFERENCE_DB_FILE)
    ours = os.path.join(data_dir, DB_FILE)
    # Both branches copy into a staging file and move it into place with
    # ONE atomic rename, so no failure point leaves a partial (or empty)
    # pages.sqlite shadowing the source data: an interrupted run leaves
    # only a stale staging file, cleaned up on the next attempt.
    staging = ours + ".migrating"
    for leftover in (staging, staging + "-wal", staging + "-shm"):
        if os.path.exists(leftover):
            os.remove(leftover)  # a previous attempt died mid-copy
    if os.path.exists(ref) and not os.path.exists(ours):
        summary = migrate_store(ref, staging, dim=dim)
        os.replace(staging, ours)
        log.info("adopted %s as %s", ref, ours)
        return summary
    if os.path.exists(ours):
        backup = ours + ".pre-migrate"
        if os.path.exists(backup):
            # Never clobber an earlier backup — it may be the only copy
            # of rows a previous migration skipped. Checked before the
            # copy so a refusal costs nothing.
            raise FileExistsError(
                f"{backup} already exists; move it aside before "
                "migrating again")
        summary = migrate_store(ours, staging, dim=dim)
        try:
            os.link(ours, backup)  # keeps pages.sqlite in place: no
            # window where the data_dir has no store at all
        except OSError:  # filesystem without hardlinks
            os.replace(ours, backup)
        os.replace(staging, ours)
        summary["backup"] = backup
        return summary
    raise FileNotFoundError(
        f"no {REFERENCE_DB_FILE} or {DB_FILE} in {data_dir}")
