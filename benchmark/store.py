"""The node's page store, written in bulk, and its embeddings.

The schema is the node's (and the reference DawnSearch's): `page(id
INTEGER PRIMARY KEY, url, title, text, embedding BLOB)` with a unique URL
index, ids contiguous from 1, each embedding a little-endian f32 unit
vector. It is written in one transaction with the journal off, and the
URL index is built after the rows. No index snapshot is written, so every
node start fills its device index from this store. Replaces
chip_smoke.py's seed_store, which went through the port's insert_batch.
"""

from __future__ import annotations

import os
import sqlite3

import numpy as np
import torch

DB_FILE = "pages.sqlite"


def write(data_dir: str, embeddings: torch.Tensor, url, title, text,
          block: int = 1 << 16) -> int:
    """Rows 1..N: url(i), title(i), text(i) of row index i (0-based) and
    embeddings[i]. Returns the file's bytes."""
    os.makedirs(data_dir, exist_ok=True)
    path = os.path.join(data_dir, DB_FILE)
    conn = sqlite3.connect(path)
    try:
        conn.execute("PRAGMA journal_mode=OFF")
        conn.execute("PRAGMA synchronous=OFF")
        conn.execute("CREATE TABLE page (id INTEGER PRIMARY KEY,"
                     " url TEXT NOT NULL, title TEXT NOT NULL,"
                     " text TEXT NOT NULL, embedding BLOB NOT NULL)")
        conn.execute("BEGIN")
        n = embeddings.shape[0]
        for s in range(0, n, block):
            e = embeddings[s:s + block].float().cpu().numpy().astype("<f4")
            conn.executemany(
                "INSERT INTO page VALUES (?,?,?,?,?)",
                ((s + j + 1, url(s + j), title(s + j), text(s + j),
                  e[j].tobytes()) for j in range(e.shape[0])))
        conn.execute("CREATE UNIQUE INDEX page_url ON page(url)")
        conn.execute("COMMIT")
    finally:
        conn.close()
    return os.path.getsize(path)


def unit_rows(n: int, dim: int, g: torch.Generator, device) -> torch.Tensor:
    e = torch.randn(n, dim, generator=g, device=device)
    return torch.nn.functional.normalize(e, dim=1)


def planted(n: int, anchors: torch.Tensor, per_anchor: int, cos_lo: float,
            cos_hi: float, seed: int, device) -> torch.Tensor:
    """(n, D) unit rows: `per_anchor` rows at a cosine drawn from
    [cos_lo, cos_hi] to each anchor row, at seeded places, and random unit
    rows elsewhere."""
    g = torch.Generator(device=device).manual_seed(seed)
    A, D = anchors.shape
    rows = unit_rows(n, D, g, device)
    m = A * per_anchor
    if m > n:
        raise ValueError(f"{m} planted rows do not fit a store of {n}")
    a = anchors.repeat_interleave(per_anchor, dim=0)
    u = torch.randn(m, D, generator=g, device=device)
    u = torch.nn.functional.normalize(u - (u * a).sum(1, keepdim=True) * a,
                                      dim=1)
    c = cos_lo + (cos_hi - cos_lo) * torch.rand(m, 1, generator=g,
                                                device=device)
    where = torch.randperm(n, generator=g, device=device)[:m]
    rows[where] = torch.nn.functional.normalize(c * a + (1 - c * c).sqrt() * u,
                                                dim=1)
    return rows


def _query(data_dir: str, sql: str, params) -> list:
    conn = sqlite3.connect(os.path.join(data_dir, DB_FILE))
    try:
        return conn.execute(sql, params).fetchall()
    finally:
        conn.close()


def read_rows(data_dir: str, ids: list[int], dim: int
              ) -> list[tuple[int, str, str, str, np.ndarray]]:
    """(id, url, title, text, embedding) of the rows `ids` that exist."""
    if not ids:
        return []
    rows = _query(data_dir, "SELECT id, url, title, text, embedding FROM "
                  f"page WHERE id IN ({','.join('?' * len(ids))}) "
                  "ORDER BY id", list(ids))
    return [(r[0], r[1], r[2], r[3], np.frombuffer(r[4], "<f4").copy())
            for r in rows if len(r[4]) == 4 * dim]


def read_urls(data_dir: str, first_id: int, last_id: int) -> list[str]:
    return [r[0] for r in _query(
        data_dir, "SELECT url FROM page WHERE id BETWEEN ? AND ?",
        (first_id, last_id))]
