"""The port's reference data_dir takeover: adoption and the migrate tool.

The 14 cases of tests/test_migrate.py on the port (its SearchProvider on
the CPU, its index/migrate.py and its CLI). Wherever a case migrates a
store, the reference's migrate runs on a copy of the same data_dir, and
the two pages.sqlite files must hold the same rows (id, url, title, text,
embedding bytes) and the same summary.
"""

from __future__ import annotations

import os
import shutil
import sqlite3

import numpy as np
import pytest
import torch

from dawnsearch_tpu.index.migrate import migrate_data_dir as ref_migrate
from dawnsearch_tpu.ops.vector import embedding_to_bytes
from dawnsearch_tpu_torch.index.migrate import migrate_data_dir, migrate_store
from dawnsearch_tpu_torch.index.provider import SearchProvider as _Provider

torch.set_num_threads(2)


def SearchProvider(**kw):
    return _Provider(device="cpu", **kw)


def make_reference_db(path: str, rows, with_unique_index: bool = False):
    """Write a DB with the reference's exact schema: `text INTEGER NOT
    NULL` declared affinity and a NON-unique find_by_url index."""
    conn = sqlite3.connect(path)
    conn.execute(
        "CREATE TABLE IF NOT EXISTS page ("
        " id INTEGER PRIMARY KEY, url TEXT NOT NULL,"
        " title TEXT NOT NULL, text INTEGER NOT NULL,"
        " embedding BLOB NOT NULL)")
    conn.execute("CREATE INDEX IF NOT EXISTS find_by_url on page(url)")
    for row_id, url, title, text, emb in rows:
        conn.execute(
            "INSERT INTO page (id, url, title, text, embedding) "
            "VALUES (?,?,?,?,?)",
            (row_id, url, title, text, embedding_to_bytes(emb)))
    conn.commit()
    conn.close()


def unit_rows(n: int, start_id: int = 1, seed: int = 0, dim: int = 384):
    rng = np.random.default_rng(seed)
    embs = rng.standard_normal((n, dim)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    return [(start_id + i, f"https://ref.example/{start_id + i}",
             f"title {start_id + i}", f"text {start_id + i}", embs[i])
            for i in range(n)], embs


def _rows(db: str) -> list:
    conn = sqlite3.connect(db)
    try:
        return conn.execute("SELECT id, url, title, text, embedding FROM page "
                            "ORDER BY id").fetchall()
    finally:
        conn.close()


def migrate_both(data_dir) -> dict:
    """Migrate `data_dir` with the port and a copy of it with the
    reference; the stores and summaries must agree. Returns the port's
    summary."""
    data_dir = str(data_dir)
    twin = data_dir.rstrip("/") + "-reference"
    shutil.copytree(data_dir, twin)
    got = migrate_data_dir(data_dir)
    want = ref_migrate(twin)
    assert {k: v for k, v in got.items() if k != "backup"} == \
        {k: v for k, v in want.items() if k != "backup"}
    assert _rows(os.path.join(data_dir, "pages.sqlite")) == \
        _rows(os.path.join(twin, "pages.sqlite"))
    return got


def test_provider_adopts_reference_store(tmp_path):
    rows, embs = unit_rows(64)
    make_reference_db(str(tmp_path / "dawnsearch.sqlite"), rows)
    (tmp_path / "index.usearch").write_bytes(b"opaque hnsw bytes")
    prov = SearchProvider(data_dir=str(tmp_path), max_pages=1000)
    assert len(prov.store) == 64
    assert len(prov.index) == 64
    res = prov.search_embeddings(embs[7:8], k=3)[0]
    assert res.pages[0].url == "https://ref.example/8"
    new = embs[0:1] * -1.0
    ids = prov.insert_pages(["https://new.example/1"], ["t"], ["x"], new)
    assert ids == [65]
    prov.shutdown()
    assert not (tmp_path / "pages.sqlite").exists()


def test_adoption_prefers_existing_pages_sqlite(tmp_path):
    rows, _ = unit_rows(4)
    _, embs2 = unit_rows(2, seed=1)
    make_reference_db(str(tmp_path / "dawnsearch.sqlite"), rows)
    p1 = SearchProvider(data_dir=str(tmp_path), max_pages=10)
    assert len(p1.store) == 4  # adopted (no pages.sqlite yet)
    p1.shutdown()
    os.rename(tmp_path / "dawnsearch.sqlite", tmp_path / "moved.sqlite")
    p2 = SearchProvider(data_dir=str(tmp_path), max_pages=10)
    p2.insert_pages(["https://a/1"], ["t"], ["x"], embs2[:1])
    p2.shutdown()
    os.rename(tmp_path / "moved.sqlite", tmp_path / "dawnsearch.sqlite")
    p3 = SearchProvider(data_dir=str(tmp_path), max_pages=10)
    assert len(p3.store) == 1  # pages.sqlite, not the 4-row reference db
    p3.shutdown()


def test_duplicate_urls_fall_back_to_checked_inserts(tmp_path):
    rows, embs = unit_rows(6)
    rows[3] = (rows[3][0], rows[2][1], "dup title", "dup text", rows[3][4])
    make_reference_db(str(tmp_path / "dawnsearch.sqlite"), rows)
    prov = SearchProvider(data_dir=str(tmp_path), max_pages=1000)
    assert not prov.store._unique_url  # unique index refused, fallback on
    assert len(prov.store) == 6
    assert prov.insert_pages([rows[0][1]], ["t"], ["x"], embs[:1]) == [None]
    assert prov.insert_pages(["https://novel.example/"], ["t"], ["x"],
                             embs[:1]) == [7]
    prov.shutdown()


def test_gappy_ids_refused_then_migrated(tmp_path):
    d = tmp_path / "dir"
    d.mkdir()
    rows, embs = unit_rows(8)
    del rows[4]  # ids 1,2,3,4,6,7,8 — breaks row_id = store_id - 1
    make_reference_db(str(d / "dawnsearch.sqlite"), rows)
    with pytest.raises(ValueError, match="dawnsearch_tpu_torch migrate"):
        SearchProvider(data_dir=str(d), max_pages=1000)
    summary = migrate_both(d)
    assert summary["copied"] == 7
    prov = SearchProvider(data_dir=str(d), max_pages=1000)
    assert len(prov.store) == 7 and len(prov.index) == 7
    res = prov.search_embeddings(embs[5:6], k=1)[0]
    assert res.pages[0].url == "https://ref.example/6"
    prov.shutdown()


def test_migrate_skips_corrupt_and_duplicate_rows(tmp_path):
    d = tmp_path / "dir"
    d.mkdir()
    rows, _ = unit_rows(5)
    make_reference_db(str(d / "dawnsearch.sqlite"), rows)
    conn = sqlite3.connect(d / "dawnsearch.sqlite")
    conn.execute("INSERT INTO page (id, url, title, text, embedding) "
                 "VALUES (9, 'https://bad/', 't', 'x', ?)", (b"short",))
    conn.execute("INSERT INTO page (id, url, title, text, embedding) "
                 "VALUES (10, ?, 't', 'x', ?)",
                 (rows[0][1], embedding_to_bytes(rows[1][4])))
    conn.commit()
    conn.close()
    assert migrate_both(d) == {"source_rows": 7, "copied": 5,
                               "skipped_corrupt": 1,
                               "skipped_duplicate_url": 1}


def test_migrate_compacts_gappy_pages_sqlite_with_backup(tmp_path):
    d = tmp_path / "dir"
    d.mkdir()
    rows, _ = unit_rows(4)
    del rows[1]
    make_reference_db(str(d / "pages.sqlite"), rows)
    summary = migrate_both(d)
    assert summary["copied"] == 3
    assert os.path.exists(summary["backup"])
    prov = SearchProvider(data_dir=str(d), max_pages=100)
    assert len(prov.index) == 3
    prov.shutdown()


def test_migrate_refuses_overwrite(tmp_path):
    rows, _ = unit_rows(2)
    make_reference_db(str(tmp_path / "dawnsearch.sqlite"), rows)
    (tmp_path / "pages.sqlite.migrating").write_bytes(b"")
    with pytest.raises(FileExistsError):
        migrate_store(str(tmp_path / "dawnsearch.sqlite"),
                      str(tmp_path / "dawnsearch.sqlite"))


def test_interrupted_migration_leaves_no_partial_store(tmp_path,
                                                       monkeypatch):
    """A migrate run that dies mid-copy leaves no partial pages.sqlite:
    the copy lands in a staging file and only an atomic rename publishes
    it."""
    d = tmp_path / "dir"
    d.mkdir()
    rows, _ = unit_rows(6)
    make_reference_db(str(d / "dawnsearch.sqlite"), rows)

    from dawnsearch_tpu_torch.index.store import PageStore
    real_insert = PageStore.insert
    calls = {"n": 0}

    def dying_insert(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 4:
            raise RuntimeError("disk full")
        return real_insert(self, *a, **kw)

    monkeypatch.setattr(PageStore, "insert", dying_insert)
    with pytest.raises(RuntimeError, match="disk full"):
        migrate_data_dir(str(d))
    monkeypatch.setattr(PageStore, "insert", real_insert)
    assert not (d / "pages.sqlite").exists()
    assert migrate_both(d)["copied"] == 6
    prov = SearchProvider(data_dir=str(d), max_pages=100)
    assert len(prov.index) == 6
    prov.shutdown()


def test_second_compaction_refuses_to_clobber_backup(tmp_path):
    rows, _ = unit_rows(4)
    del rows[1]
    make_reference_db(str(tmp_path / "pages.sqlite"), rows)
    summary = migrate_data_dir(str(tmp_path))
    assert os.path.exists(summary["backup"])
    with pytest.raises(FileExistsError, match="pre-migrate"):
        migrate_data_dir(str(tmp_path))
    prov = SearchProvider(data_dir=str(tmp_path), max_pages=100)
    assert len(prov.index) == 3
    prov.shutdown()


def test_adopting_oversized_store_names_the_cap(tmp_path):
    rows, _ = unit_rows(8)
    make_reference_db(str(tmp_path / "dawnsearch.sqlite"), rows)
    with pytest.raises(ValueError, match="max_pages"):
        SearchProvider(data_dir=str(tmp_path), max_pages=4)
    prov = SearchProvider(data_dir=str(tmp_path), max_pages=100)
    assert len(prov.index) == 8
    prov.shutdown()


def test_constructor_raise_closes_store(tmp_path, monkeypatch):
    rows, _ = unit_rows(5)
    del rows[2]  # gappy -> contiguity refusal
    make_reference_db(str(tmp_path / "dawnsearch.sqlite"), rows)
    from dawnsearch_tpu_torch.index.store import PageStore
    closed = []
    real_close = PageStore.close
    monkeypatch.setattr(PageStore, "close",
                        lambda self: (closed.append(True),
                                      real_close(self))[1])
    with pytest.raises(ValueError, match="migrate"):
        SearchProvider(data_dir=str(tmp_path), max_pages=100)
    assert closed


def test_migrate_cli(tmp_path, capsys):
    d = tmp_path / "dir"
    d.mkdir()
    rows, _ = unit_rows(3)
    make_reference_db(str(d / "dawnsearch.sqlite"), rows)
    twin = tmp_path / "twin"
    shutil.copytree(d, twin)
    from dawnsearch_tpu_torch.__main__ import main
    assert main(["migrate", "--data-dir", str(d)]) == 0
    assert '"copied": 3' in capsys.readouterr().out
    ref_migrate(str(twin))
    assert _rows(str(d / "pages.sqlite")) == _rows(str(twin / "pages.sqlite"))


def test_migrate_infers_dim_from_store(tmp_path):
    """dim comes from the first stored blob: a 768-dim (MPNet) store
    migrates whole."""
    from dawnsearch_tpu_torch.index.store import PageStore

    d = tmp_path / "mp"
    d.mkdir()
    _, v = unit_rows(3, seed=5, dim=768)
    st = PageStore(str(d / "dawnsearch.sqlite"), dim=768)
    for i in range(3):
        st.insert(f"http://m/{i}", f"t{i}", f"x{i}", v[i])
    st.close()
    summary = migrate_both(d)
    assert summary["copied"] == 3 and summary["skipped_corrupt"] == 0
    out = PageStore(str(d / "pages.sqlite"), dim=768)
    assert len(out) == 3
    out.close()


def test_cli_migrate_honors_pre_subcommand_flags(tmp_path):
    """`--data-dir X migrate` migrates X, and so does `migrate
    --data-dir X` (a subparser that redefined the parent's dest would
    reset it to its default)."""
    from dawnsearch_tpu_torch.__main__ import main
    from dawnsearch_tpu_torch.index.store import PageStore

    _, v = unit_rows(2, seed=2)
    for name, argv in (("cli", lambda d: ["--data-dir", d, "migrate"]),
                       ("cli2", lambda d: ["migrate", "--data-dir", d])):
        d = tmp_path / name
        d.mkdir()
        st = PageStore(str(d / "dawnsearch.sqlite"))
        st.insert(f"http://c/{name}", "t", "x", v[0])
        st.close()
        assert main(argv(str(d))) == 0
        out = PageStore(str(d / "pages.sqlite"))
        assert len(out) == 1
        out.close()
