"""The port's multi-process tier: 2 OS processes x 2 CPU shards serve ONE
4-shard ShardedFlatIndex over gloo and the TCP control stream.

The 11 cases of tests/test_multihost.py, on the port: crew bootstrap
(init_distributed), the control plane (INIT/ADD/SEARCH/SAVE/PING/STOP),
exact-recall parity against numpy on the leader, keepalive across an idle
gap, the save through the gather, a full DawnNode leading a crew, the
fail-stop contract, config validation and ADD coalescing. Added: the
crew-written snapshot loads in a single-process port index and in the
reference's ShardedFlatIndex with equal results, and the two faults the
port's copy fixes (a queued add keeps its own copy of the rows; a
keepalive ping does not wait on the crew lock).

The crew's processes run this file as a script (the `__main__` block
below); each has its own timeout, so a hung crew fails the test.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CREW_TIMEOUT_S = 240.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_crew(tmp_path, scenario: str, timeout: float = CREW_TIMEOUT_S):
    """Spawn leader (pid 0) + follower (pid 1); return their RESULT dicts
    keyed by role. A process still running at `timeout` is killed and
    the test fails."""
    port = _free_port()
    while _free_port() == port + 1:  # the control stream takes port + 1
        port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(p), "2",
             str(port), str(tmp_path), scenario],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO)
        for p in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = {}
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
        for line in out.splitlines():
            if line.startswith("RESULT "):
                r = json.loads(line[len("RESULT "):])
                results[r["role"]] = r
    assert {"leader", "follower"} <= set(results), outs
    return results


def _corpus():
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((700, 384)).astype(np.float32)
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


def _recall(u, rows, q):
    exact = np.argsort(1.0 - q @ rows.T, axis=1)[:, :10]
    return np.mean([len(set(u[b].tolist()) & set(exact[b].tolist())) / 10
                    for b in range(len(q))])


def test_crew_index_ops(tmp_path):
    res = _run_crew(tmp_path, "index")
    lead = res["leader"]
    assert lead["count"] == 700
    # bare-index recall: i8 scan without the provider's f32 re-rank
    assert lead["recall"] >= 0.98
    assert lead["self_hits"]
    assert lead["single_hit"] and lead["post_idle_hit"]
    assert lead["pings"] >= 2
    assert lead["snapshot"]
    assert res["follower"]["ok"]

    # The crew-written snapshot is format-identical to a single-process
    # sharded one: it reloads here on 8 shards (re-striped from 4).
    from dawnsearch_tpu_torch.index import load_index
    from dawnsearch_tpu_torch.parallel.mesh import make_mesh
    idx = load_index(os.path.join(tmp_path, "crew_snapshot.npz"),
                     mesh=make_mesh({"shard": 8}, devices=["cpu"] * 8))
    assert len(idx) == 700
    rows = _corpus()
    _, u = idx.search(rows[:8], 10)
    assert _recall(u, rows, rows[:8]) >= 0.98
    assert (u[:, 0] == np.arange(8)).all()


def test_crew_snapshot_loads_in_one_process_and_in_the_reference(tmp_path):
    """Cross-world reload: the crew's 4-shard snapshot loads in a
    single-process port index on its own 4 shards and in the reference's
    ShardedFlatIndex, and all three answer alike."""
    from dawnsearch_tpu.index import load_index as ref_load
    from dawnsearch_tpu_torch.index import load_index
    from dawnsearch_tpu_torch.parallel.mesh import make_mesh

    res = _run_crew(tmp_path, "index")
    path = os.path.join(tmp_path, "crew_snapshot.npz")
    rows = _corpus()
    q = rows[:16]
    port = load_index(path, mesh=make_mesh({"shard": 4},
                                           devices=["cpu"] * 4))
    assert port.n_shards == 4 and len(port) == 700
    d, u = port.search(q, 10)
    np.testing.assert_array_equal(u, np.asarray(res["leader"]["ids"]))
    np.testing.assert_allclose(d, np.asarray(res["leader"]["dists"]),
                               atol=1e-6)
    ref = ref_load(path)
    assert len(ref) == 700
    rd, ru = ref.search(q, 10)
    assert (ru[:, 0] == u[:, 0]).all()
    for b in range(len(q)):
        assert len(set(ru[b].tolist()) & set(u[b].tolist())) >= 9


def test_crew_full_node(tmp_path):
    res = _run_crew(tmp_path, "node")
    lead = res["leader"]
    assert lead["inserted"] == 40
    assert lead["count"] == 40
    assert lead["served"]
    assert res["follower"]["ok"]


def test_crew_dies_visibly_on_follower_local_failure(tmp_path):
    """A follower whose add raises a local failure ends its process
    (run_follower propagates), and the leader's next operation, whose
    collective the follower can no longer join, raises or blocks: the
    crew goes down visibly, never silently out of step."""
    res = _run_crew(tmp_path, "failadd")
    fol = res["follower"]
    assert fol["died"] and "injected follower-local" in fol["err"]
    lead = res["leader"]
    assert lead["outcome"] in ("raised", "blocked"), lead
    if lead["outcome"] == "raised":
        assert lead["err"]


def test_send_after_shutdown_is_dropped(monkeypatch):
    """A keepalive ping that loses the race to shutdown() must not write
    into a stream whose followers already exited on OP_STOP; real ops
    fail fast (their collective would have no peers)."""
    from dawnsearch_tpu_torch.parallel import multihost as mh

    sent = []
    monkeypatch.setattr(
        mh.MultihostCrew, "_send_frames",
        lambda self, header, payloads: sent.append(np.array(header)))
    stops = []
    monkeypatch.setattr(mh.MultihostCrew, "_send_stop",
                        lambda self: stops.append(mh.OP_STOP))
    crew = mh.MultihostCrew(ping_interval=0)
    crew.shutdown()
    assert stops == [mh.OP_STOP]
    crew.send(mh.OP_PING)  # the late timer thread's frame: dropped
    crew._ping()           # ...and the timer's own path too
    with pytest.raises(RuntimeError, match="crew stopped"):
        crew.send(mh.OP_ADD, (1, 1, 3), (np.zeros((1, 3), np.float32),))
    with pytest.raises(RuntimeError, match="crew stopped"):
        crew.send(mh.OP_SEARCH, (8, 8, 10, 3),
                  (np.zeros((8, 3), np.float32),))
    assert sent == [] and stops == [mh.OP_STOP]  # nothing leaked


class _LiveSock:
    def __init__(self):
        self.got = b""
        self.closed = False

    def sendall(self, b):
        self.got += bytes(b)

    def close(self):
        self.closed = True


def test_stop_reaches_healthy_followers_past_a_dead_socket():
    """One follower that died earlier (dead socket) must not keep OP_STOP
    from the healthy ones, nor abort the caller's shutdown."""
    from dawnsearch_tpu_torch.parallel import multihost as mh

    crew = mh.MultihostCrew(ping_interval=0)

    class DeadSock:
        def sendall(self, b):
            raise BrokenPipeError("peer died")

        def close(self):
            pass

    live = _LiveSock()
    crew.is_leader = True
    crew._socks = [DeadSock(), live]
    crew.shutdown()  # must not raise
    header = np.frombuffer(live.got, np.int64)
    assert int(header[0]) == mh.OP_STOP and live.closed


def test_recv_exact_fail_stops_on_liveness_timeout():
    """A leader host that dies without FIN/RST: the follower's liveness
    timeout surfaces as the crew's fail-stop error."""
    import socket as pysocket

    from dawnsearch_tpu_torch.parallel import multihost as mh

    class SilentSock:
        def recv_into(self, view, n):
            raise pysocket.timeout()

    with pytest.raises(RuntimeError, match="liveness bound"):
        mh._recv_exact(SilentSock(), 8)


def _follower_cfg(tmp_path):
    from dawnsearch_tpu_torch.config import Config
    return Config(device="cpu", data_dir=str(tmp_path), index_kind="sharded")


def test_follower_fail_stop_on_op_before_init(tmp_path):
    """An op arriving while the follower has no index means the leader is
    entering a collective this process cannot join: fail stop (raise),
    after consuming the payload."""
    from dawnsearch_tpu_torch.parallel import multihost as mh

    crew = mh.MultihostCrew(ping_interval=0)
    headers = iter([
        np.array([mh.OP_PING, 0, 0, 0, 0, 0, 0, 0], np.int64),  # benign
        np.array([mh.OP_SEARCH, 8, 8, 10, 384, 0, 0, 0], np.int64),
    ])
    crew.recv_header = lambda: next(headers)
    payloads = []
    crew.recv = lambda shape, dtype: (payloads.append(shape),
                                      np.zeros(shape, dtype))[1]
    with pytest.raises(RuntimeError, match="failing"):
        mh.run_follower(crew, _follower_cfg(tmp_path),
                        str(tmp_path / "index.npz"))
    assert payloads == [(8, 384)]


def _scripted_crew(mh, headers_list):
    """A crew whose stream is scripted: recv_header pops the given
    headers, recv returns zeros (payloads consumed, never used)."""
    crew = mh.MultihostCrew(ping_interval=0)
    headers = iter([np.array(h + [0] * (8 - len(h)), np.int64)
                    for h in headers_list])
    crew.recv_header = lambda: next(headers)
    crew.recv = lambda shape, dtype: np.zeros(shape, dtype)
    return crew


def test_follower_fail_stop_on_local_device_failure(tmp_path, monkeypatch):
    """A follower-local op failure (device fault, out of memory) kills
    the follower: log-and-continue would leave every later collective
    out of step."""
    from dawnsearch_tpu_torch.parallel import multihost as mh
    from dawnsearch_tpu_torch.parallel.sharded_index import ShardedFlatIndex

    def boom(self, *a, **k):
        raise RuntimeError("injected follower-local device failure")

    monkeypatch.setattr(ShardedFlatIndex, "_commit_add", boom)
    crew = _scripted_crew(mh, [
        [mh.OP_INIT, 0, 384],              # fresh build
        [mh.OP_ADD, 8, 4, 4, 384, 0],      # leader did its half...
    ])
    with pytest.raises(RuntimeError, match="injected follower-local"):
        mh.run_follower(crew, _follower_cfg(tmp_path),
                        str(tmp_path / "index.npz"))


def test_follower_co_skips_deterministic_refusals(tmp_path, monkeypatch):
    """A SEARCH the leader refused (ValueError, raised identically on the
    follower) is skipped on both sides and the loop keeps serving; ADD
    refusals never reach the wire (the leader's add() refuses first)."""
    from dawnsearch_tpu_torch.index.flat import IndexFull
    from dawnsearch_tpu_torch.parallel import multihost as mh
    from dawnsearch_tpu_torch.parallel.sharded_index import ShardedFlatIndex

    def refuse(self, *a, **k):
        raise ValueError("queries must be unit-normalized")

    monkeypatch.setattr(ShardedFlatIndex, "search", refuse)
    crew = _scripted_crew(mh, [
        [mh.OP_INIT, 0, 384],
        [mh.OP_SEARCH, 8, 8, 10, 384],     # refused on both sides
        [mh.OP_STOP],                      # ...and the loop kept going
    ])
    mh.run_follower(crew, _follower_cfg(tmp_path),
                    str(tmp_path / "index.npz"))  # returns cleanly

    class _FullInner:
        _next_id = 0
        dim = 384
        max_capacity = 4

        def __len__(self):
            return 4

        def free_slots(self):
            return 0

    sent = []
    leader_crew = mh.MultihostCrew(ping_interval=0)
    leader_crew.send = lambda *a, **k: sent.append(a)
    wrapped = mh.MultihostShardedIndex(_FullInner(), leader_crew)
    with pytest.raises(IndexFull):
        wrapped.add(np.zeros((4, 384), np.float32))
    assert sent == []  # nothing hit the wire
    assert wrapped._pending_n == 0  # ...and nothing was queued


def test_multihost_config_validation(tmp_path):
    """make_index_factory refuses a crew config that cannot work at boot
    (leader and follower run the same check): a non-sharded index, and
    a mesh_shards that does not split evenly over the processes (on the
    CPU; on cards, anything but one shard a visible card)."""
    from dawnsearch_tpu_torch.config import Config
    from dawnsearch_tpu_torch.node import make_index_factory

    def cfg(**kw):
        return Config(device="cpu", data_dir=str(tmp_path / "data"),
                      dist_num_processes=2, **kw)

    with pytest.raises(ValueError, match="sharded"):
        make_index_factory(cfg(index_kind="flat"))
    with pytest.raises(ValueError, match="mesh_shards"):
        make_index_factory(cfg(index_kind="sharded", mesh_shards=3))
    # 0 (= one shard a process) and an even split are both fine
    for n, local in ((0, 1), (4, 2)):
        mesh = make_index_factory(cfg(index_kind="sharded", mesh_shards=n)
                                  ).load_kwargs()["mesh"]
        assert mesh.shape["shard"] == 2 * local
        assert mesh.local_shards == local


def _coalescing_index(flush_rows: int, dim: int = 64):
    from dawnsearch_tpu_torch.parallel import multihost as mh
    from dawnsearch_tpu_torch.parallel.mesh import make_mesh
    from dawnsearch_tpu_torch.parallel.sharded_index import ShardedFlatIndex

    mesh = make_mesh({"shard": 4}, devices=["cpu"] * 4)
    crew = mh.MultihostCrew(ping_interval=0)
    return mesh, mh.MultihostShardedIndex(
        ShardedFlatIndex(mesh=mesh, dim=dim, dtype="i8"), crew,
        flush_rows=flush_rows)


def _unit(n: int, dim: int = 64, seed: int = 0) -> np.ndarray:
    rows = np.random.default_rng(seed).standard_normal((n, dim)).astype(
        np.float32)
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


def test_add_coalescing_semantics(tmp_path):
    """Leader-side ADD coalescing: small adds queue on the host; a
    search/save flushes them as ONE prepared plan; the size threshold
    flushes on its own; ids and results equal immediate commits. On a
    one-process crew (no sockets), where the wrapper's logic is the
    same and the wire is a no-op."""
    from dawnsearch_tpu_torch.index import load_index

    mesh, index = _coalescing_index(64)
    rows = _unit(160)
    ids = [index.add(rows[i:i + 16]) for i in range(0, 48, 16)]
    assert np.concatenate(ids).tolist() == list(range(48))
    assert len(index) == 48                 # pending rows count
    assert len(index.inner) == 0            # ...but are not committed
    d, u = index.search(rows[:8], 5)        # search flushes first
    assert len(index.inner) == 48
    assert (u[:, 0] == np.arange(8)).all()  # and observes every add

    got = index.add(rows[48:112])  # 48 committed + 64 pending >= 64
    assert got.tolist() == list(range(48, 112))
    assert len(index.inner) == 112 and index._pending_n == 0

    # save flushes too; explicit ids thread through the pending queue
    index.add(rows[112:], ids=np.arange(500, 548, dtype=np.int64))
    assert len(index) == 160 and len(index.inner) == 112
    path = str(tmp_path / "snap.npz")
    index.save(path)
    assert len(index.inner) == 160
    assert len(load_index(path, mesh=mesh)) == 160
    # auto ids continue past the explicit block (the wire pins them)
    assert index.add(rows[:1])[0] == 548


def test_queued_add_keeps_its_own_rows():
    """The port's fix: a queued add copies the caller's rows and ids (the
    reference queues the caller's arrays, so a caller that reuses its
    buffer before the flush changes what gets indexed)."""
    _, index = _coalescing_index(1 << 20)
    rows = _unit(32)
    buf = rows.copy()
    ids = np.arange(32, dtype=np.int64)
    index.add(buf, ids=ids)
    buf[:] = _unit(32, seed=1)  # the caller reuses its buffer
    ids[:] = -7
    assert len(index.inner) == 0  # still queued
    d, u = index.search(rows[:8], 1)
    assert (u[:, 0] == np.arange(8)).all()
    assert np.all(d[:, 0] < 1e-2)


def test_keepalive_ping_does_not_wait_on_the_crew_lock():
    """The port's fix: a keepalive takes only the socket's write lock, so
    a long operation under the crew lock (a snapshot load) does not hold
    the liveness frames back (the reference's ping waits on the lock)."""
    from dawnsearch_tpu_torch.parallel import multihost as mh

    crew = mh.MultihostCrew(ping_interval=0)
    crew.is_leader = True
    live = _LiveSock()
    crew._socks = [live]
    crew._ping_interval = 3600.0  # the ping re-arms its timer: far off
    held, release = threading.Event(), threading.Event()

    def long_op():
        with crew.lock:
            held.set()
            release.wait(60)

    t = threading.Thread(target=long_op, daemon=True)
    t.start()
    assert held.wait(10)
    pinger = threading.Thread(target=crew._ping, daemon=True)
    pinger.start()
    pinger.join(10)
    try:
        assert not pinger.is_alive(), "the ping waited on the crew lock"
        assert crew.pings == 1
        header = np.frombuffer(live.got, np.int64)
        assert header.shape == (8,) and int(header[0]) == mh.OP_PING
    finally:
        release.set()
        t.join(10)
        crew.shutdown()
    assert int(np.frombuffer(live.got, np.int64)[8]) == mh.OP_STOP


# -- the crew's processes ----------------------------------------------------

def _worker() -> int:
    """One process of a 2-process crew on the CPU (2 shards each ->
    a 4-shard index):

        python tests/test_torch_multihost.py <process_id> <num_processes> \\
            <coordinator_port> <data_dir> <scenario>

    "index": the leader drives MultihostShardedIndex directly (adds in
    three batches, auto and explicit ids; searches; an idle gap across
    two keepalive pings; a save) and prints RESULT lines; "node": the
    leader runs a DawnNode on the crew; "failadd": the follower's add
    fails locally. Followers run follower_main."""
    proc, nproc = int(sys.argv[1]), int(sys.argv[2])
    port, data_dir, scenario = sys.argv[3], sys.argv[4], sys.argv[5]
    import torch
    torch.set_num_threads(2)

    from dawnsearch_tpu_torch.config import Config
    from dawnsearch_tpu_torch.parallel import multihost

    cfg = Config(device="cpu", data_dir=data_dir, index_kind="sharded",
                 mesh_shards=4, dist_coordinator=f"127.0.0.1:{port}",
                 dist_num_processes=nproc, dist_process_id=proc,
                 dist_ping_interval=0.5)  # fast pings: exercise keepalive
    multihost.init_distributed(cfg.dist_coordinator, nproc, proc)
    if proc > 0:
        if scenario == "failadd":
            from dawnsearch_tpu_torch.parallel.sharded_index import \
                ShardedFlatIndex

            def boom(self, *a, **k):
                raise RuntimeError("injected follower-local failure")

            ShardedFlatIndex._commit_add = boom
            try:
                multihost.follower_main(cfg)
            except RuntimeError as e:
                print("RESULT " + json.dumps(
                    {"role": "follower", "ok": False, "died": True,
                     "err": str(e)}), flush=True)
                os._exit(0)  # no teardown: the leader may hold gloo state
            print("RESULT " + json.dumps(
                {"role": "follower", "ok": False, "died": False}), flush=True)
            return 0
        multihost.follower_main(cfg)
        print("RESULT " + json.dumps({"role": "follower", "ok": True}),
              flush=True)
        return 0
    return {"node": _leader_node, "failadd": _leader_failadd}.get(
        scenario, _leader_index)(cfg)


def _leader_index(cfg) -> int:
    import time

    from dawnsearch_tpu_torch.node import make_index_factory
    from dawnsearch_tpu_torch.parallel import multihost

    crew = multihost.MultihostCrew(ping_interval=cfg.dist_ping_interval,
                                   coordinator=cfg.dist_coordinator)
    index = make_index_factory(cfg, dim=384, crew=crew)()
    rows = _corpus()
    index.add(rows[:256])
    index.add(rows[256:600])
    # explicit ids on the last batch (the store contract: row id + 1)
    index.add(rows[600:], ids=np.arange(600, 700, dtype=np.int64))
    q = rows[:16]
    d, u = index.search(q, 10)
    d1, u1 = index.search(rows[5], 5)  # odd batch, padded by repetition
    # idle across two keepalive pings: the stream must stay in step
    pings = crew.pings
    deadline = time.monotonic() + 60
    while crew.pings < pings + 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    d2, u2 = index.search(q[:3], 10)
    snap = os.path.join(cfg.data_dir, "crew_snapshot.npz")
    index.save(snap)
    print("RESULT " + json.dumps({
        "role": "leader", "count": len(index),
        "recall": float(_recall(u, rows, q)),
        "self_hits": bool((u[:, 0] == np.arange(len(q))).all()),
        "single_hit": int(u1[0]) == 5,
        "post_idle_hit": bool((u2[:, 0] == np.arange(3)).all()),
        "pings": crew.pings - pings,
        "snapshot": os.path.exists(snap),
        "ids": u.tolist(), "dists": d.tolist(),
    }), flush=True)
    crew.shutdown()
    return 0


def _leader_failadd(cfg) -> int:
    """Leader half of the fail-stop injection: one add whose follower
    half fails, then a search, whose all_gather the follower cannot
    join: it raises (a dead peer) or blocks; either is visible."""
    from dawnsearch_tpu_torch.node import make_index_factory
    from dawnsearch_tpu_torch.parallel import multihost

    crew = multihost.MultihostCrew(ping_interval=0,
                                   coordinator=cfg.dist_coordinator)
    index = make_index_factory(cfg, dim=384, crew=crew)()
    rows = _corpus()[:16]
    state = {"outcome": "blocked"}

    def run():
        try:
            index.add(rows)
            index.flush()  # send now (16 rows sit below the threshold)
            index.search(rows[:2], 5)
            state["outcome"] = "completed"
        except Exception as e:
            state["outcome"] = "raised"
            state["err"] = f"{type(e).__name__}: {e}"[:500]

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60.0)
    print("RESULT " + json.dumps({"role": "leader", **state}), flush=True)
    os._exit(0)  # the follower is gone: no OP_STOP, no teardown


def _leader_node(cfg) -> int:
    """A full DawnNode leading the crew: pages in through the service,
    a query through the provider."""
    from dawnsearch_tpu_torch.node import DawnNode

    cfg.web = False
    node = DawnNode(cfg).start()
    texts = [f"document number {i} about topic {i % 7}" for i in range(40)]
    urls = [f"http://x.example/{i}" for i in range(40)]
    ids = node.service.insert_pages(list(zip(urls, texts, texts)))
    res = node.service.text_search("document number 3", search_remote=False)
    print("RESULT " + json.dumps({
        "role": "leader", "count": len(node.provider.index),
        "inserted": sum(1 for i in ids if i is not None),
        "served": len(res.pages) > 0 and all(i is not None for i in ids),
    }), flush=True)
    node.stop()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    raise SystemExit(_worker())
