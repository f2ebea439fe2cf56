"""Multi-process tier: one sharded index spanning a crew of processes.

Port of dawnsearch_tpu/parallel/multihost.py. A CLOSED deployment of N
processes (one per host, or several on one host) serves ONE
ShardedFlatIndex whose "shard" axis spans every process's devices:
process p holds shards [p·L, (p+1)·L). Process 0 (the leader) runs the
full DawnNode; processes 1..N-1 run `follower_main`, a loop that learns
each operation from the leader and does its own shards' part of it.

- Start-up: `init_distributed` joins a torch.distributed process group
  (gloo) over a TCP store at dist_coordinator, once per process. The
  control stream is a plain TCP socket from the leader to each follower,
  on the coordinator's host one port up (`control_address`).
- Control plane: a fixed (8,) int64 header frame (opcode + shape
  metadata), then the payload bytes the header determines. The stream
  order is the program order: the leader holds the crew lock across the
  send and the following index work, so the collectives of a search or
  a save pair up across processes by construction.
- Data plane: a search's per-shard (B, k) distances and ids meet in an
  all_gather (ShardedFlatIndex.search_dispatch); a save gathers every
  process's shards to the leader, which writes the single-process
  "sharded" .npz. Both run over gloo on host copies, also on a card:
  NCCL refuses two ranks on one GPU, and a search moves only S·B·k·8
  bytes.
- ADD wire: the leader runs the host half of an insert once
  (ShardedFlatIndex._prepare_add: quantization, stripe plan, blocks) and
  ships the finished blocks; every process writes its own shards' rows
  (_commit_add). Small adds are coalesced on the leader up to
  `flush_rows` rows, or until a search or save must see them.
- Failure model is fail-stop: a process that dies takes the crew down
  (the leader's next send or collective raises; a follower's recv raises
  on EOF or past the liveness bound). Restart the crew.
- A keepalive PING frame (dist_ping_interval, default 60 s) keeps the
  leader's sockets exercised, so a dead follower surfaces at the next
  ping. Unlike the reference's, a ping takes only the socket's write
  lock, not the crew lock, so a long operation under the crew lock (a
  snapshot load) does not hold the pings back.

The leader's SearchProvider sees a `MultihostShardedIndex`: the same
duck-typed index surface with every state-touching entry point prefixed
by a control-stream send. It has no `search_dispatch` (the provider then
serializes searches under its device lock, which the stream order needs)
and is no ShardedFlatIndex (the fused ingest path then opts out, so the
followers never need the encoder).

Shared state contract: every process reads the same config and the same
`data_dir` (shared or replicated): followers load the snapshot bytes the
leader loads. The SQLite store stays leader-only.
"""

from __future__ import annotations

import datetime
import json
import socket
import threading
import time

import numpy as np
import torch

from dawnsearch_tpu_torch.parallel.sharded_index import ShardedFlatIndex, _pow2
from dawnsearch_tpu_torch.utils.logging import METRICS, service_logger

log = service_logger("Multihost")

OP_PING = 0
OP_INIT = 1
OP_SEARCH = 2
OP_ADD = 3
OP_SAVE = 4
OP_STOP = 5

_HEADER_LEN = 8
_HEADER_BYTES = _HEADER_LEN * 8

# Control-socket buffer: ~10 ADD frames of a 256-row f32 batch in flight
# before the leader's sendall blocks.
_SOCK_BUF = 8 << 20
_CONNECT_TIMEOUT_S = 120.0
# A collective that waits longer for a peer fails (a peer that died
# without closing its sockets).
_COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def _world() -> tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int) -> None:
    """Join the gloo process group through a TCP store at `coordinator`
    (host:port; rank 0 hosts the store), once per process. Call sites:
    the CLI right after the config is read, DawnNode.__init__, and
    follower_main; later calls are no-ops."""
    dist = torch.distributed
    if num_processes <= 1 or dist.is_initialized():
        return
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=_COLLECTIVE_TIMEOUT)
    log.info("distributed runtime up: process %d/%d via %s",
             process_id, num_processes, coordinator)


def control_address(coordinator: str, control_port: int = 0
                    ) -> tuple[str, int]:
    """The control stream lives on the coordinator's host, one port up
    by default (dist_control_port overrides)."""
    host, _, port = coordinator.rpartition(":")
    if not host:
        raise ValueError(f"dist_coordinator needs host:port, got "
                         f"{coordinator!r}")
    return host, control_port or int(port) + 1


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            r = sock.recv_into(view[got:], n - got)
        except socket.timeout:
            raise RuntimeError(
                "multihost control stream silent past the liveness "
                "bound (no frame or keepalive ping) — leader host "
                "presumed dead; fail-stop") from None
        if r == 0:
            raise RuntimeError(
                "multihost control stream closed by the leader "
                "(crew is down — fail-stop)")
        got += r
    return buf


class MultihostCrew:
    """The TCP control plane shared by the leader's wrapper and the
    follower loop. `lock` orders operations: the leader holds it across
    a send and the index work that follows. `_wire` makes each frame
    group one write on the sockets; a keepalive ping takes only that."""

    def __init__(self, ping_interval: float = 60.0,
                 coordinator: str = "", control_port: int = 0):
        rank, self.n_processes = _world()
        self.is_leader = rank == 0
        self.rank = rank
        self.lock = threading.RLock()
        self._wire = threading.Lock()
        self._ping_interval = ping_interval
        self._timer: threading.Timer | None = None
        self._timer_lock = threading.Lock()
        self._stopped = False
        self.pings = 0  # keepalive frames sent
        self._socks: list[socket.socket] = []  # leader: one per follower
        self._sock: socket.socket | None = None  # follower: to the leader
        if self.n_processes > 1:
            host, port = control_address(coordinator, control_port)
            if self.is_leader:
                self._accept_followers(host, port)
            else:
                self._connect_leader(host, port)
        if self.is_leader and ping_interval > 0:
            self._schedule_ping()

    # -- connection setup ----------------------------------------------------

    def _accept_followers(self, host: str, port: int) -> None:
        """Bind the coordinator host's interface (not 0.0.0.0: the
        control stream carries index writes) and accept every follower."""
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((host, port))
        ls.listen(self.n_processes - 1)
        ls.settimeout(_CONNECT_TIMEOUT_S)
        try:
            for _ in range(self.n_processes - 1):
                conn, addr = ls.accept()
                conn.settimeout(None)
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                _SOCK_BUF)
                pid = int(np.frombuffer(_recv_exact(conn, 8), np.int64)[0])
                self._socks.append(conn)
                log.info("control stream up: follower %d from %s", pid, addr)
        finally:
            ls.close()

    def _connect_leader(self, host: str, port: int) -> None:
        deadline = time.monotonic() + _CONNECT_TIMEOUT_S
        while True:
            try:
                s = socket.create_connection((host, port), timeout=5.0)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.1)  # the leader binds in its crew constructor
        # Liveness bound: a leader host that dies without FIN/RST must not
        # leave this follower in recv_into forever. Pings satisfy a recv
        # timeout of many intervals; SO_KEEPALIVE covers crews without
        # pings at the TCP layer.
        if self._ping_interval > 0:
            s.settimeout(max(10.0 * self._ping_interval, 300.0))
        else:
            s.settimeout(None)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, _SOCK_BUF)
        s.sendall(np.int64(self.rank).tobytes())
        self._sock = s

    # -- leader side ----------------------------------------------------------

    def _send_frames(self, header: np.ndarray, payloads: tuple) -> None:
        """One ordered write per follower socket: header frame, then
        payload bytes. A follower that stopped reading eventually blocks
        the leader here; a dead socket raises (fail-stop)."""
        bufs = [header.tobytes()]
        bufs += [memoryview(np.ascontiguousarray(p)).cast("B")
                 for p in payloads]
        for s in self._socks:
            for b in bufs:
                s.sendall(b)

    def send(self, op: int, meta: tuple = (), payloads: tuple = ()) -> None:
        header = np.zeros(_HEADER_LEN, np.int64)
        header[0] = op
        header[1:1 + len(meta)] = meta
        with self.lock, self._wire:
            # re-checked under the lock: after shutdown() sent OP_STOP the
            # followers are gone, and the op's collective would have no
            # peers; fail fast instead
            if self._stopped and op != OP_STOP:
                if op == OP_PING:
                    return  # a late keepalive: just stop pinging
                raise RuntimeError(
                    "multihost crew stopped; op rejected (followers "
                    "already released by OP_STOP)")
            self._send_frames(header, payloads)

    def _schedule_ping(self) -> None:
        with self._timer_lock:
            if self._stopped:
                return
            self._timer = threading.Timer(self._ping_interval, self._ping)
            self._timer.daemon = True
            self._timer.start()

    def _ping(self) -> None:
        """One keepalive frame, under the socket's write lock only: an
        operation holding the crew lock for long does not delay it, and
        it never lands inside another op's frames."""
        header = np.zeros(_HEADER_LEN, np.int64)
        header[0] = OP_PING
        try:
            with self._wire:
                if self._stopped:
                    return  # lost the race to shutdown(): stop pinging
                self._send_frames(header, ())
                self.pings += 1
        except Exception:
            log.exception("keepalive ping failed")
        self._schedule_ping()

    def shutdown(self) -> None:
        """Stop the keepalive and release the followers (OP_STOP)."""
        if self._stopped:
            return
        self._stopped = True
        with self._timer_lock:
            if self._timer is not None:
                self._timer.cancel()
        if self.is_leader:
            self._send_stop()

    def _send_stop(self) -> None:
        """Release the followers: per-socket OP_STOP sends, so one
        follower that died earlier keeps the release from neither the
        healthy ones nor the caller's shutdown."""
        header = np.zeros(_HEADER_LEN, np.int64)
        header[0] = OP_STOP
        hb = header.tobytes()
        with self.lock, self._wire:
            for s in self._socks:
                try:
                    s.sendall(hb)
                except OSError:
                    log.warning("OP_STOP skipped a dead follower "
                                "socket (it already failed stop)")
                try:
                    s.close()  # close flushes queued frames first
                except OSError:
                    pass

    # -- follower side ---------------------------------------------------------

    def recv_header(self) -> np.ndarray:
        if self._sock is None:
            raise RuntimeError("recv_header on a crew with no control "
                               "stream (single-process or leader)")
        return np.frombuffer(_recv_exact(self._sock, _HEADER_BYTES),
                             np.int64)

    def recv(self, shape: tuple, dtype) -> np.ndarray:
        if self._sock is None:
            raise RuntimeError("recv on a crew with no control stream")
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        return np.frombuffer(_recv_exact(self._sock, n),
                             dtype).reshape(shape)


def _gather_to_leader(a: np.ndarray | None) -> np.ndarray | None:
    """Collective: every process's (L, ...) array, concatenated in rank
    order on the leader ((S, ...)); None on the followers. Moves bytes,
    so every dtype crosses gloo."""
    if a is None:
        return None
    rank, world = _world()
    if world == 1:
        return a
    a = np.ascontiguousarray(a)
    flat = torch.from_numpy(a.reshape(-1).view(np.uint8).copy())
    outs = [torch.empty_like(flat) for _ in range(world)] if rank == 0 \
        else None
    torch.distributed.gather(flat, outs, dst=0)
    if rank != 0:
        return None
    whole = np.concatenate([o.numpy() for o in outs])
    return whole.view(a.dtype).reshape((world * a.shape[0],) + a.shape[1:])


def _gather_snapshot(inner) -> dict | None:
    """Collective: gather every process's shards to the leader and
    package them in the exact array set ShardedFlatIndex.deferred_save
    writes, so the snapshot is byte-identical in layout to a
    single-process one. None on the followers."""
    local = inner.local_arrays()
    arrays = {k: _gather_to_leader(v) for k, v in local.items()}
    if _world()[0] != 0:
        return None
    return inner.snapshot_fields(arrays)


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _pack_plan(plan: dict) -> tuple[tuple, tuple]:
    """Serialize a _prepare_add plan into (meta, one uint8 payload).
    Layout (every section 8-byte aligned so the follower can view
    in place): row_blocks | scale_blocks? | exact_blocks? | id_blocks |
    lens | starts | ids."""
    parts = [plan["row_blocks"]]
    if plan["scale_blocks"] is not None:
        parts.append(plan["scale_blocks"])
    if plan["exact_blocks"] is not None:
        parts.append(plan["exact_blocks"])
    parts += [plan["id_blocks"], plan["lens"], plan["starts"], plan["ids"]]
    sizes = [_pad8(p.nbytes) for p in parts]
    buf = np.zeros(sum(sizes), np.uint8)
    off = 0
    for p, sz in zip(parts, sizes):
        buf[off:off + p.nbytes] = np.ascontiguousarray(p).reshape(-1) \
            .view(np.uint8)
        off += sz
    S, max_rows = plan["id_blocks"].shape
    n = plan["ids"].shape[0]
    dim = plan["row_blocks"].shape[2]
    meta = (S, max_rows, n, dim, plan["grown_cap"])
    return meta, (buf,)


def _unpack_plan(inner, h: np.ndarray, buf: np.ndarray) -> dict:
    """Inverse of _pack_plan, shapes from the header + the follower's
    own (identical) index config."""
    S, max_rows, n, dim, grown_cap = (int(h[1]), int(h[2]), int(h[3]),
                                      int(h[4]), int(h[5]))
    row_dt = {"f32": np.float32, "bf16": np.float32, "i8": np.int8,
              "i4": np.uint8}[inner.dtype]
    has_scales = inner.dtype in ("i8", "i4")
    has_exact = inner.exact is not None
    off = 0

    def take(shape, dtype):
        nonlocal off
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        a = buf[off:off + nbytes].view(dtype).reshape(shape)
        off += _pad8(nbytes)
        return a

    plan = dict(grown_cap=grown_cap)
    plan["row_blocks"] = take((S, max_rows, dim), row_dt)
    plan["scale_blocks"] = (take((S, max_rows), np.float32)
                            if has_scales else None)
    plan["exact_blocks"] = (take((S, max_rows, dim), np.float16)
                            if has_exact else None)
    plan["id_blocks"] = take((S, max_rows), np.int32)
    plan["lens"] = take((S,), np.int32)
    plan["starts"] = take((S,), np.int32)
    plan["ids"] = take((n,), np.int64)
    return plan


def _plan_bytes(inner, h: np.ndarray) -> int:
    """The ADD payload's size from its header and the index's config."""
    S, max_rows, n, dim = int(h[1]), int(h[2]), int(h[3]), int(h[4])
    row = {"f32": 4, "bf16": 4, "i8": 1, "i4": 1}[inner.dtype]
    nbytes = _pad8(S * max_rows * dim * row)
    if inner.dtype in ("i8", "i4"):
        nbytes += _pad8(S * max_rows * 4)
    if inner.exact is not None:
        nbytes += _pad8(S * max_rows * dim * 2)
    nbytes += _pad8(S * max_rows * 4)  # id_blocks
    nbytes += 2 * _pad8(S * 4)         # lens, starts
    nbytes += _pad8(n * 8)             # ids
    return nbytes


class MultihostShardedIndex:
    """Leader-side index: ShardedFlatIndex surface, send-prefixed.

    Wraps (not subclasses) so the fused serving paths' isinstance gates
    reject it and every mutation/search funnels through add()/search()
    — the two entry points the followers mirror."""

    def __init__(self, inner, crew: MultihostCrew, flush_rows: int = 8192):
        self.inner = inner
        self.crew = crew
        # ADD coalescing: pending host rows await one combined send. All
        # pending state is guarded by crew.lock (the lock that orders the
        # stream, so flush-before-search is race-free). flush_rows <= 1
        # sends every add at once.
        self.flush_rows = max(1, int(flush_rows))
        self._pending: list[tuple[np.ndarray, np.ndarray]] = []
        self._pending_n = 0
        self._pending_next = inner._next_id

    # -- delegated read-only surface ---------------------------------------

    def __len__(self) -> int:
        return len(self.inner) + self._pending_n

    @property
    def dim(self) -> int:
        return self.inner.dim

    @property
    def dtype(self) -> str:
        return self.inner.dtype

    @property
    def capacity(self) -> int:
        return self.inner.capacity

    @property
    def max_capacity(self):
        return self.inner.max_capacity

    @property
    def nbytes(self) -> int:
        return self.inner.nbytes

    @property
    def device_rerank(self) -> bool:
        return self.inner.device_rerank

    def device_fetch_width(self, k: int) -> int:
        return self.inner.device_fetch_width(k)

    # -- send-prefixed ops ---------------------------------------------------

    def add(self, vectors, ids=None) -> np.ndarray:
        # a copy: the rows may wait in the queue past the caller's return,
        # and the caller may reuse its buffer (the reference keeps the
        # caller's array)
        rows = np.array(vectors.cpu() if isinstance(vectors, torch.Tensor)
                        else vectors, np.float32, copy=True)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.ndim != 2 or rows.shape[1] != self.inner.dim:
            raise ValueError(f"expected (n, {self.inner.dim}) rows, got "
                             f"{rows.shape}")
        n = rows.shape[0]
        if n == 0:
            return np.empty((0,), np.int64)
        with self.crew.lock:
            # Deterministic refusal HERE, against committed + pending
            # occupancy, so the deferred flush can never refuse and the
            # followers never see a refused op. Same condition as
            # ShardedFlatIndex._plan_insert.
            free = self.inner.free_slots()
            if free is not None and self._pending_n + n > free:
                from dawnsearch_tpu_torch.index.flat import IndexFull
                raise IndexFull(
                    f"sharded index full: {n} rows, "
                    f"{max(0, free - self._pending_n)} free slots")
            if ids is None:
                # ids are fixed here, so the wire pins them: both sides
                # insert identical (row, id) pairs by contract
                ids = np.arange(self._pending_next,
                                self._pending_next + n, dtype=np.int64)
            ids = np.array(ids, np.int64, copy=True)
            if len(ids) != n:
                raise ValueError("ids/rows length mismatch")
            self._pending_next = max(self._pending_next, int(ids.max()) + 1)
            self._pending.append((rows, ids))
            self._pending_n += n
            if self._pending_n >= self.flush_rows:
                self._flush_pending()
            return ids

    def _flush_pending(self) -> None:
        """Send + commit every queued add as ONE prepared plan. Caller
        holds crew.lock."""
        if not self._pending:
            return
        if len(self._pending) == 1:
            rows, ids = self._pending[0]
        else:
            rows = np.concatenate([r for r, _ in self._pending])
            ids = np.concatenate([i for _, i in self._pending])
        self._pending.clear()
        self._pending_n = 0
        # the host half once, on the leader (cannot refuse: add()
        # pre-checked occupancy)
        plan = self.inner._prepare_add(rows, ids)
        meta, payloads = _pack_plan(plan)
        self.crew.send(OP_ADD, meta, payloads)
        self.inner._commit_add(plan)
        self._pending_next = max(self._pending_next, self.inner._next_id)

    def flush(self) -> None:
        """Commit pending adds now (search/save do this implicitly)."""
        with self.crew.lock:
            self._flush_pending()

    def search(self, queries, k: int):
        q = np.asarray(queries, np.float32)
        single = q.ndim == 1
        if single:
            q = q[None, :]
        B = q.shape[0]
        Bp = _pow2(B)
        qp = np.empty((Bp, q.shape[1]), np.float32)
        qp[:B] = q
        qp[B:] = q[0]  # pad by repetition: padding must stay unit-norm
        with self.crew.lock:
            self._flush_pending()  # results must observe queued adds
            self.crew.send(OP_SEARCH, (Bp, B, k, q.shape[1]), (qp,))
            d, u = self.inner.search(qp, k)
        d, u = d[:B], u[:B]
        if single:
            return d[0], u[0]
        return d, u

    def save(self, path: str) -> None:
        self.deferred_save()(path)

    def deferred_save(self):
        """Gather every process's shards to the leader now (all
        processes in lockstep, under the crew lock); the file write is
        deferred to the returned callable."""
        with self.crew.lock:
            self._flush_pending()  # the snapshot must hold queued adds
            self.crew.send(OP_SAVE)
            fields = _gather_snapshot(self.inner)
        descr = self.inner.snapshot_descr()

        def write(path: str) -> None:
            from dawnsearch_tpu_torch.index.flat import _atomic_savez
            _atomic_savez(path, descr=descr, **fields)

        return write


def build_fresh(crew: MultihostCrew, make_inner, dim: int,
                flush_rows: int = 8192) -> MultihostShardedIndex:
    """Announce INIT(fresh), then construct, under the crew lock: the
    followers build their replica at the same point of the stream. A
    second INIT (the provider discarded a stale snapshot and rebuilt)
    makes the followers rebuild too."""
    with crew.lock:
        crew.send(OP_INIT, (0, dim))
        inner = make_inner()
    return MultihostShardedIndex(inner, crew, flush_rows=flush_rows)


def crew_sharded_loader(crew: MultihostCrew, flush_rows: int = 8192):
    """`load_index(_sharded_loader=...)` hook: announce INIT(loaded)
    before loading, then load + wrap under the crew lock. If the load
    raises, the follower loading the same snapshot bytes raises
    identically and returns to its INIT wait, while the provider falls
    back to the factory, which announces a fresh INIT."""
    def load(path: str, kwargs: dict) -> MultihostShardedIndex:
        with np.load(path, allow_pickle=False) as z:
            dim = int(z["dim"])
        with crew.lock:
            crew.send(OP_INIT, (1, dim))
            inner = ShardedFlatIndex.load(path, **kwargs)
        return MultihostShardedIndex(inner, crew, flush_rows=flush_rows)

    return load


def _no_index(op: str) -> RuntimeError:
    return RuntimeError(
        f"follower got {op} with no index (INIT failed locally while the "
        "leader's succeeded) — failing stop rather than desyncing the "
        "collective")


def run_follower(crew: MultihostCrew, cfg, index_path: str) -> None:
    """The follower loop: build or load the index replica on INIT, then
    mirror every stream op until OP_STOP. Payloads are received
    unconditionally (a skipped recv would desync the stream). Only
    deterministic host-side refusals (ValueError, IndexFull), which
    raised identically on the leader before any collective, are skipped
    on both sides. Anything else (a device fault, an out-of-memory)
    propagates and ends this process: the leader has entered or will
    enter a collective this process can no longer match, and the crew
    must go down visibly rather than desync at the next one. An op
    arriving while this follower has no index is the same fail-stop."""
    from dawnsearch_tpu_torch.index import load_index
    from dawnsearch_tpu_torch.index.flat import IndexFull
    from dawnsearch_tpu_torch.node import make_index_factory

    inner = None
    while True:
        h = crew.recv_header()
        op = int(h[0])
        if op == OP_PING:
            continue
        if op == OP_STOP:
            log.info("follower released")
            return
        if op == OP_INIT:
            loaded, dim = int(h[1]), int(h[2])
            factory = make_index_factory(cfg, dim=dim)
            try:
                if loaded:
                    inner = load_index(index_path, **factory.load_kwargs())
                else:
                    inner = factory()
            except Exception:
                # the leader's twin load raised the same way (same
                # snapshot bytes, same code); it announces a fresh INIT
                # from its factory fallback next
                inner = None
                log.exception("follower INIT failed; awaiting re-INIT")
                continue
            log.info("follower index ready (loaded=%d, dim=%d, %d rows)",
                     loaded, dim, len(inner))
            continue
        if op == OP_SEARCH:
            bp, k, dim = int(h[1]), int(h[3]), int(h[4])
            q = crew.recv((bp, dim), np.float32)
            if inner is None:
                raise _no_index("SEARCH")
            try:
                inner.search(q, k)
            except (ValueError, IndexFull):
                # refused identically on the leader before its collective
                log.exception("follower search refused (leader too)")
        elif op == OP_ADD:
            if inner is None:
                # even the payload's size needs the index's dtype
                raise _no_index("ADD")
            buf = crew.recv((_plan_bytes(inner, h),), np.uint8)
            inner._commit_add(_unpack_plan(inner, h, buf))
        elif op == OP_SAVE:
            if inner is None:
                raise _no_index("SAVE")
            try:
                _gather_snapshot(inner)  # take part; the leader writes
            except (ValueError, IndexFull):
                log.exception("follower save-gather refused (leader too)")
        else:
            log.warning("unknown op %d — ignored", op)


def follower_main(cfg) -> None:
    """Entry point of `python -m dawnsearch_tpu_torch` when
    dist_process_id > 0: join the crew and mirror the leader until
    OP_STOP. No encoder, store or front end."""
    import os

    from dawnsearch_tpu_torch.index.provider import INDEX_FILE
    from dawnsearch_tpu_torch.node import check_config

    check_config(cfg)
    init_distributed(cfg.dist_coordinator, cfg.dist_num_processes,
                     cfg.dist_process_id)
    crew = MultihostCrew(ping_interval=cfg.dist_ping_interval,
                         coordinator=cfg.dist_coordinator,
                         control_port=cfg.dist_control_port)
    run_follower(crew, cfg, os.path.join(cfg.data_dir, INDEX_FILE))
    # the follower has no /api/metrics: its kernel launches go to its log
    launched = {k: v for k, v in METRICS.snapshot().items()
                if k.startswith("kernel_") and v}
    log.info("follower stopped; kernel launches %s", json.dumps(launched))
