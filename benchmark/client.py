"""The load generator: asyncio HTTP/1.1 keep-alive clients, run in worker
processes apart from the node's, so the node's GIL never paces them.

Each request's record is (request index, query index, due, sent, done,
status, results, server seconds, judged results), the times on the
monotonic clock that every process of the machine shares, and the judged
results [(url, distance), ...] only for requests the caller asked to keep
(None elsewhere). A request that fails or times out has status 0.
"""

from __future__ import annotations

import asyncio
import json
import math
import time
import urllib.parse


def search_path(text: str) -> bytes:
    return ("/api/search?q=" + urllib.parse.quote(text)).encode()


class Conn:
    def __init__(self, reader, writer):
        self.reader, self.writer = reader, writer

    @classmethod
    async def open(cls, port: int) -> "Conn":
        return cls(*await asyncio.open_connection("127.0.0.1", port))

    async def get(self, path: bytes) -> tuple[int, bytes]:
        self.writer.write(b"GET " + path + b" HTTP/1.1\r\nHost: bench\r\n\r\n")
        status = int((await self.reader.readline()).split()[1])
        length, close = 0, False
        while True:
            line = await self.reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            key, _, value = line.partition(b":")
            key = key.strip().lower()
            if key == b"content-length":
                length = int(value)
            elif key == b"connection" and value.strip().lower() == b"close":
                close = True
        body = await self.reader.readexactly(length)
        if close:
            self.close()
            raise ConnectionResetError("server closed the connection")
        return status, body

    def close(self) -> None:
        self.writer.close()


async def _one(port: int, pool: asyncio.Queue, item, keep: bool,
               timeout: float, due: float) -> tuple:
    """One request on a connection of `pool` (waiting for a free one: the
    wait counts as the generator's lateness); a broken connection is
    replaced, so the pool keeps its size."""
    req, query, path = item
    conn = await pool.get()
    sent = time.monotonic()
    status, nres, server_s, judged = 0, 0, math.nan, None
    try:
        if conn is None:
            conn = await Conn.open(port)
        code, body = await asyncio.wait_for(conn.get(path), timeout)
        if code == 200:
            out = json.loads(body)
            res = out["results"]
            status, nres, server_s = 200, len(res), float(out["seconds"])
            if keep:
                judged = [(r["url"], float(r["distance"])) for r in res]
        else:
            status = code
    except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError,
            ValueError, KeyError, IndexError):
        if conn is not None:
            conn.close()
        conn = None
    done = time.monotonic()
    pool.put_nowait(conn)
    return (req, query, due, sent, done, status, nres, server_s, judged)


async def _pool(port: int, n: int) -> asyncio.Queue:
    pool: asyncio.Queue = asyncio.Queue()
    for _ in range(n):
        pool.put_nowait(await Conn.open(port))
    return pool


def _close(pool: asyncio.Queue) -> None:
    while not pool.empty():
        c = pool.get_nowait()
        if c is not None:
            c.close()


async def _ready(port: int, n: int, ready, start_q):
    """Open n connections, say so on `ready`, and wait for the start time
    (monotonic) on `start_q`: connecting never falls in the window."""
    pools = [await _pool(port, 1) for _ in range(n)]
    ready.put(True)
    start = await asyncio.get_running_loop().run_in_executor(None,
                                                             start_q.get)
    return pools, start


async def _open_loop(port, items, offsets, keep, timeout, conns, ready,
                     start_q):
    pools, start = await _ready(port, conns, ready, start_q)
    pool: asyncio.Queue = asyncio.Queue()
    for p in pools:
        pool.put_nowait(p.get_nowait())
    tasks = []
    for item, off, k in zip(items, offsets, keep):
        due = start + off
        delay = due - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(asyncio.create_task(
            _one(port, pool, item, k, timeout, due)))
    out = await asyncio.gather(*tasks)
    _close(pool)
    return out


async def _closed_loop(port, items, keep_every, long_queries, clients,
                       seconds, timeout, ready, start_q):
    queue = list(reversed(items))
    out = []
    pools, start = await _ready(port, clients, ready, start_q)
    stop = start + seconds

    async def client(pool):
        while time.monotonic() < stop and queue:
            item = queue.pop()
            keep = item[0] % keep_every == 0 or item[1] in long_queries
            out.append(await _one(port, pool, item, keep, timeout,
                                  math.nan))
        _close(pool)
    await asyncio.gather(*(client(p) for p in pools))
    return out


def open_loop(port: int, items: list, offsets: list, keep: list,
              timeout: float, conns: int, ready, start_q, results) -> None:
    """Send items[i] = (request, query, path) at offsets[i] s after the
    start time that `start_q` gives, on one of `conns` keep-alive
    connections, whatever is outstanding; put the records on `results`."""
    results.put(asyncio.run(_open_loop(port, items, offsets, keep, timeout,
                                       conns, ready, start_q)))


def closed_loop(port: int, items: list, keep_every: int,
                long_queries: set, clients: int, seconds: float,
                timeout: float, ready, start_q, results) -> None:
    """`clients` clients, each sending its next item as soon as its last
    answer came, from the start time that `start_q` gives for `seconds`;
    records onto `results`."""
    results.put(asyncio.run(_closed_loop(port, items, keep_every,
                                         long_queries, clients, seconds,
                                         timeout, ready, start_q)))


def start_workers(procs: list, ready, start_qs: list,
                  lead: float = 0.5) -> float:
    """Start the worker processes, wait until every one has its
    connections open, and give them one start time; returns it."""
    for p in procs:
        p.start()
    for _ in procs:
        ready.get()
    start = time.monotonic() + lead
    for q in start_qs:
        q.put(start)
    return start
