"""The load generator: a child process that sends a run's requests to the
server over sockets, times each, and reduces each body to the fields the
reference compares.  It imports neither torch nor the program.

    python3 benchmark/client.py <job.json>

The job names the port, the loop (``open``: each request sent at its due
time, from a pool of threads; ``closed``: ``clients`` threads, each sending
its next request when the last has been answered, until the window
closes), the window's length and the requests.  The client prints
``ready``, reads the window's start (a ``time.monotonic()`` reading, the
same clock in every process of the machine) from its standard input, runs
the window, waits for every answer (at most ``wait_s`` past the close), and
prints ``done``, then writes the reduced answers to the job's ``out``
(``.npz``) and a summary line to its standard output.

A body is read into one of ``BUFS`` buffers whose pages were touched before
the window, and copied out once its request has been timed, so that the
client's own allocations stay out of the latencies.  Each request's
``head`` (its due time to the response's headers, which the server sends
once the query is set up) splits its latency in two.
"""

from __future__ import annotations

import http.client
import json
import queue
import re
import sys
import threading
import time

import numpy as np

_SITE = re.compile(rb"^([^\t\n]*)\t(\d+)\t[^\t\n]*\t([^\t\n]*)\t([^\t\n]*)"
                   rb"\t[^\t\n]*\t[^\t\n]*\t([^\t\n]*)$", re.M)
_KEY = re.compile(rb"([A-Za-z_][A-Za-z_0-9]*)=")
_VAL = re.compile(rb"=(-?\d+)(?=;|$)")
BUF_BYTES = 32 << 20   # a read buffer; a longer body is read on past it
BUFS = 4


def reduce_body(body: bytes) -> dict:
    """The compared fields of a ``view`` body: the header's presence, the
    sites (chromosomes, positions, REF/ALT, INFO keys and integer values)
    and the trailing ``*``; ``ok`` is False when the body is not such."""
    out = {"ok": False, "marker": False}
    if body.endswith(b"*\n"):
        out["marker"] = True
        body = body[:-2]
    head_end = body.find(b"\n#CHROM")
    if not body.startswith(b"##fileformat") or head_end < 0:
        return out
    nl = body.find(b"\n", head_end + 1)
    rest = body[nl + 1:] if nl >= 0 else b""
    sites = _SITE.findall(rest)
    if len(sites) != rest.count(b"\n") or (rest and not rest.endswith(b"\n")):
        return out
    if not sites:
        out.update(ok=True, chroms=[], pos=np.zeros(0, np.int64),
                   alleles=np.zeros((0, 2), np.uint8), keys=[],
                   info=np.zeros((0, 0), np.int64))
        return out
    chrom, pos, ref, alt, info = zip(*sites)
    if any(len(a) != 1 for a in ref) or any(len(a) != 1 for a in alt):
        return out
    first = _KEY.findall(info[0])
    joined = b";".join(info)
    keys = _KEY.findall(joined)
    vals = _VAL.findall(joined)
    n = len(sites)
    if keys != first * n or len(vals) != len(keys):
        return out
    out.update(
        ok=True, chroms=sorted({c.decode() for c in chrom}),
        pos=np.array(pos).astype(np.int64),
        alleles=np.stack([np.frombuffer(b"".join(ref), np.uint8),
                          np.frombuffer(b"".join(alt), np.uint8)], axis=1),
        keys=[k.decode() for k in first],
        info=np.array(vals).astype(np.int64).reshape(n, len(first)))
    return out


def read_into(resp, buf: bytearray) -> tuple:
    """Read ``resp``'s body into ``buf``: (the bytes in ``buf``, the rest
    of a body that did not fit)."""
    view = memoryview(buf)
    n = 0
    while n < len(buf):
        k = resp.readinto(view[n:])
        if not k:
            return n, b""
        n += k
    return n, resp.read()


def _ms(x: np.ndarray, q: float):
    x = x[np.isfinite(x)]
    return float(np.percentile(x, q) * 1e3) if x.size else None


class Runner:
    def __init__(self, job: dict):
        self.job = job
        self.port = job["port"]
        n = len(job["requests"])
        self.t_due = np.full(n, np.nan)
        self.t_sent = np.full(n, np.nan)
        self.t_done = np.full(n, np.nan)
        self.t_head = np.full(n, np.nan)
        self.status = np.zeros(n, np.int64)
        self.bodies: list = [None] * n
        self.errors: dict = {}
        self.taken = 0
        self._lock = threading.Lock()
        self._bufs: queue.LifoQueue = queue.LifoQueue()
        for _ in range(BUFS):
            self._bufs.put(bytearray(BUF_BYTES))  # zero-filled: every page touched

    def fetch(self, i: int) -> None:
        path = self.job["requests"][i]["path"]
        self.t_sent[i] = time.monotonic()
        try:
            buf = self._bufs.get_nowait()
        except queue.Empty:
            buf = bytearray(BUF_BYTES)
        try:
            conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                              timeout=self.job["timeout_s"])
            try:
                conn.request("GET", path)
                resp = conn.getresponse()
                self.t_head[i] = time.monotonic()
                n, rest = read_into(resp, buf)
            finally:
                conn.close()
        except (OSError, http.client.HTTPException) as e:
            self.errors[i] = f"{type(e).__name__}: {e}"
            self._bufs.put(buf)
            return
        self.t_done[i] = time.monotonic()
        self.status[i] = resp.status
        body = bytes(memoryview(buf)[:n])
        self._bufs.put(buf)
        self.bodies[i] = body + rest if rest else body

    def open_loop(self, t0: float) -> None:
        work: queue.Queue = queue.Queue()

        def worker():
            while True:
                i = work.get()
                if i is None:
                    return
                self.fetch(i)

        pool = [threading.Thread(target=worker, daemon=True)
                for _ in range(self.job["threads"])]
        for t in pool:
            t.start()
        for i, r in enumerate(self.job["requests"]):
            due = t0 + r["due"]
            self.t_due[i] = due
            wait = due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            work.put(i)
        self.taken = len(self.job["requests"])
        for _ in pool:
            work.put(None)
        self._join(pool, t0)

    def closed_loop(self, t0: float) -> None:
        end = t0 + self.job["seconds"]

        def client():
            while True:
                with self._lock:
                    i = self.taken
                    if i >= len(self.job["requests"]) or time.monotonic() >= end:
                        return
                    self.taken += 1
                self.t_due[i] = time.monotonic()
                self.fetch(i)

        pool = [threading.Thread(target=client, daemon=True)
                for _ in range(self.job["clients"])]
        wait = t0 - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        for t in pool:
            t.start()
        self._join(pool, t0)

    def _join(self, pool, t0: float) -> None:
        deadline = t0 + self.job["seconds"] + self.job["wait_s"]
        for t in pool:
            t.join(max(0.0, deadline - time.monotonic()))

    def save(self, path: str) -> dict:
        n = self.taken
        parsed = [reduce_body(b) if b is not None and s == 200 else None
                  for b, s in zip(self.bodies[:n], self.status[:n])]
        counts = np.array([len(p["pos"]) if p and p["ok"] else 0
                           for p in parsed], np.int64)
        widths = np.array([p["info"].shape[1] if p and p["ok"] and len(p["pos"])
                           else 0 for p in parsed], np.int64)

        def cat(key, shape, dtype):
            parts = [p[key] for p in parsed if p and p["ok"] and len(p["pos"])]
            if not parts:
                return np.zeros(shape, dtype)
            return np.concatenate([x.reshape(-1, *shape[1:]) for x in parts])

        info = [p["info"].reshape(-1) for p in parsed
                if p and p["ok"] and len(p["pos"])]
        meta = [{"ok": bool(p and p["ok"]), "marker": bool(p and p["marker"]),
                 "keys": (p or {}).get("keys", []),
                 "chroms": (p or {}).get("chroms", []),
                 "error": self.errors.get(i),
                 "text": (self.bodies[i][:200].decode("latin-1")
                          if self.bodies[i] is not None and not (p and p["ok"])
                          else None)}
                for i, p in enumerate(parsed)]
        np.savez(path, t_due=self.t_due[:n], t_sent=self.t_sent[:n],
                 t_done=self.t_done[:n], status=self.status[:n],
                 n_sites=counts, width=widths,
                 pos=cat("pos", (0,), np.int64),
                 alleles=cat("alleles", (0, 2), np.uint8),
                 info=np.concatenate(info) if info else np.zeros(0, np.int64),
                 meta=np.array(json.dumps(meta)))
        late = self.t_sent[:n] - self.t_due[:n]
        late = late[np.isfinite(late)]
        return {"taken": n, "answered": int(np.isfinite(self.t_done[:n]).sum()),
                "late_p50_ms": float(np.median(late) * 1e3) if late.size else None,
                "late_max_ms": float(late.max() * 1e3) if late.size else None,
                "head_p50_ms": _ms(self.t_head[:n] - self.t_due[:n], 50),
                "head_p95_ms": _ms(self.t_head[:n] - self.t_due[:n], 95)}


def main() -> int:
    with open(sys.argv[1]) as fp:
        job = json.load(fp)
    run = Runner(job)
    print("ready", flush=True)
    t0 = float(sys.stdin.readline())
    if job["loop"] == "open":
        run.open_loop(t0)
    else:
        run.closed_loop(t0)
    print("done", flush=True)
    summary = run.save(job["out"])
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
