"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run makes the cell's cohort from the seed and its database (imported by
the port's importer, with the sample metadata in its ``.spl``; kept by
configuration and seed under ``build/benchmark/inputs/``; reported as
``input_s``, not in ``setup_s``), starts the port's HTTP server in this
process as ``bgt server`` starts it (kernels and CUDA context warmed, on a
port the OS gives) on a thread, sends the mix's warm-up requests, then
drives the window from a child process over sockets (``client.py``).  After
the window it holds every answer to the NumPy reference.  With ``--trace
1`` the window runs under ``torch.profiler`` with spans around the
program's layers, and the per-layer metrics replace the end-to-end ones.

Earlier lines of standard output (``info ...``) give the card, ``input_s``,
the generator's lateness, the count tiers' and kernels' counters over the
window, the peak device memory, the judge's seconds (``judge_s``) and the
run's (``run_s``).  The last line is the result; the last
lines of standard error are the numbers compared, each with its limit.  No
card, fewer cards than the cell asks for, or ``jax``/``bgt_tpu`` loaded in
this process: no result, and a non-zero exit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import http.client  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from benchmark import bcf_writer, cohort, judge, spec, traffic  # noqa: E402
from benchmark.reference import Reference  # noqa: E402
from benchmark.tracing import DeviceWindow, Readings, Spans  # noqa: E402

WORK = ROOT / "build" / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "bgt_tpu")
WAIT_S = 60.0


def info(key: str, value) -> None:
    print(f"info {key} {json.dumps(value)}", flush=True)


def card_info(torch, device) -> dict:
    """Name, power limit and SM clock of the card, from ``nvidia-smi`` by
    the card's UUID."""
    uuid = torch.cuda.get_device_properties(device).uuid
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader", f"--id=GPU-{uuid}"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        return {"nvidia_smi": res.stderr.strip()}
    name, power, clock = (x.strip() for x in res.stdout.strip().split(","))
    return {"name": name, "power_limit": power, "sm_clock": clock}


def make_inputs(cell: spec.Cell, seed: int, work: Path):
    """The cohort, and its database: the cohort written as a BCF, imported
    by the port's importer (``bgt import``) and given the configuration's
    metadata in its ``.spl``.  The database is kept under a fixed directory
    of the checkout by configuration and seed, as a deployment keeps its
    imported database; the BCF is deleted once imported."""
    from bgt_tpu_torch.query import importer
    name = cell.workload["config"]
    coh = cohort.make_cohort(cell.config, seed)
    d = work / "inputs" / f"{name}-{seed}"
    prefix = d / "db" / name
    if not (d / "stamp").exists():
        shutil.rmtree(d, ignore_errors=True)
        prefix.parent.mkdir(parents=True)
        bcf = d / "in.bcf"
        bcf_writer.write_bcf(str(bcf), coh.chrom, coh.chrom_len, coh.names,
                             coh.pos, coh.ref, coh.alt, coh.codes)
        importer.import_vcf(str(prefix), [str(bcf)])
        Path(str(prefix) + ".spl").write_text(coh.spl_text())
        bcf.unlink()
        (d / "stamp").write_text("ok")
    return coh, str(prefix)


class Server:
    """The port's server as ``bgt server`` starts it (``main_server``),
    serving on a thread."""

    def __init__(self, prefix: str, device, max_gt: int):
        import torch
        from bgt_tpu_torch.io import files
        from bgt_tpu_torch.query.engine import BgtFile
        from bgt_tpu_torch.server import server
        dev = torch.device(device)
        if dev.type == "cuda":
            server._warm_up(dev)
        files.no_file = True
        cfg = server.ServerConfig()
        cfg.port = 0
        cfg.max_gt = max_gt
        cfg.files = [BgtFile(prefix)]
        cfg.prefixes = [os.path.basename(prefix)]
        self.srv = server.make_server(cfg, dev)
        self.port = self.srv.server_address[1]
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       name="bench-server", daemon=True)
        self.thread.start()

    def get(self, path: str) -> tuple:
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=600)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def close(self) -> None:
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=30)


def drive(server: Server, mix: dict, reqs: list, seconds: float, scratch: Path,
          on_start=None, on_stop=None) -> tuple:
    """Run the window from the client process, calling ``on_start`` before
    it opens and ``on_stop`` once the last answer is in; returns (its start
    on ``time.monotonic``, its start and end on ``time.perf_counter``, the
    client's summary, its answers' path)."""
    out = scratch / "answers.npz"
    job = {"port": server.port, "loop": mix["loop"], "seconds": seconds,
           "clients": mix.get("clients", 1), "threads": 64,
           "wait_s": WAIT_S, "timeout_s": seconds + WAIT_S + 60,
           "out": str(out),
           "requests": [{"path": r.path, "due": r.due or 0.0} for r in reqs]}
    job_path = scratch / "job.json"
    job_path.write_text(json.dumps(job))
    proc = subprocess.Popen([sys.executable, str(Path(__file__).parent / "client.py"),
                             str(job_path)], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True)
    try:
        if proc.stdout.readline().strip() != "ready":
            raise RuntimeError("the client did not start")
        if on_start is not None:
            on_start()
        t0 = time.monotonic() + 0.05
        p0 = time.perf_counter() + (t0 - time.monotonic())
        proc.stdin.write(f"{t0!r}\n")
        proc.stdin.flush()
        if proc.stdout.readline().strip() != "done":
            raise RuntimeError("the client stopped in the window")
        p1 = time.perf_counter()
        if on_stop is not None:
            on_stop()
        summary = json.loads(proc.stdout.readline())
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"the client exited {proc.returncode}")
    return t0, p0, p1, summary, out


def latencies(got: judge.Answers, t0: float, seconds: float) -> np.ndarray:
    """Each request's seconds from its due time (closed loop: its send) to
    its last byte; one never answered counts the whole wait."""
    done = np.where(np.isfinite(got.t_done), got.t_done, t0 + seconds + WAIT_S)
    return done - got.t_due


class Session:
    """A cell's set-up: its inputs, the port's import, the server and the
    warm-up; then any number of windows against that server."""

    def __init__(self, cell: spec.Cell, seed: int, device: str, work: Path):
        import torch
        self.cell, self.seed, self.work = cell, seed, work
        self.cuda = torch.device(device).type == "cuda"
        self.scratch = work / "run"
        shutil.rmtree(self.scratch, ignore_errors=True)
        self.scratch.mkdir(parents=True)
        t = time.perf_counter()
        self.coh, prefix = make_inputs(cell, seed, work)
        self.input_s = time.perf_counter() - t
        info("input_s", self.input_s)
        self.max_gt = int(cell.mix.get("max_gt", cell.config["max_gt"]))
        self.server = Server(prefix, device, self.max_gt)
        from bgt_tpu_torch.query import fastpath
        tiers0 = dict(fastpath.TIERS)
        try:
            self.gen = traffic.Generator(cell.mix, cell.config, self.coh, seed)
            for r in self.gen.warmup():
                status, body = self.server.get(r.path)
                if status != 200:
                    raise RuntimeError(f"warm-up {r.path}: {status} {body[:200]!r}")
            if self.cuda:
                torch.cuda.synchronize()
            info("warmup_tiers", {k: v - tiers0[k] for k, v in fastpath.TIERS.items()})
        except BaseException:
            self.server.close()
            raise

    def close(self) -> None:
        self.server.close()

    def requests(self, seconds: float, stream: int = cohort.STREAM_TRAFFIC) -> list:
        n_closed = int(self.cell.mix.get("max_rate_per_s", 10) * seconds) + 64
        return self.gen.window(seconds, n_closed, stream)

    def window(self, mix: dict, reqs: list, seconds: float, trace: bool) -> dict:
        """Drive one window; with ``trace``, under the profiler and spans."""
        import torch
        from bgt_tpu_torch.ops import counts as counts_ops
        from bgt_tpu_torch.query import fastpath
        tiers0 = dict(fastpath.TIERS)
        launches0 = dict(counts_ops.LAUNCHES)
        spans = Spans()
        dwin = DeviceWindow(self.cuda) if trace else None
        if trace:
            spans.install()

        def start():
            if dwin is not None:
                dwin.start()
            spans.on = True

        def stop():
            spans.on = False
            if dwin is not None:
                if self.cuda:
                    torch.cuda.synchronize()
                dwin.stop()

        try:
            t0, p0, p1, summary, path = drive(self.server, mix, reqs, seconds,
                                              self.scratch, start, stop)
        finally:
            spans.remove()
        got = judge.Answers(str(path))
        return {"t0": t0, "host": (p0, p1), "summary": summary, "got": got,
                "spans": spans, "dwin": dwin,
                "tiers": {k: v - tiers0[k] for k, v in fastpath.TIERS.items()},
                "launches": {k: v - launches0[k]
                             for k, v in counts_ops.LAUNCHES.items()}}

    def check(self, reqs: list, got: judge.Answers) -> tuple:
        """(the reference's answers, verdicts, reasons, numbers)."""
        taken = reqs[: got.n]
        answers = Reference(self.coh).answers(taken, self.max_gt)
        verdict, why = judge.verdicts(taken, answers, got, self.coh.chrom)
        return answers, verdict, why, judge.numbers(verdict)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str, work: Path, t_start: float) -> dict:
    import torch
    ses = Session(cell, seed, device, work)
    try:
        reqs = ses.requests(seconds)
        setup_s = time.perf_counter() - t_start - ses.input_s
        w = ses.window(cell.mix, reqs, seconds, trace)
    finally:
        ses.close()
    info("generator", w["summary"])
    info("tiers", w["tiers"])
    info("launches", w["launches"])
    peak = torch.cuda.max_memory_allocated() if ses.cuda else 0
    info("memory_peak_bytes", peak)

    got, t0 = w["got"], w["t0"]
    t = time.perf_counter()
    answers, verdict, why, checked = ses.check(reqs, got)
    info("judge_s", time.perf_counter() - t)
    lat = latencies(got, t0, seconds)
    info("latency", spread(got, lat))

    metrics: dict = {}
    breakdown = None
    dev = {"platform": "gpu" if ses.cuda else "cpu",
           "kind": torch.cuda.get_device_name() if ses.cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        dwin = w["dwin"]
        events, mark = dwin.events(str(ses.scratch))
        answered = int(np.isfinite(got.t_done).sum())
        rd = Readings(w["spans"], answered, w["host"], events, mark, dwin.host,
                      lat * 1e3)
        for m in cell.per_layer:
            v = spec.reader(m["name"])(rd)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = rd.busy_s()
        dev["window_s"] = rd.window_s
        breakdown = {"device_ops": rd.device_ops(), "idle_gaps": rd.idle_gaps()}
    else:
        names = {m["name"] for m in cell.end_to_end}
        unit = {m["name"]: m["unit"] for m in cell.end_to_end}
        if "p50_ms" in names:
            metrics["p50_ms"] = {"value": float(np.percentile(lat, 50)) * 1e3, "unit": unit["p50_ms"]}
        if "p95_ms" in names:
            metrics["p95_ms"] = {"value": float(np.percentile(lat, 95)) * 1e3, "unit": unit["p95_ms"]}
        if "gt_per_s" in names:
            metrics["gt_per_s"] = {"value": gt_per_s(answers, verdict, got, t0, seconds),
                                   "unit": unit["gt_per_s"]}
        metrics["setup_s"] = {"value": setup_s, "unit": unit["setup_s"]}
    return {"checked": checked, "why": why, "attempted": got.n,
            "failed": checked["missing"] + checked["wrong"],
            "metrics": metrics, "device": dev, "breakdown": breakdown,
            "latency_ms": lat * 1e3}


def spread(got: judge.Answers, lat: np.ndarray) -> dict:
    """The slowest request's latency, and how many requests were sent while
    the one before them was still being answered."""
    order = np.argsort(got.t_due, kind="stable")
    due, done = got.t_due[order], got.t_done[order]
    return {"max_ms": float(lat.max() * 1e3) if lat.size else None,
            "overlapped": int((due[1:] < done[:-1]).sum())}


def gt_per_s(answers: list, verdict: list, got: judge.Answers, t0: float,
             seconds: float) -> float:
    """Genotypes (rows of the region x output samples) of the requests
    answered correctly inside the window, per second of the window."""
    in_window = got.t_done <= t0 + seconds
    return sum(a.rows * a.n_out for a, v, w in zip(answers, verdict, in_window)
               if v == "ok" and w) / seconds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.Cell(spec.load(), args.workload)
    cache = WORK / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    import torch
    if not torch.cuda.is_available():
        print("[benchmark] no CUDA device (torch.cuda.is_available() is "
              "False): no result", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"[benchmark] {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible: no result", file=sys.stderr)
        return 2
    info("card", card_info(torch, 0))
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   WORK, T_START)
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"[benchmark] loaded in this process: {found}: no result",
              file=sys.stderr)
        return 3
    for line in res["why"]:
        print(f"[benchmark] wrong: {line}", file=sys.stderr)
    checked = {k: {"value": v, "limit": judge.LIMITS[k]}
               for k, v in res["checked"].items()}
    correct = all(c["value"] <= c["limit"] for c in checked.values())
    out = {"correct": correct, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": res["metrics"],
           "device": res["device"]}
    if res["breakdown"] is not None:
        out["breakdown"] = res["breakdown"]
    out["checked"] = checked
    for k, c in checked.items():
        print(f"checked {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    info("run_s", time.perf_counter() - T_START)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
