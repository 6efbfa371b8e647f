"""Build and load the port's hand-written CUDA kernels.

The sources under ``bgt_tpu_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a``, one ``nvcc`` per source, all started together, and linked into
one shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  The build runs at first use,
never at import, into ``build/torch_kernels/`` of the checkout, and is keyed
on a hash of the sources and flags, so a rebuild happens only when they
change.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
# flags of each source's compile; the objects are then linked with -shared
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: list = [None]
# what the last load did: {"path", "cached", "seconds", "ptxas"}
build_info: dict = {}


def _sources() -> list[Path]:
    return sorted(p for p in _SRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def _build() -> Path:
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    so = BUILD_DIR / f"libbgt_torch_kernels-{h.hexdigest()[:16]}.so"
    if so.exists():
        build_info.update(path=str(so), cached=True, seconds=0.0, ptxas="")
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(prefix=f"{so.stem}.", dir=BUILD_DIR))
    try:
        t0 = time.perf_counter()
        jobs = [(cu, work / f"{cu.stem}.o") for cu in srcs if cu.suffix == ".cu"]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(cu), "-o", str(obj)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cu, obj in jobs]
        logs = [p.communicate()[0] for p in procs]
        for (cu, _), p, out in zip(jobs, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {cu.name} "
                                   f"({p.returncode}):\n{out}")
        tmp = work / so.name
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                              *(str(obj) for _, obj in jobs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(tmp, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    build_info.update(path=str(so), cached=False,
                      seconds=time.perf_counter() - t0, ptxas="".join(logs))
    return so


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    with _lock:
        if _lib[0] is None:
            lib = ctypes.CDLL(str(_build()))
            vp = ctypes.c_void_p
            lib.bgt_count_codes.argtypes = [vp, vp, vp, vp, vp,
                                            ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int, vp]
            lib.bgt_count_codes.restype = ctypes.c_int
            lib.bgt_count_raw.argtypes = [vp, vp, vp, vp, ctypes.c_longlong,
                                          ctypes.c_int, ctypes.c_int, vp]
            lib.bgt_count_raw.restype = ctypes.c_int
            lib.bgt_count_codes_narrow.argtypes = [
                vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, vp]
            lib.bgt_count_codes_narrow.restype = ctypes.c_int
            lib.bgt_pbwt_decode.argtypes = [vp] * 8 + [ctypes.c_int] * 3 + [vp]
            lib.bgt_pbwt_decode.restype = ctypes.c_int
            lib.bgt_pbwt_decode_plan.argtypes = [ctypes.c_int] * 4 + [
                ctypes.POINTER(ctypes.c_int)]
            lib.bgt_pbwt_decode_plan.restype = ctypes.c_int
            _lib[0] = lib
        return _lib[0]
