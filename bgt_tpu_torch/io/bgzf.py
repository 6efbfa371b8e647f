"""Blocked-gzip (BGZF) I/O with virtual file offsets.

Byte-compatible with the reference implementation (reference bgzf.c): 64 KiB
blocks with an uncompressed payload capped at 0xff00 bytes, raw-deflate bodies
framed by the 18-byte BGZF gzip header carrying the compressed block size, and
a 28-byte empty EOF block on close.  Virtual offsets are
``(compressed_block_start << 16) | offset_within_uncompressed_block``
(reference bgzf.h:129).

The writer reproduces the reference's exact block boundaries (fill the 0xff00
buffer, flush when full — bgzf.c:569-587) so that files written here are
byte-identical to reference output given the same zlib.  The reader mirrors
the reference's post-read offset semantics (bgzf.c:689-714): when a read
exhausts the current block exactly, ``tell()`` reports the next block's start,
which CSI index construction depends on.
"""

from __future__ import annotations

import struct
import zlib

BLOCK_SIZE = 0xFF00  # uncompressed payload per block
MAX_BLOCK_SIZE = 0x10000

# 18-byte gzip header with BC extra field; bytes 16:18 hold (block_size - 1)
_HEADER = b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00\x42\x43\x02\x00"

# Standard 28-byte BGZF EOF marker (empty block, default compression)
EOF_BLOCK = (
    b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00\x42\x43\x02\x00"
    b"\x1b\x00\x03\x00\x00\x00\x00\x00\x00\x00\x00\x00"
)


def _deflate_block(payload: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, zlib.Z_DEFAULT_STRATEGY)
    body = co.compress(payload) + co.flush(zlib.Z_FINISH)
    bsize = len(body) + 18 + 8
    return (
        _HEADER
        + struct.pack("<H", bsize - 1)
        + body
        + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
    )


class BgzfWriter:
    """BGZF writer; with ``threads > 1`` blocks compress in a worker pool
    with ordered writeback (the zlib core releases the GIL), the Python
    equivalent of the reference's pthread write pool (bgzf.c:381-535).

    Note: ``tell()`` virtual offsets are only exact with ``threads == 1``
    (the multithreaded path defers physical writes, like the reference's
    mt writer which is also not seek-accurate mid-stream).
    """

    # segment size for the native compressor: 256 blocks per call amortizes
    # the call overhead and gives every worker thread a full queue
    _NATIVE_SEG = BLOCK_SIZE * 256

    def __init__(self, path_or_fp, level: int = -1, threads: int = 1):
        if hasattr(path_or_fp, "write"):
            self._fp = path_or_fp
            self._own = False
        else:
            self._fp = open(path_or_fp, "wb")
            self._own = True
        self._level = -1 if level < 0 or level > 9 else level
        self._buf = bytearray()
        self._block_address = 0  # compressed offset of the block being filled
        self._pool = None
        self._pending = None
        self._native = None
        self._squeue = None
        if threads > 1:
            from .. import native
            if native.get_lib() is not None:
                # C thread-pool deflate (same zlib parameters, same bytes),
                # pipelined: a single background worker compresses and
                # writes segments in order while the producer keeps
                # assembling records (2-stage pipeline; the reference's
                # bgzf_mt pool overlaps the same way, bgzf.c:381-535)
                import queue
                self._native = native
                self._threads = threads
                self._squeue = queue.Queue(maxsize=3)
                self._swriter_exc = []
                import threading as _threading
                self._swriter = _threading.Thread(
                    target=self._segment_worker, daemon=True,
                    name="bgzf-deflate")
                self._swriter.start()
            else:
                from concurrent.futures import ThreadPoolExecutor
                from collections import deque
                self._pool = ThreadPoolExecutor(max_workers=threads)
                self._pending = deque()
                self._max_pending = threads * 8

    def write(self, data) -> int:
        self._buf += data
        if self._native is not None:
            while len(self._buf) >= self._NATIVE_SEG:
                self._flush_native(final=False)
            return len(data)
        while len(self._buf) >= BLOCK_SIZE:
            self._flush_one(BLOCK_SIZE)
        return len(data)

    def _segment_worker(self) -> None:
        while True:
            payload = self._squeue.get()
            if payload is None:
                return
            try:
                out = self._native.bgzf_deflate(payload, self._level,
                                                self._threads)
                if out is None:
                    raise RuntimeError("native bgzf deflate failed")
                self._fp.write(memoryview(out))
                self._block_address += out.size
            except BaseException as e:  # noqa: BLE001 - surfaced at flush
                self._swriter_exc.append(e)
                # keep draining so the producer's bounded put never blocks
                while self._squeue.get() is not None:
                    pass
                return

    def _flush_native(self, final: bool) -> None:
        n = len(self._buf) if final else \
            (len(self._buf) // BLOCK_SIZE) * BLOCK_SIZE
        if self._swriter_exc:
            # a segment already failed mid-stream: the output is truncated
            # at that segment, so silently continuing would corrupt it
            raise self._swriter_exc[0]
        if getattr(self, "_sfinished", False):
            # the worker already exited (flush-after-flush): compress
            # synchronously so late writes are never silently dropped
            if n:
                out = self._native.bgzf_deflate(
                    memoryview(self._buf)[:n], self._level, self._threads)
                if out is None:
                    raise RuntimeError("native bgzf deflate failed")
                del self._buf[:n]
                self._fp.write(memoryview(out))
                self._block_address += out.size
            return
        if n:
            self._squeue.put(bytes(memoryview(self._buf)[:n]))
            del self._buf[:n]
        if final:
            self._squeue.put(None)
            self._swriter.join()
            self._sfinished = True
            if self._swriter_exc:
                raise self._swriter_exc[0]

    def _drain(self, leave: int) -> None:
        while len(self._pending) > leave:
            blk = self._pending.popleft().result()
            self._fp.write(blk)
            self._block_address += len(blk)

    def _flush_one(self, n: int) -> None:
        payload = bytes(self._buf[:n])
        del self._buf[:n]
        if self._pool is not None:
            self._pending.append(
                self._pool.submit(_deflate_block, payload, self._level))
            self._drain(self._max_pending)
            return
        blk = _deflate_block(payload, self._level)
        self._fp.write(blk)
        self._block_address += len(blk)

    def flush(self) -> None:
        if self._native is not None:
            self._flush_native(final=True)
            return
        while self._buf:
            self._flush_one(min(len(self._buf), BLOCK_SIZE))
        if self._pool is not None:
            self._drain(0)

    def tell(self) -> int:
        """Virtual file offset of the current write position.

        Only meaningful in the synchronous mode: with a native/threaded
        compressor active, ``_block_address`` is advanced by a background
        worker and ``_buf`` can exceed a block, so the value would be racy
        garbage — refuse rather than mislead.
        """
        if self._native is not None or self._pool is not None:
            raise RuntimeError(
                "BgzfWriter.tell() is undefined while a threaded/native "
                "compressor is active; flush() first or open with threads=0")
        return (self._block_address << 16) | (len(self._buf) & 0xFFFF)

    def close(self) -> None:
        if self._fp is None:
            return
        self.flush()
        self._fp.write(EOF_BLOCK)
        if self._pool is not None:
            self._pool.shutdown()
        if self._own:
            self._fp.close()
        self._fp = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BgzfReader:
    """Random-access BGZF reader mirroring the reference's offset semantics."""

    def __init__(self, path_or_fp, cache_blocks: int = 256):
        if hasattr(path_or_fp, "read"):
            self._fp = path_or_fp
            self._own = False
        else:
            self._fp = open(path_or_fp, "rb")
            self._own = True
        # State mirrors reference BGZF: block_address is the *physical* offset
        # of the current block; after exhausting a block it moves to the next
        # block start with offset/length zeroed (bgzf.c:709-713).
        self._block_address = 0
        self._block_offset = 0
        self._block = b""  # uncompressed content of the loaded block ("" = not loaded)
        self._phys = 0  # physical read position of the underlying file
        self._cache: dict[int, tuple[bytes, int]] = {}
        self._cache_blocks = cache_blocks

    def _read_block(self) -> None:
        """Load the block at the current physical position (bgzf_read_block)."""
        address = self._phys
        hit = self._cache.get(address)
        if hit is not None:
            block, size = hit
        else:
            self._fp.seek(address)
            hdr = self._fp.read(18)
            if len(hdr) == 0:
                self._block = b""
                return  # EOF: block_length stays 0
            if len(hdr) < 18 or hdr[:4] != b"\x1f\x8b\x08\x04":
                raise ValueError("bad BGZF header at offset %d" % address)
            bsize = struct.unpack_from("<H", hdr, 16)[0] + 1
            body = self._fp.read(bsize - 18)
            block = zlib.decompress(body[: bsize - 18 - 8], -15)
            size = bsize
            if len(self._cache) >= self._cache_blocks:
                self._cache.pop(next(iter(self._cache)))
            self._cache[address] = (block, size)
        # "Do not reset offset if this read follows a seek."
        if self._block:
            self._block_offset = 0
        self._block_address = address
        self._block = block
        self._phys = address + size

    def read(self, n: int) -> bytes:
        if n <= 0:
            return b""
        out = bytearray()
        while len(out) < n:
            available = len(self._block) - self._block_offset
            if available <= 0:
                self._read_block()
                available = len(self._block) - self._block_offset
                if available <= 0:
                    break
            take = min(n - len(out), available)
            out += self._block[self._block_offset : self._block_offset + take]
            self._block_offset += take
        # Mirror bgzf.c:709-713: when the block is exhausted (including a
        # zero-length EOF block), tell() advances to the raw file position.
        if self._block_offset == len(self._block):
            self._block_address = self._phys
            self._block_offset = 0
            self._block = b""
        return bytes(out)

    def tell(self) -> int:
        return (self._block_address << 16) | (self._block_offset & 0xFFFF)

    def seek(self, voffset: int) -> None:
        self._block_address = voffset >> 16
        self._block_offset = voffset & 0xFFFF
        self._block = b""  # current block not loaded
        self._phys = self._block_address

    def close(self) -> None:
        if self._own and self._fp is not None:
            self._fp.close()
        self._fp = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
