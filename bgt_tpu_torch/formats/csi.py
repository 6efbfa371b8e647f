"""CSI binning index with the reference's RNI record-number extension.

Functional equivalent of the reference index layer (reference hts.c:149-907):
binning index per contig with linear-index loff values, bin-merge compression,
chunk-list region queries, and the non-standard ``RNI\\1`` footer storing the
BGZF virtual offset of every ``2^rec_shift``-th record, which enables
"seek to the i-th record" paging (hts.c:394-400, 536-542, 902-907).

The on-disk CSI payload is written in the reference's khash iteration order
(via the :class:`_KhashLayout` simulator), so `.csi` files are byte-identical
to the reference's — whole-database md5 comparison passes on all four files.
"""

from __future__ import annotations

import struct

from ..io.bgzf import BgzfReader, BgzfWriter

HTS_MIN_MARKER_DIST = 0x10000
HTS_DEF_REC_SHIFT = 10


def bin_first(l: int) -> int:
    return ((1 << (3 * l)) - 1) // 7


def bin_parent(b: int) -> int:
    return (b - 1) >> 3


def reg2bin(beg: int, end: int, min_shift: int, n_lvls: int) -> int:
    end -= 1
    l = n_lvls
    s = min_shift
    t = ((1 << (3 * n_lvls)) - 1) // 7
    while l > 0:
        if beg >> s == end >> s:
            return t + (beg >> s)
        l -= 1
        s += 3
        t -= 1 << (3 * l)
    return 0


def bin_bot(b: int, n_lvls: int) -> int:
    l, x = 0, b
    while x:
        l += 1
        x = bin_parent(x)
    return (b - bin_first(l)) << (n_lvls - l) * 3


def reg2bins(beg: int, end: int, min_shift: int, n_lvls: int) -> list[int]:
    out = []
    s = min_shift + 3 * n_lvls
    if beg >= end:
        return out
    if end >= 1 << s:
        end = 1 << s
    end -= 1
    t = 0
    for l in range(n_lvls + 1):
        b = t + (beg >> s)
        e = t + (end >> s)
        out.extend(range(b, e + 1))
        s -= 3
        t += 1 << ((l << 1) + l)
    return out


class _KhashLayout:
    """khash.h bucket-layout simulator for int keys (reference khash.h).

    Replays the reference's FULL kh_put sequence — including duplicate
    puts: a put of an existing key still triggers the resize check, and
    when occupancy sits exactly at the 0.77 bound that duplicate grows the
    table (observed with the finish-time pseudo-bin re-put), changing the
    final bucket layout — so :meth:`HtsIndex.save` can emit bins in the
    exact hash-table iteration order the reference writes (hts.c:465-476),
    making the .csi byte-identical.  Faithful details:
    kh_int_hash_func(key)=key, double hashing inc=((k>>3 ^ k<<3)|1)&mask,
    0.77 upper bound, kroundup32 table sizes (min 4), and the in-place
    kick-out rehash whose insertion order differs from a plain scan
    (khash.h:214-269).
    """

    _EMPTY, _DEL, _OCC = 2, 1, 0

    def __init__(self):
        self.n_buckets = 0
        self.size = 0  # == n_occupied: no deletions during the put phase
        self.upper_bound = 0
        self.flags: list[int] = []
        self.keys: list[int] = []

    @staticmethod
    def _inc(k: int, mask: int) -> int:
        return (((k >> 3) ^ ((k << 3) & 0xFFFFFFFF)) | 1) & mask

    def _resize(self, new_n: int) -> None:
        # kroundup32, min 4 (khash.h:219-220)
        if new_n > 0:
            n = new_n - 1
            n |= n >> 1
            n |= n >> 2
            n |= n >> 4
            n |= n >> 8
            n |= n >> 16
            new_n = n + 1
        if new_n < 4:
            new_n = 4
        if self.size >= int(new_n * 0.77 + 0.5):
            return  # requested size too small
        old_n = self.n_buckets
        if old_n < new_n:
            self.keys.extend([0] * (new_n - old_n))
        new_flags = [self._EMPTY] * new_n
        mask = new_n - 1
        for j in range(old_n):
            if self.flags[j] != self._OCC:
                continue
            key = self.keys[j]
            self.flags[j] = self._DEL
            while True:  # kick-out process (khash.h:240-257)
                k = key & 0xFFFFFFFF
                i = k & mask
                inc = self._inc(k, mask)
                while new_flags[i] != self._EMPTY:
                    i = (i + inc) & mask
                new_flags[i] = self._OCC
                if i < old_n and self.flags[i] == self._OCC:
                    self.keys[i], key = key, self.keys[i]
                    self.flags[i] = self._DEL
                else:
                    self.keys[i] = key
                    break
        del self.keys[new_n:]
        self.flags = new_flags
        self.n_buckets = new_n
        self.upper_bound = int(new_n * 0.77 + 0.5)

    def put(self, key: int) -> None:
        if self.size >= self.upper_bound:
            if self.n_buckets > (self.size << 1):
                self._resize(self.n_buckets - 1)
            else:
                self._resize(self.n_buckets + 1)
        mask = self.n_buckets - 1
        k = key & 0xFFFFFFFF
        i = k & mask
        if self.flags[i] != self._EMPTY:
            inc = self._inc(k, mask)
            while (self.flags[i] != self._EMPTY
                   and (self.flags[i] == self._DEL or self.keys[i] != key)):
                i = (i + inc) & mask
        if self.flags[i] == self._EMPTY:
            self.keys[i] = key
            self.flags[i] = self._OCC
            self.size += 1

    def order(self) -> list[int]:
        """Keys in bucket-iteration order (kh_begin..kh_end)."""
        return [self.keys[i] for i in range(self.n_buckets)
                if self.flags[i] == self._OCC]


class HtsIndex:
    """Binning + linear + record-number index for one BGZF-compressed BCF."""

    def __init__(self, n_ctg: int, min_shift: int, n_lvls: int, offset0: int = 0):
        self.min_shift = min_shift
        self.n_lvls = n_lvls
        self.n_bins = ((1 << (3 * n_lvls + 3)) - 1) // 7
        self.rec_shift = HTS_DEF_REC_SHIFT
        self.n = n_ctg
        self.bidx: list[dict[int, list]] = [dict() for _ in range(n_ctg)]
        self.lidx: list[list[int]] = [[] for _ in range(n_ctg)]
        self.loff: list[dict[int, int]] = [dict() for _ in range(n_ctg)]
        # per-contig FULL kh_put sequence (duplicates included — they can
        # trigger khash resizes; bins later deleted by the merge pass stay
        # in the sequence as the layout replay needs them)
        self._bin_order: list[list[int]] = [[] for _ in range(n_ctg)]
        self.ridx: list[int] = []
        self.n_rec = 0
        self.n_no_coor = 0
        self._finished = False
        # builder state (mirrors hts.c z struct)
        self._save_bin = self._last_bin = -1
        self._save_tid = self._last_tid = -1
        self._last_coor = -1
        self._save_off = self._last_off = offset0
        self._off_beg = self._off_end = offset0
        self._n_mapped = self._n_unmapped = 0

    # --- construction ------------------------------------------------------

    def _insert_b(self, tid: int, b: int, beg: int, end: int) -> None:
        self._bin_order[tid].append(b)  # every put, duplicates included
        if b not in self.bidx[tid]:
            self.bidx[tid][b] = []
        self.bidx[tid][b].append((beg, end))

    def _insert_l(self, tid: int, beg: int, end: int, offset: int) -> None:
        l = self.lidx[tid]
        b = beg >> self.min_shift
        e = (end - 1) >> self.min_shift
        while len(l) < e + 1:
            l.append(-1)
        for i in range(b, e + 1):
            if l[i] < 0:
                l[i] = offset
        # reference records n = e+1 high-water mark implicitly via length

    def push(self, tid: int, beg: int, end: int, offset: int, is_mapped: bool = True) -> int:
        while tid >= len(self.bidx):
            self.bidx.append(dict())
            self.lidx.append([])
            self.loff.append(dict())
            self._bin_order.append([])
        if self.n < tid + 1:
            self.n = tid + 1
        if tid < 0:
            self.n_no_coor += 1
        if self._finished:
            return 0
        if self._last_tid < tid or (self._last_tid >= 0 and tid < 0):
            self._last_tid = tid
            self._last_bin = -1
        elif tid >= 0 and self._last_tid > tid:
            raise ValueError("unsorted chromosomes")
        elif tid >= 0 and self._last_coor > beg:
            raise ValueError("unsorted positions")
        if tid >= 0 and is_mapped:
            self._insert_l(tid, beg, end, self._last_off)
        b = reg2bin(beg, end, self.min_shift, self.n_lvls)
        if self._last_bin != b:
            if self._save_bin != -1:
                self._insert_b(self._save_tid, self._save_bin, self._save_off, self._last_off)
            if self._last_bin == -1 and self._save_bin != -1:
                self._off_end = self._last_off
                self._insert_b(self._save_tid, self.n_bins + 1, self._off_beg, self._off_end)
                self._insert_b(self._save_tid, self.n_bins + 1, self._n_mapped, self._n_unmapped)
                self._n_mapped = self._n_unmapped = 0
                self._off_beg = self._off_end
            self._save_off = self._last_off
            self._save_bin = self._last_bin = b
            self._save_tid = tid
            if tid < 0:
                self.finish(offset)
                return 0
        if self.rec_shift > 0 and (self.n_rec & ((1 << self.rec_shift) - 1)) == 0:
            self.ridx.append(self._last_off)
        if is_mapped:
            self._n_mapped += 1
        else:
            self._n_unmapped += 1
        self._last_off = offset
        self._last_coor = beg
        self.n_rec += 1
        return 0

    def push_batch(self, tid, beg, end, voff) -> None:
        """Vectorized equivalent of one :meth:`push` per record for a whole
        sorted mapped batch (the importer's path; per-record Python pushes
        cost ~2.5 µs each, ~100 s at the 39M-row HRC shape).

        ``voff[i]`` is the BGZF virtual offset AFTER record i (push's
        ``offset`` argument); the offset before record i is
        ``voff[i-1]`` (``offset0`` for i==0), exactly the builder's
        ``_last_off`` state.  Must be called on a fresh index; call
        :meth:`finish` afterwards as usual."""
        import numpy as np
        if self.n_rec or self._finished or self._save_bin != -1:
            raise ValueError("push_batch needs a fresh index")
        tid = np.asarray(tid, np.int64)
        beg = np.asarray(beg, np.int64)
        end = np.asarray(end, np.int64)
        voff = np.asarray(voff, np.uint64)
        n = tid.size
        if n == 0:
            return
        if (tid < 0).any():
            raise ValueError("push_batch handles mapped records only")
        if (np.diff(tid) < 0).any():
            raise ValueError("unsorted chromosomes")
        new_tid = np.empty(n, bool)
        new_tid[0] = True
        new_tid[1:] = tid[1:] != tid[:-1]
        if (np.diff(beg)[~new_tid[1:]] < 0).any():
            raise ValueError("unsorted positions")
        while int(tid.max()) >= len(self.bidx):
            self.bidx.append(dict())
            self.lidx.append([])
            self.loff.append(dict())
            self._bin_order.append([])
        self.n = max(self.n, int(tid.max()) + 1)
        off_before = np.empty(n, np.uint64)
        off_before[0] = self._last_off
        off_before[1:] = voff[:-1]

        # per-record bin (reg2bin vectorized over levels)
        e1 = end - 1
        bins = np.zeros(n, np.int64)
        done = np.zeros(n, bool)
        s = self.min_shift
        t = ((1 << (3 * self.n_lvls)) - 1) // 7
        l = self.n_lvls
        while l > 0:
            hit = ~done & ((beg >> s) == (e1 >> s))
            bins[hit] = t + (beg[hit] >> s)
            done |= hit
            l -= 1
            s += 3
            t -= 1 << (3 * l)

        # (tid, bin) runs of consecutive records -> one chunk per run
        new_run = new_tid.copy()
        new_run[1:] |= bins[1:] != bins[:-1]
        starts = np.nonzero(new_run)[0]
        run_ends = np.empty(starts.size, np.int64)
        run_ends[:-1] = starts[1:] - 1
        run_ends[-1] = n - 1
        u = off_before[starts].tolist()
        v = voff[run_ends].tolist()
        bl = bins[starts].tolist()
        tl = tid[starts].tolist()
        for k in range(starts.size):
            d = self.bidx[tl[k]]
            self._bin_order[tl[k]].append(bl[k])
            if bl[k] not in d:
                d[bl[k]] = []
            d[bl[k]].append((u[k], v[k]))

        # per-tid meta pseudo-bin: file span + (n_mapped, n_unmapped)
        tstarts = np.nonzero(new_tid)[0]
        tends = np.empty(tstarts.size, np.int64)
        tends[:-1] = tstarts[1:] - 1
        tends[-1] = n - 1
        for k in range(tstarts.size):
            i = int(tid[tstarts[k]])
            if self.n_bins + 1 not in self.bidx[i]:
                self.bidx[i][self.n_bins + 1] = []
            m = self.bidx[i][self.n_bins + 1]
            if k < tstarts.size - 1:
                # two pseudo-bin puts per CLOSED contig (span + counts);
                # the final contig's puts happen in finish()
                self._bin_order[i] += [self.n_bins + 1, self.n_bins + 1]
            # all but the last tid's span closes here; the last closes in
            # finish() at the final offset, exactly like the push builder
            if k < tstarts.size - 1:
                m.append((int(off_before[tstarts[k]]),
                          int(voff[tends[k]])))
                m.append((int(tends[k] - tstarts[k] + 1), 0))
        # leave builder state so finish() emits the final tid's records
        self._save_tid = self._last_tid = int(tid[-1])
        self._save_bin = self._last_bin = int(bins[-1])
        self._save_off = int(off_before[starts[-1]])
        self._off_beg = int(off_before[tstarts[-1]])
        self._n_mapped = int(n - 1 - tends[-2]) if tstarts.size > 1 else n
        self._n_unmapped = 0
        self._last_off = int(voff[-1])
        self._last_coor = int(beg[-1])
        # drop the final run's chunk AND its put-sequence entry: finish()
        # re-inserts it closed at the final offset (matching the push
        # builder's save_bin handling)
        self.bidx[tl[-1]][bl[-1]].pop()
        self._bin_order[tl[-1]].pop()

        # linear index: slot -> offset of the first record covering it
        ms = self.min_shift
        sb = beg >> ms
        se = e1 >> ms
        lens = se - sb + 1
        multi_slot = int(lens.max()) > 1
        if multi_slot:
            total = int(lens.sum())
            seg = np.repeat(np.cumsum(lens) - lens, lens)
            within = np.arange(total, dtype=np.int64) - seg
            slots = np.repeat(sb, lens) + within
            recs = np.repeat(np.arange(n, dtype=np.int64), lens)
        for k in range(tstarts.size):
            i = int(tid[tstarts[k]])
            lo, hi = int(tstarts[k]), int(tends[k]) + 1
            if not multi_slot:
                # every record covers one slot and sb is sorted within the
                # tid: first-covering = first occurrence, no sort needed
                # (the common all-SNP case — at 39.2M rows the general
                # lexsort dominated the whole CSI build)
                s_t = sb[lo:hi]
                first = np.empty(s_t.size, bool)
                first[0] = True
                first[1:] = s_t[1:] != s_t[:-1]
                lin = np.full(int(s_t[-1]) + 1, -1, np.int64)
                lin[s_t[first]] = off_before[lo:hi][first].astype(np.int64)
                self.lidx[i] = lin.tolist()
                continue
            j0, j1 = np.searchsorted(recs, [lo, hi])
            s_t = slots[j0:j1]
            r_t = recs[j0:j1]
            order = np.lexsort((r_t, s_t))
            s_sorted = s_t[order]
            r_sorted = r_t[order]
            first = np.ones(s_sorted.size, bool)
            first[1:] = s_sorted[1:] != s_sorted[:-1]
            lin = np.full(int(se[lo:hi].max()) + 1, -1, np.int64)
            lin[s_sorted[first]] = off_before[r_sorted[first]].astype(
                np.int64)
            self.lidx[i] = lin.tolist()

        # RNI record-number index: offset before every 2^rec_shift-th record
        if self.rec_shift > 0:
            self.ridx.extend(
                off_before[:: 1 << self.rec_shift].astype(np.int64).tolist())
        self.n_rec = n

    def finish(self, final_offset: int) -> None:
        if self._finished:
            return
        if self._save_tid >= 0:
            self._insert_b(self._save_tid, self._save_bin, self._save_off, final_offset)
            self._insert_b(self._save_tid, self.n_bins + 1, self._off_beg, final_offset)
            self._insert_b(self._save_tid, self.n_bins + 1, self._n_mapped, self._n_unmapped)
        for i in range(self.n):
            self._update_loff(i)
            self._compress_binning(i)
        self._finished = True

    def _update_loff(self, i: int) -> None:
        bidx = self.bidx[i]
        lidx = self.lidx[i]
        offset0 = 0
        meta = bidx.get(self.n_bins + 1)
        if meta:
            offset0 = meta[0][0]
        j = 0
        while j < len(lidx) and lidx[j] == -1:
            lidx[j] = offset0
            j += 1
        for j in range(1, len(lidx)):
            if lidx[j] == -1:
                lidx[j] = lidx[j - 1]
        for b in bidx:
            if b < self.n_bins:
                bb = bin_bot(b, self.n_lvls)
                self.loff[i][b] = lidx[bb] if bb < len(lidx) else (lidx[-1] if lidx else 0)
            else:
                self.loff[i][b] = 0

    def _compress_binning(self, i: int) -> None:
        bidx = self.bidx[i]
        for l in range(self.n_lvls, 0, -1):
            start = bin_first(l)
            for b in sorted(bidx):
                if b >= self.n_bins or b < start:
                    continue
                p = bidx[b]
                if l < self.n_lvls and len(p) > 1:
                    p.sort()
                if (p[-1][1] >> 16) - (p[0][0] >> 16) < HTS_MIN_MARKER_DIST:
                    parent = bin_parent(b)
                    if parent not in bidx:
                        continue
                    bidx[parent].extend(p)
                    del bidx[b]
        if 0 in bidx:
            bidx[0].sort()
        # merge adjacent chunks starting in the same BGZF block
        for b in list(bidx):
            if b >= self.n_bins:
                continue
            p = bidx[b]
            merged = [list(p[0])]
            for u, v in p[1:]:
                if merged[-1][1] >> 16 >= u >> 16:
                    if merged[-1][1] < v:
                        merged[-1][1] = v
                else:
                    merged.append([u, v])
            bidx[b] = [tuple(x) for x in merged]

    # --- save / load -------------------------------------------------------

    def _bins_in_hash_order(self, i: int) -> list[int]:
        """Bins of contig ``i`` in the reference's khash iteration order.

        Replays the full put sequence (duplicates drive resize timing;
        bins later deleted by the merge pass leave tombstones that do not
        reorder survivors) through the layout simulator, then drops
        deleted bins.  Falls back
        to dict order when the put order was not recorded (e.g. an index
        populated by :meth:`load`)."""
        order = self._bin_order[i] if i < len(self._bin_order) else None
        bidx = self.bidx[i]
        if not order:
            order = list(bidx)  # loaded index: dict order, no replay info
        kh = _KhashLayout()
        for b in order:
            kh.put(b)
        return [b for b in kh.order() if b in bidx]

    def save(self, fn: str) -> None:
        with BgzfWriter(fn + ".csi") as fp:
            fp.write(b"CSI\x01")
            fp.write(struct.pack("<3I", self.min_shift, self.n_lvls, 0))
            fp.write(struct.pack("<i", self.n))
            for i in range(self.n):
                bidx = self.bidx[i]
                fp.write(struct.pack("<i", len(bidx)))
                for b in self._bins_in_hash_order(i):
                    fp.write(struct.pack("<IQ", b, self.loff[i].get(b, 0)))
                    chunks = bidx[b]
                    fp.write(struct.pack("<i", len(chunks)))
                    for u, v in chunks:
                        fp.write(struct.pack("<QQ", u, v))
            fp.write(struct.pack("<Q", self.n_no_coor))
            if self.rec_shift > 0:
                fp.write(b"RNI\x01")
                fp.write(struct.pack("<q", self.n_rec))
                fp.write(struct.pack("<i", self.rec_shift))
                fp.write(struct.pack("<i", len(self.ridx)))
                for off in self.ridx:
                    fp.write(struct.pack("<Q", off))

    @classmethod
    def load(cls, fn: str) -> "HtsIndex":
        fp = BgzfReader(fn if fn.endswith(".csi") else fn + ".csi")
        data = bytearray()
        while True:
            blk = fp.read(1 << 20)
            if not blk:
                break
            data += blk
        fp.close()
        data = bytes(data)
        if data[:4] != b"CSI\x01":
            raise ValueError("not a CSI index")
        off = 4
        min_shift, n_lvls, l_meta = struct.unpack_from("<3I", data, off)
        off += 12 + l_meta
        (n,) = struct.unpack_from("<i", data, off)
        off += 4
        idx = cls(n, min_shift, n_lvls)
        idx._finished = True
        import numpy as np
        for i in range(n):
            (nb,) = struct.unpack_from("<i", data, off)
            off += 4
            for _ in range(nb):
                b, loff = struct.unpack_from("<IQ", data, off)
                (nchunk,) = struct.unpack_from("<i", data, off + 12)
                off += 16
                arr = np.frombuffer(data, dtype="<u8", count=2 * nchunk, offset=off)
                off += 16 * nchunk
                idx.bidx[i][b] = list(zip(arr[0::2].tolist(), arr[1::2].tolist()))
                idx.loff[i][b] = loff
        if off + 8 <= len(data):
            (idx.n_no_coor,) = struct.unpack_from("<Q", data, off)
            off += 8
        if data[off: off + 4] == b"RNI\x01":
            off += 4
            (idx.n_rec,) = struct.unpack_from("<q", data, off)
            (idx.rec_shift,) = struct.unpack_from("<i", data, off + 8)
            (nr,) = struct.unpack_from("<i", data, off + 12)
            off += 16
            idx.ridx = np.frombuffer(data, dtype="<u8", count=nr, offset=off).tolist()
        return idx

    # --- queries -----------------------------------------------------------

    def query_chunks(self, tid: int, beg: int, end: int):
        """Merged chunk list for a region (hts_itr_query, hts.c:725-814)."""
        if beg < 0:
            beg = 0
        if end < beg or tid >= len(self.bidx):
            return None
        bidx = self.bidx[tid]
        # min_off via the finest bin containing beg, walking up/left
        b = bin_first(self.n_lvls) + (beg >> self.min_shift)
        while b:
            if b in bidx:
                break
            first = (bin_parent(b) << 3) + 1
            if b > first:
                b -= 1
            else:
                b = bin_parent(b)
        min_off = self.loff[tid].get(b, 0) if b in bidx else 0
        off = []
        for b in reg2bins(beg, end, self.min_shift, self.n_lvls):
            for u, v in bidx.get(b, ()):
                if v > min_off:
                    off.append((u, v))
        if not off:
            return []
        off.sort()
        # drop fully-contained chunks
        merged = [off[0]]
        for u, v in off[1:]:
            if merged[-1][1] < v:
                merged.append((u, v))
        off = merged
        # clip overlaps
        out = []
        for j, (u, v) in enumerate(off):
            if j + 1 < len(off) and v >= off[j + 1][0]:
                v = off[j + 1][0]
            out.append((u, v))
        # merge adjacent in the same block
        merged = [list(out[0])]
        for u, v in out[1:]:
            if merged[-1][1] >> 16 == u >> 16:
                merged[-1][1] = v
            else:
                merged.append([u, v])
        return [tuple(x) for x in merged]

    def seekn_voffset(self, r: int):
        """(virtual offset, records to skip) for the r-th record (RNI)."""
        if not self.ridx or r >= self.n_rec:
            return None
        return self.ridx[r >> self.rec_shift], r & ((1 << self.rec_shift) - 1)


def parse_reg(s: str):
    """Parse 'chr:beg-end' (hts_parse_reg, hts.c:821-850).

    Returns (name, beg, end) 0-based half-open.
    """
    name_end = len(s)
    i = s.rfind(":")
    if i >= 0:
        name_end = i
    if name_end < len(s):
        n_hyphen = 0
        ok = True
        for c in s[name_end + 1:]:
            if c == "-":
                n_hyphen += 1
            elif not (c.isdigit() or c == ","):
                ok = False
                break
        if not ok or n_hyphen > 1:
            name_end = len(s)
    if name_end < len(s):
        tmp = s[name_end + 1:].replace(",", "")
        parts = tmp.split("-")
        try:
            beg = int(parts[0]) - 1
        except ValueError:
            beg = -1
        if beg < 0:
            beg = 0
        if len(parts) > 1 and parts[1]:
            try:
                end = int(parts[1])
            except ValueError:
                end = 1 << 29
        else:
            end = 1 << 29
        if beg > end:
            name_end = len(s)
    if name_end == len(s):
        beg, end = 0, 1 << 29
    return s[:name_end], beg, end
