"""The BCF writer, read back by a plain parser (gzip and struct), and
through the port's importer."""

import gzip
import struct

import numpy as np

from benchmark import bcf_writer, cohort
from helpers import tiny_cell

SEED = 2 ** 31 + 11


def parse_bcf(path):
    """(sample names, [(pos, ref, alt, GT bytes)]) of a GT-only BCF2."""
    with open(path, "rb") as fp:
        data = gzip.decompress(fp.read())
    assert data[:5] == b"BCF\x02\x02"
    (l_text,) = struct.unpack("<I", data[5:9])
    text = data[9: 9 + l_text].rstrip(b"\0").decode()
    names = text.splitlines()[-1].split("\t")[9:]
    off, recs = 9 + l_text, []
    while off < len(data):
        l_shared, l_indiv, chrom, pos, rlen, _q, nai, nfs = struct.unpack(
            "<IIiiiIII", data[off: off + 32])
        assert (chrom, rlen, nai >> 16, nai & 0xFFFF) == (0, 1, 2, 0)
        assert (nfs >> 24, nfs & 0xFFFFFF) == (1, len(names))
        shared = data[off + 32: off + 8 + l_shared]
        assert shared[0] == 0x07 and shared[1] == 0x17 and shared[3] == 0x17
        assert shared[5:7] == b"\x11\x00"  # FILTER PASS
        indiv = data[off + 8 + l_shared: off + 8 + l_shared + l_indiv]
        assert indiv[:3] == b"\x11\x01\x21"  # GT, two int8 a sample
        recs.append((pos + 1, shared[2], shared[4],
                     np.frombuffer(indiv[3:], np.uint8)))
        off += 8 + l_shared + l_indiv
    return names, text, recs


def test_bcf_reads_back(tmp_path):
    cfg = dict(tiny_cell("tiny_open").config, p_missing=0.05)
    coh = cohort.make_cohort(cfg, SEED)
    path = tmp_path / "in.bcf"
    bcf_writer.write_bcf(str(path), coh.chrom, coh.chrom_len, coh.names,
                         coh.pos, coh.ref, coh.alt, coh.codes, chunk_sites=333)
    names, text, recs = parse_bcf(path)
    assert names == coh.names
    assert "##contig=<ID=11,length=135006516>" in text
    assert [r[0] for r in recs] == coh.pos.tolist()
    assert bytes(r[1] for r in recs) == coh.ref.tobytes()
    assert bytes(r[2] for r in recs) == coh.alt.tobytes()
    gt = np.stack([r[3] for r in recs])
    first, second = gt[:, 0::2], gt[:, 1::2]
    # (allele + 1) << 1, the phase bit on the second; a missing call 0 (1)
    code_of_first = {2: 0, 4: 1, 0: 2}
    code_of_second = {3: 0, 5: 1, 1: 2}
    assert set(np.unique(first)) <= set(code_of_first)
    assert set(np.unique(second)) <= set(code_of_second)
    codes = np.empty_like(coh.codes)
    codes[:, 0::2] = np.vectorize(code_of_first.get)(first)
    codes[:, 1::2] = np.vectorize(code_of_second.get)(second)
    assert np.array_equal(codes, coh.codes)
    assert (coh.codes == 2).any() and (coh.codes == 1).any()


def test_bcf_imports_with_the_port(tmp_path):
    from bgt_tpu_torch.ops.tiles import TileStore
    from bgt_tpu_torch.query import importer
    coh = cohort.make_cohort(tiny_cell("tiny_open").config, SEED)
    bcf_writer.write_bcf(str(tmp_path / "in.bcf"), coh.chrom, coh.chrom_len,
                         coh.names, coh.pos, coh.ref, coh.alt, coh.codes)
    n = importer.import_vcf(str(tmp_path / "db"), [str(tmp_path / "in.bcf")])
    assert n == len(coh.pos)
    ts = TileStore.open_or_build(str(tmp_path / "db"))
    assert np.array_equal(ts.codes(np.arange(n))[:, : coh.codes.shape[1]], coh.codes)


def test_cohort_follows_the_configuration():
    cfg = tiny_cell("tiny_open").config
    a = cohort.make_cohort(cfg, SEED)
    b = cohort.make_cohort(cfg, SEED)
    c = cohort.make_cohort(cfg, SEED + 1)
    assert np.array_equal(a.codes, b.codes) and np.array_equal(a.pos, b.pos)
    assert not np.array_equal(a.codes, c.codes)
    assert a.codes.shape == (cfg["n_sites"], 2 * cfg["n_samples"])
    assert (np.diff(a.pos) > 0).all() and a.pos[0] == cfg["start_bp"]
    density = len(a.pos) / (a.pos[-1] - a.pos[0]) * 1000
    assert abs(density / cfg["site_density_per_kbp"] - 1) < 0.1
    assert (a.ref != a.alt).all()
    labels = cfg["samples"]["metadata"]["cohort"]["labels"]
    got = dict(zip(*np.unique(a.meta["cohort"].astype(str), return_counts=True)))
    assert got == labels
    assert a.meta["age"].min() >= 18 and a.meta["age"].max() <= 90
    spl = a.spl_text().splitlines()
    assert spl[0].startswith("S00000\tcohort:Z:C") and "\tage:i:" in spl[0]
    # missing calls at p_missing, every other code 0 or 1
    share = (a.codes == 2).mean()
    assert abs(share - cfg["p_missing"]) < 5 * (cfg["p_missing"] / a.codes.size) ** 0.5


def test_super_population_follows_population():
    cfg = tiny_cell("tiny_pop", "tiny1kg").config
    a = cohort.make_cohort(cfg, SEED)
    groups = cfg["samples"]["metadata"]["super_population"]["groups"]
    up = {p: s for s, ps in groups.items() for p in ps}
    assert [up[p] for p in a.meta["population"]] == a.meta["super_population"].tolist()
