"""Convert VEP native output to SQLite statements or FMF (misc/vep2sql.js).

Variant keys are ``chr:pos:rlen:bases`` matching ``bgt view -a`` allele specs,
so the FMF output plugs directly into ``bgt view -d anno.fmf -a'expr'``.
"""

from __future__ import annotations

import contextlib
import getopt
import re
import sys

SCHEMA = """\
CREATE TABLE Variant (
  vid         TEXT,    -- unique variant ID in the format of chr:pos:rlen:base
  chrom       TEXT,    -- contig name
  bin         INTEGER, -- BAM bin number
  chromStart  INTEGER, -- contig start, 0-based (BED-like)
  chromEnd    INTEGER, -- contig end, BED-like
  bases       TEXT,    -- allele sequence
  impact      INTEGER, -- 0=MODIFER, 1=LOW, 2=MODERATE, 3=HIGH (most significant only)
  effect      TEXT,    -- Sequence Ontology term (most significant only)
  gene        TEXT,    -- stable identifer of gene symbol
  biotype     TEXT,    -- biotype of transcript or regulatory feature
  cdsPos      INTEGER, -- position on CDS
  featID      TEXT,    -- typically the transcript ID
  distance    INTEGER, -- shortest distance from variant to transcript
  strand      INTEGER, -- strand; 1 or -1
  codonChg    TEXT,    -- codon change
  ccds        TEXT,    -- CCDS ID
  sift        TEXT,    -- SIFT effect
  polyphen    TEXT,    -- PolyPhen effect
  PRIMARY KEY (vid)
);
"""

SEVERITY = [
    "transcript_ablation", "splice_acceptor_variant", "splice_donor_variant",
    "stop_gained", "frameshift_variant", "stop_lost", "start_lost",
    "transcript_amplification", "inframe_insertion", "inframe_deletion",
    "missense_variant", "protein_altering_variant", "splice_region_variant",
    "incomplete_terminal_codon_variant", "stop_retained_variant",
    "synonymous_variant", "coding_sequence_variant", "mature_miRNA_variant",
    "5_prime_UTR_variant", "3_prime_UTR_variant",
    "non_coding_transcript_exon_variant", "intron_variant",
    "NMD_transcript_variant", "non_coding_transcript_variant",
    "upstream_gene_variant", "downstream_gene_variant", "TFBS_ablation",
    "TFBS_amplification", "TF_binding_site_variant",
    "regulatory_region_ablation", "regulatory_region_amplification",
    "feature_elongation", "regulatory_region_variant", "feature_truncation",
    "intergenic_variant",
]
IMPACT = {"MODIFIER": 0, "LOW": 1, "MODERATE": 2, "HIGH": 3}
SEVERITY_RANK = {s: i for i, s in enumerate(SEVERITY)}


def reg2bin(start: int, end: int) -> int:
    end -= 1
    if start >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (start >> 14)
    if start >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (start >> 17)
    if start >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (start >> 20)
    if start >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (start >> 23)
    if start >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (start >> 26)
    return 0


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    quiet = False
    is_fmf = False
    create_tbl = False
    opts, args = getopt.getopt(argv, "hqfc")
    for c, _v in opts:
        if c == "-q":
            quiet = True
        elif c == "-f":
            is_fmf = True
        elif c == "-c":
            create_tbl = True
        elif c == "-h":
            print("Usage: vep2sql.py [-fch] <vep-out.txt>", file=sys.stderr)
            return 1
    with contextlib.ExitStack() as stack:
        inp = stack.enter_context(open(args[0])) if args else sys.stdin
        out = sys.stdout
        if not is_fmf:
            if create_tbl:
                out.write(SCHEMA + "\n")
            out.write("BEGIN TRANSACTION;\n")
        for lineno, line in enumerate(inp, 1):
            if line.startswith("#"):
                continue
            t = line.rstrip("\n").split("\t")
            info = []
            m = re.match(r"^(\S+):(\d+)(-(\d+))?", t[1])
            if not m:
                if not quiet:
                    print(f"[{lineno}] failed to parse contig name and position",
                          file=sys.stderr)
                continue
            chrom = m.group(1)
            start = int(m.group(2))
            end = int(m.group(4)) if m.group(3) else start
            is_sym = False
            if t[2] == "-":  # deletion
                bases, rlen = "", end - start + 1
            elif start == end and len(t[2]) == 1:  # SNP
                bases, rlen = t[2], 1
            elif end - start == 1:  # insertion
                if t[2] == "insertion":
                    bases = "<INS>"
                    is_sym = True
                else:
                    bases = t[2]
                rlen, start = 0, end
            else:
                bases = "<" + t[2] + ">"
                rlen = end - start + 1
                is_sym = True
            vid = f"{chrom}:{start}:{rlen}:{bases}"
            if is_sym:
                if not quiet:
                    print(f"[{lineno}] skipped symbolic allele {vid}", file=sys.stderr)
                continue
            if not is_fmf:
                info += [("vid", "Z", vid), ("chrom", "Z", chrom),
                         ("bin", "i", reg2bin(start - 1, start - 1 + rlen)),
                         ("chromStart", "i", start - 1),
                         ("chromEnd", "i", start - 1 + rlen), ("bases", "Z", bases)]
            extra = t[13] if len(t) > 13 else ""
            m = re.search(r"SYMBOL=([^\s;]+);SYMBOL_SOURCE=HGNC;.*BIOTYPE=([^\s;]+)", extra)
            if m:
                info.append(("gene", "Z", m.group(1)))
                info.append(("biotype", "Z", m.group(2)))
            m = re.search(r"IMPACT=([^\s;]+)", extra)
            if m and m.group(1) in IMPACT:
                info.append(("impact", "i", IMPACT[m.group(1)]))
            if "," in t[6]:
                best, best_eff = -1, None
                for eff in t[6].split(","):
                    r = SEVERITY_RANK.get(eff)
                    if r is None:
                        if not quiet:
                            print(f"[{lineno}] unknown effect {eff}", file=sys.stderr)
                        continue
                    if r > best:
                        best, best_eff = r, eff
                info.append(("effect", "Z", best_eff))
            else:
                info.append(("effect", "Z", t[6]))
            if t[4] != "-" and t[5] != "-":
                info.append(("featID", "Z", t[4]))
            if t[8] != "-":
                info.append(("cdsPos", "i", t[8]))
            m = re.search(r"DISTANCE=(\d+);STRAND=(-?\d+)", extra)
            if m:
                info.append(("distance", "i", m.group(1)))
                info.append(("strand", "i", m.group(2)))
            m = re.search(r";CCDS=([^\s;]+)", extra)
            if m:
                info.append(("ccds", "Z", m.group(1)))
            if len(t) > 11 and t[10] != "-":
                info.append(("codonChg", "Z", t[11]))
            m = re.search(r";SIFT=([^\s;()]+)\(([\d.]+)\)", extra)
            if m:
                info.append(("sift", "Z", m.group(1)))
            m = re.search(r";PolyPhen=([^\s;()]+)\(([\d.]+)\)", extra)
            if m:
                info.append(("polyphen", "Z", m.group(1)))
            if not is_fmf:
                keys = ",".join(k for k, _t, _v in info)
                vals = ",".join(f"'{v}'" if tt == "Z" else str(v) for _k, tt, v in info)
                out.write(f"INSERT INTO Variant ({keys}) VALUES ({vals});\n")
            else:
                out.write("\t".join([vid] + [f"{k}:{tt}:{v}" for k, tt, v in info]) + "\n")
        if not is_fmf:
            out.write("END TRANSACTION;\n\n")
            out.write("CREATE INDEX idx_gene  ON Variant (gene);\n")
            out.write("CREATE INDEX idx_bin   ON Variant (chrom, bin);\n")
            out.write("CREATE INDEX idx_start ON Variant (chrom, chromStart);\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
