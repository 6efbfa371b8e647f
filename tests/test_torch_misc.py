"""bgt_tpu_torch.misc (the metadata converters) against bgt_tpu.misc.

Each converter runs as ``python -m <package>.misc.<name>`` on the same
crafted input in its own process; the exit codes and stdout bytes must be
equal.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from bgt_tpu.misc import vep2sql as jax_vep2sql
from bgt_tpu_torch.misc import pop2region, vep2sql

REPO = Path(__file__).resolve().parent.parent

FMF = ("NA12878\tpopulation:Z:CEU\tsex:Z:F\n"
       "HG00096\tpopulation:Z:GBR\n"
       "HG00100\tsex:Z:M\n"
       "X1\tpopulation:Z:XXX\n"
       "NA19238\tpopulation:Z:YRI\tage:i:30\n"
       "HG03006\tpopulation:Z:BEB\n")

SGDP = ("idx\tpanel\tx\ty\tAltID\tz\tName\tSubpop\tRegion\tCountry\ta\tb\tc\t"
        "Latitude\tLongitude\n"
        "1\tA\t.\t.\tB_Mbuti-4\t.\tS_Mbuti-1\tMbuti\tAfrica\tCongo\t.\t.\t.\t"
        "1.5\t29.0\n"
        "2\tA\t.\t.\tB_Han-1\t.\tS_Han-2\tHan\tEastAsia\tChina\t.\t.\t.\t?\t"
        "116.4\n"
        "3\tB\t.\t.\tALT3\t.\tS_Mixe-1\tMixe\tAmerica\tMexico\n")

_EXTRA = ("IMPACT=MODERATE;SYMBOL=ABC1;SYMBOL_SOURCE=HGNC;HGNC_ID=1;"
          "BIOTYPE=protein_coding;DISTANCE=12;STRAND=-1;CCDS=CCDS30547.1;"
          "SIFT=deleterious(0.01);PolyPhen=probably_damaging(0.998)")
VEP = "\n".join([
    "## ENSEMBL VARIANT EFFECT PREDICTOR v80",
    "#Uploaded_variation\tLocation\tAllele\tGene\tFeature\tFeature_type\t"
    "Consequence\tcDNA_position\tCDS_position\tProtein_position\t"
    "Amino_acids\tCodons\tExisting_variation\tExtra",
    "rs1\t1:12345\tA\tENSG01\tENST01\tTranscript\tmissense_variant\t100\t80\t"
    "27\tR/W\tCgg/Tgg\t-\t" + _EXTRA,
    "v2\t1:2000-2003\t-\tENSG02\tENST02\tTranscript\t"
    "frameshift_variant,intron_variant,bogus_effect\t-\t-\t-\t-\t-\t-\t"
    "IMPACT=HIGH;STRAND=1",
    "v3\t2:500-501\tTTG\t-\t-\t-\tintergenic_variant\t-\t-\t-\t-\t-\t-\t"
    "IMPACT=MODIFIER",
    "v4\t2:600-601\tinsertion\t-\t-\t-\tintergenic_variant\t-\t-\t-\t-\t-\t-\t-",
    "v5\t3:100-200\tdeletion\t-\t-\t-\tintergenic_variant\t-\t-\t-\t-\t-\t-\t-",
    "v6\tnowhere\tA\t-\t-\t-\tintergenic_variant\t-\t-\t-\t-\t-\t-\t-",
    "v7\tX:99\tG\tENSG07\tENST07\tRegulatoryFeature\tupstream_gene_variant\t"
    "-\t-\t-\t-\t-\t-",
    "v8\t17:4100-4103\tAC\tENSG08\t-\tTranscript\tinframe_deletion\t-\t12\t"
    "4\t-\t-\t-\tIMPACT=UNKNOWN;SYMBOL=XYZ;SYMBOL_SOURCE=HGNC;BIOTYPE=lincRNA",
]) + "\n"

# (converter, input, arguments before the input file)
CASES = [
    ("pop2region", FMF, []),
    ("sgdp2fmf", SGDP, []),
    ("vep2sql", VEP, []),
    ("vep2sql", VEP, ["-f"]),
    ("vep2sql", VEP, ["-c"]),
    ("vep2sql", VEP, ["-q", "-c"]),
    ("vep2sql", VEP, ["-f", "-c"]),
    ("vep2sql", VEP, ["-h"]),
]


def _run(pkg, name, args, stdin=None):
    """``python -m <pkg>.misc.<name> *args`` with ``stdin`` (bytes) as its
    input."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, "-m", f"{pkg}.misc.{name}", *args],
                          input=stdin, capture_output=True, env=env, timeout=60)


@pytest.mark.parametrize("name,text,args", CASES,
                         ids=[f"{n} {' '.join(a)}".strip() for n, _t, a in CASES])
def test_converter_stdout_matches_jax_package(tmp_path, name, text, args):
    path = tmp_path / "in.txt"
    path.write_text(text)
    want = _run("bgt_tpu", name, [*args, str(path)])
    got = _run("bgt_tpu_torch", name, [*args, str(path)])
    assert (got.returncode, got.stdout) == (want.returncode, want.stdout)
    assert got.stdout or got.returncode == 1, got.stderr.decode()[-2000:]


def test_converter_reads_stdin():
    outs = [_run(pkg, "pop2region", [], FMF.encode()).stdout
            for pkg in ("bgt_tpu", "bgt_tpu_torch")]
    assert outs[0] == outs[1] and outs[0].count(b"\n") == 4


def test_misc_converters():
    """The port's copy of tests/test_cli.py::test_misc_converters, and
    reg2bin equal to bgt_tpu's at every level of the binning."""
    assert pop2region.POP2REGION["CEU"] == "WestEurasia"
    assert vep2sql.reg2bin(0, 1) == ((1 << 15) - 1) // 7
    for beg, end in [(0, 1), (16383, 16385), (1 << 17, (1 << 17) + 5),
                     (5, 1 << 20), (7, 1 << 23), (9, 1 << 26), (0, 1 << 29)]:
        assert vep2sql.reg2bin(beg, end) == jax_vep2sql.reg2bin(beg, end)
