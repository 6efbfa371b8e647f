"""Tag 1000G sample FMF rows with continental region (misc/pop2region.pl)."""

import contextlib
import re
import sys

POP2REGION = {
    "CHB": "EastAsia", "JPT": "EastAsia", "CHS": "EastAsia", "CDX": "EastAsia",
    "KHV": "EastAsia", "CHD": "EastAsia",
    "CEU": "WestEurasia", "TSI": "WestEurasia", "GBR": "WestEurasia",
    "FIN": "WestEurasia", "IBS": "WestEurasia",
    "YRI": "Africa", "LWK": "Africa", "GWD": "Africa", "MSL": "Africa",
    "ESN": "Africa",
    "ASW": "America", "ACB": "America", "MXL": "America", "PUR": "America",
    "CLM": "America", "PEL": "America",
    "GIH": "SouthAsia", "PJL": "SouthAsia", "BEB": "SouthAsia",
    "STU": "SouthAsia", "ITU": "SouthAsia",
}


def main(argv=None):
    with contextlib.ExitStack() as stack:
        inp = stack.enter_context(open(argv[0])) if argv else sys.stdin
        for line in inp:
            line = line.rstrip("\n")
            m = re.search(r"population:Z:(\S+)", line)
            if m and m.group(1) in POP2REGION:
                print(f"{line}\tregion:Z:{POP2REGION[m.group(1)]}\tsource:Z:1000G")


if __name__ == "__main__":
    main(sys.argv[1:])
