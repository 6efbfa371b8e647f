"""Convert SGDP metadata table to FMF (misc/sgdp2fmf.pl)."""

import contextlib
import sys


def main(argv=None):
    with contextlib.ExitStack() as stack:
        inp = stack.enter_context(open(argv[0])) if argv else sys.stdin
        for lineno, line in enumerate(inp, 1):
            if lineno == 1:
                continue
            t = line.rstrip("\n").split("\t")
            a = [t[6], f"altID:Z:{t[4]}", f"subpop:Z:{t[7]}",
                 f"region:Z:{t[8]}", f"country:Z:{t[9]}"]
            if len(t) > 14 and t[13] != "?" and t[14] != "?":
                a.append(f"latitude:f:{t[13]}")
                a.append(f"longtitude:f:{t[14]}")
            print("\t".join(a))


if __name__ == "__main__":
    main(sys.argv[1:])
