"""``bgt`` command line of the torch port.

``view`` and ``server`` run this package's query path (counts on a CUDA
device).  The subcommands that never touch a device (import, atomize,
bcfidx, getalt, fmf, pbfview, gtcshard, kexpr, version) are
``bgt_tpu.cli``'s own.
"""

from __future__ import annotations

import getopt
import sys

from bgt_tpu import cli as host_cli


def main(argv=None, device=None) -> int:
    """Run one subcommand; ``view`` and ``server`` count on ``device``
    (default cuda)."""
    argv = argv if argv is not None else sys.argv[1:]
    cmd = argv[0] if argv else ""
    if cmd not in ("view", "mview", "server"):
        return host_cli.main(argv)
    try:
        if cmd == "server":
            from .server.server import main_server
            return main_server(argv[1:], device=device)
        from .query.view import main_view
        return main_view(argv[1:], device=device)
    except getopt.GetoptError as e:
        print(f"[E::main_{cmd}] {e}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        return 1
    except ZeroDivisionError:
        print(f"[E::main_{cmd}] integer division by zero in expression",
              file=sys.stderr)
        return 1
    except (OSError, ValueError) as e:
        print(f"[E::main_{cmd}] {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
