"""``dtv`` CLI dispatcher of the port (see ``dtv_utils_tpu/cli/main.py``)."""

from __future__ import annotations

import sys


def cmd_qam_mod(argv: list[str]) -> int:
    from dtv_utils_torch.models import j83b
    return j83b.cli(argv)


COMMANDS = {
    "qam-mod": cmd_qam_mod,
}


def main(argv: list[str]) -> int:
    if not argv or argv[0] in ("-h", "--help"):
        names = " ".join(sorted(COMMANDS))
        print(f"usage: dtv <tool> [args...]\ntools: {names}", file=sys.stderr)
        return 0 if argv else 255
    fn = COMMANDS.get(argv[0])
    if fn is None:
        print(f"unknown tool: {argv[0]}", file=sys.stderr)
        return 255
    return fn(argv[1:])
