"""``dtv`` CLI dispatcher of the port (see ``dtv_utils_tpu/cli/main.py``)."""

from __future__ import annotations

import sys


def cmd_papr(argv: list[str]) -> int:
    from dtv_utils_torch.analysis import papr
    return papr.cli(argv)


def cmd_dvbt_mod(argv: list[str]) -> int:
    from dtv_utils_torch.models import dvbt
    return dvbt.cli(argv)


def cmd_qam_mod(argv: list[str]) -> int:
    from dtv_utils_torch.models import j83b
    return j83b.cli(argv)


def cmd_dvbt2_mod(argv: list[str]) -> int:
    from dtv_utils_torch.models import dvbt2
    return dvbt2.cli(argv)


def cmd_dvbt_rx(argv: list[str]) -> int:
    from dtv_utils_torch.models import dvbt_rx
    return dvbt_rx.cli(argv)


def cmd_dvbt2_rx(argv: list[str]) -> int:
    from dtv_utils_torch.models import rx_cli
    return rx_cli.dvbt2_rx_cli(argv)


def cmd_qam_rx(argv: list[str]) -> int:
    from dtv_utils_torch.models import rx_cli
    return rx_cli.qam_rx_cli(argv)


def cmd_dvbt2rate(argv: list[str]) -> int:
    from dtv_utils_torch.rates import dvbt2
    return dvbt2.cli(argv)


COMMANDS = {
    "dvbt2rate": cmd_dvbt2rate,
    "papr": cmd_papr,
    "dvbt-mod": cmd_dvbt_mod,
    "qam-mod": cmd_qam_mod,
    "dvbt2-mod": cmd_dvbt2_mod,
    "dvbt-rx": cmd_dvbt_rx,
    "dvbt2-rx": cmd_dvbt2_rx,
    "qam-rx": cmd_qam_rx,
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
