"""``dtv`` CLI dispatcher of the port (see ``dtv_utils_tpu/cli/main.py``)."""

from __future__ import annotations

import sys


def _die_usage(msg: str) -> int:
    print(msg, file=sys.stderr)
    return 255  # reference tools exit(-1)


def cmd_dvbtrate(argv: list[str]) -> int:
    from dtv_utils_torch.rates import dvbt
    if len(argv) != 1:
        return _die_usage("usage: dvbtrate <channel bandwidth>")
    sys.stdout.write(dvbt.format_report(int(argv[0])))
    return 0


def cmd_dvbs2rate(argv: list[str]) -> int:
    from dtv_utils_torch.rates import dvbs2
    if len(argv) not in (1, 2):
        return _die_usage("usage: dvbs2rate -sx <symbol rate>\nOptions:\n"
                          "\ts = short FECFRAME rates\n\tv = DVB-S2X VL-SNR\n"
                          "\tx = DVB-S2X rates")
    short = s2x = vlsnr = False
    if len(argv) == 2:
        if not argv[0].startswith("-"):
            return _die_usage("usage: dvbs2rate -sx <symbol rate>")
        for ch in argv[0][1:]:
            if ch in "sS":
                short = True
            elif ch in "vV":
                vlsnr = True
            elif ch in "xX":
                s2x = True
            else:
                print(f"Unsupported Option: {ch}", file=sys.stderr)
        rate = float(argv[1])
    else:
        rate = float(argv[0])
    sys.stdout.write(dvbs2.format_report(rate, short=short, s2x=s2x,
                                         vlsnr=vlsnr))
    return 0


def cmd_atsc3rate(argv: list[str]) -> int:
    from dtv_utils_torch.rates import atsc3
    return atsc3.cli(argv)


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


def cmd_flags264(argv: list[str]) -> int:
    from dtv_utils_torch.analysis import native
    return native.cli("flags264", argv)


def cmd_h264_parse(argv: list[str]) -> int:
    from dtv_utils_torch.analysis import native
    return native.cli("h264_parse", argv)


def cmd_l1dump(argv: list[str]) -> int:
    from dtv_utils_torch.analysis import native
    return native.cli("l1dump", argv)


def cmd_xport(argv: list[str]) -> int:
    from dtv_utils_torch.analysis import native
    return native.cli("xport", argv)


def cmd_profile(argv: list[str]) -> int:
    from dtv_utils_torch.utils import profile
    return profile.cli(argv)


COMMANDS = {
    "dvbtrate": cmd_dvbtrate,
    "dvbs2rate": cmd_dvbs2rate,
    "dvbt2rate": cmd_dvbt2rate,
    "atsc3rate": cmd_atsc3rate,
    "papr": cmd_papr,
    "dvbt-mod": cmd_dvbt_mod,
    "qam-mod": cmd_qam_mod,
    "dvbt2-mod": cmd_dvbt2_mod,
    "flags264": cmd_flags264,
    "h264_parse": cmd_h264_parse,
    "l1dump": cmd_l1dump,
    "xport": cmd_xport,
    "profile": cmd_profile,
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
