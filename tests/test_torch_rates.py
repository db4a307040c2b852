"""The port's rate oracles (``dtv_utils_torch/rates/{dvbt,dvbs2,atsc3,
atsc3_tables}.py``) and their CLI subcommands against the JAX reference.

The port carries copies of these pure-Python modules (the reference's
package imports JAX).  Every table and function is pinned to the
reference's value for value, every golden report of ``tests/test_rates.py``
must come out of both, and the port's ``dtv`` CLI must print what the JAX
CLI prints, byte for byte, with the same exit code.
"""

import inspect
import itertools
from pathlib import Path

import numpy as np
import pytest

from dtv_utils_tpu.cli import main as jcli
from dtv_utils_tpu.rates import atsc3 as ja3
from dtv_utils_tpu.rates import atsc3_tables as ja3t
from dtv_utils_tpu.rates import dvbs2 as js2
from dtv_utils_tpu.rates import dvbt as jt
from dtv_utils_torch.cli import main as tcli
from dtv_utils_torch.rates import atsc3 as ta3
from dtv_utils_torch.rates import atsc3_tables as ta3t
from dtv_utils_torch.rates import dvbs2 as ts2
from dtv_utils_torch.rates import dvbt as tt

GOLDEN = Path(__file__).parent / "golden"

DVBT_BWS = [5, 6, 7, 8]
DVBS2_CASES = [("n", "27500000"), ("s", "27500000"), ("x", "27500000"),
               ("sx", "27500000"), ("v", "27500000"), ("n", "31415926.5"),
               ("sx", "1000000")]
ATSC3_CASES = ["32 5 72 2 8 2 0 6 1 1 1 0 4 0",
               "8 3 100 1 10 3 0 0 0 2 3 2 2 1",
               "16 9 120 2 6 1 1 4 1 1 2 4 0 0 150",
               "32 10 60 1 2 0 0 8 1 5 7 3 1 0 10"]


def _same(a, b, what=""):
    """Equal values of equal types, through tuples, lists and dicts."""
    assert type(a) is type(b), (what, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    else:
        assert a == b, (what, a, b)


def _tables(mod):
    """Names of the module's constant tables (upper case, not modules)."""
    return sorted(k for k, v in vars(mod).items()
                  if k.lstrip("_").isupper() and not inspect.ismodule(v))


@pytest.mark.parametrize("port,ref", [(tt, jt), (ts2, js2), (ta3, ja3),
                                      (ta3t, ja3t)],
                         ids=["dvbt", "dvbs2", "atsc3", "atsc3_tables"])
def test_rate_tables_pinned(port, ref):
    """Every constant table of each copied module equals the reference's."""
    names = _tables(ref)
    assert names and names == _tables(port)
    for name in names:
        _same(getattr(port, name), getattr(ref, name), name)


@pytest.mark.parametrize("bw", DVBT_BWS)
def test_dvbt_rate_grid_and_exact(bw):
    _same(tt.rate_grid(bw), jt.rate_grid(bw), f"rate_grid({bw})")
    for (_, bits), cr, gi in itertools.product(tt.CONSTELLATIONS,
                                               tt.CODE_RATES, tt.GUARDS):
        _same(tt.rate_exact(bw, bits, cr, gi), jt.rate_exact(bw, bits, cr, gi),
              f"rate_exact({bw}, {bits}, {cr}, {gi})")


@pytest.mark.parametrize("short", [False, True])
def test_dvbs2_ts_rate_sweep(short):
    """ts_rate over every S2X MODCOD's code rate, BCH t and modulation, both
    pilot settings, at two symbol rates, as one broadcast call."""
    rows = np.array([r[:3] for _, _, rs in ts2.S2X_NORMAL + ts2.S2X_SHORT
                     for r in rs], dtype=np.float64)
    for rate, mod, pilots in itertools.product((27.5e6, 31415926.5),
                                               (2, 3, 4, 5), (0.0, 36.0)):
        args = (rate, mod, rows[:, 0], rows[:, 1], rows[:, 2], pilots)
        _same(ts2.ts_rate(*args, short=short), js2.ts_rate(*args, short=short),
              str((rate, mod, pilots, short)))


@pytest.mark.parametrize("fft", [8192, 16384, 32768, 4096])
def test_atsc3_lookup_cells(fft):
    """lookup_cells at every guard, pilot pattern, reduced-carrier mode
    and boost (4096 takes the C default path)."""
    for guard, pilot, cred, boost in itertools.product(
            range(1, 13), range(16), range(5), range(5)):
        _same(ta3.lookup_cells(fft, guard, pilot, cred, boost),
              ja3.lookup_cells(fft, guard, pilot, cred, boost),
              str((fft, guard, pilot, cred, boost)))


@pytest.mark.parametrize("bw", DVBT_BWS)
def test_dvbt_format_report(bw):
    got = tt.format_report(bw)
    assert got == jt.format_report(bw)
    assert got == (GOLDEN / f"dvbtrate_{bw}.txt").read_text()


@pytest.mark.parametrize("opts,rate", DVBS2_CASES)
def test_dvbs2_format_report(opts, rate):
    kw = dict(short="s" in opts, s2x="x" in opts, vlsnr="v" in opts)
    got = ts2.format_report(float(rate), **kw)
    assert got == js2.format_report(float(rate), **kw)
    assert got == (GOLDEN / f"dvbs2rate_{opts}_{rate}.txt").read_text()


@pytest.mark.parametrize("args", ATSC3_CASES)
def test_atsc3_format_report(args):
    got = ta3.format_report(args.split())
    assert got == ja3.format_report(args.split())
    name = "atsc3rate_" + args.replace(" ", "_") + ".txt"
    assert got == (GOLDEN / name).read_text()


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _golden_argv():
    cases = [(["dvbtrate", str(bw)], f"dvbtrate_{bw}.txt") for bw in DVBT_BWS]
    for opts, rate in DVBS2_CASES:
        argv = ["dvbs2rate", rate] if opts == "n" else \
            ["dvbs2rate", "-" + opts, rate]
        cases.append((argv, f"dvbs2rate_{opts}_{rate}.txt"))
    cases += [(["atsc3rate", *a.split()],
               "atsc3rate_" + a.replace(" ", "_") + ".txt")
              for a in ATSC3_CASES]
    return cases


@pytest.mark.parametrize("argv,golden", _golden_argv(),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_cli_matches_reference_and_golden(argv, golden, capsys):
    got = _run(tcli.main, argv, capsys)
    assert got == _run(jcli.main, argv, capsys)
    assert got == (0, (GOLDEN / golden).read_text(), "")


@pytest.mark.parametrize("argv", [
    ["dvbtrate"], ["dvbtrate", "8", "9"],
    ["dvbs2rate"], ["dvbs2rate", "-s", "1", "2"], ["dvbs2rate", "s", "1e6"],
    ["dvbs2rate", "-sq", "27500000"], ["dvbs2rate", "-Zx", "1000000"],
    ["atsc3rate"], ["atsc3rate", *ATSC3_CASES[0].split()[:13]],
], ids=lambda v: " ".join(v))
def test_cli_usage_and_flags(argv, capsys):
    """Usage errors (exit 255, usage on stderr) and unknown dvbs2rate flags
    (``Unsupported Option: <c>`` on stderr, the report still printed)."""
    got = _run(tcli.main, argv, capsys)
    assert got == _run(jcli.main, argv, capsys)
    if got[0] == 255:
        assert got[1] == "" and got[2].startswith("usage: ")
    else:
        assert got[0] == 0 and "Unsupported Option: " in got[2]
