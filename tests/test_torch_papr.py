"""The port's PAPR analyzer (dtv_utils_torch.analysis.papr) on the CPU:
byte-identical stdout to papr.c's goldens and to the JAX reference's
report, chunked equal to one-shot, and papr.c's rounding of i² + q²."""

import json
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from dtv_utils_tpu.analysis import papr as jpapr
from dtv_utils_torch.analysis import papr as tpapr
from dtv_utils_torch.core.config import (CodeRate, Constellation, DvbtConfig,
                                         GuardInterval, TransmissionMode)
from dtv_utils_torch.tx import dvbt as txd

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
RNG = np.random.default_rng(0x9A92)
_ATTRS = ("n", "power_sum", "peak", "peak_offset", "real_pos",
          "real_pos_offset", "real_neg", "real_neg_offset", "imag_pos",
          "imag_pos_offset", "imag_neg", "imag_neg_offset")


@pytest.fixture(scope="module")
def small_cfile(tmp_path_factory):
    """tests/test_papr.py's fixture: the input papr.c's goldens came from."""
    path = tmp_path_factory.mktemp("papr") / "small.cfile"
    rng = np.random.default_rng(1234)
    iq = (rng.standard_normal(8192) * 0.25).astype(np.float32)
    iq.tofile(path)
    return str(path)


@pytest.fixture(scope="module")
def dvbt_cfile(tmp_path_factory):
    """One superframe of 2K QPSK DVB-T IQ from the port."""
    cfg = DvbtConfig(mode=TransmissionMode.M2K, bandwidth_mhz=6,
                     constellation=Constellation.QPSK,
                     code_rate=CodeRate.R1_2, guard=GuardInterval.G1_4)
    ts = RNG.integers(0, 256, size=cfg.ts_bytes_per_superframe,
                      dtype=np.uint8)
    ts[::188] = 0x47
    iq, _ = txd.modulate_stream(cfg, ts, device="cpu")
    path = tmp_path_factory.mktemp("papr") / "dvbt.cfile"
    iq.tofile(path)
    return str(path)


def _jax_report(path, graph, chunk=1 << 22):
    stats = jpapr.analyze_file(path, chunk)
    levels = jpapr.make_levels(stats.mean_power, stats.papr_db, graph)
    return jpapr.format_report(stats, jpapr.ccdf_counts(path, levels, chunk),
                               graph)


@pytest.mark.parametrize("graph,name", [(False, "papr_4096.txt"),
                                        (True, "papr_g_4096.txt")])
def test_papr_c_golden(small_cfile, graph, name):
    got = tpapr.report(small_cfile, graph, device="cpu")
    assert got == (GOLDEN / name).read_text()


@pytest.mark.parametrize("graph", [False, True])
def test_matches_jax_on_dvbt_iq(dvbt_cfile, graph):
    assert tpapr.report(dvbt_cfile, graph, device="cpu") == \
        _jax_report(dvbt_cfile, graph)


@pytest.mark.parametrize("n_floats", [20001, 40001, 16383])
@pytest.mark.parametrize("graph", [False, True])
def test_odd_trailing_float(tmp_path, n_floats, graph):
    """papr.c pairs an odd trailing float with its chunk buffer's stale
    content (_stale_q): 0.0 under 16384 floats, else the previous chunk's."""
    path = tmp_path / "odd.cfile"
    x = (RNG.standard_normal(n_floats) * 0.3).astype(np.float32)
    x[-1] = 2.5                          # the trailing float is the peak
    x.tofile(path)
    if n_floats > 16384:
        assert tpapr._stale_q(str(path)) != 0.0
    assert tpapr._stale_q(str(path)) == jpapr._stale_q(str(path))
    assert tpapr.report(str(path), graph, device="cpu") == \
        _jax_report(str(path), graph)


def test_chunked_matches_oneshot(dvbt_cfile):
    one = tpapr.analyze_file(dvbt_cfile, device="cpu")
    many = tpapr.analyze_file(dvbt_cfile, chunk_complex=7777, device="cpu")
    for attr in _ATTRS:
        assert getattr(one, attr) == getattr(many, attr), attr
    levels = tpapr.make_levels(one.mean_power, one.papr_db, True)
    np.testing.assert_array_equal(
        tpapr.ccdf_counts(dvbt_cfile, levels, device="cpu"),
        tpapr.ccdf_counts(dvbt_cfile, levels, 7777, device="cpu"))
    assert tpapr.report(dvbt_cfile, False, 7777, device="cpu") == \
        _jax_report(dvbt_cfile, False, 7777)


def test_pass2_counts_strictly_above():
    """``power > level``, as papr.c compares: ties, NaN and inf included."""
    x = RNG.standard_normal(2 * 5000).astype(np.float32)
    x[:8] = [1.0, 0.0, np.nan, 0.0, np.inf, 0.0, 0.5, 0.5]
    p = x[0::2] * x[0::2] + x[1::2] * x[1::2]
    levels = np.array([0.0, 0.5, 1.0, 1.0, 4.0], np.float32)
    got = tpapr._pass2_chunk(torch.from_numpy(x), torch.from_numpy(levels))
    want = (p[:, None] > levels[None, :]).sum(axis=0)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert tpapr._pass2_chunk(torch.from_numpy(x),
                              torch.zeros(0)).numel() == 0


def _fma_pairs(n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(i, q, fma) float32 where fma(i, i, q*q) differs from papr.c's
    i*i + q*q (two roundings, then the add)."""
    i_s, q_s, f_s = [], [], []
    while len(i_s) < n:
        i, q = (RNG.uniform(0.5, 1.0, 2)).astype(np.float32)
        qq = np.float32(q * q)
        exact = Fraction(float(i)) ** 2 + Fraction(float(qq))
        if Fraction(float(exact)) != exact:    # keep one rounding only
            continue
        fma = np.float32(float(exact))
        if fma != np.float32(np.float32(i * i) + qq):
            i_s.append(i), q_s.append(q), f_s.append(fma)
    return (np.array(i_s, np.float32), np.array(q_s, np.float32),
            np.array(f_s, np.float32))


def test_power_is_not_fused(tmp_path):
    """The port gives papr.c's separately rounded i*i + q*q, not the FMA's
    value, and its report on such samples equals the reference's."""
    i, q, fma = _fma_pairs(64)
    sep = np.float32(i * i) + np.float32(q * q)
    assert np.all(sep != fma)
    got = tpapr._power_f32(torch.from_numpy(i), torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, sep)
    raw = np.stack([i, q], axis=-1).reshape(-1)
    vals, idxs = tpapr._pass1_chunk(torch.from_numpy(raw))
    assert vals[0].item() == sep.max() and idxs[0].item() == sep.argmax()
    path = tmp_path / "fma.cfile"
    raw.tofile(path)
    stats = tpapr.analyze_file(str(path), device="cpu")
    assert np.float32(stats.peak) == sep.max() != fma[sep.argmax()]
    for graph in (False, True):
        assert tpapr.report(str(path), graph, device="cpu") == \
            _jax_report(str(path), graph)


def test_first_peak_wins(tmp_path):
    """Equal peaks: papr.c keeps the first (strict improvement only)."""
    x = np.zeros(2 * 300, np.float32)
    x[2 * 17] = x[2 * 250] = 3.0
    x[2 * 40 + 1] = x[2 * 99 + 1] = -2.0
    path = tmp_path / "ties.cfile"
    x.tofile(path)
    stats = tpapr.analyze_file(str(path), chunk_complex=64, device="cpu")
    assert (stats.peak_offset, stats.real_pos_offset,
            stats.imag_neg_offset) == (17, 17, 40)
    assert tpapr.report(str(path), False, device="cpu") == \
        _jax_report(str(path), False)


def test_cli(small_cfile, tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "dtv_utils_torch.cli", "papr", "-g",
         small_cfile, "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout == (GOLDEN / "papr_g_4096.txt").read_text()
    from dtv_utils_torch.cli.main import main

    assert main(["papr", "--device", "cpu"]) == 255
    assert main(["papr", str(tmp_path / "missing"), "--device=cpu"]) == 255


def test_cli_refuses_cuda_without_gpu(small_cfile, capsys):
    from dtv_utils_torch.cli.main import main

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert main(["papr", small_cfile]) == 255
    captured = capsys.readouterr()
    assert "is_available" in captured.err and captured.out == ""


def test_chip_smoke_papr_checks_pass_on_cpu():
    """chip_smoke.py's PAPR check on the CPU: the fixture's bytes match the
    golden's record, and the reports match papr.c's goldens."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    golden = json.loads((GOLDEN / "dvbt_torch_smoke.json").read_text())
    iq = (RNG.standard_normal(5000)
          + 1j * RNG.standard_normal(5000)).astype(np.complex64)
    smoke.check_papr(torch.device("cpu"), golden, iq)
