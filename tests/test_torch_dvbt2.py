"""The port's DVB-T2 modulator (dtv_utils_torch.tx.dvbt2, models/dvbt2,
rates/dvbt2) against the JAX reference, on the CPU.

Same TS through both, at the full BBC 32K profile and at the small configs
``tests/test_dvbt2.py`` uses.  Every stage up to the carrier grid, and the
stream state, are bit-exact (cells and grid compared as
``torch.view_as_real`` against the reference's rails moved last).  IQ after
the IFFT agrees within max|Δ|/rms < 1e-4, the bound DVB-T uses: the port's
FFT is pocketfft/cuFFT, the reference's a float32 matmul DFT.  Tone
reservation picks each symbol's peak by argmax; a near-tie between two peaks
could pick another one under that rounding, so the TR checks report any
such flip (symbol, both indices, both powers) instead of loosening a bound.

``tests/golden/dvbt2_torch_smoke.json`` and ``dvbt2_tables_bbc.txt`` are
what ``chip_smoke.py`` checks the card against.  They are made here from
the JAX reference; regenerate them from the repository root with
``JAX_PLATFORMS=cpu python -m tests.test_torch_dvbt2``.
"""

import dataclasses
import enum
import functools
import importlib.util
import io
import json
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtv_utils_tpu.cli import main as jcli
from dtv_utils_tpu.core import config as jconfig
from dtv_utils_tpu.models import dvbt2 as jmodel
from dtv_utils_tpu.ops import cfft as jcfft
from dtv_utils_tpu.tx import dvbt2 as J
from dtv_utils_tpu.tx import dvbt2_tables as JT
from dtv_utils_torch.cli import main as tcli
from dtv_utils_torch.core import config as tconfig
from dtv_utils_torch.models import dvbt2 as tmodel
from dtv_utils_torch.tx import dvbt2 as T
from dtv_utils_torch.tx import t2_annex as tannex

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "dvbt2_torch_smoke.json"
TABLES_GOLDEN = ROOT / "tests" / "golden" / "dvbt2_tables_bbc.txt"
GOLDEN_SEED = 0xD72
IQ_REL = 1e-4                      # max|Δ|/rms, port vs reference IQ
TR_REL = 1e-5                      # papr_reduce_tr on the same symbols

CFG_BBC = tmodel.PROFILES["bbc"]
CFG_SMALL = tconfig.Dvbt2Config(fec_blocks=3, ti_blocks=2)
CFG_SHORT = tconfig.Dvbt2Config(
    frame_size=tconfig.T2FrameSize.SHORT, fec_blocks=2, ti_blocks=1,
    code_rate=tconfig.T2CodeRate.R1_2,
    constellation=tconfig.T2Constellation.QPSK, rotation=False)
CFG_PAPR = tconfig.Dvbt2Config(papr_tr=True)
CONFIGS = {"bbc": CFG_BBC, "small": CFG_SMALL, "short": CFG_SHORT,
           "papr": CFG_PAPR}


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load_chip_smoke()


def _jcfg(cfg):
    """The reference's Dvbt2Config with the same field values as ``cfg``."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, enum.Enum):
            v = getattr(jconfig, type(v).__name__)[v.name]
        kw[f.name] = v
    return jconfig.Dvbt2Config(**kw)


def _stream(name: str) -> np.ndarray:
    """Two frames of TS for a config: the golden's input for BBC."""
    cfg = CONFIGS[name]
    n = 2 * cfg.payload_bytes_per_frame
    if name == "bbc":
        return smoke.seeded_ts(GOLDEN_SEED, n)
    ts = np.random.default_rng(0x72 + len(name)).integers(
        0, 256, size=n, dtype=np.uint8)
    ts[::188] = 0x47
    return ts


def _np_state(s) -> dict:
    return {f.name: np.asarray(getattr(s, f.name))
            for f in dataclasses.fields(s)}


def _assert_state_equal(port_state, ref: dict):
    got = T.state_to_numpy(port_state)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _rails_last(a: np.ndarray) -> np.ndarray:
    """The reference's rail-major float32 [2, ...] as [..., 2]."""
    return np.ascontiguousarray(np.moveaxis(a, 0, -1))


def _cplx(rails: np.ndarray) -> torch.Tensor:
    return torch.view_as_complex(torch.from_numpy(_rails_last(rails)))


def _real(x: torch.Tensor) -> np.ndarray:
    return torch.view_as_real(x).numpy()


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max()
                 / np.sqrt(np.mean(np.abs(want.astype(np.complex128)) ** 2)))


def _jax_time_symbols(jc, grid):
    """The reference's grid_to_iq up to its IFFT: rails [2, L_F, fft]."""
    fft, K = jc.fft_size, jc.carriers
    left = (fft - K + 1) // 2
    spec = jnp.zeros((2, grid.shape[1], fft), jnp.float32)
    spec = jcfft.ifftshift_rails(spec.at[:, :, left:left + K].set(grid))
    tr, ti = jcfft.fft_ri(spec[0], spec[1], sign=+1)
    return jnp.stack([tr, ti])


@functools.cache
def _jax_reference(name: str) -> dict:
    """The reference's stages over the two frames of ``_stream(name)``:
    per frame the BBFRAMEs, FECFRAMEs, cells, interleaved payload, grid,
    time-domain symbols and state, and the IQ of the whole stream."""
    jc = _jcfg(CONFIGS[name])
    ts = _stream(name)
    blk = jc.payload_bytes_per_frame

    def stages(x, st):
        bb, st = J.mode_adapt(jc, x, st)
        fec = J.fec_encode(jc, bb)
        cells = J.interleave_and_map(jc, fec)
        grid = J.build_frame_grid_fused(jc, cells)
        return (bb, fec, cells, J.cell_time_interleave(jc, cells), grid,
                _jax_time_symbols(jc, grid), st)

    run = jax.jit(stages)
    to_iq = jax.jit(functools.partial(J.grid_to_iq, jc))
    st = J.init_state(jc)
    frames, iq = [], []
    for i in range(len(ts) // blk):
        *arrays, st = run(jnp.asarray(ts[i * blk:(i + 1) * blk]), st)
        keys = ("bb", "fec", "cells", "payload", "grid", "time")
        frames.append(dict(zip(keys, map(np.array, arrays)),
                           state=_np_state(st)))
        rails = np.asarray(to_iq(arrays[4]))
        iq.append((rails[0] + 1j * rails[1]).astype(np.complex64))
    return {"frames": frames, "iq": np.concatenate(iq)}


def _tr_peaks(cfg, time_syms: torch.Tensor) -> tuple[list, list]:
    """Each TR iteration's peak per symbol, and |x|^2 before it."""
    x, peaks, powers = time_syms, [], []
    for _ in range(T.PAPR_ITERATIONS):
        powers.append((x.real * x.real + x.imag * x.imag).numpy())
        x, m = T._tr_step(cfg, x)
        peaks.append(m.numpy())
    return peaks, powers


def _report_flips(cfg, ref_time: np.ndarray, port_time: torch.Tensor
                  ) -> list[str]:
    """Symbols whose TR peak differs between the reference's and the
    port's time symbols, each with both indices and both powers."""
    want, _ = _tr_peaks(cfg, _cplx(ref_time))
    got, powers = _tr_peaks(cfg, port_time)
    out, seen = [], set()
    for it, (w, g, p) in enumerate(zip(want, got, powers)):
        for sym in np.nonzero(w != g)[0]:
            if sym not in seen:
                seen.add(sym)
                out.append(f"symbol {sym} iteration {it}: reference peak "
                           f"{w[sym]} (|x|^2 {p[sym, w[sym]]:.9g}), port "
                           f"peak {g[sym]} (|x|^2 {p[sym, g[sym]]:.9g})")
    return out


# ---------------------------------------------------------------------------
# Stages, each bit-exact, over two frames whose packet phase advances
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_mode_adapt(name):
    cfg = CONFIGS[name]
    ref = _jax_reference(name)
    ts = _stream(name)
    blk = cfg.payload_bytes_per_frame
    st = T.init_state(cfg, device="cpu")
    for i, want in enumerate(ref["frames"]):
        bb, st = T.mode_adapt(cfg, torch.from_numpy(ts[i * blk:(i + 1) * blk]),
                              st)
        assert bb.dtype == torch.uint8
        np.testing.assert_array_equal(bb.numpy(), want["bb"],
                                      err_msg=f"frame {i}")
        _assert_state_equal(st, want["state"])
    # the second frame starts mid-packet: 188 does not divide the frame
    assert ref["frames"][0]["state"]["packet_phase"] != 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fec_encode(name):
    cfg = CONFIGS[name]
    for want in _jax_reference(name)["frames"]:
        got = T.fec_encode(cfg, torch.from_numpy(want["bb"]))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want["fec"])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_interleave_and_map(name):
    cfg = CONFIGS[name]
    for want in _jax_reference(name)["frames"]:
        got = T.interleave_and_map(cfg, torch.from_numpy(want["fec"]))
        assert got.dtype == torch.complex64
        np.testing.assert_array_equal(_real(got), _rails_last(want["cells"]))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cell_time_interleave(name):
    """The stage alone on the reference's cells, and ``payload_cells``
    (TS to interleaved payload) over the stream."""
    cfg = CONFIGS[name]
    ts = _stream(name)
    blk = cfg.payload_bytes_per_frame
    st = T.init_state(cfg, device="cpu")
    for i, want in enumerate(_jax_reference(name)["frames"]):
        got = T.cell_time_interleave(cfg, _cplx(want["cells"]))
        np.testing.assert_array_equal(_real(got),
                                      _rails_last(want["payload"]))
        got, st = T.payload_cells(
            cfg, torch.from_numpy(ts[i * blk:(i + 1) * blk]), st)
        np.testing.assert_array_equal(_real(got),
                                      _rails_last(want["payload"]))
        _assert_state_equal(st, want["state"])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_frame_grid_fused_and_unfused(name):
    """The fused grid from mapped cells and the unfused one from the
    interleaved payload both equal the reference's grid."""
    cfg = CONFIGS[name]
    for want in _jax_reference(name)["frames"]:
        grid = _rails_last(want["grid"])
        assert grid.shape == (cfg.frame_symbols, cfg.carriers, 2)
        fused = T.build_frame_grid_fused(cfg, _cplx(want["cells"]))
        np.testing.assert_array_equal(_real(fused), grid)
        plain = T.build_frame_grid(cfg, _cplx(want["payload"]))
        np.testing.assert_array_equal(_real(plain), grid)


@pytest.mark.parametrize("name", ["bbc", "papr"])
def test_p1_samples(name):
    cfg = CONFIGS[name]
    got, want = T._p1_samples(cfg), J._p1_samples(_jcfg(cfg))
    assert got.dtype == want.dtype == np.float32 and got.shape == (2048, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_grid_to_iq(name):
    """The reference's grid through the port's back end, frame by frame."""
    cfg = CONFIGS[name]
    ref = _jax_reference(name)
    n = T.samples_per_frame(cfg)
    for i, want in enumerate(ref["frames"]):
        got = T.grid_to_iq(cfg, _cplx(want["grid"])).numpy()
        assert got.dtype == np.complex64 and got.shape == (n,)
        rel = _rel(got, ref["iq"][i * n:(i + 1) * n])
        print(f"{name} frame {i}: grid_to_iq max|d|/rms = {rel:.3e}")
        if cfg.papr_tr and not rel < IQ_REL:
            port_time = T.time_symbols(cfg, _cplx(want["grid"]))
            pytest.fail("TR peak flips: " + "; ".join(
                _report_flips(cfg, want["time"], port_time)))
        assert rel < IQ_REL, rel


def test_time_symbols():
    cfg = CFG_PAPR
    want = _jax_reference("papr")["frames"][0]
    got = T.time_symbols(cfg, _cplx(want["grid"])).numpy()
    assert _rel(got, want["time"][0] + 1j * want["time"][1]) < 1e-5


def test_papr_reduce_tr_on_reference_symbols():
    """Both packages' tone reservation on the reference's time-domain
    symbols: same peaks at every iteration, outputs within TR_REL."""
    cfg = CFG_PAPR
    jc = _jcfg(cfg)
    for want in _jax_reference("papr")["frames"]:
        ref = np.asarray(jax.jit(functools.partial(J.papr_reduce_tr, jc))(
            jnp.asarray(want["time"])))
        got = T.papr_reduce_tr(cfg, _cplx(want["time"])).numpy()
        rel = _rel(got, ref[0] + 1j * ref[1])
        print(f"papr_reduce_tr on the reference's symbols: max|d|/rms = "
              f"{rel:.3e}")
        assert rel < TR_REL, rel
        # the correction moved the peaks: TR did something
        before = np.abs(want["time"][0] + 1j * want["time"][1]).max(1)
        assert (np.abs(got).max(1) < before).any()


# ---------------------------------------------------------------------------
# The chain, over two frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_modulate_stream(name):
    """modulate_stream at the full BBC profile and the small configs: the
    final state bit-exact, IQ within IQ_REL of the reference's."""
    cfg = CONFIGS[name]
    ref = _jax_reference(name)
    iq, state = T.modulate_stream(cfg, _stream(name), device="cpu")
    assert iq.dtype == np.complex64 and iq.shape == ref["iq"].shape
    assert iq.size == 2 * T.samples_per_frame(cfg)
    _assert_state_equal(state, ref["frames"][-1]["state"])
    rel = _rel(iq, ref["iq"])
    print(f"{name}: modulate_stream IQ max|d|/rms = {rel:.3e}")
    assert rel < IQ_REL, rel


def test_stream_handed_over_from_jax():
    """The reference modulates frame 1; the port takes its state and
    modulates frame 2 to the reference's grid, state and IQ."""
    cfg = CFG_SMALL
    ref = _jax_reference("small")
    blk = cfg.payload_bytes_per_frame
    ts = _stream("small")[blk:]
    state = T.state_from_numpy(ref["frames"][0]["state"], device="cpu")
    bb, st = T.mode_adapt(cfg, torch.from_numpy(ts), state)
    grid = T.build_frame_grid_fused(
        cfg, T.interleave_and_map(cfg, T.fec_encode(cfg, bb)))
    np.testing.assert_array_equal(_real(grid),
                                  _rails_last(ref["frames"][1]["grid"]))
    _assert_state_equal(st, ref["frames"][1]["state"])
    iq, st = T.modulate_stream(cfg, ts, state, device="cpu")
    _assert_state_equal(st, ref["frames"][1]["state"])
    assert _rel(iq, ref["iq"][T.samples_per_frame(cfg):]) < IQ_REL


def test_state_from_numpy_rejects_mismatch():
    d = T.state_to_numpy(T.init_state(device="cpu"))
    assert d["packet_phase"].dtype == np.int32
    assert d["packet_phase"].shape == ()
    with pytest.raises(ValueError):
        T.state_from_numpy(dict(d, packet_phase=np.int64(0)), device="cpu")
    with pytest.raises(ValueError):
        T.state_from_numpy(dict(d, prev_tail=d["prev_tail"][:100]),
                           device="cpu")


def test_modulate_stream_rejects_partial_frame():
    with pytest.raises(ValueError):
        T.modulate_stream(CFG_SMALL, np.zeros(188, np.uint8), device="cpu")


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_cli_writes_modulate_stream_bytes(tmp_path):
    """``dvbt2-mod`` in this process, one frame of the default profile from
    a short TS it cycles: the file holds modulate_stream's bytes."""
    cfg = tmodel.PROFILES["blade"]
    ts = _stream("small")[:188 * 100]
    ts.tofile(tmp_path / "in.ts")
    out = io.StringIO()
    with redirect_stdout(out):
        assert tcli.main(["dvbt2-mod", "-n", "1", str(tmp_path / "in.ts"),
                          str(tmp_path / "out.cfile"), "--device",
                          "cpu"]) == 0
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert [m["metric"] for m in lines] == ["dvbt2_mod_throughput",
                                           "dvbt2_sample_rate"]
    assert lines[0]["device"] == "cpu" and lines[0]["profile"] == "blade"
    assert lines[1]["value"] == round(float(cfg.sample_rate) / 1e6, 6)
    want, _ = T.modulate_stream(
        cfg, np.tile(ts, -(-cfg.payload_bytes_per_frame // ts.size))[
            :cfg.payload_bytes_per_frame], device="cpu")
    assert (tmp_path / "out.cfile").read_bytes() == want.tobytes()


def test_cli_matches_reference_cli(tmp_path):
    """``python -m dtv_utils_torch.cli dvbt2-mod --papr`` against the
    reference's dvbt2-mod, one frame of a short TS both cycle."""
    ts = _stream("short")[:188 * 300]
    src = tmp_path / "in.ts"
    ts.tofile(src)
    assert jmodel.cli(["--papr", "-n", "1", str(src),
                       str(tmp_path / "ref.cfile")]) == 0
    res = subprocess.run(
        [sys.executable, "-m", "dtv_utils_torch.cli", "dvbt2-mod", "--papr",
         "-n", "1", str(src), str(tmp_path / "port.cfile"), "--device",
         "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    want = np.fromfile(tmp_path / "ref.cfile", dtype=np.complex64)
    got = np.fromfile(tmp_path / "port.cfile", dtype=np.complex64)
    assert got.shape == want.shape == (T.samples_per_frame(CFG_PAPR),)
    assert _rel(got, want) < IQ_REL


@pytest.mark.parametrize("argv", [["--profile", "bbc"], [],
                                  ["--papr"], ["--profile", "bbc", "--papr"]],
                         ids=["bbc", "blade", "blade_papr", "bbc_papr"])
def test_tables_matches_reference_cli(argv, capsys):
    rc_j = jcli.main(["dvbt2-mod", *argv, "--tables"])
    want = capsys.readouterr().out
    rc_t = tcli.main(["dvbt2-mod", *argv, "--tables"])
    got = capsys.readouterr().out
    assert (rc_t, got) == (rc_j, want)
    assert rc_t == 3                       # stand-in tables are active
    assert str(tannex.DATA_DIR.parent) not in got


def test_tables_golden(capsys):
    """The golden chip_smoke.py compares ``--tables`` with is the JAX CLI's
    report; it names files only, never the data directory."""
    assert jcli.main(["dvbt2-mod", "--profile", "bbc", "--tables"]) == 3
    assert TABLES_GOLDEN.read_text() == capsys.readouterr().out


def test_cli_refuses_cuda_without_gpu(tmp_path, capsys):
    """No fallback: ``--device cuda`` (the default) without a GPU is an
    error, not a CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    src = tmp_path / "in.ts"
    np.zeros(188, np.uint8).tofile(src)
    assert tcli.main(["dvbt2-mod", str(src),
                      str(tmp_path / "out.cfile")]) == 255
    assert "is_available" in capsys.readouterr().err
    assert not (tmp_path / "out.cfile").exists()


def test_cli_needs_input_file():
    with pytest.raises(SystemExit) as e:
        tcli.main(["dvbt2-mod", "--device", "cpu"])
    assert e.value.code == 2


@pytest.mark.parametrize("args", [
    "8 32 4 59 202 3 4 0 1 7 3",          # the BBC mux
    "8 4 0 100 31 3 3 0 0 7 2",           # the blade default
    "8 32 6 59 202 4 4 0 1 7 3", "0 8 1 100 50 2 2 1 0 5 1",
    "7 16 5 120 150 5 4 0 1 6 3", "8 1 3 10 3 1 1 1 0 1 0", "1 2 3"])
def test_dvbt2rate_matches_reference(args, capsys):
    rc_j = jcli.main(["dvbt2rate", *args.split()])
    want = capsys.readouterr()
    rc_t = tcli.main(["dvbt2rate", *args.split()])
    got = capsys.readouterr()
    assert (rc_t, got.out, got.err) == (rc_j, want.out, want.err)


# ---------------------------------------------------------------------------
# The golden chip_smoke.py holds the card to
# ---------------------------------------------------------------------------

def _golden_iq(cfg, iq: np.ndarray) -> dict:
    """The reference's IQ at 256 indices: P1's first 64, 64 across the end
    of the first symbol, 64 across the first frame's end (or the last 64)
    and 64 spread between."""
    frame = J.samples_per_frame(cfg)
    cut = frame if frame < iq.size else iq.size - 32
    sym_end = 2048 + cfg.fft_size + cfg.guard_samples
    idx = np.concatenate([
        np.arange(64), sym_end - 32 + np.arange(64), cut - 32 + np.arange(64),
        np.linspace(3000, iq.size - 3000, 64).astype(np.int64)])
    return {"iq_rms": float(np.sqrt(np.mean(np.abs(
                iq.astype(np.complex128)) ** 2))),
            "iq_index": idx.tolist(),
            "iq_re": [float(v) for v in iq[idx].real],
            "iq_im": [float(v) for v in iq[idx].imag]}


def golden_from_reference() -> dict:
    bbc, papr = _jcfg(CFG_BBC), _jcfg(CFG_PAPR)
    ts = _stream("bbc")
    ref = _jax_reference("bbc")
    # one tone-reservation frame of the default profile, its own input
    ts_p = smoke.seeded_ts(GOLDEN_SEED + 1, papr.payload_bytes_per_frame)
    def to_grid(x):
        bb, _ = J.mode_adapt(papr, x, J.init_state(papr))
        cells = J.interleave_and_map(papr, J.fec_encode(papr, bb))
        return J.build_frame_grid_fused(papr, cells)

    grid = jax.jit(to_grid)(jnp.asarray(ts_p))
    rails = np.asarray(jax.jit(functools.partial(J.grid_to_iq, papr))(grid))
    iq_p = (rails[0] + 1j * rails[1]).astype(np.complex64)
    peaks, _ = _tr_peaks(CFG_PAPR, _cplx(np.asarray(
        jax.jit(functools.partial(_jax_time_symbols, papr))(grid))))
    return {
        "about": "DVB-T2 BBC 32K (dvbt2-mod --profile bbc), 2 frames of "
                 "chip_smoke.seeded_ts(seed), and one frame of the default "
                 "profile with --papr from seeded_ts(seed + 1), through the "
                 "JAX reference dtv_utils_tpu.tx.dvbt2 on the CPU "
                 "(tests/test_torch_dvbt2.py); standins are sha256s of the "
                 "seeded stand-in tables (chip_smoke.dvbt2_standin_digests)",
        "seed": GOLDEN_SEED,
        "frames": 2,
        "ts_sha256": smoke.sha256(ts),
        "standins": smoke.dvbt2_standin_digests(JT, bbc, papr),
        "grid_sha256": [smoke.sha256(_rails_last(f["grid"]))
                        for f in ref["frames"]],
        "state_sha256": smoke.state_digest(ref["frames"][-1]["state"],
                                           smoke.DVBT2_STATE_KEYS),
        **_golden_iq(bbc, ref["iq"]),
        "papr": {
            "seed": GOLDEN_SEED + 1,
            "ts_sha256": smoke.sha256(ts_p),
            "grid_sha256": smoke.sha256(_rails_last(np.asarray(grid))),
            "tr_peaks": [p.tolist() for p in peaks],
            **_golden_iq(papr, iq_p),
        },
    }


def test_golden_matches_reference():
    want = golden_from_reference()
    got = json.loads(GOLDEN.read_text())
    assert got.keys() == want.keys()
    for k in ("seed", "frames", "ts_sha256", "standins", "grid_sha256",
              "state_sha256", "iq_index"):
        assert got[k] == want[k], k
    gp, wp = got.pop("papr"), want.pop("papr")
    for k in ("seed", "ts_sha256", "grid_sha256", "tr_peaks", "iq_index"):
        assert gp[k] == wp[k], k
    for g, w in ((got, want), (gp, wp)):
        np.testing.assert_allclose(g["iq_rms"], w["iq_rms"], rtol=1e-5)
        for k in ("iq_re", "iq_im"):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-6)


def test_chip_smoke_dvbt2_checks_pass_on_cpu():
    """chip_smoke.py's DVB-T2 checks, run on the CPU: the stand-in digests,
    the BBC slice, the tone-reservation frame and dvbt2-mod (a subprocess)
    against the golden."""
    golden = json.loads(GOLDEN.read_text())
    smoke.check_dvbt2_tables(golden)
    iq, rel = smoke.check_dvbt2_slice(torch.device("cpu"), golden)
    assert rel < IQ_REL
    assert smoke.check_dvbt2_papr(torch.device("cpu"), golden) < IQ_REL
    smoke.check_dvbt2_cli(golden, iq, "cpu")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    GOLDEN.write_text(json.dumps(golden_from_reference(), indent=1) + "\n")
    out = io.StringIO()
    with redirect_stdout(out):
        jcli.main(["dvbt2-mod", "--profile", "bbc", "--tables"])
    TABLES_GOLDEN.write_text(out.getvalue())
    print(f"wrote {GOLDEN} and {TABLES_GOLDEN}")
