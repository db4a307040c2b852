"""The port's DVB-T modulator (dtv_utils_torch.tx.dvbt, models/dvbt,
utils/checkpoint) against the JAX reference, on the CPU.

Same TS, made from a seed, through both.  Every integer stage, the carrier
grid and the stream state are bit-exact; IQ after the IFFT agrees within
max|Δ|/rms < 1e-4 (the port's FFT is pocketfft/cuFFT, the reference's a
float32 matmul DFT; the reference holds itself to 1e-3 against numpy.fft).

``tests/golden/dvbt_torch_smoke.json`` is what ``chip_smoke.py`` checks the
card against.  It is made here from the JAX reference; regenerate it
from the repository root with
``JAX_PLATFORMS=cpu python -m tests.test_torch_dvbt``.
"""

import dataclasses
import functools
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtv_utils_tpu.core import config as jconfig
from dtv_utils_tpu.ops import cfft as jcfft
from dtv_utils_tpu.ops import convcode as jconv
from dtv_utils_tpu.ops import interleave as jilv
from dtv_utils_tpu.ops import rs as jrs
from dtv_utils_tpu.tx import dvbt as J
from dtv_utils_tpu.tx import dvbt_tables as JT
from dtv_utils_tpu.utils import checkpoint as jckpt
from dtv_utils_torch.core import config as tconfig
from dtv_utils_torch.ops import cfft as tcfft
from dtv_utils_torch.ops import convcode as tconv
from dtv_utils_torch.ops import interleave as tilv
from dtv_utils_torch.ops import rs as trs
from dtv_utils_torch.tx import dvbt as T
from dtv_utils_torch.utils import checkpoint as tckpt
from tests.dvbt_serial_ref import SerialDvbt

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "dvbt_torch_smoke.json"
GOLDEN_SEED = 0xD7B
IQ_REL = 1e-4                      # max|Δ|/rms, port vs reference IQ
RNG = np.random.default_rng(0x7D7B)

M, C, R, G = (tconfig.TransmissionMode, tconfig.Constellation,
              tconfig.CodeRate, tconfig.GuardInterval)
FLAGSHIP = tconfig.DvbtConfig(mode=M.M8K, bandwidth_mhz=8,
                              constellation=C.QAM64, code_rate=R.R7_8,
                              guard=G.G1_32)
CFG_MIN = tconfig.DvbtConfig(mode=M.M2K, bandwidth_mhz=6,
                             constellation=C.QPSK, code_rate=R.R1_2,
                             guard=G.G1_4)
# 2K configs in which every constellation, code rate and guard appears
CONFIGS_2K = [
    CFG_MIN,
    tconfig.DvbtConfig(M.M2K, 7, C.QAM16, R.R2_3, G.G1_8),
    tconfig.DvbtConfig(M.M2K, 8, C.QAM64, R.R3_4, G.G1_16),
    tconfig.DvbtConfig(M.M2K, 5, C.QPSK, R.R5_6, G.G1_32),
    tconfig.DvbtConfig(M.M2K, 8, C.QAM16, R.R7_8, G.G1_4, cell_id=7),
]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load_chip_smoke()


def _jcfg(cfg):
    """The reference's DvbtConfig with the same field values as ``cfg``."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name in ("mode", "constellation", "code_rate", "guard"):
            v = getattr(jconfig, type(v).__name__)[v.name]
        kw[f.name] = v
    return jconfig.DvbtConfig(**kw)


def _ts(cfg, n_sf: int, seed: int) -> np.ndarray:
    ts = np.random.default_rng(seed).integers(
        0, 256, size=n_sf * cfg.ts_bytes_per_superframe, dtype=np.uint8)
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


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max()
                 / np.sqrt(np.mean(np.abs(want) ** 2)))


@functools.cache
def _jax_reference(cfg, ts_bytes: bytes) -> dict:
    """The reference over whole superframes of ``ts``: carriers (float32
    [272, K, 2]) and state after each superframe, and the IQ."""
    jc = _jcfg(cfg)
    ts = np.frombuffer(ts_bytes, np.uint8)
    blk = cfg.ts_bytes_per_superframe
    enc = jax.jit(functools.partial(J.encode_to_carriers, jc))
    to_iq = jax.jit(functools.partial(J.carriers_to_iq, jc))
    st = J.init_state(jc)
    carriers, states, iq = [], [], []
    for i in range(len(ts) // blk):
        c, st = enc(jnp.asarray(ts[i * blk:(i + 1) * blk]), st)
        carriers.append(np.asarray(c))
        states.append(_np_state(st))
        iq.append(np.asarray(to_iq(c)))
    iq = np.concatenate(iq, axis=1)
    return {"carriers": carriers, "states": states,
            "iq": (iq[0] + 1j * iq[1]).astype(np.complex64)}


def _golden_ts() -> np.ndarray:
    return smoke.seeded_ts(GOLDEN_SEED, 2 * FLAGSHIP.ts_bytes_per_superframe)


def _golden_index(total: int) -> np.ndarray:
    """256 IQ indices: the first 64 (interleaver start-up), 64 across the
    superframe boundary, the last 64 and 64 spread between."""
    half = total // 2
    return np.concatenate([
        np.arange(64), half - 32 + np.arange(64), total - 64 + np.arange(64),
        np.linspace(1000, total - 1000, 64).astype(np.int64)])


def golden_from_reference() -> dict:
    ts = _golden_ts()
    ref = _jax_reference(FLAGSHIP, ts.tobytes())
    iq = ref["iq"]
    idx = _golden_index(iq.size)
    return {
        "about": "DVB-T 8K 64-QAM 7/8 GI 1/32 8 MHz, 2 superframes of "
                 "chip_smoke.seeded_ts(seed), through the JAX reference "
                 "dtv_utils_tpu.tx.dvbt on the CPU (tests/test_torch_dvbt.py)"
                 "; papr_input_sha256 is chip_smoke.papr_fixture()",
        "seed": GOLDEN_SEED,
        "superframes": 2,
        "ts_sha256": smoke.sha256(ts),
        "carriers_sha256": [smoke.sha256(c) for c in ref["carriers"]],
        "state_sha256": smoke.state_digest(ref["states"][-1],
                                           smoke.DVBT_STATE_KEYS),
        "iq_rms": float(np.sqrt(np.mean(np.abs(iq.astype(np.complex128))
                                        ** 2))),
        "iq_index": idx.tolist(),
        "iq_re": [float(v) for v in iq[idx].real],
        "iq_im": [float(v) for v in iq[idx].imag],
        "papr_input_sha256": smoke.sha256(smoke.papr_fixture()),
    }


# ---------------------------------------------------------------------------
# Stages, each bit-exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase", [0, 3, 7, 13])
def test_dispersal(phase):
    """The mask row is picked by a device scalar; phase 13 wraps to 5."""
    cfg = CFG_MIN
    ts = _ts(cfg, 1, phase)
    want = ts ^ J._plan(_jcfg(cfg))["masks"][phase % 8]
    got, new_phase = T.disperse(cfg, torch.from_numpy(ts),
                                torch.tensor(phase, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert new_phase.dtype == torch.int32 and new_phase.dim() == 0
    assert int(new_phase) == (phase + cfg.rs_blocks_per_superframe) % 8


def test_rs_encode_bytes():
    msgs = RNG.integers(0, 256, size=(40, 188), dtype=np.uint8)
    got = trs.DVBT_RS().encode_bytes(torch.from_numpy(msgs))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (40, 204)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jrs.DVBT_RS().encode_bytes(jnp.asarray(msgs))))
    np.testing.assert_array_equal(got.numpy(),
                                  trs.DVBT_RS().encode_bytes_ref(msgs))
    np.testing.assert_array_equal(trs.DVBT_RS().encode_bytes_ref(msgs),
                                  jrs.DVBT_RS().encode_bytes_ref(msgs))


def test_forney_three_blocks_with_carry():
    I, Mm = T.OUTER_I, T.OUTER_M
    n = 24 * 204
    stream = RNG.integers(0, 256, size=(3, n), dtype=np.uint8)
    idx_np = tilv.forney_gather_indices(I, Mm, n)
    np.testing.assert_array_equal(idx_np, jilv.forney_gather_indices(I, Mm, n))
    idx_t, idx_j = torch.from_numpy(idx_np), jnp.asarray(idx_np)
    carry_t = torch.zeros(tilv.forney_carry_len(I, Mm), dtype=torch.uint8)
    carry_j = jnp.zeros(jilv.forney_carry_len(I, Mm), jnp.uint8)
    for blk in stream:
        want, carry_j = jilv.forney_interleave(jnp.asarray(blk), carry_j, idx_j)
        got, carry_t = tilv.forney_interleave(torch.from_numpy(blk), carry_t,
                                              idx_t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(carry_t.numpy(), np.asarray(carry_j))
    # the chain's stage, at a superframe of CFG_MIN, across two blocks
    n_sf = CFG_MIN.rs_blocks_per_superframe * 204
    full = RNG.integers(0, 256, size=2 * n_sf, dtype=np.uint8)
    carry_s = T.init_state(device="cpu").outer_carry
    idx_j = jnp.asarray(jilv.forney_gather_indices(I, Mm, n_sf))
    carry_j = jnp.zeros(jilv.forney_carry_len(I, Mm), jnp.uint8)
    for part in (full[:n_sf], full[n_sf:]):
        want, carry_j = jilv.forney_interleave(jnp.asarray(part), carry_j,
                                               idx_j)
        got, carry_s = T.outer_interleave(CFG_MIN, torch.from_numpy(part),
                                          carry_s)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(carry_s.numpy(), np.asarray(carry_j))


def test_forney_blocks_in_one_call():
    """Three blocks in one call gather with one block's index from three
    overlapping windows: equal to the reference over the same bytes as one
    block; a length that is not whole blocks raises."""
    I, Mm = T.OUTER_I, T.OUTER_M
    n = 24 * 204
    stream = RNG.integers(0, 256, size=3 * n, dtype=np.uint8)
    want, carry_j = jilv.forney_interleave(
        jnp.asarray(stream), jnp.zeros(jilv.forney_carry_len(I, Mm), jnp.uint8),
        jnp.asarray(jilv.forney_gather_indices(I, Mm, 3 * n)))
    idx = torch.from_numpy(tilv.forney_gather_indices(I, Mm, n))
    carry = torch.zeros(tilv.forney_carry_len(I, Mm), dtype=torch.uint8)
    got, carry_t = tilv.forney_interleave(torch.from_numpy(stream), carry, idx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(carry_t.numpy(), np.asarray(carry_j))
    with pytest.raises(ValueError):
        tilv.forney_interleave(torch.from_numpy(stream[:-12]), carry, idx)


def test_outer_interleave_rejects_short_carry():
    with pytest.raises(ValueError):
        T.outer_interleave(CFG_MIN, torch.zeros(204 * 12, dtype=torch.uint8),
                           torch.zeros(2244 - 12, dtype=torch.uint8))


@pytest.mark.parametrize("rate", [(1, 2), (2, 3), (3, 4), (5, 6), (7, 8)])
def test_conv_encode_and_puncture(rate):
    assert tconv.G1_TAPS == jconv.G1_TAPS and tconv.G2_TAPS == jconv.G2_TAPS
    assert tconv.PUNCTURE_PATTERNS == jconv.PUNCTURE_PATTERNS
    n = 7 * 5 * 6 * 40                     # a multiple of every period
    bits = RNG.integers(0, 2, size=2 * n, dtype=np.uint8)
    st_t = torch.zeros(6, dtype=torch.uint8)
    st_j = jnp.zeros(6, jnp.uint8)
    idx = tconv.puncture_indices(rate, n)
    np.testing.assert_array_equal(idx, jconv.puncture_indices(rate, n))
    for part in (bits[:n], bits[n:]):
        want = np.asarray(jconv.conv_encode(jnp.asarray(part), st_j))
        got = tconv.conv_encode(torch.from_numpy(part), st_t)
        assert got.dtype == torch.uint8 and tuple(got.shape) == (n, 2)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.reshape(-1).numpy()[idx],
                                      want.reshape(-1)[idx])
        st_t = torch.flip(torch.from_numpy(part[-6:]), (0,))
        st_j = jnp.asarray(part[-6:][::-1])


@pytest.mark.parametrize("cfg", [FLAGSHIP] + CONFIGS_2K[1:3],
                         ids=["flagship", "qam16_23", "qam64_34"])
def test_generator_matrix_words(cfg):
    """The fused generator-matrix product equals the reference's unfused
    ops: conv_encode → puncture → demux + bit interleave → MSB-first words,
    across two blocks with the coder state carried."""
    v = cfg.constellation.bits_per_symbol
    n_bytes = cfg.rs_blocks_per_superframe * 204
    n_cells = cfg.cells_per_superframe
    ilv = JT.bit_interleaver_indices(v, n_cells)
    state_t = torch.zeros(6, dtype=torch.uint8)
    state_j = jnp.zeros(6, jnp.uint8)
    for _ in range(2):
        outer = RNG.integers(0, 256, size=n_bytes, dtype=np.uint8)
        dbits = np.unpackbits(outer)
        xy = np.asarray(jconv.conv_encode(jnp.asarray(dbits), state_j))
        kept = xy.reshape(-1)[jconv.puncture_indices(cfg.code_rate.value,
                                                     dbits.size)]
        planes = kept[ilv]                                  # [n_cells, v]
        want = (planes.astype(np.int32)
                << np.arange(v - 1, -1, -1, dtype=np.int32)).sum(
                    -1, dtype=np.int32)
        got, state_t = T.inner_code(cfg, torch.from_numpy(outer), state_t)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        state_j = jnp.asarray(dbits[-6:][::-1])
        np.testing.assert_array_equal(state_t.numpy(), np.asarray(state_j))


@pytest.mark.parametrize("n", [2048, 8192])
def test_ifft_against_matmul_dft(n):
    x = (RNG.standard_normal((5, n))
         + 1j * RNG.standard_normal((5, n))).astype(np.complex64)
    wr, wi = jcfft.fft_ri(jnp.asarray(x.real), jnp.asarray(x.imag), sign=+1)
    want = np.asarray(wr) + 1j * np.asarray(wi)
    got = tcfft.ifft_unnormalized(torch.from_numpy(x))
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), want) < 1e-5
    np.testing.assert_allclose(got.numpy(), np.fft.ifft(x) * n,
                               rtol=0, atol=1e-4 * np.sqrt(n))
    rails = np.stack([x.real, x.imag], axis=-2)            # [5, 2, n]
    shifted = np.asarray(jcfft.ifftshift_rails(jnp.asarray(rails)))
    got = tcfft.ifftshift(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.real, shifted[:, 0])
    np.testing.assert_array_equal(got.imag, shifted[:, 1])


def test_ifft_rejects_other_dtypes():
    with pytest.raises(TypeError):
        tcfft.ifft_unnormalized(torch.zeros(8, dtype=torch.complex128))


# ---------------------------------------------------------------------------
# The chain, over two superframes
# ---------------------------------------------------------------------------

def _check_chain(cfg, ts: np.ndarray) -> float:
    """Carriers and state bit-exact per superframe, IQ within IQ_REL;
    returns the IQ's max|Δ|/rms."""
    ref = _jax_reference(cfg, ts.tobytes())
    blk = cfg.ts_bytes_per_superframe
    st = T.init_state(cfg, device="cpu")
    for i in range(len(ts) // blk):
        carriers, st = T.encode_to_carriers(
            cfg, torch.from_numpy(ts[i * blk:(i + 1) * blk]), st)
        assert carriers.dtype == torch.complex64
        got = torch.view_as_real(carriers).numpy()
        assert got.dtype == ref["carriers"][i].dtype
        np.testing.assert_array_equal(got, ref["carriers"][i],
                                      err_msg=f"superframe {i}")
        _assert_state_equal(st, ref["states"][i])
    iq, state = T.modulate_stream(cfg, ts, device="cpu")
    assert iq.dtype == np.complex64 and iq.shape == ref["iq"].shape
    assert iq.size == 2 * cfg.samples_per_superframe
    _assert_state_equal(state, ref["states"][-1])
    rel = _rel(iq, ref["iq"])
    assert rel < IQ_REL, rel
    return rel


def test_chain_flagship_two_superframes():
    rel = _check_chain(FLAGSHIP, _golden_ts())
    print(f"flagship IQ max|d|/rms = {rel:.3e}")


@pytest.mark.parametrize("cfg", CONFIGS_2K,
                         ids=["min", "qam16_23_g8", "qam64_34_g16",
                              "qpsk_56_g32", "qam16_78_cell"])
def test_chain_2k_two_superframes(cfg):
    _check_chain(cfg, _ts(cfg, 2, 42))


def test_chain_matches_serial_oracle():
    """Against the byte/bit-serial encoder of tests/dvbt_serial_ref.py."""
    cfg = CFG_MIN
    ts = _ts(cfg, 1, 3)
    serial = SerialDvbt(_jcfg(cfg))
    want = serial.encode_to_carriers(ts)
    carriers, _ = T.encode_to_carriers(cfg, torch.from_numpy(ts),
                                       T.init_state(cfg, device="cpu"))
    np.testing.assert_array_equal(carriers.numpy(), want)
    iq = T.carriers_to_iq(cfg, carriers).numpy()
    assert _rel(iq, serial.to_iq(want)) < IQ_REL


def test_stream_handed_over_from_jax():
    """The reference modulates superframe 1; the port takes its state and
    modulates superframe 2."""
    ts = _ts(CFG_MIN, 2, 42)
    ref = _jax_reference(CFG_MIN, ts.tobytes())
    blk = CFG_MIN.ts_bytes_per_superframe
    state = T.state_from_numpy(ref["states"][0], device="cpu")
    carriers, state = T.encode_to_carriers(CFG_MIN, torch.from_numpy(ts[blk:]),
                                           state)
    np.testing.assert_array_equal(torch.view_as_real(carriers).numpy(),
                                  ref["carriers"][1])
    _assert_state_equal(state, ref["states"][1])


def test_state_from_numpy_rejects_mismatch():
    d = T.state_to_numpy(T.init_state(device="cpu"))
    with pytest.raises(ValueError):
        T.state_from_numpy(dict(d, packet_phase=np.int64(0)), device="cpu")
    with pytest.raises(ValueError):
        T.state_from_numpy(dict(d, outer_carry=d["outer_carry"][:100]),
                           device="cpu")


def test_modulate_stream_rejects_partial_superframe():
    with pytest.raises(ValueError):
        T.modulate_stream(CFG_MIN, np.zeros(188, np.uint8), device="cpu")


# ---------------------------------------------------------------------------
# Checkpoints and the CLI
# ---------------------------------------------------------------------------

def test_checkpoint_crosses_packages(tmp_path):
    """A state file written by either package loads in the other, and both
    continue to the reference's carriers."""
    cfg, jc = CFG_MIN, _jcfg(CFG_MIN)
    ts = _ts(cfg, 2, 42)
    ref = _jax_reference(cfg, ts.tobytes())
    blk = cfg.ts_bytes_per_superframe
    # JAX writes, the port resumes
    jstate = J.init_state(jc)
    _, jstate = jax.jit(functools.partial(J.encode_to_carriers, jc))(
        jnp.asarray(ts[:blk]), jstate)
    jckpt.save_state(str(tmp_path / "j.npz"), jstate, kind="dvbt")
    tstate = tckpt.load_state(str(tmp_path / "j.npz"),
                              T.init_state(cfg, device="cpu"), kind="dvbt")
    _assert_state_equal(tstate, ref["states"][0])
    carriers, _ = T.encode_to_carriers(cfg, torch.from_numpy(ts[blk:]), tstate)
    np.testing.assert_array_equal(torch.view_as_real(carriers).numpy(),
                                  ref["carriers"][1])
    # the port writes, JAX resumes
    _, tstate = T.encode_to_carriers(cfg, torch.from_numpy(ts[:blk]),
                                     T.init_state(cfg, device="cpu"))
    tckpt.save_state(str(tmp_path / "t.npz"), tstate, kind="dvbt")
    jstate = jckpt.load_state(str(tmp_path / "t.npz"), J.init_state(jc),
                              kind="dvbt")
    carriers, _ = jax.jit(functools.partial(J.encode_to_carriers, jc))(
        jnp.asarray(ts[blk:]), jstate)
    np.testing.assert_array_equal(np.asarray(carriers), ref["carriers"][1])
    with pytest.raises(ValueError, match="kind"):
        tckpt.load_state(str(tmp_path / "t.npz"),
                         T.init_state(cfg, device="cpu"), kind="j83b")


def test_cli_resume_equals_one_run(tmp_path):
    """--save-state after one superframe, then --load-state for the next,
    writes the same bytes as one two-superframe run."""
    from dtv_utils_torch.models import dvbt as model

    cfg_args = ["-m", "t2k", "-c", "6", "-C", "qpsk", "-r", "1/2", "-g", "1/4",
                "--device", "cpu"]
    blk = CFG_MIN.ts_bytes_per_superframe
    ts = _ts(CFG_MIN, 2, 9)
    ts.tofile(tmp_path / "in.ts")
    ts[blk:].tofile(tmp_path / "rest.ts")
    run = lambda *a: model.cli([*cfg_args, *map(str, a)])  # noqa: E731
    assert run("-o", tmp_path / "one.cfile", tmp_path / "in.ts") == 0
    assert run("-n", 1, "--save-state", tmp_path / "s.npz",
               "-o", tmp_path / "a.cfile", tmp_path / "in.ts") == 0
    assert run("-n", 1, "--load-state", tmp_path / "s.npz",
               "-o", tmp_path / "b.cfile", tmp_path / "rest.ts") == 0
    one = (tmp_path / "one.cfile").read_bytes()
    assert len(one) == 2 * CFG_MIN.samples_per_superframe * 8
    assert (tmp_path / "a.cfile").read_bytes() + \
        (tmp_path / "b.cfile").read_bytes() == one


def test_cli_matches_reference_cli(tmp_path):
    """``python -m dtv_utils_torch.cli dvbt-mod ... --device cpu`` against
    the reference's dvbt-mod, flagship defaults, one superframe of a short
    TS that both cycle."""
    from dtv_utils_tpu.models import dvbt as jmodel

    ts = RNG.integers(0, 256, size=188 * 1000, dtype=np.uint8)
    ts[::188] = 0x47
    src = tmp_path / "in.ts"
    ts.tofile(src)
    assert jmodel.cli(["-n", "1", "-o", str(tmp_path / "ref.cfile"),
                       str(src)]) == 0
    res = subprocess.run(
        [sys.executable, "-m", "dtv_utils_torch.cli", "dvbt-mod", "-n", "1",
         "-o", str(tmp_path / "port.cfile"), "--txvga1", "3", "-f", "5e8",
         "--device", "cpu", str(src)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = [json.loads(x) for x in res.stdout.splitlines()]
    assert [m["metric"] for m in lines] == ["dvbt_mod_throughput",
                                           "dvbt_ts_rate"]
    assert lines[0]["device"] == "cpu" and "includes_compile" not in lines[0]
    assert lines[0]["iq_samples"] == FLAGSHIP.samples_per_superframe
    assert lines[1]["value"] == round(float(FLAGSHIP.useful_bitrate) / 1e6, 6)
    want = np.fromfile(tmp_path / "ref.cfile", dtype=np.complex64)
    got = np.fromfile(tmp_path / "port.cfile", dtype=np.complex64)
    assert got.shape == want.shape == (FLAGSHIP.samples_per_superframe,)
    assert _rel(got, want) < IQ_REL


@pytest.mark.parametrize("argv", [["-m", "t4k"], ["-c", "9"],
                                  ["-r", "4/5"]])
def test_cli_rejects_bad_config(tmp_path, argv):
    from dtv_utils_torch.models import dvbt as model

    src = tmp_path / "in.ts"
    np.zeros(188, np.uint8).tofile(src)
    with pytest.raises(SystemExit) as e:
        model.cli([*argv, "--device", "cpu", str(src)])
    assert e.value.code == 255


def test_cli_refuses_cuda_without_gpu(tmp_path, capsys):
    """No fallback: ``--device cuda`` (the default) without a GPU is an
    error, not a CPU run."""
    from dtv_utils_torch.cli.main import main

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    src = tmp_path / "in.ts"
    np.zeros(188, np.uint8).tofile(src)
    assert main(["dvbt-mod", "-o", str(tmp_path / "out.cfile"),
                 str(src)]) == 255
    assert "is_available" in capsys.readouterr().err
    assert not (tmp_path / "out.cfile").exists()


# ---------------------------------------------------------------------------
# The golden chip_smoke.py holds the card to
# ---------------------------------------------------------------------------

def test_golden_matches_reference():
    want = golden_from_reference()
    got = json.loads(GOLDEN.read_text())
    assert got.keys() == want.keys()
    for k in ("seed", "superframes", "ts_sha256", "carriers_sha256",
              "state_sha256", "iq_index", "papr_input_sha256"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["iq_rms"], want["iq_rms"], rtol=1e-5)
    np.testing.assert_allclose(got["iq_re"], want["iq_re"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got["iq_im"], want["iq_im"], rtol=0,
                               atol=1e-6)


def test_chip_smoke_dvbt_checks_pass_on_cpu():
    """chip_smoke.py's DVB-T checks, run on the CPU: the slice against the
    golden, then dvbt-mod and its save/load-state split run."""
    golden = json.loads(GOLDEN.read_text())
    iq, rel = smoke.check_dvbt_slice(torch.device("cpu"), golden)
    assert rel < IQ_REL
    smoke.check_dvbt_cli(golden, iq, "cpu")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    GOLDEN.write_text(json.dumps(golden_from_reference(), indent=1) + "\n")
    print(f"wrote {GOLDEN}")
