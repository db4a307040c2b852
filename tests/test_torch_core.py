"""Port core (dtv_utils_torch.core, ops/rs, the DVB-T host tables) against
the JAX reference.

Same inputs, made with numpy from a seed, go through both packages.  Integer
results must be bit-exact, and every host table the port copies must equal
the reference's array for array: those copies are the price of running
without JAX on the GPU machine, and this file is what keeps one source of
truth.
"""

import dataclasses
import enum
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtv_utils_tpu.core import bits as jbits
from dtv_utils_tpu.core import config as jconfig
from dtv_utils_tpu.core import cplx as jcplx
from dtv_utils_tpu.core import galois as jgalois
from dtv_utils_tpu.core import prbs as jprbs
from dtv_utils_tpu.ops import rs as jrs
from dtv_utils_tpu.tx import dvbt as JD
from dtv_utils_tpu.tx import dvbt_tables as JDT
from dtv_utils_tpu.tx import j83b as J
from dtv_utils_torch import resolve_device
from dtv_utils_torch.core import bits as tbits
from dtv_utils_torch.core import config as tconfig
from dtv_utils_torch.core import cplx as tcplx
from dtv_utils_torch.core import galois as tgalois
from dtv_utils_torch.core import prbs as tprbs
from dtv_utils_torch.ops import rs as trs
from dtv_utils_torch.tx import dvbt as TD
from dtv_utils_torch.tx import dvbt_tables as TDT
from dtv_utils_torch.tx import j83b as T

ROOT = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(0x70C4)


def test_port_imports_no_jax():
    """Every module of the port imports with neither jax nor the JAX package
    loaded.  In a subprocess: this process has imported jax already."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dtv_utils_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    dtv_utils_torch.__path__, 'dtv_utils_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'dtv_utils_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 30      # the whole port imported


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device("cuda").index is not None
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_device("cuda")


@pytest.mark.parametrize("shape", [(5,), (3, 188), (2, 4, 7)])
def test_bytes_bits_round_trip(shape):
    x = RNG.integers(0, 256, size=shape, dtype=np.uint8)
    want = np.asarray(jbits.bytes_to_bits(jnp.asarray(x)))
    got = tbits.bytes_to_bits(torch.from_numpy(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    back = tbits.bits_to_bytes(got)
    assert back.dtype == torch.uint8
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jbits.bits_to_bytes(jnp.asarray(want))))


@pytest.mark.parametrize("width", [6, 7, 8])
def test_words_bits_round_trip(width):
    w = RNG.integers(0, 1 << width, size=(4, 61), dtype=np.int32)
    want = np.asarray(jbits.words_to_bits(jnp.asarray(w), width))
    got = tbits.words_to_bits(torch.from_numpy(w), width)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    back = tbits.bits_to_words(got, width)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), w)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jbits.bits_to_words(jnp.asarray(want), width)))


@pytest.mark.parametrize("k,p", [(854, 35), (889, 7), (1496, 8)])
def test_gf2_matmul(k, p):
    """The J.83B shapes (RS, extension, CRC), bit-exact against the int8
    MXU formulation."""
    x = RNG.integers(0, 2, size=(13, k), dtype=np.uint8)
    m = RNG.integers(0, 2, size=(k, p), dtype=np.uint8)
    want = np.asarray(jgalois.gf2_matmul(jnp.asarray(x), jnp.asarray(m)))
    got = tgalois.gf2_matmul(torch.from_numpy(x), torch.from_numpy(m))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_gf128_tables():
    for name in ("m", "q", "poly"):
        assert getattr(tgalois.GF128, name) == getattr(jgalois.GF128, name)
    np.testing.assert_array_equal(tgalois.GF128.exp, jgalois.GF128.exp)
    np.testing.assert_array_equal(tgalois.GF128.log, jgalois.GF128.log)
    a = RNG.integers(0, 128, size=500)
    b = RNG.integers(0, 128, size=500)
    np.testing.assert_array_equal(tgalois.GF128.mul(a, b),
                                  jgalois.GF128.mul(a, b))


def test_rs_parity_bitmatrix():
    g = tgalois.GF128.rs_generator_poly(5, 1)
    np.testing.assert_array_equal(g, jgalois.GF128.rs_generator_poly(5, 1))
    np.testing.assert_array_equal(
        tgalois.rs_parity_bitmatrix(tgalois.GF128, 122, g),
        jgalois.rs_parity_bitmatrix(jgalois.GF128, 122, g))


def test_rs_parity_bits():
    msg = RNG.integers(0, 2, size=(9, 122 * 7), dtype=np.uint8)
    want = np.asarray(J._rs().parity_bits(jnp.asarray(msg)))
    got = T._rs().parity_bits(torch.from_numpy(msg))
    np.testing.assert_array_equal(T._rs().M, J._rs().M)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gf2_poly_mod_matrix():
    g = np.zeros(9, dtype=np.uint8)
    g[[0, 2, 4, 6, 7, 8]] = 1
    np.testing.assert_array_equal(tgalois.gf2_poly_mod_matrix(g, 187 * 8),
                                  jgalois.gf2_poly_mod_matrix(g, 187 * 8))


@pytest.mark.parametrize("name", [
    "_ext_sum_matrix", "_randomizer_frame", "_framing_crc_matrix",
    "_fsync_bits"])
def test_j83b_host_tables(name):
    got, want = getattr(T, name)(), getattr(J, name)()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_rrc_taps():
    got = T.rrc_taps(tconfig.J83bConfig())
    want = J.rrc_taps(jconfig.J83bConfig())
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", [
    "RS_N", "RS_K", "BLOCKS_PER_FRAME", "FRAME_SYMBOLS", "FSYNC_BITS",
    "FRAME_BITS", "FRAMES_PER_SUPERBLOCK", "PACKETS_PER_SUPERBLOCK",
    "FSYNC_WORD", "ILV_I", "ILV_J", "G1_TAPS", "G2_TAPS", "PUNCT_X",
    "PUNCT_Y", "CONSTELLATION_64", "CONSTELLATION_64_RAILS"])
def test_j83b_constants(name):
    got, want = getattr(T, name), getattr(J, name)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_j83b_config():
    t, j = tconfig.J83bConfig(), jconfig.J83bConfig()
    names = [f.name for f in dataclasses.fields(j)]
    assert names == [f.name for f in dataclasses.fields(t)]
    for name in names:
        a, b = getattr(t, name), getattr(j, name)
        if name == "constellation":
            assert (a.name, a.value) == (b.name, b.value)
        else:
            assert a == b
    assert t.sample_rate == j.sample_rate
    assert ([(c.name, c.value) for c in tconfig.Constellation]
            == [(c.name, c.value) for c in jconfig.Constellation])


def test_rails_boundary():
    c = (RNG.normal(size=(77,)) + 1j * RNG.normal(size=(77,))).astype(
        np.complex64)
    rails = tcplx.rails_from_np(c, device="cpu")
    assert rails.dtype == torch.float32 and tuple(rails.shape) == (2, 77)
    np.testing.assert_array_equal(rails.numpy(), jcplx.rails_from_np(c))
    back = tcplx.rails_to_np(rails)
    assert back.dtype == np.complex64
    np.testing.assert_array_equal(back, jcplx.rails_to_np(rails.numpy()))
    np.testing.assert_array_equal(back, c)


# ---------------------------------------------------------------------------
# DVB-T: config, PRBS, GF(256), RS(204,188) and the host tables
# ---------------------------------------------------------------------------

_DVBT_PROPS = ("sample_rate", "fft_size", "guard_samples", "symbol_samples",
               "symbols_per_superframe", "cells_per_superframe",
               "bits_per_superframe", "rs_blocks_per_superframe",
               "ts_bytes_per_superframe", "useful_bitrate",
               "samples_per_superframe")


def _jcfg(cfg):
    """The reference's DvbtConfig with the same field values as ``cfg``."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, enum.Enum):
            v = getattr(jconfig, type(v).__name__)[v.name]
        kw[f.name] = v
    return jconfig.DvbtConfig(**kw)


def _same_member(a, b):
    return (type(a).__name__, a.name, a.value) == (type(b).__name__, b.name,
                                                   b.value)


CFG_FLAGSHIP = tconfig.DvbtConfig(
    mode=tconfig.TransmissionMode.M8K, bandwidth_mhz=8,
    constellation=tconfig.Constellation.QAM64,
    code_rate=tconfig.CodeRate.R7_8, guard=tconfig.GuardInterval.G1_32)
CFG_MIN = tconfig.DvbtConfig(                 # tests/test_dvbt.py's CFG_MIN
    mode=tconfig.TransmissionMode.M2K, bandwidth_mhz=6,
    constellation=tconfig.Constellation.QPSK,
    code_rate=tconfig.CodeRate.R1_2, guard=tconfig.GuardInterval.G1_4)


@pytest.mark.parametrize("name", ["Constellation", "CodeRate",
                                  "GuardInterval", "TransmissionMode"])
def test_dvbt_enums(name):
    t, j = getattr(tconfig, name), getattr(jconfig, name)
    assert [(m.name, m.value) for m in t] == [(m.name, m.value) for m in j]
    props = [k for k, v in vars(j).items() if isinstance(v, property)]
    for m in t:
        for k in props:
            assert getattr(m, k) == getattr(j[m.name], k), (m, k)


def test_dvbt_config_defaults():
    t, j = tconfig.DvbtConfig(), jconfig.DvbtConfig()
    names = [f.name for f in dataclasses.fields(j)]
    assert names == [f.name for f in dataclasses.fields(t)]
    for name in names:
        a, b = getattr(t, name), getattr(j, name)
        assert _same_member(a, b) if isinstance(b, enum.Enum) \
            else a == b, name
    assert (t.SYMBOLS_PER_FRAME, t.FRAMES_PER_SUPERFRAME) == (
        j.SYMBOLS_PER_FRAME, j.FRAMES_PER_SUPERFRAME)


@pytest.mark.parametrize("mode", list(tconfig.TransmissionMode))
@pytest.mark.parametrize("cons", list(tconfig.Constellation))
def test_dvbt_config_properties(mode, cons):
    """Every derived property, for every rate x guard (x bandwidth) of this
    mode and constellation: 20 of the 120 combinations per case."""
    for rate in tconfig.CodeRate:
        for guard in tconfig.GuardInterval:
            for bw in (5, 6, 7, 8):
                t = tconfig.DvbtConfig(mode=mode, bandwidth_mhz=bw,
                                       constellation=cons, code_rate=rate,
                                       guard=guard)
                j = _jcfg(t)
                for k in _DVBT_PROPS:
                    assert getattr(t, k) == getattr(j, k), (t, k)


@pytest.mark.parametrize("name,args", [
    ("lfsr_bits", ((2, 11), np.ones(11, np.uint8), 500)),
    ("dvb_dispersal_prbs_bytes", (1503,)),
    ("dvbt_dispersal_mask", ()),
    ("dvbt_pilot_prbs", (6817,)),
    ("dvbt_pilot_signs", (6817,)),
    ("bb_scrambler_bits", (4000,)),
])
def test_prbs(name, args):
    got, want = getattr(tprbs, name)(*args), getattr(jprbs, name)(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_gf256_tables():
    for name in ("m", "q", "poly"):
        assert getattr(tgalois.GF256, name) == getattr(jgalois.GF256, name)
    np.testing.assert_array_equal(tgalois.GF256.exp, jgalois.GF256.exp)
    np.testing.assert_array_equal(tgalois.GF256.log, jgalois.GF256.log)


def test_dvbt_rs_matrix():
    t, j = trs.DVBT_RS(), jrs.DVBT_RS()
    assert (t.k_sym, t.nroots, t.m) == (j.k_sym, j.nroots, j.m) == (188, 16, 8)
    np.testing.assert_array_equal(t.genpoly, j.genpoly)
    assert t.M.dtype == j.M.dtype and t.M.shape == (1504, 128)
    np.testing.assert_array_equal(t.M, j.M)


@pytest.mark.parametrize("name", [
    "DEMUX", "BIT_ILV_OFFSETS", "BIT_ILV_BLOCK", "CONTINUAL_PILOTS_2K",
    "TPS_CARRIERS_2K", "TPS_SYNC_ODD", "TPS_SYNC_EVEN", "_TPS_BCH_G",
    "_TPS_BCH_M", "_TPS_CONST_BITS", "_TPS_RATE_BITS", "_TPS_GI_BITS",
    "_TPS_MODE_BITS", "SYM_ILV_BIT_PERM", "SYM_ILV_FEEDBACK"])
def test_dvbt_table_constants(name):
    got, want = getattr(TDT, name), getattr(JDT, name)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, dict):
        def key(k):
            return (k.name, k.value) if isinstance(k, enum.Enum) else k
        assert {key(k): v for k, v in got.items()} == \
            {key(k): v for k, v in want.items()}
    else:
        assert got == want


@pytest.mark.parametrize("mode", list(tconfig.TransmissionMode))
def test_symbol_interleaver(mode):
    jmode = jconfig.TransmissionMode[mode.name]
    got, want = TDT.symbol_interleaver_perm(mode), \
        JDT.symbol_interleaver_perm(jmode)
    assert got.dtype == want.dtype and got.shape == (mode.data_carriers,)
    np.testing.assert_array_equal(got, want)
    for g, w in zip(TDT.symbol_interleaver_gather(mode),
                    JDT.symbol_interleaver_gather(jmode)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for fn in ("continual_pilots", "tps_carriers"):
        np.testing.assert_array_equal(getattr(TDT, fn)(mode),
                                      getattr(JDT, fn)(jmode))
    for phase in range(4):
        np.testing.assert_array_equal(TDT.scattered_pilots(mode, phase),
                                      JDT.scattered_pilots(jmode, phase))


@pytest.mark.parametrize("cons", list(tconfig.Constellation))
def test_constellation_lut_and_bit_interleaver(cons):
    jcons = jconfig.Constellation[cons.name]
    got, want = TDT.constellation_lut(cons), JDT.constellation_lut(jcons)
    assert got.dtype == want.dtype == np.complex64
    np.testing.assert_array_equal(got, want)
    v = cons.bits_per_symbol
    np.testing.assert_array_equal(TDT.bit_interleaver_indices(v, 126 * 12),
                                  JDT.bit_interleaver_indices(v, 126 * 12))


@pytest.mark.parametrize("cfg", [
    CFG_FLAGSHIP, CFG_MIN, dataclasses.replace(CFG_MIN, cell_id=0x5A),
    tconfig.DvbtConfig(constellation=tconfig.Constellation.QAM16,
                       code_rate=tconfig.CodeRate.R5_6,
                       guard=tconfig.GuardInterval.G1_8)],
    ids=["flagship", "min", "cell_id", "qam16"])
def test_tps(cfg):
    j = _jcfg(cfg)
    for frame in range(4):
        got, want = TDT.tps_bits(cfg, frame), JDT.tps_bits(j, frame)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    got, want = TDT.tps_dbpsk_signs(cfg), JDT.tps_dbpsk_signs(j)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", list(tconfig.TransmissionMode))
@pytest.mark.parametrize("cons", list(tconfig.Constellation))
def test_carrier_plan(mode, cons):
    cfg = tconfig.DvbtConfig(mode=mode, constellation=cons)
    got, want = TDT.carrier_plan(cfg), JDT.carrier_plan(_jcfg(cfg))
    assert got.n_data == want.n_data == mode.data_carriers
    for name in ("gidx", "static_cells"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("cfg", [CFG_FLAGSHIP, CFG_MIN],
                         ids=["flagship", "min"])
def test_dvbt_plan(cfg):
    """The chain's composed static tables (masks, generator matrix, LUT,
    assembly gather, pilot/TPS values) equal the reference's."""
    got, want = TD._plan(cfg), JD._plan(_jcfg(cfg))
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k
