"""Port core (dtv_utils_torch.core, ops/rs, the DVB-T host tables) against
the JAX reference.

Same inputs, made with numpy from a seed, go through both packages.  Integer
results must be bit-exact, and every host table the port copies must equal
the reference's array for array: those copies are the price of running
without JAX on the GPU machine, and this file is what keeps one source of
truth.
"""

import ast
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
from dtv_utils_tpu.rates import dvbt2 as jrates2
from dtv_utils_tpu.tx import dvbt as JD
from dtv_utils_tpu.tx import dvbt2 as JD2
from dtv_utils_tpu.tx import dvbt2_tables as JD2T
from dtv_utils_tpu.tx import dvbt_tables as JDT
from dtv_utils_tpu.tx import j83b as J
from dtv_utils_tpu.tx import t2_annex as jannex
from dtv_utils_tpu.tx import t2_p1 as jp1
from dtv_utils_torch import resolve_device
from dtv_utils_torch.core import bits as tbits
from dtv_utils_torch.core import config as tconfig
from dtv_utils_torch.core import cplx as tcplx
from dtv_utils_torch.core import galois as tgalois
from dtv_utils_torch.core import prbs as tprbs
from dtv_utils_torch.models.dvbt2 import PROFILES as T2_PROFILES
from dtv_utils_torch.ops import rs as trs
from dtv_utils_torch.rates import dvbt2 as trates2
from dtv_utils_torch.tx import dvbt as TD
from dtv_utils_torch.tx import dvbt2 as TD2
from dtv_utils_torch.tx import dvbt2_tables as TD2T
from dtv_utils_torch.tx import dvbt_tables as TDT
from dtv_utils_torch.tx import j83b as T
from dtv_utils_torch.tx import t2_annex as tannex
from dtv_utils_torch.tx import t2_p1 as tp1

ROOT = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(0x70C4)


_JAX_ROOTS = ("jax", "jaxlib", "dtv_utils_tpu")


def test_port_imports_no_jax():
    """No file of the port names jax or the JAX package in an import, at
    any depth (an import inside a function runs only when called), and
    every module imports, and the BBC frame tables build, with neither
    loaded.  The second part runs in a subprocess: this process has
    imported jax already."""
    bad = []
    for path in sorted((ROOT / "dtv_utils_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if n.split(".")[0] in _JAX_ROOTS]
    assert not bad, bad
    code = (
        "import importlib, pkgutil, sys\n"
        "import dtv_utils_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    dtv_utils_torch.__path__, 'dtv_utils_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "from dtv_utils_torch.models.dvbt2 import PROFILES\n"
        "from dtv_utils_torch.tx import dvbt2\n"
        "dvbt2._frame_arrays(PROFILES['bbc'])\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {_JAX_ROOTS!r})\n"
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


@pytest.mark.parametrize("name", [
    "Constellation", "CodeRate", "GuardInterval", "TransmissionMode",
    "T2FrameSize", "T2CodeRate", "T2Constellation", "T2Guard",
    "T2PilotPattern"])
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


# ---------------------------------------------------------------------------
# DVB-T2: config, BCH generators, rates/dvbt2, annex data and host tables
# ---------------------------------------------------------------------------

_T2_PROPS = ("sample_rate", "kbch", "nbch", "bch_t", "nldpc", "ldpc_q",
             "cells_per_fec_block", "carriers", "n_p2", "frame_symbols",
             "guard_samples", "payload_bytes_per_frame")
T2_CFGS = {
    "bbc": T2_PROFILES["bbc"],
    "blade": T2_PROFILES["blade"],
    "blade_papr": dataclasses.replace(T2_PROFILES["blade"], papr_tr=True),
    "bbc_papr": dataclasses.replace(T2_PROFILES["bbc"], papr_tr=True),
    "short": tconfig.Dvbt2Config(                 # tests/test_dvbt2.py's
        frame_size=tconfig.T2FrameSize.SHORT, fec_blocks=2, ti_blocks=1,
        code_rate=tconfig.T2CodeRate.R1_2,
        constellation=tconfig.T2Constellation.QPSK, rotation=False),
}


def _assert_same(got, want, what=""):
    """Equal values, arrays with equal dtypes (NaN equal to NaN), enums by
    name and value, containers element for element."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            _assert_same(got[k], want[k], f"{what}[{k!r}]")
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{i}]")
    elif isinstance(want, enum.Enum):
        assert _same_member(got, want), what
    elif dataclasses.is_dataclass(want):
        _assert_same(dataclasses.asdict(got), dataclasses.asdict(want), what)
    else:
        assert type(got) is type(want) and got == want, (what, got, want)


def test_t2_config_defaults():
    t, j = tconfig.Dvbt2Config(), jconfig.Dvbt2Config()
    names = [f.name for f in dataclasses.fields(j)]
    assert names == [f.name for f in dataclasses.fields(t)]
    for name in names:
        _assert_same(getattr(t, name), getattr(j, name), name)
    for name in ("_T2_KBCH_NORMAL", "_T2_KBCH_SHORT", "_T2_NBCH_NORMAL",
                 "_T2_NBCH_SHORT", "_T2_CARRIERS"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name


@pytest.mark.parametrize("fft", [1024, 2048, 4096, 8192, 16384, 32768])
def test_t2_config_properties(fft):
    """Every derived property, for every frame size x code rate x
    constellation x guard x carrier mode of this FFT size."""
    for fs in tconfig.T2FrameSize:
        for rate in tconfig.T2CodeRate:
            for cons in tconfig.T2Constellation:
                for guard in tconfig.T2Guard:
                    for ext in (False, True):
                        t = tconfig.Dvbt2Config(
                            fft_size=fft, extended_carriers=ext,
                            frame_size=fs, code_rate=rate,
                            constellation=cons, guard=guard,
                            bandwidth_mhz=0 if ext else 8)
                        j = _jcfg_t2(t)
                        for k in _T2_PROPS:
                            assert getattr(t, k) == getattr(j, k), (t, k)


def _jcfg_t2(cfg):
    """The reference's Dvbt2Config with the same field values as ``cfg``."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, enum.Enum):
            v = getattr(jconfig, type(v).__name__)[v.name]
        kw[f.name] = v
    return jconfig.Dvbt2Config(**kw)


@pytest.mark.parametrize("field,t", [("GF2_16_DVB", 10), ("GF2_16_DVB", 12),
                                     ("GF2_14_DVB", 12)])
def test_bch_generator_poly(field, t):
    """The BCH generators the configs use: t = 10 and 12 on GF(2^16)
    (normal frames), t = 12 on GF(2^14) (short frames and L1)."""
    tg, jg = getattr(tgalois, field), getattr(jgalois, field)
    for name in ("m", "q", "poly"):
        assert getattr(tg, name) == getattr(jg, name)
    np.testing.assert_array_equal(tg.exp, jg.exp)
    np.testing.assert_array_equal(tg.log, jg.log)
    for j in (1, 3, 5, 2 * t - 1):
        _assert_same(tgalois.minimal_polynomial(tg, j),
                     jgalois.minimal_polynomial(jg, j), f"minpoly {j}")
    _assert_same(tgalois.bch_generator_poly(tg, t),
                 jgalois.bch_generator_poly(jg, t))
    a = RNG.integers(0, 2, size=40, dtype=np.uint8)
    b = RNG.integers(0, 2, size=17, dtype=np.uint8)
    _assert_same(tgalois.gf2_polymul(a, b), jgalois.gf2_polymul(a, b))


_RATES2_NAMES = sorted(k for k in vars(jrates2)
                       if k.lstrip("_").isupper())


@pytest.mark.parametrize("name", _RATES2_NAMES)
def test_rates_dvbt2_tables(name):
    _assert_same(getattr(trates2, name), getattr(jrates2, name), name)


@pytest.mark.parametrize("fft_k", [1, 2, 4, 8, 16, 32])
def test_rates_dvbt2_compute_sweep(fft_k):
    """compute() and the report at BBC-like points: every guard, pilot
    pattern, carrier mode, L1 constellation and MISO flag at this FFT
    size, with the BBC mux's other arguments."""
    for guard in range(7):
        for pp in range(1, 9):
            for cm in (0, 1):
                for l1 in range(4):
                    args = (8, fft_k, guard, 59, 202.0, 3, 4, 0, cm, pp, l1)
                    for miso in (False, True):
                        _assert_same(trates2.compute(*args, miso=miso),
                                     jrates2.compute(*args, miso=miso),
                                     str((args, miso)))
                    assert trates2.format_report(list(args)) == \
                        jrates2.format_report(list(args))
    assert trates2.l1_post_cells(6, 1) == jrates2.l1_post_cells(6, 1)


def test_t2_data_files():
    """The port's data/t2 holds the reference's files; every table is
    byte-identical (only the README's note differs)."""
    src, dst = jannex.DATA_DIR, tannex.DATA_DIR
    assert dst != src and dst.parent.parent.name == "dtv_utils_torch"
    names = sorted(p.name for p in src.iterdir())
    assert names == sorted(p.name for p in dst.iterdir())
    assert len(names) == 12
    for name in names:
        if name != "README.md":
            assert (dst / name).read_bytes() == (src / name).read_bytes(), \
                name


@pytest.mark.parametrize("name", list(T2_CFGS))
def test_t2_annex_loaders(name):
    cfg = T2_CFGS[name]
    j = _jcfg_t2(cfg)
    _assert_same(tannex.table_status(cfg), jannex.table_status(j))
    K = cfg.carriers
    for args in ((cfg.nldpc, 2, 3, cfg.nbch),):
        _assert_same(tannex.ldpc_rows(*args), jannex.ldpc_rows(*args))
    _assert_same(tannex.continual_pilots(cfg.fft_size, K),
                 jannex.continual_pilots(cfg.fft_size, K))
    for p2 in (False, True):
        n_tr = trates2.TR_CELLS[cfg.fft_size]
        _assert_same(tannex.tr_positions(cfg.fft_size, K, n_tr, p2),
                     jannex.tr_positions(cfg.fft_size, K, n_tr, p2))
    for nldpc in (16200, 64800):
        for nc in (8, 12, 16):
            _assert_same(tannex.column_twist(nldpc, nc),
                         jannex.column_twist(nldpc, nc))
    for nsub, tag in ((8, ""), (12, ""), (16, ""), (8, "16200_qam256")):
        _assert_same(tannex.demux_map(nsub, tag), jannex.demux_map(nsub, tag))
    _assert_same(tannex.scalar("p2_amplitude"), jannex.scalar("p2_amplitude"))


@pytest.mark.parametrize("name", list(T2_CFGS))
def test_t2_fec_tables(name):
    """LDPC rows (the data code and both L1 codes), bit interleaver, demux,
    and the BCH matrix."""
    cfg = T2_CFGS[name]
    j = _jcfg_t2(cfg)
    for key in ((cfg.code_rate.value, cfg.nldpc, cfg.nbch),
                (0, 16200, TD2T.L1PRE_NBCH), (1, 16200, TD2T.L1POST_NBCH)):
        _assert_same(TD2T.ldpc_accumulator_rows(*key),
                     JD2T.ldpc_accumulator_rows(*key), str(key))
    key = (cfg.code_rate.value, cfg.nldpc, cfg.nbch, cfg.ldpc_q)
    _assert_same(TD2T.ldpc_edge_arrays(key), JD2T.ldpc_edge_arrays(key))
    got, want = TD2T.bit_interleaver_perm(cfg), JD2T.bit_interleaver_perm(j)
    assert (got is None) == (want is None)
    if want is not None:
        _assert_same(got, want)
    _assert_same(TD2T.demux_perm(cfg), JD2T.demux_perm(j))
    if name in ("bbc", "short"):
        fs = jconfig.T2FrameSize[cfg.frame_size.name]
        _assert_same(TD2T.bch_parity_matrix(cfg.frame_size, cfg.bch_t,
                                            cfg.kbch),
                     JD2T.bch_parity_matrix(fs, cfg.bch_t, cfg.kbch))


@pytest.mark.parametrize("cons", list(tconfig.T2Constellation))
def test_t2_constellation_pairs(cons):
    jcons = jconfig.T2Constellation[cons.name]
    for rotation in (False, True):
        _assert_same(TD2T.constellation_pairs(cons, rotation),
                     JD2T.constellation_pairs(jcons, rotation))
    assert TD2T.ROTATION_DEG == JD2T.ROTATION_DEG


@pytest.mark.parametrize("name", list(T2_CFGS))
def test_t2_interleavers_and_frame_plan(name):
    """Cell interleaver and its shifts, frame plan, frequency
    interleaver."""
    cfg = T2_CFGS[name]
    j = _jcfg_t2(cfg)
    n = cfg.cells_per_fec_block
    _assert_same(TD2T.cell_interleaver_perm(n), JD2T.cell_interleaver_perm(n))
    _assert_same(TD2T.cell_interleaver_shifts(cfg.fec_blocks, n),
                 JD2T.cell_interleaver_shifts(cfg.fec_blocks, n))
    _assert_same(TD2T._budget_point(cfg), JD2T._budget_point(j))
    _assert_same(TD2T.frame_plan(cfg), JD2T.frame_plan(j))
    _assert_same(TD2T.freq_interleaver_perms(cfg),
                 JD2T.freq_interleaver_perms(j))
    assert TD2T.p2_amplitude() == JD2T.p2_amplitude()


@pytest.mark.parametrize("name", list(T2_CFGS))
def test_t2_l1_tables(name):
    cfg = T2_CFGS[name]
    j = _jcfg_t2(cfg)
    for l1 in range(4):
        for n_p2 in (1, 2, 4, 16):
            assert TD2T.l1_sizes(l1, n_p2) == JD2T.l1_sizes(l1, n_p2)
    _assert_same(TD2T.l1_pre_bits(cfg), JD2T.l1_pre_bits(j))
    for frame_idx, plp_start in ((0, 0), (3, 1234)):
        _assert_same(TD2T.l1_post_bits(cfg, frame_idx, plp_start),
                     JD2T.l1_post_bits(j, frame_idx, plp_start))
    bits = RNG.integers(0, 2, size=200, dtype=np.uint8)
    _assert_same(TD2T.crc32_mpeg(bits), JD2T.crc32_mpeg(bits))
    _assert_same(TD2._l1_plan(cfg), JD2._l1_plan(j))


@pytest.mark.parametrize("name", list(T2_CFGS))
def test_t2_chain_plans(name):
    """The chain's static tables: ``_plan``, ``_frame_arrays`` and, with
    tone reservation, ``_tr_kernel``."""
    cfg = T2_CFGS[name]
    j = _jcfg_t2(cfg)
    _assert_same(TD2._plan(cfg), JD2._plan(j))
    if name == "bbc_papr":       # 202 FEC blocks overflow the TR budget
        for fn, c in ((TD2._frame_arrays, cfg), (JD2._frame_arrays, j)):
            with pytest.raises(AssertionError):
                fn(c)
        return
    _assert_same(TD2._frame_arrays(cfg), JD2._frame_arrays(j))
    if cfg.papr_tr:
        _assert_same(TD2._tr_kernel(cfg), JD2._tr_kernel(j))
    assert JD2.TR_CELLS == trates2.TR_CELLS
    for k in ("OUTPUT_SCALE", "PAPR_VCLIP", "PAPR_ITERATIONS"):
        assert getattr(TD2, k) == getattr(JD2, k), k


def test_t2_p1_tables():
    _assert_same(tp1.p1_active_carriers(), jp1.p1_active_carriers())
    for s1 in range(8):
        _assert_same(tp1.s1_pattern(s1), jp1.s1_pattern(s1))
    for s2 in range(16):
        _assert_same(tp1.s2_pattern(s2), jp1.s2_pattern(s2))
        _assert_same(tp1.p1_symbols(s2 % 8, s2), jp1.p1_symbols(s2 % 8, s2))
    _assert_same(tp1.p1_time(0, 10, 0.8), jp1.p1_time(0, 10, 0.8))
    x = np.concatenate([np.zeros(777, np.complex128), tp1.p1_time(0, 10),
                        np.zeros(500, np.complex128)])
    assert tp1.detect_p1(x) == jp1.detect_p1(x) == 777
