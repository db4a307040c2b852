"""Port core (dtv_utils_torch.core, ops/rs) against the JAX reference.

Same inputs, made with numpy from a seed, go through both packages.  Integer
results must be bit-exact, and every host table the port copies must equal
the reference's array for array: those copies are the price of running
without JAX on the GPU machine, and this file is what keeps one source of
truth.
"""

import dataclasses
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
from dtv_utils_tpu.tx import j83b as J
from dtv_utils_torch import resolve_device
from dtv_utils_torch.core import bits as tbits
from dtv_utils_torch.core import config as tconfig
from dtv_utils_torch.core import cplx as tcplx
from dtv_utils_torch.core import galois as tgalois
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
    assert int(res.stdout.split()[-1]) >= 15      # the whole slice imported


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
