"""The port's RRC interpolator (dtv_utils_torch.ops.fir) against the JAX
reference, and its CUDA kernel against its plain version.  The split entry
(history and cells as two tensors) is held to the one-tensor entry and to
the Pallas kernel, and chip_smoke.py's one-call cuDNN yardstick to the
plain version.

On the CPU the wrapper runs the plain PyTorch version; it is held to the
Pallas kernel (interpret mode, as tests/test_j83b.py runs it) and to the
reference's CPU formulation, at atol 1e-6: float32 sums of 50 products
taken in different orders differ in the last bits.

The ``gpu`` test needs a card and no JAX; on the GPU machine run
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fir.py -m gpu``.
So this module imports JAX only inside the tests that compare with it.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from dtv_utils_torch.core.config import J83bConfig
from dtv_utils_torch.ops import _build, fir
from dtv_utils_torch.tx import j83b as T

TAPS = T.rrc_taps(J83bConfig())
TOL = dict(atol=1e-6, rtol=1e-6)
ROOT = Path(__file__).resolve().parents[1]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ext(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, fir.HIST + n)).astype(np.float32)


@pytest.mark.parametrize("n", [40_000, 300])
def test_plain_matches_pallas_interpret(n):
    from dtv_utils_tpu.ops.fir import polyphase_interp2 as pallas_fir
    import jax.numpy as jnp

    x = _ext(n, seed=n)
    want = np.asarray(pallas_fir(jnp.asarray(x), TAPS, n))
    got = fir.polyphase_interp2(torch.from_numpy(x), TAPS, n)
    assert tuple(got.shape) == (2, 2 * n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("n", [40_000, 300])
def test_plain_matches_interp2_conv(n):
    from dtv_utils_tpu.tx.j83b import _interp2_conv
    import jax.numpy as jnp

    x = _ext(n, seed=n + 1)
    want = np.asarray(_interp2_conv(jnp.asarray(x), TAPS, n))
    got = fir.interp2_reference(torch.from_numpy(x), TAPS, n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("n", [40_000, 300])
def test_rrc_interpolate_split_call_tail(n):
    """Two chained calls carry the 49-sample history like the reference's
    (tests/test_j83b.py:89-106)."""
    from dtv_utils_tpu.tx import j83b as J
    import jax.numpy as jnp

    rng = np.random.default_rng(n + 2)
    cells = rng.standard_normal((2, 2 * n)).astype(np.float32)
    tail_j = np.zeros((2, fir.HIST), np.float32)
    tail_t = torch.from_numpy(tail_j)
    for half in (cells[:, :n], cells[:, n:]):
        want, tail_j = J.rrc_interpolate(jnp.asarray(half), tail_j, TAPS)
        got, tail_t = T.rrc_interpolate(torch.from_numpy(half), tail_t, TAPS)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_array_equal(tail_t.numpy(), np.asarray(tail_j))


@pytest.mark.parametrize("bad,exc", [
    (lambda x: x.double(), TypeError),
    (lambda x: x.t().contiguous().t(), ValueError),        # non-contiguous
    (lambda x: x[:, ::2], ValueError),                      # strided view
    (lambda x: torch.cat([x, x[:1]]), ValueError),          # three rails
    (lambda x: x[:, :fir.HIST + 9], ValueError),            # n > L - 49
])
def test_wrapper_rejects(bad, exc):
    x = torch.from_numpy(_ext(10, seed=3))
    with pytest.raises(exc):
        fir.polyphase_interp2(bad(x), TAPS, 10)


def test_wrapper_rejects_wrong_taps():
    x = torch.from_numpy(_ext(10, seed=4))
    with pytest.raises(ValueError):
        fir.polyphase_interp2(x, TAPS[:98], 10)


def test_wrapper_rejects_other_devices():
    """Only a CPU tensor takes the plain version; anything else that is not
    CUDA raises instead of falling back."""
    x = torch.empty((2, fir.HIST + 10), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fir.polyphase_interp2(x, TAPS, 10)


def test_cpu_path_never_builds_the_kernel():
    from dtv_utils_torch.ops import _build

    before = _build.library.cache_info()
    fir.polyphase_interp2(torch.from_numpy(_ext(30, seed=7)), TAPS, 30)
    assert _build.library.cache_info() == before


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    from pathlib import Path

    from dtv_utils_torch.ops import _build

    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("the CUDA toolkit is installed at its default prefix")
    for var in ("CUDA_HOME", "CUDA_PATH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_library_name_follows_the_sources():
    from dtv_utils_torch.ops import _build

    p = _build.library_path()
    assert p.parent == _build.BUILD_DIR
    assert p.name.startswith("libdtv_torch_kernels_") and p.suffix == ".so"
    assert sorted(_build.CSRC.glob("*.cu"))     # sources ship with the repo


def test_cpu_tensor_leaves_launches_at_zero(monkeypatch):
    monkeypatch.setitem(_build.LAUNCHES, "fir_interp2", 0)
    x = torch.from_numpy(_ext(300, seed=5))
    out = fir.polyphase_interp2(x, TAPS, 300)
    torch.testing.assert_close(out, fir.interp2_reference(x, TAPS, 300),
                               rtol=0, atol=0)
    assert _build.LAUNCHES["fir_interp2"] == 0


def test_phase_taps_layout():
    h = fir._phase_taps(TAPS.tobytes())
    assert h.shape == (2, 50) and h.dtype == np.float32
    assert h.flags.c_contiguous
    np.testing.assert_array_equal(h[0], TAPS[0::2][::-1])
    np.testing.assert_array_equal(h[1], TAPS[1::2][::-1])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1_806_210, 40_000, 1])
def test_kernel_matches_plain_on_cuda(n, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setitem(_build.LAUNCHES, "fir_interp2", 0)
    x = torch.from_numpy(_ext(n, seed=6)).cuda()
    got = fir.polyphase_interp2(x, TAPS, n)
    want = fir.interp2_reference(x, TAPS, n)
    torch.testing.assert_close(got, want, **TOL)
    assert _build.LAUNCHES["fir_interp2"] == 1


@pytest.mark.parametrize("n", [1, 48, 49, 300, 40_000])
def test_split_matches_ext_entry_and_pallas(n):
    """History and cells as two tensors give what the one-tensor entry
    gives on their concatenation, and what the Pallas kernel gives."""
    from dtv_utils_tpu.ops.fir import polyphase_interp2 as pallas_fir
    import jax.numpy as jnp

    x = _ext(n, seed=n + 10)
    ext = torch.from_numpy(x)
    got = fir.polyphase_interp2_split(ext[:, :fir.HIST], ext[:, fir.HIST:],
                                      TAPS)
    assert tuple(got.shape) == (2, 2 * n)
    torch.testing.assert_close(got, fir.polyphase_interp2(ext, TAPS, n),
                               **TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(pallas_fir(jnp.asarray(x), TAPS, n)),
                               **TOL)


def test_split_reads_strided_views():
    """Rows of a wider buffer, starting at odd elements: the layout the
    kernel reads in place on the card."""
    rng = np.random.default_rng(11)
    buf = torch.from_numpy(rng.standard_normal((2, 400)).astype(np.float32))
    tail, cells = buf[:, 3:3 + fir.HIST], buf[:, 61:61 + 300]
    got = fir.polyphase_interp2_split(tail, cells, TAPS)
    want = fir.interp2_reference(torch.cat([tail, cells], dim=1), TAPS, 300)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("bad,exc", [
    (lambda t, c: (t[:, :48], c), ValueError),               # short history
    (lambda t, c: (t, c[:, ::2]), ValueError),               # strided row
    (lambda t, c: (t, c.double()), TypeError),
    (lambda t, c: (t, torch.cat([c, c[:1]])), ValueError),   # three rails
    (lambda t, c: (t.to("meta"), c), ValueError),            # two devices
    (lambda t, c: (t.to("meta"), c.to("meta")), ValueError),  # unsupported
])
def test_split_rejects(bad, exc):
    x = torch.from_numpy(_ext(20, seed=12))
    with pytest.raises(exc):
        fir.polyphase_interp2_split(*bad(x[:, :fir.HIST], x[:, fir.HIST:]),
                                    TAPS)


@pytest.mark.parametrize("pieces", [(20, 300), (300, 48, 49, 7, 1_000),
                                    (1, 1, 60)])
def test_rrc_interpolate_chain_short_pieces(pieces):
    """Chained calls over pieces shorter and longer than the 49-sample
    history give the reference's output, and exactly its history."""
    from dtv_utils_tpu.tx import j83b as J
    import jax.numpy as jnp

    rng = np.random.default_rng(sum(pieces))
    cells = rng.standard_normal((2, sum(pieces))).astype(np.float32)
    tail_j = rng.standard_normal((2, fir.HIST)).astype(np.float32)
    tail_t = torch.from_numpy(tail_j)
    at = 0
    for p in pieces:
        piece = cells[:, at:at + p]
        want, tail_j = J.rrc_interpolate(jnp.asarray(piece), tail_j, TAPS)
        got, tail_t = T.rrc_interpolate(torch.from_numpy(piece), tail_t,
                                        TAPS)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_array_equal(tail_t.numpy(), np.asarray(tail_j))
        assert tuple(tail_t.shape) == (2, fir.HIST) and tail_t.is_contiguous()
        at += p


@pytest.mark.parametrize("n", [1, 300, 40_000])
def test_library_yardstick_matches_plain(n):
    """chip_smoke.library_interp2, the one cuDNN call timed beside the
    kernel, computes the same function: offset 98 is right."""
    smoke = _load_chip_smoke()
    x = torch.from_numpy(_ext(n, seed=n + 13))
    w = torch.from_numpy(np.array(TAPS))[None, None]
    got = smoke.library_interp2(x, w, n)
    assert tuple(got.shape) == (2, 2 * n)
    torch.testing.assert_close(got, fir.interp2_reference(x, TAPS, n), **TOL)


def test_fir_bounds():
    """The bound chip_smoke.py reports at the main-path size: 43.35 MB over
    3.35 TB/s, 722.5 MFLOP over 67 TFLOP/s."""
    smoke = _load_chip_smoke()
    bytes_ms, ops_ms = smoke.fir_bounds_ms(1_806_210)
    assert bytes_ms == pytest.approx(43_349_432 / 3.35e12 * 1e3)
    assert ops_ms == pytest.approx(722_484_000 / 67e12 * 1e3)
    assert round(bytes_ms * 1e3, 2) == 12.94
    assert round(ops_ms * 1e3, 2) == 10.78


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1_806_210, 1_000_001, 48, 4_097])
@pytest.mark.parametrize("off", [1, 2, 3])
def test_split_kernel_on_misaligned_rows(n, off, monkeypatch):
    """The split entry on rows that start 1, 2 or 3 floats past a 16-byte
    boundary, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setitem(_build.LAUNCHES, "fir_interp2", 0)
    width = (n + off + 3) // 4 * 4        # row stride: a multiple of 4 floats
    rng = np.random.default_rng(n + off)
    buf = torch.from_numpy(
        rng.standard_normal((2, width + 52)).astype(np.float32)).cuda()
    tail, cells = buf[:, width + off:width + off + fir.HIST], \
        buf[:, off:off + n]
    got = fir.polyphase_interp2_split(tail, cells, TAPS)
    want = fir.interp2_reference(torch.cat([tail, cells], dim=1), TAPS, n)
    torch.testing.assert_close(got, want, **TOL)
    assert _build.LAUNCHES["fir_interp2"] == 1
