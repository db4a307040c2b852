"""The port's J.83B modulator (dtv_utils_torch.tx.j83b) against the JAX
reference (dtv_utils_tpu.tx.j83b), on the CPU.

Same TS, made from a seed, through both.  Every integer stage and the cells
are bit-exact; IQ after the RRC filter agrees within atol 1e-6 (the two FIRs
sum 50 float32 products in different orders); the stream state is equal.

``tests/golden/j83b_torch_smoke.json`` is what ``chip_smoke.py`` checks the
card against.  It is made here from the JAX reference; regenerate it
from the repository root with
``JAX_PLATFORMS=cpu python -m tests.test_torch_j83b``.
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

from dtv_utils_tpu.core.config import J83bConfig as JConfig
from dtv_utils_tpu.tx import j83b as J
from dtv_utils_torch.core.config import J83bConfig
from dtv_utils_torch.ops import fir
from dtv_utils_torch.tx import j83b as T

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "j83b_torch_smoke.json"
GOLDEN_SEED = 0x83B
IQ_TOL = dict(rtol=0, atol=1e-6)
BLK = T.SUPERBLOCK_BYTES
RNG = np.random.default_rng(0x7083B)


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load_chip_smoke()


def _np_state(s) -> dict:
    return {f.name: np.asarray(getattr(s, f.name))
            for f in dataclasses.fields(s)}


def _assert_state_equal(port_state, ref: dict):
    got = T.state_to_numpy(port_state)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@functools.cache
def _jax_reference() -> dict:
    """Two superblocks of the golden's TS through the JAX reference."""
    cfg = JConfig()
    ts = smoke.seeded_ts(GOLDEN_SEED, 2 * BLK)
    iq1, s1 = J.modulate_stream(cfg, ts[:BLK])
    iq2, s2 = J.modulate_stream(cfg, ts[BLK:], s1)
    enc = jax.jit(functools.partial(J.encode_to_cells, cfg))
    st = J.init_state(cfg)
    cells = []
    for i in range(2):
        c, st = enc(jnp.asarray(ts[i * BLK:(i + 1) * BLK]), st)
        cells.append(np.asarray(c))
    return {"ts": ts, "iq": np.concatenate([iq1, iq2]),
            "s1": _np_state(s1), "s2": _np_state(s2), "cells": cells}


def _golden_index(total: int) -> np.ndarray:
    """256 IQ indices: the first 64 (filter history ramp), 64 across the
    superblock boundary, the last 64 and 64 spread between."""
    half = total // 2
    return np.concatenate([
        np.arange(64), half - 32 + np.arange(64), total - 64 + np.arange(64),
        np.linspace(1000, total - 1000, 64).astype(np.int64)])


def golden_from_reference() -> dict:
    ref = _jax_reference()
    idx = _golden_index(ref["iq"].size)
    return {
        "about": "J.83B 64-QAM, 2 superblocks of chip_smoke.seeded_ts(seed), "
                 "through the JAX reference dtv_utils_tpu.tx.j83b on the "
                 "CPU (tests/test_torch_j83b.py)",
        "seed": GOLDEN_SEED,
        "superblocks": 2,
        "ts_sha256": smoke.sha256(ref["ts"]),
        "cells_sha256": [smoke.sha256(c) for c in ref["cells"]],
        "state_sha256": smoke.state_digest(ref["s2"]),
        "iq_index": idx.tolist(),
        "iq_re": [float(v) for v in ref["iq"][idx].real],
        "iq_im": [float(v) for v in ref["iq"][idx].imag],
    }


# ---------------------------------------------------------------------------
# Stages, at small sizes
# ---------------------------------------------------------------------------

def test_transport_framing():
    ts = RNG.integers(0, 256, size=(7, 188), dtype=np.uint8)
    want = np.asarray(J.transport_framing(jnp.asarray(ts)))
    got = T.transport_framing(torch.from_numpy(ts))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_rs_encode():
    syms = RNG.integers(0, 128, size=(9, T.RS_K), dtype=np.int32)
    want = np.asarray(J.rs_encode(jnp.asarray(syms)))
    got = T.rs_encode(torch.from_numpy(syms))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_interleave_carried_across_two_calls():
    n = T.ILV_I * 50
    syms = RNG.integers(0, 128, size=2 * n, dtype=np.int32)
    carry_j = J.init_state(JConfig()).ilv_carry
    carry_t = T.init_state(device="cpu").ilv_carry
    for part in (syms[:n], syms[n:]):
        want, carry_j = J.interleave(jnp.asarray(part), carry_j)
        got, carry_t = T.interleave(torch.from_numpy(part), carry_t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(carry_t.numpy(), np.asarray(carry_j))


@pytest.mark.parametrize("n,C", [(100, T.ILV_I * T.ILV_J * 127),
                                 (T.ILV_I, T.ILV_I * T.ILV_J * 126)])
def test_interleave_rejects_bad_shapes(n, C):
    """A carry too short for the deepest branch would wrap a negative gather
    index silently; it must raise."""
    with pytest.raises(ValueError):
        T.interleave(torch.zeros(n, dtype=torch.int32),
                     torch.zeros(C, dtype=torch.int32))


def test_conv_encode_45_carried_across_two_calls():
    bits = RNG.integers(0, 2, size=2 * 400, dtype=np.uint8)
    st_j = jnp.zeros(4, jnp.uint8)
    st_t = torch.zeros(4, dtype=torch.uint8)
    for part in (bits[:400], bits[400:]):
        want, st_j = J.conv_encode_45(jnp.asarray(part), st_j)
        got, st_t = T.conv_encode_45(torch.from_numpy(part), st_t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))


def test_trellis_carried_across_two_calls():
    n_bits = 28 * 400
    bits = RNG.integers(0, 2, size=2 * n_bits, dtype=np.uint8)
    sj = J.init_state(JConfig())
    st = T.init_state(device="cpu")
    regs_j = (sj.conv_a, sj.conv_b, sj.diff_state)
    regs_t = (st.conv_a, st.conv_b, st.diff_state)
    for part in (bits[:n_bits], bits[n_bits:]):
        want, *regs_j = J.trellis_encode(jnp.asarray(part), *regs_j)
        got, *regs_t = T.trellis_encode(torch.from_numpy(part), *regs_t)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for a, b in zip(regs_t, regs_j):
            assert a.dtype == torch.uint8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# The slice, at full size
# ---------------------------------------------------------------------------

def test_encode_to_cells_full_superblock():
    ref = _jax_reference()
    cells, state = T.encode_to_cells(
        J83bConfig(), torch.from_numpy(ref["ts"][:BLK]),
        T.init_state(device="cpu"))
    assert cells.dtype == torch.float32
    np.testing.assert_array_equal(cells.numpy(), ref["cells"][0])
    want = dict(ref["s1"], rrc_tail=np.zeros((2, 49), np.float32))
    _assert_state_equal(state, want)


def test_modulate_stream_two_superblocks():
    ref = _jax_reference()
    iq, state = T.modulate_stream(J83bConfig(), ref["ts"], device="cpu")
    assert iq.dtype == np.complex64 and iq.shape == ref["iq"].shape
    np.testing.assert_allclose(iq, ref["iq"], **IQ_TOL)
    _assert_state_equal(state, ref["s2"])


def test_stream_handed_over_from_jax():
    """The JAX reference modulates superblock 1, the port takes its state
    and modulates superblock 2."""
    ref = _jax_reference()
    state = T.state_from_numpy(ref["s1"], device="cpu")
    _assert_state_equal(state, ref["s1"])
    iq2, state = T.modulate_stream(J83bConfig(), ref["ts"][BLK:], state,
                                   device="cpu")
    np.testing.assert_allclose(iq2, ref["iq"][2 * T.SUPERBLOCK_SYMBOLS:],
                               **IQ_TOL)
    _assert_state_equal(state, ref["s2"])


def test_state_from_numpy_rejects_mismatch():
    d = T.state_to_numpy(T.init_state(device="cpu"))
    with pytest.raises(ValueError):
        T.state_from_numpy(dict(d, conv_a=d["conv_a"].astype(np.int32)),
                           device="cpu")
    with pytest.raises(ValueError):
        T.state_from_numpy(dict(d, rrc_tail=d["rrc_tail"][:, :48]),
                           device="cpu")


def test_modulate_stream_rejects_partial_superblock():
    with pytest.raises(ValueError):
        T.modulate_stream(J83bConfig(), np.zeros(BLK - 188, np.uint8),
                          device="cpu")


def test_cli_matches_reference_cli(tmp_path):
    """``python -m dtv_utils_torch.cli qam-mod in out --device cpu`` against
    the reference's qam-mod, on a short TS that both cycle to a superblock."""
    from dtv_utils_tpu.models import j83b as jmodel

    ts = RNG.integers(0, 256, size=188 * 1000, dtype=np.uint8)
    ts[::188] = 0x47
    src = tmp_path / "in.ts"
    ts.tofile(src)
    assert jmodel.cli([str(src), str(tmp_path / "ref.cfile")]) == 0
    res = subprocess.run(
        [sys.executable, "-m", "dtv_utils_torch.cli", "qam-mod", str(src),
         str(tmp_path / "port.cfile"), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    metric = json.loads(res.stdout.splitlines()[0])
    assert metric["metric"] == "j83b_mod_throughput"
    assert metric["iq_samples"] == 2 * T.SUPERBLOCK_SYMBOLS
    want = np.fromfile(tmp_path / "ref.cfile", dtype=np.complex64)
    got = np.fromfile(tmp_path / "port.cfile", dtype=np.complex64)
    assert got.shape == want.shape == (2 * T.SUPERBLOCK_SYMBOLS,)
    np.testing.assert_allclose(got, want, **IQ_TOL)


def test_cli_refuses_cuda_without_gpu(tmp_path, capsys):
    """No fallback: ``--device cuda`` (the default) without a GPU is an
    error, not a CPU run."""
    from dtv_utils_torch.cli.main import main

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    src = tmp_path / "in.ts"
    np.zeros(188, np.uint8).tofile(src)
    assert main(["qam-mod", str(src), str(tmp_path / "out.cfile")]) == 255
    assert "is_available" in capsys.readouterr().err
    assert not (tmp_path / "out.cfile").exists()


@pytest.mark.parametrize("argv,rc", [([], 255), (["--help"], 0),
                                     (["profile"], 255)])
def test_cli_dispatch(argv, rc):
    from dtv_utils_torch.cli.main import main

    assert main(argv) == rc


# ---------------------------------------------------------------------------
# The golden chip_smoke.py holds the card to
# ---------------------------------------------------------------------------

def test_golden_matches_reference():
    want = golden_from_reference()
    got = json.loads(GOLDEN.read_text())
    for k in ("seed", "superblocks", "ts_sha256", "cells_sha256",
              "state_sha256", "iq_index"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["iq_re"], want["iq_re"], **IQ_TOL)
    np.testing.assert_allclose(got["iq_im"], want["iq_im"], **IQ_TOL)


def test_chip_smoke_checks_pass_on_cpu(monkeypatch):
    """chip_smoke.py's own checks, run on the CPU with the plain FIR: they
    accept the port's output, and the CPU path launches no kernel."""
    monkeypatch.setattr(fir, "LAUNCHES", 0)
    golden = json.loads(GOLDEN.read_text())
    dev = torch.device("cpu")
    assert smoke.check_fir(dev, T.rrc_taps(J83bConfig())) == 0.0
    launches, iq = smoke.check_slice(dev, golden)
    assert launches == 0
    smoke.check_cli(golden, iq, "cpu")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    GOLDEN.write_text(json.dumps(golden_from_reference(), indent=1) + "\n")
    print(f"wrote {GOLDEN}")
