"""The port's stage profiler (``dtv_utils_torch/utils/profile.py``) on the
CPU, against the JAX reference's (``dtv_utils_tpu/utils/profile.py``).

Times and roofline shares come only from the card (``chip_smoke.py`` step
12); here the profiler's counts are held to independent arithmetic: the
bytes model, the flops ``FlopCounterMode`` sees, the chains and their row
names, the streaming ``-j`` output and its hook.
"""

import ast
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtv_utils_tpu.tx import dvbt as JD
from dtv_utils_tpu.tx import j83b as JQ
from dtv_utils_tpu.utils import profile as jprofile
from dtv_utils_torch.core.config import DvbtConfig, J83bConfig
from dtv_utils_torch.ops.rs import DVBT_RS
from dtv_utils_torch.tx import j83b as TQ
from dtv_utils_torch.utils import profile


def _jax_state_bytes(state) -> int:
    return sum(np.asarray(leaf).nbytes
               for leaf in jax.tree_util.tree_leaves(state))


@pytest.fixture(scope="module")
def dvbt_rows():
    """The DVB-T chain at the reference's default config (2K, QPSK 1/2)."""
    return profile.dvbt_stages(DvbtConfig(), device="cpu", n_variants=2)


@pytest.fixture(scope="module")
def j83b_rows():
    return profile.j83b_stages(device="cpu", n_variants=2)


def test_profile_bytes_model():
    """bytes_io is argument + result tensor bytes (a lower bound on memory
    traffic), not what the program reads: a gather read three times counts
    once, as in the reference."""
    x = np.zeros((1024, 128), np.float32)
    idx = np.zeros((1024,), np.int32)

    def gathery(x, idx):
        return x[idx] + x[idx] + x[idx]

    r = profile.profile_fn("gathery", gathery,
                           (torch.from_numpy(x), torch.from_numpy(idx)),
                           n_variants=3)
    in_b = 1024 * 128 * 4 + 1024 * 4
    out_b = 1024 * 128 * 4
    assert r.bytes_io == in_b + out_b
    ref = jprofile.profile_fn("gathery", gathery,
                              (jnp.asarray(x), jnp.asarray(idx)),
                              n_variants=3)
    assert r.bytes_io == ref.bytes_io
    assert r.flops == 0.0 and r.ai == 0.0
    assert r.roofline_pct is None and r.bound == "?"   # no card, no roofline
    assert r.temp_bytes == 0.0 and r.tf32 is False and r.ms > 0


def test_profile_tree_leaves():
    """Tensors in tuples, lists, dicts and dataclasses count; scalars and
    configs do not; variants roll each tensor along axis 0."""
    st = TQ.init_state(device="cpu")
    tree = (torch.arange(6, dtype=torch.int16).reshape(3, 2),
            [st, {"k": torch.zeros(5, dtype=torch.float64)}], 7, J83bConfig())
    want = 12 + _jax_state_bytes(JQ.init_state()) + 40
    assert profile._tree_nbytes(tree) == want
    variants = profile._arg_variants(tree, 3)
    for i, v in enumerate(variants):
        assert torch.equal(v[0], torch.roll(tree[0], i, 0))
        assert v[0].data_ptr() != tree[0].data_ptr()
        assert isinstance(v[1][0], TQ.J83bState) and v[2] == 7
        assert profile._tree_nbytes(v) == want


def test_profile_cli_streams_rows_as_measured(capsys, monkeypatch):
    """`dtv profile -j` emits each row the moment it is measured: a chain
    that dies after its first stage leaves that row on stdout, and the hook
    is reset.  The row's keys are the reference's, without mbytes_xla and
    with tf32."""
    def fake_chain(*, device):
        profile.profile_fn("s1", lambda x: x + 1.0,
                           (torch.zeros(128, device=device),), n_variants=3)
        raise RuntimeError("chain dies after stage 1")

    monkeypatch.setitem(profile.CHAINS, "fake", fake_chain)
    with pytest.raises(RuntimeError, match="chain dies"):
        profile.cli(["-j", "fake", "--device", "cpu"])
    assert profile.ON_REPORT is None
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert len(rows) == 1 and rows[0]["metric"] == "profile.fake.s1"

    def jax_fake():
        jprofile.profile_fn("s1", lambda x: x + 1.0,
                            (jnp.zeros(128, jnp.float32),), n_variants=3)
        raise RuntimeError("chain dies after stage 1")

    monkeypatch.setitem(jprofile.CHAINS, "fake", jax_fake)
    with pytest.raises(RuntimeError):
        jprofile.cli(["-j", "fake"])
    ref = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("{")]
    assert set(rows[0]) == set(ref[0]) - {"mbytes_xla"} | {"tf32"}
    assert rows[0]["mbytes_io"] == ref[0]["mbytes_io"]
    assert rows[0]["roofline_pct"] is None and rows[0]["bound"] == "?"


def test_profile_cli_usage(capsys):
    assert profile.cli(["nope", "--device", "cpu"]) == 255
    assert "unknown chain <nope>" in capsys.readouterr().err


def test_profile_cli_needs_the_card_by_default(capsys, monkeypatch):
    """--device defaults to cuda, and a missing card is an error (exit 255,
    as every port CLI), not a run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setitem(profile.CHAINS, "papr", ran.append)
    assert profile.cli(["papr"]) == 255
    assert "is_available" in capsys.readouterr().err
    assert profile.cli(["papr", "--device", "meta"]) == 255
    assert "unsupported device" in capsys.readouterr().err
    assert ran == []


def test_chains_match_reference():
    assert list(profile.CHAINS) == list(jprofile.CHAINS)


def _row_names(module) -> dict[str, list[str]]:
    """Per function of ``module``: the names its profile calls give, in
    order (first arguments of calls to ``profile_fn`` or ``prof``)."""
    out = {}
    for fn in ast.parse(inspect.getsource(module)).body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        names = [node.args[0].value for node in ast.walk(fn)
                 if isinstance(node, ast.Call)
                 and getattr(node.func, "id", None) in ("profile_fn", "prof")
                 and node.args and isinstance(node.args[0], ast.Constant)]
        if names:
            out[fn.name] = names
    return out


def test_row_names_match_reference(dvbt_rows, j83b_rows):
    ours, ref = _row_names(profile), _row_names(jprofile)
    assert ours == ref
    assert set(ours) == {"dvbt_stages", "dvbt2_stages", "j83b_stages",
                         "papr_stages"}
    assert [r.name for r in dvbt_rows] == ours["dvbt_stages"]
    assert [r.name for r in j83b_rows] == ours["j83b_stages"]


def test_dvbt_full_row_bytes(dvbt_rows):
    cfg = DvbtConfig()
    iq = 68 * 4 * (cfg.fft_size + cfg.guard_samples) * 8      # complex64
    state = _jax_state_bytes(JD.init_state(cfg))
    full = dvbt_rows[-1]
    assert full.name == "FULL superframe"
    assert full.bytes_io == cfg.ts_bytes_per_superframe + iq + 2 * state
    enc = dvbt_rows[0]
    carriers = 68 * 4 * cfg.mode.carriers * 8
    assert enc.bytes_io == cfg.ts_bytes_per_superframe + carriers + 2 * state
    # the FFT is not counted, so the chain's flops are the encoder's
    assert dvbt_rows[1].flops == 0 and full.flops == enc.flops > 0
    for r in dvbt_rows:
        assert r.ms > 0 and r.roofline_pct is None and r.temp_bytes == 0


def test_j83b_full_row_bytes(j83b_rows):
    ts = TQ.PACKETS_PER_SUPERBLOCK * 188
    iq = 2 * 2 * TQ.SUPERBLOCK_SYMBOLS * 4                     # float32 rails
    state = _jax_state_bytes(JQ.init_state())
    full = j83b_rows[-1]
    assert full.name == "FULL superblock"
    assert full.bytes_io == ts + iq + 2 * state
    rrc = j83b_rows[-2]
    assert rrc.name == "rrc_interpolate"
    cells, tail = 2 * TQ.SUPERBLOCK_SYMBOLS * 4, 2 * 49 * 4
    assert rrc.bytes_io == cells + tail + iq + tail     # in: cells, history
    for r in j83b_rows:
        assert r.ms > 0 and r.roofline_pct is None and r.bound == "?"


def test_flops_count_the_dvbt_rs_product():
    """FlopCounterMode counts the DVB-T RS encoder, one GF(2) product of
    the packets' 1504 message bits by the 1504 x 128 parity matrix, as
    2·n_pkt·1504·128."""
    n_pkt = DvbtConfig().ts_bytes_per_superframe // 188
    rng = np.random.default_rng(8)
    msg = torch.from_numpy(rng.integers(0, 256, (n_pkt, 188), np.uint8))
    r = profile.profile_fn("rs", DVBT_RS().encode_bytes, (msg,),
                           n_variants=2)
    assert r.flops == 2 * n_pkt * 1504 * 128
    assert r.bytes_io == n_pkt * 188 + n_pkt * 204


def test_peaks(monkeypatch):
    """The H100's data-sheet peaks by device name: float32 outside the
    tensor cores, or TF32 when TF32 matmuls are allowed; none for another
    card or the CPU."""
    h100 = "NVIDIA H100 80GB HBM3"
    name = {"v": h100}
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: name["v"])
    cuda = torch.device("cuda", 0)
    assert profile._peaks(torch.device("cpu")) is None
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    assert profile._peaks(cuda) == (67e12, 3.35e12)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert profile._peaks(cuda) == (495e12, 3.35e12)
    name["v"] = "NVIDIA A100-SXM4-80GB"
    assert profile._peaks(cuda) is None


def test_roofline_arithmetic(monkeypatch):
    """attainable = max(flops / peak, bytes / bandwidth), the share of the
    measured time, and the side that bounds it (peaks stood in for, on a
    CPU tensor)."""
    calls = []

    def mm(a):
        calls.append(a)
        return a @ a

    for peaks in ((67e12, 3.35e12), (1e9, 3.35e12)):
        monkeypatch.setattr(profile, "_peaks", lambda dev, p=peaks: p)
        calls.clear()
        r = profile.profile_fn("mm", mm, (torch.ones(64, 64),), n_variants=4)
        assert len(calls) == 1 + 4             # counted, warm, 3 timed
        assert r.flops == 2 * 64 ** 3 and r.bytes_io == 2 * 64 * 64 * 4
        t_flop, t_mem = r.flops / peaks[0], r.bytes_io / peaks[1]
        assert r.bound == ("compute" if t_flop > t_mem else "memory")
        assert r.roofline_pct == pytest.approx(
            100 * max(t_flop, t_mem) / (r.ms / 1e3))
    assert r.bound == "compute"
