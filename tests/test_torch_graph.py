"""The port's captured calls (dtv_utils_torch.utils.graph and the
``jit_modulator`` / ``jit_decode`` / batched runners built on it) against
the JAX reference's compiled calls, on the CPU.

On the CPU a captured call runs eagerly through the same static buffers as
on the card (copy in, call, copy out), so these tests hold the buffer
protocol to the reference: 3 consecutive calls carrying the state, each
state bit-exact, IQ within max|Δ|/rms < 1e-4 (DVB-T, DVB-T2 with and
without tone reservation: the port's FFT is pocketfft, the reference's a
float32 matmul DFT) and atol 2e-6 for
J.83B (held to the JAX-made golden ``tests/golden/j83b_torch_smoke.json``
rather than a full-width JAX chain); a result the caller holds is never
changed by a later call; the batched runners take ``start_idx`` as a 0-d
int32 tensor (the DVB-T2 runner held to the reference's sharded runner
on a one-device mesh); ``jit_decode``'s hard bits and ``ok`` equal the
reference's.  The card's own cases (capture, replay, launches counted per
replay) are in ``tests/test_torch_graph_gpu.py``, which imports no JAX.
"""

import dataclasses
import enum
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtv_utils_tpu.core import config as jconfig
from dtv_utils_tpu.ops import ldpc_decode as JLD
from dtv_utils_tpu.parallel import stream as JS
from dtv_utils_tpu.tx import dvbt as JD
from dtv_utils_tpu.tx import dvbt2 as JT2
from dtv_utils_torch.core import config as tconfig
from dtv_utils_torch.core.config import J83bConfig
from dtv_utils_torch.models.dvbt2 import PROFILES
from dtv_utils_torch.ops import _build
from dtv_utils_torch.ops import ldpc_decode as TLD
from dtv_utils_torch.parallel import stream as S
from dtv_utils_torch.tx import dvbt as TD
from dtv_utils_torch.tx import dvbt2 as TT2
from dtv_utils_torch.tx import j83b as TQ
from dtv_utils_torch.utils import graph

ROOT = Path(__file__).resolve().parents[1]
J83B_GOLDEN = ROOT / "tests" / "golden" / "j83b_torch_smoke.json"
IQ_REL = 1e-4                      # max|Δ|/rms, DVB-T and DVB-T2 IQ
J83B_ATOL = 2e-6                   # J.83B IQ against the golden
CALLS = 3                          # consecutive calls, state carried
CPU = torch.device("cpu")

M, C, R, G = (tconfig.TransmissionMode, tconfig.Constellation,
              tconfig.CodeRate, tconfig.GuardInterval)
CFG_MIN = tconfig.DvbtConfig(mode=M.M2K, bandwidth_mhz=6,
                             constellation=C.QPSK, code_rate=R.R1_2,
                             guard=G.G1_4)     # tests/test_torch_dvbt.py
BLADE = PROFILES["blade"]
BLADE_TR = dataclasses.replace(BLADE, papr_tr=True)     # --papr
T2_SMALL = tconfig.Dvbt2Config(fec_blocks=3, ti_blocks=2)


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load_chip_smoke()


def _jcfg(cfg):
    """The reference's config with the same field values as ``cfg``."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, enum.Enum):
            v = getattr(jconfig, type(v).__name__)[v.name]
        kw[f.name] = v
    return getattr(jconfig, type(cfg).__name__)(**kw)


def _ts(n_bytes: int, seed: int) -> np.ndarray:
    ts = np.random.default_rng(seed).integers(0, 256, size=n_bytes,
                                              dtype=np.uint8)
    ts[::188] = 0x47
    return ts


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max()
                 / np.sqrt(np.mean(np.abs(want.astype(np.complex128)) ** 2)))


def _rails(x) -> np.ndarray:
    a = np.asarray(x)
    return (a[0] + 1j * a[1]).astype(np.complex64)


def _assert_state(port, ref, label: str) -> None:
    for f in dataclasses.fields(ref):
        want = np.asarray(getattr(ref, f.name))
        got = getattr(port, f.name).numpy()
        assert got.dtype == want.dtype, (label, f.name)
        np.testing.assert_array_equal(got, want, err_msg=f"{label} {f.name}")


# ---------------------------------------------------------------------------
# jit_modulator against the reference's, 3 calls carrying the state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chain", ["dvbt", "dvbt2", "dvbt2-tr"])
def test_jit_modulator_equals_reference(chain):
    """DVB-T at CFG_MIN, DVB-T2 blade, and blade with tone reservation
    (``--papr``, the ``_tr_step`` loop inside the call): each call's state
    bit-exact and its IQ within IQ_REL of the reference's
    ``jit_modulator``."""
    port, ref, cfg = {"dvbt": (TD, JD, CFG_MIN),
                      "dvbt2": (TT2, JT2, BLADE),
                      "dvbt2-tr": (TT2, JT2, BLADE_TR)}[chain]
    blk = (cfg.ts_bytes_per_superframe if chain == "dvbt"
           else cfg.payload_bytes_per_frame)
    ts = _ts(CALLS * blk, 0x6A + len(chain))
    fn, jfn = port.jit_modulator(cfg, device="cpu"), ref.jit_modulator(
        _jcfg(cfg))
    st, jst = port.init_state(cfg, device="cpu"), ref.init_state(_jcfg(cfg))
    for i in range(CALLS):
        x = ts[i * blk:(i + 1) * blk]
        iq, st = fn(torch.from_numpy(x), st)
        jiq, jst = jfn(jnp.asarray(x), jst)
        _assert_state(st, jst, f"{chain} call {i}")
        assert iq.dtype == torch.complex64
        assert _rel(iq.numpy(), _rails(jiq)) < IQ_REL


def test_j83b_jit_modulator_equals_golden():
    """Three superblocks: the first two's IQ at the golden's indices within
    J83B_ATOL and the state after them equal to the golden's digest (both
    from the JAX reference); the third equal to the eager chain."""
    golden = json.loads(J83B_GOLDEN.read_text())
    cfg, blk = J83bConfig(), TQ.SUPERBLOCK_BYTES
    ts = smoke.seeded_ts(golden["seed"], CALLS * blk)
    assert smoke.sha256(ts[:2 * blk]) == golden["ts_sha256"]
    fn = TQ.jit_modulator(cfg, device="cpu")
    st, iqs = TQ.init_state(cfg, device="cpu"), []
    for i in range(CALLS):
        iq, st = fn(torch.from_numpy(ts[i * blk:(i + 1) * blk]), st)
        iqs.append(iq)
        if i == 1:
            two = st
    got = np.concatenate([(x[0] + 1j * x[1]).numpy() for x in iqs[:2]])
    idx = np.asarray(golden["iq_index"])
    want = (np.asarray(golden["iq_re"], np.float32)
            + 1j * np.asarray(golden["iq_im"], np.float32))
    np.testing.assert_allclose(got[idx], want, rtol=0, atol=J83B_ATOL)
    assert smoke.state_digest(TQ.state_to_numpy(two)) == \
        golden["state_sha256"]
    eager, eager_st = TQ.modulate_superblock(
        cfg, torch.from_numpy(ts[2 * blk:]), two)
    assert torch.equal(iqs[2], eager)
    for f in dataclasses.fields(st):
        assert torch.equal(getattr(st, f.name), getattr(eager_st, f.name))


# ---------------------------------------------------------------------------
# Ownership: a later call never changes what an earlier one returned
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chain", ["dvbt", "dvbt2"])
def test_results_are_the_callers(chain):
    """Call k's IQ and state are unchanged after call k+1, whose input
    overwrites the static buffers; DVB-T2's new ``prev_tail`` (a view of
    the input buffer inside ``modulate_frame``) too."""
    port, cfg = {"dvbt": (TD, CFG_MIN), "dvbt2": (TT2, T2_SMALL)}[chain]
    blk = (cfg.ts_bytes_per_superframe if chain == "dvbt"
           else cfg.payload_bytes_per_frame)
    ts = torch.from_numpy(_ts(2 * blk, 0x0A))
    fn = port.jit_modulator(cfg, device="cpu")
    iq1, st1 = fn(ts[:blk], port.init_state(cfg, device="cpu"))
    kept = (iq1.clone(), {k: v.copy()
                          for k, v in port.state_to_numpy(st1).items()})
    sc = fn.static_call(ts[blk:], st1)
    iq2, st2 = fn(ts[blk:], st1)
    assert torch.equal(iq1, kept[0]) and not torch.equal(iq1, iq2)
    for k, v in port.state_to_numpy(st1).items():
        np.testing.assert_array_equal(v, kept[1][k], err_msg=k)
    buffers = {t.untyped_storage().data_ptr() for t in sc.buffers}
    for t in (iq1, iq2, *(getattr(s, f.name) for s in (st1, st2)
                          for f in dataclasses.fields(s))):
        assert t.untyped_storage().data_ptr() not in buffers
    if chain == "dvbt2":
        np.testing.assert_array_equal(st1.prev_tail.numpy(),
                                      ts[blk - 187:blk].numpy())
        np.testing.assert_array_equal(st2.prev_tail.numpy(),
                                      ts[-187:].numpy())


# ---------------------------------------------------------------------------
# The batched runners, start_idx a device scalar
# ---------------------------------------------------------------------------

def test_batched_dvbt_tensor_start_idx_equals_reference():
    """start_idx 0 and 3 as 0-d int32 tensors against the reference's
    jitted ``batched_dvbt_modulator`` (``jnp.int32`` index), and equal to
    the eager batched call with a Python int."""
    blk = CFG_MIN.ts_bytes_per_superframe
    halo = S.HALO_PACKETS * 188
    ts = _ts(5 * blk, 0xB5).reshape(5, blk)
    fn = S.batched_dvbt_modulator(CFG_MIN, device="cpu")
    jfn = JS.batched_dvbt_modulator(_jcfg(CFG_MIN))
    x = torch.from_numpy(ts)
    for start, stop in ((0, 3), (3, 5)):
        tail = x[start - 1, -halo:] if start else None
        got = fn(x[start:stop], tail,
                 torch.tensor(start, dtype=torch.int32))
        jtail = (jnp.asarray(ts[start - 1, -halo:]) if start
                 else jnp.zeros(halo, jnp.uint8))
        want = np.asarray(jfn(jnp.asarray(ts[start:stop]), jtail,
                              jnp.int32(start)))          # [B, 2, n]
        assert got.shape == (stop - start, CFG_MIN.samples_per_superframe)
        assert _rel(got.numpy(), (want[:, 0] + 1j * want[:, 1]
                                  ).astype(np.complex64)) < IQ_REL
        assert torch.equal(got, S.modulate_dvbt_blocks(
            CFG_MIN, x[start:stop],
            torch.zeros(halo, dtype=torch.uint8) if tail is None else tail,
            torch.tensor(start, dtype=torch.int32)))


def test_batched_dvbt2_tensor_start_idx_equals_serial():
    """The DVB-T2 runner at start_idx 0 and 3 (0-d int32 tensors) equals
    the serial chain from the state at those frames, bit for bit."""
    cfg, blk = T2_SMALL, T2_SMALL.payload_bytes_per_frame
    ts = _ts(5 * blk, 0xB6)
    want, _ = TT2.modulate_stream(cfg, ts, device="cpu")
    fn = S._batched_dvbt2_modulator(cfg, device="cpu")
    x = torch.from_numpy(ts).reshape(5, blk)
    got = torch.cat([
        fn(x[:3], None, torch.tensor(0, dtype=torch.int32)),
        fn(x[3:], x[2, -S.T2_HALO_BYTES:],
           torch.tensor(3, dtype=torch.int32))])
    np.testing.assert_array_equal(got.numpy().reshape(-1), want)


def test_batched_dvbt2_tensor_start_idx_equals_reference():
    """The DVB-T2 runner at start_idx 0 and 3 (0-d int32 tensors) against
    the reference's jitted sharded runner on a one-device mesh, whose
    frames 0-2 and 3-4 are those of the same 5-frame stream: IQ within
    IQ_REL."""
    cfg, blk = T2_SMALL, T2_SMALL.payload_bytes_per_frame
    ts = _ts(5 * blk, 0xB7).reshape(5, blk)
    run, sharding = JS.sharded_dvbt2_modulator(
        _jcfg(cfg), JS.make_mesh(jax.devices()[:1]))
    want = np.asarray(run(jax.device_put(jnp.asarray(ts), sharding)))
    want = (want[:, 0] + 1j * want[:, 1]).astype(np.complex64)
    fn = S._batched_dvbt2_modulator(cfg, device="cpu")
    x = torch.from_numpy(ts)
    for start, stop in ((0, 3), (3, 5)):
        got = fn(x[start:stop], x[start - 1, -S.T2_HALO_BYTES:]
                 if start else None, torch.tensor(start, dtype=torch.int32))
        assert got.shape == (stop - start, TT2.samples_per_frame(cfg))
        assert _rel(got.numpy(), want[start:stop]) < IQ_REL


def test_block_index_takes_int32_scalars_only():
    assert S.block_index(7, CPU).dtype == torch.int32
    idx = torch.tensor(7, dtype=torch.int32)
    assert S.block_index(idx, CPU) is idx
    for bad in (torch.tensor(7), torch.tensor([7], dtype=torch.int32), -1,
                2**31):
        with pytest.raises(ValueError):
            S.block_index(bad, CPU)


# ---------------------------------------------------------------------------
# jit_decode
# ---------------------------------------------------------------------------

def test_jit_decode_equals_reference():
    """Short 2/3, 3 codewords, one through AWGN it corrects, one pure
    noise it cannot, one zero: hard bits and ``ok`` bit-exact, twice (the
    second call through the same buffers)."""
    tcfg = tconfig.Dvbt2Config(frame_size=tconfig.T2FrameSize.SHORT,
                               fec_blocks=3, ti_blocks=1)
    jcfg = _jcfg(tcfg)
    rng = np.random.default_rng(0xDEC)
    bb = rng.integers(0, 2, (3, jcfg.kbch)).astype(np.uint8)
    fec = np.asarray(JT2.fec_encode(jcfg, jnp.asarray(bb)))
    sigma = np.sqrt(1 / (2 * 10 ** (2.5 / 10)))
    y = 1.0 - 2.0 * fec.astype(np.float32)
    y[0] += rng.normal(0, sigma, y.shape[1]).astype(np.float32)
    y[1] = rng.normal(0, 1, y.shape[1]).astype(np.float32)
    llr = (2 * y / sigma ** 2).astype(np.float32)
    fn = TLD.jit_decode(tcfg, 30, device="cpu")
    jh, jok = JLD.jit_decode(jcfg, 30)(jnp.asarray(llr))
    for _ in range(2):
        th, tok = fn(torch.from_numpy(llr))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.tolist() == [True, False, True]
    np.testing.assert_array_equal(th[0].numpy(), fec[0])


# ---------------------------------------------------------------------------
# The helper's own rules
# ---------------------------------------------------------------------------

def _double(x, st):
    return x * 2, st + 1


def test_static_call_checks_its_arguments():
    sc = graph.StaticCall(
        _double, (torch.zeros(4), torch.zeros((), dtype=torch.int32)),
        device=CPU)
    out, st = sc(torch.arange(4.0), torch.tensor(5, dtype=torch.int32))
    assert out.tolist() == [0, 2, 4, 6] and int(st) == 6
    with pytest.raises(ValueError, match="takes"):
        sc(torch.zeros(5), torch.tensor(0, dtype=torch.int32))
    with pytest.raises(ValueError, match="takes"):
        sc(torch.zeros(4, dtype=torch.float64),
           torch.tensor(0, dtype=torch.int32))
    with pytest.raises(ValueError, match="structure"):
        sc(torch.zeros(4), None)
    with pytest.raises(TypeError):
        sc(torch.zeros(4), 3)


def test_static_call_refuses_another_tf32_setting(monkeypatch):
    sc = graph.StaticCall(_double, (torch.zeros(2), torch.zeros(2)),
                          device=CPU)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        not sc.tf32[0])
    with pytest.raises(RuntimeError, match="TF32"):
        sc(torch.zeros(2), torch.zeros(2))


def test_jit_keys_shapes_and_tf32_in_a_bounded_lru(monkeypatch):
    """One captured call per signature and TF32 setting; at most
    MAX_GRAPHS per device, least recently used dropped first."""
    monkeypatch.setattr(graph, "_CACHE", {})
    monkeypatch.setattr(graph, "MAX_GRAPHS", 3)
    jit = graph.Jit(_double, device=CPU)
    calls = [jit.static_call(torch.zeros(n), torch.zeros(1))
             for n in (1, 2, 1)]
    assert calls[0] is calls[2] and calls[0] is not calls[1]
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        not graph.tf32()[0])
    assert jit.static_call(torch.zeros(1), torch.zeros(1)) is not calls[0]
    for n in (3, 4):
        jit.static_call(torch.zeros(n), torch.zeros(1))
    kept = list(graph._CACHE[CPU].values())
    assert len(kept) == 3 and calls[0] not in kept and calls[1] not in kept


def test_cpu_calls_count_no_launch(monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    TQ.jit_modulator(J83bConfig(), device="cpu")(
        torch.zeros(TQ.SUPERBLOCK_BYTES, dtype=torch.uint8),
        TQ.init_state(device="cpu"))
    assert not any(_build.LAUNCHES.values())


def test_add_launches_moves_every_counter(monkeypatch):
    """A replay adds its captured launches to ``_build.LAUNCHES``, the one
    counter every kernel wrapper's launches go to."""
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 4))
    graph._add_launches({"fir_interp2": 2, "ldpc_check": 3})
    assert _build.LAUNCHES == dict.fromkeys(_build.LAUNCHES, 4) | {
        "fir_interp2": 6, "ldpc_check": 7}


def test_reads_holds_tables_not_temporaries():
    """What a capture must keep alive: every tensor its ops read that it
    did not make.  After a warm-up call (as the card's first call is),
    that is exactly the inputs and the chain's cached tables, the bounded
    dispersal rows among them, and none of the call's temporaries."""
    from dtv_utils_torch.core import bits
    from dtv_utils_torch.ops.rs import DVBT_RS

    ts = torch.from_numpy(_ts(CFG_MIN.ts_bytes_per_superframe, 3))
    st = TD.init_state(CFG_MIN, device="cpu")
    TD.modulate_superframe(CFG_MIN, ts, st)
    reads = graph._Reads()
    with reads:
        TD.modulate_superframe(CFG_MIN, ts, st)
    held = {t.untyped_storage().data_ptr() for t in reads.read.values()}
    v = CFG_MIN.constellation.bits_per_symbol
    want = [ts, st.packet_phase, st.outer_carry, st.conv_state,
            TD.dispersal_rows(CFG_MIN.rs_blocks_per_superframe, CPU),
            DVBT_RS()._device_M[CPU], TD._forney_index(CFG_MIN, CPU),
            bits._shifts(8, torch.uint8, CPU),
            bits._shifts(v, torch.int32, CPU),
            *TD._device_plan(CFG_MIN, CPU).values()]
    assert held == {t.untyped_storage().data_ptr() for t in want}
