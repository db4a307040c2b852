"""Per-stage device profiling and roofline accounting (the port of
``dtv_utils_tpu/utils/profile.py``).

Every chain stage runs standalone on one block (one superframe, T2 frame or
superblock, as the reference times it).  ``torch.utils.flop_counter``
counts its operations in one untimed call, CUDA events time it, and the
stage is scored against the card's roofline: attainable time =
max(flops / peak FLOP/s, bytes_io / peak bytes/s), roofline share =
attainable / measured.

``dtv profile {dvbt,dvbt2,dvbt2-bbc,j83b,papr}`` prints the stage table
(human) and, with ``-j``, JSON lines through ``utils.metrics``, one per row
the moment it is measured.  ``--device cuda|cpu`` (default ``cuda``, no
fallback) picks where it runs; on the CPU the time is the host clock's and
there is no roofline.

Deliberate differences from the reference:

* There is no ``bytes_xla``: PyTorch has no count of the logical bytes a
  program touches.  ``bytes_io`` (argument + result bytes) is the same
  lower bound on device-memory traffic as the reference's.
* ``flops`` counts only what ``FlopCounterMode`` knows (matmul, bmm,
  convolution), where XLA's ``cost_analysis`` counted every op.  The
  compute side of the bound is therefore a lower bound, and the two
  packages' ``flops`` are not compared.
* ``temp_bytes`` is the call's peak device allocation above what was
  allocated before it (outputs included); 0 on the CPU.
* The DVB-T2 rows keep the reference's split (``cell_time_interleave``,
  then ``build_frame_grid``), but ``FULL frame`` times ``modulate_frame``,
  which composes both interleavers into the frame gather
  (``build_frame_grid_fused``).  The stage rows need not add up to FULL.
* Each row records whether TF32 matmuls were allowed: the compute peak is
  the card's float32 rate without, its TF32 rate with.
* The reference's lane-padding workaround (``_railify``) has no purpose
  on a GPU and is not ported.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from dtv_utils_torch.utils.device import resolve_device, split_device_arg

# Card peaks for roofline scoring, keyed by torch.cuda.get_device_name():
# (float32 FLOP/s outside the tensor cores, HBM bytes/s), from NVIDIA's
# data sheet (SXM part, dense, at the 700 W limit).  With TF32 matmuls
# allowed the compute peak is TF32_PEAKS' instead.
CHIP_PEAKS: dict[str, tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (67e12, 3.35e12),
}
TF32_PEAKS: dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 495e12,
}


@dataclass
class StageReport:
    name: str
    ms: float                    # measured ms per invocation
    flops: float                 # FlopCounterMode (matmul, bmm, conv)
    bytes_io: float              # argument + result tensor bytes
    roofline_pct: float | None   # attainable/measured (None off the card)
    bound: str                   # "memory" | "compute" | "?"
    temp_bytes: float = 0.0      # peak allocation above the call's start
    tf32: bool = False           # torch.backends.cuda.matmul.allow_tf32

    @property
    def ai(self) -> float:
        """Arithmetic intensity, flops per device-memory I/O byte."""
        return self.flops / self.bytes_io if self.bytes_io else 0.0


def _peaks(device: torch.device) -> tuple[float, float] | None:
    """(compute FLOP/s, bytes/s) of ``device`` for the current TF32
    setting, or None for the CPU or a card not in CHIP_PEAKS."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    peaks = CHIP_PEAKS.get(name)
    if peaks is None:
        return None
    if torch.backends.cuda.matmul.allow_tf32:
        return TF32_PEAKS[name], peaks[1]
    return peaks


def _map_tensors(fn, tree):
    """``tree`` with ``fn`` applied to every tensor in its tuples, lists,
    dicts and dataclasses; everything else is kept as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_tensors(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of a tree, in ``_map_tensors``' order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        children = tree
    elif isinstance(tree, dict):
        children = tree.values()
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        children = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    else:
        return []
    return [t for c in children for t in _tensors(c)]


def _arg_variants(args, n: int) -> list:
    """n distinct copies of an argument tree on its device: each tensor
    rolled by i along axis 0 (same shapes, dtypes and cost, other buffers
    and values), 0-d tensors copied.  Each timed call reads its own input,
    not one the L2 still holds from the call before."""
    def mk(i):
        return _map_tensors(
            lambda t: torch.roll(t, i, 0) if t.dim() else t.clone(), args)
    return [mk(i) for i in range(n)]


def _tree_nbytes(tree) -> float:
    """Total bytes of the tensors in a tree."""
    return float(sum(t.numel() * t.element_size() for t in _tensors(tree)))


# Streaming hook (fail-open profiling): when set, every StageReport is
# passed to this callback the moment it is measured, so a run killed
# mid-chain loses only the unmeasured tail.
ON_REPORT = None


def _device_of(args) -> torch.device:
    leaves = _tensors(args)
    if not leaves:
        raise ValueError("profile_fn needs at least one tensor argument")
    return leaves[0].device


def profile_fn(name: str, fn, args, n_variants: int = 6) -> StageReport:
    """Count ``fn(*args)``'s flops, then time it on the arguments' device:
    one warm call, then ``n_variants - 1`` calls, each on its own copy of
    the arguments, between two CUDA events (the host clock on the CPU).

    Roofline bytes model: ``bytes_io`` = argument + result tensor bytes, a
    lower bound on device-memory traffic for any implementation (inputs
    read at least once, outputs written once), so attainable <= measured
    and roofline_pct <= 100 up to timer noise."""
    from torch.utils.flop_counter import FlopCounterMode

    if n_variants < 2:
        raise ValueError("n_variants must be >= 2 (one warm, one timed)")
    dev = _device_of(args)
    cuda = dev.type == "cuda"
    print(f"[profile] {name}: counting flops", file=sys.stderr, flush=True)
    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    flops = float(counter.get_total_flops())
    bytes_io = _tree_nbytes(args) + _tree_nbytes(out)
    del out
    variants = _arg_variants(args, n_variants)
    print(f"[profile] {name}: timing", file=sys.stderr, flush=True)
    temp_bytes = 0.0
    if cuda:
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    fn(*variants[0])                        # warm
    n = len(variants) - 1
    if cuda:
        torch.cuda.synchronize(dev)
        temp_bytes = float(torch.cuda.max_memory_allocated(dev) - before)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for v in variants[1:]:
            fn(*v)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / n
    else:
        t0 = time.perf_counter()
        for v in variants[1:]:
            fn(*v)
        ms = (time.perf_counter() - t0) / n * 1e3

    peaks = _peaks(dev)
    pct, bound = None, "?"
    if peaks is not None:
        pf, pb = peaks
        t_flop, t_mem = flops / pf, bytes_io / pb
        pct = 100.0 * max(t_flop, t_mem) / (ms / 1e3) if ms > 0 else 0.0
        bound = "compute" if t_flop > t_mem else "memory"
    rep = StageReport(name=name, ms=ms, flops=flops, bytes_io=bytes_io,
                      roofline_pct=pct, bound=bound, temp_bytes=temp_bytes,
                      tf32=bool(torch.backends.cuda.matmul.allow_tf32))
    if ON_REPORT is not None:
        ON_REPORT(rep)
    return rep


def _ts_for(n_bytes: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 256, n_bytes, dtype=np.uint8)
    ts[::188] = 0x47
    return ts


def dvbt2_stages(cfg=None, *, device: str | torch.device = "cuda",
                 n_variants: int = 6) -> list[StageReport]:
    """Stage-by-stage profile of the DVB-T2 chain (one T2 frame)."""
    from dtv_utils_torch.core.config import Dvbt2Config
    from dtv_utils_torch.tx import dvbt2 as t2

    dev = resolve_device(device)
    cfg = cfg or Dvbt2Config()
    ts = torch.from_numpy(_ts_for(cfg.payload_bytes_per_frame)).to(dev)
    st = t2.init_state(cfg, device=dev)
    bb, _ = t2.mode_adapt(cfg, ts, st)
    fec = t2.fec_encode(cfg, bb)
    cells = t2.interleave_and_map(cfg, fec)
    payload = t2.cell_time_interleave(cfg, cells)
    grid = t2.build_frame_grid(cfg, payload)

    P = functools.partial
    prof = P(profile_fn, n_variants=n_variants)
    return [
        prof("mode_adapt", P(t2.mode_adapt, cfg), (ts, st)),
        prof("fec_encode", P(t2.fec_encode, cfg), (bb,)),
        prof("interleave_and_map", P(t2.interleave_and_map, cfg), (fec,)),
        prof("cell_time_interleave", P(t2.cell_time_interleave, cfg),
             (cells,)),
        prof("build_frame_grid", P(t2.build_frame_grid, cfg), (payload,)),
        prof("grid_to_iq (ifft+cp+p1)", P(t2.grid_to_iq, cfg), (grid,)),
        prof("FULL frame", P(t2.modulate_frame, cfg), (ts, st)),
    ]


def dvbt_stages(cfg=None, *, device: str | torch.device = "cuda",
                n_variants: int = 6) -> list[StageReport]:
    """Stage profile of the DVB-T chain (one superframe)."""
    from dtv_utils_torch.core.config import DvbtConfig
    from dtv_utils_torch.tx import dvbt as txd

    dev = resolve_device(device)
    cfg = cfg or DvbtConfig()
    ts = torch.from_numpy(_ts_for(cfg.ts_bytes_per_superframe)).to(dev)
    st = txd.init_state(cfg, device=dev)
    carriers, _ = txd.encode_to_carriers(cfg, ts, st)

    P = functools.partial
    prof = P(profile_fn, n_variants=n_variants)
    return [
        prof("encode_to_carriers", P(txd.encode_to_carriers, cfg), (ts, st)),
        prof("carriers_to_iq (ifft+cp)", P(txd.carriers_to_iq, cfg),
             (carriers,)),
        prof("FULL superframe", P(txd.modulate_superframe, cfg), (ts, st)),
    ]


def j83b_stages(cfg=None, *, device: str | torch.device = "cuda",
                n_variants: int = 6) -> list[StageReport]:
    """Stage profile of the J.83B chain (one superblock), with the
    sub-stages of encode_to_cells.  ``rrc_interpolate`` and ``FULL
    superblock`` launch the FIR kernel on the card."""
    from dtv_utils_torch.core import bits as bitops
    from dtv_utils_torch.core.config import J83bConfig
    from dtv_utils_torch.tx import j83b as txq

    dev = resolve_device(device)
    cfg = cfg or J83bConfig()
    n_pkt = txq.PACKETS_PER_SUPERBLOCK
    ts = torch.from_numpy(_ts_for(n_pkt * 188)).to(dev)
    st = txq.init_state(cfg, device=dev)
    cells, _ = txq.encode_to_cells(cfg, ts, st)
    taps = txq.rrc_taps(cfg)

    # sub-stage inputs
    framed = txq.transport_framing(ts.reshape(n_pkt, 188)).reshape(-1)
    bits = bitops.bytes_to_bits(framed)
    info = bitops.bits_to_words(bits.reshape(-1, 7), 7).reshape(-1)
    cw = txq.rs_encode(info.reshape(-1, txq.RS_K)).reshape(-1)
    frame_bits = torch.zeros(
        txq.FRAMES_PER_SUPERBLOCK * (txq.FRAME_SYMBOLS * 7 + 42),
        dtype=torch.uint8, device=dev)
    lut = txq._device_table("lut", dev)

    def symbolize(t):
        framed = txq.transport_framing(t.reshape(n_pkt, 188)).reshape(-1)
        return bitops.bits_to_words(
            bitops.bytes_to_bits(framed).reshape(-1, 7), 7)

    def trellis_map(fb):
        words = txq.trellis_encode(fb, st.conv_a, st.conv_b,
                                   st.diff_state)[0]
        return lut.index_select(1, words)

    P = functools.partial
    prof = P(profile_fn, n_variants=n_variants)
    return [
        prof("encode_to_cells", P(txq.encode_to_cells, cfg), (ts, st)),
        prof("  sub: framing+symbolize", symbolize, (ts,)),
        prof("  sub: rs_encode",
             lambda i: txq.rs_encode(i.reshape(-1, txq.RS_K)), (info,)),
        prof("  sub: interleave",
             lambda c, carry: txq.interleave(c, carry)[0],
             (cw.to(torch.int32), st.ilv_carry)),
        prof("  sub: trellis+map", trellis_map, (frame_bits,)),
        prof("rrc_interpolate",
             lambda c, t: txq.rrc_interpolate(c, t, taps),
             (cells, st.rrc_tail)),
        prof("FULL superblock", P(txq.modulate_superblock, cfg), (ts, st)),
    ]


def papr_stages(cfg=None, *, device: str | torch.device = "cuda",
                n_variants: int = 6) -> list[StageReport]:
    """Stage profile of the PAPR analyzer's device scans (a 16M-complex
    chunk)."""
    from dtv_utils_torch.analysis import papr as pp

    del cfg
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    raw = torch.from_numpy(rng.standard_normal(1 << 25, dtype=np.float32)
                           ).to(dev)
    levels = torch.from_numpy(np.power(10.0, np.arange(11) / 10.0)
                              .astype(np.float32)).to(dev)
    prof = functools.partial(profile_fn, n_variants=n_variants)
    return [
        prof("pass1 (power+peaks+rails)", pp._pass1_chunk, (raw,)),
        prof("pass2 (ccdf histogram)", pp._pass2_chunk, (raw, levels)),
    ]


def _dvbt2_bbc_stages(*, device: str | torch.device = "cuda",
                      n_variants: int = 6) -> list[StageReport]:
    from dtv_utils_torch.models.dvbt2 import PROFILES
    return dvbt2_stages(PROFILES["bbc"], device=device,
                        n_variants=n_variants)


CHAINS = {"dvbt": dvbt_stages, "dvbt2": dvbt2_stages,
          "dvbt2-bbc": _dvbt2_bbc_stages, "j83b": j83b_stages,
          "papr": papr_stages}


def format_table(reports: list[StageReport]) -> str:
    rows = [f"{'stage':<28} {'ms':>9} {'GFLOP':>8} {'MB io':>9} "
            f"{'AI':>7} {'roof%':>6} bound"]
    for r in reports:
        pct = f"{r.roofline_pct:5.1f}" if r.roofline_pct is not None else "  n/a"
        rows.append(f"{r.name:<28} {r.ms:9.3f} {r.flops / 1e9:8.3f} "
                    f"{r.bytes_io / 1e6:9.3f} {r.ai:7.2f} {pct:>6} {r.bound}")
    return "\n".join(rows)


def cli(argv: list[str]) -> int:
    from dtv_utils_torch.utils.metrics import Metrics

    argv, device = split_device_arg(argv)
    json_mode = "-j" in argv
    names = [a for a in argv if not a.startswith("-")] or ["dvbt2"]
    for name in names:
        if name not in CHAINS:
            print(f"unknown chain <{name}> (choose from {list(CHAINS)})",
                  file=sys.stderr)
            return 255
    try:
        dev = resolve_device(device)
    except (RuntimeError, ValueError) as e:
        print(f"profile: {e}", file=sys.stderr)
        return 255
    global ON_REPORT
    for name in names:
        if json_mode:
            # stream each row the moment it is measured (fail-open: a
            # run killed mid-chain keeps every already-measured stage)
            m = Metrics(suppress_human=True)

            def _emit(r, name=name, m=m):
                m.emit(f"profile.{name}.{r.name}", round(r.ms, 4), "ms",
                       gflop=round(r.flops / 1e9, 4),
                       mbytes_io=round(r.bytes_io / 1e6, 4),
                       mbytes_temp=round(r.temp_bytes / 1e6, 4),
                       roofline_pct=(round(r.roofline_pct, 2)
                                     if r.roofline_pct is not None else None),
                       bound=r.bound, tf32=r.tf32)
            ON_REPORT = _emit
            try:
                CHAINS[name](device=dev)
            finally:
                ON_REPORT = None
        else:
            print(f"== {name} ==")
            print(format_table(CHAINS[name](device=dev)))
    return 0
