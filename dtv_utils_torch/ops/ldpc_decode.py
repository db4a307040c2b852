"""Normalized min-sum LDPC decoder for the DVB-T2/S2 IRA codes (port of
``dtv_utils_tpu/ops/ldpc_decode.py``).

The Tanner graph comes from the same accumulator tables the encoder uses
(``tx/dvbt2_tables.ldpc_edge_arrays``), so encoder and decoder agree on
whatever table is loaded.  Check p of the code c = [info | parity] is

  XOR_{edges (g,m)->p} info  ^  parity[p]  ^  parity[p-1]  = 0

(one parity bit for p = 0).  ``_graph`` is the reference's flat edge list,
sorted by check.

Check state.  The reference carries one message per edge.  A min-sum
check sends each of its edges one of two magnitudes with a sign, so the
port carries, per check p and codeword b, 16 bytes instead: ``m1``
float32 (the least |v2c|), ``m2`` float32 (the least |v2c| strictly above
m1, else 1e30, the reference's ``min(where(is_min, 1e30, mag))``) and
``meta`` int64 (bit j: v2c of slot j < 0; bits 56-61: the slot of the
minimum when it is unique, else 63).  Slot j's message is rebuilt exactly:

  c2v_j = (parity(neg bits) ^ bit_j ? -0.75 : 0.75) · (j == unique ? m2 : m1)

the product the reference computes, since ``is_min & n_min == 1`` holds at
the unique minimum's slot alone.  All-zero state rebuilds to +0.0, the
reference's first messages.  A check has at most ``MAX_CHECK_DEGREE``
(56) slots; the twelve T2 codes have 14 to 42.

Edges, unpadded.  The check side is a CSR list (``chk_start``,
``edge_var``: the edges of check p are ``chk_start[p] .. chk_start[p+1]``,
slot j the j-th of them).  The variable side is ``var_pairs`` int32
[Dv, nldpc]: column v holds v's edges as ``check << 6 | slot`` in
ascending edge order, -1 past its degree.

Layout.  Every per-row tensor the iteration carries (llr, totals and the
three state tensors) is cut into slices of ``cols`` codewords
(``SLICE_COLS``): slice s holds its rows' columns s·cols .. s·cols + w - 1
as ``[rows, w]``, w = cols but for a ragged last slice, the slices one
after another.  A warp's read of one row of a slice is then one aligned
128-byte line, and the kernels walk the slices in order, so the
totals and state of the slice they gather from stay in the L2.
``_to_slices`` and ``_from_slices`` convert; the layout never leaves this
module.

Arithmetic.  Every per-edge operation is the reference's, in its order:
``v2c = totals[var] − c2v``, ``is_min = |v2c| <= m1`` with the exact tie
count, the rebuilt product above.  Min, second min, the tie count and
the sign bits are exact in any order.  The one order-sensitive float
reduction is the variable sum ``totals = llr + Σ c2v``: the reference's
``segment_sum`` adds each variable's edges in ascending edge order, and so
does this port (never ``index_add_``, whose CUDA atomics add in no fixed
order).  The hard bits therefore equal the reference's bit for bit,
converged or not, and the card's equal the CPU's.

Kernels.  On the card an iteration is two launches of kernels hand-written
for Hopper (``csrc/ldpc_minsum.cu``): the variable sum
(``_variable_totals``, one warp per variable and 32 codewords of a slice)
and the check update (``_check_update``, one thread per check and
codeword, the state in place).  On a CPU tensor the same wrappers take the plain versions,
``variable_totals_reference`` and ``check_update_reference``
(``minsum_iteration_reference`` is the two in turn); there is no other
route and no fallback.  ``_build.LAUNCHES`` counts the kernels'
launches.

Fixed iteration count, no early exit, and no host sync: the 30 iterations
run inside a span (``utils/trace.span``) named ``ldpc_minsum``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dtv_utils_torch.core.config import Dvbt2Config
from dtv_utils_torch.ops import _build
from dtv_utils_torch.tx import dvbt2_tables as T
from dtv_utils_torch.utils.device import resolve_device
from dtv_utils_torch.utils.graph import Jit
from dtv_utils_torch.utils.trace import span

MINSUM_SCALE = 0.75          # normalized min-sum correction factor
_BIG = 1e30                  # the reference's "no second minimum"
SLOT_SHIFT = 56              # meta: neg bits below, the unique slot above
NO_UNIQUE = 63               # meta's slot field when the minimum is tied
MAX_CHECK_DEGREE = SLOT_SHIFT
PAIR_SHIFT = 6               # var_pairs: check << 6 | slot
SLICE_COLS = 32              # codewords per slice

@functools.cache
def _graph(cfg: Dvbt2Config) -> dict[str, np.ndarray]:
    """Flat Tanner graph: (var[e], chk[e]) sorted by check index (a copy
    of the reference's ``_graph``)."""
    src, dst = T.ldpc_edge_arrays(
        (cfg.code_rate.value, cfg.nldpc, cfg.nbch, cfg.ldpc_q))
    n_parity = cfg.nldpc - cfg.nbch
    # info edges + dual-diagonal parity edges
    var = [src.astype(np.int64), cfg.nbch + np.arange(n_parity)]
    chk = [dst.astype(np.int64), np.arange(n_parity)]
    var.append(cfg.nbch + np.arange(n_parity - 1))
    chk.append(1 + np.arange(n_parity - 1))
    var = np.concatenate(var)
    chk = np.concatenate(chk)
    order = np.argsort(chk, kind="stable")
    return dict(var=var[order].astype(np.int32),
                chk=chk[order].astype(np.int32),
                n_parity=n_parity, n_edges=len(var))


@functools.cache
def _tables(cfg: Dvbt2Config) -> dict:
    """Host tables of the unpadded layout.

    ``chk_start`` int32 [n_parity + 1] and ``edge_var`` int32 [E]: the
    CSR check list.  ``edge_chk``, ``edge_slot`` int64 [E]: each edge's
    check and slot in it.  ``slot_var`` int32 [n_parity · D]: the
    variable of each check slot, padded to D slots with nldpc (the
    syndrome's, an integer sum over a zero row).  ``var_pairs`` int32
    [Dv, nldpc]: the kernel's variable table (``check << 6 | slot``,
    ascending edge order, -1 past the degree).  ``columns``: the plain
    version's, as (n_d, edges) per row d of ``var_pairs`` with the edge
    indices of variables 0 .. n_d - 1 (a prefix: variable degrees never
    increase with the index).  ``D``: the largest check degree."""
    g = _graph(cfg)
    var, chk = g["var"].astype(np.int64), g["chk"].astype(np.int64)
    n_par, nldpc = g["n_parity"], cfg.nldpc
    c_deg = np.bincount(chk, minlength=n_par)
    chk_start = np.concatenate([[0], np.cumsum(c_deg)])
    slot = np.arange(len(chk)) - chk_start[chk]

    v_deg = np.bincount(var, minlength=nldpc)
    if not (np.all(np.diff(v_deg) <= 0) and v_deg[-1] >= 1):
        raise AssertionError("variable degrees must not increase with the "
                             "index: the prefix column sum relies on it")
    by_var = np.argsort(var, kind="stable")             # ascending edge order
    start = np.concatenate([[0], np.cumsum(v_deg)[:-1]])
    var_pairs = np.full((int(v_deg.max()), nldpc), -1, dtype=np.int32)
    columns = []
    for d in range(len(var_pairs)):
        n_d = int((v_deg > d).sum())                    # a prefix, by layout
        e = by_var[start[:n_d] + d]
        var_pairs[d, :n_d] = (chk[e] << PAIR_SHIFT) | slot[e]
        columns.append((n_d, e))
    D = int(c_deg.max())
    slot_var = np.full(n_par * D, nldpc, dtype=np.int32)
    slot_var[chk * D + slot] = var
    return dict(D=D, n_par=n_par, slot_var=slot_var,
                chk_start=chk_start.astype(np.int32), edge_var=g["var"],
                edge_chk=chk, edge_slot=slot, var_pairs=var_pairs,
                columns=tuple(columns))


@functools.cache
def _device_graph(cfg: Dvbt2Config, device: torch.device) -> dict:
    """``_tables`` on ``device`` (uploaded once per config and device)."""
    t = _tables(cfg)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return dict(D=t["D"], n_par=t["n_par"], nldpc=cfg.nldpc,
                chk_start=up(t["chk_start"]), edge_var=up(t["edge_var"]),
                slot_var=up(t["slot_var"]), edge_chk=up(t["edge_chk"]),
                edge_slot=up(t["edge_slot"]), var_pairs=up(t["var_pairs"]),
                columns=tuple((n, up(e)) for n, e in t["columns"]))


def _check_parity(dg: dict, bits_t: torch.Tensor) -> torch.Tensor:
    """bits uint8 [nldpc, ...] → per-check parity int32 [n_parity, ...]:
    a sum over each check's slots, padding slots reading a zero row
    appended to the bits.  It wraps in uint8, which keeps the parity."""
    bits = torch.cat([bits_t, bits_t.new_zeros(1, *bits_t.shape[1:])])
    g = bits.index_select(0, dg["slot_var"]).view(dg["n_par"], dg["D"],
                                                  *bits_t.shape[1:])
    return (g.sum(1, dtype=torch.uint8) & 1).to(torch.int32)


def syndrome(cfg: Dvbt2Config, bits: torch.Tensor) -> torch.Tensor:
    """Hard bits [..., nldpc] → per-check parity int32 [..., n_parity]
    (0 = ok), on the device of ``bits``."""
    lead = bits.shape[:-1]
    flat = bits.reshape(-1, cfg.nldpc).T.to(torch.uint8)
    dg = _device_graph(cfg, bits.device)
    return _check_parity(dg, flat).T.reshape(*lead, -1)


def _to_slices(x: torch.Tensor, cols: int) -> torch.Tensor:
    """[rows, batch] → the sliced layout, flat (see the module note)."""
    rows, batch = x.shape
    nf = batch // cols
    out = x.new_empty(rows * batch)
    out[:nf * rows * cols].view(nf, rows, cols).copy_(
        x[:, :nf * cols].view(rows, nf, cols).transpose(0, 1))
    out[nf * rows * cols:].view(rows, batch - nf * cols).copy_(
        x[:, nf * cols:])
    return out


def _from_slices(flat: torch.Tensor, rows: int, batch: int,
                 cols: int) -> torch.Tensor:
    """The sliced layout, flat → [rows, batch]."""
    nf = batch // cols
    out = flat.new_empty(rows, batch)
    out[:, :nf * cols].view(rows, nf, cols).copy_(
        flat[:nf * rows * cols].view(nf, rows, cols).transpose(0, 1))
    out[:, nf * cols:].copy_(
        flat[nf * rows * cols:].view(rows, batch - nf * cols))
    return out


def _parity64(x: torch.Tensor) -> torch.Tensor:
    """Parity of each int64's bits below bit 63 (xor folding)."""
    for s in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


def expand_c2v(dg: dict, state: tuple) -> torch.Tensor:
    """Every edge's check-to-variable message float32 [E, batch], in edge
    order, rebuilt from the check state (m1, m2, meta)."""
    n_par, b, cols = dg["n_par"], dg["batch"], dg["cols"]
    m1, m2, meta = (_from_slices(x, n_par, b, cols) for x in state)
    mask = (1 << SLOT_SHIFT) - 1
    odd = _parity64(meta & mask).index_select(0, dg["edge_chk"])
    mt = meta.index_select(0, dg["edge_chk"])
    slot = dg["edge_slot"][:, None]
    odd ^= (mt >> slot) & 1
    other = torch.where((mt >> SLOT_SHIFT) == slot,
                        m2.index_select(0, dg["edge_chk"]),
                        m1.index_select(0, dg["edge_chk"]))
    return torch.where(odd.bool(), -MINSUM_SCALE, MINSUM_SCALE) * other


def variable_totals_reference(dg: dict, llr_s: torch.Tensor, state: tuple,
                              out: torch.Tensor) -> None:
    """Plain version of the variable kernel: out = llr + Σ_edges c2v (all
    sliced), each variable's edges added in ascending edge order, the
    first to 0 (the reference's segment_sum)."""
    c2v = expand_c2v(dg, state)
    acc = None
    for n_d, edges in dg["columns"]:
        g = c2v.index_select(0, edges)
        if acc is None:
            acc = g
        else:
            acc[:n_d] += g
    torch.add(llr_s, _to_slices(acc, dg["cols"]), out=out)


def check_update_reference(dg: dict, totals: torch.Tensor,
                           state: tuple) -> tuple:
    """Plain version of the check kernel: sliced totals [nldpc · batch]
    and the state (m1, m2, meta) → the next state (new tensors)."""
    n_par, b, cols = dg["n_par"], dg["batch"], dg["cols"]
    chk, slot = dg["edge_chk"], dg["edge_slot"][:, None]
    tot = _from_slices(totals, dg["nldpc"], b, cols)
    v2c = tot.index_select(0, dg["edge_var"]) - expand_c2v(dg, state)
    mag = v2c.abs()
    idx = chk[:, None].expand_as(mag)

    def seg_min(x, init):
        return mag.new_full((n_par, b), init).scatter_reduce_(
            0, idx, x, "amin")

    def seg_sum(x):
        return x.new_zeros((n_par, b)).index_add_(0, chk, x)

    m1 = seg_min(mag, float("inf"))
    is_min = mag <= m1.index_select(0, chk)
    m2 = seg_min(torch.where(is_min, _BIG, mag), _BIG)
    n_min = seg_sum(is_min.to(torch.int64))
    neg = seg_sum((v2c < 0).to(torch.int64) << slot)   # distinct bits
    at = seg_sum(is_min.to(torch.int64) * slot)         # the slot, if unique
    meta = neg | (torch.where(n_min == 1, at, NO_UNIQUE) << SLOT_SHIFT)
    return tuple(_to_slices(x, cols) for x in (m1, m2, meta))


def minsum_iteration_reference(dg: dict, llr_s: torch.Tensor, state: tuple,
                               totals: torch.Tensor) -> tuple:
    """One plain min-sum iteration (the reference's ``one_iter``): the
    variable sum into ``totals``, then the check update; returns the next
    state."""
    variable_totals_reference(dg, llr_s, state, totals)
    return check_update_reference(dg, totals, state)


def _check_args(dg: dict, rows: dict, state: tuple) -> None:
    """Type, contiguity, device and size of the wrappers' tensors:
    ``rows`` names each float32 tensor with its row count."""
    if dg["D"] > MAX_CHECK_DEGREE:
        raise ValueError(f"a check of degree {dg['D']} does not fit the "
                         f"state's {MAX_CHECK_DEGREE} sign bits")
    m1, m2, meta = state
    want = {**{k: (x, r, torch.float32) for k, (x, r) in rows.items()},
            "m1": (m1, dg["n_par"], torch.float32),
            "m2": (m2, dg["n_par"], torch.float32),
            "meta": (meta, dg["n_par"], torch.int64)}
    for name, (x, r, dtype) in want.items():
        if x.dtype != dtype:
            raise TypeError(f"{name}: need {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: min-sum tensors must be contiguous")
        if x.device != dg["var_pairs"].device:
            raise ValueError(f"{name} on {x.device}, tables on "
                             f"{dg['var_pairs'].device}")
        if x.shape != (r * dg["batch"],):
            raise ValueError(f"{name} {tuple(x.shape)} does not fit the "
                             f"code's tables ({r} rows x {dg['batch']})")


def _variable_totals(dg: dict, llr_s: torch.Tensor, state: tuple,
                     totals: torch.Tensor) -> None:
    """totals = llr + Σ_edges c2v (llr and totals sliced [nldpc · batch]),
    by the kernel on the card and by ``variable_totals_reference`` on the
    CPU."""
    _check_args(dg, {"llr": (llr_s, dg["nldpc"]),
                     "totals": (totals, dg["nldpc"])}, state)
    if not _build.on_card(totals):
        variable_totals_reference(dg, llr_s, state, totals)
        return
    vp = dg["var_pairs"]
    _build.launch("ldpc_variable", totals.device, llr_s.data_ptr(),
                  *(x.data_ptr() for x in state), vp.data_ptr(),
                  dg["nldpc"], dg["n_par"], vp.shape[0], dg["batch"],
                  dg["cols"], totals.data_ptr())


def _check_update(dg: dict, totals: torch.Tensor, state: tuple) -> tuple:
    """The next check state from sliced totals: on the card the kernel
    updates ``state`` in place and returns it; on the CPU
    ``check_update_reference`` returns new tensors."""
    _check_args(dg, {"totals": (totals, dg["nldpc"])}, state)
    if not _build.on_card(totals):
        return check_update_reference(dg, totals, state)
    _build.launch("ldpc_check", totals.device, totals.data_ptr(),
                  *(x.data_ptr() for x in state),
                  dg["chk_start"].data_ptr(), dg["edge_var"].data_ptr(),
                  dg["nldpc"], dg["n_par"], dg["D"], dg["batch"], dg["cols"])
    return state


def _start(cfg: Dvbt2Config, llr: torch.Tensor, cols: int = SLICE_COLS):
    """The decoder's state for channel LLRs [batch, nldpc]: (tables and
    layout, llr float32 sliced, totals (uninitialized) sliced, the check
    state (m1, m2, meta) all zero: every first message +0.0)."""
    if cols % 32 or not 0 < cols <= 1024:
        raise ValueError(f"{cols} codewords per slice: need a multiple of "
                         "32 (whole warps), at most 1024")
    batch = llr.shape[0]
    dg = dict(_device_graph(cfg, llr.device), batch=batch, cols=cols)
    llr_s = _to_slices(llr.to(torch.float32).T, cols)
    state = tuple(torch.zeros(dg["n_par"] * batch, dtype=dt,
                              device=llr.device)
                  for dt in (torch.float32, torch.float32, torch.int64))
    return dg, llr_s, torch.empty_like(llr_s), state


def _finish(dg: dict, totals: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(hard bits uint8 [batch, nldpc], ok bool [batch]) from the final
    sliced totals."""
    hard_t = _from_slices((totals < 0).to(torch.uint8), dg["nldpc"],
                          dg["batch"], dg["cols"])
    ok = (_check_parity(dg, hard_t) == 0).all(0)
    return hard_t.T.contiguous(), ok


def decode(cfg: Dvbt2Config, llr: torch.Tensor, iterations: int = 30
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Min-sum decode: channel LLRs [batch, nldpc] (positive = bit 0) →
    (hard bits uint8 [batch, nldpc], ok bool [batch]), on the device of
    ``llr``."""
    dg, llr_s, totals, state = _start(cfg, llr)
    with span("ldpc_minsum"):
        for _ in range(iterations):
            _variable_totals(dg, llr_s, state, totals)
            state = _check_update(dg, totals, state)
        _variable_totals(dg, llr_s, state, totals)
    del llr_s, state                     # freed before the hard decision
    return _finish(dg, totals)


@functools.cache
def _jit_decode(cfg: Dvbt2Config, iterations: int,
                device: torch.device) -> Jit:
    return Jit(functools.partial(decode, cfg, iterations=iterations),
               device=device)


def jit_decode(cfg: Dvbt2Config, iterations: int = 30, *,
               device: str | torch.device = "cuda") -> Jit:
    """``fn(llr) -> (hard, ok)``: ``decode`` as one captured CUDA graph per
    batch size on ``device`` (the 2·iterations + 1 kernel launches and the
    hard decision in one graph launch; ``utils/graph``; eager through the
    same static buffers on the CPU), the counterpart of the reference's
    ``jit_decode``."""
    return _jit_decode(cfg, iterations, resolve_device(device))
