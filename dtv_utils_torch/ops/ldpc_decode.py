"""Normalized min-sum LDPC decoder for the DVB-T2/S2 IRA codes (port of
``dtv_utils_tpu/ops/ldpc_decode.py``).

The Tanner graph comes from the same accumulator tables the encoder uses
(``tx/dvbt2_tables.ldpc_edge_arrays``), so encoder and decoder agree on
whatever table is loaded.  Check p of the code c = [info | parity] is

  XOR_{edges (g,m)->p} info  ^  parity[p]  ^  parity[p-1]  = 0

(one parity bit for p = 0).  ``_graph`` is the reference's flat edge list,
sorted by check.

Layout.  The reference runs XLA segment reductions over the flat edges.
Here the check-to-variable messages live check-major in a padded table
``[n_parity, D, batch]`` (D = the largest check degree; edge e of check p
sits in slot ``e - first_edge(p)``), batch innermost so that every gather
moves whole rows.  The per-check min, second min, tie count and sign
parity are then reductions over the slot axis, broadcast back for free; a
padding slot reads a variable whose total is +inf, so it is never a
minimum and never negative.

Arithmetic.  Every per-edge operation is the reference's, in its order:
``v2c = totals[var] − c2v``, ``is_min = |v2c| <= m1`` with the exact tie
count, ``other = m2 if (is_min and n_min == 1) else m1``, and
``c2v = (MINSUM_SCALE · s) · other`` with s = ±1.  Min, second min and the
integer counts are exact in any order.  The one order-sensitive float
reduction is the variable sum ``totals = llr + Σ c2v``: the reference's
``segment_sum`` adds each variable's edges in ascending edge order from 0,
and so does this port, column by column of a per-variable table of edge
slots (never ``index_add_``, whose CUDA atomics add in no fixed order).
Variable degrees never increase with the index, so column d covers a
prefix of the variables and the columns together read each edge once.
The hard bits therefore equal the reference's bit for bit, converged or
not, and the card's equal the CPU's.

Kernels.  On the card an iteration is two launches of kernels hand-written
for Hopper (``csrc/ldpc_minsum.cu``): the variable sum
(``_variable_totals``, one thread per variable and codeword, its edges
read from ``var_slots`` in ascending order) and the check update
(``_check_update``, one thread per check and codeword, in place).  On a
CPU tensor the same wrappers take the plain versions,
``variable_totals_reference`` and ``check_update_reference``
(``minsum_iteration_reference`` is the two in turn); there is no other
route and no fallback.  ``LAUNCHES`` counts the kernels' launches.

Fixed iteration count, no early exit, and no host sync: the 30 iterations
run inside a ``torch.profiler`` range named ``ldpc_minsum``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dtv_utils_torch.core.config import Dvbt2Config
from dtv_utils_torch.ops import _build
from dtv_utils_torch.tx import dvbt2_tables as T

MINSUM_SCALE = 0.75          # normalized min-sum correction factor
_BIG = 1e30                  # the reference's "no second minimum"

LAUNCHES = {"ldpc_check": 0, "ldpc_variable": 0}
"""Kernel launches so far, per kernel (the CPU path does not count)."""


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
def _padded(cfg: Dvbt2Config) -> dict:
    """Host tables of the padded layout.

    ``slot_var`` [n_parity · D]: the variable of each check slot, or nldpc
    (the +inf / zero row) for padding.  ``columns``: the variable-side
    table as (n_vars, slots) groups of consecutive columns that cover the
    same prefix of variables; ``slots`` is [n_cols · n_vars], column-major,
    each variable's edges in ascending edge order.  ``var_slots`` int32
    [Dv, nldpc]: the same table padded with -1, the kernel's: column v
    holds variable v's slots in ascending edge order."""
    g = _graph(cfg)
    var, chk = g["var"].astype(np.int64), g["chk"].astype(np.int64)
    n_par, nldpc = g["n_parity"], cfg.nldpc
    c_deg = np.bincount(chk, minlength=n_par)
    D = int(c_deg.max())
    first = np.concatenate([[0], np.cumsum(c_deg)[:-1]])
    slot = chk * D + (np.arange(len(chk)) - first[chk])
    slot_var = np.full(n_par * D, nldpc, dtype=np.int64)
    slot_var[slot] = var

    v_deg = np.bincount(var, minlength=nldpc)
    if not (np.all(np.diff(v_deg) <= 0) and v_deg[-1] >= 1):
        raise AssertionError("variable degrees must not increase with the "
                             "index: the prefix column sum relies on it")
    by_var = slot[np.argsort(var, kind="stable")]       # ascending edge order
    start = np.concatenate([[0], np.cumsum(v_deg)[:-1]])
    columns: list[tuple[int, np.ndarray]] = []
    var_slots = np.full((int(v_deg.max()), nldpc), -1, dtype=np.int32)
    for d in range(len(var_slots)):
        n_d = int((v_deg > d).sum())                    # a prefix, by layout
        col = by_var[start[:n_d] + d]
        var_slots[d, :n_d] = col
        if columns and columns[-1][0] == n_d:
            columns[-1] = (n_d, np.concatenate([columns[-1][1], col]))
        else:
            columns.append((n_d, col))
    return dict(D=D, slot_var=slot_var, columns=tuple(columns),
                var_slots=var_slots)


@functools.cache
def _device_graph(cfg: Dvbt2Config, device: torch.device) -> dict:
    """``_padded`` on ``device`` (uploaded once per config and device)."""
    p = _padded(cfg)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return dict(D=p["D"], slot_var=up(p["slot_var"]),
                columns=tuple((n, up(s)) for n, s in p["columns"]),
                var_slots=up(p["var_slots"]))


def _check_parity(cfg: Dvbt2Config, bits_t: torch.Tensor) -> torch.Tensor:
    """bits [nldpc + 1, ...] (last row 0) → per-check parity int32
    [n_parity, ...]: an integer sum, exact in any order."""
    dg = _device_graph(cfg, bits_t.device)
    g = bits_t.index_select(0, dg["slot_var"])
    g = g.view(-1, dg["D"], *bits_t.shape[1:])
    return g.sum(1, dtype=torch.int32) % 2


def syndrome(cfg: Dvbt2Config, bits: torch.Tensor) -> torch.Tensor:
    """Hard bits [..., nldpc] → per-check parity int32 [..., n_parity]
    (0 = ok), on the device of ``bits``."""
    lead = bits.shape[:-1]
    flat = bits.reshape(-1, cfg.nldpc).T.to(torch.int32)
    flat = torch.cat([flat, flat.new_zeros(1, flat.shape[1])])
    return _check_parity(cfg, flat).T.reshape(*lead, -1)


def variable_totals_reference(dg: dict, llr_t: torch.Tensor,
                              c2v: torch.Tensor, out: torch.Tensor) -> None:
    """Plain version of the variable kernel: out[:nldpc] = llr + Σ_edges
    c2v, each variable's edges added in ascending edge order, the first to
    0 (the reference's segment_sum)."""
    flat = c2v.view(-1, c2v.shape[-1])
    acc = None
    for n_d, slots in dg["columns"]:
        g = flat.index_select(0, slots).view(-1, n_d, flat.shape[1])
        for j in range(g.shape[0]):
            if acc is None:
                acc = g[j]
            else:
                acc[:n_d] += g[j]
    torch.add(llr_t, acc, out=out[:-1])


def check_update_reference(dg: dict, totals: torch.Tensor,
                           c2v: torch.Tensor) -> torch.Tensor:
    """Plain version of the check kernel: totals [nldpc + 1, b] and c2v
    [n_parity, D, b] → the next c2v (a new tensor)."""
    v2c = totals.index_select(0, dg["slot_var"]).view_as(c2v) - c2v
    mag = v2c.abs()
    neg = v2c < 0
    m1 = mag.amin(1, keepdim=True)                             # [p, 1, b]
    is_min = mag <= m1
    n_min = is_min.sum(1, keepdim=True)
    m2 = torch.where(is_min, _BIG, mag).amin(1, keepdim=True)
    odd = (neg.sum(1, keepdim=True) & 1).bool()                # sign parity
    other = torch.where(is_min & (n_min == 1), m2, m1)
    return torch.where(odd != neg, -MINSUM_SCALE, MINSUM_SCALE) * other


def minsum_iteration_reference(dg: dict, llr_t: torch.Tensor,
                               c2v: torch.Tensor,
                               totals: torch.Tensor) -> torch.Tensor:
    """One plain min-sum iteration (the reference's ``one_iter``): the
    variable sum into ``totals``, then the check update; returns the next
    c2v."""
    variable_totals_reference(dg, llr_t, c2v, totals)
    return check_update_reference(dg, totals, c2v)


def _check_tables(dg: dict, *tensors: torch.Tensor) -> None:
    for x in tensors:
        if x.dtype != torch.float32:
            raise TypeError(f"need float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("min-sum tensors must be contiguous")
        if x.device != dg["slot_var"].device:
            raise ValueError(f"tensor on {x.device}, tables on "
                             f"{dg['slot_var'].device}")


def _variable_totals(dg: dict, llr_t: torch.Tensor, c2v: torch.Tensor,
                     totals: torch.Tensor) -> None:
    """totals[:nldpc] = llr + Σ_edges c2v (llr_t [nldpc, b], c2v
    [n_parity, D, b], totals [nldpc + 1, b]), by the kernel on the card and
    by ``variable_totals_reference`` on the CPU."""
    _check_tables(dg, llr_t, c2v, totals)
    nldpc, batch = llr_t.shape
    D = dg["D"]
    if (totals.shape != (nldpc + 1, batch) or c2v.dim() != 3
            or c2v.shape[1:] != (D, batch)
            or dg["var_slots"].shape[1] != nldpc):
        raise ValueError(f"shapes llr {tuple(llr_t.shape)}, c2v "
                         f"{tuple(c2v.shape)}, totals {tuple(totals.shape)} "
                         f"do not fit the code's tables")
    if not _build.on_card(c2v):
        variable_totals_reference(dg, llr_t, c2v, totals)
        return
    vs = dg["var_slots"]
    _build.launch("ldpc_variable_launch", c2v.device, llr_t.data_ptr(),
                  c2v.data_ptr(), vs.data_ptr(), nldpc, vs.shape[0], batch,
                  totals.data_ptr())
    LAUNCHES["ldpc_variable"] += 1


def _check_update(dg: dict, totals: torch.Tensor,
                  c2v: torch.Tensor) -> torch.Tensor:
    """The next c2v [n_parity, D, b] from totals [nldpc + 1, b]: on the
    card the kernel updates ``c2v`` in place and returns it; on the CPU
    ``check_update_reference`` returns a new tensor."""
    _check_tables(dg, totals, c2v)
    D = dg["D"]
    n_par = dg["slot_var"].shape[0] // D
    if (c2v.dim() != 3 or c2v.shape[:2] != (n_par, D) or totals.dim() != 2
            or totals.shape[1] != c2v.shape[2]):
        raise ValueError(f"shapes c2v {tuple(c2v.shape)}, totals "
                         f"{tuple(totals.shape)} do not fit the code's "
                         "tables")
    if not _build.on_card(c2v):
        return check_update_reference(dg, totals, c2v)
    _build.launch("ldpc_check_launch", c2v.device, totals.data_ptr(),
                  c2v.data_ptr(), dg["slot_var"].data_ptr(), n_par, D,
                  c2v.shape[2])
    LAUNCHES["ldpc_check"] += 1
    return c2v


def _start(cfg: Dvbt2Config, llr: torch.Tensor):
    """The decoder's state for channel LLRs [batch, nldpc]: (device tables,
    llr_t float32 [nldpc, batch], totals [nldpc + 1, batch] whose last row
    is +inf (read by padding slots), c2v zeros [n_parity, D, batch])."""
    dg = _device_graph(cfg, llr.device)
    batch = llr.shape[0]
    llr_t = llr.to(torch.float32).T.contiguous()
    totals = torch.full((cfg.nldpc + 1, batch), float("inf"),
                        dtype=torch.float32, device=llr.device)
    c2v = torch.zeros((cfg.nldpc - cfg.nbch, dg["D"], batch),
                      dtype=torch.float32, device=llr.device)
    return dg, llr_t, totals, c2v


def _finish(cfg: Dvbt2Config, totals: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(hard bits uint8 [batch, nldpc], ok bool [batch]) from the final
    totals."""
    hard_t = (totals < 0).to(torch.uint8)                      # pad row: 0
    ok = (_check_parity(cfg, hard_t) == 0).all(0)
    return hard_t[:-1].T.contiguous(), ok


def decode(cfg: Dvbt2Config, llr: torch.Tensor, iterations: int = 30
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Min-sum decode: channel LLRs [batch, nldpc] (positive = bit 0) →
    (hard bits uint8 [batch, nldpc], ok bool [batch]), on the device of
    ``llr``."""
    dg, llr_t, totals, c2v = _start(cfg, llr)
    with torch.profiler.record_function("ldpc_minsum"):
        for _ in range(iterations):
            _variable_totals(dg, llr_t, c2v, totals)
            c2v = _check_update(dg, totals, c2v)
        _variable_totals(dg, llr_t, c2v, totals)
    return _finish(cfg, totals)
