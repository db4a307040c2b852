"""Polyphase interpolate-by-2 FIR: the J.83B RRC pulse shaper.

Port of ``dtv_utils_tpu/ops/fir.py``.  ``polyphase_interp2`` keeps the
reference's signature and layout: rail-major ``ext [2, 49 + n]`` (49 history
samples, then n cells) → phase-interleaved ``[2, 2n]`` with
``out[:, 2m+p] = Σ_j h_p[j]·ext[:, m+j]``, ``h_p = taps[p::2]`` reversed.
``polyphase_interp2_split`` takes the history and the cells as two tensors,
so a stream (``tx/j83b.rrc_interpolate``) never concatenates them.

A CUDA tensor goes to the hand-written kernel in ``csrc/fir_interp2.cu``; a
CPU tensor goes to ``interp2_reference``, the plain PyTorch version.  There
is no other route and no fallback: a CUDA launch that fails raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from dtv_utils_torch.ops import _build

NTAPS = 100
HIST = NTAPS // 2 - 1          # 49 history samples carried between calls

LAUNCHES = 0
"""Number of kernel launches so far (the CPU path does not count)."""


@functools.cache
def _phase_taps(taps_bytes: bytes) -> np.ndarray:
    """float32 [2, 50]: row p is taps[p::2] reversed, as the kernel wants."""
    taps = np.frombuffer(taps_bytes, dtype=np.float32)
    h = np.stack([taps[0::2][::-1], taps[1::2][::-1]])
    return np.ascontiguousarray(h, dtype=np.float32)


def interp2_reference(ext_rows: torch.Tensor, taps: np.ndarray,
                      n: int) -> torch.Tensor:
    """Plain PyTorch version: two VALID correlations over the rails as the
    batch, as ``_interp2_conv`` in ``dtv_utils_tpu/tx/j83b.py`` does.

    On a GPU, cuDNN runs this in TF32 unless
    ``torch.backends.cudnn.allow_tf32`` is False; compare with it off."""
    h = _device_phase_taps(np.asarray(taps, np.float32).tobytes(),
                           ext_rows.device)
    outs = []
    for p in range(2):
        y = F.conv1d(ext_rows[:, None, :], h[p][None, None, :])  # [2,1,L-49]
        outs.append(y[:, 0, :n])
    return torch.stack(outs, dim=-1).reshape(2, -1)   # [2, 2n] interleaved


@functools.cache
def _device_phase_taps(taps_bytes: bytes, device: torch.device
                       ) -> torch.Tensor:
    """``_phase_taps`` on ``device``, uploaded once: a copy from pageable
    host memory per call would wait for the device's queue."""
    return torch.from_numpy(_phase_taps(taps_bytes)).to(device)


def polyphase_interp2(ext_rows: torch.Tensor, taps: np.ndarray,
                      n: int) -> torch.Tensor:
    """ext_rows float32 [2, 49 + n'] with n' >= n (contiguous) → [2, 2n].

    On a CUDA tensor it launches the same kernel as
    ``polyphase_interp2_split``, on the views ``ext_rows[:, :49]`` and
    ``ext_rows[:, 49:49 + n]``."""
    taps = _check_taps(taps)
    _check_rows(ext_rows, "ext_rows")
    if not ext_rows.is_contiguous():
        raise ValueError("ext_rows must be contiguous")
    if not 0 <= n <= ext_rows.shape[1] - HIST:
        raise ValueError(f"n={n} needs {HIST} + n <= {ext_rows.shape[1]} "
                         "input samples")
    if not _build.on_card(ext_rows):
        return interp2_reference(ext_rows, taps, n)
    return _launch(ext_rows[:, :HIST], ext_rows[:, HIST:HIST + n],
                   _empty_out(ext_rows, n), _phase_taps(taps.tobytes()))


def polyphase_interp2_split(tail: torch.Tensor, cells: torch.Tensor,
                            taps: np.ndarray) -> torch.Tensor:
    """History ``tail`` float32 [2, 49] and ``cells`` [2, n] → [2, 2n]: the
    result of ``polyphase_interp2`` on ``cat([tail, cells], 1)``, without
    the concatenation.  Rows may be strided views starting at any element
    (unit stride along a row); the kernel reads them in place."""
    taps = _check_taps(taps)
    _check_rows(tail, "tail")
    _check_rows(cells, "cells")
    if tail.shape[1] != HIST:
        raise ValueError(f"tail must hold {HIST} samples per rail, got "
                         f"{tail.shape[1]}")
    if tail.device != cells.device:
        raise ValueError(f"tail on {tail.device}, cells on {cells.device}")
    n = cells.shape[1]
    if not _build.on_card(cells):
        return interp2_reference(torch.cat([tail, cells], dim=1), taps, n)
    return _launch(tail, cells, _empty_out(cells, n),
                   _phase_taps(taps.tobytes()))


def _check_taps(taps: np.ndarray) -> np.ndarray:
    taps = np.asarray(taps, dtype=np.float32)
    if taps.shape != (NTAPS,):
        raise ValueError(f"need {NTAPS} taps, got {taps.shape}")
    return taps


def _check_rows(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] != 2:
        raise ValueError(f"{name} must be rails [2, L], got "
                         f"{tuple(x.shape)}")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError(f"{name} must have unit stride along its rows")


def _empty_out(like: torch.Tensor, n: int) -> torch.Tensor:
    return torch.empty((2, 2 * n), dtype=torch.float32, device=like.device)


def _launch(tail: torch.Tensor, cells: torch.Tensor, out: torch.Tensor,
            phase_taps: np.ndarray) -> torch.Tensor:
    """Run the kernel on checked CUDA rows: ``out [2, 2n]`` (contiguous)
    from ``tail [2, 49]`` and ``cells [2, n]``.  Returns ``out``."""
    global LAUNCHES
    n = cells.shape[1]
    if n == 0:
        return out
    _build.launch("fir_interp2_split_launch", cells.device,
                  tail.data_ptr(), tail.stride(0), cells.data_ptr(),
                  cells.stride(0), out.data_ptr(), out.stride(0), n,
                  phase_taps.ctypes.data_as(ctypes.c_void_p))
    LAUNCHES += 1
    return out
