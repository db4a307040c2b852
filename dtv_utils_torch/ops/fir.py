"""Polyphase interpolate-by-2 FIR: the J.83B RRC pulse shaper.

Port of ``dtv_utils_tpu/ops/fir.py``.  ``polyphase_interp2`` keeps the
reference's signature and layout: rail-major ``ext [2, 49 + n]`` (49 history
samples, then n cells) → phase-interleaved ``[2, 2n]`` with
``out[:, 2m+p] = Σ_j h_p[j]·ext[:, m+j]``, ``h_p = taps[p::2]`` reversed.

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
    outs = []
    for p in range(2):
        hp = torch.from_numpy(np.ascontiguousarray(taps[p::2][::-1])).to(
            ext_rows.device, torch.float32)
        y = F.conv1d(ext_rows[:, None, :], hp[None, None, :])   # [2, 1, L-49]
        outs.append(y[:, 0, :n])
    return torch.stack(outs, dim=-1).reshape(2, -1)   # [2, 2n] interleaved


def polyphase_interp2(ext_rows: torch.Tensor, taps: np.ndarray,
                      n: int) -> torch.Tensor:
    """ext_rows float32 [2, 49 + n'] with n' >= n (contiguous) → [2, 2n]."""
    taps = np.asarray(taps, dtype=np.float32)
    if ext_rows.dtype != torch.float32:
        raise TypeError(f"ext_rows must be float32, got {ext_rows.dtype}")
    if ext_rows.dim() != 2 or ext_rows.shape[0] != 2:
        raise ValueError(f"ext_rows must be rails [2, L], got "
                         f"{tuple(ext_rows.shape)}")
    if not ext_rows.is_contiguous():
        raise ValueError("ext_rows must be contiguous")
    if taps.shape != (NTAPS,):
        raise ValueError(f"need {NTAPS} taps, got {taps.shape}")
    if not 0 <= n <= ext_rows.shape[1] - HIST:
        raise ValueError(f"n={n} needs {HIST} + n <= {ext_rows.shape[1]} "
                         "input samples")
    if ext_rows.device.type == "cpu":
        return interp2_reference(ext_rows, taps, n)
    if ext_rows.device.type != "cuda":
        raise ValueError(f"unsupported device {ext_rows.device}")
    return _launch(ext_rows, _phase_taps(taps.tobytes()), n)


def _launch(ext_rows: torch.Tensor, phase_taps: np.ndarray,
            n: int) -> torch.Tensor:
    global LAUNCHES
    from dtv_utils_torch.ops import _build

    out = torch.empty((2, 2 * n), dtype=torch.float32, device=ext_rows.device)
    if n == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(ext_rows.device):
        stream = torch.cuda.current_stream(ext_rows.device).cuda_stream
        err = lib.fir_interp2_launch(
            ext_rows.data_ptr(), ext_rows.stride(0),
            out.data_ptr(), out.stride(0), n,
            phase_taps.ctypes.data_as(ctypes.c_void_p), stream)
    if err != 0:
        raise RuntimeError(f"fir_interp2 launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
