"""Bit pack/unpack on tensors, MSB first (port of ``dtv_utils_tpu/core/bits.py``).

Every dtype is stated: bytes↔bits stay uint8 end to end, words are int32.
"""

from __future__ import annotations

import functools

import torch


@functools.cache
def _shifts(width: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """[width-1, ..., 0] on ``device``, built once per (width, dtype, device)."""
    return torch.arange(width - 1, -1, -1, dtype=torch.int64).to(device, dtype)


def bytes_to_bits(x: torch.Tensor) -> torch.Tensor:
    """uint8 [..., n] → uint8 bits [..., n*8], MSB first."""
    b = (x.to(torch.uint8).unsqueeze(-1)
         >> _shifts(8, torch.uint8, x.device)) & 1
    return b.reshape(*x.shape[:-1], x.shape[-1] * 8)


def bits_to_bytes(b: torch.Tensor) -> torch.Tensor:
    """uint8 bits [..., n*8] → uint8 [..., n], MSB first."""
    n = b.shape[-1] // 8
    g = b.reshape(*b.shape[:-1], n, 8).to(torch.uint8)
    return (g << _shifts(8, torch.uint8, b.device)).sum(-1, dtype=torch.uint8)


def bits_to_words(b: torch.Tensor, width: int) -> torch.Tensor:
    """bits [..., n*width] → int32 words [..., n], MSB first per word."""
    n = b.shape[-1] // width
    g = b.reshape(*b.shape[:-1], n, width).to(torch.int32)
    return (g << _shifts(width, torch.int32, b.device)).sum(
        -1, dtype=torch.int32)


def words_to_bits(w: torch.Tensor, width: int) -> torch.Tensor:
    """int words [..., n] → uint8 bits [..., n*width], MSB first per word."""
    b = (w.unsqueeze(-1) >> _shifts(width, torch.int32, w.device)) & 1
    return b.reshape(*w.shape[:-1], w.shape[-1] * width).to(torch.uint8)
