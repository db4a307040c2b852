"""Host boundary for IQ (port of ``rails_to_np``/``rails_from_np`` in
``dtv_utils_tpu/core/cplx.py``, and the receivers' input conversion).

On the device the modulator keeps IQ rail-major, ``[2, n]`` float32 (re
rail, im rail), the layout the FIR kernel reads and writes.  The host format
is complex64, which is byte-identical to the gr_complex ``.cfile`` format.
"""

from __future__ import annotations

import numpy as np
import torch


def rails_to_np(x: torch.Tensor) -> np.ndarray:
    """Rail-major float32 tensor [2, ...] on any device → host complex64 [...]."""
    if x.shape[0] != 2 or x.dtype != torch.float32:
        raise ValueError(f"need float32 rails [2, ...], got {x.dtype} "
                         f"{tuple(x.shape)}")
    return torch.complex(x[0], x[1]).cpu().numpy()


def rails_from_np(c: np.ndarray, *, device: torch.device | str) -> torch.Tensor:
    """Host complex array [...] → rail-major float32 tensor [2, ...] on
    ``device``."""
    c = np.ascontiguousarray(c, dtype=np.complex64)
    return torch.from_numpy(np.stack([c.real, c.imag])).to(device)


def iq_to_device(iq: np.ndarray | torch.Tensor, *,
                 device: torch.device | str) -> torch.Tensor:
    """complex64 IQ, a NumPy array or a tensor, → flat complex64 tensor on
    ``device`` (the receivers' input; no other dtype is accepted)."""
    if isinstance(iq, np.ndarray):
        if iq.dtype != np.complex64:
            raise TypeError(f"need complex64 IQ, got {iq.dtype}")
        iq = torch.from_numpy(np.ascontiguousarray(iq))
    if iq.dtype != torch.complex64:
        raise TypeError(f"need complex64 IQ, got {iq.dtype}")
    return iq.to(device).reshape(-1)
