"""Host boundary for IQ (port of ``rails_to_np``/``rails_from_np`` in
``dtv_utils_tpu/core/cplx.py``, and the receivers' input conversion).

On the device the modulator keeps IQ rail-major, ``[2, n]`` float32 (re
rail, im rail), the layout the FIR kernel reads and writes.  The host format
is complex64, which is byte-identical to the gr_complex ``.cfile`` format.
"""

from __future__ import annotations

import numpy as np
import torch

from dtv_utils_torch.utils import staging
from dtv_utils_torch.utils.trace import span


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


@span("dtv.stream.copy_in")
def iq_to_device(iq: np.ndarray | torch.Tensor, *,
                 device: torch.device | str) -> torch.Tensor:
    """complex64 IQ, a NumPy array or a tensor, → flat complex64 tensor on
    ``device`` (the receivers' input; no other dtype is accepted).

    Host IQ bound for a CUDA device goes through that device's pinned ring
    (``utils/staging.py``), read in place even where it is strided; when
    this returns every byte of it has been read.  An array of more than one
    dimension is flattened as ``reshape(-1)`` does."""
    device = torch.device(device)
    if isinstance(iq, np.ndarray):
        if iq.dtype != np.complex64:
            raise TypeError(f"need complex64 IQ, got {iq.dtype}")
        if device.type == "cuda":
            return staging.to_device(iq.reshape(-1), device)
        iq = torch.from_numpy(np.ascontiguousarray(iq))
    if iq.dtype != torch.complex64:
        raise TypeError(f"need complex64 IQ, got {iq.dtype}")
    if device.type == "cuda" and iq.device.type == "cpu":
        return staging.to_device(iq.numpy(force=True).reshape(-1), device)
    return iq.to(device).reshape(-1)
