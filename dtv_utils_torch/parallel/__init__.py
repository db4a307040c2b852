"""Multi-block and multi-process execution: batched and sequence-sharded
modulation of the sample stream (stream) and the process group setup and
striped ingest (multihost).  Counterpart of ``dtv_utils_tpu/parallel``,
with the same exported names; ``make_mesh`` only returns the process group
the port's functions take anyway."""

from dtv_utils_torch.parallel import multihost, stream
from dtv_utils_torch.parallel.stream import (derive_state, make_mesh,
                                             sharded_dvbt_modulator)

__all__ = ["derive_state", "sharded_dvbt_modulator", "make_mesh",
           "multihost", "stream"]
