"""Structured metric lines — a copy of ``dtv_utils_tpu/utils/metrics.py``.

Every metric goes to a JSON-lines sink (stdout by default) and, unless
suppressed, a human line on stderr.  Copied rather than imported because
importing ``dtv_utils_tpu`` imports JAX.
"""

from __future__ import annotations

import json
import sys
import time
import typing
from dataclasses import dataclass, field


@dataclass
class Metrics:
    """Emit {"metric": name, "value": v, "unit": u, ...} JSON lines."""
    json_out: typing.TextIO = field(default_factory=lambda: sys.stdout)
    human_out: typing.TextIO = field(default_factory=lambda: sys.stderr)
    suppress_human: bool = False
    _t0: float = field(default_factory=time.perf_counter)

    def emit(self, metric: str, value, unit: str = "", **extra) -> None:
        rec = {"metric": metric, "value": value}
        if unit:
            rec["unit"] = unit
        rec.update(extra)
        print(json.dumps(rec), file=self.json_out, flush=True)
        if not self.suppress_human:
            tail = " ".join(f"{k}={v}" for k, v in extra.items())
            print(f"[{time.perf_counter() - self._t0:8.3f}s] "
                  f"{metric} = {value} {unit} {tail}".rstrip(),
                  file=self.human_out)
