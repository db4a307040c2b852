#!/usr/bin/env python3
"""Where ``dvbt-rx``'s device memory peaks, stage by stage.

Run from the repository root on a machine with an NVIDIA GPU:
``python3 tools/dvbt_rx_pass_peaks.py``.  It modulates 24 flagship
superframes on the card, pins the working memory to
``chip_smoke.RX_SLOPE_WORKING_BYTES`` (the setting under which
``chip_smoke.py`` reads the receive memory's slope per superframe), and
decodes the first 12 and then all 24 superframes.  Each call of the front
end (one per group of superframes), of the Viterbi's ACS and traceback
(one each per pass) and of the RS decoder prints the bytes allocated above
the IQ when it starts and at its peak: a pass that starts higher than the
one before holds memory it no longer needs.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs                                   # noqa: E402
from dtv_utils_torch.ops import viterbi                   # noqa: E402
from dtv_utils_torch.rx import dvbt as rxd                # noqa: E402
from dtv_utils_torch.tx import dvbt as txd                # noqa: E402
from dtv_utils_torch.utils import device as udev          # noqa: E402

SUPERFRAMES = (12, 24)


def _hook(module, name: str, label: str, dev, log: list) -> None:
    """Wrap ``module.name`` to append (label, bytes allocated at its
    start, peak bytes during it) to ``log``."""
    fn = getattr(module, name)

    def run(*args, **kwargs):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        out = fn(*args, **kwargs)
        torch.cuda.synchronize(dev)
        log.append((label, before, torch.cuda.max_memory_allocated(dev)))
        return out

    setattr(module, name, run)


def main() -> int:
    if not torch.cuda.is_available():
        print("dvbt_rx_pass_peaks: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cfg = cs.dvbt_flagship()
    spf = cfg.samples_per_superframe
    ts = cs.seeded_ts(1, max(SUPERFRAMES) * cfg.ts_bytes_per_superframe)
    iq, _ = txd.modulate_stream(cfg, ts, device=dev)
    x = torch.from_numpy(iq).to(dev)
    del iq
    udev.working_bytes = lambda _dev: cs.RX_SLOPE_WORKING_BYTES
    log: list = []
    _hook(rxd, "_front_end", "front", dev, log)
    _hook(viterbi, "_acs", "acs", dev, log)
    _hook(viterbi, "_traceback", "traceback", dev, log)
    _hook(rxd, "decode_outer", "rs", dev, log)
    print(f"card: {cs.card_line(dev)}; working memory pinned to "
          f"{cs.RX_SLOPE_WORKING_BYTES / 1e9:g} GB")
    for n_sf in SUPERFRAMES:
        log.clear()
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
        rxd.demodulate_stream(cfg, x[:n_sf * spf], device=dev)
        print(f"{n_sf} superframes: {held / 1e9:.3f} GB held (the IQ)")
        for label, before, peak in log:
            print(f"  {label:10s} starts {(before - held) / 1e9:.3f} GB, "
                  f"peaks {(peak - held) / 1e9:.3f} GB above it")
    return 0


if __name__ == "__main__":
    sys.exit(main())
