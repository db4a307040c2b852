"""Reading a profiler session: device activities, their union, the host
ranges around them, and the breakdown the result line carries.

The interval arithmetic (``union_s``) is the one ``chip_smoke.py`` uses
(``_union_us``), kept here so that the yardstick does not move when the
program moves.
"""

from __future__ import annotations

import collections
import json
import tempfile
from dataclasses import dataclass
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "dtvbench.window"
NAME_CHARS = 120        # a kernel's name is cut to this in the breakdown


def union_s(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


@dataclass
class Summary:
    """One traced window: its span on the profiler's clock (µs), the
    device activities inside it, the host events, and the calls made."""
    start: float
    end: float
    calls: int
    acts: list[dict]
    host: list[dict]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def clipped(self, cats=DEVICE_CATS) -> list[tuple[float, float]]:
        return [(max(e["ts"], self.start), min(e["ts"] + e["dur"], self.end))
                for e in self.acts if e.get("cat") in cats
                and e["ts"] < self.end and e["ts"] + e["dur"] > self.start]

    def busy_s(self, cats=DEVICE_CATS) -> float:
        return union_s(self.clipped(cats)) / 1e6

    def total_s(self, cat: str) -> float:
        return sum(e["dur"] for e in self.acts if e.get("cat") == cat) / 1e6

    def count(self, cat: str) -> int:
        return sum(1 for e in self.acts if e.get("cat") == cat)

    def in_ranges(self, names: tuple[str, ...]) -> list[dict]:
        """Device activities launched from inside a host range of one of
        ``names`` (a ``record_function`` of the program), matched through
        the runtime call that launched them."""
        ranges = [(e["ts"], e["ts"] + e["dur"], e.get("tid"))
                  for e in self.host if e.get("name") in names]
        corr = set()
        for e in self.host:
            if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
                continue
            t = e["ts"]
            if any(a <= t <= b and tid == e.get("tid") for a, b, tid in ranges):
                corr.add(e.get("args", {}).get("correlation"))
        corr.discard(None)
        return [e for e in self.acts
                if e.get("args", {}).get("correlation") in corr]

    def breakdown(self) -> dict:
        """The device operations that took most time and the longest idle
        gaps, each named by the innermost host event running at the gap's
        middle; at most 10 of each, in seconds."""
        by_name: dict[str, float] = collections.defaultdict(float)
        for e in self.acts:
            by_name[e["name"]] += e["dur"] / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        busy = sorted(self.clipped())
        gaps, end = [], self.start
        for a, b in busy:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.end > end:
            gaps.append((end, self.end))
        named = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
            mid = (a + b) / 2
            around = [e for e in self.host if e.get("name") != WINDOW
                      and not e.get("name", "").startswith("PyTorch Profiler")
                      and e["ts"] <= mid <= e["ts"] + e.get("dur", 0)]
            name = min(around, key=lambda e: e.get("dur", 0))["name"] \
                if around else "host (no op)"
            named.append([name, (b - a) / 1e6])
        return {"device_ops": [[k[:NAME_CHARS], v] for k, v in ops],
                "idle_gaps": [[k[:NAME_CHARS], v] for k, v in named]}


def summarize(prof, calls: int) -> Summary:
    """Read a finished ``torch.profiler`` session whose profiled calls ran
    inside one ``record_function(WINDOW)``."""
    with tempfile.TemporaryDirectory() as d:
        path = Path(d, "trace.json")
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    windows = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") in ("user_annotation", "cpu_op")]
    if not windows:
        raise RuntimeError("the trace holds no dtvbench.window range")
    w = max(windows, key=lambda e: e["dur"])
    start, end = w["ts"], w["ts"] + w["dur"]
    acts = [e for e in events if e.get("cat") in DEVICE_CATS
            and e["ts"] < end and e["ts"] + e.get("dur", 0) > start]
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") not in DEVICE_CATS
            and e.get("cat") not in ("gpu_user_annotation",)
            and e["ts"] < end and e["ts"] + e.get("dur", 0) > start]
    return Summary(start=start, end=end, calls=calls, acts=acts, host=host)
