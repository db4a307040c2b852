"""Run one cell of the benchmark once and print its result line.

    python3 dtvbench/run.py --workload NAME --seed N --seconds S --trace 0|1

(or ``python3 -m dtvbench.run ...``) from the root of a checkout.  The
cell is found by name in ``BENCHMARK.json``; everything else by the names
it gives: the cell's file ``dtvbench/workloads/<cell>.json`` (its driver,
traffic and limits), the configuration's file, the standard's module
``dtvbench/standards/<standard>.py``, the driver
``dtvbench/drivers/<driver>.py`` and one reader per metric,
``dtvbench/metrics/<name>.py`` for the end-to-end metrics of a
``--trace 0`` run and ``dtvbench/layer_metrics/<name>.py`` for the
per-layer metrics of a ``--trace 1`` run.  A reader that finds nothing to
read returns None, and its metric is left out of the line.

A run needs a CUDA card for each chip the cell asks for; without them it
exits with 2 and prints no result.  It also exits without a result (3)
if, once the window has closed, a module of JAX or of the JAX package is
loaded.  The last lines on standard error, and the last key of the result
line, give each number compared with its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "dtv_utils_tpu")


MALLOPT = {"M_MMAP_THRESHOLD": -3, "M_TRIM_THRESHOLD": -1}


def host_malloc(cfg: dict) -> None:
    """Set the host allocator as the configuration's deployment states
    (``host_malloc``: glibc ``mallopt`` parameters by name); a
    configuration without the key runs on glibc's own heuristics."""
    params = {k: v for k, v in cfg.get("host_malloc", {}).items()
              if k in MALLOPT}
    if not params:
        return
    libc = ctypes.CDLL("libc.so.6")
    for k, v in params.items():
        if not libc.mallopt(MALLOPT[k], int(v)):
            raise OSError(f"mallopt({k}, {v}) failed")


class NoCard(RuntimeError):
    """The cell's chips are not there."""


def load(path: Path):
    """Import the Python file ``path`` (its name may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    name = "dtvbench._loaded." + path.relative_to(HERE).with_suffix(
        "").as_posix().replace("/", ".")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with the files it names."""
    name: str
    entry: dict
    workload: dict
    cfg: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @classmethod
    def find(cls, name: str) -> "Cell":
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        entry = next((w for w in bench["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        conf = next(c for c in bench["configs"]
                    if c["name"] == entry["config"])
        workload = json.loads((HERE / "workloads" / f"{name}.json")
                              .read_text())
        if workload["config"] != entry["config"]:
            raise ValueError(f"{name}.json names config "
                             f"{workload['config']!r}, BENCHMARK.json "
                             f"{entry['config']!r}")
        cfg = json.loads((ROOT / conf["file"]).read_text())
        return cls(name, entry, workload, cfg,
                   [m for m in bench["end_to_end"] if reports(m, name)],
                   [m for m in bench["per_layer"] if reports(m, name)])

    def readers(self, trace: bool) -> dict:
        folder, metrics = (("layer_metrics", self.per_layer) if trace
                           else ("metrics", self.end_to_end))
        return {m["name"]: (m["unit"], load(HERE / folder / f"{m['name']}.py"))
                for m in metrics}


@dataclass
class Context:
    """What a driver gets: the cell's files, the standard's module, the
    seed, the window's length, the device, the traced calls, and (for the
    control and fault runs of ``readings.py`` and the tests, never for the
    benchmark's own runs) a plant."""
    cell: Cell
    std: object
    seed: int
    seconds: float
    device: object
    trace_args: dict = field(default_factory=dict)
    plant: str | None = None
    t_start: float = T_START

    def mark(self, phase: str) -> None:
        """Log how far set-up has come, in s since the process started."""
        print(f"setup {phase}: {time.perf_counter() - self.t_start:.3f} s",
              file=sys.stderr, flush=True)

    @property
    def workload(self) -> dict:
        return self.cell.workload

    @property
    def cfg(self) -> dict:
        return self.cell.cfg

    def memory_peak(self) -> int:
        import torch
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def release_program(self) -> None:
        """Free what the program holds on the card, before the check."""
        import gc

        import torch
        gc.collect()
        if self.device.type == "cuda":
            from dtv_utils_torch.utils import graph
            graph.release(self.device)
            torch.cuda.empty_cache()


@dataclass
class Run:
    """A finished run, as the metric readers see it."""
    outcome: object
    setup_s: float
    kind: str

    @property
    def record(self):
        return self.outcome.record

    @property
    def summary(self):
        return self.outcome.record.summary


def device_for(cell: Cell, device=None):
    """The card the cell runs on; ``device`` (the tests' CPU) skips the
    look for one."""
    import torch
    if device is not None:
        return torch.device(device)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, "
                     f"{torch.cuda.device_count()} found")
    return torch.device("cuda", 0)


def execute(name: str, seed: int, seconds: float, trace: bool, *,
            device=None, plant: str | None = None,
            overrides: dict | None = None, t_start: float = T_START,
            info: dict | None = None) -> dict:
    """One run of cell ``name``: its result line as a dict.  ``device``,
    ``plant``, ``overrides`` (sections of the workload's file, each a
    dict merged into it) and ``info`` (a dict that takes the driver's
    readings beside the check) are for the tests and ``readings.py``."""
    import torch
    cell = Cell.find(name)
    host_malloc(cell.cfg)
    dev = device_for(cell, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for section, values in (overrides or {}).items():
        cell.workload[section].update(values)
    tw = cell.workload["trace"]
    trace_args = ({"trace_calls": tw["calls"],
                   "trace_after_s": min(tw["after_s"], seconds / 4)}
                  if trace else {})
    std = load(HERE / "standards" / f"{cell.cfg['standard']}.py")
    driver = load(HERE / "drivers" / f"{cell.workload['driver']}.py")
    ctx = Context(cell, std, seed, seconds, dev, trace_args, plant, t_start)
    ctx.mark("imports")
    out = driver.run(ctx)
    _log_window(out.record)
    for k, v in out.info.items():
        print(f"reading {k}: {v}", file=sys.stderr, flush=True)
    if info is not None:
        info.update(out.info)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    run = Run(out, out.record.t0 - t_start, kind)
    metrics = {}
    for mname, (unit, reader) in cell.readers(trace).items():
        v = reader.value(run)
        if v is not None:
            metrics[mname] = {"value": v, "unit": unit}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                "kind": kind, "count": cell.entry["chips"],
                "memory_peak_bytes": out.memory_peak_bytes}
    if dev.type == "cuda":
        dev_info["power_limit"] = _power_limit(dev)
    line = {"correct": all(v <= lim for v, lim in out.checks.values()),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dev_info}
    if trace and run.summary is not None:
        dev_info["busy_s"] = run.summary.busy_s()
        dev_info["window_s"] = run.summary.window_s
        line["breakdown"] = run.summary.breakdown()
    line["checks"] = {k: {"value": _num(v), "limit": lim}
                      for k, (v, lim) in out.checks.items()}
    return line


def _log_window(rec) -> None:
    """The window's calls and the spread of their host spans, in ms."""
    spans = sorted(rec.unprofiled_spans())
    if spans:
        q = [spans[min(int(f * len(spans)), len(spans) - 1)] * 1e3
             for f in (0.05, 0.5, 0.95, 0.99)]
        slow = sorted(range(len(rec.spans)), key=lambda i: -rec.spans[i])[:3]
        print(f"window: {rec.calls} calls in {rec.seconds:.3f} s; call ms "
              f"p5 {q[0]:.3f} p50 {q[1]:.3f} p95 {q[2]:.3f} p99 {q[3]:.3f} "
              f"max {spans[-1] * 1e3:.3f}; slowest calls "
              + ", ".join(f"{i}: {rec.spans[i] * 1e3:.1f}" for i in slow),
              file=sys.stderr, flush=True)


def _num(v: float):
    return v if math.isfinite(v) else str(v)


def _power_limit(dev) -> str:
    """The card's power limit as nvidia-smi reports it: a card may be set
    below its maximum, and then runs slower."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.splitlines()
        return out[dev.index].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        line = execute(a.workload, a.seed, a.seconds, bool(a.trace))
    except NoCard as e:
        print(f"dtvbench: {e}: no result", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"dtvbench: loaded {', '.join(found)}: no result",
              file=sys.stderr)
        return 3
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
