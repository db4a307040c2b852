"""Each cell's test data, read from its workload file: ``rehearsal``
(sections of the file, each a dict merged into it, for a run at a size a
CPU test holds; ``run.execute``'s ``overrides``) and ``faults`` (the
control and fault plants that its comparison has to fail).  The drivers
read neither.  The per-cell tests parametrize over the cells that
``BENCHMARK.json`` names, so a cell added as new files is tested with no
edit to a test.
"""

from __future__ import annotations

import json

from dtvbench import run


def names() -> list[str]:
    """The cells of ``BENCHMARK.json``, in its order."""
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]


def workload(name: str) -> dict:
    return run.Cell.find(name).workload


def rehearsal(name: str) -> dict:
    return workload(name)["rehearsal"]


def fault_cases() -> list[tuple[str, str]]:
    """(cell, plant) for every plant of every cell; a cell without
    ``faults`` has none here, and fails its own data test."""
    return [(c, p) for c in names() for p in workload(c).get("faults", [])]
