"""The harness on the CPU: every cell resolves its files by name and
holds its own test data, a cell added as data (of a standard the
benchmark has never had, too) runs with no edit to an existing file, the
command fails without a card rather than falling back, the result line
has the contract's keys, and a checkout without the program gives no
result.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from dtvbench import run
from dtvbench.tests import cells

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = cells.names()


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_has_a_tiny_rehearsal(name):
    """The cell's workload file holds its CPU rehearsal, whose sections
    and keys are the file's own, and its plants: at least one control."""
    w = cells.workload(name)
    assert w["rehearsal"]
    for section, values in w["rehearsal"].items():
        assert isinstance(w.get(section), dict), section
        assert set(values) <= set(w[section]), section
    assert w["faults"]
    assert any(p.startswith("control") for p in w["faults"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_its_files(name):
    cell = run.Cell.find(name)
    assert cell.cfg["name"] == cell.entry["config"]
    run.load(run.HERE / "standards" / f"{cell.cfg['standard']}.py")
    driver = run.load(run.HERE / "drivers" / f"{cell.workload['driver']}.py")
    assert callable(driver.run)
    for trace in (False, True):
        for _, reader in cell.readers(trace).values():
            assert callable(reader.value)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert cell.workload["why"] == cell.entry["why"]


def test_benchmark_json_keeps_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    every = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"])
    for x in every:
        assert NAME.match(x["name"]), x["name"]
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        for key in c["reduced"]:
            assert key in cfg and key in cfg["published"], key
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            moved = next(x for x in BENCH["end_to_end"]
                         if x["name"] == m["moves"])
            assert run.reports(moved, cell)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contract_keys(trace):
    line = run.execute("dvbt-tx-batched", 2**31 + 99, 0.2, trace,
                       device="cpu",
                       overrides=cells.rehearsal("dvbt-tx-batched"))
    want = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        want.append("breakdown")
    assert list(line) == want + ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(line["device"])
    assert json.loads(json.dumps(line)) == line
    if not trace:
        assert set(line["metrics"]) == {"tx_msps", "setup_s"}
        for m in line["metrics"].values():
            assert m["value"] > 0


def test_command_fails_without_a_card():
    r = subprocess.run(
        [sys.executable, "dtvbench/run.py", "--workload", "dvbt-tx-batched",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "no result" in r.stderr


def _copy(tmp_path: Path) -> Path:
    dst = tmp_path / "checkout"
    dst.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    shutil.copytree(ROOT / "dtvbench", dst / "dtvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def _in_copy(dst: Path, code: str, with_program: bool):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) if with_program else ""
    return subprocess.run([sys.executable, "-c", code], cwd=dst, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_cell_added_as_data_runs(tmp_path):
    """A new cell is a workload file and an entry in BENCHMARK.json: no
    file of dtvbench/ changes."""
    dst = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (dst / "dtvbench").rglob("*")
              if p.is_file()}
    w = json.loads((dst / "dtvbench/workloads/dvbt-tx-batched.json")
                   .read_text())
    w["why"] = "a second batched cell, 2 superframes per call"
    w["traffic"].update(blocks_per_call=2, pool_blocks=4, warmup_calls=1)
    (dst / "dtvbench/workloads/dvbt-tx-batched-2sf.json").write_text(
        json.dumps(w))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dvbt-tx-batched-2sf",
                               "config": w["config"], "traffic": "batched-2sf",
                               "chips": 1, "why": w["why"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "dvbt-tx-batched" in m.get("workloads", []):
            m["workloads"].append("dvbt-tx-batched-2sf")
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; sys.path.insert(0, '.'); "
            "from dtvbench import run; "
            "print(json.dumps(run.execute('dvbt-tx-batched-2sf', 7, 0.2, "
            "False, device='cpu')))")
    r = _in_copy(dst, code, with_program=True)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.splitlines()[-1])
    assert line["correct"] is True and set(line["metrics"]) == {
        "tx_msps", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data, p


def _pytest(dst: Path, *args: str):
    """pytest in the copy, on its own dtvbench/ and BENCHMARK.json, with
    the program from this checkout."""
    env = {**os.environ, "PYTHONPATH": str(ROOT),
           "PYTEST_DISABLE_PLUGIN_AUTOLOAD": "1"}
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:cacheprovider", *args],
        cwd=dst, env=env, capture_output=True, text=True, timeout=900)


def test_a_cell_of_a_new_standard_is_added_as_files(tmp_path):
    """A cell of a standard the benchmark has never had is new files (the
    standard's module, a configuration that names it, a workload file
    with its ``rehearsal`` and ``faults``) and entries appended to the
    lists of BENCHMARK.json: every per-cell test collects it, its
    rehearsal runs correct and a fault does not, and no file of
    dtvbench/ changes."""
    dst = _copy(tmp_path)
    d = dst / "dtvbench"
    before = {p: p.read_bytes() for p in d.rglob("*") if p.is_file()}
    new, like = "dvbtx-tx-batched", "dvbt-tx-batched"
    shutil.copy(d / "standards/dvbt.py", d / "standards/dvbtx.py")
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    conf = dict(bench["configs"][0], name="dvbtx-8k",
                file="dtvbench/configs/dvbtx-8k.json")
    cfg = json.loads((dst / bench["configs"][0]["file"]).read_text())
    cfg.update(name=conf["name"], standard="dvbtx")
    (dst / conf["file"]).write_text(json.dumps(cfg))
    w = json.loads((d / f"workloads/{like}.json").read_text())
    w["config"] = conf["name"]
    (d / f"workloads/{new}.json").write_text(json.dumps(w))
    bench["configs"].append(conf)
    bench["workloads"].append({"name": new, "config": conf["name"],
                               "traffic": "batched-8sf", "chips": 1,
                               "why": w["why"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(new)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))

    r = _pytest(dst, "--collect-only", "-q", "dtvbench/tests")
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    ids = [x for x in r.stdout.splitlines() if "::" in x]

    def per_cell(cell):
        param = re.compile(r"\[" + re.escape(cell) + r"[\]-]")
        return sorted(i.split("[")[0] for i in ids if param.search(i))

    tests = sorted({t for c in CELLS for t in per_cell(c)})
    assert "dtvbench/tests/test_dtvbench_control.py::" \
        "test_fault_fails_on_the_card" in tests
    assert per_cell(new) == per_cell(like)
    assert sorted(set(per_cell(new))) == tests

    control = "dtvbench/tests/test_dtvbench_control.py::"
    r = _pytest(dst, "-q",
                f"{control}test_program_passes_at_a_small_size[{new}]",
                f"{control}test_fault_fails_at_a_small_size[{new}-altered]")
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "2 passed" in r.stdout
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and dtvbench/ gives no
    result: the run cannot load the program."""
    dst = _copy(tmp_path)
    code = ("import sys; sys.path.insert(0, '.'); "
            "from dtvbench import run; "
            "run.execute('dvbt-tx-batched', 7, 0.2, False, device='cpu')")
    r = _in_copy(dst, code, with_program=False)
    assert r.returncode != 0
    assert "dtv_utils_torch" in r.stderr
    r = subprocess.run(
        [sys.executable, "dtvbench/run.py", "--workload", "dvbt-tx-batched",
         "--seed", "7", "--seconds", "1", "--trace", "0"], cwd=dst,
        env={**os.environ, "PYTHONPATH": ""}, capture_output=True,
        text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
