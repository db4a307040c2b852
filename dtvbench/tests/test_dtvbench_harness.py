"""The harness on the CPU: every cell resolves its files by name, a cell
added as data runs with no edit to an existing file, the command fails
without a card rather than falling back, the result line has the
contract's keys, and a checkout without the program gives no result.
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

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
TWO_TRACED = {"calls": 2}
TINY = {"dvbt-tx-batched": {"traffic": {"blocks_per_call": 2,
                                        "pool_blocks": 4,
                                        "warmup_calls": 1},
                            "trace": TWO_TRACED},
        "dvbt-tx-stream": {"traffic": {"channels": 2,
                                       "pool_blocks_per_channel": 2,
                                       "warmup_calls_per_channel": 1},
                           "trace": TWO_TRACED},
        "dvbt-rx-20db": {"traffic": {"blocks_per_call": 1,
                                     "noise_draws": 1, "warmup_calls": 1},
                         "check": {"min_packets": 5281},
                         "trace": TWO_TRACED},
        "j83b-rx-27db": {"traffic": {"blocks_per_call": 1,
                                     "noise_draws": 1, "warmup_calls": 1},
                         "check": {"min_packets": 6115},
                         "trace": TWO_TRACED}}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_every_cell_has_a_tiny_rehearsal():
    assert sorted(TINY) == sorted(CELLS)


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
        assert (ROOT / c["file"]).is_file() and c["reduced"] == []
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
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
                       device="cpu", overrides=TINY["dvbt-tx-batched"])
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
