"""The port's scaling harness (dtv_utils_torch/scaling_bench.py) on the CPU:
gloo rows at worlds 1 and 2 (each rank a process, pinned to its core), the
card's rows refused without a card, and worlds beyond the machine's cards
reported on stderr with no row."""

import json

import pytest
import torch

from dtv_utils_torch import scaling_bench as sb
from dtv_utils_torch.utils import device as udev


def _rows(text: str) -> list[dict]:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_cpu_gloo_rows(capsys):
    returned = sb.cpu_rows([1, 2])
    rows = _rows(capsys.readouterr().out)
    assert rows == returned
    assert [r["world"] for r in rows] == [1, 2]
    for r in rows:
        assert r["hardware"] == "cpu-gloo"
        assert r["cores"] == min(r["world"], r["host_cores"])
        assert r["msps"] > 0
        assert r["blocks_per_rank"] == sb.BLOCKS_PER_RANK
    assert rows[0]["efficiency_per_core"] == 1.0
    assert rows[1]["efficiency_per_core"] > 0


def test_gpu_without_card_fails_with_no_row(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="is_available"):
        sb.main(["--gpu", "--worlds", "1"])
    assert _rows(capsys.readouterr().out) == []


def test_gpu_rows_only_for_cards_present(monkeypatch, capsys):
    """On a one-card machine world 1 gets a row and worlds 2 and 4 one
    stderr line each (the card and the ranks stubbed: no process runs)."""
    monkeypatch.setattr(udev, "resolve_device", lambda d: torch.device(d))
    monkeypatch.setattr(udev, "card_line", lambda d: "Card X, 700.00 W")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "Card X")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    measured = []
    monkeypatch.setattr(sb, "_measure",
                        lambda n, kind: measured.append((n, kind)) or 123.0)
    sb.gpu_rows([1, 2, 4])
    out, err = capsys.readouterr()
    (row,) = _rows(out)
    assert measured == [(1, "cuda")]
    assert row["hardware"] == "gpu" and row["world"] == 1
    assert row["device_kind"] == "Card X"
    assert row["power_limit"] == "700.00 W"
    assert (row["rounds"], row["warmup"]) == (10, 2)
    assert "world 2 needs 2 cards" in err and "world 4 needs 4 cards" in err
