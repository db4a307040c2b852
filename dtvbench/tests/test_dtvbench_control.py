"""Each cell's comparison has to fail its control and the faults the cell
can have, and pass the program: a run with the timed path broken
underneath (the reference, or the stage whose precision the
configuration states, one precision lower in the program's place; a
receiver with cut soft decisions; a state left unchanged; half of a call
left out; one answer altered where it is produced) comes out
``correct`` false.

On the CPU at sizes a test run holds; with the ``gpu`` marker, on the
card at each cell's own size:

    python -m pytest dtvbench/tests -q                 # the CPU
    python -m pytest dtvbench/tests -q -m gpu          # on the card
"""

from __future__ import annotations

import pytest

from dtvbench import run
from dtvbench.tests.test_dtvbench_harness import TINY

FAULTS = {"dvbt-tx-batched": ["control", "state", "half", "altered"],
          "dvbt-tx-stream": ["control", "state", "half", "altered"],
          "dvbt-rx-20db": ["control-bfloat16", "control-hard", "half",
                           "altered"],
          "j83b-rx-27db": ["control-bfloat16", "half", "altered"]}
CASES = [(c, p) for c, ps in FAULTS.items() for p in ps]
SEED = 2**31 + 4242


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_program_passes_at_a_small_size(name):
    line = run.execute(name, SEED, 0.2, False, device="cpu",
                       overrides=TINY[name])
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("name,plant", CASES)
def test_fault_fails_at_a_small_size(name, plant):
    line = run.execute(name, SEED, 0.2, False, device="cpu", plant=plant,
                       overrides=TINY[name])
    assert line["correct"] is False, line["checks"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("name,plant", CASES)
def test_fault_fails_on_the_card(card, name, plant):
    line = run.execute(name, SEED + 1, 1.0, False, plant=plant)
    assert line["correct"] is False, line["checks"]
