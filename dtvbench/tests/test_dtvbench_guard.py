"""What a run loads: after a CPU rehearsal of each driver no module of
JAX or of the JAX package is loaded, and the reference loads nothing of
the program.  Each check runs in a fresh interpreter, so that what this
test process loaded does not count."""

from __future__ import annotations

import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

from dtvbench.tests import cells

ROOT = Path(__file__).resolve().parents[2]


def _fresh(code: str) -> str:
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.splitlines()[-1]


@pytest.mark.parametrize("name", sorted(cells.names()))
def test_rehearsal_loads_no_jax(name):
    code = ("import json, sys; from dtvbench import run; "
            f"line = run.execute({name!r}, 2**31 + 3, 0.2, True, "
            f"device='cpu', overrides={cells.rehearsal(name)!r}); "
            "print(json.dumps([line['correct'], run.forbidden_modules(), "
            "sorted({m.split('.')[0] for m in sys.modules})]))")
    correct, found, top = json.loads(_fresh(code))
    assert correct is True
    assert found == []
    assert not {"jax", "jaxlib", "flax", "dtv_utils_tpu"} & set(top)
    assert "dtv_utils_torch" in top


def test_reference_loads_nothing_of_the_program():
    mods = [p.stem for p in (ROOT / "dtvbench/reference").glob("*.py")
            if p.stem != "__init__"]
    code = ("import json, sys; "
            + "; ".join(f"import dtvbench.reference.{m}" for m in mods)
            + "; print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    top = set(json.loads(_fresh(code)))
    assert "dtvbench" in top
    assert not {"dtv_utils_torch", "jax", "jaxlib", "flax",
                "dtv_utils_tpu"} & top


def test_forbidden_names_are_compared_whole():
    """A module counts by its whole top-level name: ``jax.x`` is JAX,
    ``jaxtyping`` and ``dtv_utils_tpux`` are not."""
    from dtvbench import run
    names = ["jaxtyping_fake", "dtv_utils_tpux", "jax.fake_sub"]
    saved = {n: sys.modules.get(n) for n in names}
    try:
        for n in names[:2]:
            sys.modules[n] = types.ModuleType(n)
        assert "dtv_utils_tpu" not in run.forbidden_modules()
        sys.modules[names[2]] = types.ModuleType(names[2])
        assert "jax" in run.forbidden_modules()
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m
