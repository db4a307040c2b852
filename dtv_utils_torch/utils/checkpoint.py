"""Stream-state checkpoint/resume (port of
``dtv_utils_tpu/utils/checkpoint.py``).

A chain's carry state is a small dataclass of tensors, so a long modulation
job saves it after a block and resumes mid-stream exactly.  The file format
is the reference's, magic string included: one ``.npz`` with a JSON
``__meta__`` entry and the fields as ``leaf0``, ``leaf1``, ... in dataclass
field order (the order ``jax.tree`` flattens a registered dataclass in), so
a state file written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

_MAGIC = "dtv_utils_tpu.state.v1"


def save_state(path: str, state, kind: str) -> None:
    """Write a chain-state dataclass of tensors to an .npz file."""
    names = [f.name for f in dataclasses.fields(state)]
    arrays = {f"leaf{i}": getattr(state, name).cpu().numpy()
              for i, name in enumerate(names)}
    meta = {
        "magic": _MAGIC,
        "kind": kind,
        "cls": type(state).__name__,
        "fields": names,
        "n_leaves": len(names),
    }
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def load_state(path: str, template, kind: str):
    """Rebuild a chain state from an .npz, validated against ``template``
    (a fresh ``init_state(cfg, device=...)``): shapes and dtypes must match
    the config, and the tensors land on the template's device."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        if meta.get("magic") != _MAGIC:
            raise ValueError(f"{path}: not a dtv_utils state file")
        if meta["kind"] != kind:
            raise ValueError(
                f"{path}: state kind {meta['kind']!r}, expected {kind!r}")
        if meta["cls"] != type(template).__name__:
            raise ValueError(
                f"{path}: state class {meta['cls']} != "
                f"{type(template).__name__}")
        names = [f.name for f in dataclasses.fields(template)]
        if meta["n_leaves"] != len(names):
            raise ValueError(f"{path}: leaf count mismatch")
        out = {}
        for i, name in enumerate(names):
            a = z[f"leaf{i}"]
            t = getattr(template, name)
            want = t.cpu().numpy()
            if a.shape != want.shape or a.dtype != want.dtype:
                raise ValueError(
                    f"{path}: leaf {i} is {a.dtype}{a.shape}, config "
                    f"expects {want.dtype}{want.shape}")
            out[name] = torch.from_numpy(a).to(t.device)
        return type(template)(**out)
