"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a``, all
started together in a temporary directory, and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``.  No
PyTorch header is included, so the build takes seconds rather than
minutes.  The library lands in ``build/torch_kernels/`` at the repository
root, named by a hash of the sources and flags: an edit to a source
rebuilds it, an unchanged tree reuses it.  ``-Xptxas -v`` makes ptxas
report each kernel's registers, shared memory and spills; that report,
with each ``nvcc``'s seconds, is kept beside the library (``build_log``).
Nothing here runs at import time; the first CUDA call builds.

Every kernel launch goes through ``launch``, which counts it in
``LAUNCHES``: the one counter of the port's kernels, which the tests and
``chip_smoke.py`` read and ``utils/graph`` adds a graph replay's launches
to.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_vp, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_LAUNCHERS = {
    # kernel: (its C launcher, the launcher's arguments, the stream last)
    "fir_interp2": ("fir_interp2_split_launch",
                    [_vp, _ll, _vp, _ll, _vp, _ll, _ll, _vp, _vp]),
    "viterbi_acs": ("viterbi_acs_launch",
                    [_i, _vp, _ll, _ll, _i, _i, _vp, _vp, _vp]),
    "viterbi_traceback": ("viterbi_traceback_launch",
                          [_i, _vp, _vp, _ll, _ll, _vp, _vp]),
    "ldpc_check": ("ldpc_check_launch", [_vp] * 6 + [_ll] * 5 + [_vp]),
    "ldpc_variable": ("ldpc_variable_launch",
                      [_vp] * 5 + [_ll] * 5 + [_vp, _vp]),
}

LAUNCHES = dict.fromkeys(_LAUNCHERS, 0)
"""Launches per kernel: ``launch`` adds one where it launches a kernel,
and nowhere else."""


def _nvcc() -> str:
    """nvcc from CUDA_HOME, then PATH, then the toolkit's default prefix."""
    candidates = [Path(os.environ[v]) / "bin" / "nvcc"
                  for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $CUDA_PATH/bin, PATH and "
        "/usr/local/cuda/bin): dtv_utils_torch compiles its CUDA kernels "
        "from dtv_utils_torch/csrc at first use and needs the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdtv_torch_kernels_{h.hexdigest()[:16]}.so"


def build_log() -> str:
    """nvcc's output for the current library (ptxas's resource report), or
    '' if it has not been built."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _nvcc_run(cmd: list[str]) -> str:
    """Run one nvcc command and return its output, led by the file it
    made and the seconds it took; raise if it fails."""
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    made = Path(cmd[cmd.index("-o") + 1]).name
    return (f"nvcc -o {made}: {time.perf_counter() - t0:.2f} s\n"
            f"{res.stdout}{res.stderr}")


@functools.cache
def library() -> ctypes.CDLL:
    """Build the kernels if their library is missing, load it, declare the
    C signatures."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc, srcs = _nvcc(), sorted(CSRC.glob("*.cu"))
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [f"{tmp}/{src.stem}.o" for src in srcs]
            with ThreadPoolExecutor(len(srcs)) as pool:
                log = "".join(pool.map(_nvcc_run, (
                    [nvcc, *NVCC_FLAGS, "-c", "-o", o, str(src)]
                    for src, o in zip(srcs, objs))))
            lib_tmp = f"{tmp}/{out.name}"
            log += _nvcc_run([nvcc, *NVCC_FLAGS, "-o", lib_tmp, *objs])
            out.with_suffix(".log").write_text(log)
            os.replace(lib_tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, args in _LAUNCHERS.values():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def on_card(x: torch.Tensor) -> bool:
    """The route of a kernel wrapper: True for a CUDA tensor (launch the
    kernel), False for a CPU one (take the plain version); any other
    device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


def launch(kernel: str, device, *args) -> None:
    """Launch ``kernel`` (a key of ``LAUNCHES``): call its C launcher with
    ``args`` and the current stream of ``device`` (a CUDA
    ``torch.device``) as the last argument, raise if it returns a CUDA
    error, else count the launch.  The build happens at the first call."""
    name = _LAUNCHERS[kernel][0]
    fn = getattr(library(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")
    LAUNCHES[kernel] += 1
