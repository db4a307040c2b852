"""Build and invoke the native (C++) stream analyzers under ``native/``
(the port of ``dtv_utils_tpu/analysis/native.py``).

The analyzers (``xport``, ``flags264``, ``h264_parse``, ``l1dump``) are
sequential bit parsers: host code on any accelerator, so the port runs the
same C++ sources as the JAX package.  It builds them differently.  The JAX
package runs ``make`` in ``native/``, whose rule for ``atsc3_tables.inc``
imports the JAX package's tables; this module never runs that Makefile.  It
writes ``atsc3_tables.inc`` from the port's own ``rates/atsc3_tables.py``
(:func:`tables_inc`, byte for byte what ``native/gen_tables.py`` prints),
compiles each ``native/src/*.cpp`` with the Makefile's flags, and links one
binary per ``native/tools/*_main.cpp`` against those objects.

The compiler is ``$CXX``, else ``g++``.  The build lands in
``build/torch_native/<hash>/`` at the repository root, named by a hash of
the compiler, the flags, the sources and the generated tables: an edit
rebuilds, an unchanged tree reuses.  It is built at first use, in a
temporary directory that is renamed into place, so processes that build at
once never see half a build.  A failed build raises with the compiler's
output; nothing falls back to ``native/build/``.
"""

from __future__ import annotations

import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

from dtv_utils_torch.rates import atsc3_tables as T

ROOT = pathlib.Path(__file__).resolve().parents[2]
NATIVE_DIR = ROOT / "native"
BUILD_ROOT = ROOT / "build" / "torch_native"
CXXFLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra")


def _carray2(name, rows):
    body = ",\n  ".join("{" + ", ".join(str(v) for v in r) + "}" for r in rows)
    return (f"static const int {name}[{len(rows)}][{len(rows[0])}] = {{\n"
            f"  {body}\n}};\n")


def _carray3(name, cube):
    rows = []
    for plane in cube:
        inner = ", ".join("{" + ", ".join(str(v) for v in r) + "}"
                          for r in plane)
        rows.append("{" + inner + "}")
    body = ",\n  ".join(rows)
    d = (len(cube), len(cube[0]), len(cube[0][0]))
    return (f"static const int {name}[{d[0]}][{d[1]}][{d[2]}] = {{\n"
            f"  {body}\n}};\n")


def _cstrarray2(name, rows):
    body = ",\n  ".join(
        "{" + ", ".join(f'"{v}"' for v in r) + "}" for r in rows)
    return (f"static const char* {name}[{len(rows)}][{len(rows[0])}] = {{\n"
            f"  {body}\n}};\n")


def tables_inc() -> str:
    """``atsc3_tables.inc`` (C arrays for ``l1dump``) from the port's
    tables.  The emitters are those of ``native/gen_tables.py``, and so is
    the first line, so that the two files are byte-identical."""
    out = ["// generated by native/gen_tables.py -- do not edit\n"]
    out.append(_carray2("kPreambleCells", T.PREAMBLE_CELLS_TABLE))
    for k in ("8K", "16K", "32K"):
        out.append(_carray2(f"kDataCells{k}",
                            getattr(T, f"DATA_CELLS_TABLE_{k}")))
        out.append(_carray2(f"kSbsCells{k}",
                            getattr(T, f"SBS_CELLS_TABLE_{k}")))
        out.append(_carray3(f"kSbsDataCells{k}",
                            getattr(T, f"SBS_DATA_CELLS_TABLE_{k}")))
    out.append(_cstrarray2("kPilotBoostStr", T.PILOT_BOOST_STR))
    return "\n".join(out)


def _sources() -> tuple[list[pathlib.Path], list[pathlib.Path]]:
    """(library sources, tool mains), sorted."""
    return (sorted((NATIVE_DIR / "src").glob("*.cpp")),
            sorted((NATIVE_DIR / "tools").glob("*_main.cpp")))


def build_dir() -> pathlib.Path:
    """Where the tools for the current sources live (built or not)."""
    h = hashlib.sha256(" ".join((os.environ.get("CXX", "g++"),)
                                + CXXFLAGS).encode())
    h.update(tables_inc().encode())
    for sub in ("src", "include", "tools"):
        for path in sorted((NATIVE_DIR / sub).rglob("*")):
            if path.is_file():
                h.update(str(path.relative_to(NATIVE_DIR)).encode())
                h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> None:
    """Run the compiler commands at once; raise with the output of the
    first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [(c, p.communicate()[0], p.returncode)
            for c, p in zip(cmds, procs)]
    for cmd, out, rc in outs:
        if rc != 0:
            raise RuntimeError(f"native build failed ({rc}):\n"
                               f"{' '.join(cmd)}\n{out}")


def _build(dest: pathlib.Path) -> None:
    cxx = os.environ.get("CXX", "g++")
    srcs, mains = _sources()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix=f"{dest.name}.",
                                        dir=BUILD_ROOT))
    try:
        tmp.chmod(0o755)
        (tmp / "atsc3_tables.inc").write_text(tables_inc())
        inc = ["-I", str(NATIVE_DIR / "include"), "-I", str(tmp)]
        objs = [tmp / f"{s.stem}.o" for s in srcs]
        _run_all([[cxx, *CXXFLAGS, *inc, "-c", str(s), "-o", str(o)]
                  for s, o in zip(srcs, objs)])
        _run_all([[cxx, *CXXFLAGS, *inc, str(m), *map(str, objs),
                   "-o", str(tmp / m.name.removesuffix("_main.cpp"))]
                  for m in mains])
        try:
            os.replace(tmp, dest)
        except OSError:
            if not dest.is_dir():           # not another process's build
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@functools.cache
def ensure_built() -> pathlib.Path:
    """Build the tools once if their directory is missing; returns it."""
    dest = build_dir()
    if not dest.is_dir():
        _build(dest)
    return dest


def tool_path(name: str) -> pathlib.Path:
    path = ensure_built() / name
    if not path.exists():
        raise FileNotFoundError(f"native tool not built: {name}")
    return path


def run(name: str, args: list[str], **kwargs) -> subprocess.CompletedProcess:
    return subprocess.run([str(tool_path(name))] + args, **kwargs)


def cli(name: str, argv: list[str]) -> int:
    """CLI passthrough: stdout/stderr inherit the parent terminal."""
    try:
        proc = run(name, argv)
    except (RuntimeError, FileNotFoundError) as e:
        print(e, file=sys.stderr)
        return 255
    return proc.returncode & 0xFF
