"""The port's native analyzers (``dtv_utils_torch/analysis/native.py``)
against the JAX package's build of the same C++ sources and the goldens.

The port builds ``native/`` without its Makefile: it writes
``atsc3_tables.inc`` from its own copy of the ATSC 3.0 tables and runs the
compiler itself.  Here the generated file must equal
``native/gen_tables.py``'s output byte for byte, every tool the port builds
must print what the JAX package's ``make`` build prints (stdout, stderr and
exit code, and for ``xport`` the demuxed files), and the CLI passthroughs
must behave alike.  Inputs come from the generators the JAX package's own
native tests use.
"""

import subprocess
import sys
from pathlib import Path

import pytest

import h264_gen
import l1_gen
import ts_gen
from dtv_utils_tpu.analysis import native as jnative
from dtv_utils_tpu.cli import main as jcli
from dtv_utils_torch.analysis import native as tnative
from dtv_utils_torch.cli import main as tcli
from test_native_h264 import STREAMS as H264_STREAMS
from test_native_xport import CASES as XPORT_CASES
from test_native_xport import run_in

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = Path(__file__).parent / "golden"


def test_tables_inc_matches_gen_tables():
    """The port's generated tables equal ``native/gen_tables.py``'s stdout
    (run here in a subprocess: the script imports the JAX package's tables,
    which the port may not)."""
    ref = subprocess.run([sys.executable, str(ROOT / "native" /
                                              "gen_tables.py")],
                         capture_output=True, check=True, cwd=ROOT).stdout
    assert tnative.tables_inc().encode() == ref


def _both(tmp_path, name, args, argv0=None):
    """(port, JAX) CompletedProcess of one tool on the same arguments, each
    run in its own empty directory; argv0 fixes the name the tool sees."""
    out = []
    for side, mod in (("port", tnative), ("jax", jnative)):
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        binary = mod.tool_path(name)
        out.append(subprocess.run([argv0 or str(binary), *args],
                                  executable=str(binary),
                                  capture_output=True, cwd=d))
    return out


def _same_run(ours, theirs):
    assert ours.returncode == theirs.returncode
    assert ours.stdout == theirs.stdout
    assert ours.stderr == theirs.stderr


@pytest.mark.parametrize("name", sorted(l1_gen.SCENARIOS))
def test_l1dump_matches(name, tmp_path):
    infile = tmp_path / f"{name}.b64"
    infile.write_bytes(l1_gen.SCENARIOS[name]())
    ours, theirs = _both(tmp_path, "l1dump", [str(infile)])
    _same_run(ours, theirs)
    assert ours.returncode == 0
    assert ours.stdout == (GOLDEN / f"l1dump_{name}.txt").read_bytes()


def _h264_cases():
    cases = [("flags264", s) for s in sorted(H264_STREAMS)]
    return cases + [("h264_parse", s)
                    for s in sorted([*H264_STREAMS, "extended"])]


@pytest.mark.parametrize("tool,stream", _h264_cases())
def test_h264_tools_match(tool, stream, tmp_path):
    es = (h264_gen.make_extended_stream() if stream == "extended"
          else h264_gen.make_stream(**H264_STREAMS[stream]))
    infile = tmp_path / f"{stream}.264"
    infile.write_bytes(es)
    # the same argv[0] for both, so h264_parse's version banner matches
    ours, theirs = _both(tmp_path, tool, [str(infile)], argv0=tool)
    _same_run(ours, theirs)
    assert ours.returncode == 0
    assert ours.stdout == (GOLDEN / f"{tool}_{stream}.txt").read_bytes()


@pytest.mark.parametrize("name", sorted(XPORT_CASES))
def test_xport_matches(name, tmp_path):
    """stdout and every demuxed file, against the JAX build and the
    golden."""
    kwargs, argt = XPORT_CASES[name]
    ts = tmp_path / "in.ts"
    ts.write_bytes(ts_gen.make_ts(**kwargs))
    args = [a.format(ts=ts) for a in argt]
    ours, our_files = run_in(tmp_path / "port", tnative.tool_path("xport"),
                             args)
    theirs, their_files = run_in(tmp_path / "jax",
                                 jnative.tool_path("xport"), args)
    _same_run(ours, theirs)
    assert ours.returncode == 0
    assert our_files == their_files
    assert ours.stdout == (GOLDEN / f"xport_{name}.txt").read_bytes()


@pytest.mark.parametrize("tool,args,rc,needle", [
    ("l1dump", [], 255, b"usage: l1dump"),
    ("l1dump", ["{bad}"], 255, b"Decode Failure"),
    ("flags264", [], 255, b"usage: flags264"),
    ("h264_parse", [], 1, b"usage: h264_parse"),
    ("h264_parse", ["-v"], None, b"mpeg4ip version 1.5.0.1"),
    ("xport", [], 255, b"xport Transport Stream Demuxer 1.1"),
])
def test_usage_matches(tool, args, rc, needle, tmp_path):
    bad = tmp_path / "bad.b64"
    bad.write_bytes(b"!!!not-base64!!!\n")
    args = [a.format(bad=bad) for a in args]
    ours, theirs = _both(tmp_path, tool, args, argv0=tool)
    _same_run(ours, theirs)
    if rc is not None:
        assert ours.returncode == rc
    assert needle in ours.stderr


@pytest.mark.parametrize("tool", ["flags264", "h264_parse", "l1dump",
                                  "xport"])
def test_cli_passthrough(tool, capfd):
    """``dtv <tool>`` with no arguments: the tool's usage and exit code,
    through the port's CLI as through the JAX CLI (h264_parse names its
    own path in its usage; each build's path is read as the tool's name)."""
    rc = tcli.main([tool])
    ours = capfd.readouterr()
    assert rc == jcli.main([tool])
    theirs = capfd.readouterr()
    assert rc in (1, 255)
    assert ours.out == theirs.out == ""
    assert ours.err.replace(str(tnative.tool_path(tool)), tool) == \
        theirs.err.replace(str(jnative.tool_path(tool)), tool)
    assert ours.err.startswith(("usage: ", "xport Transport Stream"))


def test_build_is_reused(monkeypatch):
    """The tools land in build/torch_native/<hash>/, and a second
    ensure_built() with an empty cache builds nothing."""
    d = tnative.ensure_built()
    assert d.parent == ROOT / "build" / "torch_native"
    assert d == tnative.build_dir()
    tools = sorted(p.name for p in d.iterdir() if not p.suffix)
    assert tools == ["flags264", "h264_parse", "l1dump", "xport"]
    stamps = {p.name: p.stat().st_mtime_ns for p in d.iterdir()}
    calls = []
    monkeypatch.setattr(tnative, "_build", calls.append)
    tnative.ensure_built.cache_clear()
    try:
        assert tnative.ensure_built() == d
    finally:
        tnative.ensure_built.cache_clear()
    assert calls == []
    assert stamps == {p.name: p.stat().st_mtime_ns for p in d.iterdir()}


def test_build_commands(tmp_path, monkeypatch):
    """One compile per native/src/*.cpp with the Makefile's flags, one link
    per native/tools/*_main.cpp against those objects, the generated
    tables beside them, and no make and no gen_tables.py.  The compiler is
    ``true``, so the commands are recorded and nothing is compiled."""
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CXX", "true")
    cmds = []
    real = subprocess.Popen

    def record(cmd, **kw):
        cmds.append(cmd)
        return real(cmd, **kw)

    monkeypatch.setattr(subprocess, "Popen", record)
    dest = tmp_path / "out"
    tnative._build(dest)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["out"]
    assert (dest / "atsc3_tables.inc").read_text() == tnative.tables_inc()
    srcs, mains = tnative._sources()
    assert len(srcs) == 4 and len(mains) == 4
    assert all(c[0] == "true" and list(tnative.CXXFLAGS) == c[1:5]
               for c in cmds)
    compiles = [c for c in cmds if "-c" in c]
    links = [c for c in cmds if "-c" not in c]
    assert sorted(c[c.index("-c") + 1] for c in compiles) == \
        sorted(map(str, srcs))
    objs = sorted(c[c.index("-o") + 1] for c in compiles)
    assert [sorted(a for a in c if a.endswith(".o")) for c in links] == \
        [objs] * len(mains)
    assert not any("make" in a or "gen_tables" in a for c in cmds for a in c)


def test_build_failure_raises(tmp_path, monkeypatch):
    """A compiler that fails: RuntimeError with its output, no build
    directory left behind, nothing cached."""
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CXX", "false")
    tnative.ensure_built.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="native build failed"):
            tnative.ensure_built()
    finally:
        tnative.ensure_built.cache_clear()
    assert list(tmp_path.iterdir()) == []
