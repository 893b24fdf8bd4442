"""How the port builds its compiled libraries, on the CPU: the CUDA kernels'
(``ops/_build.py``) and the native host library's (``native``).

* Two processes that need the same kernel library on a checkout with no
  build: the library is compiled once, under the file lock, and each
  process loads a complete file.  A fake ``nvcc`` (under ``CUDA_HOME``)
  writes a real shared library slowly, in chunks, so a process that loaded
  the file while it was written would fail.
* A library is stale, and rebuilt, when its stamp differs: other
  ``NVCC_FLAGS``, another ``nvcc --version``, or another header.
* The native library is rebuilt when its sidecar (g++ command, the host's
  CPU flags) differs from this host's.

None needs nvcc or a card; the compiler is g++ (as for the native library).
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from polymath_tpu_torch import native
from polymath_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAKE_NVCC = textwrap.dedent("""\
    #!{python}
    import os, sys, time
    here = os.path.dirname(os.path.abspath(__file__))
    if "--version" in sys.argv:
        print(open(os.path.join(here, "version.txt")).read())
        sys.exit(0)
    with open(os.path.join(here, "calls.txt"), "a") as f:
        f.write(" ".join(sys.argv[1:]) + "\\n")
    out = sys.argv[sys.argv.index("-o") + 1]
    data = open(os.path.join(here, "stub.so"), "rb").read()
    step = max(1, len(data) // 8)
    with open(out, "wb") as f:
        for i in range(0, len(data), step):
            f.write(data[i:i + step])
            f.flush()
            time.sleep(0.15)
    print("ptxas info    : Used 10 registers, 0 bytes spill stores, "
          "0 bytes spill loads")
    """)


@pytest.fixture
def fake_cuda(tmp_path, monkeypatch):
    """CUDA_HOME with a fake nvcc, and an empty build directory for
    ``_build`` (also given to subprocesses as tmp_path / "build")."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to make the fake nvcc's library")
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    src = tmp_path / "stub.cpp"
    src.write_text('extern "C" int pm_stub() { return 42; }\n')
    subprocess.run(["g++", "-shared", "-fPIC", "-o",
                    str(home / "bin" / "stub.so"), str(src)], check=True)
    (home / "bin" / "version.txt").write_text("nvcc fake, release 12.4\n")
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_nvcc_version", {})
    return home


def nvcc_calls(home) -> int:
    calls = home / "bin" / "calls.txt"
    return len(calls.read_text().splitlines()) if calls.exists() else 0


def test_two_processes_build_once_and_load_a_whole_library(fake_cuda,
                                                           tmp_path):
    script = textwrap.dedent(f"""\
        import sys
        sys.path.insert(0, {ROOT!r})
        from polymath_tpu_torch.ops import _build
        _build.BUILD = {str(tmp_path / "build")!r}
        _build.build_all(("field",))
        print(_build.lib("field").pm_stub())
        """)
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "42"
    assert nvcc_calls(fake_cuda) == 1
    # the library was compiled to a temporary name, then renamed
    assert f"{_build.library_path('field')} " not in \
        (fake_cuda / "bin" / "calls.txt").read_text()
    assert not _build._stale("field")
    assert [f for f in os.listdir(tmp_path / "build")
            if f.endswith(".tmp")] == []


def test_changed_flags_or_toolkit_make_a_library_stale(fake_cuda,
                                                       monkeypatch):
    _build.build_all(("field",))
    assert nvcc_calls(fake_cuda) == 1 and not _build._stale("field")
    with open(_build.stamp_path("field")) as f:
        made = json.load(f)
    assert made["command"][-3:] == [
        "-o", _build.library_path("field"),
        os.path.join(_build.CSRC, "field.cu")]
    assert made["nvcc_version"].startswith("nvcc fake, release 12.4")

    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-G"])
    assert _build._stale("field")
    assert set(_build.build_all(("field",))) == {"field"}
    assert nvcc_calls(fake_cuda) == 2 and not _build._stale("field")

    (fake_cuda / "bin" / "version.txt").write_text("nvcc fake, release 12.8\n")
    monkeypatch.setattr(_build, "_nvcc_version", {})
    assert _build._stale("field")
    _build.build_all(("field",))
    assert nvcc_calls(fake_cuda) == 3
    assert _build.build_all(("field",)) == {}      # fresh: nothing to do
    assert nvcc_calls(fake_cuda) == 3


def test_changed_header_makes_a_library_stale(fake_cuda, tmp_path,
                                              monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    _build.build_all(("field",))
    assert not _build._stale("field")
    with open(csrc / "g1.cuh", "a") as f:       # a header field.cu does
        f.write("\n")                           # not include: still stale
    assert _build._stale("field")
    os.remove(_build.report_path("field"))
    _build.build_all(("field",))
    assert nvcc_calls(fake_cuda) == 2 and not _build._stale("field")


@pytest.fixture
def fake_native(tmp_path, monkeypatch):
    """The native module pointed at a one-function source in tmp_path (the
    real sources take about 15 s to compile)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    src = tmp_path / "one.cpp"
    src.write_text('extern "C" int pm_one() { return 1; }\n')
    so = str(tmp_path / "libpolymath_native.so")
    monkeypatch.setattr(native, "_SO", so)
    monkeypatch.setattr(native, "_SIDECAR", so + ".build.json")
    monkeypatch.setattr(native, "_SOURCES", [str(src)])
    return so


def test_native_library_rebuilds_when_its_sidecar_differs(fake_native):
    assert native._build()
    first = os.stat(fake_native).st_ino
    with open(native._SIDECAR) as f:
        side = json.load(f)
    assert side == native._build_id()
    assert side["command"][:3] == ["g++", "-O3", "-march=native"]
    assert native._build() and os.stat(fake_native).st_ino == first

    side["cpu_flags"] = [f for f in side["cpu_flags"] if f != "avx2"] + [
        "another_cpu"]
    with open(native._SIDECAR, "w") as f:
        json.dump(side, f)
    assert native._build()
    second = os.stat(fake_native).st_ino
    assert second != first
    with open(native._SIDECAR) as f:
        assert json.load(f) == native._build_id()

    os.remove(native._SIDECAR)                  # a library of unknown origin
    assert native._build() and os.stat(fake_native).st_ino != second
