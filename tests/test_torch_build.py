"""The port's kernel libraries are built and loaded once per process,
whichever threads ask for them together (the serving worker runs each
request on a thread of its own).  No compiler is needed: a stand-in
``nvcc`` writes its output file after a pause, and the load is faked."""

from __future__ import annotations

import stat
import sys
import threading

from scdna_replication_tools_tpu_torch.ops import _cuda


class _FakeFn:
    argtypes = None
    restype = None


class _FakeLib:
    def __init__(self, path):
        self.path = path
        self._fns = {}

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.__dict__["_fns"].setdefault(name, _FakeFn())


def _fake_nvcc(tmp_path):
    """A script that logs its call, waits, and writes the ``-o`` file."""
    calls = tmp_path / "calls.txt"
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        f"open({str(calls)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "time.sleep(0.3)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(b'stub')\n"
        "print('ptxas info: stub')\n")
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    return script, calls


def test_library_is_built_once_under_concurrent_first_use(
        tmp_path, monkeypatch):
    """Eight threads load both libraries at once from an empty build
    directory: one nvcc per library, every thread gets the same loaded
    library, no temporary file is left, and each compile event says
    ``miss`` once and ``hit`` after."""
    script, calls = _fake_nvcc(tmp_path)
    build_dir = tmp_path / "_build"
    monkeypatch.setattr(_cuda, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_cuda, "_nvcc", lambda: str(script))
    monkeypatch.setattr(_cuda, "_LIBS", {})
    monkeypatch.setattr(_cuda, "BUILD_INFO", {})
    monkeypatch.setattr(_cuda.ctypes, "CDLL", _FakeLib)

    got, errors = [], []
    start = threading.Barrier(8)

    def load(name):
        try:
            start.wait(timeout=30)
            got.append((name, _cuda.library(name)))
        except BaseException as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=load, args=(name,))
               for name in ("enum_fused", "adam") * 4]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert len(got) == 8
    for name in ("enum_fused", "adam"):
        libs = {id(lib) for n, lib in got if n == name}
        assert libs == {id(_cuda._LIBS[name])}
        assert _cuda.BUILD_INFO[name]["cache"] == "miss"
        assert _cuda.BUILD_INFO[name]["log"].startswith("ptxas info")
    lines = calls.read_text().splitlines()
    assert len(lines) == 2
    assert sorted(line.rsplit("/", 1)[1] for line in lines) == \
        ["adam.cu", "enum_fused.cu"]
    assert sorted(p.suffix for p in build_dir.iterdir()) == \
        [".log", ".log", ".so", ".so"]
    assert _cuda.load_event("adam")["cache"] == "hit"


def test_each_build_writes_a_temporary_file_of_its_own(
        tmp_path, monkeypatch):
    """Two builds of one source (here one after the other, as two
    processes sharing a build directory would start them) never name
    the same temporary output."""
    script, calls = _fake_nvcc(tmp_path)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_cuda, "_nvcc", lambda: str(script))
    monkeypatch.setattr(_cuda, "BUILD_INFO", {})
    _cuda.build(["adam"])
    (_cuda.BUILD_DIR / _cuda._target("adam").name).unlink()
    _cuda.build(["adam"])
    outs = [line.split(" -o ", 1)[1].split(" ", 1)[0]
            for line in calls.read_text().splitlines()]
    assert len(outs) == 2 and outs[0] != outs[1]
    assert all(o.endswith(".tmp") for o in outs)
