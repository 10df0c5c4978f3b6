"""The kernel build of geomesa_tpu_torch, with a stand-in compiler.

``kernels/_build.py`` compiles ``csrc/*.cu`` with nvcc; these tests swap
nvcc for a small script that writes its ``-o`` file slowly and logs each
call, so the staleness check, the cross-process lock and the atomic rename
run here without a CUDA toolkit.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from geomesa_tpu_torch.kernels import _build

REPO = Path(__file__).resolve().parent.parent

FAKE_NVCC = """#!{python}
import sys, time
from pathlib import Path
args = sys.argv[1:]
with open(Path(__file__).parent / "calls", "a") as f:
    f.write(" ".join(args) + "\\n")
if Path(args[-1]).read_text().startswith("broken"):
    print("error: broken source")
    sys.exit(2)
with open(args[args.index("-o") + 1], "wb") as f:
    for _ in range(10):
        f.write(b"\\0" * 1000)
        f.flush()
        time.sleep({pause})
"""

DRIVER = """
import sys
from pathlib import Path
from geomesa_tpu_torch.kernels import _build
root = Path(sys.argv[1])
_build.CSRC, _build.BUILD_DIR = root / "csrc", root / "build"
_build.nvcc = lambda: str(root / "nvcc")
print(sorted(_build.build(["k"])))
"""


def _toolchain(root: Path, pause: float, source: str = "kernel") -> None:
    (root / "csrc").mkdir()
    (root / "csrc" / "k.cu").write_text(source)
    nvcc = root / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, pause=pause))
    nvcc.chmod(0o755)


def _calls(root: Path) -> int:
    calls = root / "calls"
    return len(calls.read_text().splitlines()) if calls.exists() else 0


@pytest.fixture
def fake(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: str(tmp_path / "nvcc"))
    return tmp_path


def test_two_processes_compile_once(tmp_path):
    """Both find the library missing at the same moment; the lock makes the
    second wait and then find it up to date, whole."""
    _toolchain(tmp_path, pause=0.15)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen([sys.executable, "-c", DRIVER, str(tmp_path)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert sorted(o.strip().splitlines()[-1] for o in outs) == ["['k']", "[]"]
    assert _calls(tmp_path) == 1
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [".lock", "libk.so"]
    assert (tmp_path / "build" / "libk.so").stat().st_size == 10_000


def test_rebuilds_only_a_stale_library(fake):
    _toolchain(fake, pause=0.0)
    assert list(_build.build(["k"])) == ["k"]
    assert _build.build(["k"]) == {}
    assert _calls(fake) == 1
    src = fake / "csrc" / "k.cu"
    later = (fake / "build" / "libk.so").stat().st_mtime + 10
    os.utime(src, (later, later))
    assert list(_build.build(["k"])) == ["k"]
    assert _calls(fake) == 2
    # the compiler wrote a temporary file, renamed onto the library
    out = (fake / "calls").read_text().splitlines()[-1].split()
    assert Path(out[out.index("-o") + 1]).name == f".libk.{os.getpid()}.so"


def test_failed_build_raises_and_leaves_no_library(fake):
    _toolchain(fake, pause=0.0, source="broken")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="broken source"):
        _build.build(["k"])
    assert time.perf_counter() - t0 < 60
    assert sorted(p.name for p in (fake / "build").iterdir()) == [".lock"]
