"""``scan2cap_torch.kernels._build`` when processes build at once, with a
stand-in for nvcc (the CPU has none): the ranks of a mesh, spawned
together, each load the kernels at first use.

Four processes start the same build: one compiler runs, one library
appears with its whole log beside it, every process reads that log, and
no temporary file is left.  A compiler that fails leaves no temporary file
and no held lock: its error carries the log, and the next build runs.
"""

import json
import os
import stat
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINES = 40

COMPILER = """#!{python}
import os, sys, time
args = sys.argv[1:]
with open(os.environ["FAKE_NVCC_RUNS"], "a") as f:
    f.write(f"{{os.getpid()}}\\n")
for i in range({lines}):
    print(f"ptxas info    : line {{i}}", flush=True)
    time.sleep(0.005)
if os.environ.get("FAKE_NVCC_FAIL"):
    print("error: the stand-in fails", flush=True)
    sys.exit(1)
with open(args[args.index("-o") + 1], "wb") as f:
    f.write(b"library" * 1000)
print("done", flush=True)
"""

BUILD = """import json, sys
from scan2cap_torch.kernels import _build
_build.CSRC, _build.BUILD_DIR = sys.argv[1], sys.argv[2]
try:
    print(json.dumps(_build.build_all(["fake"])))
except RuntimeError as e:
    print(json.dumps({"error": str(e)}))
"""


@pytest.fixture
def tree(tmp_path):
    cuda = tmp_path / "cuda" / "bin"
    cuda.mkdir(parents=True)
    nvcc = cuda / "nvcc"
    nvcc.write_text(COMPILER.format(python=sys.executable, lines=LINES))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("// a source\n")
    runs = tmp_path / "runs.txt"
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"),
               FAKE_NVCC_RUNS=str(runs), PYTHONPATH=REPO)
    return dict(csrc=csrc, build=tmp_path / "_build", runs=runs, env=env)


def _build(tree, n, env=None):
    procs = [subprocess.Popen(
        [sys.executable, "-c", BUILD, str(tree["csrc"]), str(tree["build"])],
        env=env or tree["env"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in range(n)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


def test_four_processes_build_one_library(tree):
    outs = _build(tree, 4)
    assert len(tree["runs"].read_text().split()) == 1
    files = sorted(os.listdir(tree["build"]))
    assert len(files) == 3, files
    stem = files[0].rsplit(".", 1)[0]
    assert files == [stem + ".lock", stem + ".log", stem + ".so"]
    assert stem.startswith("fake-")
    assert (tree["build"] / (stem + ".so")).read_bytes() == b"library" * 1000
    log = (tree["build"] / (stem + ".log")).read_text()
    assert log.splitlines() == [f"ptxas info    : line {i}"
                                for i in range(LINES)] + ["done"]
    assert all(o == {"fake": log} for o in outs)
    # built: a later process starts no compiler
    _build(tree, 1)
    assert len(tree["runs"].read_text().split()) == 1


def test_a_failed_build_leaves_nothing_half_done(tree):
    fail = dict(tree["env"], FAKE_NVCC_FAIL="1")
    outs = _build(tree, 2, env=fail)
    for o in outs:
        assert "nvcc failed for csrc/fake.cu (rc=1)" in o["error"]
        assert "error: the stand-in fails" in o["error"]
    # each process found no library and tried once, one after the other
    assert len(tree["runs"].read_text().split()) == 2
    assert [f for f in os.listdir(tree["build"])
            if not f.endswith(".lock")] == []
    # the lock is free: the next build runs and succeeds
    outs = _build(tree, 1)
    assert "done" in outs[0]["fake"]
    assert len(tree["runs"].read_text().split()) == 3
