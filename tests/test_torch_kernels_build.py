"""The kernel library's build: one ``nvcc`` per CUDA source, all started
together, then one link into the shared library.

The CUDA toolkit is not on the test machine, so a stand-in ``nvcc`` records
its arguments and the times it ran, and writes the file it is asked for.
"""

import json
import sys

import pytest
import torch

from imitation_tpu_torch.ops import kernels

torch.set_num_threads(1)

FAKE_NVCC = """#!{python}
import json, sys, time
args = sys.argv[1:]
start = time.time()
if "-c" in args:
    time.sleep({sleep})
if "{fail}" and any(a.endswith("{fail}") for a in args):
    print("error: {fail} does not compile", file=sys.stderr)
    sys.exit(2)
open(args[args.index("-o") + 1], "w").write("built")
with open({log!r}, "a") as f:
    f.write(json.dumps(dict(args=args, start=start, end=time.time())) + "\\n")
"""


def _fake_nvcc(tmp_path, monkeypatch, sleep=0.0, fail=""):
    log = tmp_path / "calls.jsonl"
    fake = tmp_path / "nvcc"
    fake.write_text(FAKE_NVCC.format(python=sys.executable, sleep=sleep, fail=fail, log=str(log)))
    fake.chmod(0o755)
    monkeypatch.setattr(kernels, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    return log


def _calls(log):
    return [json.loads(line) for line in log.read_text().splitlines()] if log.exists() else []


def test_build_compiles_each_source_in_parallel_then_links(tmp_path, monkeypatch):
    log = _fake_nvcc(tmp_path, monkeypatch, sleep=1.0)
    path = kernels.build()
    assert path == kernels.library_path() and path.read_text() == "built"
    calls = _calls(log)
    compiles = [c for c in calls if "-c" in c["args"]]
    links = [c for c in calls if "-shared" in c["args"]]
    assert len(compiles) == len(kernels.SOURCES) == 2 and len(links) == 1
    for src, c in zip(sorted(kernels.SOURCES), sorted(compiles, key=lambda c: c["args"][-1])):
        assert c["args"][-1].endswith(src)
        assert "arch=compute_90a,code=sm_90a" in c["args"] and "-shared" not in c["args"]
    # All compiles were running at once, and the link came after them.
    assert max(c["start"] for c in compiles) < min(c["end"] for c in compiles)
    assert links[0]["start"] >= max(c["end"] for c in compiles)
    objs = [c["args"][c["args"].index("-o") + 1] for c in compiles]
    assert sorted(a for a in links[0]["args"] if a.endswith(".o")) == sorted(objs)
    assert sorted(p.name for p in path.parent.iterdir()) == [path.name]  # objects removed
    kernels.build()  # built already: no second nvcc
    assert len(_calls(log)) == len(calls)


def test_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    log = _fake_nvcc(tmp_path, monkeypatch, fail="disc_assembly.cu")
    with pytest.raises(RuntimeError, match="disc_assembly.cu does not compile"):
        kernels.build()
    assert not any("-shared" in c["args"] for c in _calls(log))  # no link after a failure
    assert list((tmp_path / "_build").iterdir()) == []
