"""What the benchmark loads, and that a new cell takes new files only."""

import ast
import json
import os
import shutil
import subprocess
import sys

from benchmark import run
from benchmark.lib import spec

ROOT = spec.ROOT


def test_forbidden_names_are_whole_top_level_names():
    assert run.forbidden_loaded(["popsift_torch", "popsift_torch.kernels",
                                 "jaxtyping", "flaxen", "numpy"]) == []
    assert run.forbidden_loaded(["jax.numpy", "popsift_tpu._host_native",
                                 "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "popsift_tpu"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax():
    for path in spec.BENCH_DIR.rglob("*.py"):
        names = set(_imports(path))
        assert not names & set(run.FORBIDDEN), path
        if "reference" in path.parts:
            assert "popsift_torch" not in names, path


CPU_RUN = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import run
from benchmark.lib import spec
cell = {cell!r}
bench = spec.benchmark()
config = spec.config(bench, spec.cell(bench, cell)["config"])
config["input"].update(width=96, height=64, canvases=1, margin=4)
res = run.execute(cell, 99, 0.5, False, device="cpu",
                  overrides={{"config": config}})
res.pop("_stderr")
print(json.dumps({{"result": res,
                  "loaded": run.forbidden_loaded(list(sys.modules))}}))
"""


def _cpu_run(root, cell):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c",
                          CPU_RUN.format(root=str(root), cell=cell)],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_module():
    got = _cpu_run(ROOT, "1080p-default.live")
    assert got["loaded"] == []
    assert got["result"]["correct"]


def test_a_new_cell_takes_only_new_files(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and the cell's
    limits added as new files and new entries of BENCHMARK.json run, with
    no file of the benchmark edited."""
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.benchmark()
    b = tmp_path / "benchmark"
    config = spec.config(bench, "popsift-1080p")
    config.update(name="dummy-720p", reduced=[])
    config["input"].update(width=1280, height=720)
    (b / "configs" / "dummy-720p.json").write_text(json.dumps(config))
    (b / "traffic" / "live2.json").write_text(json.dumps(
        dict(driver="closed", in_flight=2, warmup=1, sample=2, slice=4)))
    (b / "limits" / "dummy-720p.live2.json").write_text(
        (b / "limits" / "1080p-default.live.json").read_text())
    (b / "metrics" / "frames_sent.live2.py").write_text(
        '"""Frames sent in the window."""\n\n\ndef read(run):\n'
        '    return len(run.window.requests)\n')
    bench["configs"].append(dict(name="dummy-720p", source="a test",
                                 file="benchmark/configs/dummy-720p.json",
                                 reduced=[], why="a test"))
    bench["workloads"].append(dict(name="dummy-720p.live2",
                                   config="dummy-720p", traffic="live2",
                                   chips=1, why="a test"))
    for m in bench["end_to_end"]:
        if m["name"] == "frame_ms_p95":
            m["workloads"].append("dummy-720p.live2")
    bench["end_to_end"].append(dict(
        name="frames_sent.live2", unit="frames", better="higher",
        bound=0.1, source="host_clock", workloads=["dummy-720p.live2"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    got = _cpu_run(tmp_path, "dummy-720p.live2")["result"]
    assert got["correct"]
    assert set(got["metrics"]) == {"frame_ms_p95", "setup_s",
                                   "frames_sent.live2"}
    assert got["metrics"]["frames_sent.live2"]["value"] == got["attempted"]


def test_a_cell_on_the_card(card, tmp_path):
    """One short run of a cell through the benchmark's command."""
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "oxford-640.pairs", "--seed", str(2 ** 31 + 77), "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"


def test_without_a_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "1080p-default.live", "--seed", "1", "--seconds", "1"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
