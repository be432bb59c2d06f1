"""The benchmark's definition: ``BENCHMARK.json`` at the checkout's root
and the files it names by name under ``benchmark/``.

A cell names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<traffic>.json``); a configuration may name its plain
reference (``reference/<reference>.py``) and its image mode; a metric is
read by ``metrics/<metric>.py``; the numbers that decide ``correct`` have
their limits in ``limits/<cell>.json``.  Adding a configuration, a
reference, a mix, a metric or a cell takes new files and entries, never
an edit.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                     f"{[w['name'] for w in spec['workloads']]}")


def config(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise SystemExit(f"unknown configuration {name!r}")


def traffic(name: str) -> dict:
    return load_json(BENCH_DIR / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return load_json(BENCH_DIR / "limits" / f"{cell_name}.json")


def metrics_of(spec: dict, cell_name: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones: each metric whose ``workloads`` lists the cell, or that has no
    such list."""
    group = spec["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]


def reader(metric_name: str):
    """The ``read(run)`` function of ``metrics/<metric_name>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric_name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", metric_name), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def named_module(package: str, name: str):
    """``benchmark.<package>.<name>``: an input generator or a driver."""
    if not NAME.match(name) or "." in name:
        raise SystemExit(f"bad {package} name {name!r}")
    return importlib.import_module(f"benchmark.{package}.{name}")


REFERENCE_EXPORTS = ("settings_of", "make_plan", "gauss_tables", "extract")
IMAGE_MODES = ("byte", "float")


def reference_of(config: dict):
    """The plain reference that judges the configuration:
    ``benchmark/reference/<config["reference"]>.py``, ``sift`` where the
    key is left out.  The module's contract is in
    ``benchmark/reference/__init__.py``."""
    name = config.get("reference", "sift")
    if not isinstance(name, str) or not NAME.match(name) or "." in name:
        raise SystemExit(f"configuration key 'reference': bad name {name!r}")
    full = f"benchmark.reference.{name}"
    try:
        mod = importlib.import_module(full)
    except ModuleNotFoundError as e:
        if e.name != full:
            raise
        raise SystemExit(f"configuration key 'reference': no module "
                         f"benchmark/reference/{name}.py") from None
    missing = [f for f in REFERENCE_EXPORTS
               if not callable(getattr(mod, f, None))]
    if missing:
        raise SystemExit(f"configuration key 'reference': {name!r} lacks "
                         f"{missing}")
    return mod


def image_mode_of(config: dict) -> str:
    """How the configuration hands images to PopSift: ``byte`` (uint8,
    the default where the key is left out) or ``float``."""
    mode = config.get("image_mode", "byte")
    if mode not in IMAGE_MODES:
        raise SystemExit(f"configuration key 'image_mode': {mode!r} is not "
                         f"one of {list(IMAGE_MODES)}")
    return mode
