"""`BENCHMARK.json` and the files it names: a cell's configuration and
traffic mix, and the loaders of drivers and metric readers by name."""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(manifest: dict, workload: str):
    """(workload entry, config entry, config file, traffic file) of a cell."""
    for w in manifest["workloads"]:
        if w["name"] == workload:
            break
    else:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    return w, conf, config, traffic


def metrics_of(manifest: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics (untraced run) or per-layer metrics
    (traced run): those without a `workloads` key, and those that list it."""
    group = manifest["per_layer"] if trace else manifest["end_to_end"]
    return [m for m in group if "workloads" not in m or workload in m["workloads"]]


def driver(name: str):
    if not NAME.match(name):
        raise ValueError(f"bad driver name {name!r}")
    return importlib.import_module(f"benchmark.drivers.{name}")


def reader(name: str):
    """The metric's reader, `benchmark/metrics/<name>.py` (the file name may
    hold dots, so it is loaded by path)."""
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "__").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
