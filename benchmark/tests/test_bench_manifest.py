"""`BENCHMARK.json` against the rules of its format, and every file it names.

Run from the root of the repository:
    python -m pytest --noconftest benchmark/tests -q
"""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(MAN["command"]) <= 32 and all(_line(w) for w in MAN["command"])
    for w in MAN["command"]:
        assert not w.startswith("/") and ".." not in w.split("/")
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and (ROOT / p).is_dir()
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51


def test_check_fits_the_budget_at_24_cells():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (MAN["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = [c["name"] for c in MAN["configs"]] + [w["name"] for w in MAN["workloads"]]
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in MAN["per_layer"]:
        assert _line(m["layer"])
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert _line(w["why"]) and w["chips"] in (1, 4) and NAME.match(w["traffic"])


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_reports_and_files(cell):
    w = next(x for x in MAN["workloads"] if x["name"] == cell)
    conf = next(c for c in MAN["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    assert config["name"] == conf["name"] and config["reduced"] == conf["reduced"]
    assert (BENCH / "drivers" / f"{config['driver']}.py").is_file()
    assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    e2e = [m for m in MAN["end_to_end"] if _reports(m, cell)]
    per = [m for m in MAN["per_layer"] if _reports(m, cell)]
    assert any(m["name"] == "setup_s" for m in e2e) and len(e2e) >= 2 and per
    for m in e2e + per:
        if m["name"] != "setup_s":
            assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    reported = {m["name"] for m in e2e}
    for m in per:
        # the end-to-end metric a per-layer metric moves is reported in each of its cells
        assert m["moves"] in reported, (m["name"], cell)


def test_configs_each_used_and_files_distinct():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith(tuple(p + "/" for p in MAN["paths"]))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(pairs) // 4)
