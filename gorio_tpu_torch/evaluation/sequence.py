"""One evaluation sequence through the port's CLI: `simulate`, then `slam`
with `--timing-out` on the chosen device. Shared by `accuracy`, `recall`
and `loop_replay`."""

from __future__ import annotations

import json
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]


def device_of(name) -> torch.device:
    """`name` as a torch device; a CUDA device without a card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return device


class Run(NamedTuple):
    """A finished sequence: its dataset directory, the estimated TUM path,
    the `--timing-out` record, the CLI's `RadarGraphSLAM` and the `slam`
    wall seconds (the host clock, ending in a synchronise)."""

    ds: Path
    est: Path
    timing: dict
    slam: object
    wall_s: float


def resolve(name_or_spec, sequences: dict, slam_args=None) -> tuple[str, dict]:
    """(name, spec) of a sequence named in `sequences`, or of a spec dict
    {"simulate": [...], "slam": [...], "name": ...}; a spec without "slam"
    takes `slam_args`."""
    if isinstance(name_or_spec, str):
        name, spec = name_or_spec, dict(sequences[name_or_spec])
    else:
        spec = dict(name_or_spec)
        name = spec.get("name", "seq")
    if "slam" not in spec:
        spec["slam"] = list(slam_args or [])
    return name, spec


def run(name: str, spec: dict, workdir=None, device="cuda", prefix="gorio_eval_") -> Run:
    """`simulate` with spec["simulate"] into WORKDIR/NAME, then `slam` with
    spec["slam"] and `--timing-out` on `device`."""
    from ..cli import main as cli

    device = device_of(device)  # before the simulation: a missing card fails at once
    base = Path(workdir or tempfile.mkdtemp(prefix=f"{prefix}{name}_"))
    ds = base / name
    cli(["simulate", "--output", str(ds), *spec["simulate"]])
    est, timing = ds / "est.tum", ds / "timing.json"
    t0 = time.perf_counter()
    slam, _, _ = cli(["slam", "--dataset", str(ds), "--output", str(est), "--timing-out",
                      str(timing), *spec["slam"], "--device", str(device)])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    return Run(ds, est, json.loads(timing.read_text()), slam, wall)


def gt_positions(ds: Path):
    """(stamps, (T, 3) positions) of a dataset's ground truth (TUM rows
    `stamp x y z qx qy qz qw`)."""
    rows = np.loadtxt(ds / "groundtruth.tum", usecols=(0, 1, 2, 3), ndmin=2)
    return rows[:, 0], rows[:, 1:4]


def card_name(device) -> str:
    """The card's `nvidia-smi` name and power limit, or "cpu"."""
    device = device_of(device)
    if device.type != "cuda":
        return "cpu"
    from ..bench import card_name as smi

    return smi(device)
