"""Does exporting `CUBLAS_WORKSPACE_CONFIG` cost host time per call on the
card? Every rank of `parallel/mesh.spawn` (and so every row of `scaling`)
sets it to `mesh.CUBLAS_WORKSPACE` before its first CUDA call; the
profilers run without it unless the caller exports it.

    python -m gorio_tpu_torch.evaluation.cublas_workspace [--device cuda] [--out J.json]

The same readings run in `2 * PAIRS` fresh processes, the variable unset
("off") and set ("on") in the order off, on, on, off, off, on, ... (each
pair reversed from the last, so that a drift of the host over the call
falls on both settings alike). Each process reads, on `--device`:

* host us per call of 1,000 back-to-back calls (`timing.chain_ms`): a
  float64 `bmm` of (64, 6, 6) blocks (cuBLAS, the shape of the graph
  solve's blocks), a float32 `bmm` of (4,096, 3, 3) (the linearize's
  3 x 3 blocks) and an in-place add on one element (no cuBLAS);
* `profile_graph_solve`'s block build and PCG(20) at K = 256 (float64,
  `timing.split`: 5 and 2 calls);
* `profile_linearize`'s five components (N = 4,096, float32).

It prints each process's readings with its setting and the card's
`nvidia-smi` name and power limit, then for each reading the median of
"on" over the median of "off".
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from . import timing
from .sequence import REPO, card_name, device_of

VAR = "CUBLAS_WORKSPACE_CONFIG"
PAIRS = 3
CALLS = 1000
GRAPH_K = 256


def order(pairs):
    """The settings of the processes in turn: off, on, on, off, ..."""
    return [s for p in range(pairs) for s in (("off", "on") if p % 2 == 0 else ("on", "off"))]


def child_env(setting):
    """The environment of one process: the variable set to the value every
    spawned rank sets ("on"), or removed ("off")."""
    from ..parallel.mesh import CUBLAS_WORKSPACE

    env = dict(os.environ)
    env.pop(VAR, None)
    if setting == "on":
        env[VAR] = CUBLAS_WORKSPACE
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _us(fn, device):
    return 1e3 * timing.chain_ms(lambda _: fn(), None, CALLS, 1, device)


def readings(device="cuda") -> dict:
    """One process's readings (see the module's docstring)."""
    from . import profile_graph_solve as pg
    from . import profile_linearize as pl

    dev = device_of(device)
    g = torch.Generator(device=dev).manual_seed(0)
    a64 = torch.randn(64, 6, 6, generator=g, dtype=torch.float64, device=dev)
    a32 = torch.randn(4096, 3, 3, generator=g, device=dev)
    one = torch.zeros(1, device=dev)
    out = {"setting": "on" if os.environ.get(VAR) else "off", VAR: os.environ.get(VAR),
           "card": card_name(dev),
           "host_us_per_call": {"bmm f64 (64, 6, 6)": _us(lambda: torch.bmm(a64, a64), dev),
                                "bmm f32 (4096, 3, 3)": _us(lambda: torch.bmm(a32, a32), dev),
                                "add_ (no cuBLAS)": _us(lambda: one.add_(1.0), dev)}}
    poses0, graph = pg.graph(GRAPH_K, dev)
    Hdiag, Hoff, b, _ = pg.build(poses0, graph)
    out[f"graph K={GRAPH_K}"] = {
        "build": timing.split(lambda _: pg.build(poses0, graph), None, 5, 1, dev),
        "cg20": timing.split(lambda _: pg.solve_cg(Hdiag, Hoff, b, graph, 20), None, 2, 1, dev)}
    out["linearize"] = pl.main(dev, log=lambda *a: None)["components"]
    return out


def _host_ms(row) -> dict:
    """{reading: host ms or us} of one process's readings."""
    flat = {f"{k} (us)": v for k, v in row["host_us_per_call"].items()}
    for part in (f"graph K={GRAPH_K}", "linearize"):
        flat.update({f"{part}: {k} (ms)": v["host_ms"] for k, v in row[part].items()})
    return flat


def main(device="cuda", log=print) -> dict:
    device_of(device)  # no card: raise before starting anything
    runs = []
    for setting in order(PAIRS):
        r = subprocess.run([sys.executable, "-m", "gorio_tpu_torch.evaluation.cublas_workspace",
                            "--one", "--device", str(device)], env=child_env(setting),
                           cwd=REPO, capture_output=True, text=True, timeout=900)
        if r.returncode:
            raise RuntimeError(f"the {setting} process failed ({r.returncode}):\n{r.stderr}")
        row = json.loads(r.stdout.strip().splitlines()[-1])
        assert row["setting"] == setting, (row["setting"], setting)
        runs.append(row)
        log(f"[cublas_workspace] {row['card']}: {setting} ({row[VAR]}): "
            + ", ".join(f"{k} {v:.4f}" for k, v in _host_ms(row).items()))
    ratio = {}
    for k in _host_ms(runs[0]):
        on = statistics.median(_host_ms(r)[k] for r in runs if r["setting"] == "on")
        off = statistics.median(_host_ms(r)[k] for r in runs if r["setting"] == "off")
        ratio[k] = {"on": on, "off": off, "on_over_off": on / off}
        log(f"[cublas_workspace] {runs[0]['card']}: {k}: on {on:.4f} / off {off:.4f} = "
            f"{on / off:.3f}")
    return {"card": runs[0]["card"], "order": order(PAIRS), "runs": runs, "median": ratio}


def main_cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the readings here (JSON)")
    ap.add_argument("--one", action="store_true", help="one process's readings (as `main` runs)")
    args = ap.parse_args(argv)
    res = readings(args.device) if args.one else main(args.device)
    print(json.dumps(res), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=2) + "\n")


if __name__ == "__main__":
    main_cli()
