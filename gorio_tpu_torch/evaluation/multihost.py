"""Two processes, one SMC population: `scripts/demo_multihost.py` on the
port.

`driver()` starts two OS processes (`subprocess`), this module with the
rank as its argument. Each joins one `torch.distributed` group through
`parallel/mesh.py` `initialize_distributed(coordinator="localhost:PORT",
num_processes=2, process_id=rank)`, the TCP bring-up a multi-host run
takes, and holds its half of the script's population: 1,024 particles of
D = 8, normal x 3.0, drawn by numpy with seed 0, float32 (the script's two
local devices of a JAX host are one rank here: 512 rows). One
`sharded_smc_step` with the log-density -0.5 sum(x * x) and proposal std
0.2 then weighs the particles across the process boundary (pmax / psum of
the weights, the global cumulative weights gathered). Each rank prints
the global ESS, which is computed before any draw; `driver()` asserts that
both print the same value and that 0 < ESS <= 1,024, and exits as the
script does: 1 unless both ranks exit 0 within 300 s (a rank still running
then is killed).

Backend: gloo. On the card both ranks put their tensors on cuda:0 (one
card cannot hold two NCCL ranks; gloo copies them through the host); with
`--device cpu` gloo runs on the CPU. The script met on the fixed port
9911, where two concurrent runs (test workers, chip_smoke.py's lanes)
would meet each other; `driver()` binds a free port unless `--port` names
one, and prints it.

    python -m gorio_tpu_torch.evaluation.multihost [--device cuda] [--port P]
"""

from __future__ import annotations

import argparse
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .sequence import REPO, card_name, device_of

N_PROC = 2
DEVS_PER_PROC = 2  # the script's local devices per process: one rank holds their rows
PPD, D = 256, 8  # particles per JAX device, dimensions
NP = PPD * N_PROC * DEVS_PER_PROC
PORT = 9911  # the script's; `driver()` takes a free port unless given one
DEADLINE_S = 300
STD = 0.2
ESS_LINE = re.compile(r"\[proc (\d+)/\d+\] global ESS = (\S+) over")


def population():
    """(particles (NP, D), log weights (NP,)) of the script, float32 numpy."""
    rng = np.random.default_rng(0)  # every rank draws the same global population
    return (rng.normal(size=(NP, D)).astype(np.float32) * 3.0, np.zeros((NP,), np.float32))


def log_target(x):
    """The script's target, N(0, I): one value per row."""
    return -0.5 * torch.sum(x * x, dim=-1)


def worker(rank, port=PORT, device="cuda"):
    """One rank: join the group, run one sharded SMC step over the global
    population, print the global ESS."""
    from ..inference.smc import sharded_smc_step
    from ..parallel.mesh import data_parallel_mesh, initialize_distributed

    dev = device_of(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)  # both ranks share the first card
    pid, pcount = initialize_distributed(f"localhost:{port}", N_PROC, rank, device=dev,
                                         backend="gloo")
    try:
        assert pcount == N_PROC, f"expected {N_PROC} processes, got {pcount}"
        mesh = data_parallel_mesh(N_PROC, device=dev)
        step = sharded_smc_step(mesh, log_target)
        particles, logw = (torch.as_tensor(a, device=dev) for a in population())
        gen = torch.Generator(device=dev).manual_seed(0)  # the same draws on both ranks
        p_new, lw_new, ess = step(particles, logw, torch.tensor(STD, device=dev), generator=gen)
        ess = float(ess)
        assert torch.isfinite(p_new).all() and torch.isfinite(lw_new).all()
        print(f"[proc {pid}/{pcount}] global ESS = {ess!r} over {NP} particles (gloo, "
              f"{mesh.device}; {card_name(dev)})", flush=True)
        assert 0.0 < ess <= NP
    finally:
        torch.distributed.destroy_process_group()


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def driver(port=None, device="cuda", log=print) -> dict:
    """Start the two ranks, wait for them (killing one still running at the
    deadline), print their output; returns {"ok", "codes", "ess", "port"}:
    ok when both exit 0 and print the same ESS in (0, NP]."""
    device_of(device)  # no card: raise before starting anything
    port = port or free_port()
    log(f"multihost demo: {N_PROC} processes meet at localhost:{port}")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # as every rank of `mesh.spawn`
    with tempfile.TemporaryDirectory(prefix="gorio_multihost_") as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(N_PROC)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "gorio_tpu_torch.evaluation.multihost", "--rank", str(r),
             "--port", str(port), "--device", str(device)],
            env=env, cwd=REPO, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(N_PROC)]
        deadline = time.time() + DEADLINE_S
        codes = [None] * N_PROC
        while time.time() < deadline and any(c is None for c in codes):
            codes = [p.poll() for p in procs]
            time.sleep(0.2)
        for i, p in enumerate(procs):
            if codes[i] is None:
                p.kill()
                p.wait()
                codes[i] = -9
        outs = []
        for fh in logs:
            fh.seek(0)
            outs.append(fh.read())
            fh.close()
    ess = {}
    for text in outs:
        log(text.rstrip())
        for m in ESS_LINE.finditer(text):
            ess[int(m.group(1))] = float(m.group(2))
    values = set(ess.values())
    ok = (all(c == 0 for c in codes) and len(ess) == N_PROC and len(values) == 1
          and 0.0 < values.pop() <= NP)
    log(f"multihost demo: exit codes {codes}, ESS by rank {ess} -> {'OK' if ok else 'FAIL'}")
    return {"ok": ok, "codes": codes, "ess": ess, "port": port}


def main_cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None, help="run one rank (as `driver()` does)")
    args = ap.parse_args(argv)
    if args.rank is not None:
        worker(args.rank, args.port or PORT, args.device)
    else:
        sys.exit(0 if driver(args.port, args.device)["ok"] else 1)


if __name__ == "__main__":
    main_cli()
