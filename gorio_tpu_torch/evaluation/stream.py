"""Real-time streaming of the port: `scripts/stream_benchmark.py` on the
port's `stream_sequence`.

Replays the stored-accuracy circuit (`simulate --duration 75 --rate 5
--seed 22 --circuit --laps 2 --dynamic 2`) against the wall clock with the
full back end in the loop: loop closure on and an optimize every 15
keyframes on the async worker (the reference's 2-3 s timer). Reports the
`StreamReport` (frames processed / dropped, frames on time, latency
percentiles, the realtime factor) plus the ATE of the streamed run after a
final, untimed optimize, in block and drop mode (STREAM.json's keys).

    python -m gorio_tpu_torch.evaluation.stream [--rate 1] [--rates 2,4]
        [--device cuda] [--update --out STREAM_PORT.json]

`platform` is the card's `nvidia-smi` name and power limit ("cpu" on the
CPU). The JAX package's `STREAM.json` is never written.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from .sequence import card_name, device_of

CIRCUIT_SIM = ["--duration", "75", "--rate", "5", "--seed", "22", "--circuit", "--laps", "2",
               "--dynamic", "2"]
CAPACITY = 2048


def run(rate: float, mode: str, workdir=None, loops: bool = True, device="cuda") -> dict:
    """Wall-clock replay of WORKDIR/seq (simulated as the recall circuit
    when it is not there yet) through `stream_sequence` on `device`, with
    the script's `SLAMConfig` / `OdometryConfig` / `PreprocessConfig`; the
    frontend warmed on two frames outside the timed stream."""
    from ..cli import main
    from ..io.native import NativeDataset
    from ..io.tum import ate_rmse, load_tum
    from ..pipeline.odometry import OdometryConfig, ScanMatchingOdometry
    from ..pipeline.preprocessing import PreprocessConfig
    from ..pipeline.slam import RadarGraphSLAM, SLAMConfig
    from ..pipeline.streaming import stream_sequence

    device = device_of(device)
    base = Path(workdir or tempfile.mkdtemp(prefix="gorio_stream_"))
    ds = base / "seq"
    if not (ds / "imu.npz").exists():
        main(["simulate", "--output", str(ds), *CIRCUIT_SIM])
    imu = np.load(ds / "imu.npz")
    slam = RadarGraphSLAM(SLAMConfig(
        enable_loop_closure=loops,
        gyr_var=float(imu["gyr_var"]), vel_var=float(imu["vel_var"]),
    ), device=device)
    for t, g in zip(imu["gyr_t"], imu["gyr"]):
        slam.push_imu(t, g)
    for t, v in zip(imu["vel_t"], imu["vel"]):
        slam.push_twist(t, v)
    odo = ScanMatchingOdometry(OdometryConfig())
    odo.preprocess_cfg = PreprocessConfig()
    frames = sorted(ds.glob("*.grf"))
    # warm the frontend outside the timed stream
    w = ScanMatchingOdometry(OdometryConfig())
    w.preprocess_cfg = odo.preprocess_cfg
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    for stamp, xyz, inten, dop in NativeDataset([str(f) for f in frames[:2]], capacity=CAPACITY):
        packed = np.zeros((CAPACITY, 5))
        packed[: len(xyz)] = np.column_stack([xyz, inten, dop])
        w.step_fused(float(stamp), torch.tensor(packed, device=device), len(xyz),
                     omega=np.zeros(3), generator=gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    gen.manual_seed(0)
    report = stream_sequence(
        frames, slam, odo, imu={"gyr_t": imu["gyr_t"], "gyr": imu["gyr"]},
        rate_multiplier=rate, mode=mode, capacity=CAPACITY,
        # ~3 s cadence at 5 Hz keyframes; async like the reference's timer
        optimize_every=(15 if loops else 0), optimize_async=True, generator=gen,
    )
    out = json.loads(report.to_json())
    # trajectory quality of this streamed run: a final (untimed) optimize,
    # then ATE against the recording's ground truth
    slam.optimize()
    gs, gp = load_tum(ds / "groundtruth.tum")
    st, sp = slam.trajectory()
    out["ate_rmse_m"] = round(float(ate_rmse(st, sp, np.asarray(gs), gp)), 4)
    return out


def main_cli(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--update", action="store_true", help="write the results to --out")
    ap.add_argument("--out", default=None, help="the port's stream record (JSON)")
    ap.add_argument("--rate", type=float, default=1.0)
    ap.add_argument("--rates", type=str, default="",
                    help="comma-separated extra rate multipliers (block mode)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.update and not args.out:
        ap.error("--update needs --out (the JAX package's STREAM.json is not written)")
    device = device_of(args.device)
    with tempfile.TemporaryDirectory(prefix="gorio_stream_") as wd:
        # a throwaway pass first, in block mode so that every graph size of
        # the back end is reached: the first contact with each (the solvers'
        # cuSOLVER / cuBLAS handles, the kernels' library) stays out of the
        # measured runs
        run(8.0, "block", wd, device=device)
        results = {
            "platform": card_name(device),
            "block_rate1": run(args.rate, "block", wd, device=device),
            "drop_rate1": run(args.rate, "drop", wd, device=device),
            # frontend-only reference point: how much of a deadline slip is
            # the back end in the loop
            "frontend_only_block_rate1": run(args.rate, "block", wd, loops=False,
                                             device=device),
        }
        for r in (float(x) for x in args.rates.split(",") if x):
            results[f"block_rate{r:g}"] = run(r, "block", wd, device=device)
    print(json.dumps(results, indent=2))
    if args.update:
        Path(args.out).write_text(json.dumps(results, indent=2) + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    return results


if __name__ == "__main__":
    main_cli()
