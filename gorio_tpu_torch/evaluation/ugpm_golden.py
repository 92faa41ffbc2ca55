"""The UGPM golden record on the port: `scripts/make_ugpm_golden.py`.

The inputs are the script's: the port's `io/synthetic.py`
`simulate_trajectory(seed=42, duration=3.0)` and `sample_imu(...,
gyr_rate=200, vel_rate=30, gyr_std=0.01, vel_std=0.03, seed=43)`, the
samples of the 1.0-1.5 s window padded by 0.3 s on both sides, queries at
1.1, 1.25 and 1.5 s, `UGPMConfig(window_duration=0.5)`. The port's
`ugpm_preintegrate` runs them in float64 on `--device`, and `--out` gets
an `.npz` with the fixture's keys (`tests/golden/ugpm_golden.npz`, which
the JAX package's record is and which this never writes).

`check` holds a run against a fixture with `tests/test_ugpm_golden.py`'s
four checks and tolerances: delta_p rtol 1e-6 / atol 1e-8 and the
rotations within 1e-7 rad (dt rtol 1e-12), cov rtol 1e-5 / atol 1e-12,
the Jacobians rtol 1e-5 / atol 1e-9, and the truth bound (position within
4 sigma + 1 mm, rotation within 6 sigma + 1e-4 rad).

    python -m gorio_tpu_torch.evaluation.ugpm_golden [--device cuda] [--out G.npz]
        [--check tests/golden/ugpm_golden.npz]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .sequence import REPO, card_name, device_of

GOLDEN = REPO / "tests" / "golden" / "ugpm_golden.npz"
T0, T1, PAD = 1.0, 1.5, 0.3
QUERIES = (1.1, 1.25, 1.5)
WINDOW = 0.5
JACOBIANS = ("d_delta_R_d_bw", "d_delta_R_d_t", "d_delta_p_d_bw", "d_delta_p_d_bv",
             "d_delta_p_d_t")
OUTPUTS = ("delta_R", "delta_p", "dt", "cov", *JACOBIANS)


def inputs() -> dict:
    """The fixture's input streams and constants, and the ground-truth
    deltas (float64 numpy)."""
    from ..io.synthetic import sample_imu, simulate_trajectory

    traj = simulate_trajectory(seed=42, duration=3.0)
    imu = sample_imu(traj, gyr_rate=200.0, vel_rate=30.0, gyr_std=0.01, vel_std=0.03, seed=43)
    sel_g = (imu.gyr_t >= T0 - PAD) & (imu.gyr_t <= T1 + PAD)
    sel_v = (imu.vel_t >= T0 - PAD) & (imu.vel_t <= T1 + PAD)
    queries = np.array(QUERIES, dtype=np.float64)
    R0, p0 = traj.interp_pose(np.array([T0]))
    Rq, pq = traj.interp_pose(queries)
    return dict(
        gyr_t=np.asarray(imu.gyr_t[sel_g], np.float64), gyr=np.asarray(imu.gyr[sel_g], np.float64),
        vel_t=np.asarray(imu.vel_t[sel_v], np.float64), vel=np.asarray(imu.vel[sel_v], np.float64),
        t0=np.float64(T0), queries=queries, gyr_var=np.float64(imu.gyr_var),
        vel_var=np.float64(imu.vel_var), window_duration=np.float64(WINDOW),
        delta_R_true=np.einsum("ij,qjk->qik", R0[0].T, Rq),
        delta_p_true=np.einsum("ij,qj->qi", R0[0].T, pq - p0[0]))


def run(d, device) -> dict:
    """`ugpm_preintegrate` of the streams in `d` (the fixture's keys) in
    float64 on `device`: {output name: float64 numpy}."""
    from ..preintegration.ugpm import UGPMConfig, ugpm_preintegrate

    def t(k):
        return torch.as_tensor(np.asarray(d[k]), dtype=torch.float64, device=device)

    meas = ugpm_preintegrate(t("gyr_t"), t("gyr"), t("vel_t"), t("vel"), float(d["t0"]),
                             t("queries"), float(d["gyr_var"]), float(d["vel_var"]),
                             UGPMConfig(window_duration=float(d["window_duration"])))
    return {k: getattr(meas, k).double().cpu().numpy() for k in OUTPUTS}


def _rot_angle(Ra, Rb):
    """Geodesic angle between rotations (Q, 3, 3), float64: the norm of the
    relative rotation's rotation vector (exact near 0, where an arccos of
    the trace is not)."""
    from scipy.spatial.transform import Rotation

    return Rotation.from_matrix(np.swapaxes(Ra, -1, -2) @ Rb).magnitude()


def _rel_excess(got, want, rtol, atol):
    """Largest |got - want| / (atol + rtol |want|): <= 1 passes allclose."""
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))


def check(out, golden) -> dict:
    """The four checks of `tests/test_ugpm_golden.py` on `out` against the
    fixture `golden`: {check: largest error over its tolerance}, each <= 1
    to pass."""
    rot = _rot_angle(out["delta_R"], golden["delta_R"])
    gaps = {"delta_p": _rel_excess(out["delta_p"], golden["delta_p"], 1e-6, 1e-8),
            "delta_R": float(rot.max() / 1e-7),
            "dt": _rel_excess(out["dt"], golden["dt"], 1e-12, 0.0),
            "cov": _rel_excess(out["cov"], golden["cov"], 1e-5, 1e-12)}
    for k in JACOBIANS:
        gaps[k] = _rel_excess(out[k], golden[k], 1e-5, 1e-9)
    sig_p = np.sqrt(np.diagonal(golden["cov"], axis1=-2, axis2=-1)[:, 3:])
    p_err = np.abs(out["delta_p"] - golden["delta_p_true"])
    sig_r = np.sqrt(np.trace(golden["cov"][:, :3, :3], axis1=-2, axis2=-1))
    ang = _rot_angle(out["delta_R"], golden["delta_R_true"])
    gaps["truth_p"] = float(np.max(p_err / (4.0 * sig_p + 1e-3)))
    gaps["truth_R"] = float(np.max(ang / (6.0 * sig_r + 1e-4)))
    return gaps


def main(device="cuda", out=None, golden=None, log=print) -> dict:
    """Generate the record on `device`; write it to `out` (an `.npz`) where
    given; hold it against `golden` where given. Returns {"record", "gaps"}."""
    device = device_of(device)
    d = inputs()
    rec = {**d, **run(d, device)}
    if out:
        np.savez_compressed(out, **rec)
        log(f"wrote {out}")
    log(f"[ugpm_golden] {card_name(device)}: delta_p[-1] = {rec['delta_p'][-1]}, true = "
        f"{rec['delta_p_true'][-1]}; cov diag[-1] = {np.diag(rec['cov'][-1])}")
    gaps = None
    if golden is not None:
        gaps = check(rec, np.load(golden))
        log(f"[ugpm_golden] {card_name(device)}: against {golden}, error / tolerance: "
            + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items()))
    return {"record": rec, "gaps": gaps}


def main_cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the record here (.npz)")
    ap.add_argument("--check", default=None, metavar="NPZ",
                    help=f"hold the record against a fixture (e.g. {GOLDEN.relative_to(REPO)}); "
                    "exit 1 off its tolerances")
    args = ap.parse_args(argv)
    res = main(args.device, args.out, args.check)
    if res["gaps"] is not None and max(res["gaps"].values()) > 1.0:
        sys.exit(1)


if __name__ == "__main__":
    main_cli()
