"""The batched UGPM fit by variant and by batch: `scripts/profile_ugpm.py`
and `scripts/profile_ugpm2.py` on the port, one module with two sections.

The inputs are the scripts' (numpy seed 0): W = 64 windows of G = 128 gyro
and V = 32 velocity samples over [0, 1] s, each fitted from 0.2 s with
`UGPMConfig(window_duration=0.6, lm_iters=10)`, noise variances 1e-4 and
1e-3, in float64 (the port's UGPM does not run float32; see `bench.py`).

* `variants` (`profile_ugpm.py`): the fit as is, with `correlate=False`,
  with `lm_iters=3` and with `init_grid_n=128`; host and device ms per
  call (`timing.split`, 5 calls) and windows/s.
* `batches` (`profile_ugpm2.py`): 10 fits over 10 distinct gyro batches
  against 10 fits of the same batch, back to back (the host clock, ending
  in a synchronise): ms per fit and windows/s.

The split of one keyframe window by stage (LPM warm start, LM, query) is
`graph/solve_timing.py --ugpm`'s, not repeated here.

    python -m gorio_tpu_torch.evaluation.profile_ugpm [--device cuda] [--out J.json]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import timing
from .sequence import card_name, device_of

W, G, V = 64, 128, 32
N_BATCHES = 10
REPS = 5
GYR_VAR, VEL_VAR = 1e-4, 1e-3
VARIANTS = {"full fit": {}, "fit no-correlate": {"correlate": False},
            "fit lm_iters=3": {"lm_iters": 3}, "fit init_grid=128": {"init_grid_n": 128}}


def _t(x, device):
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def inputs(device, w=W):
    """(gyr_t, gyr, vel_t, vel, starts) of the first script, float64 on
    `device`."""
    rng = np.random.default_rng(0)
    gyr = rng.normal(scale=0.2, size=(w, G, 3))
    vel = rng.normal(scale=1.0, size=(w, V, 3))
    return (_t(np.linspace(0, 1.0, G)[None].repeat(w, 0), device), _t(gyr, device),
            _t(np.linspace(0, 1.0, V)[None].repeat(w, 0), device), _t(vel, device),
            _t(np.full(w, 0.2), device))


def batch_inputs(device, w=W, n_batches=N_BATCHES):
    """The second script's: its velocities, then `n_batches` gyro batches,
    from one generator seeded 0; ((gyr_t, vel_t, vel, starts), batches)."""
    rng = np.random.default_rng(0)
    vel = rng.normal(scale=1.0, size=(w, V, 3))
    batches = [_t(rng.normal(scale=0.2, size=(w, G, 3)), device) for _ in range(n_batches)]
    return (_t(np.linspace(0, 1.0, G)[None].repeat(w, 0), device),
            _t(np.linspace(0, 1.0, V)[None].repeat(w, 0), device), _t(vel, device),
            _t(np.full(w, 0.2), device)), batches


def config(variant):
    """The `UGPMConfig` of a variant (a key of `VARIANTS`)."""
    from ..preintegration.ugpm import UGPMConfig

    return UGPMConfig(window_duration=0.6, lm_iters=10)._replace(**VARIANTS[variant])


def fit(args, cfg):
    """The batched fit of (gyr_t, gyr, vel_t, vel, starts): its `_GPState`."""
    from ..preintegration.ugpm import ugpm_fit

    return ugpm_fit(*args, GYR_VAR, VEL_VAR, cfg)


def timed(name, f, *a, reps=REPS, device="cuda", log=print):
    """The first script's `timed`: f(*a) `reps` times back to back, host
    and device ms per call (`timing.split`); logs ms and windows/s."""
    device = device_of(device)
    row = timing.split(lambda _: f(*a), None, reps, 1, device)
    row["windows_per_s"] = a[0][0].shape[0] / (row["host_ms"] / 1e3)  # a[0]: the inputs
    log(f"[profile_ugpm] {card_name(device)}: {timing.fmt(name, row, 22)} "
        f"({row['windows_per_s']:.0f} win/s)")
    return row


def batch_rates(rest, batches, cfg, device):
    """The second script: (distinct-batch, same-batch) ms per fit over the
    batches, the host clock around each loop ending in a synchronise."""
    gyr_t, vel_t, vel, starts = rest
    fit((gyr_t, batches[0], vel_t, vel, starts), cfg)  # warm-up
    out = []
    for gyrs in (batches, [batches[0]] * len(batches)):
        timing.sync(device)
        t0 = time.perf_counter()
        for b in gyrs:
            fit((gyr_t, b, vel_t, vel, starts), cfg)
        timing.sync(device)
        out.append(1e3 * (time.perf_counter() - t0) / len(gyrs))
    return out


def main(device="cuda", n_batches=N_BATCHES, reps=REPS, log=print) -> dict:
    device = device_of(device)
    card = card_name(device)
    w = W
    args = inputs(device)
    variants = {name: timed(name, fit, args, config(name), reps=reps, device=device, log=log)
                for name in VARIANTS}
    distinct, same = batch_rates(*batch_inputs(device, w, n_batches), config("full fit"), device)
    log(f"[profile_ugpm] {card}: distinct-batch fit: {distinct:.2f} ms -> "
        f"{w / distinct * 1e3:.0f} windows/s")
    log(f"[profile_ugpm] {card}: same-batch fit:     {same:.2f} ms -> "
        f"{w / same * 1e3:.0f} windows/s")
    return {"card": card, "windows": w, "dtype": "torch.float64", "variants": variants,
            "batches": {"n": n_batches, "distinct_ms": distinct, "same_ms": same,
                        "distinct_windows_per_s": w / distinct * 1e3,
                        "same_windows_per_s": w / same * 1e3}}


if __name__ == "__main__":
    timing.profiler_cli(__doc__, main)
