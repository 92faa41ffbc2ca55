"""GP velocity preintegration: LPM (scan-based), UGPM (GP solve) and the
facade.

`preintegrate` is the port of the JAX package's facade (the
`VelPreintegration` facade, `preint.h:22-82,1516-1703`): LPM or UGPM over
one window, or over overlapping chunks of `quantum` seconds chained with
`combine_preints`, the reference's own blockwise mechanism.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .lpm import lpm_preintegrate
from .types import PreintMeas, PreintPrior, add_bias_cov, combine_preints  # noqa: F401
from .ugpm import UGPMConfig, ugpm_fit, ugpm_preintegrate, ugpm_query  # noqa: F401


def _pick(meas: PreintMeas, i) -> PreintMeas:
    return PreintMeas(*(x[i] for x in meas))


def preintegrate(gyr_t, gyr, vel_t, vel, start_t, query_t, gyr_var, vel_var,
                 method: str = "lpm", quantum: float = -1.0, overlap_s: float = 0.1,
                 grid_n: int = 512, ugpm_cfg: UGPMConfig | None = None) -> PreintMeas:
    """Preintegrate the streams over [start_t, query_t[i]] for every query.

    quantum <= 0: one window (`opt.quantum < 0`, `preint.h:1532`).
    quantum > 0: chunks of `quantum` seconds, each fitted on the samples
    within `overlap_s` of its ends (the whole streams when that leaves fewer
    than 4 gyro or 2 velocity samples) and chained with `combine_preints`
    (`preint.h:1584-1701`). The chunk loop runs on the host, as in the JAX
    package: the chunk count depends on the window; each chunk's work stays
    on the streams' device."""
    dtype, device = gyr.dtype, gyr.device
    query_t = torch.atleast_1d(torch.as_tensor(query_t, dtype=dtype, device=device))

    def run(sel_g, sel_v, t0, q):
        args = (gyr_t[sel_g], gyr[sel_g], vel_t[sel_v], vel[sel_v], t0, q, gyr_var, vel_var)
        if method == "ugpm":
            cfg = ugpm_cfg or UGPMConfig(window_duration=float(torch.max(q) - t0) + 1e-3)
            return ugpm_preintegrate(*args, cfg)
        return lpm_preintegrate(*args, grid_n=grid_n)

    everything = slice(None)
    if quantum <= 0:
        return run(everything, everything, start_t, query_t)

    # ---- chunked mode: a host loop over the chunks -----------------------
    q_np = query_t.cpu().numpy()
    t_end = float(q_np.max())
    t0 = float(start_t)
    n_chunks = max(1, int(math.ceil((t_end - t0) / quantum)))
    gyr_t_np, vel_t_np = gyr_t.cpu().numpy(), vel_t.cpu().numpy()

    def on_device(mask):
        return torch.as_tensor(np.nonzero(mask)[0], device=device)

    results = [None] * q_np.shape[0]
    prev = None
    for c in range(n_chunks):
        c_start = t0 + c * quantum
        last = c == n_chunks - 1
        c_end = t_end + 1e-9 if last else t0 + (c + 1) * quantum
        sel = q_np >= c_start - 1e-12
        if not last:
            sel &= q_np < c_end
        q_chunk = q_np[sel]
        # the chunk's queries plus its end point, for chaining
        q_all = torch.as_tensor(np.concatenate([q_chunk, [min(c_end, t_end)]]), dtype=dtype,
                                device=device)
        g_sel = (gyr_t_np >= c_start - overlap_s) & (gyr_t_np <= c_end + overlap_s)
        v_sel = (vel_t_np >= c_start - overlap_s) & (vel_t_np <= c_end + overlap_s)
        if g_sel.sum() < 4 or v_sel.sum() < 2:
            sel_g = sel_v = everything
        else:
            sel_g, sel_v = on_device(g_sel), on_device(v_sel)
        meas = run(sel_g, sel_v, c_start, q_all)
        for qi, out_i in enumerate(np.nonzero(sel)[0]):
            m = _pick(meas, qi)
            results[out_i] = m if prev is None else combine_preints(prev, m)
        chunk_end = _pick(meas, -1)
        prev = chunk_end if prev is None else combine_preints(prev, chunk_end)
    return PreintMeas(*(torch.stack(xs) for xs in zip(*results)))
