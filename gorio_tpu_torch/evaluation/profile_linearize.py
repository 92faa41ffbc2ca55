"""The APDGICP linearize split by component: `scripts/profile_linearize.py`
on the port.

At the script's operating point (a 4,096-point float32 `random_cloud`,
seed 0, as target; the source the same cloud moved by [0.4, 0.15, 0.02] m;
`GICPConfig()`), it times:

* `full_linearize` — one linearize of `make_gicp_callbacks` (its 1-NN is
  one `gorio_nn1_select` launch);
* `nn_only` — the 1-NN alone (`nn1_best`, one `gorio_nn1` launch);
* `nn_gather` — the 1-NN plus the target gathers (xyz, covariance,
  cluster);
* `apd_inv3` — the APD polar covariance (`apd_polar_cov`) added to both
  covariances and inverted; the JAX script's `gicp._inv3` is
  `core/linalg.py` `inv3` here (the same adjugate form);
* `hb_einsums` — the H / b einsums on a fixed Mahalanobis and error;
* unaccounted — full - (nn+gather) - (apd+inv3) - (H/b). The script adds
  the NN's time back into this line; here it is left out, so the four
  parts and the remainder add up to the full linearize.

Each component is a function of its inputs, evaluated apart from its
timing (the tests hold each against the JAX package's expression). The
script asked one question, compute or dispatch; on the card it is host
time or device time (`timing.split`): each component chained `CH` times,
`REPS` times, between CUDA events, beside its device time per call.

    python -m gorio_tpu_torch.evaluation.profile_linearize [--device cuda] [--out J.json]
"""

from __future__ import annotations

import torch

from . import timing
from .sequence import card_name, device_of

N = 4096
CH = 50  # calls chained per timing: the script's fori_loop
REPS = 5
SHIFT = (0.4, 0.15, 0.02)


def problem(device, n=N, dtype=torch.float32):
    """(src, tgt, prob, cfg) at the script's operating point: the target a
    `random_cloud` of n points drawn on a CPU generator seeded 0, the source
    its real points moved by `SHIFT`."""
    from ..core.pointcloud import PointCloud, random_cloud
    from ..registration.gicp import GICPConfig, prepare_gicp

    tgt = random_cloud(torch.Generator().manual_seed(0), n, capacity=n, dtype=dtype)
    tgt = PointCloud(*(x.to(device) for x in tgt))
    shift = torch.tensor(SHIFT, dtype=dtype, device=device)
    src = tgt._replace(xyz=torch.where(tgt.mask[:, None], tgt.xyz + shift, tgt.xyz))
    cfg = GICPConfig()
    return src, tgt, prepare_gicp(src, tgt, cfg), cfg


def full_linearize(linearize, T):
    """(cost, H, b) of one linearize at T."""
    cost, H, b, _ = linearize(T)
    return cost, H, b


def nn_only(prob, x):
    """(idx, d2): the 1-NN of x among the target."""
    from ..ops.nn import nn1_best

    return nn1_best(x, prob.tgt_xyz, ref_mask=prob.tgt_mask)


def nn_gather(prob, x):
    """The 1-NN and the gathers of the winners' covariance, xyz and
    cluster, summed with d2 into one scalar."""
    idx, d2 = nn_only(prob, x)
    idx = idx.long()
    return (torch.sum(prob.tgt_cov[idx]) + torch.sum(prob.tgt_xyz[idx])
            + torch.sum(prob.tgt_cluster[idx]) + torch.sum(d2))


def apd_inv3(prob, cfg, x):
    """(C_B + APD(x)) + (C_A + APD(x)), inverted: the Mahalanobis pipeline
    on the target's covariances standing in for the gathered ones."""
    from ..core.linalg import inv3
    from ..registration.gicp import apd_polar_cov

    cov_d = apd_polar_cov(x, cfg.dist_var, cfg.azimuth_var_deg, cfg.elevation_var_deg)
    return inv3((prob.tgt_cov + cov_d) + (prob.src_cov + cov_d))


def hb_inputs(prob):
    """(mah0, err0, okf0): the fixed Mahalanobis, error and mask of the H / b
    component."""
    from ..core.linalg import inv3

    return (inv3(prob.tgt_cov + prob.src_cov), prob.tgt_xyz - prob.src_xyz,
            prob.src_mask.to(prob.src_xyz.dtype))


def hb_einsums(x, mah0, err0, okf0):
    """(H_rr, H_rt, H_tt, b_r) of the script's einsums at points x."""
    from ..core.lie import hat

    sk = hat(x)
    MS = mah0 @ sk
    H_rr = torch.einsum("nji,njk,n->ik", sk, MS, okf0)
    H_rt = -torch.einsum("nji,njk,n->ik", sk, mah0, okf0)
    H_tt = torch.einsum("nij,n->ij", mah0, okf0)
    m_err = torch.einsum("nij,nj->ni", mah0, err0)
    b_r = torch.einsum("nji,nj,n->i", sk, m_err, okf0)
    return H_rr, H_rt, H_tt, b_r


def _carry(x, s):
    """x with a data dependency on s, as the script's `x * (1 + 0 * s)`."""
    return x * (1.0 + 0.0 * s)


def chain_time(fn, x0, n=CH, reps=REPS, device="cuda"):
    """The script's `chain_time`: host and device ms per call of
    `x = fn(x)` chained n times (`timing.split`)."""
    return timing.split(fn, x0, n, reps, device_of(device))


def main(device="cuda", ch=CH, reps=REPS, log=print) -> dict:
    from ..ops import nn as K
    from ..registration.gicp import make_gicp_callbacks

    device = device_of(device)
    card = card_name(device)
    src, tgt, prob, cfg = problem(device)
    linearize, _ = make_gicp_callbacks(prob, cfg)
    eye = torch.eye(4, dtype=src.xyz.dtype, device=device)
    mah0, err0, okf0 = hb_inputs(prob)
    bodies = {
        "full linearize": (lambda T: _carry(T, full_linearize(linearize, T)[0]), eye),
        "nn only": (lambda x: _carry(x, torch.sum(nn_only(prob, x)[1])), src.xyz),
        "nn+gather": (lambda x: _carry(x, nn_gather(prob, x)), src.xyz),
        "apd+inv3": (lambda x: _carry(x, torch.sum(apd_inv3(prob, cfg, x))), src.xyz),
        "H/b einsums": (lambda x: _carry(x, sum(torch.sum(h) for h in
                                                hb_einsums(x, mah0, err0, okf0))), src.xyz),
    }
    K.reset_launch_counts()
    rows = {name: chain_time(fn, x0, ch, reps, device) for name, (fn, x0) in bodies.items()}
    launches = dict(K.launch_counts)
    unaccounted = (rows["full linearize"]["host_ms"] - rows["nn+gather"]["host_ms"]
                   - rows["apd+inv3"]["host_ms"] - rows["H/b einsums"]["host_ms"])
    for name, row in rows.items():
        log(f"[profile_linearize] {card}: {timing.fmt(name, row, 16)}")
    gather = rows["nn+gather"]["host_ms"] - rows["nn only"]["host_ms"]
    log(f"[profile_linearize] {card}: gather ~{gather:.4f} ms host; unaccounted "
        f"{unaccounted:.4f} ms host; launches {launches}")
    return {"card": card, "n": N, "dtype": str(src.xyz.dtype), "chained": ch, "reps": reps,
            "components": rows, "unaccounted_host_ms": unaccounted, "launches": launches}


if __name__ == "__main__":
    timing.profiler_cli(__doc__, main)
