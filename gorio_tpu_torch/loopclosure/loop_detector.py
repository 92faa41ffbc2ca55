"""Loop detection: candidate gating + Scan Context + registration verification.

Port of `gorio_tpu/loopclosure/loop_detector.py` (`LoopDetector`,
`loop_detector.cpp`). The candidate gates (`find_candidates`), the odometry
check and the pairwise consistency check run on the host in numpy, copied
from the JAX package as they are. Scan-Context matching is one batched
search on the device for all new keyframes of a `detect_batch` call, and
registration verification is one batched APDGICP over every candidate pair
and both seeds (`_verify_batch`): each outer LM iteration of the batch is
one `nn1_select` launch at 2 x pairs lanes, and its fitness one `nn1_best`
launch.

Port-side choices (ROADMAP A8):
- `detect_batch` reads `self.db` once into a local, so a `grow()` from
  another thread mid-call cannot hand it two different databases.
- Batches are not padded to powers of two: the JAX package pads them to
  bound its compiles, which torch does not need; a padded lane repeats a
  real one and is discarded, so no result depends on it.
- `verify_iterations` counts the outer LM iterations of every verification
  batch, the number of `nn1_select` launches verification made.
- The gate counters keep the JAX package's keys and semantics, so that
  `gate_counts` compare equal with it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.pointcloud import PointCloud
from ..registration.gicp import (
    GICPConfig, GICPProblem, align_prepared_batch, gicp_align, prepare_gicp,
)
from .information import InformationConfig, calc_information_matrix
from .scancontext import (
    ScanContextConfig, ScanContextDB, best_match, detect_loop, make_scancontext, search,
    top_matches,
)


class LoopConfig(NamedTuple):
    """Defaults of the JAX package's `LoopConfig` (`loop_detector.hpp`
    params + ntu launch values, with its recall-tuned gates; the comments
    there say why each differs from the reference)."""

    distance_thresh: float = 10.0  # only the rviz search-sphere radius
    accum_distance_thresh: float = 50.0
    min_loop_interval_dist: float = 5.0
    max_yaw_difference_deg: float = 95.0
    max_baro_difference: float = 2.0
    odom_drift_xy: float = 0.05
    odom_drift_z: float = 0.02
    drift_scale_xy: float = 2.0
    drift_scale_z: float = 2.0
    fitness_thresh: float = 2.5
    # coarse-to-fine verification: first align with this correspondence gate
    coarse_corr_dist: float = 10.0
    # reject a gated-fallback match whose verified translation exceeds this
    fallback_max_trans: float = 5.0
    # ... and apply the same ceiling to direct matches
    trans_gate_all: bool = True
    enable_odom_check: bool = True
    odom_check_trans_thresh: float = 0.3
    odom_check_rot_thresh: float = 0.05
    pairwise_check_trans_thresh: float = 3.0
    pairwise_check_rot_thresh: float = 0.3
    pairwise_mode: str = "odom"  # "odom" (reference parity) | "estimate"
    pairwise_drift_scaled: bool = True
    ellipse_base: float = 3.0
    ellipse_base_after_first: float = 6.0
    pairwise_nearest: bool = True
    pairwise_trans_cap: float = 8.0
    # Scan-Context candidates verified per new keyframe
    sc_candidates: int = 2


class Loop(NamedTuple):
    """A verified loop closure (`Loop` struct, `loop_detector.hpp:27`)."""

    key_new: int
    key_old: int
    T_rel: np.ndarray  # (4,4): old_T_new (relative pose for the between factor)
    information: np.ndarray  # (6,6)
    fitness: float


def _sc_match_batch(db: ScanContextDB, idxs, cfg: ScanContextConfig, masks=None):
    """Batched `detect_loop`: keyframe idxs[b] is the query and may only
    match descriptors below idxs[b] - num_exclude_recent, restricted to
    `masks[b]` (B, capacity) when given. Returns (matches, yaws, dists),
    each (B,)."""
    res = search(db, db.descs[idxs], idxs, cfg, masks)
    return best_match(res, cfg, db.descs.dtype)


def _sc_match_batch_topk(db: ScanContextDB, idxs, cfg: ScanContextConfig, masks, k: int):
    """Batched `detect_loop_topk` (the gated search, several candidates per
    query). Returns (matches, yaws, dists), each (B, min(k, num_candidates))."""
    res = search(db, db.descs[idxs], idxs, cfg, masks)
    return top_matches(res, cfg, db.descs.dtype, k)


def _stack(clouds) -> PointCloud:
    return PointCloud(*(torch.stack(xs) for xs in zip(*clouds)))


def _twice(x):
    """Both seeds in one batch: lanes [0, P) and [P, 2P) hold the same pair."""
    return type(x)(*(torch.cat([t, t]) for t in x))


def _verify_batch(src: PointCloud, tgt: PointCloud, init_T, gicp_cfg: GICPConfig,
                  coarse_cfg: GICPConfig, info_cfg: InformationConfig):
    """Batched loop verification over P pairs (clouds (P, N, .), init_T
    (P, 4, 4)): coarse-to-fine APDGICP from two seeds each, the current
    estimate `init_T` and co-location (identity), then the information from
    the fine fitness, keeping the better-fitting seed with NaN counted as
    +inf on both sides (`_verify_batch`, `loop_detector.py:190-234`).

    Both seeds ride one batch of 2P lanes; the covariances are computed once
    per pair and serve both stages (they do not depend on the gate).
    Returns (T (P, 4, 4), converged (P,) on the CPU, info (P, 6, 6),
    fitness (P,), outer LM iterations run = `nn1_select` launches)."""
    P = init_T.shape[0]
    prob = _twice(prepare_gicp(src, tgt, gicp_cfg))
    eye = torch.eye(4, dtype=init_T.dtype, device=init_T.device).expand(P, 4, 4)
    res_c = align_prepared_batch(prob, torch.cat([init_T, eye]), coarse_cfg)
    res = align_prepared_batch(prob, res_c.T, gicp_cfg)
    info, fit = calc_information_matrix(_twice(src), _twice(tgt), res.T, info_cfg)
    inf = torch.full_like(fit[:P], float("inf"))
    fa = torch.where(torch.isnan(fit[:P]), inf, fit[:P])
    fb = torch.where(torch.isnan(fit[P:]), inf, fit[P:])
    a = fa <= fb
    T = torch.where(a[:, None, None], res.T[:P], res.T[P:])
    a_host = a.cpu()
    conv = torch.where(a_host, res.converged[:P], res.converged[P:])
    info = torch.where(a[:, None, None], info[:P], info[P:])
    fit = torch.where(a, fit[:P], fit[P:])
    iterations = int(res_c.iterations.max()) + int(res.iterations.max())
    return T, conv, info, fit, iterations


def _rot_angle_np(R) -> float:
    return float(np.arccos(np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)))


def candidate_gate_reason(new_pos, new_yaw, new_accum, old_pos, old_yaw, old_accum,
                          dist_since_last_loop, cfg: LoopConfig,
                          new_alt=None, old_alt=None) -> str:
    """`find_candidates` gates (`loop_detector.cpp:139-189`):
    accumulated-distance, barometer-altitude difference (`:155-157`),
    yaw-difference, and both drift-scaled ellipses (since-last-loop +
    accumulated-distance). Returns '' on pass or the failing gate's name.
    Scalar numpy: these run per candidate in the host-side accept chain."""
    accum_d = new_accum - old_accum
    if accum_d <= cfg.accum_distance_thresh:
        return "accum_distance"
    # barometer gate: only when the OLD keyframe carries an altitude
    if old_alt is not None and new_alt is not None:
        if abs(float(old_alt) - float(new_alt)) > cfg.max_baro_difference:
            return "barometer"
    yaw_diff = abs((new_yaw - old_yaw + np.pi) % (2 * np.pi) - np.pi)
    if np.rad2deg(yaw_diff) >= cfg.max_yaw_difference_deg:
        return "yaw"
    diff = np.asarray(new_pos) - np.asarray(old_pos)
    rad_lle = cfg.ellipse_base + dist_since_last_loop * cfg.odom_drift_xy * cfg.drift_scale_xy
    if (diff[0] / rad_lle) ** 2 + (diff[1] / rad_lle) ** 2 > 1.0:
        return "ellipse_since_last_loop"
    rad_xy = 10.0 + cfg.odom_drift_xy * accum_d * cfg.drift_scale_xy
    if (diff[0] / rad_xy) ** 2 + (diff[1] / rad_xy) ** 2 > 1.0:
        return "ellipse_accum"
    return ""


def candidate_gates_np(*args, **kwargs) -> bool:
    """Boolean view of `candidate_gate_reason` (True = candidate passes)."""
    return not candidate_gate_reason(*args, **kwargs)


def odometry_check(T_loop_ij, odom_new, odom_old, idx_new, idx_old, cfg: LoopConfig):
    """Per-edge drift bound (`loop_detector.cpp:249-267`)."""
    T_odom_ji = np.linalg.inv(odom_new) @ odom_old
    T_err = np.asarray(T_loop_ij) @ T_odom_ji
    n = max(idx_new - idx_old, 1)
    trans_err = np.linalg.norm(T_err[:3, 3]) / n
    rot_err = _rot_angle_np(T_err[:3, :3]) / n
    return trans_err <= cfg.odom_check_trans_thresh and rot_err <= cfg.odom_check_rot_thresh


def pairwise_consistency_check(
    T_loop_ij, odom_li, T_loop_kl_inv, odom_jk, cfg: LoopConfig,
    span_dist: float = 0.0,
):
    """Consistency vs the previous loop (`loop_detector.cpp:270-297`);
    with `cfg.pairwise_drift_scaled` the translation bound grows with
    `span_dist`, the distance travelled along the cycle's odometry spans."""
    T_err = np.asarray(T_loop_ij) @ odom_li @ T_loop_kl_inv @ odom_jk
    trans_err = np.linalg.norm(T_err[:3, 3])
    rot_err = _rot_angle_np(T_err[:3, :3])
    thr_t = cfg.pairwise_check_trans_thresh
    if cfg.pairwise_drift_scaled:
        thr_t = min(
            thr_t + cfg.odom_drift_xy * cfg.drift_scale_xy * float(span_dist),
            cfg.pairwise_trans_cap,
        )
    return trans_err <= thr_t and rot_err <= cfg.pairwise_check_rot_thresh


def _candidate_mask(i, poses, yaw_all, accum, alts, dist_since, cfg: LoopConfig):
    """The `find_candidates` gates of keyframe i against every older one,
    vectorised: (i,) bool."""
    accum_d = accum[i] - accum[:i]
    mk = accum_d > cfg.accum_distance_thresh
    if alts is not None and alts[i] is not None:
        old_alts = np.array([np.nan if a is None else float(a) for a in alts[:i]])
        mk &= ~(np.abs(old_alts - float(alts[i])) > cfg.max_baro_difference)
    yaw_diff = np.abs((yaw_all[i] - yaw_all[:i] + np.pi) % (2 * np.pi) - np.pi)
    mk &= np.rad2deg(yaw_diff) < cfg.max_yaw_difference_deg
    diff = poses[:i, :3, 3] - poses[i][:3, 3][None, :]
    rad_lle = cfg.ellipse_base + dist_since * cfg.odom_drift_xy * cfg.drift_scale_xy
    mk &= (diff[:, 0] / rad_lle) ** 2 + (diff[:, 1] / rad_lle) ** 2 <= 1.0
    rad_xy = 10.0 + cfg.odom_drift_xy * accum_d * cfg.drift_scale_xy
    mk &= (diff[:, 0] / rad_xy) ** 2 + (diff[:, 1] / rad_xy) ** 2 <= 1.0
    return mk


@dataclass
class LoopDetector:
    """Host-side orchestrator over the batched device work. The
    Scan-Context database lives on `device`: the card unless the caller
    asks for the CPU (without a card, the default raises)."""

    cfg: LoopConfig = LoopConfig()
    sc_cfg: ScanContextConfig = ScanContextConfig()
    gicp_cfg: GICPConfig = GICPConfig()
    info_cfg: InformationConfig = InformationConfig()
    capacity: int = 1024
    db: Optional[ScanContextDB] = None
    last_loop_accum: float = 0.0
    loops: list = field(default_factory=list)
    # per-gate rejection counters (which gate starves recall)
    gate_counts: dict = field(default_factory=dict)
    # per-verified-candidate decision log (pair, seed, fitness, |t|, cycle
    # errors, final gate)
    candidate_log: list = field(default_factory=list)
    device: torch.device = torch.device("cuda")
    # outer LM iterations of every verification batch (= nn1_select launches)
    verify_iterations: int = 0

    def _count(self, gate: str, n: int = 1):
        self.gate_counts[gate] = self.gate_counts.get(gate, 0) + n

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"LoopDetector(device={self.device}): no CUDA device is "
                               "available (pass device='cpu' to run on the CPU)")
        if self.db is None:
            self.db = ScanContextDB.create(self.capacity, self.sc_cfg, device=self.device)

    def add_keyframe(self, cloud: PointCloud):
        """`makeAndSaveScancontextAndKeys`: the descriptor goes into the DB,
        which doubles when full."""
        desc = make_scancontext(cloud, self.sc_cfg).to(self.db.descs.dtype)
        if self.db.count >= self.db.descs.shape[0]:
            self.db = self.db.grow()
        self.db = self.db.add(desc.to(self.db.descs.device))

    def _coarse_cfg(self):
        return self.gicp_cfg._replace(max_correspondence_distance=self.cfg.coarse_corr_dist)

    def detect(
        self,
        new_index: int,
        new_cloud: PointCloud,
        keyframe_clouds,
        keyframe_poses,
        keyframe_odoms,
        keyframe_accum,
        keyframe_altitudes=None,
    ) -> Optional[Loop]:
        """The full gate chain for one new keyframe (whose descriptor must
        already be in the DB at `new_index`), verified pair by pair."""
        cfg = self.cfg
        if self.loops:  # loop-corrected estimate: widen the ellipse floor
            cfg = cfg._replace(ellipse_base=cfg.ellipse_base_after_first)
        poses = np.asarray(keyframe_poses)
        accum = np.asarray(keyframe_accum)
        new_accum = accum[new_index]
        dist_since = new_accum - self.last_loop_accum
        if dist_since < cfg.min_loop_interval_dist:
            self._count("interval")
            return None

        db = self.db
        alts = keyframe_altitudes
        yaw_all = np.arctan2(poses[:, 1, 0], poses[:, 0, 0])
        yaw_new = yaw_all[new_index]
        mask = _candidate_mask(new_index, poses, yaw_all, accum, alts, dist_since, cfg)
        if not mask.any():
            self._count("no_eligible_candidate")
            return None
        full_mask = np.zeros(db.descs.shape[0], bool)
        full_mask[:new_index] = mask
        match, _, sc_dist = detect_loop(
            db._replace(count=new_index), db.descs[new_index], self.sc_cfg,
            cand_mask=torch.as_tensor(full_mask, device=db.descs.device),
        )
        match, sc_dist = int(match), float(sc_dist)
        if match < 0:
            self._count("sc_distance" if np.isfinite(sc_dist) else "sc_no_candidate")
            return None
        reason = candidate_gate_reason(
            poses[new_index][:3, 3], yaw_new, new_accum,
            poses[match][:3, 3], yaw_all[match], accum[match], dist_since, cfg,
            new_alt=None if alts is None else alts[new_index],
            old_alt=None if alts is None else alts[match],
        )
        if reason:  # defense in depth: the mask already enforced these
            self._count(reason)
            return None

        # coarse-to-fine align of new (source) to old from the estimate and
        # the co-location seeds
        dev = new_cloud.xyz.device
        init = torch.as_tensor(np.linalg.inv(poses[match]) @ poses[new_index], device=dev)

        def _one(Ti):
            rc = gicp_align(new_cloud, keyframe_clouds[match], init_T=Ti, cfg=self._coarse_cfg())
            rr = gicp_align(new_cloud, keyframe_clouds[match], init_T=rc.T, cfg=self.gicp_cfg)
            self.verify_iterations += int(rc.iterations) + int(rr.iterations)
            info, fit = calc_information_matrix(
                new_cloud, keyframe_clouds[match], rr.T, self.info_cfg
            )
            return rr, info, float(fit)

        res, info, fitness = _one(init)
        res_b, info_b, fit_b = _one(torch.eye(4, dtype=init.dtype, device=dev))
        # NaN-safe seed selection (as in _verify_batch)
        f_a = fitness if np.isfinite(fitness) else np.inf
        f_b = fit_b if np.isfinite(fit_b) else np.inf
        if f_b < f_a:
            res, info, fitness = res_b, info_b, fit_b
        if not np.isfinite(fitness) or fitness > cfg.fitness_thresh:
            self._count("fitness")
            return None
        T_rel = res.T.cpu().numpy()  # maps new-frame points into the old frame
        if cfg.trans_gate_all and np.linalg.norm(T_rel[:3, 3]) > cfg.fallback_max_trans:
            self._count("fallback_trans")
            return None

        if cfg.enable_odom_check and not odometry_check(
            np.linalg.inv(T_rel), np.asarray(keyframe_odoms[new_index]),
            np.asarray(keyframe_odoms[match]), new_index, match, cfg,
        ):
            return None
        if self.loops:
            def _span_of(p):
                return abs(accum[match] - accum[p.key_old]) + abs(
                    accum[new_index] - accum[p.key_new]
                )

            prev = min(self.loops, key=_span_of) if cfg.pairwise_nearest else self.loops[-1]
            span = poses if cfg.pairwise_mode == "estimate" else np.asarray(keyframe_odoms)
            odom_li = np.linalg.inv(span[match]) @ span[prev.key_old]
            odom_jk = np.linalg.inv(span[prev.key_new]) @ span[new_index]
            if not pairwise_consistency_check(
                np.linalg.inv(T_rel), odom_li, np.asarray(prev.T_rel), odom_jk, cfg,
                span_dist=_span_of(prev),
            ):
                return None

        loop = Loop(key_new=new_index, key_old=match, T_rel=T_rel,
                    information=info.cpu().numpy(), fitness=fitness)
        self.loops.append(loop)
        self.last_loop_accum = float(new_accum)
        return loop

    def detect_batch(
        self,
        new_indices,
        keyframe_clouds,
        keyframe_poses,
        keyframe_odoms,
        keyframe_accum,
        keyframe_altitudes=None,
    ) -> list:
        """Batched `detect` over many new keyframes (`detect_batch`,
        `loop_detector.py:500-805`): one batched Scan-Context search for the
        global match and one for the gated candidates, one batched
        registration + information over the gate survivors, then the
        sequential accept chain on the host (interval, fitness, gates,
        translation, odometry and pairwise checks)."""
        if len(new_indices) == 0:
            return []
        db = self.db  # read once: a concurrent grow() swaps in new tensors
        cfg = self.cfg
        if self.loops:  # see detect(): post-first-loop ellipse floor
            cfg = cfg._replace(ellipse_base=cfg.ellipse_base_after_first)
        poses = np.asarray(keyframe_poses)
        odoms = np.asarray(keyframe_odoms)
        accum = np.asarray(keyframe_accum)
        idxs = np.asarray(new_indices, np.int64)
        n_new = len(idxs)
        alts = keyframe_altitudes

        # ---- stage 1: Scan-Context matching for all new keyframes: the
        # reference-parity global search, and a gated search with the
        # `find_candidates` gates applied inside the ring-key masking (the
        # gated matches are fallbacks used only when the global one is not
        # eligible)
        yaw_all = np.arctan2(poses[:, 1, 0], poses[:, 0, 0])
        cap = db.descs.shape[0]
        masks = np.zeros((n_new, cap), bool)
        for k, i in enumerate(idxs):
            i = int(i)
            dist_since0 = accum[i] - self.last_loop_accum  # upper-bounds the true value
            masks[k, :i] = _candidate_mask(i, poses, yaw_all, accum, alts, dist_since0, cfg)
        idxs_t = torch.as_tensor(idxs, device=db.descs.device)
        masks_t = torch.as_tensor(masks, device=db.descs.device)
        matches_g, _, dists_g = _sc_match_batch(db, idxs_t, self.sc_cfg)
        K_SC = max(1, int(cfg.sc_candidates))
        if K_SC == 1:
            matches_m = _sc_match_batch(db, idxs_t, self.sc_cfg, masks_t)[0][:, None]
        else:
            matches_m = _sc_match_batch_topk(db, idxs_t, self.sc_cfg, masks_t, K_SC)[0]
        matches_g = matches_g.cpu().numpy()
        dists_g = dists_g.cpu().numpy()
        matches_m = matches_m.cpu().numpy()
        no_eligible = ~masks.any(axis=1)

        # per-keyframe candidate lists: the gate-passing global match first,
        # then gated-search matches, deduplicated, at most K_SC entries
        cand_lists: list = [[] for _ in range(n_new)]
        for k in range(n_new):
            cl = cand_lists[k]
            mg = int(matches_g[k])
            if mg >= 0 and masks[k, mg]:
                cl.append((mg, False))
            for r in range(matches_m.shape[1]):
                mm = int(matches_m[k, r])
                if mm >= 0 and len(cl) < K_SC and all(mm != c0 for c0, _ in cl):
                    cl.append((mm, True))
                    self._count("gated_fallback_match")

        # ---- stage 2: host prefilter before verification (safe with
        # in-batch accepts: last_loop_accum only grows)
        pairs = []
        for k, i in enumerate(idxs):
            i = int(i)
            dist_since0 = accum[i] - self.last_loop_accum
            if not cand_lists[k]:
                mg = int(matches_g[k])
                if mg >= 0 and not masks[k, mg]:
                    # the global match failed a gate and no gated candidate
                    # cleared the SC threshold: attribute the gate
                    reason = candidate_gate_reason(
                        poses[i][:3, 3], yaw_all[i], accum[i],
                        poses[mg][:3, 3], yaw_all[mg], accum[mg], dist_since0, cfg,
                        new_alt=None if alts is None else alts[i],
                        old_alt=None if alts is None else alts[mg],
                    )
                    self._count(reason or "gated_sc_distance")
                elif no_eligible[k]:
                    self._count("no_eligible_candidate")
                else:
                    self._count("sc_distance" if np.isfinite(dists_g[k]) else "sc_no_candidate")
                continue
            if dist_since0 < cfg.min_loop_interval_dist:
                self._count("interval")
                continue
            for m, fb in cand_lists[k]:
                reason = candidate_gate_reason(
                    poses[i][:3, 3], yaw_all[i], accum[i],
                    poses[m][:3, 3], yaw_all[m], accum[m], dist_since0, cfg,
                    new_alt=None if alts is None else alts[i],
                    old_alt=None if alts is None else alts[m],
                )
                if reason:
                    self._count(reason)
                    continue
                pairs.append((i, m, fb))
        if not pairs:
            return []

        # ---- stage 3: batched verification, pairs grouped by (source,
        # target) cloud capacity so that each group stacks
        n_pairs = len(pairs)
        Ts = np.zeros((n_pairs, 4, 4))
        conv = np.zeros(n_pairs, bool)
        infos = np.zeros((n_pairs, 6, 6))
        fits = np.full(n_pairs, np.inf)
        groups = {}
        for n, (i, m, _fb) in enumerate(pairs):
            kcap = (keyframe_clouds[i].capacity, keyframe_clouds[m].capacity)
            groups.setdefault(kcap, []).append(n)
        for members in groups.values():
            gp = [pairs[n] for n in members]
            src = _stack([keyframe_clouds[i] for i, _, _ in gp])
            tgt = _stack([keyframe_clouds[m] for _, m, _ in gp])
            # each verification starts at the current estimated old_T_new
            init = torch.as_tensor(
                np.stack([np.linalg.inv(poses[m]) @ poses[i] for i, m, _ in gp]),
                device=src.xyz.device,
            )
            T_g, c_g, i_g, f_g, iters = _verify_batch(
                src, tgt, init, self.gicp_cfg, self._coarse_cfg(), self.info_cfg
            )
            self.verify_iterations += iters
            Ts[members] = T_g.cpu().numpy()
            conv[members] = c_g.numpy()
            infos[members] = i_g.cpu().numpy()
            fits[members] = f_g.cpu().numpy()

        # ---- stage 4: sequential accept chain (host): keyframes ascending,
        # a keyframe's candidates in verified-fitness order, at most one
        # accepted loop per keyframe
        by_i: dict = {}
        for n, (i, m, fb) in enumerate(pairs):
            by_i.setdefault(i, []).append(n)
        order = []
        for i in sorted(by_i):
            order.extend(sorted(by_i[i], key=lambda n: fits[n]))
        accepted = []
        accepted_i = set()
        for n in order:
            i, m, fb = pairs[n]
            if i in accepted_i:
                continue
            T_rel = Ts[n]
            est_rel = np.linalg.inv(poses[m]) @ poses[i]
            rec = {
                "new": int(i), "old": int(m), "fallback": bool(fb),
                "fitness": float(fits[n]),
                "t_norm": float(np.linalg.norm(T_rel[:3, 3])),
                # disagreement between the verified transform and the graph
                # estimate of the same relative pose
                "est_err": float(np.linalg.norm((np.linalg.inv(est_rel) @ T_rel)[:3, 3])),
                "gate": "accepted",
            }
            self.candidate_log.append(rec)
            # the LM convergence flag is counted, not gating (PCL's
            # hasConverged() is always true); non-finite fitness rejects
            if not bool(conv[n]):
                self._count("not_converged")
            if not np.isfinite(fits[n]) or float(fits[n]) > cfg.fitness_thresh:
                rec["gate"] = "fitness"
                self._count("fitness")
                continue
            new_accum = accum[i]
            dist_since = new_accum - self.last_loop_accum
            if dist_since < cfg.min_loop_interval_dist:
                rec["gate"] = "interval"
                self._count("interval")
                continue
            reason = candidate_gate_reason(
                poses[i][:3, 3], yaw_all[i], new_accum,
                poses[m][:3, 3], yaw_all[m], accum[m], dist_since, cfg,
                new_alt=None if alts is None else alts[i],
                old_alt=None if alts is None else alts[m],
            )
            if reason:
                rec["gate"] = reason
                self._count(reason)
                continue
            if (fb or cfg.trans_gate_all) and (
                np.linalg.norm(T_rel[:3, 3]) > cfg.fallback_max_trans
            ):
                # the match asserts co-location; a verified transform that
                # moves the keyframe far is a displaced-basin "success"
                rec["gate"] = "fallback_trans"
                self._count("fallback_trans")
                continue
            if cfg.enable_odom_check and not odometry_check(
                np.linalg.inv(T_rel), odoms[i], odoms[m], i, m, cfg
            ):
                rec["gate"] = "odom_check"
                self._count("odom_check")
                continue
            if self.loops:
                def _span_of(p):
                    return abs(accum[m] - accum[p.key_old]) + abs(accum[i] - accum[p.key_new])

                prev = (
                    min(self.loops, key=_span_of) if cfg.pairwise_nearest else self.loops[-1]
                )
                span = poses if cfg.pairwise_mode == "estimate" else odoms
                odom_li = np.linalg.inv(span[m]) @ span[prev.key_old]
                odom_jk = np.linalg.inv(span[prev.key_new]) @ span[i]
                T_err = np.linalg.inv(T_rel) @ odom_li @ np.asarray(prev.T_rel) @ odom_jk
                span_dist = _span_of(prev)
                rec["pairwise_trans"] = float(np.linalg.norm(T_err[:3, 3]))
                rec["pairwise_rot"] = _rot_angle_np(T_err[:3, :3])
                rec["span_dist"] = float(span_dist)
                rec["prev"] = [int(prev.key_new), int(prev.key_old)]
                if not pairwise_consistency_check(
                    np.linalg.inv(T_rel), odom_li, np.asarray(prev.T_rel), odom_jk, cfg,
                    span_dist=span_dist,
                ):
                    rec["gate"] = "pairwise"
                    self._count("pairwise")
                    continue
            loop = Loop(key_new=i, key_old=m, T_rel=T_rel, information=infos[n],
                        fitness=float(fits[n]))
            self.loops.append(loop)
            self.last_loop_accum = float(new_accum)
            self._count("accepted")
            accepted.append(loop)
            accepted_i.add(i)
        return accepted
