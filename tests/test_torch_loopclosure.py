"""Port parity: `gorio_tpu_torch.loopclosure` (Scan Context, the gates,
batched verification, `LoopDetector`) and the batched LM
(`registration.lsq.lm_optimize_batch`) against the JAX package on the same
inputs, on the CPU (the kernels' plain versions).

Tolerances, each with its reason:
- descriptors: a max over the same intensities, so exactly equal; their
  ring and sector keys are means, equal up to summation order (1e-14);
- `sc_distance`: the same float64 cosine sums up to summation order, 1e-12,
  and the same shift;
- candidate searches: the same ring-key distances and the same tie rule
  (the lower index first), so equal matches, also where ineligible entries
  tie at +inf;
- verification: the same float64 LM on the same correspondences; the
  reduction order differs (XLA against torch), so T atol 1e-8, information
  and fitness rtol 1e-8, equal flags;
- `detect_batch`: decisions are equal, T_rel atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gorio_tpu.io.synthetic import make_world, render_radar_scan
from gorio_tpu.loopclosure import information as jinfo
from gorio_tpu.loopclosure import loop_detector as jl
from gorio_tpu.loopclosure import scancontext as jsc
from gorio_tpu.registration import gicp as jg
from gorio_tpu_torch.convert import cloud_from_numpy, config_from_dict, scancontext_db_from_numpy
from gorio_tpu_torch.loopclosure import information as tinfo
from gorio_tpu_torch.loopclosure import loop_detector as tl
from gorio_tpu_torch.loopclosure import scancontext as tsc
from gorio_tpu_torch.registration import gicp as tg
from gorio_tpu_torch.registration import lsq as tlsq

LAP, LAPS, RADIUS = 24, 1.5, 6.0  # keyframes per lap of a 37.7 m circle
LOOP = dict(accum_distance_thresh=20.0, min_loop_interval_dist=10.0,
            odom_check_trans_thresh=1.0, odom_check_rot_thresh=0.3)


@pytest.fixture(scope="module")
def circuit():
    """Keyframes on 1.5 laps of a circle: radar scans rendered at the true
    poses, odometry with a yaw drift of 3 mrad per keyframe (the pose
    estimate the detector sees)."""
    world = make_world(seed=61, n_landmarks=6000, extent=40.0)
    n = int(LAP * LAPS)
    truth, clouds = [], []
    for k in range(n):
        a = 2 * np.pi * k / LAP
        T = np.eye(4)
        T[:3, :3] = Rotation.from_euler("z", a + np.pi / 2).as_matrix()
        T[:3, 3] = [RADIUS * np.cos(a), RADIUS * np.sin(a), 0.0]
        truth.append(T)
        clouds.append(render_radar_scan(world, T[:3, :3], T[:3, 3], np.array([3.0, 0, 0]),
                                        capacity=512, seed=700 + k, dropout=0.1))
    drift = np.eye(4)
    drift[:3, :3] = Rotation.from_euler("z", 0.003).as_matrix()
    odom = [truth[0]]
    for k in range(1, n):
        odom.append(odom[-1] @ np.linalg.inv(truth[k - 1]) @ truth[k] @ drift)
    odom = np.stack(odom)
    accum = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(odom[:, :3, 3], axis=0),
                                                            axis=1))])
    return clouds, [cloud_from_numpy(c) for c in clouds], odom, accum


@pytest.fixture(scope="module")
def descs(circuit):
    clouds = circuit[0]
    return np.stack([np.asarray(jsc.make_scancontext(c)) for c in clouds])


def _jdb(descs, capacity, count):
    db = jsc.ScanContextDB.create(capacity, dtype=jnp.float32)
    for d in descs[:count]:
        db = db.add(jnp.asarray(d))
    return db


# ---- Scan Context ---------------------------------------------------------


@pytest.mark.parametrize("k", [0, 7, 30])
def test_descriptor_equals_jax(circuit, descs, k):
    t = tsc.make_scancontext(circuit[1][k])
    np.testing.assert_array_equal(t.numpy(), descs[k])
    # the keys are means: equal up to summation order
    np.testing.assert_allclose(tsc.ring_key(t).numpy(), np.asarray(jsc.ring_key(descs[k])),
                               rtol=1e-14)
    np.testing.assert_allclose(tsc.sector_key(t).numpy(), np.asarray(jsc.sector_key(descs[k])),
                               rtol=1e-14)


def test_sc_distance_matches_jax(descs):
    """Every pair among a few keyframes, float64, plus a descriptor with
    empty columns and one that is all zero (no effective column)."""
    d = descs[[0, 5, 24, 29]].astype(np.float64)
    holes = d[1].copy()
    holes[:, ::3] = 0.0
    d = np.concatenate([d, holes[None], np.zeros_like(d[:1])])
    for a in d:
        for b in d:
            jd, js = jsc.sc_distance(jnp.asarray(a), jnp.asarray(b))
            td, ts = tsc.sc_distance(torch.as_tensor(a), torch.as_tensor(b))
            np.testing.assert_allclose(float(td), float(jd), rtol=0, atol=1e-12)
            assert int(ts) == int(js)


@pytest.mark.parametrize("count,masked", [(36, False), (36, True), (12, False), (14, True)])
def test_detect_loop_matches_jax(descs, count, masked):
    """`detect_loop` and `detect_loop_topk` of the last keyframe in a DB of
    `count`: with 12 or 14 entries and the 10 most recent excluded, fewer
    than `num_candidates` entries are eligible, and the ineligible ones tie
    at +inf."""
    cfg = jsc.ScanContextConfig()
    jdb = _jdb(descs, 48, count)
    tdb = scancontext_db_from_numpy(jdb)
    q = descs[count - 1]
    mask = np.zeros(48, bool)
    if masked:
        mask[np.arange(0, count, 3)] = True
    jm = jnp.asarray(mask) if masked else None
    tm = torch.as_tensor(mask) if masked else None
    want = jsc.detect_loop(jdb, jnp.asarray(q), cfg, cand_mask=jm)
    got = tsc.detect_loop(tdb, torch.as_tensor(q), cand_mask=tm)
    assert int(got[0]) == int(want[0])
    np.testing.assert_allclose([float(got[1]), float(got[2])], [float(want[1]), float(want[2])],
                               rtol=1e-6)
    want = jsc.detect_loop_topk(jdb, jnp.asarray(q), cfg, cand_mask=jm, k=2)
    got = tsc.detect_loop_topk(tdb, torch.as_tensor(q), cand_mask=tm, k=2)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-6)


def test_sc_match_batch_matches_jax(descs):
    """The batched global and gated searches of `detect_batch`: query i
    sees only entries below i - num_exclude_recent."""
    cfg = jsc.ScanContextConfig()
    jdb = _jdb(descs, 64, len(descs))
    tdb = scancontext_db_from_numpy(jdb)
    idxs = np.arange(8, len(descs))
    masks = np.random.default_rng(3).random((len(idxs), 64)) < 0.4
    for jm, tm in ((None, None), (jnp.asarray(masks), torch.as_tensor(masks))):
        want = jl._sc_match_batch(jdb, jnp.asarray(idxs, jnp.int32), cfg, masks=jm)
        got = tl._sc_match_batch(tdb, torch.as_tensor(idxs), tsc.ScanContextConfig(), masks=tm)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-6)
    want = jl._sc_match_batch_topk(jdb, jnp.asarray(idxs, jnp.int32), cfg, jnp.asarray(masks), 2)
    got = tl._sc_match_batch_topk(tdb, torch.as_tensor(idxs), tsc.ScanContextConfig(),
                                  torch.as_tensor(masks), 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_descriptor_images_equal_jax(descs, tmp_path):
    """The numpy image helpers, copied from the JAX package, on a tensor."""
    a, b = descs[3], descs[27]
    np.testing.assert_array_equal(tsc.sc_image(torch.as_tensor(a)), jsc.sc_image(a))
    img = tsc.sc_pair_image(torch.as_tensor(a), torch.as_tensor(b), upscale=4)
    np.testing.assert_array_equal(img, jsc.sc_pair_image(a, b, upscale=4))
    tsc.save_pgm(tmp_path / "t.pgm", img)
    jsc.save_pgm(tmp_path / "j.pgm", img)
    assert (tmp_path / "t.pgm").read_bytes() == (tmp_path / "j.pgm").read_bytes()


def test_db_grows_past_capacity(circuit):
    det = tl.LoopDetector(capacity=4, device="cpu")
    for c in circuit[1][:9]:
        det.add_keyframe(c)
    assert det.db.count == 9 and det.db.descs.shape[0] == 16
    np.testing.assert_array_equal(det.db.descs[8].numpy(),
                                  tsc.make_scancontext(circuit[1][8]).float().numpy())


# ---- the numpy gates (copied from the JAX package) ------------------------


@pytest.mark.parametrize("seed", range(4))
def test_gates_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        args = (rng.normal(size=3) * 8, rng.uniform(-3, 3), rng.uniform(0, 120),
                rng.normal(size=3) * 8, rng.uniform(-3, 3), rng.uniform(0, 60),
                rng.uniform(0, 80))
        alts = dict(new_alt=rng.uniform(0, 4), old_alt=rng.uniform(0, 4)) if seed % 2 else {}
        assert tl.candidate_gate_reason(*args, tl.LoopConfig(), **alts) == \
            jl.candidate_gate_reason(*args, jl.LoopConfig(), **alts)
        T = [np.eye(4) for _ in range(4)]
        for M in T:
            M[:3, :3] = Rotation.from_rotvec(rng.normal(size=3) * 0.1).as_matrix()
            M[:3, 3] = rng.normal(size=3)
        n_new, n_old = int(rng.integers(1, 40)), int(rng.integers(0, 20))
        assert tl.odometry_check(T[0], T[1], T[2], n_new, n_old, tl.LoopConfig()) == \
            jl.odometry_check(T[0], T[1], T[2], n_new, n_old, jl.LoopConfig())
        span = rng.uniform(0, 100)
        assert tl.pairwise_consistency_check(*T, tl.LoopConfig(), span_dist=span) == \
            jl.pairwise_consistency_check(*T, jl.LoopConfig(), span_dist=span)


def test_loop_configs_carry_over():
    assert tl.LoopConfig() == config_from_dict(tl.LoopConfig, jl.LoopConfig()._asdict())
    assert tl.LoopConfig()._asdict() == jl.LoopConfig()._asdict()
    assert tsc.ScanContextConfig()._asdict() == jsc.ScanContextConfig()._asdict()


# ---- batched LM and verification ------------------------------------------


def _pairs(circuit, n):
    """n (new, old) revisit pairs with the drifted estimate as the seed."""
    clouds, tclouds, odom, _ = circuit
    pairs = [(i, i - LAP + d) for d in (0, 1, -1) for i in range(LAP, len(clouds))][:n]
    init = np.stack([np.linalg.inv(odom[m]) @ odom[i] for i, m in pairs])
    return pairs, init


def test_lm_optimize_batch_matches_single_lanes(circuit):
    """Each lane of the batched LM returns what `lm_optimize` returns for
    its pair alone: lanes converge after different iteration counts, and
    one starts from a NaN pose and fails at once."""
    clouds, tclouds, odom, _ = circuit
    pairs, init = _pairs(circuit, 6)
    init[2, 0, 3] = np.nan
    cfg = tg.GICPConfig(max_correspondence_distance=10.0)
    src = tl._stack([tclouds[i] for i, _ in pairs])
    tgt = tl._stack([tclouds[m] for _, m in pairs])
    batch = tg.gicp_align_batch(src, tgt, torch.as_tensor(init), cfg)
    assert len(set(batch.iterations.tolist())) > 2
    for k, (i, m) in enumerate(pairs):
        if k == 2:
            continue
        one = tg.gicp_align(tclouds[i], tclouds[m], torch.as_tensor(init[k]), cfg)
        assert int(batch.iterations[k]) == int(one.iterations)
        assert bool(batch.converged[k]) == bool(one.converged)
        np.testing.assert_allclose(batch.T[k].numpy(), one.T.numpy(), atol=1e-10)
        np.testing.assert_allclose(batch.H[k].numpy(), one.H.numpy(), rtol=1e-9, atol=1e-6)
        np.testing.assert_allclose(float(batch.error[k]), float(one.error), rtol=1e-9)
    assert np.isnan(batch.T[2].numpy()).any() and int(batch.iterations[2]) == 1
    assert not bool(batch.converged[2])


def test_information_batched_matches_jax(circuit):
    clouds, tclouds, _, _ = circuit
    pairs, init = _pairs(circuit, 4)
    js = jax.tree.map(lambda *x: jnp.stack(x), *[clouds[i] for i, _ in pairs])
    jt = jax.tree.map(lambda *x: jnp.stack(x), *[clouds[m] for _, m in pairs])
    ji, jf = jax.vmap(lambda s, t, T: jinfo.calc_information_matrix(s, t, T))(
        js, jt, jnp.asarray(init))
    ti, tf = tinfo.calc_information_matrix(tl._stack([tclouds[i] for i, _ in pairs]),
                                           tl._stack([tclouds[m] for _, m in pairs]),
                                           torch.as_tensor(init))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-10)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-10)


def test_verify_batch_matches_jax(circuit, monkeypatch):
    """`_verify_batch` lane by lane against the JAX package's vmapped one,
    from both seeds. Lane 1's estimate seed is NaN. `fitness_score` gives
    such a seed fitness 0 (no inlier), so both packages' information step is
    wrapped to report a non-finite pose's fitness as NaN, the diverged
    result the NaN-safe seed selection guards against: the co-location seed
    must win there."""
    clouds, tclouds, _, _ = circuit
    pairs, init = _pairs(circuit, 8)
    init[1, 1, 3] = np.nan

    def j_info(s, t, T, cfg):
        info, fit = jinfo.calc_information_matrix(s, t, T, cfg)
        return info, jnp.where(jnp.isnan(T).any(), jnp.nan, fit)

    def t_info(s, t, T, cfg):
        info, fit = tinfo.calc_information_matrix(s, t, T, cfg)
        return info, torch.where(torch.isnan(T).flatten(-2).any(-1), float("nan"), fit)

    monkeypatch.setattr(jl, "calc_information_matrix", j_info)
    monkeypatch.setattr(tl, "calc_information_matrix", t_info)
    j_verify = jax.jit(jl._verify_batch.__wrapped__,  # traced anew, with the wrapper
                       static_argnames=("gicp_cfg", "coarse_cfg", "info_cfg"))
    gcfg = jg.GICPConfig()
    js = jax.tree.map(lambda *x: jnp.stack(x), *[clouds[i] for i, _ in pairs])
    jt = jax.tree.map(lambda *x: jnp.stack(x), *[clouds[m] for _, m in pairs])
    jT, jc, ji, jf = j_verify(js, jt, jnp.asarray(init), gcfg,
                              gcfg._replace(max_correspondence_distance=10.0),
                              jinfo.InformationConfig())
    tT, tc, ti, tf, iters = tl._verify_batch(
        tl._stack([tclouds[i] for i, _ in pairs]), tl._stack([tclouds[m] for _, m in pairs]),
        torch.as_tensor(init), tg.GICPConfig(), tg.GICPConfig(max_correspondence_distance=10.0),
        tinfo.InformationConfig())
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-8)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-8)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-8)
    assert np.isfinite(tf.numpy()).all() and np.isfinite(tT.numpy()).all()
    assert iters > 0


def test_detect_batch_matches_jax(circuit):
    """Both detectors fed the same keyframes (DB capacity 16, so it grows
    twice) and asked in two calls, as `optimize` asks: the same accepted
    pairs, the same verified transforms, the same gate counts."""
    clouds, tclouds, odom, accum = circuit
    jdet = jl.LoopDetector(cfg=jl.LoopConfig(**LOOP), capacity=16)
    tdet = tl.LoopDetector(cfg=tl.LoopConfig(**LOOP), capacity=16, device="cpu")
    for c, tc in zip(clouds, tclouds):
        jdet.add_keyframe(c)
        tdet.add_keyframe(tc)
    np.testing.assert_array_equal(tdet.db.descs.numpy(), np.asarray(jdet.db.descs))
    got, want = [], []
    for chunk in (range(0, LAP), range(LAP, len(clouds))):
        want += jdet.detect_batch(list(chunk), clouds, odom, odom, accum)
        got += tdet.detect_batch(list(chunk), tclouds, odom, odom, accum)
    assert want, "the JAX detector accepts no loop on this circuit"
    assert [(l.key_new, l.key_old) for l in got] == [(l.key_new, l.key_old) for l in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.T_rel, np.asarray(w.T_rel), atol=1e-6)
        np.testing.assert_allclose(g.information, np.asarray(w.information), rtol=1e-6)
    assert tdet.gate_counts == jdet.gate_counts
    assert [r["gate"] for r in tdet.candidate_log] == [r["gate"] for r in jdet.candidate_log]
    assert tdet.verify_iterations > 0


def test_detect_matches_jax(circuit):
    """`LoopDetector.detect`, the one-keyframe path verified pair by pair:
    the same loop (or none) for a revisiting keyframe and one that is not."""
    clouds, tclouds, odom, accum = circuit
    jdet = jl.LoopDetector(cfg=jl.LoopConfig(**LOOP), capacity=64)
    tdet = tl.LoopDetector(cfg=tl.LoopConfig(**LOOP), capacity=64, device="cpu")
    for c, tc in zip(clouds, tclouds):
        jdet.add_keyframe(c)
        tdet.add_keyframe(tc)
    for i in (LAP + 2, 5):
        want = jdet.detect(i, clouds[i], clouds, odom, odom, accum)
        got = tdet.detect(i, tclouds[i], tclouds, odom, odom, accum)
        assert (got is None) == (want is None)
        if want is not None:
            assert (got.key_new, got.key_old) == (want.key_new, want.key_old)
            np.testing.assert_allclose(got.T_rel, np.asarray(want.T_rel), atol=1e-6)
            np.testing.assert_allclose(got.fitness, want.fitness, rtol=1e-6)
    assert tdet.gate_counts == jdet.gate_counts and len(tdet.loops) == len(jdet.loops) == 1


def test_loop_detector_defaults_to_the_card():
    """`LoopDetector()` puts its Scan-Context DB on CUDA; without a card it
    raises instead of falling back to the CPU, as `RadarGraphSLAM()` does."""
    assert tl.LoopDetector.device == torch.device("cuda")
    if torch.cuda.is_available():
        assert tl.LoopDetector().db.descs.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.LoopDetector()
    assert tl.LoopDetector(device="cpu").db.descs.device == torch.device("cpu")
