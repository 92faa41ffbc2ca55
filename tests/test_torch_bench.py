"""Port parity: `gorio_tpu_torch/bench.py` against the root `bench.py` (the
JAX CLI's `bench`), loaded by path, and the JAX package's functions it calls.

Tolerances: `synth_pair`, `downsample_np` and `make_solve_graph` are the
same numpy arithmetic on the same seeds, so they agree to the bit. The NDT
readings run the same Newton iterations in float64 in both packages; only
reduction order differs, so fitness agrees to 1e-9 relative and the
known-pose errors to 1e-9 m / 1e-7 deg. The quality pass's scoring is the
same float64 arithmetic (1e-10). Nothing here times anything: the bench's
times come only from the card."""

import ast
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gorio_tpu.core import lie as jlie
from gorio_tpu.core.pointcloud import make_cloud as j_make_cloud
from gorio_tpu.inference.hmc import chain_ess as j_chain_ess
from gorio_tpu.inference.hmc import potential_scale_reduction as j_rhat
from gorio_tpu.registration import ndt as jndt
from gorio_tpu.registration.gicp import fitness_score as j_fitness
from gorio_tpu_torch import bench as tbench
from gorio_tpu_torch.cli import main as cli

ROOT = Path(__file__).resolve().parents[1]
PAIR_N = 4000  # points of the small synthetic pair


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jbench():
    spec = importlib.util.spec_from_file_location("root_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_inputs_equal_bench_py(jbench):
    """synth_pair, downsample_np and make_solve_graph(40) give bench.py's
    arrays to the bit."""
    for (a, ia), (b, ib) in zip(tbench.synth_pair(n=PAIR_N, seed=3),
                                jbench.synth_pair(n=PAIR_N, seed=3)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ia, ib)
    xyz = tbench.synth_pair(n=PAIR_N)[0][0]
    np.testing.assert_array_equal(tbench.downsample_np(xyz), jbench.downsample_np(xyz))
    tp, tg = tbench.make_solve_graph(40).freeze()
    jp, jg = jbench.make_solve_graph(40).freeze()
    assert tp.dtype == torch.float32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    for jf, tf in zip(jg, tg):
        for a, b in zip(jf, tf):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_ndt_quality_matches_jax():
    """`ndt_quality` on a small synth_pair in float64 on the CPU gives the
    fitness, identity fitness and known-pose errors of bench.py's JAX code
    (`bench.py:301-331`) on the same numpy clouds."""
    (a, _), (b, _) = tbench.synth_pair(n=PAIR_N)
    inp = tbench.ndt_inputs(a, b, torch.device("cpu"), dtype=torch.float64)
    got = tbench.ndt_quality(inp)

    cap = inp.source.xyz.shape[0]
    target, source = (j_make_cloud(jnp.asarray(tbench.downsample_np(x), jnp.float64),
                                   capacity=cap) for x in (a, b))
    cfg = jndt.NDTConfig(resolution=1.0, neighborhood="direct7", voxel_capacity=32768)
    vmap_t = jndt.build_voxel_map(target, cfg)
    vmap_c = jndt.build_voxel_map(target, jndt.coarse_cfg(cfg))
    eye = jnp.eye(4, dtype=jnp.float64)
    res = jndt.ndt_align_multires(source, vmap_c, vmap_t, eye, cfg)
    fit, _ = j_fitness(source, target, res.T, max_range=jnp.inf)
    fit0, _ = j_fitness(source, target, eye, max_range=jnp.inf)
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, :3] = Rotation.from_euler("zyx", [0.03, 0.01, -0.008]).as_matrix()
    T_true[:3, 3] = [0.5, -0.3, 0.1]
    T_true = jnp.asarray(T_true, jnp.float64)
    pert = target._replace(xyz=jnp.where(target.mask[:, None],
                                         target.xyz @ T_true[:3, :3].T + T_true[:3, 3],
                                         target.xyz))
    dT = jndt.ndt_align_multires(pert, vmap_c, vmap_t, eye, cfg).T @ T_true
    want = {"fitness": float(fit), "fitness_identity": float(fit0),
            "known_pose_trans_err_m": float(jnp.linalg.norm(dT[:3, 3])),
            "known_pose_rot_err_deg": float(np.rad2deg(float(jlie.rotation_geodesic_angle(
                dT[:3, :3], jnp.eye(3, dtype=jnp.float64)))))}
    assert got["fitness"] < got["fitness_identity"]
    assert got["ndt_iterations"] == int(res.iterations)
    np.testing.assert_allclose(got["fitness"], want["fitness"], rtol=1e-9)
    np.testing.assert_allclose(got["fitness_identity"], want["fitness_identity"], rtol=1e-9)
    np.testing.assert_allclose(got["known_pose_trans_err_m"], want["known_pose_trans_err_m"],
                               atol=1e-9)
    np.testing.assert_allclose(got["known_pose_rot_err_deg"], want["known_pose_rot_err_deg"],
                               atol=1e-7)


def test_quality_scoring_matches_jax():
    """`score_chains` (the whitened draws' pose embedding, Geyer ESS and
    split R-hat) on seeded numpy draws equals bench.py's scoring with the
    JAX package's functions (`bench.py:667-693`)."""
    rng = np.random.default_rng(4)
    C, S, K = 4, 48, 5
    D = 6 * K
    ys = rng.normal(size=(C, S, D)) + 0.3 * rng.normal(size=(C, 1, D))
    A = rng.normal(size=(D, D))
    L = np.linalg.cholesky(A @ A.T + D * np.eye(D))
    poses = np.tile(np.eye(4), (K, 1, 1))
    poses[:, :3, :3] = Rotation.from_rotvec(rng.normal(size=(K, 3))).as_matrix()
    poses[:, :3, 3] = rng.normal(size=(K, 3))
    got = tbench.score_chains(torch.as_tensor(ys), torch.as_tensor(L), torch.as_tensor(poses))

    Lw = jnp.asarray(L)

    def embed(y):
        x = jax.scipy.linalg.solve_triangular(Lw, y, lower=True, trans=1).reshape(K, 6)
        T = jax.vmap(lambda P, dd: P @ jlie.se3_exp_split(dd))(jnp.asarray(poses), x)
        return jnp.concatenate([T[:, :3, :3].reshape(K, 9), T[:, :3, 3]], axis=1).reshape(-1)

    es = np.asarray(jax.jit(jax.vmap(jax.vmap(embed)))(jnp.asarray(ys)))
    post = es[:, S // 4:]
    keep = post.std(axis=(0, 1)) > 1e-7
    ess = j_chain_ess(post[..., keep])
    rhat = float(np.max(np.asarray(j_rhat(jnp.asarray(post[..., keep])))))
    assert got["n_draws_scored"] == C * (S - S // 4)
    np.testing.assert_allclose(got["ess_min"], float(ess.min()), rtol=1e-10)
    np.testing.assert_allclose(got["ess_median"], float(np.median(ess)), rtol=1e-10)
    np.testing.assert_allclose(got["rhat_max"], rhat, rtol=1e-10)


def _bench_py_keys():
    """The keys of bench.py's JSON line: the literal keys of the dict that
    main() prints and every `extras[...]` key that secondary() sets, the
    f-string keys expanded over their `for` loop's values."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    keys = []
    for node in ast.walk(fns["main"]):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and isinstance(node.args[0], ast.Dict)):
            keys += [k.value for k in node.args[0].keys if isinstance(k, ast.Constant)]

    def extras(body, env):
        for node in body:
            if isinstance(node, ast.For) and isinstance(node.iter, ast.Tuple):
                for v in node.iter.elts:
                    yield from extras(node.body, {**env, node.target.id: v.value})
                continue
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Subscript) and isinstance(sub.ctx, ast.Store)
                        and isinstance(sub.value, ast.Name) and sub.value.id == "extras"):
                    key = sub.slice
                    if isinstance(key, ast.Constant):
                        yield key.value
                    else:
                        assert isinstance(key, ast.JoinedStr)
                        yield "".join(str(env[p.value.id]) if isinstance(p, ast.FormattedValue)
                                      else p.value for p in key.values)

    keys += list(extras(fns["secondary"].body, {}))
    return keys


def test_json_line_holds_every_bench_py_key():
    keys = _bench_py_keys()
    assert {"metric", "value", "fitness", "hmc_accept_mean", "hmc_robust_rhat_max",
            "graph_solve_k256_ms", "graph_solve_k1024_ms"} <= set(keys)
    ndt = {k: 1.0 for k in tbench.NDT_KEYS}
    extras = {k: 2.0 for k in tbench.EXTRA_KEYS}
    line = tbench.bench_line(ndt, extras, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert not [k for k in keys if k not in line]
    assert line["platform"] == "cuda" and line["card"].startswith("NVIDIA")
    assert not [k for k in line if k not in keys and k != "card"]
    for k in ("hmc_robust_ess_min", "value"):
        with pytest.raises(KeyError, match=k):
            tbench.bench_line({kk: v for kk, v in ndt.items() if kk != k},
                              {kk: v for kk, v in extras.items() if kk != k}, "card")


def test_bench_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli(["bench"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main("cuda")
    with pytest.raises(ValueError, match="not a CUDA device"):
        cli(["bench", "--device", "cpu"])



def test_ndt_batch_equals_its_single_aligns_in_float64():
    """`ndt_batch_sources` draws one float32 jitter for every dtype, and
    the batched coarse-to-fine align of the float64 sources equals
    `B_NDT` single aligns within 1e-9 relative, with the same outer
    iterations per lane (the card's check in `chip_smoke.py`)."""
    from gorio_tpu_torch.core.pointcloud import PointCloud
    from gorio_tpu_torch.registration.ndt import ndt_align_multires

    (a, _), (b, _) = tbench.synth_pair(n=PAIR_N)
    inp = tbench.ndt_inputs(a, b, torch.device("cpu"), dtype=torch.float64)
    srcs = tbench.ndt_batch_sources(inp.source)
    src32 = inp.source._replace(xyz=inp.source.xyz.float())
    m = inp.source.mask
    jitter = (srcs.xyz - inp.source.xyz)[:, m]
    # the same draw: the float32 sources differ only by their coordinates'
    # rounding (one ulp at ~60 m, 3.8e-6)
    torch.testing.assert_close(jitter.float(),
                               (tbench.ndt_batch_sources(src32).xyz - src32.xyz)[:, m],
                               rtol=0, atol=1e-5)
    assert jitter.shape[0] == tbench.B_NDT and len(set(jitter[:, 0, 0].tolist())) == tbench.B_NDT
    eye = torch.eye(4, dtype=torch.float64)
    got = ndt_align_multires(srcs, inp.vmap_c, inp.vmap_t, eye, inp.cfg)
    for i in range(tbench.B_NDT):
        one = ndt_align_multires(PointCloud(*(x[i] for x in srcs)), inp.vmap_c, inp.vmap_t, eye,
                                 inp.cfg)
        assert int(got.iterations[i]) == int(one.iterations)
        torch.testing.assert_close(got.T[i], one.T, rtol=1e-9, atol=1e-9)
        torch.testing.assert_close(got.error[i], one.error, rtol=1e-9, atol=0)
