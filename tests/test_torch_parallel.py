"""Port parity: `gorio_tpu_torch.parallel` (the mesh, the sharded UGPM
windows, APDGICP / GICP align and pose-graph solve, the dry run) against
`gorio_tpu.parallel` on a 4-device mesh of the conftest's 8 CPU devices.

One world-4 gloo group of CPU ranks (`mesh.spawn`, targets in
`tests/torch_ranks.py`) runs every program once for the whole file. The
tolerances are `tests/test_sharded_programs.py`'s, which hold the JAX
sharded programs to their single-device forms in float64: UGPM deltas
rtol 1e-8 / atol 1e-10, its covariance rtol 1e-3 / atol 1e-7 of its
diagonal's scale; the align's T rtol 1e-6 / atol 1e-8, H rtol 1e-5 / atol
1e-6, cost rtol 1e-6 / atol 1e-9, and the same LM iteration count; the
graph's poses rtol 1e-7 / atol 1e-9, chi2 rtol 1e-7 / atol 1e-12, H rtol
1e-6 / atol 1e-8. Replicated outputs agree to the bit across the ranks,
and `dryrun_multichip` at world 4 (dp, mp) = (2, 2) agrees with world 1
on the same sizes within the same tolerances (its APDGICP runs in
float32: T within 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_ranks
from gorio_tpu.core.pointcloud import make_cloud as j_make_cloud
from gorio_tpu.parallel import sharded as js
from gorio_tpu.preintegration.ugpm import UGPMConfig as JUGPMConfig
from gorio_tpu.registration.gicp import GICPConfig as JGICPConfig
from gorio_tpu_torch.convert import cloud_from_numpy, graph_from_numpy
from gorio_tpu_torch.parallel import dryrun, mesh as tmesh, sharded as ts
from gorio_tpu_torch.registration import gicp as tg
from test_sharded_programs import _chain_graph, _cloud_pair

WORLD = 4


def close(a, b, rtol=0.0, atol=0.0):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def _jmesh(axis):
    return Mesh(np.asarray(jax.devices()[:WORLD]), (axis,))


@pytest.fixture(scope="module")
def inputs():
    src_np, tgt_np = _cloud_pair()
    cluster = (np.arange(len(src_np)) % 7).astype(np.float64)
    jclouds = tuple(j_make_cloud(jnp.asarray(x), doppler=jnp.zeros(len(x)), capacity=512)
                    ._replace(cluster=jnp.asarray(cluster)) for x in (src_np, tgt_np))
    poses0, graph = _chain_graph(12, np.random.default_rng(4)).freeze()
    ugpm, gyr_var, vel_var = dryrun.ugpm_windows(WORLD)
    return {
        "jax": {"clouds": jclouds, "graph": (poses0, graph), "ugpm": ugpm,
                "var": (gyr_var, vel_var)},
        "torch": {"clouds": tuple(cloud_from_numpy(c) for c in jclouds),
                  "graph": (torch.as_tensor(np.asarray(poses0)), graph_from_numpy(graph)),
                  "ugpm": (*ugpm, gyr_var, vel_var, dryrun.UGPM_CFG)},
    }


@pytest.fixture(scope="module")
def ranks(inputs):
    """Every rank's results (rank 0 first)."""
    return tmesh.spawn(torch_ranks.programs, WORLD, inputs["torch"], device="cpu",
                       timeout=600)


@pytest.mark.parametrize("mode", ["gicp", "apdgicp"])
def test_sharded_gicp_matches_jax(inputs, ranks, mode):
    ref = js.sharded_gicp_align(_jmesh("mp"), JGICPConfig(mode=mode), "mp")(
        *inputs["jax"]["clouds"])
    out = ranks[0][mode]
    assert int(out.iterations) == int(ref.iterations)
    close(out.T, ref.T, rtol=1e-6, atol=1e-8)
    close(out.H, ref.H, rtol=1e-5, atol=1e-6)
    close(out.error, ref.error, rtol=1e-6, atol=1e-9)
    assert np.linalg.norm(out.T[:3, 3].numpy() - [0.3, -0.2, 0.05]) < 0.05


def test_sharded_optimize_graph_matches_jax(inputs, ranks):
    from gorio_tpu.graph.solver import SolveConfig

    ref = js.sharded_optimize_graph(_jmesh("dp"), SolveConfig(max_iterations=32), "dp")(
        *inputs["jax"]["graph"])
    out = ranks[0]["graph"]
    assert int(out.iterations) == int(ref.iterations)
    close(out.poses, ref.poses, rtol=1e-7, atol=1e-9)
    close(out.chi2, ref.chi2, rtol=1e-7, atol=1e-12)
    close(out.H, ref.H, rtol=1e-6, atol=1e-8)


def test_sharded_ugpm_windows_matches_jax(inputs, ranks):
    """4 windows of the dry run (G = 48, V = 10, 5 LM iterations), one per
    rank."""
    c = dryrun.UGPM_CFG
    cfg = JUGPMConfig(state_freq=c.state_freq, overlap=c.overlap,
                      window_duration=c.window_duration, lm_iters=c.lm_iters,
                      init_grid_n=c.init_grid_n)
    ref = js.sharded_ugpm_windows(_jmesh("dp"), "dp")(*inputs["jax"]["ugpm"],
                                                       *inputs["jax"]["var"], cfg)
    out = ranks[0]["ugpm"]
    assert out.delta_p.shape == (WORLD, 1, 3)
    close(out.delta_p, ref.delta_p, rtol=1e-8, atol=1e-10)
    close(out.delta_R, ref.delta_R, rtol=1e-8, atol=1e-10)
    for i in range(WORLD):
        scale = float(np.max(np.diag(np.asarray(ref.cov)[i, 0])))
        close(out.cov[i], ref.cov[i], rtol=1e-3, atol=1e-7 * scale)


@pytest.mark.parametrize("n", [4, 8])
def test_pad_graph_for_matches_jax(inputs, n):
    _, graph = inputs["jax"]["graph"]
    ref = js.pad_graph_for(jax.tree.map(jnp.asarray, graph), n)
    out = ts.pad_graph_for(inputs["torch"]["graph"][1], n)
    for fo, fr in zip(out, ref):
        assert fo.mask.shape[0] % n == 0
        for a, b in zip(fo, fr):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cluster_bonus_counts_the_whole_source(inputs):
    """APDGICP's cluster bonus on a shard of the source is 1 / the whole
    capacity (`n_total`), as on one device: with the shard's own size it
    would be 4x too large, and the sharded align would weigh every point
    differently from the single-device one."""
    src, tgt = inputs["torch"]["clouds"]
    cfg = tg.GICPConfig(mode="apdgicp")
    full = tg.prepare_gicp(src, tgt, cfg)
    rows = slice(128, 256)
    shard = full._replace(src_xyz=full.src_xyz[rows], src_mask=full.src_mask[rows],
                          src_cov=full.src_cov[rows], src_geo_w=full.src_geo_w[rows],
                          src_cluster=full.src_cluster[rows])
    T = torch.eye(4, dtype=torch.float64)
    w_full = tg._correspondences(full, T, cfg)[3][rows]
    w_shard = tg._correspondences(shard, T, cfg, n_total=512)[3]
    assert torch.equal(w_shard, w_full)
    bonus = w_full > 1.0 + full.src_geo_w[rows] + 1e-6
    assert bool(bonus.any())  # some points match their own cluster
    gap = tg._correspondences(shard, T, cfg)[3] - w_full  # the shard's own size
    close(gap[bonus], torch.full((int(bonus.sum()),), 1 / 128 - 1 / 512), rtol=1e-12)


def test_dryrun_world4_equals_world1(ranks):
    """World 4 on (dp, mp) = (2, 2) against this process as a mesh of one
    rank (no process group: identity collectives): the same fixed sizes."""
    mesh1 = tmesh.make_mesh((1, 1), ("dp", "mp"), "cpu")
    one = dryrun.dryrun_multichip(mesh1)
    four = ranks[0]["dryrun"]
    close(four["ugpm"].delta_p, one["ugpm"].delta_p, rtol=1e-8, atol=1e-10)
    close(four["ugpm"].delta_R, one["ugpm"].delta_R, rtol=1e-8, atol=1e-10)
    assert int(four["gicp"].iterations) == int(one["gicp"].iterations)
    close(four["gicp"].T, one["gicp"].T, atol=1e-5)  # float32 clouds
    assert int(four["graph"].iterations) == int(one["graph"].iterations)
    close(four["graph"].poses, one["graph"].poses, rtol=1e-7, atol=1e-9)
    for a, b in zip(four["smc"], one["smc"]):  # the same generator's draws
        close(a, b, rtol=1e-5, atol=1e-6)


def leaves(x):
    """The tensors of nested dicts and (named) tuples, in order."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from leaves(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from leaves(v)


def test_replicated_outputs_equal_across_ranks(ranks):
    """Every rank returns the same results, to the bit: the replicated ones
    (align, graph solve, ESS) and the gathered ones (UGPM windows, SMC
    particles)."""
    first = list(leaves(ranks[0]))
    assert len(first) > 40
    for r in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in zip(leaves(r), first))


def test_ranks_import_nothing_of_jax(ranks):
    assert [r["leaked"] for r in ranks] == [[]] * WORLD


def test_mesh_shapes_and_collectives():
    """A mesh of one rank without a process group: its collectives are
    identities; rows split evenly or raise, as the JAX programs do."""
    mesh = tmesh.make_mesh((1,), ("dp",), "cpu")
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(tmesh.psum(mesh, x, "dp"), x) and torch.equal(tmesh.pmax(mesh, x, "dp"), x)
    assert tmesh.all_gather(mesh, x, "dp").shape == (1, 3, 2)
    assert torch.equal(tmesh.shard_batch(mesh, x, "dp"), x)
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        tmesh.make_mesh((2, 2), ("dp", "mp"), "cpu")
    three = tmesh.Mesh((3,), ("mp",), torch.device("cpu"), {"mp": None}, (1,), None)
    assert tmesh.shard_rows(three, 9, "mp") == slice(3, 6)
    with pytest.raises(ValueError, match="do not divide"):
        tmesh.shard_rows(three, 512, "mp")
    assert dryrun.mesh_layout(4) == (2, 2) and dryrun.mesh_layout(3) == (3, 1)
    assert tmesh.initialize_distributed() == (0, 1)  # no torchrun environment


def test_spawn_fails_with_a_failed_rank():
    """A rank that raises fails the call with its traceback; the rank left
    waiting in a collective is killed and counted."""
    with pytest.raises(RuntimeError, match=r"(?s)2 of 2 ranks failed.*rank 1 fails"):
        tmesh.spawn(torch_ranks.fails_on_rank1, 2, device="cpu", timeout=120)
