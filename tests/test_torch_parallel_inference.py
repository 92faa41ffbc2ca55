"""Port parity: the mesh forms of `gorio_tpu_torch.inference.smc.
sharded_smc_step` and `smoother.smc_loop_relaxation` against the JAX
package's on a 4-device mesh of the conftest's 8 CPU devices, in float64.

One world-4 gloo group of CPU ranks (`mesh.spawn`, the target
`tests/torch_ranks.py::inference`) runs both for the whole file. JAX draws
each shard's normals and accept uniforms from `fold_in(key, shard)`; the
tests rebuild them from the keys and hand the port the global draws (the
shards' in order), of which every rank takes its own rows; the resampling
uniform is replicated, as JAX's. Tolerances are those of the one-card
parity tests: the SMC step's ESS rtol 1e-10, particles atol 1e-10, log
weights rtol / atol 1e-10, its parents equal except within 1e-12 N of a
cumulative weight (`test_torch_inference.py::_parents_equal`); the
smoother (`tests/test_smoother.py`'s square graph, 64 particles, 3 stages,
1 move) field by field within 1e-8, and within 1e-12 of the port's own
one-card run on the same draws (the order of the reductions only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_ranks
from gorio_tpu.inference import smc as jsmc
from gorio_tpu.inference import smoother as js
from gorio_tpu_torch.convert import graph_from_numpy
from gorio_tpu_torch.inference import smoother as ts
from gorio_tpu_torch.parallel import mesh as tmesh
from test_smoother import _square_graph
from test_torch_inference import F64, _parents_equal, _smc_target, close, t

WORLD = 4
SMC_N, SMC_STEPS = 128, 5
SMOOTHER = dict(n_particles=64, n_stages=3, n_moves=1)
TARGET = (np.array([0.5, -1.0]), np.array([0.3, 0.3]))  # `_smc_target`'s


def smc_draws(key, n):
    """The JAX mesh step's draws: (its replicated uniform, the shards'
    normals (n, 2) in order)."""
    k_r, k_m = jax.random.split(jax.random.fold_in(key, 0))
    z = [jax.random.normal(jax.random.fold_in(k_m, me), (n // WORLD, 2), F64)
         for me in range(WORLD)]
    return jax.random.uniform(k_r, (), F64), jnp.concatenate(z)


def smoother_draws(key, N, D, n_stages, n_moves):
    """The JAX mesh smoother's draws over WORLD shards, global: init_z (N,
    D), u0 (S,), move_z (S, M, N, D), log_u (S, M, N)."""
    n_local = N // WORLD
    k_init, k_scan = jax.random.split(jax.random.fold_in(key, 0))
    init_z = jnp.concatenate([jax.random.normal(jax.random.fold_in(k_init, me), (n_local, D),
                                                F64) for me in range(WORLD)])

    def particle(kx):
        k1, k2 = jax.random.split(kx)
        return jax.random.normal(k1, (D,), F64), jnp.log(jax.random.uniform(k2, (), F64))

    u0, move_z, log_u = [], [], []
    for k in jax.random.split(k_scan, n_stages):
        k_r, k_mv = jax.random.split(jax.random.fold_in(k, 1))
        u0.append(jax.random.uniform(k_r, (), F64))
        zs, lus = [], []
        for kk in jax.random.split(k_mv, n_moves):
            z, lu = zip(*(jax.vmap(particle)(jax.random.split(jax.random.fold_in(kk, me),
                                                               n_local))
                          for me in range(WORLD)))
            zs.append(np.concatenate(z))
            lus.append(np.concatenate(lu))
        move_z.append(np.stack(zs))
        log_u.append(np.stack(lus))
    return t(init_z), t(np.stack(u0)), t(np.stack(move_z)), t(np.stack(log_u))


@pytest.fixture(scope="module")
def square():
    poses_gt, poses0, data, loop_mask = _square_graph()
    return np.asarray(poses0), data, np.asarray(loop_mask)


@pytest.fixture(scope="module")
def jax_runs(square):
    """The JAX mesh step over SMC_STEPS steps (each step's global log
    weights before it, key, state and ESS) and the JAX mesh smoother."""
    jlp, _ = _smc_target()
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("dp",))
    jstep = jax.jit(jsmc.sharded_smc_step(mesh, jlp))
    p = jax.random.normal(jax.random.PRNGKey(8), (SMC_N, 2), F64) * 3.0
    lw = jnp.zeros(SMC_N, F64)
    steps = []
    for i in range(SMC_STEPS):
        key = jax.random.PRNGKey(200 + i)
        lw_before = np.asarray(lw + jax.vmap(jlp)(p))
        p, lw, ess = jstep(key, p, lw, jnp.asarray(0.05))
        steps.append((key, lw_before, np.asarray(p), np.asarray(lw), float(ess)))
    poses0, data, loop_mask = square
    with pytest.MonkeyPatch.context() as mp:  # `test_torch_posterior.py`'s compile shortcut
        mp.setattr(js, "build_normal_equations", jax.jit(js.build_normal_equations))
        smoother = js.smc_loop_relaxation(mesh, jnp.asarray(poses0), data,
                                          jnp.asarray(loop_mask), **SMOOTHER)(
            jax.random.PRNGKey(0))
    return steps, smoother


@pytest.fixture(scope="module")
def torch_inputs(square):
    poses0, data, loop_mask = square
    p0 = np.asarray(jax.random.normal(jax.random.PRNGKey(8), (SMC_N, 2), F64)) * 3.0
    draws = [tuple(t(x) for x in smc_draws(jax.random.PRNGKey(200 + i), SMC_N))
             for i in range(SMC_STEPS)]
    sdraws = smoother_draws(jax.random.PRNGKey(0), SMOOTHER["n_particles"],
                            poses0.shape[0] * 6, SMOOTHER["n_stages"], SMOOTHER["n_moves"])
    return {"target": tuple(t(x) for x in TARGET),
            "smc_init": (t(p0), torch.zeros(SMC_N, dtype=torch.float64)), "smc_draws": draws,
            "smoother": (t(poses0), graph_from_numpy(data), loop_mask, SMOOTHER, sdraws)}


@pytest.fixture(scope="module")
def ranks(torch_inputs):
    return tmesh.spawn(torch_ranks.inference, WORLD, torch_inputs, device="cpu", timeout=600)


def test_sharded_smc_step_matches_jax(jax_runs, ranks):
    resampled = 0
    for (key, lw, jp, jw, jess), (tp, tw, tess, _) in zip(jax_runs[0], ranks[0]["smc"]):
        close(tess, jess, rtol=1e-10)
        close(tp, jp, atol=1e-10)
        close(tw, jw, rtol=1e-10, atol=1e-10)
        resampled += jess < 0.5 * SMC_N
    assert resampled >= 1


def test_sharded_smc_parents_match_jax(jax_runs, ranks):
    """Each step's comb against the global cumulative weights: the ranks'
    parents, gathered, against the JAX package's systematic resampling on
    the same uniform."""
    for (key, lw, *_), (*_, tparents) in zip(jax_runs[0], ranks[0]["smc"]):
        k_r, _ = jax.random.split(jax.random.fold_in(key, 0))
        u = float(jax.random.uniform(k_r, (), F64))
        _parents_equal(tparents, jsmc.systematic_resample(k_r, jnp.asarray(lw), SMC_N), lw, u,
                       SMC_N)


def test_cumsum_rows_is_the_global_cumsum(jax_runs, ranks):
    """The cumulative weights the ranks' parents are drawn against
    (`mesh.cumsum_rows`: each rank's scan offset by the shards before it)
    against numpy's cumsum of the same normalised weights, within 1e-12."""
    for (key, lw, *_), cum in zip(jax_runs[0], ranks[0]["smc_cum"]):
        close(cum, np.cumsum(np.exp(lw - np.logaddexp.reduce(lw))), rtol=1e-12, atol=1e-14)


def test_smoother_mesh_form_matches_jax(jax_runs, ranks):
    tres, jres = ranks[0]["smoother"], jax_runs[1]
    for name in ts.SmootherResult._fields:
        close(getattr(tres, name), getattr(jres, name), rtol=1e-8, atol=1e-8)
    assert 0.0 < float(tres.accept_rate) < 1.0
    assert bool((tres.ess_per_stage < 0.5 * SMOOTHER["n_particles"]).any())  # it resampled


def test_smoother_mesh_form_equals_one_card(torch_inputs, ranks):
    """The port's one-card run (`mesh=None`) on the same global draws."""
    poses0, graph, loop_mask, kw, draws = torch_inputs["smoother"]
    one = ts.smc_loop_relaxation(None, poses0, graph, loop_mask, **kw)(draws=draws)
    for a, b in zip(ranks[0]["smoother"], one):
        close(a, b, rtol=1e-12, atol=1e-12)


def test_inference_outputs_equal_across_ranks(ranks):
    """Every rank returns the same step outputs and smoother result, to the
    bit (replicated scalars, gathered particles and weights)."""
    from test_torch_parallel import leaves

    first = list(leaves(ranks[0]))
    assert len(first) > 20
    for r in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in zip(leaves(r), first))


def test_inference_ranks_import_nothing_of_jax(ranks):
    assert [r["leaked"] for r in ranks] == [[]] * WORLD


def test_smoother_mesh_needs_divisible_particles(square):
    poses0, data, loop_mask = square
    three = tmesh.Mesh((3,), ("dp",), torch.device("cpu"), {"dp": None}, (0,), None)
    with pytest.raises(ValueError, match="do not divide"):
        ts.smc_loop_relaxation(three, t(poses0), graph_from_numpy(data), loop_mask,
                               n_particles=64)
