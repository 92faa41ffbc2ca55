"""The two-process SMC demo (`gorio_tpu_torch/evaluation/multihost.py`, the
port of `scripts/demo_multihost.py`) on the CPU, against the JAX package.

`python -m gorio_tpu_torch.evaluation.multihost --device cpu` starts two
OS processes that meet over TCP (gloo); it must exit 0 with both ranks
printing the same global ESS. That ESS is computed before any draw, from
the script's numpy population (1,024 x 8, normal x 3.0, float32): it must
equal the JAX package's `sharded_smc_step` on 4 of the conftest's 8 CPU
devices, as the script ran it (2 processes x 2 devices), to 1e-5
relative (float32 sums in another order)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gorio_tpu.inference.smc import sharded_smc_step
from gorio_tpu_torch.evaluation import multihost

ROOT = multihost.REPO


@pytest.fixture(scope="module")
def run():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-m", "gorio_tpu_torch.evaluation.multihost",
                           "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=240)
    return proc


def jax_ess():
    particles, logw = multihost.population()
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("dp",))
    step = jax.jit(sharded_smc_step(mesh, lambda x: -0.5 * jnp.sum(x * x)))
    dp, repl = NamedSharding(mesh, P("dp")), NamedSharding(mesh, P())
    _, _, ess = step(jax.device_put(jax.random.PRNGKey(0), repl),
                     jax.device_put(jnp.asarray(particles), dp),
                     jax.device_put(jnp.asarray(logw), dp),
                     jax.device_put(jnp.asarray(multihost.STD, jnp.float32), repl))
    return float(ess)


def test_driver_exits_0_and_both_ranks_agree(run):
    assert run.returncode == 0, run.stdout + run.stderr
    ess = {int(m.group(1)): float(m.group(2)) for m in multihost.ESS_LINE.finditer(run.stdout)}
    assert sorted(ess) == [0, 1] and ess[0] == ess[1], run.stdout
    assert 0.0 < ess[0] <= multihost.NP
    assert "OK" in run.stdout and "gloo" in run.stdout


def test_ess_equals_the_jax_package(run):
    m = multihost.ESS_LINE.search(run.stdout)
    assert m, run.stdout + run.stderr
    want = jax_ess()
    assert 1.0 < want < multihost.NP  # the population is far from the target: few carry weight
    assert float(m.group(2)) == pytest.approx(want, rel=1e-5)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.driver(device="cuda")
