"""The card-only check of the mesh: two ranks that share one card over gloo
with CUDA tensors run the sharded APDGICP align (`gorio_nn1` on each rank's
half of the source), equal to the one-card `gicp_align` within
`tests/test_sharded_programs.py`'s tolerances (float64: T rtol 1e-6 / atol
1e-8, H rtol 1e-5 / atol 1e-6, cost rtol 1e-6 / atol 1e-9; the same LM
iteration count), the two ranks' results equal to the bit.

This file imports no JAX, so that it runs where there is none:
`python -m pytest --noconftest tests/test_torch_parallel_card.py -m cuda`.
Here, without a card, the test skips."""

import numpy as np
import pytest
import torch

import torch_ranks


def _pair(n=4096, seed=0):
    """A structured pair (a plane and a scatter) 0.05 rad and
    [0.3, -0.2, 0.05] m apart, as `tests/test_sharded_programs.py`'s."""
    rng = np.random.default_rng(seed)
    tgt = np.concatenate([
        np.stack([rng.uniform(-5, 5, n // 2), rng.uniform(-5, 5, n // 2),
                  0.02 * rng.normal(size=n // 2)], axis=1),
        rng.normal(scale=2.0, size=(n // 2, 3))])
    ang = 0.05
    Rz = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1.0]])
    src = (tgt - np.array([0.3, -0.2, 0.05])) @ Rz + rng.normal(scale=0.01, size=tgt.shape)
    return src, tgt


@pytest.mark.cuda
def test_two_ranks_sharing_the_card_equal_the_one_card_align():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gorio_tpu_torch.core.pointcloud import make_cloud
    from gorio_tpu_torch.ops import nn as K
    from gorio_tpu_torch.parallel.mesh import spawn
    from gorio_tpu_torch.registration.gicp import GICPConfig, gicp_align

    K.build_library()  # here, once: the ranks only load it
    src_np, tgt_np = _pair()
    cluster = torch.as_tensor((np.arange(len(src_np)) % 7).astype(np.float64))
    src, tgt = (make_cloud(torch.as_tensor(x), capacity=len(x))._replace(cluster=cluster)
                for x in (src_np, tgt_np))
    ranks = spawn(torch_ranks.card_align, 2, (src, tgt), device="cuda:0", backend="gloo",
                  timeout=300)
    dev = torch.device("cuda")
    ref = gicp_align(*(type(c)(*(t.to(dev) for t in c)) for c in (src, tgt)),
                     cfg=GICPConfig(mode="apdgicp"))
    out = ranks[0]["align"]
    assert int(out.iterations) == int(ref.iterations)
    np.testing.assert_allclose(out.T.numpy(), ref.T.cpu().numpy(), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(out.H.numpy(), ref.H.cpu().numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(out.error), float(ref.error), rtol=1e-6, atol=1e-9)
    assert all(torch.equal(a, b) for a, b in zip(ranks[1]["align"], out))
    assert [r["nn1"] > 0 for r in ranks] == [True, True]
