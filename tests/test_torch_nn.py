"""Port parity: the 1-NN search (`gorio_tpu_torch.registration.knn`,
`gorio_tpu_torch.ops.nn`) against `gorio_tpu.registration.knn` and
`gorio_tpu.ops.nn_pallas` (whose CPU branch is the XLA fallback), plus the
kernel dispatch rules.

Tolerance: the port computes d2 directly as sum (q - r)^2 while the JAX
package expands |q|^2 + |r|^2 - 2 q.r; in float64 at these ranges the two
differ by < 1e-12 (atol), which leaves every index equal on random data.
Exact ties (duplicated refs) must resolve to the first index on both sides."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from gorio_tpu.ops import nn_pallas
from gorio_tpu_torch.ops import nn as tnn
from gorio_tpu_torch.registration import knn as tknn

# the JAX package's `registration/__init__` re-exports a function named knn
jknn = importlib.import_module("gorio_tpu.registration.knn")


def _case(seed, n, m, masked_frac=0.0, dup=False):
    rng = np.random.default_rng(seed)
    ref = rng.normal(size=(m, 3)) * 10.0
    if dup:  # exact ties: every ref appears twice
        ref[m // 2:] = ref[: m - m // 2]
    query = ref[rng.integers(0, m, n)] + 0.5 * rng.normal(size=(n, 3))
    mask = rng.uniform(size=m) >= masked_frac
    payload = rng.normal(size=(m, 11))
    return query, ref, mask, payload


CASES = {
    "square": (0, 300, 300, 0.0, False),
    "ragged_masked": (1, 257, 1999, 0.3, False),
    "ties": (2, 200, 128, 0.0, True),
    "all_masked": (3, 50, 64, 1.0, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_nn1_and_select_match_jax(case):
    q, r, mask, pay = _case(*CASES[case])
    j_idx, j_d2 = jknn.nn1(jnp.asarray(q), jnp.asarray(r), ref_mask=jnp.asarray(mask), block=128)
    t_idx, t_d2 = tknn.nn1(torch.as_tensor(q), torch.as_tensor(r), torch.as_tensor(mask), block=64)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_d2.numpy(), np.asarray(j_d2), rtol=1e-12, atol=1e-9)

    j_idx, j_d2, j_sel = nn_pallas.nn1_select(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(pay), ref_mask=jnp.asarray(mask)
    )
    t_idx, t_d2, t_sel = tnn.nn1_select(
        torch.as_tensor(q), torch.as_tensor(r), torch.as_tensor(pay), ref_mask=torch.as_tensor(mask)
    )
    assert t_idx.dtype == torch.int32 and t_sel.shape == (q.shape[0], tnn.PAYLOAD)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_d2.numpy(), np.asarray(j_d2), rtol=1e-12, atol=1e-9)
    np.testing.assert_array_equal(t_sel.numpy(), np.asarray(j_sel))

    j_idx, j_d2 = nn_pallas.nn1_best(jnp.asarray(q), jnp.asarray(r), ref_mask=jnp.asarray(mask))
    t_idx, t_d2 = tnn.nn1_best(torch.as_tensor(q), torch.as_tensor(r), torch.as_tensor(mask))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_d2.numpy(), np.asarray(j_d2), rtol=1e-12, atol=1e-9)


def test_nn_vs_scipy_and_knn_matches_jax():
    """`test_registration.py::test_nn_vs_scipy` on the port, and the top-k
    against JAX's."""
    rng = np.random.default_rng(0)
    ref = rng.normal(size=(500, 3))
    q = rng.normal(size=(300, 3))
    idx, d2 = tknn.nn1(torch.as_tensor(q), torch.as_tensor(ref))
    d_ref, i_ref = cKDTree(ref).query(q, k=1)
    np.testing.assert_array_equal(idx.numpy(), i_ref)
    np.testing.assert_allclose(np.sqrt(d2.numpy()), d_ref, atol=1e-10)

    t_idx, t_d2 = tknn.knn(torch.as_tensor(q), torch.as_tensor(ref), 8, block=128)
    j_idx, j_d2 = jknn.knn(jnp.asarray(q), jnp.asarray(ref), 8)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_d2.numpy(), np.asarray(j_d2), atol=1e-12)
    np.testing.assert_allclose(np.sqrt(t_d2.numpy()), cKDTree(ref).query(q, k=8)[0], atol=1e-10)


def test_nn_respects_mask():
    """`test_registration.py::test_nn_respects_mask` on the port."""
    rng = np.random.default_rng(1)
    ref = torch.as_tensor(rng.normal(size=(100, 3)))
    mask = torch.arange(100) < 50
    idx, _ = tknn.nn1(ref[60:70], ref, ref_mask=mask)
    assert bool((idx < 50).all())
    idx, _ = tnn.nn1_best(ref[60:70], ref, ref_mask=mask)
    assert bool((idx < 50).all())


def test_batch_axis_equals_per_batch_calls():
    """The leading batch axis the kernels take: (B, N, 3) equals B calls."""
    qs, rs, ms, ps = zip(*[_case(10 + b, 97, 211, 0.2) for b in range(3)])
    q, r, m, p = (torch.as_tensor(np.stack(x)) for x in (qs, rs, ms, ps))
    idx, d2, sel = tnn.nn1_select(q, r, p, ref_mask=m)
    for b in range(3):
        i1, d1, s1 = tnn.nn1_select(q[b], r[b], p[b], ref_mask=m[b])
        assert torch.equal(idx[b], i1) and torch.equal(d2[b], d1) and torch.equal(sel[b], s1)


def test_dispatch_refuses_non_cpu_without_falling_back(monkeypatch):
    """CPU tensors take the plain version; any other tensor goes to the
    kernel path, which raises rather than falling back to the plain one."""
    q, r, mask, pay = (torch.as_tensor(a) for a in _case(0, 16, 32))
    calls = []
    monkeypatch.setattr(tnn, "nn1", lambda *a, **k: calls.append(1) or tknn.nn1(*a, **k))
    tnn.nn1_best(q, r, mask)
    assert calls == [1]

    meta = [t.to("meta") for t in (q, r, mask, pay)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        tnn.nn1_best(meta[0], meta[1], meta[2])
    with pytest.raises(ValueError, match="CUDA tensors"):
        tnn.nn1_select(meta[0], meta[1], meta[3], meta[2])

    # past the device check, a failing build/load propagates
    monkeypatch.setattr(tnn, "_check_cuda", lambda *t: None)

    def broken_loader():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(tnn, "load_library", broken_loader)
    for fn, args in ((tnn.nn1_best, (meta[0], meta[1], meta[2])),
                     (tnn.nn1_select, (meta[0], meta[1], meta[3], meta[2]))):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            fn(*args)
    assert calls == [1]  # the plain version was never reached
    assert tnn.launch_counts == {"nn1": 0, "nn1_select": 0}


def test_shape_checks():
    q, r, mask, pay = (torch.as_tensor(a) for a in _case(0, 16, 32))
    with pytest.raises(ValueError, match="ref must hold"):
        tnn.nn1_best(q, r[:0])
    with pytest.raises(ValueError, match="payload"):
        tnn.nn1_select(q, r, torch.zeros(32, 17, dtype=q.dtype))
    with pytest.raises(ValueError, match="ref_mask"):
        tnn.nn1_best(q, r, mask[:5])


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """On a card: both kernels against their plain versions (float32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    for case in sorted(CASES):
        q, r, mask, pay = (torch.as_tensor(a, device="cuda") for a in _case(*CASES[case]))
        q, r, pay = q.float(), r.float(), pay.float()
        idx, d2, sel = tnn.nn1_select(q, r, pay, mask)
        pidx, pd2, psel = tnn.nn1_select_plain(q, r, pay, mask)
        kidx, kd2 = tnn.nn1_best(q, r, mask)
        assert torch.equal(idx, kidx) and torch.equal(d2, kd2)
        agree = idx == pidx
        assert float(agree.float().mean()) > 0.99
        torch.testing.assert_close(d2, pd2, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(sel[agree], psel[agree], rtol=1e-5, atol=1e-6)
