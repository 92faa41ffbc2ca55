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


@pytest.mark.parametrize("case", sorted(CASES))
def test_nn1_select_f32_query_matches_jax(case):
    """A float32 query against float64 refs. The port's plain version
    searches in the promoted float64; JAX promotes the cross term q.r and
    |r|^2 but sums |q|^2 in float32, an offset that is the same for every
    ref of a query, so the indices are equal and d2 differs by that
    rounding: atol 4 * eps32 * |q|^2 per query (three squares, two adds),
    plus the float32 rounding of the port's d2 (rtol 1e-7). The payload rows
    are the same float32 values on both sides."""
    q, r, mask, pay = _case(*CASES[case])
    q = q.astype(np.float32)
    atol = 4 * np.finfo(np.float32).eps * (q.astype(np.float64) ** 2).sum(-1) + 1e-9
    j_idx, j_d2, j_sel = nn_pallas.nn1_select(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(pay), ref_mask=jnp.asarray(mask)
    )
    t_idx, t_d2, t_sel = tnn.nn1_select(
        torch.as_tensor(q), torch.as_tensor(r), torch.as_tensor(pay), ref_mask=torch.as_tensor(mask)
    )
    assert t_d2.dtype == t_sel.dtype == torch.float32 and t_idx.dtype == torch.int32
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    err = np.abs(t_d2.numpy().astype(np.float64) - np.asarray(j_d2))
    assert (err <= atol + 1e-7 * np.abs(np.asarray(j_d2))).all(), err.max()
    np.testing.assert_array_equal(t_sel.numpy(), np.asarray(j_sel))

    j_idx, j_d2 = nn_pallas.nn1_best(jnp.asarray(q), jnp.asarray(r), ref_mask=jnp.asarray(mask))
    t_idx, t_d2 = tnn.nn1_best(torch.as_tensor(q), torch.as_tensor(r), torch.as_tensor(mask))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    err = np.abs(t_d2.numpy().astype(np.float64) - np.asarray(j_d2))
    assert (err <= atol + 1e-7 * np.abs(np.asarray(j_d2))).all(), err.max()


def _main_path_tensors(n=2048, m=2048):
    """The tensors of the main path's `nn1_select` call: an f64 moved source,
    an f32 target, a bool mask and an f32 11-column payload."""
    q, r, mask, pay = _case(5, n, m, 0.1)
    return (torch.as_tensor(q), torch.as_tensor(r, dtype=torch.float32), torch.as_tensor(mask),
            torch.as_tensor(pay, dtype=torch.float32))


def test_kernel_args_take_the_callers_tensors():
    """At the main path's types every pointer the kernel gets is an input
    tensor's own storage: nothing is cast, padded or copied."""
    q, r, mask, pay = _main_path_tensors()
    a = tnn._kernel_args(q, r, mask, pay)
    assert (a.query, a.ref, a.mask, a.payload) == (
        q.data_ptr(), r.data_ptr(), mask.data_ptr(), pay.data_ptr())
    assert (a.q_dtype, a.r_dtype, a.p_dtype) == (1, 0, 0)
    assert (a.P, a.p_stride, a.B, a.N, a.M, a.S, a.squeeze) == (11, 11, 1, 2048, 2048, 8, True)

    wide = torch.zeros(3, 40, 16, dtype=torch.float64)  # a strided payload view
    qb, rb = torch.zeros(3, 7, 3), torch.zeros(3, 40, 3, dtype=torch.float64)
    a = tnn._kernel_args(qb, rb, None, wide[..., :11])
    assert (a.payload, a.P, a.p_stride, a.p_dtype, a.mask) == (wide.data_ptr(), 11, 16, 1, None)
    assert (a.q_dtype, a.r_dtype, a.B, a.squeeze) == (0, 1, 3, False)


def _bad_args():
    q, r, mask, pay = _main_path_tensors(16, 32)
    return {
        "non-contiguous ref": ((q, r.t().contiguous().t(), mask, pay), "contiguous ref"),
        "non-contiguous query": ((q[::2], r, mask, pay), "contiguous query"),
        "half query": ((q.half(), r, mask, pay), "float32 or float64 query"),
        "int ref": ((q, r.int(), mask, pay), "float32 or float64 ref"),
        "int payload": ((q, r, mask, pay.int()), "float32 or float64 payload"),
        "float mask": ((q, r, mask.float(), pay), "bool"),
        "P > 16": ((q, r, mask, torch.zeros(32, 17)), "payload"),
        "column-strided payload": ((q, r, mask, torch.zeros(32, 22)[:, ::2]), "unit-stride"),
    }


@pytest.mark.parametrize("what", sorted(_bad_args()))
def test_kernel_args_refuse_what_the_kernel_does_not_take(what):
    args, match = _bad_args()[what]
    with pytest.raises(ValueError, match=match):
        tnn._kernel_args(*args)


def test_cluster_size_covers_the_card():
    for B in (1, 2, 3, 8, 64):
        for N in (1, 5, 127, 128, 129, 1000, 1537, 2048, 4096, 20000, 100000):
            S = tnn.cluster_size(B, N)
            assert S in (1, 2, 4, 8)
            ctas = B * -(-N // tnn.QUERIES) * S
            # S is the least power of two that covers the SMs, or 8
            assert ctas >= tnn.SMS or S == tnn.MAX_CLUSTER
            assert S == 1 or ctas // 2 < tnn.SMS
    assert tnn.cluster_size(1, 2048) == 8 and tnn.cluster_size(3, 1537) == 4
    assert tnn.cluster_size(64, 2048) == 1


def test_launch_is_one_call_on_the_callers_tensors(monkeypatch):
    """`_launch` hands the kernel the callers' own pointers and three fresh
    outputs in the query's dtype, makes one library call and counts it."""
    calls = []

    class FakeLib:
        def gorio_nn1(self, *args):
            calls.append(("nn1", args))
            return 0

        def gorio_nn1_select(self, *args):
            calls.append(("nn1_select", args))
            return 0

    monkeypatch.setattr(tnn, "_check_cuda", lambda *t: None)
    monkeypatch.setattr(tnn, "load_library", FakeLib)
    monkeypatch.setattr(tnn, "_stream", lambda device: 1234)
    monkeypatch.setattr(tnn, "launch_counts", {"nn1": 0, "nn1_select": 0})
    q, r, mask, pay = _main_path_tensors()
    idx, d2, sel = tnn._launch("nn1_select", q, r, mask, pay)
    assert (idx.dtype, idx.shape, d2.dtype, d2.shape) == (torch.int32, (2048,), torch.float64,
                                                          (2048,))
    assert (sel.dtype, sel.shape) == (torch.float64, (2048, tnn.PAYLOAD))
    name, args = calls[-1]
    assert name == "nn1_select" and args == (
        q.data_ptr(), 1, r.data_ptr(), 0, mask.data_ptr(), pay.data_ptr(), 0, 11, 11, 1, 2048,
        2048, 8, idx.data_ptr(), d2.data_ptr(), sel.data_ptr(), 1234)
    idx, d2 = tnn._launch("nn1", q, r, None, None)
    assert calls[-1][1] == (q.data_ptr(), 1, r.data_ptr(), 0, None, 1, 2048, 2048, 8,
                            idx.data_ptr(), d2.data_ptr(), 1234)
    assert tnn.launch_counts == {"nn1": 1, "nn1_select": 1} and len(calls) == 2

    monkeypatch.setattr(FakeLib, "gorio_nn1", lambda self, *a: 98)
    with pytest.raises(RuntimeError, match="cudaError_t 98"):
        tnn._launch("nn1", q, r, mask, None)
    assert tnn.launch_counts["nn1"] == 1


def test_batched_launches_are_counted(monkeypatch):
    """A launch over B > 1 lanes (loop verification) counts in both
    `launch_counts` and `batched_launch_counts`; B = 1 only in the first;
    `reset_launch_counts` zeroes both."""
    class FakeLib:
        def gorio_nn1_select(self, *args):
            return 0

    monkeypatch.setattr(tnn, "_check_cuda", lambda *t: None)
    monkeypatch.setattr(tnn, "load_library", FakeLib)
    monkeypatch.setattr(tnn, "_stream", lambda device: 0)
    monkeypatch.setattr(tnn, "launch_counts", {"nn1": 0, "nn1_select": 0})
    monkeypatch.setattr(tnn, "batched_launch_counts", {"nn1": 0, "nn1_select": 0})
    q, r, mask, pay = _main_path_tensors(n=64, m=64)
    tnn._launch("nn1_select", q, r, mask, pay)
    qb, rb, mb, pb = (torch.stack([t, t]) for t in (q, r, mask, pay))
    idx, d2, sel = tnn._launch("nn1_select", qb, rb, mb, pb)
    assert idx.shape == (2, 64) and sel.shape == (2, 64, tnn.PAYLOAD)
    assert tnn.launch_counts["nn1_select"] == 2 and tnn.batched_launch_counts["nn1_select"] == 1
    tnn.reset_launch_counts()
    assert tnn.launch_counts == tnn.batched_launch_counts == {"nn1": 0, "nn1_select": 0}


def test_main_path_tensors_fit_the_kernel(monkeypatch):
    """One APDGICP align, its inlier fraction and fitness score on float32
    clouds with a float64 pose, as the slam CLI runs them: every 1-NN call
    passes `_kernel_args` as it comes (contiguous, supported dtypes), and
    the `nn1_select` calls are the f64 query / f32 ref / P = 11 f32 payload
    the kernel is tuned for."""
    from gorio_tpu_torch.core.pointcloud import make_cloud
    from gorio_tpu_torch.io.synthetic import make_world, render_radar_scan
    from gorio_tpu_torch.pipeline import odometry as todo
    from gorio_tpu_torch.registration import gicp as tg

    seen = []

    def hooked(fn):
        def call(query, ref, *args, ref_mask=None, **kw):
            a = tnn._kernel_args(query, ref, ref_mask, args[0] if args else None)
            seen.append((fn.__name__, query.dtype, ref.dtype, a.P, a.p_dtype))
            return fn(query, ref, *args, ref_mask=ref_mask, **kw)
        return call

    monkeypatch.setattr(tg, "nn1_select", hooked(tnn.nn1_select))
    monkeypatch.setattr(tg, "nn1_best", hooked(tnn.nn1_best))
    monkeypatch.setattr(todo, "nn1_best", hooked(tnn.nn1_best))
    world = make_world(seed=11, n_landmarks=3000)
    v = np.array([2.0, 0.3, 0.0])
    clouds = []
    for k, p in enumerate((np.zeros(3), np.array([0.4, 0.1, 0.0]))):
        c = render_radar_scan(world, np.eye(3), p, v, capacity=256, seed=k)
        m = c.mask.numpy()
        frame = torch.as_tensor(c.xyz.numpy()[m], dtype=torch.float32)
        clouds.append(make_cloud(frame, capacity=256))
    T = torch.eye(4, dtype=torch.float64)
    res = tg.gicp_align(clouds[1], clouds[0], T, tg.GICPConfig())
    todo._inlier_fraction(clouds[1].xyz, clouds[1].mask, clouds[0].xyz, clouds[0].mask,
                          res.T, 0.5)
    tg.fitness_score(clouds[1], clouds[0], res.T)
    names = [s[0] for s in seen]
    assert names.count("nn1_best") == 2 and names.count("nn1_select") >= 1
    for name, qd, rd, P, pd in seen:
        assert (qd, rd) == (torch.float64, torch.float32)
        if name == "nn1_select":
            assert (P, pd) == (11, 0)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """On a card: both kernels against their plain versions run at the
    kernel's float32 arithmetic: all-float32, at the main path's mixed types
    (f64 query, f32 ref and payload), and with refs that repeat every M / S,
    so that each minimum ties across the cluster's CTAs and the lowest copy
    must win."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    f32 = torch.float32
    for case in sorted(CASES):
        for qdt, rdt in ((f32, f32), (torch.float64, f32)):
            q, r, mask, pay = (torch.as_tensor(a, device="cuda") for a in _case(*CASES[case]))
            q, r, pay = q.to(qdt), r.to(rdt), pay.float()
            idx, d2, sel = tnn.nn1_select(q, r, pay, mask)
            pidx, pd2, psel = tnn.nn1_select_plain(q, r, pay, mask, compute_dtype=f32)
            kidx, kd2 = tnn.nn1_best(q, r, mask)
            assert torch.equal(idx, kidx) and torch.equal(d2, kd2)
            assert d2.dtype == sel.dtype == qdt
            agree = idx == pidx
            assert float(agree.float().mean()) > 0.99
            torch.testing.assert_close(d2, pd2, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(sel[agree], psel[agree], rtol=1e-5, atol=1e-6)

    q, r, mask, pay = (torch.as_tensor(a, device="cuda") for a in _main_path_tensors())
    split = r.shape[0] // tnn.cluster_size(1, q.shape[0])
    r = r[:split].repeat(r.shape[0] // split, 1)
    mask = torch.ones_like(mask)
    idx, d2, sel = tnn.nn1_select(q, r, pay, mask)
    pidx, _, _ = tnn.nn1_select_plain(q, r, pay, mask, compute_dtype=f32)
    assert int(idx.max()) < split and torch.equal(idx, tnn.nn1_best(q, r, mask)[0])
    assert float((idx == pidx).float().mean()) > 0.99
