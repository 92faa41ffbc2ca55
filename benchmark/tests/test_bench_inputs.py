"""The benchmark's frozen inputs against the program's generator at this
commit, bit for bit."""

import math
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.reference.chain_graph import chain_graph  # noqa: E402


def test_chain_graph_matches_solve_timing(monkeypatch):
    """The frozen `chain_graph` gives the program's graph: its poses and
    every factor, in order (the original freezes on the card; here its
    `PoseGraph` is read before freezing)."""
    from gorio_tpu_torch.graph import graph as G
    from gorio_tpu_torch.graph import solve_timing

    monkeypatch.setattr(G.PoseGraph, "freeze", lambda self, device=None: self)
    g = solve_timing.chain_graph(40, 40, 5, seed=9)
    poses, between, priors = chain_graph(40, 5, seed=9)
    assert np.array_equal(np.stack(g.poses), poses)
    ref = G.PoseGraph()
    for i, T, info in priors:
        ref.add_prior(i, T, info=info)
    for i, j, T, info, d in between:
        ref.add_between(i, j, T, info=info, robust_delta=d)
    assert len(g._between) == len(ref._between)
    for a, b in zip(g._between, ref._between):
        assert a[:2] == b[:2] and np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])
        assert a[4] == b[4] or (math.isinf(a[4]) and math.isinf(b[4]))
    assert np.array_equal(g._priors[0][1], ref._priors[0][1])
