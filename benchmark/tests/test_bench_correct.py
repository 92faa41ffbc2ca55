"""`correct` at a size a CPU test run holds: a sound run is correct; the
control (the reference one precision down, in the program's place) is not;
and a run whose timed path is broken underneath is not, once for each fault
the cell can have (an answer altered where it is produced, in the last draw
of a call; half of the chains left unadvanced; every state returned
unchanged). The look for a card is passed over (`execute(..., device=cpu)`);
the rest of a run is the benchmark's own, with the mix's own calls of
`draws_per_call` draws."""

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import benchmark.run as run  # noqa: E402
from benchmark.lib import manifest as mf  # noqa: E402

SEED = 2**31 + 12345
CELL = "posterior-circuit.hmc16"
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def small_cell(monkeypatch):
    """The cell at a CPU size: the same configuration and mix with fewer
    poses, loops and chains; the calls keep the mix's number of draws. The
    smaller posterior takes a larger step for the acceptance that dual
    averaging aims at (0.8): at 0.1 its chains accept 0.77 of their
    transitions, at the cell's 0.04 0.98."""
    torch.set_num_threads(2)
    orig = mf.cell

    def small(man, w):
        e, c, cfg, tr = orig(man, w)
        cfg, tr = copy.deepcopy(cfg), copy.deepcopy(tr)
        cfg["graph"].update(n_poses=30, n_loops=3)
        cfg["sampler"]["step_size"] = 0.1
        tr.update(chains=4)
        return e, c, cfg, tr

    monkeypatch.setattr(mf, "cell", small)


def _correct(seconds, control=False, monkeypatch=None):
    if control:
        drv = mf.driver(mf.cell(mf.load_manifest(), CELL)[2]["driver"])
        check = drv.check
        monkeypatch.setattr(drv, "check",
                            lambda st, obs, ctx: check(st, obs, ctx, control=True))
    r = run.execute(CELL, SEED, seconds, False, device=CPU, log=lambda s: None)
    return r["correct"], r["checks"]


def test_posterior_sound_and_control(monkeypatch):
    ok, checks = _correct(2.0)
    assert ok, checks
    ok, checks = _correct(2.0, control=True, monkeypatch=monkeypatch)
    assert not ok, checks


@pytest.mark.parametrize("fault", ["altered_last_draw", "half_chains_still", "state_unchanged"])
def test_posterior_faults(monkeypatch, fault):
    from gorio_tpu_torch.inference import hmc

    orig = hmc.run_hmc
    n_draws = []

    def broken(lp, y0, **kw):
        s, a = orig(lp, y0, **kw)
        n_draws.append(s.shape[1])
        s = s.clone()
        if fault == "altered_last_draw":
            s[0, -1, 0] += 0.1  # one answer altered where it is produced
        elif fault == "half_chains_still":
            half = s.shape[0] // 2  # half of the chains left where they started
            s[:half] = y0[:half, None, :]
        else:
            s[:] = y0[:, None, :]  # every step returns its state unchanged
        return s, a

    monkeypatch.setattr(hmc, "run_hmc", broken)
    ok, checks = _correct(2.0)
    assert not ok, checks
    # the window's calls had the mix's own number of draws
    draws = mf.cell(mf.load_manifest(), CELL)[3]["draws_per_call"]
    assert n_draws[1:] and set(n_draws[1:]) == {draws}
