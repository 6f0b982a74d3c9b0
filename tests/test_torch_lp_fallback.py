"""The paper's evaluation (§4, fig. 5) through the port's LP core under the
solver's fallback, against the JAX package's: `solver._HAVE_SCIPY` set
False in both packages, as on a host whose scipy has no
`scipy.optimize.milp`, so that every trial is solved by the module's own
simplex and branch-and-bound.  Exact equality, as in
`tests/test_torch_lp.py` (which holds the same sweep under HiGHS); one
window a case, as a window of 400 takes the fallback 5-10 s a run."""

import numpy as np
import pytest

import repro.core as jc
from repro.core import solver as jsolver
import repro_torch.core as tc
from repro_torch.core import solver as tsolver


@pytest.fixture(autouse=True)
def fallback(monkeypatch):
    monkeypatch.setattr(tsolver, "_HAVE_SCIPY", False)
    monkeypatch.setattr(jsolver, "_HAVE_SCIPY", False)


def _experiment(r):
    return (r.window_size, r.n_placed, r.n_rejected,
            [(e.window_size, e.n_target, e.n_moved, e.mean_moved_ratio, e.gain)
             for e in r.events], r.moved_fraction, r.mean_moved_ratio)


@pytest.mark.parametrize("window", [100, 200, 400])
def test_run_paper_sweep_under_the_fallback_equals_the_reference(window):
    t = tc.run_paper_sweep(windows=(window,), seeds=(0, 1, 2))
    j = jc.run_paper_sweep(windows=(window,), seeds=(0, 1, 2))
    assert [_experiment(r) for r in t[window]] == [_experiment(r) for r in j[window]]
    fracs = [r.moved_fraction for r in t[window]]
    assert 0.05 <= np.mean(fracs) <= 0.18, fracs          # paper fig. 5(a): about 1 in 10
    assert abs(np.mean([r.mean_moved_ratio for r in t[window]]) - 1.96) < 0.02


def test_the_fallback_gives_what_highs_gives_on_the_paper_experiment(monkeypatch):
    """The two solver paths agree on the trial's outcome (a proven optimum
    is one optimum here: no ties between different placements)."""
    fallback = _experiment(tc.run_paper_experiment(200, seed=1))
    monkeypatch.setattr(tsolver, "_HAVE_SCIPY", True)
    assert _experiment(tc.run_paper_experiment(200, seed=1))[:4] == fallback[:4]
