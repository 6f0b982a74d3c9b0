"""The comparison that decides ``correct`` fails what it must, at small
bfloat16 sizes on the CPU: the control (the reference computed in
float8, in the program's place) and whole runs with a fault planted under
the timed path (a step that returns its state unchanged; half of the
batch left out), while sound runs of the program pass.  The limits here
are the small cells' own, set as the cells' limits are (between the
program's readings and the control's); the cells' limits were read on
the card at their own sizes (PERF.md)."""

import time

import pytest
import torch

from conftest import TINY_TRAFFIC, tiny
from drivers import train as driver
from harness import check

LIMITS = {"tiny-dense": {"loss_gap": 1e-3, "grad_gap": 6e-3, "delta_gap": 8e-3},
          "tiny-hybrid": {"loss_gap": 1e-3, "grad_gap": 0.025, "delta_gap": 0.04}}
CPU = torch.device("cpu")


def _whole_run(name, seed, fault=None):
    return driver.run(tiny(name, "bfloat16"), TINY_TRAFFIC, LIMITS[name], seed, 0.3, False, CPU,
                      time.perf_counter(), fault=fault)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(LIMITS))
def test_sound_runs_pass_and_the_control_fails(name, seed):
    run = _whole_run(name, seed)
    assert run["correct"], run["checked"]
    cfg = tiny(name, "bfloat16")
    ref = driver.reference_readings(cfg, TINY_TRAFFIC, seed, CPU)
    ctl = driver.reference_readings(cfg, TINY_TRAFFIC, seed, CPU, precision="float8")
    checked = check.verdict(check.numbers(ctl, ref), LIMITS[name])
    assert not check.passed(checked), checked


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("name", sorted(LIMITS))
def test_a_planted_fault_fails(name, fault):
    run = _whole_run(name, 1, fault)
    assert not run["correct"], run["checked"]
    if fault == "unchanged":       # no change and no first moment: both read 1
        assert run["checked"]["grad_gap"]["value"] == pytest.approx(1.0)
        assert run["checked"]["delta_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.chip
@pytest.mark.parametrize("name", sorted(LIMITS))
def test_the_kernels_path_passes_on_the_card(card, name):
    """The same small cells through the port's kernels on the card: sound
    runs pass their limits (the bf16 kernels round as the plain path
    does, within them)."""
    cfg = dict(tiny(name, "bfloat16"), d_model=128, n_heads=2, d_head=64,
               n_kv_heads=1 if name == "tiny-dense" else 2)
    if name == "tiny-hybrid":       # the scan kernels' own tile sizes
        cfg.update(mamba_headdim=64, ssm_state=64, ssm_chunk=64)
    run = driver.run(cfg, dict(TINY_TRAFFIC, seq=128), LIMITS[name], 4, 0.5, True, card,
                     time.perf_counter())
    assert run["correct"], run["checked"]
    assert run["trace"]["busy_s"] > 0
