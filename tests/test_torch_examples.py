"""The port's own entry points (`repro_torch.examples`), the twins of the
JAX package's ``examples/`` scripts, run here with ``--device cpu`` at
small arguments: each returns what it printed, and where the reference
computes the same thing the two agree.  The fleet demo's three policies
give the reference's telemetry fingerprints; the reconfiguration demo's
fleet, trial, moves and satisfaction ratios are the reference's exactly,
and its live move restores the job bit for bit onto a (1, 1) gloo mesh;
`train_lm` resumes from its own checkpoint and from the reference's (the
shared checkpoint format carries the weights across), its loss there
within 1e-5 of the reference's uninterrupted run (tests/test_torch_ckpt.py's
tolerance)."""

import importlib
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

NAMES = ("quickstart", "serve_lm", "train_lm", "fleet_runtime_demo", "reconfiguration_demo")
LOSS_TOL = dict(rtol=1e-5)


def twin(name):
    return importlib.import_module(f"repro_torch.examples.{name}")


def reference(name):
    """The JAX package's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", NAMES)
def test_an_entry_point_runs_on_the_card_unless_asked_for_the_cpu(name, tmp_path):
    """``--device`` defaults to ``cuda``; without a card the entry point
    raises before it runs anything."""
    assert twin(name).main.__defaults__ == (None,)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = ["--ckpt-dir", str(tmp_path)] if name == "train_lm" else []
    with pytest.raises(RuntimeError, match="CUDA"):
        twin(name).main(argv)
    assert not list(tmp_path.iterdir())


def test_quickstart_learns():
    out = twin("quickstart").main(["--steps", "8", "--device", "cpu"])
    assert out["device"] == "cpu" and len(out["losses"]) == 8
    assert np.all(np.isfinite(out["losses"])) and out["learning"]


def test_serve_lm_serves_every_request_alike_twice():
    argv = ["--requests", "3", "--slots", "2", "--max-new", "4", "--train-steps", "2",
            "--device", "cpu"]
    first, second = (twin("serve_lm").main(argv) for _ in range(2))
    assert first["served"] == first["requests"] == 3 and first["tokens"] == 12
    assert first["streams"] == second["streams"]
    assert first["train_losses"] == second["train_losses"]


def test_train_lm_resumes_from_its_own_checkpoint(tmp_path):
    argv = lambda steps: ["--steps", str(steps), "--batch", "2", "--seq", "16",
                          "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    first = twin("train_lm").main(argv(4))
    assert first["start_step"] == 0 and len(first["losses"]) == 4
    again = twin("train_lm").main(argv(6))
    assert again["start_step"] == 4 and len(again["losses"]) == 2
    assert np.all(np.isfinite(again["losses"]))


class _Crash(Exception):
    pass


def test_train_lm_resumes_the_references_checkpoint(tmp_path):
    """The reference's `Trainer`, built as its ``train_lm.py`` builds it,
    stops after its step-20 checkpoint; the port's ``train_lm`` resumes at
    step 21 and its loss there is the reference's uninterrupted run's."""
    from repro.train import trainer as jtrainer

    cfg = reference("train_lm").build_cfg("tiny")
    make = lambda d, hooks=(): jtrainer.make_synthetic_trainer(
        cfg, jtrainer.TrainerConfig(steps=22, ckpt_every=20, log_every=10 ** 9, ckpt_dir=d),
        2, 16, step_hooks=list(hooks))
    straight = make(str(tmp_path / "straight"))
    straight.run()
    want = {m["step"]: m["loss"] for m in straight.metrics_log}

    def crash(trainer, step, state, rec):
        if step == 21:
            raise _Crash

    shared = tmp_path / "job"
    first = make(str(shared), [crash])
    with pytest.raises(_Crash):
        first.run()
    first.ckpt.wait()
    shutil.rmtree(tmp_path / "straight")
    out = twin("train_lm").main(["--steps", "22", "--batch", "2", "--seq", "16", "--ckpt-dir",
                                 str(shared), "--device", "cpu"])
    assert out["start_step"] == 21 and len(out["losses"]) == 1
    np.testing.assert_allclose(out["losses"][0], want[21], **LOSS_TOL)


def test_the_fleet_demo_gives_the_references_fingerprints():
    out = twin("fleet_runtime_demo").main(["--device", "cpu"])
    ref = reference("fleet_runtime_demo")
    assert list(out["policies"]) == ["milp", "decomposed", "noop"]
    for policy, got in out["policies"].items():
        assert got["fingerprint"] == ref.run_one(out["scenario"], policy).fingerprint(), policy


def _reference_trial():
    """Steps 1-3 and 5 of the reference's demo, as its ``main`` runs them."""
    from repro.core.cluster import FleetScheduler, JobSpec, PodSpec, build_fleet_topology

    from repro_torch.examples.reconfiguration_demo import PODS

    sched = FleetScheduler(build_fleet_topology([PodSpec(*p) for p in PODS]),
                           reconfig_every=10 ** 9, window=24)
    rng = np.random.default_rng(0)
    admitted = []
    for i in range(14):
        fast = i % 3 == 0
        t = float(rng.uniform(0.8, 2.0))
        admitted.append(sched.submit(JobSpec(
            job_id=i, arch="granite-3-2b", shape="train_4k", chips=64, step_time_s=t,
            step_slo_s=t + (0.1 if fast else 2.0), budget_usd_month=None if fast else 90_000.0)))
    utilization = sched.utilization()
    for done in (1, 2):
        sched.engine.release(done)
    return sched.recon.plan(sched.engine.recent(24)), admitted, utilization


def test_the_reconfiguration_demo_is_the_references_and_moves_its_job_bit_for_bit():
    from repro_torch.configs import get_config
    from repro_torch.models import reduced
    from repro_torch.train.trainer import TrainerConfig, make_synthetic_trainer

    out = twin("reconfiguration_demo").main(["--device", "cpu"])
    res, admitted, utilization = _reference_trial()
    assert out["admitted"] == admitted and out["utilization"] == utilization
    assert (out["s_before"], out["s_after"], out["gain"]) == (res.s_before, res.s_after,
                                                              res.gain)
    assert out["n_moved"] == res.n_moved > 0 and out["mean_moved_ratio"] == res.mean_moved_ratio
    assert out["moves"] == [{"job": m.req_id, "source": m.old.node.site_id,
                             "destination": m.new.node.site_id, "ratio": m.ratio}
                            for m in res.moves]
    assert out["ratios"] == [s.ratio for s in res.satisfaction]

    move = out["live_move"]
    assert move["job"] == res.moves[0].req_id and move["mesh"] == [1, 1]
    assert move["resumed_at_step"] == 6 and move["restored_bit_for_bit"]
    # The job never moved: the same 6 steps, then 4 from its own state.
    cfg = reduced(get_config("granite-3-2b"), vocab_size=128)
    first = make_synthetic_trainer(cfg, TrainerConfig(steps=6, log_every=10 ** 9), 4, 32,
                                   device="cpu")
    state = first.run()
    second = make_synthetic_trainer(cfg, TrainerConfig(steps=10, log_every=10 ** 9), 4, 32,
                                    device="cpu")
    second.run(state=state, start_step=6)
    assert move["losses_before"] == [r["loss"] for r in first.metrics_log]
    assert move["losses_after"] == [r["loss"] for r in second.metrics_log]
