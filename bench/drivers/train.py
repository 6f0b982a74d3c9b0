"""The driver of training traffic: the port's `Trainer.run` on batches of
token ids drawn from ``--seed``, timed over a window.

Set-up builds one train state from the benchmark's weights (`weights`)
and hands it to one `Trainer.run` call, which goes on from the checked
steps into the window: the first ``checked_steps`` steps are the
warm-up, and the readings `harness.check` compares are taken from them
(the losses; AdamW's first moment after one step; each leaf's change
after the last); then the window, ``--seconds`` long, and with ``--trace
1`` a traced stretch after it.  A step hook stamps each step and ends the
loop.  Once the window has closed and the peak is read, the program's
state is freed and the plain reference (`reference.train`) runs the same
steps from the same weights and batches."""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
from typing import Dict, List, Optional

import torch

from harness import check, trace
from harness.weights import layout, make_leaf, make_weights, slices

#: Stamps of the host's spans, wall clock (ns), as the profiler's events.
_now_ns = time.time_ns


class _Stop(Exception):
    """Raised by the step hook to end `Trainer.run`."""


def batch_seed(seed: int, step: int) -> int:
    return (seed * 0xD1B54A32D192ED03 + (step + 1) * 0x94D049BB133111EB) % (1 << 63)


def make_batch(traffic: Dict, vocab: int, seed: int, step: int, device):
    """Step ``step``'s token ids, uniform over the vocabulary: (inputs,
    targets), each (batch, seq), targets the inputs shifted by one."""
    g = torch.Generator(device).manual_seed(batch_seed(seed, step))
    ids = torch.randint(0, vocab, (traffic["batch"], traffic["seq"] + 1), generator=g,
                        device=device)
    return ids[:, :-1], ids[:, 1:]


class Batches:
    """The batch source `Trainer.run` reads (``batch_at``), stamping when
    each step's batch is asked for."""

    def __init__(self, traffic: Dict, vocab: int, seed: int, device, loop: "Loop"):
        self.traffic, self.vocab, self.seed, self.device, self.loop = (
            traffic, vocab, seed, device, loop)

    def batch_at(self, step: int):
        self.loop.batch_begins(step)
        start = _now_ns()
        inputs, targets = make_batch(self.traffic, self.vocab, self.seed, step, self.device)
        self.loop.spans.append(("batch", start, _now_ns()))
        return {"inputs": inputs, "targets": targets}


def model_config(cfg: Dict):
    from repro_torch.models import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def _by_path(tree) -> Dict[str, torch.Tensor]:
    from repro_torch._tree import tree_items
    return dict(tree_items(tree))


def nested(flat: Dict[str, torch.Tensor]) -> Dict:
    """The port's parameter tree from dotted leaf paths: dicts, and a list
    under ``tail`` (empty where the stack has no tail layers)."""
    tree: Dict = {"tail": {}}
    for path, t in flat.items():
        *keys, last = path.split(".")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = t
    tree["tail"] = [tree["tail"][str(i)] for i in range(len(tree["tail"]))]
    return tree


def program_state(optimizer, weights: Dict[str, torch.Tensor]) -> Dict:
    """The port's train state holding ``weights`` (no copy): its
    parameters, the optimizer's state and step 0."""
    params = nested(weights)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=weights["embed.embedding"].device)}


class Loop:
    """The step hook: records the checked steps' readings, times the
    window, runs the traced stretch, and ends the loop."""

    def __init__(self, cfg, traffic, seed, seconds, traced, window, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.seconds, self.traced, self.window = seconds, traced, window
        self.checked = traffic["checked_steps"]
        self.readings = {"loss": [], "grad": {}, "delta": {}}
        self.spans: List = []
        self.window_start = self.window_end = None
        self.window_steps = 0
        self.window_losses: List[float] = []
        self.window_step_s: List[float] = []
        self.peak = 0
        self.trace_start_ns = None
        self.trace_steps = 0
        self.prof = None
        self.trace: Optional[Dict] = None
        self.phase = "checked"
        self.call_end = 0
        self.marks: Dict[str, float] = {}
        self.loaded: Dict[str, int] = {}
        self.dynamo_by: Optional[str] = None
        self.mark("start")
        self.collections = self.gc_at_start = self.gc_in_window = None

    def mark(self, name: str) -> None:
        """Stamps a stage of set-up, with the modules loaded by then."""
        self.marks[name] = time.perf_counter()
        self.loaded[name] = len(sys.modules)
        if self.dynamo_by is None and "torch._dynamo" in sys.modules:
            self.dynamo_by = name

    def batch_begins(self, step: int) -> None:
        if step == self.checked and self.window:
            # Set-up's garbage collected before the window, so that the
            # window's collections come at the same steps in every run.
            gc.collect()
            self.mark("window")
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.device)
            self.gc_at_start = {g: list(v) for g, v in self.collections.totals.items()}
            self.window_start = time.perf_counter()
        if self.phase == "trace" and self.trace_start_ns is None:
            self.trace_start_ns = _now_ns()

    def wrap(self, step_fn):
        def timed(state, batch):
            start = _now_ns()
            out = step_fn(state, batch)
            self.call_end = _now_ns()
            self.spans.append(("step call", start, self.call_end))
            return out
        return timed

    def __call__(self, trainer, step, state, rec):
        entry = _now_ns()
        self.spans.append(("loss wait", self.call_end, entry))
        try:
            getattr(self, f"_{self.phase}")(step, state, rec)
        finally:
            self.spans.append(("hook", entry, _now_ns()))

    def _checked(self, step, state, rec):
        self.mark(f"step {step}")
        self.readings["loss"].append(rec["loss"])
        if step == 0:
            b1 = self.traffic["optimizer"]["b1"]
            self.readings["grad"] = self._leaf_norms(state["opt"]["m"], 1 - b1)
        if step == self.checked - 1:
            self.readings["delta"] = self._changes(state["params"])
            self.mark("readings")
            self.phase = "window"
            if not self.window:
                raise _Stop

    def _window(self, step, state, rec):
        now = time.perf_counter()
        self.window_steps += 1
        self.window_losses.append(rec["loss"])
        self.window_step_s.append(rec["dt_s"])
        if now - self.window_start < self.seconds:
            return
        self.window_end = now
        self.gc_in_window = {g: [v[0] - self.gc_at_start[g][0], v[1] - self.gc_at_start[g][1]]
                             for g, v in self.collections.totals.items()}
        if self.device.type == "cuda":
            self.peak = torch.cuda.max_memory_allocated(self.device)
        if not self.traced or self.device.type != "cuda":
            raise _Stop
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])   # one step to warm it up
        self.prof.__enter__()
        self.phase = "trace_warm"

    def _trace_warm(self, step, state, rec):
        from torch.profiler import ProfilerActivity, profile
        self.prof.__exit__(None, None, None)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.spans.clear()
        self.phase = "trace"

    def _trace(self, step, state, rec):
        self.trace_steps += 1
        if self.trace_steps < self.traffic["trace_steps"]:
            return
        t0, t1 = self.trace_start_ns, _now_ns()
        torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        events = trace.device_events(self.prof)
        self.prof = None
        if not any(s < t1 and e > t0 for _, s, e in events):
            raise RuntimeError("the profiler's device events lie outside the traced steps' "
                               "host stamps: the two clocks differ")
        self.trace = trace.reduce(events, self.spans, t0, t1)
        self.trace["steps"] = self.trace_steps
        raise _Stop

    def _leaf_norms(self, tree, div: float = 1.0) -> Dict[str, float]:
        flat = _by_path(tree)
        out = {}
        for leaf in layout(self.cfg):
            for name, t in slices(leaf, flat[leaf.name]):
                out[name] = float(t.float().norm()) / div
        return out

    def _changes(self, params) -> Dict[str, float]:
        flat = _by_path(params)
        out = {}
        for i, leaf in enumerate(layout(self.cfg)):
            first = make_leaf(leaf, self.seed, i, self.device)
            for (name, now), (_, then) in zip(slices(leaf, flat[leaf.name]), slices(leaf, first)):
                out[name] = float((now.float() - then.float()).norm())
            del first
        return out


class _Collections:
    """Stamps the interpreter's garbage collections as host spans while a
    run trains (observation only: `gc.callbacks`)."""

    def __init__(self, spans: List):
        self.spans, self.start = spans, 0
        self.totals = {0: [0, 0.0], 1: [0, 0.0], 2: [0, 0.0]}   # generation: count, seconds

    def __call__(self, phase, info):
        if phase == "start":
            self.start = _now_ns()
        else:
            end, gen = _now_ns(), info["generation"]
            self.spans.append((f"gc gen {gen}", self.start, end))
            self.totals[gen][0] += 1
            self.totals[gen][1] += (end - self.start) / 1e9

    def __enter__(self):
        gc.callbacks.append(self)

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def _faulty(step_fn, fault: Optional[str], mcfg, loss_chunk: int):
    """The program's step with a planted fault, for the checks of the
    comparison itself: ``unchanged`` returns its state as it was (the loss
    still computed); ``half_batch`` leaves out half of the batch's rows."""
    if fault is None:
        return step_fn
    if fault == "unchanged":
        from repro_torch.models import lm_loss

        def unchanged(state, batch):
            with torch.no_grad():
                loss, _ = lm_loss(state["params"], batch, mcfg, loss_chunk=loss_chunk)
            return state, {"loss": loss, "grad_norm": torch.zeros(())}
        return unchanged
    if fault == "half_batch":
        def half(state, batch):
            return step_fn(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
        return half
    raise ValueError(f"unknown fault {fault!r}")


def _optimizer(o: Dict):
    from repro_torch.train import make_optimizer
    return make_optimizer("adamw", lr=o["lr"], warmup=o["warmup"], total_steps=o["total_steps"],
                          b1=o["b1"], b2=o["b2"], eps=o["eps"], weight_decay=o["weight_decay"],
                          grad_clip=o["grad_clip"])


def _release(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def program(cfg: Dict, traffic: Dict, seed: int, device, seconds: float = 0.0,
            traced: bool = False, window: bool = True, fault: Optional[str] = None) -> Loop:
    """The port trained through `Trainer.run`: the checked steps, then
    (``window``) the timed window and (``traced``) the traced stretch.
    Returns the hook, which holds the readings and stamps; the program's
    state is freed.  ``fault`` plants a fault in its step (`_faulty`)."""
    loop = Loop(cfg, traffic, seed, seconds, traced, window, device)
    from repro_torch.train import Trainer, TrainerConfig

    mcfg = model_config(cfg)
    optimizer = _optimizer(traffic["optimizer"])
    loop.mark("port")
    torch.zeros((), device=device)
    loop.mark("device")
    state = program_state(optimizer, make_weights(cfg, seed, device))
    loop.mark("state")
    tcfg = TrainerConfig(steps=1 << 40, log_every=1 << 40, loss_chunk=traffic["loss_chunk"])
    data = Batches(traffic, cfg["vocab_size"], seed, device, loop)
    trainer = Trainer(mcfg, tcfg, data, optimizer=optimizer, step_hooks=[loop], device=device)
    trainer._step = loop.wrap(_faulty(trainer._step, fault, mcfg, traffic["loss_chunk"]))
    loop.collections = _Collections(loop.spans)
    try:
        with loop.collections:
            trainer.run(state=state, start_step=0)
    except _Stop:
        pass
    finally:
        if loop.prof is not None:
            loop.prof.__exit__(None, None, None)
            loop.prof = None
    del trainer, state, data, optimizer
    _release(device)
    return loop


def reference_readings(cfg: Dict, traffic: Dict, seed: int, device,
                       precision: str = "float32") -> Dict:
    """The plain reference's readings of the checked steps, from the same
    weights and batches as the program's; ``precision`` "float8" gives the
    control's."""
    import reference        # only once the program's window has closed

    lay = layout(cfg)
    batches = [make_batch(traffic, cfg["vocab_size"], seed, s, device)
               for s in range(traffic["checked_steps"])]
    out = reference.train(cfg, traffic["optimizer"], lay, make_weights(cfg, seed, device),
                          batches, lambda leaf: make_leaf(leaf, seed, lay.index(leaf), device),
                          precision=precision)
    _release(device)
    return out


def run(cfg: Dict, traffic: Dict, limits: Dict, seed: int, seconds: float, traced: bool,
        device, t_start: float, fault: Optional[str] = None) -> Dict:
    """One run of a training cell: the program's set-up, window and
    (``traced``) traced steps, then the comparison with the reference.
    ``fault`` (the benchmark's own tests) plants a fault in the step."""
    device = torch.device(device)
    loop = program(cfg, traffic, seed, device, seconds, traced, fault=fault)
    t_ref = time.perf_counter()
    ref = reference_readings(cfg, traffic, seed, device)
    checked = check.verdict(check.numbers(loop.readings, ref), limits)
    return {
        "cfg": cfg, "traffic": traffic,
        "setup_s": loop.window_start - t_start,
        "window_s": loop.window_end - loop.window_start,
        "steps": loop.window_steps,
        "tokens": loop.window_steps * traffic["batch"] * traffic["seq"],
        "peak_bytes": loop.peak,
        "trace": loop.trace,
        "attempted": loop.window_steps,
        "failed": sum(1 for x in loop.window_losses if not math.isfinite(x)),
        "checked": checked,
        "correct": check.passed(checked),
        "notes": {"reference_s": time.perf_counter() - t_ref,
                  "setup_marks": {k: v - t_start for k, v in loop.marks.items()},
                  "setup_modules": loop.loaded,
                  "dynamo_by": loop.dynamo_by,
                  "step_s": loop.window_step_s,
                  "gc_in_window": loop.gc_in_window,
                  "losses": loop.readings["loss"], "reference_losses": ref["loss"]},
    }
