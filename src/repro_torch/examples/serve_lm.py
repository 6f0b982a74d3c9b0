"""End-to-end serving: briefly train a small LM so it has structure,
then serve a stream of batched requests through the continuous-batching
engine on the card and report latency and throughput.

    python -m repro_torch.examples.serve_lm [--arch qwen1.5-0.5b] [--requests 24]
                                            [--slots 4] [--device cuda]

The twin of the JAX package's ``examples/serve_lm.py``.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.examples import device_of
from repro_torch.models import reduced
from repro_torch.serve import Request, ServeEngine
from repro_torch.train.trainer import TrainerConfig, make_synthetic_trainer


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--train-steps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    cfg = reduced(get_config(args.arch), vocab_size=256)
    print(f"arch={args.arch} reduced {cfg.param_count()/1e6:.2f}M params on {device}")
    tcfg = TrainerConfig(steps=args.train_steps, log_every=100)
    trainer = make_synthetic_trainer(cfg, tcfg, global_batch=8, seq_len=64, device=device)
    params = trainer.run()["params"]

    rng = np.random.default_rng(0)
    engine = ServeEngine(cfg, params, batch_slots=args.slots, max_len=64, eos_id=-1,
                         temperature=0.0, device=device)
    for i in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size, size=rng.integers(4, 12)).tolist()
        engine.submit(Request(i, prompt=prompt, max_new_tokens=args.max_new))

    t0 = time.perf_counter()
    done = engine.run_until_done()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    print(f"served {len(done)}/{args.requests} requests, {toks} tokens "
          f"in {dt:.2f}s → {toks/dt:.1f} tok/s "
          f"({engine.steps} engine steps, {args.slots} slots)")
    if len(done) != args.requests:
        raise RuntimeError(f"served {len(done)} of {args.requests} requests")
    return {"arch": args.arch, "device": str(device), "served": len(done),
            "requests": args.requests, "tokens": toks, "seconds": dt, "tok_s": toks / dt,
            "engine_steps": engine.steps, "slots": args.slots,
            "train_losses": [r["loss"] for r in trainer.metrics_log],
            "streams": {r.req_id: list(r.output) for r in done}}


if __name__ == "__main__":
    main()
