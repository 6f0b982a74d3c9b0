"""Quickstart: train a tiny LM for 30 steps on synthetic data, on the card.

    python -m repro_torch.examples.quickstart [--arch granite-3-2b] [--steps 30]
                                              [--device cuda]

The twin of the JAX package's ``examples/quickstart.py``.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.examples import device_of
from repro_torch.models import reduced
from repro_torch.train.trainer import TrainerConfig, make_synthetic_trainer


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-3-2b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    cfg = reduced(get_config(args.arch), vocab_size=256)
    print(f"arch={args.arch} (reduced: {cfg.param_count()/1e6:.2f}M params) on {device}")
    tcfg = TrainerConfig(steps=args.steps, log_every=5)
    trainer = make_synthetic_trainer(cfg, tcfg, global_batch=8, seq_len=64, device=device)
    trainer.run()
    first, last = trainer.metrics_log[0]["loss"], trainer.metrics_log[-1]["loss"]
    print(f"loss: {first:.3f} → {last:.3f}  ({'✓ learning' if last < first else '✗'})")
    return {"arch": args.arch, "params": cfg.param_count(), "device": str(device),
            "losses": [r["loss"] for r in trainer.metrics_log], "first_loss": first,
            "last_loss": last, "learning": last < first}


if __name__ == "__main__":
    main()
