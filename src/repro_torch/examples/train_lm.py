"""Training with checkpoint/restart: kill it mid-run and re-invoke
it; it resumes from the latest committed checkpoint on identical data.

    python -m repro_torch.examples.train_lm --steps 60 [--ckpt-dir DIR] \
        [--model-size 100m] [--device cuda]

The twin of the JAX package's ``examples/train_lm.py``, in the same
checkpoint format: a run of either package resumes the other's.
``--model-size 100m`` builds a ~100M-param granite-family config.  The
checkpoints go to ``repro_ckpt`` in the temporary directory (``$TMPDIR``)
unless ``--ckpt-dir`` names another.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Dict, Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.examples import device_of
from repro_torch.models import reduced
from repro_torch.train.trainer import TrainerConfig, make_synthetic_trainer


def build_cfg(size: str):
    base = get_config("granite-3-2b")
    if size == "tiny":
        return reduced(base, vocab_size=512)
    if size == "100m":
        return dataclasses.replace(
            base, name="granite-100m", n_layers=12, d_model=768, n_heads=12,
            n_kv_heads=4, d_ff=2048, vocab_size=32_000,
            param_dtype="float32", compute_dtype="float32")
    raise SystemExit(f"unknown --model-size {size}")


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--model-size", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    cfg = build_cfg(args.model_size)
    print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params → {args.steps} steps on {device}")
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=20, log_every=5, ckpt_dir=args.ckpt_dir)
    trainer = make_synthetic_trainer(cfg, tcfg, global_batch=args.batch, seq_len=args.seq,
                                     device=device)
    trainer.run()
    log = trainer.metrics_log
    start = log[0]["step"] if log else args.steps
    print(f"done; resumed at step {start}; checkpoints in {args.ckpt_dir}")
    return {"model": cfg.name, "params": cfg.param_count(), "device": str(device),
            "steps": args.steps, "start_step": start, "losses": [r["loss"] for r in log],
            "ckpt_dir": args.ckpt_dir}


if __name__ == "__main__":
    main()
