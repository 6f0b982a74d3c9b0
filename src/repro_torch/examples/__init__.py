"""The port's own entry points, the twins of the JAX package's
``examples/`` scripts: each runs as ``python -m repro_torch.examples.<name>``
with the reference script's arguments and defaults and ``--device``
(default ``cuda``: without a card it raises; ``cpu`` is for tests), and its
``main(argv=None)`` returns what it printed as a dict.

  quickstart             train a tiny LM for 30 steps on synthetic data
  serve_lm               train briefly, then serve a request stream
                         through the continuous-batching engine
  train_lm               train with checkpoints; re-invoked, it resumes
  fleet_runtime_demo     the fleet runtime under three policies
  reconfiguration_demo   Steps 5 and 7 of the paper on a pod fleet, and
                         one move executed live through the elastic bridge
"""

from __future__ import annotations

import torch


def device_of(name: str) -> torch.device:
    """The device ``--device`` names; a CUDA device must be there."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this entry point runs on the card by default; "
                           "pass --device cpu to run it on the host")
    return device
