"""The dense decoder (granite-3-2b), plain float32: token embedding,
blocks of pre-norm grouped-query attention with RoPE and a SwiGLU
feed-forward, a final RMSNorm and the head (the embedding's transpose
where tied), mean cross-entropy over the next tokens.  Each block is
recomputed in the backward (`torch.utils.checkpoint`)."""

from __future__ import annotations

from torch.utils.checkpoint import checkpoint

from reference.common import (Precision, attention_block, layer_leaves, mean_cross_entropy,
                              rms_norm)


def loss(params, inputs, targets, cfg, prec: Precision):
    x = params["embed.embedding"][inputs]
    for i in range(cfg["n_layers"]):
        x = checkpoint(attention_block, layer_leaves(params, cfg, i), x, cfg, prec,
                       use_reentrant=False)
    h = rms_norm(x, params["final_norm.scale"], cfg["norm_eps"])
    head = params["embed.embedding"].t() if cfg["tie_embeddings"] else params["unembed.w"]
    return mean_cross_entropy(h, head, targets, prec)
