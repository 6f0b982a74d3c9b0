"""Mixture-of-Experts FFN: top-k token-choice router + capacity-bounded
sort-based dispatch (DBRX 16e/top-4, Kimi-K2 384e/top-8); the port of
`repro.models.moe`.

The sort-based dispatch gives operations in proportion to the active
experts' work (times the capacity factor).  The expert products are plain
batched matrix products (`torch.matmul`), as the reference computes them
outside any kernel of its own.  Under a sharding context whose strategy
selects ``ep_shardmap`` (and whose model axis divides the experts), `moe_ffn`
takes the expert-parallel branch, `parallel.moe_ep.moe_ffn_ep`, as the
reference does; otherwise the single-program path below.  There, as in the
reference, the layer is over the whole batch, wherever its rows are: when
the data-parallel ranks each hold a part, they share their per-expert
counts (`parallel.context.dp_gather`), so that the capacity is the whole
batch's, a rank's assignments take their places in each expert's buffer
after those of the ranks before it, and the load balance uses the whole
batch's dispatch fractions.

Each rank computes only its own share of that buffer (`_own_rows`): the
rows its own tokens take, for the experts it holds (the experts' leaves
stay cut along ``strat.ep``, "model"; all E outside a context).  Its
tokens' rows of an expert are a contiguous run of that expert's buffer,
so they are packed into a buffer of ``E / n_ep`` experts, ``rows`` long,
and the rank's partial outputs are summed over the expert axis.  Where
the batch is one part, ``rows`` is the capacity, and the layer is the
whole (E, cap, d) buffer's product.  Where it is several, ``rows`` is the
longest run: a device-to-host read of one number a layer, after the
counts' all-gather (on the card `torch.bincount` already reads one back).
A run is at most min(cap, T): each token takes an expert once.  On the
``meta`` device, where there are no counts, ``rows`` is a part's even
share of the capacity, so a dry run counts the layer under even routing.
Outputs, drops and the aux loss are those of the whole buffer.

Two differences of order, neither of value where the inputs have no ties:
`torch.topk` does not promise the reference's lower index first among
equal router probabilities (ties are rare in fp32), and the combine sums
each token's k expert outputs in a fixed order (unsort to (T, k, d), then
a sum over k) where the reference scatter-adds, so that a token's output
does not depend on the order of atomic adds on the card (a migrated slot
continues bit for bit).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .._tree import tree_stack
from ..parallel.comm import copy_to, reduce_from
from ..parallel.context import current, dp_gather, ep_part, ep_size, gather_params
from .config import ModelConfig
from .ffn import ACTIVATIONS, init_ffn
from .layers import dtype_of, init_linear


def init_moe(generator, cfg: ModelConfig, dtype, device=None) -> Dict:
    # Stacked expert FFNs: leaves get a leading (E,) axis.
    return {
        "router": init_linear(generator, cfg.d_model, cfg.n_experts, torch.float32,
                              device=device),
        "experts": tree_stack(cfg.n_experts,
                              lambda: init_ffn(generator, cfg, dtype, device=device)),
    }


def router_probs(params, x_flat, cfg: ModelConfig):
    """fp32 router; returns (logits, probs, top-k probs/ids) with the top-k
    weights renormalized (standard for top-k>1 routers)."""
    logits = x_flat.float() @ params["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_ids = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, top_p, top_ids


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    return max(1, int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                                / cfg.n_experts)))


def build_dispatch(top_ids, top_p, n_tokens: int, cfg: ModelConfig, cap: int):
    """Sort-based dispatch plan.

    Returns (token_src, buffer_idx, keep, weight) flat tensors of length
    ``n_tokens*top_k`` in expert order (a stable sort of the assignments),
    where ``buffer_idx`` addresses an (E*cap,) expert buffer and dropped
    assignments point at a dump slot E*cap.
    """
    return _plan(top_ids, top_p, n_tokens, cfg, cap)[1:]


def _plan(top_ids, top_p, n_tokens: int, cfg: ModelConfig, cap: int, before=None):
    """The sorting permutation, then `build_dispatch`'s outputs.  ``before``
    (E,): the assignments to each expert that take its buffer's places
    ahead of these (those of the batch's earlier rows, held elsewhere)."""
    k = cfg.top_k
    flat_e = top_ids.reshape(-1)                                  # (T*k,)
    sorted_e, order = torch.sort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=cfg.n_experts)
    offsets = torch.cumsum(counts, 0) - counts
    if before is not None:
        offsets = offsets - before
    rank = torch.arange(n_tokens * k, device=top_ids.device) - offsets[sorted_e]
    keep = rank < cap
    buffer_idx = torch.where(keep, sorted_e * cap + rank,
                             torch.full_like(rank, cfg.n_experts * cap))
    token_src = torch.div(order, k, rounding_mode="floor")        # repeat(arange(T), k)[order]
    return order, token_src, buffer_idx, keep, top_p.reshape(-1)[order]


def aux_losses(logits, probs, top_ids, cfg: ModelConfig, dispatched=None):
    """Switch-style load-balance loss + router z-loss.  ``dispatched`` (E,):
    the whole batch's assignments to each expert where these tokens are a
    part of it; the loss is then this part's share, linear in its tokens'
    router statistics, so that the mean over equal parts is the whole
    batch's loss."""
    E = cfg.n_experts
    if dispatched is None:
        dispatched = torch.bincount(top_ids.reshape(-1), minlength=E)        # (E,)
    frac_dispatched = dispatched.float() / dispatched.sum()
    mean_prob = probs.mean(0)
    balance = E * torch.sum(frac_dispatched * mean_prob)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return cfg.aux_loss_coef * balance + cfg.router_z_loss * z, {
        "moe_balance": balance, "moe_zloss": z,
    }


def expert_ffn(expert_params, buf, cfg: ModelConfig):
    """Apply stacked expert FFNs: buf (E, C, d) -> (E, C, d)."""
    cd = dtype_of(cfg.compute_dtype)
    b = buf.to(cd)
    w = lambda name: expert_params[name]["w"].to(cd)
    if cfg.ffn_type == "swiglu":
        gate = F.silu(torch.matmul(b, w("w_gate")))
        up = torch.matmul(b, w("w_up"))
        return torch.matmul(gate * up, w("w_down"))
    h = torch.matmul(b, w("w_up"))
    h = ACTIVATIONS["gelu" if cfg.ffn_type == "gelu" else "relu2"](h)
    return torch.matmul(h, w("w_down"))


def moe_ffn(params: Dict, x: torch.Tensor,
            cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """MoE FFN.  x: (B, S, d) -> (out, aux_loss, metrics).

    Capacity is taken over all B*S tokens of the call (of the whole batch,
    under a context whose data-parallel ranks each hold a part), so in
    decode (S = 1) a row's output depends on which experts the other rows
    chose: an assignment past its expert's capacity is dropped, as in the
    reference.
    """
    if ep_size(cfg) > 1:
        from ..parallel.moe_ep import moe_ffn_ep
        return moe_ffn_ep(params, x, cfg, *current())
    params = gather_params(params, experts=True)
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    logits, probs, top_p, top_ids = router_probs(params, xf, cfg)
    counts = torch.bincount(top_ids.reshape(-1), minlength=cfg.n_experts)
    every, part = dp_gather(counts)                   # (n_parts, E): every part's counts
    cap = capacity(T * every.shape[0], cfg)
    before = every[:part].sum(0)
    order, token_src, buffer_idx, keep, weight = _plan(top_ids, top_p, T, cfg, cap,
                                                       before=before)
    out = _own_rows(params["experts"], xf, top_ids, counts, before, cap, order, token_src,
                    buffer_idx, keep, weight, every.shape[0], cfg)
    aux, metrics = aux_losses(logits, probs, top_ids, cfg, dispatched=every.sum(0))
    metrics["moe_drop_frac"] = 1.0 - keep.float().mean()
    return out.reshape(B, S, d), aux, metrics


def _own_rows(experts, xf, top_ids, counts, before, cap, order, token_src, buffer_idx, keep,
              weight, n_parts, cfg: ModelConfig) -> torch.Tensor:
    """`moe_ffn`'s output for this rank's tokens ``xf`` (T, d), from the
    rows of the whole (E, cap, d) buffer that they take in the experts
    this rank holds (``experts``: E / n_ep of them, from this rank's index
    along the expert axis, or all E where they arrive whole), summed over
    that axis.  ``before`` (E,): each expert's slots taken by the parts of
    the batch ahead of this one; ``n_parts`` the batch's parts.  With one
    part and all E experts this is the whole buffer's product, op for op."""
    T, d = xf.shape
    E_loc = experts["w_up"]["w"].shape[0]
    n_ep, r_ep, group = ep_part() if E_loc < cfg.n_experts else (1, 0, None)
    if E_loc * n_ep != cfg.n_experts:
        raise ValueError(f"{E_loc} experts a rank over {n_ep} expert ranks: "
                         f"not the config's {cfg.n_experts}")
    e0 = r_ep * E_loc
    sorted_e = top_ids.reshape(-1)[order]
    rows = _part_rows(counts, before, cap, n_parts, T, e0, E_loc, xf.is_meta)
    mine = keep & (sorted_e >= e0) & (sorted_e < e0 + E_loc)
    run_pos = buffer_idx - sorted_e * cap - before[sorted_e]   # place in the run
    dest = torch.where(mine, (sorted_e - e0) * rows + run_pos,
                       torch.full_like(run_pos, E_loc * rows))
    xin = copy_to(xf, group, n_ep)            # the other ranks' experts take their parts
    buf = torch.zeros((E_loc * rows + 1, d), dtype=xf.dtype, device=xf.device)
    buf = buf.index_put((dest,), xin[token_src] * mine[:, None].to(xf.dtype))
    y = expert_ffn(experts, buf[:-1].reshape(E_loc, rows, d), cfg)
    y = torch.cat([y.reshape(-1, d), torch.zeros((1, d), dtype=y.dtype, device=y.device)])
    w = copy_to(weight, group, n_ep)
    gathered = y[dest] * (w * mine)[:, None].to(y.dtype)
    out = gathered[torch.argsort(order)].reshape(T, cfg.top_k, d).sum(1)
    return reduce_from(out, group, n_ep)


def _part_rows(counts, before, cap: int, n_parts: int, T: int, e0: int, E_loc: int,
               meta: bool) -> int:
    """The rows a part's buffer holds for each expert: the capacity where
    the batch is one part; else the longest run of this part's tokens in
    the buffers of experts ``[e0, e0 + E_loc)``, read back to the host (on
    meta, where there are no counts, the even share).  A run is at most
    min(cap, T): each token takes an expert once."""
    if n_parts == 1:
        return cap                    # the part's runs are the whole buffer
    if meta:
        return min(-(-cap // n_parts), T)
    # This part's run of each expert's buffer: slots [before, before + n).
    runs = ((before + counts).clamp(max=cap) - before).clamp(min=0)[e0:e0 + E_loc]
    return int(runs.max())


def moe_ffn_dense_oracle(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """All-experts dense evaluation (no capacity drops): a tiny-shape oracle
    for the dispatch path when the capacity factor is large enough that
    nothing drops."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    _, _, top_p, top_ids = router_probs(params, xf, cfg)
    # (T, E): combined weight per expert.
    w = torch.zeros((xf.shape[0], cfg.n_experts), dtype=torch.float32, device=x.device)
    w = w.scatter(1, top_ids, top_p)
    # Evaluate every expert on every token.
    buf = xf[None].expand(cfg.n_experts, *xf.shape)
    y = expert_ffn(params["experts"], buf, cfg)                  # (E, T, d)
    out = torch.einsum("etd,te->td", y.float(), w)
    return out.reshape(B, S, d).to(x.dtype)
