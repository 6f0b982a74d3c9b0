"""Serving: prefill / decode steps and a continuous-batching engine.

`make_prefill_step` / `make_decode_step` build the pure step functions;
`ServeEngine` drives the decode step for real requests, prefilling a
request *through* the decode step, one token a step, into its slot.  As in
the reference, the engine takes neither a cross length nor a vision
prefix: an encoder-decoder serves through the two step functions, and a
VLM through the engine as text (the same id on all three M-RoPE axes).

Everything runs on ``device`` (default ``"cuda"``); the cache (K/V, and
the conv windows and SSM states of a hybrid stack) is updated in place.  The step functions run without autograd: their logits
carry no graph.

Given a ``mesh``, the step functions serve data-parallel over the batch
and tensor-parallel over "model": the parameters are DTensors placed by
`parallel.sharding.param_specs`, each rank runs its rows of the batch
(`parallel.sharding.local_batch`), and the model gathers each period's
parameters over the data axes where it uses them
(`parallel.context.gather_params`), as the sharded train step does.  The
ranks along "model" hold the same rows and split the heads, FFN columns,
experts and vocab of each layer; the logits' vocab slices are gathered
before they are returned.  The cache keeps the port's own layout: a rank's
rows, and of those its own kv heads (`models.attention.local_heads`),
where the reference's cache rule (`parallel.sharding.cache_specs`) cuts
the sequence over "model", and its Mamba2 and xLSTM mixers' channels and
heads, as that rule cuts them.  `ServeEngine` takes the mesh too: every
rank keeps the slots' bookkeeping alike from the whole batch's logits, and
its `export_slot` and `import_slot` move a slot between the ranks' rows,
and between a mesh and one device: the payload is the one-device payload.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import struct
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._tree import tree_map
from repro_torch.models import ModelConfig, forward, init_cache, logits_fn
from repro_torch.models.config import BLOCK_ATTN
from repro_torch.models.transformer import block_cache_spans, encode, reset_slot, stack_layout
from repro_torch.parallel.context import (activation_sharding, batch_part, dp_gather,
                                         gather_params, tp_group, tp_rank, tp_size)
from repro_torch.parallel.sharding import batch_mesh_dims, default_strategy, local_batch


def _on_mesh(step, cfg: ModelConfig, mesh, strategy):
    """``step`` run on ``mesh`` (see the module's docstring): the batch cut
    to this rank's rows, the head gathered once (a tied embedding serves
    the lookup too), under the sharding context."""
    strategy = strategy or default_strategy(mesh)
    head = "embed" if cfg.tie_embeddings else "unembed"

    def sharded(params, *rest):
        *state, batch = rest
        cut = batch_mesh_dims(batch, mesh, strategy)
        batch = local_batch(batch, mesh, strategy)
        with activation_sharding(mesh, strategy, batch_dims=cut):
            params = dict(params, **gather_params({head: params[head]}))
            return step(params, *state, batch)

    return sharded


def make_prefill_step(cfg: ModelConfig, max_len: int, cross_len: int = 0,
                      device="cuda", mesh=None, strategy=None):
    """(params, batch) -> (cache, last_token_logits).

    batch: {"tokens": (B,S)} (+ encoder_embeds / vision_embeds / positions).
    The cache is allocated inside (zeros), so the Mamba2 mixers of a hybrid
    stack prefill from a zero state through the chunked scan; an
    encoder-decoder's ``encoder_embeds`` are encoded and their projected K/V
    fill the cache's ``cross`` part, ``cross_len`` long (the encoder's
    length).  With a ``mesh`` (``strategy`` by default
    `default_strategy(mesh)`) the batch is the whole one and the cache the
    rank's rows of it.
    """

    @torch.no_grad()
    def prefill(params, batch):
        tokens = batch["tokens"]
        encoder_out = None
        if cfg.n_encoder_layers:
            encoder_out = encode(params, batch["encoder_embeds"], cfg)
        cache = init_cache(cfg, tokens.shape[0], max_len, cross_len=cross_len, device=device)
        hidden, cache, _ = forward(params, tokens, cfg, positions=batch.get("positions"),
                                   cache=cache, encoder_out=encoder_out,
                                   vision_embeds=batch.get("vision_embeds"))
        return cache, logits_fn(params, hidden[:, -1:], cfg)

    if mesh is None:
        return prefill
    return _on_mesh(prefill, cfg, mesh, strategy)


def make_decode_step(cfg: ModelConfig, mesh=None, strategy=None):
    """(params, cache, tokens (B,1)) -> (cache, logits (B,1,V)).  With a
    ``mesh`` the tokens are the whole batch's, and the cache and the logits
    the rank's rows of it."""

    @torch.no_grad()
    def decode(params, cache, tokens):
        hidden, cache, _ = forward(params, tokens, cfg, cache=cache)
        return cache, logits_fn(params, hidden, cfg)

    if mesh is None:
        return decode
    step = _on_mesh(lambda params, cache, batch: decode(params, cache, batch["tokens"]),
                    cfg, mesh, strategy)
    return lambda params, cache, tokens: step(params, cache, {"tokens": tokens})


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           temperature: float = 0.0) -> torch.Tensor:
    """Greedy for ``temperature <= 0``; else one categorical draw per row of
    ``logits / temperature`` by the Gumbel-max trick, the noise drawn on the
    CPU from ``generator`` so that a seed gives one stream on any device."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() / temperature + gumbel.to(logits.device), dim=-1)


# ------------------------------------------------------------------ engine
@dataclasses.dataclass
class Request:
    req_id: int
    prompt: List[int]
    max_new_tokens: int = 32
    done: bool = False
    output: List[int] = dataclasses.field(default_factory=list)


class ServeEngine:
    """Slot-based continuous batching over a fixed decode batch.

    Finished sequences free their slot; queued requests are prefilled into
    freed slots through the decode step.  Placing *engines* on nodes is the
    fleet scheduler's work; `export_slot` / `import_slot` are what it moves
    a live request with.

    With a ``mesh`` (``params`` placed by `param_specs`; ``strategy`` by
    default `default_strategy(mesh)`), each rank holds the cache of its
    rows of the slots (of its kv heads), the decode step is the mesh form,
    and every rank samples every slot from the whole batch's logits, so
    that the ranks' bookkeeping is the same.  Every rank of the mesh must
    call the same methods in the same order: a step and `export_slot` are
    collective."""

    def __init__(self, cfg: ModelConfig, params, batch_slots: int, max_len: int,
                 eos_id: int = 0, temperature: float = 0.0, rng_seed: int = 0,
                 device="cuda", mesh=None, strategy=None):
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.temperature = temperature
        self.rng_seed = rng_seed
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.mesh = mesh
        self.strategy = strategy = None if mesh is None else strategy or default_strategy(mesh)
        with self._sharding():
            # The slots this rank holds: [first, first + rows).
            parts, part = batch_part()
            rows = batch_slots // parts
            self.first = part * rows
            self.cache = init_cache(cfg, rows, max_len, per_slot_index=True, device=self.device)
        # Per-slot write offsets (slot-local KV positions).
        self.offsets = np.zeros(batch_slots, np.int32)
        self._decode = make_decode_step(cfg, mesh=mesh, strategy=strategy)
        self.steps = 0

    def _sharding(self):
        """The sharding context of the engine's mesh, its batch dims those
        that cut the slots; a null context without a mesh."""
        if self.mesh is None:
            return contextlib.nullcontext()
        cut = batch_mesh_dims({"tokens": torch.zeros((len(self.slots), 1))}, self.mesh,
                              self.strategy)
        return activation_sharding(self.mesh, self.strategy, batch_dims=cut)

    def _row(self, slot: int) -> Optional[int]:
        """``slot``'s row in this rank's cache, or None where another rank
        holds it."""
        row = slot - self.first
        return row if 0 <= row < self.cache["index"].shape[0] else None

    def _all_rows(self, tree):
        """Every leaf (of this rank's rows, batch first) stacked with the
        other parts' in the slots' order; ``tree`` itself without a mesh."""
        if self.mesh is None:
            return tree
        with self._sharding():
            return tree_map(lambda t: dp_gather(t)[0].flatten(0, 1), tree)

    def _request_generator(self, req: Request) -> torch.Generator:
        """Generator for ``req``'s next token: seeded from (rng_seed, req_id,
        tokens generated so far) and nothing else -- never from batch
        position or step count -- so a sampled decode replays identically
        whatever other requests share the batch, and a request resumed on
        another engine (same ``rng_seed``) continues the same stream."""
        key = struct.pack("<qqq", self.rng_seed, req.req_id, len(req.output))
        seed = int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(), "little")
        return torch.Generator("cpu").manual_seed(seed & (2 ** 63 - 1))

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    # Slot-level prefill: run the prompt through decode one token at a time
    # into this slot's cache region.  Simple and exactly consistent with
    # decode (per-slot caches share the batched buffers).
    def _admit(self, slot: int, req: Request) -> None:
        self.slots[slot] = req
        self.offsets[slot] = 0
        # Reset the slot's write offset and wipe its K/V (stale K/V would be
        # masked by kv_len anyway; zeroing keeps slot states comparable).
        if self._row(slot) is not None:
            self.cache = reset_slot(self.cache, self._row(slot))
        req.output = []

    def _slot_tokens(self) -> np.ndarray:
        toks = np.zeros((len(self.slots), 1), np.int32)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            pos = int(self.offsets[i])
            if pos < len(req.prompt):
                toks[i, 0] = req.prompt[pos]
            else:
                toks[i, 0] = req.output[-1] if req.output else self.eos_id
        return toks

    @torch.no_grad()
    def step(self) -> None:
        # Fill free slots.
        for i, s in enumerate(self.slots):
            if s is None and self.queue:
                self._admit(i, self.queue.pop(0))
        if all(s is None for s in self.slots):
            return
        tokens = torch.from_numpy(self._slot_tokens()).to(self.device)
        self.cache, logits = self._decode(self.params, self.cache, tokens)
        logits = self._all_rows(logits)
        self.steps += 1
        if self.temperature <= 0.0:
            next_tok = sample(logits[:, 0], None, 0.0).cpu().numpy()
        else:
            next_tok = np.zeros(len(self.slots), np.int64)
            for i, req in enumerate(self.slots):
                if req is not None:
                    next_tok[i] = int(sample(logits[i, 0], self._request_generator(req),
                                             self.temperature))
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.offsets[i] += 1
            pos = int(self.offsets[i])
            if pos >= len(req.prompt):  # generating
                req.output.append(int(next_tok[i]))
                if (len(req.output) >= req.max_new_tokens
                        or int(next_tok[i]) == self.eos_id
                        or pos >= self.max_len - 1):
                    req.done = True
                    self.finished.append(req)
                    self.slots[i] = None

    def run_until_done(self, max_steps: int = 10_000) -> List[Request]:
        while (self.queue or any(self.slots)) and self.steps < max_steps:
            self.step()
        return self.finished

    # ---------------------------------------------------- slot migration --
    # One slot's cache region is a self-contained request state: these two
    # helpers are the engine-level half of the fleet's kv-ship migration
    # strategy -- export on the source engine, import into any free slot of
    # a destination engine built from the same config/params/rng_seed, and
    # decoding continues bit-identically.  In an MoE stack a decode step's
    # slots share the experts' capacity, so there the continuation is
    # bit-identical only beside the same neighbours in the same slots.  On a
    # mesh the payload is made whole: the ranks' kv heads and mixer
    # channels and heads of the slot are gathered over "model" on export and
    # each rank takes its own on import, so a slot moves between meshes of
    # any shape and one device.
    def export_slot(self, slot: int) -> Dict:
        """Deep-copy one slot's KV / recurrent state + write offset (and
        the shared block's per-depth caches of a hybrid stack).  The tensors
        are clones: the engine's cache is written in place, and the payload
        must not change when the engine steps on.  On a mesh every rank
        takes the slot from the rank whose rows hold it, whole."""
        c = self.cache
        rows = c["index"].shape[0]
        row = slot % rows              # on a mesh, every rank's row at the slot's place
        take = lambda t: t.clone()
        if self.mesh is not None:
            def take(t):
                with self._sharding():
                    return dp_gather(t)[0][slot // rows].clone()    # the holder's
        state = {
            "index": take(c["index"][row]),
            "blocks": tree_map(lambda x: take(x[:, row]), c["blocks"]),
            "tail": tree_map(lambda x: take(x[row]), c["tail"]),
            "offset": int(self.offsets[slot]),
        }
        if "shared" in c:
            state["shared"] = tree_map(lambda x: take(x[:, row]), c["shared"])
        if "tail_shared" in c:
            state["tail_shared"] = tree_map(lambda x: take(x[row]), c["tail_shared"])
        return self._over_model(state, whole=True)

    def import_slot(self, slot: int, state: Dict) -> None:
        """Install an `export_slot` payload into ``slot`` (overwrites it);
        on a mesh, the ranks whose rows hold the slot do, each its part."""
        c, row = self.cache, self._row(slot)
        if row is not None:
            state = self._over_model(state, whole=False)
            c["index"][row] = state["index"].to(self.device)
            tree_map(lambda x, v: x[:, row].copy_(v), c["blocks"], state["blocks"])
            tree_map(lambda x, v: x[row].copy_(v), c["tail"], state["tail"])
            if "shared" in c:
                tree_map(lambda x, v: x[:, row].copy_(v), c["shared"], state["shared"])
            if "tail_shared" in c:
                tree_map(lambda x, v: x[row].copy_(v), c["tail_shared"], state["tail_shared"])
        self.offsets[slot] = state["offset"]

    def _over_model(self, state: Dict, whole: bool) -> Dict:
        """A slot's payload with each leaf that the "model" axis cuts
        (`models.transformer.block_cache_spans`) gathered whole from the
        ranks' parts (``whole``; collective over the axis), or cut to this
        rank's part of the whole.  As it is off a mesh, or on one rank."""
        if self.mesh is None:
            return state
        with self._sharding():
            n, r, group = tp_size(), tp_rank(), tp_group()
        if n == 1:
            return state

        def block(cache, kind):
            specs = [block_cache_spans(self.cfg, kind, q, n) for q in range(n)]

            def walk(t, path):
                if isinstance(t, dict):
                    return {k: walk(v, path + (k,)) for k, v in t.items()}
                mine = _spec(specs[r], path)
                if mine is None:
                    return t
                dim, size, spans = mine
                dim %= t.ndim
                if not whole:
                    return torch.cat([t.narrow(dim, lo, hi - lo) for lo, hi in spans], dim)
                parts = [torch.empty_like(t) for _ in range(n)]
                dist.all_gather(parts, t.contiguous(), group=group)
                out = t.new_zeros(t.shape[:dim] + (size,) + t.shape[dim + 1:])
                for spec, part in zip(specs, parts):
                    at = 0
                    for lo, hi in _spec(spec, path)[2]:
                        out.narrow(dim, lo, hi - lo).copy_(part.narrow(dim, at, hi - lo))
                        at += hi - lo
                return out

            return walk(cache, ()) if specs[r] else cache

        layout = stack_layout(self.cfg)
        out = dict(state)
        out["blocks"] = {f"pos{j}": block(state["blocks"][f"pos{j}"], kind)
                         for j, kind in enumerate(layout.period_kinds)}
        out["tail"] = [block(t, kind) for t, kind in zip(state["tail"], layout.tail)]
        if "shared" in state:
            out["shared"] = block(state["shared"], BLOCK_ATTN)
        if "tail_shared" in state:
            out["tail_shared"] = [block(t, BLOCK_ATTN) for t in state["tail_shared"]]
        return out


def _spec(tree, path):
    """The entry of ``tree`` at ``path``, or None."""
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree
