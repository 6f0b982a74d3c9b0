"""Deterministic, shardable data pipeline (the port's own copy of
`repro.data.pipeline`, which needs only numpy; batches are bit-equal to the
reference's).

For a multi-host fleet each process loads only its batch shard
(``process_index``-strided), with background prefetch.  Sources: a seeded
synthetic LM stream (benchmarks / dry-runs / tests — fully deterministic and
restart-consistent via the step-indexed PRNG) and a byte-tokenized text file
source for the example drivers.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    n_hosts: int = 1
    host_index: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        return self.global_batch // self.n_hosts


class SyntheticLM:
    """Step-indexed synthetic stream: batch(step) is a pure function of
    (seed, step, host), so a restarted trainer resumes on identical data —
    the property the checkpoint/restart tests rely on."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_index]))
        toks = rng.integers(
            0, cfg.vocab_size, size=(cfg.host_batch, cfg.seq_len + 1), dtype=np.int64)
        # Plant n-gram structure so loss can actually fall in examples.
        toks[:, 2::3] = (toks[:, 1::3][:, : toks[:, 2::3].shape[1]]
                         * 31 + 7) % cfg.vocab_size
        return {"inputs": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class ByteTokenizer:
    """Trivial byte-level tokenizer (vocab 256 + bos/eos)."""

    vocab_size = 258
    bos = 256
    eos = 257

    def encode(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(np.int32)

    def decode(self, ids) -> str:
        b = bytes(int(i) for i in ids if int(i) < 256)
        return b.decode("utf-8", errors="replace")


class TextFileLM:
    """Chunk a byte-tokenized file into (inputs, targets) windows."""

    def __init__(self, path: str, cfg: DataConfig):
        self.cfg = cfg
        self.tok = ByteTokenizer()
        with open(path, "rb") as f:
            data = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)
        self.data = data

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_index]))
        starts = rng.integers(0, len(self.data) - cfg.seq_len - 1, size=cfg.host_batch)
        rows = np.stack([self.data[s:s + cfg.seq_len + 1] for s in starts])
        return {"inputs": rows[:, :-1], "targets": rows[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch with bounded buffer."""

    def __init__(self, source, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._src = iter(source)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._src:
                if self._stop.is_set():
                    return
                self._q.put(item)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
