"""Training data pipeline: the port's own copy of ``repro/data/pipeline.py``
(numpy only), so that for every (seed, step) it gives the reference's batches
bit for bit.

Sources:
* :class:`SyntheticLM` — deterministic Zipf-ish token stream (seeded; every
  restart resumes exactly, keyed by global step — required for the
  checkpoint/restart fault-tolerance path to be bitwise reproducible).
* :class:`FileTokenSource` — memory-mapped ``.bin`` of uint16/uint32 tokens
  with epoch shuffling by block permutation.

:class:`Prefetcher` runs the source on a background thread with a bounded
queue — host-side batch assembly overlaps device compute (the data-pipeline
instance of the paper's dataflow-invocation overlap).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Mapping

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "FileTokenSource", "Prefetcher",
           "make_pipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"       # "synthetic" | path to .bin
    prefetch: int = 2


class SyntheticLM:
    """Deterministic pseudo-natural token stream.

    Tokens follow a Zipf-like marginal with a short-range Markov blend so
    the loss actually decreases during the example runs; ``batch_at(step)``
    is a pure function of (seed, step) — restart-safe."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = 1.0 / ranks ** 1.1
        self._probs = probs / probs.sum()
        self._mix = base.integers(0, cfg.vocab, size=4096)

    def batch_at(self, step: int) -> Mapping[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ step)
        iid = rng.choice(cfg.vocab, size=(cfg.global_batch, cfg.seq_len + 1),
                         p=self._probs)
        # short-range structure: every other token repeats a mixed copy of
        # its predecessor (gives the model something learnable).
        mixed = self._mix[iid[:, :-1] % self._mix.size]
        toks = iid.copy()
        toks[:, 1::2] = np.where((iid[:, 1::2] % 3) == 0,
                                 mixed[:, ::2][:, :toks[:, 1::2].shape[1]],
                                 iid[:, 1::2])
        return {"tokens": toks.astype(np.int32)}

    def __iter__(self) -> Iterator[Mapping[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class FileTokenSource:
    """Memory-mapped flat token file -> fixed-length sequences."""

    def __init__(self, cfg: DataConfig, path: str, dtype=np.uint16):
        self.cfg = cfg
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        n_seq = (len(self.tokens) - 1) // cfg.seq_len
        if n_seq < 1:
            raise ValueError("token file shorter than one sequence")
        self.n_seq = n_seq

    def batch_at(self, step: int) -> Mapping[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ (step // self.n_seq))
        perm = rng.permutation(self.n_seq)
        out = np.empty((cfg.global_batch, cfg.seq_len + 1), np.int32)
        for i in range(cfg.global_batch):
            j = perm[(step * cfg.global_batch + i) % self.n_seq]
            start = j * cfg.seq_len
            out[i] = self.tokens[start:start + cfg.seq_len + 1]
        return {"tokens": out}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch with a bounded queue (host overlap)."""

    _STOP = object()

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> tuple[int, Mapping[str, np.ndarray]]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)


def make_pipeline(cfg: DataConfig, start_step: int = 0) -> Prefetcher:
    if cfg.source == "synthetic":
        src = SyntheticLM(cfg)
    else:
        src = FileTokenSource(cfg, cfg.source)
    return Prefetcher(src, start_step=start_step, depth=cfg.prefetch)
