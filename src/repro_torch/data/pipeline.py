"""Deterministic synthetic LM data pipeline (host-side numpy).

Port of the reference's ``data/pipeline.py``.  A seeded Markov token
stream: ``next = (a * cur + c + noise) mod V`` with a small noise
vocabulary, so the distribution has low conditional entropy and a model
trained on it shows a clearly decreasing loss.  Batches are keyed by
(seed, step) and drawn with numpy exactly as the reference draws them, so
both packages see the same batches, and restarts replay the same stream
(a checkpoint stores only the step counter).  ``device_batch`` puts a
batch on the card unless asked for another device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclass
class DataConfig:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 1234
    noise_vocab: int = 17      # conditional branching factor
    mult: int = 31             # affine transition parameters
    add: int = 7


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        start = rng.integers(0, c.vocab_size, size=(c.batch, 1))
        noise = rng.integers(0, c.noise_vocab, size=(c.batch, c.seq_len))
        toks = np.zeros((c.batch, c.seq_len + 1), np.int64)
        toks[:, :1] = start
        for t in range(c.seq_len):
            toks[:, t + 1] = (toks[:, t] * c.mult + c.add + noise[:, t]) \
                % c.vocab_size
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1

    def device_batch(self, step: int, device: DeviceLike = None
                     ) -> Dict[str, torch.Tensor]:
        """``batch_at(step)`` as int32 tensors on ``device`` (default: the
        card)."""
        dev = resolve_device(device)
        return {k: torch.from_numpy(v).to(dev)
                for k, v in self.batch_at(step).items()}


def stub_frontend_batch(cfg, B: int, S: int, step: int, d_model: int,
                        *, kind: str) -> Dict[str, np.ndarray]:
    """Precomputed embeddings for stub-frontend archs (vlm/audio)."""
    rng = np.random.default_rng((hash(kind) & 0xFFFF, step))
    out = {"embeds": rng.normal(size=(B, S, d_model)).astype(np.float32) * 0.02}
    if kind == "vlm":
        t = np.arange(S)[None, :].repeat(B, 0)
        out["positions3"] = np.stack([t, t, t], -1).astype(np.int32)
    return out
