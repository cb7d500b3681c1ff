"""Deterministic synthetic LM data pipeline.  Counterpart of
``repro.data.pipeline``: the same numpy generator and draws, so a batch is
bit-equal to the reference's for every (seed, shard, n_shards, step).

Generates structured token streams (a mixture of Zipf-distributed unigrams
and copy/induction patterns so a model can actually reduce loss), packs them
into fixed-length sequences, and shards by host.  Deterministic per
(seed, shard, step): resumable without state files.  Batches are int32
tensors on the CPU; the training loop moves them to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    shard: int = 0
    n_shards: int = 1
    induction_prob: float = 0.3   # fraction of sequence that is a repeated motif


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, cfg.shard, cfg.n_shards, step]))


def synth_batch(cfg: DataConfig, step: int) -> dict:
    """One packed batch: {'tokens': [B, S] int32 tensor on the CPU}."""
    rng = _batch_rng(cfg, step)
    B, S, V = cfg.batch, cfg.seq_len, cfg.vocab
    # Zipf-ish unigram distribution over a capped working vocab.
    work_v = min(V, 4096)
    ranks = np.arange(1, work_v + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(work_v, size=(B, S), p=probs).astype(np.int32)
    # Induction motifs: copy a random early span later in the sequence.
    motif_len = max(4, S // 16)
    for b in range(B):
        if rng.random() < cfg.induction_prob and S >= 4 * motif_len:
            src = rng.integers(0, S // 2 - motif_len)
            dst = rng.integers(S // 2, S - motif_len)
            toks[b, dst:dst + motif_len] = toks[b, src:src + motif_len]
    return {"tokens": torch.from_numpy(toks)}


def data_iterator(cfg: DataConfig, start_step: int = 0):
    step = start_step
    while True:
        yield synth_batch(cfg, step)
        step += 1
