"""Train a small LM end to end: a few hundred steps on the synthetic
pipeline, the loss must drop by more than 0.5, and the checkpoint (the
reference's .npz layout) round-trips bit for bit.  Counterpart of
``examples/train_lm.py``; on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch.bridge import train_state_to_numpy
from repro_torch.compat import resolve_device
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, data_iterator
from repro_torch.models import build_model
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.loop import train_loop
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.tree import tree_leaves


def run(steps: int = 300, arch: str = "qwen2-0.5b", device="cuda", log=print):
    """Train the reduced ``arch`` for ``steps`` steps and round-trip its
    checkpoint; returns (history, whether the restored leaves equal the
    saved ones bit for bit)."""
    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    dc = DataConfig(vocab=cfg.vocab, seq_len=128, batch=8, seed=0)
    opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=steps)

    def on_log(i, m):
        log(f"step {m['step']:4d} loss {m['loss']:.4f} lr {m['lr']:.2e}")

    state, hist = train_loop(model, data_iterator(dc), steps=steps, opt_cfg=opt,
                             callback=on_log, log_every=25, device=dev)
    saved = train_state_to_numpy(cfg, state)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.npz")
        save_checkpoint(path, saved, step=steps)
        restored = restore_checkpoint(path, saved)
    same = all(np.array_equal(a, b) for a, b in zip(tree_leaves(saved), tree_leaves(restored)))
    return hist, same


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    hist, same = run(args.steps, args.arch, args.device)
    if not hist[-1]["loss"] < hist[0]["loss"] - 0.5:
        raise AssertionError("insufficient learning")
    print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    if not same:
        raise AssertionError("checkpoint round trip differs")
    print("checkpoint round-trip OK")
    return hist


if __name__ == "__main__":
    main()
