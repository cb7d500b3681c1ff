"""Training driver, on the card unless ``--device cpu``.

Trains the REDUCED variant of an arch (random weights from ``--seed``, the
synthetic data pipeline), as the JAX driver does, and checks that the loss
falls.  The audio family gets the reference's stub of encoder features (the
same normal [batch, encoder_seq, d_model] draw from ``--seed`` in every
batch); the vlm family exits, as the reference's launcher does (its frontend
is a stub).  ``--checkpoint`` writes the train state in the reference's layout,
which ``repro.train.checkpoint.restore_checkpoint`` reads too.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --steps 100
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.bridge import train_state_to_numpy
from repro_torch.compat import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import DataConfig, data_iterator
from repro_torch.models import build_model
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.loop import train_loop
from repro_torch.train.optimizer import AdamWConfig


def with_encoder_feats(cfg, it, batch: int, seed: int, device="cuda"):
    """The reference's stub of encoder features for the audio family: the
    same normal [batch, encoder_seq, d_model] draw from ``seed`` (a
    generator on ``device``: the card unless the caller names the CPU)
    added to every batch of ``it``; the other families' batches pass
    through."""
    if cfg.family != "audio":
        return it
    device = resolve_device(device)
    feats = torch.randn((batch, cfg.encdec.encoder_seq, cfg.d_model), device=device,
                        generator=torch.Generator(device=device).manual_seed(seed))
    return (dict(b, encoder_feats=feats) for b in it)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=list(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    if cfg.family == "vlm":
        raise SystemExit("use the dry-run for VLM training shapes (stub frontend)")
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch, seed=args.seed)
    it = with_encoder_feats(cfg, data_iterator(dc), args.batch, args.seed, device=device)
    opt = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                      total_steps=args.steps)

    def log(i, m):
        print(f"step {m['step']:5d} loss {m['loss']:.4f} gnorm {m['grad_norm']:.3f} "
              f"lr {m['lr']:.2e} wall {m['wall_s']:.1f}s")

    state, history = train_loop(model, it, steps=args.steps, opt_cfg=opt,
                                gen=torch.Generator(device=device).manual_seed(args.seed),
                                callback=log, device=device)
    if not history[-1]["loss"] < history[0]["loss"]:
        raise AssertionError("training failed to reduce loss")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, train_state_to_numpy(cfg, state), step=args.steps)
        print(f"saved checkpoint to {args.checkpoint}")
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(history, f, indent=1)


if __name__ == "__main__":
    main()
