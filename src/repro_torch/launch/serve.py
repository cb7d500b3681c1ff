"""Serving entry point: batched requests with host-memory context caching,
comparing KV-fetch backends (the paper's §5.3 workload), on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --batch 4 --ctx 128

Runs the miss path (prefill + save), then a hit through each fetch backend,
and asserts that every backend gives the miss path's tokens, as the JAX
entry point does, on the reduced config with random weights from ``--seed``.
Beside each hit's measured TTFT it prints ``fetch_modeled``: the modeled
fetch latency on the reference's MI300X platform (DMA engine model), not a
measurement.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.host_store import BACKENDS


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=list(ARCH_IDS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ctx", type=int, default=128)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    try:
        model = build_model(cfg)
        params = model.init(torch.Generator(device=device).manual_seed(args.seed))
        eng = ServeEngine(model, params, device=device)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(f"{args.arch} is not servable by this port yet ({e}); use a "
                         "dense or moe arch, e.g. qwen2-0.5b, deepseek-7b, olmoe-1b-7b")
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.ctx)).astype(np.int32)
    keys = [f"req-{i}" for i in range(args.batch)]

    print(f"== {cfg.name} on {device}: {args.batch} requests x {args.ctx} ctx, "
          f"{args.new} new tokens ==")
    res_miss = eng.generate(prompts, keys, args.new)
    print(f"[miss/prefill] ttft_wall={res_miss.request_stats[0].ttft_wall_s * 1e3:.3f}ms "
          f"tok/s={res_miss.tokens_per_s_wall:.1f}")
    for backend in BACKENDS:
        res = eng.generate(prompts, keys, args.new, fetch_backend=backend)
        st = res.request_stats[0]
        same = (res.tokens == res_miss.tokens).all()
        print(f"[hit/{backend:7s}] ttft_wall={st.ttft_wall_s * 1e3:.3f}ms "
              f"fetch_modeled(MI300X model)={st.fetch_modeled_s * 1e6:.1f}us "
              f"transfers={st.n_transfers} tok/s={res.tokens_per_s_wall:.1f} "
              f"tokens_match={same}")
        assert same, f"{backend} produced different tokens"


if __name__ == "__main__":
    main()
