"""End-to-end driver (the paper's workload): batched LLM serving with
host-memory context caching, comparing KV-fetch backends (pcpy / b2b /
opt_b2b / kernel, the last through B1 on the card) on TTFT and throughput:
§5.3 at reduced scale, real execution.  Counterpart of
``examples/serve_kv_cache.py``; on the card unless ``--device cpu``.  The
fetch latencies are the MI300X simulator's (modeled), not measurements.

    PYTHONPATH=src python -m repro_torch.examples.serve_kv_cache [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve.engine import ServeEngine

BACKENDS = ("pcpy", "b2b", "opt_b2b", "kernel")
B, CTX, NEW = 4, 192, 24        # the reference's batch, context and new tokens


def run(device="cuda") -> dict:
    """The miss, then a hit through each backend; returns {"miss" or
    backend: GenerationResult}."""
    dev = resolve_device(device)
    cfg = get_config("qwen2-0.5b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    eng = ServeEngine(model, params, device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (B, CTX)).astype(np.int32)
    keys = [f"doc-{i}" for i in range(B)]

    print(f"model={cfg.name} batch={B} ctx={CTX} new={NEW} on {dev}")
    miss = eng.generate(prompts, keys, NEW)                 # prefill + save
    print(f"miss : ttft={miss.request_stats[0].ttft_wall_s*1e3:7.2f}ms (prefill) "
          f"tok/s={miss.tokens_per_s_wall:7.1f}")
    results = {"miss": miss}
    for backend in BACKENDS:
        res = eng.generate(prompts, keys, NEW, fetch_backend=backend)
        st = res.request_stats[0]
        if not (res.tokens == miss.tokens).all():
            raise AssertionError(f"{backend}: hit tokens differ from the miss path's")
        results[backend] = res
        print(f"hit/{backend:7s}: fetch_modeled(MI300X model)={st.fetch_modeled_s*1e6:8.1f}us "
              f"transfers={st.n_transfers:3d} tok/s={res.tokens_per_s_wall:7.1f} "
              f"(tokens identical)")
    modeled = {b: results[b].request_stats[0].fetch_modeled_s for b in BACKENDS}
    print(f"\nb2b fetch speedup over pcpy (modeled, MI300X): "
          f"{modeled['pcpy']/modeled['b2b']:.2f}x")
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
