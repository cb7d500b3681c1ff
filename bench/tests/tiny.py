"""Tiny versions of the benchmark's configurations and mixes for CPU tests:
the same families and keys, small widths."""
from __future__ import annotations

from bench.harness import registry


def config(name: str) -> dict:
    cfg = registry.load_config(registry.config_file(name))
    cfg.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4, head_dim=16,
               vocab_size=256, max_position_embeddings=128)
    if cfg["family"] == "moe":
        cfg.update(num_key_value_heads=4, intermediate_size=32, num_experts=8,
                   num_experts_per_tok=2)
    else:
        cfg.update(num_key_value_heads=2, intermediate_size=96,
                   rope_scaling={"type": "mrope", "mrope_section": [4, 2, 2]})
    return cfg


def traffic(kind: str) -> dict:
    spec = {"kind": kind, "batch": 4, "prompt_tokens": 40, "new_tokens": 5, "check_requests": 4}
    if kind == "revisit":
        spec.update(pool=6, fill_per_prefill=4)
    return spec


def cell(config_name: str, kind: str) -> registry.Cell:
    spec = registry.load_spec()
    wl = f"tiny.{config_name}.{kind}"
    e2e = tuple(m for m in spec["end_to_end"]
                if "workloads" not in m or any(kind in w for w in m["workloads"]))
    names = {m["name"] for m in e2e}
    layer = tuple(m for m in spec["per_layer"] if m["moves"] in names
                  and any(kind in w for w in m.get("workloads", [kind])))
    return registry.Cell(wl, config(config_name), traffic(kind), 1, e2e, layer)
