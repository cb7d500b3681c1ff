"""A configuration file as the port runs it, and its weights made from the seed.

``arch_config`` turns a ``bench/configs/*.json`` file into the port's
``ArchConfig`` and refuses what the port cannot run as the file states.
``make_weights`` makes the weights on the device from the seed, in the
port's layout and in the types the port serves them in (bf16 matmul weights,
float32 norm scales and router), with one ``randn`` call per dtype: the leaves
are views of one flat buffer, laid out so that each leaf kind is scaled by one
in-place call.  The reference (``bench/reference``) reads the same tensors.
"""
from __future__ import annotations

import math

import torch

# what the port's layers fix in code, which a configuration file has to state
PORT_RMS_EPS = 1e-6


def arch_config(cfg: dict):
    """The port's ``ArchConfig`` for the configuration file ``cfg``."""
    from repro_torch.configs.base import ArchConfig, MoEConfig
    if cfg["rms_norm_eps"] != PORT_RMS_EPS:
        raise ValueError(f"{cfg['name']}: the port's RMSNorm uses eps {PORT_RMS_EPS}")
    if cfg.get("qk_layernorm") or cfg.get("hidden_act") != "silu" or cfg["torch_dtype"] != "bfloat16":
        raise ValueError(f"{cfg['name']}: the port serves silu, bf16 and no q/k norm")
    moe = None
    if cfg["family"] == "moe":
        if not cfg["norm_topk_prob"]:
            raise ValueError(f"{cfg['name']}: the port renormalises the top-k weights")
        moe = MoEConfig(n_experts=cfg["num_experts"], top_k=cfg["num_experts_per_tok"],
                        d_ff_expert=cfg["intermediate_size"],
                        capacity_factor=cfg["capacity_factor"])
    rope = cfg.get("rope_scaling") or {}
    mrope = rope.get("type") == "mrope"
    return ArchConfig(
        name=cfg["name"], family=cfg["family"], source=cfg["source"],
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["head_dim"], d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        qkv_bias=bool(cfg["attention_bias"]), norm="rmsnorm", act="silu",
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        rope_kind="mrope" if mrope else "rope", rope_theta=float(cfg["rope_theta"]),
        mrope_sections=tuple(rope["mrope_section"]) if mrope else (),
        moe=moe, stub_frontend=cfg["family"] == "vlm", compute_dtype="bfloat16")


def leaves(cfg: dict) -> list[tuple[tuple, tuple, torch.dtype, str, float]]:
    """(path in the params tree, shape, dtype, kind, scale) of every leaf.
    kind "normal" is N(0, scale^2); "norm" is 1 + N(0, scale^2)."""
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    H, KV, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    F = cfg["intermediate_size"]
    bf, f32 = torch.bfloat16, torch.float32
    out = [(("embed",), (V, D), bf, "normal", 0.02)]
    for i in range(cfg["num_hidden_layers"]):
        b = ("blocks", i)
        out += [(b + ("ln1", "scale"), (D,), f32, "norm", 0.1),
                (b + ("ln2", "scale"), (D,), f32, "norm", 0.1),
                (b + ("attn", "wq"), (D, H * hd), bf, "normal", 1 / math.sqrt(D)),
                (b + ("attn", "wk"), (D, KV * hd), bf, "normal", 1 / math.sqrt(D)),
                (b + ("attn", "wv"), (D, KV * hd), bf, "normal", 1 / math.sqrt(D)),
                (b + ("attn", "wo"), (H * hd, D), bf, "normal", 1 / math.sqrt(H * hd))]
        if cfg["attention_bias"]:
            out += [(b + ("attn", n), (w,), bf, "normal", 0.02)
                    for n, w in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd))]
        if cfg["family"] == "moe":
            E = cfg["num_experts"]
            out += [(b + ("moe", "router"), (D, E), f32, "normal", 1 / math.sqrt(D)),
                    (b + ("moe", "wg"), (E, D, F), bf, "normal", 1 / math.sqrt(D)),
                    (b + ("moe", "wu"), (E, D, F), bf, "normal", 1 / math.sqrt(D)),
                    (b + ("moe", "wd"), (E, F, D), bf, "normal", 1 / math.sqrt(F))]
        else:
            out += [(b + ("mlp", "wg"), (D, F), bf, "normal", 1 / math.sqrt(D)),
                    (b + ("mlp", "wu"), (D, F), bf, "normal", 1 / math.sqrt(D)),
                    (b + ("mlp", "wd"), (F, D), bf, "normal", 1 / math.sqrt(F))]
    out += [(("final_norm", "scale"), (D,), f32, "norm", 0.1)]
    if not cfg["tie_word_embeddings"]:
        out += [(("unembed",), (D, V), bf, "normal", 0.02)]
    return out


def n_params(cfg: dict) -> int:
    return sum(math.prod(shape) for _, shape, *_ in leaves(cfg))


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The params tree of ``cfg`` on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    groups: dict[tuple, list] = {}
    for leaf in leaves(cfg):
        groups.setdefault((leaf[2], leaf[3], leaf[4]), []).append(leaf)
    params: dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        mine = [(k, g) for k, g in groups.items() if k[0] == dtype]
        total = sum(math.prod(leaf[1]) for _, g in mine for leaf in g)
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        off = 0
        for (_, kind, scale), group in mine:
            n = sum(math.prod(leaf[1]) for leaf in group)
            seg = flat[off:off + n]
            seg.mul_(scale)
            if kind == "norm":
                seg.add_(1.0)
            for path, shape, *_ in group:
                size = math.prod(shape)
                _put(params, path, flat[off:off + size].view(shape))
                off += size
    return params
