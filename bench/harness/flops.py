"""The yardstick: what the served work needs, in operations and bytes, and the
card's peaks.  Counts are of what the inputs need, not of what the program
computes: a prefill needs the head at its last position only, an MoE token
its top-k experts only, causal attention the pairs at or below the diagonal.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense bf16 on the tensor cores, at 700 W
PEAK_BF16_FLOPS = 989e12
# PCIe Gen5 x16, one direction (32 GT/s x 16 lanes, 128b/130b): the link
# between host memory and the card, which every host-to-device copy crosses
PCIE_GEN5_X16_BYTES_S = 64e9
BF16_BYTES = 2
BLOCK_TOKENS = 16          # the port's paged KV block (serve/kvcache.py)


def _attn_width(cfg: dict) -> int:
    return cfg["num_attention_heads"] * cfg["head_dim"]


def layer_params(cfg: dict) -> int:
    """Matmul parameters one token goes through in one layer (active experts only)."""
    D, hd = cfg["hidden_size"], cfg["head_dim"]
    H, KV, F = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["intermediate_size"]
    attn = D * H * hd + 2 * D * KV * hd + H * hd * D
    if cfg["family"] == "moe":
        ffn = D * cfg["num_experts"] + cfg["num_experts_per_tok"] * 3 * D * F
    else:
        ffn = 3 * D * F
    return attn + ffn


def head_params(cfg: dict) -> int:
    return cfg["hidden_size"] * cfg["vocab_size"]


def active_params(cfg: dict) -> int:
    """Matmul parameters per generated token: every layer's, and the head."""
    return cfg["num_hidden_layers"] * layer_params(cfg) + head_params(cfg)


def kv_bytes_per_token(cfg: dict) -> int:
    """K and V of one token over all layers, in bf16."""
    return (cfg["num_hidden_layers"] * cfg["num_key_value_heads"] * cfg["head_dim"]
            * 2 * BF16_BYTES)


def stored_kv_bytes(cfg: dict, tokens: int) -> int:
    """Bytes of one context in the host store: whole blocks of 16 tokens."""
    blocks = -(-tokens // BLOCK_TOKENS)
    return blocks * BLOCK_TOKENS * kv_bytes_per_token(cfg)


def prefill_flops(cfg: dict, batch: int, tokens: int) -> float:
    """A prefill of ``batch`` prompts of ``tokens``, up to the first token:
    every layer at every position, causal attention, the head at the last."""
    L = cfg["num_hidden_layers"]
    pairs = tokens * (tokens + 1) // 2
    per_seq = (2 * L * layer_params(cfg) * tokens + 4 * L * _attn_width(cfg) * pairs
               + 2 * head_params(cfg))
    return float(batch * per_seq)


def decode_flops(cfg: dict, batch: int, pos: int) -> float:
    """One decode step of ``batch`` tokens at position ``pos`` (attending
    ``pos + 1`` keys)."""
    L = cfg["num_hidden_layers"]
    return float(batch * (2 * active_params(cfg) + 4 * L * _attn_width(cfg) * (pos + 1)))


def generate_flops(cfg: dict, batch: int, tokens: int, new: int, hit: bool) -> tuple[float, float]:
    """(first-token FLOPs, FLOPs of the other ``new - 1`` steps) of one
    ``generate`` call: a hit's first token is a decode step at ``tokens - 1``
    over the fetched cache, a miss's a prefill."""
    first = (decode_flops(cfg, batch, tokens - 1) if hit
             else prefill_flops(cfg, batch, tokens))
    rest = sum(decode_flops(cfg, batch, tokens + i) for i in range(new - 1))
    return first, rest
