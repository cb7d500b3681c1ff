"""The yardstick's counts against hand-worked values."""
import json

import pytest

from bench.harness import flops, model, registry


def cfg(name):
    return json.loads(registry.config_file(name).read_text())


def test_olmoe_per_token():
    c = cfg("olmoe-1b-7b")
    # 16 x (attention 4 x 2048^2 + router 2048 x 64 + 8 experts x 3 x 2048 x 1024) + head
    want = 16 * (4 * 2048 ** 2 + 2048 * 64 + 8 * 3 * 2048 * 1024) + 2048 * 50304
    assert flops.active_params(c) == want
    assert flops.active_params(c) == pytest.approx(1.18e9, rel=0.005)
    assert flops.kv_bytes_per_token(c) == 131_072           # 16 x 16 x 128 x 2 x 2 B
    assert flops.stored_kv_bytes(c, 4080) == 255 * 16 * 131_072
    assert model.n_params(c) == pytest.approx(6.92e9, rel=0.005)


def test_qwen2_vl_8l():
    c = cfg("qwen2-vl-72b-8l")
    assert flops.kv_bytes_per_token(c) == 32_768            # 8 x 8 x 128 x 2 x 2 B
    assert model.n_params(c) == pytest.approx(9.51e9, rel=0.005)
    # 8 x 2048 prefill: 2 x 7.16e9 x 16,384 matmul FLOPs, plus causal attention
    # 4 x 8192 x 2048 x 2049 / 2 x 8 layers x 8 prompts, plus the head once a prompt
    body = 2 * 8 * (2 * 8192 ** 2 + 2 * 8192 * 1024 + 3 * 8192 * 29568) * 8 * 2048
    attn = 4 * 8192 * (2048 * 2049 // 2) * 8 * 8
    head = 2 * 8192 * 152064 * 8
    assert flops.prefill_flops(c, 8, 2048) == body + attn + head
    assert flops.prefill_flops(c, 8, 2048) == pytest.approx(2.35e14, rel=0.03)


def test_generate_counts_the_hit_as_one_decode_step():
    c = cfg("olmoe-1b-7b")
    first, rest = flops.generate_flops(c, 8, 4080, 16, hit=True)
    assert first == flops.decode_flops(c, 8, 4079)
    assert rest == sum(flops.decode_flops(c, 8, 4080 + i) for i in range(15))
    miss_first, miss_rest = flops.generate_flops(c, 8, 4080, 16, hit=False)
    assert miss_first == flops.prefill_flops(c, 8, 4080) and miss_rest == rest
    # one decode token: 2 x active params + 4 x 16 layers x 2048 x keys
    assert flops.decode_flops(c, 1, 99) == 2 * flops.active_params(c) + 4 * 16 * 2048 * 100
