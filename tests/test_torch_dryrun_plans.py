"""The dry-run's plan does not depend on the torch version (C-port8 in
ROADMAP), on the CPU.

Imports no jax and nothing of the JAX package, so that it runs on the
card's machine too, where the torch differs from this one's:

* Four pairs traced as the dry-run traces them (attention in query
  chunks), on fake CPU tensors: stablelm-12b, mixtral-8x7b and
  qwen2-vl-72b train_4k at 1 layer on 16x16 (8 KV heads on a 'model' of
  16), qwen2-0.5b decode_32k at 2 layers on 16x16.  Per-device FLOPs,
  wire bytes and temp are each within 1% of the figures
  ``tools/dryrun_plans.py --write`` recorded in ``tools/dryrun_plans.json``.
* One op-level case for each op whose plan differed between torch 2.11
  and 2.13 (``tools/dryrun_plans.py --diff``), on a fake (2, 4) mesh,
  asserting the collectives (kind, bytes) and the local FLOPs that
  ``_Reshard`` decides: an embedding lookup of a vocab-split table by
  sharded tokens, a Partial attention output through the reshape and the
  output projection, the MoE combine's product of two Partial sums and
  its gradient, and the gradient norm, which the card's optimizer takes by
  ``_foreach_norm`` and the CPU's by a sum per leaf.
"""
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard  # noqa: E402
from torch.distributed.tensor.experimental import implicit_replication  # noqa: E402

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_mesh  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import dryrun_plans  # noqa: E402

RTOL = 0.01
# the pairs of dryrun_plans.PAIRS cheap enough for tier-1 (~25 s together;
# olmoe-1b-7b on 2x16x16 takes ~45 s and is held in chip_smoke.py)
CHEAP_PAIRS = [p for p in dryrun_plans.PAIRS if p[2] == "16x16"]


@pytest.fixture(scope="module")
def recorded():
    with open(dryrun_plans.JSON_PATH) as f:
        return json.load(f)


@pytest.mark.parametrize("arch,shape,mesh,layers", CHEAP_PAIRS)
def test_pair_matches_recorded_plan(recorded, arch, shape, mesh, layers):
    got, _ = dryrun_plans.trace(arch, shape, mesh, layers, "cpu")
    want = recorded["traces"][dryrun_plans.key(arch, shape, mesh, layers, "chunked")]
    print(f"{arch} {shape} {mesh} x{layers} on torch {torch.__version__} against "
          f"{recorded['torch']}: " + ", ".join(
              f"{k} {got[k] / want[k]:.6f}" for k in ("flops", "wire", "temp")))
    assert got["replicated_ops"] == {}
    for k in ("flops", "wire", "temp"):
        assert got[k] == pytest.approx(want[k], rel=RTOL), k


def _traced(fn):
    """``fn(mesh)`` run on fake tensors over a fake (2, 4) mesh under the
    dry-run's tracing: (its result, [(kind, in bytes, out bytes)], FLOPs)."""
    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
        with FakeTensorMode(), implicit_replication():
            args = fn.inputs(mesh)
            with dryrun.tracing() as (rec, cost, reshard):
                out = fn(*args)
    assert reshard.replicated_ops == {}
    return out, [(op.kind, op.in_bytes, op.out_bytes) for op in rec.ops], cost.flops


def _dtensor(local_shape, placements, mesh, dtype=torch.float32, **kw):
    return DTensor.from_local(torch.empty(local_shape, dtype=dtype, **kw), mesh, placements,
                              run_check=False)


def test_embedding_lookup_of_a_vocab_split_table():
    """``table[tokens]``, the table [64, 16] split over its vocab on
    'model' and its width on 'data', the tokens [4, 3] over 'data': the
    vocab's split moves onto the width (an all-to-all of the table's
    shard), the tokens are all-gathered over 'data', and the rows come out
    split on their width over both mesh dims.  Torch 2.11's DTensor
    gathered the table instead, 2.13's moved it; this is decided in
    ``_Reshard`` on both."""
    def lookup(table, tokens):
        return table[tokens]
    lookup.inputs = lambda mesh: (_dtensor((16, 8), [Shard(1), Shard(0)], mesh),
                                  _dtensor((2, 3), [Shard(0), Replicate()], mesh,
                                           dtype=torch.int64))
    out, ops, flops = _traced(lookup)
    assert tuple(out.shape) == (4, 3, 16)
    assert list(out.placements) == [Shard(2), Shard(2)]
    assert tuple(out.to_local().shape) == (4, 3, 2)
    assert ops == [("all-to-all", 16 * 8 * 4, 16 * 8 * 4), ("all-gather", 2 * 3 * 8, 4 * 3 * 8)]
    assert flops == 0


def test_partial_attention_output_reaches_wo_on_a_shard():
    """One attention block's output [B, S, KV, G, hd] = [16, 8, 2, 2, 4],
    a Partial sum over 'model' laid out as the einsum leaves it (strided),
    through ``reshape(B, S, H * hd) @ wo``: the reshape's copy
    reduce-scatters the Partial onto the batch (torch 2.13's layout of
    that copy; 2.11's kept the Partial, and the projection ran on the whole
    rows on every rank), and the projection runs on one eighth of the
    product on each rank."""
    B, S, KV, G, hd, D = 16, 8, 2, 2, 4, 16

    def project(out, wo):
        return out.reshape(B, S, KV * G * hd) @ wo

    def inputs(mesh):
        block = _dtensor((B // 2, KV, G, S, hd), [Shard(0), Partial()], mesh,
                         dtype=torch.bfloat16)
        wo = _dtensor((KV * G * hd // 4, D // 2), [Shard(1), Shard(0)], mesh,
                      dtype=torch.bfloat16)
        return block.permute(0, 3, 1, 2, 4), wo

    project.inputs = inputs
    out, ops, flops = _traced(project)
    local = B // 2 * S * KV * G * hd * 2
    assert ops[0] == ("reduce-scatter", local, local // 4)
    assert not any(kind == "all-reduce" for kind, _, _ in ops)
    assert tuple(out.shape) == (B, S, D)
    assert flops == 2 * B * S * KV * G * hd * D / 8


def test_moe_combine_product_of_two_partials_and_its_gradient():
    """The MoE combine's expert outputs [T, D] (a Partial sum over both
    mesh dims, from the gather out of the expert-split buffer) times the
    kept-slot mask [T, 1] (a Partial sum over 'data'), and the gradient of
    that product by the outputs for a Partial upstream gradient: the
    product is linear in each, so the outputs keep their Partial sums and
    the mask is all-reduced over 'data' once (the gradient reuses it).
    Torch 2.11's DTensor reduce-scattered the [T, D] outputs instead."""
    T, D = 32, 16

    def combine(y, keep, grad):
        out = y * keep
        g, = torch.autograd.grad(out, y, grad_outputs=grad)
        return out, g

    combine.inputs = lambda mesh: (
        _dtensor((T, D), [Partial(), Partial()], mesh, dtype=torch.bfloat16,
                 requires_grad=True),
        _dtensor((T, 1), [Partial(), Replicate()], mesh, dtype=torch.bfloat16),
        _dtensor((T, D), [Partial(), Partial()], mesh, dtype=torch.bfloat16))
    (out, g), ops, flops = _traced(combine)
    for t in (out, g):
        assert list(t.placements) == [Partial(), Partial()]
        assert tuple(t.to_local().shape) == (T, D)
    assert ops == [("all-reduce", T * 2, T * 2)]
    assert flops == 0


def test_gradient_norm_plans_alike_on_card_and_cpu():
    """``optimizer.global_norm`` is one ``_foreach_norm`` on the card and a
    sum of squares per leaf on the CPU.  Over gradients that are Partial
    sums, both reduce-scatter each leaf the same way (torch 2.11's DTensor
    all-reduced every leaf whole for ``_foreach_norm``); they differ only
    in the all-reduces of 4-byte sums."""
    shapes = [(8, 6), (12,), (16, 4)]

    def card(*leaves):
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(leaves))))

    def cpu(*leaves):
        return torch.sqrt(sum(torch.sum(leaf * leaf) for leaf in leaves))

    for fn in (card, cpu):
        fn.inputs = lambda mesh: tuple(_dtensor(s, [Partial(), Partial()], mesh) for s in shapes)
    (_, card_ops, _), (_, cpu_ops, _) = _traced(card), _traced(cpu)
    assert [op for op in card_ops if op[2] > 4] == [op for op in cpu_ops if op[2] > 4]
    assert ("reduce-scatter", 8 * 6 * 4, 8 * 6 * 4 // 2) in card_ops
