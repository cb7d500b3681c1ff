"""The port's MoE layer and latte MoE against the JAX reference, on the CPU.

The JAX side runs once per module in a subprocess with 8 emulated devices:
``init_moe`` (the params go through ``bridge.moe_params_from_numpy``),
``apply_moe`` and ``make_latte_moe`` under ``shard_map``, at the widths of
``tests/test_latte_moe.py`` (reduced mixtral with 8 experts, top-2,
d_model 64, d_ff_expert 32), in float32, with capacity factor 64 (no
drops), the default 1.25 and 0.5, so that tokens are dropped and the
pack-and-drop logic is compared.  Tolerance 1e-5: the two differ only in
summation order.  Routing compares top-k choices of random floats, where
ties (which ``lax.top_k`` and ``torch.topk`` may order differently) have
negligible probability.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_subprocess  # noqa: E402

from repro_torch.bridge import moe_params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import collectives as coll  # noqa: E402
from repro_torch.core import latte_moe  # noqa: E402
from repro_torch.kernels.ring_all_to_all import ops as aa_ops  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402

N = 8
TOL = 1e-5
# capacity factor 64: no drops; 1.25 (the default): latte drops at its local
# capacity of 5; 0.5: the dense layer drops too (capacity 16 for 128 tokens)
CAPACITY = {"nodrop": 64.0, "drop": 1.25, "tight": 0.5}

JAX_SIDE = r"""
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.configs import get_config
from repro.core.latte_moe import make_latte_moe
from repro.models import moe as moe_mod

mesh = make_mesh((8,), ("x",))
res = {}
base = get_config("mixtral-8x7b").reduced()
x = np.random.default_rng(1).normal(size=(8, 16, 64)).astype(np.float32)
res["x"] = x
for tag, cf in CAPACITY.items():
    cfg = dataclasses.replace(base, d_model=64, moe=dataclasses.replace(
        base.moe, n_experts=8, top_k=2, d_ff_expert=32, capacity_factor=cf))
    p = moe_mod.init_moe(cfg, jax.random.PRNGKey(0))
    for k, v in p.items():
        res[f"p_{k}"] = np.asarray(v)
    out, aux = jax.jit(lambda p, x: moe_mod.apply_moe(cfg, p, x))(p, jnp.asarray(x))
    res[f"dense_{tag}"], res[f"dense_aux_{tag}"] = np.asarray(out), np.asarray(aux)
    out, aux = jax.jit(make_latte_moe(cfg, mesh, "x"))(p, jnp.asarray(x))
    res[f"latte_{tag}"], res[f"latte_aux_{tag}"] = np.asarray(out), np.asarray(aux)
np.savez(OUT, **res)
print("JAX_SIDE_OK")
"""


def _cfg(tag: str):
    base = get_config("mixtral-8x7b").reduced()
    return dataclasses.replace(base, d_model=64, moe=dataclasses.replace(
        base.moe, n_experts=8, top_k=2, d_ff_expert=32, capacity_factor=CAPACITY[tag]))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_latte_moe") / "ref.npz")
    code = f"OUT = {path!r}\nCAPACITY = {CAPACITY!r}\n" + JAX_SIDE
    assert "JAX_SIDE_OK" in run_subprocess(code, n_devices=N)
    return dict(np.load(path))


def _params(ref, tag):
    tree = {k[2:]: v for k, v in ref.items() if k.startswith("p_")}
    return moe_params_from_numpy(_cfg(tag), tree, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def _n_dropped(cfg, x: torch.Tensor, router: torch.Tensor, capacity: int) -> int:
    _, topk_e, _ = moe_mod.route(cfg, router, x)
    return int((~moe_mod.assign_slots(topk_e, cfg.moe.n_experts, capacity)["keep"]).sum())


@pytest.mark.parametrize("tag", sorted(CAPACITY))
def test_apply_moe_matches_jax(ref, tag):
    cfg = _cfg(tag)
    p = _params(ref, tag)
    x = torch.from_numpy(ref["x"])
    out, aux = moe_mod.apply_moe(cfg, p, x)
    assert out.shape == x.shape and out.dtype == x.dtype
    _close(out, ref[f"dense_{tag}"])
    _close(aux, ref[f"dense_aux_{tag}"])
    dropped = _n_dropped(cfg, x.reshape(-1, 64), p["router"], moe_mod.capacity_for(cfg, 128))
    assert (dropped > 0) == (tag == "tight")


@pytest.mark.parametrize("tag", sorted(CAPACITY))
def test_latte_moe_matches_jax(ref, tag, monkeypatch):
    monkeypatch.setattr(aa_ops, "launches", 0)
    cfg = _cfg(tag)
    p = _params(ref, tag)
    x = torch.from_numpy(ref["x"])
    out, aux = latte_moe.make_latte_moe(cfg, coll.make_ranks(N, "cpu"))(p, x)
    assert out.shape == x.shape and aux.shape == ()
    _close(out, ref[f"latte_{tag}"])
    _close(aux, ref[f"latte_aux_{tag}"])
    assert aa_ops.launches == 0
    # each rank packs its 16 tokens at local capacity 5 (default factor) or
    # 4 (the floor), so some choices are dropped
    C = latte_moe.local_capacity(cfg, 16)
    dropped = sum(_n_dropped(cfg, x[r], p["router"], C) for r in range(N))
    assert (dropped > 0) == (tag != "nodrop")


def test_latte_moe_without_drops_equals_dense(ref):
    """With no drops the expert-parallel layer is the dense layer."""
    cfg = _cfg("nodrop")
    p = _params(ref, "nodrop")
    x = torch.from_numpy(ref["x"])
    latte, _ = latte_moe.make_latte_moe(cfg, coll.make_ranks(N, "cpu"))(p, x)
    dense, _ = moe_mod.apply_moe(cfg, p, x)
    torch.testing.assert_close(latte, dense, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("tag", sorted(CAPACITY))
def test_latte_moe_all_to_all_is_replaceable(ref, tag):
    """``all_to_all=`` takes any rendering: the one-shot reference gives the
    same bits as the pairwise schedule on the CPU."""
    cfg = _cfg(tag)
    p = _params(ref, tag)
    x = torch.from_numpy(ref["x"])
    ranks = coll.make_ranks(N, "cpu")
    calls = []

    def counting(xs, rk):
        calls.append(tuple(xs.shape))
        return coll.reference_all_to_all(xs, rk)

    want, _ = latte_moe.make_latte_moe(cfg, ranks)(p, x)
    got, _ = latte_moe.make_latte_moe(cfg, ranks, all_to_all=counting)(p, x)
    assert torch.equal(got, want)
    C = latte_moe.local_capacity(cfg, 16)
    assert calls == [(N, N, 1, C, 64)] * 2               # out and back, e_local = 1


def test_capacities():
    cfg = _cfg("drop")
    assert latte_moe.local_capacity(cfg, 16) == 5
    assert latte_moe.local_capacity(cfg, 4) == 4          # floor of 4
    assert moe_mod.capacity_for(cfg, 128) == 40
    assert moe_mod.capacity_for(cfg, 4) == 8              # floor of 8
    assert moe_mod.capacity_for(cfg, 1000) == 384         # >= 128 rounds to 128
    full = get_config("olmoe-1b-7b")
    assert latte_moe.local_capacity(full, 512) == 80


def test_init_moe_shapes_and_scales():
    cfg = dataclasses.replace(_cfg("drop"), d_model=256)
    p = moe_mod.init_moe(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (256, 8), "wg": (8, 256, 32), "wu": (8, 256, 32), "wd": (8, 32, 256)}
    assert all(v.dtype == torch.float32 for v in p.values())
    assert abs(p["wg"].std().item() - 256 ** -0.5) < 0.01
    assert abs(p["wd"].std().item() - 32 ** -0.5) < 0.01


def test_drop_never_overwrites_the_last_slot():
    """Every choice of one expert past its capacity is dropped; the last
    kept slot keeps its own token."""
    cfg = _cfg("drop")
    xf = torch.arange(6.0)[:, None].repeat(1, 64)
    topk_e = torch.tensor([[0, 1]] * 6)
    slots = moe_mod.assign_slots(topk_e, cfg.moe.n_experts, 4)
    buf = moe_mod.dispatch(xf, slots, cfg.moe.n_experts, 4)
    assert buf[0, :, 0].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert int((~slots["keep"]).sum()) == 4


def test_bridge_refuses_wrong_shapes(ref):
    tree = {k[2:]: v for k, v in ref.items() if k.startswith("p_")}
    tree["wd"] = tree["wd"].transpose(0, 2, 1)
    with pytest.raises(ValueError, match="wd"):
        moe_params_from_numpy(_cfg("drop"), tree, device="cpu")
