"""The port's training path against the JAX reference, on the CPU.

Data batches are bit-equal (both packages draw them with numpy).  Loss,
aux loss and gradients are compared in float32 on bridged weights
(``compute_dtype="float32"`` in both packages, which then differ only in
summation order): the loss at 1e-5, the aux loss at 1e-6, and each
gradient leaf at 1e-4 of that leaf's largest element (measured: ~2e-6).
A bf16 loss through ``cast_params_for_compute`` is compared at 1e-2 on the
dense configs (measured: 5e-4; the two frameworks round the bf16 logits
at different places, and a loss of ~6 is an average of differences of
bf16 values of ~1, so one bf16 step at the loss's own magnitude, 3e-2,
bounds it with room).  MoE configs are compared in float32 only, where no
routing probabilities tie (bf16 rounding moves near ties, PERF.md §6).

Params after Adam steps are compared in units of the learning rate.  In
Adam's first steps ``mhat / (sqrt(vhat) + eps)`` is about ``sign(g)``: the
ratio is 1/eps-Lipschitz in g, so where |g| is near eps = 1e-8, float32
noise of ~1e-8 in g moves an element by up to 2 * lr in one step.  So
every element must lie within 2 * (sum of the steps' lr) of the
reference's, and all but 1e-3 of the elements within 1e-6 (measured:
at most 1.8e-4 of the elements are off by more than 1e-6 after three
steps, the worst by 0.053 * lr); the moments ``m`` and ``v``,
which carry the clipped gradients and no ratio, at 1e-4 of their leaf's
largest element.  Elements whose gradient is exactly 0 agree exactly
(0 / (0 + eps) = 0).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro.train import loop as jax_loop  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro_torch.bridge import (params_to_numpy, train_state_from_numpy,  # noqa: E402
                                train_state_to_numpy)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten  # noqa: E402

LOSS_TOL = 1e-5
AUX_TOL = 1e-6
GRAD_RTOL = 1e-4
BF16_LOSS_TOL = 1e-2
PARAM_ATOL = 1e-6
PARAM_OFF_SHARE = 1e-3
ARCHS = ("qwen2-0.5b", "gemma2-27b", "olmoe-1b-7b")    # gemma2: softcaps, local windows


def _cfgs(arch, dtype="float32"):
    jc = dataclasses.replace(jax_get_config(arch).reduced(), compute_dtype=dtype)
    tc = dataclasses.replace(get_config(arch).reduced(), compute_dtype=dtype)
    return jc, tc


def _states(arch, dtype="float32", seed=0):
    """The reference's train state and the port's, bridged from it."""
    jc, tc = _cfgs(arch, dtype)
    jm = jax_build_model(jc)
    js = jax_loop.init_train_state(jm, jax.random.PRNGKey(seed))
    ts = train_state_from_numpy(tc, jax.tree.map(np.asarray, js), device="cpu")
    return jm, js, build_model(tc), ts


def _tokens(vocab, seed, step=0, seq=32, batch=2):
    dc = pipeline.DataConfig(vocab=vocab, seq_len=seq, batch=batch, seed=seed)
    return pipeline.synth_batch(dc, step)["tokens"].numpy()


def _named(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x))
            for p, x in jax.tree_util.tree_leaves_with_path(tree)]


def _close_leaves(got, want, rtol):
    """Each leaf of ``got`` within ``rtol`` of the largest element of the
    matching leaf of ``want`` (reference layout, same structure)."""
    got_l = jax.tree.leaves(got)
    named = _named(want)
    assert len(got_l) == len(named)
    for (name, w), g in zip(named, got_l):
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= rtol * scale, (name, err, scale)


# ------------------------------------------------------------------ data ----
@pytest.mark.parametrize("induction_prob", [0.3, 1.0])
@pytest.mark.parametrize("seed,step,shard,n_shards,vocab,seq",
                         [(0, 0, 0, 1, 512, 64), (1, 3, 0, 1, 512, 256),
                          (7, 11, 1, 4, 151936, 128), (123, 2, 3, 4, 50304, 64)])
def test_synth_batch_bit_equal(induction_prob, seed, step, shard, n_shards, vocab, seq):
    kw = dict(vocab=vocab, seq_len=seq, batch=5, seed=seed, shard=shard, n_shards=n_shards,
              induction_prob=induction_prob)
    got = pipeline.synth_batch(pipeline.DataConfig(**kw), step)["tokens"]
    want = np.asarray(jax_pipeline.synth_batch(jax_pipeline.DataConfig(**kw), step)["tokens"])
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_data_iterator_resumes():
    kw = dict(vocab=128, seq_len=32, batch=2, seed=0)
    it = pipeline.data_iterator(pipeline.DataConfig(**kw), start_step=4)
    jit_ = jax_pipeline.data_iterator(jax_pipeline.DataConfig(**kw), start_step=4)
    for _ in range(3):
        np.testing.assert_array_equal(next(it)["tokens"].numpy(), np.asarray(next(jit_)["tokens"]))


# ------------------------------------------------------------- optimizer ----
@pytest.mark.parametrize("step", [0, 1, 10, 55, 100, 150])
def test_lr_at(step):
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    got = float(opt.lr_at(opt.AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32)))
    want = float(jax_opt.lr_at(jax_opt.AdamWConfig(**kw), jnp.int32(step)))
    assert abs(got - want) <= 1e-6 * 1e-3


def _tree_of(rng, scale=1.0):
    """A port-style tree (dicts and lists) of float32 numpy arrays."""
    def make(t):
        if isinstance(t, dict):
            return {k: make(v) for k, v in t.items()}
        if isinstance(t, list):
            return [make(v) for v in t]
        return (rng.normal(size=t) * scale).astype(np.float32)
    return make({"a": (3, 4), "b": [{"w": (5,), "x": (2, 3, 2)}, {"w": (5,), "x": (2, 3, 2)}],
                 "c": (7,)})


def _torch_tree(tree):
    return tree_map(lambda a: torch.from_numpy(a.copy()), tree)


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def test_global_norm():
    tree = _tree_of(np.random.default_rng(0))
    got = float(opt.global_norm(_torch_tree(tree)))
    want = float(jax_opt.global_norm(_jax_tree(tree)))
    assert abs(got - want) <= 1e-6 * want
    assert abs(float(opt.global_norm({"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}))
               - 5.0) < 1e-6


@pytest.mark.parametrize("grad_scale,clip", [(10.0, 1.0), (1e-3, 1.0)])   # clip active, not
def test_adamw_update_matches_reference(grad_scale, clip):
    """Five steps on a random tree with random gradients, at 1e-6."""
    rng = np.random.default_rng(1)
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=8, weight_decay=0.1, grad_clip=clip)
    params = _tree_of(rng)
    tp, jp = _torch_tree(params), _jax_tree(params)
    to, jo = opt.init_opt_state(tp), jax_opt.init_opt_state(jp)
    assert to["step"].dtype == torch.int32 and to["step"].dim() == 0
    clipped = []
    for _ in range(5):
        grads = _tree_of(rng, grad_scale)
        tp, to, tm = opt.adamw_update(opt.AdamWConfig(**cfg_kw), tp, _torch_tree(grads), to)
        jp, jo, jm = jax_opt.adamw_update(jax_opt.AdamWConfig(**cfg_kw), jp, _jax_tree(grads), jo)
        clipped.append(float(jm["grad_norm"]) > clip)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-6 * float(jm["grad_norm"])
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-6 * cfg_kw["lr"]
        for got, want in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
            for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)
    assert int(to["step"]) == 5
    assert all(clipped) if grad_scale > 1 else not any(clipped)


def test_adamw_minimizes_quadratic():
    cfg = opt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=200,
                          min_lr_ratio=1.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init_opt_state(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt.adamw_update(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 0.1


def test_grad_clip_bounds_update():
    cfg = opt.AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0, warmup_steps=0)
    params = {"w": torch.zeros(4)}
    huge = {"w": torch.full((4,), 1e9)}
    new, _, metrics = opt.adamw_update(cfg, params, huge, opt.init_opt_state(params))
    assert float(metrics["grad_norm"]) > 1e8  # reported unclipped
    assert float(new["w"].abs().max()) <= 1.0 + 1e-6


# ------------------------------------------------------ loss and gradients ----
def _port_loss_and_grads(tm, params, batch, remat=True):
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = tm.loss(leaves, batch, remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    return loss.detach(), tree_unflatten(leaves, grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_f32(arch):
    jm, js, tm, ts = _states(arch)
    toks = _tokens(jm.cfg.vocab, seed=3)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, {"tokens": jnp.asarray(toks)})))(js["params"])
    _, jaux, _ = jm.forward(js["params"], {"tokens": jnp.asarray(toks)}, remat=False)
    batch = {"tokens": torch.from_numpy(toks)}
    tloss, tgrads = _port_loss_and_grads(tm, ts["params"], batch)
    _, taux, _ = tm.forward(ts["params"], batch)
    assert tloss.dtype == torch.float32 and tloss.dim() == 0
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL
    assert abs(float(taux) - float(jaux)) <= AUX_TOL
    assert (float(taux) > 0) == (arch == "olmoe-1b-7b")
    _close_leaves(params_to_numpy(tm.cfg, tgrads), jgrads, GRAD_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_with_labels(arch):
    """``batch["labels"]`` replaces the shifted tokens, logits uncut."""
    jm, js, tm, ts = _states(arch)
    toks = _tokens(jm.cfg.vocab, seed=4)
    labels = np.roll(toks, -1, axis=1)
    want = jm.loss(js["params"], {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    with torch.no_grad():
        got = tm.loss(ts["params"], {"tokens": torch.from_numpy(toks),
                                     "labels": torch.from_numpy(labels)})
    assert abs(float(got) - float(want)) <= LOSS_TOL


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma2-27b"])
def test_loss_bf16_through_compute_cast(arch):
    jm, js, tm, ts = _states(arch, dtype="bfloat16", seed=1)
    toks = _tokens(jm.cfg.vocab, seed=5)
    want = jm.loss(jax_loop.cast_params_for_compute(js["params"]), {"tokens": jnp.asarray(toks)})
    cast = loop.cast_params_for_compute(ts["params"])
    ref_cast = jax_loop.cast_params_for_compute(js["params"])
    for (name, w), g in zip(_named(ref_cast), _port_dtypes(tm.cfg, cast)):
        assert str(w.dtype) == g, (name, w.dtype, g)
    with torch.no_grad():
        got = tm.loss(cast, {"tokens": torch.from_numpy(toks)})
    assert abs(float(got) - float(want)) <= BF16_LOSS_TOL


def _port_dtypes(cfg, params):
    """Dtype names of the port's params in the reference's leaf order."""
    names = tree_map(lambda t: str(t.dtype).replace("torch.", ""), params)
    per_unit = len(cfg.layer_pattern or ("layer",))
    blocks = names["blocks"]
    ordered = dict(names, blocks=tuple(blocks[i] for i in range(per_unit)))
    return tree_leaves(ordered)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b"])
def test_remat_gives_the_same_gradients(arch):
    _, _, tm, ts = _states(arch, seed=2)
    batch = {"tokens": torch.from_numpy(_tokens(tm.cfg.vocab, seed=6))}
    l1, g1 = _port_loss_and_grads(tm, ts["params"], batch, remat=True)
    l0, g0 = _port_loss_and_grads(tm, ts["params"], batch, remat=False)
    assert torch.equal(l1, l0)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        assert torch.equal(a, b)


# ----------------------------------------------------------- train steps ----
@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference_f32(arch):
    jm, js, tm, ts = _states(arch)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jax_loop.make_train_step(jm, jax_opt.AdamWConfig(**kw), cast_params=False))
    tstep = loop.make_train_step(tm, opt.AdamWConfig(**kw), cast_params=False)
    lr_sum = 0.0
    for i in range(3):
        toks = _tokens(jm.cfg.vocab, seed=7, step=i)
        js, jmet = jstep(js, {"tokens": jnp.asarray(toks)})
        ts, tmet = tstep(ts, {"tokens": torch.from_numpy(toks)})
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= LOSS_TOL
        assert abs(float(tmet["grad_norm"]) / float(jmet["grad_norm"]) - 1) <= 1e-5
        assert abs(float(tmet["lr"]) - float(jmet["lr"])) <= 1e-6 * kw["lr"]
        lr_sum += float(jmet["lr"])
    got = train_state_to_numpy(tm.cfg, ts)
    assert int(got["opt"]["step"]) == 3
    for key in ("m", "v"):
        _close_leaves(got["opt"][key], js["opt"][key], GRAD_RTOL)
    off = total = 0
    for (name, w), g in zip(_named(js["params"]), jax.tree.leaves(got["params"])):
        err = np.abs(g - w)
        assert float(err.max()) <= 2 * lr_sum, (name, float(err.max()), lr_sum)
        off += int((err > PARAM_ATOL).sum())
        total += err.size
    assert off <= PARAM_OFF_SHARE * total, (off, total)


def test_train_step_is_functional():
    """The step returns a new state and leaves its input as it was."""
    _, _, tm, ts = _states("qwen2-0.5b", seed=3)
    before = tree_map(torch.clone, ts)
    step = loop.make_train_step(tm, opt.AdamWConfig(lr=1e-3, warmup_steps=1))
    new, metrics = step(ts, {"tokens": torch.from_numpy(_tokens(tm.cfg.vocab, seed=8))})
    for a, b in zip(tree_leaves(ts), tree_leaves(before)):
        assert torch.equal(a, b)
    assert int(new["opt"]["step"]) == 1 and set(metrics) == {"loss", "grad_norm", "lr"}
    assert not any(p.requires_grad for p in tree_leaves(new))


def test_cast_params_for_compute_rule():
    """The reference's rule, ndim >= 2 in its stacked layout: every block
    leaf (router, norm scales, QKV biases too) and the embedding to bf16;
    ``final_norm`` stays float32."""
    for arch in ("olmoe-1b-7b", "qwen2-0.5b"):
        _, js, _, ts = _states(arch)
        cast = loop.cast_params_for_compute(ts["params"])
        want = jax_loop.cast_params_for_compute(js["params"])
        assert [str(w.dtype) for _, w in _named(want)] == _port_dtypes(get_config(arch), cast)
    assert cast["blocks"][0]["attn"]["bq"].dtype == torch.bfloat16
    assert cast["blocks"][0]["ln1"]["scale"].dtype == torch.bfloat16
    assert cast["final_norm"]["scale"].dtype == torch.float32
    assert cast["embed"].dtype == torch.bfloat16


def test_init_train_state_masters_float32():
    """``masters=True`` keeps every leaf float32; serving's init keeps its
    compute-dtype cast; both draw the same values."""
    tc = get_config("olmoe-1b-7b").reduced()
    tm = build_model(tc)
    state = loop.init_train_state(tm, torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float32 for p in tree_leaves(state["params"]))
    assert all(not torch.count_nonzero(m) for m in tree_leaves(state["opt"]["m"]))
    served = tm.init(torch.Generator().manual_seed(0))
    assert served["blocks"][0]["moe"]["wg"].dtype == torch.bfloat16
    assert served["blocks"][0]["moe"]["router"].dtype == torch.float32
    assert torch.equal(served["blocks"][1]["moe"]["wg"],
                       state["params"]["blocks"][1]["moe"]["wg"].to(torch.bfloat16))


# ----------------------------------------------------------- checkpoints ----
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b"])
def test_checkpoint_across_packages(arch, direction, tmp_path):
    jm, js, tm, ts = _states(arch, seed=4)
    # one step, so that m, v and step are not all zero
    toks = _tokens(jm.cfg.vocab, seed=9)
    js, _ = jax.jit(jax_loop.make_train_step(
        jm, jax_opt.AdamWConfig(lr=1e-3, warmup_steps=1), cast_params=False))(
        js, {"tokens": jnp.asarray(toks)})
    ts = train_state_from_numpy(tm.cfg, jax.tree.map(np.asarray, js), device="cpu")
    path = str(tmp_path / "state.npz")
    if direction == "jax_to_port":
        jax_ckpt.save_checkpoint(path, js, step=1)
        tree = ckpt.restore_checkpoint(path, train_state_to_numpy(tm.cfg, ts))
        got = train_state_from_numpy(tm.cfg, tree, device="cpu")
        for a, b in zip(tree_leaves(got), tree_leaves(ts)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        ckpt.save_checkpoint(path, train_state_to_numpy(tm.cfg, ts), step=1)
        got = jax_ckpt.restore_checkpoint(path, js)
        for (name, w), g in zip(_named(js), jax.tree.leaves(got)):
            g = np.asarray(g)
            assert g.dtype == w.dtype and np.array_equal(g, w), name
    with np.load(path) as f:
        manifest = json.loads(str(f["__manifest__"]))
    assert manifest["n_leaves"] == len(jax.tree.leaves(js)) and manifest["step"] == 1


@pytest.mark.parametrize("like", [{"w": np.zeros((4, 5), np.float32)},
                                  {"w": np.zeros((4, 4), np.float32),
                                   "extra": np.zeros(1, np.float32)}])
def test_checkpoint_mismatch_raises(like, tmp_path):
    path = str(tmp_path / "c.npz")
    ckpt.save_checkpoint(path, {"w": np.zeros((4, 4), np.float32)}, step=3)
    with pytest.raises(ValueError):
        ckpt.restore_checkpoint(path, like)


# ------------------------------------------------------- loop, launcher ----
def test_training_reduces_loss():
    """The reference's ``test_training_reduces_loss`` setting, on the port."""
    cfg = get_config("qwen2-0.5b").reduced()
    dc = pipeline.DataConfig(vocab=cfg.vocab, seq_len=64, batch=4, seed=0)
    _, hist = loop.train_loop(build_model(cfg), pipeline.data_iterator(dc), steps=40,
                              opt_cfg=opt.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=40),
                              log_every=39, device="cpu")
    assert [h["step"] for h in hist] == [0, 39]
    assert set(hist[0]) == {"loss", "grad_norm", "lr", "step", "wall_s"}
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.5


def test_train_launcher_writes_checkpoint(tmp_path, capsys):
    path, hist_path = str(tmp_path / "run.npz"), str(tmp_path / "hist.json")
    launch_train.main(["--device", "cpu", "--steps", "10", "--seq", "64", "--batch", "4",
                       "--checkpoint", path, "--history-out", hist_path])
    assert "saved checkpoint" in capsys.readouterr().out
    with open(hist_path) as f:
        assert json.load(f)[-1]["step"] == 9
    # the reference restores it into its own train state
    jc = jax_get_config("qwen2-0.5b").reduced()
    like = jax_loop.init_train_state(jax_build_model(jc), jax.random.PRNGKey(0))
    got = jax_ckpt.restore_checkpoint(path, like)
    assert int(got["opt"]["step"]) == 10
    assert os.path.getsize(path) > 0


def test_train_launcher_draws_encoder_feats_on_its_device(monkeypatch):
    """The audio family's stub encoder features are drawn on the device
    ``main`` resolved (the card under ``--device cuda``), not on the CPU and
    copied to the card every step."""
    class Stop(Exception):
        pass

    seen = {}
    resolved = torch.device("meta")

    def feats(cfg, it, batch, seed, device="cpu"):
        seen["device"] = device
        raise Stop

    monkeypatch.setattr(launch_train, "resolve_device", lambda name: resolved)
    monkeypatch.setattr(launch_train, "with_encoder_feats", feats)
    with pytest.raises(Stop):
        launch_train.main(["--device", "cuda", "--arch", "whisper-tiny", "--steps", "2"])
    assert seen["device"] is resolved


def test_encoder_feats_take_the_card_unless_cpu(monkeypatch):
    """The audio family's stub features are drawn on the card unless the
    caller names the CPU; without a card that raises, as every entry point
    does."""
    cfg = get_config("whisper-tiny").reduced()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.with_encoder_feats(cfg, iter([{}]), 2, 0)
    batch = next(launch_train.with_encoder_feats(cfg, iter([{}]), 2, 0, device="cpu"))
    assert batch["encoder_feats"].device.type == "cpu"
    assert batch["encoder_feats"].shape == (2, cfg.encdec.encoder_seq, cfg.d_model)
    text = iter([{"tokens": 1}])
    assert launch_train.with_encoder_feats(get_config("qwen2-0.5b"), text, 2, 0) is text


def test_train_launcher_unported_family_raises():
    """Every family is ported; the launcher refuses vlm training, as the
    reference's does (its frontend is a stub)."""
    with pytest.raises(SystemExit, match="VLM"):
        launch_train.main(["--device", "cpu", "--arch", "qwen2-vl-72b", "--steps", "2"])
