"""The port's sharding rules against the JAX reference's, on the CPU.

Param specs of every arch on both production meshes, and batch and cache
specs of every arch x input shape, equal the reference's leaf by leaf under
the layout contract: a port leaf of a stack of layers (a list of per-layer
dicts) has the reference's spec of the stacked leaf with the stacked dims
dropped.  Both sides run on a duck-typed mesh (axis sizes only), the
reference's as in ``tests/test_sharding.py``.  The port's params are fake
tensors at full width (nothing allocated).  On a fake 16x16 process group,
DTensor's own ``distribute_tensor`` cuts every full-width param leaf of
qwen2-0.5b and olmoe-1b-7b to the global shape divided by its spec's axis
sizes, as the dry-run's shards are cut.  The reference's own checks
(divisibility, whisper's unsharded vocab, EP vs TP) are ported too.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.tensor import distribute_tensor  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch.input_specs import input_specs as jax_input_specs  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.sharding import rules as jax_rules  # noqa: E402
from repro_torch.bridge import stacked_keys  # noqa: E402
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, get_shape  # noqa: E402
from repro_torch.launch.dryrun import _distribute  # noqa: E402
from repro_torch.launch.input_specs import input_specs, skip_reason  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_production_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding.rules import to_placements  # noqa: E402
from repro_torch.train.tree import tree_map  # noqa: E402


class FakeMesh:
    """Duck-typed mesh exposing only .shape (axis sizes)."""

    def __init__(self, shape: dict):
        self.shape = shape


MESHES = {"single": (FakeMesh({"data": 16, "model": 16}), "data"),
          "multipod": (FakeMesh({"pod": 2, "data": 16, "model": 16}), ("pod", "data"))}


def _rules(mesh_id):
    mesh, dp = MESHES[mesh_id]
    return jax_rules.ShardingRules(mesh=mesh, dp=dp), rules.ShardingRules(mesh=mesh, dp=dp)


def _fake_params(cfg):
    with FakeTensorMode():
        return build_model(cfg).init(torch.Generator().manual_seed(0), masters=True)


def _jax_params_shape(arch_id):
    model = jax_build_model(jax_get_config(arch_id))
    return jax.eval_shape(model.init, jax.random.PRNGKey(0))


def _flat(tree, path=(), nodes=(dict, list)):
    """[(path, leaf)] of a tree of dicts and lists (a spec tree's tuples are
    its leaves); ``nodes=(dict, list, tuple)`` for the reference's trees."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _flat(tree[k], path + (k,), nodes)]
    if isinstance(tree, nodes):
        return [x for i, v in enumerate(tree) for x in _flat(v, path + (i,), nodes)]
    return [(path, tree)]


def _ref_paths(spec_tree):
    return {p for p, _ in _flat(jax.tree.map(lambda s: 0, spec_tree, is_leaf=_is_spec),
                                nodes=(dict, list, tuple))}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _spec(p) -> tuple:
    return tuple(p)


def _ref_param_path(cfg, path):
    """A port param path -> (reference path, number of stacked dims)."""
    stacks = stacked_keys(cfg)
    if path[0] not in stacks:
        return path, 0
    n = stacks[path[0]]
    layer = path[1]
    ref = (path[0],) + (() if n is None else (layer % n,)) + path[2:]
    return ref, 1


def _is_spec(x):
    return isinstance(x, P)


@pytest.mark.parametrize("mesh_id", MESHES)
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_param_specs_match_reference(arch_id, mesh_id):
    cfg = get_config(arch_id)
    jrules, prules = _rules(mesh_id)
    ref_shapes = _jax_params_shape(arch_id)
    ref = jax_rules.infer_param_specs(ref_shapes, jax_get_config(arch_id), jrules)
    params = _fake_params(cfg)
    got = rules.infer_param_specs(params, cfg, prules)
    covered = set()
    for path, spec in _flat(got):
        ref_path, n_stacked = _ref_param_path(cfg, path)
        want = _spec(_get(ref, ref_path))[n_stacked:]
        assert spec == want, (path, spec, want)
        assert tuple(_get(params, path).shape) == _get(ref_shapes, ref_path).shape[n_stacked:]
        covered.add(ref_path)
    assert covered == _ref_paths(ref)


def _ref_cache_path(cfg, path):
    """A port cache path -> (reference path, number of stacked dims)."""
    if cfg.family in ("dense", "moe", "vlm"):
        n = len(cfg.layer_pattern or ("layer",))
        return (path[0] % n,) + path[1:], 1
    if cfg.family == "ssm":
        return path[1:], 1
    if cfg.family == "hybrid":
        return (path[0],) + path[2:], 2 if path[0] == "mamba" else 1
    return (path[0],) + path[2:], 1          # audio: self / cross


# every pair but the documented skips, for which the reference builds no inputs
PAIRS = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES
         if not skip_reason(get_config(a), get_shape(s))]


@pytest.mark.parametrize("arch_id,shape_id", PAIRS)
def test_batch_and_cache_specs_match_reference(arch_id, shape_id):
    cfg, shape = get_config(arch_id), get_shape(shape_id)
    jcfg = jax_get_config(arch_id)
    for mesh_id in MESHES:
        jrules, prules = _rules(mesh_id)
        ref_in = jax_input_specs(jcfg, shape, jax_build_model(jcfg))
        got_in = input_specs(cfg, shape, build_model(cfg), device="cpu")
        ref_b = jax_rules.batch_specs(ref_in["batch"], jcfg, shape, jrules)
        got_b = rules.batch_specs(got_in["batch"], cfg, shape, prules)
        assert got_b == {k: _spec(v) for k, v in ref_b.items()}
        for k, v in got_in["batch"].items():
            assert tuple(v.shape) == ref_in["batch"][k].shape
            assert str(v.dtype).split(".")[-1] == str(ref_in["batch"][k].dtype)
        if ref_in["caches"] is None:
            assert got_in["caches"] is None
            continue
        ref_c = jax_rules.cache_specs(ref_in["caches"], jcfg, shape, jrules)
        got_c = rules.cache_specs(got_in["caches"], cfg, shape, prules)
        covered = set()
        for path, spec in _flat(got_c):
            ref_path, n_stacked = _ref_cache_path(cfg, path)
            want = _spec(_get(ref_c, ref_path))[n_stacked:]
            assert spec == want, (mesh_id, path, spec, want)
            assert (tuple(_get(got_in["caches"], path).shape)
                    == _get(ref_in["caches"], ref_path).shape[n_stacked:])
            covered.add(ref_path)
        assert covered == _ref_paths(ref_c)


def _axis_size(mesh, axes):
    return rules._axsize(mesh, axes)


@pytest.mark.parametrize("mesh_id", MESHES)
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_param_specs_divisible(arch_id, mesh_id):
    """Every sharded dimension divides the product of its mesh axes."""
    cfg = get_config(arch_id)
    _, prules = _rules(mesh_id)
    params = _fake_params(cfg)
    for path, spec in _flat(rules.infer_param_specs(params, cfg, prules)):
        shape = _get(params, path).shape
        assert len(spec) == len(shape), (path, spec, shape)
        for dim, axes in zip(shape, spec):
            if axes is not None:
                assert dim % _axis_size(prules.mesh, axes) == 0, (path, spec, shape)


def test_divisibility_fallback():
    """whisper's odd vocab (51865) leaves the embedding unsharded over
    'model'; qwen2's 151936-vocab embedding is sharded."""
    _, prules = _rules("single")
    for arch, embed_sharded in (("whisper-tiny", False), ("qwen2-0.5b", True)):
        cfg = get_config(arch)
        specs = rules.infer_param_specs(_fake_params(cfg), cfg, prules)
        assert (specs["embed"][0] == "model") is embed_sharded


def test_moe_expert_parallel_vs_tp():
    """olmoe's 64 experts divide the 16-wide 'model' axis (expert parallel);
    mixtral's 8 do not (TP inside the experts)."""
    _, prules = _rules("single")
    for arch, expect_ep in (("olmoe-1b-7b", True), ("mixtral-8x7b", False)):
        cfg = get_config(arch)
        wg = rules.infer_param_specs(_fake_params(cfg), cfg, prules)["blocks"][0]["moe"]["wg"]
        if expect_ep:
            assert wg[-3] == "model", wg
        else:
            assert wg[-3] is None and wg[-1] == "model", wg


def test_to_placements_major_to_minor():
    """('pod', 'data') on one dim shards it over both mesh dims in the mesh's
    order; axes out of that order are refused."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    assert to_placements((("pod", "data"), None, "model"), Mesh()) == [Shard(0), Shard(0),
                                                                        Shard(2)]
    assert to_placements((None, None), Mesh()) == [Replicate()] * 3
    with pytest.raises(ValueError):
        to_placements((("data", "pod"),), Mesh())


@pytest.fixture(scope="module")
def mesh16():
    with fake_world(256):
        yield make_production_mesh(device="cpu")


@pytest.mark.parametrize("arch_id", ["qwen2-0.5b", "olmoe-1b-7b"])
def test_local_shapes_on_fake_mesh(arch_id, mesh16):
    """DTensor's own sharding of every full-width param leaf on the fake 16x16
    mesh: local shape = global shape / the spec's axis sizes, the shape the
    dry-run's shards get."""
    cfg = get_config(arch_id)
    prules = rules.ShardingRules(mesh=mesh16, dp="data")
    with FakeTensorMode():
        params = build_model(cfg).init(torch.Generator().manual_seed(0), masters=True)
        specs = rules.infer_param_specs(params, cfg, prules)
        n = 0

        def check(t, spec):
            nonlocal n
            want = tuple(d // _axis_size(mesh16, axes) for d, axes in zip(t.shape, spec))
            local = distribute_tensor(t, mesh16, to_placements(spec, mesh16)).to_local()
            assert tuple(local.shape) == want, (spec, t.shape)
            assert tuple(_distribute(t, spec, mesh16).to_local().shape) == want
            n += 1

        tree_map(check, params, specs)
    assert n == len(_flat(params))
