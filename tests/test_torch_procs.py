"""The collectives and the latte MoE layer with one rank per process, on the
CPU over gloo.

``core.procgroup.spawn`` starts one gloo group per world size (8, the
reference's test mesh, and 6, for the all-to-all's rotation pairing); each
process runs every B3 / B4 variant per rank (``ops.ring_all_gather_rank``,
``ops.all_to_all_rank``: on the CPU their ring and pairing schedules step
by step over gloo ``send``/``recv``), the ring reduce-scatter per rank,
the ``core.collectives`` functions and ``CommBackend`` with a
``ProcessRanks``, on inputs made with numpy from a seed, in f32 and bf16,
and (8 ranks) the latte MoE layer per rank.  Each case below reads its
rank's results from that one run and holds them to the numpy oracle (data
movement bit-equal, sums within a stated tolerance), to the emulated
``RankGroup`` rendering on the same inputs (bit-equal for every ring and
for the MoE layer), and to the reference's ``shard_map`` functions and
``make_latte_moe`` (one JAX subprocess with 8 host devices, no Pallas
interpret).  The card's cases are in ``tests/test_torch_gpu.py``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import REPO, run_subprocess  # noqa: E402

from test_torch_latte_moe import CAPACITY, TOL, _cfg  # noqa: E402

from repro_torch.bridge import moe_params_from_numpy  # noqa: E402
from repro_torch.core import collectives as coll  # noqa: E402
from repro_torch.core import latte_moe  # noqa: E402
from repro_torch.core import procgroup  # noqa: E402
from repro_torch.core.backend import CommBackend  # noqa: E402
from repro_torch.kernels.ring_all_gather import ops as ag_ops  # noqa: E402
from repro_torch.kernels.ring_all_to_all import ops as aa_ops  # noqa: E402
from repro_torch.kernels.ring_reduce_scatter import ops as rs_ops  # noqa: E402

SIZES = (8, 6)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TIMEOUT_S = 240
MOE_RANKS = 8                    # the latte MoE's ranks (8 experts: 6 do not divide them)


def inputs(n: int) -> dict:
    """Rank j's shard is ag[j] / coll_ag[j]; rank j's chunk for rank i is
    aa[j, i] / coll_aa[j, i] (also the reductions' addends).  With 8 ranks,
    the latte MoE's params (scaled as the reference's ``init_moe``, at
    ``test_torch_latte_moe.py``'s widths) and 16 tokens a rank."""
    rng = np.random.default_rng(n)
    data = {"ag": rng.normal(size=(n, 3, 40)).astype(np.float32),
            "aa": rng.normal(size=(n, n, 2, 24)).astype(np.float32),
            "coll_ag": rng.normal(size=(n, 4, 32)).astype(np.float32),
            "coll_aa": rng.normal(size=(n, n, 2, 16)).astype(np.float32)}
    if n == MOE_RANKS:
        cfg = _cfg("drop")
        D, E, F = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
        for k, shape, scale in (("router", (D, E), D), ("wg", (E, D, F), D),
                                ("wu", (E, D, F), D), ("wd", (E, F, D), F)):
            data[f"p_{k}"] = (rng.normal(size=shape) / np.sqrt(scale)).astype(np.float32)
        data["moe_x"] = rng.normal(size=(n, 16, D)).astype(np.float32)
    return data


def moe_params(data: dict, tag: str) -> dict:
    tree = {k[2:]: v for k, v in data.items() if k.startswith("p_")}
    return moe_params_from_numpy(_cfg(tag), tree, device="cpu")


REDUCTIONS = ("ring_reduce_scatter", "ring_all_reduce", "reference_reduce_scatter",
              "reference_all_reduce")


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def rank_work(ranks, data: dict) -> dict:
    """One process: every per-rank rendering on this rank's part of
    ``data``, and what the process group looks like from here."""
    my, out = ranks.rank, {"rank": ranks.rank, "n": ranks.n, "device": str(ranks.device)}
    for d, dtype in DTYPES.items():
        t = {k: torch.from_numpy(v).to(dtype) for k, v in data.items()}
        for v in ag_ops.VARIANTS:
            out[f"ag {v} {d}"] = _f32(ag_ops.ring_all_gather_rank(t["ag"][my], ranks, v))
        for v in aa_ops.VARIANTS:
            out[f"aa {v} {d}"] = _f32(aa_ops.all_to_all_rank(t["aa"][my].contiguous(), ranks, v))
        out[f"ring_all_gather {d}"] = _f32(coll.ring_all_gather(t["coll_ag"][my], ranks))
        out[f"bidir_ring_all_gather {d}"] = _f32(
            coll.bidir_ring_all_gather(t["coll_ag"][my], ranks))
        out[f"pairwise_all_to_all {d}"] = _f32(
            coll.pairwise_all_to_all(t["coll_aa"][my].contiguous(), ranks))
        out[f"reference_all_gather {d}"] = _f32(coll.reference_all_gather(t["coll_ag"][my], ranks))
        out[f"reference_all_to_all {d}"] = _f32(
            coll.reference_all_to_all(t["coll_aa"][my].contiguous(), ranks))
        be = CommBackend("latte", axis_devices=ranks.n, allow_stale_tables=True)
        out[f"backend all_gather {d}"] = _f32(be.all_gather(t["coll_ag"][my], ranks))
        out[f"backend all_to_all {d}"] = _f32(be.all_to_all(t["coll_aa"][my].contiguous(), ranks))
        addends = t["coll_aa"][my].contiguous()
        for name in REDUCTIONS:
            out[f"{name} {d}"] = _f32(getattr(coll, name)(addends, ranks))
        out[f"backend reduce_scatter {d}"] = _f32(be.reduce_scatter(addends, ranks))
        out[f"backend all_reduce {d}"] = _f32(be.all_reduce(addends, ranks))
        out[f"rs kernel {d}"] = _f32(rs_ops.reduce_scatter_rank(addends, ranks))
    if ranks.n == MOE_RANKS:
        for tag in CAPACITY:
            o, aux = latte_moe.make_latte_moe(_cfg(tag), ranks)(moe_params(data, tag),
                                                                torch.from_numpy(
                                                                    data["moe_x"][my:my + 1]))
            out[f"moe {tag}"], out[f"moe aux {tag}"] = o.numpy(), aux.numpy()
    try:
        latte_moe.make_latte_moe(_cfg("drop"), ranks)
        out["moe ranks"] = "accepted"
    except AssertionError:
        out["moe ranks"] = "rejected"
    out["launches"] = (ag_ops.launches_rank, aa_ops.launches_rank, rs_ops.launches_rank)
    torch.cuda.is_available = lambda: False       # this process has no card from here
    try:
        procgroup.process_ranks()
        out["default device"] = "no error"
    except RuntimeError as e:
        out["default device"] = str(e)
    out["cpu device"] = str(procgroup.process_ranks("cpu").device)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{n: (inputs, [rank results])}, one gloo group of n processes each."""
    out = {}
    for n in SIZES:
        data = inputs(n)
        out[n] = (data, procgroup.spawn(rank_work, n, device="cpu", args=(data,),
                                        timeout_s=TIMEOUT_S))
    return out


JAX_SIDE = r"""
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.configs import get_config
from repro.core import collectives as coll
from repro.core.latte_moe import make_latte_moe

res = {}
for n in (8, 6):
    data = np.load(IN.format(n))
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    for d, jd in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        names = [("ring_all_gather", "coll_ag"), ("bidir_ring_all_gather", "coll_ag"),
                 ("pairwise_all_to_all", "coll_aa")]
        if d == "float32":
            names += [(name, "coll_aa") for name in REDUCTIONS]
        for name, key in names:
            x = jnp.asarray(data[key]).astype(jd)
            spec = P("x", *[None] * (x.ndim - 1))
            fn = getattr(coll, name)
            out_ndim = 2 if name.endswith("reduce_scatter") else 3   # one device's result
            f = shard_map(lambda a, fn=fn: fn(a[0], "x")[None], mesh=mesh, in_specs=spec,
                          out_specs=P("x", *[None] * out_ndim), check_vma=False)
            res[f"{name} {d} {n}"] = np.asarray(jax.jit(f)(x).astype(jnp.float32))
    if n == 8:
        # the latte MoE at test_torch_latte_moe.py's config, on these params
        base = get_config("mixtral-8x7b").reduced()
        p = {k: jnp.asarray(data["p_" + k]) for k in ("router", "wg", "wu", "wd")}
        for tag, cf in CAPACITY.items():
            cfg = dataclasses.replace(base, d_model=64, moe=dataclasses.replace(
                base.moe, n_experts=8, top_k=2, d_ff_expert=32, capacity_factor=cf))
            out, aux = jax.jit(make_latte_moe(cfg, mesh, "x"))(p, jnp.asarray(data["moe_x"]))
            res[f"moe {tag}"], res[f"moe aux {tag}"] = np.asarray(out), np.asarray(aux)
np.savez(OUT, **res)
print("JAX_SIDE_OK")
"""


@pytest.fixture(scope="module")
def jax_ref(runs, tmp_path_factory):
    """The reference's shard_map collectives and make_latte_moe on the same
    inputs: row i is device i's result."""
    d = tmp_path_factory.mktemp("jax_procs")
    for n, (data, _) in runs.items():
        np.savez(d / f"in{n}.npz", **data)
    path = d / "ref.npz"
    code = (f"IN = {str(d / 'in{}.npz')!r}\nOUT = {str(path)!r}\nCAPACITY = {CAPACITY!r}\n"
            f"REDUCTIONS = {REDUCTIONS!r}\n" + JAX_SIDE)
    assert "JAX_SIDE_OK" in run_subprocess(code, n_devices=8)
    return dict(np.load(path))


def _rounded(a: np.ndarray, d: str) -> np.ndarray:
    return torch.from_numpy(a).to(DTYPES[d]).float().numpy()


RANK_CASES = [(n, r) for n in SIZES for r in range(n)]


@pytest.mark.parametrize("n,rank", RANK_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("variant", sorted(ag_ops.VARIANTS))
def test_all_gather_per_rank_bit_equal(runs, n, rank, dtype, variant):
    """Every B3 variant's gloo schedule: numpy's gathered array, and the
    emulated kernel's plain version's row for this rank."""
    data, res = runs[n]
    got = res[rank][f"ag {variant} {dtype}"]
    x = _rounded(data["ag"], dtype)
    np.testing.assert_array_equal(got, x.reshape(n * 3, 40))
    emulated = ag_ops.ring_all_gather(torch.from_numpy(data["ag"]).to(DTYPES[dtype]), variant)
    np.testing.assert_array_equal(got, _f32(emulated[rank]))


@pytest.mark.parametrize("n,rank", RANK_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("variant", sorted(aa_ops.VARIANTS))
def test_all_to_all_per_rank_bit_equal(runs, n, rank, dtype, variant):
    """Every B4 variant's gloo pairing (XOR at 8, rotation at 6): numpy's
    transpose and the emulated kernel's plain version's row."""
    data, res = runs[n]
    got = res[rank][f"aa {variant} {dtype}"]
    np.testing.assert_array_equal(got, _rounded(data["aa"], dtype)[:, rank])
    emulated = aa_ops.all_to_all(torch.from_numpy(data["aa"]).to(DTYPES[dtype]), variant)
    np.testing.assert_array_equal(got, _f32(emulated[rank]))


COLL = ("ring_all_gather", "bidir_ring_all_gather", "pairwise_all_to_all")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", COLL)
def test_collectives_over_processes_match_shard_map(runs, jax_ref, n, dtype, name):
    """``core.collectives`` with a ``ProcessRanks`` and this rank's operand,
    as the reference's functions are called inside shard_map: each rank's
    result bit-equal to its device's, and to the emulated ``RankGroup``
    rendering's row."""
    data, res = runs[n]
    key = "coll_aa" if name == "pairwise_all_to_all" else "coll_ag"
    emulated = getattr(coll, name)(torch.from_numpy(data[key]).to(DTYPES[dtype]),
                                   coll.make_ranks(n, "cpu"))
    for r in range(n):
        got = res[r][f"{name} {dtype}"]
        np.testing.assert_array_equal(got, jax_ref[f"{name} {dtype} {n}"][r], err_msg=f"rank {r}")
        np.testing.assert_array_equal(got, _f32(emulated[r]), err_msg=f"rank {r}")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["all_gather", "all_to_all"])
def test_backend_and_one_shot_over_processes(runs, n, dtype, name):
    """``CommBackend('latte')`` (its table's variant) and the one-shot
    reference (gloo's own collective) over processes, against numpy."""
    data, res = runs[n]
    for r in range(n):
        if name == "all_gather":
            want = _rounded(data["coll_ag"], dtype)
        else:
            want = _rounded(data["coll_aa"], dtype)[:, r]
        np.testing.assert_array_equal(res[r][f"backend {name} {dtype}"], want)
        np.testing.assert_array_equal(res[r][f"reference_{name} {dtype}"], want)


def _reduction_oracle(data: dict, fn: str, dtype: str, n: int, rank: int):
    """numpy's sum over ranks of the (dtype-rounded) addends for what the
    ``core.collectives`` function ``fn`` returns on ``rank``, and its
    tolerance: f32 atol 1e-4; bf16,
    each of the n - 1 adds rounds to one bf16 ulp (2^-7 relative) of a
    partial no larger than sum_e |x_e|, so 2^-7 (n - 1) sum_e |x_e|."""
    x = _rounded(data["coll_aa"], dtype).astype(np.float64)
    total, scale = x.sum(0), np.abs(x).sum(0)
    if fn.endswith("reduce_scatter"):
        total, scale = total[rank], scale[rank]
    atol = 1e-4 if dtype == "float32" else 2.0 ** -7 * (n - 1) * scale
    return total, atol


def _within(got: np.ndarray, want: np.ndarray, atol, what: str) -> None:
    excess = np.abs(got - want) - atol
    assert (excess <= 0).all(), f"{what}: {int((excess > 0).sum())} elements out, by up to " \
        f"{excess.max()} (largest difference {np.abs(got - want).max()})"


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", [*REDUCTIONS, "backend reduce_scatter",
                                  "backend all_reduce", "rs kernel"])
def test_reductions_over_processes(runs, jax_ref, n, dtype, name):
    """Reduce-scatter and all-reduce with a ``ProcessRanks``, as the
    reference's are called inside shard_map (this rank's addends [n, *chunk]
    -> [*chunk] or [n, *chunk]): within the stated tolerance of numpy; the
    rings (the per-rank kernel's gloo schedule, the ring all-reduce, and
    ``CommBackend('latte')``, whose tables pick a ring) bit-equal to the
    emulated ``RankGroup`` rendering's row; in f32 within atol 1e-4 of the
    reference's shard_map function (C-ref1: the reference's own test of
    these checks nothing, so numpy is the oracle that counts)."""
    data, res = runs[n]
    xs = torch.from_numpy(data["coll_aa"]).to(DTYPES[dtype])
    ranks = coll.make_ranks(n, "cpu")
    fn = {"backend reduce_scatter": "ring_reduce_scatter", "backend all_reduce":
          "ring_all_reduce", "rs kernel": "ring_reduce_scatter"}.get(name, name)
    emulated = getattr(coll, fn)(xs, ranks)
    if name.startswith("backend"):
        be = CommBackend("latte", axis_devices=n, allow_stale_tables=True)
        assert be.choose(name[8:], be.message_bytes(name[8:], xs, ranks))[0].endswith("ring_rs")
        emulated = getattr(be, name[8:])(xs, ranks)
    for r in range(n):
        got = res[r][f"{name} {dtype}"]
        want, atol = _reduction_oracle(data, fn, dtype, n, r)
        assert got.shape == want.shape, (r, got.shape)
        _within(got, want, atol, f"rank {r} against numpy")
        if "reference" not in name:
            np.testing.assert_array_equal(got, _f32(emulated[r]), err_msg=f"rank {r}")
        else:
            _within(got, _f32(emulated[r]), atol, f"rank {r} against the emulated sum")
        if dtype == "float32" and name in REDUCTIONS:
            np.testing.assert_allclose(got, jax_ref[f"{name} {dtype} {n}"][r], rtol=0,
                                       atol=1e-4, err_msg=f"rank {r}")


@pytest.mark.parametrize("tag", sorted(CAPACITY))
def test_latte_moe_over_processes(runs, jax_ref, tag):
    """The latte MoE layer with one rank per process (8 gloo processes, each
    its 16 tokens and the full params): every rank's output and the pmean-ed
    aux bit-equal to the emulated layer on the same tokens and weights, and
    within ``test_torch_latte_moe.TOL`` of the reference's ``make_latte_moe``
    on 8 host devices."""
    data, res = runs[MOE_RANKS]
    x = torch.from_numpy(data["moe_x"])
    want, want_aux = latte_moe.make_latte_moe(_cfg(tag), coll.make_ranks(MOE_RANKS, "cpu"))(
        moe_params(data, tag), x)
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out[f"moe {tag}"][0], want[r].numpy(), err_msg=f"rank {r}")
        np.testing.assert_array_equal(out[f"moe aux {tag}"], want_aux.numpy())
        np.testing.assert_allclose(out[f"moe {tag}"][0], jax_ref[f"moe {tag}"][r], atol=TOL,
                                   rtol=TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(out[f"moe aux {tag}"], jax_ref[f"moe aux {tag}"], atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("n", SIZES)
def test_process_ranks_and_what_is_not_ported(runs, n):
    """Rank r of n on the CPU when asked; the card otherwise, which raises
    with no card; the reductions over processes, which raised before they
    were ported, now run on every rank; the latte MoE layer takes ranks that
    divide its 8 experts (8) and rejects those that do not (6), as the
    reference asserts; the CPU path launched no kernel."""
    _, res = runs[n]
    for r, out in enumerate(res):
        assert (out["rank"], out["n"], out["device"]) == (r, n, "cpu")
        assert out["cpu device"] == "cpu"
        assert "CUDA is not available" in out["default device"]
        assert out["launches"] == (0, 0, 0)
        for d in DTYPES:
            for name in (*REDUCTIONS, "backend reduce_scatter", "backend all_reduce"):
                assert np.isfinite(out[f"{name} {d}"]).all(), name
        assert out["moe ranks"] == ("accepted" if n == MOE_RANKS else "rejected")


def test_spawn_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        procgroup.spawn(rank_work, 2, args=({},))
    with pytest.raises(ValueError):
        procgroup.spawn(rank_work, 0, device="cpu", args=({},))


def fail_on_rank_one(ranks):
    if ranks.rank == 1:
        raise ValueError("rank one gives up")
    ranks.barrier()
    return ranks.rank


def test_a_rank_that_raises_fails_spawn():
    with pytest.raises(RuntimeError, match="rank1 failed first(.|\n)*rank one gives up"):
        procgroup.spawn(fail_on_rank_one, 3, device="cpu", timeout_s=TIMEOUT_S)


def test_per_rank_wrappers_reject():
    """The same checks as the emulated wrappers, before any exchange."""
    ranks = procgroup.ProcessRanks(4, 0, torch.device("cpu"), None)
    for bad, err in ((lambda: ag_ops.ring_all_gather_rank(torch.zeros(2, 3), ranks, "swap"),
                      ValueError),
                     (lambda: ag_ops.ring_all_gather_rank(torch.zeros(2, 3, 4), ranks),
                      ValueError),
                     (lambda: ag_ops.ring_all_gather_rank(torch.zeros(2, 3, dtype=torch.int32),
                                                          ranks), TypeError),
                     (lambda: aa_ops.all_to_all_rank(torch.zeros(3, 2, 5), ranks), ValueError),
                     (lambda: aa_ops.all_to_all_rank(torch.zeros(4, 2, 5), ranks, "bcst"),
                      ValueError),
                     (lambda: aa_ops.all_to_all_rank(torch.zeros(4, 2, 5, dtype=torch.float16),
                                                     ranks), TypeError)):
        with pytest.raises(err):
            bad()
    with pytest.raises(ValueError):
        ranks.ppermute(torch.zeros(2, device="meta"), [(0, 1)])


def test_launch_collectives_procs_validates_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.collectives", "--procs",
                        "--ranks", "4", "--device", "cpu", "--chunk", "2", "--width", "16"],
                       env=env, cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "all collectives validated against their oracles" in r.stdout
    assert "MISMATCH" not in r.stdout
    assert r.stdout.count(" OK") == 4 * (2 * (4 + 2) + 4)
    for name in ("reduce_scatter", "all_reduce"):
        assert r.stdout.count(f"CommBackend('latte').{name} ") == 4, name
