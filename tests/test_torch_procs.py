"""The collectives with one rank per process, on the CPU over gloo.

``core.procgroup.spawn`` starts one gloo group per world size (8, the
reference's test mesh, and 6, for the all-to-all's rotation pairing); each
process runs every B3 / B4 variant per rank (``ops.ring_all_gather_rank``,
``ops.all_to_all_rank``: on the CPU their ring and pairing schedules step
by step over gloo ``send``/``recv``) and the ``core.collectives`` functions
with a ``ProcessRanks``, on inputs made with numpy from a seed, in f32 and
bf16.  Each case below reads its rank's results from that one run and
holds them bit-equal to the numpy oracle, to the emulated ``RankGroup``
rendering on the same inputs, and to the reference's ``shard_map``
functions (one JAX subprocess with 8 host devices, no Pallas interpret).
The card's cases are in ``tests/test_torch_gpu.py``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import REPO, run_subprocess  # noqa: E402

from repro_torch.core import collectives as coll  # noqa: E402
from repro_torch.core import procgroup  # noqa: E402
from repro_torch.core.backend import CommBackend  # noqa: E402
from repro_torch.kernels.ring_all_gather import ops as ag_ops  # noqa: E402
from repro_torch.kernels.ring_all_to_all import ops as aa_ops  # noqa: E402

SIZES = (8, 6)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TIMEOUT_S = 240


def inputs(n: int) -> dict:
    """Rank j's shard is ag[j] / coll_ag[j]; rank j's chunk for rank i is
    aa[j, i] / coll_aa[j, i]."""
    rng = np.random.default_rng(n)
    return {"ag": rng.normal(size=(n, 3, 40)).astype(np.float32),
            "aa": rng.normal(size=(n, n, 2, 24)).astype(np.float32),
            "coll_ag": rng.normal(size=(n, 4, 32)).astype(np.float32),
            "coll_aa": rng.normal(size=(n, n, 2, 16)).astype(np.float32)}


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
    for fn in (be.reduce_scatter, be.all_reduce, coll.ring_reduce_scatter):
        try:
            fn(torch.from_numpy(data["coll_aa"][my]), ranks)
            out[f"not ported {fn.__name__}"] = "ran"
        except NotImplementedError as e:
            out[f"not ported {fn.__name__}"] = str(e)
    out["launches"] = (ag_ops.launches_rank, aa_ops.launches_rank)
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
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.core import collectives as coll

res = {}
for n in (8, 6):
    data = np.load(IN.format(n))
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    for d, jd in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        for name, key in (("ring_all_gather", "coll_ag"), ("bidir_ring_all_gather", "coll_ag"),
                          ("pairwise_all_to_all", "coll_aa")):
            x = jnp.asarray(data[key]).astype(jd)
            spec = P("x", *[None] * (x.ndim - 1))
            fn = getattr(coll, name)
            f = shard_map(lambda a, fn=fn: fn(a[0], "x")[None], mesh=mesh, in_specs=spec,
                          out_specs=P("x", None, None, None), check_vma=False)
            res[f"{name} {d} {n}"] = np.asarray(jax.jit(f)(x).astype(jnp.float32))
np.savez(OUT, **res)
print("JAX_SIDE_OK")
"""


@pytest.fixture(scope="module")
def jax_ref(runs, tmp_path_factory):
    """The reference's shard_map collectives on the same inputs: row i is
    device i's result."""
    d = tmp_path_factory.mktemp("jax_procs")
    for n, (data, _) in runs.items():
        np.savez(d / f"in{n}.npz", **data)
    path = d / "ref.npz"
    code = f"IN = {str(d / 'in{}.npz')!r}\nOUT = {str(path)!r}\n" + JAX_SIDE
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


@pytest.mark.parametrize("n", SIZES)
def test_process_ranks_and_what_is_not_ported(runs, n):
    """Rank r of n on the CPU when asked; the card otherwise, which raises
    with no card; reductions over processes raise, naming ROADMAP; the CPU
    path launched no kernel."""
    _, res = runs[n]
    for r, out in enumerate(res):
        assert (out["rank"], out["n"], out["device"]) == (r, n, "cpu")
        assert out["cpu device"] == "cpu"
        assert "CUDA is not available" in out["default device"]
        assert out["launches"] == (0, 0)
        for fn in ("reduce_scatter", "all_reduce", "ring_reduce_scatter"):
            assert "ROADMAP 10c" in out[f"not ported {fn}"], fn


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
    assert r.stdout.count(" OK") == 4 * (2 * (4 + 2) + 2)
