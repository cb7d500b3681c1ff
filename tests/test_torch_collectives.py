"""The port's collectives slice against the JAX reference, on the CPU.

The JAX side runs once per module in a subprocess with 8 emulated devices
(``conftest.run_subprocess``): the Pallas remote-DMA kernels B3 and B4 in
TPU interpret mode on the inputs of ``tests/test_kernels.py::DIST_TEST``
(plus n = 6 for the all-to-all's rotation pairing), and every function of
``repro.core.collectives`` and ``CommBackend`` under ``shard_map`` on the
inputs of ``tests/test_collectives.py::LATTE_TEST``.  Inputs are made with
numpy from a seed and saved with the outputs; bf16 inputs are rounded from
the same float32 values by each framework (both round to nearest even).

On the CPU the port's kernel wrappers take their plain versions and the
collectives run their own step schedules.  Data movement is bit-equal in
f32 and bf16; the ring reduce-scatter adds in the reference's order, so it
is bit-equal too, and the one-shot sums are compared at atol 1e-4 (f32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_subprocess  # noqa: E402

from repro.core import backend as jax_backend  # noqa: E402
from repro_torch.core import backend, collectives as coll  # noqa: E402
from repro_torch.kernels.ring_all_gather import ops as ag_ops  # noqa: E402
from repro_torch.kernels.ring_all_to_all import ops as aa_ops  # noqa: E402

N = 8
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

JAX_SIDE = r"""
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.core import collectives as coll
from repro.core.backend import CommBackend
from repro.kernels.ring_all_gather.ops import ring_all_gather
from repro.kernels.ring_all_to_all.ops import pallas_all_to_all

N = 8
DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
rng = np.random.default_rng(0)
res = {}
mesh = lambda n: Mesh(np.array(jax.devices()[:n]), ("x",))
f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))

def smap(fn, arr, in_rank, out_spec):
    f = shard_map(fn, mesh=mesh(N), in_specs=P("x", *[None] * (in_rank - 1)),
                  out_specs=out_spec, check_vma=False)
    return f32(jax.jit(f)(arr))

for d, jd in DT.items():
    # B3 / B4 (DIST_TEST inputs)
    x = rng.normal(size=(N * 4, 128)).astype(np.float32)
    res[f"ag_in_{d}"] = x
    for v in ("pcpy", "b2b", "bcst", "bcst_b2b"):
        res[f"ag_{v}_{d}"] = f32(ring_all_gather(jnp.asarray(x).astype(jd), mesh(N), "x",
                                                 variant=v, interpret=True))
    for n in (8, 6):
        xa = rng.normal(size=(n, n, 2, 128)).astype(np.float32)
        res[f"aa_in_{n}_{d}"] = xa
        for v in ("per_round", "b2b"):
            res[f"aa_{v}_{n}_{d}"] = f32(pallas_all_to_all(jnp.asarray(xa).astype(jd), mesh(n),
                                                           "x", variant=v, interpret=True))

    # core/collectives.py under shard_map (LATTE_TEST inputs and specs; the
    # reduce-scatter gets a rank-3 out_specs for its rank-3 result)
    xg = rng.normal(size=(N, 4, 32)).astype(np.float32)
    xc = rng.normal(size=(N, N, 2, 16)).astype(np.float32)
    res[f"coll_ag_in_{d}"], res[f"coll_aa_in_{d}"] = xg, xc
    xg, xc = jnp.asarray(xg).astype(jd), jnp.asarray(xc).astype(jd)
    rep3 = P(None, None, None)
    sh3, sh4 = P("x", None, None), P("x", None, None, None)
    be = CommBackend("latte", axis_devices=N, allow_stale_tables=True)
    ag = {"ring_all_gather": coll.ring_all_gather,
          "bidir_ring_all_gather": coll.bidir_ring_all_gather,
          "reference_all_gather": coll.reference_all_gather, "backend_all_gather": be.all_gather}
    for name, fn in ag.items():
        res[f"{name}_{d}"] = smap(lambda a, fn=fn: fn(a[0], "x"), xg, 3, rep3)
    aa = {"pairwise_all_to_all": (coll.pairwise_all_to_all, sh4),
          "reference_all_to_all": (coll.reference_all_to_all, sh4),
          "ring_reduce_scatter": (coll.ring_reduce_scatter, sh3),
          "reference_reduce_scatter": (coll.reference_reduce_scatter, sh3),
          "ring_all_reduce": (coll.ring_all_reduce, rep3),
          "reference_all_reduce": (coll.reference_all_reduce, rep3),
          "backend_all_to_all": (be.all_to_all, sh4),
          "backend_reduce_scatter": (be.reduce_scatter, sh3),
          "backend_all_reduce": (be.all_reduce, rep3)}
    for name, (fn, spec) in aa.items():
        lift = (lambda a, fn=fn: fn(a[0], "x")) if spec is rep3 else \
            (lambda a, fn=fn: fn(a[0], "x")[None])
        res[f"{name}_{d}"] = smap(lift, xc, 4, spec)
np.savez(OUT, **res)
print("JAX_SIDE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX side's inputs and outputs, computed once for the module."""
    path = str(tmp_path_factory.mktemp("jax_collectives") / "ref.npz")
    out = run_subprocess(f"OUT = {path!r}\n" + JAX_SIDE, n_devices=N)
    assert "JAX_SIDE_OK" in out
    return dict(np.load(path))


@pytest.fixture
def no_launches(monkeypatch):
    monkeypatch.setattr(ag_ops, "launches", 0)
    monkeypatch.setattr(aa_ops, "launches", 0)
    yield
    assert ag_ops.launches == 0 and aa_ops.launches == 0


def _t(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(a).to(DTYPES[dtype])


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _each_rank_equals(got: torch.Tensor, want: np.ndarray) -> None:
    """The port returns one copy per rank of a replicated result."""
    assert got.shape[0] == N
    for r in range(N):
        np.testing.assert_array_equal(_np(got[r]), want, err_msg=f"rank {r}")


# ------------------------------------------------------------------ B3/B4 ----
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("variant", sorted(ag_ops.VARIANTS))
def test_ring_all_gather_matches_pallas(ref, dtype, variant, no_launches):
    x = _t(ref[f"ag_in_{dtype}"], dtype).reshape(N, 4, 128)
    got = ag_ops.ring_all_gather(x, variant)
    assert got.dtype == x.dtype and got.shape == (N, N * 4, 128)
    _each_rank_equals(got, ref[f"ag_{variant}_{dtype}"])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [8, 6])
@pytest.mark.parametrize("variant", sorted(aa_ops.VARIANTS))
def test_all_to_all_matches_pallas(ref, dtype, n, variant, no_launches):
    xa = _t(ref[f"aa_in_{n}_{dtype}"], dtype)
    got = aa_ops.all_to_all(xa, variant)
    assert got.dtype == xa.dtype and got.shape == xa.shape
    np.testing.assert_array_equal(_np(got), ref[f"aa_{variant}_{n}_{dtype}"])


@pytest.mark.parametrize("bad, err", [
    (lambda: ag_ops.ring_all_gather(torch.zeros(2, 3, 4), "swap"), ValueError),
    (lambda: ag_ops.ring_all_gather(torch.zeros(2, 12), "b2b"), ValueError),
    (lambda: ag_ops.ring_all_gather(torch.zeros(2, 3, 4, dtype=torch.int32)), TypeError),
    (lambda: aa_ops.all_to_all(torch.zeros(2, 3, 4, 5)), ValueError),
    (lambda: aa_ops.all_to_all(torch.zeros(2, 2, 4, 5), "bcst"), ValueError),
    (lambda: aa_ops.all_to_all(torch.zeros(2, 2, 4, 5, dtype=torch.float16)), TypeError),
])
def test_rank_kernel_wrappers_reject(bad, err, no_launches):
    with pytest.raises(err):
        bad()


# ---------------------------------------------------------- collectives ----
AG_FUNCS = ("ring_all_gather", "bidir_ring_all_gather", "reference_all_gather")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", AG_FUNCS)
def test_all_gathers_match_shard_map(ref, dtype, name, no_launches):
    ranks = coll.make_ranks(N, "cpu")
    got = getattr(coll, name)(_t(ref[f"coll_ag_in_{dtype}"], dtype), ranks)
    assert got.shape == (N, N, 4, 32)
    _each_rank_equals(got, ref[f"{name}_{dtype}"])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["pairwise_all_to_all", "reference_all_to_all",
                                  "ring_reduce_scatter"])
def test_chunk_collectives_match_shard_map(ref, dtype, name, no_launches):
    ranks = coll.make_ranks(N, "cpu")
    got = getattr(coll, name)(_t(ref[f"coll_aa_in_{dtype}"], dtype), ranks)
    np.testing.assert_array_equal(_np(got), ref[f"{name}_{dtype}"])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ring_all_reduce_matches_shard_map(ref, dtype, no_launches):
    ranks = coll.make_ranks(N, "cpu")
    got = coll.ring_all_reduce(_t(ref[f"coll_aa_in_{dtype}"], dtype), ranks)
    _each_rank_equals(got, ref[f"ring_all_reduce_{dtype}"])


@pytest.mark.parametrize("name", ["ring_reduce_scatter", "reference_reduce_scatter",
                                  "ring_all_reduce", "reference_all_reduce"])
def test_reductions_match_numpy_and_shard_map(ref, name, no_launches):
    """float32 sums against numpy's sum over ranks and against JAX (atol 1e-4:
    the one-shot sums add in another order)."""
    ranks = coll.make_ranks(N, "cpu")
    xc = ref["coll_aa_in_float32"]
    got = _np(getattr(coll, name)(torch.from_numpy(xc), ranks))
    want = xc.sum(axis=0)
    if name.endswith("all_reduce"):
        assert got.shape == (N,) + want.shape
        want = np.broadcast_to(want, got.shape)
        np.testing.assert_allclose(got, np.broadcast_to(ref[f"{name}_float32"], got.shape),
                                   atol=1e-4)
    else:
        np.testing.assert_allclose(got, ref[f"{name}_float32"], atol=1e-4)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 6, 8])
def test_schedules_against_numpy_any_rank_count(n, no_launches):
    """Every rendering at rank counts the reference tests do not reach."""
    rng = np.random.default_rng(n)
    ranks = coll.make_ranks(n, "cpu")
    shard = rng.normal(size=(n, 3, 5)).astype(np.float32)
    chunks = rng.normal(size=(n, n, 2, 3)).astype(np.float32)
    for fn in (coll.ring_all_gather, coll.bidir_ring_all_gather, coll.reference_all_gather):
        got = _np(fn(torch.from_numpy(shard), ranks))
        for r in range(n):
            np.testing.assert_array_equal(got[r], shard)
    for fn in (coll.pairwise_all_to_all, coll.reference_all_to_all):
        np.testing.assert_array_equal(_np(fn(torch.from_numpy(chunks), ranks)),
                                      np.swapaxes(chunks, 0, 1))
    np.testing.assert_allclose(_np(coll.ring_reduce_scatter(torch.from_numpy(chunks), ranks)),
                               chunks.sum(0), atol=1e-5)


def test_rank_group_checks_and_ppermute():
    ranks = coll.make_ranks(4, "cpu")
    with pytest.raises(ValueError):
        coll.ring_all_gather(torch.zeros(3, 2), ranks)
    with pytest.raises(ValueError):
        coll.pairwise_all_to_all(torch.zeros(4, 3, 2), ranks)
    with pytest.raises(ValueError):
        coll.make_ranks(0, "cpu")
    x = torch.arange(4.0)[:, None]
    out = ranks.ppermute(x, [(0, 1), (1, 2)])              # ranks 0 and 3 receive nothing
    assert out.flatten().tolist() == [0.0, 0.0, 1.0, 0.0]


def test_make_ranks_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        coll.make_ranks(8)


# -------------------------------------------------------------- backend ----
def _entries(tables):
    return [[(e.lo, e.hi, e.variant, e.chunk) for e in t] for t in tables]


@pytest.fixture
def fresh_tables(tmp_path, monkeypatch):
    """The port's tables with no memo and an empty disk cache, so each
    call derives them with the port's own simulator (or hits the bundled
    copy)."""
    monkeypatch.setattr(backend, "_TABLE_CACHE_DIR", str(tmp_path))
    backend.tpu_dispatch_tables.cache_clear()
    yield tmp_path
    backend.tpu_dispatch_tables.cache_clear()


@pytest.mark.parametrize("n", [4, 8, 16])
def test_dispatch_tables_equal_the_reference(n, fresh_tables):
    """Derived by the port's simulator for n = 4 and 8 (the bundled copy
    holds 16 only), and bundled for 16, equal to the reference's."""
    from repro_torch.core.dma.topology import tpu_v5e_pod
    got = backend.tpu_dispatch_tables(n)
    assert _entries(got) == _entries(jax_backend.tpu_dispatch_tables(n))
    derived = list(fresh_tables.iterdir())
    assert len(derived) == (0 if n == 16 else 1)
    assert backend._bundled_current(tpu_v5e_pod(n), tuple(backend._SWEEP_SIZES)) == (n == 16)


def test_bundled_tables_hit_for_16_without_warning(fresh_tables):
    """The port's fingerprint of tpu_v5e_pod(16) is the reference's, so the
    bundled copy serves it and no StaleTablesWarning is raised; a count the
    bundled copy lacks warns unless acknowledged."""
    import warnings
    from repro.core.dma.topology import tpu_v5e_pod as jax_pod
    from repro_torch.core.dma.topology import tpu_v5e_pod
    assert backend._table_key(tpu_v5e_pod(16), backend._SWEEP_SIZES) == \
        jax_backend._table_key(jax_pod(16), jax_backend._SWEEP_SIZES)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert backend.CommBackend("latte", axis_devices=16).choose(
            "all_gather", 1 << 20)[0] == "pipe_bidir_ring"
        backend.CommBackend("latte", axis_devices=4, allow_stale_tables=True).choose(
            "all_to_all", 1 << 16)
    with pytest.warns(backend.StaleTablesWarning):
        backend.CommBackend("latte", axis_devices=4).choose("all_to_all", 1 << 16)
    assert list(fresh_tables.iterdir())          # 4 was derived and cached


def test_dispatch_tables_refuse_other_device_counts(fresh_tables):
    """No device count is refused any more: 6, which the old bundled JSON of
    8 and 16 lacked, gives the reference's tables, as its tpu_v5e_pod(n)
    accepts any n."""
    assert _entries(backend.tpu_dispatch_tables(6)) == \
        _entries(jax_backend.tpu_dispatch_tables(6))
    be = backend.CommBackend("latte", axis_devices=6, allow_stale_tables=True)
    ref_be = jax_backend.CommBackend("latte", axis_devices=6, allow_stale_tables=True)
    for collective in backend.COLLECTIVES:
        table = jax_backend.tpu_dispatch_tables(6)[backend.COLLECTIVES.index(collective)]
        assert be.choose(collective, 1 << 20)[0] == ref_be._strip(jax_backend._pick(table, 1 << 20))


def test_multinode_tables_equal_the_reference():
    """The bundled hierarchical tables, looked up by the port's fingerprint."""
    for spec in backend.MULTINODE_TOPOS:
        assert _entries(backend.multinode_dispatch_tables(spec)) == \
            _entries(jax_backend.multinode_dispatch_tables(spec))


SIZES = sorted({2 ** i for i in range(0, 33)} | {3 * 2 ** i for i in range(8, 30, 3)}
               | {524287, 524289, 67108863, 67108865})


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("collective", backend.COLLECTIVES)
def test_backend_picks_the_reference_variant(n, collective):
    """At every size the port's choice is the reference's stripped winner
    and the rendering of the same name."""
    table = jax_backend.tpu_dispatch_tables(n)[backend.COLLECTIVES.index(collective)]
    ref_be = jax_backend.CommBackend("latte", axis_devices=n, allow_stale_tables=True)
    ref_impl = {"all_gather": (jax_backend._AG_IMPL, "reference_all_gather"),
                "all_to_all": (jax_backend._AA_IMPL, "reference_all_to_all"),
                "reduce_scatter": (jax_backend._RS_IMPL, "reference_reduce_scatter"),
                "all_reduce": (jax_backend._AR_IMPL, "reference_all_reduce")}[collective]
    be = backend.CommBackend("latte", axis_devices=n, allow_stale_tables=True)
    for size in SIZES:
        want = ref_be._strip(jax_backend._pick(table, size))
        got, fn = be.choose(collective, size)
        assert got == want, size
        want_fn = ref_impl[0].get(want)
        assert fn.__name__ == (want_fn.__name__ if want_fn else ref_impl[1]), size


def test_backend_message_bytes_follow_the_reference():
    """AG counts the gathered bytes (shard x axis_devices), the rest the
    operand of one rank."""
    be = backend.CommBackend("latte", axis_devices=8)
    shard = torch.zeros(8, 4, 32)
    chunks = torch.zeros(8, 8, 2, 16, dtype=torch.bfloat16)
    assert be.message_bytes("all_gather", shard) == 4 * 32 * 4 * 8
    for name in ("all_to_all", "reduce_scatter", "all_reduce"):
        assert be.message_bytes(name, chunks) == 8 * 2 * 16 * 2


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("collective", backend.COLLECTIVES)
def test_backend_collectives_match_shard_map(ref, dtype, collective, no_launches):
    ranks = coll.make_ranks(N, "cpu")
    be = backend.CommBackend("latte", axis_devices=N, allow_stale_tables=True)
    key = "coll_ag_in" if collective == "all_gather" else "coll_aa_in"
    got = getattr(be, collective)(_t(ref[f"{key}_{dtype}"], dtype), ranks)
    want = ref[f"backend_{collective}_{dtype}"]
    if collective in ("all_gather", "all_reduce"):
        _each_rank_equals(got, want)
    else:
        np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("collective", backend.COLLECTIVES)
def test_reference_backend_takes_the_one_shot(ref, collective, no_launches):
    ranks = coll.make_ranks(N, "cpu")
    be = backend.CommBackend("reference", axis_devices=N)
    assert be.choose(collective, 1 << 20)[0] == "reference"
    key = "coll_ag_in" if collective == "all_gather" else "coll_aa_in"
    xs = torch.from_numpy(ref[f"{key}_float32"])
    want = getattr(coll, f"reference_{collective}")(xs, ranks)
    assert torch.equal(getattr(be, collective)(xs, ranks), want)


def test_backend_keeps_the_fetch_plan():
    assert backend.CommBackend(axis_devices=8).kv_fetch_plan(16, 16 * 1024) == \
        {"mode": "b2b", "fanout": 1, "optimized": True}


def test_launcher_on_cpu(capsys, monkeypatch):
    """``python -m repro_torch.launch.collectives --device cpu`` validates
    every variant and names the backend's choices."""
    from repro_torch.launch import collectives as launcher
    monkeypatch.setattr("sys.argv", ["collectives", "--device", "cpu", "--chunk", "2",
                                     "--width", "8"])
    launcher.main()
    out = capsys.readouterr().out
    assert "MISMATCH" not in out and "all collectives validated" in out
    assert "pipe_bidir_ring" in out and "-> swap" in out
