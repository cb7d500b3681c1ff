"""CommBackend: the paper's size-dispatched collective policy, over ranks
emulated on one device.  Counterpart of ``repro.core.backend.CommBackend``.

``CommBackend('latte')`` picks a rendering of each collective by message
size from a dispatch table; ``CommBackend('reference')`` always takes the
one-shot ``reference_*`` collectives.  The serving engine's KV-fetch path
consumes ``kv_fetch_plan``.

The tables are derived, as in the reference, by the port's copy of the DMA
timing model (``core/dma``) on a TPU v5e pod of ``axis_devices`` chips:
modeled TPU-pod thresholds, not H100 ones.  A derivation is memoized in the
process and on disk (``$REPRO_TORCH_DISPATCH_CACHE``, by default
``repro-torch-dma-dispatch`` under the temp directory); the bundled copy
``core/dma/_dispatch_tables.json`` is the reference's, keyed by the same
fingerprint, and serves cold starts.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import tempfile
import warnings

from . import collectives as coll
from .dma.dispatch import DispatchEntry, derive_dispatch
from .dma.topology import Topology, mi300x_cluster, tpu_v5e_multislice, tpu_v5e_pod

MB = 1024 * 1024
COLLECTIVES = ("all_gather", "all_to_all", "reduce_scatter", "all_reduce")

# The reference's table-cache version (repro/core/backend.py): part of the
# fingerprint, so the bundled copy hits exactly when the simulator, its
# calibration and the sweep are the reference's.
_TABLE_CACHE_VERSION = 7
# The size sweep behind every cached/bundled table; part of the cache key.
_SWEEP_SIZES = [2 ** i for i in range(10, 31)]
# Chunk granularities the table sweep offers the argmin; part of the cache key.
_SWEEP_CHUNKS = (None, 1 * MB)
_TABLE_CACHE_DIR = os.environ.get(
    "REPRO_TORCH_DISPATCH_CACHE",
    os.path.join(tempfile.gettempdir(), "repro-torch-dma-dispatch"))
_BUNDLED_TABLES = os.path.join(os.path.dirname(__file__), "dma", "_dispatch_tables.json")


def _table_key(topo: Topology, sizes: list[int]) -> str:
    # topo!r embeds the full Calibration and names no module, so the key is
    # the reference's for the same topology.
    return hashlib.sha1(
        f"v{_TABLE_CACHE_VERSION}|{topo!r}|{sizes!r}|{_SWEEP_CHUNKS!r}"
        .encode()).hexdigest()[:16]


def _table_cache_path(topo: Topology, sizes: list[int]) -> str:
    return os.path.join(_TABLE_CACHE_DIR, f"tables_{topo.name}_{_table_key(topo, sizes)}.json")


def _parse_tables(raw):
    return tuple(tuple(DispatchEntry(e["lo"], e["hi"], e["variant"], e.get("chunk"))
                       for e in tbl) for tbl in raw)


def _load_table_cache(topo: Topology, sizes: list[int]):
    """The bundled copy, else the disk cache, else None."""
    try:
        with open(_BUNDLED_TABLES) as f:
            raw = json.load(f).get(_table_key(topo, sizes))
        if raw is not None:
            return _parse_tables(raw)
    except (OSError, ValueError, KeyError):
        pass
    try:
        with open(_table_cache_path(topo, sizes)) as f:
            return _parse_tables(json.load(f))
    except (OSError, ValueError, KeyError):
        return None


def _serialize_tables(tables):
    return [[{"lo": e.lo, "hi": e.hi, "variant": e.variant, "chunk": e.chunk} for e in tbl]
            for tbl in tables]


def _store_table_cache(topo: Topology, sizes: list[int], tables) -> None:
    try:
        os.makedirs(_TABLE_CACHE_DIR, exist_ok=True)
        path = _table_cache_path(topo, sizes)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(_serialize_tables(tables), f)
        os.replace(tmp, path)
    except OSError:
        pass


def _derive_single_node(topo: Topology):
    """The (ag, aa, rs, ar) latte tables of one single-node topology, with
    the optimized/prelaunch command streams and the pipelined rings offered."""
    kw = dict(allow_pipelined=True, allow_optimized=True, chunk_sizes=_SWEEP_CHUNKS)
    return (tuple(derive_dispatch(topo, "all_gather", _SWEEP_SIZES, **kw)),
            tuple(derive_dispatch(topo, "all_to_all", _SWEEP_SIZES, **kw)),
            tuple(derive_dispatch(topo, "reduce_scatter", _SWEEP_SIZES, allow_reduce=True,
                                  **kw)),
            tuple(derive_dispatch(topo, "all_reduce", _SWEEP_SIZES, allow_reduce=True, **kw)))


@functools.lru_cache(maxsize=8)
def tpu_dispatch_tables(n_devices: int = 16):
    """``(ag, aa, rs, ar)`` dispatch entries for an n-device TPU v5e pod,
    from the bundled copy, the disk cache or the simulator's argmin sweep."""
    topo = tpu_v5e_pod(n_devices)
    cached = _load_table_cache(topo, _SWEEP_SIZES)
    if cached is not None:
        return cached
    tables = _derive_single_node(topo)
    _store_table_cache(topo, _SWEEP_SIZES, tables)
    return tables


#: Multi-node topologies the bundled tables cover: 4- and 16-slice TPU v5e
#: multislices and a 2-node MI300X RDMA cluster.
MULTINODE_TOPOS = {
    "tpu64": lambda: tpu_v5e_multislice(64),
    "tpu256": lambda: tpu_v5e_multislice(256),
    "mi300x-2node": lambda: mi300x_cluster(2),
}


def _derive_multinode(topo: Topology):
    """The (ag, rs, ar) tables of one multi-node topology (no all-to-all:
    it has no hierarchical rendering)."""
    kw = dict(allow_pipelined=True, allow_optimized=True, chunk_sizes=_SWEEP_CHUNKS)
    return (tuple(derive_dispatch(topo, "all_gather", _SWEEP_SIZES, **kw)),
            tuple(derive_dispatch(topo, "reduce_scatter", _SWEEP_SIZES, allow_reduce=True,
                                  **kw)),
            tuple(derive_dispatch(topo, "all_reduce", _SWEEP_SIZES, allow_reduce=True, **kw)))


@functools.lru_cache(maxsize=8)
def multinode_dispatch_tables(spec: str = "tpu64"):
    """``(ag, rs, ar)`` hierarchical dispatch entries for a
    :data:`MULTINODE_TOPOS` spec, with the cache discipline of
    :func:`tpu_dispatch_tables`."""
    topo = MULTINODE_TOPOS[spec]()
    cached = _load_table_cache(topo, _SWEEP_SIZES)
    if cached is not None:
        return cached
    tables = _derive_multinode(topo)
    _store_table_cache(topo, _SWEEP_SIZES, tables)
    return tables


class StaleTablesWarning(UserWarning):
    """The bundled dispatch tables do not carry this simulator's fingerprint.

    The backend still dispatches on correct tables (it derives them, once
    per process and device count), but the bundled copy is stale: it is the
    reference's ``_dispatch_tables.json``, to be copied again after the
    reference regenerates it.  ``CommBackend(allow_stale_tables=True)``
    acknowledges and silences the warning.
    """


@functools.lru_cache(maxsize=32)
def _bundled_current(topo: Topology, sizes: tuple[int, ...]) -> bool:
    """True when the bundled tables carry this topology's fingerprint."""
    try:
        with open(_BUNDLED_TABLES) as f:
            return _table_key(topo, list(sizes)) in json.load(f)
    except (OSError, ValueError):
        return False


def _pick(entries, size: int) -> str:
    for e in entries:
        if size >= e.lo and (e.hi is None or size < e.hi):
            return e.variant
    return entries[-1].variant


# Winning variant names -> renderings, as in the reference's maps.
_AG_IMPL = {
    "pcpy": coll.reference_all_gather,
    "b2b": coll.ring_all_gather,
    "bcst": coll.bidir_ring_all_gather,
    "ring": coll.ring_all_gather,
    "bidir_ring": coll.bidir_ring_all_gather,
    "pipe_b2b": coll.ring_all_gather,
    "pipe_bidir_ring": coll.bidir_ring_all_gather,
    "hier_ring": coll.ring_all_gather,
    "hier_pipe": coll.ring_all_gather,
}
_AA_IMPL = {
    "pcpy": coll.reference_all_to_all,
    "b2b": coll.pairwise_all_to_all,
    "swap": coll.pairwise_all_to_all,
    "ring": coll.pairwise_all_to_all,
    "pipe_b2b": coll.pairwise_all_to_all,
}
_RS_IMPL = {v: coll.ring_reduce_scatter for v in (
    "ring_rs", "bidir_ring_rs", "pipe_ring_rs", "pipe_bidir_ring_rs", "hier_ring_rs",
    "hier_pipe_rs")}
_AR_IMPL = {v: coll.ring_all_reduce for v in _RS_IMPL}
_IMPL = {"all_gather": (_AG_IMPL, coll.reference_all_gather),
         "all_to_all": (_AA_IMPL, coll.reference_all_to_all),
         "reduce_scatter": (_RS_IMPL, coll.reference_reduce_scatter),
         "all_reduce": (_AR_IMPL, coll.reference_all_reduce)}


@dataclasses.dataclass(frozen=True)
class CommBackend:
    kind: str = "latte"                  # latte | reference
    axis_devices: int = 16
    b2b_fanout_threshold: int = 4 * MB   # paper §5.3.1 empirical threshold
    # Dispatching on a topology whose fingerprint the bundled tables lack
    # warns (StaleTablesWarning) unless acknowledged here.
    allow_stale_tables: bool = False

    def _strip(self, v: str) -> str:
        # opt_/prelaunch_ change the command stream's scheduling envelope,
        # not which rendering implements the winner.
        for prefix in ("opt_", "prelaunch_"):
            if v.startswith(prefix):
                v = v[len(prefix):]
        return v

    def _tables(self, collective: str):
        topo = tpu_v5e_pod(self.axis_devices)
        if not self.allow_stale_tables and not _bundled_current(topo, tuple(_SWEEP_SIZES)):
            warnings.warn(
                f"CommBackend('latte').{collective}: the bundled dispatch tables do not "
                f"match this simulator/calibration fingerprint (v{_TABLE_CACHE_VERSION}, "
                f"{topo.name}); deriving them; pass allow_stale_tables=True to acknowledge",
                StaleTablesWarning, stacklevel=4)
        return tpu_dispatch_tables(self.axis_devices)

    def message_bytes(self, collective: str, xs) -> int:
        """The size the table is read at, as the reference computes it from
        one rank's operand: an all-gather counts the gathered bytes
        (shard x axis_devices), the others the operand's bytes."""
        size = xs[0].numel() * xs.element_size()
        return size * self.axis_devices if collective == "all_gather" else size

    def choose(self, collective: str, size: int) -> tuple[str, object]:
        """(stripped winning variant, rendering) for a message of ``size``
        bytes; the reference backend always takes the one-shot rendering."""
        impl, ref = _IMPL[collective]
        if self.kind == "reference":
            return "reference", ref
        table = self._tables(collective)[COLLECTIVES.index(collective)]
        variant = self._strip(_pick(table, size))
        return variant, impl.get(variant, ref)

    def _run(self, collective: str, xs, ranks):
        return self.choose(collective, self.message_bytes(collective, xs))[1](xs, ranks)

    def all_gather(self, xs, ranks):
        """xs [n, *shard] -> [n, n, *shard] (every rank's gathered copy)."""
        return self._run("all_gather", xs, ranks)

    def all_to_all(self, xs, ranks):
        """xs [n, n, *chunk] -> out[i, j] = xs[j, i]."""
        return self._run("all_to_all", xs, ranks)

    def reduce_scatter(self, xs, ranks):
        """xs [n, n, *chunk] addends -> [n, *chunk], row i = sum_e xs[e, i]."""
        return self._run("reduce_scatter", xs, ranks)

    def all_reduce(self, xs, ranks):
        """xs [n, n, *chunk] -> [n, n, *chunk], every rank's copy of the sum."""
        return self._run("all_reduce", xs, ranks)

    def kv_fetch_plan(self, n_blocks: int, block_bytes: int) -> dict:
        """How the serving engine should fetch dispersed KV blocks (§5.3).

        The latte plan additionally requests the optimized command stream
        (``optimized: True``); the serving engine maps it to the ``opt_b2b``
        fetch backend.
        """
        total = n_blocks * block_bytes
        if self.kind == "reference":
            return {"mode": "pcpy", "fanout": min(n_blocks, 16), "optimized": False}
        if total < self.b2b_fanout_threshold:
            return {"mode": "b2b", "fanout": 1, "optimized": True}
        return {"mode": "b2b", "fanout": 4, "optimized": True}
