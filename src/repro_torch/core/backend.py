"""CommBackend: the paper's size-dispatched collective policy, over ranks
emulated on one device.  Counterpart of ``repro.core.backend.CommBackend``.

``CommBackend('latte')`` picks a rendering of each collective by message
size from a dispatch table; ``CommBackend('reference')`` always takes the
one-shot ``reference_*`` collectives.  The serving engine's KV-fetch path
consumes ``kv_fetch_plan``.

The tables are the reference's ``tpu_dispatch_tables(n)`` for n = 8 and 16
(``repro/core/backend.py``), copied into ``dispatch_tables.json``: the
reference derives them from its DMA timing model of a TPU v5e pod, which the
port does not have yet.  They are modeled TPU-pod thresholds, not H100 ones;
an H100 table needs the simulator and a measured H100 topology in the port.
Any other ``axis_devices`` raises.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from pathlib import Path

from . import collectives as coll

MB = 1024 * 1024
TABLES_FILE = Path(__file__).resolve().parent / "dispatch_tables.json"
COLLECTIVES = ("all_gather", "all_to_all", "reduce_scatter", "all_reduce")


@dataclasses.dataclass(frozen=True)
class DispatchEntry:
    """Sizes in [lo, hi) bytes (hi None: no upper end) go to ``variant``."""
    lo: int
    hi: int | None
    variant: str
    chunk: int | None = None


@functools.cache
def tpu_dispatch_tables(n_devices: int = 16) -> tuple[tuple[DispatchEntry, ...], ...]:
    """The reference's ``(ag, aa, rs, ar)`` tables for an n-device TPU pod."""
    tables = json.loads(TABLES_FILE.read_text())["tables"]
    if str(n_devices) not in tables:
        raise ValueError(f"no dispatch tables for {n_devices} devices; the port ships "
                         f"the reference's tables for {sorted(tables, key=int)}")
    raw = tables[str(n_devices)]
    return tuple(tuple(DispatchEntry(**e) for e in raw[name]) for name in COLLECTIVES)


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

    def _strip(self, v: str) -> str:
        # opt_/prelaunch_ change the command stream's scheduling envelope,
        # not which rendering implements the winner.
        for prefix in ("opt_", "prelaunch_"):
            if v.startswith(prefix):
                v = v[len(prefix):]
        return v

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
        table = tpu_dispatch_tables(self.axis_devices)[COLLECTIVES.index(collective)]
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
