"""Communication backend: the KV-fetch plan of the serving engine.

Counterpart of ``repro.core.backend.CommBackend`` reduced to what the
serving slice uses, ``kv_fetch_plan``.  The collectives and their dispatch
tables come with the collectives slice of the port.
"""
from __future__ import annotations

import dataclasses

MB = 1024 * 1024


@dataclasses.dataclass(frozen=True)
class CommBackend:
    kind: str = "latte"                  # latte | reference
    b2b_fanout_threshold: int = 4 * MB   # paper §5.3.1 empirical threshold

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
