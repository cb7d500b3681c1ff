"""Latte collectives over ranks emulated on one device, plus the reference
(one-shot) backend.  Counterpart of ``repro.core.collectives``.

The reference calls each collective inside ``shard_map`` with one device's
shard.  The port runs the n ranks on one device instead: a collective takes
a **rank-stacked** tensor ``xs`` whose dim 0 is the rank (the global view of
``shard_map(in_specs=P(axis, ...))``) and a :class:`RankGroup`, the
counterpart of the reference's mesh axis.  Where the reference's result is
replicated (``out_specs=P(None, ...)``), the port returns one copy per rank,
``[n, ...]``.

Renderings, and what each runs on the device of ``xs``:

* ``ring_all_gather``: CPU, n-1 ``ppermute`` steps; CUDA, B3 ``b2b``.
* ``bidir_ring_all_gather``: CPU, ceil((n-1)/2) steps in both directions;
  CUDA, B3 ``bcst_b2b``.
* ``pairwise_all_to_all``: CPU, n-1 rounds with the XOR partner (rotation
  when n is not a power of two); CUDA, B4 ``b2b``.
* ``ring_reduce_scatter``: n-1 shift-and-add steps on every device (the
  reference has no kernel for it).
* ``ring_all_reduce``: the reduce-scatter, then ``ring_all_gather``.

On the CPU each rendering runs its own schedule, step by step, so the CPU
tests check the same indices as the reference's ``ppermute`` renderings; on
CUDA the whole collective is one launch of the hand-written kernel, whose
schedule is the same ring or pairing.  The ``reference_*`` functions are one
PyTorch call each, the counterpart of XLA's one-shot collectives (the
reference backend of ``CommBackend``), not the kernels' plain versions.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.compat import resolve_device
from repro_torch.kernels.ring_all_gather import ops as ag_ops
from repro_torch.kernels.ring_all_to_all import ops as aa_ops


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """n ranks emulated on one device: the counterpart of the reference's
    ``make_mesh((n,), (axis,))`` + ``shard_map`` + ``axis_size``."""
    n: int
    device: torch.device

    def check(self, xs: torch.Tensor, lead: int = 1) -> None:
        """Raise unless the first ``lead`` dims of ``xs`` are this group's
        ranks and ``xs`` lies on its device."""
        if xs.dim() < lead or tuple(xs.shape[:lead]) != (self.n,) * lead:
            raise ValueError(f"expected {lead} leading rank dim(s) of size {self.n}, "
                             f"got {tuple(xs.shape)}")
        if xs.device != self.device:
            raise ValueError(f"tensor on {xs.device}, ranks on {self.device}")

    def ppermute(self, xs: torch.Tensor, perm) -> torch.Tensor:
        """``jax.lax.ppermute`` over the rank dim: out[dst] = xs[src] for
        each (src, dst) pair; ranks that receive nothing get zeros."""
        out = torch.zeros_like(xs)
        src = torch.tensor([s for s, _ in perm], device=xs.device)
        dst = torch.tensor([d for _, d in perm], device=xs.device)
        out[dst] = xs[src]
        return out


def make_ranks(n: int, device="cuda") -> RankGroup:
    """n emulated ranks on ``device`` (the card unless ``device="cpu"``)."""
    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return RankGroup(n, dev)


def _flat_shards(xs: torch.Tensor, lead: int) -> torch.Tensor:
    """[lead rank dims..., *shard] -> [lead rank dims..., 1, numel(shard)]."""
    return xs.contiguous().reshape(*xs.shape[:lead], 1, -1)


def ring_all_gather(xs: torch.Tensor, ranks: RankGroup) -> torch.Tensor:
    """b2b analogue.  xs [n, *shard] -> [n, n, *shard]: rank i's row j is
    rank j's shard."""
    ranks.check(xs)
    n = ranks.n
    if xs.device.type == "cuda":
        out = ag_ops.ring_all_gather(_flat_shards(xs, 1), "b2b")
        return out.reshape(n, n, *xs.shape[1:])
    idx = torch.arange(n)
    perm = [(i, (i + 1) % n) for i in range(n)]
    chunks = [xs]
    send = xs
    for _ in range(n - 1):
        send = ranks.ppermute(send, perm)
        chunks.append(send)
    stacked = torch.stack(chunks, 1)              # stacked[i, k] = xs[(i - k) % n]
    order = (idx[:, None] - idx[None, :]) % n     # out[i, j] = stacked[i, (i - j) % n]
    return stacked[idx[:, None], order]


def bidir_ring_all_gather(xs: torch.Tensor, ranks: RankGroup) -> torch.Tensor:
    """bcst analogue: both directions each step, ceil((n-1)/2) steps."""
    ranks.check(xs)
    n = ranks.n
    if xs.device.type == "cuda":
        out = ag_ops.ring_all_gather(_flat_shards(xs, 1), "bcst_b2b")
        return out.reshape(n, n, *xs.shape[1:])
    idx = torch.arange(n)
    fwd_perm = [(i, (i + 1) % n) for i in range(n)]
    bwd_perm = [(i, (i - 1) % n) for i in range(n)]
    n_fwd = n // 2
    n_bwd = (n - 1) - n_fwd
    out = {0: xs}
    send_f, send_b = xs, xs
    for k in range(1, n_fwd + 1):
        send_f = ranks.ppermute(send_f, fwd_perm)
        out[k] = send_f                           # chunk from rank i-k (offset k)
        if k <= n_bwd:
            send_b = ranks.ppermute(send_b, bwd_perm)
            out[(n - k) % n] = send_b             # chunk from rank i+k
    stacked = torch.stack([out[o] for o in range(n)], 1)   # stacked[i, o] = xs[(i - o) % n]
    order = (idx[:, None] - idx[None, :]) % n
    return stacked[idx[:, None], order]


def pairwise_all_to_all(xs: torch.Tensor, ranks: RankGroup) -> torch.Tensor:
    """swap analogue.  xs [n, n, *chunk] (xs[j, i] is rank j's chunk for
    rank i) -> out[i, j] = xs[j, i].

    Round r exchanges chunk xs[i, i ^ r] with partner i ^ r (n a power of
    two), a symmetric pairwise swap; rotation pairing (i + r) otherwise.
    """
    ranks.check(xs, lead=2)
    n = ranks.n
    if xs.device.type == "cuda":
        return aa_ops.all_to_all(_flat_shards(xs, 2), "b2b").reshape(xs.shape)
    idx = torch.arange(n)
    power_of_two = (n & (n - 1)) == 0
    out = torch.zeros_like(xs)
    out[idx, idx] = xs[idx, idx]                  # own chunk stays
    for r in range(1, n):
        if power_of_two:
            perm = [(i, i ^ r) for i in range(n)]
            partner = idx ^ r
            src = partner
        else:
            perm = [(i, (i + r) % n) for i in range(n)]
            partner = (idx + r) % n
            src = (idx - r) % n
        recv = ranks.ppermute(xs[idx, partner], perm)
        out[idx, src] = recv
    return out


def ring_reduce_scatter(xs: torch.Tensor, ranks: RankGroup) -> torch.Tensor:
    """Ring reduce-scatter.  xs [n, n, *chunk] (xs[e, i] is rank e's addend
    for rank i) -> [n, *chunk], row i = ``sum_e xs[e, i]``.

    The partial destined for rank o starts at its successor o+1, travels the
    ring forward for n-1 hops, and each visited rank folds in its own
    contribution: at step r rank i holds (and sends) the partial destined for
    ``(i - r - 1) % n``.  Tensor code on every device: the reference has no
    kernel for it.
    """
    ranks.check(xs, lead=2)
    n = ranks.n
    idx = torch.arange(n, device=xs.device)
    acc = xs[idx, (idx - 1) % n]
    for r in range(n - 1):
        # ppermute one step forward (i -> i + 1), as a roll of the rank dim
        acc = torch.roll(acc, 1, 0) + xs[idx, (idx - r - 2) % n]
    return acc


def ring_all_reduce(xs: torch.Tensor, ranks: RankGroup) -> torch.Tensor:
    """Ring reduce-scatter + ring all-gather.  xs [n, n, *chunk] -> [n, n,
    *chunk], every rank's copy of ``out[j] = sum_e xs[e, j]``."""
    return ring_all_gather(ring_reduce_scatter(xs, ranks), ranks)


def reference_all_gather(xs: torch.Tensor, ranks: RankGroup) -> torch.Tensor:
    ranks.check(xs)
    return xs.unsqueeze(0).expand(ranks.n, *xs.shape).contiguous()


def reference_all_to_all(xs: torch.Tensor, ranks: RankGroup) -> torch.Tensor:
    ranks.check(xs, lead=2)
    return xs.transpose(0, 1).contiguous()


def reference_reduce_scatter(xs: torch.Tensor, ranks: RankGroup) -> torch.Tensor:
    """Full sum over ranks; row i is rank i's chunk."""
    ranks.check(xs, lead=2)
    return xs.sum(0)


def reference_all_reduce(xs: torch.Tensor, ranks: RankGroup) -> torch.Tensor:
    ranks.check(xs)
    return xs.sum(0, keepdim=True).expand(xs.shape).contiguous()
