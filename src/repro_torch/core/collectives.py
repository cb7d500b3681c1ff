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
  reference has no kernel for it, so over emulated ranks it stays tensor
  code).
* ``ring_all_reduce``: the reduce-scatter, then ``ring_all_gather``.

On the CPU each rendering runs its own schedule, step by step, so the CPU
tests check the same indices as the reference's ``ppermute`` renderings; on
CUDA the whole collective is one launch of the hand-written kernel, whose
schedule is the same ring or pairing.  The ``reference_*`` functions are one
PyTorch call each, the counterpart of XLA's one-shot collectives (the
reference backend of ``CommBackend``), not the kernels' plain versions.

One rank per process: every function also takes a
``core.procgroup.ProcessRanks`` and this rank's operand, exactly as the
reference's functions are called inside ``shard_map``: all-gather ``x
[*shard] -> [n, *shard]``; all-to-all ``x [n, *chunk] -> [n, *chunk]``
with ``out[j]`` rank j's chunk for this rank; reduce-scatter ``x [n,
*chunk] -> [*chunk]``, ``sum_e x_e[this rank]``; all-reduce ``x [n, *chunk]
-> [n, *chunk]``, ``out[j] = sum_e x_e[j]``.  CUDA: per-rank launches of B3
``b2b`` / ``bcst_b2b``, B4 ``b2b`` and the ring reduce-scatter
(``kernels/csrc/ring_reduce_scatter.cu``), storing into peers' memory through
CUDA IPC; the one-shots go through B3 ``pcpy`` and B4 ``per_round``.  CPU:
the same schedules over gloo, and gloo's own collectives for the one-shots.
No library collective touches a CUDA tensor, and no CUDA tensor goes
through the CPU.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.compat import resolve_device
from repro_torch.core.procgroup import ProcessRanks
from repro_torch.kernels.ring_all_gather import ops as ag_ops
from repro_torch.kernels.ring_all_to_all import ops as aa_ops
from repro_torch.kernels.ring_reduce_scatter import ops as rs_ops


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
        """JAX's ``lax.ppermute`` over the rank dim: out[dst] = xs[src] for
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


def _gather_rank(x: torch.Tensor, ranks: ProcessRanks, variant: str) -> torch.Tensor:
    """This rank's shard [*shard] -> [n, *shard] through B3 per rank."""
    out = ag_ops.ring_all_gather_rank(x.contiguous().reshape(1, -1), ranks, variant)
    return out.reshape(ranks.n, *x.shape)


def _per_rank_chunks(x: torch.Tensor, ranks: ProcessRanks) -> torch.Tensor:
    """This rank's chunks [n, *chunk] -> [n, 1, numel(chunk)]."""
    n = ranks.n
    if x.dim() < 1 or x.shape[0] != n:
        raise ValueError(f"expected a leading rank dim of size {n}, got {tuple(x.shape)}")
    return x.contiguous().reshape(n, 1, -1)


def _all_to_all_rank(x: torch.Tensor, ranks: ProcessRanks, variant: str) -> torch.Tensor:
    """This rank's chunks [n, *chunk] -> [n, *chunk] through B4 per rank."""
    return aa_ops.all_to_all_rank(_per_rank_chunks(x, ranks), ranks, variant).reshape(x.shape)


def ring_all_gather(xs: torch.Tensor, ranks: RankGroup | ProcessRanks) -> torch.Tensor:
    """b2b analogue.  xs [n, *shard] -> [n, n, *shard]: rank i's row j is
    rank j's shard.  Over processes: this rank's x [*shard] -> [n, *shard]."""
    if isinstance(ranks, ProcessRanks):
        return _gather_rank(xs, ranks, "b2b")
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


def bidir_ring_all_gather(xs: torch.Tensor, ranks: RankGroup | ProcessRanks) -> torch.Tensor:
    """bcst analogue: both directions each step, ceil((n-1)/2) steps."""
    if isinstance(ranks, ProcessRanks):
        return _gather_rank(xs, ranks, "bcst_b2b")
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


def pairwise_all_to_all(xs: torch.Tensor, ranks: RankGroup | ProcessRanks) -> torch.Tensor:
    """swap analogue.  xs [n, n, *chunk] (xs[j, i] is rank j's chunk for
    rank i) -> out[i, j] = xs[j, i].  Over processes: this rank's x [n,
    *chunk] -> [n, *chunk], out[j] = rank j's x[this rank].

    Round r exchanges chunk xs[i, i ^ r] with partner i ^ r (n a power of
    two), a symmetric pairwise swap; rotation pairing (i + r) otherwise.
    """
    if isinstance(ranks, ProcessRanks):
        return _all_to_all_rank(xs, ranks, "b2b")
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


def ring_reduce_scatter(xs: torch.Tensor, ranks: RankGroup | ProcessRanks) -> torch.Tensor:
    """Ring reduce-scatter.  xs [n, n, *chunk] (xs[e, i] is rank e's addend
    for rank i) -> [n, *chunk], row i = ``sum_e xs[e, i]``.  Over processes:
    this rank's addends x [n, *chunk] -> [*chunk], ``sum_e x_e[this rank]``.

    The partial destined for rank o starts at its successor o+1, travels the
    ring forward for n-1 hops, and each visited rank folds in its own
    contribution: at step r rank i holds (and sends) the partial destined for
    ``(i - r - 1) % n``.  Over emulated ranks, tensor code on every device
    (the reference has no kernel for it); over processes, the per-rank ring
    kernel on CUDA and the same ring over gloo on the CPU, bit-equal to it.
    """
    if isinstance(ranks, ProcessRanks):
        out = rs_ops.reduce_scatter_rank(_per_rank_chunks(xs, ranks), ranks)
        return out.reshape(xs.shape[1:])
    ranks.check(xs, lead=2)
    n = ranks.n
    idx = torch.arange(n, device=xs.device)
    acc = xs[idx, (idx - 1) % n]
    for r in range(n - 1):
        # ppermute one step forward (i -> i + 1), as a roll of the rank dim
        acc = torch.roll(acc, 1, 0) + xs[idx, (idx - r - 2) % n]
    return acc


def ring_all_reduce(xs: torch.Tensor, ranks: RankGroup | ProcessRanks) -> torch.Tensor:
    """Ring reduce-scatter + ring all-gather.  xs [n, n, *chunk] -> [n, n,
    *chunk], every rank's copy of ``out[j] = sum_e xs[e, j]``.  Over
    processes: this rank's x [n, *chunk] -> [n, *chunk], its copy."""
    return ring_all_gather(ring_reduce_scatter(xs, ranks), ranks)


def reference_all_gather(xs: torch.Tensor, ranks: RankGroup | ProcessRanks) -> torch.Tensor:
    """One-shot all-gather.  Over processes: gloo's ``all_gather`` on the
    CPU; on the card, where the port uses no library collective, B3
    ``pcpy`` per rank (every step synced, the paper's parallel copies)."""
    if isinstance(ranks, ProcessRanks):
        if xs.device.type == "cuda":
            return _gather_rank(xs, ranks, "pcpy")
        out = [torch.empty_like(xs) for _ in range(ranks.n)]
        torch.distributed.all_gather(out, xs.contiguous(), group=ranks.group)
        return torch.stack(out)
    ranks.check(xs)
    return xs.unsqueeze(0).expand(ranks.n, *xs.shape).contiguous()


def reference_all_to_all(xs: torch.Tensor, ranks: RankGroup | ProcessRanks) -> torch.Tensor:
    """One-shot all-to-all.  Over processes: gloo's ``all_to_all_single``
    on the CPU; on the card B4 ``per_round`` per rank."""
    if isinstance(ranks, ProcessRanks):
        if xs.device.type == "cuda":
            return _all_to_all_rank(xs, ranks, "per_round")
        out = torch.empty_like(xs)
        torch.distributed.all_to_all_single(out, xs.contiguous(), group=ranks.group)
        return out
    ranks.check(xs, lead=2)
    return xs.transpose(0, 1).contiguous()


def reference_reduce_scatter(xs: torch.Tensor, ranks: RankGroup | ProcessRanks) -> torch.Tensor:
    """Full sum over ranks; row i is rank i's chunk.  Over processes: the
    one-shot all-to-all of this rank's addends, then their sum (the
    reference's "full psum, keep this rank's chunk" with 1/n of the bytes)."""
    if isinstance(ranks, ProcessRanks):
        return reference_all_to_all(xs, ranks).sum(0)
    ranks.check(xs, lead=2)
    return xs.sum(0)


def reference_all_reduce(xs: torch.Tensor, ranks: RankGroup | ProcessRanks) -> torch.Tensor:
    """Every rank's copy of the sum over ranks.  Over processes: the
    one-shot all-gather of this rank's x [n, *chunk], then the sum."""
    if isinstance(ranks, ProcessRanks):
        return reference_all_gather(xs, ranks).sum(0)
    ranks.check(xs)
    return xs.sum(0, keepdim=True).expand(xs.shape).contiguous()
