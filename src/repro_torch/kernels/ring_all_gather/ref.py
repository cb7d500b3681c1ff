"""Plain PyTorch versions of the ring all-gather kernel (the oracle of
``repro.kernels.ring_all_gather.ref``): after the collective, every rank
holds the global array.  ``all_gather_ref`` over emulated ranks;
``all_gather_gloo`` with one rank per process, the kernel's ring run step by
step over gloo."""
from __future__ import annotations

import torch


def all_gather_ref(xs: torch.Tensor) -> torch.Tensor:
    """xs [n, chunk, F] (rank r's shard is xs[r]) -> [n, n * chunk, F], one
    copy of the global array per rank."""
    n, chunk, f = xs.shape
    return xs.reshape(1, n * chunk, f).expand(n, n * chunk, f).contiguous()


def all_gather_gloo(x: torch.Tensor, ranks, bidir: bool = False) -> torch.Tensor:
    """This rank's shard x [chunk, F] -> [n * chunk, F], over
    ``ranks.ppermute`` (a ``core.procgroup.ProcessRanks`` on the CPU): n - 1
    ring steps rightward, each forwarding what the last one brought; with
    ``bidir`` ceil((n-1)/2) steps rightward and the rest leftward at once,
    the kernel's bidirectional schedule."""
    n, my = ranks.n, ranks.rank
    right = [(i, (i + 1) % n) for i in range(n)]
    left = [(i, (i - 1) % n) for i in range(n)]
    n_right = n // 2 if bidir else n - 1
    n_left = (n - 1) - n_right
    got = {my: x}
    send_r = send_l = x
    for k in range(1, n_right + 1):
        send_r = ranks.ppermute(send_r, right)
        got[(my - k) % n] = send_r
        if k <= n_left:
            send_l = ranks.ppermute(send_l, left)
            got[(my + k) % n] = send_l
    return torch.cat([got[j] for j in range(n)], 0)
