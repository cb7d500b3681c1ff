"""Ranks with one process each: the counterpart of the reference's mesh axis
with one device per rank (``shard_map`` over ``make_mesh((n,), (axis,))``).

The emulated collectives (``core.collectives.RankGroup``) run n ranks inside
one process on one device.  Here each rank is a process of a
``torch.distributed`` gloo group and owns its memory: on CUDA the collective
kernels launch one rank per process and store into peers' buffers through
CUDA IPC (``kernels._rank_sync.SymmetricBuffers``); on the CPU the same ring
and pairing schedules run step by step over gloo ``send``/``recv``
(``ProcessRanks.ppermute``).

    def work(ranks, x):          # runs in every process
        return ring_all_gather(x[ranks.rank], ranks)
    outs = spawn(work, 4, device="cpu", args=(x,))   # one result per rank

Rank r takes ``cuda:(r % device_count)`` unless the caller asks for the CPU,
so on one card every rank is ``cuda:0`` and the processes' kernels take
turns by time slice.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.compat import resolve_device

TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class ProcessRanks:
    """This process's rank of ``n``, its device and the gloo group."""
    n: int
    rank: int
    device: torch.device
    group: object = dataclasses.field(repr=False, compare=False)

    def check(self, x: torch.Tensor) -> None:
        """Raise unless ``x`` lies on this rank's device."""
        if x.device != self.device:
            raise ValueError(f"tensor on {x.device}, rank {self.rank} on {self.device}")

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """JAX's ``lax.ppermute`` for this rank: for each (src, dst) pair,
        src's ``x`` becomes dst's result; a rank that receives nothing gets
        zeros.  gloo ``isend``/``irecv`` of the raw bytes (bit-exact in every
        dtype); every rank of the group must call it with the same ``perm``."""
        if x.device.type != "cpu":
            raise ValueError(f"ppermute runs over gloo on CPU tensors, got {x.device}")
        x = x.contiguous()
        out = torch.zeros_like(x)
        send, recv = x.reshape(-1).view(torch.uint8), out.reshape(-1).view(torch.uint8)
        reqs = []
        for src, dst in perm:
            if src == self.rank and dst == self.rank:
                out.copy_(x)
            elif src == self.rank:
                reqs.append(dist.isend(send, dst, group=self.group))
            elif dst == self.rank:
                reqs.append(dist.irecv(recv, src, group=self.group))
        for req in reqs:
            req.wait()
        return out

    def all_gather_object(self, obj) -> list:
        out = [None] * self.n
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def process_ranks(device="cuda") -> ProcessRanks:
    """This process's ``ProcessRanks`` in the initialised (gloo) default
    group: rank r on ``cuda:(r % device_count)`` (made current) unless
    ``device`` names the CPU or a card."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: run under spawn() or init_process_group")
    rank, n = dist.get_rank(), dist.get_world_size()
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return ProcessRanks(n, rank, dev, dist.group.WORLD)


def _entry(rank, fn, n, device, init_file, out_dir, args, timeout_s):
    """One rank: join the gloo group through the file store, run fn, save
    its result, leave the group."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=n, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        ranks = process_ranks(device)
        result = fn(ranks, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        ranks.barrier()
        if ranks.device.type == "cuda":
            from repro_torch.kernels import _rank_sync
            _rank_sync.release_symmetric(ranks)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _first_failure(out_dir: str) -> str:
    """The traceback of the rank that failed first (the others' often only
    say that a peer went away)."""
    errs = sorted((os.path.getmtime(os.path.join(out_dir, f)), f)
                  for f in os.listdir(out_dir) if f.endswith(".err"))
    if not errs:
        return ""
    with open(os.path.join(out_dir, errs[0][1])) as f:
        return f"{errs[0][1][:-4]} failed first:\n{f.read()}"


def spawn(fn, n: int, device="cuda", args=(), timeout_s: float = TIMEOUT_S) -> list:
    """Run ``fn(ranks, *args)`` in ``n`` new processes (start method
    ``spawn``), one rank each, joined in a gloo group through a ``file://``
    store in a temp directory; returns each rank's result, in rank order
    (results and ``fn`` must pickle).  On CUDA the kernels are built here
    first, so the n processes do not run nvcc at once.  The first failure
    on any rank fails the call (the others are stopped), and so does a
    call that takes more than ``timeout_s`` (every rank's gloo operations
    time out after it too)."""
    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    tmp = tempfile.mkdtemp(prefix="repro-torch-ranks-")
    try:
        ctx = torch.multiprocessing.start_processes(
            _entry, args=(fn, n, str(device), os.path.join(tmp, "store"), tmp, tuple(args),
                          timeout_s),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not _joined(ctx, tmp):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10)
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"spawn: {n} ranks did not finish in {timeout_s} s")
        results = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _joined(ctx, out_dir: str) -> bool:
    try:
        return ctx.join(timeout=1.0)
    except Exception as e:          # a rank failed; ctx.join stopped the others
        raise RuntimeError(f"spawn: {_first_failure(out_dir) or e}") from e
