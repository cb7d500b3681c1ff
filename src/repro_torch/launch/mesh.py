"""Production mesh construction over a fake process group.

Counterpart of ``repro.launch.mesh``.  The reference builds its meshes over
512 emulated host devices; the port builds a ``DeviceMesh`` over torch's
``"fake"`` process group, whose collectives are no-ops, so the dry-run can
trace a 256- or 512-rank program in one process on one device.  A process
group is global to the process: ``fake_world(n)`` sets one up for the
duration of a ``with`` block and tears it down after, so a caller can build
meshes of different sizes in turn.  Building a mesh needs an active group of
the mesh's size.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.compat import resolve_device

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``"fake"`` process group of ``world_size`` ranks (this process is
    rank 0) for the duration of the block.  Raises if a group is active."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def production_mesh_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(shape, axis names) of the production mesh: 16 x 16 = 256 ranks, or
    2 x 16 x 16 = 512 with ``multi_pod``."""
    return MULTI_POD if multi_pod else SINGLE_POD


def make_mesh(shape: tuple, names: tuple, device="cuda") -> DeviceMesh:
    """A mesh of ``shape`` with axes ``names`` over the active fake group."""
    want = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != want:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs an active process group "
                           f"of {want} ranks (launch.mesh.fake_world({want}))")
    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> DeviceMesh:
    """The production mesh of ``device``'s type (``"cuda"`` unless the
    caller asks for the CPU)."""
    shape, names = production_mesh_shape(multi_pod)
    return make_mesh(shape, names, device)


def make_local_mesh(model_axis: int = 1, device="cuda") -> DeviceMesh:
    """A (n // model_axis, model_axis) mesh over the devices there are: the
    CUDA device count, or 1 for the CPU."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n % model_axis:
        raise ValueError(f"{n} devices do not split into a model axis of {model_axis}")
    return make_mesh((n // model_axis, model_axis), ("data", "model"), dev)


def mesh_name(mesh: DeviceMesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def dp_axes(mesh) -> tuple[str, ...] | str:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"
