"""A data-parallel mesh over a ``torch.distributed`` process group.

Counterpart of ``superviseddescent_tpu/parallel/mesh.py``. The JAX package
shards one program's arrays over the devices of a 1-D ``"data"`` mesh;
here every rank is a process of its own that holds the same inputs, takes
its shard of the batch (``shard_batch``) and joins the others through
collectives over the group (``parallel/dist.py``). The mesh is a
``DeviceMesh`` with one ``"data"`` dimension over the whole group.

The caller starts the group: ``torch.distributed.init_process_group`` with
its backend, address, world size and rank (``torchrun`` sets them in the
environment). Nothing here picks or changes a backend.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from superviseddescent_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """This process's place in a 1-D data-parallel mesh: its ``rank`` of
    ``size``, the ``device`` it computes on, the group's ``backend`` and
    the ``DeviceMesh`` whose ``axis_name`` dimension the collectives run
    over."""
    device_mesh: DeviceMesh
    rank: int
    size: int
    device: torch.device
    backend: str
    axis_name: str = "data"

    @property
    def group(self):
        return self.device_mesh.get_group(self.axis_name)


def make_mesh(num_devices: Optional[int] = None, axis_name: str = "data",
              device=None, share_device: bool = False) -> Mesh:
    """The mesh of every rank of the initialised default group.

    num_devices: the group's size, checked: a group of any other size
    raises. device: this rank's device type, CUDA unless ``"cpu"`` is
    named; rank r computes on ``cuda:r``. More ranks than CUDA devices
    raise, since a mesh that silently shares a device makes any
    multi-device check vacuous, unless the caller asks for it with
    ``share_device=True`` (then rank r takes ``cuda:(r % devices)``; NCCL
    refuses two ranks on one device, so that needs a gloo group). CPU ranks
    are processes and share nothing.
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group: call "
            "torch.distributed.init_process_group with its backend, "
            "address, world size and rank first")
    size, rank = dist.get_world_size(), dist.get_rank()
    backend = str(dist.get_backend())
    if num_devices is not None and num_devices != size:
        raise ValueError(f"make_mesh({num_devices}) but the process group "
                         f"has {size} rank(s)")
    device = resolve_device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if size > count and not share_device:
            raise ValueError(
                f"a mesh of {size} ranks but only {count} CUDA device(s); "
                "pass share_device=True to run several ranks on one device")
        if size > count and backend == "nccl":
            raise ValueError("NCCL refuses two ranks on one device: share a "
                             "device over a gloo group")
        device = torch.device("cuda", rank % count)
        torch.cuda.set_device(device)
    device_mesh = DeviceMesh(device.type, list(range(size)),
                             mesh_dim_names=(axis_name,))
    return Mesh(device_mesh, rank, size, device, backend, axis_name)


def _as_tensor(array, device) -> torch.Tensor:
    if isinstance(array, torch.Tensor):
        return array.to(device)
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def shard_bounds(n: int, mesh: Mesh):
    """(start, stop) of this rank's rows of an n-row batch; n must divide
    over the mesh."""
    if n % mesh.size:
        raise ValueError(f"batch of {n} does not divide over the mesh "
                         f"({mesh.size} ranks)")
    per = n // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def shard_batch(array, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of an array's leading (batch) axis, on its
    device; every rank passes the same array."""
    a, b = shard_bounds(array.shape[0], mesh)
    return _as_tensor(array[a:b], mesh.device)


def replicate(array, mesh: Mesh) -> torch.Tensor:
    """The array on this rank's device, with rank 0's values on every
    rank (one broadcast)."""
    t = _as_tensor(array, mesh.device).contiguous()
    dist.broadcast(t, src=0, group=mesh.group)
    return t


def gather_rows(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's (n, ...) rows, in rank order, as one (n * size, ...)
    tensor on every rank. NCCL gathers them; gloo takes only broadcast
    and all_reduce for CUDA tensors, so there each rank writes its rows
    into a zero-filled buffer and the buffers are summed (exact: each
    entry has one non-zero term)."""
    local = local.contiguous()
    n = local.shape[0]
    out = local.new_zeros((n * mesh.size,) + tuple(local.shape[1:]))
    if mesh.backend == "nccl":
        dist.all_gather_into_tensor(out, local, group=mesh.group)
    else:
        out[mesh.rank * n:(mesh.rank + 1) * n] = local
        dist.all_reduce(out, group=mesh.group)
    return out
