"""Device-mesh and sharding helpers.

Port of ``mclstexp_tpu/parallel/mesh.py``. A JAX ``Mesh`` names the
devices one process sees; here the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group, one card (or CPU process) each. ``make_mesh`` makes a one-rank group
(a ``FileStore`` in a temporary directory) when none is initialized, so the
sharded paths run their collectives at world size 1 too.
``shard_batch`` keeps JAX's placement rule: a batch whose length divides
the mesh axis is sharded (this rank keeps its contiguous slice), any other
is replicated (every rank keeps all of it); ``batch_rows`` names this
rank's rows under that rule.

``train_mesh`` is the mesh a training run takes from its config, as JAX's
loop builds one from ``TrainConfig.mesh_shape`` / ``mesh_axes``: the
configured shape, else one "data" axis over every rank when a process group
exists; one process without a group and without a configured shape trains
with no mesh. As in JAX's loop the batch is sharded on "data" only: the
ranks along any other axis ("seq", "model") hold replicas of the step
(``check_data_mesh`` asks for a "data" axis).

``active_mesh(mesh)`` is the port's ``with mesh:``: inside it
``current_mesh()`` returns the mesh, which the attention's "ring" backend
reads for its "seq" axis (``parallel.ring_attention``), as JAX's layer reads
the ambient mesh. JAX's ``train_fold`` enters no ``with mesh:``, so a "ring"
model trained by it raises; the port's ``train_fold`` enters no
``active_mesh`` either. Tensor-parallel parameter layouts on a "model" axis
are ``parallel.tp``.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import os
import tempfile
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from mclstexp_tpu_torch.parallel import distributed


def _one_rank_group(device) -> None:
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(distributed.local_rank())
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(prefix="mclstexp_mesh_"), "store"), 1)
    dist.init_process_group("nccl" if cuda else "gloo", store=store, world_size=1, rank=0)


def make_mesh(shape: Optional[Tuple[int, ...]] = None, axes: Tuple[str, ...] = ("data",),
              device="cuda") -> DeviceMesh:
    """A mesh over every rank of the process group (created at world size 1
    when there is none); by default 1-D on "data". ``device`` picks the
    mesh's device type and, for a new group, its backend (NCCL on a card,
    gloo on the CPU)."""
    if not distributed.is_initialized():
        _one_rank_group(device)
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axes) - 1)
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} ranks; the group "
                         f"has {world}")
    return DeviceMesh(torch.device(device).type, torch.arange(world).reshape(shape),
                      mesh_dim_names=tuple(axes))


def mesh_axis(mesh: DeviceMesh, axis: str = "data"):
    """(process group, size, this rank's index) of one axis of ``mesh``."""
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(dim), mesh.size(dim), mesh.get_local_rank(dim)


def batch_rows(n: int, mesh: DeviceMesh, axis: str = "data") -> slice:
    """This rank's rows of a batch of ``n``: its contiguous share when ``n``
    divides the mesh axis, else all of them (the batch is replicated)."""
    _, n_shards, me = mesh_axis(mesh, axis)
    if n % n_shards:
        return slice(0, n)
    per = n // n_shards
    return slice(me * per, (me + 1) * per)


def shard_batch(batch: Dict[str, object], mesh: DeviceMesh, axis: str = "data"):
    """This rank's part of a host batch: its contiguous slice along the
    leading axis when the length divides the mesh axis, else all of it
    (remainder batches are replicated)."""
    return {k: v[batch_rows(len(v), mesh, axis)] for k, v in batch.items()}


def check_data_mesh(mesh: DeviceMesh) -> None:
    """Raise unless ``mesh`` has a "data" axis, the axis a training batch is
    sharded on; the ranks along its other axes hold replicas."""
    names = tuple(mesh.mesh_dim_names or ())
    if "data" not in names:
        raise ValueError(f"a training mesh needs a 'data' axis; got axes {names}")


_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar("active_mesh", default=None)


@contextlib.contextmanager
def active_mesh(mesh: DeviceMesh) -> Iterator[DeviceMesh]:
    """Make ``mesh`` the ambient mesh of the block (JAX's ``with mesh:``)."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)


def current_mesh() -> Optional[DeviceMesh]:
    """The mesh of the innermost ``active_mesh`` block, or None."""
    return _ACTIVE_MESH.get()


def train_mesh(shape: Optional[Tuple[int, ...]], axes: Tuple[str, ...],
               device="cuda") -> Optional[DeviceMesh]:
    """The mesh of a training run configured with ``mesh_shape`` ``shape``
    and ``mesh_axes`` ``axes``: ``make_mesh(shape, axes)`` when a shape is
    configured or a process group exists, else None (one process, no
    collectives); checked by ``check_data_mesh``."""
    if shape is None and not distributed.is_initialized():
        return None
    mesh = make_mesh(shape, axes, device=device)
    check_data_mesh(mesh)
    return mesh
