"""Device meshes over a ``torch.distributed`` process group.

The reference builds its meshes from JAX's devices (``jax.make_mesh``); the
port builds a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, which the caller starts
(``torch.distributed.init_process_group``, or ``torch.distributed.run``).
NCCL groups give ``"cuda"`` meshes, the others ``"cpu"`` ones.  Every
function here is a collective call: every rank of the group makes it.

Single pod: 256 ranks as (data=16, model=16).  Multi-pod: 512 ranks as
(pod=2, data=16, model=16); the pod axis is the outer data-parallel axis,
"model" the tensor- and expert-parallel one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist


def _group_size() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("a mesh spans a torch.distributed process group: call "
                         "torch.distributed.init_process_group first")
    return dist.get_world_size()


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default group
    (the product of ``shape`` must be its size)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding.dist_fft import _device_type

    world = _group_size()
    shape = tuple(int(n) for n in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {tuple(axes)} differ in length")
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"mesh shape {shape} spans {n} ranks, the process group has {world}")
    return init_device_mesh(device_type or _device_type(dist.get_backend()), shape, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """(data=16, model=16) over 256 ranks, or (pod=2, data=16, model=16)
    over 512; ``ValueError`` on a group of another size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(model_parallel: Optional[int] = None):
    """(data, model) over every rank of the group, ``model_parallel``
    (default 1) of them on "model"."""
    n = _group_size()
    mp = model_parallel or 1
    if n % mp:
        raise ValueError(f"model_parallel={mp} does not divide the group's {n} ranks")
    return make_mesh((n // mp, mp), ("data", "model"))


def data_axes(mesh) -> Tuple[str, ...]:
    """All data-parallel axes of a mesh (pod is outer DP when present)."""
    from repro_torch.sharding.rules import mesh_sizes

    names = mesh_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)
