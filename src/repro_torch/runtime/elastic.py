"""Elastic re-planning: rebuild the mesh from the surviving ranks.

Checkpoints store full (host-gathered) arrays, so elasticity reduces to
(1) choosing a new (data, model) factorization for the surviving device
count and (2) re-entering the step with the new mesh: no state surgery.

Planning policy: keep the model-parallel degree as close to the requested
one as the device count allows (it is tied to weight-dim divisibility), give
the rest to data parallelism; drop the pod axis when a whole pod is lost.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist


def plan_mesh_shape(n_devices: int, preferred_model: int = 16) -> Tuple[Tuple[int, int], Tuple[str, str]]:
    """Largest model-parallel degree <= preferred that divides n_devices."""
    mp = min(preferred_model, n_devices)
    while mp > 1 and n_devices % mp != 0:
        mp -= 1
    return (n_devices // mp, mp), ("data", "model")


def replan_mesh(n_devices: Optional[int] = None, preferred_model: int = 16, device_type: Optional[str] = None):
    """A 2-D ``DeviceMesh`` ``("data", "model")`` over the live process group.

    The survivors re-form the default process group first (the port never
    starts one); ``n_devices`` defaults to its size and must equal it.
    ``device_type`` defaults to ``"cuda"`` on an NCCL group, else ``"cpu"``.
    A collective call: every rank of the group makes it.
    """
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("replan_mesh needs the survivors' process group: call "
                         "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"replan_mesh spans the live group of {world} ranks, got n_devices={n}")
    shape, axes = plan_mesh_shape(n, preferred_model)
    if device_type is None:
        device_type = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def survivors_after_pod_loss(total: int = 512, pods: int = 2, lost_pods: int = 1) -> int:
    return total // pods * (pods - lost_pods)
