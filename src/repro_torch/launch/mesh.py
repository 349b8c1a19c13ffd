"""Production mesh construction (mirrors :mod:`repro.launch.mesh`).

Functions, not module-level constants: importing this module touches no
device or process-group state.  Each builds a named ``DeviceMesh`` over the
default process group the caller has started (``torch.distributed.
init_process_group``): a ``"fake"`` group of 256 or 512 ranks in the dry
run, gloo ranks in the CPU tests, NCCL on the card.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

__all__ = ["make_production_mesh", "make_local_mesh"]


def _device_type(device: Optional[str]) -> str:
    if device is not None:
        return str(device).split(":")[0]
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[str] = None):
    """Single pod: 256 chips as (data=16, model=16).
    Multi-pod: 2 pods × 256 chips as (pod=2, data=16, model=16).
    The default group must have that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=axes)


def make_local_mesh(device: Optional[str] = None):
    """Every rank of the default group as a 1×N (data, model) mesh — used
    by tests and the card's world-size-1 run."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    return init_device_mesh(_device_type(device), (1, n),
                            mesh_dim_names=("data", "model"))
