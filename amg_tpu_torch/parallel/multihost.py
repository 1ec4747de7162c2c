"""Multi-process execution (counterpart of amg_tpu/parallel/multihost.py).

The reference's multi-host substrate is MPI, one rank per process; the JAX
package maps it to jax.distributed with a global device mesh. The port runs
one process per card (or per CPU worker) under `torch.distributed`: NCCL
between CUDA devices, gloo between CPU processes, and gloo with host-staged
collectives between processes that share one card (NCCL refuses two ranks
on one device). A row mesh
(`parallel.dist.make_row_mesh`) made after `init_multihost` spreads its D
logical shards over the processes of the group, D / world_size consecutive
shards to each, and the halo operators exchange across processes through
the group (`parallel.spcomm`).

Setup is deterministic (seeded generators, identical host hierarchies in
every process), so each process builds the same host data and keeps its own
shards: the reference's matrix redistribution without the all-to-all.

Validated by tests/test_torch_multiprocess.py: 2 gloo processes x 4 shards
run every row-mesh and grid route and equal the one-process 8-shard run.
"""

from __future__ import annotations

import torch

from amg_tpu_torch.dtypes import resolve_device


def process_group_backend(device) -> str:
    """The torch.distributed backend for ranks on `device`: "nccl" for a
    CUDA device, "gloo" for the CPU. Pure: reads only its argument."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_multihost(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    device=None,
    backend=None,
) -> torch.device:
    """Initialize the default process group; call before building a mesh.

    coordinator_address is "host:port" (or a full "tcp://host:port" init
    method); nothing is discovered from the environment. `device` (None: the
    CUDA device; raises without one) is this process's device: a CUDA device
    becomes the current device. `backend` None takes
    `process_group_backend(device)` (NCCL between cards, gloo on the CPU);
    backend="gloo" with a CUDA device is for processes that share one card,
    which NCCL does not accept: the meshes made then stage each collective
    through host buffers and keep the arithmetic on the card. The backend is
    the caller's choice, never a fallback. Returns the resolved device."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    method = coordinator_address
    if "://" not in method:
        method = f"tcp://{method}"
    torch.distributed.init_process_group(
        backend or process_group_backend(device), init_method=method,
        world_size=num_processes, rank=process_id,
    )
    return device


def global_mesh_info(mesh=None) -> dict:
    """Topology summary (the reference prints ranks and grids at startup):
    this process's index and the process count, and with a row mesh its
    shards per process and in all, and its device."""
    dist = torch.distributed
    on = dist.is_available() and dist.is_initialized()
    info = {
        "process_index": dist.get_rank() if on else 0,
        "process_count": dist.get_world_size() if on else 1,
    }
    if mesh is not None:
        info.update(local_devices=mesh.local_devices, global_devices=mesh.n_devices,
                    device=str(mesh.device))
    return info
