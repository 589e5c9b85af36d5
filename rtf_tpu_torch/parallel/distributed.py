"""Several processes, one card each: torch.distributed set up by hand
(rtf_tpu/parallel/distributed.py).

rtf_tpu initialises jax.distributed and builds one mesh over every
process's devices.  The port runs one process per card (or, with
device='cpu', per CPU rank) and joins them with
torch.distributed.init_process_group; parallel/mesh.py::render_sharded
then shards a frame over them.  Nothing discovers a cluster: the caller
gives the coordinator's address, the process count and this process's
index.

    from rtf_tpu_torch.parallel.distributed import init_multihost
    init_multihost("localhost:29500", num_processes=4, process_id=rank)
"""
from __future__ import annotations

import torch
from torch import distributed as dist


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, device="cuda") -> int:
    """Join the process group (TCP rendezvous at coordinator_address,
    "host:port" of process 0) and return this process's rank.  The
    backend is NCCL for device 'cuda' (this process takes card
    process_id % the host's card count) and gloo for device 'cpu';
    asking for CUDA on a host without it raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_multihost: CUDA was requested but "
                               "torch.cuda.is_available() is False; pass "
                               "device='cpu' for gloo on the CPU")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_multihost: no backend for device {device}")
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dist.get_rank()


def local_tile_range(num_px: int):
    """The contiguous range of pixel lanes (camera.pixel_order's order)
    this process's tile owns under render_sharded with one process per
    tile: (lo, hi), the last process taking the remainder (for splitting
    host-side IO)."""
    n_proc = dist.get_world_size()
    i = dist.get_rank()
    per = num_px // n_proc
    return i * per, (i + 1) * per if i + 1 < n_proc else num_px
