"""Multi-process launch and `torch.distributed` initialisation.

Counterpart of `pbmm_tpu/parallel/launcher.py`: one process a device (a
CUDA card over NCCL, or a CPU process over gloo), initialised from
arguments or from torchrun's environment (`MASTER_ADDR`, `MASTER_PORT`,
`WORLD_SIZE`, `RANK`, `LOCAL_RANK`); videos shard over "data", frames
over "frame" (`parallel/mesh.py`).  Health: initialisation is the failure
detector (a missing rank fails the rendezvous); recovery is the
launching job's: restart and resume from the last `VideoState`
checkpoint (`engine/state.py`).

A single process needs no initialisation; the sharded engines then run
on a world that the caller initialised (a world of one on one card, for
example: `init_world(f"tcp://127.0.0.1:{free_port()}", 1, 0,
rank_device())`).
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from pbmm_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for


def rank_device(device=None, local_rank: Optional[int] = None
                ) -> torch.device:
    """The device of this rank: `cuda:LOCAL_RANK` unless `device` asks for
    the CPU.  Raises where the card it names is absent (there is no
    fallback to the CPU)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if not torch.cuda.is_available() or local_rank >= \
            torch.cuda.device_count():
        raise RuntimeError(
            f"rank needs CUDA card {local_rank} and the machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            "; pass device='cpu' to run the rank on the CPU (gloo)")
    return torch.device("cuda", local_rank)


def free_port() -> int:
    """A free TCP port on the loopback interface, for a rendezvous URL
    (`tcp://127.0.0.1:<port>`) of processes on this machine."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_world(init_method: str, world_size: int, rank: int,
               device: torch.device) -> None:
    """Join a world of `world_size` ranks (one included) as `rank` on
    `device` (`rank_device`'s): NCCL on a CUDA card, made the current
    one, or gloo on the CPU."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, world_size=world_size,
                            rank=rank)


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           local_rank: Optional[int] = None,
                           device=None) -> bool:
    """Initialise `torch.distributed` from the arguments or torchrun's
    environment.  Returns True if a multi-process world was initialised,
    False for a single process (nothing is initialised: `init_world`
    makes a world of one).

    init_method: a rendezvous URL (`tcp://host:port`); default
      `env://` from MASTER_ADDR / MASTER_PORT.
    device: "cpu" runs the rank on the CPU over gloo; otherwise the rank
      takes `cuda:LOCAL_RANK` over NCCL (and raises without that card).
    """
    world_size = (world_size if world_size is not None
                  else int(os.environ.get("WORLD_SIZE", "1")))
    if world_size <= 1:
        return False
    rank = rank if rank is not None else int(os.environ.get("RANK", "0"))
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    init_world(init_method or "env://", world_size, rank,
               rank_device(device, local_rank))
    return True


def global_mesh(n_videos: int = 1):
    """Mesh over every rank of the world: videos over "data", frames over
    "frame" (`mesh_shape_for`)."""
    return make_mesh(mesh_shape_for(dist.get_world_size(), n_videos))


def host_local_batch_slice(batch_size: int) -> Tuple[int, int]:
    """[start, end) of the video-batch rows this rank feeds."""
    pid, n = dist.get_rank(), dist.get_world_size()
    per = -(-batch_size // n)
    return pid * per, min((pid + 1) * per, batch_size)
