"""Device-mesh construction over a `torch.distributed` world.

Counterpart of `pbmm_tpu/parallel/mesh.py`: a ("data", "frame") mesh where
independent videos shard over "data" and the frames of each video over
"frame", with a 1-frame halo for the two-frame temporal dependency; the
spatial engine (`parallel/spatial.py`) takes a ("rows",) or ("frame",
"rows") mesh.  Each rank of the world is one device of the mesh: one CUDA
card per process (NCCL), or one CPU process (gloo).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def mesh_shape_for(n_devices: int, n_videos: int = 1) -> Tuple[int, int]:
    """Pick (data, frame) mesh dims: give the data axis as many devices as
    there are videos to spread (capped at n_devices), the rest to frames."""
    data = 1
    d = n_devices
    while data * 2 <= min(n_videos, n_devices) and d % 2 == 0:
        data *= 2
        d //= 2
    return data, n_devices // data


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Tuple[str, ...] = ("data", "frame"),
              device_type: Optional[str] = None) -> DeviceMesh:
    """A `DeviceMesh` of `shape` over the default process group's ranks,
    in rank order, with `axis_names` (one a dimension).  `shape` defaults
    to `mesh_shape_for(world size)`, `device_type` to the world's
    ("cuda" on NCCL, "cpu" on gloo).  Every rank calls it (a collective:
    the mesh makes a process group for each dimension).  Raises
    `ValueError` when the shape's product is not the world size; a world
    of one takes the mesh (1, 1) or (1,)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(parallel.launcher.initialize_distributed)")
    n = dist.get_world_size()
    if shape is None:
        shape = mesh_shape_for(n)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    if len(axis_names) != len(shape):
        raise ValueError(f"{len(shape)} mesh dims but axis names "
                         f"{tuple(axis_names)}")
    if device_type is None:  # the world's: NCCL's cards, gloo's CPU
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))


def on_rank(x, mesh: DeviceMesh) -> torch.Tensor:
    """`x` as a tensor for an engine on `mesh`: a torch tensor stays where
    it lies; numpy goes to this rank's device (the current CUDA card, or
    the CPU on a gloo world)."""
    from pbmm_tpu_torch.engine.pipeline import on_device

    if isinstance(x, torch.Tensor):
        return x
    return on_device(x, torch.device("cpu") if mesh.device_type == "cpu"
                     else torch.device("cuda", torch.cuda.current_device()))


def mesh_dims(mesh: DeviceMesh) -> dict:
    """{axis name: size} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_coord(mesh: DeviceMesh, name: str) -> int:
    """This rank's coordinate along mesh axis `name`."""
    return mesh.get_local_rank(name)


def neighbour(mesh: DeviceMesh, name: str, step: int) -> Optional[int]:
    """The global rank `step` places along axis `name` from this rank (the
    other coordinates kept), or None past either end (no wrap)."""
    coord = list(mesh.get_coordinate())
    dim = mesh.mesh_dim_names.index(name)
    coord[dim] += step
    if not 0 <= coord[dim] < mesh.mesh.shape[dim]:
        return None
    return int(mesh.mesh[tuple(coord)])


def exchange(sends):
    """One step of point-to-point sends: `sends` is [(tensor, global rank
    to send it to, global rank to receive its like from)], either rank
    None for none; returns the received tensors (shaped as the sent
    ones), None where nothing is received.  Every rank issues its sends
    in the same order, which pairs each message with its receive."""
    ops, recvs = [], []
    for t, dst, src in sends:
        r = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
             if src is not None else None)
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, t.contiguous(), dst))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, r, src))
        recvs.append(r)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recvs


def gather_grid(block: torch.Tensor, ranks) -> torch.Tensor:
    """Every rank's `block` gathered (an all-gather over the world) and
    tiled by `ranks`, a 2D list of global ranks: the blocks of a row of
    `ranks` side by side along dim 1, the rows along dim 0.  Blocks may
    differ in their first two sizes (each is padded to the largest for
    the all-gather and cut back after it); the rest of the shape is one
    for all."""
    n = dist.get_world_size()
    size = torch.tensor(block.shape[:2], dtype=torch.int64,
                        device=block.device)
    sizes = [torch.empty_like(size) for _ in range(n)]
    dist.all_gather(sizes, size)
    sizes = [tuple(s.tolist()) for s in sizes]
    big = tuple(max(s[i] for s in sizes) for i in (0, 1))
    padded = block.new_zeros(big + tuple(block.shape[2:]))
    padded[:block.shape[0], :block.shape[1]] = block
    parts = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(parts, padded)
    parts = [x[:a, :b] for x, (a, b) in zip(parts, sizes)]
    return torch.cat([torch.cat([parts[r] for r in row], dim=1)
                      for row in ranks], dim=0)
