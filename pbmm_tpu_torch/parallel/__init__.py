"""Multi-device engines on `torch.distributed` (counterpart of
`pbmm_tpu/parallel/`): the ("data", "frame") sharded batch
(`sharding.py`), the rows-sharded spatial engine (`spatial.py`), the mesh
(`mesh.py`), the launcher (`launcher.py`) and the traffic model
(`model.py`).  On one card the engines run a world of one."""

from pbmm_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for
from pbmm_tpu_torch.parallel.sharding import (
    gather_blocks,
    local_block,
    magnify_batch_sharded,
    magnify_clip_batched,
)
from pbmm_tpu_torch.parallel.spatial import (
    gather_spatial,
    magnify_frame_pair_spatial,
    magnify_video_spatial,
)

__all__ = [
    "make_mesh",
    "mesh_shape_for",
    "magnify_clip_batched",
    "magnify_batch_sharded",
    "local_block",
    "gather_blocks",
    "magnify_video_spatial",
    "magnify_frame_pair_spatial",
    "gather_spatial",
]
