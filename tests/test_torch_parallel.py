"""The port's batched and ("data", "frame")-sharded clip engines
(`pbmm_tpu_torch.parallel.sharding`) against the JAX package's
(`tests/test_parallel.py`): the mesh shapes, `magnify_clip_batched` here
on the CPU, `magnify_batch_sharded` in a real gloo world of 4 CPU
processes (spawned through `pbmm_tpu_torch.tools.multihost`'s worker
mode, which imports the port only) against the JAX engine on the same
mesh shapes of the 8 virtual CPU devices (Pallas in interpret mode), a
world of one in this process, and the traffic model."""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from pbmm_tpu.config import MagnifyConfig, TemporalConfig
from pbmm_tpu.core.window import geometry_for
from pbmm_tpu.engine.pipeline import hermitian_active
from pbmm_tpu.oracle.reference import oracle_magnify_video
from pbmm_tpu.oracle.synthetic import oscillating_gaussian_blob
from pbmm_tpu.parallel import model as jmodel
from pbmm_tpu.parallel.sharding import (
    magnify_batch_sharded as jax_sharded,
    magnify_clip_batched as jax_batched,
)
from pbmm_tpu.utils.metrics import psnr
from pbmm_tpu_torch.parallel import launcher, model, sharding, spatial
from pbmm_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for
from pbmm_tpu_torch.tools import multihost
from pbmm_tpu_torch.tools.multihost import make_config

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices"
)

CLIP = oscillating_gaussian_blob(height=48, width=48, frames=8)
# The fused path's kernels 1 and 7 take rows of 128 lanes and more.
CLIP128 = oscillating_gaussian_blob(height=96, width=96, frames=8)
HERM = oscillating_gaussian_blob(height=200, width=300, frames=4)
DEFAULT = {}
TUNED = {"tuned": True, "fields": {"interpret_pallas": True}}


def _jcfg(spec):
    fields = dict(spec.get("fields", {}))
    if "temporal" in fields:
        fields["temporal"] = TemporalConfig(**fields["temporal"])
    cfg = MagnifyConfig(**fields)
    return cfg.tuned_for_tpu() if spec.get("tuned") else cfg


def _jmesh(shape):
    return Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(
        shape), ("data", "frame"))


@pytest.mark.parametrize("n,videos,want", [
    (8, 1, (1, 8)), (8, 4, (4, 2)), (8, 64, (8, 1)), (1, 1, (1, 1))])
def test_mesh_shape_for(n, videos, want):
    assert mesh_shape_for(n, n_videos=videos) == want


@pytest.mark.parametrize("spec,clip", [(DEFAULT, CLIP), (TUNED, CLIP128)],
                         ids=["default", "tuned"])
def test_batched_matches_jax(spec, clip):
    got = sharding.magnify_clip_batched(clip, make_config(spec),
                                        device="cpu").numpy()
    want = np.asarray(jax_batched(clip, _jcfg(spec)))
    assert got.shape == clip.shape
    assert psnr(got, want) > 70.0


def test_batched_tuned_vs_oracle():
    got = sharding.magnify_clip_batched(CLIP128, make_config(TUNED),
                                        device="cpu").numpy()
    want = oracle_magnify_video(CLIP128[:4], _jcfg(TUNED))
    assert psnr(got[:4], want) > 100.0


def test_batched_rejects_iir_mode():
    cfg = make_config({"fields": {"temporal": {"mode": "iir_bandpass"}}})
    with pytest.raises(ValueError, match="two-frame"):
        sharding.magnify_clip_batched(CLIP, cfg, device="cpu")


# name -> (mesh shape, config spec, batch)
BATCHES = {"two": np.stack([CLIP, CLIP[:, ::-1]]), "one": CLIP[None],
           "two128": np.stack([CLIP128, CLIP128[:, ::-1]]),
           "one128": CLIP128[None], "herm": np.stack([HERM, HERM[:, ::-1]])}
SHARDED = {
    "data2_frame2": ((2, 2), DEFAULT, "two"),
    "data1_frame4": ((1, 4), DEFAULT, "one"),
    "data2_frame2_tuned": ((2, 2), TUNED, "two128"),
    "data1_frame4_tuned": ((1, 4), TUNED, "one128"),
    "data2_frame2_tuned_hermitian": ((2, 2), TUNED, "herm"),
    "iir": ((2, 2), {"fields": {"temporal": {"mode": "iir_bandpass"}}},
            "two"),
    "mesh_mismatch": ((2, 3), DEFAULT, "two"),
}


@pytest.fixture(scope="module")
def port_sharded():
    """{case: the gathered (B, T, H, W, 3) output or the error text}, from
    one gloo world of 4 processes."""
    cases = [{"name": name, "engine": "batch_sharded", "mesh": list(shape),
              "axes": ["data", "frame"], "config": spec, "inputs": [batch]}
             for name, (shape, spec, batch) in SHARDED.items()]
    arrays = {k: np.ascontiguousarray(v, np.float32)
              for k, v in BATCHES.items()}
    outs, report = multihost.run_cases(cases, arrays, 4, "cpu", timeout=300)
    yield {name: info.get("error", outs.get(name))
           for name, info in report["cases"].items()}
    jax.clear_caches()


@pytest.mark.parametrize("name", [n for n in SHARDED
                                  if n not in ("iir", "mesh_mismatch")])
def test_sharded_matches_jax(port_sharded, name):
    shape, spec, batch = SHARDED[name]
    got = port_sharded[name]
    assert isinstance(got, np.ndarray), got
    want = np.asarray(jax_sharded(BATCHES[batch], _jcfg(spec),
                                  _jmesh(shape)))
    assert got.shape == want.shape
    assert np.array_equal(got, want) or psnr(got, want) > 70.0


def test_sharded_tuned_hermitian_active():
    """The kept-width spectra cross the frame-rank halo at 200x300."""
    assert hermitian_active(_jcfg(TUNED), geometry_for(200, 300))


def test_sharded_rejections(port_sharded):
    assert "two-frame" in port_sharded["iir"]
    assert "mesh shape (2, 3) != 4 devices" in port_sharded["mesh_mismatch"]
    with pytest.raises(ValueError, match="two-frame"):
        jax_sharded(BATCHES["two"], _jcfg(SHARDED["iir"][1]), _jmesh((2, 2)))


@pytest.fixture
def world_of_one():
    """A gloo world of one in this process, destroyed after the test."""
    launcher.init_world(f"tcp://127.0.0.1:{launcher.free_port()}", 1, 0,
                        torch.device("cpu"))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_world_of_one(world_of_one):
    """The engines on a world of one, as on one card: the (1, 1) sharded
    run equals `magnify_clip_batched` bit for bit, the spatial engine on a
    ("rows",) mesh of one returns the whole clip and matches the
    single-device `magnify_video` under the same config, and the
    launcher's helpers see one rank."""
    from pbmm_tpu_torch.engine.video import magnify_video

    cfg = make_config(TUNED)
    mesh = launcher.global_mesh(n_videos=4)
    assert tuple(mesh.mesh.shape) == (1, 1)
    assert launcher.host_local_batch_slice(5) == (0, 5)
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh((2, 1))
    batch = torch.from_numpy(BATCHES["one128"])
    block = sharding.local_block(batch, mesh)
    out = sharding.gather_blocks(
        sharding.magnify_batch_sharded(block, cfg, mesh), mesh)
    assert torch.equal(out[0], sharding.magnify_clip_batched(batch[0], cfg))
    rows = make_mesh((1,), ("rows",))
    clip = torch.from_numpy(CLIP128[:4])
    got = spatial.magnify_video_spatial(clip, cfg, rows)
    assert torch.equal(spatial.gather_spatial(got, rows), got)
    want, _ = magnify_video(clip, cfg)
    assert got.shape == want.shape
    assert psnr(got.numpy(), want.numpy()) > 70.0


def test_launcher_single_process(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert launcher.initialize_distributed() is False
    assert launcher.rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launcher.rank_device()


def test_frame_axis_traffic():
    t = model.frame_axis_traffic(2048, 1152, frames_per_shard=16)
    # one (2048, 1152) f32 re/im pair per 16-frame chunk
    assert t.bytes_per_frame == 2 * 2048 * 1152 * 4 / 16
    assert t.bytes_per_frame == jmodel.frame_axis_traffic(
        2048, 1152, 16).bytes_per_frame


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_rows_axis_traffic(n_dev):
    t = model.rows_axis_traffic(2048, 2048, n_dev=n_dev, blur_radius=2)
    a2a = 2 * (2048 * 2048 * 2 * 4) * (n_dev - 1) / n_dev
    halo = 2 * 4 * 2048 * 4
    assert t.bytes_per_frame == a2a + halo
    assert t.bytes_per_frame == jmodel.rows_axis_traffic(
        2048, 2048, n_dev, 2).bytes_per_frame


def test_efficiency_bounds_ordering():
    """The bounds at an explicit link rate: the frame axis's tiny halo
    above the rows axis's all-to-alls, which fall with the device count;
    equal to the JAX model's at the same rate."""
    rows = model.scaling_table(1080, 1920, "square_pow2",
                               compute_ms_per_frame=0.45, link_gbps=200.0)
    frame_row = rows[0]
    assert frame_row["axis"] == "frame"
    assert frame_row["efficiency_bound_no_overlap"] >= 0.98
    effs = [r["efficiency_bound_no_overlap"] for r in rows[1:]]
    assert all(e < frame_row["efficiency_bound_no_overlap"] for e in effs)
    assert effs == sorted(effs, reverse=True)
    want = jmodel.scaling_table(1080, 1920, "square_pow2", 0.45)
    assert effs == [r["efficiency_bound_no_overlap"] for r in want[1:]]
    with pytest.raises(ValueError, match="link_gbps"):
        model.efficiency_bound(0.45, model.frame_axis_traffic(8, 8, 1), 0.0)
