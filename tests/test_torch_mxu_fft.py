"""The port's four-step matmul FFT backend (`fft_backend="mxu"`,
`pbmm_tpu_torch/spectral/mxu_fft.py`) against the JAX package's, on the
CPU: every case of `tests/test_mxu_fft.py` at its sizes, each held both
to `jnp.fft` (2e-5 of the largest magnitude, the JAX tests' bar) and to
the JAX `rfft2_mxu` / `irfft2_mxu` / `fft2_mxu` on the same input (1e-5),
the inverse's Hermitian extension at 16, 32, 512 and 2048 lanes; the pipeline
end to end against the JAX backend (> 100 dB) and the port's xla backend
(> 70 dB); `magnify_video` over two chunks with the state threaded; and
the matmul-precision guard, which raises on a CUDA tensor when TF32 is
allowed and never changes the process's setting itself."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbmm_tpu.config import MagnifyConfig as JCfg
from pbmm_tpu.engine.pipeline import magnify_frame_pair as jpair
from pbmm_tpu.engine.video import magnify_video as jmagnify
from pbmm_tpu.oracle.synthetic import oscillating_gaussian_blob
from pbmm_tpu.spectral import mxu_fft as jmxu
from pbmm_tpu.utils.metrics import psnr
from pbmm_tpu_torch import MagnifyConfig, magnify_frame_pair, magnify_video
from pbmm_tpu_torch.spectral import mxu_fft


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel worker processes, and PyTorch's default of one OpenMP thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _max_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _case(kind, h, w):
    """(port result, jnp.fft result, JAX mxu result) on seeded input."""
    rng = np.random.default_rng(7)
    if kind == "fft2":
        y = rng.standard_normal((3, h, w)).astype(np.float32)
        return (mxu_fft.fft2_mxu(torch.from_numpy(y)).numpy(),
                np.asarray(jnp.fft.fft2(y.astype(np.complex64))),
                np.asarray(jmxu.fft2_mxu(jnp.asarray(y))))
    if kind == "roundtrip":
        x = rng.random((h, w)).astype(np.float32)
        back = mxu_fft.irfft2_mxu(mxu_fft.rfft2_mxu(torch.from_numpy(x)), w)
        jback = jmxu.irfft2_mxu(jmxu.rfft2_mxu(jnp.asarray(x)), w)
        return back.numpy(), x, np.asarray(jback)
    y = rng.standard_normal((2, h, w)).astype(np.float32)
    if kind == "rfft2":
        return (mxu_fft.rfft2_mxu(torch.from_numpy(y)).numpy(),
                np.asarray(jnp.fft.rfft2(y)),
                np.asarray(jmxu.rfft2_mxu(jnp.asarray(y))))
    spec = np.asarray(jnp.fft.rfft2(y))
    return (mxu_fft.irfft2_mxu(torch.from_numpy(spec.copy()), w).numpy(),
            np.asarray(jnp.fft.irfft2(spec, s=(h, w))),
            np.asarray(jmxu.irfft2_mxu(jnp.asarray(spec), w)))


@pytest.mark.parametrize("kind,h,w", [
    ("rfft2", 16, 16), ("rfft2", 64, 32), ("rfft2", 128, 256),
    ("rfft2", 256, 512),
    # irfft2: the Hermitian tail at pad_w = 16, 32, 512 and 2048 lanes.
    ("irfft2", 16, 16), ("irfft2", 64, 32), ("irfft2", 256, 512),
    ("irfft2", 16, 2048),
    ("fft2", 64, 128), ("roundtrip", 256, 512),
])
def test_transforms_match_jax(kind, h, w):
    got, spec, jax_mxu = _case(kind, h, w)
    assert got.shape == spec.shape == jax_mxu.shape
    assert got.dtype == (np.complex64 if kind in ("rfft2", "fft2")
                         else np.float32)
    if kind == "roundtrip":
        # The JAX test's bar: the round trip within 2e-4 of the input.
        np.testing.assert_allclose(got, spec, atol=2e-4)
    else:
        assert _max_rel(got, spec) < 2e-5
    assert _max_rel(got, jax_mxu) < 1e-5


def test_mxu_requires_rfft():
    for cfg_cls in (MagnifyConfig, JCfg):
        with pytest.raises(ValueError):
            cfg_cls(fft_backend="mxu", use_rfft=False)


def test_pipeline_mxu_against_jax_and_xla():
    """`magnify_frame_pair` at 40x56 (square_pow2: 64x64), smooth motion
    away from atan2's cut: the port's mxu against the JAX package's mxu
    (> 100 dB) and against the port's xla backend (> 70 dB, the JAX
    test's bar between the two backends)."""
    rng = np.random.default_rng(7)
    prev = rng.random((40, 56, 3)).astype(np.float32)
    cur = np.roll(prev, 1, axis=1)
    base = MagnifyConfig(phase_scale=10.0)
    mxu = base.replace(fft_backend="mxu")
    got = magnify_frame_pair(prev, cur, mxu, device="cpu").numpy()
    want = np.asarray(jpair(prev, cur, JCfg(phase_scale=10.0,
                                            fft_backend="mxu")))
    assert got.shape == (40, 56, 3)
    assert psnr(got, want) > 100
    xla = magnify_frame_pair(prev, cur, base, device="cpu").numpy()
    assert psnr(got, xla) > 70


def test_magnify_video_two_chunks_against_jax():
    """The scan engine with the mxu transforms on a 64x64 clip, two
    chunks with the state threaded, against the JAX package's."""
    clip = oscillating_gaussian_blob(height=64, width=64, frames=6)
    cfg = MagnifyConfig(fft_backend="mxu", phase_scale=10.0)
    jcfg = JCfg(fft_backend="mxu", phase_scale=10.0)
    o1, s1 = magnify_video(torch.from_numpy(clip[:3]), cfg)
    o2, s2 = magnify_video(torch.from_numpy(clip[3:]), cfg, s1)
    j1, js1 = jmagnify(clip[:3], jcfg)
    j2, _ = jmagnify(clip[3:], jcfg, js1)
    got = np.concatenate([o1.numpy(), o2.numpy()])
    want = np.concatenate([np.asarray(j1), np.asarray(j2)])
    assert got.shape == (6, 64, 64, 3) and s2.frame_idx == 6
    assert psnr(got, want) > 100
    # The state carries the rfft half spectrum the transform gave.
    assert tuple(s2.prev_spec_re.shape)[-1] == 64 // 2 + 1


@pytest.mark.parametrize("setting,raises", [
    ("highest", False), ("high", True), ("medium", True),
    ("allow_tf32", True)])
def test_precision_guard(setting, raises):
    """On a CUDA tensor (stood in for by its `is_cuda` flag: this
    machine has no card) the guard raises while float32 products may
    round to TF32 or bf16, naming the setting; the transforms leave the
    process's setting as they found it; on the CPU it does not apply."""
    before = (torch.get_float32_matmul_precision(),
              torch.backends.cuda.matmul.allow_tf32)
    cuda_like = types.SimpleNamespace(is_cuda=True)
    try:
        if setting == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision(setting)
        if raises:
            with pytest.raises(ValueError, match="IEEE float32"):
                mxu_fft.check_matmul_precision(cuda_like)
        else:
            mxu_fft.check_matmul_precision(cuda_like)
        y = torch.from_numpy(
            np.random.default_rng(3).random((8, 16), np.float32))
        now = (torch.get_float32_matmul_precision(),
               torch.backends.cuda.matmul.allow_tf32)
        back = mxu_fft.irfft2_mxu(mxu_fft.rfft2_mxu(y), 16)
        assert (torch.get_float32_matmul_precision(),
                torch.backends.cuda.matmul.allow_tf32) == now
        assert float((back - y).abs().max()) < 1e-5
    finally:
        torch.set_float32_matmul_precision(before[0])
        torch.backends.cuda.matmul.allow_tf32 = before[1]
    assert (torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32) == before


@pytest.mark.parametrize("shape,inverse", [
    ((2, 64, 256), False), ((2, 64, 256), True), ((1, 16, 2048), False),
    ((3, 32, 512), True)])
def test_work_count_follows_the_code(monkeypatch, shape, inverse):
    """`tools/roofline.py::mxu_transform_work` (the bound chip_smoke.py
    prints beside the transforms' times) counts the f32 operations the
    transforms issue: each product 2 K an output element, each elementwise
    product, sum, difference and negation one, counted here by wrapping
    the tensor operators while a transform runs."""
    from pbmm_tpu_torch.tools.roofline import mxu_transform_work

    ops = [0]

    def counted(name, per_out):
        orig = getattr(torch.Tensor, name)

        def op(*args):
            out = orig(*args)
            ops[0] += per_out(*args) * out.numel()
            return out
        monkeypatch.setattr(torch.Tensor, name, op)

    counted("__matmul__", lambda a, b: 2 * a.shape[-1])
    for name in ("__mul__", "__add__", "__sub__"):
        counted(name, lambda a, b: 1)
    counted("__neg__", lambda a: 1)
    y = torch.from_numpy(
        np.random.default_rng(4).standard_normal(shape).astype(np.float32))
    if inverse:
        spec = torch.fft.rfft2(y)
        ops[0] = 0
        mxu_fft.irfft2_mxu(spec, shape[-1])
    else:
        mxu_fft.rfft2_mxu(y)
    monkeypatch.undo()
    assert ops[0] == mxu_transform_work(shape, inverse)[1]
