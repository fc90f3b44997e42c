// Kernel 7: Hermitian rebuild + row IFFT + |z| (or Re z), the first half
// of the two-kernel tail.
//
// Replaces pbmm_tpu/spectral/fused.py:1236 row_ifft_magnitude (the Pallas
// kernel launched at :1294): each (Hb, Wk) row of bit-reversed kept lanes
// is rebuilt to the full width W by the static plan of
// spectral/hermitian.py::reconstruction_plan (the JAX kernel's
// _rebuild_kept_lanes, fused.py:1182), taken to natural order by a
// radix-2 DIT inverse, and |z| / (pad_h * W) (magnitude = 1) or
// Re z / (pad_h * W) (magnitude = 0, reconstruct="real") is written at
// full width.  The chunk engine runs it for chroma="rgb" (before kernel
// 11 or the torch posttail) and where post_pallas_ok is False (frame
// sizes the merged kernel 3 does not tile, e.g. 960x540).
//
// The load -> rebuild -> IFFT -> |z| step is pbmm_row_ifft_mag
// (common.cuh), the same code kernel 3 runs on each region row.
//
// What bounds it on an H100: a row reads 2 x Wk x 4 bytes and writes
// W x 4 bytes (~13 KB at W = 1024 with 5 of 8 tiles kept); the 10-12
// stages cost 5 W log2(W) flops.  Design: one block per (frame, row),
// the complex row in shared memory (2 x W floats: 32 KB at W = 4096),
// every stage in place between __syncthreads().  Simple and right first.

#include "common.cuh"

__global__ void row_ifft_kernel(const float* __restrict__ re,
                                const float* __restrict__ im,
                                const float* __restrict__ tw_re,
                                const float* __restrict__ tw_im,
                                float* __restrict__ out, PbmmLanePlan plan,
                                int hb, int wk, int w, float scale,
                                int magnitude) {
  extern __shared__ float smem[];
  const size_t rowid = (size_t)blockIdx.y * hb + blockIdx.x;
  pbmm_row_ifft_mag(re + rowid * wk, im + rowid * wk, plan, w, tw_re, tw_im,
                    smem, smem + w, out + rowid * w, scale,
                    magnitude != 0);
}

extern "C" int pbmm_row_ifft(const float* re, const float* im,
                             const float* tw_re, const float* tw_im,
                             float* out, const int* plan_src,
                             const int* plan_rev, int n_tiles, int batch,
                             int hb, int wk, int w, float scale,
                             int magnitude, void* stream) {
  if (batch < 1 || hb < 1 || n_tiles < 1 || n_tiles > PBMM_MAX_TILES ||
      n_tiles * PBMM_LANE != w || wk < PBMM_LANE || wk > w)
    return (int)cudaErrorInvalidValue;
  PbmmLanePlan plan;
  for (int i = 0; i < n_tiles; ++i) {
    if (plan_src[i] < 0 || (plan_src[i] + 1) * PBMM_LANE > wk)
      return (int)cudaErrorInvalidValue;
    plan.src[i] = plan_src[i];
    plan.rev[i] = plan_rev[i];
  }
  const size_t smem = 2 * (size_t)w * sizeof(float);
  cudaError_t err = pbmm_smem_opt_in(row_ifft_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(hb, batch);
  row_ifft_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      re, im, tw_re, tw_im, out, plan, hb, wk, w, scale, magnitude);
  return (int)cudaGetLastError();
}
