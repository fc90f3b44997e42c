// Kernel 8: a radix-2 FFT along one axis of (B, H, W) f32 planes.
//
// Replaces pbmm_tpu/spectral/pallas_fft.py:405 _fft_axis (the Pallas
// kernel launched at :464), reached through fft2_bitrev / ifft2_bitrev
// (:486, :495): the unfused fft_backend="pallas" path's inverse
// (engine/pipeline.py::reconstruct).  The layout contract is the JAX
// one: the forward transform is decimation in frequency (natural order
// in, bit-reversed out), with a first stage that reads no imaginary plane
// when the input is real; the inverse is decimation in time (bit-reversed
// in, natural out), unnormalised but for `scale`, which multiplies the
// output.  Lengths are powers of two from 2 to 8192.  The TPU kernel runs
// the 7 innermost stages as one 128 x 128 MXU group matmul with a 3-pass
// bf16 split, a way around the TPU's matmul precision; here every stage
// is an f32 radix-2 butterfly, each product and sum rounded on its own.
//
// What bounds it on an H100: it reads 1 (real) or 2 planes and writes 2,
// once each, against 5 n log2(n) flops per length-n transform: ~3.4
// flops per byte at n = 2048, far under the card's ~20, so bytes bound.
//
// Axis 2 (rows of W): one block per row holds the row (2 W f32, 16 KB at
// W = 2048) in shared memory, every stage in place.  Axis 1 (columns of
// H): col_pass.cuh's engine, shared with kernel 5.  The strip-of-8 design
// it replaces held 8 columns of every row in shared memory (128 KB at
// H = 2048, one block of 8 warps an SM), read 32 bytes of each row, put
// its threads 8 floats apart (8-way bank conflicts on every stage) and
// synchronised after each of the 11 stages.  Now a warp owns 32
// neighbouring columns (128-byte row segments, the row-copy pattern), a
// thread holds up to 64 points of its column in registers and runs up to
// six stages there, and there is no shared memory and no barrier: two
// passes over the planes at H <= 4096, three at 8192.  The ragged last
// tile of columns is masked.  On an NVIDIA H100 80GB HBM3 at its 700 W
// limit (chip_smoke.py) the inverse column pass at (1, 2048, 2048) takes
// 0.055 ms warm, against 0.057 for torch.fft.ifft along dim -2 and 0.329
// for the strip-of-8 design; its two passes move 134 MB at 2.4 TB/s.

#include "col_pass.cuh"
#include "common.cuh"

#define FA_MAXN 8192  // longest transform (a row of it in shared memory)

// The forward DIF's first stage (d = n / 2) on a real row: im is
// written, never read (pallas_fft.py:331-347).
__device__ __forceinline__ void fa_real_first_stage(
    float* re, float* im, int n, const float* __restrict__ tw_re,
    const float* __restrict__ tw_im) {
  const int d = n >> 1;
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
    const float xr = re[k], ur = re[k + d];
    const float br = __fsub_rn(xr, ur);
    re[k] = __fadd_rn(xr, ur);
    im[k] = 0.0f;
    re[k + d] = __fmul_rn(br, __ldg(tw_re + k + d));
    im[k + d] = __fmul_rn(br, __ldg(tw_im + k + d));
  }
}

// All stages of one row held in shared memory.
template <bool INVERSE, bool REAL>
__device__ __forceinline__ void fa_stages(float* re, float* im, int n,
                                          const float* tw_re,
                                          const float* tw_im) {
  int stages = 0;
  while ((1 << stages) < n) ++stages;
  for (int s = 0; s < stages; ++s) {
    const int d = INVERSE ? (1 << s) : (n >> (s + 1));
    if (REAL && s == 0)
      fa_real_first_stage(re, im, n, tw_re, tw_im);
    else
      pbmm_radix2_stage(re, im, n, d, 1, 1, 0, 0, 1, tw_re + s * n,
                        tw_im + s * n, INVERSE);
    __syncthreads();
  }
}

template <bool INVERSE, bool REAL>
__global__ void __launch_bounds__(256)
    fft_rows_kernel(const float* __restrict__ re,
                    const float* __restrict__ im, const float* tw_re,
                    const float* tw_im, float* __restrict__ out_re,
                    float* __restrict__ out_im, int w, float scale) {
  extern __shared__ float smem[];
  float* xr = smem;
  float* xi = smem + w;
  const size_t base = (size_t)blockIdx.x * w;
  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    xr[i] = re[base + i];
    if (!REAL) xi[i] = im[base + i];
  }
  __syncthreads();
  fa_stages<INVERSE, REAL>(xr, xi, w, tw_re, tw_im);
  const bool scaled = scale != 1.0f;
  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    out_re[base + i] = scaled ? __fmul_rn(xr[i], scale) : xr[i];
    out_im[base + i] = scaled ? __fmul_rn(xi[i], scale) : xi[i];
  }
}

// One pass of the column transform (col_pass.cuh).  The min-blocks
// bound of 1 lets the 64-point pass keep up to 255 registers a thread
// (without it nvcc stops at 184 and the kernel runs slower), and the
// loads are evict-first: both measured against the alternatives on the
// card (PERF.md).
template <int L, bool INVERSE, bool REAL>
__global__ void __launch_bounds__(PBMM_CP_LANES * PBMM_CP_GROUPS, 1)
    fft_cols_pass(PbmmColPass a) {
  pbmm_col_pass<L, INVERSE, REAL, false, true>(a);
}

template <bool INVERSE, bool REAL>
static cudaError_t fa_launch(const float* re, const float* im,
                             const float* tw_re, const float* tw_im,
                             float* out_re, float* out_im, int b, int h,
                             int w, int axis, float scale,
                             cudaStream_t stream) {
  if (axis == 2) {
    const size_t smem = 2 * (size_t)w * sizeof(float);
    cudaError_t err = pbmm_smem_opt_in(fft_rows_kernel<INVERSE, REAL>, smem);
    if (err != cudaSuccess) return err;
    fft_rows_kernel<INVERSE, REAL><<<(unsigned)((size_t)b * h), 256, smem,
                                     stream>>>(re, im, tw_re, tw_im, out_re,
                                               out_im, w, scale);
  } else {
    const PbmmColPass a = {re, im, out_re, out_im, tw_re, tw_im, h, w, h,
                           0, 0, 0, 1.0f};
    auto first = [](int k, dim3 grid, dim3 block, const PbmmColPass& a,
                    cudaStream_t stream) -> cudaError_t {
      PBMM_CP_SWITCH(fft_cols_pass, INVERSE, REAL)
    };
    auto rest = [](int k, dim3 grid, dim3 block, const PbmmColPass& a,
                   cudaStream_t stream) -> cudaError_t {
      PBMM_CP_SWITCH(fft_cols_pass, INVERSE, false)
    };
    return pbmm_col_launch(a, b, first, rest, INVERSE, false, scale,
                           stream);
  }
  return cudaGetLastError();
}

// im null: real input (forward only).  axis 1 = H, 2 = W.
extern "C" int pbmm_fft_axis(const float* re, const float* im,
                             const float* tw_re, const float* tw_im,
                             float* out_re, float* out_im, int b, int h,
                             int w, int axis, int inverse, float scale,
                             void* stream) {
  const int n = axis == 1 ? h : w;
  if (b < 1 || h < 1 || w < 1 || (axis != 1 && axis != 2) || n < 2 ||
      (n & (n - 1)) != 0 || n > FA_MAXN || (inverse && im == nullptr) ||
      (axis == 1 && b > 65535) || (axis == 2 && (size_t)b * h > 2147483647u))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (inverse)
    err = fa_launch<true, false>(re, im, tw_re, tw_im, out_re, out_im, b, h,
                                 w, axis, scale, s);
  else if (im == nullptr)
    err = fa_launch<false, true>(re, im, tw_re, tw_im, out_re, out_im, b, h,
                                 w, axis, scale, s);
  else
    err = fa_launch<false, false>(re, im, tw_re, tw_im, out_re, out_im, b,
                                  h, w, axis, scale, s);
  return (int)err;
}
