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
// output.  Lengths are any powers of two from 2.  The TPU kernel runs
// the 7 innermost stages as one 128 x 128 MXU group matmul with a 3-pass
// bf16 split, a way around the TPU's matmul precision; here every stage
// is an f32 radix-2 butterfly, each product and sum rounded on its own.
//
// What bounds it on an H100: it reads 1 (real) or 2 planes and writes 2,
// once each, against 5 n log2(n) flops per length-n transform: ~3.4
// flops per byte at n = 2048, far under the card's ~20, so bytes bound.
//
// Axis 2 (rows of W): from 128 points up, the row engine of kernels 1, 4
// and 7 (row_pass.cuh): W / 16 threads hold a row, 16 points each, running
// up to four radix-2 stages a pass in registers; the passes exchange
// through padded shared memory inside one launch (3 barriers at W =
// 2048), rows under 2048 points several to a block.  The forward's first
// pass reads its points straight from the row (a warp's reads of one
// point are consecutive lanes); its last pass holds 16 consecutive
// bit-reversed lanes a thread and stores them as four 16-byte words.  The
// inverse's first pass loads 2^K consecutive bit-reversed lanes a group
// by 16-byte loads (both planes must start on 16 bytes), and its last
// pass stores natural lanes a warp-wide row segment at a time, times
// `scale` (one rounded product, as before).  Twiddles: the compact table
// (spectral/radix2.py::compact_twiddles, W - 1 words) in L1.  The stage
// order, the butterflies and the twiddle words are pbmm_radix2's, and the
// real input's first stage is the stage-by-stage kernel's
// (fa_real_first_stage), so every output is bit for bit the one the
// stage-by-stage design it replaces computes (one block a row, a barrier
// after each stage, 0.078 ms for the inverse at (1, 2048, 2048) against
// 0.051 for torch.fft.ifft along dim -1); kernel 1 equals it on a zero
// imaginary plane, and kernel 7 is it + torch's |z|.  Lengths 2 to 64 keep
// that stage-by-stage kernel (fft_rows_kernel): a routing by length.
// Axis 1 (columns of H): col_pass.cuh's engine, shared with kernel 5.  The
// strip-of-8 design
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
// for the strip-of-8 design; its two passes move 134 MB at 2.4 TB/s.  The
// row pass's times on the row engine are in PERF.md.
// A row of 16384 points runs in one block (1024 threads, 139 KB: faster
// than the bracket at that length, PERF.md).  Longer rows run
// col_pass.cuh's bracket: the forward's outer stages as passes through the
// output planes
// (fa_rows_bracket; the first reads the input, REAL its real first
// stage), then the row engine on each 8192-point block in place, the
// scale in its store; the inverse the other way round, the scale in the
// last bracket pass.  Columns of any length take the column engine's
// passes (three at 16384).

#include "col_pass.cuh"
#include "common.cuh"
#include "row_pass.cuh"

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

// All stages of one row held in shared memory (rows of 2 to 64 points).
template <bool INVERSE, bool REAL>
__device__ __forceinline__ void fa_stages(float* re, float* im, int n,
                                          const float* tw_re,
                                          const float* tw_im) {
  if (!REAL) {
    pbmm_radix2(re, im, n, 1, 1, 0, 0, 1, tw_re, tw_im, INVERSE);
    return;
  }
  fa_real_first_stage(re, im, n, tw_re, tw_im);
  __syncthreads();
  for (int s = 1; (1 << s) < n; ++s) {
    pbmm_radix2_stage(re, im, n, n >> (s + 1), 1, 1, 0, 0, 1, tw_re + s * n,
                      tw_im + s * n, false);
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

// A row pass of N = 128 .. 16384 points on the row engine (row_pass.cuh):
// rows of (B H) rows of N f32; REAL: im unread (forward only).
template <int N, bool INVERSE, bool REAL>
__global__ void __launch_bounds__(PBMM_RP_BOUND(N))
    fft_rows_engine_kernel(const float* __restrict__ re,
                           const float* __restrict__ im,
                           const float* __restrict__ tw_re,
                           const float* __restrict__ tw_im,
                           float* __restrict__ out_re,
                           float* __restrict__ out_im, long long rows,
                           float scale) {
  extern __shared__ float smem[];
  constexpr int NT = N / PBMM_RP_P;
  const int r = threadIdx.x / NT, t = threadIdx.x % NT;
  const long long row = (long long)blockIdx.x * pbmm_rp_rows_per_block(N) + r;
  const bool valid = row < rows;
  float* sre = smem + (size_t)r * pbmm_rp_row_floats(N);
  float* sim = sre + pbmm_rp_pad(N);
  const size_t base = (size_t)(valid ? row : 0) * N;  // past the end: row 0
  const float* src_re = re + base;
  const float* src_im = REAL ? nullptr : im + base;
  float* dre = out_re + base;
  float* dim = out_im + base;
  const bool scaled = scale != 1.0f;
  auto load = [&](const auto& gr, float (&xr)[PBMM_RP_P],
                  float (&xi)[PBMM_RP_P]) {
    using G = PbmmRpOf<decltype(gr)>;
    if constexpr (!INVERSE) {
      // First DIF pass: base = g < st, point q of group j is lane g + q st.
#pragma unroll
      for (int j = 0; j < G::J; ++j)
#pragma unroll
        for (int q = 0; q < G::L; ++q) {
          xr[j * G::L + q] = __ldg(src_re + gr.pos(j, q));
          xi[j * G::L + q] = REAL ? 0.0f : __ldg(src_im + gr.pos(j, q));
        }
    } else {
      // First DIT pass (st = 1): 2^K consecutive lanes a group.
      static_assert(G::L % 4 == 0, "the first DIT pass runs 2 stages or more");
#pragma unroll
      for (int j = 0; j < G::J; ++j) {
        const float4* a = reinterpret_cast<const float4*>(src_re + gr.base[j]);
        const float4* b = reinterpret_cast<const float4*>(src_im + gr.base[j]);
#pragma unroll
        for (int c = 0; c < G::L / 4; ++c) {
          const float4 u = __ldg(a + c), v = __ldg(b + c);
          const int e = j * G::L + 4 * c;
          xr[e] = u.x; xr[e + 1] = u.y; xr[e + 2] = u.z; xr[e + 3] = u.w;
          xi[e] = v.x; xi[e + 1] = v.y; xi[e + 2] = v.z; xi[e + 3] = v.w;
        }
      }
    }
  };
  auto out = [&](float x) { return scaled ? __fmul_rn(x, scale) : x; };
  auto store = [&](const auto& gr, const float (&xr)[PBMM_RP_P],
                   const float (&xi)[PBMM_RP_P]) {
    using G = PbmmRpOf<decltype(gr)>;
    if (!valid) return;
    if constexpr (!INVERSE) {
      // Last DIF pass, its groups adjacent: 2^K J consecutive lanes.
      static_assert(G::L % 4 == 0, "the last DIF pass runs 2 stages or more");
#pragma unroll
      for (int j = 0; j < G::J; ++j)
#pragma unroll
        for (int c = 0; c < G::L / 4; ++c) {
          const int e = j * G::L + 4 * c;
          reinterpret_cast<float4*>(dre + gr.base[j])[c] = make_float4(
              out(xr[e]), out(xr[e + 1]), out(xr[e + 2]), out(xr[e + 3]));
          reinterpret_cast<float4*>(dim + gr.base[j])[c] = make_float4(
              out(xi[e]), out(xi[e + 1]), out(xi[e + 2]), out(xi[e + 3]));
        }
    } else {
      // Last DIT pass: base = g < st, point q of group j is lane g + q st.
#pragma unroll
      for (int j = 0; j < G::J; ++j)
#pragma unroll
        for (int q = 0; q < G::L; ++q) {
          dre[gr.pos(j, q)] = out(xr[j * G::L + q]);
          dim[gr.pos(j, q)] = out(xi[j * G::L + q]);
        }
    }
  };
  pbmm_row_transform<N, INVERSE, !INVERSE, REAL>(t, sre, sim, tw_re, tw_im,
                                                 ~0ull, load, store);
}

// One bracket pass of rows of n points (col_pass.cuh): thread (row, group).
// EDGE: the pass that meets the caller's planes, the first of the forward
// (it reads re / im; REAL: no imaginary plane, its first stage real) or
// the last of the inverse (it writes the output times `scale`); the other
// passes run in place on the output planes.
template <int L, bool INVERSE, bool REAL, bool EDGE>
__global__ void __launch_bounds__(PBMM_BK_THREADS)
    fa_rows_bracket(const float* re, const float* im, float* out_re,
                    float* out_im, const float* __restrict__ tw_re,
                    const float* __restrict__ tw_im, long long n, int lst,
                    float scale) {
  constexpr int K = pbmm_log2(L);
  constexpr bool FROM_IN = !INVERSE && EDGE;
  constexpr bool REAL_IN = REAL && FROM_IN;
  const long long g = (long long)blockIdx.y * PBMM_BK_THREADS + threadIdx.x;
  if (g >= (n >> K)) return;
  const long long st = 1ll << lst;
  const int base = pbmm_cp_base<K>((int)g, lst);
  const size_t row = (size_t)blockIdx.x * n;
  const float* sr = (FROM_IN ? re : out_re) + row + base;
  const float* si = (FROM_IN ? im : out_im) + row + base;
  float xr[L], xi[L];
#pragma unroll
  for (int q = 0; q < L; ++q) {
    xr[q] = __ldcs(sr + q * st);
    xi[q] = REAL_IN ? 0.0f : __ldcs(si + q * st);
  }
  pbmm_cp_stages<L, INVERSE, REAL_IN, true>(base, lst, 0, 0, xr, xi, tw_re,
                                            tw_im);
  const bool scaled = INVERSE && EDGE && scale != 1.0f;
  float* dr = out_re + row + base;
  float* di = out_im + row + base;
#pragma unroll
  for (int q = 0; q < L; ++q) {
    dr[q * st] = scaled ? __fmul_rn(xr[q], scale) : xr[q];
    di[q * st] = scaled ? __fmul_rn(xi[q], scale) : xi[q];
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
  if (axis == 2 && w > PBMM_RP_BLOCKN) {
    // The bracket around the row engine on the rows' 8192-point blocks.
    const long long rows = (long long)b * h;
    const long long blocks = rows * (w / PBMM_BK_N);
    const size_t smem = (size_t)pbmm_rp_row_floats(PBMM_BK_N) * sizeof(float);
    if (rows > 2147483647LL || blocks > 2147483647LL)
      return cudaErrorInvalidValue;
    auto bracket = [&](const PbmmCpPass& p, bool first,
                       bool last) -> cudaError_t {
      const dim3 grid((unsigned)rows,
                      (unsigned)(((w >> p.k) + PBMM_BK_THREADS - 1) /
                                 PBMM_BK_THREADS));
      const bool edge = INVERSE ? last : first;
#define FA_BK(L)                                                            \
  if (edge)                                                                 \
    fa_rows_bracket<L, INVERSE, REAL, true><<<grid, PBMM_BK_THREADS, 0,     \
                                              stream>>>(                    \
        re, im, out_re, out_im, tw_re, tw_im, w, p.lst, scale);             \
  else                                                                      \
    fa_rows_bracket<L, INVERSE, false, false><<<grid, PBMM_BK_THREADS, 0,   \
                                                stream>>>(                  \
        re, im, out_re, out_im, tw_re, tw_im, w, p.lst, scale)
      PBMM_CP_SWITCH(p.k, FA_BK)
#undef FA_BK
      return cudaGetLastError();
    };
    // The row engine on every 8192-point block: the inverse's first step
    // (input -> output), the forward's last (in place, scaled).
    auto inner = [&](const float* ir, const float* ii, float sc) {
      cudaError_t err = pbmm_smem_opt_in(
          fft_rows_engine_kernel<PBMM_BK_N, INVERSE, false>, smem);
      if (err != cudaSuccess) return err;
      fft_rows_engine_kernel<PBMM_BK_N, INVERSE, false>
          <<<(unsigned)blocks, PBMM_BK_N / PBMM_RP_P, smem, stream>>>(
              ir, ii, tw_re, tw_im, out_re, out_im, blocks, sc);
      return cudaGetLastError();
    };
    if (INVERSE) {
      cudaError_t err = inner(re, im, 1.0f);
      if (err != cudaSuccess) return err;
      return pbmm_bracket_launch(w, true, bracket);
    }
    cudaError_t err = pbmm_bracket_launch(w, false, bracket);
    if (err != cudaSuccess) return err;
    return inner(out_re, out_im, scale);
  } else if (axis == 2 && w >= PBMM_RP_MINN) {

    const long long rows = (long long)b * h;
    const int rpb = pbmm_rp_rows_per_block(w);
    const long long blocks = (rows + rpb - 1) / rpb;
    const size_t smem = (size_t)rpb * pbmm_rp_row_floats(w) * sizeof(float);
#define FA_ROWS(N)                                                          \
  {                                                                         \
    cudaError_t err =                                                       \
        pbmm_smem_opt_in(fft_rows_engine_kernel<N, INVERSE, REAL>, smem);   \
    if (err != cudaSuccess) return err;                                     \
    fft_rows_engine_kernel<N, INVERSE, REAL>                                \
        <<<(unsigned)blocks, rpb * (N / PBMM_RP_P), smem, stream>>>(        \
            re, im, tw_re, tw_im, out_re, out_im, rows, scale);             \
  }
    switch (w) {
      case 128: FA_ROWS(128); break;
      case 256: FA_ROWS(256); break;
      case 512: FA_ROWS(512); break;
      case 1024: FA_ROWS(1024); break;
      case 2048: FA_ROWS(2048); break;
      case 4096: FA_ROWS(4096); break;
      case 8192: FA_ROWS(8192); break;
      case 16384: FA_ROWS(16384); break;
      default: return cudaErrorInvalidValue;
    }
#undef FA_ROWS
  } else if (axis == 2) {
    const size_t smem = 2 * (size_t)w * sizeof(float);
    cudaError_t err = pbmm_smem_opt_in(fft_rows_kernel<INVERSE, REAL>, smem);
    if (err != cudaSuccess) return err;
    fft_rows_kernel<INVERSE, REAL><<<(unsigned)((size_t)b * h), 256, smem,
                                     stream>>>(re, im, tw_re, tw_im, out_re,
                                               out_im, w, scale);
  } else {
    const PbmmColPass a = {re, im, out_re, out_im, tw_re, tw_im, h, w, h,
                           0, 0, 0, 1.0f};
#define FA_COLS(L) fft_cols_pass<L, INVERSE, R><<<grid, block, 0, stream>>>(a)
    auto first = [](int k, dim3 grid, dim3 block, const PbmmColPass& a,
                    cudaStream_t stream) -> cudaError_t {
      constexpr bool R = REAL;
      PBMM_CP_SWITCH(k, FA_COLS)
      return cudaGetLastError();
    };
    auto rest = [](int k, dim3 grid, dim3 block, const PbmmColPass& a,
                   cudaStream_t stream) -> cudaError_t {
      constexpr bool R = false;
      PBMM_CP_SWITCH(k, FA_COLS)
      return cudaGetLastError();
    };
#undef FA_COLS
    return pbmm_col_launch(a, b, first, rest, INVERSE, false, scale,
                           stream);
  }
  return cudaGetLastError();
}

// im null: real input (forward only).  axis 1 = H, 2 = W.  tw_re / tw_im:
// compact_twiddles(n, inverse) for a row pass of 128 points or more (the
// row engine and its bracket above 8192), else _dif_twiddles(n, inverse).
// The row engine's inverse takes planes that start on 16 bytes.
extern "C" int pbmm_fft_axis(const float* re, const float* im,
                             const float* tw_re, const float* tw_im,
                             float* out_re, float* out_im, int b, int h,
                             int w, int axis, int inverse, float scale,
                             void* stream) {
  const int n = axis == 1 ? h : w;
  if (b < 1 || h < 1 || w < 1 || (axis != 1 && axis != 2) || n < 2 ||
      (n & (n - 1)) != 0 || (inverse && im == nullptr) ||
      (axis == 1 && b > 65535) || (axis == 2 && (size_t)b * h > 2147483647u))
    return (int)cudaErrorInvalidValue;
  if (axis == 2 && n >= PBMM_RP_MINN && inverse &&
      ((size_t)re % 16 != 0 || (size_t)im % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
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
