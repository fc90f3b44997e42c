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
// What bounds it on an H100: a row reads 2 x Wk x 4 bytes and writes
// W x 4 bytes (17 KB at W = 2048 with 9 of 16 tiles kept), against 5 W
// log2(W) flops: bytes bound if the butterflies keep up.  Design: the row
// engine of row_pass.cuh.  W / 16 threads hold a row, 16 points each: the
// first pass gathers its 16 bit-reversed positions (one run inside one
// tile) straight from the kept lanes with 16-byte loads, conjugated and
// lane-reversed where the plan rebuilds a missing tile; the passes
// exchange through shared memory (two barriers at W = 2048); the last DIT
// pass holds points W / 2^K apart, so each of its stores of |z| is a
// 128-byte row segment of a warp.  The compact twiddle table (W - 1 words)
// stays in L1.  The butterflies and their order are pbmm_radix2's (the
// stage-by-stage transform, and kernel 8's row pass on this engine), and
// |z| is rounded as torch rounds sqrt(re re + im im) * scale: the output
// is bit for bit
// kernel 8's row pass followed by torch's |z| (tests/test_torch_cuda.py,
// chip_smoke.py).  Kernel 3 (rowifft_post.cu) runs this load, transform
// and rounding on the same engine, so its |z| rows are these.  On an NVIDIA H100
// 80GB HBM3 at its 700 W limit (chip_smoke.py) it takes 0.156 ms warm at
// the 1080p shape (16 x 1152 rows, 1152 -> 2048 lanes: 321 MB, 2.1 TB/s),
// against 0.313 for torch.fft.irfft and 0.565 for the one-block-a-row
// design with a barrier after each stage that it replaces.
//
// The rebuild plan (kept source tile, conjugate-reversed flag per full
// tile) is a device table of fw / 128 entries each.  One block holds a
// row up to 16384 lanes (16K); longer rows run col_pass.cuh's bracket:
// ri_inner_kernel runs the rebuild load and the inner DIT stages on each
// 8192-lane block (its tiles read by their global numbers) into a complex
// scratch the wrapper allocates, then ri_bracket_kernel runs the outer
// DIT stages in place there, and its last pass writes |z| or Re z times
// the scale, rounded as above.

#include "col_pass.cuh"
#include "common.cuh"
#include "row_pass.cuh"

// |z| * scale (magnitude) or Re z * scale, rounded as torch rounds them.
__device__ __forceinline__ float ri_out(float a, float b, float scale,
                                        int magnitude) {
  return magnitude
             ? __fmul_rn(sqrtf(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b))),
                         scale)
             : __fmul_rn(a, scale);
}

template <int N>
__global__ void __launch_bounds__(PBMM_RP_BOUND(N))
    row_ifft_kernel(const float* __restrict__ re,
                    const float* __restrict__ im,
                    const float* __restrict__ tw_re,
                    const float* __restrict__ tw_im, float* __restrict__ out,
                    const int* __restrict__ plan_src,
                    const int* __restrict__ plan_rev, long long rows, int wk,
                    float scale, int magnitude) {
  extern __shared__ float smem[];
  constexpr int NT = N / PBMM_RP_P;
  const int r = threadIdx.x / NT, t = threadIdx.x % NT;
  const long long row = (long long)blockIdx.x * pbmm_rp_rows_per_block(N) + r;
  const bool valid = row < rows;
  float* sre = smem + (size_t)r * pbmm_rp_row_floats(N);
  float* sim = sre + pbmm_rp_pad(N);
  const float* src_re = re + (size_t)row * wk;
  const float* src_im = im + (size_t)row * wk;
  auto load = [&](const auto& gr, float (&xr)[PBMM_RP_P],
                  float (&xi)[PBMM_RP_P]) {
    pbmm_rp_rebuild_load(gr, xr, xi, src_re, src_im, plan_src, plan_rev, 0,
                         valid);
  };
  // Last DIT pass: base = g < st, so point q of group j is natural lane
  // g + q st, and a warp's stores of one (j, q) are consecutive.
  float* dst = out + (size_t)row * (PBMM_RP_P * NT);
  auto store = [&](const auto& gr, const float (&xr)[PBMM_RP_P],
                   const float (&xi)[PBMM_RP_P]) {
    using G = PbmmRpOf<decltype(gr)>;
    if (!valid) return;
#pragma unroll
    for (int j = 0; j < G::J; ++j) {
#pragma unroll
      for (int q = 0; q < G::L; ++q)
        dst[gr.pos(j, q)] =
            ri_out(xr[j * G::L + q], xi[j * G::L + q], scale, magnitude);
    }
  };
  pbmm_row_transform<N, true, false>(t, sre, sim, tw_re, tw_im, ~0ull, load,
                                     store);
}

// The inner DIT stages of a bracketed row: block blk of row `row` (vid =
// row blks + blk) rebuilt from the row's kept lanes and transformed by the
// row engine, natural lanes of the block out to the scratch (rows, w).
__global__ void __launch_bounds__(PBMM_BK_N / PBMM_RP_P)
    ri_inner_kernel(const float* __restrict__ re,
                    const float* __restrict__ im,
                    const float* __restrict__ tw_re,
                    const float* __restrict__ tw_im, float* __restrict__ sc_re,
                    float* __restrict__ sc_im,
                    const int* __restrict__ plan_src,
                    const int* __restrict__ plan_rev, int wk, int blks) {
  extern __shared__ float smem[];
  constexpr int N = PBMM_BK_N;
  const long long vid = blockIdx.x;
  const long long row = vid / blks;
  const int blk = (int)(vid - row * blks);
  float* sre = smem;
  float* sim = smem + pbmm_rp_pad(N);
  const float* src_re = re + (size_t)row * wk;
  const float* src_im = im + (size_t)row * wk;
  float* dre = sc_re + (size_t)vid * N;
  float* dim = sc_im + (size_t)vid * N;
  auto load = [&](const auto& gr, float (&xr)[PBMM_RP_P],
                  float (&xi)[PBMM_RP_P]) {
    pbmm_rp_rebuild_load(gr, xr, xi, src_re, src_im, plan_src, plan_rev,
                         blk * (N / PBMM_LANE), true);
  };
  auto store = [&](const auto& gr, const float (&xr)[PBMM_RP_P],
                   const float (&xi)[PBMM_RP_P]) {
    using G = PbmmRpOf<decltype(gr)>;
#pragma unroll
    for (int j = 0; j < G::J; ++j)
#pragma unroll
      for (int q = 0; q < G::L; ++q) {
        dre[gr.pos(j, q)] = xr[j * G::L + q];
        dim[gr.pos(j, q)] = xi[j * G::L + q];
      }
  };
  pbmm_row_transform<N, true, false>(threadIdx.x, sre, sim, tw_re, tw_im,
                                     ~0ull, load, store);
}

// One outer DIT pass of a bracketed row of n lanes, in place on the
// scratch; LAST writes |z| or Re z times the scale to out (rows, n).
template <int L, bool LAST>
__global__ void __launch_bounds__(PBMM_BK_THREADS)
    ri_bracket_kernel(float* sc_re, float* sc_im,
                      const float* __restrict__ tw_re,
                      const float* __restrict__ tw_im, float* out,
                      long long n, int lst, float scale, int magnitude) {
  constexpr int K = pbmm_log2(L);
  const long long g = (long long)blockIdx.y * PBMM_BK_THREADS + threadIdx.x;
  if (g >= (n >> K)) return;
  const long long st = 1ll << lst;
  const size_t o = (size_t)blockIdx.x * n + pbmm_cp_base<K>((int)g, lst);
  float xr[L], xi[L];
#pragma unroll
  for (int q = 0; q < L; ++q) {
    xr[q] = __ldcs(sc_re + o + q * st);
    xi[q] = __ldcs(sc_im + o + q * st);
  }
  pbmm_cp_stages<L, true, false, true>(pbmm_cp_base<K>((int)g, lst), lst, 0,
                                       0, xr, xi, tw_re, tw_im);
#pragma unroll
  for (int q = 0; q < L; ++q) {
    if (LAST) {
      out[o + q * st] = ri_out(xr[q], xi[q], scale, magnitude);
    } else {
      sc_re[o + q * st] = xr[q];
      sc_im[o + q * st] = xi[q];
    }
  }
}

// tw_re / tw_im: compact_twiddles(w, inverse=True), w - 1 words each;
// plan_src / plan_rev: the rebuild plan, device tables of n_tiles = w /
// 128 ints; sc_re / sc_im: a (batch hb, w) scratch above 16384 lanes
// (else null).
extern "C" int pbmm_row_ifft(const float* re, const float* im,
                             const float* tw_re, const float* tw_im,
                             float* out, const int* plan_src,
                             const int* plan_rev, int n_tiles, int batch,
                             int hb, int wk, int w, float scale,
                             int magnitude, float* sc_re, float* sc_im,
                             void* stream) {
  if (batch < 1 || hb < 1 || n_tiles < 1 || n_tiles * PBMM_LANE != w ||
      wk < PBMM_LANE || wk > w || w < PBMM_RP_MINN || (w & (w - 1)) != 0 ||
      plan_src == nullptr || plan_rev == nullptr)
    return (int)cudaErrorInvalidValue;
  // 16-byte loads: both planes start 16-byte aligned (rows of wk, a
  // multiple of 128 floats, keep every row so).
  if ((size_t)re % 16 != 0 || (size_t)im % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long rows = (long long)batch * hb;
  cudaStream_t s = (cudaStream_t)stream;
  if (w > PBMM_RP_BLOCKN) {
    const int blks = w / PBMM_BK_N;
    const long long vblocks = rows * blks;
    if (sc_re == nullptr || sc_im == nullptr || vblocks > 2147483647LL)
      return (int)cudaErrorInvalidValue;
    const size_t smem =
        (size_t)pbmm_rp_row_floats(PBMM_BK_N) * sizeof(float);
    cudaError_t err = pbmm_smem_opt_in(ri_inner_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    ri_inner_kernel<<<(unsigned)vblocks, PBMM_BK_N / PBMM_RP_P, smem, s>>>(
        re, im, tw_re, tw_im, sc_re, sc_im, plan_src, plan_rev, wk, blks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)pbmm_bracket_launch(
        w, true, [&](const PbmmCpPass& p, bool, bool last) -> cudaError_t {
          const dim3 grid((unsigned)rows,
                          (unsigned)(((w >> p.k) + PBMM_BK_THREADS - 1) /
                                     PBMM_BK_THREADS));
#define RI_BK(L)                                                           \
  if (last)                                                                \
    ri_bracket_kernel<L, true><<<grid, PBMM_BK_THREADS, 0, s>>>(           \
        sc_re, sc_im, tw_re, tw_im, out, w, p.lst, scale, magnitude);      \
  else                                                                     \
    ri_bracket_kernel<L, false><<<grid, PBMM_BK_THREADS, 0, s>>>(          \
        sc_re, sc_im, tw_re, tw_im, out, w, p.lst, scale, magnitude)
          PBMM_CP_SWITCH(p.k, RI_BK)
#undef RI_BK
          return cudaGetLastError();
        });
  }
  const int rpb = pbmm_rp_rows_per_block(w);
  const long long blocks = (rows + rpb - 1) / rpb;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)rpb * pbmm_rp_row_floats(w) * sizeof(float);
#define RI_LAUNCH(N)                                                      \
  {                                                                       \
    cudaError_t err = pbmm_smem_opt_in(row_ifft_kernel<N>, smem);         \
    if (err != cudaSuccess) return (int)err;                              \
    row_ifft_kernel<N><<<(unsigned)blocks, rpb * (N / PBMM_RP_P), smem,   \
                         s>>>(re, im, tw_re, tw_im, out, plan_src,        \
                              plan_rev, rows, wk, scale, magnitude);      \
  }
  PBMM_RP_SWITCH_BLOCK(w, RI_LAUNCH)
#undef RI_LAUNCH
  return (int)cudaGetLastError();
}
