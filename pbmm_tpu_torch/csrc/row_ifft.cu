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

#include "common.cuh"
#include "row_pass.cuh"

template <int N>
__global__ void __launch_bounds__(PBMM_RP_MAXN / PBMM_RP_P)
    row_ifft_kernel(const float* __restrict__ re,
                    const float* __restrict__ im,
                    const float* __restrict__ tw_re,
                    const float* __restrict__ tw_im, float* __restrict__ out,
                    PbmmLanePlan plan, long long rows, int wk, float scale,
                    int magnitude) {
  extern __shared__ float smem[];
  constexpr int NT = N / PBMM_RP_P;
  const int r = threadIdx.x / NT, t = threadIdx.x % NT;
  const long long row = (long long)blockIdx.x * pbmm_rp_rows_per_block(N) + r;
  const bool valid = row < rows;
  float* sre = smem + (size_t)r * pbmm_rp_row_floats(N);
  float* sim = sre + pbmm_rp_pad(N);
  const float* src_re = re + (size_t)row * wk;
  const float* src_im = im + (size_t)row * wk;

  // First DIT pass (st = 1): a group is 2^K consecutive bit-reversed
  // positions inside one tile, read from the kept tile the plan names
  // (lane-reversed and conjugated where it rebuilds a missing tile).
  auto load = [&](const auto& gr, float (&xr)[PBMM_RP_P],
                  float (&xi)[PBMM_RP_P]) {
    using G = PbmmRpOf<decltype(gr)>;
    constexpr int L = G::L;
    static_assert(L % 4 == 0, "the first DIT pass runs 3 or 4 stages");
#pragma unroll
    for (int j = 0; j < G::J; ++j) {
      const int p0 = gr.base[j];
      const int tile = p0 / PBMM_LANE, l0 = p0 % PBMM_LANE;
      const bool rev = plan.rev[tile] != 0;
      // Lowest source lane of the group's run of L lanes.
      const int s0 = plan.src[tile] * PBMM_LANE +
                     (rev ? PBMM_LANE - l0 - L : l0);
      float vr[L], vi[L];
      if (!valid) {
#pragma unroll
        for (int e = 0; e < L; ++e) vr[e] = vi[e] = 0.0f;
      } else {
        const float4* a = reinterpret_cast<const float4*>(src_re + s0);
        const float4* b = reinterpret_cast<const float4*>(src_im + s0);
#pragma unroll
        for (int c = 0; c < L / 4; ++c) {
          const float4 u = __ldg(a + c), v = __ldg(b + c);
          vr[4 * c] = u.x; vr[4 * c + 1] = u.y;
          vr[4 * c + 2] = u.z; vr[4 * c + 3] = u.w;
          vi[4 * c] = v.x; vi[4 * c + 1] = v.y;
          vi[4 * c + 2] = v.z; vi[4 * c + 3] = v.w;
        }
      }
#pragma unroll
      for (int q = 0; q < L; ++q) {
        xr[j * L + q] = rev ? vr[L - 1 - q] : vr[q];
        xi[j * L + q] = rev ? -vi[L - 1 - q] : vi[q];
      }
    }
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
      for (int q = 0; q < G::L; ++q) {
        const float a = xr[j * G::L + q], b = xi[j * G::L + q];
        dst[gr.pos(j, q)] =
            magnitude ? __fmul_rn(sqrtf(__fadd_rn(__fmul_rn(a, a),
                                                  __fmul_rn(b, b))),
                                  scale)
                      : __fmul_rn(a, scale);
      }
    }
  };
  pbmm_row_transform<N, true, false>(t, sre, sim, tw_re, tw_im, ~0ull, load,
                                     store);
}

// tw_re / tw_im: compact_twiddles(w, inverse=True), w - 1 words each.
extern "C" int pbmm_row_ifft(const float* re, const float* im,
                             const float* tw_re, const float* tw_im,
                             float* out, const int* plan_src,
                             const int* plan_rev, int n_tiles, int batch,
                             int hb, int wk, int w, float scale,
                             int magnitude, void* stream) {
  if (batch < 1 || hb < 1 || n_tiles < 1 || n_tiles > PBMM_MAX_TILES ||
      n_tiles * PBMM_LANE != w || wk < PBMM_LANE || wk > w ||
      !pbmm_rp_length_ok(w))
    return (int)cudaErrorInvalidValue;
  // 16-byte loads: both planes start 16-byte aligned (rows of wk, a
  // multiple of 128 floats, keep every row so).
  if ((size_t)re % 16 != 0 || (size_t)im % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  PbmmLanePlan plan;
  for (int i = 0; i < n_tiles; ++i) {
    if (plan_src[i] < 0 || (plan_src[i] + 1) * PBMM_LANE > wk)
      return (int)cudaErrorInvalidValue;
    plan.src[i] = plan_src[i];
    plan.rev[i] = plan_rev[i];
  }
  const long long rows = (long long)batch * hb;
  const int rpb = pbmm_rp_rows_per_block(w);
  const long long blocks = (rows + rpb - 1) / rpb;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)rpb * pbmm_rp_row_floats(w) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
#define RI_LAUNCH(N)                                                      \
  {                                                                       \
    cudaError_t err = pbmm_smem_opt_in(row_ifft_kernel<N>, smem);         \
    if (err != cudaSuccess) return (int)err;                              \
    row_ifft_kernel<N><<<(unsigned)blocks, rpb * (N / PBMM_RP_P), smem,   \
                         s>>>(re, im, tw_re, tw_im, out, plan, rows, wk,  \
                              scale, magnitude);                          \
  }
  PBMM_RP_SWITCH(w, RI_LAUNCH)
#undef RI_LAUNCH
  return (int)cudaGetLastError();
}
