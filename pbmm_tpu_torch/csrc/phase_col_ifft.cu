// Kernel 6: one frame's band/phase pass against its previous frame, then
// the radix-2 column IFFT, rows [r0, r1) out.
//
// Replaces pbmm_tpu/spectral/fused.py:1022 phase_col_ifft (the Pallas
// kernel launched at :1168): the per-frame scan engine's fused
// phase + column-IFFT (engine/pipeline.py::amplify_reconstruct_fused) and
// the stateless frame pair's.  Inputs are whole spectra in the working
// layout (bit-reversed rows at a pow-2 height H, bit-reversed kept lanes),
// as kernels 1 and 5 give them; each of the B frames has its own prev
// (and, with the IIR band-pass, its own taps, written back full height).
// Every branch of _phase_block runs: host planes or per-bin masks,
// standard mode, steerable sectors, integer power or atan2 + sin/cos, IIR
// taps; the sharded engines' fx_values and the benchmark-only pair_offset
// are not ported.
//
// Design: kernel 2's pow-2 branch without its forward half.  A block owns
// a strip of S columns of one frame, S a template parameter as in kernel
// 2: 4 up to H = 2048, 2 above, up to 4096; cur and prev (4 x H x S f32,
// 128 KB at H = 2048 or 4096) and the taps (2 more planes, 192 KB) sit in
// shared memory.  The phase pass is phase_pass.cuh's pbmm_phase_bin and the
// inverse is common.cuh's pbmm_radix2 with kernel 2's arguments, so on
// the spectra kernel 5 gives, this kernel's rows equal kernel 2's bit for
// bit (checked on the card by chip_smoke.py).
//
// What bounds it on an H100: it reads 4 (IIR 6) planes of B x H x W f32
// once and writes 2 x B x (r1 - r0) x W (+ 2 tap planes); at 1080p
// square_pow2 (H = 2048, W = 1152) that is ~38 MB in and ~18 MB out per
// frame, against 5 H log2(H) flops per column plus the phase chain:
// bytes bound.  The strip of 4 columns reads 16 bytes of each row, half
// a 32-byte sector; simple and right first.

#include "common.cuh"
#include "phase_pass.cuh"


struct PhaseColIO {
  const float* cur_re;
  const float* cur_im;
  const float* prev_re;
  const float* prev_im;
  const float* lpf_in;
  const float* lps_in;
  const float* plane0;  // total (pyramid) or w (standard), (H, W)
  const float* plane1;  // m_amp (pyramid)
  const float* fy;      // row frequency, (H,)
  const float* fx;      // lane frequency, (W,)
  const float* tw_re;   // _dif_twiddles(H, inverse)
  const float* tw_im;
  float* out_re;
  float* out_im;
  float* lpf_out;
  float* lps_out;
  int h, w, r0, r1;
};

template <bool GENERAL, bool IIR, int PC_S>
__global__ void __launch_bounds__(256)
    phase_col_ifft_kernel(PhaseColIO io, PhaseArgs pa) {
  extern __shared__ float smem[];
  const int h = io.h, w = io.w;
  const int hs = h * PC_S;
  float* a_re = smem;  // current frame
  float* a_im = smem + hs;
  float* b_re = smem + 2 * hs;  // previous frame, then the modified one
  float* b_im = smem + 3 * hs;
  float* l_f = smem + 4 * hs;  // IIR taps
  float* l_s = smem + 5 * hs;
  const int col0 = blockIdx.x * PC_S;
  const size_t fo = (size_t)blockIdx.y * h * w;  // this frame's planes
  const int nt = blockDim.x;

  for (int e = threadIdx.x; e < hs; e += nt) {
    const int p = e / PC_S, c = e % PC_S;
    const size_t g = fo + (size_t)p * w + col0 + c;
    a_re[e] = io.cur_re[g];
    a_im[e] = io.cur_im[g];
    b_re[e] = io.prev_re[g];
    b_im[e] = io.prev_im[g];
    if (IIR) {
      l_f[e] = io.lpf_in[g];
      l_s[e] = io.lps_in[g];
    }
  }
  __syncthreads();

  // The phase pass (kernel 2's step 4); the result replaces prev.
  for (int e = threadIdx.x; e < hs; e += nt) {
    const int p = e / PC_S, c = e % PC_S;
    const size_t g = (size_t)p * w + col0 + c;  // host-plane index
    const float cr = a_re[e], ci = a_im[e];
    const float pr = b_re[e], pi = b_im[e];
    float o_r, o_i;
    pbmm_phase_bin<GENERAL, IIR>(cr, ci, pr, pi, io.plane0, io.plane1, g,
                                 io.fy, p, io.fx, col0 + c, l_f + e, l_s + e,
                                 pa, o_r, o_i);
    b_re[e] = o_r;
    b_im[e] = o_i;
  }
  __syncthreads();

  // The DIT inverse: bit-reversed rows in, natural rows out, unnormalised.
  pbmm_radix2(b_re, b_im, h, PC_S, PC_S, 0, 1, PC_S, io.tw_re, io.tw_im,
              true);

  const int hr = io.r1 - io.r0;
  const size_t obase = (size_t)blockIdx.y * hr * w;
  for (int e = threadIdx.x; e < hr * PC_S; e += nt) {
    const int p = e / PC_S, c = e % PC_S;
    const size_t g = obase + (size_t)p * w + col0 + c;
    io.out_re[g] = b_re[(p + io.r0) * PC_S + c];
    io.out_im[g] = b_im[(p + io.r0) * PC_S + c];
  }
  if (IIR) {
    for (int e = threadIdx.x; e < hs; e += nt) {
      const int p = e / PC_S, c = e % PC_S;
      const size_t g = fo + (size_t)p * w + col0 + c;
      io.lpf_out[g] = l_f[e];
      io.lps_out[g] = l_s[e];
    }
  }
}

template <bool GENERAL, bool IIR, int S>
static cudaError_t pc_launch(const PhaseColIO& io, const PhaseArgs& pa,
                             int b, cudaStream_t stream) {
  const size_t smem = (IIR ? 6 : 4) * (size_t)io.h * S * sizeof(float);
  cudaError_t err =
      pbmm_smem_opt_in(phase_col_ifft_kernel<GENERAL, IIR, S>, smem);
  if (err != cudaSuccess) return err;
  phase_col_ifft_kernel<GENERAL, IIR, S>
      <<<dim3(io.w / S, b), 256, smem, stream>>>(io, pa);
  return cudaGetLastError();
}

template <int S>
static cudaError_t pc_branch(const PhaseColIO& io, const PhaseArgs& pa,
                             bool general, int b, cudaStream_t stream) {
  return pa.iir   ? pc_launch<true, true, S>(io, pa, b, stream)
         : general ? pc_launch<true, false, S>(io, pa, b, stream)
                   : pc_launch<false, false, S>(io, pa, b, stream);
}

// iargs, fargs: the phase pass's branch and constants (host arrays, as
// for pbmm_colspec_chunk).  lpf/lps pointers are null without IIR,
// plane0/plane1 without host planes, fy/fx on the main branch.
extern "C" int pbmm_phase_col_ifft(
    const float* cur_re, const float* cur_im, const float* prev_re,
    const float* prev_im, const float* lpf_in, const float* lps_in,
    const float* plane0, const float* plane1, const float* fy,
    const float* fx, const float* tw_re, const float* tw_im, float* out_re,
    float* out_im, float* lpf_out, float* lps_out, const int* iargs,
    const float* fargs, int b, int h, int w, int r0, int r1,
    void* stream) {
  PhaseArgs pa;
  const bool args_ok = pbmm_phase_unpack(iargs, fargs, pa);
  const bool general = pbmm_phase_general(pa);
  const bool tall = h > PBMM_COL_MAXH;
  const int s = tall ? PBMM_COL_S_TALL : PBMM_COL_S;
  if (!args_ok || b < 1 || b > 65535 || h < 2 || (h & (h - 1)) != 0 ||
      h > PBMM_COL_MAXH_TALL || w < s || w % s != 0 || r0 < 0 || r1 <= r0 ||
      r1 > h || (pa.host_planes && plane0 == nullptr) ||
      (pa.host_planes && !pa.standard && plane1 == nullptr) ||
      (!general && (plane0 == nullptr || plane1 == nullptr)) ||
      (pa.iir && (lpf_in == nullptr || lps_in == nullptr ||
                  lpf_out == nullptr || lps_out == nullptr)) ||
      (general && (fy == nullptr || fx == nullptr)))
    return (int)cudaErrorInvalidValue;
  const PhaseColIO io = {cur_re, cur_im, prev_re, prev_im, lpf_in, lps_in,
                         plane0, plane1, fy, fx, tw_re, tw_im, out_re,
                         out_im, lpf_out, lps_out, h, w, r0, r1};
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      tall ? pc_branch<PBMM_COL_S_TALL>(io, pa, general, b, st)
           : pc_branch<PBMM_COL_S>(io, pa, general, b, st);
  return (int)err;
}
