// Kernel 5: the zero-embedded radix-2 column FFT at pow-2 heights.
//
// Replaces pbmm_tpu/spectral/fused.py:303 col_fft_zero_padded (the Pallas
// kernel launched at :345): (B, Hc, Wk) row spectra of the content rows
// -> (B, H, Wk) forward column FFT, the content slab embedded at row0
// among zero rows on chip (the zero rows are never read), rows
// bit-reversed.  The chunk engine runs it once per stream, on frame 0
// through video_init when a pow-2 stream starts from interleaved frames
// (pbmm_tpu/engine/video.py:382 -> :83 -> pipeline.py:150), and on the
// last frame of a bypassed clip (video.py:466); the scan engine and the
// unfused backends once a frame.  Any pow-2 height H from 2 (16384 at
// 16K: three passes).
//
// The arithmetic is kernel 2's forward half (colspec_chunk.cu's launch 1:
// the zero-embed, then the radix-2 DIF over the whole column): the same
// butterflies on the same elements in the same stage
// order, the same twiddles, every product and sum rounded on its own.  So
// the spectrum this kernel gives a frame is bit for bit the one kernel 2
// carries for it, and a stream started here continues exactly as one
// started through kernel 2 against a zero previous spectrum.
//
// What bounds it on an H100: it reads Hc x Wk x 8 bytes and writes
// H x Wk x 8 bytes per frame (29 MB at 1080p square_pow2) against
// 5 H log2(H) flops per column: bytes.  The strip-of-4 design it replaces
// held 4 columns of every row in shared memory (64 KB at H = 2048), read
// 16 bytes of each row (half a sector; the pattern copies at 767 GB/s),
// put its threads 4 floats apart (4-way bank conflicts) and synchronised
// after each stage.  Now it runs on col_pass.cuh's engine, shared with
// kernel 8's column pass: warps of 32 neighbouring columns (128-byte row
// segments), up to six stages a pass in registers, two passes over the
// planes at H <= 4096 and three at 8192.  The first pass reads the
// content rows only and zero-fills the rest in registers; the later
// passes run in place on the output.  On an NVIDIA H100 80GB HBM3 at its
// 700 W limit (chip_smoke.py), at 1080p square_pow2 (1152 content rows
// -> 2048, 1152 lanes) it takes 0.033 ms warm, against 0.024 for
// torch.fft.fft along dim -2 and 0.119 for the strip-of-4 design: the two
// passes move 67 MB where one pass would move 29.

#include "col_pass.cuh"

// Three blocks an SM (at most 168 registers a thread): at 1080p's 1152
// lanes a pass then fits the card in one wave.  The shorter pass runs
// first.  Both choices were measured against the alternatives on the card
// (PERF.md); neither changes a bit of the result.
template <int L, bool EMBED>
__global__ void __launch_bounds__(PBMM_CP_LANES * PBMM_CP_GROUPS, 3)
    col_fft_pass(PbmmColPass a) {
  pbmm_col_pass<L, false, false, EMBED, false>(a);
}

extern "C" int pbmm_col_fft(const float* re, const float* im,
                            const float* tw_re, const float* tw_im,
                            float* out_re, float* out_im, int batch, int hc,
                            int h, int wk, int row0, void* stream) {
  if (batch < 1 || batch > 65535 || h < 2 || (h & (h - 1)) != 0 ||
      hc < 1 || row0 < 0 || row0 + hc > h || wk < 1)
    return (int)cudaErrorInvalidValue;
  const PbmmColPass a = {re, im, out_re, out_im, tw_re, tw_im, h, wk, hc,
                         row0, 0, 0, 1.0f};
#define CF_PASS(L) col_fft_pass<L, E><<<grid, block, 0, stream>>>(a)
  auto first = [](int k, dim3 grid, dim3 block, const PbmmColPass& a,
                  cudaStream_t stream) -> cudaError_t {
    constexpr bool E = true;
    PBMM_CP_SWITCH(k, CF_PASS)
    return cudaGetLastError();
  };
  auto rest = [](int k, dim3 grid, dim3 block, const PbmmColPass& a,
                 cudaStream_t stream) -> cudaError_t {
    constexpr bool E = false;
    PBMM_CP_SWITCH(k, CF_PASS)
    return cudaGetLastError();
  };
#undef CF_PASS
  return (int)pbmm_col_launch(a, batch, first, rest, false, true, 1.0f,
                              (cudaStream_t)stream);
}
