// Kernel 13: a pure copy of two f32 planes in the access patterns of the
// port's kernels, each at the best rate this card gives for the pattern.
//
// Replaces benchmarks/kexp.py:70 main's copy kernel (copy_kernel, :173,
// launched at :182): the same two planes copied by row blocks or by lane
// blocks with no arithmetic, so that a kernel's time against its
// pattern's copy says whether the pattern or the work is the wall.  The
// two patterns, named after kexp's experiments:
//   copy_rowblocks   a block copies `rb` whole rows of both planes (kernels
//                    1, 3, 4, 7 and kernel 8's row pass read whole rows):
//                    16-byte words, eight of each plane in flight a thread
//                    (every load of an iteration issued before its
//                    stores), consecutive threads on consecutive words;
//                    the blocks take 32 to 256 threads, as many as the
//                    span gives eight words of a plane each (64 on a
//                    2048-lane row).  Where a pointer or the width is off
//                    the 16-byte grid, a second instantiation adds scalar
//                    heads and tails; the aligned one needs 80 registers a
//                    thread, so the 1152 rows of kexp's planes are all
//                    resident at once (a design with the scalar code in
//                    every launch, 128 threads of four words at 64
//                    registers, left 96 rows for a second wave and ran
//                    ~10 % slower on an H100);
//   copy_laneblocks  a block of 512 threads copies a full-height strip of
//                    S columns of one frame through shared memory, both
//                    planes in one pass where 2 H S floats fit a block's
//                    227 KB (else a plane a pass), the way kernels 2 and 6
//                    stage theirs: every load of the strip issued at once
//                    as cp.async copies of up to 16 bytes (S >= 4: one
//                    16-byte word per 4 columns of a row; S = 2: 8 bytes;
//                    S = 1 or a pointer not so aligned: 4), one wait, then
//                    the strip written back in the same words.
//
// What bounds it on an H100: bytes only, the planes read once and written
// once, over 3.35 TB/s.  Timed cold (the L2 flushed before each launch)
// or on planes far larger than the 50 MB L2, it reads the HBM ceiling of
// the pattern; warm on small planes, L2's.  The design gives each pattern
// the widest words and the most bytes in flight it allows, so that what
// is left against the bound is the pattern's own cost (a strip of S
// columns touches 4 S bytes of each row).

#include "common.cuh"

#define CP_UNROLL 8          // 16-byte words of each plane a thread holds
#define CP_ROW_THREADS 256   // the most threads of a row block
#define CP_LANE_THREADS 512  // a lane block, as kernels 2 and 6

// Elements before src's first 16-byte boundary, when dst shares its
// alignment; else n (the span copies as scalars).
__device__ __forceinline__ int cp_head(const float* src, const float* dst,
                                       int n) {
  const unsigned sa = (unsigned)(size_t)src & 15u;
  if (sa != ((unsigned)(size_t)dst & 15u)) return n;
  const int hd = (int)(((16u - sa) & 15u) >> 2);
  return hd < n ? hd : n;
}

// ALIGNED: every pointer on the 16-byte grid and w a multiple of 4, so
// every block's span is whole words: no head, no tail.
template <bool ALIGNED>
__global__ void __launch_bounds__(CP_ROW_THREADS)
    copy_rows_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ oa, float* __restrict__ ob, int h,
                     int w, int rb) {
  const int row0 = blockIdx.x * rb;
  const int rows = min(rb, h - row0);
  const size_t base = ((size_t)blockIdx.y * h + row0) * w;
  const int n = rows * w;
  a += base;
  b += base;
  oa += base;
  ob += base;
  const int ha = ALIGNED ? 0 : cp_head(a, oa, n);
  const int hb = ALIGNED ? 0 : cp_head(b, ob, n);
  const int va = (n - ha) >> 2, vb = (n - hb) >> 2;  // 16-byte words
  const float4* a4 = reinterpret_cast<const float4*>(a + ha);
  const float4* b4 = reinterpret_cast<const float4*>(b + hb);
  float4* oa4 = reinterpret_cast<float4*>(oa + ha);
  float4* ob4 = reinterpret_cast<float4*>(ob + hb);
  const int nt = blockDim.x, nv = max(va, vb);
  for (int k0 = threadIdx.x; k0 < nv; k0 += CP_UNROLL * nt) {
    float4 x[CP_UNROLL], y[CP_UNROLL];
#pragma unroll
    for (int u = 0; u < CP_UNROLL; ++u) {
      const int k = k0 + u * nt;
      if (k < va) x[u] = a4[k];
      if (k < vb) y[u] = b4[k];
    }
#pragma unroll
    for (int u = 0; u < CP_UNROLL; ++u) {
      const int k = k0 + u * nt;
      if (k < va) oa4[k] = x[u];
      if (k < vb) ob4[k] = y[u];
    }
  }
  if constexpr (!ALIGNED) {
    // Each plane's scalars: its head, then its tail after the words.
    for (int e = threadIdx.x; e < n - 4 * va; e += nt) {
      const int i = e < ha ? e : e + 4 * va;
      oa[i] = a[i];
    }
    for (int e = threadIdx.x; e < n - 4 * vb; e += nt) {
      const int i = e < hb ? e : e + 4 * vb;
      ob[i] = b[i];
    }
  }
}

template <int V>
struct CpWord;
template <>
struct CpWord<1> {
  using T = float;
};
template <>
struct CpWord<2> {
  using T = float2;
};
template <>
struct CpWord<4> {
  using T = float4;
};

// Strips of S columns (0: s, given at run time), words of V floats.
// Word e of a pass: plane e / n of the pass, row (e mod n) / (S / V),
// word (e mod n) mod (S / V) of the row; in shared memory at e V.
template <int S, int V>
__global__ void __launch_bounds__(CP_LANE_THREADS)
    copy_lanes_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, float* __restrict__ oa,
                      float* __restrict__ ob, int h, int w, int s,
                      int planes) {
  extern __shared__ float4 smem4[];
  using T = typename CpWord<V>::T;
  float* strip = reinterpret_cast<float*>(smem4);
  const int wr = (S ? S : s) / V;  // words a row
  const int n = h * wr;            // words a plane
  const size_t fo = (size_t)blockIdx.y * h * w + (size_t)blockIdx.x * wr * V;
  for (int p0 = 0; p0 < 2; p0 += planes) {
    const int nw = n * planes;
    for (int e = threadIdx.x; e < nw; e += blockDim.x) {
      const int pl = e >= n, r = e - pl * n;
      const int row = r / wr, j = r - row * wr;
      const float* src = (p0 + pl ? b : a) + fo + (size_t)row * w + j * V;
      pbmm_cp_async<4 * V>(strip + (size_t)e * V, src);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int e = threadIdx.x; e < nw; e += blockDim.x) {
      const int pl = e >= n, r = e - pl * n;
      const int row = r / wr, j = r - row * wr;
      float* dst = (p0 + pl ? ob : oa) + fo + (size_t)row * w + j * V;
      *reinterpret_cast<T*>(dst) =
          *reinterpret_cast<const T*>(strip + (size_t)e * V);
    }
    __syncthreads();
  }
}

template <int S, int V>
static cudaError_t cp_lanes(const float* a, const float* b, float* oa,
                            float* ob, int s, int batch, int h, int w,
                            cudaStream_t st) {
  const size_t plane = (size_t)h * s * sizeof(float);
  const int planes = 2 * plane <= 232448 ? 2 : 1;
  const cudaError_t err =
      pbmm_smem_opt_in(copy_lanes_kernel<S, V>, planes * plane);
  if (err != cudaSuccess) return err;
  copy_lanes_kernel<S, V><<<dim3(w / s, batch), CP_LANE_THREADS,
                            planes * plane, st>>>(a, b, oa, ob, h, w, s,
                                                  planes);
  return cudaGetLastError();
}

// The widest word (of V <= S floats) every row start of the strips and
// every pointer allows.
template <int S>
static cudaError_t cp_words(const float* a, const float* b, float* oa,
                            float* ob, int v, int batch, int h, int w,
                            cudaStream_t st) {
  if constexpr (S >= 4) {
    if (v >= 4) return cp_lanes<S, 4>(a, b, oa, ob, S, batch, h, w, st);
  }
  if constexpr (S >= 2) {
    if (v >= 2) return cp_lanes<S, 2>(a, b, oa, ob, S, batch, h, w, st);
  }
  return cp_lanes<S, 1>(a, b, oa, ob, S, batch, h, w, st);
}

// pattern 0: rows, `block` rows a block; pattern 1: lanes, strips of
// `block` columns (the strip of one plane must fit in shared memory).
extern "C" int pbmm_copy_probe(const float* a, const float* b, float* oa,
                               float* ob, int pattern, int block, int batch,
                               int h, int w, void* stream) {
  if (batch < 1 || batch > 65535 || h < 1 || w < 1 || block < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t ptrs = (size_t)a | (size_t)b | (size_t)oa | (size_t)ob;
  if (pattern == 0) {
    const long long span = (long long)(block < h ? block : h) * w;
    if (span > (1LL << 30)) return (int)cudaErrorInvalidValue;
    // Eight words of each plane a thread: 32 .. 256 threads.
    const long long want = (span / 4 + CP_UNROLL - 1) / CP_UNROLL;
    const int nt = want >= CP_ROW_THREADS ? CP_ROW_THREADS
                   : want > 32            ? (int)((want + 31) / 32 * 32)
                                          : 32;
    const dim3 grid((h + block - 1) / block, batch);
    if (ptrs % 16 == 0 && w % 4 == 0)
      copy_rows_kernel<true><<<grid, nt, 0, s>>>(a, b, oa, ob, h, w, block);
    else
      copy_rows_kernel<false><<<grid, nt, 0, s>>>(a, b, oa, ob, h, w, block);
    return (int)cudaGetLastError();
  }
  if (pattern != 1 || w % block != 0 ||
      (size_t)h * block * sizeof(float) > 232448)
    return (int)cudaErrorInvalidValue;
  int v = 4;
  while (v > 1 && (block % v != 0 || w % v != 0 || ptrs % (4 * v) != 0))
    v /= 2;
  switch (block) {
    case 1: return (int)cp_words<1>(a, b, oa, ob, v, batch, h, w, s);
    case 2: return (int)cp_words<2>(a, b, oa, ob, v, batch, h, w, s);
    case 4: return (int)cp_words<4>(a, b, oa, ob, v, batch, h, w, s);
    case 8: return (int)cp_words<8>(a, b, oa, ob, v, batch, h, w, s);
    case 16: return (int)cp_words<16>(a, b, oa, ob, v, batch, h, w, s);
    case 32: return (int)cp_words<32>(a, b, oa, ob, v, batch, h, w, s);
    default: return (int)cp_lanes<0, 1>(a, b, oa, ob, block, batch, h, w, s);
  }
}
