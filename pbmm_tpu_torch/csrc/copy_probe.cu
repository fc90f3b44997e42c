// Kernel 13: a pure copy of two f32 planes in the access patterns of the
// port's kernels, the ceiling each pattern can reach on this card.
//
// Replaces benchmarks/kexp.py:70 main's copy kernel (copy_kernel, :173,
// launched at :182): the same two planes copied by row blocks or by lane
// blocks with no arithmetic, so that a kernel's time against its
// pattern's copy says whether the pattern or the work is the wall.  The
// two patterns, named after kexp's experiments:
//   copy_rowblocks   a block copies `rb` whole rows, consecutive threads on
//                    consecutive addresses (kernels 1, 3, 4, 7 and kernel
//                    8's row pass read whole rows);
//   copy_laneblocks  a block copies a full-height strip of S columns of one
//                    plane through shared memory, loaded as kernels 2, 5
//                    and 6 load their strips (S = 4: 16 bytes of each row,
//                    half a 32-byte sector) and kernel 8's column pass (S =
//                    8), then written back the same way.
//
// What bounds it on an H100: bytes only, the planes read once and written
// once, over 3.35 TB/s.  Timed cold (the L2 flushed before each launch)
// or on planes far larger than the 50 MB L2, it reads the HBM ceiling of
// the pattern; warm on small planes, L2's.  The design adds nothing to
// the pattern: no vector loads, no arithmetic, the port's own thread
// mapping, so that the copy is the pattern's ceiling as the port uses it.

#include "common.cuh"

__global__ void __launch_bounds__(256)
    copy_rows_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ oa, float* __restrict__ ob, int h,
                     int w, int rb) {
  const int row0 = blockIdx.x * rb;
  const int rows = min(rb, h - row0);
  const size_t base = ((size_t)blockIdx.y * h + row0) * w;
  const int n = rows * w;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    oa[base + e] = a[base + e];
    ob[base + e] = b[base + e];
  }
}

__global__ void __launch_bounds__(256)
    copy_lanes_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, float* __restrict__ oa,
                      float* __restrict__ ob, int h, int w, int s) {
  extern __shared__ float strip[];
  const int col0 = blockIdx.x * s;
  const size_t fo = (size_t)blockIdx.y * h * w;
  const int hs = h * s;
  for (int plane = 0; plane < 2; ++plane) {
    const float* src = plane ? b : a;
    float* dst = plane ? ob : oa;
    for (int e = threadIdx.x; e < hs; e += blockDim.x) {
      const int p = e / s, c = e % s;
      strip[e] = src[fo + (size_t)p * w + col0 + c];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < hs; e += blockDim.x) {
      const int p = e / s, c = e % s;
      dst[fo + (size_t)p * w + col0 + c] = strip[e];
    }
    __syncthreads();
  }
}

// pattern 0: rows, `block` rows a block; pattern 1: lanes, strips of
// `block` columns (the strip of one plane must fit in shared memory).
extern "C" int pbmm_copy_probe(const float* a, const float* b, float* oa,
                               float* ob, int pattern, int block, int batch,
                               int h, int w, void* stream) {
  if (batch < 1 || batch > 65535 || h < 1 || w < 1 || block < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (pattern == 0) {
    const dim3 grid((h + block - 1) / block, batch);
    copy_rows_kernel<<<grid, 256, 0, s>>>(a, b, oa, ob, h, w, block);
    return (int)cudaGetLastError();
  }
  if (pattern != 1 || w % block != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)h * block * sizeof(float);
  const cudaError_t err = pbmm_smem_opt_in(copy_lanes_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  copy_lanes_kernel<<<dim3(w / block, batch), 256, smem, s>>>(a, b, oa, ob,
                                                              h, w, block);
  return (int)cudaGetLastError();
}
