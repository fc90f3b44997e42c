// The row engine of kernels 1, 4, 7 and 8's row pass: a radix-2 transform of one row of
// length N (128 to 8192) held on chip, as a few register passes that
// exchange through the row's shared memory inside one launch.  Longer rows
// run on it block by block inside col_pass.cuh's bracket passes.
//
// A pass runs K <= PBMM_RP_KMAX consecutive stages s0 .. s0 + K - 1 of the
// stage sequence of common.cuh's pbmm_radix2 (forward DIF: spans N/2 .. 1;
// inverse DIT: spans 1 .. N/2).  The stages of one pass couple only the
// 2^K points {base + q st : q < 2^K}, st the pass's smallest span (DIF) or
// its first (DIT), base = (g / st) st 2^K + g % st for the group g < N /
// 2^K (col_pass.cuh's formula, with a row's groups in place of a column's).
// A row has nt = N / PBMM_RP_P threads, each holding PBMM_RP_P points:
// thread t takes the groups g = t + j nt, j < PBMM_RP_P / 2^K (or, in a
// pass that asks for it, g = t J + j).  It loads them into registers, runs
// the pass's stages there and writes them back in place, so the log2(N)
// stages cost one barrier per pass boundary (2 at N = 2048) instead of one
// per stage.  The first pass reads the kernel's input from device memory
// and the last writes its output: only the exchanges between passes go
// through shared memory.  N is a template parameter, so every pass's
// stride, twiddle offset and shared-memory offset is a constant of the
// code: a thread computes one address a group and reaches its points by
// immediate offsets.
//
// Every butterfly is pbmm_radix2_stage's, on the same elements, in the
// same stage order, with each product and sum rounded on its own and no
// shortcut for a real input or a unit twiddle, so the result is bit for
// bit the one pbmm_radix2 computes stage by stage.  The twiddles are the
// same words: row s of the _dif_twiddles table (span d) is periodic with
// period d, so the kernels read the compact table of its N - 1 distinct
// words (spectral/radix2.py::compact_twiddles), word d - 1 + (i1 mod d)
// for the bottom element i1 = base + (q + dl) st, which is d - 1 + g mod
// st + (q mod dl) st.
//
// Shared memory holds a row as two planes (re, im) of N + N / 16 floats,
// element p at pbmm_rp_pad(p) = p + p / 16: a pass's points lie at
// pbmm_rp_pad(base) + pbmm_rp_pad(q st), and a warp's 32 accesses of one
// point touch at most two words of a bank (one in most passes; an XOR
// swizzle that left none cost more in address arithmetic than the
// conflicts it saved).  tests/test_torch_rowpass.py checks both for every
// pass of every length.  Rows under 512 lanes put 2 or 4 rows in a warp,
// whose planes then share banks.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

#define PBMM_RP_KMAX 4                  // stages a pass runs in registers
#define PBMM_RP_P (1 << PBMM_RP_KMAX)  // points a thread holds
#define PBMM_RP_MAXPASS 4               // passes of the longest transform
#define PBMM_RP_THREADS 128  // a block's threads, rows of up to 2048 lanes
#define PBMM_RP_MINN 128
#define PBMM_RP_MAXN (PBMM_MAX_TILES * PBMM_LANE)  // rows of 64-bit tile masks
// The longest row one block holds: 16384 lanes, 1024 threads, 139 KB of
// shared memory (every tile's groups on: kernels 1 and 4 skip the tiles
// they do not keep at their store).  Longer rows are bracketed
// (col_pass.cuh), on 8192-lane blocks.
#define PBMM_RP_BLOCKN (2 * PBMM_RP_MAXN)
// A row kernel's launch bound: 512 threads, 1024 for the 16384-lane row.
#define PBMM_RP_BOUND(N) (((N) > PBMM_RP_MAXN ? (N) : PBMM_RP_MAXN) / PBMM_RP_P)

__host__ __device__ constexpr int pbmm_rp_log2(int v) {
  return v <= 1 ? 0 : 1 + pbmm_rp_log2(v >> 1);
}

// The passes of one transform: stage counts and log2 of each stride st.
struct PbmmRowPlan {
  int passes;
  int k[PBMM_RP_MAXPASS];
  int lst[PBMM_RP_MAXPASS];
};

__host__ __device__ constexpr void pbmm_rp_split(int stages, PbmmRowPlan& p) {
  const int np = (stages + PBMM_RP_KMAX - 1) / PBMM_RP_KMAX;
  for (int i = 0; i < np; ++i)
    p.k[p.passes + i] = stages / np + (i < stages % np ? 1 : 0);
  p.passes += np;
}

// The split of log2(n) stages into passes, the longer first.  Forward: the
// stages of spans >= 128 first, then the last 7 (spans 64 .. 1, which
// couple lanes inside one 128-lane tile) in passes of their own (4 and 3),
// so that a kernel storing only some tiles can skip those passes' groups
// in the others.  n: a power of two in [PBMM_RP_MINN, PBMM_RP_MAXN].
__host__ __device__ constexpr PbmmRowPlan pbmm_row_plan(int n, bool inverse) {
  PbmmRowPlan p{0, {0, 0, 0, 0}, {0, 0, 0, 0}};
  const int stages = pbmm_rp_log2(n);
  if (inverse) {
    pbmm_rp_split(stages, p);
  } else {
    if (stages > 7) pbmm_rp_split(stages - 7, p);
    pbmm_rp_split(7, p);
  }
  int s0 = 0;
  for (int i = 0; i < p.passes; ++i) {
    // DIT: the pass's first span is 1 << s0; DIF: its smallest n >> (s0 + k).
    p.lst[i] = inverse ? s0 : stages - s0 - p.k[i];
    s0 += p.k[i];
  }
  return p;
}

static inline bool pbmm_rp_length_ok(int n) {
  return n >= PBMM_RP_MINN && n <= PBMM_RP_MAXN && (n & (n - 1)) == 0;
}

// Rows a block holds: nt = N / P threads a row, at least PBMM_RP_THREADS
// threads a block.
__host__ __device__ constexpr int pbmm_rp_rows_per_block(int n) {
  return n / PBMM_RP_P >= PBMM_RP_THREADS ? 1
                                          : PBMM_RP_THREADS / (n / PBMM_RP_P);
}

__host__ __device__ constexpr int pbmm_rp_pad(int p) { return p + (p >> 4); }

// Floats of one row's two shared-memory planes.
__host__ __device__ constexpr int pbmm_rp_row_floats(int n) {
  return 2 * pbmm_rp_pad(n);
}

// The groups a thread holds in pass PASS of the length-N transform.  keep:
// one bit per 128-lane tile; where every span of the pass is under 128
// its groups lie inside one tile, and a group in a tile whose bit is 0 is
// off (not loaded, transformed or stored).  ADJ: thread t takes the
// adjacent groups g = t J + j (else g = t + j nt).
template <int N, bool INVERSE, int PASS, bool ADJ = false>
struct PbmmRpGroups {
  static constexpr int K = pbmm_row_plan(N, INVERSE).k[PASS];
  static constexpr int LST = pbmm_row_plan(N, INVERSE).lst[PASS];
  static constexpr int L = 1 << K;           // points of a group
  static constexpr int J = PBMM_RP_P >> K;   // groups of a thread
  static constexpr int ST = 1 << LST;
  static constexpr int NT = N / PBMM_RP_P;
  static constexpr bool INTRA = (ST << K) <= PBMM_LANE;
  int base[J];
  int lo[J];  // g mod st: the group's offset into each twiddle row
  bool on[J];
  __device__ __forceinline__ PbmmRpGroups(int t, unsigned long long keep) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int g = ADJ ? t * J + j : t + j * NT;
      lo[j] = g & (ST - 1);
      base[j] = ((g >> LST) << (LST + K)) | lo[j];
      // A row of more than 64 tiles runs every tile's groups.
      on[j] = !INTRA || N > PBMM_RP_MAXN ||
              ((keep >> (base[j] / PBMM_LANE)) & 1ull);
    }
  }
  __device__ __forceinline__ int pos(int j, int q) const {
    return base[j] + q * ST;
  }
};

template <class G>
using PbmmRpOf = typename std::decay<G>::type;

// The pass's K stages on the groups in registers (x[j L + q] is point q of
// group j).  REAL (the first forward pass only): the input's imaginary
// part is zero, and the transform's first stage (span N / 2) reads none
// of it and writes it 0 above, br tw below (kernel 8's real row pass).
template <class G, bool INVERSE, bool REAL = false>
__device__ __forceinline__ void pbmm_rp_stages(
    const G& gr, float (&xr)[PBMM_RP_P], float (&xi)[PBMM_RP_P],
    const float* __restrict__ tw_re, const float* __restrict__ tw_im) {
  constexpr int K = G::K, L = G::L, ST = G::ST;
#pragma unroll
  for (int j = 0; j < G::J; ++j) {
    if (!gr.on[j]) continue;
    const float* twr = tw_re + gr.lo[j];
    const float* twi = tw_im + gr.lo[j];
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const int tt = INVERSE ? t : K - 1 - t;  // log2(span / st)
      const int dl = 1 << tt;
#pragma unroll
      for (int q = 0; q < L; ++q) {
        if (q & dl) continue;
        const int w = (ST << tt) - 1 + (q & (dl - 1)) * ST;
        const float tr = __ldg(twr + w), ti = __ldg(twi + w);
        const int a = j * L + q, b = a + dl;
        const float x_r = xr[a], x_i = xi[a];
        const float u_r = xr[b], u_i = xi[b];
        if (REAL && t == 0) {
          const float br = __fsub_rn(x_r, u_r);
          xr[a] = __fadd_rn(x_r, u_r);
          xi[a] = 0.0f;
          xr[b] = __fmul_rn(br, tr);
          xi[b] = __fmul_rn(br, ti);
        } else if (!INVERSE) {
          const float br = __fsub_rn(x_r, u_r), bi = __fsub_rn(x_i, u_i);
          xr[a] = __fadd_rn(x_r, u_r);
          xi[a] = __fadd_rn(x_i, u_i);
          xr[b] = __fsub_rn(__fmul_rn(br, tr), __fmul_rn(bi, ti));
          xi[b] = __fadd_rn(__fmul_rn(br, ti), __fmul_rn(bi, tr));
        } else {
          const float zr = __fsub_rn(__fmul_rn(u_r, tr), __fmul_rn(u_i, ti));
          const float zi = __fadd_rn(__fmul_rn(u_r, ti), __fmul_rn(u_i, tr));
          xr[a] = __fadd_rn(x_r, zr);
          xi[a] = __fadd_rn(x_i, zi);
          xr[b] = __fsub_rn(x_r, zr);
          xi[b] = __fsub_rn(x_i, zi);
        }
      }
    }
  }
}

template <class G>
__device__ __forceinline__ void pbmm_rp_read(const G& gr,
                                             float (&xr)[PBMM_RP_P],
                                             float (&xi)[PBMM_RP_P],
                                             const float* sre,
                                             const float* sim) {
#pragma unroll
  for (int j = 0; j < G::J; ++j) {
    if (!gr.on[j]) continue;
    const float* ar = sre + pbmm_rp_pad(gr.base[j]);
    const float* ai = sim + pbmm_rp_pad(gr.base[j]);
#pragma unroll
    for (int q = 0; q < G::L; ++q) {
      xr[j * G::L + q] = ar[pbmm_rp_pad(q * G::ST)];
      xi[j * G::L + q] = ai[pbmm_rp_pad(q * G::ST)];
    }
  }
}

template <class G>
__device__ __forceinline__ void pbmm_rp_write(const G& gr,
                                              const float (&xr)[PBMM_RP_P],
                                              const float (&xi)[PBMM_RP_P],
                                              float* sre, float* sim) {
#pragma unroll
  for (int j = 0; j < G::J; ++j) {
    if (!gr.on[j]) continue;
    float* ar = sre + pbmm_rp_pad(gr.base[j]);
    float* ai = sim + pbmm_rp_pad(gr.base[j]);
#pragma unroll
    for (int q = 0; q < G::L; ++q) {
      ar[pbmm_rp_pad(q * G::ST)] = xr[j * G::L + q];
      ai[pbmm_rp_pad(q * G::ST)] = xi[j * G::L + q];
    }
  }
}

// Passes PASS .. passes - 2, each from and back to the row's shared memory
// (sre, sim), after a barrier.  Every thread of the block calls it.
template <int N, bool INVERSE, int PASS>
__device__ __forceinline__ void pbmm_rp_middle(
    int t, float* sre, float* sim, const float* __restrict__ tw_re,
    const float* __restrict__ tw_im, unsigned long long keep) {
  if constexpr (PASS < pbmm_row_plan(N, INVERSE).passes - 1) {
    using G = PbmmRpGroups<N, INVERSE, PASS>;
    const G gr(t, keep);
    float xr[PBMM_RP_P], xi[PBMM_RP_P];
    __syncthreads();
    pbmm_rp_read(gr, xr, xi, sre, sim);
    pbmm_rp_stages<G, INVERSE>(gr, xr, xi, tw_re, tw_im);
    pbmm_rp_write(gr, xr, xi, sre, sim);
    pbmm_rp_middle<N, INVERSE, PASS + 1>(t, sre, sim, tw_re, tw_im, keep);
  }
}

// A whole transform of one row: load(gr, xr, xi) fills the first pass's
// groups from the kernel's input, the passes run, and store(gr, xr, xi)
// takes the last pass's (ADJ_LAST: its groups adjacent, g = t J + j).
// The callbacks read the pass's constants as PbmmRpOf<decltype(gr)>::K.
// REAL: a real input, forward only (pbmm_rp_stages).
template <int N, bool INVERSE, bool ADJ_LAST, bool REAL = false, class Load,
          class Store>
__device__ __forceinline__ void pbmm_row_transform(
    int t, float* sre, float* sim, const float* __restrict__ tw_re,
    const float* __restrict__ tw_im, unsigned long long keep, Load&& load,
    Store&& store) {
  constexpr int LAST = pbmm_row_plan(N, INVERSE).passes - 1;
  {
    using G = PbmmRpGroups<N, INVERSE, 0>;
    const G gr(t, keep);
    float xr[PBMM_RP_P], xi[PBMM_RP_P];
    load(gr, xr, xi);
    pbmm_rp_stages<G, INVERSE, REAL>(gr, xr, xi, tw_re, tw_im);
    pbmm_rp_write(gr, xr, xi, sre, sim);
  }
  pbmm_rp_middle<N, INVERSE, 1>(t, sre, sim, tw_re, tw_im, keep);
  {
    using G = PbmmRpGroups<N, INVERSE, LAST, ADJ_LAST>;
    const G gr(t, keep);
    float xr[PBMM_RP_P], xi[PBMM_RP_P];
    __syncthreads();
    pbmm_rp_read(gr, xr, xi, sre, sim);
    pbmm_rp_stages<G, INVERSE>(gr, xr, xi, tw_re, tw_im);
    store(gr, xr, xi);
  }
}

// Kernels 7 and 3's first DIT pass (st = 1), the Hermitian rebuild: a
// group is 2^K consecutive bit-reversed positions inside one tile, read
// by 16-byte loads from the kept tile the plan names (lane-reversed and
// conjugated where it rebuilds a missing tile).  plan_src / plan_rev: the
// rebuild plan, one int each a tile of the row (device tables,
// spectral/fused.py::lane_plan_tables); tile0: the global number of the
// engine's first tile (its block of a bracketed row); src_re / src_im:
// the row's kept lanes (16-byte aligned); !valid: zeros.
template <class G>
__device__ __forceinline__ void pbmm_rp_rebuild_load(
    const G& gr, float (&xr)[PBMM_RP_P], float (&xi)[PBMM_RP_P],
    const float* src_re, const float* src_im,
    const int* __restrict__ plan_src, const int* __restrict__ plan_rev,
    int tile0, bool valid) {
  constexpr int L = G::L;
  static_assert(L % 4 == 0, "the first DIT pass runs 3 or 4 stages");
#pragma unroll
  for (int j = 0; j < G::J; ++j) {
    const int p0 = gr.base[j];
    const int tile = tile0 + p0 / PBMM_LANE, l0 = p0 % PBMM_LANE;
    const bool rev = __ldg(plan_rev + tile) != 0;
    // Lowest source lane of the group's run of L lanes.
    const int s0 = __ldg(plan_src + tile) * PBMM_LANE +
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
}

// Launch of KERNEL<N> for a row length w (a power of two in [128, 8192]):
// a switch over the seven lengths, for the kernels' C entry points;
// PBMM_RP_SWITCH_BLOCK adds the one-block 16384 (longer rows take their
// bracketed route before it).
#define PBMM_RP_SWITCH(w, LAUNCH) \
  switch (w) {                    \
    case 128: LAUNCH(128); break;   \
    case 256: LAUNCH(256); break;   \
    case 512: LAUNCH(512); break;   \
    case 1024: LAUNCH(1024); break; \
    case 2048: LAUNCH(2048); break; \
    case 4096: LAUNCH(4096); break; \
    case 8192: LAUNCH(8192); break; \
    default: return (int)cudaErrorInvalidValue; \
  }
#define PBMM_RP_SWITCH_BLOCK(w, LAUNCH)                    \
  if ((w) == PBMM_RP_BLOCKN) {                            \
    LAUNCH(PBMM_RP_BLOCKN);                               \
  } else {                                                \
    PBMM_RP_SWITCH(w, LAUNCH)                             \
  }
