// Kernel 3: Hermitian rebuild + row IFFT + |z| + blur + crop + chroma
// combine + YIQ->RGB, straight to the output layout.
//
// Replaces pbmm_tpu/engine/post_pallas.py:198 rowifft_post_fused (the
// Pallas kernel launched at :382, with the row transform of
// spectral/fused.py:1532 make_row_ifft_block and the rebuild of :1182
// _rebuild_kept_lanes).  Both chroma sources and all three output
// layouts of the JAX kernel are template parameters:
//   U8 = false: the original I/Q come as (T, H, W) f32 planes;
//   U8 = true:  they are formed here from the (T, 3, H, W) uint8 source
//               frames, (r c0 + g c1 + b c2) * window with the 1/255
//               folded into c (post_pallas.py:319-331);
//   LAYOUT 0 "tuple3":    three (T, H, W) f32 planes;
//   LAYOUT 1 "planar":    one (T, 3, H, W) f32 array;
//   LAYOUT 2 "planar_u8": one (T, 3, H, W) uint8 array, rint(255 x)
//                         (round half to even, as jnp.round and
//                         torch.round; the value is clipped to [0, 1]).
// The reference's quirk switches are runtime flags: Re z in place of |z|
// (reconstruct="real"), the window compensation (multiply by
// 1 / max(win, 1e-3)) and the YIQ gains, in the JAX kernel's order
// (post_pallas.py:335-342).
//
// Design.  A block owns a run of `run` output rows of one frame and
// streams the run's region rows (the run plus the r-row blur halo on each
// side) through three steps, `rows` region rows at a time:
//   1. the row transform on row_pass.cuh's engine (N / 16 threads a row,
//      up to four radix-2 stages a pass in registers), kernel 7's: its
//      first pass gathers the bit-reversed kept lanes with 16-byte loads,
//      rebuilding the missing tiles by the static plan, and its last pass
//      stores |z| * scale (or Re z * scale) into the row's own exchange
//      plane, rounded as kernel 7 rounds it, so the |z| rows are kernel
//      7's bit for bit;
//   2. the horizontal blur of each row, once, at the crop's columns only:
//      a thread owns four neighbouring columns and keeps their taps' sum
//      hb in registers (no modulo: the halo check puts x0 - r and
//      x0 + in_w + r inside the row);
//   3. the vertical taps: a ring of the 2 r previous hb rows in shared
//      memory (2 r x in_w f32), to which the thread's own four columns
//      alone are read and written, so the ring needs no barrier; once a
//      row's window is complete the epilogue runs on the four pixels:
//      16-byte loads of I/Q and the window (or 4-byte uchar4 loads of the
//      uint8 frames), the windowed chroma, compensation, gains, YIQ->RGB
//      and the clip, and 16-byte (planar_u8: 4-byte) stores.
// So each region row is transformed once a run (the halo twice at the
// runs' ends), each blur product is taken once, and the blur sums in
// kernel 3's order of products and sums, every product and sum rounded on
// its own (__fmul_rn / __fadd_rn): the output equals kernel 7 followed by
// kernel 10 bit for bit, and "planar_u8" is exactly rint(255 * "planar").
// Shared memory: rows x pbmm_rp_row_floats(N) + 2 r x in_w floats, at
// most 227 KB; the caller chooses rows (engine/post_fused.py::
// kernel3_rows: up to 256 threads, fewer where the ring leaves less room)
// and runs kernel 7 + kernel 10 where not even one row fits.  The run
// length spreads the frames' rows over the blocks the SMs hold at once.
//
// What bounds it on an H100: it reads each region row's 2 x Wk f32 once
// and the chroma (8 bytes of f32 I/Q or 3 bytes of u8 a pixel, and the
// window), and writes 12 (f32) or 3 (u8) bytes a pixel: ~50 KB an output
// row at 1080p with f32 I/Q in and out; the transform costs 5 W log2(W)
// flops a region row: bytes bound.  On an NVIDIA H100 80GB HBM3 at its
// 700 W limit (chip_smoke.py) it takes 0.468 ms warm at the 1080p shape
// (16 x 1080 x 1920 out of 1152 x 1152 -> 2048 lanes, radius 2: 842 MB,
// 1.8 TB/s, against a 0.251 ms bound), 0.513 with the uint8 chroma to
// planar_u8 and 0.619 at radius 5 (the stage-by-stage design before it:
// 2.176, 2.179 and 7.118).

#include "common.cuh"
#include "row_pass.cuh"

struct PostParams {
  PbmmLanePlan plan;
  float taps[2 * PBMM_MAX_BLUR_R + 1];
  float m[9];    // YIQ -> RGB, row-major
  float iq[6];   // I and Q rows of RGB -> YIQ times 1/255 (u8 chroma)
  float gains[3];  // YIQ gains
  int magnitude;   // |z| (1) or Re z (0)
  int comp;        // divide the Hann window back out
  int gain;        // apply the gains
};

struct PostIO {
  const float* rre;  // (T, hr, wk) bit-reversed kept lanes
  const float* rim;
  const float* i_plane;  // (T, in_h, in_w) f32 chroma, or null (U8)
  const float* q_plane;
  const unsigned char* rgb_u8;  // (T, 3, in_h, in_w), or null
  const float* win;             // (in_h, in_w) crop-region window
  const float* tw_re;           // compact_twiddles(W, inverse)
  const float* tw_im;
  void* out0;
  void* out1;
  void* out2;
  int radius, run, hr, wk, in_h, in_w, yrow0, x0;
  float scale;
};

// Word of natural lane c in a row's |z| plane: one word of padding every
// 32, so the four-column taps of a warp (stride 4) fall on distinct banks.
__device__ __forceinline__ int pp_zpad(int c) { return c + (c >> 5); }

// The epilogue's inputs of four pixels: the window and the f32 I/Q (or
// the uint8 R, G, B).
struct PpIn {
  float4 w, a, b;
  uchar4 r, g, bl;
};

template <bool U8>
__device__ __forceinline__ PpIn pp_load(const PostIO& io, int f, int j,
                                        int x) {
  const size_t plane = (size_t)io.in_h * io.in_w;
  const size_t pix = (size_t)j * io.in_w + x;
  PpIn in;
  in.w = __ldg(reinterpret_cast<const float4*>(io.win + pix));
  if (U8) {
    const unsigned char* px = io.rgb_u8 + (size_t)f * 3 * plane + pix;
    in.r = *reinterpret_cast<const uchar4*>(px);
    in.g = *reinterpret_cast<const uchar4*>(px + plane);
    in.bl = *reinterpret_cast<const uchar4*>(px + 2 * plane);
  } else {
    const size_t o = (size_t)f * plane + pix;
    in.a = __ldg(reinterpret_cast<const float4*>(io.i_plane + o));
    in.b = __ldg(reinterpret_cast<const float4*>(io.q_plane + o));
  }
  return in;
}

// The epilogue on the four pixels (f, j, x .. x + 3): vb the blurred Y.
template <bool U8, int LAYOUT>
__device__ __forceinline__ void pp_epilogue(const PostIO& io,
                                            const PostParams& prm,
                                            const PpIn& in, int f, int j,
                                            int x, float (&vb)[4]) {
  const size_t plane = (size_t)io.in_h * io.in_w;
  const size_t pix = (size_t)j * io.in_w + x;
  const float wn[4] = {in.w.x, in.w.y, in.w.z, in.w.w};
  float iw[4], qw[4];
  if (U8) {
    const unsigned char rc[4] = {in.r.x, in.r.y, in.r.z, in.r.w};
    const unsigned char gc[4] = {in.g.x, in.g.y, in.g.z, in.g.w};
    const unsigned char bc[4] = {in.bl.x, in.bl.y, in.bl.z, in.bl.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ru = (float)rc[e], gu = (float)gc[e], bu = (float)bc[e];
      iw[e] = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(ru, prm.iq[0]),
                                            __fmul_rn(gu, prm.iq[1])),
                                  __fmul_rn(bu, prm.iq[2])),
                        wn[e]);
      qw[e] = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(ru, prm.iq[3]),
                                            __fmul_rn(gu, prm.iq[4])),
                                  __fmul_rn(bu, prm.iq[5])),
                        wn[e]);
    }
  } else {
    const float iv[4] = {in.a.x, in.a.y, in.a.z, in.a.w};
    const float qv[4] = {in.b.x, in.b.y, in.b.z, in.b.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      iw[e] = __fmul_rn(iv[e], wn[e]);
      qw[e] = __fmul_rn(qv[e], wn[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (prm.comp) {
      const float inv = __fdiv_rn(1.0f, fmaxf(wn[e], 1e-3f));
      vb[e] = __fmul_rn(vb[e], inv);
      iw[e] = __fmul_rn(iw[e], inv);
      qw[e] = __fmul_rn(qw[e], inv);
    }
    if (prm.gain) {
      vb[e] = __fmul_rn(vb[e], prm.gains[0]);
      iw[e] = __fmul_rn(iw[e], prm.gains[1]);
      qw[e] = __fmul_rn(qw[e], prm.gains[2]);
    }
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float cl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = __fadd_rn(__fadd_rn(__fmul_rn(vb[e], prm.m[3 * d]),
                                          __fmul_rn(iw[e], prm.m[3 * d + 1])),
                                __fmul_rn(qw[e], prm.m[3 * d + 2]));
      cl[e] = fminf(fmaxf(v, 0.0f), 1.0f);
    }
    if (LAYOUT == 2) {
      const size_t po = ((size_t)f * 3 + d) * plane + pix;
      uchar4 u;
      u.x = (unsigned char)rintf(__fmul_rn(cl[0], 255.0f));
      u.y = (unsigned char)rintf(__fmul_rn(cl[1], 255.0f));
      u.z = (unsigned char)rintf(__fmul_rn(cl[2], 255.0f));
      u.w = (unsigned char)rintf(__fmul_rn(cl[3], 255.0f));
      *reinterpret_cast<uchar4*>((unsigned char*)io.out0 + po) = u;
    } else {
      float* dst = LAYOUT == 0
                       ? (d == 0 ? (float*)io.out0
                                 : d == 1 ? (float*)io.out1 : (float*)io.out2) +
                             (size_t)f * plane + pix
                       : (float*)io.out0 + ((size_t)f * 3 + d) * plane + pix;
      *reinterpret_cast<float4*>(dst) = make_float4(cl[0], cl[1], cl[2], cl[3]);
    }
  }
}

#define PP_MAX_THREADS 512  // a block: one row of 8192 lanes

template <int N, bool U8, int LAYOUT>
__global__ void __launch_bounds__(PP_MAX_THREADS)
    rowifft_post_kernel(PostIO io, PostParams prm) {
  extern __shared__ float smem[];
  constexpr int NT = N / PBMM_RP_P;
  constexpr int RF = pbmm_rp_row_floats(N);
  const int rows = blockDim.x / NT;  // region rows in flight
  const int rr = threadIdx.x / NT, t = threadIdx.x % NT;
  float* sre = smem + rr * RF;
  float* sim = sre + pbmm_rp_pad(N);
  float* ring = smem + rows * RF;  // 2 r hb rows of in_w
  const int r = io.radius, r2 = 2 * r, in_w = io.in_w;
  const int f = blockIdx.y;
  const int j0 = blockIdx.x * io.run;  // the run's first output row
  const int nreg = min(io.run, io.in_h - j0) + r2;  // its region rows
  // Region row of the run's local row 0.
  const size_t reg0 = (size_t)f * io.hr + io.yrow0 + j0 - r;

  for (int y0 = 0; y0 < nreg; y0 += rows) {
    // 1. The transform of local rows y0 .. y0 + rows - 1, |z| into each
    //    row's re plane at pp_zpad(lane).
    const bool valid = y0 + rr < nreg;
    const float* src_re = io.rre + (reg0 + (valid ? y0 + rr : 0)) * io.wk;
    const float* src_im = io.rim + (reg0 + (valid ? y0 + rr : 0)) * io.wk;
    // First DIT pass (st = 1): kernel 7's gather of 2^K consecutive
    // bit-reversed positions inside one tile from the kept tile the plan
    // names (lane-reversed and conjugated where it rebuilds a missing one).
    auto load = [&](const auto& gr, float (&xr)[PBMM_RP_P],
                    float (&xi)[PBMM_RP_P]) {
      using G = PbmmRpOf<decltype(gr)>;
      constexpr int L = G::L;
      static_assert(L % 4 == 0, "the first DIT pass runs 3 or 4 stages");
#pragma unroll
      for (int j = 0; j < G::J; ++j) {
        const int p0 = gr.base[j];
        const int tile = p0 / PBMM_LANE, l0 = p0 % PBMM_LANE;
        const bool rev = prm.plan.rev[tile] != 0;
        const int s0 = prm.plan.src[tile] * PBMM_LANE +
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
    // Last DIT pass: point q of group j is natural lane g + q st.  Every
    // thread of the block calls it: the barrier lets the row's last-pass
    // reads of its planes finish before |z| overwrites them.
    auto store = [&](const auto& gr, const float (&xr)[PBMM_RP_P],
                     const float (&xi)[PBMM_RP_P]) {
      using G = PbmmRpOf<decltype(gr)>;
      __syncthreads();
      if (!valid) return;
#pragma unroll
      for (int j = 0; j < G::J; ++j) {
#pragma unroll
        for (int q = 0; q < G::L; ++q) {
          const float a = xr[j * G::L + q], b = xi[j * G::L + q];
          sre[pp_zpad(gr.pos(j, q))] =
              prm.magnitude
                  ? __fmul_rn(sqrtf(__fadd_rn(__fmul_rn(a, a),
                                              __fmul_rn(b, b))),
                              io.scale)
                  : __fmul_rn(a, io.scale);
        }
      }
    };
    pbmm_row_transform<N, true, false>(t, sre, sim, io.tw_re, io.tw_im, ~0ull,
                                       load, store);
    __syncthreads();

    // 2-3. Per four columns: each new row's hb, the vertical taps of the
    //      output row it completes, the epilogue, and hb into the ring.
    //      The epilogue's loads run one output row ahead of its
    //      arithmetic (the next row of the quad, or the next quad's first).
    const int nrow = min(rows, nreg - y0);
    const int i0 = max(0, r2 - y0);  // the first row completing an output
    const int xstep = 4 * blockDim.x;
    PpIn next;
    if (i0 < nrow && 4 * (int)threadIdx.x < in_w)
      next = pp_load<U8>(io, f, j0 + y0 + i0 - r2, 4 * threadIdx.x);
    for (int x = 4 * threadIdx.x; x < in_w; x += xstep) {
      for (int i = 0; i < nrow; ++i) {
        const int yy = y0 + i;  // local region row
        const float* z = smem + i * RF;
        float hb[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = io.x0 + x + e;
          float h = __fmul_rn(z[pp_zpad(c)], prm.taps[r]);
          for (int k = 1; k <= r; ++k)
            h = __fadd_rn(h, __fadd_rn(__fmul_rn(z[pp_zpad(c - k)],
                                                 prm.taps[r - k]),
                                       __fmul_rn(z[pp_zpad(c + k)],
                                                 prm.taps[r + k])));
          hb[e] = h;
        }
        if (i >= i0) {  // output row j0 + yy - 2 r: rows yy - 2 r .. yy
          const PpIn in = next;
          if (i + 1 < nrow)
            next = pp_load<U8>(io, f, j0 + yy + 1 - r2, x);
          else if (x + xstep < in_w)
            next = pp_load<U8>(io, f, j0 + y0 + i0 - r2, x + xstep);
          float vb[4];
          int slot = yy % (r2 ? r2 : 1);  // ring slot of row yy - 2 r
          for (int ky = 0; ky < r2; ++ky) {
            const float4 v =
                *reinterpret_cast<const float4*>(ring + slot * in_w + x);
            const float tk = prm.taps[ky];
            const float tv[4] = {__fmul_rn(v.x, tk), __fmul_rn(v.y, tk),
                                 __fmul_rn(v.z, tk), __fmul_rn(v.w, tk)};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              vb[e] = ky == 0 ? tv[e] : __fadd_rn(vb[e], tv[e]);
            slot = slot + 1 == r2 ? 0 : slot + 1;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float tv = __fmul_rn(hb[e], prm.taps[r2]);
            vb[e] = r2 == 0 ? tv : __fadd_rn(vb[e], tv);
          }
          pp_epilogue<U8, LAYOUT>(io, prm, in, f, j0 + yy - r2, x, vb);
        }
        if (r2)  // the slot of row yy - 2 r, whose last reader was above
          *reinterpret_cast<float4*>(ring + (yy % r2) * in_w + x) =
              make_float4(hb[0], hb[1], hb[2], hb[3]);
      }
    }
    __syncthreads();  // the |z| planes are read; the next rows may come
  }
}

// Launch of kernel<N, U8, LAYOUT>: the run length from the blocks the SMs
// hold at once, then the grid.
template <int N, bool U8, int LAYOUT>
static cudaError_t launch_post(PostIO io, const PostParams& prm, int rows,
                               int t, cudaStream_t stream) {
  const auto kernel = rowifft_post_kernel<N, U8, LAYOUT>;
  const int threads = rows * (N / PBMM_RP_P);
  const size_t smem = ((size_t)rows * pbmm_rp_row_floats(N) +
                       2 * (size_t)io.radius * io.in_w) *
                      sizeof(float);
  if (threads > PP_MAX_THREADS) return cudaErrorInvalidValue;
  cudaError_t err = pbmm_smem_opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  const int slots = sms * (per_sm > 1 ? per_sm : 1);
  const int runs = slots > t ? slots / t : 1;  // runs a frame
  io.run = (io.in_h + runs - 1) / runs;
  const dim3 grid((io.in_h + io.run - 1) / io.run, t);
  rowifft_post_kernel<N, U8, LAYOUT><<<grid, threads, smem, stream>>>(io,
                                                                       prm);
  return cudaGetLastError();
}

template <int N>
static cudaError_t post_variant(const PostIO& io, const PostParams& prm,
                                int rows, int t, int layout, bool u8,
                                cudaStream_t s) {
  switch (layout + 3 * (int)u8) {
    case 0: return launch_post<N, false, 0>(io, prm, rows, t, s);
    case 1: return launch_post<N, false, 1>(io, prm, rows, t, s);
    case 2: return launch_post<N, false, 2>(io, prm, rows, t, s);
    case 3: return launch_post<N, true, 0>(io, prm, rows, t, s);
    case 4: return launch_post<N, true, 1>(io, prm, rows, t, s);
    default: return launch_post<N, true, 2>(io, prm, rows, t, s);
  }
}

// layout: 0 tuple3 (out0..2 = R, G, B planes), 1 planar f32, 2 planar
// uint8 (out0 only).  rgb_u8 non-null selects the u8 chroma source
// (i_plane/q_plane are then unused).  tw_re / tw_im:
// compact_twiddles(w, inverse=True).  rows: region rows a block
// transforms at once (engine/post_fused.py::kernel3_rows).
extern "C" int pbmm_rowifft_post(
    const float* rre, const float* rim, const float* i_plane,
    const float* q_plane, const unsigned char* rgb_u8, const float* win,
    const float* tw_re, const float* tw_im, void* out0, void* out1,
    void* out2, const int* plan_src, const int* plan_rev, int n_tiles,
    const float* taps, int radius, int rows, const float* yiq_to_rgb, const float* iq_u8, int layout, int t, int hr,
    int wk, int w, int in_h, int in_w, int yrow0, int x0, float scale,
    int magnitude, int comp, int gain, float g_y, float g_i, float g_q,
    void* stream) {
  const bool u8 = rgb_u8 != nullptr;
  if (t < 1 || t > 65535 || n_tiles < 1 || n_tiles > PBMM_MAX_TILES ||
      n_tiles * PBMM_LANE != w || !pbmm_rp_length_ok(w) ||
      wk < PBMM_LANE || wk > w || radius < 0 ||
      radius > PBMM_MAX_BLUR_R || rows < 1 || in_h < 1 ||
      in_w < 4 || in_w % 4 != 0 || yrow0 - radius < 0 ||
      yrow0 + in_h + radius > hr || x0 < radius || x0 + in_w + radius > w ||
      layout < 0 || layout > 2 ||
      (!u8 && (i_plane == nullptr || q_plane == nullptr)) ||
      out0 == nullptr || (layout == 0 && (out1 == nullptr || out2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  // 16-byte loads and stores (4-byte for the uint8 frames and planes).
  const void* vec16[] = {rre, rim, win, out0, u8 ? nullptr : i_plane,
                         u8 ? nullptr : q_plane, layout == 0 ? out1 : nullptr,
                         layout == 0 ? out2 : nullptr};
  for (const void* p : vec16)
    if ((size_t)p % (layout == 2 && p == out0 ? 4 : 16) != 0)
      return (int)cudaErrorMisalignedAddress;
  if ((size_t)rgb_u8 % 4 != 0) return (int)cudaErrorMisalignedAddress;
  PostParams prm;
  for (int i = 0; i < n_tiles; ++i) {
    if (plan_src[i] < 0 || (plan_src[i] + 1) * PBMM_LANE > wk)
      return (int)cudaErrorInvalidValue;
    prm.plan.src[i] = plan_src[i];
    prm.plan.rev[i] = plan_rev[i];
  }
  for (int i = 0; i <= 2 * radius; ++i) prm.taps[i] = taps[i];
  for (int i = 0; i < 9; ++i) prm.m[i] = yiq_to_rgb[i];
  for (int i = 0; i < 6; ++i) prm.iq[i] = iq_u8[i];
  prm.gains[0] = g_y;
  prm.gains[1] = g_i;
  prm.gains[2] = g_q;
  prm.magnitude = magnitude;
  prm.comp = comp;
  prm.gain = gain;
  const PostIO io = {rre,   rim,  i_plane, q_plane, rgb_u8, win,
                     tw_re, tw_im, out0,   out1,    out2,   radius,
                     0,     hr,   wk,      in_h,    in_w,   yrow0,
                     x0,    scale};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
#define PP_LAUNCH(N) \
  err = post_variant<N>(io, prm, rows, t, layout, u8, s)
  PBMM_RP_SWITCH(w, PP_LAUNCH)
#undef PP_LAUNCH
  return (int)err;
}
