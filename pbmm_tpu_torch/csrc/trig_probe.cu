// Kernel 14: the phase pass's transcendentals, one element a thread.
//
// Replaces benchmarks/trig_probe.py:27 run_kernel (the Pallas kernel
// launched at :33), which runs each polynomial trig helper of the TPU
// phase pass elementwise on the chip to hold it against fp64.  The port's
// phase pass (phase_pass.cuh, inlined by kernels 2 and 6) uses IEEE
// functions and small helpers in place of those polynomials; this kernel
// includes that header and runs, selected by an op code, exactly what
// kernels 2 and 6 run:
//   0  cs_atan2(y, x)                 (-0 counted as +0, 0 at (0, 0))
//   1  cosf(u)                        2  sinf(u)
//   3  sincosf(t): cos, sin           (the rotation, |t| up to ~90)
//   4  cs_mask(kind, lo, hi, span, f) (the band's raised cosine)
//   5  cs_pow_int(x, n)
//   6  cs_unit_pow(re, im, n): re, im (its 1e-38 guard is subnormal)
//   7  pbmm_phase_bin<true, false>    one standard-mode bin: cur, prev and
//                                     the w plane in, the rotated bin out
//
// What bounds it on an H100: nothing that matters: a few thousand
// elements, one launch, a few microseconds, most of it the launch.  Its
// purpose is correctness on the card: built without fast math or -ftz,
// as every kernel of the port, so the subnormal guard survives and the
// functions are the IEEE ones the plain versions are held against.

#include "phase_pass.cuh"

struct TrigIO {
  const float* in0;
  const float* in1;
  const float* in2;
  const float* in3;
  const float* in4;  // op 7: the w plane, (rows, w)
  const float* fy;   // op 7: frequency of each row, (rows,)
  const float* fx;   // op 7: frequency of each lane, (w,)
  float* out0;
  float* out1;
  int n, w, op, iarg;
  float f0, f1, f2;
};

__global__ void __launch_bounds__(256)
    trig_probe_kernel(TrigIO io, PhaseArgs pa) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  float r0 = 0.0f, r1 = 0.0f;
  switch (io.op) {
    case 0:
      r0 = cs_atan2(io.in0[i], io.in1[i]);
      break;
    case 1:
      r0 = cosf(io.in0[i]);
      break;
    case 2:
      r0 = sinf(io.in0[i]);
      break;
    case 3:
      sincosf(io.in0[i], &r1, &r0);
      break;
    case 4:
      r0 = cs_mask(io.iarg, io.f0, io.f1, io.f2, io.in0[i]);
      break;
    case 5:
      r0 = cs_pow_int(io.in0[i], io.iarg);
      break;
    case 6:
      cs_unit_pow(io.in0[i], io.in1[i], io.iarg, r0, r1);
      break;
    default:  // 7
      pbmm_phase_bin<true, false>(io.in0[i], io.in1[i], io.in2[i], io.in3[i],
                                  io.in4, nullptr, (size_t)i, io.fy,
                                  i / io.w, io.fx, i % io.w, nullptr,
                                  nullptr, pa, r0, r1);
  }
  io.out0[i] = r0;
  if (io.out1) io.out1[i] = r1;
}

// Inputs in0..in4 as the op reads them (null where unread); out1 is null
// for the ops with one result.  iarg: the mask kind (op 4) or the power
// (ops 5, 6); f0, f1, f2: lo, hi, span (op 4); iargs/fargs: the phase
// pass's constants (op 7, standard mode with its host w plane).
extern "C" int pbmm_trig_probe(const float* in0, const float* in1,
                               const float* in2, const float* in3,
                               const float* in4, const float* fy,
                               const float* fx, float* out0, float* out1,
                               const int* iargs, const float* fargs, int op,
                               int iarg, float f0, float f1, float f2, int n,
                               int w, void* stream) {
  PhaseArgs pa = {};
  const bool two = op == 3 || op == 6 || op == 7;
  if (op < 0 || op > 7 || n < 1 || w < 1 || n % w != 0 || in0 == nullptr ||
      out0 == nullptr || (two && out1 == nullptr) ||
      ((op == 0 || op == 6 || op == 7) && in1 == nullptr) ||
      (op == 5 && (iarg < 0 || iarg > 64)) ||
      (op == 6 && (iarg < 0 || iarg > 64)))
    return (int)cudaErrorInvalidValue;
  if (op == 7) {
    if (!pbmm_phase_unpack(iargs, fargs, pa) || !pa.standard || pa.iir ||
        !pa.host_planes || in2 == nullptr || in3 == nullptr ||
        in4 == nullptr || fy == nullptr || fx == nullptr)
      return (int)cudaErrorInvalidValue;
  }
  const TrigIO io = {in0, in1,  in2, in3, in4, fy, fx, out0, out1,
                     n,   w,    op,  iarg, f0, f1, f2};
  trig_probe_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(io,
                                                                        pa);
  return (int)cudaGetLastError();
}
