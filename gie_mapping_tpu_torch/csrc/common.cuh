// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel is exported through a plain C entry point that launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError() so
// the Python wrapper can raise on a refused launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define GIE_EXPORT extern "C" __attribute__((visibility("default")))

namespace gie {

// ---------------------------------------------------------------------------
// Bit-exact single-precision atan2 / atan.
//
// The JAX package's CPU reference calls the C library's atan2f (glibc's
// fdlibm-derived single-precision code, e_atan2f.c / s_atanf.c, built
// without FMA); CUDA's own atan2f rounds differently in the last bit for
// roughly a fifth of all inputs, which moves voxels across panorama bin
// edges.  This is that algorithm with every operation an explicitly rounded
// intrinsic, so no contraction or reassociation can change a bit.
//
// atanf_exact has no branch: the lanes of a warp fall into different
// argument ranges, and the library's four-way branch with a division on
// each arm would serialise them.  Every arm's numerator and denominator
// are formed, the range's pair is selected, and one division follows; the
// smallest range divides x by 1, which is exact.  The range's atan(hi) and
// atan(lo) are selected too, not read from an array with a run-time index
// (which would go to local memory).
// ---------------------------------------------------------------------------
__device__ __forceinline__ float bits_f(uint32_t u) { return __uint_as_float(u); }

__device__ __forceinline__ float atanf_exact(float x) {
  const int32_t hx = __float_as_int(x);
  const int32_t ix = hx & 0x7fffffff;
  const float ax = fabsf(x);
  // ranges of |x|: < 7/16 (id -1), < 11/16 (0), < 19/16 (1), < 39/16 (2),
  // else (3)
  const bool r_m1 = ix < 0x3ee00000, r0 = ix < 0x3f300000;
  const bool r1 = ix < 0x3f980000, r2 = ix < 0x401c0000;
  const float num = r_m1 ? x
                  : r0   ? __fsub_rn(__fadd_rn(ax, ax), 1.0f)
                  : r1   ? __fsub_rn(ax, 1.0f)
                  : r2   ? __fsub_rn(ax, 1.5f)
                         : -1.0f;
  const float den = r_m1 ? 1.0f
                  : r0   ? __fadd_rn(ax, 2.0f)
                  : r1   ? __fadd_rn(ax, 1.0f)
                  : r2   ? __fadd_rn(__fmul_rn(ax, 1.5f), 1.0f)
                         : ax;
  const float xr = __fdiv_rn(num, den);
  const float z = __fmul_rn(xr, xr);
  const float w = __fmul_rn(z, z);
  float s1 = __fmul_rn(bits_f(0x3c8569d7u), w);
  s1 = __fmul_rn(__fadd_rn(s1, bits_f(0x3d4bda59u)), w);
  s1 = __fmul_rn(__fadd_rn(s1, bits_f(0x3d886b35u)), w);
  s1 = __fmul_rn(__fadd_rn(s1, bits_f(0x3dba2e6eu)), w);
  s1 = __fmul_rn(__fadd_rn(s1, bits_f(0x3e124925u)), w);
  s1 = __fmul_rn(__fadd_rn(s1, bits_f(0x3eaaaaabu)), z);
  float s2 = __fmul_rn(bits_f(0xbd15a221u), w);
  s2 = __fmul_rn(__fsub_rn(s2, bits_f(0x3d6ef16bu)), w);
  s2 = __fmul_rn(__fsub_rn(s2, bits_f(0x3d9d8795u)), w);
  s2 = __fmul_rn(__fsub_rn(s2, bits_f(0x3de38e38u)), w);
  s2 = __fmul_rn(__fsub_rn(s2, bits_f(0x3e4ccccdu)), w);
  const float xs = __fmul_rn(__fadd_rn(s1, s2), xr);
  const float hi = bits_f(r0 ? 0x3eed6338u : r1 ? 0x3f490fdau
                          : r2 ? 0x3f7b985eu : 0x3fc90fdau);
  const float lo = bits_f(r0 ? 0x31ac3769u : r1 ? 0x33222168u
                          : r2 ? 0x33140fb4u : 0x33a22168u);
  const float r = __fsub_rn(hi, __fsub_rn(__fsub_rn(xs, lo), xr));
  const float atanhi3 = bits_f(0x3fc90fdau), atanlo3 = bits_f(0x33a22168u);
  const float huge =  // |x| >= 2^25: +-pi/2; NaN: itself
      ix > 0x7f800000 ? __fadd_rn(x, x)
      : hx > 0 ? __fadd_rn(atanhi3, atanlo3) : __fsub_rn(-atanhi3, atanlo3);
  return ix >= 0x4c000000 ? huge
         : ix < 0x31000000 ? x  // |x| < 2^-29
         : r_m1 ? __fsub_rn(xr, xs) : (hx < 0 ? -r : r);
}

__device__ __forceinline__ float atan2f_exact(float y, float x) {
  const float pi = bits_f(0x40490fdbu), pi_o_2 = bits_f(0x3fc90fdbu);
  const float pi_o_4 = bits_f(0x3f490fdbu), neg_pi_lo = bits_f(0x33bbbd2eu);
  const float tiny = bits_f(0x0da24260u);
  const int32_t hx = __float_as_int(x), hy = __float_as_int(y);
  const int32_t ix = hx & 0x7fffffff, iy = hy & 0x7fffffff;
  if (ix > 0x7f800000 || iy > 0x7f800000) return __fadd_rn(x, y);  // NaN
  if (hx == 0x3f800000) return atanf_exact(y);                      // x == 1
  const int m = ((hy >> 31) & 1) | ((hx >> 30) & 2);  // 2*sign(x)+sign(y)
  if (iy == 0) {
    if (m <= 1) return y;
    return m == 2 ? __fadd_rn(pi, tiny) : __fsub_rn(-pi, tiny);
  }
  if (ix == 0) return hy < 0 ? __fsub_rn(-pi_o_2, tiny) : __fadd_rn(tiny, pi_o_2);
  if (ix == 0x7f800000) {
    if (iy == 0x7f800000) {
      switch (m) {
        case 0: return __fadd_rn(tiny, pi_o_4);
        case 1: return __fsub_rn(-pi_o_4, tiny);
        case 2: return __fadd_rn(__fmul_rn(3.0f, pi_o_4), tiny);
        default: return __fsub_rn(__fmul_rn(-3.0f, pi_o_4), tiny);
      }
    }
    switch (m) {
      case 0: return 0.0f;
      case 1: return -0.0f;
      case 2: return __fadd_rn(pi, tiny);
      default: return __fsub_rn(-pi, tiny);
    }
  }
  if (iy == 0x7f800000) return hy < 0 ? __fsub_rn(-pi_o_2, tiny) : __fadd_rn(tiny, pi_o_2);
  const int32_t d = iy - ix;
  float z;
  if (d > 0x1e7fffff) {
    z = __fsub_rn(pi_o_2, bits_f(0x333bbd2eu));  // |y/x| > 2^60
  } else if (hx < 0 && (d >> 23) < -60) {
    z = 0.0f;
  } else {
    z = atanf_exact(fabsf(__fdiv_rn(y, x)));
  }
  switch (m) {
    case 0: return z;
    case 1: return -z;
    case 2: return __fsub_rn(pi, __fadd_rn(z, neg_pi_lo));
    default: return __fsub_rn(__fadd_rn(z, neg_pi_lo), pi);
  }
}

}  // namespace gie
