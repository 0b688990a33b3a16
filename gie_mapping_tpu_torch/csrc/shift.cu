// Canvas scroll shift with the fused coc re-anchor, for NVIDIA Hopper
// (sm_90a).
//
// Replaces: gie_mapping_tpu/ops/pallas/blockrows.py::shift_canvas_pallas
// (_shift_kernel).  On the TPU the x/y displacement rides a scalar-prefetched
// index map and the z displacement is a STATIC lane rotation, so the caller
// dispatches a lax.switch over a few z shifts and composes larger ones with
// a second pass (a Mosaic lane-rotation limit).  Here every thread computes
// its own source address, so one kernel takes any shift, teleports beyond
// the canvas included, in one read and one write.
//
// On the packed canvas view cv [X, Y, L] (L = 3 * Z words, int32 bit
// patterns of the packed uint32 voxel words):
//   out[x, y, l] = cv[x + sx, y + sy, l + sl]   where the source is in range,
//                  defaults[l]                  elsewhere,
// then the surviving voxels' canvas-relative cocs re-anchor by the shift,
// per 16-bit half of the word (lane l % 3 == 1 holds cx | cy << 16, lane 2
// holds cz): the 0x7FFF sentinel passes through, the subtraction wraps mod
// 2^16, lane 0 (dist | occ | type) is untouched.  Exposed lanes get the
// defaults pattern, which is all sentinel, so re-anchoring them is a no-op.
//
// Bound on the H100: memory.  A cow-lady canvas is 152 x 152 x 240 words,
// 22.2 MB read plus 22.2 MB written per scroll, ~13 us at 3.35 TB/s.  One
// thread moves one 16-byte int4: sl = 24 * zb and the row pitch L are
// multiples of 4 words, so a 4-word group never straddles the in-range
// edge and every access is a full aligned 16-byte transaction.
#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t reanchor(uint32_t w, int lm, uint32_t rx,
                                             uint32_t ry, uint32_t rz) {
  if (lm == 0) return w;
  const uint32_t sent = 0x7FFFu;
  const uint32_t lo = w & 0xFFFFu;
  const uint32_t hi = w >> 16;
  const uint32_t lo_delta = lm == 1 ? rx : rz;
  const uint32_t new_lo = lo == sent ? lo : (lo - lo_delta) & 0xFFFFu;
  const uint32_t new_hi = (lm == 1 && hi != sent) ? (hi - ry) & 0xFFFFu : hi;
  return new_lo | (new_hi << 16);
}

__global__ void shift_canvas_kernel(const int4* __restrict__ src,
                                    int4* __restrict__ dst,
                                    const int4* __restrict__ defaults, int X,
                                    int Y, int L, int sx, int sy, int sl,
                                    uint32_t rx, uint32_t ry, uint32_t rz) {
  const int Lq = L >> 2;
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= int64_t(X) * Y * Lq) return;
  const int q = int(i % Lq);
  const int64_t xy = i / Lq;
  const int y = int(xy % Y);
  const int x = int(xy / Y);
  const int xs = x + sx, ys = y + sy, ls = 4 * q + sl;
  int4 v;
  if (xs >= 0 && xs < X && ys >= 0 && ys < Y && ls >= 0 && ls < L) {
    v = src[(int64_t(xs) * Y + ys) * Lq + (ls >> 2)];
  } else {
    v = defaults[q];
  }
  const int l0 = 4 * q;
  v.x = int(reanchor(uint32_t(v.x), (l0 + 0) % 3, rx, ry, rz));
  v.y = int(reanchor(uint32_t(v.y), (l0 + 1) % 3, rx, ry, rz));
  v.z = int(reanchor(uint32_t(v.z), (l0 + 2) % 3, rx, ry, rz));
  v.w = int(reanchor(uint32_t(v.w), (l0 + 3) % 3, rx, ry, rz));
  dst[i] = v;
}

}  // namespace

// src, dst int32 [X, Y, L] and defaults int32 [L], C-contiguous, 16-byte
// aligned, L a multiple of 4; src and dst must not overlap.  sx, sy, sl:
// the source offset in voxels / voxels / lanes (the caller clamps a shift
// beyond the canvas, which gives all defaults either way); rx, ry, rz: the
// coc re-anchor deltas mod 2^16.
GIE_EXPORT int gie_shift_canvas(const void* src, void* dst, const void* defaults,
                                int X, int Y, int L, int sx, int sy, int sl,
                                int rx, int ry, int rz, void* stream) {
  const int64_t n = int64_t(X) * Y * (L / 4);
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = unsigned((n + threads - 1) / threads);
  shift_canvas_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int4*)src, (int4*)dst, (const int4*)defaults, X, Y, L, sx, sy, sl,
      uint32_t(rx) & 0xFFFFu, uint32_t(ry) & 0xFFFFu, uint32_t(rz) & 0xFFFFu);
  return (int)cudaGetLastError();
}
