// EDT phase 1 (1-D distance to the nearest occupied voxel along y) with the
// packed output word, for NVIDIA Hopper (sm_90a).
//
// Replaces: gie_mapping_tpu/ops/pallas/phase1.py::phase1_packed_pallas
// (_phase1_kernel), a Hillis-Steele max/min scan over a VMEM-resident
// [8, Y, 128] block.  On the GPU the reference's own shape is better: one
// thread per (x, z) column makes two serial passes over y (forward
// last-occupied, backward next-occupied), local_edt_core.h:14-82.
//
// Output, per voxel (yb = bits(Y - 1)):
//   valid ? (g1^2 << (yb + 1)) | (coc_y << 1) | 1 : 0
// with ties at equal forward/backward distance going to the lower y, and
// valid = g1 < max_width.
//
// Bound on the H100: memory.  Each voxel is read twice (int8 type, the
// second read mostly from L2) and written twice (the forward pass parks the
// last-occupied index in the output word, the backward pass overwrites it);
// 152x152x80 canvases move ~16 MB, a few microseconds at 3.35 TB/s, so the
// launch itself dominates.  z is the fastest axis, so the 32 threads of a
// warp read 32 neighbouring bytes and write 32 neighbouring words per step.
// The kernel reads the int8 type directly (occupied = type == 2): the
// int32 widening in front of the TPU kernel was a Mosaic workaround.
#include "common.cuh"

namespace {

constexpr int8_t kOccupied = 2;

__global__ void phase1_packed_kernel(const int8_t* __restrict__ vox_type,
                                     int32_t* __restrict__ out, int X, int Y,
                                     int Z, int yb, int max_width) {
  const int64_t col = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= int64_t(X) * Z) return;
  const int64_t x = col / Z;
  const int64_t z = col % Z;
  const int8_t* t = vox_type + x * Y * Z + z;
  int32_t* o = out + x * Y * Z + z;

  int last = -1;  // last occupied y at or below the current y
  for (int y = 0; y < Y; ++y) {
    if (t[int64_t(y) * Z] == kOccupied) last = y;
    o[int64_t(y) * Z] = last;
  }
  const int big = 1 << 29;
  int next = big;  // first occupied y at or above the current y
  for (int y = Y - 1; y >= 0; --y) {
    if (t[int64_t(y) * Z] == kOccupied) next = y;
    const int lst = o[int64_t(y) * Z];
    const int d_fwd = lst >= 0 ? y - lst : max_width;
    const int d_bwd = next < big ? next - y : max_width;
    const int g1 = min(min(d_fwd, d_bwd), max_width);
    const bool valid = g1 < max_width;
    const int coc = d_fwd <= d_bwd ? lst : next;
    o[int64_t(y) * Z] = valid ? ((g1 * g1) << (yb + 1)) | (coc << 1) | 1 : 0;
  }
}

}  // namespace

// vox_type int8 [X, Y, Z] and out int32 [X, Y, Z], both C-contiguous (an
// x-slab of a contiguous canvas qualifies).
GIE_EXPORT int gie_phase1_packed(const void* vox_type, void* out, int X, int Y,
                                 int Z, int yb, int max_width, void* stream) {
  const int64_t cols = int64_t(X) * Z;
  if (cols == 0 || Y == 0) return 0;
  const int threads = 128;
  const unsigned blocks = unsigned((cols + threads - 1) / threads);
  phase1_packed_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)vox_type, (int32_t*)out, X, Y, Z, yb, max_width);
  return (int)cudaGetLastError();
}
