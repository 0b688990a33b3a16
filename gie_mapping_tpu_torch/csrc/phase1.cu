// EDT phase 1 (1-D distance to the nearest occupied voxel along y) with the
// packed output word, for NVIDIA Hopper (sm_90a).
//
// Replaces: gie_mapping_tpu/ops/pallas/phase1.py::phase1_packed_pallas
// (_phase1_kernel), a Hillis-Steele max/min scan over a VMEM-resident
// [8, Y, 128] block.
//
// Output, per voxel (yb = bits(Y - 1)):
//   valid ? (g1^2 << (yb + 1)) | (coc_y << 1) | 1 : 0
// with ties at equal forward/backward distance going to the lower y, and
// valid = g1 < max_width.
//
// Bound on the H100: bytes, 1 read and 4 written per voxel (9.2 MB, 0.0028
// ms at the cow-lady canvas [152, 152, 80]).  The first design, a thread
// per (x, z) column making two serial passes over y (the reference's
// local_edt_core.h:14-82), ran 0.035 ms there on an H100 80GB HBM3 at
// 700 W: 12,160 threads, each a chain of about 300 dependent steps, the
// backward pass reading back the words the forward pass parked in the
// output.  This design has no chain along y:
//   1. a CTA takes kTz z-columns of one x-plane (grid: x times z-tiles);
//   2. each column's occupancy becomes a bitmask in shared memory, one
//      32-bit word per 32 y (Y <= 1024: at most 32 words), a thread per
//      (word, z) loading its 32 bytes (neighbouring threads on neighbouring
//      z, so each row's bytes are one coalesced load);
//   3. a thread per column records, per word, the last occupied y before
//      it and the first after it (a walk over at most 32 words);
//   4. a thread per (y, z), z fastest so the stores coalesce, finds the
//      last occupied y <= its own and the first >= its own with __clz /
//      __ffs on its word, or the summaries of step 3 where its word has
//      none, and writes the packed word once.
// kTz (a power of two up to 16) trades CTAs for store width: the wrapper
// takes 8 where that grid fits one wave of the card, else 16, and never
// more than Z rounded up to a power of two (ops/kernels/phase1.py).  The kernel reads the
// int8 type directly (occupied = type == 2): the int32 widening in front of
// the TPU kernel was a Mosaic workaround.
#include "common.cuh"

namespace {

constexpr int8_t kOccupied = 2;
constexpr int kThreads = 256;
constexpr int kMaxWords = 32;   // Y <= 1024 (the packed word's limit)
constexpr int kNone = 1 << 29;  // "no occupied y after"

template <int kTz>
__global__ void __launch_bounds__(kThreads)
phase1_bits_kernel(const int8_t* __restrict__ vox_type,
                   int32_t* __restrict__ out, int Y, int Z, int tiles, int yb,
                   int max_width) {
  __shared__ uint32_t bits[kMaxWords * kTz];  // [word][z]
  __shared__ int32_t before[kMaxWords * kTz];  // last occupied y before word
  __shared__ int32_t after[kMaxWords * kTz];   // first occupied y after word
  constexpr int kRows = kThreads / kTz;        // y rows (or words) per pass
  const int W = (Y + 31) >> 5;
  const int zl = threadIdx.x % kTz;
  const int r = threadIdx.x / kTz;
  const int z = (blockIdx.x % tiles) * kTz + zl;
  const bool zin = z < Z;
  const int64_t plane = int64_t(blockIdx.x / tiles) * Y * Z;
  const int8_t* t = vox_type + plane + z;
  int32_t* o = out + plane + z;

  // 2. occupancy bits: bit i of word w is y = 32 w + i
  for (int w = r; w < W; w += kRows) {
    uint32_t m = 0;
    if (zin) {
      const int8_t* tw = t + int64_t(w) * 32 * Z;
      if (w * 32 + 32 <= Y) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          m |= uint32_t(tw[int64_t(i) * Z] == kOccupied) << i;
      } else {
        for (int i = 0; i < Y - w * 32; ++i)
          m |= uint32_t(tw[int64_t(i) * Z] == kOccupied) << i;
      }
    }
    bits[w * kTz + zl] = m;
  }
  __syncthreads();

  // 3. per column and word, the nearest occupied y outside the word
  if (r == 0) {
    int last = -1;
    for (int w = 0; w < W; ++w) {
      before[w * kTz + zl] = last;
      const uint32_t m = bits[w * kTz + zl];
      if (m) last = w * 32 + 31 - __clz((int)m);
    }
    int next = kNone;
    for (int w = W - 1; w >= 0; --w) {
      after[w * kTz + zl] = next;
      const uint32_t m = bits[w * kTz + zl];
      if (m) next = w * 32 + __ffs((int)m) - 1;
    }
  }
  __syncthreads();
  if (!zin) return;

  // 4. one packed word per (y, z)
  for (int y = r; y < Y; y += kRows) {
    const int w = y >> 5, b = y & 31;
    const uint32_t m = bits[w * kTz + zl];
    const uint32_t lo = m & (0xFFFFFFFFu >> (31 - b));  // occupied y' <= y
    const uint32_t hi = m >> b;                         // occupied y' >= y
    const int lst = lo ? w * 32 + 31 - __clz((int)lo) : before[w * kTz + zl];
    const int nxt = hi ? y + __ffs((int)hi) - 1 : after[w * kTz + zl];
    const int d_fwd = lst >= 0 ? y - lst : max_width;
    const int d_bwd = nxt < kNone ? nxt - y : max_width;
    const int g1 = min(min(d_fwd, d_bwd), max_width);
    const bool valid = g1 < max_width;
    const int coc = d_fwd <= d_bwd ? lst : nxt;
    o[int64_t(y) * Z] = valid ? ((g1 * g1) << (yb + 1)) | (coc << 1) | 1 : 0;
  }
}

template <int kTz>
int launch(const void* vox_type, void* out, int X, int Y, int Z, int yb,
           int max_width, cudaStream_t stream) {
  const int tiles = (Z + kTz - 1) / kTz;
  phase1_bits_kernel<kTz><<<unsigned(int64_t(X) * tiles), kThreads, 0,
                            stream>>>((const int8_t*)vox_type, (int32_t*)out,
                                      Y, Z, tiles, yb, max_width);
  return (int)cudaGetLastError();
}

}  // namespace

// vox_type int8 [X, Y, Z] and out int32 [X, Y, Z], both C-contiguous (an
// x-slab of a contiguous canvas qualifies); 1 <= Y <= 1024; tile_z, the
// z-columns per CTA, is 1, 2, 4, 8 or 16 (cudaErrorInvalidValue otherwise,
// or for a larger Y).
GIE_EXPORT int gie_phase1_packed(const void* vox_type, void* out, int X, int Y,
                                 int Z, int yb, int max_width, int tile_z,
                                 void* stream) {
  if (X == 0 || Y == 0 || Z == 0) return 0;
  if (Y > 32 * kMaxWords) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (tile_z) {
    case 1: return launch<1>(vox_type, out, X, Y, Z, yb, max_width, s);
    case 2: return launch<2>(vox_type, out, X, Y, Z, yb, max_width, s);
    case 4: return launch<4>(vox_type, out, X, Y, Z, yb, max_width, s);
    case 8: return launch<8>(vox_type, out, X, Y, Z, yb, max_width, s);
    case 16: return launch<16>(vox_type, out, X, Y, Z, yb, max_width, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// CTAs of the 8-column kernel that one SM of the current device holds at
// once, as the driver computes it for this build (the wrapper's wave rule),
// or minus a CUDA error code.
GIE_EXPORT int gie_phase1_ctas_per_sm() {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, phase1_bits_kernel<8>, kThreads, 0);
  return e == cudaSuccess ? n : -(int)e;
}
