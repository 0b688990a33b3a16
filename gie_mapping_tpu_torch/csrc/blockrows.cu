// Block-row copies of the canvas scroll and of changed-block streaming, for
// NVIDIA Hopper (sm_90a): four entry points of one copy family.
//
// Replaces: gie_mapping_tpu/ops/pallas/blockrows.py
//   gather_block_rows    (_gather_kernel)       canvas block-columns -> rows
//   scatter_block_rows   (_scatter_kernel)      rows -> canvas blocks
//   gather_archive_rows  (_arow_gather_kernel)  archive rows by id
//   scatter_archive_rows (_arow_scatter_kernel) rows -> archive by id
//
// A block's archive row is 1536 words, [8, 8, 24] row-major: word
// (a * 8 + b) * 24 + c is canvas word cv[8bx + a, 8by + b, 24j + c] of the
// packed canvas view cv [X, Y, L] (L = 3 * Z).  On the TPU the canvas side
// moves whole (8, 8, L) block-column tiles (Mosaic's tiling forbids 24-lane
// slices) and the archive side issues batches of manual 6 KB row DMAs
// behind semaphores; invalid column entries need a "parking" column that
// is rewritten unchanged.  Here one CTA copies one 6 KB row, its threads
// walking the row as 384 aligned int4 (a 24-word canvas run starts at a
// multiple of 4 words), and an invalid entry simply returns.  Valid targets
// are unique, so no two CTAs write the same bytes.
//
// Bound on the H100: memory latency more than bandwidth.  A cow-lady scroll
// moves at most 3,610 rows (22 MB) each way, a 64-column streaming tick 640
// rows (3.9 MB); each CTA keeps 3 independent 16-byte loads per thread in
// flight, and thousands of CTAs cover the latency.
//
// gather_archive_rows, the one of the four that PyTorch has as one call
// (index_select), has a design of its own: a 32-thread CTA per row whose
// lanes issue all 12 of their 16-byte loads before any store.  A design
// with persistent CTAs and 1-D TMA bulk copies through a ring in shared
// memory was slower at every row count, warm and cold (PERF.md).
#include "common.cuh"

namespace {

constexpr int kRowQuads = 8 * 8 * 24 / 4;  // 384 int4 per block row
constexpr int kThreads = 128;

// int4 offset of quad t of block (bx, by, j) in the canvas view
__device__ __forceinline__ int64_t canvas_quad(int t, int bx, int by, int j,
                                               int Y, int Lq) {
  const int a = t / 48;
  const int b = (t / 6) % 8;
  const int c4 = t % 6;
  return (int64_t(8 * bx + a) * Y + (8 * by + b)) * Lq + 6 * j + c4;
}

__global__ void gather_block_rows_kernel(const int4* __restrict__ cv,
                                         const int32_t* __restrict__ col_ids,
                                         int4* __restrict__ out, int Y, int Lq,
                                         int cby, int cbz, int ncols) {
  const int e = blockIdx.x;  // row = column entry k * cbz + z-block j
  const int col = col_ids[e / cbz];
  if (col < 0 || col >= ncols) return;
  const int j = e % cbz, bx = col / cby, by = col % cby;
  int4* row = out + int64_t(e) * kRowQuads;
  for (int t = threadIdx.x; t < kRowQuads; t += kThreads)
    row[t] = cv[canvas_quad(t, bx, by, j, Y, Lq)];
}

__global__ void scatter_block_rows_kernel(int4* __restrict__ cv,
                                          const int4* __restrict__ rows,
                                          const int32_t* __restrict__ col_ids,
                                          const int32_t* __restrict__ valid,
                                          int Y, int Lq, int cby, int cbz,
                                          int ncols) {
  const int e = blockIdx.x;
  if (valid[e] == 0) return;
  const int col = col_ids[e / cbz];
  if (col < 0 || col >= ncols) return;
  const int j = e % cbz, bx = col / cby, by = col % cby;
  const int4* row = rows + int64_t(e) * kRowQuads;
  for (int t = threadIdx.x; t < kRowQuads; t += kThreads)
    cv[canvas_quad(t, bx, by, j, Y, Lq)] = row[t];
}

// gather_archive_rows: one warp per row, one row per CTA (a CTA per row
// spreads even a 320-row gather over every SM).  Each lane issues its 12
// int4 loads (a warp's load j is 512 contiguous bytes) before any store,
// so the row's 6 KB is in flight at once.
constexpr int kWarpRowQuads = kRowQuads / 32;  // 12 int4 per lane

__global__ void __launch_bounds__(32)
gather_archive_rows_kernel(const int4* __restrict__ arch,
                           const int32_t* __restrict__ ids,
                           int4* __restrict__ out, int B) {
  const int k = blockIdx.x;
  const int id = ids[k];
  if (id < 0 || id >= B) return;
  const int4* src = arch + int64_t(id) * kRowQuads + threadIdx.x;
  int4* dst = out + int64_t(k) * kRowQuads + threadIdx.x;
  int4 r[kWarpRowQuads];
#pragma unroll
  for (int j = 0; j < kWarpRowQuads; ++j) r[j] = src[j * 32];
#pragma unroll
  for (int j = 0; j < kWarpRowQuads; ++j) dst[j * 32] = r[j];
}

__global__ void scatter_archive_rows_kernel(int4* __restrict__ arch,
                                            const int4* __restrict__ rows,
                                            const int32_t* __restrict__ ids,
                                            const int32_t* __restrict__ valid,
                                            int B) {
  const int k = blockIdx.x;
  if (valid[k] == 0) return;
  const int id = ids[k];
  if (id < 0 || id >= B) return;
  const int4* src = rows + int64_t(k) * kRowQuads;
  int4* dst = arch + int64_t(id) * kRowQuads;
  for (int t = threadIdx.x; t < kRowQuads; t += kThreads) dst[t] = src[t];
}

}  // namespace

// Canvas view cv int32 [X, Y, L] (L = 3 * Z, a multiple of 24), rows int32
// [S * cbz, 1536], col_ids / valid int32; all C-contiguous and 16-byte
// aligned.  Column ids outside [0, cbx * cby) are skipped.
GIE_EXPORT int gie_gather_block_rows(const void* cv, const void* col_ids,
                                     void* out, int S, int X, int Y, int L,
                                     int cbz, void* stream) {
  if (S == 0 || cbz == 0) return 0;
  const int cby = Y / 8;
  gather_block_rows_kernel<<<S * cbz, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)cv, (const int32_t*)col_ids, (int4*)out, Y, L / 4, cby, cbz,
      (X / 8) * cby);
  return (int)cudaGetLastError();
}

GIE_EXPORT int gie_scatter_block_rows(void* cv, const void* rows,
                                      const void* col_ids, const void* valid,
                                      int S, int X, int Y, int L, int cbz,
                                      void* stream) {
  if (S == 0 || cbz == 0) return 0;
  const int cby = Y / 8;
  scatter_block_rows_kernel<<<S * cbz, kThreads, 0, (cudaStream_t)stream>>>(
      (int4*)cv, (const int4*)rows, (const int32_t*)col_ids,
      (const int32_t*)valid, Y, L / 4, cby, cbz, (X / 8) * cby);
  return (int)cudaGetLastError();
}

// Archive arch int32 [B, 1536], rows int32 [K, 1536], ids / valid int32
// [K]; ids outside [0, B) are skipped.
GIE_EXPORT int gie_gather_archive_rows(const void* arch, const void* ids,
                                       void* out, int K, int B, void* stream) {
  if (K == 0) return 0;
  gather_archive_rows_kernel<<<K, 32, 0, (cudaStream_t)stream>>>(
      (const int4*)arch, (const int32_t*)ids, (int4*)out, B);
  return (int)cudaGetLastError();
}

GIE_EXPORT int gie_scatter_archive_rows(void* arch, const void* rows,
                                        const void* ids, const void* valid,
                                        int K, int B, void* stream) {
  if (K == 0) return 0;
  scatter_archive_rows_kernel<<<K, kThreads, 0, (cudaStream_t)stream>>>(
      (int4*)arch, (const int4*)rows, (const int32_t*)ids,
      (const int32_t*)valid, B);
  return (int)cudaGetLastError();
}
