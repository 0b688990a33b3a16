// Exact 1-D lower envelope with winner payload, for NVIDIA Hopper (sm_90a):
// EDT phases 2 and 3.
//
// Replaces: gie_mapping_tpu/ops/pallas/envelope.py
//   envelope_packed_pallas (_envelope_2d + _envelope_kernel, packed_yb):
//     phase 2 along axis 0, reading phase 1's packed word (the O(N) kernel
//     below);
//   envelope_mid_pallas (_envelope_mid_3d + _envelope_mid_kernel):
//     phase 3 along the middle axis of [B, N, L], so no transpose is needed
//     between the phases;
//   envelope_pallas (_envelope_2d + _envelope_kernel): the generic axis-0
//     envelope of [N, L] site costs with one separate payload (phase 2 of
//     the 2-D, Z == 1 EDT), which is phase 3's [B, N, L] with B = 1: the
//     wrapper (ops/kernels/envelope.py::envelope) launches gie_envelope_mid.
//
// All three compute, per output row x and lane l,
//   key[x, l] = min_i ( min((x - i)^2 + min(f[i, l], cap), cap) << idx_bits | i )
//   pay[x, l] = payload[site(key), l]
// with cap = (1 << (31 - idx_bits)) - 1.  The packed key is unique per site,
// so ties go to the smallest site by construction and the payload always
// belongs to the same winner.  For the packed phase-1 input,
// f = valid ? word >> (yb + 1) : cap and payload = word & ((1 << (yb + 1)) - 1).
//
// envelope_packed (phase 2) and envelope_mid (phase 3, and the generic
// envelope), one launch each per frame on every canvas-engine path, share
// one body (envelope_fh, templated on the input form): Felzenszwalb and
// Huttenlocher's O(N) lower envelope with exact integer boundaries.  With g_i = f_i + i^2 over the sites S
// whose f_i < cap, site v < q wins at x (ties included) exactly when
// x <= b(v, q) = floor((g_q - g_v) / (2 (q - v))).  Pass 1 walks sites in
// increasing order over a stack of (site, start): it pops the top while
// b(top, q) < start(top), tested without a division as
// g_q - g_top < start(top) * 2 (q - top), and pushes q at b(top, q) + 1
// (0 on an empty stack) when that start is <= N - 1.  Pass 2 walks the
// rows with a pointer into the stack.  A row whose best cost reaches the
// cap (or a lane without a site) gets the plain version's answer: key
// cap << idx_bits | 0 and site 0's payload.  Everything stays in int32 for
// costs 0 <= f: a site's f < cap = 2^(31 - idx_bits) - 1 and i^2 < 2^(2 idx_bits).
//
// Bound on the H100: bytes, 12 per element for the packed input (22 MB,
// 0.0066 ms at the cow-lady slice's [152, 80 * 152]), 16 for separate f and
// payload (30 MB, 0.0088 ms at its phase-3 [152, 80, 152]).  But one lane is
// a serial chain, and the slice has only 12,160 phase-2 lanes, about three
// warps per SM: a thread per lane ran 0.050 ms on an H100 80GB HBM3 at
// 700 W, all of it chain.  So each lane's sites AND rows are cut into
// kChunks chunks, one warp each: pass 1 builds one stack per chunk of
// sites; in pass 2 each warp writes its chunk of rows, walking a pointer
// into every chunk's stack and keeping the lexicographic min of (cost,
// site) (chunks come in site order, so a strict < keeps ties on the smaller
// site).  Fewer chunks lengthen pass 1's chain, more add pass-2 work (every
// row evaluates every chunk).  A CTA holds 32 lanes of one b (grid: lane
// tiles x B, flattened), neighbouring threads on neighbouring lanes, so each
// site row is one coalesced read and each output row one coalesced write.
// The lanes' columns (the packed word, or f and the payload) are staged
// into shared memory by cp.async (no register holds a load), which also
// turns the winner's payload into a shared-memory read where neighbouring
// lanes win at different sites; the columns, the stacks (int2 entries:
// site << 16 | start, and the site's f) and the stack sizes are laid out
// [..][32], so a warp's accesses at any mix of sites fall in 32 distinct
// banks.  Phase 2 (6 chunks): 60 KiB at N = 152, 195 KiB at its limit
// N = 512.  Phase 3 (4 chunks, the fastest of 2, 3, 4, 6 and 8 at the
// paths' shapes on an H100 80GB HBM3 at 700 W; PERF.md): 42 KiB at N = 80,
// so 5 CTAs fit an SM and the slice's 760 take 1.15 waves, 194 KiB at its
// limit N = 384.  Entries of one word
// (f read back from the column) fit 7 CTAs and one wave, but the dependent
// read on every pop and advance made each CTA slower: on an H100 80GB HBM3
// at 700 W that design ran 0.0170 ms against this one's 0.0197 at
// [152, 80, 152], and 0.0119 and 0.0129 against 0.0104 and 0.0106 at the
// gated slab's [96, 80, 96] and scan2d's [128, 56, 128], the shapes most
// frames run.
//
// The generic envelope keeps phase 3's instantiation.  Its grids are
// small (a 100 x 100 2-D window is 4 CTAs), so its time is one CTA's, about
// 12 us on an H100 80GB HBM3 at 700 W, against 3.6 us for the brute-force
// body it replaced (a thread per output looping over every site); at the
// sharded EDT's [128, 56 * 128] and [56, 128 * 128] it takes a third and
// two thirds of that body's time.  Cutting pass 2's rows over 8, 16 or 32
// warps instead of 4 did not shorten a CTA (PERF.md).
#include "common.cuh"

namespace {

constexpr int kFhLanes = 32;           // lanes per CTA
constexpr int kPackedChunks = 6;       // phase 2: site (and row) chunks per lane
constexpr int kMidChunks = 4;          // phase 3
constexpr int kPackedMaxSites = 512;   // shared memory: see fh_smem_bytes
constexpr int kMidMaxSites = 384;

__host__ __device__ constexpr int fh_chunk(int N, int chunks) {
  return (N + chunks - 1) / chunks;
}

// columns [cols][N][32] int32 + stacks [chunks][chunk + 1][32] int2 (one
// entry for an end marker) + stack sizes [chunks][32]
__host__ __device__ constexpr int fh_smem_bytes(int N, int chunks, int cols) {
  return 4 * kFhLanes *
         (cols * N + 2 * chunks * (fh_chunk(N, chunks) + 1) + chunks);
}

__device__ __forceinline__ int floor_div(int a, int d) {  // d > 0
  const int q = a / d;  // C truncates toward zero
  return a - q * d < 0 ? q - 1 : q;
}

__device__ __forceinline__ void cp_async4(const int32_t* smem_dst,
                                          const int32_t* src) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

// One CTA: 32 lanes of batch row b, kChunks warps.  kPacked: `a` is phase
// 1's packed word (f = valid ? a >> (yb + 1) : cap, payload =
// a & ((1 << (yb + 1)) - 1)); else `a` is f and `p` the payload.  Site i of
// lane l of row b sits at [b * N * L + i * L + l].  A stack entry: x = site
// << 16 | start, y = the site's cost f.
template <int kChunks, bool kPacked>
__device__ __forceinline__ void envelope_fh(
    const int32_t* __restrict__ a, const int32_t* __restrict__ p,
    int32_t* __restrict__ key_out, int32_t* __restrict__ pay_out, int N,
    int64_t L, int tiles, int idx_bits, int yb) {
  extern __shared__ int32_t smem[];
  constexpr int kCols = kPacked ? 1 : 2;
  const int t = threadIdx.x % kFhLanes;  // lane within the CTA
  const int c = threadIdx.x / kFhLanes;  // chunk (= warp)
  const int M = fh_chunk(N, kChunks);
  const int S = M + 1;  // stack capacity with the end marker
  const int32_t* col = smem + t;
  const int32_t* pcol = smem + kFhLanes * N + t;  // separate payload only
  const int2* stacks = (const int2*)(smem + kCols * kFhLanes * N) + t;
  int2* stk = (int2*)(smem + kCols * kFhLanes * N) + c * S * kFhLanes + t;
  int32_t* sizes = smem + kFhLanes * (kCols * N + 2 * kChunks * S) + t;
  const int64_t lane = int64_t(blockIdx.x % tiles) * kFhLanes + t;
  const int64_t base = int64_t(blockIdx.x / tiles) * N * L + lane;
  const bool active = lane < L;  // every thread reaches the barriers
  const int32_t cap = (1 << (31 - idx_bits)) - 1;
  const int sh = yb + 1;

  // stage the columns: warp c copies rows c, c + chunks, ...
  if (active) {
    for (int i = c; i < N; i += kChunks) {
      cp_async4(col + i * kFhLanes, a + base + int64_t(i) * L);
      if (!kPacked) cp_async4(pcol + i * kFhLanes, p + base + int64_t(i) * L);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // pass 1: warp c builds the envelope of sites [c M, c M + M); the top
  // (site tv, start ts, g tg) stays in registers, the next word is read
  // one site ahead
  const int q0 = c * M, q1 = active ? min(N, q0 + M) : q0;
  int sp = 0, tv = 0, ts = 0;
  int32_t tg = 0;
  int32_t wn = q0 < q1 ? col[q0 * kFhLanes] : 0;
  for (int q = q0; q < q1; ++q) {
    const int32_t wq = wn;
    if (q + 1 < q1) wn = col[(q + 1) * kFhLanes];
    if (kPacked && !(wq & 1)) continue;
    const int32_t fq = kPacked ? wq >> sh : wq;
    if (fq >= cap) continue;
    const int32_t gq = fq + q * q;
    while (sp > 0 && gq - tg < ts * 2 * (q - tv)) {
      if (--sp > 0) {
        const int2 e = stk[(sp - 1) * kFhLanes];
        tv = e.x >> 16;
        ts = e.x & 0xFFFF;
        tg = e.y + tv * tv;
      }
    }
    const int start = sp == 0 ? 0 : floor_div(gq - tg, 2 * (q - tv)) + 1;
    if (start <= N - 1) {
      stk[sp * kFhLanes] = make_int2((q << 16) | start, fq);
      ++sp;
      tv = q;
      ts = start;
      tg = gq;
    }
  }
  stk[sp * kFhLanes] = make_int2(0xFFFF, 0);  // end marker: start 0xFFFF > N
  sizes[c * kFhLanes] = sp;
  __syncthreads();
  if (!active) return;

  // pass 2: warp c writes rows [c M, c M + M), each the lexicographic min
  // of (cost, site) over the chunks' envelopes; chunks come in site order,
  // so a strict < leaves a tie to the smaller site.  Per chunk: its
  // current site and cost and its next entry, read ahead; a binary search
  // over the starts places it at the first row.  Starts strictly increase
  // from 0, so a chunk moves at most once a row.  A chunk without a site
  // has cost cap and never wins.
  const int x0 = c * M, x1 = min(N, x0 + M);
  if (x0 >= x1) return;
  const int2* nxt[kChunks];  // the entry after the current one
  int v[kChunks], ns[kChunks];
  int32_t fv[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int2* s = stacks + k * S * kFhLanes;
    int lo = 0, hi = sizes[k * kFhLanes] - 1;  // last entry starting <= x0
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if ((s[mid * kFhLanes].x & 0xFFFF) <= x0) lo = mid; else hi = mid - 1;
    }
    const int2 e = hi >= 0 ? s[lo * kFhLanes] : make_int2(0, cap);
    v[k] = e.x >> 16;
    fv[k] = e.y;
    nxt[k] = s + (hi >= 0 ? lo + 1 : 0) * kFhLanes;
    ns[k] = nxt[k]->x & 0xFFFF;
  }
  const int32_t mask = (1 << sh) - 1;
  for (int x = x0; x < x1; ++x) {
    int32_t bc = cap;
    int bv = 0;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      if (ns[k] <= x) {
        const int2 e = *nxt[k];
        v[k] = e.x >> 16;
        fv[k] = e.y;
        nxt[k] += kFhLanes;
        ns[k] = nxt[k]->x & 0xFFFF;
      }
      const int d = x - v[k];
      const int32_t cost = d * d + fv[k];
      if (cost < bc) {
        bc = cost;
        bv = v[k];
      }
    }
    // bc == cap leaves bv = 0: the plain version's capped key and payload
    const int64_t o = base + int64_t(x) * L;
    key_out[o] = (bc << idx_bits) | bv;
    pay_out[o] = kPacked ? col[bv * kFhLanes] & mask : pcol[bv * kFhLanes];
  }
}

__global__ void __launch_bounds__(kFhLanes * kPackedChunks)
envelope_packed_fh_kernel(const int32_t* __restrict__ w,
                          int32_t* __restrict__ key_out,
                          int32_t* __restrict__ pay_out, int N, int64_t L,
                          int tiles, int idx_bits, int yb) {
  envelope_fh<kPackedChunks, true>(w, nullptr, key_out, pay_out, N, L, tiles,
                                   idx_bits, yb);
}

__global__ void __launch_bounds__(kFhLanes * kMidChunks)
envelope_mid_fh_kernel(const int32_t* __restrict__ f,
                       const int32_t* __restrict__ pay,
                       int32_t* __restrict__ key_out,
                       int32_t* __restrict__ pay_out, int N, int64_t L,
                       int tiles, int idx_bits) {
  envelope_fh<kMidChunks, false>(f, pay, key_out, pay_out, N, L, tiles,
                                 idx_bits, 0);
}

// Raise a kernel's dynamic shared memory limit (48 KB by default) to
// `bytes`, once per device (`raised` is the caller's flag per device).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool (&raised)[64], int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return e;
    raised[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace

// Phase 2: packed int32 [N, L] (sites on axis 0) -> key, payload [N, L];
// N <= 512 (returns cudaErrorInvalidValue above).
GIE_EXPORT int gie_envelope_packed(const void* packed, void* key_out,
                                   void* pay_out, int N, int64_t L,
                                   int idx_bits, int yb, void* stream) {
  if (N <= 0 || L == 0) return 0;
  if (N > kPackedMaxSites) return (int)cudaErrorInvalidValue;
  static bool raised[64];
  const cudaError_t e =
      allow_smem(envelope_packed_fh_kernel, raised,
                 fh_smem_bytes(kPackedMaxSites, kPackedChunks, 1));
  if (e != cudaSuccess) return (int)e;
  const int64_t tiles = (L + kFhLanes - 1) / kFhLanes;
  envelope_packed_fh_kernel<<<unsigned(tiles), kFhLanes * kPackedChunks,
                              fh_smem_bytes(N, kPackedChunks, 1),
                              (cudaStream_t)stream>>>(
      (const int32_t*)packed, (int32_t*)key_out, (int32_t*)pay_out, N, L,
      int(tiles), idx_bits, yb);
  return (int)cudaGetLastError();
}

// Phase 3: f, payload int32 [B, N, L] (sites on axis 1) -> key, payload;
// N <= 384 (returns cudaErrorInvalidValue above).
GIE_EXPORT int gie_envelope_mid(const void* f, const void* pay, void* key_out,
                                void* pay_out, int B, int N, int64_t L,
                                int idx_bits, void* stream) {
  if (B <= 0 || N <= 0 || L == 0) return 0;
  if (N > kMidMaxSites) return (int)cudaErrorInvalidValue;
  static bool raised[64];
  const cudaError_t e = allow_smem(envelope_mid_fh_kernel, raised,
                                   fh_smem_bytes(kMidMaxSites, kMidChunks, 2));
  if (e != cudaSuccess) return (int)e;
  const int64_t tiles = (L + kFhLanes - 1) / kFhLanes;
  envelope_mid_fh_kernel<<<unsigned(tiles * B), kFhLanes * kMidChunks,
                           fh_smem_bytes(N, kMidChunks, 2),
                           (cudaStream_t)stream>>>(
      (const int32_t*)f, (const int32_t*)pay, (int32_t*)key_out,
      (int32_t*)pay_out, N, L, int(tiles), idx_bits);
  return (int)cudaGetLastError();
}
