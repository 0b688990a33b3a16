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
//     the 2-D, Z == 1 EDT), which is the middle-axis kernel with B = 1.
//
// All three compute, per output row x and lane l,
//   key[x, l] = min_i ( min((x - i)^2 + min(f[i, l], cap), cap) << idx_bits | i )
//   pay[x, l] = payload[site(key), l]
// with cap = (1 << (31 - idx_bits)) - 1.  The packed key is unique per site,
// so ties go to the smallest site by construction and the payload always
// belongs to the same winner.  For the packed phase-1 input,
// f = valid ? word >> (yb + 1) : cap and payload = word & ((1 << (yb + 1)) - 1).
//
// Two designs, one function.
//
// envelope_packed (phase 2, one launch per frame on every canvas-engine
// path) runs Felzenszwalb and Huttenlocher's O(N) lower envelope with
// exact integer boundaries.  With g_i = f_i + i^2 over the sites S whose
// f_i < cap, site v < q wins at x (ties included) exactly when
// x <= b(v, q) = floor((g_q - g_v) / (2 (q - v))).  Pass 1 walks sites in
// increasing order over a stack of (site, start): it pops the top while
// b(top, q) < start(top), tested without a division as
// g_q - g_top < start(top) * 2 (q - top), and pushes q at b(top, q) + 1
// (0 on an empty stack) when that start is <= N - 1.  Pass 2 walks the
// rows with a pointer into the stack.  A row whose best cost reaches the
// cap (or a lane without a site) gets the plain version's answer: key
// cap << idx_bits | 0 and site 0's payload.  Everything stays in int32:
// f < cap = 2^(31 - idx_bits) - 1 and i^2 < 2^(2 idx_bits).
//
// Bound on the H100: bytes, 12 per element (22 MB, 0.0066 ms at the cow-lady
// slice's [152, 80 * 152]).  But one lane is a serial chain, and the slice has
// only 12,160 lanes, about three warps per SM: a thread per lane ran 0.050 ms
// on an H100 80GB HBM3 at 700 W, all of it chain.  So each lane's sites AND
// rows are cut into kFhChunks chunks, one warp each: pass 1 builds one stack
// per chunk of sites; in pass 2 each warp writes its chunk of rows, walking a
// pointer into every chunk's stack and keeping the lexicographic min of (cost,
// site) (chunks come in site order, so a strict < keeps ties on the smaller
// site).  Fewer chunks lengthen pass 1's chain, more add pass-2 work.  A CTA
// holds 32 lanes, neighbouring threads on neighbouring lanes, so each site row
// is one coalesced read and each output row one coalesced write.  The lanes'
// columns are staged into shared memory by cp.async (no register holds a load);
// the column, the stacks (int2 entries: site << 16 | start, and the site's f)
// and the stack sizes are laid out [..][32], so a warp's accesses at any mix of
// sites fall in 32 distinct banks.  60 KiB at N = 152, 195 KiB at the limit
// N = 512 (above it the wrapper raises).
//
// envelope_mid and envelope (phase 3 and the generic one) keep the first
// design: one thread per output (x, lane) looping over every site, O(N^2)
// per lane, neighbouring threads on neighbouring lanes.  The generic
// entry's call on a 100 x 100 2-D window is 1 M steps in 100 x 1 CTAs: it
// is bound by launch latency, not by the card.
#include "common.cuh"

namespace {

constexpr int kFhLanes = 32;      // lanes per CTA
constexpr int kFhChunks = 6;      // site (and row) chunks per lane, a warp each
constexpr int kFhMaxSites = 512;  // shared memory: see fh_smem_bytes

__host__ __device__ constexpr int fh_chunk(int N) {
  return (N + kFhChunks - 1) / kFhChunks;
}

// column [N][32] int32 + stacks [chunks][chunk + 1][32] int2 (one entry
// for an end marker) + stack sizes [chunks][32]
__host__ __device__ constexpr int fh_smem_bytes(int N) {
  return 4 * kFhLanes * (N + 2 * kFhChunks * (fh_chunk(N) + 1) + kFhChunks);
}

__device__ __forceinline__ int floor_div(int a, int d) {  // d > 0
  const int q = a / d;  // C truncates toward zero
  return a - q * d < 0 ? q - 1 : q;
}

// A stack entry: x = site << 16 | start, y = the site's cost f.
__global__ void __launch_bounds__(kFhLanes * kFhChunks)
envelope_packed_fh_kernel(const int32_t* __restrict__ w,
                          int32_t* __restrict__ key_out,
                          int32_t* __restrict__ pay_out, int N, int64_t L,
                          int idx_bits, int yb) {
  extern __shared__ int32_t smem[];
  const int t = threadIdx.x % kFhLanes;  // lane within the CTA
  const int c = threadIdx.x / kFhLanes;  // chunk (= warp)
  const int M = fh_chunk(N);
  const int S = M + 1;  // stack capacity with the end marker
  const int32_t* col = smem + t;
  const int2* stacks = (const int2*)(smem + kFhLanes * N) + t;
  int2* stk = (int2*)(smem + kFhLanes * N) + c * S * kFhLanes + t;
  int32_t* sizes = smem + kFhLanes * (N + 2 * kFhChunks * S) + t;
  const int64_t lane = int64_t(blockIdx.x) * kFhLanes + t;
  const bool active = lane < L;  // every thread reaches the barriers
  const int32_t cap = (1 << (31 - idx_bits)) - 1;
  const int sh = yb + 1;

  // stage the column: warp c copies rows c, c + chunks, ...
  if (active) {
    for (int i = c; i < N; i += kFhChunks) {
      const uint32_t dst =
          (uint32_t)__cvta_generic_to_shared(col + i * kFhLanes);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                   "l"(w + int64_t(i) * L + lane));
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
    const int32_t fq = wq >> sh;
    if (!(wq & 1) || fq >= cap) continue;
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
  const int2* nxt[kFhChunks];  // the entry after the current one
  int v[kFhChunks], ns[kFhChunks];
  int32_t fv[kFhChunks];
#pragma unroll
  for (int k = 0; k < kFhChunks; ++k) {
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
    for (int k = 0; k < kFhChunks; ++k) {
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
    const int64_t o = int64_t(x) * L + lane;
    key_out[o] = (bc << idx_bits) | bv;
    pay_out[o] = col[bv * kFhLanes] & mask;
  }
}

__global__ void envelope_kernel(const int32_t* __restrict__ f,
                                const int32_t* __restrict__ pay,
                                int32_t* __restrict__ key_out,
                                int32_t* __restrict__ pay_out, int N,
                                int64_t L, int idx_bits) {
  const int64_t lane = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const int x = blockIdx.y;
  const int64_t base = int64_t(blockIdx.z) * N * L + lane;
  const int32_t cap = (1 << (31 - idx_bits)) - 1;

  int32_t best = 0x7fffffff;
  for (int i = 0; i < N; ++i) {
    const int32_t dx = x - i;
    const int32_t cand = min(dx * dx + min(f[base + int64_t(i) * L], cap), cap);
    best = min(best, (cand << idx_bits) | i);
  }
  const int site = best & ((1 << idx_bits) - 1);
  const int64_t out = base + int64_t(x) * L;
  key_out[out] = best;
  pay_out[out] = pay[base + int64_t(site) * L];
}

int launch(const void* f, const void* pay, void* key_out, void* pay_out,
           int B, int N, int64_t L, int idx_bits, void* stream) {
  if (B == 0 || N == 0 || L == 0) return 0;
  const int threads = 128;
  const dim3 grid(unsigned((L + threads - 1) / threads), unsigned(N),
                  unsigned(B));
  envelope_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)f, (const int32_t*)pay, (int32_t*)key_out,
      (int32_t*)pay_out, N, L, idx_bits);
  return (int)cudaGetLastError();
}

}  // namespace

// Phase 2: packed int32 [N, L] (sites on axis 0) -> key, payload [N, L],
// by the O(N) kernel; N <= 512 (returns cudaErrorInvalidValue above).
GIE_EXPORT int gie_envelope_packed(const void* packed, void* key_out,
                                   void* pay_out, int N, int64_t L,
                                   int idx_bits, int yb, void* stream) {
  if (N <= 0 || L == 0) return 0;
  if (N > kFhMaxSites) return (int)cudaErrorInvalidValue;
  const int smem = fh_smem_bytes(N);
  // raise the kernel's dynamic shared memory limit (48 KB by default) once
  // per device, to what N = kFhMaxSites needs
  static int raised[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(envelope_packed_fh_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             fh_smem_bytes(kFhMaxSites));
    if (e != cudaSuccess) return (int)e;
    raised[dev] = 1;
  }
  const unsigned grid = unsigned((L + kFhLanes - 1) / kFhLanes);
  envelope_packed_fh_kernel<<<grid, kFhLanes * kFhChunks, smem,
                              (cudaStream_t)stream>>>(
      (const int32_t*)packed, (int32_t*)key_out, (int32_t*)pay_out, N, L,
      idx_bits, yb);
  return (int)cudaGetLastError();
}

// Generic: f, payload int32 [N, L] (sites on axis 0) -> key, payload.
GIE_EXPORT int gie_envelope(const void* f, const void* pay, void* key_out,
                            void* pay_out, int N, int64_t L, int idx_bits,
                            void* stream) {
  return launch(f, pay, key_out, pay_out, 1, N, L, idx_bits, stream);
}

// Phase 3: f, payload int32 [B, N, L] (sites on axis 1) -> key, payload.
GIE_EXPORT int gie_envelope_mid(const void* f, const void* pay, void* key_out,
                                void* pay_out, int B, int N, int64_t L,
                                int idx_bits, void* stream) {
  return launch(f, pay, key_out, pay_out, B, N, L, idx_bits, stream);
}
