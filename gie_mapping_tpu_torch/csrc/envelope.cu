// Exact 1-D lower envelope with winner payload, for NVIDIA Hopper (sm_90a):
// EDT phases 2 and 3.
//
// Replaces: gie_mapping_tpu/ops/pallas/envelope.py
//   envelope_packed_pallas (_envelope_2d + _envelope_kernel, packed_yb):
//     phase 2 along axis 0, reading phase 1's packed word;
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
// Bound on the H100: issue rate, not bytes.  Phase 2 of a 152x152x80 canvas
// is 152 * (80 * 152) lanes * 152 sites ~ 0.28 G compare-min steps with a
// ~7 MB working set that stays in the 50 MB L2; the design is one thread per
// output (x, lane) looping over every site, neighbouring threads on
// neighbouring lanes so each site row is one coalesced read per warp.  The
// TPU kernel's band/tile-skip prologue is a speed-up only and is not needed
// for exactness; shared-memory site tiles and a Felzenszwalb stack are later
// work.  The generic entry's call on a 100 x 100 2-D window is 1 M steps in
// 100 x 1 CTAs: it is bound by launch latency, not by the card.
#include "common.cuh"

namespace {

template <bool kPacked>
__global__ void envelope_kernel(const int32_t* __restrict__ f,
                                const int32_t* __restrict__ pay,
                                int32_t* __restrict__ key_out,
                                int32_t* __restrict__ pay_out, int N,
                                int64_t L, int idx_bits, int yb) {
  const int64_t lane = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const int x = blockIdx.y;
  const int64_t base = int64_t(blockIdx.z) * N * L + lane;
  const int32_t cap = (1 << (31 - idx_bits)) - 1;
  const int32_t pay_mask = (1 << (yb + 1)) - 1;

  int32_t best = 0x7fffffff;
  for (int i = 0; i < N; ++i) {
    const int32_t w = f[base + int64_t(i) * L];
    int32_t fi;
    if (kPacked) {
      fi = (w & 1) ? (w >> (yb + 1)) : cap;
    } else {
      fi = w;
    }
    const int32_t dx = x - i;
    const int32_t cand = min(dx * dx + min(fi, cap), cap);
    best = min(best, (cand << idx_bits) | i);
  }
  const int site = best & ((1 << idx_bits) - 1);
  const int64_t out = base + int64_t(x) * L;
  key_out[out] = best;
  if (kPacked) {
    pay_out[out] = f[base + int64_t(site) * L] & pay_mask;
  } else {
    pay_out[out] = pay[base + int64_t(site) * L];
  }
}

int launch(bool packed, const void* f, const void* pay, void* key_out,
           void* pay_out, int B, int N, int64_t L, int idx_bits, int yb,
           void* stream) {
  if (B == 0 || N == 0 || L == 0) return 0;
  const int threads = 128;
  const dim3 grid(unsigned((L + threads - 1) / threads), unsigned(N),
                  unsigned(B));
  if (packed) {
    envelope_kernel<true><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)f, nullptr, (int32_t*)key_out, (int32_t*)pay_out, N,
        L, idx_bits, yb);
  } else {
    envelope_kernel<false><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)f, (const int32_t*)pay, (int32_t*)key_out,
        (int32_t*)pay_out, N, L, idx_bits, 0);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Phase 2: packed int32 [N, L] (sites on axis 0) -> key, payload [N, L].
GIE_EXPORT int gie_envelope_packed(const void* packed, void* key_out,
                                   void* pay_out, int N, int64_t L,
                                   int idx_bits, int yb, void* stream) {
  return launch(true, packed, nullptr, key_out, pay_out, 1, N, L, idx_bits,
                yb, stream);
}

// Generic: f, payload int32 [N, L] (sites on axis 0) -> key, payload.
GIE_EXPORT int gie_envelope(const void* f, const void* pay, void* key_out,
                            void* pay_out, int N, int64_t L, int idx_bits,
                            void* stream) {
  return launch(false, f, pay, key_out, pay_out, 1, N, L, idx_bits, 0,
                stream);
}

// Phase 3: f, payload int32 [B, N, L] (sites on axis 1) -> key, payload.
GIE_EXPORT int gie_envelope_mid(const void* f, const void* pay, void* key_out,
                                void* pay_out, int B, int N, int64_t L,
                                int idx_bits, void* stream) {
  return launch(false, f, pay, key_out, pay_out, B, N, L, idx_bits, 0,
                stream);
}
