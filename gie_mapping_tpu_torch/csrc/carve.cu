// Projective point-cloud sensor model on NVIDIA Hopper (sm_90a): the
// min-depth panorama and endpoint registration over the points
// (gie_panorama), then the free-space carve over the window's voxels
// (gie_carve).
//
// Replaces: gie_mapping_tpu/ops/pallas/carve.py::panorama_select
// (_carve_kernel), the per-voxel lookup of the spherical min-depth panorama,
// together with the rest of gie_mapping_tpu/ops/raycast.py::
// pointcloud_project: its endpoint scatter (:83-94) and panorama scatters
// (:96-110), which XLA runs as scatter-add / scatter-min, and its per-voxel
// tail (the freed test, endpoint override, robot sphere and type map).  On
// the TPU a gather is serialised, so that kernel selects theta rows with a
// one-hot bf16 matmul and phi with a compare-select reduction.  A GPU
// gathers and scatters natively.
//
// gie_panorama: one thread per point.  It bins the point exactly as the
// voxel pass bins a voxel, then takes one atomicMin on the bin's depth bits
// and one atomicAdd on its count: the range is >= +0 and never NaN, so the
// int32 order of its bits is the float order, and min and add do not depend
// on the order of the atomics (deterministic, equal to scatter-min /
// index_add).  The same thread registers the point's endpoint voxel
// (floor(fma(p, 1/w, 0.5)) - pivot, the height band, inside the window)
// with an atomicAdd.  An invalid point does nothing.  A first small launch fills
// the depth table with BIG_DEPTH's bits and zeroes the counts.
//
// gie_carve: a CTA takes kCarveRun consecutive voxels in [X, Y, Z] order
// (z fastest, so the int8 and int32 stores coalesce), two a thread.
// Theta, the planar range and the x/y part of the squared range depend
// only on the (x, y) column, so one thread per column that the CTA touches
// computes them once into shared memory; each voxel then computes only its
// own z offset, range, phi and bin, reads the tables (1 MB at 512x256,
// resident in L2) and writes its ray count and type.  That halves the
// per-voxel transcendental work of the first design (a thread per voxel
// computing everything: two atan2, two roots and the divisions of each
// atan).  Two voxels a thread ran faster than one, four or eight at both
// presets' windows on an H100 80GB HBM3 at 700 W (PERF.md).
//
// Exactness: the bins come from float trigonometry, and a one-ulp change
// moves a voxel across a bin edge.  Every float operation is therefore an
// explicitly rounded intrinsic in the order the JAX CPU reference rounds it:
//   rel  = p - origin; vrel = fma(c, w, -origin)   (XLA contracts c*w - o)
//   r    = sqrt(fma(z, z, fma(y, y, x*x)))          (its norm reduction)
//   rho  = sqrt(fma(x, x, y*y))
//   theta, phi = the C library's atan2f (gie::atan2f_exact)
//   bin  = trunc(clamp((a + pi) * scale, 0, n - 1))
//   endpoint voxel = floor(fma(p, inv_w, 0.5)), inv_w the float32 1/w
//                    (XLA folds p / w, w a constant, into a multiply by
//                    inv_w and contracts it with the + 0.5)
// and the library is built with --fmad=false as a second guard.
//
// Bound on the H100: bytes.  The panorama reads 13 bytes a point (12 of
// position, 1 of validity) and writes its two tables and the window's
// counts once; the carve reads the tables and the counts and writes 5
// bytes a voxel.  What takes the time is instruction issue: the correctly
// rounded divisions, roots and atan2 (two a point, one a voxel) and the
// integer index arithmetic run to a few hundred instructions a point or
// voxel.  Aggregating a warp's atomics on one bin (__match_any_sync, then
// one atomic per bin) made the panorama slower.
#include <algorithm>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int8_t kUnknown = 0, kFree = 1, kOccupied = 2;
constexpr int kCarveThreads = 256;    // threads per CTA of gie_carve
constexpr int kVoxelsPerThread = 2;   // its voxels per thread
constexpr int kCarveRun = kCarveThreads * kVoxelsPerThread;  // per CTA
constexpr int kPanoThreads = 256;     // points per CTA, one per thread

// The launches' arguments as the wrappers pack them into one buffer
// (ops/kernels/carve.py: _PANORAMA_CALL + _PANORAMA_CONFIG, _CARVE_CALL +
// _CARVE_CONFIG): the pointers and the stream, the frame's pivot and
// origin, then the config's values, floats rounded to float32 by the
// wrapper.  One packed buffer costs the host far less than two dozen ctypes
// arguments; the kernels take it by value.
struct Bins {
  int32_t n_theta, n_phi;
  float pi, theta_scale, half_pi, phi_scale;
};
struct PanoramaCall {
  uint64_t points, valid, depth, cnt, endpoint_cnt, stream;
  int32_t n, pvt_x, pvt_y, pvt_z;
  float ox, oy, oz;
  int32_t X, Y, Z;
  float inv_voxel_width, min_h, max_h, big;
  Bins b;
};
struct CarveCall {
  uint64_t depth, cnt, endpoint_cnt, inst_type, ray_count, stream;
  int32_t pvt_x, pvt_y, pvt_z;
  float ox, oy, oz;
  int32_t X, Y, Z;
  float voxel_width, max_length, big;
  int32_t for_motion_planner, robot_r2;
  Bins b;
};
static_assert(sizeof(PanoramaCall) == 128 && sizeof(CarveCall) == 128,
              "the wrappers pack 128 bytes");

__device__ __forceinline__ int bin_of(float a, float shift, float scale,
                                      int n) {
  float v = __fmul_rn(__fadd_rn(a, shift), scale);
  v = fminf(fmaxf(v, 0.0f), float(n - 1));
  return int(v);
}

__device__ __forceinline__ int theta_bin(float rx, float ry, const Bins& b) {
  return bin_of(gie::atan2f_exact(ry, rx), b.pi, b.theta_scale, b.n_theta);
}

__device__ __forceinline__ int phi_bin(float rz, float rho, const Bins& b) {
  return bin_of(gie::atan2f_exact(rz, rho), b.half_pi, b.phi_scale, b.n_phi);
}

__device__ __forceinline__ float planar(float rx, float ry) {
  return __fsqrt_rn(__fmaf_rn(rx, rx, __fmul_rn(ry, ry)));
}

__global__ void panorama_init(const PanoramaCall a) {
  int32_t* __restrict__ depth_bits = (int32_t*)a.depth;
  int32_t* __restrict__ cnt = (int32_t*)a.cnt;
  int32_t* __restrict__ endpoint_cnt = (int32_t*)a.endpoint_cnt;
  const int n_bins = a.b.n_theta * a.b.n_phi, n_vox = a.X * a.Y * a.Z;
  const int32_t big_bits = __float_as_int(a.big);
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < max(n_bins, n_vox);
       i += stride) {
    if (i < n_vox) endpoint_cnt[i] = 0;
    if (i < n_bins) {
      depth_bits[i] = big_bits;
      cnt[i] = 0;
    }
  }
}

__global__ void __launch_bounds__(kPanoThreads)
panorama_points(const PanoramaCall a) {
  const float* __restrict__ points = (const float*)a.points;
  int32_t* __restrict__ depth_bits = (int32_t*)a.depth;
  int32_t* __restrict__ cnt = (int32_t*)a.cnt;
  const int i = blockIdx.x * kPanoThreads + threadIdx.x;
  if (i >= a.n || !((const uint8_t*)a.valid)[i]) return;
  const float px = points[3 * i], py = points[3 * i + 1],
              pz = points[3 * i + 2];
  const float rx = __fsub_rn(px, a.ox), ry = __fsub_rn(py, a.oy),
              rz = __fsub_rn(pz, a.oz);
  const float r =
      __fsqrt_rn(__fmaf_rn(rz, rz, __fmaf_rn(ry, ry, __fmul_rn(rx, rx))));
  const int bin = theta_bin(rx, ry, a.b) * a.b.n_phi +
                  phi_bin(rz, planar(rx, ry), a.b);
  atomicMin(depth_bits + bin, __float_as_int(r));
  atomicAdd(cnt + bin, 1);

  const int lx = int(floorf(__fmaf_rn(px, a.inv_voxel_width, 0.5f))) - a.pvt_x;
  const int ly = int(floorf(__fmaf_rn(py, a.inv_voxel_width, 0.5f))) - a.pvt_y;
  const int lz = int(floorf(__fmaf_rn(pz, a.inv_voxel_width, 0.5f))) - a.pvt_z;
  if (pz >= a.min_h && pz <= a.max_h && lx >= 0 && lx < a.X && ly >= 0 &&
      ly < a.Y && lz >= 0 && lz < a.Z)
    atomicAdd((int32_t*)a.endpoint_cnt + (lx * a.Y + ly) * a.Z + lz, 1);
}

__global__ void __launch_bounds__(kCarveThreads)
carve_kernel(const CarveCall a) {
  const float* __restrict__ depth = (const float*)a.depth;
  const int32_t* __restrict__ cnt = (const int32_t*)a.cnt;
  const int32_t* __restrict__ endpoint_cnt = (const int32_t*)a.endpoint_cnt;
  // per column of the CTA's run: q = rx^2 + ry^2 as the norm rounds it,
  // the planar range and the theta bin (a run of kCarveRun voxels touches
  // at most kCarveRun columns)
  __shared__ float s_q[kCarveRun], s_rho[kCarveRun];
  __shared__ int s_bt[kCarveRun];
  const int n = a.X * a.Y * a.Z;
  const int v0 = blockIdx.x * kCarveRun;
  const int c0 = v0 / a.Z;
  const int ncols = (min(v0 + kCarveRun, n) - 1) / a.Z - c0 + 1;
  for (int t = threadIdx.x; t < ncols; t += kCarveThreads) {
    const int col = c0 + t;
    const float rx = __fmaf_rn(float(col / a.Y + a.pvt_x), a.voxel_width, -a.ox);
    const float ry = __fmaf_rn(float(col % a.Y + a.pvt_y), a.voxel_width, -a.oy);
    s_q[t] = __fmaf_rn(ry, ry, __fmul_rn(rx, rx));
    s_rho[t] = planar(rx, ry);
    s_bt[t] = theta_bin(rx, ry, a.b);
  }
  __syncthreads();
  // voxel v0 + k * kCarveThreads + threadIdx.x: each store instruction
  // covers consecutive voxels, and a thread's voxels are independent
  // chains the compiler can interleave
#pragma unroll
  for (int k = 0; k < kVoxelsPerThread; ++k) {
    const int v = v0 + k * kCarveThreads + threadIdx.x;
    if (v >= n) break;
    const int col = v / a.Z, z = v - col * a.Z, t = col - c0;
    const float rz = __fmaf_rn(float(z + a.pvt_z), a.voxel_width, -a.oz);
    const float vr = __fsqrt_rn(__fmaf_rn(rz, rz, s_q[t]));
    const int bin = s_bt[t] * a.b.n_phi + phi_bin(rz, s_rho[t], a.b);
    const float vdepth = depth[bin];
    const int32_t vcnt = cnt[bin];
    const bool freed = (vdepth < a.big) &&
                       (__fadd_rn(vr, a.voxel_width) < vdepth) &&
                       (vr <= a.max_length);
    const int32_t ep = endpoint_cnt[v];
    int32_t rc = ep > 0 ? ep : (freed ? -min(vcnt, 10) : 0);
    if (a.for_motion_planner) {
      const int dx = col / a.Y - a.X / 2, dy = col % a.Y - a.Y / 2,
                dz = z - a.Z / 2;
      if (dx * dx + dy * dy + dz * dz <= a.robot_r2) rc = -1;
    }
    ((int32_t*)a.ray_count)[v] = rc;
    ((int8_t*)a.inst_type)[v] = rc > 0 ? kOccupied : (rc < 0 ? kFree : kUnknown);
  }
}

}  // namespace

// `packed` is a PanoramaCall: points f32 [n, 3], valid uint8 [n]; outputs
// depth f32 and cnt int32 [n_theta * n_phi], endpoint_cnt int32 [X, Y, Z];
// all contiguous; 3 n and X * Y * Z below 2^31 (the wrapper checks).
GIE_EXPORT int gie_panorama(const void* packed, int nbytes) {
  if (nbytes != sizeof(PanoramaCall)) return (int)cudaErrorInvalidValue;
  PanoramaCall a;
  memcpy(&a, packed, sizeof a);
  const cudaStream_t s = (cudaStream_t)a.stream;
  const int fill = std::max(a.b.n_theta * a.b.n_phi, a.X * a.Y * a.Z);
  panorama_init<<<std::min((fill + 255) / 256, 1024), 256, 0, s>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n == 0) return (int)e;
  panorama_points<<<(a.n + kPanoThreads - 1) / kPanoThreads, kPanoThreads, 0,
                    s>>>(a);
  return (int)cudaGetLastError();
}

// `packed` is a CarveCall: depth f32 / cnt int32 [n_theta * n_phi],
// endpoint_cnt int32 [X, Y, Z]; outputs inst_type int8 and ray_count int32
// [X, Y, Z]; all contiguous; X * Y * Z below 2^31 (the wrapper checks).
GIE_EXPORT int gie_carve(const void* packed, int nbytes) {
  if (nbytes != sizeof(CarveCall)) return (int)cudaErrorInvalidValue;
  CarveCall a;
  memcpy(&a, packed, sizeof a);
  const int n = a.X * a.Y * a.Z;
  if (n == 0) return 0;
  carve_kernel<<<(n + kCarveRun - 1) / kCarveRun, kCarveThreads, 0,
                 (cudaStream_t)a.stream>>>(a);
  return (int)cudaGetLastError();
}
