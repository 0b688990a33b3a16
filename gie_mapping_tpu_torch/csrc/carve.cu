// Projective free-space carve of the point-cloud sensor model, for NVIDIA
// Hopper (sm_90a).
//
// Replaces: gie_mapping_tpu/ops/pallas/carve.py::panorama_select
// (_carve_kernel), the per-voxel lookup of the spherical min-depth panorama.
// On the TPU a gather is serialised, so that kernel selects theta rows with a
// one-hot bf16 matmul and phi with a compare-select reduction.  A GPU
// gathers natively: here one thread per window voxel computes its own
// panorama bin, reads the 512x256 tables (1 MB, resident in L2) directly,
// and fuses the rest of the voxel's sensor model (gie_mapping_tpu/ops/
// raycast.py::pointcloud_project, the freed test, endpoint override, robot
// sphere and type map).
//
// Exactness: the bins come from float trigonometry, and a one-ulp change
// moves a voxel across a bin edge.  Every float operation is therefore an
// explicitly rounded intrinsic in the order the JAX CPU reference rounds it:
//   vrel = fma(c, w, -origin)                 (XLA contracts c*w - o)
//   vr   = sqrt(fma(z, z, fma(y, y, x*x)))    (its norm reduction)
//   rho  = sqrt(fma(x, x, y*y))
//   theta, phi = the C library's atan2f (gie::atan2f_exact)
//   bin  = trunc(clamp((a + pi) * scale, 0, n - 1))
// and the library is built with --fmad=false as a second guard.
//
// Bound on the H100: a few hundred flops per voxel (two atan2, two sqrt,
// two divisions) over 300 k voxels, ~0.1 GFLOP; the 1 MB tables are read
// from L2 and the outputs are 1.5 MB.  Latency and issue bound; neighbouring
// threads take neighbouring z, so the output writes coalesce.
#include "common.cuh"

namespace {

constexpr int8_t kUnknown = 0, kFree = 1, kOccupied = 2;

struct CarveArgs {
  int X, Y, Z;
  int pvt_x, pvt_y, pvt_z;
  float ox, oy, oz;
  float voxel_width;
  int n_theta, n_phi;
  float pi, theta_scale, half_pi, phi_scale;
  float max_length, big;
  int for_motion_planner, robot_r2;
};

__device__ __forceinline__ int bin_of(float a, float shift, float scale,
                                      int n) {
  float v = __fmul_rn(__fadd_rn(a, shift), scale);
  v = fminf(fmaxf(v, 0.0f), float(n - 1));
  return int(v);
}

__global__ void carve_kernel(const float* __restrict__ depth,
                             const int32_t* __restrict__ cnt,
                             const int32_t* __restrict__ endpoint_cnt,
                             int8_t* __restrict__ inst_type,
                             int32_t* __restrict__ ray_count, CarveArgs a) {
  const int64_t v = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= int64_t(a.X) * a.Y * a.Z) return;
  const int z = int(v % a.Z);
  const int y = int((v / a.Z) % a.Y);
  const int x = int(v / (int64_t(a.Y) * a.Z));

  const float rx = __fmaf_rn(float(x + a.pvt_x), a.voxel_width, -a.ox);
  const float ry = __fmaf_rn(float(y + a.pvt_y), a.voxel_width, -a.oy);
  const float rz = __fmaf_rn(float(z + a.pvt_z), a.voxel_width, -a.oz);
  const float vr =
      __fsqrt_rn(__fmaf_rn(rz, rz, __fmaf_rn(ry, ry, __fmul_rn(rx, rx))));
  const float vtheta = gie::atan2f_exact(ry, rx);
  const float vrho = __fsqrt_rn(__fmaf_rn(rx, rx, __fmul_rn(ry, ry)));
  const float vphi = gie::atan2f_exact(rz, vrho);
  const int bt = bin_of(vtheta, a.pi, a.theta_scale, a.n_theta);
  const int bp = bin_of(vphi, a.half_pi, a.phi_scale, a.n_phi);
  const int64_t bin = int64_t(bt) * a.n_phi + bp;
  const float vdepth = depth[bin];
  const int32_t vcnt = cnt[bin];

  const bool freed = (vdepth < a.big) &&
                     (__fadd_rn(vr, a.voxel_width) < vdepth) &&
                     (vr <= a.max_length);
  const int32_t ep = endpoint_cnt[v];
  int32_t rc = ep > 0 ? ep : (freed ? -min(vcnt, 10) : 0);
  if (a.for_motion_planner) {
    const int dx = x - a.X / 2, dy = y - a.Y / 2, dz = z - a.Z / 2;
    if (dx * dx + dy * dy + dz * dz <= a.robot_r2) rc = -1;
  }
  ray_count[v] = rc;
  inst_type[v] = rc > 0 ? kOccupied : (rc < 0 ? kFree : kUnknown);
}

}  // namespace

// depth f32 / cnt int32 [n_theta * n_phi]; endpoint_cnt int32 [X, Y, Z];
// outputs inst_type int8 and ray_count int32 [X, Y, Z]; all contiguous.
GIE_EXPORT int gie_carve(const void* depth, const void* cnt,
                         const void* endpoint_cnt, void* inst_type,
                         void* ray_count, int X, int Y, int Z, int pvt_x,
                         int pvt_y, int pvt_z, float ox, float oy, float oz,
                         float voxel_width, int n_theta, int n_phi, float pi,
                         float theta_scale, float half_pi, float phi_scale,
                         float max_length, float big, int for_motion_planner,
                         int robot_r2, void* stream) {
  const int64_t n = int64_t(X) * Y * Z;
  if (n == 0) return 0;
  const CarveArgs a{X,  Y,  Z,  pvt_x,       pvt_y,   pvt_z,    ox,
                    oy, oz, voxel_width, n_theta, n_phi, pi,    theta_scale,
                    half_pi, phi_scale, max_length, big, for_motion_planner,
                    robot_r2};
  const int threads = 256;
  carve_kernel<<<unsigned((n + threads - 1) / threads), threads, 0,
                 (cudaStream_t)stream>>>(
      (const float*)depth, (const int32_t*)cnt, (const int32_t*)endpoint_cnt,
      (int8_t*)inst_type, (int32_t*)ray_count, a);
  return (int)cudaGetLastError();
}
