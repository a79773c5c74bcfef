// Spherical resampling of MAS variables for Hopper (sm_90a), bound through
// plain C entries.
//
// Two entries share one interpolator, the nonuniform trilinear sample of a
// MAS array (nphi + 1, ntheta, nr) on its (phi periodic, theta, r) mesh of
// raytracinggrff_tpu_torch/ops/resample.py::sample_sph_plain (the JAX
// package's raytracinggrff_tpu/mas/model.py::_interp_sph, :148-187): phi
// taken modulo 2 pi, each axis located by the count of its nodes <= the
// query and the fraction clamped to [0, 1], eight corners lerped along
// phi, theta and r, NaN where r lies off the mesh or is not finite. Each
// launch serves a scene of 1 to kMaxVars variables, each on its own mesh
// (a MAS run staggers the field components), and writes one result a
// variable from one computation of each point's coordinates:
//   rgrff_resample_cube resamples the variables onto a uniform (nx, ny, nz)
//       cube: the voxel's (x, y, z) from the three grid axes,
//       coords.cart_to_sph(x, -z, y) with the longitude offset, the sample,
//       NaN where r < R_MIN, then the fill of non-finite values. It
//       replaces the JAX package's _resample_cube_jit
//       (raytracinggrff_tpu/mas/model.py:259-301, jax.jit around a
//       fori_loop over x-slabs), one device program a variable.
//   rgrff_sample_sph samples the variables at query points (r, colat,
//       lon). It replaces _interp_sph_jit (mas/model.py:133-135), one
//       device program a variable.
// Neither is a TPU kernel. The plain torch versions (ops/resample.py) make
// about 100 launches a 16-plane slab of a cube, and some 20 slab-sized
// temporaries; here one launch covers a whole scene and keeps every
// intermediate in registers.
//
// The arithmetic repeats the plain version's torch ops one by one and in
// their order, and the shipped -fmad=false build keeps nvcc from fusing
// them:
//   * searchsorted(ax, q, right=True) - 1 counts the nodes <= q with
//     torch's test !(node > q), so a NaN q counts every node, as in torch;
//     the index is then clamped to [0, n - 2], so a NaN query reads inside
//     the array. Its fraction and the lerps stay NaN and the r mask hides
//     them, as in the plain version.
//   * torch.remainder(phi, 2 pi) is fmod plus 2 pi where the remainder is
//     negative; a Python scalar enters torch's float32 kernels rounded to
//     float32 (2 pi, 1e-9, R_MIN), and the longitude offset phi0 pi / 180
//     is computed by the wrapper with the plain version's own CPU ops.
//   * torch.clamp passes NaN through, where fminf/fmaxf would drop it.
//   * r^2 = (x^2 + z^2) + y^2 in that order, x^2 a product (torch's pow
//     with exponent 2), and each lerp a * (1 - t) + b * t as two products
//     and one sum.
// acosf and atan2f are CUDA's own, as in torch's kernels. Their library
// code writes its fused multiply-adds explicitly (their PTX holds the same
// 15 fma.rn with and without -fmad=false), so PyTorch's contracting build
// and this one round them alike: on an H100 every voxel and sample equals
// the plain version's (chip_smoke.py phase 18, PERF.md). Sharing a value
// between voxels or variables changes where it is computed, never how.
//
// What bounds it: by the count, bytes. A cube voxel writes 4 bytes a
// variable and reads nothing but the MAS arrays and their axes, which stay
// in L2 (some 0.85 MB a variable for the synthetic model's 64 x 55 x 60
// mesh); a query point reads 12 bytes and writes 4 a variable. Counted as
// chip_smoke.py counts them, a variable-voxel takes some 50 float32
// operations, under the card's 20 operations a byte written. But acos,
// atan2, the IEEE square root and divisions are many instructions each,
// and a binary search is 6-7 dependent loads, so instruction issue and
// load latency held the one-variable design (a thread a voxel, every axis
// searched in global memory) far above the byte bound (PERF.md).
// This design cuts the instructions a variable-voxel:
//   * one launch a scene: sqrt, y / r, acos and the theta and r locates
//     are computed once a voxel for all variables, and once a distinct
//     axis (the wrapper gives each variable an axis id per kind, the same
//     id for the same axis);
//   * a cube thread owns a column (ix, iz) and a run of kRun voxels along
//     iy: the longitude atan2(-z, x), its offset, wrap and fmod, the phi
//     locates and x^2 + z^2 depend on (ix, iz) alone and are computed once
//     a run; a warp still holds consecutive iz and writes one 128-byte row
//     a variable and iy;
//   * the scene's distinct axes are staged in shared memory and searched
//     there; down a column colat falls and r falls and then rises with iy,
//     so a voxel's theta and r cells are walked from the last voxel's for
//     up to kWalk nodes, and searched where the walk does not end;
//   * the sampler reads a point's queries once for all variables, on a
//     grid of the blocks the SMs hold at once (a grid-stride loop takes
//     the rest), so that each block stages the axes once.
// 64-bit offsets throughout.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

// variables a launch; mirrored in ops/_build.py::MAX_VARS
constexpr int kMaxVars = 5;

// Mirror of ops/_build.py::_SphParams. It sits outside the unnamed
// namespace below: the C entries take it, and a parameter of that
// namespace's type would give them internal linkage. Axis kinds are 0 phi
// (the periodic copy included), 1 theta, 2 r; axis[k][a] is the scene's
// distinct axis a of kind k, and variable v reads axis var_axis[v][k] of
// each kind, with dims[v] = (nphi, ntheta, nr) its array's shape.
struct SphParams {
  long long n;                     // query points (rgrff_sample_sph)
  const float* data[kMaxVars];     // each variable's (nphi, ntheta, nr)
  float* out[kMaxVars];            // its cube (nx, ny, nz) or n samples
  const float* axis[3][kMaxVars];
  int axis_len[3][kMaxVars];
  int n_axes[3];
  int var_axis[kMaxVars][3];
  int dims[kMaxVars][3];
  int n_vars;
  int nx, ny, nz;                  // the cube (rgrff_resample_cube)
  int fill_on;                     // replace non-finite values by `fill`
  float lon_offset;  // float32(phi0) * pi / 180 as the plain version rounds it
  float r_min;       // float32(R_MIN)
  float fill;
};

namespace {

constexpr int kThreads = 128;
// iy voxels a cube thread resamples down its column (ix, iz): at 128^3, 16
// gives 131,072 threads and the shortest launch (32 and 64 leave the card
// part idle); at 576^3, 32 and 64 are within 3% of it (PERF.md)
constexpr int kRun = 16;
// float32(2 pi): torch rounds the Python scalar 2 * math.pi so
constexpr float kTwoPi = 6.28318530717958647692f;
// the shared memory a block may use on an H100
constexpr int kMaxSharedBytes = 232448;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// torch.clamp(v, lo, hi): NaN passes
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// The count of nodes of the ascending axis ax[0..n) with !(node > q), by
// binary search: torch.searchsorted(ax, q, right=True).
__device__ __forceinline__ int count_search(const float* ax, int n, float q) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(ax[mid] > q))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The same count, walked from the count `c` of a nearby query for at most
// kWalk nodes, else searched. On an ascending axis the nodes with
// !(node > q) are a prefix, so a walk that stops stops at the search's
// count; a NaN q walks up and is then searched, to n.
constexpr int kWalk = 4;
__device__ __forceinline__ int count_near(const float* ax, int n, int c,
                                          float q) {
#pragma unroll
  for (int s = 0; s < kWalk; ++s) {
    if (c > 0 && ax[c - 1] > q)
      --c;
    else if (c < n && !(ax[c] > q))
      ++c;
    else
      return c;
  }
  return count_search(ax, n, q);
}

// Cell index and clamped fraction of q from its count c:
// ops/resample.py::_axis_locate.
__device__ __forceinline__ int cell(const float* ax, int n, int c, float q,
                                    float& t) {
  const int i = min(max(c - 1, 0), n - 2);
  const float a0 = ax[i], a1 = ax[i + 1];
  t = clamp_nan((q - a0) / (a1 - a0), 0.0f, 1.0f);
  return i;
}

// x[id] of a register array, by selects (an index into a register array
// that the compiler cannot resolve would put the array in local memory)
template <int NA, typename T>
__device__ __forceinline__ T pick(const T (&x)[NA], int id) {
  T v = x[0];
#pragma unroll
  for (int j = 1; j < NA; ++j)
    if (id == j) v = x[j];
  return v;
}

// The kernels are instantiated for NA = 1..kMaxVars, the most distinct
// axes of one kind in the scene, so that a scene of one mesh keeps one
// located cell a kind in registers.

// Copy the scene's distinct axes into shared memory, one after another in
// kind and axis order; off[k][a] is where axis (k, a) starts.
template <int NA>
__device__ __forceinline__ void stage_axes(const SphParams& p, float* sh,
                                           int (&off)[3][NA]) {
  int o = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      off[k][a] = o;
      if (a < p.n_axes[k]) {
        const float* src = p.axis[k][a];
        const int n = p.axis_len[k][a];
        for (int j = threadIdx.x; j < n; j += kThreads)
          sh[o + j] = __ldg(src + j);
        o += n;
      }
    }
  __syncthreads();
}

// Where one point lies on each distinct axis of one kind: the count of
// nodes <= it (kept for the next walk), the cell index and fraction.
template <int NA>
struct Located {
  int c[NA];
  int i[NA];
  float t[NA];
};

// Locate q on every distinct axis of kind k: by binary search, or with
// `walk` by a walk from the counts in `at`.
template <int NA>
__device__ __forceinline__ void locate_all(const SphParams& p,
                                           const float* sh,
                                           const int (&off)[3][NA], int k,
                                           float q, bool walk,
                                           Located<NA>& at) {
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    if (a < p.n_axes[k]) {
      const float* ax = sh + off[k][a];
      const int n = p.axis_len[k][a];
      at.c[a] = walk ? count_near(ax, n, at.c[a], q) : count_search(ax, n, q);
      at.i[a] = cell(ax, n, at.c[a], q, at.t[a]);
    } else {
      at.c[a] = at.i[a] = 0;
      at.t[a] = 0.0f;
    }
  }
}

// Whether r_q lies off each distinct r axis (or is not finite), as
// sample_sph_plain's oob.
template <int NA>
__device__ __forceinline__ void off_mesh(const SphParams& p, const float* sh,
                                         const int (&off)[3][NA], float r_q,
                                         bool (&oob)[NA]) {
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    oob[a] = true;
    if (a < p.n_axes[2]) {
      const float* ax = sh + off[2][a];
      const float r_lo = ax[0] - 1e-9f;
      const float r_hi = ax[p.axis_len[2][a] - 1] + 1e-9f;
      oob[a] = r_q < r_lo || r_q > r_hi || !isfinite(r_q);
    }
  }
}

// Each variable's sample at one located point, NaN where r lies off its r
// axis or `below` holds, then the fill; written to out[v][o].
template <int NA>
__device__ __forceinline__ void write_samples(
    const SphParams& p, const Located<NA>& ph, const Located<NA>& th,
    const Located<NA>& ra, const bool (&oob)[NA], bool below, int64_t o) {
#pragma unroll
  for (int v = 0; v < kMaxVars; ++v) {
    if (v >= p.n_vars) break;
    const int kp = p.var_axis[v][0], kt = p.var_axis[v][1],
              kr = p.var_axis[v][2];
    const int ip = pick(ph.i, kp), it = pick(th.i, kt), ir = pick(ra.i, kr);
    const float tp = pick(ph.t, kp), tt = pick(th.t, kt),
                tr = pick(ra.t, kr);
    const int64_t st = p.dims[v][2];
    const int64_t sp = int64_t(p.dims[v][1]) * p.dims[v][2];
    const float* c = p.data[v] + (int64_t(ip) * p.dims[v][1] + it) * st + ir;
    const float c00 = __ldg(c) * (1.0f - tp) + __ldg(c + sp) * tp;
    const float c10 = __ldg(c + st) * (1.0f - tp) + __ldg(c + sp + st) * tp;
    const float c01 = __ldg(c + 1) * (1.0f - tp) + __ldg(c + sp + 1) * tp;
    const float c11 =
        __ldg(c + st + 1) * (1.0f - tp) + __ldg(c + sp + st + 1) * tp;
    const float c0 = c00 * (1.0f - tt) + c10 * tt;
    const float c1 = c01 * (1.0f - tt) + c11 * tt;
    float val = c0 * (1.0f - tr) + c1 * tr;
    if (pick(oob, kr) || below) val = nan_f();
    if (p.fill_on && !isfinite(val)) val = p.fill;
    p.out[v][o] = val;
  }
}

// One thread a column (ix, iz) and a run of kRun voxels along iy:
// blockIdx.z = ix, blockIdx.y = the run.
template <int NA>
__global__ void __launch_bounds__(kThreads)
    resample_cube_kernel(const float* __restrict__ xs,
                         const float* __restrict__ ys,
                         const float* __restrict__ zs, const SphParams p) {
  extern __shared__ float sh[];
  int off[3][NA];
  stage_axes(p, sh, off);
  const int iz = blockIdx.x * kThreads + threadIdx.x;
  if (iz >= p.nz) return;
  const int ix = blockIdx.z;
  const int iy0 = blockIdx.y * kRun;
  const int iy1 = min(iy0 + kRun, p.ny);
  const float x = __ldg(xs + ix), z = __ldg(zs + iz);
  // coords.image_xyz_to_mas_sph: cart_to_sph(x, -z, y, phi0), whose
  // longitude and x^2 + z^2 do not depend on y
  const float mz = -z;
  const float xz2 = x * x + mz * mz;
  float lon = atan2f(mz, x);
  lon = lon + p.lon_offset;
  if (lon < 0.0f) lon = lon + kTwoPi;
  float phm = fmodf(lon, kTwoPi);
  if (phm < 0.0f) phm += kTwoPi;  // torch adds the divisor to a negative one
  Located<NA> ph, th, ra;
  locate_all(p, sh, off, 0, phm, false, ph);
  const int64_t plane = int64_t(p.ny) * p.nz;
  for (int iy = iy0; iy < iy1; ++iy) {
    const float y = __ldg(ys + iy);
    const float rr = sqrtf(xz2 + y * y);
    const float colat = acosf(clamp_nan(y / rr, -1.0f, 1.0f));
    const bool walk = iy > iy0;
    locate_all(p, sh, off, 1, colat, walk, th);
    locate_all(p, sh, off, 2, rr, walk, ra);
    bool oob[NA];
    off_mesh(p, sh, off, rr, oob);
    write_samples(p, ph, th, ra, oob, !(rr >= p.r_min),
                  ix * plane + int64_t(iy) * p.nz + iz);
  }
}

template <int NA>
__global__ void __launch_bounds__(kThreads)
    sample_sph_kernel(const float* __restrict__ r_q,
                      const float* __restrict__ colat_q,
                      const float* __restrict__ phi_q, const SphParams p) {
  extern __shared__ float sh[];
  int off[3][NA];
  stage_axes(p, sh, off);
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x; i < p.n;
       i += stride) {
    const float r = __ldg(r_q + i), colat = __ldg(colat_q + i);
    float phm = fmodf(__ldg(phi_q + i), kTwoPi);
    if (phm < 0.0f) phm += kTwoPi;
    Located<NA> ph, th, ra;
    locate_all(p, sh, off, 0, phm, false, ph);
    locate_all(p, sh, off, 1, colat, false, th);
    locate_all(p, sh, off, 2, r, false, ra);
    bool oob[NA];
    off_mesh(p, sh, off, r, oob);
    write_samples(p, ph, th, ra, oob, false, i);
  }
}

// The shared memory bytes of p's axes, or -1 if p is not a scene the
// kernels take: 1 to kMaxVars variables, 1 to kMaxVars distinct axes of
// each kind with at least 2 nodes, each variable's axis ids in range and
// its array's shape that of its axes, the axes within kMaxSharedBytes.
int scene_bytes(const SphParams* p) {
  if (p == nullptr || p->n_vars < 1 || p->n_vars > kMaxVars) return -1;
  long long floats = 0;
  for (int k = 0; k < 3; ++k) {
    if (p->n_axes[k] < 1 || p->n_axes[k] > kMaxVars) return -1;
    for (int a = 0; a < p->n_axes[k]; ++a) {
      if (p->axis_len[k][a] < 2) return -1;
      floats += p->axis_len[k][a];
    }
    for (int v = 0; v < p->n_vars; ++v) {
      const int a = p->var_axis[v][k];
      if (a < 0 || a >= p->n_axes[k] || p->dims[v][k] != p->axis_len[k][a])
        return -1;
    }
  }
  const long long bytes = 4 * floats;
  return bytes > kMaxSharedBytes ? -1 : static_cast<int>(bytes);
}

// Launch kernel<NA> for the scene's most distinct axes of one kind, NA,
// with `bytes` of dynamic shared memory (above 48 KB only by the
// attribute).
template <template <int> class Launch, typename... Args>
cudaError_t dispatch(const SphParams& p, Args... args) {
  int na = p.n_axes[0];
  if (p.n_axes[1] > na) na = p.n_axes[1];
  if (p.n_axes[2] > na) na = p.n_axes[2];
  switch (na) {
    case 1: return Launch<1>::run(p, args...);
    case 2: return Launch<2>::run(p, args...);
    case 3: return Launch<3>::run(p, args...);
    case 4: return Launch<4>::run(p, args...);
    default: return Launch<kMaxVars>::run(p, args...);
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int NA>
struct LaunchCube {
  static cudaError_t run(const SphParams& p, dim3 grid, int bytes,
                         cudaStream_t stream, const float* xs,
                         const float* ys, const float* zs) {
    const cudaError_t err = allow_shared(resample_cube_kernel<NA>, bytes);
    if (err != cudaSuccess) return err;
    resample_cube_kernel<NA><<<grid, kThreads, bytes, stream>>>(xs, ys, zs,
                                                                 p);
    return cudaGetLastError();
  }
};

template <int NA>
struct LaunchSample {
  static cudaError_t run(const SphParams& p, int sms, int bytes,
                         cudaStream_t stream, const float* r_q,
                         const float* colat_q, const float* phi_q) {
    cudaError_t err = allow_shared(sample_sph_kernel<NA>, bytes);
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sample_sph_kernel<NA>, kThreads, bytes);
    if (err != cudaSuccess) return err;
    // one wave of the blocks the SMs hold at once: the grid-stride loop
    // takes the rest, so that no block waits for a second wave and each
    // stages the axes once for many points
    const long long blocks = (p.n + kThreads - 1) / kThreads;
    const long long cap = static_cast<long long>(per_sm > 0 ? per_sm : 1) *
                          sms;
    const unsigned grid = static_cast<unsigned>(blocks < cap ? blocks : cap);
    sample_sph_kernel<NA><<<grid, kThreads, bytes, stream>>>(r_q, colat_q,
                                                              phi_q, p);
    return cudaGetLastError();
  }
};

}  // namespace

// Resample p->n_vars MAS variables onto the cube of axes xs, ys, zs (nx,
// ny, nz): variable v's array p->data[v] into p->out[v], (nx, ny, nz).
// float32, device pointers; p on the host.
extern "C" int rgrff_resample_cube(const void* xs, const void* ys,
                                   const void* zs, const SphParams* p,
                                   void* stream) {
  const int bytes = scene_bytes(p);
  if (bytes < 0 || p->nx < 0 || p->ny < 0 || p->nz < 0 || p->nx > 65535 ||
      (p->ny + kRun - 1) / kRun > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p->nx == 0 || p->ny == 0 || p->nz == 0) return 0;
  const dim3 grid((p->nz + kThreads - 1) / kThreads,
                  (p->ny + kRun - 1) / kRun, p->nx);
  return static_cast<int>(dispatch<LaunchCube>(
      *p, grid, bytes, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(xs), static_cast<const float*>(ys),
      static_cast<const float*>(zs)));
}

// Sample p->n_vars MAS variables at p->n points: r_q (R_sun), colat_q and
// phi_q (rad); variable v's samples into p->out[v]. float32, device
// pointers; p on the host.
extern "C" int rgrff_sample_sph(const void* r_q, const void* colat_q,
                                const void* phi_q, const SphParams* p,
                                void* stream) {
  const int bytes = scene_bytes(p);
  if (bytes < 0 || p->n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (p->n == 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dispatch<LaunchSample>(
      *p, sms, bytes, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(r_q), static_cast<const float*>(colat_q),
      static_cast<const float*>(phi_q)));
}
