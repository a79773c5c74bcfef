// Spherical resampling of MAS variables for Hopper (sm_90a), bound through
// plain C entries.
//
// Two entries share one interpolator, the nonuniform trilinear sample of a
// MAS array (nphi + 1, ntheta, nr) on its (phi periodic, theta, r) mesh of
// raytracinggrff_tpu_torch/ops/resample.py::sample_sph_plain (the JAX
// package's raytracinggrff_tpu/mas/model.py::_interp_sph, :148-187): phi
// taken modulo 2 pi, each axis located by a binary search and its fraction
// clamped to [0, 1], eight corners lerped along phi, theta and r, NaN where
// r lies off the mesh or is not finite.
//   rgrff_resample_cube resamples one variable onto a uniform (nx, ny, nz)
//       cube, one thread per voxel: the voxel's (x, y, z) from the three
//       grid axes, coords.cart_to_sph(x, -z, y) with the longitude offset,
//       the sample, NaN where r < R_MIN, then the fill of non-finite values.
//       It replaces the JAX package's _resample_cube_jit
//       (raytracinggrff_tpu/mas/model.py:259-301, jax.jit around a
//       fori_loop over x-slabs), one device program a variable.
//   rgrff_sample_sph samples at query points (r, colat, lon), one thread
//       a point. It replaces _interp_sph_jit (mas/model.py:133-135).
// Neither is a TPU kernel. The plain torch versions (ops/resample.py) make
// about 100 launches a 16-plane slab of the cube, and some 20 slab-sized
// temporaries; here one launch covers a whole cube or query set and keeps
// every intermediate in registers.
//
// The arithmetic repeats the plain version's torch ops one by one and in
// their order, and the shipped -fmad=false build keeps nvcc from fusing
// them:
//   * searchsorted(ax, q, right=True) - 1 is a binary search that counts
//     the nodes <= q with torch's test !(node > q), so a NaN q counts every
//     node, as in torch; the index is then clamped to [0, n - 2], so a NaN
//     query reads inside the array. Its fraction and the lerps stay NaN and
//     the r mask hides them, as in the plain version.
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
// the plain version's (chip_smoke.py phase 18, PERF.md).
//
// What bounds it: by the count, bytes. A cube voxel writes 4 bytes and
// reads nothing but the MAS array and its axes, which stay in L2 (some
// 0.85 MB for the synthetic model's 64 x 55 x 60 mesh); a query point
// reads 12 bytes and writes 4. Counted as chip_smoke.py counts them (a
// square root, a division, acos or atan2 one operation each), a voxel
// takes some 50 float32 operations, under the card's 20 operations a
// byte written. But those routines are many instructions each (acos,
// atan2, the IEEE square root and four IEEE divisions), and each of the
// three binary searches is 6-7 dependent loads, so instruction issue and
// load latency hold the kernel far above the byte bound (PERF.md). The
// design: one thread a voxel on a (z blocks, y, x) grid, so that no
// thread divides its index, z fastest, so that a warp writes 128
// contiguous bytes; the axes and the array are read through the read-only
// cache; 64-bit offsets throughout.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

// Mirror of ops/_build.py::_SphParams. It sits outside the unnamed
// namespace below: the C entries take it, and a parameter of that
// namespace's type would give them internal linkage.
struct SphParams {
  long long n;       // query points (rgrff_sample_sph)
  int nphi;          // phi nodes, the periodic copy included
  int ntheta;
  int nr;
  int nx, ny, nz;    // the cube (rgrff_resample_cube)
  int fill_on;       // replace non-finite values by `fill`
  float lon_offset;  // float32(phi0) * pi / 180 as the plain version rounds it
  float r_min;       // float32(R_MIN)
  float fill;
};

namespace {

constexpr int kThreads = 128;
// float32(2 pi): torch rounds the Python scalar 2 * math.pi so
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// torch.clamp(v, lo, hi): NaN passes
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// Cell index and clamped fraction of q on the ascending axis ax[0..n):
// ops/resample.py::_axis_locate.
__device__ __forceinline__ int locate(const float* __restrict__ ax, int n,
                                      float q, float& t) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(__ldg(ax + mid) > q))
      lo = mid + 1;
    else
      hi = mid;
  }
  const int i = min(max(lo - 1, 0), n - 2);
  const float a0 = __ldg(ax + i), a1 = __ldg(ax + i + 1);
  t = clamp_nan((q - a0) / (a1 - a0), 0.0f, 1.0f);
  return i;
}

// ops/resample.py::sample_sph_plain at one point.
__device__ float interp(const float* __restrict__ data,
                        const float* __restrict__ phi,
                        const float* __restrict__ theta,
                        const float* __restrict__ r, const SphParams& p,
                        float r_q, float colat_q, float phi_q) {
  float ph = fmodf(phi_q, kTwoPi);
  if (ph < 0.0f) ph += kTwoPi;  // torch adds the divisor to a negative one
  float tp, tt, tr;
  const int ip = locate(phi, p.nphi, ph, tp);
  const int it = locate(theta, p.ntheta, colat_q, tt);
  const int ir = locate(r, p.nr, r_q, tr);
  const float r_lo = __ldg(r) - 1e-9f;
  const float r_hi = __ldg(r + p.nr - 1) + 1e-9f;
  const bool oob = r_q < r_lo || r_q > r_hi || !isfinite(r_q);

  const int64_t st = p.nr;
  const int64_t sp = int64_t(p.ntheta) * p.nr;
  const float* c = data + (int64_t(ip) * p.ntheta + it) * p.nr + ir;
  const float c00 = __ldg(c) * (1.0f - tp) + __ldg(c + sp) * tp;
  const float c10 = __ldg(c + st) * (1.0f - tp) + __ldg(c + sp + st) * tp;
  const float c01 = __ldg(c + 1) * (1.0f - tp) + __ldg(c + sp + 1) * tp;
  const float c11 =
      __ldg(c + st + 1) * (1.0f - tp) + __ldg(c + sp + st + 1) * tp;
  const float c0 = c00 * (1.0f - tt) + c10 * tt;
  const float c1 = c01 * (1.0f - tt) + c11 * tt;
  const float v = c0 * (1.0f - tr) + c1 * tr;
  return oob ? nan_f() : v;
}

// One thread a voxel (ix, iy, iz): blockIdx.z = ix, blockIdx.y = iy.
__global__ void __launch_bounds__(kThreads)
    resample_cube_kernel(const float* __restrict__ data,
                         const float* __restrict__ phi,
                         const float* __restrict__ theta,
                         const float* __restrict__ r,
                         const float* __restrict__ xs,
                         const float* __restrict__ ys,
                         const float* __restrict__ zs,
                         float* __restrict__ out, SphParams p) {
  const int iz = blockIdx.x * kThreads + threadIdx.x;
  if (iz >= p.nz) return;
  const int iy = blockIdx.y, ix = blockIdx.z;
  const float x = __ldg(xs + ix), y = __ldg(ys + iy), z = __ldg(zs + iz);
  // coords.image_xyz_to_mas_sph: cart_to_sph(x, -z, y, phi0)
  const float mz = -z;
  const float rr = sqrtf(x * x + mz * mz + y * y);
  const float colat = acosf(clamp_nan(y / rr, -1.0f, 1.0f));
  float lon = atan2f(mz, x);
  lon = lon + p.lon_offset;
  if (lon < 0.0f) lon = lon + kTwoPi;
  float v = interp(data, phi, theta, r, p, rr, colat, lon);
  if (!(rr >= p.r_min)) v = nan_f();
  if (p.fill_on && !isfinite(v)) v = p.fill;
  out[(int64_t(ix) * p.ny + iy) * p.nz + iz] = v;
}

__global__ void __launch_bounds__(kThreads)
    sample_sph_kernel(const float* __restrict__ data,
                      const float* __restrict__ phi,
                      const float* __restrict__ theta,
                      const float* __restrict__ r,
                      const float* __restrict__ r_q,
                      const float* __restrict__ colat_q,
                      const float* __restrict__ phi_q,
                      float* __restrict__ out, SphParams p) {
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x; i < p.n;
       i += stride)
    out[i] = interp(data, phi, theta, r, p, __ldg(r_q + i),
                    __ldg(colat_q + i), __ldg(phi_q + i));
}

bool bad_mesh(const SphParams* p) {
  return p == nullptr || p->nphi < 2 || p->ntheta < 2 || p->nr < 2;
}

}  // namespace

// Resample one MAS variable onto the cube. data: (nphi, ntheta, nr); phi,
// theta, r: its axes; xs, ys, zs: the cube's axes (nx, ny, nz); out: (nx,
// ny, nz). float32, device pointers; p on the host.
extern "C" int rgrff_resample_cube(const void* data, const void* phi,
                                   const void* theta, const void* r,
                                   const void* xs, const void* ys,
                                   const void* zs, void* out,
                                   const SphParams* p, void* stream) {
  if (bad_mesh(p) || p->nx < 0 || p->ny < 0 || p->nz < 0 ||
      p->nx > 65535 || p->ny > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p->nx == 0 || p->ny == 0 || p->nz == 0) return 0;
  const dim3 grid((p->nz + kThreads - 1) / kThreads, p->ny, p->nx);
  resample_cube_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const float*>(phi),
      static_cast<const float*>(theta), static_cast<const float*>(r),
      static_cast<const float*>(xs), static_cast<const float*>(ys),
      static_cast<const float*>(zs), static_cast<float*>(out), *p);
  return static_cast<int>(cudaGetLastError());
}

// Sample one MAS variable at p->n points: r_q (R_sun), colat_q and phi_q
// (rad), out: p->n values. float32, device pointers; p on the host.
extern "C" int rgrff_sample_sph(const void* data, const void* phi,
                                const void* theta, const void* r,
                                const void* r_q, const void* colat_q,
                                const void* phi_q, void* out,
                                const SphParams* p, void* stream) {
  if (bad_mesh(p) || p->n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p->n == 0) return 0;
  const long long blocks = (p->n + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < (1 << 20) ? blocks
                                                                 : (1 << 20));
  sample_sph_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const float*>(phi),
      static_cast<const float*>(theta), static_cast<const float*>(r),
      static_cast<const float*>(r_q), static_cast<const float*>(colat_q),
      static_cast<const float*>(phi_q), static_cast<float*>(out), *p);
  return static_cast<int>(cudaGetLastError());
}
