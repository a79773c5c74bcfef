// The two remaining scans along lines of sight, for Hopper (sm_90a), bound
// through plain C entries.
//
//   rgrff_valid_ds: the validity and ds of records (n_rec, n_rays) from
//       their positions (n_rec, n_rays, 3), cross-sections s (n_rec,
//       n_rays) and the ray starts (n_rays, 3): a record is valid where
//       its position and s are finite and s > 0 (and, with a `usable` mask,
//       where that holds), and its ds is the distance from the ray's last
//       valid position (the start before the first) times R_sun in cm, 0 at
//       an invalid record. It replaces the JAX package's ds scans,
//       raytracinggrff_tpu/sampler.py::sample_model_with_rays (ds_body
//       :78-85) and los_from_records (:144-152), each a lax.scan inside a
//       jitted program; its plain version is ops/los_scans.py::
//       valid_ds_plain, one record_step a record.
//   rgrff_dem_scan: GET_MW's DEM-mode recurrence along one line of sight,
//       over the opacities, sources and evanescent flags (2 modes, Nz, Nf)
//       that grff/transfer.py::_grff_transfer_dem builds as whole tensors:
//           f <- f exp(-tau) + [valid] src (-expm1(-tau));
//           an evanescent voxel sets f = 0 and sum(tau) = inf.
//       It replaces the voxel scan of raytracinggrff_tpu/grff/transfer.py::
//       _grff_transfer_dem_jit (:425-441, lax.scan); its plain version is
//       ops/los_scans.py::dem_scan_plain, 6 torch ops a voxel and mode.
// Neither is a TPU kernel: in JAX both scans run inside one device
// program; the plain torch versions launch about 12 kernels a record and 6
// a voxel and mode.
//
// The arithmetic is the plain version's, op by op and in order, under the
// shipped -fmad=false build; expf and expm1f round as torch's exp and
// expm1 do (csrc/transfer_fold.cu). The order of the ds sum is that of
// torch's CUDA sum over the contiguous last axis of the (n_rays, 3)
// squared steps: two threads share a row of three, one adding elements 0
// and 2 and the other holding element 1, so ds = sqrtf((dx dx + dz dz) +
// dy dy) * scale. (csrc/transfer_fold.cu adds (dx dx + dy dy) + dz dz, as
// torch does over the strided rows of its plain fold.)
//
// What bounds them. rgrff_valid_ds: bytes; a record reads 16 bytes (17
// with `usable`) and writes 5, and takes some 10 operations. One thread a
// ray walks the records with the last valid position in registers; the
// loads of a record do not depend on the previous record's result, so the
// loop is unrolled to keep several records' loads in flight, and a warp's
// 32 rays read 384 contiguous bytes of positions. rgrff_dem_scan: latency;
// a line of sight has 2 Nf independent recurrences (one thread each, a
// few hundred at most) of Nz dependent steps, each an exp, an expm1 and
// four other operations, far too few threads to fill the card. It exists
// so that the recurrence runs as one launch instead of 12 Nz; the step's
// loads are unrolled ahead as above.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

// Mirrors of ops/_build.py::_ScanParams and _DemParams, outside the
// unnamed namespace (the C entries take them).
struct ScanParams {
  long long n_rays;
  int n_rec;
  float scale;  // float32(R_sun in cm)
};

struct DemParams {
  int nz;
  int nf;
};

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    valid_ds_kernel(const float* __restrict__ pos,
                    const float* __restrict__ s,
                    const float* __restrict__ start,
                    const bool* __restrict__ usable,
                    bool* __restrict__ valid, float* __restrict__ ds,
                    ScanParams p) {
  const int64_t ray = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (ray >= p.n_rays) return;
  float px = start[3 * ray], py = start[3 * ray + 1],
        pz = start[3 * ray + 2];
#pragma unroll 4
  for (int k = 0; k < p.n_rec; ++k) {
    const int64_t i = int64_t(k) * p.n_rays + ray;
    const float x = __ldg(pos + 3 * i), y = __ldg(pos + 3 * i + 1),
                z = __ldg(pos + 3 * i + 2), sk = __ldg(s + i);
    bool ok = isfinite(x) && isfinite(y) && isfinite(z) && isfinite(sk) &&
              sk > 0.0f;
    if (usable != nullptr) ok = ok && usable[i];
    float d = 0.0f;
    if (ok) {
      const float dx = x - px, dy = y - py, dz = z - pz;
      d = sqrtf((dx * dx + dz * dz) + dy * dy) * p.scale;
      px = x;
      py = y;
      pz = z;
    }
    valid[i] = ok;
    ds[i] = d;
  }
}

// One thread a (mode, frequency): t = mode * nf + f.
__global__ void __launch_bounds__(kThreads)
    dem_scan_kernel(const float* __restrict__ tau,
                    const float* __restrict__ src,
                    const bool* __restrict__ evan,
                    const bool* __restrict__ m, float* __restrict__ out,
                    DemParams p) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= 2 * p.nf) return;
  const int mode = t / p.nf, f = t - mode * p.nf;
  const int64_t base = int64_t(mode) * p.nz * p.nf + f;
  float fl = 0.0f, t_sum = 0.0f;
#pragma unroll 4
  for (int k = 0; k < p.nz; ++k) {
    const int64_t i = base + int64_t(k) * p.nf;
    const float tk = __ldg(tau + i);
    const float att = expf(-tk);
    const float emit = -expm1f(-tk);
    fl = fl * att + (m[k] ? __ldg(src + i) * emit : 0.0f);
    if (evan[i]) {
      fl = 0.0f;
      t_sum = INFINITY;
    } else {
      t_sum = t_sum + tk;
    }
  }
  out[(2 * mode) * p.nf + f] = fl;
  out[(2 * mode + 1) * p.nf + f] = t_sum;
}

}  // namespace

// Validity and ds of records. pos: (n_rec, n_rays, 3), s: (n_rec, n_rays),
// start: (n_rays, 3) float32; usable: (n_rec, n_rays) one byte a record, or
// null; valid: (n_rec, n_rays) one byte; ds: (n_rec, n_rays) float32.
// Device pointers; p on the host.
extern "C" int rgrff_valid_ds(const void* pos, const void* s,
                              const void* start, const void* usable,
                              void* valid, void* ds, const ScanParams* p,
                              void* stream) {
  if (p == nullptr || p->n_rays < 0 || p->n_rec < 0 ||
      (p->n_rays + kThreads - 1) / kThreads >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p->n_rays == 0 || p->n_rec == 0) return 0;
  const unsigned grid =
      static_cast<unsigned>((p->n_rays + kThreads - 1) / kThreads);
  valid_ds_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(s),
      static_cast<const float*>(start), static_cast<const bool*>(usable),
      static_cast<bool*>(valid), static_cast<float*>(ds), *p);
  return static_cast<int>(cudaGetLastError());
}

// DEM-mode recurrence. tau, src: (2, nz, nf) float32; evan: (2, nz, nf) and
// m: (nz,) one byte each; out: (2, 2, nf) float32, [mode][f or sum(tau)].
// Device pointers; p on the host.
extern "C" int rgrff_dem_scan(const void* tau, const void* src,
                              const void* evan, const void* m, void* out,
                              const DemParams* p, void* stream) {
  if (p == nullptr || p->nz < 0 || p->nf < 0 || p->nf > (1 << 29))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p->nf == 0) return 0;
  const unsigned grid = (2 * p->nf + kThreads - 1) / kThreads;
  dem_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tau), static_cast<const float*>(src),
      static_cast<const bool*>(evan), static_cast<const bool*>(m),
      static_cast<float*>(out), *p);
  return static_cast<int>(cudaGetLastError());
}
