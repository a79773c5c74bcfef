// Trace-segment kernel for Hopper (sm_90a), bound through a plain C entry,
// and at the end of the file the kernel that builds its input cubes.
//
// Replaces the Pallas TPU kernel raytracinggrff_tpu/ops/pallas_trace.py::
// _make_kernel (pallas_call at ops/pallas_trace.py:654, launched by
// run_trace_segment). One segment advances every ray n_first +
// (rps-1)*stride RK4 steps of
//     dr/dt = C_R k/omega,  dk/dt = -(omega_pe/omega) C_R grad(omega_pe),
//     omega^2 = omega_pe^2 + |k|^2,
// with cross-section tracking (two rays launched eps = pr*|dr| off the
// pre-step position along e1, e2 advance one step; cumS *= |(d1 x d2).t| /
// eps^2), and writes rps records [x, y, z, S, ne, te, b, cos_theta]. S is
// cumS, or with p.per_step the ratio of the record's last step (the JAX
// tracer's s_mode='per_step', raytracinggrff_tpu/tracer.py:235-266); the
// state carries cumS in both modes, so a continued segment does not depend
// on the mode. The arithmetic follows the JAX XLA tracer in its serial order
// (raytracinggrff_tpu/tracer.py:93-170), not the TPU kernel's pipelined
// perturbed pair, and its per-evaluation validity: an evaluation outside
// the cube zeroes dr and leaves dk NaN, which freezes the ray for good.
//
// Every step makes 12 trilinear evaluations of the trace cube (3 RK4s x
// 4 stages), 1,702 float32 operations; read straight from the cube, each
// evaluation is also 8 dependent float4 gathers, a warp's 32 rays on
// cells 262 KB apart along x (at 128^3). Those gathers cost about a
// quarter of the uncached design's time. What the design does about them:
// a step moves a ray by at most ~0.06 of a cell and its perturbed pair
// sits within ~0.11 of a cell, so a ray makes some 200 evaluations in one
// cell. Each ray keeps the 8 float4 corners of the trace-cube cell it last
// loaded, and that cell's flat index, in registers (its cache; 96
// registers in all at 32-bit offsets). Every evaluation, central or
// perturbed, whose cell matches reads no memory; on a miss only the lanes
// that miss load the cell into the cache, and every lane then runs one
// lerp sequence on its cached corners (a cache kept for the central ray
// alone forces a second lerp sequence or 32 selects on the lanes that
// miss, and measured slower). The cached corners are the bytes a load
// would return and the lerps run in the same order, so the records do not
// depend on the cache. `locate` floors without the conversion pipe.
// What bounds it on the card then: the arithmetic, not the gathers. The
// canonical segment runs as fast as on a uniform cube whose every gather
// hits one line (PERF.md); whether instruction issue or dependency latency
// limits the arithmetic is not measured.
// The rest: one thread per ray keeps r, k and cumS in
// registers for the whole segment; the cubes are channels-last so one
// 16-byte __ldg brings four channels of a corner; records go to
// records[b][row][ray] so a warp writes 128 contiguous bytes per row.
// Weights are computed in f32 by hand: texture filtering keeps 8-bit
// weights, too coarse for parity with the f32 reference. Cube offsets are
// 32-bit float4 indices unless the wrapper asks for 64-bit ones
// (wide_index, for cubes of 2^31 float4 or more).
//
// A frozen ray steps no more. Once k has a non-finite component, rhs
// gives dr = 0 at every position, so a step returns its input (a -0
// coordinate turns +0 once); a ray that leaves the cube gets a NaN k
// within the step. A lane whose step returns (r, k) bit for bit, NaN
// payloads included, with a cross-section ratio rho of +0 or NaN (or no
// ratio, cross-sections off) is frozen for the rest of the launch: the
// step is a pure function of (r, k) (the cache changes no result), so
// every later step returns (r, k) and rho again. Its remaining steps are
// skipped, and that changes no bit: for rho in {+0, NaN} and any acc,
// acc*rho*rho == acc*rho, so the block that froze keeps its acc, and a
// later block's acc and last are 1*rho == rho. A frozen lane so only
// multiplies cum and writes its records. Lanes leave the step loop one by
// one, and a warp stops issuing steps when its last lane has frozen, so a
// leaving ray costs at most two steps past its exit. A lane that never
// freezes pays one comparison of six words a step, about 1% of the
// canonical segment's time. What bounds the kernel then: the arithmetic
// of live rays, and warps held by their last live lane (a warp's lanes
// are 32 neighbouring pixels, which leave at close steps).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

struct TraceParams {  // mirrored by ops/_build.py::_TraceParams
  float dt, c_r, perturb_ratio;
  float x0, y0, z0, inv_dx, inv_dy, inv_dz;
  float fill_ne, fill_te, fill_b;
  int nx, ny, nz, n_rays, n_first, stride, rps, crosssections,
      sample_channels, wide_index, per_step;
};

namespace {

constexpr int kThreads = 128;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 axpy(float a, V3 u, V3 v) {  // v + a*u
  return {v.x + a * u.x, v.y + a * u.y, v.z + a * u.z};
}

__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}

__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

// Corner of the trilinear cell around a position (ops/trilinear.py).
template <typename Idx>
struct Cell {
  Idx base;  // flat voxel index of corner (i0, j0, k0)
  float tx, ty, tz;
};

// min(floor(f), top) as an int and as a float, for 0 <= f < 2^23, with
// no conversion instruction (those issue at 1/8 of the FP32 rate): 2^23
// added with rounding down holds floor(f) in its low mantissa bits.
__device__ __forceinline__ int floor_index(float f, int top, float ftop,
                                           float& fl) {
  const float t = __fadd_rd(f, 8388608.f);
  fl = fminf(t - 8388608.f, ftop);
  return min(__float_as_int(t) - 0x4B000000, top);
}

// False outside the cube; NaN positions fail every comparison.
template <typename Idx>
__device__ __forceinline__ bool locate(const TraceParams& p, V3 r,
                                       Cell<Idx>& c) {
  const float fx = (r.x - p.x0) * p.inv_dx;
  const float fy = (r.y - p.y0) * p.inv_dy;
  const float fz = (r.z - p.z0) * p.inv_dz;
  if (!(fx >= 0.f && fy >= 0.f && fz >= 0.f && fx <= float(p.nx - 1) &&
        fy <= float(p.ny - 1) && fz <= float(p.nz - 1)))
    return false;
  // the cube has fewer than 2^23 nodes per axis, so the floors are exact
  float gx, gy, gz;
  const int i0 = floor_index(fx, p.nx - 2, float(p.nx - 2), gx);
  const int j0 = floor_index(fy, p.ny - 2, float(p.ny - 2), gy);
  const int k0 = floor_index(fz, p.nz - 2, float(p.nz - 2), gz);
  c.tx = fminf(fmaxf(fx - gx, 0.f), 1.f);
  c.ty = fminf(fmaxf(fy - gy, 0.f), 1.f);
  c.tz = fminf(fmaxf(fz - gz, 0.f), 1.f);
  c.base = (Idx(i0) * p.ny + j0) * p.nz + k0;
  return true;
}

// The 8 corners of float4 group g of cell `base` in a cube with `groups`
// float4 per voxel, in the order c000, c100, c010, c110, c001, c101, c011,
// c111.
template <typename Idx>
__device__ __forceinline__ void load_corners(const float4* __restrict__ cube,
                                             int groups, int g,
                                             const TraceParams& p, Idx base,
                                             float4 (&v)[8]) {
  const Idx sx = Idx(p.ny) * p.nz * groups;
  const Idx sy = Idx(p.nz) * groups;
  const Idx sz = groups;
  const Idx o = base * groups + g;
  v[0] = __ldg(cube + o);
  v[1] = __ldg(cube + (o + sx));
  v[2] = __ldg(cube + (o + sy));
  v[3] = __ldg(cube + (o + sx + sy));
  v[4] = __ldg(cube + (o + sz));
  v[5] = __ldg(cube + (o + sx + sz));
  v[6] = __ldg(cube + (o + sy + sz));
  v[7] = __ldg(cube + (o + sx + sy + sz));
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float t) {
  const float u = 1.f - t;
  return make_float4(a.x * u + b.x * t, a.y * u + b.y * t, a.z * u + b.z * t,
                     a.w * u + b.w * t);
}

// Trilinear value from a cell's corners, in the lerp order of
// ops/trilinear.py::trilinear_packed.
template <typename Idx>
__device__ __forceinline__ float4 lerp_corners(const float4 (&v)[8],
                                               const Cell<Idx>& c) {
  const float4 c00 = lerp4(v[0], v[1], c.tx);
  const float4 c10 = lerp4(v[2], v[3], c.tx);
  const float4 c01 = lerp4(v[4], v[5], c.tx);
  const float4 c11 = lerp4(v[6], v[7], c.tx);
  const float4 c0 = lerp4(c00, c10, c.ty);
  const float4 c1 = lerp4(c01, c11, c.ty);
  return lerp4(c0, c1, c.tz);
}

template <typename Idx>
__device__ __forceinline__ float4 trilerp(const float4* __restrict__ cube,
                                          int groups, int g,
                                          const TraceParams& p,
                                          const Cell<Idx>& c) {
  float4 v[8];
  load_corners(cube, groups, g, p, c.base, v);
  return lerp_corners(v, c);
}

// A ray's cache: the flat index and the 8 corners of the trace-cube cell
// it last loaded, in registers.
template <typename Idx>
struct RayCache {
  Idx key;
  float4 v[8];

  __device__ __forceinline__ void init() { key = Idx(-1); }

  // Trilinear trace-cube value at cell c. A miss, central or perturbed,
  // loads c's cell into the cache in the lanes that miss; every lane then
  // runs one lerp sequence on its cached corners, so a warp whose lanes
  // split between hit and miss does not run it twice.
  __device__ __forceinline__ float4 value(const float4* __restrict__ tcube,
                                          const TraceParams& p,
                                          const Cell<Idx>& c) {
    if (c.base != key) {
      key = c.base;
      load_corners(tcube, 1, 0, p, c.base, v);
    }
    return lerp_corners(v, c);
  }
};

// [omega_pe, grad] at r: NaN outside the cube.
template <typename Idx>
__device__ __forceinline__ float4 field(const float4* __restrict__ tcube,
                                        const TraceParams& p,
                                        RayCache<Idx>& cache, V3 r) {
  Cell<Idx> c;
  return locate(p, r, c) ? cache.value(tcube, p, c)
                         : make_float4(NAN, NAN, NAN, NAN);
}

// ODE right-hand side at (r, k) (tracer.py::_rhs).
template <typename Idx>
__device__ __forceinline__ void rhs(const float4* __restrict__ tcube,
                                    const TraceParams& p,
                                    RayCache<Idx>& cache, V3 r, V3 k,
                                    V3& dr, V3& dk) {
  const float4 v = field(tcube, p, cache, r);
  const float wpe = v.x;
  const float om2 = wpe * wpe + dot(k, k);
  // NaN om2 becomes 0 here where the reference keeps NaN: both are invalid
  const float om = sqrtf(om2 > 0.f ? om2 : 0.f);
  const bool valid = isfinite(wpe) && isfinite(om) && om > 0.f &&
                     isfinite(v.y) && isfinite(v.z) && isfinite(v.w);
  const float inv_om = valid ? 1.f / om : 0.f;
  const float a = p.c_r * inv_om;
  dr = valid ? V3{a * k.x, a * k.y, a * k.z} : V3{0.f, 0.f, 0.f};
  const float b = -wpe * inv_om * p.c_r;  // NaN outside the cube
  dk = valid ? V3{b * v.y, b * v.z, b * v.w} : V3{b * 0.f, b * 0.f, b * 0.f};
}

__device__ __forceinline__ V3 rk4_sum(float c, V3 x, V3 d1, V3 d2, V3 d3,
                                      V3 d4) {
  return {x.x + c * (d1.x + 2.f * d2.x + 2.f * d3.x + d4.x),
          x.y + c * (d1.y + 2.f * d2.y + 2.f * d3.y + d4.y),
          x.z + c * (d1.z + 2.f * d2.z + 2.f * d3.z + d4.z)};
}

template <typename Idx>
__device__ __forceinline__ void rk4(const float4* __restrict__ tcube,
                                    const TraceParams& p,
                                    RayCache<Idx>& cache, V3 r, V3 k,
                                    V3& r_new, V3& k_new) {
  const float h = 0.5f * p.dt;
  V3 k1r, k1k, k2r, k2k, k3r, k3k, k4r, k4k;
  rhs(tcube, p, cache, r, k, k1r, k1k);
  rhs(tcube, p, cache, axpy(h, k1r, r), axpy(h, k1k, k), k2r, k2k);
  rhs(tcube, p, cache, axpy(h, k2r, r), axpy(h, k2k, k), k3r, k3k);
  rhs(tcube, p, cache, axpy(p.dt, k3r, r), axpy(p.dt, k3k, k), k4r, k4k);
  const float c = p.dt / 6.f;
  r_new = rk4_sum(c, r, k1r, k2r, k3r, k4r);
  k_new = rk4_sum(c, k, k1k, k2k, k3k, k4k);
}

__device__ __forceinline__ V3 normalized(V3 e) {
  const float n = sqrtf(dot(e, e)) + 1e-30f;
  return {e.x / n, e.y / n, e.z / n};
}

// The bits in which a and b differ, ORed over x, y and z: 0 when they hold
// the same bits, signed zeros and NaN payloads told apart. (Six integer
// compares chained by AND cost the canonical segment 3%, this 1%.)
__device__ __forceinline__ unsigned diff_bits(V3 a, V3 b) {
  return (__float_as_uint(a.x) ^ __float_as_uint(b.x)) |
         (__float_as_uint(a.y) ^ __float_as_uint(b.y)) |
         (__float_as_uint(a.z) ^ __float_as_uint(b.z));
}

// One RK4 step plus its cross-section ratio
// (tracer.py::_step_with_crosssection and _transverse_basis); `same`
// tells whether the step returned (r, k) bit for bit.
template <typename Idx>
__device__ __forceinline__ float step_with_crosssection(
    const float4* __restrict__ tcube, const TraceParams& p,
    RayCache<Idx>& cache, V3& r, V3& k, bool& same) {
  V3 rn, kn;
  rk4(tcube, p, cache, r, k, rn, kn);
  same = (diff_bits(rn, r) | diff_bits(kn, k)) == 0u;
  const V3 rd = sub(rn, r);
  const float dnorm = sqrtf(dot(rd, rd)) + 1e-32f;
  const V3 t = {rd.x / dnorm, rd.y / dnorm, rd.z / dnorm};
  const bool use_z = fabsf(t.z) < 0.9f;
  const V3 a = {0.f, use_z ? 0.f : 1.f, use_z ? 1.f : 0.f};
  const V3 e1 = normalized(cross(a, t));
  const V3 e2 = normalized(cross(t, e1));
  const float eps = p.perturb_ratio * dnorm;
  V3 r1, r2, unused;
  rk4(tcube, p, cache, axpy(eps, e1, r), k, r1, unused);
  rk4(tcube, p, cache, axpy(eps, e2, r), k, r2, unused);
  const V3 cr = cross(sub(r1, rn), sub(r2, rn));
  const float num = fabsf(dot(cr, t));
  r = rn;
  k = kn;
  return num / (eps * eps + 1e-30f);
}

__device__ __forceinline__ float finite_or(float v, float fill) {
  return isfinite(v) ? v : fill;
}

// Record fields at r (sampler.py::sample_model_with_rays and
// cos_theta_signed): fills outside the cube, NaN kept where the reference
// keeps it (clamp and max pass NaN through).
template <int NG, typename Idx>
__device__ __forceinline__ void record(const float4* __restrict__ scube,
                                       const TraceParams& p, V3 r, V3 k,
                                       float s, float* __restrict__ out,
                                       int64_t n) {
  Cell<Idx> c;
  const bool in = locate(p, r, c);
  const float4 nan4 = make_float4(NAN, NAN, NAN, NAN);
  const float4 s0 = in ? trilerp(scube, NG, 0, p, c) : nan4;
  float cos_t = 0.f;
  if (NG == 2) {
    const float4 s1 = in ? trilerp(scube, NG, 1, p, c) : nan4;
    const V3 bv = {finite_or(s0.w, 0.f), finite_or(s1.x, 0.f),
                   finite_or(s1.y, 0.f)};
    const float den = sqrtf(dot(bv, bv)) * sqrtf(dot(k, k));
    cos_t = dot(bv, k) / (den < 1e-30f ? 1e-30f : den);
    cos_t = cos_t < -1.f ? -1.f : (cos_t > 1.f ? 1.f : cos_t);
  }
  out[0 * n] = r.x;
  out[1 * n] = r.y;
  out[2 * n] = r.z;
  out[3 * n] = s;
  out[4 * n] = finite_or(s0.x, p.fill_ne);
  out[5 * n] = finite_or(s0.y, p.fill_te);
  out[6 * n] = finite_or(s0.z, p.fill_b);
  out[7 * n] = cos_t;
}

// CS: cross-sections on; PS: records hold the per-step S (only with CS).
template <bool CS, bool PS, int NG, typename Idx>
__global__ void __launch_bounds__(kThreads)
    trace_segment_kernel(const float4* __restrict__ tcube,
                         const float4* __restrict__ scube,
                         const float* __restrict__ state_in,
                         float* __restrict__ state_out,
                         float* __restrict__ records, TraceParams p) {
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  if (ray >= p.n_rays) return;
  const int64_t n = p.n_rays;
  V3 r = {state_in[0 * n + ray], state_in[1 * n + ray],
          state_in[2 * n + ray]};
  V3 k = {state_in[3 * n + ray], state_in[4 * n + ray],
          state_in[5 * n + ray]};
  float cum = state_in[6 * n + ray];
  RayCache<Idx> cache;
  cache.init();
  bool frozen = false;  // the last step returned (r, k) and a ratio rho
  float rho = 0.f;      // of +0 or NaN: so will every step left
  for (int b = 0; b < p.rps; ++b) {
    const int steps = b == 0 ? p.n_first : p.stride;
    float acc = 1.f;   // this block's S product, as in tracer.py::do_steps
    float last = 1.f;  // the ratio of the block's last step
    for (int s = 0; s < steps; ++s) {
      if (frozen) {  // the block's steps left, as one: acc*rho*rho == acc*rho
        if (CS) acc *= rho;
        if (PS) last = rho;
        break;
      }
      if (CS) {
        rho = step_with_crosssection(tcube, p, cache, r, k, frozen);
        acc *= rho;
        if (PS) last = rho;
        frozen = frozen && (__float_as_uint(rho) == 0u || isnan(rho));
      } else {
        V3 rn, kn;
        rk4(tcube, p, cache, r, k, rn, kn);
        frozen = (diff_bits(rn, r) | diff_bits(kn, k)) == 0u;
        r = rn;
        k = kn;
      }
    }
    if (CS) cum *= acc;
    record<NG, Idx>(scube, p, r, k, PS ? last : cum,
                    records + int64_t(b) * 8 * n + ray, n);
  }
  state_out[0 * n + ray] = r.x;
  state_out[1 * n + ray] = r.y;
  state_out[2 * n + ray] = r.z;
  state_out[3 * n + ray] = k.x;
  state_out[4 * n + ray] = k.y;
  state_out[5 * n + ray] = k.z;
  state_out[6 * n + ray] = cum;
}

template <bool CS, bool PS, typename Idx>
void launch(const float4* t, const float4* s, const float* in, float* out,
            float* rec, const TraceParams& p, cudaStream_t stream) {
  const dim3 grid((p.n_rays + kThreads - 1) / kThreads);
  if (p.sample_channels == 8)
    trace_segment_kernel<CS, PS, 2, Idx>
        <<<grid, kThreads, 0, stream>>>(t, s, in, out, rec, p);
  else
    trace_segment_kernel<CS, PS, 1, Idx>
        <<<grid, kThreads, 0, stream>>>(t, s, in, out, rec, p);
}

template <typename Idx>
void launch_cs(const float4* t, const float4* s, const float* in, float* out,
               float* rec, const TraceParams& p, cudaStream_t stream) {
  if (p.crosssections && p.per_step)
    launch<true, true, Idx>(t, s, in, out, rec, p, stream);
  else if (p.crosssections)
    launch<true, false, Idx>(t, s, in, out, rec, p, stream);
  else
    launch<false, false, Idx>(t, s, in, out, rec, p, stream);
}

}  // namespace

// Launch one segment on `stream`; returns cudaGetLastError() (0 = launched).
// Cubes: (nx, ny, nz, 4) trace and (nx, ny, nz, sample_channels) sample,
// float32, contiguous. state_in/out: (7, n_rays); records: (rps, 8, n_rays).
// p.wide_index selects 64-bit cube offsets, which a sample cube of 2^31
// float4 or more needs. p.per_step (with p.crosssections) writes each
// record's last step ratio into row 3 instead of cumS.
extern "C" int rgrff_trace_segment(const void* tcube, const void* scube,
                                   const void* state_in, void* state_out,
                                   void* records, TraceParams p,
                                   void* stream) {
  if (p.n_rays <= 0) return 0;
  const int groups = p.sample_channels / 4;
  if (!p.wide_index &&
      int64_t(p.nx) * p.ny * p.nz * groups >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const float4*>(tcube);
  const auto* s = static_cast<const float4*>(scube);
  const auto* in = static_cast<const float*>(state_in);
  auto* out = static_cast<float*>(state_out);
  auto* rec = static_cast<float*>(records);
  auto st = static_cast<cudaStream_t>(stream);
  if (p.wide_index)
    launch_cs<int64_t>(t, s, in, out, rec, p, st);
  else
    launch_cs<int>(t, s, in, out, rec, p, st);
  return static_cast<int>(cudaGetLastError());
}

// The trace inputs: the two channels-last cubes the trace kernel reads,
// built in one pass.
//
// Replaces no TPU kernel (the JAX package leaves this to XLA). Plain torch
// (ops/trace_segment.pack_trace_inputs_plain) makes two rolled copies of
// omega_pe an axis, a difference, a product and a cat for each gradient,
// then stacks the channels 4 bytes at a 16- or 32-byte stride: some 200
// bytes of device traffic a voxel.
// What bounds this kernel: the bytes, each input read once and each output
// written once, 48 a voxel with 4 sample channels (16 read, 32 written) and
// 76 with 8 (28 read, 48 written), at the card's memory rate.
// What its design does about that: a block of kPackZ x kPackY threads takes
// a (y, z) tile, z fastest, so that a warp reads 128 contiguous bytes of
// each input and writes each voxel's channels as one 16-byte store (two for
// the 8-channel sample cube), and marches kPackRun planes along x. A thread
// keeps omega_pe at x - 1, x and x + 1 of its column in registers, so it
// loads each plane of its column once; its y and z neighbours are the
// values the neighbouring threads of the block load in the same plane, and
// come from L1. At 128^3 the grid has 1,024 blocks of 256 threads, near
// eight an SM on 132 SMs; at 576^3, 93,312.
// The arithmetic is torch's on the card, bit for bit: a difference times
// the float32 reciprocal of the step, 1/(2h) inside and 1/h at the
// one-sided edges, since torch's CUDA division by a Python float multiplies
// by the divisor's reciprocal, taken in float64 and rounded to float32
// (div_true_kernel_cuda); the wrapper computes the reciprocals that way.
// Non-finite inputs go through the same operations, and the zero channels
// are written as +0.

struct PackParams {  // mirrored by ops/_build.py::_PackParams
  float inv_2dx, inv_2dy, inv_2dz, inv_dx, inv_dy, inv_dz;
  int nx, ny, nz, sample_channels;
};

namespace {

constexpr int kPackZ = 32;    // threads a block along z, the contiguous axis
constexpr int kPackY = 8;     // threads a block along y
constexpr int kPackRun = 8;   // x planes a block marches through

// The derivative at index i of an axis of n >= 2 nodes from the values at
// i - 1, i and i + 1 (those off the axis unused): one-sided at the edges,
// central inside, as tracer.gradient_cubes.
__device__ __forceinline__ float axis_slope(float lo, float mid, float hi,
                                            int i, int n, float inv_h,
                                            float inv_2h) {
  if (i == 0) return (hi - mid) * inv_h;
  if (i == n - 1) return (mid - lo) * inv_h;
  return (hi - lo) * inv_2h;
}

// G float4 groups of sample channels: 1 ([ne, te, b, 0]) or 2 ([ne, te, b,
// Bx], [By, Bz, 0, 0]).
template <int G>
__global__ void __launch_bounds__(kPackZ * kPackY) pack_trace_inputs_kernel(
    const float* __restrict__ wpe, const float* __restrict__ ne,
    const float* __restrict__ te, const float* __restrict__ b,
    const float* __restrict__ bx, const float* __restrict__ by,
    const float* __restrict__ bz, float4* __restrict__ tcube,
    float4* __restrict__ scube, const PackParams p) {
  const int k = blockIdx.x * kPackZ + threadIdx.x;
  const int j = blockIdx.y * kPackY + threadIdx.y;
  if (k >= p.nz || j >= p.ny) return;
  const int64_t plane = int64_t(p.ny) * p.nz;
  const int i0 = blockIdx.z * kPackRun;
  const int i1 = min(i0 + kPackRun, p.nx);
  int64_t v = i0 * plane + int64_t(j) * p.nz + k;
  float lo = i0 > 0 ? __ldg(wpe + (v - plane)) : 0.f;
  float mid = __ldg(wpe + v);
  for (int i = i0; i < i1; ++i, v += plane) {
    const float hi = i + 1 < p.nx ? __ldg(wpe + (v + plane)) : 0.f;
    const float ym = j > 0 ? __ldg(wpe + (v - p.nz)) : 0.f;
    const float yp = j + 1 < p.ny ? __ldg(wpe + (v + p.nz)) : 0.f;
    const float zm = k > 0 ? __ldg(wpe + (v - 1)) : 0.f;
    const float zp = k + 1 < p.nz ? __ldg(wpe + (v + 1)) : 0.f;
    tcube[v] = make_float4(
        mid, axis_slope(lo, mid, hi, i, p.nx, p.inv_dx, p.inv_2dx),
        axis_slope(ym, mid, yp, j, p.ny, p.inv_dy, p.inv_2dy),
        axis_slope(zm, mid, zp, k, p.nz, p.inv_dz, p.inv_2dz));
    const float n_e = __ldg(ne + v), t_e = __ldg(te + v), b_m = __ldg(b + v);
    if (G == 1) {
      scube[v] = make_float4(n_e, t_e, b_m, 0.f);
    } else {
      scube[2 * v] = make_float4(n_e, t_e, b_m, __ldg(bx + v));
      scube[2 * v + 1] = make_float4(__ldg(by + v), __ldg(bz + v), 0.f, 0.f);
    }
    lo = mid;
    mid = hi;
  }
}

}  // namespace

// Build the trace cube (nx, ny, nz, 4) = [omega_pe, d/dx, d/dy, d/dz] and
// the sample cube (nx, ny, nz, sample_channels) = [ne, te, b, 0] or [ne, te,
// b, Bx, By, Bz, 0, 0] in one launch on `stream`; returns
// cudaGetLastError() (0 = launched). Inputs: float32 (nx, ny, nz) cubes,
// contiguous; bx, by, bz are read only with 8 sample channels. Every axis
// needs 2 nodes or more.
extern "C" int rgrff_pack_trace_inputs(const void* wpe, const void* ne,
                                       const void* te, const void* b,
                                       const void* bx, const void* by,
                                       const void* bz, void* tcube,
                                       void* scube, PackParams p,
                                       void* stream) {
  const dim3 block(kPackZ, kPackY);
  const dim3 grid((p.nz + kPackZ - 1) / kPackZ, (p.ny + kPackY - 1) / kPackY,
                  (p.nx + kPackRun - 1) / kPackRun);
  if (p.nx < 2 || p.ny < 2 || p.nz < 2 || grid.y > 65535 || grid.z > 65535 ||
      (p.sample_channels != 4 && p.sample_channels != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* w = static_cast<const float*>(wpe);
  const auto* n_e = static_cast<const float*>(ne);
  const auto* t_e = static_cast<const float*>(te);
  const auto* b_m = static_cast<const float*>(b);
  const auto* b_x = static_cast<const float*>(bx);
  const auto* b_y = static_cast<const float*>(by);
  const auto* b_z = static_cast<const float*>(bz);
  auto* t = static_cast<float4*>(tcube);
  auto* s = static_cast<float4*>(scube);
  auto st = static_cast<cudaStream_t>(stream);
  if (p.sample_channels == 8)
    pack_trace_inputs_kernel<2><<<grid, block, 0, st>>>(
        w, n_e, t_e, b_m, b_x, b_y, b_z, t, s, p);
  else
    pack_trace_inputs_kernel<1><<<grid, block, 0, st>>>(
        w, n_e, t_e, b_m, b_x, b_y, b_z, t, s, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rgrff_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
