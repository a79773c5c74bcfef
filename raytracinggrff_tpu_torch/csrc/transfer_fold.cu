// Transfer folds for Hopper (sm_90a), bound through plain C entries.
//
// Two entries share one __device__ voxel update, the two-mode transfer of
// raytracinggrff_tpu_torch/grff/transfer.py::make_voxel_update (the JAX
// package's raytracinggrff_tpu/grff/transfer.py:65-182, with the physics of
// grff/physics.py: Appleton-Hartree n^2, free-free with the Dulk or the
// exact Gaunt factor, the Saha neutral term, thermal gyroresonance over
// harmonics 2..s_max in log space):
//   rgrff_fold_records folds one trace segment's records (rps, 8, n_rays),
//       rows [x, y, z, S, ne, te, b, cos_theta], into the carry, taking
//       each record's validity and ds from consecutive positions
//       (sampler.record_step). It replaces the JAX pipeline's per-segment
//       scan stream_seg (raytracinggrff_tpu/pipeline.py:377-396, jax.jit
//       around lax.scan).
//   rgrff_fold_voxels folds (Nz, n_pix) voxel arrays that already hold ds,
//       the validity and the source areas, with an optional per-voxel theta
//       and mechanism mask. It replaces _grff_transfer_jit
//       (raytracinggrff_tpu/grff/transfer.py:231-275, lax.scan).
// Neither is a TPU kernel: in JAX both scans are XLA programs, one device
// program a call. The plain torch versions (ops/transfer_fold.py) launch
// about 271 small kernels a record, so they run at the host's launch rate.
//
// Design. One thread per (ray, frequency): consecutive rays in a warp, so
// a warp reads 128 contiguous bytes of each record row, and frequencies on
// the grid's y axis. The carry (flux_o, flux_x, tau_o, tau_x) and the ray's
// last valid position stay in registers across every record of a call and
// are written once. A voxel that is not valid leaves the carry as the plain
// update leaves it (it adds 0 and multiplies by exp(-0) = 1), so it costs
// only its loads. The arithmetic repeats the plain version's torch ops one
// by one and in their order, and the shipped -fmad=false build keeps nvcc
// from fusing them; a division by a Python scalar is, as torch's CUDA div
// computes it, a product with the float reciprocal of the scalar. Terms
// that do not depend on the mode (the logs of T and nu, the Saha density,
// the gyroresonance harmonic sum) are computed once a voxel instead of once
// a mode: the same values. The harmonic sum runs s = 2..s_max in order,
// where torch's reduction may add in another order, so with gyroresonance
// the two agree to rounding, not bit for bit. The physics constants come
// from constants.py and grff/physics.py through FoldParams (one source);
// the literals here are those of the formulas in grff/physics.py.
// What bounds it on the card: at mechanism 5 a valid record takes some 37
// float32 operations that do not depend on the frequency and 64 for each
// frequency, against 28 bytes of record (32 with theta from row 7), so at
// Nf = 3 the record bytes bound the canonical segment (chip_smoke.py
// counts both); with gyroresonance each harmonic adds 13 operations a
// record and 7 a frequency, and the arithmetic bounds it. Each of a ray's
// Nf threads repeats the frequency-free terms, and exp, log, pow and expm1
// run in the special function units and in multi-instruction routines, so
// the kernel's time sits well above either bound (PERF.md).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

constexpr int kMaxHarmonic = 128;   // MAX_HARMONIC in ops/_build.py

// Mirror of ops/_build.py::_FoldParams. Floats are the float32 values the
// plain version's torch ops use: a Python scalar rounded to float32, or
// 1/that for a division by it. It sits outside the unnamed namespace below:
// the C entries take it, and a parameter of that namespace's type would
// give them internal linkage.
struct FoldParams {
  int n_rays;           // rays (records) or pixels (voxels)
  int nf;
  int n_steps;          // records of the segment, or voxels along the LOS
  int mechanism;        // bit union: 1 free-free, 2 gyroresonance, 4 neutrals
  int gaunt_exact;      // 0 Dulk Coulomb log, 1 exact Gaunt factor
  int s_max;            // highest gyroresonance harmonic
  int theta_per_voxel;  // theta from row 7 (records) or the theta array
  int s_on;             // records: source area S * area
  float theta0;         // fixed theta, rad
  float area;           // pixel area, cm^2
  float inv_au_sq;      // (1/AU)^2, the product of two float32 1/AU
  float r_sun_cm;       // ds scale of record positions
  float src_coef;       // k_B / c^2 / SFU
  float fpe_sq;         // FPE_COEF^2
  float fb;             // FB_COEF
  float kappa_ff;       // KAPPA_FF_COEF
  float kappa_ff_exact;
  float gaunt_cl, gaunt_born, sqrt3_over_pi;
  float saha, neg_chi, sigma_eh;
  float vmean_num;      // 8 k_B
  float inv_vmean_den;  // 1 / (pi m_e)
  float c_cgs;
  float kb;
  float inv_mec2;       // 1 / (m_e c^2)
  float gr_pref;        // pi^2 / (2 c)
  float sqrt_2pi;
  float log_s2[kMaxHarmonic + 1];   // 2 ln s, by s
  float lgam[kMaxHarmonic + 1];     // lgamma(s + 1), by s
};

namespace {

constexpr int kThreads = 128;
constexpr int kMechFreeFree = 1;
constexpr int kMechGyro = 2;
constexpr int kMechNeutrals = 4;
constexpr int kMechAll = kMechFreeFree | kMechGyro | kMechNeutrals;

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// torch.maximum: NaN if either is NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

// physics.refractive_index_sq: Appleton-Hartree n^2 of mode sigma.
__device__ __forceinline__ float refractive_index_sq(float X, float Y,
                                                     float st, float ct,
                                                     float sigma) {
  const float yst = Y * st;
  const float yt2 = yst * yst;
  const float yct = Y * ct;
  const float yl2 = yct * yct;
  const float one_m_x = 1.0f - X;
  const float root = sqrtf(yt2 * yt2 * 0.25f + one_m_x * one_m_x * yl2);
  const float denom = (one_m_x - yt2 * 0.5f) + sigma * root;
  const float safe = fabsf(denom) > 1e-30f ? denom : 1e-30f;
  return 1.0f - X * one_m_x / safe;
}

// physics.gyro_polarization_coupling: F_sigma(theta).
__device__ __forceinline__ float gyro_coupling(float X, float Y, float st,
                                               float ct, float sigma) {
  const float n2 = refractive_index_sq(X, Y, st, ct, sigma);
  const float one_m_y2 = 1.0f - Y * Y;
  const float safe = fabsf(one_m_y2) > 1e-12f
                         ? one_m_y2
                         : (one_m_y2 >= 0.0f ? 1e-12f : -1e-12f);
  const float s_stix = 1.0f - X / safe;
  const float d_stix = -X * Y / safe;
  const float p_stix = 1.0f - X;
  const float a = n2 - s_stix;
  const float d_l = p_stix - n2 * st * st;
  const float apd = a + d_stix;
  const float num = apd * apd * d_l * d_l;
  const float cs = ct * st;
  const float den = (a * a + d_stix * d_stix) * d_l * d_l +
                    a * a * (n2 * n2) * (cs * cs);
  return num / clamp_min(den, 1e-38f);
}

// The mode-free part of physics.gyroresonance_kappa: the sum over
// harmonics s = 2..s_max of (s nu_B) exp(log_term_s) Gauss_s.
__device__ __forceinline__ float gyro_harmonic_sum(const FoldParams& p,
                                                   float nu, float nu_b,
                                                   float beta, float act,
                                                   float log_arg) {
  float total = 0.0f;
  for (int s = 2; s <= p.s_max; ++s) {
    const float sf = static_cast<float>(s);
    const float snb = sf * nu_b;
    const float width = snb * beta * act;
    const float log_s2 = p.log_s2[s];
    const float log_term =
        log_s2 + (sf - 1.0f) * (log_arg + log_s2) - p.lgam[s];
    const float dnu = nu - snb;
    const float gauss = expf(-(dnu * dnu) / (2.0f * width * width)) /
                        (p.sqrt_2pi * width);
    total = total + snb * expf(log_term) * gauss;
  }
  return total;
}

// One mode's step of the carry (the plain update's `apply`).
__device__ __forceinline__ void apply_mode(float& f, float& t_sum, float tau,
                                           bool evan, float src) {
  const float f_new = f * expf(-tau) + src * -expm1f(-tau);
  f = evan ? 0.0f : f_new;
  t_sum = evan ? INFINITY : t_sum + tau;
}

// Per-thread frequency terms, fixed over a call.
struct FreqTerms {
  float nu, nu2, ln_nu, src;
};

__device__ __forceinline__ FreqTerms freq_terms(const FoldParams& p,
                                                float nu) {
  const float nu2 = nu * nu;
  return {nu, nu2, logf(nu), p.src_coef * nu2};
}

// The voxel update of grff/transfer.make_voxel_update for one (ray,
// frequency), on a voxel whose mask holds (valid, finite ne/te/b/ds, ds >
// 0). st, ct: sin and cos of its theta; swap: the angle is per voxel, so
// cos(theta) < -1e-6 swaps the output slots; mech: the voxel's mechanism
// bits (kMechAll without a per-voxel mask; p.mechanism says which terms are
// computed at all).
__device__ __forceinline__ void voxel_update(
    const FoldParams& p, const FreqTerms& fq, float ds, float te, float ne,
    float b, float sarea, float st, float ct, bool swap, int mech,
    float& f_o, float& f_x, float& t_o, float& t_x) {
  const bool ff_on = (p.mechanism & kMechFreeFree) && (mech & kMechFreeFree);
  const bool n_on = ff_on && (p.mechanism & kMechNeutrals) &&
                    (mech & kMechNeutrals);
  const bool gr_on = (p.mechanism & kMechGyro) && (mech & kMechGyro);
  const float nu = fq.nu;
  const float area = (sarea > 0.0f ? sarea : p.area) * p.inv_au_sq;
  const float nu_p_sq = p.fpe_sq * ne;
  const float nu_b = p.fb * b;
  const float X = nu_p_sq / fq.nu2;
  const float Y = nu_b / nu;
  const float abs_ct = fabsf(ct);

  // free-free: coef ne^2 lnLambda / (n_sigma eff_nu^2 T^1.5)
  float ff_num = 0.0f, t32 = 1.0f;
  if (ff_on) {
    const float ln_t = logf(te);
    float lnlam;
    if (p.gaunt_exact) {
      const float g_cl = p.gaunt_cl + 1.5f * ln_t - fq.ln_nu;
      const float g_born = p.gaunt_born + ln_t - fq.ln_nu;
      lnlam = p.sqrt3_over_pi * clamp_min(nan_max(g_cl, g_born), 0.0f);
    } else {
      const float low = 18.2f + 1.5f * ln_t - fq.ln_nu;
      const float high = 24.5f + ln_t - fq.ln_nu;
      lnlam = clamp_min(te < 2e5f ? low : high, 0.0f);
    }
    ff_num = (p.gaunt_exact ? p.kappa_ff_exact : p.kappa_ff) * ne * ne *
             lnlam;
    t32 = te * sqrtf(te);
  }
  // neutral hydrogen: the Saha density times the e-H collision rate
  float nu_en = 0.0f;
  if (n_on) {
    const float te_c = clamp_min(te, 500.0f);
    const float rhs =
        p.saha * powf(te_c, 1.5f) * expf((1.0f / te_c) * p.neg_chi);
    const float n_h = ne * ne / clamp_min(rhs, 1e-30f);
    const float v_mean = sqrtf(p.vmean_num * te * p.inv_vmean_den);
    nu_en = n_h * p.sigma_eh * v_mean;
  }
  // gyroresonance: pref_sigma * F_sigma * (the mode-free harmonic sum)
  float gr_pref = 0.0f, gr_total = 0.0f, y_gr = 0.0f;
  if (gr_on) {
    const float nu_bg = clamp_min(p.fb * b, 1.0f);
    const float beta2 = p.kb * te * p.inv_mec2;
    const float beta = sqrtf(beta2);
    const float act = clamp_min(abs_ct, 0.01f);
    const float log_arg = logf(clamp_min(beta2 * (st * st) * 0.5f, 1e-38f));
    y_gr = nu_bg / nu;
    gr_pref = p.gr_pref * nu_p_sq / nu;
    gr_total = gyro_harmonic_sum(p, nu, nu_bg, beta, act, log_arg);
  }

  float tau[2];
  bool evan[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float sigma = m == 0 ? 1.0f : -1.0f;
    const float n2 = refractive_index_sq(X, Y, st, ct, sigma);
    const float n_sigma = sqrtf(clamp_min(n2, 1e-12f));
    const float eff = nu + sigma * nu_b * abs_ct;
    const float eff_sq = clamp_min(eff * eff, 1e-30f);
    float kappa = 0.0f;
    if (ff_on) {
      kappa = ff_num / (n_sigma * eff_sq * t32);
      if (n_on)
        kappa = kappa + nu_p_sq / eff_sq * nu_en / (p.c_cgs * n_sigma);
    }
    if (gr_on)
      kappa = kappa +
              gr_pref * gyro_coupling(X, y_gr, st, ct, sigma) * gr_total;
    const float t = kappa * ds;
    tau[m] = isfinite(t) ? t : 0.0f;
    evan[m] = n2 <= 0.0f;
  }
  const bool sw = swap && ct < -1e-6f;
  const float src = te * fq.src * area;
  apply_mode(f_o, t_o, sw ? tau[1] : tau[0], sw ? evan[1] : evan[0], src);
  apply_mode(f_x, t_x, sw ? tau[0] : tau[1], sw ? evan[0] : evan[1], src);
}

__device__ __forceinline__ bool usable(float ne, float te, float b,
                                       float ds) {
  return isfinite(ne) && isfinite(te) && isfinite(b) && isfinite(ds) &&
         ds > 0.0f;
}

__global__ void __launch_bounds__(kThreads) fold_records_kernel(
    const float* __restrict__ recs, const float* __restrict__ freqs,
    const float* __restrict__ fo_in, const float* __restrict__ fx_in,
    const float* __restrict__ to_in, const float* __restrict__ tx_in,
    const float* __restrict__ prev_in, float* __restrict__ carry_out,
    float* __restrict__ prev_out, const __grid_constant__ FoldParams p) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= p.n_rays) return;
  const int f = blockIdx.y;
  const int64_t n = p.n_rays;
  const int64_t ci = int64_t(ray) * p.nf + f;
  float f_o = fo_in[ci], f_x = fx_in[ci], t_o = to_in[ci], t_x = tx_in[ci];
  float px = prev_in[3 * int64_t(ray)], py = prev_in[3 * int64_t(ray) + 1],
        pz = prev_in[3 * int64_t(ray) + 2];
  const FreqTerms fq = freq_terms(p, freqs[f]);
  const bool theta_los = p.theta_per_voxel != 0;
  const float st0 = sinf(p.theta0), ct0 = cosf(p.theta0);
  for (int r = 0; r < p.n_steps; ++r) {
    const float* row = recs + int64_t(r) * 8 * n + ray;
    const float x = row[0], y = row[n], z = row[2 * n], s = row[3 * n];
    const float cos_t = theta_los ? row[7 * n] : 0.0f;
    // sampler.record_step: valid where the position and S are finite and
    // S > 0 (and, with theta from row 7, cos theta is finite); ds from the
    // last valid position
    if (!(isfinite(x) && isfinite(y) && isfinite(z) && isfinite(s) &&
          s > 0.0f && (!theta_los || isfinite(cos_t))))
      continue;
    const float dx = x - px, dy = y - py, dz = z - pz;
    const float ds = sqrtf(dx * dx + dy * dy + dz * dz) * p.r_sun_cm;
    px = x;
    py = y;
    pz = z;
    const float ne = row[4 * n], te = row[5 * n], b = row[6 * n];
    if (!usable(ne, te, b, ds)) continue;
    float st = st0, ct = ct0;
    if (theta_los) {
      const float th = acosf(fminf(fmaxf(cos_t, -1.0f), 1.0f));
      st = sinf(th);
      ct = cosf(th);
    }
    voxel_update(p, fq, ds, te, ne, b, p.s_on ? s * p.area : 0.0f, st, ct,
                 theta_los, kMechAll, f_o, f_x, t_o, t_x);
  }
  const int64_t plane = n * p.nf;
  carry_out[ci] = f_o;
  carry_out[plane + ci] = f_x;
  carry_out[2 * plane + ci] = t_o;
  carry_out[3 * plane + ci] = t_x;
  if (f == 0) {
    prev_out[3 * int64_t(ray)] = px;
    prev_out[3 * int64_t(ray) + 1] = py;
    prev_out[3 * int64_t(ray) + 2] = pz;
  }
}

__global__ void __launch_bounds__(kThreads) fold_voxels_kernel(
    const float* __restrict__ ds, const float* __restrict__ te,
    const float* __restrict__ ne, const float* __restrict__ b,
    const unsigned char* __restrict__ valid,
    const float* __restrict__ sarea, const float* __restrict__ theta,
    const int* __restrict__ mech, const float* __restrict__ freqs,
    const float* __restrict__ fo_in, const float* __restrict__ fx_in,
    const float* __restrict__ to_in, const float* __restrict__ tx_in,
    float* __restrict__ carry_out, const __grid_constant__ FoldParams p) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= p.n_rays) return;
  const int f = blockIdx.y;
  const int64_t n = p.n_rays;
  const int64_t ci = int64_t(pix) * p.nf + f;
  float f_o = 0.0f, f_x = 0.0f, t_o = 0.0f, t_x = 0.0f;
  if (fo_in != nullptr) {
    f_o = fo_in[ci];
    f_x = fx_in[ci];
    t_o = to_in[ci];
    t_x = tx_in[ci];
  }
  const FreqTerms fq = freq_terms(p, freqs[f]);
  const float st0 = sinf(p.theta0), ct0 = cosf(p.theta0);
  for (int k = 0; k < p.n_steps; ++k) {
    const int64_t v = int64_t(k) * n + pix;
    if (!valid[v]) continue;
    const float d = ds[v], t = te[v], e = ne[v], bb = b[v];
    if (!usable(e, t, bb, d)) continue;
    float st = st0, ct = ct0;
    if (theta != nullptr) {
      st = sinf(theta[v]);
      ct = cosf(theta[v]);
    }
    voxel_update(p, fq, d, t, e, bb, sarea != nullptr ? sarea[v] : 0.0f, st,
                 ct, theta != nullptr, mech != nullptr ? mech[v] : kMechAll,
                 f_o, f_x, t_o, t_x);
  }
  const int64_t plane = n * p.nf;
  carry_out[ci] = f_o;
  carry_out[plane + ci] = f_x;
  carry_out[2 * plane + ci] = t_o;
  carry_out[3 * plane + ci] = t_x;
}

bool bad_params(const FoldParams* p) {
  return p->n_rays < 0 || p->nf < 0 || p->nf > 65535 || p->n_steps < 0 ||
         p->s_max > kMaxHarmonic;
}

dim3 fold_grid(const FoldParams* p) {
  return dim3((p->n_rays + kThreads - 1) / kThreads, p->nf);
}

}  // namespace

// Fold one segment's records into the carry. recs: (n_steps, 8, n_rays);
// carry_in: four (n_rays, nf) arrays; prev_in: (n_rays, 3) last valid
// positions; carry_out: (4, n_rays, nf); prev_out: (n_rays, 3). float32,
// device pointers; p on the host.
extern "C" int rgrff_fold_records(const void* recs, const void* freqs,
                                  const void* fo_in, const void* fx_in,
                                  const void* to_in, const void* tx_in,
                                  const void* prev_in, void* carry_out,
                                  void* prev_out, const FoldParams* p,
                                  void* stream) {
  if (bad_params(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (p->n_rays == 0 || p->nf == 0) return 0;
  fold_records_kernel<<<fold_grid(p), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(recs), static_cast<const float*>(freqs),
      static_cast<const float*>(fo_in), static_cast<const float*>(fx_in),
      static_cast<const float*>(to_in), static_cast<const float*>(tx_in),
      static_cast<const float*>(prev_in), static_cast<float*>(carry_out),
      static_cast<float*>(prev_out), *p);
  return static_cast<int>(cudaGetLastError());
}

// Fold (n_steps, n_rays) voxel arrays into the carry. ds, te, ne, b float32;
// valid one byte a voxel; sarea (float32), theta (float32 rad) and mech
// (int32) may be null: no source area, p->theta0, every mechanism bit of
// p->mechanism. carry_in: four (n_rays, nf) arrays, or all null for a zero
// carry; carry_out: (4, n_rays, nf).
extern "C" int rgrff_fold_voxels(const void* ds, const void* te,
                                 const void* ne, const void* b,
                                 const void* valid, const void* sarea,
                                 const void* theta, const void* mech,
                                 const void* freqs, const void* fo_in,
                                 const void* fx_in, const void* to_in,
                                 const void* tx_in, void* carry_out,
                                 const FoldParams* p, void* stream) {
  if (bad_params(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (p->n_rays == 0 || p->nf == 0) return 0;
  fold_voxels_kernel<<<fold_grid(p), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ds), static_cast<const float*>(te),
      static_cast<const float*>(ne), static_cast<const float*>(b),
      static_cast<const unsigned char*>(valid),
      static_cast<const float*>(sarea), static_cast<const float*>(theta),
      static_cast<const int*>(mech), static_cast<const float*>(freqs),
      static_cast<const float*>(fo_in), static_cast<const float*>(fx_in),
      static_cast<const float*>(to_in), static_cast<const float*>(tx_in),
      static_cast<float*>(carry_out), *p);
  return static_cast<int>(cudaGetLastError());
}
