// Transfer folds for Hopper (sm_90a), bound through plain C entries.
//
// Two entries share one voxel update, the two-mode transfer of
// raytracinggrff_tpu_torch/grff/transfer.py::make_voxel_update (the JAX
// package's raytracinggrff_tpu/grff/transfer.py:65-182, with the physics of
// grff/physics.py: Appleton-Hartree n^2, free-free with the Dulk or the
// exact Gaunt factor, the Saha neutral term, thermal gyroresonance over
// harmonics 2..s_max in log space):
//   rgrff_fold_records folds one trace segment's records (rps, 8, n_rays),
//       rows [x, y, z, S, ne, te, b, cos_theta], into the carry, taking
//       each record's validity and ds from consecutive positions
//       (ops/los_scans.record_step). It replaces the JAX pipeline's
//       per-segment scan stream_seg (raytracinggrff_tpu/pipeline.py:377-396,
//       jax.jit around lax.scan).
//   rgrff_fold_voxels folds (Nz, n_pix) voxel arrays that already hold ds,
//       the validity and the source areas, with an optional per-voxel theta
//       and mechanism mask. It replaces _grff_transfer_jit
//       (raytracinggrff_tpu/grff/transfer.py:231-275, lax.scan).
// Neither is a TPU kernel: in JAX both scans are XLA programs, one device
// program a call. The plain torch versions (ops/transfer_fold.py) launch
// about 271 small kernels a record, so they run at the host's launch rate.
// A third entry, rgrff_fold_counts, counts what rgrff_fold_records does
// with a segment's records, for the fold's roofline in traced runs: the
// records it steps from (valid) and those it takes (valid, finite ne, te,
// b and ds, ds > 0). Four lanes a ray step the records as the fold's lane
// groups do, with the last valid position in registers and the fold's ds;
// a block adds its counts with one atomic each. It is a kernel of its own
// so that the fold is the same whether or not anything counts.
//
// Design: lane groups. A ray (a pixel) is served by G consecutive lanes of
// one warp, G = 1, 2, 4 or 8 (a template parameter). Lane j of the group
// owns the carry (flux_o, flux_x, tau_o, tau_x) of frequency g G + j, where
// g is the grid's y index, so any Nf runs in ceil(Nf / G) frequency groups;
// a lane past Nf computes but writes nothing. The group walks the records
// in chunks of G:
//   1. Lane j loads record r + j of its ray (rows 0-6, and row 7 only with
//      a per-record theta). The next chunk's record is loaded before this
//      chunk is computed, so its load latency is off the serial path.
//   2. Lane j computes its record's frequency-free terms once: validity;
//      ds from the last valid position (the group's validity ballot gives
//      each lane the highest valid lane below it, else the position carried
//      from the previous chunk's last valid lane, both by shuffle); ln T,
//      T^1.5, the Saha density, theta's sine and cosine, the area, nu_p^2,
//      nu_B; with gyroresonance, each harmonic's s nu_B, widths and
//      s nu_B exp(log_term).
//   3. Lane j then runs the per-frequency part of the update of its record
//      at each of the group's frequencies, up to the carry: the opacities,
//      tau, the evanescent flags, and the step's factors exp(-tau) and
//      src * -expm1(-tau) of both slots.
//   4. It stages those steps in shared memory; after a __syncwarp each lane
//      applies the G records' steps at its own frequency to its carry, in
//      record order. The carry and the ray's last valid position stay in
//      registers over the call and are written once.
// So a record's frequency-free terms are computed once per frequency group
// and no lane idles in the per-frequency work (Nf = 3 runs 3 steps on each
// of 4 lanes, where a lane per frequency would leave the fourth idle); only
// the steps' application, a multiply, an add and a select a mode, runs on
// the lane of each frequency. At G = 4 the 8 rays of a warp read 32
// consecutive bytes of a record row per load: one sector. A voxel that is
// not valid leaves the carry as the plain update leaves it (it adds 0 and
// multiplies by exp(-0) = 1), so it is skipped, and a chunk none of whose
// records any lane of the warp takes costs only its loads. Shuffles,
// ballots and __syncwarp take the whole warp, whose lanes all stay in the
// loop, under warp-uniform branches.
//
// Group and block size. The wrapper (ops/transfer_fold.group_size) takes
// the next power of two >= min(Nf, 8), and doubles it, up to 8, while the
// launch holds fewer than 65,536 lanes: the TbSpectra sweep's folds
// (16,384 rays at Nf = 1) have 512 warps at G = 1, too few for 132 SMs to
// hide their latency, and G = 4 folds four records of a ray at once. A
// block has kThreads = 128 threads: blocks of 32 and 64 threads were at
// most 0.4% faster at any group size, in any case, and up to 6% slower in
// the record folds at G = 8 (H100, PERF.md section 6).
//
// The arithmetic repeats the plain version's torch ops one by one and in
// their order, and the shipped -fmad=false build keeps nvcc from fusing
// them; a division by a Python scalar is, as torch's CUDA div computes it, a
// product with the float reciprocal of the scalar. A term that no frequency
// enters is computed once a record instead of once a (record, frequency),
// and one that no mode enters once a (record, frequency): the same values,
// since C evaluates a * b * c as (a * b) * c and the shared factor is that
// leading product; the carry step f exp(-tau) + src (-expm1(-tau)) is the
// same sum of the same two products. The harmonic sum runs s = 2..s_max in
// order, where torch's reduction may add in another order, so with
// gyroresonance the two agree to rounding, not bit for bit (on the card
// they have agreed exactly). The physics constants come from constants.py
// and grff/physics.py through FoldParams (one source); the literals here
// are those of the formulas in grff/physics.py. The harmonic tables (2 ln s
// and lgamma(s + 1), s = 0..s_max) come as one device array of 2 (s_max +
// 1) floats; a block stages them into shared memory when they fit beside
// its chunk stage in kSmemTableBytes, and reads them from global memory
// otherwise, so any s_max runs.
//
// What bounds it: at mechanism 5 a valid record takes some 37 float32
// operations that no frequency enters and 64 for each frequency, against
// 28 bytes of record (32 with theta from row 7), so at Nf = 3 the record
// bytes bound the canonical segment (chip_smoke.py counts both); with
// gyroresonance each harmonic adds 13 operations a record and 7 a
// frequency, and the arithmetic bounds it. The kernel's time sits well
// above either bound, and at the canonical size it follows the count of
// frequency-free and per-frequency updates it runs: exp, log, pow, expm1,
// sqrt and the IEEE divisions are multi-instruction routines that the
// count takes as one operation. The shipped build may not contract a
// multiply and an add into one FMA, while the peak rate (67 TFLOP/s)
// counts an FMA as two operations, so an operation-bound fold reaches at
// most about half its bound.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

// Mirror of ops/_build.py::_FoldParams, scalars only. Floats are the
// float32 values the plain version's torch ops use: a Python scalar rounded
// to float32, or 1/that for a division by it. It sits outside the unnamed
// namespace below: the C entries take it, and a parameter of that
// namespace's type would give them internal linkage.
struct FoldParams {
  int n_rays;           // rays (records) or pixels (voxels)
  int nf;
  int n_steps;          // records of the segment, or voxels along the LOS
  int mechanism;        // bit union: 1 free-free, 2 gyroresonance, 4 neutrals
  int gaunt_exact;      // 0 Dulk Coulomb log, 1 exact Gaunt factor
  int s_max;            // highest gyroresonance harmonic
  int theta_per_voxel;  // theta from row 7 (records) or the theta array
  int s_on;             // records: source area S * area
  int group;            // lanes a ray: 1, 2, 4 or 8
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
};

namespace {

constexpr int kThreads = 128;  // threads a block (the header says why)
constexpr int kMechFreeFree = 1;
constexpr int kMechGyro = 2;
constexpr int kMechNeutrals = 4;
constexpr int kMechAll = kMechFreeFree | kMechGyro | kMechNeutrals;
// harmonic tables up to this size are staged in shared memory (the default
// dynamic shared memory of a block); larger ones are read from global memory
constexpr long long kSmemTableBytes = 48 * 1024;

__host__ __device__ inline bool gyro_on(int mechanism, int s_max) {
  return (mechanism & kMechGyro) && s_max >= 2;
}

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

// One mode's step of the carry (the plain update's `apply`), split where
// the carry enters: f_new = f * exp(-tau) + src * -expm1(-tau), so `e` and
// `m` are those two factors, computed before the carry is at hand.
struct ModeStep {
  float e, m, tau;
  bool evan;
};

__device__ __forceinline__ ModeStep mode_step(float tau, bool evan,
                                              float src) {
  return {expf(-tau), src * -expm1f(-tau), tau, evan};
}

__device__ __forceinline__ void apply_mode(float& f, float& t_sum,
                                           const ModeStep& st) {
  const float f_new = f * st.e + st.m;
  f = st.evan ? 0.0f : f_new;
  t_sum = st.evan ? INFINITY : t_sum + st.tau;
}

// A lane's frequency terms, fixed over a call.
struct FreqTerms {
  float nu, nu2, ln_nu, src;
};

__device__ __forceinline__ FreqTerms freq_terms(const FoldParams& p,
                                                float nu) {
  const float nu2 = nu * nu;
  return {nu, nu2, logf(nu), p.src_coef * nu2};
}

// The terms of one voxel that no frequency enters: the leading factors of
// make_voxel_update's products, and the voxel's mechanism bits (kMechAll
// without a per-voxel mask; p.mechanism says which terms are computed).
struct VoxelTerms {
  float ds, te, area, st, ct;
  float nu_p_sq, nu_b, nb_ct;   // nu_B |cos theta|
  float ffc, lam_a, lam_b, t32;  // coef ne^2; Coulomb-log leads; T^1.5
  float nu_en;                   // neutrals' collision rate
  float nu_bg, gr_num;           // max(nu_B, 1); pi^2/(2c) nu_p^2
  int mech;
};

__device__ __forceinline__ bool ff_on(const FoldParams& p, int mech) {
  return (p.mechanism & kMechFreeFree) && (mech & kMechFreeFree);
}

__device__ __forceinline__ bool n_on(const FoldParams& p, int mech) {
  return ff_on(p, mech) && (p.mechanism & kMechNeutrals) &&
         (mech & kMechNeutrals);
}

__device__ __forceinline__ bool gr_on(const FoldParams& p, int mech) {
  return (p.mechanism & kMechGyro) && (mech & kMechGyro);
}

// make_voxel_update's frequency-free terms of a voxel whose mask holds
// (valid, finite ne/te/b/ds, ds > 0); st, ct: sin and cos of its theta.
__device__ __forceinline__ VoxelTerms voxel_terms(const FoldParams& p,
                                                  float ds, float te,
                                                  float ne, float b,
                                                  float sarea, float st,
                                                  float ct, int mech) {
  VoxelTerms v;
  v.ds = ds;
  v.te = te;
  v.st = st;
  v.ct = ct;
  v.mech = mech;
  v.area = (sarea > 0.0f ? sarea : p.area) * p.inv_au_sq;
  v.nu_p_sq = p.fpe_sq * ne;
  v.nu_b = p.fb * b;
  // sigma * nu_B * |cos theta| is +-(nu_B |cos theta|) exactly
  v.nb_ct = v.nu_b * fabsf(ct);
  v.ffc = v.lam_a = v.lam_b = 0.0f;
  v.t32 = 1.0f;
  if (ff_on(p, mech)) {
    // free-free: coef ne^2 lnLambda / (n_sigma eff_nu^2 T^1.5); the
    // Coulomb log is (lead - ln nu), the lead chosen by T (Dulk) or both
    // leads kept (the exact Gaunt factor's classical and Born terms)
    const float ln_t = logf(te);
    if (p.gaunt_exact) {
      v.lam_a = p.gaunt_cl + 1.5f * ln_t;
      v.lam_b = p.gaunt_born + ln_t;
    } else {
      v.lam_a = te < 2e5f ? 18.2f + 1.5f * ln_t : 24.5f + ln_t;
    }
    v.ffc = (p.gaunt_exact ? p.kappa_ff_exact : p.kappa_ff) * ne * ne;
    v.t32 = te * sqrtf(te);
  }
  v.nu_en = 0.0f;
  if (n_on(p, mech)) {
    // neutral hydrogen: the Saha density times the e-H collision rate
    const float te_c = clamp_min(te, 500.0f);
    const float rhs =
        p.saha * powf(te_c, 1.5f) * expf((1.0f / te_c) * p.neg_chi);
    const float n_h = ne * ne / clamp_min(rhs, 1e-30f);
    const float v_mean = sqrtf(p.vmean_num * te * p.inv_vmean_den);
    v.nu_en = n_h * p.sigma_eh * v_mean;
  }
  v.nu_bg = v.gr_num = 0.0f;
  if (gr_on(p, mech)) {
    v.nu_bg = clamp_min(p.fb * b, 1.0f);
    v.gr_num = p.gr_pref * v.nu_p_sq;
  }
  return v;
}

// The rest of the voxel update for one frequency: make_voxel_update's
// per-frequency and per-mode ops up to the carry, as the two output slots'
// steps. gr_total: the frequency's harmonic sum; swap: the angle is per
// voxel, so cos(theta) < -1e-6 swaps the output slots.
__device__ __forceinline__ void freq_step(const FoldParams& p,
                                          const FreqTerms& fq,
                                          const VoxelTerms& v,
                                          float gr_total, bool swap,
                                          ModeStep& o, ModeStep& x) {
  const bool ff = ff_on(p, v.mech);
  const bool nn = n_on(p, v.mech);
  const bool gr = gr_on(p, v.mech);
  const float nu = fq.nu;
  const float X = v.nu_p_sq / fq.nu2;
  const float Y = v.nu_b / nu;
  float ff_num = 0.0f;
  if (ff) {
    float lnlam;
    if (p.gaunt_exact) {
      const float g_cl = v.lam_a - fq.ln_nu;
      const float g_born = v.lam_b - fq.ln_nu;
      lnlam = p.sqrt3_over_pi * clamp_min(nan_max(g_cl, g_born), 0.0f);
    } else {
      lnlam = clamp_min(v.lam_a - fq.ln_nu, 0.0f);
    }
    ff_num = v.ffc * lnlam;
  }
  float gr_pref = 0.0f, y_gr = 0.0f;
  if (gr) {
    y_gr = v.nu_bg / nu;
    gr_pref = v.gr_num / nu;
  }
  float tau[2];
  bool evan[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float sigma = m == 0 ? 1.0f : -1.0f;
    const float n2 = refractive_index_sq(X, Y, v.st, v.ct, sigma);
    const float n_sigma = sqrtf(clamp_min(n2, 1e-12f));
    const float eff = nu + (m == 0 ? v.nb_ct : -v.nb_ct);
    const float eff_sq = clamp_min(eff * eff, 1e-30f);
    float kappa = 0.0f;
    if (ff) {
      kappa = ff_num / (n_sigma * eff_sq * v.t32);
      if (nn)
        kappa = kappa + v.nu_p_sq / eff_sq * v.nu_en / (p.c_cgs * n_sigma);
    }
    if (gr)
      kappa = kappa +
              gr_pref * gyro_coupling(X, y_gr, v.st, v.ct, sigma) * gr_total;
    const float t = kappa * v.ds;
    tau[m] = isfinite(t) ? t : 0.0f;
    evan[m] = n2 <= 0.0f;
  }
  const bool sw = swap && v.ct < -1e-6f;
  const float src = v.te * fq.src * v.area;
  o = mode_step(sw ? tau[1] : tau[0], sw ? evan[1] : evan[0], src);
  x = mode_step(sw ? tau[0] : tau[1], sw ? evan[0] : evan[1], src);
}

__device__ __forceinline__ bool usable(float ne, float te, float b,
                                       float ds) {
  return isfinite(ne) && isfinite(te) && isfinite(b) && isfinite(ds) &&
         ds > 0.0f;
}

// A lane group of G lanes: the lane's index j in it, and shuffles and
// ballots over it. Every lane of a warp stays in the loops to their end (a
// lane whose ray is past the last computes on that ray and writes nothing),
// and every branch around a shuffle, a ballot or __syncwarp is
// warp-uniform, so they take the full warp's mask.
template <int G>
struct Group {
  static constexpr unsigned kAll = 0xffffffffu;
  int j, base;

  __device__ Group() {
    const int lane = threadIdx.x & 31;
    j = lane & (G - 1);
    base = lane - j;
  }
  // value v of the group's lane src
  __device__ __forceinline__ float from(float v, int src) const {
    if constexpr (G == 1) return v;
    else return __shfl_sync(kAll, v, src, G);
  }
  // whether pred holds in some lane of the warp
  __device__ __forceinline__ bool any(bool pred) const {
    return __any_sync(kAll, pred);
  }
  // bit i: pred of the group's lane i
  __device__ __forceinline__ unsigned ballot(bool pred) const {
    const unsigned bits = __ballot_sync(kAll, pred);
    if constexpr (G == 1) return (bits >> base) & 1u;
    else return (bits >> base) & ((1u << G) - 1u);
  }
};

// Floats of a block's dynamic shared memory that stage the steps of a
// chunk (G > 1): for each warp, 7 values (ModeStep o and x, and the two
// evanescent flags) for each lane, of each of the G records, at a pitch of
// G + 1 so that neither the writes nor the reads meet in a bank.
constexpr int kStepValues = 7;

__host__ __device__ inline int warp_stage_floats(int g) {
  return g == 1 ? 0 : kStepValues * 32 * (g + 1);
}

__host__ __device__ inline int stage_floats(int g) {
  return (kThreads / 32) * warp_stage_floats(g);
}

// Whether a block stages the harmonic tables in shared memory beside its
// chunk stage (at most kSmemTableBytes in all); else it reads them from
// global memory.
__host__ __device__ inline bool tables_in_smem(const FoldParams& p) {
  return gyro_on(p.mechanism, p.s_max) &&
         (stage_floats(p.group) + 2LL * (p.s_max + 1)) *
                 static_cast<long long>(sizeof(float)) <=
             kSmemTableBytes;
}

// The block's set-up: the frequency terms of its frequency group g
// (blockIdx.y), nf_g of them, into fqs, and the harmonic tables staged
// after the chunk stage when they fit. Returns the tables.
template <int G>
__device__ __forceinline__ const float* block_setup(const FoldParams& p,
                                                    const float* freqs,
                                                    const float* tables,
                                                    FreqTerms* fqs) {
  extern __shared__ float smem[];
  if (threadIdx.x < G) {
    const int f = blockIdx.y * G + threadIdx.x;
    fqs[threadIdx.x] = freq_terms(p, freqs[f < p.nf ? f : p.nf - 1]);
  }
  const float* tab = tables;
  if (tables_in_smem(p)) {
    float* staged = smem + stage_floats(G);
    const int n = 2 * (p.s_max + 1);
    for (int i = threadIdx.x; i < n; i += kThreads) staged[i] = tables[i];
    tab = staged;
  }
  __syncthreads();
  return tab;
}

// physics.gyroresonance_kappa's mode-free harmonic sum over s = 2..s_max of
// the lane's voxel v at each of its group's nf_g frequencies: sums[f].
// The frequency-free terms of each harmonic are computed once; tab holds
// 2 ln s at [s] and lgamma(s + 1) at [s_max + 1 + s].
template <int G>
__device__ __forceinline__ void harmonic_sums(const FoldParams& p,
                                              const float* tab,
                                              const VoxelTerms& v,
                                              const FreqTerms* fqs, int nf_g,
                                              float (&sums)[G]) {
  float nu[G];
#pragma unroll
  for (int f = 0; f < G; ++f) {
    nu[f] = fqs[f].nu;
    sums[f] = 0.0f;
  }
  const float beta2 = p.kb * v.te * p.inv_mec2;
  const float beta = sqrtf(beta2);
  const float act = clamp_min(fabsf(v.ct), 0.01f);
  const float log_arg =
      logf(clamp_min(beta2 * (v.st * v.st) * 0.5f, 1e-38f));
  for (int s = 2; s <= p.s_max; ++s) {
    const float sf = static_cast<float>(s);
    const float log_s2 = tab[s];
    const float snb = sf * v.nu_bg;
    const float width = snb * beta * act;
    const float log_term =
        log_s2 + (sf - 1.0f) * (log_arg + log_s2) - tab[p.s_max + 1 + s];
    const float amp = snb * expf(log_term);
    const float w2 = 2.0f * width * width;
    const float sw = p.sqrt_2pi * width;
#pragma unroll
    for (int f = 0; f < G; ++f) {
      if (f >= nf_g) break;
      const float dnu = nu[f] - snb;
      const float gauss = expf(-(dnu * dnu) / w2) / sw;
      sums[f] = sums[f] + amp * gauss;
    }
  }
}

// Fold a chunk of G voxels into the carry of the lane's frequency. Lane j
// of a group holds voxel j of the chunk (`v`, taken where `mine`) and
// computes its steps at each of the group's nf_g frequencies; with G > 1 it
// stages them in shared memory (`stage`, this warp's part), and each lane
// then applies the steps of the chunk's voxels at its own frequency to its
// carry, in order. With G = 1 the lane applies its voxel's step at once.
template <int G>
__device__ __forceinline__ void fold_chunk(const FoldParams& p,
                                           const Group<G>& grp,
                                           const float* tab,
                                           const FreqTerms* fqs, int nf_g,
                                           const VoxelTerms& v, bool mine,
                                           bool swap, float* stage,
                                           bool f_on, float& f_o, float& f_x,
                                           float& t_o, float& t_x) {
  const unsigned take = grp.ballot(mine);
  if (mine) {
    float sums[G] = {};
    if (gr_on(p, v.mech)) harmonic_sums<G>(p, tab, v, fqs, nf_g, sums);
#pragma unroll 1
    for (int f = 0; f < nf_g; ++f) {
      // sums[0] is frequency f's; the rest move down one
      const float gr_total = sums[0];
#pragma unroll
      for (int k = 0; k + 1 < G; ++k) sums[k] = sums[k + 1];
      ModeStep o, x;
      freq_step(p, fqs[f], v, gr_total, swap, o, x);
      if constexpr (G == 1) {
        apply_mode(f_o, t_o, o);
        apply_mode(f_x, t_x, x);
      } else {
        float* at = stage + (grp.base + f) * (G + 1) + grp.j;
        constexpr int kRow = 32 * (G + 1);
        at[0 * kRow] = o.e;
        at[1 * kRow] = o.m;
        at[2 * kRow] = o.tau;
        at[3 * kRow] = x.e;
        at[4 * kRow] = x.m;
        at[5 * kRow] = x.tau;
        at[6 * kRow] = __int_as_float(int(o.evan) | (int(x.evan) << 1));
      }
    }
  }
  if constexpr (G > 1) {
    __syncwarp();
    if (f_on) {
      const float* at = stage + (grp.base + grp.j) * (G + 1);
      constexpr int kRow = 32 * (G + 1);
#pragma unroll 1
      for (int i = 0; i < G; ++i) {
        if (!((take >> i) & 1u)) continue;
        const int flags = __float_as_int(at[6 * kRow + i]);
        apply_mode(f_o, t_o, {at[i], at[kRow + i], at[2 * kRow + i],
                              (flags & 1) != 0});
        apply_mode(f_x, t_x, {at[3 * kRow + i], at[4 * kRow + i],
                              at[5 * kRow + i], (flags & 2) != 0});
      }
    }
    __syncwarp();
  }
}

// One record's rows, as a lane loads them: past the segment, x is NaN.
struct Record {
  float x, y, z, s, ne, te, b, cos_t;
};

__device__ __forceinline__ Record load_record(const float* __restrict__ recs,
                                              int64_t n, int64_t ray, int r,
                                              int n_steps, bool theta_los) {
  Record c;
  if (r >= n_steps) {
    c.x = NAN;
    c.y = c.z = c.s = c.ne = c.te = c.b = c.cos_t = 0.0f;
    return c;
  }
  const float* row = recs + int64_t(r) * 8 * n + ray;
  c.x = row[0];
  c.y = row[n];
  c.z = row[2 * n];
  c.s = row[3 * n];
  c.ne = row[4 * n];
  c.te = row[5 * n];
  c.b = row[6 * n];
  c.cos_t = theta_los ? row[7 * n] : 0.0f;
  return c;
}

template <int G>
__global__ void __launch_bounds__(kThreads) fold_records_kernel(
    const float* __restrict__ recs, const float* __restrict__ freqs,
    const float* __restrict__ tables, const float* __restrict__ fo_in,
    const float* __restrict__ fx_in, const float* __restrict__ to_in,
    const float* __restrict__ tx_in, const float* __restrict__ prev_in,
    float* __restrict__ carry_out, float* __restrict__ prev_out,
    const __grid_constant__ FoldParams p) {
  __shared__ FreqTerms fqs[G];
  extern __shared__ float smem[];
  const float* tab = block_setup<G>(p, freqs, tables, fqs);
  float* stage = smem + (threadIdx.x / 32) * warp_stage_floats(G);
  const int nf_g = min(G, p.nf - int(blockIdx.y) * G);
  const Group<G> grp;
  const int64_t ray_g =
      (int64_t(blockIdx.x) * kThreads + threadIdx.x) / G;
  const bool live = ray_g < p.n_rays;   // the whole group: one ray
  const int64_t ray = live ? ray_g : p.n_rays - 1;
  const int f = blockIdx.y * G + grp.j;
  const bool f_on = live && f < p.nf;
  const int64_t n = p.n_rays;
  const int64_t ci = ray * p.nf + f;
  float f_o = 0.0f, f_x = 0.0f, t_o = 0.0f, t_x = 0.0f;
  if (f_on) {
    f_o = fo_in[ci];
    f_x = fx_in[ci];
    t_o = to_in[ci];
    t_x = tx_in[ci];
  }
  float px = prev_in[3 * ray], py = prev_in[3 * ray + 1],
        pz = prev_in[3 * ray + 2];
  const bool theta_los = p.theta_per_voxel != 0;
  const float st0 = sinf(p.theta0), ct0 = cosf(p.theta0);
  Record next = load_record(recs, n, ray, grp.j, p.n_steps, theta_los);
  for (int r0 = 0; r0 < p.n_steps; r0 += G) {
    const Record c = next;
    if (r0 + G < p.n_steps)
      next = load_record(recs, n, ray, r0 + G + grp.j, p.n_steps, theta_los);
    // los_scans.record_step: valid where the position and S are finite and
    // S > 0 (and, with theta from row 7, cos theta is finite); ds from the
    // last valid position: the highest valid lane below this one, else the
    // position carried from the previous chunk
    const bool valid = isfinite(c.x) && isfinite(c.y) && isfinite(c.z) &&
                       isfinite(c.s) && c.s > 0.0f &&
                       (!theta_los || isfinite(c.cos_t));
    const unsigned vm = grp.ballot(valid);
    const unsigned below = vm & ((1u << grp.j) - 1u);
    const int src = below ? 31 - __clz(below) : grp.j;
    float qx = grp.from(c.x, src), qy = grp.from(c.y, src),
          qz = grp.from(c.z, src);
    if (!below) {
      qx = px;
      qy = py;
      qz = pz;
    }
    const int last = vm ? 31 - __clz(vm) : grp.j;
    const float lx = grp.from(c.x, last), ly = grp.from(c.y, last),
                lz = grp.from(c.z, last);
    if (vm) {
      px = lx;
      py = ly;
      pz = lz;
    }
    const float dx = c.x - qx, dy = c.y - qy, dz = c.z - qz;
    const float ds = sqrtf(dx * dx + dy * dy + dz * dz) * p.r_sun_cm;
    const bool mine = valid && usable(c.ne, c.te, c.b, ds);
    if (!grp.any(mine)) continue;
    VoxelTerms v{};
    if (mine) {
      float st = st0, ct = ct0;
      if (theta_los) {
        const float th = acosf(fminf(fmaxf(c.cos_t, -1.0f), 1.0f));
        st = sinf(th);
        ct = cosf(th);
      }
      v = voxel_terms(p, ds, c.te, c.ne, c.b, p.s_on ? c.s * p.area : 0.0f,
                      st, ct, kMechAll);
    }
    fold_chunk<G>(p, grp, tab, fqs, nf_g, v, mine, theta_los, stage, f_on,
                  f_o, f_x, t_o, t_x);
  }
  if (f_on) {
    const int64_t plane = n * p.nf;
    carry_out[ci] = f_o;
    carry_out[plane + ci] = f_x;
    carry_out[2 * plane + ci] = t_o;
    carry_out[3 * plane + ci] = t_x;
  }
  if (live && blockIdx.y == 0 && grp.j == 0) {
    prev_out[3 * ray] = px;
    prev_out[3 * ray + 1] = py;
    prev_out[3 * ray + 2] = pz;
  }
}

// One voxel's inputs, as a lane loads them: past the batch, not valid.
struct Voxel {
  float ds, te, ne, b, sarea, theta;
  int mech;
  bool valid;
};

__device__ __forceinline__ Voxel load_voxel(
    const float* __restrict__ ds, const float* __restrict__ te,
    const float* __restrict__ ne, const float* __restrict__ b,
    const unsigned char* __restrict__ valid,
    const float* __restrict__ sarea, const float* __restrict__ theta,
    const int* __restrict__ mech, int64_t n, int64_t pix, int k,
    int n_steps) {
  Voxel c{};
  c.valid = false;
  c.mech = kMechAll;
  if (k >= n_steps) return c;
  const int64_t v = int64_t(k) * n + pix;
  c.valid = valid[v] != 0;
  c.ds = ds[v];
  c.te = te[v];
  c.ne = ne[v];
  c.b = b[v];
  c.sarea = sarea != nullptr ? sarea[v] : 0.0f;
  c.theta = theta != nullptr ? theta[v] : 0.0f;
  if (mech != nullptr) c.mech = mech[v];
  return c;
}

template <int G>
__global__ void __launch_bounds__(kThreads) fold_voxels_kernel(
    const float* __restrict__ ds, const float* __restrict__ te,
    const float* __restrict__ ne, const float* __restrict__ b,
    const unsigned char* __restrict__ valid,
    const float* __restrict__ sarea, const float* __restrict__ theta,
    const int* __restrict__ mech, const float* __restrict__ freqs,
    const float* __restrict__ tables, const float* __restrict__ fo_in,
    const float* __restrict__ fx_in, const float* __restrict__ to_in,
    const float* __restrict__ tx_in, float* __restrict__ carry_out,
    const __grid_constant__ FoldParams p) {
  __shared__ FreqTerms fqs[G];
  extern __shared__ float smem[];
  const float* tab = block_setup<G>(p, freqs, tables, fqs);
  float* stage = smem + (threadIdx.x / 32) * warp_stage_floats(G);
  const int nf_g = min(G, p.nf - int(blockIdx.y) * G);
  const Group<G> grp;
  const int64_t pix_g =
      (int64_t(blockIdx.x) * kThreads + threadIdx.x) / G;
  const bool live = pix_g < p.n_rays;   // the whole group: one pixel
  const int64_t pix = live ? pix_g : p.n_rays - 1;
  const int f = blockIdx.y * G + grp.j;
  const bool f_on = live && f < p.nf;
  const int64_t n = p.n_rays;
  const int64_t ci = pix * p.nf + f;
  float f_o = 0.0f, f_x = 0.0f, t_o = 0.0f, t_x = 0.0f;
  if (f_on && fo_in != nullptr) {
    f_o = fo_in[ci];
    f_x = fx_in[ci];
    t_o = to_in[ci];
    t_x = tx_in[ci];
  }
  const bool per_theta = theta != nullptr;
  const float st0 = sinf(p.theta0), ct0 = cosf(p.theta0);
  Voxel next = load_voxel(ds, te, ne, b, valid, sarea, theta, mech, n, pix,
                          grp.j, p.n_steps);
  for (int k0 = 0; k0 < p.n_steps; k0 += G) {
    const Voxel c = next;
    if (k0 + G < p.n_steps)
      next = load_voxel(ds, te, ne, b, valid, sarea, theta, mech, n, pix,
                        k0 + G + grp.j, p.n_steps);
    const bool mine = c.valid && usable(c.ne, c.te, c.b, c.ds);
    if (!grp.any(mine)) continue;
    VoxelTerms v{};
    if (mine) {
      float st = st0, ct = ct0;
      if (per_theta) {
        st = sinf(c.theta);
        ct = cosf(c.theta);
      }
      v = voxel_terms(p, c.ds, c.te, c.ne, c.b, c.sarea, st, ct, c.mech);
    }
    fold_chunk<G>(p, grp, tab, fqs, nf_g, v, mine, per_theta, stage, f_on,
                  f_o, f_x, t_o, t_x);
  }
  if (f_on) {
    const int64_t plane = n * p.nf;
    carry_out[ci] = f_o;
    carry_out[plane + ci] = f_x;
    carry_out[2 * plane + ci] = t_o;
    carry_out[3 * plane + ci] = t_x;
  }
}

bool bad_params(const FoldParams* p, const void* tables) {
  const int g = p->group;
  return p->n_rays < 0 || p->nf < 0 || p->nf > 65535 || p->n_steps < 0 ||
         !(g == 1 || g == 2 || g == 4 || g == 8) ||
         (gyro_on(p->mechanism, p->s_max) && tables == nullptr);
}

struct Launch {
  dim3 grid;
  size_t smem;
};

Launch fold_launch(const FoldParams* p) {
  const int64_t per_block = kThreads / p->group;   // rays a block
  const size_t smem =
      sizeof(float) *
      (size_t(stage_floats(p->group)) +
       (tables_in_smem(*p) ? 2 * size_t(p->s_max + 1) : 0));
  return {dim3(unsigned((p->n_rays + per_block - 1) / per_block),
               unsigned((p->nf + p->group - 1) / p->group)),
          smem};
}

template <int G>
void launch_records(const Launch& l, cudaStream_t stream, const void* recs,
                    const void* freqs, const void* tables, const void* fo_in,
                    const void* fx_in, const void* to_in, const void* tx_in,
                    const void* prev_in, void* carry_out, void* prev_out,
                    const FoldParams* p) {
  fold_records_kernel<G><<<l.grid, kThreads, l.smem, stream>>>(
      static_cast<const float*>(recs), static_cast<const float*>(freqs),
      static_cast<const float*>(tables), static_cast<const float*>(fo_in),
      static_cast<const float*>(fx_in), static_cast<const float*>(to_in),
      static_cast<const float*>(tx_in), static_cast<const float*>(prev_in),
      static_cast<float*>(carry_out), static_cast<float*>(prev_out), *p);
}

template <int G>
void launch_voxels(const Launch& l, cudaStream_t stream, const void* ds,
                   const void* te, const void* ne, const void* b,
                   const void* valid, const void* sarea, const void* theta,
                   const void* mech, const void* freqs, const void* tables,
                   const void* fo_in, const void* fx_in, const void* to_in,
                   const void* tx_in, void* carry_out, const FoldParams* p) {
  fold_voxels_kernel<G><<<l.grid, kThreads, l.smem, stream>>>(
      static_cast<const float*>(ds), static_cast<const float*>(te),
      static_cast<const float*>(ne), static_cast<const float*>(b),
      static_cast<const unsigned char*>(valid),
      static_cast<const float*>(sarea), static_cast<const float*>(theta),
      static_cast<const int*>(mech), static_cast<const float*>(freqs),
      static_cast<const float*>(tables), static_cast<const float*>(fo_in),
      static_cast<const float*>(fx_in), static_cast<const float*>(to_in),
      static_cast<const float*>(tx_in), static_cast<float*>(carry_out), *p);
}

// rgrff_fold_counts: kCountGroup lanes a ray, lane j of the group on
// record r0 + j of each chunk, with the validity ballot and the last valid
// position of fold_records_kernel, so that it counts what the fold does at
// any group size. Four lanes a ray read a ray's record rows as whole 32-byte
// sectors and give the latency of the segment's records four times the
// lanes that one lane a ray gives. A warp adds its counts by shuffle, a
// block in shared memory, and the block's sums go out in one atomic each.
constexpr int kCountGroup = 4;

__global__ void __launch_bounds__(kThreads)
    fold_counts_kernel(const float* __restrict__ recs,
                       const float* __restrict__ prev_in,
                       unsigned long long* __restrict__ counts,
                       const __grid_constant__ FoldParams p) {
  __shared__ unsigned block_sums[2];
  if (threadIdx.x < 2) block_sums[threadIdx.x] = 0;
  __syncthreads();
  const Group<kCountGroup> grp;
  const int64_t ray_g =
      (int64_t(blockIdx.x) * kThreads + threadIdx.x) / kCountGroup;
  const bool live = ray_g < p.n_rays;
  const int64_t ray = live ? ray_g : p.n_rays - 1;
  const int64_t n = p.n_rays;
  const bool theta_los = p.theta_per_voxel != 0;
  float px = prev_in[3 * ray], py = prev_in[3 * ray + 1],
        pz = prev_in[3 * ray + 2];
  unsigned stepped = 0, taken = 0;
  Record next = load_record(recs, n, ray, grp.j, p.n_steps, theta_los);
  for (int r0 = 0; r0 < p.n_steps; r0 += kCountGroup) {
    const Record c = next;
    if (r0 + kCountGroup < p.n_steps)
      next = load_record(recs, n, ray, r0 + kCountGroup + grp.j, p.n_steps,
                         theta_los);
    // as fold_records_kernel: validity, and ds from the highest valid lane
    // below this one, else the position carried from the previous chunk
    const bool valid = isfinite(c.x) && isfinite(c.y) && isfinite(c.z) &&
                       isfinite(c.s) && c.s > 0.0f &&
                       (!theta_los || isfinite(c.cos_t));
    const unsigned vm = grp.ballot(valid);
    const unsigned below = vm & ((1u << grp.j) - 1u);
    const int src = below ? 31 - __clz(below) : grp.j;
    float qx = grp.from(c.x, src), qy = grp.from(c.y, src),
          qz = grp.from(c.z, src);
    if (!below) {
      qx = px;
      qy = py;
      qz = pz;
    }
    const int last = vm ? 31 - __clz(vm) : grp.j;
    const float lx = grp.from(c.x, last), ly = grp.from(c.y, last),
                lz = grp.from(c.z, last);
    if (vm) {
      px = lx;
      py = ly;
      pz = lz;
    }
    const float dx = c.x - qx, dy = c.y - qy, dz = c.z - qz;
    const float ds = sqrtf(dx * dx + dy * dy + dz * dz) * p.r_sun_cm;
    stepped += valid;
    taken += valid && usable(c.ne, c.te, c.b, ds);
  }
  if (!live) stepped = taken = 0;
  stepped = __reduce_add_sync(0xffffffffu, stepped);
  taken = __reduce_add_sync(0xffffffffu, taken);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&block_sums[0], stepped);
    atomicAdd(&block_sums[1], taken);
  }
  __syncthreads();
  if (threadIdx.x < 2)
    atomicAdd(counts + threadIdx.x,
              static_cast<unsigned long long>(block_sums[threadIdx.x]));
}

}  // namespace

// Fold one segment's records into the carry. recs: (n_steps, 8, n_rays);
// tables: (2, s_max + 1) harmonic tables, 2 ln s and lgamma(s + 1) by s
// (may be null without gyroresonance); carry_in: four (n_rays, nf) arrays;
// prev_in: (n_rays, 3) last valid positions; carry_out: (4, n_rays, nf);
// prev_out: (n_rays, 3). float32, device pointers; p on the host.
extern "C" int rgrff_fold_records(const void* recs, const void* freqs,
                                  const void* tables, const void* fo_in,
                                  const void* fx_in, const void* to_in,
                                  const void* tx_in, const void* prev_in,
                                  void* carry_out, void* prev_out,
                                  const FoldParams* p, void* stream) {
  if (bad_params(p, tables)) return static_cast<int>(cudaErrorInvalidValue);
  if (p->n_rays == 0 || p->nf == 0) return 0;
  const Launch l = fold_launch(p);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (p->group) {
    case 1:
      launch_records<1>(l, s, recs, freqs, tables, fo_in, fx_in, to_in,
                        tx_in, prev_in, carry_out, prev_out, p);
      break;
    case 2:
      launch_records<2>(l, s, recs, freqs, tables, fo_in, fx_in, to_in,
                        tx_in, prev_in, carry_out, prev_out, p);
      break;
    case 4:
      launch_records<4>(l, s, recs, freqs, tables, fo_in, fx_in, to_in,
                        tx_in, prev_in, carry_out, prev_out, p);
      break;
    default:
      launch_records<8>(l, s, recs, freqs, tables, fo_in, fx_in, to_in,
                        tx_in, prev_in, carry_out, prev_out, p);
  }
  return static_cast<int>(cudaGetLastError());
}

// Fold (n_steps, n_rays) voxel arrays into the carry. ds, te, ne, b float32;
// valid one byte a voxel; sarea (float32), theta (float32 rad) and mech
// (int32) may be null: no source area, p->theta0, every mechanism bit of
// p->mechanism. tables as for rgrff_fold_records. carry_in: four
// (n_rays, nf) arrays, or all null for a zero carry; carry_out:
// (4, n_rays, nf).
extern "C" int rgrff_fold_voxels(const void* ds, const void* te,
                                 const void* ne, const void* b,
                                 const void* valid, const void* sarea,
                                 const void* theta, const void* mech,
                                 const void* freqs, const void* tables,
                                 const void* fo_in, const void* fx_in,
                                 const void* to_in, const void* tx_in,
                                 void* carry_out, const FoldParams* p,
                                 void* stream) {
  if (bad_params(p, tables)) return static_cast<int>(cudaErrorInvalidValue);
  if (p->n_rays == 0 || p->nf == 0) return 0;
  const Launch l = fold_launch(p);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (p->group) {
    case 1:
      launch_voxels<1>(l, s, ds, te, ne, b, valid, sarea, theta, mech, freqs,
                       tables, fo_in, fx_in, to_in, tx_in, carry_out, p);
      break;
    case 2:
      launch_voxels<2>(l, s, ds, te, ne, b, valid, sarea, theta, mech, freqs,
                       tables, fo_in, fx_in, to_in, tx_in, carry_out, p);
      break;
    case 4:
      launch_voxels<4>(l, s, ds, te, ne, b, valid, sarea, theta, mech, freqs,
                       tables, fo_in, fx_in, to_in, tx_in, carry_out, p);
      break;
    default:
      launch_voxels<8>(l, s, ds, te, ne, b, valid, sarea, theta, mech, freqs,
                       tables, fo_in, fx_in, to_in, tx_in, carry_out, p);
  }
  return static_cast<int>(cudaGetLastError());
}

// Count what rgrff_fold_records does with one segment's records, called
// with the same recs, prev_in and p: add the records it steps from to
// counts[0] and those it takes to counts[1] (two int64 device counters).
extern "C" int rgrff_fold_counts(const void* recs, const void* prev_in,
                                 void* counts, const FoldParams* p,
                                 void* stream) {
  if (p == nullptr || p->n_rays < 0 || p->n_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p->n_rays == 0) return 0;
  const unsigned grid = static_cast<unsigned>(
      (int64_t(p->n_rays) * kCountGroup + kThreads - 1) / kThreads);
  fold_counts_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(recs), static_cast<const float*>(prev_in),
      static_cast<unsigned long long*>(counts), *p);
  return static_cast<int>(cudaGetLastError());
}
