// Generic pair sweep over the sorted-tile layout, written for Hopper (sm_90a).
//
// pair_sweep (asph_pair_sweep) replaces
//   adaptive_sph_tpu/ops/pallas_sweeps.py::run_sweep -> _sweep_kernel.
//   For every query slot i it reduces an op's n_out per-pair values over the
//   pairs (i, j) of the tile walk with |x_ij| < scale * h_ij (h_ij =
//   max((h_i + h_j) / 2, 1e-6), both h > 0, self pair included) and the op's
//   own mask, by sum or by max from the op's fill (the ops: COUNT, the
//   EmptyAngle normal and cone, the level wavefront and smoothing, the four
//   partner-matching passes, the classic branch's DENSITY sum m_j W_ij, the
//   viscosity acceleration after the divergence solve in its ApproxLaplace
//   and WCSPH variants, IISPH2's Omega sum m_j dW/dH, the distribution h
//   estimators' sums W_ij and V_j W_ij, the constant-field diagnostic, the
//   range-limited cone and wavefront of the FromDistribution estimators,
//   CenterDiff's four sums, the neighbourhood constraint's fringe count,
//   check_aii's divergence in both discretizations, and the sweep-only
//   step's ops: prep (the six a_ii sums and the first kick's viscosity,
//   ApproxLaplace, WCSPH or none), aii_sums, the pressure acceleration
//   accel and the divergence div in both discretizations).
//   Inputs: statics (C, 4)
//   float32 [x, y, h, mass] and dyn (C, D) float32, both in sorted order;
//   output (C, n_out) float32.
//
//   Structure: K1's walk, csrc/tile_walk.cuh. One warp per query row (two
//   for a long one); the lanes test 32 consecutive candidate slots of the
//   tile's window ranges at a time, level by level. In-radius lanes load the candidate's mass
//   and the op's D dyn channels and emit the op's values; sums are added in
//   slot order (ordered_sum: the set lanes one by one, lowest first), while
//   counts (0/1 values, exact in any order) and maxima fold per lane and
//   then across the warp. Up to 8 accumulators and 8 dyn channels per
//   query. The op is a compile-time functor (template <int OP>) plus a
//   by-value SweepParams.
//
//   Every float operation that feeds a decision (the radius mask, the
//   merge/share distance mask, the cone test, the mass check) and every
//   accumulation is written with __fmul_rn / __fadd_rn / __fsub_rn /
//   __fdiv_rn / __fsqrt_rn, so nvcc contracts nothing on its own: the kernel
//   performs the plain PyTorch version's operations in the same order (a
//   row's values are added in walk order in both), and both select the same
//   pairs and give the same counts and maxima. The fused multiply-adds are
//   explicit, where the JAX reference's sweep has them on the CPU: squared
//   distances are __fmaf_rn(dx, dx, dy * dy), and the spline's inner pieces
//   (cubic, cubic_deriv) contract as ops/kernels.py describes. The
//   sweep-only step's ops take the reference sweep's compiled rounding
//   further (probed with isolated pairs, one pair per row, and bit-equal to
//   it per pair): the gradient factor with one division (gmag1), and
//   |grad W|^2, the dot products and r^2 + c h^2 as FMAs; the older ops keep
//   the rounding their fixtures and the long runs were built on.
//
//   Cost on the H100: the function needs only the pairs inside the radius
//   and one read of each table (its bound, computed by chip_smoke.py, is set
//   by those bytes), but the walk also tests every candidate of the tile's
//   windows, ~17x as many at the default dam break's extended range, each
//   ~8 float32 operations: the warp per row spreads every row's candidates
//   over 32 lanes, and the long rows are split in two (tile_walk.cuh).
//   Registers per thread (ptxas -v for sm_90a, logged by chip_smoke.py phase
//   1): 39-64; the adapt_cnt0, DENSITY, omega, constant_field, centerdiff,
//   check_aii and prep (ApproxLaplace, WCSPH) functors spill 12, 32, 8, 8,
//   16, 28, 12 and 16 B (stored). A functor
//   gets the candidate's whole statics row [x, y, h, m] (CenterDiff reads
//   x and y, the fringe count h).
//
// Returns cudaGetLastError() (0 on success); cudaErrorInvalidValue when the
// op id, D or n_out do not match. Launches on the given stream, allocates
// nothing, does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_walk.cuh"

namespace {

constexpr float NEG_BIG = -3.0e38f;
// 7 * pi rounded once to float32, as the plain version computes it
constexpr float SEVEN_PI = static_cast<float>(7.0 * 3.141592653589793);

// class codes of the size classification (models/state.py)
constexpr float SIZE_TOO_SMALL = 0.0f, SIZE_SMALL = 1.0f, SIZE_OPTIMAL = 2.0f,
                SIZE_LARGE = 3.0f, SIZE_TOO_LARGE = 4.0f;
constexpr float FACTOR_LARGE = 1.1f;

}  // namespace

struct SweepParams {
  float inv_rest;   // f32(1 / f32(rest_density))
  float cone_thr;   // f32(cos 50 deg)
  float max_dist;   // max_{merge,share}_distance
  float mass_base;  // f32(mass_base)
  int merge;        // 1: merge rules, 0: share rules
  int allow_optimal;
  int allow_size_difference;
  int allow_too_small;
  float visc;       // nu (ApproxLaplace) or f32(2 nu) (WCSPH)
  float max_range;  // f32(maximum_range): the level-estimation range factor
  float inv_pi;     // f32(1 / f32(pi))
};

namespace {

enum SweepOpId {
  OP_COUNT = 0, OP_NORMAL = 1, OP_CONE = 2, OP_WAVEFRONT = 3, OP_SMOOTH = 4,
  OP_ADAPT_CNT0 = 5, OP_ADAPT_CNT1 = 6, OP_ADAPT_EDGE = 7, OP_DENSITY = 8,
  OP_VISC_LAPLACE = 9, OP_VISC_WCSPH = 10, OP_OMEGA = 11, OP_H_W_SUM = 12, OP_H_VW_SUM = 13,
  OP_CONSTANT_FIELD = 14, OP_CONE_RANGE = 15, OP_WAVEFRONT_RANGE = 16, OP_CENTERDIFF = 17,
  OP_FRINGE_COUNT = 18, OP_CHECK_AII = 19, OP_CHECK_AII_W2020 = 20, OP_PREP_LAPLACE = 21,
  OP_PREP_WCSPH = 22, OP_PREP_XSPH = 23, OP_AII_SUMS = 24, OP_ACCEL = 25, OP_DIV = 26,
  OP_DIV_W2020 = 27
};

// the WCSPH viscosity's speed of sound
constexpr float SPEED_OF_SOUND = 88.0f;
// 40 / (7 pi) and -2 times it, rounded once to float32, as the plain
// version's dW/dH takes them
constexpr float DWDH_C = static_cast<float>(40.0 / (7.0 * 3.141592653589793));
constexpr float DWDH_C2 = static_cast<float>(40.0 / (7.0 * 3.141592653589793) * -2.0);

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// the un-normalised cubic spline and its derivative, operation for operation
// as ops/kernels.py evaluates them
__device__ __forceinline__ float cubic(float q) {
  const float v = sub(1.0f, q);
  const float qq = mul(q, q);
  const float inner = __fmaf_rn(6.0f, __fmaf_rn(qq, q, -qq), 1.0f);
  const float outer = mul(mul(mul(2.0f, v), v), v);
  return q < 0.5f ? inner : (q < 1.0f ? outer : 0.0f);
}

__device__ __forceinline__ float cubic_deriv(float q) {
  const float v = sub(1.0f, q);
  const float inner = __fmaf_rn(mul(18.0f, q), q, -mul(12.0f, q));
  const float outer = mul(mul(-6.0f, v), v);
  return q < 0.5f ? inner : (q < 1.0f ? outer : 0.0f);
}

__device__ __forceinline__ float norm2d(float h) { return dvd(10.0f, mul(SEVEN_PI, mul(h, h))); }

__device__ __forceinline__ float sq2(float dx, float dy) { return __fmaf_rn(dx, dx, mul(dy, dy)); }

__device__ __forceinline__ float dist(float r2) { return __fsqrt_rn(fmaxf(r2, 1e-30f)); }

__device__ __forceinline__ float kernel_w(float r, float h) {
  return mul(norm2d(h), cubic(dvd(r, mul(2.0f, h))));
}

__device__ __forceinline__ float gmag(float r, float h) {
  const float two_h = mul(2.0f, h);
  const float q = dvd(r, two_h);
  const float mag = dvd(mul(norm2d(h), cubic_deriv(q)), two_h);
  return q > 1.0e-5f ? dvd(mag, r) : 0.0f;
}

// gmag as the reference's compiled sweep rounds it: XLA's simplifier turns
// (norm W'(q) / 2h) / r into norm W'(q) / (2h r), one division (the
// sweep-only step's ops)
__device__ __forceinline__ float gmag1(float r, float h) {
  const float two_h = mul(2.0f, h);
  const float q = dvd(r, two_h);
  return q > 1.0e-5f ? dvd(mul(norm2d(h), cubic_deriv(q)), mul(two_h, r)) : 0.0f;
}

struct Geo {
  float dx, dy, r2, h_ij;
};

// receiver_ok of models/adaptivity.py: may a particle of class rc and mass
// r_mass receive from a donor of mass d_mass?
__device__ __forceinline__ bool receiver_ok(float d_mass, float rc, float r_mass,
                                            const SweepParams& p) {
  if (p.merge) {
    bool bad = rc == SIZE_LARGE || rc == SIZE_TOO_LARGE;
    if (!p.allow_optimal) bad = bad || rc == SIZE_OPTIMAL;
    bool ok = !bad;
    if (p.allow_size_difference) ok = ok || r_mass > mul(5.0f, d_mass);
    return ok;
  }
  bool ok = rc == SIZE_SMALL;
  if (p.allow_too_small) ok = ok || rc == SIZE_TOO_SMALL;
  if (p.allow_optimal) ok = ok || rc == SIZE_OPTIMAL;
  return ok;
}

// adapt dyn channels: 0 cls, 1 target, 2 dropped, 3 fidx, 4 donor, 5 cnt0, 6 cand
__device__ __forceinline__ bool elig_base(float d_mass, const float* d, float r_mass,
                                          const float* r, const SweepParams& p) {
  return d[4] > 0.5f && d[3] != r[3] && receiver_ok(d_mass, r[0], r_mass, p);
}

__device__ __forceinline__ bool elig_full(float d_mass, const float* d, float r_mass,
                                          const float* r, const SweepParams& p) {
  const float new_mass_r = add(r_mass, dvd(d[2], d[5]));
  const bool mass_ok = new_mass_r < mul(r[1], FACTOR_LARGE) && new_mass_r <= p.mass_base;
  return elig_base(d_mass, d, r_mass, r, p) && mass_ok;
}

// One functor per op: NOUT outputs, D dyn channels, MAX (else sum), FILL
// (max start), NEAR (the merge/share distance mask r2 <= (max_dist h_ij)^2),
// INTEGER (every value is 0 or 1: the sum is exact in any order).
template <int OP>
struct Op;

template <>
struct Op<OP_COUNT> {
  static constexpr int NOUT = 1, D = 0;
  static constexpr bool MAX = false, NEAR = false, INTEGER = true;
  static constexpr float FILL = 0.0f;
  __device__ static void emit(const Geo&, float, const float*, const float*,
                              const float*, const SweepParams&, float* e) {
    e[0] = 1.0f;
  }
};

template <>
struct Op<OP_NORMAL> {  // EmptyAngle normal: -(m_i / rho0) grad W
  static constexpr int NOUT = 2, D = 0;
  static constexpr bool MAX = false, NEAR = false, INTEGER = false;
  static constexpr float FILL = 0.0f;
  __device__ static void emit(const Geo& g, float qm, const float*, const float*, const float*,
                              const SweepParams& p, float* e) {
    const float coef = -mul(qm, p.inv_rest);
    const float gm = gmag(dist(g.r2), g.h_ij);
    e[0] = mul(coef, mul(gm, g.dx));
    e[1] = mul(coef, mul(gm, g.dy));
  }
};

template <>
struct Op<OP_CONE> {  // dyn: unx, uny of the query; 1 if j lies in the 50-degree cone
  static constexpr int NOUT = 1, D = 2;
  static constexpr bool MAX = true, NEAR = false, INTEGER = false;
  static constexpr float FILL = 0.0f;
  __device__ static void emit(const Geo& g, float, const float* qd, const float*, const float*,
                              const SweepParams& p, float* e) {
    const float d = dvd(sub(mul(-g.dx, qd[0]), mul(g.dy, qd[1])), add(dist(g.r2), 1e-6f));
    e[0] = d > p.cone_thr ? 1.0f : 0.0f;
  }
};

template <>
struct Op<OP_WAVEFRONT> {  // dyn: lvl, has; max_j has_j ? lvl_j - r : NEG_BIG
  static constexpr int NOUT = 1, D = 2;
  static constexpr bool MAX = true, NEAR = false, INTEGER = false;
  static constexpr float FILL = NEG_BIG;
  __device__ static void emit(const Geo& g, float, const float*, const float*, const float* cd,
                              const SweepParams&, float* e) {
    e[0] = cd[1] > 0.5f ? sub(cd[0], dist(g.r2)) : NEG_BIG;
  }
};

template <>
struct Op<OP_SMOOTH> {  // dyn: rho, dist, xnew, ynew; W at the advected positions
  static constexpr int NOUT = 2, D = 4;
  static constexpr bool MAX = false, NEAR = false, INTEGER = false;
  static constexpr float FILL = 0.0f;
  __device__ static void emit(const Geo& g, float, const float* qd, const float* cs,
                              const float* cd, const SweepParams&, float* e) {
    const float cm = cs[3];
    const float dxn = sub(qd[2], cd[2]);
    const float dyn = sub(qd[3], cd[3]);
    const float w = kernel_w(dist(sq2(dxn, dyn)), g.h_ij);
    const float vw = mul(dvd(cm, fmaxf(cd[0], 1e-30f)), w);
    e[0] = mul(vw, cd[1]);
    e[1] = vw;
  }
};

template <>
struct Op<OP_ADAPT_CNT0> {  // query = donor, candidate = receiver
  static constexpr int NOUT = 1, D = 5;
  static constexpr bool MAX = false, NEAR = true, INTEGER = true;
  static constexpr float FILL = 0.0f;
  __device__ static void emit(const Geo&, float qm, const float* qd, const float* cs,
                              const float* cd, const SweepParams& p, float* e) {
    const float cm = cs[3];
    e[0] = elig_base(qm, qd, cm, cd, p) ? 1.0f : 0.0f;
  }
};

template <>
struct Op<OP_ADAPT_CNT1> {  // query = donor, candidate = receiver
  static constexpr int NOUT = 1, D = 6;
  static constexpr bool MAX = false, NEAR = true, INTEGER = true;
  static constexpr float FILL = 0.0f;
  __device__ static void emit(const Geo&, float qm, const float* qd, const float* cs,
                              const float* cd, const SweepParams& p, float* e) {
    const float cm = cs[3];
    e[0] = elig_full(qm, qd, cm, cd, p) ? 1.0f : 0.0f;
  }
};

template <>
struct Op<OP_ADAPT_EDGE> {  // query = receiver, candidate = claiming donor; max of -index
  static constexpr int NOUT = 1, D = 7;
  static constexpr bool MAX = true, NEAR = true, INTEGER = false;
  static constexpr float FILL = NEG_BIG;
  __device__ static void emit(const Geo&, float qm, const float* qd, const float* cs,
                              const float* cd, const SweepParams& p, float* e) {
    const float cm = cs[3];
    e[0] = (cd[6] > 0.5f && elig_full(cm, cd, qm, qd, p)) ? -cd[3] : NEG_BIG;
  }
};

template <>
struct Op<OP_DENSITY> {  // fluid density sum m_j W_ij
  static constexpr int NOUT = 1, D = 0;
  static constexpr bool MAX = false, NEAR = false, INTEGER = false;
  static constexpr float FILL = 0.0f;
  __device__ static void emit(const Geo& g, float, const float*, const float* cs, const float*,
                              const SweepParams&, float* e) {
    const float cm = cs[3];
    e[0] = mul(cm, kernel_w(dist(g.r2), g.h_ij));
  }
};

// the viscosity pair terms over dyn (rho, vx, vy): the pair's x_ij . v_ij,
// and the attracting pairs' coefficient times grad W
__device__ __forceinline__ float visc_dot(const Geo& g, const float* qd, const float* cd) {
  return add(mul(g.dx, sub(qd[1], cd[1])), mul(g.dy, sub(qd[2], cd[2])));
}

__device__ __forceinline__ void visc_emit(const Geo& g, float coef, float* e) {
  const float gm = gmag(dist(g.r2), g.h_ij);
  e[0] = mul(coef, mul(gm, g.dx));
  e[1] = mul(coef, mul(gm, g.dy));
}

template <>
struct Op<OP_VISC_LAPLACE> {  // nu m_j 2(D+2) dot / (r2 + 0.01 h^2) / rho_ij grad W
  static constexpr int NOUT = 2, D = 3;
  static constexpr bool MAX = false, NEAR = false, INTEGER = false;
  static constexpr float FILL = 0.0f;
  __device__ static void emit(const Geo& g, float, const float* qd, const float* cs,
                              const float* cd, const SweepParams& p, float* e) {
    const float cm = cs[3];
    const float dot = visc_dot(g, qd, cd);
    const float rho_ij = fmaxf(mul(add(qd[0], cd[0]), 0.5f), 1e-30f);
    const float den = add(g.r2, mul(mul(0.01f, g.h_ij), g.h_ij));
    const float coef = mul(mul(p.visc, cm), dvd(dvd(mul(8.0f, dot), den), rho_ij));
    visc_emit(g, dot < 0.0f ? coef : 0.0f, e);
  }
};

template <>
struct Op<OP_VISC_WCSPH> {  // -m_j pi_ab grad W, pi_ab = -2 nu h_ij c dot / (rho_i + rho_j) / ...
  static constexpr int NOUT = 2, D = 3;
  static constexpr bool MAX = false, NEAR = false, INTEGER = false;
  static constexpr float FILL = 0.0f;
  __device__ static void emit(const Geo& g, float, const float* qd, const float* cs,
                              const float* cd, const SweepParams& p, float* e) {
    const float cm = cs[3];
    const float dot = visc_dot(g, qd, cd);
    const float vt =
        dvd(mul(mul(p.visc, g.h_ij), SPEED_OF_SOUND), fmaxf(add(qd[0], cd[0]), 1e-30f));
    const float pi_ab = dvd(mul(-vt, dot), add(g.r2, mul(mul(0.001f, g.h_ij), g.h_ij)));
    visc_emit(g, dot < 0.0f ? mul(-cm, pi_ab) : 0.0f, e);
  }
};

template <>
struct Op<OP_OMEGA> {  // m_j dW/dH (r, H = 2 h_ij)
  static constexpr int NOUT = 1, D = 0;
  static constexpr bool MAX = false, NEAR = false, INTEGER = false;
  static constexpr float FILL = 0.0f;
  __device__ static void emit(const Geo& g, float, const float*, const float* cs, const float*,
                              const SweepParams&, float* e) {
    const float cm = cs[3];
    const float d = dist(g.r2);
    const float H = mul(g.h_ij, 2.0f);
    const float q = dvd(d, H);
    const float hh = mul(H, H);
    const float t1 = mul(dvd(DWDH_C2, mul(hh, H)), cubic(q));
    const float t2 = mul(mul(dvd(DWDH_C, hh), cubic_deriv(q)), dvd(-d, hh));
    e[0] = mul(cm, add(t1, t2));
  }
};

template <>
struct Op<OP_H_W_SUM> {  // sum_j W_ij (the distribution h estimators)
  static constexpr int NOUT = 1, D = 0;
  static constexpr bool MAX = false, NEAR = false, INTEGER = false;
  static constexpr float FILL = 0.0f;
  __device__ static void emit(const Geo& g, float, const float*, const float*, const float*,
                              const SweepParams&, float* e) {
    e[0] = kernel_w(dist(g.r2), g.h_ij);
  }
};

template <>
struct Op<OP_H_VW_SUM> {  // sum_j (m_j / rho0) W_ij (FromDistribution2)
  static constexpr int NOUT = 1, D = 0;
  static constexpr bool MAX = false, NEAR = false, INTEGER = false;
  static constexpr float FILL = 0.0f;
  __device__ static void emit(const Geo& g, float, const float*, const float* cs, const float*,
                              const SweepParams& p, float* e) {
    e[0] = mul(mul(cs[3], p.inv_rest), kernel_w(dist(g.r2), g.h_ij));
  }
};

template <>
struct Op<OP_CONSTANT_FIELD> {  // dyn: rho; sum_j m_j / rho_j W_ij
  static constexpr int NOUT = 1, D = 1;
  static constexpr bool MAX = false, NEAR = false, INTEGER = false;
  static constexpr float FILL = 0.0f;
  __device__ static void emit(const Geo& g, float, const float*, const float* cs,
                              const float* cd, const SweepParams&, float* e) {
    e[0] = mul(dvd(cs[3], fmaxf(cd[0], 1e-30f)), kernel_w(dist(g.r2), g.h_ij));
  }
};

// the pair lies in the query's level-estimation range: r <= R(m_i / rho0) *
// maximum_range, R(V) = sqrt(V / pi) the radius of the circle of area V
__device__ __forceinline__ bool range_ok(float r, float qm, const SweepParams& p) {
  const float radius = __fsqrt_rn(mul(mul(qm, p.inv_rest), p.inv_pi));
  return r <= mul(radius, p.max_range);
}

template <>
struct Op<OP_CONE_RANGE> {  // the cone scan over the pairs in the query's range
  static constexpr int NOUT = 1, D = 2;
  static constexpr bool MAX = true, NEAR = false, INTEGER = false;
  static constexpr float FILL = 0.0f;
  __device__ static void emit(const Geo& g, float qm, const float* qd, const float*,
                              const float*, const SweepParams& p, float* e) {
    const float r = dist(g.r2);
    const float d = dvd(sub(mul(-g.dx, qd[0]), mul(g.dy, qd[1])), add(r, 1e-6f));
    e[0] = (d > p.cone_thr && range_ok(r, qm, p)) ? 1.0f : 0.0f;
  }
};

template <>
struct Op<OP_WAVEFRONT_RANGE> {  // the wavefront over the pairs in the query's range
  static constexpr int NOUT = 1, D = 2;
  static constexpr bool MAX = true, NEAR = false, INTEGER = false;
  static constexpr float FILL = NEG_BIG;
  __device__ static void emit(const Geo& g, float qm, const float*, const float*,
                              const float* cd, const SweepParams& p, float* e) {
    const float r = dist(g.r2);
    e[0] = (cd[1] > 0.5f && range_ok(r, qm, p)) ? sub(cd[0], r) : NEG_BIG;
  }
};

template <>
struct Op<OP_CENTERDIFF> {  // [V_j W, V_j W x_j, V_j W y_j, V_j W R(V_j)], V_j = m_j / rho0
  static constexpr int NOUT = 4, D = 0;
  static constexpr bool MAX = false, NEAR = false, INTEGER = false;
  static constexpr float FILL = 0.0f;
  __device__ static void emit(const Geo& g, float, const float*, const float* cs, const float*,
                              const SweepParams& p, float* e) {
    const float vol = mul(cs[3], p.inv_rest);
    const float r_j = __fsqrt_rn(mul(vol, p.inv_pi));
    const float wv = mul(kernel_w(dist(g.r2), g.h_ij), vol);
    e[0] = wv;
    e[1] = mul(wv, cs[0]);
    e[2] = mul(wv, cs[1]);
    e[3] = mul(wv, r_j);
  }
};

template <>
struct Op<OP_FRINGE_COUNT> {  // dyn: t; #{j : 2 r_ij - 2 h_j > t_i}
  static constexpr int NOUT = 1, D = 1;
  static constexpr bool MAX = false, NEAR = false, INTEGER = true;
  static constexpr float FILL = 0.0f;
  __device__ static void emit(const Geo& g, float, const float* qd, const float* cs,
                              const float*, const SweepParams&, float* e) {
    const float f = sub(mul(2.0f, dist(g.r2)), mul(cs[2], 2.0f));
    e[0] = f > qd[0] ? 1.0f : 0.0f;
  }
};

// check_aii over dyn (rho, ax, ay): w_j ((m_i / rho_i^2) grad W - a_i) . grad W,
// w_j = m_j / rho_j under Winchenbach2020 (W2020), else m_j
template <bool W2020>
struct CheckAii {
  static constexpr int NOUT = 1, D = 3;
  static constexpr bool MAX = false, NEAR = false, INTEGER = false;
  static constexpr float FILL = 0.0f;
  __device__ static void emit(const Geo& g, float qm, const float* qd, const float* cs,
                              const float* cd, const SweepParams&, float* e) {
    const float coef = dvd(qm, fmaxf(mul(qd[0], qd[0]), 1e-30f));
    const float gm = gmag(dist(g.r2), g.h_ij);
    const float gx = mul(gm, g.dx), gy = mul(gm, g.dy);
    const float d = add(mul(sub(mul(coef, gx), qd[1]), gx), mul(sub(mul(coef, gy), qd[2]), gy));
    const float m = W2020 ? dvd(cs[3], fmaxf(cd[0], 1e-30f)) : cs[3];
    e[0] = mul(m, d);
  }
};

template <>
struct Op<OP_CHECK_AII> : CheckAii<false> {};

template <>
struct Op<OP_CHECK_AII_W2020> : CheckAii<true> {};

// the first kick's viscosity pair terms over dyn (rho, vx, vy) in prep: the
// attracting pairs' coefficient (0 for the others) of grad W, rounded as
// XLA's CPU backend compiles the reference's prep sweep: x_ij . v_ij =
// fma(dx, dvx, dy dvy), r^2 + c h^2 = fma(c h, h, r^2), and ApproxLaplace's
// two divisions as one.
// WCSPH (WCSPH = true): -m_j pi_ab, pi_ab = -(2 nu h_ij c / (rho_i + rho_j))
// dot / (r^2 + 0.001 h^2), c = SPEED_OF_SOUND, p.visc = f32(2 nu);
// ApproxLaplace: nu m_j 2(D+2) dot / ((r^2 + 0.01 h^2) rho_ij), rho_ij the
// mean density, p.visc = nu
template <bool WCSPH>
__device__ __forceinline__ float visc_coef(const Geo& g, float cm, const float* qd,
                                           const float* cd, const SweepParams& p) {
  const float dot = __fmaf_rn(g.dx, sub(qd[1], cd[1]), mul(g.dy, sub(qd[2], cd[2])));
  float coef;
  if (WCSPH) {
    const float vt =
        dvd(mul(mul(p.visc, g.h_ij), SPEED_OF_SOUND), fmaxf(add(qd[0], cd[0]), 1e-30f));
    const float pi_ab = dvd(mul(-vt, dot), __fmaf_rn(mul(0.001f, g.h_ij), g.h_ij, g.r2));
    coef = mul(-cm, pi_ab);
  } else {
    const float rho_ij = fmaxf(mul(add(qd[0], cd[0]), 0.5f), 1e-30f);
    const float den = __fmaf_rn(mul(0.01f, g.h_ij), g.h_ij, g.r2);
    coef = mul(mul(p.visc, cm), dvd(mul(8.0f, dot), mul(den, rho_ij)));
  }
  return dot < 0.0f ? coef : 0.0f;
}

// The sweep-only step's ops (the tile step without a pair list): the a_ii
// sums, the first kick's viscosity, and the pressure solves' two products.

// grad W_ij = gmag1 (dx, dy) as (gx, gy)
__device__ __forceinline__ void grad_w(const Geo& g, float& gx, float& gy) {
  const float gm = gmag1(dist(g.r2), g.h_ij);
  gx = mul(gm, g.dx);
  gy = mul(gm, g.dy);
}

// the a_ii fluid sums' pair terms [m_j grad W, m_j |grad W|^2, (m_j / rho_j)
// grad W, (m_j / rho_j) |grad W|^2]; |grad W|^2 = fma(gx, gx, gy * gy), as
// XLA's CPU backend contracts the reference's gx * gx + gy * gy
__device__ __forceinline__ void aii_terms(float cm, float rho_j, float gx, float gy, float* e) {
  const float g2 = __fmaf_rn(gx, gx, mul(gy, gy));
  const float mbr = dvd(cm, fmaxf(rho_j, 1e-30f));
  e[0] = mul(cm, gx);
  e[1] = mul(cm, gy);
  e[2] = mul(cm, g2);
  e[3] = mul(mbr, gx);
  e[4] = mul(mbr, gy);
  e[5] = mul(mbr, g2);
}

// the once-per-step sweep over dyn (rho, vx, vy): the six a_ii sums and the
// first kick's viscosity (VISC: 0 none, the XSPH setting; 1 ApproxLaplace;
// 2 WCSPH), visc_coef's pair terms
template <int VISC>
struct Prep {
  static constexpr int NOUT = 8, D = 3;
  static constexpr bool MAX = false, NEAR = false, INTEGER = false;
  static constexpr float FILL = 0.0f;
  __device__ static void emit(const Geo& g, float, const float* qd, const float* cs,
                              const float* cd, const SweepParams& p, float* e) {
    const float cm = cs[3];
    float gx, gy;
    grad_w(g, gx, gy);
    aii_terms(cm, cd[0], gx, gy, e);
    if (VISC != 0) {
      const float coef = visc_coef<VISC == 2>(g, cm, qd, cd, p);
      e[6] = mul(coef, gx);
      e[7] = mul(coef, gy);
    } else {
      e[6] = e[7] = 0.0f;
    }
  }
};

template <>
struct Op<OP_PREP_XSPH> : Prep<0> {};

template <>
struct Op<OP_PREP_LAPLACE> : Prep<1> {};

template <>
struct Op<OP_PREP_WCSPH> : Prep<2> {};

template <>
struct Op<OP_AII_SUMS> {  // dyn: rho; the six a_ii sums alone
  static constexpr int NOUT = 6, D = 1;
  static constexpr bool MAX = false, NEAR = false, INTEGER = false;
  static constexpr float FILL = 0.0f;
  __device__ static void emit(const Geo& g, float, const float*, const float* cs,
                              const float* cd, const SweepParams&, float* e) {
    float gx, gy;
    grad_w(g, gx, gy);
    aii_terms(cs[3], cd[0], gx, gy, e);
  }
};

template <>
struct Op<OP_ACCEL> {  // dyn: rho, p; -m_j (p_i / rho_i^2 + p_j / rho_j^2) grad W
  static constexpr int NOUT = 2, D = 2;
  static constexpr bool MAX = false, NEAR = false, INTEGER = false;
  static constexpr float FILL = 0.0f;
  __device__ static void emit(const Geo& g, float, const float* qd, const float* cs,
                              const float* cd, const SweepParams&, float* e) {
    const float term = add(dvd(qd[1], fmaxf(mul(qd[0], qd[0]), 1e-30f)),
                           dvd(cd[1], fmaxf(mul(cd[0], cd[0]), 1e-30f)));
    const float coef = mul(-cs[3], term);
    float gx, gy;
    grad_w(g, gx, gy);
    e[0] = mul(coef, gx);
    e[1] = mul(coef, gy);
  }
};

// the divergence's fluid sum over dyn (rho, qx, qy): w_j (q_j - q_i) . grad W,
// w_j = m_j / rho_j under Winchenbach2020 (W2020), else m_j; the dot product
// fma(dqx, gx, dqy * gy), as XLA's CPU backend contracts the reference's
template <bool W2020>
struct Div {
  static constexpr int NOUT = 1, D = 3;
  static constexpr bool MAX = false, NEAR = false, INTEGER = false;
  static constexpr float FILL = 0.0f;
  __device__ static void emit(const Geo& g, float, const float* qd, const float* cs,
                              const float* cd, const SweepParams&, float* e) {
    float gx, gy;
    grad_w(g, gx, gy);
    const float dq_dot = __fmaf_rn(sub(cd[1], qd[1]), gx, mul(sub(cd[2], qd[2]), gy));
    const float m = W2020 ? dvd(cs[3], fmaxf(cd[0], 1e-30f)) : cs[3];
    e[0] = mul(m, dq_dot);
  }
};

template <>
struct Op<OP_DIV> : Div<false> {};

template <>
struct Op<OP_DIV_W2020> : Div<true> {};

// One query row of a sweep on the tile walk (tile_walk.cuh)
template <int OP>
struct SweepRow {
  using O = Op<OP>;
  static constexpr int D = O::D, NOUT = O::NOUT;
  // sums of real values keep the plain version's order; counts and maxima
  // fold per lane, then across the warp (finish)
  static constexpr bool ORDERED = !O::MAX && !O::INTEGER;
  using Geo = ::Geo;

  const float* statics;
  const float* dyn;
  float scale;
  SweepParams prm;
  float qx, qy, qh, qm;
  float qd[D > 0 ? D : 1];
  float acc[NOUT];

  __device__ __forceinline__ bool test(float cx, float cy, float ch, Geo& g) const {
    g.h_ij = fmaxf(mul(0.5f, add(qh, ch)), 1e-6f);
    g.dx = sub(qx, cx);
    g.dy = sub(qy, cy);
    g.r2 = sq2(g.dx, g.dy);
    const float rad = mul(scale, g.h_ij);
    if (!(g.r2 < mul(rad, rad) && ch > 0.0f)) return false;
    if (O::NEAR) {
      const float md = mul(prm.max_dist, g.h_ij);
      return g.r2 <= mul(md, md);
    }
    return true;
  }

  __device__ __forceinline__ void take(int cj, const Geo& g, bool in, unsigned m) {
    float e[NOUT] = {};
    if (in) {
      float cd[D > 0 ? D : 1];
#pragma unroll
      for (int d = 0; d < D; ++d) cd[d] = dyn[(size_t)cj * D + d];
      O::emit(g, qm, qd, statics + 4 * (size_t)cj, cd, prm, e);
      if (!ORDERED) {
#pragma unroll
        for (int o = 0; o < NOUT; ++o) acc[o] = O::MAX ? fmaxf(acc[o], e[o]) : add(acc[o], e[o]);
      }
    }
    if (ORDERED) tile_walk::ordered_sum<NOUT>(acc, e, m);
  }

  __device__ __forceinline__ void finish() {
    if (ORDERED) return;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int o = 0; o < NOUT; ++o) {
        const float v = __shfl_xor_sync(tile_walk::FULL, acc[o], off);
        acc[o] = O::MAX ? fmaxf(acc[o], v) : add(acc[o], v);
      }
    }
  }
};

template <int OP>
__global__ void __launch_bounds__(tile_walk::BLOCK)
    pair_sweep_kernel(const int* __restrict__ cell_starts, const int* __restrict__ wm, int nl,
                      int tq, int C, const float* __restrict__ statics,
                      const float* __restrict__ dyn, float scale, SweepParams prm,
                      float* __restrict__ out) {
  using Row = SweepRow<OP>;
  using O = typename Row::O;
  constexpr int NOUT = Row::NOUT;
  __shared__ float part[tile_walk::WARPS][NOUT];
  const int q = tile_walk::row();
  const bool valid = q < C;
  const int qs = valid ? q : 0;
  Row b{statics, dyn, scale, prm, statics[4 * (size_t)qs], statics[4 * (size_t)qs + 1],
        statics[4 * (size_t)qs + 2], statics[4 * (size_t)qs + 3]};
#pragma unroll
  for (int d = 0; d < Row::D; ++d) b.qd[d] = dyn[(size_t)qs * Row::D + d];
#pragma unroll
  for (int o = 0; o < NOUT; ++o) b.acc[o] = O::MAX ? O::FILL : 0.0f;
  const int t = q / tq;
  const tile_walk::RowPlan plan =
      tile_walk::plan_row(cell_starts, wm, nl, t, valid && b.qh > 0.0f);
  if (plan.E > plan.A) tile_walk::walk_row<4>(cell_starts, wm, nl, t, plan.A, plan.E, statics, b);
  b.finish();
  // the row's pieces, folded in piece order by its first warp
  const int wi = tile_walk::warp();
  if (tile_walk::lane() == 0) {
#pragma unroll
    for (int o = 0; o < NOUT; ++o) part[wi][o] = b.acc[o];
  }
  __syncthreads();
  if (!valid || tile_walk::piece() != 0 || tile_walk::lane() != 0) return;
#pragma unroll
  for (int o = 0; o < NOUT; ++o) {
    float v = part[wi][o];
    if (plan.split)
      for (int j = 1; j < tile_walk::S; ++j)
        v = O::MAX ? fmaxf(v, part[wi + j][o]) : add(v, part[wi + j][o]);
    out[(size_t)q * NOUT + o] = v;
  }
}

template <int OP>
int launch(const int* cs, const int* wm, int nt, int nl, int tq, const float* statics,
           const float* dyn, int D, float scale, const SweepParams& prm, float* out, int n_out,
           cudaStream_t st) {
  if (D != Op<OP>::D || n_out != Op<OP>::NOUT) return static_cast<int>(cudaErrorInvalidValue);
  const int C = nt * tq;
  if (C == 0) return 0;
  pair_sweep_kernel<OP><<<tile_walk::grid(C), tile_walk::BLOCK, 0, st>>>(
      cs, wm, nl, tq, C, statics, dyn, scale, prm, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int asph_pair_sweep(int op, const int* cell_starts, const int* wm, int nt, int nl, int tq,
                    const float* statics, const float* dyn, int D, float scale, SweepParams prm,
                    float* out, int n_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ASPH_SWEEP_CASE(ID) \
  case ID:                  \
    return launch<ID>(cell_starts, wm, nt, nl, tq, statics, dyn, D, scale, prm, out, n_out, st);
  switch (op) {
    ASPH_SWEEP_CASE(OP_COUNT)
    ASPH_SWEEP_CASE(OP_NORMAL)
    ASPH_SWEEP_CASE(OP_CONE)
    ASPH_SWEEP_CASE(OP_WAVEFRONT)
    ASPH_SWEEP_CASE(OP_SMOOTH)
    ASPH_SWEEP_CASE(OP_ADAPT_CNT0)
    ASPH_SWEEP_CASE(OP_ADAPT_CNT1)
    ASPH_SWEEP_CASE(OP_ADAPT_EDGE)
    ASPH_SWEEP_CASE(OP_DENSITY)
    ASPH_SWEEP_CASE(OP_VISC_LAPLACE)
    ASPH_SWEEP_CASE(OP_VISC_WCSPH)
    ASPH_SWEEP_CASE(OP_OMEGA)
    ASPH_SWEEP_CASE(OP_H_W_SUM)
    ASPH_SWEEP_CASE(OP_H_VW_SUM)
    ASPH_SWEEP_CASE(OP_CONSTANT_FIELD)
    ASPH_SWEEP_CASE(OP_CONE_RANGE)
    ASPH_SWEEP_CASE(OP_WAVEFRONT_RANGE)
    ASPH_SWEEP_CASE(OP_CENTERDIFF)
    ASPH_SWEEP_CASE(OP_FRINGE_COUNT)
    ASPH_SWEEP_CASE(OP_CHECK_AII)
    ASPH_SWEEP_CASE(OP_CHECK_AII_W2020)
    ASPH_SWEEP_CASE(OP_PREP_LAPLACE)
    ASPH_SWEEP_CASE(OP_PREP_WCSPH)
    ASPH_SWEEP_CASE(OP_PREP_XSPH)
    ASPH_SWEEP_CASE(OP_AII_SUMS)
    ASPH_SWEEP_CASE(OP_ACCEL)
    ASPH_SWEEP_CASE(OP_DIV)
    ASPH_SWEEP_CASE(OP_DIV_W2020)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ASPH_SWEEP_CASE
}

}  // extern "C"
