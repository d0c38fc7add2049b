// PERT enumeration kernels for Hopper (sm_90a), forward and backward: the
// fused objective and the unfused enumerated log-likelihood.
//
// Replaces the TPU kernels _fused_fwd_kernel / _fused_bwd_kernel of
// scdna_replication_tools_tpu/ops/enum_kernel.py (:547, :608) in all four
// configurations: dense (pallas_call :741, :766), sparse (:856, :881),
// dense binary (:976, :1002) and sparse binary (:1073, :1100), the
// dense and sparse ones also with a block axis (W stacked fits in one
// launch, the form the pallas_call batching rule gives under jax.vmap in
// infer/svi.py _run_fit_chunk_slab); and the unfused pair _fwd_kernel / _bwd_kernel (:174, :207; pallas_call :444,
// :466).
//
// Per (cell, locus) bin, with pi_t the state-major (P, cells, loci) logits:
//   lp_s  = log_softmax(pi_t[:, bin])_s
//   lse   = logsumexp_{s, r} (lp_s + log Bern(r | phi) + nb(chi = s(1+r)))
//   nb    = lgamma(x + d) - lgamma(d) + d log(1 - lamb),  d = max(mu chi q, 1)
//   out   = lse + x log(lamb) - lgamma(x + 1) + sum_s (etas_s - 1) lp_s
// (sparse: the data term is ew * lp_{eidx}).  The backward recomputes the
// state terms from the inputs and the saved enumeration-only lse and emits
// dmu, dphi and dpi_s = dlp_s - softmax_s * sum_s' dlp_s'.  Binary
// encoding (BINARY): pi_t holds Kb = ceil(log2 P) planes z_k, the logit of
// state s is the sum of its set bits' planes in ascending bit order (state
// 0 has logit 0), and the backward writes dz_k = sum_{s: bit_k(s)=1} dpi_s
// (ascending s) instead of the P dpi planes.
//
// The unfused pair (enum_fwd_kernel / enum_bwd_kernel) takes lp itself:
// log_pi, the CELLS-MAJOR (cells, loci, P) already normalised log-simplex
// of the JAX entry point, with no softmax and no Dirichlet term:
//   ll    = lse + x log(lamb) - lgamma(x + 1)
// and its backward normalises the posterior weights against
// ll - (x log(lamb) - lgamma(x + 1)) and writes dmu, dphi and the
// cells-major dlog_pi_s = sum of the weights of state s.  Both read each
// bin's P consecutive log_pi floats per thread: a bin's floats sit P * 4
// bytes from its neighbour's, so each of a warp's P load instructions
// touches about 32 sectors of the warp's contiguous 32 P floats, which
// the first brings into L1 for the rest.  The backward stages its dlog_pi
// instead: a block of THREADS bins owns one contiguous span of THREADS * P
// floats (1024 P bytes, a multiple of 16), each thread writes its P
// floats to a shared tile and one bulk asynchronous copy (cp.async.bulk,
// the TMA's non-tensor form) writes the span back, where P strided stores
// would each write about 32 partial sectors; the grid's short last block
// stores per thread.  Staging log_pi the same way (a bulk copy on an
// mbarrier, or cooperative 16-B cp.async copies, per block or per warp)
// made both kernels slower on an H100 than the per-thread loads, which
// cost the issue-bound sweep nothing it could win back (PERF.md).  No
// transpose is needed on either side and the bytes moved stay each
// operand's own.
//
// What bounds it on this card: each bin reads 3 + Kp (+ P dense | + 2
// sparse) planes and writes 2 (forward) or 2 + Kp (backward), Kp = P or
// Kb -- 0.07-0.3 ms of HBM traffic at 1000 x 5451 x 13 -- against ~19 NB
// cores of two lgammas each (two more digammas backward) and ~40 exps,
// which is of the same order on the SM's float32 and SFU pipes; the
// binary planes cut the bytes but not the operations, so the binary
// kernels are bound by operations.  Design: one thread per bin over the
// flattened (cells, loci) grid, so every plane is read coalesced along
// loci and nothing touches shared memory; the P logits (expanded from the
// Kb planes in registers under BINARY), the per-state accumulators, the
// Kb dz accumulators and the NB values of the two-pass logsumexp stay in
// registers (the TPU kernel kept 19 VMEM tiles resident instead); the chi
// loop and the bit tables are unrolled at compile time (each distinct
// total CN chi = s(1+r) evaluates its NB core once; enum_lse and
// enum_sweep_bwd hold that loop once for all six kernels).  P is a runtime
// argument up to MAXP; the unrolled loops are guarded by it.  lgamma and
// digamma use the TPU kernel's Stirling series (z >= 1 shifted up by 8),
// so kernel, plain PyTorch version and JAX agree to float32 rounding
// rather than to two libraries' approximations.
//
// The shift is where this card parts from the TPU.  A TPU vector unit has
// no per-lane branch, so its kernel evaluates the 8-step recurrence (a
// product and its log; for digamma also 8 IEEE reciprocals) for every
// argument and discards it with a select wherever z >= 8.  A warp can
// branch, once per bin: it votes on whether any of its 32 bins has an
// lgamma argument below 8 -- x + 1, or delta at chi = 1, the least delta
// (delta grows with chi, and x + delta >= delta for reads >= 0) -- and
// runs the chi sweep either in the TPU's select form (SHIFT) or with the
// series alone, which then gives every lane the value the select keeps.
// On fitted operands delta = mu chi q is far above 8 for every chi >= 1
// (tens of reads per copy), so nearly every warp takes the short sweep:
// one reciprocal and one log per argument, branch-free.  A vote per lgamma
// call instead reads the dense backward at 1.0 ms on fitted operands on an
// H100 but at 3.2 ms on operands whose warps mix both sides, against
// 2.1 ms for the select form everywhere: each vote and its reconvergence
// point split the unrolled sweep into pieces that no longer overlap
// (PERF.md).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXP = 16;
constexpr int MAXKB = 4;  // ceil(log2 MAXP) binary planes
constexpr int MAXCHI = 2 * MAXP - 1;
constexpr int THREADS = 256;
// every lane of a warp; lanes past the grid's end have exited, and a vote
// counts only the lanes that have not
constexpr unsigned kFullMask = 0xffffffffu;

// constants rounded from double once, as the JAX series rounds its
// Python-float literals
constexpr float kHalfLog2Pi = (float)0.9189385332046727;
constexpr float kC12 = (float)(1.0 / 12.0);
constexpr float kC360 = (float)(-1.0 / 360.0);
constexpr float kC1260 = (float)(1.0 / 1260.0);
constexpr float kC120 = (float)(-1.0 / 120.0);
constexpr float kC252 = (float)(1.0 / 252.0);

// float32 log-Gamma for z >= 1 (ops/enum_kernel.py _lgamma_ge1).  SHIFT:
// the TPU kernel's form, Stirling's series at z + 8 less log(z (z + 1) ...
// (z + 7)) wherever z < 8, by a select.  Without SHIFT, the series at z
// alone: the select's value wherever z >= 8, which the caller guarantees.
template <bool SHIFT>
__device__ __forceinline__ float lgamma_ge1(float z) {
  const float zz = (SHIFT && z < 8.0f) ? z + 8.0f : z;
  const float inv = 1.0f / zz;
  const float inv2 = inv * inv;
  const float series = inv * (kC12 + inv2 * (kC360 + inv2 * kC1260));
  const float st = (zz - 0.5f) * logf(zz) - zz + kHalfLog2Pi + series;
  if (!SHIFT) return st;
  const float zs = fminf(z, 8.0f);
  const float shift_prod = zs * (zs + 1.0f) * (zs + 2.0f) * (zs + 3.0f) *
                           (zs + 4.0f) * (zs + 5.0f) * (zs + 6.0f) *
                           (zs + 7.0f);
  return (z < 8.0f) ? st - logf(shift_prod) : st;
}

// (lgamma(z), digamma(z)) for z >= 1 sharing 1/zz and log(zz)
// (ops/enum_kernel.py _lgamma_digamma_ge1); SHIFT as in lgamma_ge1, where
// the shift also takes 8 reciprocals off digamma
template <bool SHIFT>
__device__ __forceinline__ void lgamma_digamma_ge1(float z, float& lg,
                                                   float& psi) {
  const float zz = (SHIFT && z < 8.0f) ? z + 8.0f : z;
  const float inv = 1.0f / zz;
  const float inv2 = inv * inv;
  const float logzz = logf(zz);
  const float series = inv * (kC12 + inv2 * (kC360 + inv2 * kC1260));
  lg = (zz - 0.5f) * logzz - zz + kHalfLog2Pi + series;
  psi = logzz - 0.5f * inv - inv2 * (kC12 + inv2 * (kC120 + inv2 * kC252));
  if (!SHIFT) return;
  const float zs = fminf(z, 8.0f);
  const float t1 = zs + 1.0f, t2 = zs + 2.0f, t3 = zs + 3.0f;
  const float t4 = zs + 4.0f, t5 = zs + 5.0f, t6 = zs + 6.0f, t7 = zs + 7.0f;
  const float shift_prod = zs * t1 * t2 * t3 * t4 * t5 * t6 * t7;
  const float shift_sum = 1.0f / zs + 1.0f / t1 + 1.0f / t2 + 1.0f / t3 +
                          1.0f / t4 + 1.0f / t5 + 1.0f / t6 + 1.0f / t7;
  lg = (z < 8.0f) ? lg - logf(shift_prod) : lg;
  psi = (z < 8.0f) ? psi - shift_sum : psi;
}

// Kb = ceil(log2 P) for P >= 2, and 1 for P = 1
__host__ __device__ __forceinline__ int binary_width(int P) {
  int kb = 1;
  while ((1 << kb) < P) ++kb;
  return kb;
}

// whether the SHIFT sweep is needed anywhere in the warp: a vote on each
// bin's least lgamma arguments, x + 1 and delta at chi = 1 (delta =
// max(mu chi q, 1) grows with chi, x + delta >= delta, and (float)1 * q
// is q)
__device__ __forceinline__ bool warp_needs_shift(float x, float mui, float q,
                                                 int P) {
  const bool small =
      x + 1.0f < 8.0f || (P > 1 && fmaxf(mui * q, 1.0f) < 8.0f);
  return __any_sync(kFullMask, small);
}

// log-softmax of the bin's P states into lp[] (two passes: max, sum).  The
// state logits are the P loaded planes, or (BINARY) each state's sum of
// its set bits' z planes, ascending, with 0 for state 0.
template <bool BINARY>
__device__ __forceinline__ void log_softmax_bin(const float* __restrict__ pi,
                                                int64_t i, int64_t n, int P,
                                                float (&lp)[MAXP]) {
  if (BINARY) {
    float z[MAXKB] = {};
#pragma unroll
    for (int k = 0; k < MAXKB; ++k)
      if (k == 0 || (1 << k) < P) z[k] = pi[k * n + i];
#pragma unroll
    for (int s = 0; s < MAXP; ++s) {
      if (s >= P) continue;
      float x = 0.0f;
      bool first = true;
#pragma unroll
      for (int k = 0; k < MAXKB; ++k)
        if ((s >> k) & 1) {
          x = first ? z[k] : x + z[k];
          first = false;
        }
      lp[s] = x;
    }
  } else {
#pragma unroll
    for (int s = 0; s < MAXP; ++s)
      if (s < P) lp[s] = pi[s * n + i];
  }
  float m = lp[0];
#pragma unroll
  for (int s = 1; s < MAXP; ++s)
    if (s < P) m = fmaxf(m, lp[s]);
  float z = 0.0f;
#pragma unroll
  for (int s = 0; s < MAXP; ++s)
    if (s < P) z += expf(lp[s] - m);
  const float log_z = m + logf(z);
#pragma unroll
  for (int s = 0; s < MAXP; ++s)
    if (s < P) lp[s] = lp[s] - log_z;
}

// two-pass logsumexp over the bin's (state, rep) pairs, one NB core per
// distinct chi; chi = 0 has delta == 1 and reuses lgx1 = lgamma(x + 1).
// SHIFT: the series' shift by select, as lgamma_ge1; without it the caller
// guarantees every argument >= 8 (warp_needs_shift)
template <bool SHIFT>
__device__ __forceinline__ float enum_lse(float x, float mui, float bern0,
                                          float bern1, float lgx1,
                                          float log1m_lamb, float q,
                                          const float (&lp)[MAXP], int P) {
  float nb[MAXCHI];
  float m = -INFINITY;
#pragma unroll
  for (int chi = 0; chi < MAXCHI; ++chi) {
    const bool has0 = chi < MAXP && chi < P;
    const bool has1 = (chi % 2 == 0) && (chi / 2 < P);
    if (!has0 && !has1) continue;
    float v;
    if (chi == 0) {
      v = lgx1 + log1m_lamb;
    } else {
      const float delta = fmaxf(mui * ((float)chi * q), 1.0f);
      v = lgamma_ge1<SHIFT>(x + delta) - lgamma_ge1<SHIFT>(delta) +
          delta * log1m_lamb;
    }
    nb[chi] = v;
    if (chi < MAXP && has0) m = fmaxf(m, lp[chi < MAXP ? chi : 0] + bern0 + v);
    if (has1) m = fmaxf(m, lp[chi / 2] + bern1 + v);
  }
  float acc = 0.0f;
#pragma unroll
  for (int chi = 0; chi < MAXCHI; ++chi) {
    const bool has0 = chi < MAXP && chi < P;
    const bool has1 = (chi % 2 == 0) && (chi / 2 < P);
    if (chi < MAXP && has0)
      acc = acc + expf(lp[chi < MAXP ? chi : 0] + bern0 + nb[chi] - m);
    if (has1) acc = acc + expf(lp[chi / 2] + bern1 + nb[chi] - m);
  }
  return m + logf(acc);
}

// the backward's chi sweep: each (state, rep) pair's posterior weight
// g exp(lp_s + bern_r + nb - lse), accumulated into dmu, dphi, dlp[s] and
// tot (the fused backward's softmax Jacobian needs the sum; the unfused
// one drops it); SHIFT as in enum_lse
template <bool SHIFT>
__device__ __forceinline__ void enum_sweep_bwd(
    float x, float mui, float g, float lse, float bern0, float bern1,
    float dbern0, float dbern1, float lgx1, float log1m_lamb, float q,
    const float (&lp)[MAXP], int P, float (&dlp)[MAXP], float& tot,
    float& dmu, float& dphi) {
#pragma unroll
  for (int chi = 0; chi < MAXCHI; ++chi) {
    const bool has0 = chi < MAXP && chi < P;
    const bool has1 = (chi % 2 == 0) && (chi / 2 < P);
    if (!has0 && !has1) continue;
    float nbv, dmu_slot = 0.0f;
    if (chi == 0) {
      nbv = lgx1 + log1m_lamb;
    } else {
      const float cq = (float)chi * q;
      const float delta = fmaxf(mui * cq, 1.0f);
      float lg_xd, psi_xd, lg_d, psi_d;
      lgamma_digamma_ge1<SHIFT>(x + delta, lg_xd, psi_xd);
      lgamma_digamma_ge1<SHIFT>(delta, lg_d, psi_d);
      nbv = lg_xd - lg_d + delta * log1m_lamb;
      const float ddelta = psi_xd - psi_d + log1m_lamb;
      // d nb / d mu, gated on the delta > 1 clamp region
      dmu_slot = ddelta * (mui * cq > 1.0f ? 1.0f : 0.0f) * cq;
    }
    if (chi < MAXP && has0) {
      const int s = chi < MAXP ? chi : 0;
      const float gw = g * expf(lp[s] + bern0 + nbv - lse);
      if (chi != 0) dmu = dmu + gw * dmu_slot;
      dphi = dphi + gw * dbern0;
      dlp[s] = dlp[s] + gw;
      tot = tot + gw;
    }
    if (has1) {
      const int s = chi / 2;
      const float gw = g * expf(lp[s] + bern1 + nbv - lse);
      if (chi != 0) dmu = dmu + gw * dmu_slot;
      dphi = dphi + gw * dbern1;
      dlp[s] = dlp[s] + gw;
      tot = tot + gw;
    }
  }
}

// The block axis: fit blockIdx.y of gridDim.y stacked ones.  Its bin
// planes start lane * n into the (lanes, n) operands, its pi planes lane *
// Kp * n into the (lanes, Kp, n) ones, its dense etas lane * P * n in and
// its scalars at scal + 3 * lane.  Every block lies inside one fit, so a
// warp's vote and each bin's arithmetic are a one-fit launch's on that
// fit's operands, bit for bit.  A one-fit launch has lane 0.
template <bool SPARSE, bool BINARY>
__global__ void __launch_bounds__(THREADS) fused_fwd_kernel(
    const float* __restrict__ reads, const float* __restrict__ mu,
    const float* __restrict__ phi, const float* __restrict__ pi,
    const float* __restrict__ etas, const float* __restrict__ eidx,
    const float* __restrict__ ew, const float* __restrict__ scal,
    float* __restrict__ out, float* __restrict__ lse_out, int64_t n, int P) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t bins = (int64_t)blockIdx.y * n;
  reads += bins, mu += bins, phi += bins, out += bins, lse_out += bins;
  pi += bins * (BINARY ? binary_width(P) : P);
  if (SPARSE) eidx += bins, ew += bins;
  else etas += bins * P;
  scal += 3 * blockIdx.y;
  const float log_lamb = scal[0], log1m_lamb = scal[1], q = scal[2];
  const float x = reads[i], mui = mu[i], ph = phi[i];
  const float bern0 = log1pf(-ph), bern1 = logf(ph);

  float lp[MAXP];
  log_softmax_bin<BINARY>(pi, i, n, P, lp);

  // Dirichlet data term sum_s (etas_s - 1) * lp_s
  float lp_acc = 0.0f;
  if (SPARSE) {
    const float ei = eidx[i], w = ew[i];
#pragma unroll
    for (int s = 0; s < MAXP; ++s)
      if (s < P) lp_acc = lp_acc + (ei == (float)s ? w : 0.0f) * lp[s];
  } else {
#pragma unroll
    for (int s = 0; s < MAXP; ++s)
      if (s < P) lp_acc = lp_acc + (etas[s * n + i] - 1.0f) * lp[s];
  }

  float lgx1, lse;
  if (warp_needs_shift(x, mui, q, P)) {
    lgx1 = lgamma_ge1<true>(x + 1.0f);
    lse = enum_lse<true>(x, mui, bern0, bern1, lgx1, log1m_lamb, q, lp, P);
  } else {
    lgx1 = lgamma_ge1<false>(x + 1.0f);
    lse = enum_lse<false>(x, mui, bern0, bern1, lgx1, log1m_lamb, q, lp, P);
  }
  lse_out[i] = lse;
  out[i] = lse + x * log_lamb - lgx1 + lp_acc;
}

template <bool SPARSE, bool BINARY>
__global__ void __launch_bounds__(THREADS) fused_bwd_kernel(
    const float* __restrict__ reads, const float* __restrict__ mu,
    const float* __restrict__ phi, const float* __restrict__ pi,
    const float* __restrict__ etas, const float* __restrict__ eidx,
    const float* __restrict__ ew, const float* __restrict__ scal,
    const float* __restrict__ lse_in, const float* __restrict__ g_in,
    float* __restrict__ dmu_out, float* __restrict__ dphi_out,
    float* __restrict__ dpi_out, int64_t n, int P) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // the block axis (see fused_fwd_kernel)
  const int64_t bins = (int64_t)blockIdx.y * n;
  const int64_t planes = bins * (BINARY ? binary_width(P) : P);
  reads += bins, mu += bins, phi += bins, lse_in += bins, g_in += bins;
  dmu_out += bins, dphi_out += bins, pi += planes, dpi_out += planes;
  if (SPARSE) eidx += bins, ew += bins;
  else etas += bins * P;
  scal += 3 * blockIdx.y;
  const float log1m_lamb = scal[1], q = scal[2];
  const float x = reads[i], mui = mu[i], ph = phi[i];
  const float g = g_in[i], lse = lse_in[i];
  const float bern0 = log1pf(-ph), bern1 = logf(ph);
  const float dbern0 = -1.0f / (1.0f - ph), dbern1 = 1.0f / ph;

  float lp[MAXP];
  log_softmax_bin<BINARY>(pi, i, n, P, lp);

  // each dlog_pi slot starts at its Dirichlet term g * (etas_s - 1)
  float dlp[MAXP];
  float tot = 0.0f;
  if (SPARSE) {
    const float ei = eidx[i], gew = g * ew[i];
#pragma unroll
    for (int s = 0; s < MAXP; ++s)
      if (s < P) {
        dlp[s] = (ei == (float)s) ? gew : 0.0f;
        tot = tot + dlp[s];
      }
  } else {
#pragma unroll
    for (int s = 0; s < MAXP; ++s)
      if (s < P) {
        dlp[s] = g * (etas[s * n + i] - 1.0f);
        tot = tot + dlp[s];
      }
  }

  float dmu = 0.0f, dphi = 0.0f;
  if (warp_needs_shift(x, mui, q, P))
    enum_sweep_bwd<true>(x, mui, g, lse, bern0, bern1, dbern0, dbern1,
                         lgamma_ge1<true>(x + 1.0f), log1m_lamb, q, lp, P,
                         dlp, tot, dmu, dphi);
  else
    enum_sweep_bwd<false>(x, mui, g, lse, bern0, bern1, dbern0, dbern1,
                          lgamma_ge1<false>(x + 1.0f), log1m_lamb, q, lp, P,
                          dlp, tot, dmu, dphi);
  dmu_out[i] = dmu;
  dphi_out[i] = dphi;
  // softmax Jacobian: dpi_s = dlog_pi_s - softmax_s * sum_s' dlog_pi_s'
  if (BINARY) {
    // chained through x_s = sum_{k in bits(s)} z_k: the Kb planes
    // accumulate in registers, in ascending s, and dpi never reaches HBM
    float dz[MAXKB];
#pragma unroll
    for (int k = 0; k < MAXKB; ++k) dz[k] = 0.0f;
#pragma unroll
    for (int s = 0; s < MAXP; ++s) {
      if (s >= P) continue;
      const float dpi_s = dlp[s] - expf(lp[s]) * tot;
#pragma unroll
      for (int k = 0; k < MAXKB; ++k)
        if ((s >> k) & 1) dz[k] = dz[k] + dpi_s;
    }
#pragma unroll
    for (int k = 0; k < MAXKB; ++k)
      if (k == 0 || (1 << k) < P) dpi_out[k * n + i] = dz[k];
  } else {
#pragma unroll
    for (int s = 0; s < MAXP; ++s)
      if (s < P) dpi_out[s * n + i] = dlp[s] - expf(lp[s]) * tot;
  }
}

// unfused forward: ll from the cells-major log_pi as given
__global__ void __launch_bounds__(THREADS) enum_fwd_kernel(
    const float* __restrict__ reads, const float* __restrict__ mu,
    const float* __restrict__ phi, const float* __restrict__ log_pi,
    const float* __restrict__ scal, float* __restrict__ ll_out, int64_t n,
    int P) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float log_lamb = scal[0], log1m_lamb = scal[1], q = scal[2];
  const float x = reads[i], mui = mu[i], ph = phi[i];
  const float bern0 = log1pf(-ph), bern1 = logf(ph);
  const float* row = log_pi + i * P;
  float lp[MAXP];
#pragma unroll
  for (int s = 0; s < MAXP; ++s)
    if (s < P) lp[s] = row[s];
  float lgx1, lse;
  if (warp_needs_shift(x, mui, q, P)) {
    lgx1 = lgamma_ge1<true>(x + 1.0f);
    lse = enum_lse<true>(x, mui, bern0, bern1, lgx1, log1m_lamb, q, lp, P);
  } else {
    lgx1 = lgamma_ge1<false>(x + 1.0f);
    lse = enum_lse<false>(x, mui, bern0, bern1, lgx1, log1m_lamb, q, lp, P);
  }
  ll_out[i] = lse + x * log_lamb - lgx1;
}

// the shared-memory address of p, as the bulk-copy instructions take it
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one thread, after every thread's shared-memory writes, a proxy fence
// (fence.proxy.async) and the block's barrier: the bulk asynchronous copy
// (the TMA's non-tensor form) of `bytes` from shared `src` to global `dst`,
// both 16-B aligned, bytes a multiple of 16; it waits until the copy has
// read the shared memory, which the block's exit releases
__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// unfused backward: the weights normalise against ll less the hoisted
// x log(lamb) - lgamma(x + 1), and dlog_pi_s is state s's weight sum.  A
// full block stages its dlog_pi span: each thread writes its bin's P
// floats to its own slots of a shared tile (stride P words: conflict-free
// at odd P), and one bulk copy writes the block's contiguous THREADS * P
// floats back.  The grid's short last block stores per thread.
__global__ void __launch_bounds__(THREADS) enum_bwd_kernel(
    const float* __restrict__ reads, const float* __restrict__ mu,
    const float* __restrict__ phi, const float* __restrict__ log_pi,
    const float* __restrict__ scal, const float* __restrict__ ll_in,
    const float* __restrict__ g_in, float* __restrict__ dmu_out,
    float* __restrict__ dphi_out, float* __restrict__ dlog_pi_out, int64_t n,
    int P) {
  alignas(16) __shared__ float tile[THREADS * MAXP];
  const int64_t first = (int64_t)blockIdx.x * THREADS;
  const int64_t i = first + threadIdx.x;
  const bool staged = first + THREADS <= n;  // the same for the whole block
  if (i >= n) return;
  const float log_lamb = scal[0], log1m_lamb = scal[1], q = scal[2];
  const float x = reads[i], mui = mu[i], ph = phi[i], g = g_in[i];
  const bool shift = warp_needs_shift(x, mui, q, P);
  const float lgx1 =
      shift ? lgamma_ge1<true>(x + 1.0f) : lgamma_ge1<false>(x + 1.0f);
  const float ll_state = ll_in[i] - (x * log_lamb - lgx1);
  const float bern0 = log1pf(-ph), bern1 = logf(ph);
  const float dbern0 = -1.0f / (1.0f - ph), dbern1 = 1.0f / ph;
  const float* row = log_pi + i * P;
  float lp[MAXP], dlp[MAXP];
#pragma unroll
  for (int s = 0; s < MAXP; ++s)
    if (s < P) {
      lp[s] = row[s];
      dlp[s] = 0.0f;
    }
  float tot = 0.0f, dmu = 0.0f, dphi = 0.0f;
  if (shift)
    enum_sweep_bwd<true>(x, mui, g, ll_state, bern0, bern1, dbern0, dbern1,
                         lgx1, log1m_lamb, q, lp, P, dlp, tot, dmu, dphi);
  else
    enum_sweep_bwd<false>(x, mui, g, ll_state, bern0, bern1, dbern0, dbern1,
                          lgx1, log1m_lamb, q, lp, P, dlp, tot, dmu, dphi);
  dmu_out[i] = dmu;
  dphi_out[i] = dphi;
  if (staged) {
    float* slot = tile + threadIdx.x * P;
#pragma unroll
    for (int s = 0; s < MAXP; ++s)
      if (s < P) slot[s] = dlp[s];
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0)
      bulk_store(dlog_pi_out + first * P, tile, THREADS * P * sizeof(float));
  } else {
    float* drow = dlog_pi_out + i * P;
#pragma unroll
    for (int s = 0; s < MAXP; ++s)
      if (s < P) drow[s] = dlp[s];
  }
}

inline unsigned int blocks_for(int64_t n) {
  return (unsigned int)((n + THREADS - 1) / THREADS);
}

template <bool SPARSE, bool BINARY>
void launch_fwd(const float* reads, const float* mu, const float* phi,
                const float* pi, const float* etas, const float* eidx,
                const float* ew, const float* scal, float* out, float* lse,
                int64_t n, int P, int lanes, cudaStream_t st) {
  const dim3 grid(blocks_for(n), (unsigned int)lanes);
  fused_fwd_kernel<SPARSE, BINARY><<<grid, THREADS, 0, st>>>(
      reads, mu, phi, pi, etas, eidx, ew, scal, out, lse, n, P);
}

template <bool SPARSE, bool BINARY>
void launch_bwd(const float* reads, const float* mu, const float* phi,
                const float* pi, const float* etas, const float* eidx,
                const float* ew, const float* scal, const float* lse,
                const float* g, float* dmu, float* dphi, float* dpi,
                int64_t n, int P, int lanes, cudaStream_t st) {
  const dim3 grid(blocks_for(n), (unsigned int)lanes);
  fused_bwd_kernel<SPARSE, BINARY><<<grid, THREADS, 0, st>>>(
      reads, mu, phi, pi, etas, eidx, ew, scal, lse, g, dmu, dphi, dpi, n,
      P);
}

inline bool refused(int P, int binary, long long n, int lanes = 1) {
  // the binary encoding with more than one lane has no caller and is
  // not ported (ROADMAP B1)
  return P < 1 || P > MAXP || n < 0 || (binary && binary_width(P) > MAXKB) ||
         lanes < 1 || lanes > 65535 || (binary && lanes != 1);
}

}  // namespace

extern "C" {

const char* scrt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// pi: P planes, or Kb planes when binary != 0; `lanes` stacked fits of n
// bins each, every operand lane-major ((lanes, n) bins, (lanes, Kp, n)
// planes, (lanes, 3) scal), one for a solo fit
int scrt_fused_fwd(const float* reads, const float* mu, const float* phi,
                   const float* pi, const float* etas, const float* eidx,
                   const float* ew, const float* scal, float* out,
                   float* lse, long long n, int P, int sparse, int binary,
                   int lanes, void* stream) {
  if (refused(P, binary, n, lanes)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  auto fn = sparse ? (binary ? launch_fwd<true, true> : launch_fwd<true, false>)
                   : (binary ? launch_fwd<false, true>
                             : launch_fwd<false, false>);
  fn(reads, mu, phi, pi, etas, eidx, ew, scal, out, lse, n, P, lanes, st);
  return (int)cudaGetLastError();
}

// dpi: P planes, or Kb planes when binary != 0; lanes as scrt_fused_fwd
int scrt_fused_bwd(const float* reads, const float* mu, const float* phi,
                   const float* pi, const float* etas, const float* eidx,
                   const float* ew, const float* scal, const float* lse,
                   const float* g, float* dmu, float* dphi, float* dpi,
                   long long n, int P, int sparse, int binary, int lanes,
                   void* stream) {
  if (refused(P, binary, n, lanes)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  auto fn = sparse ? (binary ? launch_bwd<true, true> : launch_bwd<true, false>)
                   : (binary ? launch_bwd<false, true>
                             : launch_bwd<false, false>);
  fn(reads, mu, phi, pi, etas, eidx, ew, scal, lse, g, dmu, dphi, dpi, n, P,
     lanes, st);
  return (int)cudaGetLastError();
}

// log_pi: the cells-major (n, P) normalised log-simplex
int scrt_enum_fwd(const float* reads, const float* mu, const float* phi,
                  const float* log_pi, const float* scal, float* ll,
                  long long n, int P, void* stream) {
  if (refused(P, 0, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  enum_fwd_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      reads, mu, phi, log_pi, scal, ll, n, P);
  return (int)cudaGetLastError();
}

// dlog_pi: cells-major (n, P), as log_pi, 16-B aligned (the bulk copy's
// requirement: every full block's span then starts aligned, THREADS * P * 4
// bytes after the last); a launch stages a span when n holds a full block
int scrt_enum_bwd(const float* reads, const float* mu, const float* phi,
                  const float* log_pi, const float* scal, const float* ll,
                  const float* g, float* dmu, float* dphi, float* dlog_pi,
                  long long n, int P, void* stream) {
  if (refused(P, 0, n) || reinterpret_cast<uintptr_t>(dlog_pi) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  enum_bwd_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      reads, mu, phi, log_pi, scal, ll, g, dmu, dphi, dlog_pi, n, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
