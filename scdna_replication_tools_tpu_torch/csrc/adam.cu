// Single-sweep Adam update for the (planes, cells, loci) pi parameter,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel _adam_kernel of
// scdna_replication_tools_tpu/ops/adam_kernel.py (:120, pallas_call :168),
// with float32 or bfloat16 stored moments.
// Math in optax operation order (adam_kernel.py:99-117):
//   m' = (1 - b1) g + b1 m
//   v' = (1 - b2) g g + b2 v
//   p' = p + (-lr) * (m' / bc1) / (sqrt(v' / bc2) + eps)   (eps outside)
// with bc1 = 1 - b1^t and bc2 = 1 - b2^t at the incremented step count.
// A live gate of 0 (an iteration launched after the fit stopped, before
// the host read the stop) writes p, m and v through unchanged, bit for
// bit, and does no arithmetic.
// The arithmetic is float32 for either moment type: bfloat16 moments are
// widened on load and narrowed (round to nearest even) on store, and the
// parameter update uses this step's float32 moments, not the rounded ones
// (adam_kernel.py:129-135).  Every multiply and add is a round-to-nearest
// intrinsic (__fmul_rn, __fadd_rn), which the compiler never contracts
// into an FMA, so the kernel repeats the plain version's roundings: a
// contracted (1 - b1) g + b1 m differs by an ulp of its larger term, and
// where the two terms cancel that is many bfloat16 ulps of the stored m'
// (on the card: up to 25, at 495 of 21.8 M elements of a random sweep).
//
// What bounds it on this card: memory -- it reads four planes per element
// and writes three, about 15 float32 operations against 28 bytes (20 with
// bfloat16 moments).  Design: a grid-stride elementwise sweep that streams
// every operand exactly once; the stored moment type is a template
// parameter.  lr, bc1, bc2 and the live gate arrive in a 4-float device
// tensor, not as host floats, so neither the step count nor the fit's
// stop ever has to come back to the host inside a chunk of iterations,
// and the fit loop stays capturable in a CUDA graph.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float kEps = 1e-8f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename M>
__device__ __forceinline__ M narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename M>
__global__ void __launch_bounds__(THREADS) adam_kernel(
    float* __restrict__ p_out, M* __restrict__ m_out, M* __restrict__ v_out,
    const float* __restrict__ p, const float* __restrict__ g,
    const M* __restrict__ m, const M* __restrict__ v,
    const float* __restrict__ scal, float b1, float omb1, float b2,
    float omb2, int64_t n) {
  const float lr = scal[0], bc1 = scal[1], bc2 = scal[2];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  if (scal[3] == 0.f) {
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
      p_out[i] = p[i];
      m_out[i] = m[i];
      v_out[i] = v[i];
    }
    return;
  }
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float gi = g[i];
    const float mi = __fadd_rn(__fmul_rn(omb1, gi), __fmul_rn(b1, widen(m[i])));
    const float vi = __fadd_rn(__fmul_rn(omb2, __fmul_rn(gi, gi)),
                               __fmul_rn(b2, widen(v[i])));
    m_out[i] = narrow<M>(mi);
    v_out[i] = narrow<M>(vi);
    const float update = (mi / bc1) / __fadd_rn(sqrtf(vi / bc2), kEps);
    p_out[i] = __fadd_rn(p[i], __fmul_rn(-lr, update));
  }
}

template <typename M>
int launch(float* p_out, void* m_out, void* v_out, const float* p,
           const float* g, const void* m, const void* v, const float* scal,
           float b1, float omb1, float b2, float omb2, long long n,
           cudaStream_t st) {
  const int64_t want = (n + THREADS - 1) / THREADS;
  const unsigned int blocks = (unsigned int)(want < 65536 ? want : 65536);
  adam_kernel<M><<<blocks, THREADS, 0, st>>>(
      p_out, (M*)m_out, (M*)v_out, p, g, (const M*)m, (const M*)v, scal, b1,
      omb1, b2, omb2, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* scrt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// m, v, m_out, v_out: float32, or bfloat16 when bf16_moments != 0
int scrt_adam(float* p_out, void* m_out, void* v_out, const float* p,
              const float* g, const void* m, const void* v,
              const float* scal, float b1, float omb1, float b2, float omb2,
              long long n, int bf16_moments, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16_moments
             ? launch<__nv_bfloat16>(p_out, m_out, v_out, p, g, m, v, scal,
                                     b1, omb1, b2, omb2, n, st)
             : launch<float>(p_out, m_out, v_out, p, g, m, v, scal, b1, omb1,
                             b2, omb2, n, st);
}

}  // extern "C"
