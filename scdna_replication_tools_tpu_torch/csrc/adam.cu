// Single-sweep Adam update for the (planes, cells, loci) pi parameter,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel _adam_kernel of
// scdna_replication_tools_tpu/ops/adam_kernel.py (:120, pallas_call :168).
// Math in optax operation order (adam_kernel.py:99-117):
//   m' = (1 - b1) g + b1 m
//   v' = (1 - b2) g g + b2 v
//   p' = p + (-lr) * (m' / bc1) / (sqrt(v' / bc2) + eps)   (eps outside)
// with bc1 = 1 - b1^t and bc2 = 1 - b2^t at the incremented step count.
//
// What bounds it on this card: memory -- it reads four planes per element
// and writes three, about 15 float32 operations against 28 bytes.  Design:
// a grid-stride elementwise sweep that streams every operand exactly once.
// lr, bc1 and bc2 arrive in a 3-float device tensor, not as host floats,
// so the step count never has to come back to the host and the fit loop
// stays capturable in a CUDA graph.  Moments are float32 here.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float kEps = 1e-8f;

__global__ void __launch_bounds__(THREADS) adam_kernel(
    float* __restrict__ p_out, float* __restrict__ m_out,
    float* __restrict__ v_out, const float* __restrict__ p,
    const float* __restrict__ g, const float* __restrict__ m,
    const float* __restrict__ v, const float* __restrict__ scal, float b1,
    float omb1, float b2, float omb2, int64_t n) {
  const float lr = scal[0], bc1 = scal[1], bc2 = scal[2];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float gi = g[i];
    const float mi = omb1 * gi + b1 * m[i];
    const float vi = omb2 * (gi * gi) + b2 * v[i];
    m_out[i] = mi;
    v_out[i] = vi;
    const float update = (mi / bc1) / (sqrtf(vi / bc2) + kEps);
    p_out[i] = p[i] + (-lr) * update;
  }
}

}  // namespace

extern "C" {

const char* scrt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int scrt_adam(float* p_out, float* m_out, float* v_out, const float* p,
              const float* g, const float* m, const float* v,
              const float* scal, float b1, float omb1, float b2, float omb2,
              long long n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int64_t want = (n + THREADS - 1) / THREADS;
  const unsigned int blocks = (unsigned int)(want < 65536 ? want : 65536);
  adam_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      p_out, m_out, v_out, p, g, m, v, scal, b1, omb1, b2, omb2, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
