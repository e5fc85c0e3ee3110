// MMD RBF cross term (Eq. 10's sum_i m_i sum_c k(x_i, z_c)) and its
// gradient for Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernels `mmd_cross_sum` (`_kernel`) and
// `mmd_cross_grads` (`_grad_kernel`) of the JAX package's
// kernels/mmd_rbf.py.  k(x, z) = exp(-|x - z|^2 / (2 sigma^2)); the mask
// weights the sum and is not differentiated.  For a scalar cotangent g:
//   dx_i = -(1/sigma^2) sum_c w_ic (x_i - z_c),
//   dz_c =  (1/sigma^2) sum_i w_ic (x_i - z_c),   w_ic = g m_i k(x_i, z_c).
//
// One thread per node.  The TPU kernels carried the scalar (or dz) across
// their sequential grid; here each block reduces its threads in a fixed
// tree (warp shuffles, then warps in order) into one partial per block,
// and a one-block second kernel adds the partials in block order.  No
// float atomics, so repeated runs are bitwise equal.  The (N, C) kernel
// matrix is never stored.
//
// Bound on an H100: 16 bytes read per node (x, mask) and ~10 FLOP plus one
// exp per node and channel: bound by bytes, ~0.04 us at N = 8,192, so its
// time is the launch latency of the two kernels.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  return v;
}

// sum of v over the block, fixed order; valid in thread 0 (red: WARPS floats)
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // red may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

__global__ void __launch_bounds__(THREADS)
mmd_sum_partials(const float* __restrict__ x, const float* __restrict__ z,
                 const float* __restrict__ mask, float* __restrict__ part,
                 int n, int n_chan, float two_s2) {
  __shared__ float red[WARPS];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  float v = 0.0f;
  if (i < n) {
    const float m = mask[i];
    const float x0 = x[3 * i], x1 = x[3 * i + 1], x2 = x[3 * i + 2];
    for (int c = 0; c < n_chan; ++c) {
      const float r0 = x0 - z[3 * c], r1 = x1 - z[3 * c + 1],
                  r2 = x2 - z[3 * c + 2];
      v += expf(-(r0 * r0 + r1 * r1 + r2 * r2) / two_s2) * m;
    }
  }
  const float s = block_sum(v, red);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

__global__ void __launch_bounds__(THREADS)
mmd_grad_partials(const float* __restrict__ x, const float* __restrict__ z,
                  const float* __restrict__ mask, const float* __restrict__ g,
                  float* __restrict__ dx, float* __restrict__ part, int n,
                  int n_chan, float two_s2) {
  __shared__ float red[WARPS];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool ok = i < n;
  const float inv_s2 = 2.0f / two_s2;
  const float gm = ok ? g[0] * mask[i] : 0.0f;
  const float x0 = ok ? x[3 * i] : 0.0f, x1 = ok ? x[3 * i + 1] : 0.0f,
              x2 = ok ? x[3 * i + 2] : 0.0f;
  float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
  for (int c = 0; c < n_chan; ++c) {
    const float r0 = x0 - z[3 * c], r1 = x1 - z[3 * c + 1],
                r2 = x2 - z[3 * c + 2];
    const float w = ok ? expf(-(r0 * r0 + r1 * r1 + r2 * r2) / two_s2) * gm
                       : 0.0f;
    d0 += w * r0;
    d1 += w * r1;
    d2 += w * r2;
    const float c0 = block_sum(w * r0, red);
    const float c1 = block_sum(w * r1, red);
    const float c2 = block_sum(w * r2, red);
    if (threadIdx.x == 0) {
      float* p = part + ((size_t)blockIdx.x * n_chan + c) * 3;
      p[0] = inv_s2 * c0;
      p[1] = inv_s2 * c1;
      p[2] = inv_s2 * c2;
    }
  }
  if (ok) {
    dx[3 * i] = -inv_s2 * d0;
    dx[3 * i + 1] = -inv_s2 * d1;
    dx[3 * i + 2] = -inv_s2 * d2;
  }
}

// out[f] = sum over blocks b, in order, of part[b * width + f]
__global__ void mmd_block_sums(const float* __restrict__ part,
                               float* __restrict__ out, int n_blocks,
                               int width) {
  const int f = threadIdx.x;
  if (f >= width) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += part[(size_t)b * width + f];
  out[f] = s;
}

}  // namespace

extern "C" int mmd_blocks(int n) { return (n + THREADS - 1) / THREADS; }

extern "C" int mmd_cross_sum_launch(const float* x, const float* z,
                                    const float* mask, float* part,
                                    float* out, int n, int n_chan,
                                    float two_s2, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int nb = mmd_blocks(n);
  if (nb > 0) {
    mmd_sum_partials<<<nb, THREADS, 0, stream>>>(x, z, mask, part, n, n_chan,
                                                 two_s2);
  }
  mmd_block_sums<<<1, 32, 0, stream>>>(part, out, nb, 1);
  return (int)cudaGetLastError();
}

extern "C" int mmd_cross_grads_launch(const float* x, const float* z,
                                      const float* mask, const float* g,
                                      float* dx, float* part, float* dz, int n,
                                      int n_chan, float two_s2,
                                      void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int nb = mmd_blocks(n);
  if (nb > 0) {
    mmd_grad_partials<<<nb, THREADS, 0, stream>>>(x, z, mask, g, dx, part, n,
                                                  n_chan, two_s2);
  }
  const int width = 3 * n_chan;
  mmd_block_sums<<<1, ((width + 31) / 32) * 32, 0, stream>>>(part, dz, nb,
                                                             width);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
