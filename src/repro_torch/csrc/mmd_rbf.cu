// MMD RBF cross term (Eq. 10's sum_i m_i sum_c k(x_i, z_c)) and its
// gradient for Hopper (sm_90a), f32, for a batch of graphs.
//
// Replaces the Pallas TPU kernels `mmd_cross_sum` (`_kernel`) and
// `mmd_cross_grads` (`_grad_kernel`) of the JAX package's
// kernels/mmd_rbf.py, which its trainer vmaps over the batch: one
// pallas_call a train step with the batch as a grid axis.  Here too one
// launch covers the batch.  k(x, z) = exp(-|x - z|^2 / (2 sigma^2)); the
// mask weights the sum and is not differentiated.  For graph b with the
// cotangent g_b:
//   out_b   = sum_i m_i sum_c k(x_i, z_c),
//   dx_i    = -(1/sigma^2) sum_c w_ic (x_i - z_c),
//   dz_c    =  (1/sigma^2) sum_i w_ic (x_i - z_c),   w_ic = g_b m_i k(x_i, z_c).
//
// Bound on an H100: 16 bytes read per node (x, mask), ~12 FLOP and one exp
// per node and channel: bound by bytes, 0.16 us for 4 graphs of 8,192
// nodes.  What costs is the chain of latencies of one small launch (the
// loads, the reductions, the cluster syncs) and, where a graph gets few
// SMs, the arithmetic: so a graph gets as many CTAs as a cluster holds
// before they widen, and each reduction's last adds are read by one warp
// at once and added in order by one lane.
//
// Design: one thread-block cluster per graph (grid (ctas, B), cluster
// (ctas, 1, 1)); its CTAs stride over the graph's nodes, each thread
// taking nodes rank * threads + t, + ctas * threads, ... in that order,
// UNROLL of them loaded before any is used.  A CTA reduces its threads in
// a fixed tree (warp shuffles, then the warps in index order); then CTA
// rank 0 reads the other CTAs' sums from their shared memory (distributed
// shared memory) in rank order and writes the graph's result.  So each
// kernel is one launch, with no second pass, no float atomics and no
// global scratch that a later launch would need zeroed; repeated runs are
// bitwise equal.  The caller picks (threads, ctas) from N alone
// (kernels/mmd_rbf.py `schedule`), so a graph's result does not depend on
// B or on the other graphs of the batch.  The gradient kernel keeps each
// node's dx in registers across channels and the thread's dz sums for
// CHAN_REG channels at a time; it reduces all 3C dz sums of a CTA in one
// pass (a shuffle tree each, one __syncthreads).  The (N, C) kernel
// matrix is never stored.  No node is skipped for its mask: a NaN in x
// makes its graph's results NaN, as in the plain version (NaN * 0).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_CTAS = 16;   // cluster size; above 8 it is non-portable
constexpr int UNROLL = 4;      // nodes a thread loads before it computes
constexpr int CHAN_REG = 4;    // channels (z, dz sums) held in registers
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  return v;
}

// sum of v over lanes 0 .. count - 1 (count <= 32), added in lane order from
// 0.0f, valid in lane 0: the lanes load at once, the adds stay in order
__device__ __forceinline__ float lane_order_sum(float v, int count) {
  float s = 0.0f;
#pragma unroll
  for (int l = 0; l < 32; ++l) {
    const float t = __shfl_sync(FULL, v, l);
    if (l < count) s += t;
  }
  return s;
}

// the graph's nodes i0, i0 + stride, ... (UNROLL of them): x and mask,
// zeros past n
__device__ __forceinline__ void load_nodes(const float* __restrict__ x,
                                           const float* __restrict__ mask,
                                           int n, int i0, int stride,
                                           float (&xs)[UNROLL][3],
                                           float (&ms)[UNROLL]) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int i = i0 + u * stride;
    const bool ok = i < n;
    ms[u] = ok ? mask[i] : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) xs[u][k] = ok ? x[3 * (size_t)i + k] : 0.0f;
  }
}

// channels c0 .. c0 + CHAN_REG - 1 of z into registers, zeros past n_chan
__device__ __forceinline__ void load_channels(const float* __restrict__ z,
                                              int n_chan, int c0,
                                              float (&zr)[CHAN_REG][3]) {
#pragma unroll
  for (int cc = 0; cc < CHAN_REG; ++cc)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      zr[cc][k] = c0 + cc < n_chan ? z[3 * (c0 + cc) + k] : 0.0f;
}

// Each thread adds its nodes' terms in node order, a node's channels in
// channel order (with more than CHAN_REG channels: CHAN_REG at a time, a
// pass over the nodes each).
__global__ void __launch_bounds__(MAX_THREADS)
mmd_sum_kernel(const float* __restrict__ x, const float* __restrict__ z,
               const float* __restrict__ mask, float* __restrict__ out, int n,
               int n_chan, float neg_inv_2s2) {
  __shared__ float red[MAX_WARPS];
  __shared__ float cta_sum;
  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x += (size_t)b * n * 3;
  mask += (size_t)b * n;
  z += (size_t)b * n_chan * 3;
  const int stride = gridDim.x * blockDim.x;
  float v = 0.0f;
  for (int c0 = 0; c0 < n_chan; c0 += CHAN_REG) {
    float zr[CHAN_REG][3];
    load_channels(z, n_chan, c0, zr);
    for (int i0 = blockIdx.x * blockDim.x + threadIdx.x; i0 < n;
         i0 += UNROLL * stride) {
      float xs[UNROLL][3], ms[UNROLL];
      load_nodes(x, mask, n, i0, stride, xs, ms);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (i0 + u * stride >= n) break;
#pragma unroll
        for (int cc = 0; cc < CHAN_REG; ++cc) {
          if (c0 + cc >= n_chan) break;
          const float r0 = xs[u][0] - zr[cc][0], r1 = xs[u][1] - zr[cc][1],
                      r2 = xs[u][2] - zr[cc][2];
          v += expf((r0 * r0 + r1 * r1 + r2 * r2) * neg_inv_2s2) * ms[u];
        }
      }
    }
  }
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    const float s = lane_order_sum(lane < warps ? red[lane] : 0.0f, warps);
    if (lane == 0) cta_sum = s;
  }
  cluster.sync();
  if (blockIdx.x == 0 && warp == 0) {
    const int ctas = gridDim.x;
    const float p = lane < ctas ? *cluster.map_shared_rank(&cta_sum, lane)
                                : 0.0f;
    const float s = lane_order_sum(p, ctas);
    if (lane == 0) out[b] = s;
  }
  cluster.sync();  // the other CTAs keep their shared memory until read
}

// dynamic shared memory: [warps][3C] warp sums, then [3C] CTA sums
__global__ void __launch_bounds__(MAX_THREADS)
mmd_grad_kernel(const float* __restrict__ x, const float* __restrict__ z,
                const float* __restrict__ mask, const float* __restrict__ g,
                float* __restrict__ dx, float* __restrict__ dz, int n,
                int n_chan, float neg_inv_2s2) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5, width = 3 * n_chan;
  float* red = smem;
  float* part = smem + warps * width;
  x += (size_t)b * n * 3;
  dx += (size_t)b * n * 3;
  mask += (size_t)b * n;
  z += (size_t)b * width;
  const float gb = g[b], inv_s2 = -2.0f * neg_inv_2s2;
  const int stride = gridDim.x * blockDim.x;
  for (int c0 = 0; c0 < n_chan; c0 += CHAN_REG) {
    // more than CHAN_REG channels: dx carries its running sum (unscaled)
    // from one group of channels to the next through the output
    const bool first = c0 == 0, last = c0 + CHAN_REG >= n_chan;
    float zr[CHAN_REG][3], acc[3 * CHAN_REG];
    load_channels(z, n_chan, c0, zr);
#pragma unroll
    for (int j = 0; j < 3 * CHAN_REG; ++j) acc[j] = 0.0f;
    for (int i0 = blockIdx.x * blockDim.x + threadIdx.x; i0 < n;
         i0 += UNROLL * stride) {
      float xs[UNROLL][3], ms[UNROLL];
      load_nodes(x, mask, n, i0, stride, xs, ms);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * stride;
        if (i >= n) break;
        float* d = dx + 3 * (size_t)i;
        float d0 = first ? 0.0f : d[0], d1 = first ? 0.0f : d[1],
              d2 = first ? 0.0f : d[2];
        const float gm = gb * ms[u];
#pragma unroll
        for (int cc = 0; cc < CHAN_REG; ++cc) {
          if (c0 + cc >= n_chan) break;
          const float r0 = xs[u][0] - zr[cc][0], r1 = xs[u][1] - zr[cc][1],
                      r2 = xs[u][2] - zr[cc][2];
          const float w =
              expf((r0 * r0 + r1 * r1 + r2 * r2) * neg_inv_2s2) * gm;
          const float w0 = w * r0, w1 = w * r1, w2 = w * r2;
          d0 += w0;
          d1 += w1;
          d2 += w2;
          acc[3 * cc] += w0;
          acc[3 * cc + 1] += w1;
          acc[3 * cc + 2] += w2;
        }
        const float s = last ? -inv_s2 : 1.0f;
        d[0] = s * d0;
        d[1] = s * d1;
        d[2] = s * d2;
      }
    }
#pragma unroll
    for (int j = 0; j < 3 * CHAN_REG; ++j) {
      if (3 * c0 + j >= width) break;
      const float s = warp_sum(acc[j]);
      if (lane == 0) red[warp * width + 3 * c0 + j] = s;
    }
  }
  __syncthreads();
  for (int f = warp; f < width; f += warps) {  // a warp a component
    const float s =
        lane_order_sum(lane < warps ? red[lane * width + f] : 0.0f, warps);
    if (lane == 0) part[f] = s;
  }
  cluster.sync();
  if (blockIdx.x == 0) {
    const int ctas = gridDim.x;
    for (int f = warp; f < width; f += warps) {
      const float p =
          lane < ctas ? cluster.map_shared_rank(part, lane)[f] : 0.0f;
      const float s = lane_order_sum(p, ctas);
      if (lane == 0) dz[(size_t)b * width + f] = inv_s2 * s;
    }
  }
  cluster.sync();  // the other CTAs keep their shared memory until read
}

// grid (ctas, b), one cluster of ctas CTAs per graph
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int b, int threads, int ctas,
                    size_t smem, void* stream, Args... args) {
  if (b < 1 || b > 65535 || threads < 32 || threads > MAX_THREADS ||
      threads % 32 != 0 || ctas < 1 || ctas > MAX_CTAS)
    return (int)cudaErrorInvalidValue;
  if (ctas > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, b, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// x (b, n, 3), z (b, n_chan, 3), mask (b, n) -> out (b,);
// neg_inv_2s2 = -1 / (2 sigma^2)
extern "C" int mmd_cross_sum_launch(const float* x, const float* z,
                                    const float* mask, float* out, int b,
                                    int n, int n_chan, float neg_inv_2s2,
                                    int threads, int ctas, void* stream) {
  return launch_clusters(mmd_sum_kernel, b, threads, ctas, 0, stream, x, z,
                         mask, out, n, n_chan, neg_inv_2s2);
}

// ... and g (b,) -> dx (b, n, 3), dz (b, n_chan, 3)
extern "C" int mmd_cross_grads_launch(const float* x, const float* z,
                                      const float* mask, const float* g,
                                      float* dx, float* dz, int b, int n,
                                      int n_chan, float neg_inv_2s2,
                                      int threads, int ctas, void* stream) {
  const size_t smem = sizeof(float) * 3 * n_chan * (threads / 32 + 1);
  return launch_clusters(mmd_grad_kernel, b, threads, ctas, smem, stream, x,
                         z, mask, g, dx, dz, n, n_chan, neg_inv_2s2);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
