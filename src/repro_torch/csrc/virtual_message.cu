// Virtual-node pathway forward (Eq. 5 + the virtual terms of Eqs. 6-8) for
// Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel `virtual_pathway_fused` (`_kernel`) of the
// JAX package's kernels/virtual_message.py.  For node i and channel c:
//   rel     = x_i - z_c ;  d2 = |rel|^2
//   msg     = SiLU(h_i . w1h_c + d2 * w1d_c + const1_c) . w2_c + b2_c
//   gate_x  = SiLU(msg . wg1_c + bg1_c) . wg2_c
//   gate_z  = SiLU(msg . wz1_c + bz1_c) . wz2_c
// and it returns dx_i = mean_c rel * gate_x, mh_i = mean_c msg (per node),
// dz_sum_c = sum_i mask_i (z_c - x_i) gate_z and ms_sum_c = sum_i mask_i msg.
//
// The TPU kernel carried dz_sum / ms_sum across its sequential grid.  A GPU
// grid runs in no order, so the cross-node sums use a deterministic
// two-stage reduction: each CTA writes its partial sums to a
// (n_blocks, C, 3 + hid) scratch tensor in a fixed order (nodes of a warp
// in order, then warps in order), and `virtual_block_sums` adds the blocks
// in index order.  No float atomics, so repeated runs are bitwise equal.
//
// One CTA owns NODES = 64 nodes (8 warps x TN = 8 nodes) and loops over the
// C channels in order; each channel's w1h, w2, wg1 and wz1 (4 x 16 KB) and
// bias rows are loaded into shared memory in turn.  A warp keeps its 8
// nodes' h in a shared tile [k][t] and runs every 64x64 matvec over the
// tile with one lane per pair of output columns (j = lane, lane + 32).
// Nothing of size N x C x hid reaches device memory.
//
// Bound on an H100: per node and channel four 64x64 matvecs (32,768 f32
// FLOP) against 268 bytes of x, h and mask read and 268 bytes of dx, mh
// written per node — ~370 FLOP per byte at C = 3, far above the f32 ridge
// (67 TFLOP/s / 3.35 TB/s = 20), so it is bound by f32 operations.
#include <cuda_runtime.h>

namespace {

constexpr int HID = 64;  // Dh = hid
constexpr int TN = 8;    // nodes per warp
constexpr int WARPS = 8;
constexpr int NODES = TN * WARPS;
constexpr int OUTW = 3 + HID;  // partial-sum row: dz (3) | ms (hid)
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_FLOATS =
    4 * HID * HID + 8 * HID + 2 * WARPS * HID * TN + WARPS * OUTW + 4;

__device__ __forceinline__ float silu(float u) { return u / (1.0f + expf(-u)); }

__device__ __forceinline__ void tile_matvec(const float* __restrict__ buf,
                                            const float* __restrict__ W,
                                            int lane, float* acc0, float* acc1) {
#pragma unroll 8
  for (int k = 0; k < HID; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(buf + k * TN);
    const float4 b = *reinterpret_cast<const float4*>(buf + k * TN + 4);
    const float w0 = W[k * HID + lane];
    const float w1 = W[k * HID + lane + 32];
    const float v[TN] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      acc0[t] = fmaf(v[t], w0, acc0[t]);
      acc1[t] = fmaf(v[t], w1, acc1[t]);
    }
  }
}

__device__ __forceinline__ void tile_store(float* buf, int lane,
                                           const float* v0, const float* v1) {
  float4* p0 = reinterpret_cast<float4*>(buf + lane * TN);
  float4* p1 = reinterpret_cast<float4*>(buf + (lane + 32) * TN);
  p0[0] = make_float4(v0[0], v0[1], v0[2], v0[3]);
  p0[1] = make_float4(v0[4], v0[5], v0[6], v0[7]);
  p1[0] = make_float4(v1[0], v1[1], v1[2], v1[3]);
  p1[1] = make_float4(v1[4], v1[5], v1[6], v1[7]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  return v;
}

// gate[t] = SiLU(buf . W1 + b1) . w2 for the tile held in buf
__device__ __forceinline__ void tile_gate(const float* buf, const float* W1,
                                          const float* b1, const float* w2,
                                          int lane, float* gate) {
  float g0[TN], g1[TN];
#pragma unroll
  for (int t = 0; t < TN; ++t) {
    g0[t] = 0.0f;
    g1[t] = 0.0f;
  }
  tile_matvec(buf, W1, lane, g0, g1);
#pragma unroll
  for (int t = 0; t < TN; ++t) {
    gate[t] = warp_sum(silu(g0[t] + b1[lane]) * w2[lane] +
                       silu(g1[t] + b1[lane + 32]) * w2[lane + 32]);
  }
}

__global__ void __launch_bounds__(WARPS * 32, 2)
virtual_fwd_kernel(const float* __restrict__ x, const float* __restrict__ h,
                   const float* __restrict__ z, const float* __restrict__ mask,
                   const float* __restrict__ w1h, const float* __restrict__ w1d,
                   const float* __restrict__ c1, const float* __restrict__ w2,
                   const float* __restrict__ b2, const float* __restrict__ wg1,
                   const float* __restrict__ bg1, const float* __restrict__ wg2,
                   const float* __restrict__ wz1, const float* __restrict__ bz1,
                   const float* __restrict__ wz2, float* __restrict__ dx,
                   float* __restrict__ mh, float* __restrict__ part,
                   int n_nodes, int n_chan) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sW1h = smem;
  float* sW2 = sW1h + HID * HID;
  float* sWg1 = sW2 + HID * HID;
  float* sWz1 = sWg1 + HID * HID;
  float* sw1d = sWz1 + HID * HID;
  float* sc1 = sw1d + HID;
  float* sb2 = sc1 + HID;
  float* sbg1 = sb2 + HID;
  float* swg2 = sbg1 + HID;
  float* sbz1 = swg2 + HID;
  float* swz2 = sbz1 + HID;
  float* tiles = swz2 + 2 * HID;  // keeps 16-byte alignment
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* hbuf = tiles + warp * HID * TN;
  float* buf = tiles + (WARPS + warp) * HID * TN;
  float* red = tiles + 2 * WARPS * HID * TN;  // [WARPS][OUTW]

  const int node0 = blockIdx.x * NODES + warp * TN;
  float xt[TN][3], mt[TN];
  {
    float v0[TN], v1[TN];
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      const int i = node0 + t;
      const bool ok = i < n_nodes;
      xt[t][0] = ok ? x[3 * i] : 0.0f;
      xt[t][1] = ok ? x[3 * i + 1] : 0.0f;
      xt[t][2] = ok ? x[3 * i + 2] : 0.0f;
      mt[t] = ok ? mask[i] : 0.0f;
      v0[t] = ok ? h[(size_t)i * HID + lane] : 0.0f;
      v1[t] = ok ? h[(size_t)i * HID + lane + 32] : 0.0f;
    }
    tile_store(hbuf, lane, v0, v1);
  }
  float dxa[TN][3], mha0[TN], mha1[TN];
#pragma unroll
  for (int t = 0; t < TN; ++t) {
    dxa[t][0] = dxa[t][1] = dxa[t][2] = 0.0f;
    mha0[t] = mha1[t] = 0.0f;
  }

  for (int c = 0; c < n_chan; ++c) {
    __syncthreads();  // previous channel's weights and partials are consumed
    const size_t wo = (size_t)c * HID * HID;
    for (int i = tid; i < HID * HID; i += blockDim.x) {
      sW1h[i] = w1h[wo + i];
      sW2[i] = w2[wo + i];
      sWg1[i] = wg1[wo + i];
      sWz1[i] = wz1[wo + i];
    }
    for (int i = tid; i < HID; i += blockDim.x) {
      const int o = c * HID + i;
      sw1d[i] = w1d[o];
      sc1[i] = c1[o];
      sb2[i] = b2[o];
      sbg1[i] = bg1[o];
      swg2[i] = wg2[o];
      sbz1[i] = bz1[o];
      swz2[i] = wz2[o];
    }
    __syncthreads();
    const float zc0 = z[3 * c], zc1 = z[3 * c + 1], zc2 = z[3 * c + 2];

    float d2[TN];
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      const float r0 = xt[t][0] - zc0, r1 = xt[t][1] - zc1, r2 = xt[t][2] - zc2;
      d2[t] = r0 * r0 + r1 * r1 + r2 * r2;
    }
    float p0[TN], p1[TN];
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      p0[t] = 0.0f;
      p1[t] = 0.0f;
    }
    tile_matvec(hbuf, sW1h, lane, p0, p1);
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      p0[t] = silu((p0[t] + d2[t] * sw1d[lane]) + sc1[lane]);
      p1[t] = silu((p1[t] + d2[t] * sw1d[lane + 32]) + sc1[lane + 32]);
    }
    __syncwarp();
    tile_store(buf, lane, p0, p1);
    __syncwarp();
    float m0[TN], m1[TN];
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      m0[t] = 0.0f;
      m1[t] = 0.0f;
    }
    tile_matvec(buf, sW2, lane, m0, m1);
    float ms0 = 0.0f, ms1 = 0.0f;
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      m0[t] += sb2[lane];
      m1[t] += sb2[lane + 32];
      mha0[t] += m0[t];
      mha1[t] += m1[t];
      ms0 += m0[t] * mt[t];
      ms1 += m1[t] * mt[t];
    }
    __syncwarp();
    tile_store(buf, lane, m0, m1);
    __syncwarp();
    float gx[TN], gz[TN];
    tile_gate(buf, sWg1, sbg1, swg2, lane, gx);
    tile_gate(buf, sWz1, sbz1, swz2, lane, gz);

    float dz0 = 0.0f, dz1 = 0.0f, dz2 = 0.0f;
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      const float r0 = xt[t][0] - zc0, r1 = xt[t][1] - zc1, r2 = xt[t][2] - zc2;
      dxa[t][0] += r0 * gx[t];
      dxa[t][1] += r1 * gx[t];
      dxa[t][2] += r2 * gx[t];
      dz0 += -r0 * gz[t] * mt[t];
      dz1 += -r1 * gz[t] * mt[t];
      dz2 += -r2 * gz[t] * mt[t];
    }
    float* rw = red + warp * OUTW;
    if (lane == 0) {
      rw[0] = dz0;
      rw[1] = dz1;
      rw[2] = dz2;
    }
    rw[3 + lane] = ms0;
    rw[3 + lane + 32] = ms1;
    __syncthreads();
    for (int f = tid; f < OUTW; f += blockDim.x) {
      float s = 0.0f;
      for (int w = 0; w < WARPS; ++w) s += red[w * OUTW + f];
      part[((size_t)blockIdx.x * n_chan + c) * OUTW + f] = s;
    }
  }

  const float inv_c = 1.0f / (float)n_chan;
#pragma unroll
  for (int t = 0; t < TN; ++t) {
    const int i = node0 + t;
    if (i < n_nodes) {
      mh[(size_t)i * HID + lane] = mha0[t] * inv_c;
      mh[(size_t)i * HID + lane + 32] = mha1[t] * inv_c;
      if (lane == 0) {
        dx[3 * i] = dxa[t][0] * inv_c;
        dx[3 * i + 1] = dxa[t][1] * inv_c;
        dx[3 * i + 2] = dxa[t][2] * inv_c;
      }
    }
  }
}

// out[c][f] = sum over blocks b = 0..n_blocks-1, in order, of part[b][c][f]
__global__ void virtual_block_sums(const float* __restrict__ part,
                                   float* __restrict__ dz,
                                   float* __restrict__ ms, int n_blocks,
                                   int n_chan) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_chan * OUTW) return;
  const int c = idx / OUTW;
  const int f = idx % OUTW;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += part[((size_t)b * n_chan + c) * OUTW + f];
  if (f < 3) {
    dz[c * 3 + f] = s;
  } else {
    ms[c * HID + (f - 3)] = s;
  }
}

}  // namespace

extern "C" int virtual_forward(const float* x, const float* h, const float* z,
                               const float* mask, const float* w1h,
                               const float* w1d, const float* c1,
                               const float* w2, const float* b2,
                               const float* wg1, const float* bg1,
                               const float* wg2, const float* wz1,
                               const float* bz1, const float* wz2, float* dx,
                               float* mh, float* part, int n_nodes,
                               int n_chan, void* stream) {
  const size_t smem = SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      virtual_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_blocks = (n_nodes + NODES - 1) / NODES;
  if (n_blocks > 0) {
    virtual_fwd_kernel<<<n_blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(
        x, h, z, mask, w1h, w1d, c1, w2, b2, wg1, bg1, wg2, wz1, bz1, wz2, dx,
        mh, part, n_nodes, n_chan);
  }
  return (int)cudaGetLastError();
}

extern "C" int virtual_sums(const float* part, float* dz, float* ms,
                            int n_blocks, int n_chan, void* stream) {
  const int total = n_chan * OUTW;
  virtual_block_sums<<<(total + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      part, dz, ms, n_blocks, n_chan);
  return (int)cudaGetLastError();
}

extern "C" int virtual_nodes_per_block() { return NODES; }
extern "C" int virtual_partial_width() { return OUTW; }

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
