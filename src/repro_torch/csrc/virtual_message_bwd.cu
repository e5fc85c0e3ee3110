// Virtual-node pathway backward for Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel `virtual_pathway_bwd_fused` (`_bwd_kernel`)
// of the JAX package's kernels/virtual_message.py.  From the forward's
// primals and the four output cotangents (g_dx, g_mh, g_dz, g_ms) it
// returns the 14 gradients (x, h, z and the 11 per-channel weight stacks
// w1h, w1d, const1, w2, b2, wg1, bg1, wg2, wz1, bz1, wz2).  There are no
// residuals: every per-channel activation is recomputed, as `_bwd_kernel`
// does.  The 1/C channel mean is folded into the upstream; u_z = -m g_dz
// and g_rel = u_x gate_x + u_z gate_z + 2 rel g_d2.
//
// One CTA owns 64 nodes (8 warps x 8 nodes) and loops over the channels in
// order, with that channel's four 64x64 matrices and their transposes in
// shared memory (128 KB).  Per node it sums dx and dh over the channels in
// order and writes them once.  The cross-node sums go through global
// scratch, in fixed orders (no atomics, repeated runs are bitwise equal):
//   * dz: each CTA writes its per-channel partial (nodes of a warp in
//     order, then warps in order) and `virtual_bwd_dz` adds the CTAs in
//     index order;
//   * the weight stacks: the kernel stores, per channel and node, the
//     64-wide rows t1, g_msg, msg, g_gpx, g_gpz, g_pre1, d2 g_pre1,
//     sx g_gx and sz g_gz, and the two-stage block reduction of
//     common.cuh forms w1h = h^T g_pre1 (+ const1 = sum g_pre1),
//     w2 = t1^T g_msg (+ b2), wg1 = msg^T g_gpx (+ bg1),
//     wz1 = msg^T g_gpz (+ bz1), w1d, wg2 and wz2 as column sums.
//
// Bound on an H100: per node and channel eight 64x64 matvecs (the four of
// the forward recomputed, the cotangents through W1h^T, W2^T, Wg1^T and
// Wz1^T) plus four outer products: ~98K f32 FLOP against ~800 bytes of
// node inputs and outputs, so it is bound by f32 operations.
#include "common.cuh"

namespace {

constexpr int TN = TILE;  // nodes per warp
constexpr int WARPS = 8;
constexpr int NODES = TN * WARPS;
constexpr int SMEM_FLOATS = 8 * HID * HID + 8 * HID + 2 * WARPS * HID * TN +
                            WARPS * 4;

inline size_t round4(size_t v) { return (v + 3) & ~size_t(3); }

// gate[t] = SiLU(pre[t]) . w2 where pre = buf . W1 + b1 (pre kept)
__device__ __forceinline__ void tile_gate(float* buf, const float* W1,
                                          const float* b1, const float* w2,
                                          int lane, const float* in0,
                                          const float* in1, float* pre0,
                                          float* pre1, float* gate) {
  tile_product(buf, W1, lane, in0, in1, pre0, pre1);
#pragma unroll
  for (int t = 0; t < TN; ++t) {
    pre0[t] += b1[lane];
    pre1[t] += b1[lane + 32];
    gate[t] = warp_sum(silu(pre0[t]) * w2[lane] + silu(pre1[t]) * w2[lane + 32]);
  }
}

__device__ __forceinline__ void store_rows(float* dst, int node0, int n_nodes,
                                           int lane, const float* v0,
                                           const float* v1) {
#pragma unroll
  for (int t = 0; t < TN; ++t) {
    const int i = node0 + t;
    if (i < n_nodes) {
      dst[(size_t)i * HID + lane] = v0[t];
      dst[(size_t)i * HID + lane + 32] = v1[t];
    }
  }
}

struct Rows {  // per-channel (N, 64) row arrays, channel c at + c * N * 64
  float *T1, *GMSG, *MSG, *GGPX, *GGPZ, *GPRE1, *DG, *SXG, *SZG;
};

__global__ void __launch_bounds__(WARPS * 32, 1)
virtual_bwd_kernel(const float* __restrict__ x, const float* __restrict__ h,
                   const float* __restrict__ z, const float* __restrict__ mask,
                   const float* __restrict__ w1h, const float* __restrict__ w1d,
                   const float* __restrict__ c1, const float* __restrict__ w2,
                   const float* __restrict__ b2, const float* __restrict__ wg1,
                   const float* __restrict__ bg1, const float* __restrict__ wg2,
                   const float* __restrict__ wz1, const float* __restrict__ bz1,
                   const float* __restrict__ wz2, const float* __restrict__ gdx,
                   const float* __restrict__ gmh, const float* __restrict__ gdz,
                   const float* __restrict__ gms, float* __restrict__ gx,
                   float* __restrict__ gh, float* __restrict__ dzpart, Rows R,
                   int n_nodes, int n_chan) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sW1h = smem;
  float* sW1hT = sW1h + HID * HID;
  float* sW2 = sW1hT + HID * HID;
  float* sW2T = sW2 + HID * HID;
  float* sWg1 = sW2T + HID * HID;
  float* sWg1T = sWg1 + HID * HID;
  float* sWz1 = sWg1T + HID * HID;
  float* sWz1T = sWz1 + HID * HID;
  float* sw1d = sWz1T + HID * HID;
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
  float* red = tiles + 2 * WARPS * HID * TN;  // [WARPS][4]

  const int node0 = blockIdx.x * NODES + warp * TN;
  const float inv_c = 1.0f / (float)n_chan;
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
  float dxa[TN][3], dh0[TN], dh1[TN];
#pragma unroll
  for (int t = 0; t < TN; ++t) {
    dxa[t][0] = dxa[t][1] = dxa[t][2] = 0.0f;
    dh0[t] = dh1[t] = 0.0f;
  }

  for (int c = 0; c < n_chan; ++c) {
    __syncthreads();  // the previous channel's weights and partials are used
    const size_t wo = (size_t)c * HID * HID;
    for (int i = tid; i < HID * HID; i += blockDim.x) {
      const int k = i / HID, j = i % HID;
      const size_t it = wo + (size_t)j * HID + k;
      sW1h[i] = w1h[wo + i];
      sW1hT[i] = w1h[it];
      sW2[i] = w2[wo + i];
      sW2T[i] = w2[it];
      sWg1[i] = wg1[wo + i];
      sWg1T[i] = wg1[it];
      sWz1[i] = wz1[wo + i];
      sWz1T[i] = wz1[it];
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
    const float gz0 = gdz[3 * c], gz1 = gdz[3 * c + 1], gz2 = gdz[3 * c + 2];
    const size_t co = (size_t)c * n_nodes * HID;

    float rl[TN][3], d2[TN];
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      rl[t][0] = xt[t][0] - zc0;
      rl[t][1] = xt[t][1] - zc1;
      rl[t][2] = xt[t][2] - zc2;
      d2[t] = rl[t][0] * rl[t][0] + rl[t][1] * rl[t][1] + rl[t][2] * rl[t][2];
    }
    // ---- recompute the channel's forward chain --------------------------
    float pre0[TN], pre1[TN];
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      pre0[t] = 0.0f;
      pre1[t] = 0.0f;
    }
    tile_matvec(hbuf, sW1h, lane, pre0, pre1);
    float a0[TN], a1[TN];
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      pre0[t] = (pre0[t] + d2[t] * sw1d[lane]) + sc1[lane];
      pre1[t] = (pre1[t] + d2[t] * sw1d[lane + 32]) + sc1[lane + 32];
      a0[t] = silu(pre0[t]);
      a1[t] = silu(pre1[t]);
    }
    store_rows(R.T1 + co, node0, n_nodes, lane, a0, a1);
    float m0[TN], m1[TN];
    tile_product(buf, sW2, lane, a0, a1, m0, m1);
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      m0[t] += sb2[lane];
      m1[t] += sb2[lane + 32];
    }
    store_rows(R.MSG + co, node0, n_nodes, lane, m0, m1);
    float px0[TN], px1[TN], gate_x[TN], pz0[TN], pz1[TN], gate_z[TN];
    tile_gate(buf, sWg1, sbg1, swg2, lane, m0, m1, px0, px1, gate_x);
    tile_gate(buf, sWz1, sbz1, swz2, lane, m0, m1, pz0, pz1, gate_z);

    // ---- backpropagate the four cotangents -----------------------------
    float ux[TN][3], uz[TN][3], g_gx[TN], g_gz[TN];
    float gg0[TN], gg1[TN];  // g_msg
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      const int i = node0 + t;
      const bool ok = i < n_nodes;
      ux[t][0] = ok ? gdx[3 * i] * inv_c : 0.0f;
      ux[t][1] = ok ? gdx[3 * i + 1] * inv_c : 0.0f;
      ux[t][2] = ok ? gdx[3 * i + 2] * inv_c : 0.0f;
      uz[t][0] = -mt[t] * gz0;
      uz[t][1] = -mt[t] * gz1;
      uz[t][2] = -mt[t] * gz2;
      g_gx[t] = ux[t][0] * rl[t][0] + ux[t][1] * rl[t][1] + ux[t][2] * rl[t][2];
      g_gz[t] = uz[t][0] * rl[t][0] + uz[t][1] * rl[t][1] + uz[t][2] * rl[t][2];
      const float gm0 = ok ? gmh[(size_t)i * HID + lane] * inv_c : 0.0f;
      const float gm1 = ok ? gmh[(size_t)i * HID + lane + 32] * inv_c : 0.0f;
      gg0[t] = gm0 + mt[t] * gms[c * HID + lane];
      gg1[t] = gm1 + mt[t] * gms[c * HID + lane + 32];
    }
    float q0[TN], q1[TN], p0[TN], p1[TN], s0[TN], s1[TN];
    // gate-x MLP
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      q0[t] = (g_gx[t] * swg2[lane]) * silu_grad(px0[t]);
      q1[t] = (g_gx[t] * swg2[lane + 32]) * silu_grad(px1[t]);
      s0[t] = silu(px0[t]) * g_gx[t];
      s1[t] = silu(px1[t]) * g_gx[t];
    }
    store_rows(R.GGPX + co, node0, n_nodes, lane, q0, q1);
    store_rows(R.SXG + co, node0, n_nodes, lane, s0, s1);
    tile_product(buf, sWg1T, lane, q0, q1, p0, p1);
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      gg0[t] += p0[t];
      gg1[t] += p1[t];
    }
    // gate-z MLP
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      q0[t] = (g_gz[t] * swz2[lane]) * silu_grad(pz0[t]);
      q1[t] = (g_gz[t] * swz2[lane + 32]) * silu_grad(pz1[t]);
      s0[t] = silu(pz0[t]) * g_gz[t];
      s1[t] = silu(pz1[t]) * g_gz[t];
    }
    store_rows(R.GGPZ + co, node0, n_nodes, lane, q0, q1);
    store_rows(R.SZG + co, node0, n_nodes, lane, s0, s1);
    tile_product(buf, sWz1T, lane, q0, q1, p0, p1);
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      gg0[t] += p0[t];
      gg1[t] += p1[t];
    }
    store_rows(R.GMSG + co, node0, n_nodes, lane, gg0, gg1);
    // message MLP
    tile_product(buf, sW2T, lane, gg0, gg1, p0, p1);
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      q0[t] = p0[t] * silu_grad(pre0[t]);
      q1[t] = p1[t] * silu_grad(pre1[t]);
      s0[t] = d2[t] * q0[t];
      s1[t] = d2[t] * q1[t];
    }
    store_rows(R.GPRE1 + co, node0, n_nodes, lane, q0, q1);
    store_rows(R.DG + co, node0, n_nodes, lane, s0, s1);
    tile_product(buf, sW1hT, lane, q0, q1, p0, p1);
    float dz0 = 0.0f, dz1 = 0.0f, dz2 = 0.0f;
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      dh0[t] += p0[t];
      dh1[t] += p1[t];
      const float g_d2 = warp_sum(q0[t] * sw1d[lane] + q1[t] * sw1d[lane + 32]);
      float g_rel[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        g_rel[k] = ux[t][k] * gate_x[t] + uz[t][k] * gate_z[t] +
                   2.0f * rl[t][k] * g_d2;
        dxa[t][k] += g_rel[k];
      }
      dz0 += g_rel[0];
      dz1 += g_rel[1];
      dz2 += g_rel[2];
    }
    float* rw = red + warp * 4;
    if (lane == 0) {
      rw[0] = dz0;
      rw[1] = dz1;
      rw[2] = dz2;
    }
    __syncthreads();
    if (tid < 3) {
      float s = 0.0f;
      for (int w = 0; w < WARPS; ++w) s += red[w * 4 + tid];
      dzpart[((size_t)blockIdx.x * n_chan + c) * 3 + tid] = -s;
    }
  }

#pragma unroll
  for (int t = 0; t < TN; ++t) {
    const int i = node0 + t;
    if (i < n_nodes) {
      gh[(size_t)i * HID + lane] = dh0[t];
      gh[(size_t)i * HID + lane + 32] = dh1[t];
      if (lane == 0) {
        gx[3 * i] = dxa[t][0];
        gx[3 * i + 1] = dxa[t][1];
        gx[3 * i + 2] = dxa[t][2];
      }
    }
  }
}

// gz[c][k] = sum over blocks b = 0..n_blocks-1, in order, of dzpart[b][c][k]
__global__ void virtual_bwd_dz(const float* __restrict__ dzpart,
                               float* __restrict__ gz, int n_blocks,
                               int n_chan) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n_chan * 3) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += dzpart[(size_t)b * n_chan * 3 + f];
  gz[f] = s;
}

struct Scratch {
  Rows R;
  float* dzpart;
  float* part;
  size_t total;
};

Scratch carve(float* base, int n, int c) {
  Scratch s;
  size_t off = 0;
  auto take = [&](size_t count) {
    float* p = base == nullptr ? nullptr : base + off;
    off += round4(count);
    return p;
  };
  const size_t rows = (size_t)c * n * HID;
  s.R.T1 = take(rows);
  s.R.GMSG = take(rows);
  s.R.MSG = take(rows);
  s.R.GGPX = take(rows);
  s.R.GGPZ = take(rows);
  s.R.GPRE1 = take(rows);
  s.R.DG = take(rows);
  s.R.SXG = take(rows);
  s.R.SZG = take(rows);
  s.dzpart = take((size_t)((n + NODES - 1) / NODES) * c * 3);
  s.part = take((size_t)outer_blocks(n) * OUTER_W);
  s.total = off;
  return s;
}

}  // namespace

extern "C" long long virtual_bwd_scratch_floats(int n_nodes, int n_chan) {
  return (long long)carve(nullptr, n_nodes, n_chan).total;
}

extern "C" int virtual_backward(
    const float* x, const float* h, const float* z, const float* mask,
    const float* w1h, const float* w1d, const float* c1, const float* w2,
    const float* b2, const float* wg1, const float* bg1, const float* wg2,
    const float* wz1, const float* bz1, const float* wz2, const float* gdx,
    const float* gmh, const float* gdz, const float* gms, float* gx,
    float* gh, float* gz, float* gw1h, float* gw1d, float* gc1, float* gw2,
    float* gb2, float* gwg1, float* gbg1, float* gwg2, float* gwz1,
    float* gbz1, float* gwz2, float* scratch, int n_nodes, int n_chan,
    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const size_t smem = SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      virtual_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  Scratch s = carve(scratch, n_nodes, n_chan);
  const int n_blocks = (n_nodes + NODES - 1) / NODES;
  if (n_blocks > 0) {
    virtual_bwd_kernel<<<n_blocks, WARPS * 32, smem, stream>>>(
        x, h, z, mask, w1h, w1d, c1, w2, b2, wg1, bg1, wg2, wz1, bz1, wz2,
        gdx, gmh, gdz, gms, gx, gh, s.dzpart, s.R, n_nodes, n_chan);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  virtual_bwd_dz<<<1, 256, 0, stream>>>(s.dzpart, gz, n_blocks, n_chan);
  for (int c = 0; c < n_chan; ++c) {
    const size_t co = (size_t)c * n_nodes * HID;
    const size_t mo = (size_t)c * HID * HID, vo = (size_t)c * HID;
    outer_sum(h, s.R.GPRE1 + co, nullptr, nullptr, n_nodes, s.part,
              gw1h + mo, gc1 + vo, stream);
    outer_sum(s.R.T1 + co, s.R.GMSG + co, nullptr, nullptr, n_nodes, s.part,
              gw2 + mo, gb2 + vo, stream);
    outer_sum(s.R.MSG + co, s.R.GGPX + co, nullptr, nullptr, n_nodes, s.part,
              gwg1 + mo, gbg1 + vo, stream);
    outer_sum(s.R.MSG + co, s.R.GGPZ + co, nullptr, nullptr, n_nodes, s.part,
              gwz1 + mo, gbz1 + vo, stream);
    outer_sum(nullptr, s.R.DG + co, nullptr, nullptr, n_nodes, s.part,
              nullptr, gw1d + vo, stream);
    outer_sum(nullptr, s.R.SXG + co, nullptr, nullptr, n_nodes, s.part,
              nullptr, gwg2 + vo, stream);
    outer_sum(nullptr, s.R.SZG + co, nullptr, nullptr, n_nodes, s.part,
              nullptr, gwz2 + vo, stream);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
