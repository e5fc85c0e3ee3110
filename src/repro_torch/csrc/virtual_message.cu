// Virtual-node pathway forward (Eq. 5 + the virtual terms of Eqs. 6-8) for
// Hopper (sm_90a), f32 and bf16 modes.
//
// Replaces the Pallas TPU kernel `virtual_pathway_fused` (`_kernel`) of the
// JAX package's kernels/virtual_message.py.  For node i and channel c:
//   rel     = x_i - z_c ;  d2 = |rel|^2
//   msg     = SiLU(h_i . W1h_c + d2 w1d_c + const1_c) . W2_c + b2_c
//   gate_x  = SiLU(msg . Wg1_c + bg1_c) . wg2_c
//   gate_z  = SiLU(msg . Wz1_c + bz1_c) . wz2_c
// and it returns dx_i = mean_c rel gate_x, mh_i = mean_c msg (per node),
// dz_sum_c = sum_i mask_i (z_c - x_i) gate_z and ms_sum_c = sum_i mask_i msg.
//
// Two launches on one stream (bf16: three), no atomics, every sum in a
// fixed order (repeated runs are bitwise equal):
//   1. virtual_fwd_kernel  one CTA of 8 warps per 64-node tile.  It gathers
//      the h tile once (swizzled) and takes the channels in order; per
//      channel four 3xTF32 tensor-core tile products (common.cuh, each
//      k-step summed on its own: STEP_SUM): h.W1h, t1.W2, msg.Wg1,
//      msg.Wz1.  The two gates' dots with wg2 / wz2 are fixed-order row
//      sums, their products rounded on their own (`__fmul_rn`); mh and
//      dx add the channels in order in registers.  The masked column sums
//      (ms: `frag_colsum`; dz: the tile's 64 nodes in order) give one
//      partial row per CTA and channel.
//      Channel c + 1's four weight tiles and seven vectors stream in by
//      cp.async while channel c computes (two slots, ping-pong).
//   2. virtual_block_sums  adds the partial rows in CTA order, a warp a
//      column.
// The bf16 mode (template BF; `precision='bf16'` of the Pallas kernel):
// x, z, h, the stacks, const1, b2, bg1 and bz1 rounded to bf16 (the
// vectors in shared memory when their channel arrives); rel = x - z_c, d2 =
// sum rel^2 and d2 w1d are bfloat16 arithmetic (each op rounded; d2's three
// terms added in f32, as jnp.sum upcasts bf16); t1, msg and the gates'
// SiLU enter their products rounded; mh, ms_sum, dz_sum and dx are f32
// sums of unrounded terms (virtual_message.py:73-86).  Every read of the
// weight, h, t1 and msg tiles is a product's operand, so in bf16 they are
// bf16 tiles (common.cuh: `swz16`, each value rounded once as stored) and
// the four products bf16 tensor-core MMAs (`tile_mma_bf`, m16n8k16 on
// `ldmatrix` fragments, STEP_SUM per k16 step); a third launch,
// virtual_round_stacks (common.cuh), rounds the four stacks once a call,
// so that each channel streams 2-byte tiles straight into shared memory
// (8 KB a tile at 64, half the f32 bytes).
// Shared memory: 8 weight tiles, the h, t1 and msg tiles, ~189 KB at
// Dh = hid = 64 (~65 KB at 32): one CTA an SM; bf16 ~97 KB (~36 KB): two
// CTAs an SM (at most 128 registers a thread).  At N = 8,192 that is 128
// CTAs for 132 SMs, a single short wave; at 131,072 nodes 2,048.  Widths:
// compiled for Dh = hid = W, W = 32 and 64 (the entry point's `width`;
// other widths up to 64 arrive zero-padded, wider ones take panel.cu).
//
// Bound on an H100: per node and channel four 64 x 64 products (32,768
// FLOP) against 268 bytes of x, h and mask read and 268 bytes of dx, mh
// written per node -- ~370 FLOP per byte at C = 3, far above the f32
// ridge, so bound by operations: 0.805 GFLOP at N = 8,192, C = 3, that is
// 0.0121 ms at 67 TFLOP/s f32 and 0.0049 ms for three TF32 MMAs a product
// at 495 TFLOP/s.  The products run on the tensor cores; the SiLU chain,
// the gate dots and the sums on the FP32 units.
#include "common.cuh"

namespace {

template <int W>
constexpr int OUTW = 3 + W;  // partial row: dz (3) | ms (hid)
// row scalars (64 each): x, mask, rel, d2, the dz terms, the dx sums
enum { R_X0 = 0, R_X1, R_X2, R_M, R_RL0, R_RL1, R_RL2, R_D2, R_DZ0, R_DZ1,
       R_DZ2, R_DX0, R_DX1, R_DX2, R_N };
// two slots of W_N weight tiles, the vectors, the h, t1 and msg tiles (f32;
// bf16: the tiles in bf16, half a float an element) and the row data
template <int W, bool BF>
constexpr int SMEM_FLOATS = (2 * W_N * WT<W> + 3 * RT<W>) / (BF ? 2 : 1) +
                            2 * NVEC * W + R_N * TR + 4 * TR + 4 * TR;

// bf16: wbf holds the four stacks rounded (virtual_round_stacks), channel c's
// tile k at wbf + (c W_N + k) W^2
template <int W, bool BF>
__global__ void __launch_bounds__(THREADS, BF ? 2 : 1)
virtual_fwd_kernel(const float* __restrict__ x, const float* __restrict__ h,
                   const float* __restrict__ z, const float* __restrict__ mask,
                   const float* __restrict__ w1h, const float* __restrict__ w1d,
                   const float* __restrict__ c1, const float* __restrict__ w2,
                   const float* __restrict__ b2, const float* __restrict__ wg1,
                   const float* __restrict__ bg1, const float* __restrict__ wg2,
                   const float* __restrict__ wz1, const float* __restrict__ bz1,
                   const float* __restrict__ wz2, float* __restrict__ dx,
                   float* __restrict__ mh, float* __restrict__ part,
                   const Bf* __restrict__ wbf, int n_nodes, int n_chan) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // bf16: the same tiles in bf16, half as many floats
  constexpr int HALF = BF ? 2 : 1;
  float* sW = smem;                                // [2 slots][W_N tiles]
  float* sVec = sW + 2 * W_N * WT<W> / HALF;       // [2 slots][NVEC][W]
  float* tH = sVec + 2 * NVEC * W;
  float* tT1 = tH + RT<W>;
  float* tMSG = tT1 + RT<W>;
  Bf* bW = reinterpret_cast<Bf*>(sW);
  Bf* bH = reinterpret_cast<Bf*>(tH);
  Bf* bT1 = bH + RT<W>;
  Bf* bMSG = bT1 + RT<W>;
  float* rs = tH + 3 * RT<W> / HALF;  // [R_N][64]
  float* rowred = rs + R_N * TR;  // [2 gates][2 halves][64]
  float* colred = rowred + 4 * TR;  // [4 row blocks][64]
  auto R = [&](int k) { return rs + k * TR; };
  auto Wt = [&](int slot, int k) { return sW + (slot * W_N + k) * WT<W>; };
  auto bWt = [&](int slot, int k) { return bW + (slot * W_N + k) * WT<W>; };

  const int tid = threadIdx.x;
  const Lane L = lane_of();
  const int node0 = blockIdx.x * TR;
  const size_t WW = (size_t)W * W;
  auto load_channel = [&](int slot, int c) {
    if constexpr (BF) {
#pragma unroll
      for (int k = 0; k < W_N; ++k)
        tile_load_async_bf<W>(bWt(slot, k), wbf + (c * W_N + k) * WW);
    } else {
      tile_load_async<W>(Wt(slot, W_1H), w1h + c * WW);
      tile_load_async<W>(Wt(slot, W_2), w2 + c * WW);
      tile_load_async<W>(Wt(slot, W_G1), wg1 + c * WW);
      tile_load_async<W>(Wt(slot, W_Z1), wz1 + c * WW);
    }
    load_virtual_vecs<W>(sVec + slot * NVEC * W, c, w1d, c1, b2, bg1, wg2,
                         bz1, wz2);
    async_commit();
  };
  load_channel(0, 0);
  auto node = [&](int i) { return node0 + i < n_nodes ? node0 + i : -1; };
  if constexpr (BF)
    tile_gather_bf<W>(bH, h, TR, node);
  else
    tile_gather<W>(tH, h, node);
  if (tid < TR) {
    const int i = node0 + tid;
    const bool ok = i < n_nodes;
    R(R_X0)[tid] = ok ? rnd<BF>(x[3 * i]) : 0.0f;
    R(R_X1)[tid] = ok ? rnd<BF>(x[3 * i + 1]) : 0.0f;
    R(R_X2)[tid] = ok ? rnd<BF>(x[3 * i + 2]) : 0.0f;
    R(R_M)[tid] = ok ? mask[i] : 0.0f;
    R(R_DX0)[tid] = R(R_DX1)[tid] = R(R_DX2)[tid] = 0.0f;
  }
  Frag<W> mha;  // sum over channels of msg
  frag_zero<W>(mha);

  for (int c = 0; c < n_chan; ++c) {
    const int slot = c & 1;
    float* vec = sVec + slot * NVEC * W;
    async_wait_all();
    __syncthreads();  // channel c's weights are in; channel c - 1 is done
    if (c + 1 < n_chan) load_channel(slot ^ 1, c + 1);
    // bf16: the vectors rounded once (first read after the next sync)
    if (BF) smem_round_bf16(vec, NVEC * W);
    float* out = part + ((size_t)blockIdx.x * n_chan + c) * OUTW<W>;
    if (tid < TR) {
      const float rl0 = rnd<BF>(R(R_X0)[tid] - rnd<BF>(z[3 * c]));
      const float rl1 = rnd<BF>(R(R_X1)[tid] - rnd<BF>(z[3 * c + 1]));
      const float rl2 = rnd<BF>(R(R_X2)[tid] - rnd<BF>(z[3 * c + 2]));
      R(R_RL0)[tid] = rl0;
      R(R_RL1)[tid] = rl1;
      R(R_RL2)[tid] = rl2;
      R(R_D2)[tid] = BF ? bf16_round((bf16_round(rl0 * rl0) +
                                      bf16_round(rl1 * rl1)) +
                                     bf16_round(rl2 * rl2))
                        : rl0 * rl0 + rl1 * rl1 + rl2 * rl2;
    }
    __syncthreads();
    {  // t1 = SiLU(h.W1h + d2 w1d + const1)
      Frag<W> p;
      frag_zero<W>(p);
      if constexpr (BF)
        tile_mma_bf<W, false, false, true>(p, bH, bWt(slot, W_1H), L);
      else
        tile_mma<W, false, false, true>(p, tH, Wt(slot, W_1H), L);
#pragma unroll
      for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = L.col<W>(jn, e);
          // bf16: d2 w1d is a bf16 product (rounded)
          const float u =
              (p[jn][e] + rnd<BF>(R(R_D2)[L.row(e)] * vec[V_W1D * W + j])) +
              vec[V_C1 * W + j];
          p[jn][e] = u * sigm(u);
        }
      if (BF)
        frag_store_bf<W>(bT1, p, L);
      else
        frag_store<W>(tT1, p, L);
    }
    __syncthreads();
    {  // msg = t1.W2 + b2; mh += msg; the masked column sums of msg
      Frag<W> m, w;
      frag_zero<W>(m);
      if constexpr (BF)
        tile_mma_bf<W, false, false, true>(m, bT1, bWt(slot, W_2), L);
      else
        tile_mma<W, false, false, true>(m, tT1, Wt(slot, W_2), L);
#pragma unroll
      for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = L.row(e);
          m[jn][e] += vec[V_B2 * W + L.col<W>(jn, e)];
          mha[jn][e] += m[jn][e];
          w[jn][e] = node0 + r < n_nodes ? m[jn][e] * R(R_M)[r] : 0.0f;
        }
      if (BF)
        frag_store_bf<W>(bMSG, m, L);
      else
        frag_store<W>(tMSG, m, L);
      frag_colsum<W>(w, L, colred);
    }
    __syncthreads();
    {  // the two gates: SiLU(msg.Wg1 + bg1) . wg2, SiLU(msg.Wz1 + bz1) . wz2
      Frag<W> gx, gz;
      frag_zero<W>(gx);
      frag_zero<W>(gz);
      if constexpr (BF) {
        tile_mma_bf<W, false, false, true>(gx, bMSG, bWt(slot, W_G1), L);
        tile_mma_bf<W, false, false, true>(gz, bMSG, bWt(slot, W_Z1), L);
      } else {
        tile_mma<W, false, false, true>(gx, tMSG, Wt(slot, W_G1), L);
        tile_mma<W, false, false, true>(gz, tMSG, Wt(slot, W_Z1), L);
      }
#pragma unroll
      for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = L.col<W>(jn, e);
          const float u = gx[jn][e] + vec[V_BG1 * W + j];
          const float v = gz[jn][e] + vec[V_BZ1 * W + j];
          // rounded on their own: a row's gate does not depend on its
          // tile row (no FMA fused into the row sum per fragment slot)
          gx[jn][e] = __fmul_rn(rnd<BF>(u * sigm(u)), vec[V_WG2 * W + j]);
          gz[jn][e] = __fmul_rn(rnd<BF>(v * sigm(v)), vec[V_WZ2 * W + j]);
        }
      frag_rowsum<W>(gx, L, rowred);
      frag_rowsum<W>(gz, L, rowred + 2 * TR);
    }
    __syncthreads();
    if (tid < TR) {
      const float gxr = rowred[tid] + rowred[TR + tid];
      const float gzr = rowred[2 * TR + tid] + rowred[3 * TR + tid];
      const bool ok = node0 + tid < n_nodes;
      const float m = R(R_M)[tid];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float rl = R(R_RL0 + k)[tid];
        R(R_DX0 + k)[tid] += rl * gxr;
        R(R_DZ0 + k)[tid] = ok ? (-rl * gzr) * m : 0.0f;
      }
    }
    if (tid < W) out[3 + tid] = colsum4(colred, tid);  // ms
    __syncthreads();
    if (tid < 3) {  // dz: the tile's nodes in order
      float s = 0.0f;
      for (int r = 0; r < TR; ++r) s += R(R_DZ0 + tid)[r];
      out[tid] = s;
    }
  }

  const float inv_c = 1.0f / (float)n_chan;
#pragma unroll
  for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int i = node0 + L.row(2 * h2);
      if (i < n_nodes)
        *reinterpret_cast<float2*>(mh + (size_t)i * W + L.col<W>(jn, 0)) =
            make_float2(mha[jn][2 * h2] * inv_c, mha[jn][2 * h2 + 1] * inv_c);
    }
  if (tid < TR && node0 + tid < n_nodes) {
    const int i = node0 + tid;
    dx[3 * i] = R(R_DX0)[tid] * inv_c;
    dx[3 * i + 1] = R(R_DX1)[tid] * inv_c;
    dx[3 * i + 2] = R(R_DX2)[tid] * inv_c;
  }
}

// out[c][f] = the sum over CTAs b = 0..n_blocks-1 of part[b][c][f], added in
// CTA order.  One warp a column: lane l loads the partials of CTAs b0 + l,
// b0 + 32 + l, ... (four loads in flight), and every lane adds the 128 in
// CTA order from shuffles: the adds of a thread-a-column loop, without its
// 2,048 loads one after another at 131,072 nodes.
__global__ void virtual_block_sums(const float* __restrict__ part,
                                   float* __restrict__ dz,
                                   float* __restrict__ ms, int n_blocks,
                                   int n_chan, int width) {
  const int outw = 3 + width;
  const int idx = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (idx >= n_chan * outw) return;  // whole warps leave together
  const size_t stride = (size_t)n_chan * outw;
  float s = 0.0f;
  for (int b0 = 0; b0 < n_blocks; b0 += 128) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int b = b0 + 32 * u + lane;
      v[u] = b < n_blocks ? part[idx + b * stride] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int n = n_blocks - (b0 + 32 * u);  // CTAs left from here
#pragma unroll
      for (int l = 0; l < 32; ++l) {
        const float w = __shfl_sync(FULL, v[u], l);
        if (l < n) s += w;
      }
    }
  }
  if (lane == 0) {
    const int c = idx / outw, f = idx % outw;
    if (f < 3) dz[c * 3 + f] = s;
    else ms[c * width + (f - 3)] = s;
  }
}

template <int W, bool BF>
constexpr int smem_bytes() {
  return SMEM_FLOATS<W, BF> * sizeof(float);
}

template <int W, bool BF>
int launch_forward(const float* x, const float* h, const float* z,
                   const float* mask, const float* w1h, const float* w1d,
                   const float* c1, const float* w2, const float* b2,
                   const float* wg1, const float* bg1, const float* wg2,
                   const float* wz1, const float* bz1, const float* wz2,
                   float* dx, float* mh, float* part, float* scratch,
                   int n_nodes, int n_chan, cudaStream_t stream) {
  const size_t smem = smem_bytes<W, BF>();
  cudaError_t err = cudaFuncSetAttribute(
      virtual_fwd_kernel<W, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_blocks = n_tiles(n_nodes);
  Bf* wbf = reinterpret_cast<Bf*>(scratch);
  if (BF && n_blocks > 0) {
    err = launch_round_stacks<W>(w1h, w2, wg1, wz1, wbf, n_chan, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_blocks > 0) {
    virtual_fwd_kernel<W, BF><<<n_blocks, THREADS, smem, stream>>>(
        x, h, z, mask, w1h, w1d, c1, w2, b2, wg1, bg1, wg2, wz1, bz1, wz2, dx,
        mh, part, wbf, n_nodes, n_chan);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// the scratch of a forward call: the bf16 mode's rounded stacks (bf16,
// half a float an element), none in f32
extern "C" long long virtual_fwd_scratch_floats(int n_chan, int width,
                                                int bf16) {
  return bf16 ? round_stacks_floats(n_chan, width) : 0;
}

// width: the compiled width (32 or 64) that Dh and hid were padded to;
// bf16 != 0: the bf16 mode (scratch: virtual_fwd_scratch_floats)
extern "C" int virtual_forward(const float* x, const float* h, const float* z,
                               const float* mask, const float* w1h,
                               const float* w1d, const float* c1,
                               const float* w2, const float* b2,
                               const float* wg1, const float* bg1,
                               const float* wg2, const float* wz1,
                               const float* bz1, const float* wz2, float* dx,
                               float* mh, float* part, float* scratch,
                               int n_nodes, int n_chan, int width, int bf16,
                               void* stream) {
  if (!(aligned16(h) && aligned16(w1h) && aligned16(w2) && aligned16(wg1) &&
        aligned16(wz1) && aligned16(mh) && (!bf16 || aligned16(scratch))))
    return (int)cudaErrorMisalignedAddress;
  return with_width(width, bf16, [&](auto w, auto bf) {
    return launch_forward<decltype(w)::value, decltype(bf)::value>(
        x, h, z, mask, w1h, w1d, c1, w2, b2, wg1, bg1, wg2, wz1, bz1, wz2, dx,
        mh, part, scratch, n_nodes, n_chan, (cudaStream_t)stream);
  });
}

// the CTAs of the forward an SM holds at once, as the card reports it for
// its registers and shared memory (-1 on an error)
extern "C" int virtual_fwd_occupancy(int width, int bf16) {
  return with_width(width, bf16, [](auto w, auto bf) {
    constexpr int W = decltype(w)::value;
    constexpr bool B = decltype(bf)::value;
    const int bytes = smem_bytes<W, B>();
    int n = -1;
    if (cudaFuncSetAttribute(virtual_fwd_kernel<W, B>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, virtual_fwd_kernel<W, B>, THREADS, bytes) != cudaSuccess)
      return -1;
    return n;
  });
}

extern "C" int virtual_sums(const float* part, float* dz, float* ms,
                            int n_blocks, int n_chan, int width,
                            void* stream) {
  const int warps = n_chan * (3 + width);  // one a column
  virtual_block_sums<<<(warps + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
      part, dz, ms, n_blocks, n_chan, width);
  return (int)cudaGetLastError();
}

extern "C" int virtual_nodes_per_block() { return TR; }
extern "C" int virtual_partial_width(int width) { return 3 + width; }

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
