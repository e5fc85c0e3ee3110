// Virtual-node pathway backward for Hopper (sm_90a), f32 and bf16 modes.
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
// Two launches, one stream, no atomics, every sum in an order fixed by the
// inputs (repeated runs are bitwise equal); bf16: three:
//   0. virtual_round_stacks  (bf16 only, common.cuh) rounds the four weight
//      stacks W1h, W2, Wg1, Wz1 once a call into the scratch, as #3 does.
//   1. virtual_bwd_kernel  one CTA of 8 warps per 64-node tile, the
//      channels in order.  Per channel it recomputes the forward chain and
//      backpropagates as 64 x 64 tile products of its node tile (common.cuh,
//      tensor cores, 3xTF32): .W1h, .W2, .Wg1, .Wz1 and the cotangents
//      .Wg1^T, .Wz1^T, .W2^T, .W1h^T (the transposes are the same tiles read
//      in the other operand layout), then the four weight-gradient
//      partials of the tile -- h^T g_pre1, t1^T g_msg, msg^T g_gpx,
//      msg^T g_gpz -- as four more products, and the seven column sums
//      (const1, b2, bg1, bz1, w1d, wg2, wz2) and the dz sum.  The CTA
//      writes one partial per channel (16,836 floats) and, after the last
//      channel, the nodes' dx and dh.  Nothing per node and channel leaves
//      the chip.
//   2. virtual_bwd_reduce  adds the CTAs' partials in CTA order: every
//      weight gradient and dz.
// The bf16 mode (template BF; `precision='bf16'` of `_bwd_kernel`): the
// forward's rounding points in the recompute (virtual_message.cu), and
// every product's operands rounded: g_gx, g_gz, g_gpx, g_gpz, g_msg and
// g_pre1 enter their products rounded, as do h, t1, msg and the weights,
// while the column sums (b2, bg1, bz1, const1, w1d), g_d2 and g_rel take
// unrounded terms (virtual_message.py:155-230); the cotangents stay f32.
// Every read of the weight and activation tiles is a product's operand, so
// in bf16 they are bf16 tiles (common.cuh: `swz16`, each value rounded
// once, as it is stored) and the twelve products bf16 tensor-core MMAs
// (`tile_mma_bf`, m16n8k16 on `ldmatrix` fragments); the column sums and
// row dots read the unrounded f32 fragments, never the tiles.  In bf16
// the two gates run one after the other, and dh sums over the channels in
// gh (read back by the thread that wrote it), so that few fragments are
// live at once (two CTAs an SM hold 128 registers a thread).
// Weights stream in with 16-byte cp.async as soon as the previous channel
// is done with their slot (bf16: 2-byte tiles from the rounded stacks):
// W1h (needed first) ping-pongs between two slots, Wg1 / Wz1 / W2 of
// channel c + 1 load while channel c finishes.
// Shared memory: 5 weight tiles, 6 activation tiles (h, t1, msg, g_gpx
// -- later g_pre1 --, g_gpz, g_msg), row scalars and reduction rows:
// ~194 KB at Dh = hid = 64 (~80 KB at 32), one CTA an SM; bf16 ~102 KB
// (~37 KB): two CTAs an SM.  N = 8,192 gives 128 CTAs for 132 SMs.
// Widths: compiled for W = 32 and 64, as virtual_message.cu.
//
// Bound on an H100: per node and channel twelve 64 x 64 products (four
// recomputed, four cotangents, four weight gradients), ~98K FLOP against
// ~800 bytes of node inputs and outputs: bound by operations.  All twelve
// run on the tensor cores (TF32, three MMAs each: 3 x the FLOP at the
// 495 TFLOP/s TF32 rate; bf16: one MMA at 989 TFLOP/s); the elementwise
// SiLU chain, the row dots and the column sums run on the FP32 units.
// The partials add 25.8 MB of writes and reads at N = 8,192, C = 3 (128
// CTAs x 3 channels x 16,836 floats), which stay in the 50 MB L2.  On the
// card the twelve products take about nine tenths of a channel's time in
// f32 (tools/phase_trace.py).
#include "common.cuh"

namespace {

// partial of one CTA and channel: W1h | W2 | Wg1 | Wz1 | c1 | b2 | bg1 |
// bz1 | w1d | wg2 | wz2 | dz (3) + 1 pad
// (the matrices W x W, the vectors W long)
template <int W>
struct VirtPart {
  static constexpr int W1H = 0, W2 = W * W, WG1 = 2 * W * W, WZ1 = 3 * W * W,
                       C1 = 4 * W * W, B2 = C1 + W, BG1 = B2 + W,
                       BZ1 = BG1 + W, W1D = BZ1 + W, WG2 = W1D + W,
                       WZ2 = WG2 + W, DZ = WZ2 + W, size = DZ + 4;
};
// row scalars (64 each)
enum { R_X0 = 0, R_X1, R_X2, R_M, R_UX0, R_UX1, R_UX2, R_RL0, R_RL1, R_RL2,
       R_D2, R_GGX, R_GGZ, R_GX, R_GZ, R_DX0, R_DX1, R_DX2, R_GR0, R_GR1,
       R_GR2, R_N };
// 5 weight and 6 activation tiles (bf16: half a float an element), the
// vectors, the row scalars and the reduction rows
template <int W, bool BF>
constexpr int SMEM_FLOATS = (5 * WT<W> + 6 * RT<W>) / (BF ? 2 : 1) +
                            2 * NVEC * W + R_N * TR + 2 * 2 * TR + 4 * 4 * TR;

// the tiles' element: f32, or bf16 in the bf16 mode
template <bool BF>
using Tile = std::conditional_t<BF, Bf, float>;

// acc += op(A) . op(B): 3xTF32 in f32 (`tile_mma`), bf16 tensor-core MMAs
// in bf16 (`tile_mma_bf`); both without STEP_SUM, as the f32 mode has
// always run: no sum of this kernel adds up more than 12 MMA results (dh
// over the channels), a bias toward zero of a few ulp
template <int W, bool TA, bool TB, bool BF>
__device__ __forceinline__ void mma(Frag<W>& acc, const Tile<BF>* A,
                                    const Tile<BF>* B, const Lane& L) {
  if constexpr (BF)
    tile_mma_bf<W, TA, TB>(acc, A, B, L);
  else
    tile_mma<W, TA, TB>(acc, A, B, L);
}

template <int W, bool BF>
__device__ __forceinline__ void store(Tile<BF>* tile, const Frag<W>& v,
                                      const Lane& L) {
  if constexpr (BF)
    frag_store_bf<W>(tile, v, L);
  else
    frag_store<W>(tile, v, L);
}

// bf16: wbf holds the four stacks rounded (virtual_round_stacks), channel
// c's tile k at wbf + (c W_N + k) W^2
template <int W, bool BF>
__global__ void __launch_bounds__(THREADS, BF ? 2 : 1)
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
                   float* __restrict__ gh, float* __restrict__ part,
                   const Bf* __restrict__ wbf, int n_nodes, int n_chan) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  using VP = VirtPart<W>;
  using T = Tile<BF>;
  constexpr int HALF = BF ? 2 : 1;  // bf16: the tiles in half the floats
  T* sW1h = reinterpret_cast<T*>(smem);  // [2 slots], then W2, Wg1, Wz1
  T* sW2 = sW1h + 2 * WT<W>;
  T* sWg1 = sW2 + WT<W>;
  T* sWz1 = sWg1 + WT<W>;
  float* sVec = smem + 5 * WT<W> / HALF;  // [2 slots][NVEC][W]
  T* tH = reinterpret_cast<T*>(sVec + 2 * NVEC * W);
  T* tT1 = tH + RT<W>;
  T* tMSG = tT1 + RT<W>;
  T* tGX = tMSG + RT<W>;  // g_gpx, then g_pre1
  T* tGZ = tGX + RT<W>;
  T* tGM = tGZ + RT<W>;
  float* rs = sVec + 2 * NVEC * W + 6 * RT<W> / HALF;  // [R_N][64] row scalars
  float* rowred = rs + R_N * TR;      // [2 sums][2 halves][64]
  float* colred = rowred + 4 * TR;    // [4 sums][4 row blocks][64]
  auto R = [&](int k) { return rs + k * TR; };

  const int tid = threadIdx.x;
  const Lane L = lane_of();
  const int node0 = blockIdx.x * TR;
  const float inv_c = 1.0f / (float)n_chan;

  auto load_vecs = [&](float* dst, int c) {
    load_virtual_vecs<W>(dst, c, w1d, c1, b2, bg1, wg2, bz1, wz2);
  };
  const size_t WW = (size_t)W * W;
  // channel c's weight tile k (W_1H, W_2, W_G1, W_Z1) into dst (cp.async;
  // the caller commits)
  const float* stack[W_N] = {w1h, w2, wg1, wz1};
  auto load_w = [&](T* dst, int k, int c) {
    if constexpr (BF)
      tile_load_async_bf<W>(dst, wbf + ((size_t)c * W_N + k) * WW);
    else
      tile_load_async<W>(dst, stack[k] + c * WW);
  };
  load_w(sW1h, W_1H, 0);
  load_w(sW2, W_2, 0);
  load_w(sWg1, W_G1, 0);
  load_w(sWz1, W_Z1, 0);
  load_vecs(sVec, 0);
  async_commit();
  auto node = [&](int i) { return node0 + i < n_nodes ? node0 + i : -1; };
  if constexpr (BF)
    tile_gather_bf<W>(tH, h, TR, node);
  else
    tile_gather<W>(tH, h, node);
  if (tid < TR) {
    const int i = node0 + tid;
    const bool ok = i < n_nodes;
    R(R_X0)[tid] = ok ? rnd<BF>(x[3 * i]) : 0.0f;
    R(R_X1)[tid] = ok ? rnd<BF>(x[3 * i + 1]) : 0.0f;
    R(R_X2)[tid] = ok ? rnd<BF>(x[3 * i + 2]) : 0.0f;
    R(R_M)[tid] = ok ? mask[i] : 0.0f;
    R(R_UX0)[tid] = ok ? gdx[3 * i] * inv_c : 0.0f;
    R(R_UX1)[tid] = ok ? gdx[3 * i + 1] * inv_c : 0.0f;
    R(R_UX2)[tid] = ok ? gdx[3 * i + 2] * inv_c : 0.0f;
    R(R_DX0)[tid] = R(R_DX1)[tid] = R(R_DX2)[tid] = 0.0f;
  }
  // dh = sum over the channels of g_pre1.W1h^T: in registers in f32; in
  // bf16 kept in gh between the channels (f32, each thread its own
  // fragment positions of the tile's rows, read back exactly as it wrote
  // them), so that no fragment stays live across a channel (two CTAs an
  // SM allow 128 registers a thread, and an f32 tile of dh in shared
  // memory would not fit beside them)
  Frag<W> dh;
  frag_zero<W>(dh);
  auto dh_rows = [&](Frag<W>& v, bool store) {
#pragma unroll
    for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int i = node0 + L.row(2 * h2);
        float2* g = reinterpret_cast<float2*>(gh + (size_t)i * W +
                                              L.col<W>(jn, 0));
        if (store && i < n_nodes)
          *g = make_float2(v[jn][2 * h2], v[jn][2 * h2 + 1]);
        if (!store) {
          const float2 a = i < n_nodes ? *g : make_float2(0.f, 0.f);
          v[jn][2 * h2] = a.x;
          v[jn][2 * h2 + 1] = a.y;
        }
      }
  };

  for (int c = 0; c < n_chan; ++c) {
    const int buf = c & 1;
    const T* W1h = sW1h + buf * WT<W>;
    float* vec = sVec + buf * NVEC * W;
    async_wait_all();
    __syncthreads();  // channel c's weights are in; channel c - 1 is done
    if (c + 1 < n_chan) {
      load_w(sW1h + (buf ^ 1) * WT<W>, W_1H, c + 1);
      load_vecs(sVec + (buf ^ 1) * NVEC * W, c + 1);
      async_commit();
    }
    // bf16: the vectors rounded once (first read after the next sync)
    if (BF) smem_round_bf16(vec, NVEC * W);
    float* P = part + ((size_t)blockIdx.x * n_chan + c) * VP::size;
    if (tid < TR) {
      const float rl0 = rnd<BF>(R(R_X0)[tid] - rnd<BF>(z[3 * c]));
      const float rl1 = rnd<BF>(R(R_X1)[tid] - rnd<BF>(z[3 * c + 1]));
      const float rl2 = rnd<BF>(R(R_X2)[tid] - rnd<BF>(z[3 * c + 2]));
      const float m = R(R_M)[tid];
      R(R_RL0)[tid] = rl0;
      R(R_RL1)[tid] = rl1;
      R(R_RL2)[tid] = rl2;
      R(R_D2)[tid] = BF ? bf16_round((bf16_round(rl0 * rl0) +
                                      bf16_round(rl1 * rl1)) +
                                     bf16_round(rl2 * rl2))
                        : rl0 * rl0 + rl1 * rl1 + rl2 * rl2;
      R(R_GGX)[tid] = R(R_UX0)[tid] * rl0 + R(R_UX1)[tid] * rl1 +
                      R(R_UX2)[tid] * rl2;
      R(R_GGZ)[tid] = (-m * gdz[3 * c]) * rl0 + (-m * gdz[3 * c + 1]) * rl1 +
                      (-m * gdz[3 * c + 2]) * rl2;
    }
    __syncthreads();
    // ---- recompute: pre = h.W1h + d2 w1d + c1, t1 = silu(pre) ----------
    Frag<W> pre;  // then silu'(pre)
    frag_zero<W>(pre);
    mma<W, false, false, BF>(pre, tH, W1h, L);
#pragma unroll
    for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = L.row(e), j = L.col<W>(jn, e);
        pre[jn][e] =
            (pre[jn][e] + rnd<BF>(R(R_D2)[r] * vec[V_W1D * W + j])) +
            vec[V_C1 * W + j];
      }
    {
      Frag<W> t1;
#pragma unroll
      for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) silu_both(pre[jn][e], t1[jn][e], pre[jn][e]);
      store<W, BF>(tT1, t1, L);
    }
    __syncthreads();
    // ---- msg = t1.W2 + b2 -------------------------------------------------
    {
      Frag<W> m;
      frag_zero<W>(m);
      mma<W, false, false, BF>(m, tT1, sW2, L);
#pragma unroll
      for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) m[jn][e] += vec[V_B2 * W + L.col<W>(jn, e)];
      store<W, BF>(tMSG, m, L);
    }
    __syncthreads();
    // ---- the two gate MLPs and their cotangents -------------------------
    if constexpr (BF) {  // one gate at a time: fewer live fragments
      static_assert(V_BZ1 == V_BG1 + 2 && V_WZ2 == V_WG2 + 2 &&
                        R_GGZ == R_GGX + 1,
                    "the gates' vectors and row scalars in step");
#pragma unroll 1
      for (int k = 0; k < 2; ++k) {
        // Wg1 / Wz1 (adjacent tiles), g_gpx / g_gpz (adjacent tiles), the
        // vectors bg1 / bz1, wg2 / wz2 and the row scalar g_gx / g_gz
        const int vb = V_BG1 + 2 * k, vw = V_WG2 + 2 * k, rg = R_GGX + k;
        Frag<W> p;  // msg.Wg1 + bg1, then its SiLU derivative
        frag_zero<W>(p);
        mma<W, false, false, BF>(p, tMSG, sWg1 + k * WT<W>, L);
        Frag<W> sg;  // its SiLU
#pragma unroll
        for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            silu_both(p[jn][e] + vec[vb * W + L.col<W>(jn, e)], sg[jn][e],
                      p[jn][e]);
        {
          Frag<W> w;  // the gate's terms
#pragma unroll
          for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              w[jn][e] = rnd<BF>(sg[jn][e]) * vec[vw * W + L.col<W>(jn, e)];
          frag_rowsum<W>(w, L, rowred + 2 * k * TR);
        }
#pragma unroll
        for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = L.row(e), j = L.col<W>(jn, e);
            // bf16: g_gx, g_gz and silu enter their products rounded
            const float gg = rnd<BF>(R(rg)[r]);
            p[jn][e] = (gg * vec[vw * W + j]) * p[jn][e];  // g_gpx / g_gpz
            sg[jn][e] = rnd<BF>(sg[jn][e]) * gg;
          }
        store<W, BF>(tGX + k * RT<W>, p, L);
        frag_colsum<W>(p, L, colred + 4 * k * TR);
        frag_colsum<W>(sg, L, colred + (8 + 4 * k) * TR);
      }
    } else {
      Frag<W> px, pz;
      frag_zero<W>(px);
      frag_zero<W>(pz);
      mma<W, false, false, BF>(px, tMSG, sWg1, L);
      mma<W, false, false, BF>(pz, tMSG, sWz1, L);
      Frag<W> sx, sz;  // silu(px), silu(pz); px, pz become their derivatives
#pragma unroll
      for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = L.col<W>(jn, e);
          silu_both(px[jn][e] + vec[V_BG1 * W + j], sx[jn][e], px[jn][e]);
          silu_both(pz[jn][e] + vec[V_BZ1 * W + j], sz[jn][e], pz[jn][e]);
        }
      Frag<W> wx, wz;
#pragma unroll
      for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = L.col<W>(jn, e);
          wx[jn][e] = sx[jn][e] * vec[V_WG2 * W + j];
          wz[jn][e] = sz[jn][e] * vec[V_WZ2 * W + j];
        }
      frag_rowsum<W>(wx, L, rowred);
      frag_rowsum<W>(wz, L, rowred + 2 * TR);
      Frag<W> qx, qz;
#pragma unroll
      for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = L.row(e), j = L.col<W>(jn, e);
          const float ggx = R(R_GGX)[r], ggz = R(R_GGZ)[r];
          qx[jn][e] = (ggx * vec[V_WG2 * W + j]) * px[jn][e];
          qz[jn][e] = (ggz * vec[V_WZ2 * W + j]) * pz[jn][e];
          sx[jn][e] = sx[jn][e] * ggx;
          sz[jn][e] = sz[jn][e] * ggz;
        }
      frag_store<W>(tGX, qx, L);
      frag_store<W>(tGZ, qz, L);
      frag_colsum<W>(qx, L, colred);
      frag_colsum<W>(qz, L, colred + 4 * TR);
      frag_colsum<W>(sx, L, colred + 8 * TR);
      frag_colsum<W>(sz, L, colred + 12 * TR);
    }
    __syncthreads();
    if (tid < TR) {
      R(R_GX)[tid] = rowred[tid] + rowred[TR + tid];
      R(R_GZ)[tid] = rowred[2 * TR + tid] + rowred[3 * TR + tid];
    }
    if (tid < W) {
      P[VP::BG1 + tid] = colsum4(colred, tid);
      P[VP::BZ1 + tid] = colsum4(colred + 4 * TR, tid);
      P[VP::WG2 + tid] = colsum4(colred + 8 * TR, tid);
      P[VP::WZ2 + tid] = colsum4(colred + 12 * TR, tid);
    }
    // ---- g_msg = g_mh / C + m g_ms + g_gpx.Wg1^T + g_gpz.Wz1^T ----------
    {
      Frag<W> gm;
      frag_zero<W>(gm);
      mma<W, false, true, BF>(gm, tGX, sWg1, L);
      mma<W, false, true, BF>(gm, tGZ, sWz1, L);
#pragma unroll
      for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = L.row(2 * h2), j = L.col<W>(jn, 0);
          const int i = node0 + r;
          float2 g = make_float2(0.f, 0.f);
          if (i < n_nodes)
            g = *reinterpret_cast<const float2*>(gmh + (size_t)i * W + j);
          const float m = R(R_M)[r];
          gm[jn][2 * h2] += g.x * inv_c + m * gms[c * W + j];
          gm[jn][2 * h2 + 1] += g.y * inv_c + m * gms[c * W + j + 1];
        }
      store<W, BF>(tGM, gm, L);
      __syncthreads();  // colred / rowred reads above are done
      frag_colsum<W>(gm, L, colred);
    }
    __syncthreads();
    if (tid < W) P[VP::B2 + tid] = colsum4(colred, tid);
    // ---- weight partials of the message and gate MLPs ----------------
    {
      Frag<W> a;
      frag_zero<W>(a);
      mma<W, true, false, BF>(a, tMSG, tGX, L);
      frag_store_global<W>(P + VP::WG1, a, L);
      frag_zero<W>(a);
      mma<W, true, false, BF>(a, tMSG, tGZ, L);
      frag_store_global<W>(P + VP::WZ1, a, L);
      frag_zero<W>(a);
      mma<W, true, false, BF>(a, tT1, tGM, L);
      frag_store_global<W>(P + VP::W2, a, L);
    }
    // ---- g_pre1 = (g_msg.W2^T) silu'(pre) ----------------------------------
    Frag<W> gp;
    frag_zero<W>(gp);
    mma<W, false, true, BF>(gp, tGM, sW2, L);
    __syncthreads();  // msg / g_gpx / g_gpz / Wg1 / Wz1 / colred are free
    if (c + 1 < n_chan) {
      load_w(sWg1, W_G1, c + 1);
      load_w(sWz1, W_Z1, c + 1);
      async_commit();
    }
    {
      Frag<W> dg, gw;
#pragma unroll
      for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = L.row(e), j = L.col<W>(jn, e);
          gp[jn][e] *= pre[jn][e];
          dg[jn][e] = R(R_D2)[r] * gp[jn][e];
          gw[jn][e] = gp[jn][e] * vec[V_W1D * W + j];
        }
      store<W, BF>(tGX, gp, L);
      frag_rowsum<W>(gw, L, rowred);
      frag_colsum<W>(gp, L, colred);
      frag_colsum<W>(dg, L, colred + 4 * TR);
    }
    __syncthreads();
    if (c + 1 < n_chan) {
      load_w(sW2, W_2, c + 1);
      async_commit();
    }
    if (tid < W) {
      P[VP::C1 + tid] = colsum4(colred, tid);
      P[VP::W1D + tid] = colsum4(colred + 4 * TR, tid);
    }
    if (tid < TR) {
      const float g_d2 = rowred[tid] + rowred[TR + tid];
      const float m = R(R_M)[tid];
      const float gxr = R(R_GX)[tid], gzr = R(R_GZ)[tid];
      const float rl[3] = {R(R_RL0)[tid], R(R_RL1)[tid], R(R_RL2)[tid]};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float uz = -m * gdz[3 * c + k];
        const float g_rel =
            R(R_UX0 + k)[tid] * gxr + uz * gzr + 2.0f * rl[k] * g_d2;
        R(R_DX0 + k)[tid] += g_rel;
        R(R_GR0 + k)[tid] = node0 + tid < n_nodes ? g_rel : 0.0f;
      }
    }
    // ---- dh += g_pre1.W1h^T; the W1h partial h^T g_pre1 ----------------
    if constexpr (BF) {
      Frag<W> d;
      if (c == 0)
        frag_zero<W>(d);
      else
        dh_rows(d, false);
      mma<W, false, true, BF>(d, tGX, W1h, L);
      dh_rows(d, true);
    } else {
      mma<W, false, true, BF>(dh, tGX, W1h, L);
    }
    {
      Frag<W> a;
      frag_zero<W>(a);
      mma<W, true, false, BF>(a, tH, tGX, L);
      frag_store_global<W>(P + VP::W1H, a, L);
    }
    __syncthreads();
    if (tid < 3) {  // dz: nodes in order
      float s = 0.0f;
      for (int r = 0; r < TR; ++r) s += R(R_GR0 + tid)[r];
      P[VP::DZ + tid] = -s;
    }
  }

  if (!BF || n_chan == 0) dh_rows(dh, true);
  if (tid < TR && node0 + tid < n_nodes) {
    const int i = node0 + tid;
    gx[3 * i] = R(R_DX0)[tid];
    gx[3 * i + 1] = R(R_DX1)[tid];
    gx[3 * i + 2] = R(R_DX2)[tid];
  }
}

struct Outs {
  float *gz, *gw1h, *gw1d, *gc1, *gw2, *gb2, *gwg1, *gbg1, *gwg2, *gwz1,
      *gbz1, *gwz2;
};

// every weight gradient and dz: the CTAs' partials added in CTA order
template <int W>
__global__ void virtual_bwd_reduce(const float* __restrict__ part, Outs o,
                                   int n_blocks, int n_chan) {
  using VP = VirtPart<W>;
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n_chan * VP::size) return;
  const int c = f / VP::size, k = f % VP::size;
  if (k >= VP::DZ + 3) return;
  const float s = sum_strided(part + (size_t)c * VP::size + k,
                              (size_t)n_chan * VP::size, n_blocks);
  const size_t mo = (size_t)c * W * W, vo = (size_t)c * W;
  if (k < VP::W2) o.gw1h[mo + k] = s;
  else if (k < VP::WG1) o.gw2[mo + k - VP::W2] = s;
  else if (k < VP::WZ1) o.gwg1[mo + k - VP::WG1] = s;
  else if (k < VP::C1) o.gwz1[mo + k - VP::WZ1] = s;
  else if (k < VP::B2) o.gc1[vo + k - VP::C1] = s;
  else if (k < VP::BG1) o.gb2[vo + k - VP::B2] = s;
  else if (k < VP::BZ1) o.gbg1[vo + k - VP::BG1] = s;
  else if (k < VP::W1D) o.gbz1[vo + k - VP::BZ1] = s;
  else if (k < VP::WG2) o.gw1d[vo + k - VP::W1D] = s;
  else if (k < VP::WZ2) o.gwg2[vo + k - VP::WG2] = s;
  else if (k < VP::DZ) o.gwz2[vo + k - VP::WZ2] = s;
  else o.gz[3 * c + k - VP::DZ] = s;
}

template <int W, bool BF>
constexpr int smem_bytes() {
  return SMEM_FLOATS<W, BF> * sizeof(float);
}

// the scratch: the partials of every CTA and channel, then (bf16) the
// rounded stacks
template <int W>
long long partial_floats(int n_nodes, int n_chan) {
  return (long long)n_tiles(n_nodes) * n_chan * VirtPart<W>::size;
}

template <int W>
long long scratch_floats(int n_nodes, int n_chan, bool bf16) {
  const long long parts = round4((size_t)partial_floats<W>(n_nodes, n_chan));
  return bf16 ? parts + round_stacks_floats(n_chan, W) : parts;
}

template <int W, bool BF>
int launch_backward(const float* x, const float* h, const float* z,
                    const float* mask, const float* w1h, const float* w1d,
                    const float* c1, const float* w2, const float* b2,
                    const float* wg1, const float* bg1, const float* wg2,
                    const float* wz1, const float* bz1, const float* wz2,
                    const float* gdx, const float* gmh, const float* gdz,
                    const float* gms, float* gx, float* gh, const Outs& o,
                    float* scratch, int n_nodes, int n_chan,
                    cudaStream_t stream) {
  const size_t smem = smem_bytes<W, BF>();
  cudaError_t err = cudaFuncSetAttribute(
      virtual_bwd_kernel<W, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_blocks = n_tiles(n_nodes);
  Bf* wbf = reinterpret_cast<Bf*>(
      scratch + round4((size_t)partial_floats<W>(n_nodes, n_chan)));
  if (BF && n_blocks > 0) {
    err = launch_round_stacks<W>(w1h, w2, wg1, wz1, wbf, n_chan, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_blocks > 0) {
    virtual_bwd_kernel<W, BF><<<n_blocks, THREADS, smem, stream>>>(
        x, h, z, mask, w1h, w1d, c1, w2, b2, wg1, bg1, wg2, wz1, bz1, wz2,
        gdx, gmh, gdz, gms, gx, gh, scratch, wbf, n_nodes, n_chan);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int total = n_chan * VirtPart<W>::size;
  virtual_bwd_reduce<W><<<(total + 255) / 256, 256, 0, stream>>>(
      scratch, o, n_blocks, n_chan);
  return (int)cudaGetLastError();
}

}  // namespace

// the scratch of a backward call: the CTAs' partials and, in bf16, the
// rounded stacks (-1: no compiled width)
extern "C" long long virtual_bwd_scratch_floats(int n_nodes, int n_chan,
                                                int width, int bf16) {
  if (width == 32) return scratch_floats<32>(n_nodes, n_chan, bf16 != 0);
  if (width == 64) return scratch_floats<64>(n_nodes, n_chan, bf16 != 0);
  return -1;
}

// the CTAs of the backward an SM holds at once, as the card reports it for
// its registers and shared memory (-1 on an error)
extern "C" int virtual_bwd_occupancy(int width, int bf16) {
  return with_width(width, bf16, [](auto w, auto bf) {
    constexpr int W = decltype(w)::value;
    constexpr bool B = decltype(bf)::value;
    const int bytes = smem_bytes<W, B>();
    int n = -1;
    if (cudaFuncSetAttribute(virtual_bwd_kernel<W, B>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, virtual_bwd_kernel<W, B>, THREADS, bytes) != cudaSuccess)
      return -1;
    return n;
  });
}

// width: the compiled width (32 or 64) that Dh and hid were padded to;
// bf16 != 0: the bf16 mode (scratch: virtual_bwd_scratch_floats)
extern "C" int virtual_backward(
    const float* x, const float* h, const float* z, const float* mask,
    const float* w1h, const float* w1d, const float* c1, const float* w2,
    const float* b2, const float* wg1, const float* bg1, const float* wg2,
    const float* wz1, const float* bz1, const float* wz2, const float* gdx,
    const float* gmh, const float* gdz, const float* gms, float* gx,
    float* gh, float* gz, float* gw1h, float* gw1d, float* gc1, float* gw2,
    float* gb2, float* gwg1, float* gbg1, float* gwg2, float* gwz1,
    float* gbz1, float* gwz2, float* scratch, int n_nodes, int n_chan,
    int width, int bf16, void* stream_ptr) {
  if (!(aligned16(h) && aligned16(w1h) && aligned16(w2) && aligned16(wg1) &&
        aligned16(wz1) && aligned16(gmh) && aligned16(gh) &&
        aligned16(scratch)))
    return (int)cudaErrorMisalignedAddress;
  const Outs o{gz, gw1h, gw1d, gc1, gw2, gb2, gwg1, gbg1, gwg2, gwz1, gbz1,
               gwz2};
  return with_width(width, bf16, [&](auto w, auto bf) {
    return launch_backward<decltype(w)::value, decltype(bf)::value>(
        x, h, z, mask, w1h, w1d, c1, w2, b2, wg1, bg1, wg2, wz1, bz1, wz2,
        gdx, gmh, gdz, gms, gx, gh, o, scratch, n_nodes, n_chan,
        (cudaStream_t)stream_ptr);
  });
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
