// Real-real edge pathway backward for Hopper (sm_90a), f32 and bf16 modes.
//
// Replaces the Pallas TPU kernel `edge_pathway_bwd_fused` (its receiver
// pass `_edge_bwd_r_kernel` and sender pass `_edge_bwd_s_kernel`, sharing
// `_edge_bwd_common`) of the JAX package's kernels/edge_message.py.  Given
// the forward's primals, its `deg` output and the cotangents (g_dx, g_mh)
// it returns the 11 gradients (x, h, W1r, W1s, w1d, b1, W2, b2, Wg1, bg1,
// wg2).  Per live edge e = (r <- s) with upstream u = g_*[r] / max(deg_r, 1)
// * em_e it recomputes msg and gate and backpropagates exactly as
// `_edge_bwd_common` does (clip vjp passes only inside [-clamp, clamp],
// inv1p adds the d kf / d d2 term).
//
// Four launches on one stream, no atomics, every sum in an order fixed by
// the inputs and the CTA count (repeated runs are bitwise equal); gx and gh
// do not depend on the CTA count either (an edge's g_pre1 and g_rel do not
// depend on its tile row: the products feeding a row sum are rounded on
// their own, `__fmul_rn`), the weight gradients' order of partials does:
//   1. node_proj   (common.cuh, shared with the forward) CTA per 64
//                  nodes: P = h.W1r, Q = h.W1s (the forward's
//                  pre-activation is P_r + Q_s + d2 w1d + b1), and the
//                  receiver row of each of their slots.
//   2. edge pass   `n_blocks` CTAs (fixed by the caller, never by the
//                  card) split the live slot range [0, indptr[N]) into
//                  equal index ranges.  A CTA packs the live slots of its
//                  range, in slot order, into 64-edge tiles
//                  (`for_live_tiles`, common.cuh: a block-wide ballot scan;
//                  a slot's receiver comes from the row map node_proj
//                  writes, so a row may cross ranges).
//                  Per tile: gather P[r] + Q[s] + d2 w1d + b1, then as tile
//                  products t1.W2, msg.Wg1, g_gp1.Wg1^T, g_msg.W2^T and
//                  the weight partials t1^T g_msg, msg^T g_gp1, kept in
//                  registers across the CTA's tiles; the column sums (b2,
//                  bg1, wg2, b1, w1d) likewise.  Per live slot it stores
//                  only g_pre1 (64 floats) and g_rel (3 + 1 pad).
//   3. node pass   CTA per 64 nodes: sums each node's receiver segment (G,
//                  dx_r) in slot order and its sender segment (S, dx_s) in
//                  `csr_sender_perm` order (8 lanes per node, four rows
//                  in flight), then gh = G.W1r^T + S.W1s^T and the
//                  partials h^T G, h^T S as tile products.
//   4. reduce      adds the edge-pass partials in CTA order, then the
//                  node-pass partials in CTA order: every weight gradient.
// The bf16 mode (template BF; `precision='bf16'` of `_edge_bwd_common` and
// its two passes): the forward's rounding points in the recompute
// (edge_message.cu); the gathered inv, g_mh and g_dx rounded (the
// reference gathers them with one-hot matmuls); every product's operands
// rounded (tile_mma_bf), while the column sums (b1, b2, bg1) and g_gate,
// g_rel take unrounded terms (edge_message.py:488-609).  The node pass's
// summands are the reference's scatter operands, rounded: bf16(g_rel),
// bf16(g_pre1) and the per-edge products bf16(bf16(g_pre1) W1r^T) /
// bf16(bf16(g_pre1) W1s^T), which the edge pass forms as two more tile
// products (W1r and W1s resident too) and stores per slot; so in bf16
// the node pass sums gh instead of multiplying the summed G and S, and
// forms h^T G, h^T S with h rounded and G, S in f32 (3xTF32: the
// reference's sum of bf16 products, exact in f32).
// The bf16 edge pass keeps its tiles in bf16 (common.cuh): the four weight
// tiles W2, Wg1, W1r, W1s rounded once as they are stored, and t1, msg /
// g_msg, g_gp1 / g_pre1 stored rounded, as every read of them is a
// product's operand; only silu'(pre1), an f32 factor, stays f32.  Its
// products are bf16 tensor-core MMAs (`tile_mma_bf`, m16n8k16 on
// `ldmatrix` fragments).  Its per-slot scratch (g_pre1 and the two dh
// terms, each a rounded value) is bf16, 3 x 2 W bytes a live slot; the
// node pass widens it to f32 and sums it as before.
// The f32 mode's 64 x 64 products run on the tensor cores in 3xTF32
// (common.cuh): mma.sync.m16n8k8, the transposes read from the same
// swizzled tile in the other operand layout.  SiLU, the gate, the clip and
// the sums run on the FP32 units, one exponential per SiLU and its
// derivative.  Shared memory: edge pass 6 tiles (2 weights, 3
// activations, silu'(pre1)) + row data and the compaction queue, ~111 KB
// (bf16: 4 weights and 3 activations in bf16, silu'(pre1) in f32, ~89 KB):
// two CTAs of 8 warps per SM, at most 128 registers a thread; node pass 5
// tiles, 80 KB (at W = 32: ~55 (bf16 ~44) and 32 KB).  Widths: compiled
// for Dh = H1 = M = W, W = 32 and 64 (the entry point's `width`, as
// edge_message.cu).
//
// Bound on an H100: per live edge six 64x64 products (recompute .W2 and
// .Wg1; cotangents through Wg1^T and W2^T; the W2 and Wg1 outer products)
// and per node six (h.W1r, h.W1s, the W1r/W1s outer products, G.W1r^T,
// S.W1s^T) -- ~50K FLOP per edge against ~300 bytes of node gathers, far
// above the f32 ridge, so the function is bound by operations.  The kernel
// also moves 272 bytes per live edge through g_pre1 / g_rel (written by
// the edge pass, read twice by the node pass).  On the card the edge pass
// dominates, and within a tile the six products take about three
// quarters of the time (tools/phase_trace.py); `wgmma` with the same split
// is the next step (PERF.md section 6).
#include "common.cuh"

namespace {

// edge-pass partial of one CTA: W2 | Wg1 | b2 | bg1 | wg2 | b1 | w1d, the
// matrices W x W and the vectors W long
template <int W>
struct EdgePart {
  static constexpr int W2 = 0, WG1 = W * W, B2 = 2 * W * W, BG1 = B2 + W,
                       WG2 = BG1 + W, B1 = WG2 + W, W1D = B1 + W,
                       size = W1D + W;
};
// node-pass partial of one CTA: W1r | W1s
template <int W>
constexpr int PN = 2 * W * W;
// edge-pass row data (64 each)
enum { Q_E = 0, Q_REL0, Q_REL1, Q_REL2, Q_D2, Q_INV, Q_U0, Q_U1, Q_U2, Q_GG,
       Q_GR0, Q_GR1, Q_GR2, Q_GQ2, Q_N };
// f32: the W2 and Wg1 tiles, t1, msg / g_msg, g_gp1 / g_pre1 and
// silu'(pre1); bf16: W2, Wg1, W1r, W1s, t1, msg / g_msg and g_gp1 / g_pre1
// in bf16 (half as many floats), silu'(pre1) in f32
template <int W, bool BF>
constexpr int EDGE_TILE_FLOATS =
    BF ? 2 * WT<W> + 5 * RT<W> / 2 : 2 * WT<W> + 4 * RT<W>;
template <int W, bool BF>
constexpr int EDGE_SMEM_FLOATS = EDGE_TILE_FLOATS<W, BF> + 5 * W + Q_N * TR +
                                 QUEUE_WORDS + 2 * TR + 5 * 4 * TR;
template <int W>
constexpr int NODE_SMEM_FLOATS = 2 * WT<W> + 3 * RT<W>;

template <int W, bool BF>
__global__ void __launch_bounds__(THREADS, 2)
edge_bwd_edges(const float* __restrict__ x, const int* __restrict__ snd,
               const float* __restrict__ em, const int* __restrict__ indptr,
               const int* __restrict__ rowof,
               const float* __restrict__ P, const float* __restrict__ Q,
               const float* __restrict__ w1d, const float* __restrict__ b1,
               const float* __restrict__ w2, const float* __restrict__ b2,
               const float* __restrict__ wg1, const float* __restrict__ bg1,
               const float* __restrict__ wg2, const float* __restrict__ deg,
               const float* __restrict__ gdx, const float* __restrict__ gmh,
               const float* __restrict__ w1r, const float* __restrict__ w1s,
               float* __restrict__ GPRE1, float* __restrict__ GREL,
               float* __restrict__ GR, float* __restrict__ GS,
               float* __restrict__ part, int n_nodes, int gate_mlp,
               int rel_inv1p, float clamp) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  using EP = EdgePart<W>;
  float* sW2 = smem;  // f32 tiles
  float* sWg1 = sW2 + WT<W>;
  float* tT1 = sWg1 + WT<W>;
  float* tMSG = tT1 + RT<W>;  // msg, then g_msg
  float* tGG = tMSG + RT<W>;  // g_gp1, then g_pre1
  float* tSG = tGG + RT<W>;   // silu'(pre1)
  Bf* bW2 = reinterpret_cast<Bf*>(smem);  // bf16 tiles
  Bf* bWg1 = bW2 + WT<W>;
  Bf* bW1r = bWg1 + WT<W>;
  Bf* bW1s = bW1r + WT<W>;
  Bf* bT1 = bW1s + WT<W>;
  Bf* bMSG = bT1 + RT<W>;  // msg, then g_msg
  Bf* bGG = bMSG + RT<W>;  // g_gp1, then g_pre1
  if (BF) tSG = reinterpret_cast<float*>(bGG + RT<W>);
  float* sw1d = smem + EDGE_TILE_FLOATS<W, BF>;
  float* sb1 = sw1d + W;
  float* sb2 = sb1 + W;
  float* sbg1 = sb2 + W;
  float* swg2 = sbg1 + W;
  float* rq = swg2 + W;  // [Q_N][64]
  const LiveQueue lq(reinterpret_cast<int*>(rq + Q_N * TR));
  const int *pslot = lq.slot, *prow = lq.row, *psnd = lq.snd;
  const float* pem = lq.em;
  float* rowred = reinterpret_cast<float*>(rq + Q_N * TR + QUEUE_WORDS);
  float* colred = rowred + 2 * TR;  // [5 sums][4][64]
  auto RQ = [&](int k) { return rq + k * TR; };

  const int tid = threadIdx.x;
  const Lane L = lane_of();
  if constexpr (BF) {
    tile_load_bf<W>(bW2, w2);
    if (gate_mlp) tile_load_bf<W>(bWg1, wg1);
    tile_load_bf<W>(bW1r, w1r);
    tile_load_bf<W>(bW1s, w1s);
  } else {
    tile_load_async<W>(sW2, w2);
    if (gate_mlp) tile_load_async<W>(sWg1, wg1);
    async_commit();
  }
  if (tid < W) {
    sw1d[tid] = rnd<BF>(w1d[tid]);
    sb1[tid] = rnd<BF>(b1[tid]);
    sb2[tid] = rnd<BF>(b2[tid]);
    sbg1[tid] = gate_mlp ? rnd<BF>(bg1[tid]) : 0.0f;
    swg2[tid] = gate_mlp ? rnd<BF>(wg2[tid]) : 0.0f;
  }
  Frag<W> aW2, aWg1;
  frag_zero<W>(aW2);
  frag_zero<W>(aWg1);
  float cb2 = 0.0f, cbg1 = 0.0f, cwg2 = 0.0f, cb1 = 0.0f, cw1d = 0.0f;

  // one tile: the first `cnt` (<= 64) slots of the queue
  auto tile = [&](int cnt) {
    if (tid < TR) {
      const bool live = tid < cnt;
      const int r = live ? prow[tid] : -1;
      const int s = live ? psnd[tid] : -1;
      const float e = live ? pem[tid] : 0.0f;
      float rel[3] = {0.f, 0.f, 0.f}, u[3] = {0.f, 0.f, 0.f}, d2 = 0.f,
            inv = 0.f;
      if (live) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
          rel[k] = rnd<BF>(x[3 * r + k]) - rnd<BF>(x[3 * s + k]);
        d2 = rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2];
        inv = 1.0f / fmaxf(deg[r], 1.0f);
        if (BF) {  // the gathered inv and g_dx are rounded
          inv = bf16_round(inv);
#pragma unroll
          for (int k = 0; k < 3; ++k)
            u[k] = bf16_round(gdx[3 * r + k]) * (inv * e);
        } else {
#pragma unroll
          for (int k = 0; k < 3; ++k) u[k] = (gdx[3 * r + k] * inv) * e;
        }
      }
      RQ(Q_E)[tid] = e;
      RQ(Q_INV)[tid] = inv;
      RQ(Q_D2)[tid] = d2;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        RQ(Q_REL0 + k)[tid] = rel[k];
        RQ(Q_U0 + k)[tid] = u[k];
        RQ(Q_GR0 + k)[tid] = 0.0f;
      }
      RQ(Q_GQ2)[tid] = 0.0f;
    }
    __syncthreads();
    // pre1 = ((P_r + Q_s) + d2 w1d) + b1 (0 on rows past cnt); t1 =
    // silu(pre1) into tT1 (bf16: bT1, rounded), silu'(pre1) into tSG
    for (int f = tid; f < TR * W / 4; f += THREADS) {
      const int i = f / (W / 4), q = (f % (W / 4)) * 4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (i < cnt) {
        const float4 p = *reinterpret_cast<const float4*>(
            P + (size_t)prow[i] * W + q);
        const float4 o = *reinterpret_cast<const float4*>(
            Q + (size_t)psnd[i] * W + q);
        const float d2 = rnd<BF>(RQ(Q_D2)[i]);  // an operand of d2 . w1d
        v[0] = ((p.x + o.x) + d2 * sw1d[q]) + sb1[q];
        v[1] = ((p.y + o.y) + d2 * sw1d[q + 1]) + sb1[q + 1];
        v[2] = ((p.z + o.z) + d2 * sw1d[q + 2]) + sb1[q + 2];
        v[3] = ((p.w + o.w) + d2 * sw1d[q + 3]) + sb1[q + 3];
      }
      float t[4], g[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) silu_both(v[k], t[k], g[k]);
      if (BF)
        *reinterpret_cast<uint2*>(bT1 + swz16<W>(i, q)) =
            bf16x4(make_float4(t[0], t[1], t[2], t[3]));
      else
        *reinterpret_cast<float4*>(tT1 + swz<W>(i, q)) =
            make_float4(t[0], t[1], t[2], t[3]);
      *reinterpret_cast<float4*>(tSG + swz<W>(i, q)) =
          make_float4(g[0], g[1], g[2], g[3]);
    }
    __syncthreads();
    {  // msg = t1.W2 + b2
      Frag<W> m;
      frag_zero<W>(m);
      if constexpr (BF)
        tile_mma_bf<W, false, false>(m, bT1, bW2, L);
      else
        tile_mma<W, false, false>(m, tT1, sW2, L);
#pragma unroll
      for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) m[jn][e] += sb2[L.col<W>(jn, e)];
      if (BF)
        frag_store_bf<W>(bMSG, m, L);
      else
        frag_store<W>(tMSG, m, L);
    }
    __syncthreads();
    if (gate_mlp) {
      Frag<W> gp, sv;
      frag_zero<W>(gp);
      if constexpr (BF)
        tile_mma_bf<W, false, false>(gp, bMSG, bWg1, L);
      else
        tile_mma<W, false, false>(gp, tMSG, sWg1, L);
#pragma unroll
      for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = L.col<W>(jn, e);
          gp[jn][e] += sbg1[j];
          // rounded on its own: a row's gate does not depend on its tile
          // row (no FMA fused into the row sum per fragment slot)
          sv[jn][e] =
              __fmul_rn(rnd<BF>(gp[jn][e] * sigm(gp[jn][e])), swg2[j]);
        }
      frag_rowsum<W>(sv, L, rowred);
      __syncthreads();
      if (tid < TR) {
        const float gate_pre = rowred[tid] + rowred[TR + tid];
        const float gate = fminf(fmaxf(gate_pre, -clamp), clamp);
        const float r0 = RQ(Q_REL0)[tid], r1 = RQ(Q_REL1)[tid],
                    r2 = RQ(Q_REL2)[tid];
        const float u0 = RQ(Q_U0)[tid], u1 = RQ(Q_U1)[tid],
                    u2 = RQ(Q_U2)[tid];
        float kf = 1.0f, sd = 0.0f;
        if (rel_inv1p) {
          sd = sqrtf(RQ(Q_D2)[tid] + 1e-12f);
          kf = 1.0f / (sd + 1.0f);
        }
        float g_gate = u0 * (r0 * kf) + u1 * (r1 * kf) + u2 * (r2 * kf);
        if (!(gate_pre >= -clamp && gate_pre <= clamp)) g_gate = 0.0f;
        const float gu0 = u0 * gate, gu1 = u1 * gate, gu2 = u2 * gate;
        RQ(Q_GG)[tid] = g_gate;
        if (rel_inv1p) {
          RQ(Q_GR0)[tid] = gu0 * kf;
          RQ(Q_GR1)[tid] = gu1 * kf;
          RQ(Q_GR2)[tid] = gu2 * kf;
          RQ(Q_GQ2)[tid] = (gu0 * r0 + gu1 * r1 + gu2 * r2) *
                           (-(kf * kf) / (2.0f * sd));
        } else {
          RQ(Q_GR0)[tid] = gu0;
          RQ(Q_GR1)[tid] = gu1;
          RQ(Q_GR2)[tid] = gu2;
        }
      }
      __syncthreads();
#pragma unroll
      for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // bf16: g_gate and silu enter their products rounded
          const float g_gate = rnd<BF>(RQ(Q_GG)[L.row(e)]);
          float sgp, dsgp;
          silu_both(gp[jn][e], sgp, dsgp);
          sv[jn][e] = rnd<BF>(sgp) * g_gate;
          gp[jn][e] = (g_gate * swg2[L.col<W>(jn, e)]) * dsgp;
        }
      if (BF)
        frag_store_bf<W>(bGG, gp, L);
      else
        frag_store<W>(tGG, gp, L);
      frag_colsum<W>(gp, L, colred);           // bg1
      frag_colsum<W>(sv, L, colred + 4 * TR);  // wg2
      __syncthreads();
      if constexpr (BF)
        tile_mma_bf<W, true, false>(aWg1, bMSG, bGG, L);
      else
        tile_mma<W, true, false>(aWg1, tMSG, tGG, L);
    }
    {  // g_msg = g_mh[r] inv em (+ g_gp1.Wg1^T)
      Frag<W> gm;
      frag_zero<W>(gm);
      if (gate_mlp) {
        if constexpr (BF)
          tile_mma_bf<W, false, true>(gm, bGG, bWg1, L);
        else
          tile_mma<W, false, true>(gm, tGG, sWg1, L);
      }
#pragma unroll
      for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int i = L.row(2 * h2), j = L.col<W>(jn, 0);
          if (i < cnt) {
            const float2 g = *reinterpret_cast<const float2*>(
                gmh + (size_t)prow[i] * W + j);
            const float inv = RQ(Q_INV)[i], e = RQ(Q_E)[i];
            if (BF) {  // bf16(g_mh[r]) (bf16(inv) em)
              gm[jn][2 * h2] += bf16_round(g.x) * (inv * e);
              gm[jn][2 * h2 + 1] += bf16_round(g.y) * (inv * e);
            } else {
              gm[jn][2 * h2] += (g.x * inv) * e;
              gm[jn][2 * h2 + 1] += (g.y * inv) * e;
            }
          }
        }
      frag_colsum<W>(gm, L, colred + 8 * TR);  // b2
      __syncthreads();  // msg and g_gp1 are read
      if (BF)
        frag_store_bf<W>(bMSG, gm, L);
      else
        frag_store<W>(tMSG, gm, L);
    }
    __syncthreads();
    if (tid < W) {
      cb2 += colsum4(colred + 8 * TR, tid);
      if (gate_mlp) {
        cbg1 += colsum4(colred, tid);
        cwg2 += colsum4(colred + 4 * TR, tid);
      }
    }
    Frag<W> gp;  // g_pre1 = (g_msg.W2^T) silu'(pre1), into tGG (read above)
    frag_zero<W>(gp);
    if constexpr (BF) {
      tile_mma_bf<W, true, false>(aW2, bT1, bMSG, L);
      tile_mma_bf<W, false, true>(gp, bMSG, bW2, L);
    } else {
      tile_mma<W, true, false>(aW2, tT1, tMSG, L);
      tile_mma<W, false, true>(gp, tMSG, sW2, L);
    }
    {
      Frag<W> dg, gw;
#pragma unroll
      for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          gp[jn][e] *= tSG[swz<W>(L.row(e), L.col<W>(jn, e))];
          // bf16: d2 and g_pre1 enter d2^T g_pre1 and g_pre1 . w1d rounded
          dg[jn][e] = rnd<BF>(RQ(Q_D2)[L.row(e)]) * rnd<BF>(gp[jn][e]);
          gw[jn][e] = __fmul_rn(rnd<BF>(gp[jn][e]), sw1d[L.col<W>(jn, e)]);
        }
      if (BF)  // bf16: g_pre1 rounded, the operand of its every read
        frag_store_bf<W>(bGG, gp, L);
      else
        frag_store<W>(tGG, gp, L);
      frag_rowsum<W>(gw, L, rowred);
      frag_colsum<W>(gp, L, colred + 12 * TR);  // b1
      frag_colsum<W>(dg, L, colred + 16 * TR);  // w1d
    }
    __syncthreads();
    if (tid < W) {
      cb1 += colsum4(colred + 12 * TR, tid);
      cw1d += colsum4(colred + 16 * TR, tid);
    }
    if (tid < cnt) {  // g_rel = g_r + 2 rel g_d2
      const float g_d2 = RQ(Q_GQ2)[tid] + (rowred[tid] + rowred[TR + tid]);
      float4 g;
      // bf16: the node pass's summands, rounded
      g.x = rnd<BF>(RQ(Q_GR0)[tid] + 2.0f * RQ(Q_REL0)[tid] * g_d2);
      g.y = rnd<BF>(RQ(Q_GR1)[tid] + 2.0f * RQ(Q_REL1)[tid] * g_d2);
      g.z = rnd<BF>(RQ(Q_GR2)[tid] + 2.0f * RQ(Q_REL2)[tid] * g_d2);
      g.w = 0.0f;
      *reinterpret_cast<float4*>(GREL + (size_t)pslot[tid] * 4) = g;
    }
    if constexpr (BF) {
      // the node pass's summands, bf16: g_pre1, and the per-edge dh terms
      // bf16(bf16(g_pre1) W1r^T), ... W1s^T
      Bf* gpre1 = reinterpret_cast<Bf*>(GPRE1);
      for (int f = tid; f < TR * W / 8; f += THREADS) {
        const int i = f / (W / 8), q = (f % (W / 8)) * 8;
        if (i < cnt)
          *reinterpret_cast<uint4*>(gpre1 + (size_t)pslot[i] * W + q) =
              *reinterpret_cast<const uint4*>(bGG + swz16<W>(i, q));
      }
      Bf* dst[2] = {reinterpret_cast<Bf*>(GR), reinterpret_cast<Bf*>(GS)};
      const Bf* Wk[2] = {bW1r, bW1s};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        Frag<W> a;
        frag_zero<W>(a);
        tile_mma_bf<W, false, true>(a, bGG, Wk[k], L);
#pragma unroll
        for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int i = L.row(2 * h2);
            if (i < cnt)
              *reinterpret_cast<uint32_t*>(dst[k] + (size_t)pslot[i] * W +
                                           L.col<W>(jn, 0)) =
                  bf16x2(a[jn][2 * h2], a[jn][2 * h2 + 1]);
          }
      }
    } else {
      for (int f = tid; f < TR * W / 4; f += THREADS) {
        const int i = f / (W / 4), q = (f % (W / 4)) * 4;
        if (i < cnt)
          *reinterpret_cast<float4*>(GPRE1 + (size_t)pslot[i] * W + q) =
              *reinterpret_cast<const float4*>(tGG + swz<W>(i, q));
      }
    }
    __syncthreads();
  };

  // this CTA's slot range: an equal share of [0, indptr[N])
  const int live_end = indptr[n_nodes];
  const int len = (live_end + gridDim.x - 1) / gridDim.x;
  const int beg = min((int)blockIdx.x * len, live_end);
  const int end = min(beg + len, live_end);
  async_wait_all();
  __syncthreads();  // weights in
  for_live_tiles(em, rowof, snd, beg, end, lq, tile);

  float* out = part + (size_t)blockIdx.x * EP::size;
  frag_store_global<W>(out + EP::W2, aW2, L);
  frag_store_global<W>(out + EP::WG1, aWg1, L);
  if (tid < W) {
    out[EP::B2 + tid] = cb2;
    out[EP::BG1 + tid] = cbg1;
    out[EP::WG2 + tid] = cwg2;
    out[EP::B1 + tid] = cb1;
    out[EP::W1D + tid] = cw1d;
  }
}

// Per node: G = receiver-segment sum of g_pre1 (slot order), S = sender-
// segment sum (sender-permutation order), gx = dx_r + dx_s; then
// gh = G.W1r^T + S.W1s^T (bf16: the receiver-segment sum of GR plus the
// sender-segment sum of GS) and the W1r / W1s partials h^T G, h^T S.
template <int W, bool BF>
__global__ void __launch_bounds__(THREADS)
edge_bwd_nodes(const float* __restrict__ h, const float* __restrict__ em,
               const int* __restrict__ indptr, const int* __restrict__ sperm,
               const int* __restrict__ sptr, const float* __restrict__ w1r,
               const float* __restrict__ w1s, const float* __restrict__ GPRE1,
               const float* __restrict__ GREL, const float* __restrict__ GR,
               const float* __restrict__ GS, float* __restrict__ gx,
               float* __restrict__ gh, float* __restrict__ part,
               int n_nodes) {
  extern __shared__ float4 smem4[];
  float* sWr = reinterpret_cast<float*>(smem4);
  float* sWs = sWr + WT<W>;
  float* tH = sWs + WT<W>;
  // the edge pass's per-slot rows: bf16 in the bf16 mode
  using T = std::conditional_t<BF, Bf, float>;
  const T* gpre1 = reinterpret_cast<const T*>(GPRE1);
  float* tG = tH + RT<W>;
  float* tS = tG + RT<W>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int node0 = blockIdx.x * TR;
  if (!BF) {
    tile_load_async<W>(sWr, w1r);
    tile_load_async<W>(sWs, w1s);
    async_commit();
  }
  // bf16: h rounded (an operand of h^T G)
  tile_gather<W, BF>(
      tH, h, [&](int i) { return node0 + i < n_nodes ? node0 + i : -1; });
  // 8 lanes per node, 2 nodes each; lane gl owns columns (W/8) gl .. + W/8-1
  constexpr int CPL = W / 8;
  const int grp = lane >> 3, gl = lane & 7;
  for (int k = 0; k < 2; ++k) {
    const int r = (4 * warp + grp) * 2 + k;
    const int i = node0 + r;
    float G[CPL], S[CPL], Hr[CPL], Hs[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) G[c] = S[c] = Hr[c] = Hs[c] = 0.0f;
    float dr = 0.0f, ds = 0.0f;  // lanes gl < 3: component gl
    if (i < n_nodes) {
      segment_sum<W, false, BF>(nullptr, em, gpre1, GREL,
                                reinterpret_cast<const T*>(GR), indptr[i],
                                indptr[i + 1], gl, grp, 1.0f, G, Hr, dr);
      segment_sum<W, true, BF>(sperm, em, gpre1, GREL,
                               reinterpret_cast<const T*>(GS), sptr[i],
                               sptr[i + 1], gl, grp, -1.0f, S, Hs, ds);
      if (gl < 3) gx[3 * i + gl] = dr + ds;
      if (BF) {  // gh = dh_r + dh_s, the reference's two passes
#pragma unroll
        for (int h2 = 0; h2 < CPL / 4; ++h2)
          *reinterpret_cast<float4*>(gh + (size_t)i * W + CPL * gl + 4 * h2) =
              make_float4(Hr[4 * h2] + Hs[4 * h2],
                          Hr[4 * h2 + 1] + Hs[4 * h2 + 1],
                          Hr[4 * h2 + 2] + Hs[4 * h2 + 2],
                          Hr[4 * h2 + 3] + Hs[4 * h2 + 3]);
      }
    }
#pragma unroll
    for (int h2 = 0; h2 < CPL / 4; ++h2) {
      *reinterpret_cast<float4*>(tG + swz<W>(r, CPL * gl + 4 * h2)) =
          make_float4(G[4 * h2], G[4 * h2 + 1], G[4 * h2 + 2], G[4 * h2 + 3]);
      *reinterpret_cast<float4*>(tS + swz<W>(r, CPL * gl + 4 * h2)) =
          make_float4(S[4 * h2], S[4 * h2 + 1], S[4 * h2 + 2], S[4 * h2 + 3]);
    }
  }
  if (!BF) async_wait_all();
  __syncthreads();
  const Lane L = lane_of();
  Frag<W> a;
  if (!BF) {
    frag_zero<W>(a);
    tile_mma<W, false, true>(a, tG, sWr, L);
    tile_mma<W, false, true>(a, tS, sWs, L);
#pragma unroll
    for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int i = node0 + L.row(2 * h2);
        if (i < n_nodes)
          *reinterpret_cast<float2*>(gh + (size_t)i * W + L.col<W>(jn, 0)) =
              make_float2(a[jn][2 * h2], a[jn][2 * h2 + 1]);
      }
  }
  float* out = part + (size_t)blockIdx.x * PN<W>;
  frag_zero<W>(a);
  tile_mma<W, true, false>(a, tH, tG, L);
  frag_store_global<W>(out, a, L);
  frag_zero<W>(a);
  tile_mma<W, true, false>(a, tH, tS, L);
  frag_store_global<W>(out + W * W, a, L);
}

struct Outs {
  float *gw1r, *gw1s, *gw1d, *gb1, *gw2, *gb2, *gwg1, *gbg1, *gwg2;
};

// every weight gradient: edge-pass partials in CTA order, then node-pass
// partials in CTA order
template <int W>
__global__ void edge_bwd_reduce(const float* __restrict__ pe,
                                const float* __restrict__ pn, Outs o,
                                int n_edge_ctas, int n_node_ctas,
                                int gate_mlp) {
  using EP = EdgePart<W>;
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= EP::size + PN<W>) return;
  if (f < EP::size) {
    if (!gate_mlp && f >= EP::WG1 && f < EP::B1 &&
        !(f >= EP::B2 && f < EP::BG1))
      return;  // no gate: the caller's gate grads stay zero
    const float s = sum_strided(pe + f, EP::size, n_edge_ctas);
    if (f < EP::WG1) o.gw2[f] = s;
    else if (f < EP::B2) o.gwg1[f - EP::WG1] = s;
    else if (f < EP::BG1) o.gb2[f - EP::B2] = s;
    else if (f < EP::WG2) o.gbg1[f - EP::BG1] = s;
    else if (f < EP::B1) o.gwg2[f - EP::WG2] = s;
    else if (f < EP::W1D) o.gb1[f - EP::B1] = s;
    else o.gw1d[f - EP::W1D] = s;
  } else {
    const int k = f - EP::size;
    const float s = sum_strided(pn + k, PN<W>, n_node_ctas);
    if (k < W * W) o.gw1r[k] = s;
    else o.gw1s[k - W * W] = s;
  }
}

struct Scratch {
  float *P, *Q, *GPRE1, *GREL, *GR, *GS, *pe, *pn;
  int* rowof;
  size_t total;
};

template <int W, bool BF>
Scratch carve(float* base, int n, int e, int n_edge_ctas) {
  Scratch s;
  size_t off = 0;
  auto take = [&](size_t count) {
    float* p = base == nullptr ? nullptr : base + off;
    off += round4(count);
    return p;
  };
  s.P = take((size_t)n * W);
  s.Q = take((size_t)n * W);
  // bf16: g_pre1, GR and GS as bf16, half a float an element
  s.GPRE1 = take((size_t)e * W / (BF ? 2 : 1));
  s.GREL = take((size_t)e * 4);
  s.GR = BF ? take((size_t)e * W / 2) : nullptr;
  s.GS = BF ? take((size_t)e * W / 2) : nullptr;
  s.rowof = reinterpret_cast<int*>(take((size_t)e));
  s.pe = take((size_t)n_edge_ctas * EdgePart<W>::size);
  s.pn = take((size_t)n_tiles(n) * PN<W>);
  s.total = off;
  return s;
}

template <int W, bool BF>
int launch_backward(
    const float* x, const float* h, const int* snd, const float* em,
    const int* indptr, const int* sperm, const int* sptr, const float* w1r,
    const float* w1s, const float* w1d, const float* b1, const float* w2,
    const float* b2, const float* wg1, const float* bg1, const float* wg2,
    const float* deg, const float* gdx, const float* gmh, float* gx,
    float* gh, const Outs& o, float* scratch, int n_nodes, int n_slots,
    int gate_mlp, int rel_inv1p, float clamp, int n_blocks,
    cudaStream_t stream) {
  const size_t e_smem = EDGE_SMEM_FLOATS<W, BF> * sizeof(float);
  const size_t n_smem = NODE_SMEM_FLOATS<W> * sizeof(float);
  const size_t p_smem = PROJ_SMEM_FLOATS<W, BF> * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      edge_bwd_edges<W, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)e_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(edge_bwd_nodes<W, BF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)n_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(node_proj<W, BF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)p_smem);
  if (err != cudaSuccess) return (int)err;
  if (n_nodes <= 0) return (int)cudaGetLastError();
  Scratch s = carve<W, BF>(scratch, n_nodes, n_slots, n_blocks);
  const int nt = n_tiles(n_nodes);
  node_proj<W, BF><<<nt, THREADS, p_smem, stream>>>(
      h, w1r, w1s, indptr, s.P, s.Q, s.rowof, nullptr, n_nodes, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  edge_bwd_edges<W, BF><<<n_blocks, THREADS, e_smem, stream>>>(
      x, snd, em, indptr, s.rowof, s.P, s.Q, w1d, b1, w2, b2, wg1, bg1, wg2,
      deg, gdx, gmh, w1r, w1s, s.GPRE1, s.GREL, s.GR, s.GS, s.pe, n_nodes,
      gate_mlp, rel_inv1p, clamp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  edge_bwd_nodes<W, BF><<<nt, THREADS, n_smem, stream>>>(
      h, em, indptr, sperm, sptr, w1r, w1s, s.GPRE1, s.GREL, s.GR, s.GS, gx,
      gh, s.pn, n_nodes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = EdgePart<W>::size + PN<W>;
  edge_bwd_reduce<W><<<(total + 255) / 256, 256, 0, stream>>>(
      s.pe, s.pn, o, n_blocks, nt, gate_mlp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long edge_bwd_scratch_floats(int n_nodes, int n_slots,
                                             int n_edge_ctas, int width,
                                             int bf16) {
  long long total = -1;
  with_width(width, bf16, [&](auto w, auto bf) {
    total = carve<decltype(w)::value, decltype(bf)::value>(
                nullptr, n_nodes, n_slots, n_edge_ctas).total;
    return 0;
  });
  return total;
}

// width: the compiled width (32 or 64) that Dh, H1 and M were padded to;
// bf16 != 0: the bf16 mode
extern "C" int edge_backward(
    const float* x, const float* h, const int* snd, const float* em,
    const int* indptr, const int* sperm, const int* sptr, const float* w1r,
    const float* w1s, const float* w1d, const float* b1, const float* w2,
    const float* b2, const float* wg1, const float* bg1, const float* wg2,
    const float* deg, const float* gdx, const float* gmh, float* gx,
    float* gh, float* gw1r, float* gw1s, float* gw1d, float* gb1, float* gw2,
    float* gb2, float* gwg1, float* gbg1, float* gwg2, float* scratch,
    int n_nodes, int n_slots, int gate_mlp, int rel_inv1p, float clamp,
    int n_blocks, int width, int bf16, void* stream_ptr) {
  if (!(aligned16(h) && aligned16(w1r) && aligned16(w1s) && aligned16(w2) &&
        (!gate_mlp || aligned16(wg1)) && aligned16(gmh) && aligned16(gh) &&
        aligned16(scratch)))
    return (int)cudaErrorMisalignedAddress;
  if (n_blocks <= 0) return (int)cudaErrorInvalidValue;
  const Outs o{gw1r, gw1s, gw1d, gb1, gw2, gb2, gwg1, gbg1, gwg2};
  return with_width(width, bf16, [&](auto w, auto bf) {
    return launch_backward<decltype(w)::value, decltype(bf)::value>(
        x, h, snd, em, indptr, sperm, sptr, w1r, w1s, w1d, b1, w2, b2, wg1,
        bg1, wg2, deg, gdx, gmh, gx, gh, o, scratch, n_nodes, n_slots,
        gate_mlp, rel_inv1p, clamp, n_blocks, (cudaStream_t)stream_ptr);
  });
}

// the CTAs of the edge pass an SM holds at once, as the card reports it
// for its registers and shared memory (-1 on an error)
extern "C" int edge_bwd_occupancy(int width, int bf16) {
  return with_width(width, bf16, [](auto w, auto bf) {
    constexpr int W = decltype(w)::value;
    constexpr bool B = decltype(bf)::value;
    const int bytes = EDGE_SMEM_FLOATS<W, B> * sizeof(float);
    int n = -1;
    if (cudaFuncSetAttribute(edge_bwd_edges<W, B>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, edge_bwd_edges<W, B>, THREADS, bytes) != cudaSuccess)
      return -1;
    return n;
  });
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
