// Real-real edge pathway forward (Eq. 3 + the real parts of Eqs. 6-7) for
// Hopper (sm_90a), f32 and bf16 modes.
//
// Replaces the Pallas TPU kernel `edge_pathway_fused` (`_edge_kernel`) of
// the JAX package's kernels/edge_message.py.  It computes the same
// function, not the same blocks: the TPU kernel regrouped edges into
// (receiver-window x sender-window) bands and gathered / scattered with
// one-hot matmuls on the MXU; here the layout is a receiver-sorted CSR
// (`indptr`, N+1 row offsets into the slot arrays).  Per receiver r and
// live slot e = (r <- s) (em[e] != 0), in slot order:
//   d2   = |x_r - x_s|^2
//   msg  = SiLU(((P_r + Q_s) + d2 w1d) + b1) . W2 + b2,  P = h.W1r, Q = h.W1s
//   mh  += msg em ;  deg += em
//   gate = clip(SiLU(msg . Wg1 + bg1) . wg2, -clamp, clamp)   (gate 'mlp')
//   dx  += (rel gate) em   (rel = x_r - x_s, or rel / (|rel| + 1))
//   mh /= max(deg, 1) ; dx /= max(deg, 1)
//
// Two launches on one stream, no atomics:
//   1. node_proj (common.cuh)  CTA per 64 nodes: P and Q once per node as
//      tile products, the receiver row of every slot, and the rows each
//      edge CTA owns.
//   2. edge_fwd_edges  `n_ctas` CTAs.  CTA b owns the receiver rows whose
//      CSR segment starts inside its equal share of [0, indptr[N]), so a
//      row is never split and a 200-edge hub row is just more tiles in one
//      CTA.  It packs the live slots of its rows, in slot order, into
//      64-edge tiles (`for_live_tiles`).  Per tile: gather pre1 = P_r + Q_s
//      + d2 w1d + b1 with the SiLU into a swizzled tile, msg = t1.W2 + b2
//      and the gate's msg.Wg1 as 3xTF32 tensor-core tile products
//      (common.cuh, each k-step summed on its own: STEP_SUM), the gate's
//      dot with wg2 as a fixed-order row sum.
//      Its products are rounded on their own (`__fmul_rn`): an FMA that
//      fused one of them into the sum would be chosen per unrolled
//      fragment slot, and a row's gate would depend on its tile row.
//      Then each row's mh, deg and dx start from zero and add its live
//      edges one at a time in slot order (64 threads a row, one a column;
//      four rows at a time), carried across tile boundaries; a finished
//      row is divided by max(deg, 1) and written once; rows without a
//      live slot get zeros.
// The bf16 mode (template BF; `precision='bf16'` of `_edge_kernel`): x, h
// and the weights rounded to bf16 (x where it is read, the vectors where
// they are loaded, h and the weight tiles as they are stored); rel and d2
// are formed in f32 from the rounded coordinates (the reference gathers
// with a one-hot matmul, f32 result); d2, t1, msg and the gate's SiLU
// enter their products rounded; the row sums take rounded summands
// (bf16(msg em), bf16(rel gate em), bf16(em): the reference scatters with
// a one-hot matmul, edge_message.py:314-326).  A product of two bf16
// values is exact, so no FMA the compiler fuses can change it.  Its tiles
// are bf16 (common.cuh: W2, Wg1 and h rounded once, as they are stored;
// t1 and msg stored rounded, msg also in f32 for the mh sums) and its
// products bf16 tensor-core MMAs, m16n8k16 on `ldmatrix` fragments
// (`tile_mma_bf`).  The shared memory this frees holds a stage for the
// gathers: the tiles come one ahead (`for_live_tiles_ahead`), and as soon
// as a tile has read its P_r / Q_s rows and coordinates from the stage,
// cp.async brings the next tile's there while this one's products and
// row sums run.  P and Q stay f32 (pre1 = P_r + Q_s + ... is an f32 sum).
// Widths: compiled for Dh = H1 = M = W, W = 32 and 64 (the entry point's
// `width`; other widths up to 64 arrive zero-padded, wider ones take
// panel.cu): the tiles are 64 x W, the products 64 x W x W.
// Masked slots never enter a tile (an Inf there cannot become a NaN), and
// each output depends only on its row's live edges and their order: not on
// the CTA count, the SM count, or how many masked slots the layout holds
// (a trajectory is bitwise independent of the Verlet skin).  Repeated runs
// are bitwise equal.  W2 and Wg1 stay in shared memory as swizzled tiles;
// f32: ~75 KB of shared memory at W = 64 (~34 KB at 32), bf16: ~94 KB
// (~48 KB), and at most 128 registers give two CTAs an SM (CTAS_PER_SM).
//
// Bound on an H100: per live edge two 64 x 64 products (.W2, .Wg1) and per
// node two (h.W1r, h.W1s), ~18K FLOP per edge against a 256-byte gather of
// Q_s: above the f32 ridge, so bound by operations -- 1.52 GFLOP at the
// serving shapes (8,192 nodes, 84,806 live edges), 0.0229 ms at the
// 67 TFLOP/s f32 rate, and 0.0092 ms for its three TF32 MMAs a product at
// 495 TFLOP/s; in bf16 0.0015 ms at 989 TFLOP/s.  Every product here is a
// tensor-core tile product; the elementwise SiLU, the gate and the
// ordered row sums run on the FP32 units.
#include "common.cuh"

namespace {

// edge-pass row data (64 each): mask, rel, d2, the edge's dx term
enum { F_E = 0, F_REL0, F_REL1, F_REL2, F_D2, F_DX0, F_DX1, F_DX2, F_N };
// carried sums of an unfinished row: mh (W) | deg | dx (3)
template <int W>
constexpr int CARRY = W + 4;
// f32: the W2 and Wg1 tiles, the t1 and msg tiles.  bf16: W2, Wg1, t1 and
// msg in bf16 (half as many floats), msg in f32, and the stage: the P and
// Q rows of a tile (2 x 64 x W) and the coordinates of its receivers and
// senders (2 x 64 x 3)
template <int W, bool BF>
constexpr int EDGE_TILE_FLOATS =
    BF ? WT<W> + 4 * RT<W> + 6 * TR : 2 * WT<W> + 2 * RT<W>;
template <int W, bool BF>
constexpr int EDGE_SMEM_FLOATS =
    EDGE_TILE_FLOATS<W, BF> + 5 * W + F_N * TR +
    queue_words(BF ? PEND_AHEAD : PEND) + 2 * TR + (TR + 8) + 2 * CARRY<W>;
// At width 32 shared memory would admit six CTAs an SM, but the 128
// registers a thread that two CTAs leave are what the width-64 tile pass
// is built around; both widths and both modes keep two (the bf16 mode's
// ~94 KB at 64 admits no third).
template <int W, bool BF>
constexpr int CTAS_PER_SM = 2;

template <int W, bool BF>
__global__ void __launch_bounds__(THREADS, (CTAS_PER_SM<W, BF>))
edge_fwd_edges(const float* __restrict__ x, const int* __restrict__ snd,
               const float* __restrict__ em, const int* __restrict__ indptr,
               const int* __restrict__ rowof, const int* __restrict__ ctarow,
               const float* __restrict__ P, const float* __restrict__ Q,
               const float* __restrict__ w1d, const float* __restrict__ b1,
               const float* __restrict__ w2, const float* __restrict__ b2,
               const float* __restrict__ wg1, const float* __restrict__ bg1,
               const float* __restrict__ wg2, float* __restrict__ dx,
               float* __restrict__ mh, float* __restrict__ deg, int gate_mlp,
               int rel_inv1p, float clamp) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sW2 = smem;  // f32 tiles
  float* sWg1 = sW2 + WT<W>;
  float* tT1 = sWg1 + WT<W>;
  float* tMSG = tT1 + RT<W>;
  Bf* bW2 = reinterpret_cast<Bf*>(smem);  // bf16 tiles
  Bf* bWg1 = bW2 + WT<W>;
  Bf* bT1 = bWg1 + WT<W>;
  Bf* bMSG = bT1 + RT<W>;
  if (BF) tMSG = reinterpret_cast<float*>(bMSG + RT<W>);
  float* stage = tMSG + RT<W>;  // bf16: P rows | Q rows
  float* sx = stage + 2 * RT<W>;  // bf16: x of receivers | of senders
  float* sw1d = smem + EDGE_TILE_FLOATS<W, BF>;
  float* sb1 = sw1d + W;
  float* sb2 = sb1 + W;
  float* sbg1 = sb2 + W;
  float* swg2 = sbg1 + W;
  float* rq = swg2 + W;  // [F_N][64]
  const LiveQueue lq(reinterpret_cast<int*>(rq + F_N * TR),
                     BF ? PEND_AHEAD : PEND);
  // [2][64]
  float* rowred = reinterpret_cast<float*>(lq.wcount + THREADS / 32);
  int* seg = reinterpret_cast<int*>(rowred + 2 * TR);  // segment starts
  // meta[0]: segments of the tile; meta[1 + k]: row of carry buffer k
  // (-1: none); meta[3], meta[4]: the segment-start ballots
  int* meta = seg + TR + 1;
  float* carry = reinterpret_cast<float*>(meta + 7);  // [2][CARRY]
  auto RQ = [&](int k) { return rq + k * TR; };

  const int tid = threadIdx.x;
  const Lane L = lane_of();
  if constexpr (BF) {
    tile_load_bf<W>(bW2, w2);
    if (gate_mlp) tile_load_bf<W>(bWg1, wg1);
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
  if (tid == 0) meta[1] = meta[2] = -1;
  const int row_lo = ctarow[blockIdx.x], row_hi = ctarow[blockIdx.x + 1];
  // the row sums: thread (grp, j) adds column j of every (256 / W)-th
  // segment
  const int j = tid & (W - 1), grp = tid / W;
  int cur = 0;  // the carry buffer the next tile reads

  // row r is complete: its sums over max(deg, 1), written once
  auto finish = [&](int r, float a, float dg, float d) {
    const float inv = 1.0f / fmaxf(dg, 1.0f);
    mh[(size_t)r * W + j] = a * inv;
    if (j < 3) dx[3 * r + j] = d * inv;
    if (j == 0) deg[r] = dg;
  };

  // bf16: start the gathers of queue entries [base, base + n) into the
  // stage (one cp.async group)
  auto fetch = [&](int base, int n) {
    constexpr int G = W / 4;
    for (int f = tid; f < 2 * TR * G; f += THREADS) {
      const int k = f / (TR * G), i = (f / G) % TR, q = (f % G) * 4;
      if (i < n) {
        const int v = k ? lq.snd[base + i] : lq.row[base + i];
        cp_async16(stage + k * RT<W> + i * W + q,
                   (k ? Q : P) + (size_t)v * W + q);
      }
    }
    for (int f = tid; f < 6 * TR; f += THREADS) {
      const int k = f / (3 * TR), i = (f / 3) % TR, c = f % 3;
      if (i < n) {
        const int v = k ? lq.snd[base + i] : lq.row[base + i];
        cp_async4(sx + k * 3 * TR + 3 * i + c, x + 3 * v + c);
      }
    }
    async_commit();
  };

  // one tile: the first `cnt` (<= 64) live slots of the queue; bf16: the
  // next tile's `nxt` are entries [64, 64 + nxt)
  auto tile = [&](int cnt, int nxt) {
    if (BF) {
      async_wait_all();
      __syncthreads();  // this tile's gathers are in
    }
    if (tid < TR) {
      const bool live = tid < cnt;
      float rel[3] = {0.f, 0.f, 0.f}, d2 = 0.f;
      int r = -1;
      if (live) {
        r = lq.row[tid];
        const int s = lq.snd[tid];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          rel[k] = BF ? bf16_round(sx[3 * tid + k]) -
                            bf16_round(sx[3 * TR + 3 * tid + k])
                      : x[3 * r + k] - x[3 * s + k];
        d2 = rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2];
      }
      RQ(F_E)[tid] = live ? lq.em[tid] : 0.0f;
      RQ(F_D2)[tid] = d2;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        RQ(F_REL0 + k)[tid] = rel[k];
        RQ(F_DX0 + k)[tid] = 0.0f;
      }
      // a row's first live slot in the tile starts a segment
      const bool first = live && (tid == 0 || lq.row[tid - 1] != r);
      const unsigned m = __ballot_sync(FULL, first);
      if ((tid & 31) == 0) meta[3 + (tid >> 5)] = (int)m;
    }
    __syncthreads();
    if (tid < TR) {  // the segment starts, in order; seg[nseg] = cnt
      const unsigned m0 = meta[3], m1 = meta[4];
      const int lane = tid & 31;
      const unsigned mine = tid < 32 ? m0 : m1;
      if ((mine >> lane) & 1u)
        seg[(tid < 32 ? 0 : __popc(m0)) + __popc(mine & ((1u << lane) - 1u))] =
            tid;
      if (tid == 0) {
        const int ns = __popc(m0) + __popc(m1);
        meta[0] = ns;
        seg[ns] = cnt;
      }
    }
    // pre1 = ((P_r + Q_s) + d2 w1d) + b1 (0 on rows past cnt); t1 = SiLU
    for (int f = tid; f < TR * W / 4; f += THREADS) {
      const int i = f / (W / 4), q = (f % (W / 4)) * 4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (i < cnt) {
        const float4 p = *reinterpret_cast<const float4*>(
            BF ? stage + i * W + q : P + (size_t)lq.row[i] * W + q);
        const float4 o = *reinterpret_cast<const float4*>(
            BF ? stage + RT<W> + i * W + q : Q + (size_t)lq.snd[i] * W + q);
        const float d2 = rnd<BF>(RQ(F_D2)[i]);  // an operand of d2 . w1d
        v[0] = ((p.x + o.x) + d2 * sw1d[q]) + sb1[q];
        v[1] = ((p.y + o.y) + d2 * sw1d[q + 1]) + sb1[q + 1];
        v[2] = ((p.z + o.z) + d2 * sw1d[q + 2]) + sb1[q + 2];
        v[3] = ((p.w + o.w) + d2 * sw1d[q + 3]) + sb1[q + 3];
      }
      const float4 t = make_float4(v[0] * sigm(v[0]), v[1] * sigm(v[1]),
                                   v[2] * sigm(v[2]), v[3] * sigm(v[3]));
      if (BF)
        *reinterpret_cast<uint2*>(bT1 + swz16<W>(i, q)) = bf16x4(t);
      else
        *reinterpret_cast<float4*>(tT1 + swz<W>(i, q)) = t;
    }
    __syncthreads();
    if (BF && nxt > 0) fetch(TR, nxt);  // the stage has been read
    {  // msg = t1.W2 + b2
      Frag<W> m;
      frag_zero<W>(m);
      if constexpr (BF)
        tile_mma_bf<W, false, false, true>(m, bT1, bW2, L);
      else
        tile_mma<W, false, false, true>(m, tT1, sW2, L);
#pragma unroll
      for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) m[jn][e] += sb2[L.col<W>(jn, e)];
      frag_store<W>(tMSG, m, L);
      if (BF) frag_store_bf<W>(bMSG, m, L);
    }
    __syncthreads();
    if (gate_mlp) {  // gate = clip(SiLU(msg.Wg1 + bg1) . wg2)
      Frag<W> gp;
      frag_zero<W>(gp);
      if constexpr (BF)
        tile_mma_bf<W, false, false, true>(gp, bMSG, bWg1, L);
      else
        tile_mma<W, false, false, true>(gp, tMSG, sWg1, L);
#pragma unroll
      for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = L.col<W>(jn, e);
          const float u = gp[jn][e] + sbg1[c];
          gp[jn][e] = __fmul_rn(rnd<BF>(u * sigm(u)), swg2[c]);  // never fused
        }
      frag_rowsum<W>(gp, L, rowred);
      __syncthreads();
      if (tid < cnt) {
        float g = rowred[tid] + rowred[TR + tid];
        g = g < -clamp ? -clamp : (g > clamp ? clamp : g);  // NaN stays
        const float kd =
            rel_inv1p ? sqrtf(RQ(F_D2)[tid] + 1e-12f) + 1.0f : 1.0f;
        const float e = RQ(F_E)[tid];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float q = rel_inv1p ? RQ(F_REL0 + k)[tid] / kd
                                    : RQ(F_REL0 + k)[tid];
          RQ(F_DX0 + k)[tid] = rnd<BF>((q * g) * e);  // bf16: a summand
        }
      }
      __syncthreads();
    }
    // each row's sums, its live edges in slot order
    const int ns = meta[0];
    const int crow = meta[1 + cur];
    const float* cin = carry + cur * CARRY<W>;
    float* cout = carry + (cur ^ 1) * CARRY<W>;
    for (int k = grp; k < ns; k += THREADS / W) {
      const int e0 = seg[k], e1 = seg[k + 1];
      const int r = lq.row[e0];
      float a = 0.0f, dg = 0.0f, d = 0.0f;
      // rows between the previous segment's and this one's: no live slot
      int gap = k > 0 ? lq.row[seg[k - 1]] + 1
                      : (crow >= 0 ? crow + 1 : row_lo);
      if (k == 0 && crow >= 0) {
        if (crow == r) {  // the carried row goes on
          a = cin[j];
          dg = cin[W];
          d = j < 3 ? cin[W + 1 + j] : 0.0f;
        } else {
          finish(crow, cin[j], cin[W], j < 3 ? cin[W + 1 + j] : 0.0f);
        }
      }
      for (; gap < r; ++gap) finish(gap, 0.0f, 0.0f, 0.0f);
      for (int e = e0; e < e1; ++e) {
        const float w = RQ(F_E)[e];
        a += rnd<BF>(tMSG[swz<W>(e, j)] * w);
        dg += rnd<BF>(w);
        if (j < 3) d += RQ(F_DX0 + j)[e];
      }
      if (k + 1 < ns) {
        finish(r, a, dg, d);
      } else {  // the tile's last row may go on in the next tile
        cout[j] = a;
        if (j < 3) cout[W + 1 + j] = d;
        if (j == 0) {
          cout[W] = dg;
          meta[1 + (cur ^ 1)] = r;
        }
      }
    }
    cur ^= 1;
    __syncthreads();
  };

  async_wait_all();
  __syncthreads();  // weights in
  const int beg = indptr[row_lo], end = indptr[row_hi];
  if constexpr (BF)
    for_live_tiles_ahead(em, rowof, snd, beg, end, lq, fetch, tile);
  else
    for_live_tiles(em, rowof, snd, beg, end, lq,
                   [&](int cnt) { tile(cnt, 0); });

  // the last row with live slots, then the rows after it: zeros
  const int crow = meta[1 + cur];
  int tail = row_lo;
  if (crow >= 0) {
    const float* cin = carry + cur * CARRY<W>;
    if (grp == 0)
      finish(crow, cin[j], cin[W], j < 3 ? cin[W + 1 + j] : 0.0f);
    tail = crow + 1;
  }
  for (int f = tail * W + tid; f < row_hi * W; f += THREADS) mh[f] = 0.0f;
  for (int f = tail + tid; f < row_hi; f += THREADS) deg[f] = 0.0f;
  for (int f = 3 * tail + tid; f < 3 * row_hi; f += THREADS) dx[f] = 0.0f;
}

struct Scratch {
  float *P, *Q;
  int *rowof, *ctarow;
  size_t total;
};

Scratch carve(float* base, int n, int e, int n_ctas, int width) {
  Scratch s;
  size_t off = 0;
  auto take = [&](size_t count) {
    float* p = base == nullptr ? nullptr : base + off;
    off += round4(count);
    return p;
  };
  s.P = take((size_t)n * width);
  s.Q = take((size_t)n * width);
  s.rowof = reinterpret_cast<int*>(take((size_t)e));
  s.ctarow = reinterpret_cast<int*>(take((size_t)n_ctas + 1));
  s.total = off;
  return s;
}

template <int W, bool BF>
int launch_forward(const float* x, const float* h, const int* snd,
                   const float* em, const int* indptr, const float* w1r,
                   const float* w1s, const float* w1d, const float* b1,
                   const float* w2, const float* b2, const float* wg1,
                   const float* bg1, const float* wg2, float* dx, float* mh,
                   float* deg, float* scratch, int n_nodes, int n_slots,
                   int gate_mlp, int rel_inv1p, float clamp, int n_ctas,
                   cudaStream_t stream) {
  const size_t e_smem = EDGE_SMEM_FLOATS<W, BF> * sizeof(float);
  const size_t p_smem = PROJ_SMEM_FLOATS<W, BF> * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      edge_fwd_edges<W, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)e_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(node_proj<W, BF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)p_smem);
  if (err != cudaSuccess) return (int)err;
  if (n_nodes <= 0) return (int)cudaGetLastError();
  Scratch s = carve(scratch, n_nodes, n_slots, n_ctas, W);
  node_proj<W, BF><<<n_tiles(n_nodes), THREADS, p_smem, stream>>>(
      h, w1r, w1s, indptr, s.P, s.Q, s.rowof, s.ctarow, n_nodes, n_ctas);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  edge_fwd_edges<W, BF><<<n_ctas, THREADS, e_smem, stream>>>(
      x, snd, em, indptr, s.rowof, s.ctarow, s.P, s.Q, w1d, b1, w2, b2, wg1,
      bg1, wg2, dx, mh, deg, gate_mlp, rel_inv1p, clamp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long edge_fwd_scratch_floats(int n_nodes, int n_slots,
                                             int n_ctas, int width) {
  return (long long)carve(nullptr, n_nodes, n_slots, n_ctas, width).total;
}

// width: the compiled width (32 or 64) that Dh, H1 and M were padded to;
// bf16 != 0: the bf16 mode
extern "C" int edge_forward(const float* x, const float* h, const int* snd,
                            const float* em, const int* indptr,
                            const float* w1r, const float* w1s,
                            const float* w1d, const float* b1,
                            const float* w2, const float* b2,
                            const float* wg1, const float* bg1,
                            const float* wg2, float* dx, float* mh,
                            float* deg, float* scratch, int n_nodes,
                            int n_slots, int gate_mlp, int rel_inv1p,
                            float clamp, int n_ctas, int width, int bf16,
                            void* stream_ptr) {
  if (!(aligned16(h) && aligned16(w1r) && aligned16(w1s) && aligned16(w2) &&
        (!gate_mlp || aligned16(wg1)) && aligned16(scratch)))
    return (int)cudaErrorMisalignedAddress;
  if (n_ctas <= 0) return (int)cudaErrorInvalidValue;
  return with_width(width, bf16, [&](auto w, auto bf) {
    return launch_forward<decltype(w)::value, decltype(bf)::value>(
        x, h, snd, em, indptr, w1r, w1s, w1d, b1, w2, b2, wg1, bg1, wg2, dx,
        mh, deg, scratch, n_nodes, n_slots, gate_mlp, rel_inv1p, clamp,
        n_ctas, (cudaStream_t)stream_ptr);
  });
}

// the CTAs an SM the edge kernel is built for (the wrapper launches that
// many an SM)
extern "C" int edge_fwd_blocks_per_sm(int width, int bf16) {
  return with_width(width, bf16, [](auto w, auto bf) {
    return CTAS_PER_SM<decltype(w)::value, decltype(bf)::value>;
  });
}

// the CTAs of the edge kernel an SM holds at once, as the card reports
// it for its registers and shared memory (-1 on an error)
extern "C" int edge_fwd_occupancy(int width, int bf16) {
  return with_width(width, bf16, [](auto w, auto bf) {
    constexpr int W = decltype(w)::value;
    constexpr bool B = decltype(bf)::value;
    const int bytes = EDGE_SMEM_FLOATS<W, B> * sizeof(float);
    int n = -1;
    if (cudaFuncSetAttribute(edge_fwd_edges<W, B>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, edge_fwd_edges<W, B>, THREADS, bytes) != cudaSuccess)
      return -1;
    return n;
  });
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
