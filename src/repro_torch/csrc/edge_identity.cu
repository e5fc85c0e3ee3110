// Real-real edge pathway with the identity gate, forward and backward, for
// Hopper (sm_90a), f32: the `gate_mode = 'identity'` branch of the Pallas
// TPU kernels `edge_pathway_fused` (`_edge_kernel`, the branch where the
// width-1 message is the gate) and `edge_pathway_bwd_fused`
// (`_edge_bwd_common`, `g_msg += g_gate`) of the JAX package's
// kernels/edge_message.py.  RF runs it with a zero feature column (Dh = 1,
// rel 'inv1p'), SchNet's Eq. 13 coordinate head with Dh = 64 (rel 'raw');
// both with H1 = 64 and M = 1, over the receiver-sorted CSR layout of the
// port (`indptr`, N+1 row offsets into the slot arrays).
//
// Per receiver r and live slot e = (r <- s) (em[e] != 0), in slot order:
//   pre1 = ((P_r + Q_s) + d2 w1d) + b1     P = h.W1r, Q = h.W1s  (64)
//   msg  = sum_c silu(pre1_c) w2_c + b2                            (scalar)
//   gate = clip(msg, -clamp, clamp)                                (NaN stays)
//   mh  += msg em ; deg += em ; dx += (rel_used gate) em
//   rel_used = rel, or rel / (sqrt(d2 + 1e-12) + 1) ('inv1p')
// then mh and dx are divided by max(deg, 1).
//
// With M = 1 the second product is a 64-long dot per edge, so there is no
// tile product to give to the tensor cores: the kernels run on the FP32
// units.  One warp owns one receiver row at a time (lane l holds columns l
// and l + 32); it reads 32 slots' masks and senders at once, ballots the
// live ones and walks them in slot order, the dot product a fixed xor
// butterfly (every lane ends with the same bits).  A row's sums start from
// zero and add its live edges one at a time, so each output depends on its
// row's live edges and their order only: not on the CTA count, the card,
// or how many masked slots the layout holds.  No float atomics; repeated
// runs are bitwise equal.
//
// Forward, two launches: idn_proj (P and Q, one thread a node and column,
// a Dh-long dot: for RF's Dh = 1 the rank-1 product h_n W1r[0, c]) and
// idn_fwd_rows.  Backward, four: idn_proj; idn_bwd_rows, which recomputes
// each live edge's forward, backpropagates as `_edge_bwd_common` does
// (upstream u = g_*[r] / max(deg_r, 1) em; the clip passes the gradient
// inside [-clamp, clamp], bounds included; 'inv1p' adds the
// -(kf^2 / 2 sd) (g_rel_used . rel) term to g_d2), stores g_pre1 (64) and
// g_rel (3) per live slot, and sums per row G_r = sum g_pre1, the
// receiver half of gx and the row's W2, w1d and b2 gradient partials;
// idn_bwd_nodes, one CTA per 64 nodes, which adds each node's sender
// segment (the `csr_sender_perm` order), forms gh = G.W1r^T + S.W1s^T and
// the tile's W1r, W1s, b1, W2, w1d and b2 partials in node order; and
// idn_bwd_reduce, which adds the tiles' partials in tile order.  The
// summation order of every gradient is fixed by the inputs alone.
//
// Bound on an H100 (serving shape: 8,192 nodes, 84,806 live edges,
// Dh = 64): per node the two 64 x 64 projections (16K FLOP), per live edge
// ~0.66K FLOP forward; ~0.19 GFLOP in all, 0.0028 ms at 67 TFLOP/s, against
// ~3.8 MB of reads and writes (0.0011 ms at 3.35 TB/s): bound by
// operations.  In practice a warp's walk of its row is a chain of
// dependent gathers (slot -> sender -> Q_s), which the 32-slot prefetch
// shortens.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int H1 = 64;             // phi1's hidden width
constexpr int WARPS = 8;           // warps a CTA
constexpr int THREADS = 32 * WARPS;
constexpr int TILE_N = 64;         // nodes of a node-pass tile
constexpr int RPW = 2 * H1 + 4;    // row partials: W2 (64) | w1d (64) | b2
constexpr int PAD = H1 + 1;        // padded shared rows (no bank conflicts)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float sigm(float u) {
  return 1.0f / (1.0f + expf(-u));
}

// the same sum on every lane: a fixed xor butterfly
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// P = h.W1r, Q = h.W1s: one thread a (node, column), a Dh-long dot in k
// order
__global__ void __launch_bounds__(THREADS)
idn_proj(const float* __restrict__ h, const float* __restrict__ w1r,
         const float* __restrict__ w1s, float* __restrict__ P,
         float* __restrict__ Q, int n_nodes, int dh) {
  const long long f = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (f >= (long long)n_nodes * H1) return;
  const int n = (int)(f / H1), c = (int)(f % H1);
  float p = 0.0f, q = 0.0f;
  for (int k = 0; k < dh; ++k) {
    const float hv = h[(size_t)n * dh + k];
    p = fmaf(hv, w1r[k * H1 + c], p);
    q = fmaf(hv, w1s[k * H1 + c], q);
  }
  P[f] = p;
  Q[f] = q;
}

// One live edge's forward terms, recomputed identically by the backward.
struct Edge {
  float rel[3], d2, msg;
};

__device__ __forceinline__ void edge_forward(
    const float* __restrict__ x, const float* __restrict__ Q, int s,
    const float (&xr)[3], const float (&p)[2], const float (&w1d)[2],
    const float (&b1)[2], const float (&w2)[2], float b2, int lane, Edge& e,
    float (&t)[2], float (&dt)[2], bool want_dt) {
  e.rel[0] = xr[0] - x[3 * s];
  e.rel[1] = xr[1] - x[3 * s + 1];
  e.rel[2] = xr[2] - x[3 * s + 2];
  e.d2 = __fadd_rn(__fadd_rn(__fmul_rn(e.rel[0], e.rel[0]),
                             __fmul_rn(e.rel[1], e.rel[1])),
                   __fmul_rn(e.rel[2], e.rel[2]));
  float part = 0.0f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = lane + 32 * j;
    const float u =
        ((p[j] + Q[(size_t)s * H1 + c]) + e.d2 * w1d[j]) + b1[j];
    const float sg = sigm(u);
    t[j] = u * sg;
    if (want_dt) dt[j] = sg * (1.0f + u * (1.0f - sg));
    part = fmaf(t[j], w2[j], part);
  }
  e.msg = warp_sum(part) + b2;
}

// Calls fn(e, em_e, s) for every live slot e of [e0, e1) in slot order:
// 32 masks and senders read at once, the live ones balloted.
template <typename Fn>
__device__ __forceinline__ void for_live_slots(const float* __restrict__ em,
                                               const int* __restrict__ snd,
                                               int e0, int e1, int lane,
                                               Fn fn) {
  for (int b = e0; b < e1; b += 32) {
    const int e = b + lane;
    const float m = e < e1 ? em[e] : 0.0f;
    const int s = e < e1 ? snd[e] : 0;
    unsigned live = __ballot_sync(FULL, m != 0.0f);
    while (live) {
      const int k = __ffs(live) - 1;
      live &= live - 1;
      fn(b + k, __shfl_sync(FULL, m, k), __shfl_sync(FULL, s, k));
    }
  }
}

__device__ __forceinline__ float clip(float g, float clamp) {
  return g < -clamp ? -clamp : (g > clamp ? clamp : g);  // NaN stays
}

__global__ void __launch_bounds__(THREADS)
idn_fwd_rows(const float* __restrict__ x, const int* __restrict__ snd,
             const float* __restrict__ em, const int* __restrict__ indptr,
             const float* __restrict__ P, const float* __restrict__ Q,
             const float* __restrict__ w1d_g, const float* __restrict__ b1_g,
             const float* __restrict__ w2_g, const float* __restrict__ b2_g,
             float* __restrict__ dx, float* __restrict__ mh,
             float* __restrict__ deg, int n_nodes, int rel_inv1p,
             float clamp) {
  const int lane = threadIdx.x & 31;
  const int warp0 = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * WARPS;
  const float w1d[2] = {w1d_g[lane], w1d_g[lane + 32]};
  const float b1[2] = {b1_g[lane], b1_g[lane + 32]};
  const float w2[2] = {w2_g[lane], w2_g[lane + 32]};
  const float b2 = b2_g[0];
  for (int r = warp0; r < n_nodes; r += n_warps) {
    const float xr[3] = {x[3 * r], x[3 * r + 1], x[3 * r + 2]};
    const float p[2] = {P[(size_t)r * H1 + lane], P[(size_t)r * H1 + lane + 32]};
    float a = 0.0f, dg = 0.0f, d[3] = {0.0f, 0.0f, 0.0f};
    for_live_slots(em, snd, indptr[r], indptr[r + 1], lane,
                   [&](int, float m, int s) {
      Edge e;
      float t[2], dt[2];
      edge_forward(x, Q, s, xr, p, w1d, b1, w2, b2, lane, e, t, dt, false);
      const float g = clip(e.msg, clamp);
      const float kd = rel_inv1p ? sqrtf(e.d2 + 1e-12f) + 1.0f : 1.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float q = rel_inv1p ? e.rel[k] / kd : e.rel[k];
        d[k] += __fmul_rn(__fmul_rn(q, g), m);
      }
      a += __fmul_rn(e.msg, m);
      dg += m;
    });
    const float inv = 1.0f / fmaxf(dg, 1.0f);
    if (lane == 0) {
      mh[r] = a * inv;
      deg[r] = dg;
    }
    if (lane < 3) dx[3 * r + lane] = d[lane] * inv;
  }
}

// Backward, per receiver row: each live edge's g_pre1 and g_rel into
// GPRE1 / GREL (slot-indexed), and the row's sums: G (64), the receiver
// half of gx (3) and the partials W2 (64) | w1d (64) | b2 of RP.
__global__ void __launch_bounds__(THREADS)
idn_bwd_rows(const float* __restrict__ x, const int* __restrict__ snd,
             const float* __restrict__ em, const int* __restrict__ indptr,
             const float* __restrict__ P, const float* __restrict__ Q,
             const float* __restrict__ w1d_g, const float* __restrict__ b1_g,
             const float* __restrict__ w2_g, const float* __restrict__ b2_g,
             const float* __restrict__ deg, const float* __restrict__ gdx,
             const float* __restrict__ gmh, float* __restrict__ GPRE1,
             float* __restrict__ GREL, float* __restrict__ G,
             float* __restrict__ GXR, float* __restrict__ RP, int n_nodes,
             int rel_inv1p, float clamp) {
  const int lane = threadIdx.x & 31;
  const int warp0 = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * WARPS;
  const float w1d[2] = {w1d_g[lane], w1d_g[lane + 32]};
  const float b1[2] = {b1_g[lane], b1_g[lane + 32]};
  const float w2[2] = {w2_g[lane], w2_g[lane + 32]};
  const float b2 = b2_g[0];
  for (int r = warp0; r < n_nodes; r += n_warps) {
    const float xr[3] = {x[3 * r], x[3 * r + 1], x[3 * r + 2]};
    const float p[2] = {P[(size_t)r * H1 + lane], P[(size_t)r * H1 + lane + 32]};
    const float inv = 1.0f / fmaxf(deg[r], 1.0f);
    const float gm = gmh[r];
    const float gd[3] = {gdx[3 * r], gdx[3 * r + 1], gdx[3 * r + 2]};
    float sG[2] = {0.0f, 0.0f}, sW2[2] = {0.0f, 0.0f}, sW1d[2] = {0.0f, 0.0f};
    float sB2 = 0.0f, gxr = 0.0f;  // lane k < 3: component k
    for_live_slots(em, snd, indptr[r], indptr[r + 1], lane,
                   [&](int slot, float m, int s) {
      Edge e;
      float t[2], dt[2];
      edge_forward(x, Q, s, xr, p, w1d, b1, w2, b2, lane, e, t, dt, true);
      const float sc = inv * m;
      float u[3], ru[3], kf = 1.0f, sd = 0.0f;
      if (rel_inv1p) {
        sd = sqrtf(e.d2 + 1e-12f);
        kf = 1.0f / (sd + 1.0f);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        u[k] = gd[k] * sc;
        ru[k] = rel_inv1p ? e.rel[k] * kf : e.rel[k];
      }
      const float gate = clip(e.msg, clamp);
      float g_gate = u[0] * ru[0] + u[1] * ru[1] + u[2] * ru[2];
      if (!(e.msg >= -clamp && e.msg <= clamp)) g_gate = 0.0f;
      const float g_msg = gm * sc + g_gate;
      float gp[2], gwd = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        gp[j] = __fmul_rn(g_msg * w2[j], dt[j]);
        gwd = fmaf(gp[j], w1d[j], gwd);
      }
      float g_d2 = warp_sum(gwd);
      float gr[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) gr[k] = u[k] * gate;  // g_rel_used
      if (rel_inv1p) {
        g_d2 += (gr[0] * e.rel[0] + gr[1] * e.rel[1] + gr[2] * e.rel[2]) *
                (-(kf * kf) / (2.0f * sd));
#pragma unroll
        for (int k = 0; k < 3; ++k) gr[k] *= kf;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) gr[k] += 2.0f * e.rel[k] * g_d2;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        GPRE1[(size_t)slot * H1 + lane + 32 * j] = gp[j];
        sG[j] += gp[j];
        sW2[j] += __fmul_rn(t[j], g_msg);
        sW1d[j] += __fmul_rn(e.d2, gp[j]);
      }
      sB2 += g_msg;
      const float mine = lane == 0 ? gr[0] : (lane == 1 ? gr[1] : gr[2]);
      if (lane < 3) {
        GREL[(size_t)slot * 4 + lane] = mine;
        gxr += mine;
      }
    });
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      G[(size_t)r * H1 + lane + 32 * j] = sG[j];
      RP[(size_t)r * RPW + lane + 32 * j] = sW2[j];
      RP[(size_t)r * RPW + H1 + lane + 32 * j] = sW1d[j];
    }
    if (lane == 0) RP[(size_t)r * RPW + 2 * H1] = sB2;
    if (lane < 3) GXR[(size_t)r * 4 + lane] = gxr;
  }
}

// the tile's partials: W1r (dh x 64) | W1s (dh x 64) | b1 | W2 | w1d | b2
__host__ __device__ inline int pn_width(int dh) {
  return 2 * dh * H1 + 3 * H1 + 1;
}

// CTA per 64 nodes: each node's sender segment S (and the sender half of
// gx), gh = G.W1r^T + S.W1s^T, then the tile's partials in node order.
__global__ void __launch_bounds__(THREADS)
idn_bwd_nodes(const float* __restrict__ h, const float* __restrict__ em,
              const int* __restrict__ sperm, const int* __restrict__ sptr,
              const float* __restrict__ w1r, const float* __restrict__ w1s,
              const float* __restrict__ GPRE1, const float* __restrict__ GREL,
              const float* __restrict__ G, const float* __restrict__ GXR,
              const float* __restrict__ RP, float* __restrict__ gx,
              float* __restrict__ gh, float* __restrict__ PN, int n_nodes,
              int dh) {
  extern __shared__ float smem[];
  float* sWr = smem;              // [dh][PAD]
  float* sWs = sWr + dh * PAD;    // [dh][PAD]
  float* sG = sWs + dh * PAD;     // [64][PAD]
  float* sS = sG + TILE_N * PAD;  // [64][PAD]
  float* sH = sS + TILE_N * PAD;  // [64][dh]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int node0 = blockIdx.x * TILE_N;
  for (int f = tid; f < dh * H1; f += THREADS) {
    sWr[(f / H1) * PAD + f % H1] = w1r[f];
    sWs[(f / H1) * PAD + f % H1] = w1s[f];
  }
  for (int f = tid; f < TILE_N * dh; f += THREADS) {
    const int i = node0 + f / dh;
    sH[f] = i < n_nodes ? h[(size_t)i * dh + f % dh] : 0.0f;
  }
  __syncthreads();
  for (int li = warp; li < TILE_N; li += WARPS) {
    const int i = node0 + li;
    float S[2] = {0.0f, 0.0f}, gxs = 0.0f, Gv[2] = {0.0f, 0.0f};
    if (i < n_nodes) {
      Gv[0] = G[(size_t)i * H1 + lane];
      Gv[1] = G[(size_t)i * H1 + lane + 32];
      const int p1 = sptr[i + 1];
      for (int b = sptr[i]; b < p1; b += 32) {
        const int p = b + lane;
        const int slot = p < p1 ? sperm[p] : 0;
        unsigned live = __ballot_sync(FULL, p < p1 && em[slot] != 0.0f);
        while (live) {
          const int k = __ffs(live) - 1;
          live &= live - 1;
          const int sl = __shfl_sync(FULL, slot, k);
          S[0] += GPRE1[(size_t)sl * H1 + lane];
          S[1] += GPRE1[(size_t)sl * H1 + lane + 32];
          if (lane < 3) gxs -= GREL[(size_t)sl * 4 + lane];
        }
      }
      if (lane < 3) gx[3 * i + lane] = GXR[(size_t)i * 4 + lane] + gxs;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sG[li * PAD + lane + 32 * j] = Gv[j];
      sS[li * PAD + lane + 32 * j] = S[j];
    }
    __syncwarp();
    if (i < n_nodes) {
      for (int k = lane; k < dh; k += 32) {
        float a = 0.0f;
        for (int c = 0; c < H1; ++c) a = fmaf(sG[li * PAD + c], sWr[k * PAD + c], a);
        for (int c = 0; c < H1; ++c) a = fmaf(sS[li * PAD + c], sWs[k * PAD + c], a);
        gh[(size_t)i * dh + k] = a;
      }
    }
  }
  __syncthreads();
  const int pw = pn_width(dh);
  float* out = PN + (size_t)blockIdx.x * pw;
  const int nn = min(TILE_N, n_nodes - node0);
  for (int f = tid; f < pw; f += THREADS) {
    float a = 0.0f;
    if (f < 2 * dh * H1) {
      const float* T = f < dh * H1 ? sG : sS;
      const int q = f < dh * H1 ? f : f - dh * H1;
      const int k = q / H1, c = q % H1;
      for (int li = 0; li < nn; ++li)
        a = fmaf(sH[li * dh + k], T[li * PAD + c], a);
    } else if (f < 2 * dh * H1 + H1) {  // b1: sum of G
      const int c = f - 2 * dh * H1;
      for (int li = 0; li < nn; ++li) a += sG[li * PAD + c];
    } else {  // W2 | w1d | b2: the rows' partials
      const int q = f - 2 * dh * H1 - H1;
      for (int li = 0; li < nn; ++li)
        a += RP[(size_t)(node0 + li) * RPW + q];
    }
    out[f] = a;
  }
}

struct Outs {
  float *gw1r, *gw1s, *gw1d, *gb1, *gw2, *gb2;
};

// every weight gradient: the tiles' partials added in tile order
__global__ void idn_bwd_reduce(const float* __restrict__ PN, Outs o,
                               int n_tiles, int dh) {
  const int pw = pn_width(dh);
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= pw) return;
  float a = 0.0f;
  for (int t = 0; t < n_tiles; ++t) a += PN[(size_t)t * pw + f];
  const int dw = dh * H1;
  if (f < dw) o.gw1r[f] = a;
  else if (f < 2 * dw) o.gw1s[f - dw] = a;
  else if (f < 2 * dw + H1) o.gb1[f - 2 * dw] = a;
  else if (f < 2 * dw + 2 * H1) o.gw2[f - 2 * dw - H1] = a;
  else if (f < 2 * dw + 3 * H1) o.gw1d[f - 2 * dw - 2 * H1] = a;
  else o.gb2[0] = a;
}

size_t round4(size_t v) { return (v + 3) & ~size_t(3); }
int node_tiles(int n) { return (n + TILE_N - 1) / TILE_N; }
int row_blocks(int n, int n_ctas) {
  return n_ctas > 0 ? n_ctas : (n + WARPS - 1) / WARPS;
}

struct Scratch {
  float *P, *Q, *G, *GXR, *RP, *GPRE1, *GREL, *PN;
  size_t total;
};

Scratch carve(float* base, int n, int e, int dh, bool backward) {
  Scratch s{};
  size_t off = 0;
  auto take = [&](size_t count) {
    float* p = base == nullptr ? nullptr : base + off;
    off += round4(count);
    return p;
  };
  s.P = take((size_t)n * H1);
  s.Q = take((size_t)n * H1);
  if (backward) {
    s.G = take((size_t)n * H1);
    s.GXR = take((size_t)n * 4);
    s.RP = take((size_t)n * RPW);
    s.GPRE1 = take((size_t)e * H1);
    s.GREL = take((size_t)e * 4);
    s.PN = take((size_t)node_tiles(n) * pn_width(dh));
  }
  s.total = off;
  return s;
}

int check_shape(int dh, int n_ctas) {
  if ((dh != 1 && dh != H1) || n_ctas < 0) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" long long idn_scratch_floats(int n_nodes, int n_slots, int dh,
                                        int backward) {
  return (long long)carve(nullptr, n_nodes, n_slots, dh, backward != 0).total;
}

// n_ctas: CTAs of the row passes (0: one warp a row); any count gives the
// same bits
extern "C" int edge_identity_forward(
    const float* x, const float* h, const int* snd, const float* em,
    const int* indptr, const float* w1r, const float* w1s, const float* w1d,
    const float* b1, const float* w2, const float* b2, float* dx, float* mh,
    float* deg, float* scratch, int n_nodes, int n_slots, int dh,
    int rel_inv1p, float clamp, int n_ctas, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (int err = check_shape(dh, n_ctas)) return err;
  if (n_nodes <= 0) return (int)cudaGetLastError();
  Scratch s = carve(scratch, n_nodes, n_slots, dh, false);
  const long long nf = (long long)n_nodes * H1;
  idn_proj<<<(unsigned)((nf + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      h, w1r, w1s, s.P, s.Q, n_nodes, dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  idn_fwd_rows<<<row_blocks(n_nodes, n_ctas), THREADS, 0, stream>>>(
      x, snd, em, indptr, s.P, s.Q, w1d, b1, w2, b2, dx, mh, deg, n_nodes,
      rel_inv1p, clamp);
  return (int)cudaGetLastError();
}

extern "C" int edge_identity_backward(
    const float* x, const float* h, const int* snd, const float* em,
    const int* indptr, const int* sperm, const int* sptr, const float* w1r,
    const float* w1s, const float* w1d, const float* b1, const float* w2,
    const float* b2, const float* deg, const float* gdx, const float* gmh,
    float* gx, float* gh, float* gw1r, float* gw1s, float* gw1d, float* gb1,
    float* gw2, float* gb2, float* scratch, int n_nodes, int n_slots, int dh,
    int rel_inv1p, float clamp, int n_ctas, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (int err = check_shape(dh, n_ctas)) return err;
  const size_t n_smem =
      (size_t)(2 * dh * PAD + 2 * TILE_N * PAD + TILE_N * dh) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      idn_bwd_nodes, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)n_smem);
  if (err != cudaSuccess) return (int)err;
  if (n_nodes <= 0) return (int)cudaGetLastError();
  Scratch s = carve(scratch, n_nodes, n_slots, dh, true);
  const long long nf = (long long)n_nodes * H1;
  idn_proj<<<(unsigned)((nf + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      h, w1r, w1s, s.P, s.Q, n_nodes, dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  idn_bwd_rows<<<row_blocks(n_nodes, n_ctas), THREADS, 0, stream>>>(
      x, snd, em, indptr, s.P, s.Q, w1d, b1, w2, b2, deg, gdx, gmh, s.GPRE1,
      s.GREL, s.G, s.GXR, s.RP, n_nodes, rel_inv1p, clamp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nt = node_tiles(n_nodes);
  idn_bwd_nodes<<<nt, THREADS, n_smem, stream>>>(
      h, em, sperm, sptr, w1r, w1s, s.GPRE1, s.GREL, s.G, s.GXR, s.RP, gx,
      gh, s.PN, n_nodes, dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Outs o{gw1r, gw1s, gw1d, gb1, gw2, gb2};
  const int pw = pn_width(dh);
  idn_bwd_reduce<<<(pw + 255) / 256, 256, 0, stream>>>(s.PN, o, nt, dh);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
