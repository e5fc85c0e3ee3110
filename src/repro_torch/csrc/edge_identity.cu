// Real-real edge pathway with the identity gate, forward and backward, for
// Hopper (sm_90a), f32 and bf16 modes: the `gate_mode = 'identity'` branch of the Pallas
// TPU kernels `edge_pathway_fused` (`_edge_kernel`, the branch where the
// width-1 message is the gate) and `edge_pathway_bwd_fused`
// (`_edge_bwd_common`, `g_msg += g_gate`) of the JAX package's
// kernels/edge_message.py.  RF runs it with a zero feature column (Dh = 1,
// rel 'inv1p'), SchNet's Eq. 13 coordinate head with Dh = hidden (rel
// 'raw'); both with H1 = hidden and M = 1, over the receiver-sorted CSR
// layout of the port (`indptr`, N+1 row offsets into the slot arrays).
// Any Dh, and H1 up to 32 MAX_NJ: a lane holds columns lane + 32 j, j <
// NJ (NJ = 1, 2, 4, 8, 16 or 24, the fewest that hold H1; compiled with
// the width a constant where H1 = 32 NJ, columns past H1 read as zeros
// and add +0 otherwise).
//
// Per receiver r and live slot e = (r <- s) (em[e] != 0), in slot order:
//   pre1 = ((P_r + Q_s) + d2 w1d) + b1     P = h.W1r, Q = h.W1s  (64)
//   msg  = sum_c silu(pre1_c) w2_c + b2                            (scalar)
//   gate = clip(msg, -clamp, clamp)                                (NaN stays)
//   mh  += msg em ; deg += em ; dx += (rel_used gate) em
//   rel_used = rel, or rel / (sqrt(d2 + 1e-12) + 1) ('inv1p')
// then mh and dx are divided by max(deg, 1).
//
// With M = 1 the second product is an H1-long dot per edge, so there is no
// tile product to give to the tensor cores: the per-edge work runs on the
// FP32 units.  The dot is a fixed xor butterfly over 32 lanes' partials
// (lane l: columns l, l + 32, ...), the same tree in every kernel that
// forms it.  Each row's sums start from zero and add its live edges one
// at a time in slot order, so each output depends on its row's live edges
// and their order only: not on the CTA count, the card, or how many
// masked slots the layout holds.  No float atomics; repeated runs are
// bitwise equal.
//
// Forward, two launches: the projection (P and Q) and the edge pass.
// * The tile route (Dh and H1 up to 64, `tile_width`: SchNet's form at 32
//   and 64, RF's Dh = 1): the projection `padded_proj` (common.cuh:
//   64-node tiles, both widths zero-padded to W = 32 or 64 in the kernel,
//   two tile products on the tensor cores, 3xTF32; bf16: bf16 tiles,
//   m16n8k16), or for RF's Dh = 1 (a rank-1 product) idn_proj_rows,
//   writes P and Q as rows of W (zeros past H1) and the CSR by-products of #1's
//   node_proj (`csr_rows`: each slot's receiver row, each edge CTA's
//   rows).  Then idn_fwd_tiles, edge-parallel as #1's edge pass: CTA b
//   owns the receiver rows whose CSR segment starts in its equal share of
//   [0, indptr[N]) (a row is never split), packs their live slots in slot
//   order into 64-edge tiles (#1's tiles) and brings the next tile's Q_s
//   rows, x_s and its rows' P_r and x_r (once a row a tile) into a second
//   shared-memory stage by cp.async while this tile runs.
//   Four threads an edge, 16 columns a thread at W = 64: pre1, the SiLU
//   (the fast sigmoid of #1) and the thread's eight lanes' partials of
//   the dot, the butterfly's xor 16, 8, 4 levels inside the thread and
//   2, 1 by shuffles -- the warp butterfly's tree.  Each row's five sums
//   are added in slot order by one thread, carried across tiles; a warp of
//   its own scans the slots, cuts the tiles and adds the row sums beside
//   the compute warps.  Masked slots never enter a tile (an Inf there
//   cannot become a NaN).
// * Wider layers (H1 above 64, or Dh above 64): idn_proj (one thread a
//   node and column, a Dh-long dot) and idn_fwd_rows, one warp a receiver
//   row at a time (lane l holds columns l, l + 32, ...): it reads 32
//   slots' masks and senders at once, ballots the live ones and walks them
//   in slot order.
// Backward,
// four: the projection; idn_bwd_rows, which recomputes
// each live edge's forward, backpropagates as `_edge_bwd_common` does
// (upstream u = g_*[r] / max(deg_r, 1) em; the clip passes the gradient
// inside [-clamp, clamp], bounds included; 'inv1p' adds the
// -(kf^2 / 2 sd) (g_rel_used . rel) term to g_d2), stores g_pre1 (H1) and
// g_rel (3) per live slot, and sums per row G_r = sum g_pre1, the
// receiver half of gx and the row's W2, w1d and b2 gradient partials;
// the node pass, one CTA per tile of 64 nodes, which adds each node's
// sender segment (the `csr_sender_perm` order), forms gh = G.W1r^T +
// S.W1s^T and the tile's W1r, W1s, b1, W2, w1d and b2 partials; and
// idn_bwd_reduce, which adds the tiles' partials in tile order.  The
// summation order of every gradient is fixed by the inputs alone.
// At Dh and H1 up to 64 the node pass is the tile route's
// idn_bwd_nodes_tile<W, false>: idn_bwd_rows stores g_pre1 per live slot
// as f32 rows of W (zeros past H1); a CTA of 512 threads, 8 lanes a node,
// walks all 64 nodes' sender segments at once (`segment_sum`, common.cuh:
// the same order and bits as the FP32-unit walk below), stages G, S and
// h as f32 tiles beside W1r and W1s, and forms gh and the W1r / W1s
// partials h^T G, h^T S as four 3xTF32 tile products; the b1, W2, w1d
// and b2 partials are the rows' sums in node order.  Wider layers take
// idn_bwd_nodes (fewer nodes a tile where they would not fit shared
// memory beside the weights, which are then read from device memory:
// `node_plan`): a warp a node, gh one lane an entry, the partials one
// thread an entry, serial sums over the tile's nodes.
//
// The bf16 mode (template BF; `precision='bf16'` of the Pallas kernels'
// identity branch): the rounding points of edge_message.cu /
// edge_message_bwd.cu with gate = msg: x, h and the weights rounded (h and
// W1r / W1s in the projections, x where it is read, the rest where it is
// loaded), d2 and t1 rounded as operands, the row sums' summands rounded
// (bf16(msg em), bf16(rel gate em), bf16(em)); backward: the gathered inv,
// g_mh and g_dx rounded, g_msg and g_pre1 rounded as operands, b1 and b2
// sums of unrounded terms, and the node pass's summands the reference's
// scatter operands: bf16(g_rel), bf16(g_pre1) and the per-edge products
// bf16(bf16(g_pre1) W1r^T) (summed per receiver) and bf16(bf16(g_pre1)
// W1s^T) (summed per sender).  The FMAs stay f32: a product of two bf16
// values is exact.
// The bf16 backward's tile route (Dh and H1 up to 64, SchNet's and RF's
// forms): idn_bwd_rows stores bf16(g_pre1) per slot as bf16 rows of W;
// idn_bwd_dh streams the slot range in 64-slot tiles and forms the two
// per-edge dh products on the tensor cores (bf16 tiles, m16n8k16, as
// edge_message_bwd.cu's bf16 edge pass), stored per live slot in bf16;
// and idn_bwd_nodes_tile<W, true> sums them per node with 8 lanes a node
// (the receiver segment in slot order, the sender segment in
// sender-permutation order, the FP32-unit route's orders) and forms the
// W1r / W1s partials as 3xTF32 tile products, as edge_message_bwd.cu's
// bf16 node pass does: five launches, scratch 3 x 2 W bytes a slot.  Wider
// bf16 layers keep the FP32-unit route: a warp dot a per-edge dh entry in
// the row pass, the node pass's serial per-lane sum of the sender terms.
// Bound on an H100 (serving shape: 8,192 nodes, 84,806 live edges,
// Dh = 64): per node the two 64 x 64 projections (16K FLOP), per live edge
// ~0.66K FLOP forward; ~0.19 GFLOP in all, 0.0028 ms at 67 TFLOP/s, against
// ~3.8 MB of reads and writes (0.0011 ms at 3.35 TB/s): bound by
// operations.  In practice the FP32-unit route's walk of a row is a chain
// of dependent gathers (slot -> sender -> Q_s), which the 32-slot
// prefetch shortens; the tile route gathers a tile's 64 Q_s rows (16 KB)
// at once, a tile ahead, and spreads its 4,096 sigmoids over the CTA.
#include "common.cuh"  // THREADS, FULL, the bf16 tiles and node sums

#include <math.h>

#include <initializer_list>

namespace {

constexpr int WARPS = THREADS / 32;  // warps a CTA
constexpr int TILE_N = 64;         // nodes of a node-pass tile (at most)
constexpr int MAX_NJ = 24;         // columns a lane: H1 <= 32 MAX_NJ
constexpr size_t SMEM_MAX = 227 * 1024;  // shared memory a CTA can have
constexpr int DH_CTAS_PER_SM = 4;  // CTAs of the bf16 dh pass an SM (any
                                   // count gives the same bits)

// row partials of the backward: W2 (h1) | w1d (h1) | b2 | 3 pad; in bf16
// also b1 (h1) before b2 (G sums rounded g_pre1 there, b1 unrounded)
__host__ __device__ inline int rp_width(int h1, bool bf16) {
  return (bf16 ? 3 : 2) * h1 + 4;
}

// the sigmoid with IEEE division and expf (common.cuh's `sigm` takes the
// fast ones, as the forward's tile pass does; the row passes keep their
// own bits)
__device__ __forceinline__ float sigm_ieee(float u) {
  return 1.0f / (1.0f + expf(-u));
}

// The tile route, for Dh and H1 up to 64 (both modes): the compiled width
// W (32 or 64) both are zero-padded to; 0: the FP32-unit route (above 64)
int tile_width(int dh, int h1) {
  if (dh > 64 || h1 > 64) return 0;
  return dh <= 32 && h1 <= 32 ? 32 : 64;
}

// the same sum on every lane: a fixed xor butterfly
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// P = h.W1r, Q = h.W1s above the tile route: one thread a (node, column),
// a Dh-long dot in k order
template <int NJ, bool EXACT, bool BF>
__global__ void __launch_bounds__(THREADS)
idn_proj(const float* __restrict__ h, const float* __restrict__ w1r,
         const float* __restrict__ w1s, float* __restrict__ P,
         float* __restrict__ Q, int n_nodes, int dh, int h1_) {
  const int h1 = EXACT ? 32 * NJ : h1_;
  const long long f = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (f >= (long long)n_nodes * h1) return;
  const int n = (int)(f / h1), c = (int)(f % h1);
  float p = 0.0f, q = 0.0f;
  for (int k = 0; k < dh; ++k) {
    const float hv = rnd<BF>(h[(size_t)n * dh + k]);
    p = fmaf(hv, rnd<BF>(w1r[(size_t)k * h1 + c]), p);
    q = fmaf(hv, rnd<BF>(w1s[(size_t)k * h1 + c]), q);
  }
  P[f] = p;
  Q[f] = q;
}

// The tile route forward's projection at RF's Dh = 1 (a rank-1 product):
// P and Q as rows of W (zeros past h1), one thread an entry, idn_proj's
// products; CTA t < n_tiles(N) also writes node tile t's CSR by-products
// (`csr_rows`)
template <int W, bool BF>
__global__ void __launch_bounds__(THREADS)
idn_proj_rows(const float* __restrict__ h, const float* __restrict__ w1r,
              const float* __restrict__ w1s, float* __restrict__ P,
              float* __restrict__ Q, int n_nodes, int h1,
              const int* __restrict__ indptr, int* __restrict__ rowof,
              int* __restrict__ ctarow, int n_ctas) {
  if ((int)blockIdx.x < n_tiles(n_nodes))
    csr_rows(indptr, rowof, ctarow, n_nodes, n_ctas, blockIdx.x);
  const int f = blockIdx.x * THREADS + threadIdx.x;
  if (f >= n_nodes * W) return;
  const int n = f / W, c = f % W;
  const float hv = rnd<BF>(h[n]);
  P[f] = c < h1 ? fmaf(hv, rnd<BF>(w1r[c]), 0.0f) : 0.0f;
  Q[f] = c < h1 ? fmaf(hv, rnd<BF>(w1s[c]), 0.0f) : 0.0f;
}

// One live edge's forward terms, recomputed identically by the backward.
struct Edge {
  float rel[3], d2, msg;
};

// lane's columns c = lane + 32 j, j < NJ; columns past h1 read as zeros
// (and add +0 to every sum)
// (rounded to bf16 with BF: the weight vectors)
template <int NJ, bool EXACT, bool BF = false>
__device__ __forceinline__ void load_cols(float (&dst)[NJ],
                                          const float* __restrict__ src,
                                          int lane, int h1) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = lane + 32 * j;
    dst[j] = EXACT || c < h1 ? rnd<BF>(src[c]) : 0.0f;
  }
}

// (BF: xr and the weight vectors arrive rounded)
template <int NJ, bool EXACT, bool BF>
__device__ __forceinline__ void edge_forward(
    const float* __restrict__ x, const float* __restrict__ Q, int s,
    const float (&xr)[3], const float (&p)[NJ], const float (&w1d)[NJ],
    const float (&b1)[NJ], const float (&w2)[NJ], float b2, int lane, int h1,
    Edge& e, float (&t)[NJ], float (&dt)[NJ], bool want_dt) {
  e.rel[0] = xr[0] - rnd<BF>(x[3 * s]);
  e.rel[1] = xr[1] - rnd<BF>(x[3 * s + 1]);
  e.rel[2] = xr[2] - rnd<BF>(x[3 * s + 2]);
  e.d2 = __fadd_rn(__fadd_rn(__fmul_rn(e.rel[0], e.rel[0]),
                             __fmul_rn(e.rel[1], e.rel[1])),
                   __fmul_rn(e.rel[2], e.rel[2]));
  float part = 0.0f;
  const float d2 = rnd<BF>(e.d2);  // an operand of d2 . w1d
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = lane + 32 * j;
    const float qv = EXACT || c < h1 ? Q[(size_t)s * h1 + c] : 0.0f;
    const float u = ((p[j] + qv) + d2 * w1d[j]) + b1[j];
    const float sg = sigm_ieee(u);
    t[j] = u * sg;
    if (want_dt) dt[j] = sg * (1.0f + u * (1.0f - sg));
    part = fmaf(rnd<BF>(t[j]), w2[j], part);
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

template <int NJ, bool EXACT, bool BF>
__global__ void __launch_bounds__(THREADS)
idn_fwd_rows(const float* __restrict__ x, const int* __restrict__ snd,
             const float* __restrict__ em, const int* __restrict__ indptr,
             const float* __restrict__ P, const float* __restrict__ Q,
             const float* __restrict__ w1d_g, const float* __restrict__ b1_g,
             const float* __restrict__ w2_g, const float* __restrict__ b2_g,
             float* __restrict__ dx, float* __restrict__ mh,
             float* __restrict__ deg, int n_nodes, int h1_, int rel_inv1p,
             float clamp) {
  const int h1 = EXACT ? 32 * NJ : h1_;
  const int lane = threadIdx.x & 31;
  const int warp0 = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * WARPS;
  float w1d[NJ], b1[NJ], w2[NJ];
  load_cols<NJ, EXACT, BF>(w1d, w1d_g, lane, h1);
  load_cols<NJ, EXACT, BF>(b1, b1_g, lane, h1);
  load_cols<NJ, EXACT, BF>(w2, w2_g, lane, h1);
  const float b2 = rnd<BF>(b2_g[0]);
  for (int r = warp0; r < n_nodes; r += n_warps) {
    const float xr[3] = {rnd<BF>(x[3 * r]), rnd<BF>(x[3 * r + 1]),
                         rnd<BF>(x[3 * r + 2])};
    float p[NJ];
    load_cols<NJ, EXACT>(p, P + (size_t)r * h1, lane, h1);
    float a = 0.0f, dg = 0.0f, d[3] = {0.0f, 0.0f, 0.0f};
    for_live_slots(em, snd, indptr[r], indptr[r + 1], lane,
                   [&](int, float m, int s) {
      Edge e;
      float t[NJ], dt[NJ];
      edge_forward<NJ, EXACT, BF>(x, Q, s, xr, p, w1d, b1, w2, b2, lane, h1,
                                  e, t, dt, false);
      const float g = clip(e.msg, clamp);
      const float kd = rel_inv1p ? sqrtf(e.d2 + 1e-12f) + 1.0f : 1.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float q = rel_inv1p ? e.rel[k] / kd : e.rel[k];
        d[k] += rnd<BF>(__fmul_rn(__fmul_rn(q, g), m));  // bf16: a summand
      }
      a += rnd<BF>(__fmul_rn(e.msg, m));
      dg += rnd<BF>(m);
    });
    const float inv = 1.0f / fmaxf(dg, 1.0f);
    if (lane == 0) {
      mh[r] = a * inv;
      deg[r] = dg;
    }
    if (lane < 3) dx[3 * r + lane] = d[lane] * inv;
  }
}

// ------------------------------------------------ forward, tile route
// idn_fwd_tiles<W, BF>: the forward's edge pass at Dh and H1 up to 64
// (both zero-padded to W), n_ctas CTAs of FWD_THREADS, FWD_CTAS_PER_SM an
// SM by default.  The CTA's live slots, in slot order, make tiles of 64
// (the last one shorter).  Eight compute warps and a scan warp (warp 8),
// one barrier a tile.  While the compute warps run tile t, the scan warp
// scans the next slots into a ring of entries (row, sender, mask; a block
// of 256 slots read a block ahead into registers), cuts tile t + 2 and
// finds its segments (a row's first live slot in the tile) and each
// edge's row's first entry, and adds tile t - 1's row sums.  A compute
// thread first starts its quarter of tile t + 1's gathers into the other
// stage by cp.async (a quarter of its entry's Q_s row, and of the P_r row
// at its row's first entry; a coordinate of x_s and x_r), then, as
// thread (e, k) -- edge e = tid / T, k = tid % T, T = FWD_TPE threads an
// edge -- forms edge e's pre1, SiLU and dot partials of the butterfly's
// lanes v = k + T i (columns v and v + 32) and adds them as the warp
// butterfly does (the levels xor 16 down to T in registers, the rest by
// shuffles); thread k = 0 stores the edge's five row-sum summands.  The
// scan warp's lane s adds segment s's summands in slot order (the row's
// first live edge from zero, or from the sums carried from the tile
// before) and finishes the row unless it is the tile's last.  (A warp
// that issued all of a tile's gathers beside the compute warps got too
// few issue slots to keep up: PERF.md section 6.)
constexpr int FWD_TPE = THREADS / TR;  // threads an edge: 4
constexpr int FWD_NV = 32 / FWD_TPE;    // butterfly lanes a thread
constexpr int FWD_THREADS = THREADS + 32;  // 8 compute warps + the scan
constexpr int FWD_CTAS_PER_SM = 2;  // (any count gives the same bits)
// the ring of entries: tiles t - 1 to t + 2 and the slots scanned ahead
// (fewer than 4 x 64 + 64 + 256) are never overwritten
constexpr int RING = 1024;
// a tile's record: ring start | size | segment-start ballots (entries
// 0-31, 32-63); four tiles (t - 1 to t + 2) at once
enum { TI_H = 0, TI_N, TI_M0, TI_M1, TI_W };
// an edge's row-sum summands: msg em | em | rel_used gate em (3)
enum { T_A = 0, T_DG, T_D0, T_N = T_D0 + 3 };
// a stage row's stride in floats: rows 4 banks apart, so that the 32
// threads of a warp (8 edges x 4 columns) read 32 banks; a multiple of 4
// (16-byte cp.async)
template <int W>
constexpr int FWD_LD = W + FWD_TPE;
template <int W>
constexpr int FWD_STAGE = 2 * TR * FWD_LD<W>;  // P rows | Q rows
// two stages and their coordinates ([x_r | x_s][64][3]), w1d | b1 | w2,
// two tiles' summands, the ring (row | sender | mask), four tiles' first
// entries and records, the segments, the carried row
template <int W>
constexpr int FWD_SMEM_FLOATS = 2 * FWD_STAGE<W> + 12 * TR + 3 * W +
                                2 * T_N * TR + 3 * RING + 4 * TR +
                                4 * TI_W + (TR + 1) + 8 + 1;

// the in-thread levels of warp_sum's butterfly: s[i] += s[i + O] for
// i < O, O = FWD_NV / 2, ..., 1 (s[0] then holds this thread's lane)
template <int O>
__device__ __forceinline__ void fold_lanes(float (&s)[FWD_NV]) {
  if constexpr (O > 0) {
#pragma unroll
    for (int i = 0; i < O; ++i) s[i] = s[i] + s[i + O];
    fold_lanes<O / 2>(s);
  }
}

// row r's outputs from its five sums
__device__ __forceinline__ void fwd_finish(float* __restrict__ mh,
                                           float* __restrict__ deg,
                                           float* __restrict__ dx, int r,
                                           const float (&v)[T_N]) {
  const float inv = 1.0f / fmaxf(v[T_DG], 1.0f);
  mh[r] = v[T_A] * inv;
  deg[r] = v[T_DG];
#pragma unroll
  for (int k = 0; k < 3; ++k) dx[3 * r + k] = v[T_D0 + k] * inv;
}

template <int W, bool BF>
__global__ void __launch_bounds__(FWD_THREADS, FWD_CTAS_PER_SM)
idn_fwd_tiles(const float* __restrict__ x, const int* __restrict__ snd,
              const float* __restrict__ em, const int* __restrict__ indptr,
              const int* __restrict__ rowof, const int* __restrict__ ctarow,
              const float* __restrict__ P, const float* __restrict__ Q,
              const float* __restrict__ w1d_g, const float* __restrict__ b1_g,
              const float* __restrict__ w2_g, const float* __restrict__ b2_g,
              float* __restrict__ dx, float* __restrict__ mh,
              float* __restrict__ deg, int h1, int rel_inv1p, float clamp) {
  constexpr int LD = FWD_LD<W>, NJ = W / 32, M = RING - 1;
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);  // [2][P | Q][64][LD]
  float* sx = stage + 2 * FWD_STAGE<W>;            // [2][x_r | x_s][64][3]
  float* sw1d = sx + 12 * TR;
  float* sb1 = sw1d + W;
  float* sw2 = sb1 + W;
  float* term = sw2 + W;  // [2][T_N][64]
  int* ring_row = reinterpret_cast<int*>(term + 2 * T_N * TR);
  int* ring_snd = ring_row + RING;
  float* ring_em = reinterpret_cast<float*>(ring_snd + RING);
  // pidx[t & 3][e]: the tile entry that holds edge e's P_r row and x_r
  // (its row's first in the tile); tinfo[t & 3]: tile t's record
  int* pidx = reinterpret_cast<int*>(ring_em + RING);
  int* tinfo = pidx + 4 * TR;
  int* seg = tinfo + 4 * TI_W;  // the segment starts, seg[ns] = size
  float* carry = reinterpret_cast<float*>(seg + TR + 1);  // mh | deg | dx
  int* crow = reinterpret_cast<int*>(carry + 8);  // the carried row (-1)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int c = tid; c < W; c += FWD_THREADS) {  // zeros past h1
    const bool in = c < h1;
    sw1d[c] = in ? rnd<BF>(w1d_g[c]) : 0.0f;
    sb1[c] = in ? rnd<BF>(b1_g[c]) : 0.0f;
    sw2[c] = in ? rnd<BF>(w2_g[c]) : 0.0f;
  }
  if (tid == 0) *crow = -1;
  const int row_lo = ctarow[blockIdx.x], row_hi = ctarow[blockIdx.x + 1];
  const int beg = indptr[row_lo], end = indptr[row_hi];

  // ---- the scan warp's state and steps
  int head = 0, tail = 0;  // ring positions: the next tile's, the next free
  int base = beg;          // the first slot not scanned
  float ae[8];             // the block of slots read ahead: mask, row,
  int ar[8], as[8];        // sender of slot base + 32 j + lane
  auto read_ahead = [&]() {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int slot = base + 32 * j + lane;
      ae[j] = 0.0f;
      if (slot < end) {
        ae[j] = em[slot];
        ar[j] = rowof[slot];
        as[j] = snd[slot];
      }
    }
  };
  // the live slots of the block read ahead join the ring in slot order;
  // the next block's reads start
  auto scan = [&]() {
    float e[8];
    int r[8], s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      e[j] = ae[j];
      r[j] = ar[j];
      s[j] = as[j];
    }
    base += THREADS;
    read_ahead();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool live = e[j] != 0.0f;
      const unsigned m = __ballot_sync(FULL, live);
      if (live) {
        const int p = (tail + __popc(m & ((1u << lane) - 1u))) & M;
        ring_row[p] = r[j];
        ring_snd[p] = s[j];
        ring_em[p] = e[j];
      }
      tail += __popc(m);
    }
  };
  // cut tile t (size 0 when the range is done): its record, and each
  // edge's row's first entry
  auto cut = [&](int t) {
    while (tail - head < TR && base < end) scan();
    const int h = head, n = min(tail - head, TR);
    head += n;
    const int r0 = ring_row[(h + lane) & M];
    const int r1 = ring_row[(h + lane + 32) & M];
    const int q0 = __shfl_up_sync(FULL, r0, 1);
    const int q1 = __shfl_up_sync(FULL, r1, 1);
    const int last0 = __shfl_sync(FULL, r0, 31);
    const unsigned m0 =
        __ballot_sync(FULL, lane < n && (lane == 0 || r0 != q0));
    const unsigned m1 =
        __ballot_sync(FULL, lane + 32 < n && r1 != (lane ? q1 : last0));
    const unsigned upto = (2u << lane) - 1u;  // bits <= lane
    int* pi = pidx + (t & 3) * TR;
    pi[lane] = 31 - __clz(m0 & upto);
    pi[lane + 32] = m1 & upto ? 63 - __clz(m1 & upto) : 31 - __clz(m0);
    if (lane == 0) {
      int* ti = tinfo + (t & 3) * TI_W;
      ti[TI_H] = h;
      ti[TI_N] = n;
      ti[TI_M0] = (int)m0;
      ti[TI_M1] = (int)m1;
    }
  };
  // tile t's row sums: lane k adds segment k's summands in slot order
  auto row_sums = [&](int t) {
    const int* ti = tinfo + (t & 3) * TI_W;
    const int h = ti[TI_H], n = ti[TI_N];
    const unsigned m0 = (unsigned)ti[TI_M0], m1 = (unsigned)ti[TI_M1];
    const float* tv = term + (t & 1) * T_N * TR;
    const int ns = __popc(m0) + __popc(m1);
    const unsigned below = (1u << lane) - 1u;
    if ((m0 >> lane) & 1u) seg[__popc(m0 & below)] = lane;
    if ((m1 >> lane) & 1u) seg[__popc(m0) + __popc(m1 & below)] = lane + 32;
    if (lane == 0) seg[ns] = n;
    const int cr = *crow;
    float cin[T_N];
#pragma unroll
    for (int c = 0; c < T_N; ++c) cin[c] = carry[c];
    __syncwarp();  // seg written; the carry read before it is replaced
    for (int k = lane; k < ns; k += 32) {
      const int e0 = seg[k], e1 = seg[k + 1];
      const int r = ring_row[(h + e0) & M];
      float v[T_N] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      // rows between the previous segment's and this one's: no live slot
      int gap = k > 0 ? ring_row[(h + seg[k - 1]) & M] + 1
                      : (cr >= 0 ? cr + 1 : row_lo);
      if (k == 0 && cr >= 0) {
        if (cr == r) {  // the carried row goes on
#pragma unroll
          for (int c = 0; c < T_N; ++c) v[c] = cin[c];
        } else {
          fwd_finish(mh, deg, dx, cr, cin);
        }
      }
      const float zero[T_N] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (; gap < r; ++gap) fwd_finish(mh, deg, dx, gap, zero);
#pragma unroll 4
      for (int e = e0; e < e1; ++e)  // (the loads of 4 edges in flight)
#pragma unroll
        for (int c = 0; c < T_N; ++c) v[c] += tv[c * TR + e];
      if (k + 1 < ns) {
        fwd_finish(mh, deg, dx, r, v);
      } else {  // the tile's last row may go on in the next tile
#pragma unroll
        for (int c = 0; c < T_N; ++c) carry[c] = v[c];
        *crow = r;
      }
    }
    __syncwarp();
  };

  // ---- the compute warps' steps
  // start this thread's quarter of tile t's gathers into stage t & 1 (one
  // cp.async group): entry i = tid / 4, part = tid % 4
  auto gather = [&](int t) {
    const int* ti = tinfo + (t & 3) * TI_W;
    const int i = tid >> 2, part = tid & 3;
    if (i < ti[TI_N]) {
      float* sp = stage + (t & 1) * FWD_STAGE<W>;
      float* xs = sx + (t & 1) * 6 * TR;
      const int e = (ti[TI_H] + i) & M;
      const int r = ring_row[e], s = ring_snd[e];
      const unsigned m = (unsigned)ti[i < 32 ? TI_M0 : TI_M1];
      const bool first = ((m >> (i & 31)) & 1u) != 0;
      constexpr int GQ = W / 16;  // 16-byte granules of a quarter row
#pragma unroll
      for (int g = 0; g < GQ; ++g) {
        const int q = 4 * (part * GQ + g);
        cp_async16(sp + (TR + i) * LD + q, Q + (size_t)s * W + q);
        if (first) cp_async16(sp + i * LD + q, P + (size_t)r * W + q);
      }
      if (part < 3) {
        cp_async4(xs + 3 * TR + 3 * i + part, x + 3 * s + part);
        if (first) cp_async4(xs + 3 * i + part, x + 3 * r + part);
      }
    }
    async_commit();
  };
  const float b2 = rnd<BF>(b2_g[0]);
  // tile t's edges
  auto compute = [&](int t, int n) {
    const int b = t & 1, h = tinfo[(t & 3) * TI_W + TI_H];
    const float* sp = stage + b * FWD_STAGE<W>;
    const float* xs = sx + b * 6 * TR;
    float* tv = term + b * T_N * TR;
    const int e = tid / FWD_TPE, k = tid % FWD_TPE;
    const bool live = e < n;
    const int pe = live ? pidx[(t & 3) * TR + e] : 0;
    const float* prow = sp + pe * LD;
    const float* qrow = sp + (TR + e) * LD;
    float rel[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rel[c] = live ? rnd<BF>(xs[3 * pe + c]) - rnd<BF>(xs[3 * TR + 3 * e + c])
                    : 0.0f;
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(rel[0], rel[0]),
                                         __fmul_rn(rel[1], rel[1])),
                               __fmul_rn(rel[2], rel[2]));
    const float d2r = rnd<BF>(d2);  // an operand of d2 . w1d
    float s[FWD_NV];
#pragma unroll
    for (int i = 0; i < FWD_NV; ++i) {
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = k + FWD_TPE * i + 32 * j;
        const float pv = live ? prow[c] : 0.0f;
        const float qv = live ? qrow[c] : 0.0f;
        const float u = ((pv + qv) + d2r * sw1d[c]) + sb1[c];
        // the fast sigmoid: the pass took 17.8 us on an H100 against 21.0
        // with sigm_ieee (PERF.md section 6)
        const float sg = sigm(u);
        const float tt = u * sg;
        part = fmaf(rnd<BF>(tt), sw2[c], part);
      }
      s[i] = part;
    }
    // the butterfly: lane v + lane v ^ o; o = 16 .. T here (s[i] and
    // s[i + o / T]), then T / 2 .. 1 by shuffles
    fold_lanes<FWD_NV / 2>(s);
#pragma unroll
    for (int o = FWD_TPE / 2; o > 0; o >>= 1)
      s[0] += __shfl_xor_sync(FULL, s[0], o);
    const float msg = s[0] + b2;
    if (live && k == 0) {
      const float m = ring_em[(h + e) & M];
      const float g = clip(msg, clamp);
      const float kd = rel_inv1p ? sqrtf(d2 + 1e-12f) + 1.0f : 1.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float q = rel_inv1p ? rel[c] / kd : rel[c];
        // bf16: a summand
        tv[(T_D0 + c) * TR + e] = rnd<BF>(__fmul_rn(__fmul_rn(q, g), m));
      }
      tv[T_A * TR + e] = rnd<BF>(__fmul_rn(msg, m));
      tv[T_DG * TR + e] = rnd<BF>(m);
    }
  };

  // ---- the pipeline: one barrier a tile
  if (warp == 8) {
    read_ahead();
    cut(0);
    cut(1);
  }
  __syncthreads();
  if (warp < 8) {
    gather(0);
    async_wait_all();
  }
  __syncthreads();
  for (int t = 0;; ++t) {
    const int n = tinfo[(t & 3) * TI_W + TI_N];  // 0: the range is done
    if (warp < 8) {
      if (n > 0) {
        gather(t + 1);  // (into the stage of tile t - 1)
        compute(t, n);
      }
      async_wait_all();
    } else {
      if (n > 0) cut(t + 2);
      if (t > 0) row_sums(t - 1);
    }
    __syncthreads();
    if (n == 0) break;
  }

  // the last row with live slots, then the rows after it: zeros
  const int cr = *crow;
  int tail_row = row_lo;
  if (cr >= 0) {
    if (tid == 0) {
      float v[T_N];
#pragma unroll
      for (int c = 0; c < T_N; ++c) v[c] = carry[c];
      fwd_finish(mh, deg, dx, cr, v);
    }
    tail_row = cr + 1;
  }
  for (int r = tail_row + tid; r < row_hi; r += FWD_THREADS) {
    mh[r] = 0.0f;
    deg[r] = 0.0f;
  }
  for (int f = 3 * tail_row + tid; f < 3 * row_hi; f += FWD_THREADS)
    dx[f] = 0.0f;
}

// Backward, per receiver row: each live edge's g_pre1 and g_rel into
// GPRE1 / GREL (slot-indexed), and the row's sums: G (h1), the receiver
// half of gx (3) and the partials W2 (h1) | w1d (h1) | b1 (h1) | b2 of RP.
// On the tile route (gw = its width W) GPRE1 holds rows of W, zeros past
// h1: f32 rows of g_pre1 for the node pass, or (BF) bf16 rows of
// bf16(g_pre1) for the dh pass.  BF above 64 (gw = 0):
// also the row's sum of the per-edge bf16(bf16(g_pre1) W1r^T) into GHR
// (dh) and each edge's bf16(bf16(g_pre1) W1s^T) into GS (slot-indexed):
// for each entry k a warp dot over the columns (the weights' rows read
// coalesced), lane k % 32 writing it.
template <int NJ, bool EXACT, bool BF>
__global__ void __launch_bounds__(THREADS)
idn_bwd_rows(const float* __restrict__ x, const int* __restrict__ snd,
             const float* __restrict__ em, const int* __restrict__ indptr,
             const float* __restrict__ P, const float* __restrict__ Q,
             const float* __restrict__ w1d_g, const float* __restrict__ b1_g,
             const float* __restrict__ w2_g, const float* __restrict__ b2_g,
             const float* __restrict__ deg, const float* __restrict__ gdx,
             const float* __restrict__ gmh, float* __restrict__ GPRE1,
             float* __restrict__ GREL, float* __restrict__ G,
             float* __restrict__ GXR, float* __restrict__ RP,
             const float* __restrict__ w1r, const float* __restrict__ w1s,
             float* __restrict__ GHR, float* __restrict__ GS, int n_nodes,
             int dh, int h1_, int rel_inv1p, float clamp, int gw_) {
  const int h1 = EXACT ? 32 * NJ : h1_;
  // the tile route takes H1 <= 64 (NJ <= 2): wider instances keep gw = 0
  // as a constant, and their code as it was
  const int gw = NJ <= 2 ? gw_ : 0;
  const int lane = threadIdx.x & 31;
  const int warp0 = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * WARPS;
  const int rpw = rp_width(h1, BF);
  Bf* gb = reinterpret_cast<Bf*>(GPRE1);  // the tile route's bf16 rows
  float w1d[NJ], b1[NJ], w2[NJ];
  load_cols<NJ, EXACT, BF>(w1d, w1d_g, lane, h1);
  load_cols<NJ, EXACT, BF>(b1, b1_g, lane, h1);
  load_cols<NJ, EXACT, BF>(w2, w2_g, lane, h1);
  const float b2 = rnd<BF>(b2_g[0]);
  for (int r = warp0; r < n_nodes; r += n_warps) {
    const float xr[3] = {rnd<BF>(x[3 * r]), rnd<BF>(x[3 * r + 1]),
                         rnd<BF>(x[3 * r + 2])};
    float p[NJ];
    load_cols<NJ, EXACT>(p, P + (size_t)r * h1, lane, h1);
    // BF: the gathered inv, g_mh and g_dx are rounded
    const float inv = rnd<BF>(1.0f / fmaxf(deg[r], 1.0f));
    const float gm = rnd<BF>(gmh[r]);
    const float gd[3] = {rnd<BF>(gdx[3 * r]), rnd<BF>(gdx[3 * r + 1]),
                         rnd<BF>(gdx[3 * r + 2])};
    float sG[NJ], sW2[NJ], sW1d[NJ], sB1[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) sG[j] = sW2[j] = sW1d[j] = sB1[j] = 0.0f;
    float sB2 = 0.0f, gxr = 0.0f;  // lane k < 3: component k
    if (BF && !gw)
      for (int k = lane; k < dh; k += 32) GHR[(size_t)r * dh + k] = 0.0f;
    for_live_slots(em, snd, indptr[r], indptr[r + 1], lane,
                   [&](int slot, float m, int s) {
      Edge e;
      float t[NJ], dt[NJ];
      edge_forward<NJ, EXACT, BF>(x, Q, s, xr, p, w1d, b1, w2, b2, lane, h1,
                                  e, t, dt, true);
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
      float gp[NJ], gwd = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        gp[j] = __fmul_rn(rnd<BF>(g_msg) * w2[j], dt[j]);
        gwd = fmaf(rnd<BF>(gp[j]), w1d[j], gwd);
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
      for (int k = 0; k < 3; ++k)  // bf16: the node pass's summand, rounded
        gr[k] = rnd<BF>(gr[k] + 2.0f * e.rel[k] * g_d2);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float gq = rnd<BF>(gp[j]);
        const int c = lane + 32 * j;
        if (gw) {
          const float v = EXACT || c < h1 ? gq : 0.0f;
          if (BF && c < gw)
            gb[(size_t)slot * gw + c] = __float2bfloat16_rn(v);
          else if (c < gw)
            GPRE1[(size_t)slot * gw + c] = v;
        } else if (EXACT || c < h1) {
          GPRE1[(size_t)slot * h1 + c] = gq;
        }
        sG[j] += gq;
        if (BF) sB1[j] += gp[j];
        sW2[j] += __fmul_rn(rnd<BF>(t[j]), rnd<BF>(g_msg));
        sW1d[j] += __fmul_rn(rnd<BF>(e.d2), gq);
      }
      sB2 += g_msg;
      for (int c = 32 * NJ + lane; c < gw; c += 32) {  // the tile route's
        if (BF)                                        // pad columns past
          gb[(size_t)slot * gw + c] = __float2bfloat16_rn(0.0f);  // 32 NJ
        else
          GPRE1[(size_t)slot * gw + c] = 0.0f;
      }
      if (BF && !gw) {  // the per-edge dh terms, above width 64
        for (int k = 0; k < dh; ++k) {
          const float* wr = w1r + (size_t)k * h1;
          const float* ws = w1s + (size_t)k * h1;
          float ar = 0.0f, as = 0.0f;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int c = lane + 32 * j;
            if (EXACT || c < h1) {
              const float gq = bf16_round(gp[j]);
              ar = fmaf(gq, bf16_round(wr[c]), ar);
              as = fmaf(gq, bf16_round(ws[c]), as);
            }
          }
          ar = warp_sum(ar);
          as = warp_sum(as);
          if (lane == (k & 31)) {
            GHR[(size_t)r * dh + k] += bf16_round(ar);
            GS[(size_t)slot * dh + k] = bf16_round(as);
          }
        }
      }
      const float mine = lane == 0 ? gr[0] : (lane == 1 ? gr[1] : gr[2]);
      if (lane < 3) {
        GREL[(size_t)slot * 4 + lane] = mine;
        gxr += mine;
      }
    });
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      if (EXACT || c < h1) {
        G[(size_t)r * h1 + c] = sG[j];
        RP[(size_t)r * rpw + c] = sW2[j];
        RP[(size_t)r * rpw + h1 + c] = sW1d[j];
        if (BF) RP[(size_t)r * rpw + 2 * h1 + c] = sB1[j];
      }
    }
    if (lane == 0) RP[(size_t)r * rpw + (BF ? 3 : 2) * h1] = sB2;
    if (lane < 3) GXR[(size_t)r * 4 + lane] = gxr;
  }
}

// the tile's partials: W1r (dh x h1) | W1s (dh x h1) | b1 | W2 | w1d | b2
__host__ __device__ inline long long pn_width(int dh, int h1) {
  return 2LL * dh * h1 + 3LL * h1 + 1;
}

// The node pass's layout: weights in shared memory when they fit beside
// 64-node tiles (else read from device memory), and the node tile as large
// as shared memory admits, at most 64 nodes.
struct NodePlan {
  int tn;      // nodes a tile
  bool wsm;    // W1r / W1s in shared memory
  size_t smem; // bytes
};

NodePlan node_plan(int dh, int h1) {
  const size_t pad = (size_t)h1 + 1;
  auto bytes = [&](int tn, bool wsm) {
    return ((wsm ? 2 * (size_t)dh * pad : 0) + 2 * (size_t)tn * pad +
            (size_t)tn * dh) * sizeof(float);
  };
  if (bytes(TILE_N, true) <= SMEM_MAX) return {TILE_N, true, bytes(TILE_N, true)};
  int tn = TILE_N;
  while (tn > 1 && bytes(tn, false) > SMEM_MAX) tn /= 2;
  return {tn, false, bytes(tn, false)};
}

// CTA per tile of tn nodes: each node's sender segment S (and the sender
// half of gx), gh = G.W1r^T + S.W1s^T (BF: GHR plus the sender segment's
// sum of GS), then the tile's partials in node order (BF: h rounded).
template <int NJ, bool EXACT, bool BF>
__global__ void __launch_bounds__(THREADS)
idn_bwd_nodes(const float* __restrict__ h, const float* __restrict__ em,
              const int* __restrict__ sperm, const int* __restrict__ sptr,
              const float* __restrict__ w1r, const float* __restrict__ w1s,
              const float* __restrict__ GPRE1, const float* __restrict__ GREL,
              const float* __restrict__ G, const float* __restrict__ GXR,
              const float* __restrict__ RP, const float* __restrict__ GHR,
              const float* __restrict__ GS, float* __restrict__ gx,
              float* __restrict__ gh, float* __restrict__ PN, int n_nodes,
              int dh, int h1_, int tn, int wsm) {
  const int h1 = EXACT ? 32 * NJ : h1_;
  extern __shared__ float smem[];
  const int pad = h1 + 1, rpw = rp_width(h1, BF);
  // [dh][pad] each when wsm, else read in place with row stride h1
  float* sWr = smem;
  float* sWs = sWr + (wsm ? dh * pad : 0);
  float* sG = sWs + (wsm ? dh * pad : 0);  // [tn][pad]
  float* sS = sG + tn * pad;               // [tn][pad]
  float* sH = sS + tn * pad;               // [tn][dh]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int node0 = blockIdx.x * tn;
  if (wsm && !BF) {
    for (int f = tid; f < dh * h1; f += THREADS) {
      sWr[(f / h1) * pad + f % h1] = w1r[f];
      sWs[(f / h1) * pad + f % h1] = w1s[f];
    }
  }
  for (int f = tid; f < tn * dh; f += THREADS) {
    const int i = node0 + f / dh;
    sH[f] = i < n_nodes ? rnd<BF>(h[(size_t)i * dh + f % dh]) : 0.0f;
  }
  __syncthreads();
  for (int li = warp; li < tn; li += WARPS) {
    const int i = node0 + li;
    float S[NJ], Gv[NJ], gxs = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) S[j] = Gv[j] = 0.0f;
    if (i < n_nodes) {
      load_cols<NJ, EXACT>(Gv, G + (size_t)i * h1, lane, h1);
      const int p1 = sptr[i + 1];
      for (int b = sptr[i]; b < p1; b += 32) {
        const int p = b + lane;
        const int slot = p < p1 ? sperm[p] : 0;
        unsigned live = __ballot_sync(FULL, p < p1 && em[slot] != 0.0f);
        while (live) {
          const int k = __ffs(live) - 1;
          live &= live - 1;
          const int sl = __shfl_sync(FULL, slot, k);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            if (EXACT || lane + 32 * j < h1)
              S[j] += GPRE1[(size_t)sl * h1 + lane + 32 * j];
          if (lane < 3) gxs -= GREL[(size_t)sl * 4 + lane];
        }
      }
      if (lane < 3) gx[3 * i + lane] = GXR[(size_t)i * 4 + lane] + gxs;
      if constexpr (BF) {  // gh = the receiver rows' sum + the senders'
        for (int k = lane; k < dh; k += 32) {
          float a = 0.0f;
          for (int p = sptr[i]; p < p1; ++p) {
            const int sl = sperm[p];
            if (em[sl] != 0.0f) a += GS[(size_t)sl * dh + k];
          }
          gh[(size_t)i * dh + k] = GHR[(size_t)i * dh + k] + a;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      if (EXACT || c < h1) {
        sG[li * pad + c] = Gv[j];
        sS[li * pad + c] = S[j];
      }
    }
    __syncwarp();
    // gh = G.W1r^T + S.W1s^T, the weights read where they are (one copy
    // of the loop each, so that the shared one stays a shared access)
    auto gh_row = [&](const float* Wr, const float* Ws, int wstride) {
      for (int k = lane; k < dh; k += 32) {
        float a = 0.0f;
        for (int c = 0; c < h1; ++c)
          a = fmaf(sG[li * pad + c], Wr[(size_t)k * wstride + c], a);
        for (int c = 0; c < h1; ++c)
          a = fmaf(sS[li * pad + c], Ws[(size_t)k * wstride + c], a);
        gh[(size_t)i * dh + k] = a;
      }
    };
    if (i < n_nodes && !BF) {
      if (wsm) gh_row(sWr, sWs, pad);
      else gh_row(w1r, w1s, h1);
    }
  }
  __syncthreads();
  // (fewer than 2^31 entries: the widths are capped at 32 MAX_NJ)
  const int pw = (int)pn_width(dh, h1);
  float* out = PN + (size_t)blockIdx.x * pw;
  const int nn = min(tn, n_nodes - node0);
  const int dw = dh * h1;
  for (int f = tid; f < pw; f += THREADS) {
    float a = 0.0f;
    if (f < 2 * dw) {
      const float* T = f < dw ? sG : sS;
      const int q = f < dw ? f : f - dw;
      const int k = q / h1, c = q % h1;
      for (int li = 0; li < nn; ++li)
        a = fmaf(sH[li * dh + k], T[li * pad + c], a);
    } else if (f < 2 * dw + h1) {  // b1: sum of G (bf16: of its column)
      const int c = f - 2 * dw;
      for (int li = 0; li < nn; ++li)
        a += BF ? RP[(size_t)(node0 + li) * rpw + 2 * h1 + c]
                : sG[li * pad + c];
    } else {  // W2 | w1d | b2: the rows' partials
      int q = f - 2 * dw - h1;
      if (BF && q >= 2 * h1) q += h1;  // b2 sits after the rows' b1
      for (int li = 0; li < nn; ++li)
        a += RP[(size_t)(node0 + li) * rpw + q];
    }
    out[f] = a;
  }
}

// ------------------------------------------------- bf16 tile route (<= 64)
// The per-edge dh terms of the bf16 backward, bf16(bf16(g_pre1) W1r^T) and
// bf16(bf16(g_pre1) W1s^T), of every live slot into GR / GS (bf16 rows of
// W).  The slot range [0, indptr[N]) is cut into 64-slot tiles, CTA b
// taking tiles b, b + gridDim.x, ...  By cp.async, a tile's masks arrive
// one tile ahead of its g_pre1 rows (bf16 rows of W from idn_bwd_rows),
// so that only the live slots' rows are fetched, and both arrive while
// the tile before runs (two row stages, three mask stages).  Both
// products run on the tensor cores (`tile_mma_bf`, m16n8k16) against W1r
// and W1s, resident as bf16 tiles (dh x h1 zero-padded to W x W, rounded
// once as they are stored); the results go through a bf16 stage in shared
// memory, so that the live slots' rows leave as whole 16-byte granules.
// A masked slot's row (stale in the stage) gives a product row that is
// never stored: a row of a product depends on its own row of A alone, so
// the live slots' terms do not depend on the tiling, the CTA count or the
// masked slots.  (Packing the live slots into tiles first, as
// edge_message_bwd.cu's edge pass does for its longer per-tile chain,
// cost a block-wide scan and three dependent round trips to device memory
// a tile here: 34 us of device time at the serve shape on an H100,
// PERF.md.)
template <int W>
constexpr int DH_SMEM_FLOATS = (2 * WT<W> + 4 * RT<W>) / 2 + 3 * TR;

template <int W>
__global__ void __launch_bounds__(THREADS, DH_CTAS_PER_SM)
idn_bwd_dh(const float* __restrict__ em, const int* __restrict__ indptr,
           const float* __restrict__ w1r, const float* __restrict__ w1s,
           const Bf* __restrict__ GPRE1, Bf* __restrict__ GR,
           Bf* __restrict__ GS, int n_nodes, int dh, int h1) {
  extern __shared__ float4 smem4[];
  Bf* bWr = reinterpret_cast<Bf*>(smem4);
  Bf* bWs = bWr + WT<W>;
  Bf* bG = bWs + WT<W>;     // [2 stages][RT]: g_pre1 rows
  Bf* bO = bG + 2 * RT<W>;  // [2][RT]: the two products, rounded
  float* sEm = reinterpret_cast<float*>(bO + 2 * RT<W>);  // [3][64] masks
  const int tid = threadIdx.x;
  const Lane L = lane_of();
  auto wrow = [&](int i) { return i < dh ? i : -1; };
  tile_gather_padded<W, true>(bWr, w1r, W, h1, h1, wrow);
  tile_gather_padded<W, true>(bWs, w1s, W, h1, h1, wrow);
  const int live_end = indptr[n_nodes];
  const int n_t = (live_end + TR - 1) / TR, step = gridDim.x;
  auto fetch_masks = [&](int t, int ms) {  // masks past live_end: 0
    if (t < n_t && tid < TR) {
      const int sl = t * TR + tid;
      if (sl < live_end)
        cp_async4(sEm + ms * TR + tid, em + sl);
      else
        sEm[ms * TR + tid] = 0.0f;
    }
  };
  auto fetch_rows = [&](int t, int stage, int ms) {  // the live slots'
    if (t >= n_t) return;
    Bf* dst = bG + stage * RT<W>;
    for (int f = tid; f < TR * W / 8; f += THREADS) {
      const int i = f / (W / 8), q = (f % (W / 8)) * 8;
      if (sEm[ms * TR + i] != 0.0f)
        cp_async16(dst + swz16<W>(i, q),
                   GPRE1 + (size_t)(t * TR + i) * W + q);
    }
  };
  // tile t (the k-th of this CTA): rows in stage k & 1, masks in k % 3
  const int t0 = blockIdx.x;
  fetch_masks(t0, 0);
  async_commit();
  async_wait_all();
  __syncthreads();
  fetch_rows(t0, 0, 0);
  fetch_masks(t0 + step, 1);
  async_commit();
  int k = 0;
  for (int t = t0; t < n_t; t += step, ++k) {
    const int stage = k & 1, ms = k % 3;
    async_wait_all();
    __syncthreads();  // tile t's rows and the next tile's masks are in
    fetch_rows(t + step, stage ^ 1, (k + 1) % 3);
    fetch_masks(t + 2 * step, (k + 2) % 3);
    async_commit();
    const Bf* Wk[2] = {bWr, bWs};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      Frag<W> a;
      frag_zero<W>(a);
      tile_mma_bf<W, false, true>(a, bG + stage * RT<W>, Wk[j], L);
      frag_store_bf<W>(bO + j * RT<W>, a, L);
    }
    __syncthreads();  // the products are staged
    const float* m = sEm + ms * TR;
    Bf* dst[2] = {GR, GS};
    for (int f = tid; f < 2 * TR * W / 8; f += THREADS) {
      const int j = f / (TR * W / 8), g = f % (TR * W / 8);
      const int i = g / (W / 8), q = (g % (W / 8)) * 8;
      if (m[i] != 0.0f)
        *reinterpret_cast<uint4*>(dst[j] + (size_t)(t * TR + i) * W + q) =
            *reinterpret_cast<const uint4*>(bO + j * RT<W> + swz16<W>(i, q));
    }
  }
}

// The tile route's node pass, a CTA of NODE_THREADS per 64 nodes, a group
// of 8 lanes a node (the 64 nodes' segment walks all in flight): each
// node's sender segment S (g_pre1 rows in `csr_sender_perm` order: f32
// rows, or BF bf16 rows widened) and the sender half of gx, in the
// FP32-unit route's order.  Then
// * f32: G, S and h staged as f32 tiles beside W1r and W1s (dh x h1
//   zero-padded to W x W); warps 0-7 form gh = G.W1r^T + S.W1s^T, warps
//   8-15 the tile's W1r / W1s partials h^T G, h^T S (3xTF32 tile products);
// * BF: gh = the receiver segment's sum of GR (slot order) + the sender
//   segment's sum of GS, each from zero (the FP32-unit route's order);
//   warps 8-15 form the partials h^T G, h^T S (3xTF32, h rounded).
// The b1, W2, w1d and b2 partials (warps 0-7, after gh in f32) are the
// rows' sums in node order: b1 of G's columns (BF: of the rows' unrounded
// b1 partials), the rest of RP's.  dh and h1 are zero-padded to W.
constexpr int NODE_THREADS = 2 * THREADS;

template <int W, bool BF>
constexpr int NODE_SMEM_FLOATS = 3 * RT<W> + (BF ? 0 : 2 * WT<W>);

template <int W, bool BF>
__global__ void __launch_bounds__(NODE_THREADS)
idn_bwd_nodes_tile(const float* __restrict__ h, const float* __restrict__ em,
                   const int* __restrict__ indptr,
                   const int* __restrict__ sperm, const int* __restrict__ sptr,
                   const float* __restrict__ GPRE1,
                   const float* __restrict__ GREL,
                   const float* __restrict__ G, const float* __restrict__ GXR,
                   const float* __restrict__ RP, const Bf* __restrict__ GR,
                   const Bf* __restrict__ GS, const float* __restrict__ w1r,
                   const float* __restrict__ w1s, float* __restrict__ gx,
                   float* __restrict__ gh, float* __restrict__ PN,
                   int n_nodes, int dh, int h1) {
  extern __shared__ float4 smem4[];
  float* tH = reinterpret_cast<float*>(smem4);
  float* tG = tH + RT<W>;
  float* tS = tG + RT<W>;
  float* sWr = tS + RT<W>;  // f32 only
  float* sWs = sWr + WT<W>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int node0 = blockIdx.x * TR;
#pragma unroll 4
  for (int f = tid; f < RT<W>; f += NODE_THREADS) {
    const int i = f / W, c = f % W, n = node0 + i;
    const bool ok = n < n_nodes;
    tH[swz<W>(i, c)] = ok && c < dh ? rnd<BF>(h[(size_t)n * dh + c]) : 0.0f;
    tG[swz<W>(i, c)] = ok && c < h1 ? G[(size_t)n * h1 + c] : 0.0f;
  }
  if constexpr (!BF) {
    auto wrow = [&](int i) { return i < dh ? i : -1; };
    tile_gather_padded<W, false>(sWr, w1r, W, h1, h1, wrow);
    tile_gather_padded<W, false>(sWs, w1s, W, h1, h1, wrow);
  }
  constexpr int CPL = W / 8;  // columns a lane
  const int grp = lane >> 3, gl = lane & 7;
  const int r = 4 * warp + grp, i = node0 + r;
  float S[CPL], Hr[CPL], Hs[CPL], unused[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) S[c] = Hr[c] = Hs[c] = 0.0f;
  float dr = 0.0f, ds = 0.0f;  // lanes gl < 3: component gl
  if (i < n_nodes) {
    if constexpr (BF) {
      const Bf* g1 = reinterpret_cast<const Bf*>(GPRE1);
      segment_sum<W, false, false>(nullptr, em, GR, GREL, GR, indptr[i],
                                   indptr[i + 1], gl, grp, 1.0f, Hr, unused,
                                   dr);
      segment_sum<W, true, true>(sperm, em, g1, GREL, GS, sptr[i],
                                 sptr[i + 1], gl, grp, -1.0f, S, Hs, ds);
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (CPL * gl + c < dh)
          gh[(size_t)i * dh + CPL * gl + c] = Hr[c] + Hs[c];
    } else {
      segment_sum<W, true, false>(sperm, em, GPRE1, GREL, GPRE1, sptr[i],
                                  sptr[i + 1], gl, grp, -1.0f, S, unused,
                                  ds);
    }
    if (gl < 3) gx[3 * i + gl] = GXR[(size_t)i * 4 + gl] + ds;
  }
#pragma unroll
  for (int h2 = 0; h2 < CPL / 4; ++h2)
    *reinterpret_cast<float4*>(tS + swz<W>(r, CPL * gl + 4 * h2)) =
        make_float4(S[4 * h2], S[4 * h2 + 1], S[4 * h2 + 2], S[4 * h2 + 3]);
  __syncthreads();
  const int pw = (int)pn_width(dh, h1), dw = dh * h1;
  float* out = PN + (size_t)blockIdx.x * pw;
  // this thread's place in the tile products of its half of the CTA
  const int hw = warp & 7;
  const Lane L{hw & 3, hw >> 2, lane >> 2, lane & 3};
  if (warp >= THREADS / 32) {  // h^T G, h^T S
#pragma unroll 1
    for (int m = 0; m < 2; ++m) {
      Frag<W> a;
      frag_zero<W>(a);
      tile_mma<W, true, false>(a, tH, m ? tS : tG, L);
      if (16 * L.rb < W)
#pragma unroll
        for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = L.row(e), c = L.col<W>(jn, e);
            if (k < dh && c < h1) out[m * dw + k * h1 + c] = a[jn][e];
          }
    }
    return;
  }
  if constexpr (!BF) {  // gh = G.W1r^T + S.W1s^T
    Frag<W> a;
    frag_zero<W>(a);
    tile_mma<W, false, true>(a, tG, sWr, L);
    tile_mma<W, false, true>(a, tS, sWs, L);
#pragma unroll
    for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = node0 + L.row(e), k = L.col<W>(jn, e);
        if (n < n_nodes && k < dh) gh[(size_t)n * dh + k] = a[jn][e];
      }
  }
  // b1 | W2 | w1d | b2 in node order: b1 from G (BF: RP's b1), the rest
  // from RP (W2 | w1d | b2; BF: W2 | w1d | b1 | b2)
  const int nn = min(TR, n_nodes - node0), rpw = rp_width(h1, BF);
  for (int f = 2 * dw + tid; f < pw; f += THREADS) {
    const int q = f - 2 * dw;
    const int col = q >= h1 ? (q < 3 * h1 ? q - h1 : (BF ? 3 : 2) * h1)
                            : 2 * h1 + q;  // BF: b1
    out[f] = BF || q >= h1
                 ? sum_strided(RP + (size_t)node0 * rpw + col, rpw, nn)
                 : sum_strided(G + (size_t)node0 * h1 + q, h1, nn);
  }
}

struct Outs {
  float *gw1r, *gw1s, *gw1d, *gb1, *gw2, *gb2;
};

// every weight gradient: the tiles' partials added in tile order
__global__ void idn_bwd_reduce(const float* __restrict__ PN, Outs o,
                               int n_tiles, int dh, int h1) {
  const long long pw = pn_width(dh, h1);
  const long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= pw) return;
  float a = 0.0f;
  for (int t = 0; t < n_tiles; ++t) a += PN[(size_t)t * pw + f];
  const long long dw = (long long)dh * h1;
  if (f < dw) o.gw1r[f] = a;
  else if (f < 2 * dw) o.gw1s[f - dw] = a;
  else if (f < 2 * dw + h1) o.gb1[f - 2 * dw] = a;
  else if (f < 2 * dw + 2 * h1) o.gw2[f - 2 * dw - h1] = a;
  else if (f < 2 * dw + 3 * h1) o.gw1d[f - 2 * dw - 2 * h1] = a;
  else o.gb2[0] = a;
}

int row_blocks(int n, int n_ctas) {
  return n_ctas > 0 ? n_ctas : (n + WARPS - 1) / WARPS;
}

// the instantiation for h1: the fewest columns a lane that hold it
int lane_cols(int h1) {
  for (int nj : {1, 2, 4, 8, 16, MAX_NJ})
    if (h1 <= 32 * nj) return nj;
  return 0;
}

// fn(NJ, EXACT, BF) for h1: EXACT when h1 = 32 NJ, its width then a
// constant; BF the bf16 mode (bf16 != 0)
template <typename Fn>
int with_cols(int h1, int bf16, Fn&& fn) {
  using std::integral_constant;
  const bool exact = h1 == 32 * lane_cols(h1);
  auto go = [&](auto nj) {
    auto at = [&](auto bf) {
      return exact ? fn(nj, std::true_type(), bf)
                   : fn(nj, std::false_type(), bf);
    };
    return bf16 ? at(std::true_type()) : at(std::false_type());
  };
  switch (lane_cols(h1)) {
    case 1: return go(integral_constant<int, 1>());
    case 2: return go(integral_constant<int, 2>());
    case 4: return go(integral_constant<int, 4>());
    case 8: return go(integral_constant<int, 8>());
    case 16: return go(integral_constant<int, 16>());
    case MAX_NJ: return go(integral_constant<int, MAX_NJ>());
  }
  return (int)cudaErrorInvalidValue;
}

struct Scratch {
  float *P, *Q, *G, *GXR, *RP, *GPRE1, *GREL, *PN, *GHR, *GR, *GS;
  int *rowof, *ctarow;  // the forward's tile route
  size_t total;
};

// n_ctas: the forward tile route's CTAs (its ctarow)
Scratch carve(float* base, int n, int e, int dh, int h1, bool backward,
              bool bf16, int n_ctas) {
  Scratch s{};
  size_t off = 0;
  auto take = [&](size_t count) {
    float* p = base == nullptr ? nullptr : base + off;
    off += round4(count);
    return p;
  };
  // the forward's tile route: P and Q as rows of its width W
  const int fw = backward ? 0 : tile_width(dh, h1);
  s.P = take((size_t)n * (fw ? fw : h1));
  s.Q = take((size_t)n * (fw ? fw : h1));
  if (fw) {
    s.rowof = reinterpret_cast<int*>(take((size_t)e));
    s.ctarow = reinterpret_cast<int*>(take((size_t)n_ctas + 1));
  }
  if (backward) {
    const int tw = tile_width(dh, h1);
    const int tn = tw ? TR : node_plan(dh, h1).tn;
    s.G = take((size_t)n * h1);
    s.GXR = take((size_t)n * 4);
    s.RP = take((size_t)n * rp_width(h1, bf16));
    // the tile route: g_pre1 as rows of its width, f32 or (bf16) half a
    // float an element, as are the two dh terms
    s.GPRE1 = take(!tw ? (size_t)e * h1 : bf16 ? (size_t)e * tw / 2
                                               : (size_t)e * tw);
    s.GREL = take((size_t)e * 4);
    s.PN = take((size_t)((n + tn - 1) / tn) * pn_width(dh, h1));
    if (tw) {
      s.GR = take((size_t)e * tw / 2);
      s.GS = take((size_t)e * tw / 2);
    } else if (bf16) {
      s.GHR = take((size_t)n * dh);
      s.GS = take((size_t)e * dh);
    }
  }
  s.total = off;
  return s;
}

int check_shape(int dh, int h1, int n_ctas) {
  if (dh < 1 || lane_cols(h1) == 0 || n_ctas < 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The projection P = h.W1r, Q = h.W1s: on the tile route `padded_proj`
// (64-node tiles of tensor-core products), else idn_proj, which also
// takes RF's Dh = 1: its rank-1 product h_n W1r[0, c] elementwise ran in
// 2.9 us at the serve shape against 9.1 for the tile products of a
// zero-padded h (PERF.md section 6).  fwd: the forward's tile route, rows
// of its width W and the CSR by-products for n_ctas edge CTAs (RF's
// Dh = 1: idn_proj_rows, the same products); else rows of h1.
template <int NJ, bool EX, bool BF>
int launch_proj(const float* h, const float* w1r, const float* w1s,
                const int* indptr, const Scratch& s, int n_nodes, int dh,
                int h1, bool fwd, int n_ctas, cudaStream_t stream) {
  const int tw = tile_width(dh, h1);
  const int ld = fwd ? tw : h1;
  int* rowof = fwd ? s.rowof : nullptr;
  int* ctarow = fwd ? s.ctarow : nullptr;
  if (!fwd && (tw == 0 || dh == 1)) {
    const long long nf = (long long)n_nodes * h1;
    idn_proj<NJ, EX, BF><<<(unsigned)((nf + THREADS - 1) / THREADS), THREADS,
                           0, stream>>>(h, w1r, w1s, s.P, s.Q, n_nodes, dh,
                                        h1);
    return (int)cudaGetLastError();
  }
  return with_width(tw, BF, [&](auto w, auto) {
    constexpr int W = decltype(w)::value;
    if (dh == 1) {  // the forward's tile route at RF's Dh = 1
      idn_proj_rows<W, BF><<<max(n_tiles(n_nodes), (n_nodes * W + THREADS - 1) /
                                                       THREADS),
                             THREADS, 0, stream>>>(h, w1r, w1s, s.P, s.Q,
                                                   n_nodes, h1, indptr, rowof,
                                                   ctarow, n_ctas);
      return (int)cudaGetLastError();
    }
    const size_t smem = PAD_PROJ_SMEM_FLOATS<W, BF> * sizeof(float);
    const cudaError_t e = cudaFuncSetAttribute(
        padded_proj<W, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int vec = aligned16(h) && aligned16(w1r) && aligned16(w1s);
    padded_proj<W, BF><<<n_tiles(n_nodes), THREADS, smem, stream>>>(
        h, w1r, w1s, s.P, s.Q, n_nodes, dh, h1, ld, vec, indptr, rowof,
        ctarow, n_ctas);
    return (int)cudaGetLastError();
  });
}

// The forward's edge pass on the tile route, n_ctas CTAs
template <int W, bool BF>
int launch_fwd_tiles(const float* x, const int* snd, const float* em,
                     const int* indptr, const float* w1d, const float* b1,
                     const float* w2, const float* b2, float* dx, float* mh,
                     float* deg, const Scratch& s, int h1, int rel_inv1p,
                     float clamp, int n_ctas, cudaStream_t stream) {
  const size_t smem = FWD_SMEM_FLOATS<W> * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      idn_fwd_tiles<W, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  idn_fwd_tiles<W, BF><<<n_ctas, FWD_THREADS, smem, stream>>>(
      x, snd, em, indptr, s.rowof, s.ctarow, s.P, s.Q, w1d, b1, w2, b2, dx,
      mh, deg, h1, rel_inv1p, clamp);
  return (int)cudaGetLastError();
}

// The tile route's passes after idn_bwd_rows: (bf16) the dh pass on n_ctas
// CTAs, else DH_CTAS_PER_SM an SM; the node pass
template <int W, bool BF>
int launch_tile_passes(const float* h, const float* em,
                       const int* indptr, const int* sperm, const int* sptr,
                       const float* w1r, const float* w1s, const Scratch& s,
                       float* gx, float* gh, int n_nodes, int dh, int h1,
                       int n_ctas, cudaStream_t stream) {
  const size_t n_smem = NODE_SMEM_FLOATS<W, BF> * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      idn_bwd_nodes_tile<W, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)n_smem);
  if (e != cudaSuccess) return (int)e;
  Bf* gr = reinterpret_cast<Bf*>(s.GR);
  Bf* gs = reinterpret_cast<Bf*>(s.GS);
  if constexpr (BF) {
    const size_t d_smem = DH_SMEM_FLOATS<W> * sizeof(float);
    e = cudaFuncSetAttribute(idn_bwd_dh<W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)d_smem);
    int dev = 0, sms = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    idn_bwd_dh<W><<<n_ctas > 0 ? n_ctas : DH_CTAS_PER_SM * sms, THREADS,
                    d_smem, stream>>>(em, indptr, w1r, w1s,
                                      reinterpret_cast<const Bf*>(s.GPRE1),
                                      gr, gs, n_nodes, dh, h1);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  idn_bwd_nodes_tile<W, BF><<<n_tiles(n_nodes), NODE_THREADS, n_smem,
                              stream>>>(
      h, em, indptr, sperm, sptr, s.GPRE1, s.GREL, s.G, s.GXR, s.RP, gr, gs,
      w1r, w1s, gx, gh, s.PN, n_nodes, dh, h1);
  return (int)cudaGetLastError();
}

}  // namespace

// n_ctas: the CTAs the forward is given (its tile route's ctarow)
extern "C" long long idn_scratch_floats(int n_nodes, int n_slots, int dh,
                                        int h1, int backward, int bf16,
                                        int n_ctas) {
  return (long long)carve(nullptr, n_nodes, n_slots, dh, h1, backward != 0,
                          bf16 != 0, n_ctas)
      .total;
}

// the widest phi1 hidden width the kernels take
extern "C" int idn_max_width() { return 32 * MAX_NJ; }

// the CTAs an SM the forward's tile route is built for at (dh, h1), 0 off
// it (the wrapper launches that many an SM)
extern "C" int idn_fwd_blocks_per_sm(int dh, int h1) {
  return tile_width(dh, h1) ? FWD_CTAS_PER_SM : 0;
}

// the CTAs of the forward's tile pass an SM holds at once, as the card
// reports it for its registers and shared memory (-1 on an error)
extern "C" int idn_fwd_occupancy(int width, int bf16) {
  return with_width(width, bf16, [](auto w, auto bf) {
    constexpr int W = decltype(w)::value;
    constexpr bool B = decltype(bf)::value;
    const int bytes = FWD_SMEM_FLOATS<W> * sizeof(float);
    int n = -1;
    if (cudaFuncSetAttribute(idn_fwd_tiles<W, B>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, idn_fwd_tiles<W, B>, FWD_THREADS, bytes) != cudaSuccess)
      return -1;
    return n;
  });
}

// n_ctas: CTAs of the forward's tile pass (Dh and H1 up to 64: at least
// 1, each owning whole receiver rows), else of the row passes and the
// bf16 dh pass (0: one warp a row, DH_CTAS_PER_SM dh CTAs an SM); any
// count gives the same bits.  bf16 != 0: the bf16 mode
extern "C" int edge_identity_forward(
    const float* x, const float* h, const int* snd, const float* em,
    const int* indptr, const float* w1r, const float* w1s, const float* w1d,
    const float* b1, const float* w2, const float* b2, float* dx, float* mh,
    float* deg, float* scratch, int n_nodes, int n_slots, int dh, int h1,
    int rel_inv1p, float clamp, int n_ctas, int bf16, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (int err = check_shape(dh, h1, n_ctas)) return err;
  const int tw = tile_width(dh, h1);
  if (tw && n_ctas == 0) return (int)cudaErrorInvalidValue;
  if (n_nodes <= 0) return (int)cudaGetLastError();
  Scratch s =
      carve(scratch, n_nodes, n_slots, dh, h1, false, bf16 != 0, n_ctas);
  return with_cols(h1, bf16, [&](auto nj, auto exact, auto bf) {
    constexpr int NJ = decltype(nj)::value;
    constexpr bool EX = decltype(exact)::value;
    constexpr bool BF = decltype(bf)::value;
    if (int e = launch_proj<NJ, EX, BF>(h, w1r, w1s, indptr, s, n_nodes, dh,
                                        h1, tw != 0, n_ctas, stream))
      return e;
    if (tw)
      return with_width(tw, BF, [&](auto w, auto) {
        return launch_fwd_tiles<decltype(w)::value, BF>(
            x, snd, em, indptr, w1d, b1, w2, b2, dx, mh, deg, s, h1,
            rel_inv1p, clamp, n_ctas, stream);
      });
    idn_fwd_rows<NJ, EX, BF><<<row_blocks(n_nodes, n_ctas), THREADS, 0,
                               stream>>>(x, snd, em, indptr, s.P, s.Q, w1d,
                                         b1, w2, b2, dx, mh, deg, n_nodes, h1,
                                         rel_inv1p, clamp);
    return (int)cudaGetLastError();
  });
}

extern "C" int edge_identity_backward(
    const float* x, const float* h, const int* snd, const float* em,
    const int* indptr, const int* sperm, const int* sptr, const float* w1r,
    const float* w1s, const float* w1d, const float* b1, const float* w2,
    const float* b2, const float* deg, const float* gdx, const float* gmh,
    float* gx, float* gh, float* gw1r, float* gw1s, float* gw1d, float* gb1,
    float* gw2, float* gb2, float* scratch, int n_nodes, int n_slots, int dh,
    int h1, int rel_inv1p, float clamp, int n_ctas, int bf16,
    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (int err = check_shape(dh, h1, n_ctas)) return err;
  const NodePlan plan = node_plan(dh, h1);
  if (n_nodes <= 0) return (int)cudaGetLastError();
  Scratch s = carve(scratch, n_nodes, n_slots, dh, h1, true, bf16 != 0, 0);
  const int tw = tile_width(dh, h1);  // the tile route, <= 64
  const int nt = tw ? n_tiles(n_nodes) : (n_nodes + plan.tn - 1) / plan.tn;
  int rc = with_cols(h1, bf16, [&](auto nj, auto exact, auto bf) {
    constexpr int NJ = decltype(nj)::value;
    constexpr bool EX = decltype(exact)::value;
    constexpr bool BF = decltype(bf)::value;
    cudaError_t e = cudaFuncSetAttribute(
        idn_bwd_nodes<NJ, EX, BF>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (e != cudaSuccess) return (int)e;
    if (int err = launch_proj<NJ, EX, BF>(h, w1r, w1s, indptr, s, n_nodes,
                                          dh, h1, false, 0, stream))
      return err;
    idn_bwd_rows<NJ, EX, BF><<<row_blocks(n_nodes, n_ctas), THREADS, 0,
                               stream>>>(
        x, snd, em, indptr, s.P, s.Q, w1d, b1, w2, b2, deg, gdx, gmh, s.GPRE1,
        s.GREL, s.G, s.GXR, s.RP, w1r, w1s, s.GHR, s.GS, n_nodes, dh, h1,
        rel_inv1p, clamp, tw);
    e = cudaGetLastError();
    if (e != cudaSuccess || tw) return (int)e;
    idn_bwd_nodes<NJ, EX, BF><<<nt, THREADS, plan.smem, stream>>>(
        h, em, sperm, sptr, w1r, w1s, s.GPRE1, s.GREL, s.G, s.GXR, s.RP,
        s.GHR, s.GS, gx, gh, s.PN, n_nodes, dh, h1, plan.tn, (int)plan.wsm);
    return (int)cudaGetLastError();
  });
  if (rc == 0 && tw)
    rc = with_width(tw, bf16, [&](auto w, auto bf) {
      return launch_tile_passes<decltype(w)::value, decltype(bf)::value>(
          h, em, indptr, sperm, sptr, w1r, w1s, s, gx, gh, n_nodes, dh,
          h1, n_ctas, stream);
    });
  if (rc != 0) return rc;
  Outs o{gw1r, gw1s, gw1d, gb1, gw2, gb2};
  const long long pw = pn_width(dh, h1);
  idn_bwd_reduce<<<(unsigned)((pw + 255) / 256), 256, 0, stream>>>(
      s.PN, o, nt, dh, h1);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
