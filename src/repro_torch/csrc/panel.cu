// The panel path of the FastEGNN edge and virtual pathways (forward and
// backward) for widths above 64, for Hopper (sm_90a), f32 and bf16 modes.
//
// Replaces, for those widths, the same Pallas TPU kernels as
// edge_message.cu / edge_message_bwd.cu (`edge_pathway_fused`,
// `edge_pathway_bwd_fused`) and virtual_message.cu / virtual_message_bwd.cu
// (`virtual_pathway_fused`, `virtual_pathway_bwd_fused`) of the JAX
// package's kernels/.  Their tile kernels keep every weight resident in
// shared memory, which holds widths up to 64 only; here every feature
// width is a multiple of 64 (the caller zero-pads Dh, H1, M and hid up to
// one: exact, as in the tile kernels) and each layer is a sequence of
// launches over device-memory intermediates:
//   * `gemm`: C = op(A) . op(B) (+ C) (+ bias), 64 x 64 output blocks, one
//     CTA each, the K dimension streamed through shared memory as 64 x 64
//     panels of A and B; the products are common.cuh's 3xTF32 tensor-core
//     tile products (`tile_mma<64, ...>`), k-steps in order over the
//     panels in order, so a sum over K runs in one fixed order.  Weight
//     gradients are products over the live edges or nodes (TA), K up to
//     the live edge count: they sum each k-step on its own (STEP_SUM), as
//     the forwards do, since the tensor core's round-toward-zero of ~10^4
//     accumulations in a row would bias them past the gradient tolerance.
//   * elementwise and row kernels (one warp a row, columns a lane apart,
//     each row's sum in column order then a fixed butterfly) for the SiLU
//     chains, the gates and the cotangents;
//   * ordered sums: each receiver row of the edge pathway is summed by one
//     warp over its live slots in slot order, each node's sender segment
//     in the `csr_sender_perm` order; column sums over edges or nodes run
//     in 64 fixed chunks, added in chunk order.
// The edge pathway works on the live slots only, compacted in slot order
// (`compact_live`), so masked slots never enter a product and no output
// depends on how many masked slots the layout holds; nothing depends on a
// CTA count.  No float atomics; repeated runs are bitwise equal.
// The bf16 mode (`bf`, the Pallas kernels' `precision='bf16'`): the gemms
// run common.cuh's bf16 tile products (operands rounded to bf16, one TF32
// MMA a k-step; a bias rounded too), and the elementwise kernels round
// where the tile kernels do (edge_message.cu, edge_message_bwd.cu,
// virtual_message.cu, virtual_message_bwd.cu).  The edge backward's gh is
// then the reference's sum of per-edge rounded products: two more gemms
// over the live edges, bf16(bf16(g_pre1) W1r^T) and ... W1s^T (outputs
// rounded), summed per receiver row and per sender; W1r = h^T G and W1s =
// h^T S take h rounded (a copy) and G, S in f32.  A simple
// path: the intermediates make several round trips through device memory
// and every panel is loaded synchronously.
#include "common.cuh"

namespace {

constexpr int P64 = 64;            // panel width
constexpr int CHUNKS = 64;         // row chunks of a column sum
constexpr int SPLIT = 32;          // K chunks of a weight-gradient product
constexpr int SCAN_BLOCK = 1024;   // slots a compaction block

// ------------------------------------------------------------------- gemm
// A 64 x 64 block of a row-major matrix (leading dimension ld) at (r0, c0)
// into a swizzled tile; rows at or past n_rows read as zeros.
__device__ __forceinline__ void panel_load(float* tile, const float* src,
                                           int ld, int r0, int c0,
                                           int n_rows) {
  for (int f = threadIdx.x; f < P64 * 16; f += blockDim.x) {
    const int i = f >> 4, q = (f & 15) * 4;
    const int r = r0 + i;
    const float4 v = r < n_rows ? *reinterpret_cast<const float4*>(
                                      src + (size_t)r * ld + c0 + q)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(tile + swz<64>(i, q)) = v;
  }
}

struct Gemm {
  const float* A;
  const float* B;
  float* C;
  const float* bias;  // per output column, or nullptr
  int lda, ldb, ldc;
  int M, N, K;        // op(A) is M x K, op(B) K x N; N a multiple of 64
  const int* dynM;    // if set: M = *dynM (the live count)
  const int* dynK;    // if set: K = *dynK
  int acc;            // C += op(A) op(B) (else C =)
  float* part;        // if set: SPLIT partials over K chunks, M x N each
  int rnd_out = 0;    // bf16 mode: outputs rounded to bf16 (no `part`)
};

// One CTA a 64 x 64 block of C.  op(A)[m][k] = TA ? A[k][m] : A[m][k],
// op(B)[k][n] = TB ? B[n][k] : B[k][n]; rows of A, B or C past M or K read
// as zeros and are not written.  With `part`, CTA z of the grid's third
// dimension takes K chunk z of SPLIT (64-row aligned) into partial z.
template <bool TA, bool TB, bool STEP_SUM, bool BF>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(Gemm g) {
  __shared__ __align__(16) float sA[64 * 64];
  __shared__ __align__(16) float sB[64 * 64];
  const int M = g.dynM ? *g.dynM : g.M;
  const int Kall = g.dynK ? *g.dynK : g.K;
  const int m0 = blockIdx.x * P64, n0 = blockIdx.y * P64;
  if (m0 >= M) return;
  int kb = 0, K = Kall;
  float* C = g.C;
  if (g.part != nullptr) {  // this CTA's K chunk and partial
    const int len = ((Kall + SPLIT - 1) / SPLIT + P64 - 1) / P64 * P64;
    kb = min((int)blockIdx.z * len, Kall);
    K = min(kb + len, Kall);
    C = g.part + (size_t)blockIdx.z * M * g.ldc;
  }
  const Lane L = lane_of();
  Frag<64> acc;
  if (g.acc) {
#pragma unroll
    for (int jn = 0; jn < JN<64>; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + L.row(e);
        acc[jn][e] = r < M ? C[(size_t)r * g.ldc + n0 + L.col<64>(jn, e)]
                           : 0.0f;
      }
  } else {
    frag_zero<64>(acc);
  }
  for (int k0 = kb; k0 < K; k0 += P64) {
    // TA: A is K x M, the block rows k; else M x K, rows m
    if (TA) panel_load(sA, g.A, g.lda, k0, m0, K);
    else panel_load(sA, g.A, g.lda, m0, k0, M);
    // TB: B is N x K, the block rows n; else K x N, rows k
    if (TB) panel_load(sB, g.B, g.ldb, n0, k0, g.N);
    else panel_load(sB, g.B, g.ldb, k0, n0, K);
    __syncthreads();
    tile_mma<64, TA, TB, STEP_SUM, BF>(acc, sA, sB, L);
    __syncthreads();
  }
#pragma unroll
  for (int jn = 0; jn < JN<64>; ++jn)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + L.row(2 * h);
      const int c = n0 + L.col<64>(jn, 0);
      if (r < M) {
        float2 v = make_float2(acc[jn][2 * h], acc[jn][2 * h + 1]);
        if (g.bias) {
          v.x += rnd<BF>(g.bias[c]);
          v.y += rnd<BF>(g.bias[c + 1]);
        }
        if (BF && g.rnd_out) v = make_float2(bf16_round(v.x), bf16_round(v.y));
        *reinterpret_cast<float2*>(C + (size_t)r * g.ldc + c) = v;
      }
    }
}

// C = the SPLIT partials added in chunk order
__global__ void split_sum(const float* __restrict__ part,
                          float* __restrict__ C, long long size) {
  const long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= size) return;
  float s = 0.0f;
  for (int z = 0; z < SPLIT; ++z) s += part[z * size + f];
  C[f] = s;
}

// bf: the bf16 mode
template <bool TA, bool TB, bool STEP_SUM = false>
cudaError_t gemm(const Gemm& g, int max_m, cudaStream_t stream, int bf) {
  const dim3 grid((max_m + P64 - 1) / P64, g.N / P64,
                  g.part != nullptr ? SPLIT : 1);
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;
  if (bf) gemm_kernel<TA, TB, STEP_SUM, true><<<grid, THREADS, 0, stream>>>(g);
  else gemm_kernel<TA, TB, STEP_SUM, false><<<grid, THREADS, 0, stream>>>(g);
  if (g.part == nullptr) return cudaGetLastError();
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long size = (long long)g.M * g.ldc;
  split_sum<<<(unsigned)((size + 255) / 256), 256, 0, stream>>>(g.part, g.C,
                                                                size);
  return cudaGetLastError();
}

// A weight gradient W (M x N) = A^T B over K rows (K chunks in SPLIT
// partials, `part` of SPLIT M N floats, added in chunk order; each k-step
// summed on its own)
cudaError_t weight_grad(const float* A, int lda, const float* B, int ldb,
                        float* W, int M, int N, int K, const int* dynK,
                        float* part, cudaStream_t stream, int bf) {
  Gemm g{A, B, W, nullptr, lda, ldb, N, M, N, K, nullptr, dynK, 0, part};
  return gemm<true, false, true>(g, M, stream, bf);
}

// C (M x N) = op(A) op(B) [+ bias] [+ C]
Gemm mm(const float* A, int lda, const float* B, int ldb, float* C, int ldc,
        int M, int N, int K, const float* bias = nullptr, int acc = 0,
        const int* dynM = nullptr, const int* dynK = nullptr) {
  return Gemm{A, B, C, bias, lda, ldb, ldc, M, N, K, dynM, dynK, acc,
              nullptr};
}

// -------------------------------------------------------------- col sums
// part[chunk][c] = sum over the rows of the chunk, in row order, of
// X[r][c] (times scale[r] if given); rows [0, M) cut into CHUNKS equal
// ranges.  Then out[c] = the chunks' partials in chunk order.
__global__ void colsum_chunks(const float* __restrict__ X, int ld, int ncol,
                              const float* __restrict__ scale, int sstride,
                              int M_static, const int* __restrict__ dynM,
                              float* __restrict__ part, int rnd_terms) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int chunk = blockIdx.y;
  if (c >= ncol) return;
  const int M = dynM ? *dynM : M_static;
  const int len = (M + CHUNKS - 1) / CHUNKS;
  const int r0 = min(chunk * len, M), r1 = min(r0 + len, M);
  float s = 0.0f;
  for (int r = r0; r < r1; ++r) {
    float v = X[(size_t)r * ld + c];
    float w = scale ? scale[(size_t)r * sstride] : 1.0f;
    if (rnd_terms) {  // bf16: a product of rounded operands
      v = bf16_round(v);
      w = bf16_round(w);
    }
    s += scale ? w * v : v;
  }
  part[(size_t)chunk * ncol + c] = s;
}

__global__ void colsum_finish(const float* __restrict__ part, int ncol,
                              float* __restrict__ out, float sign) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncol) return;
  float s = 0.0f;
  for (int k = 0; k < CHUNKS; ++k) s += part[(size_t)k * ncol + c];
  out[c] = sign * s;
}

// out[c] = sign * sum over rows of X[r][c] (x scale[r]) in the fixed chunk
// order; part holds CHUNKS x ncol floats
// (rnd_terms: X and scale rounded to bf16 first)
cudaError_t colsum(const float* X, int ld, int ncol, const float* scale,
                   int sstride, int M, const int* dynM, float* part,
                   float* out, cudaStream_t stream, float sign = 1.0f,
                   int rnd_terms = 0) {
  const dim3 grid((ncol + 127) / 128, CHUNKS);
  colsum_chunks<<<grid, 128, 0, stream>>>(X, ld, ncol, scale, sstride, M,
                                          dynM, part, rnd_terms);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colsum_finish<<<(ncol + 127) / 128, 128, 0, stream>>>(part, ncol, out,
                                                        sign);
  return cudaGetLastError();
}

// ------------------------------------------------------------- compaction
// The live slots (em != 0) of [0, indptr[N]) in slot order: live[i] = the
// i-th, lidx[slot] = its index (or -1), *n_live = their count; and
// rowof[slot] = the slot's receiver row.
__global__ void count_live(const float* __restrict__ em,
                           const int* __restrict__ indptr, int n_nodes,
                           int* __restrict__ counts) {
  __shared__ int wc[THREADS / 32];
  const int end = indptr[n_nodes];
  int c = 0;
  for (int k = threadIdx.x; k < SCAN_BLOCK; k += THREADS) {
    const int s = blockIdx.x * SCAN_BLOCK + k;
    c += s < end && em[s] != 0.0f;
  }
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(FULL, c, o);
  if ((threadIdx.x & 31) == 0) wc[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < THREADS / 32; ++w) t += wc[w];
    counts[blockIdx.x] = t;
  }
}

// exclusive scan of the block counts (one CTA, in order) and the total
__global__ void scan_counts(int* __restrict__ counts, int n_blocks,
                            int* __restrict__ n_live) {
  if (threadIdx.x != 0) return;
  int t = 0;
  for (int b = 0; b < n_blocks; ++b) {
    const int c = counts[b];
    counts[b] = t;
    t += c;
  }
  *n_live = t;
}

__global__ void write_live(const float* __restrict__ em,
                           const int* __restrict__ indptr, int n_nodes,
                           int n_slots, const int* __restrict__ offsets,
                           int* __restrict__ live, int* __restrict__ lidx) {
  __shared__ int wc[THREADS / 32];
  const int end = indptr[n_nodes];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = offsets[blockIdx.x];
  for (int k0 = 0; k0 < SCAN_BLOCK; k0 += THREADS) {
    const int s = blockIdx.x * SCAN_BLOCK + k0 + threadIdx.x;
    const bool ok = s < end && em[s] != 0.0f;
    const unsigned m = __ballot_sync(FULL, ok);
    if (lane == 0) wc[warp] = __popc(m);
    __syncthreads();
    int off = base, total = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      off += w < warp ? wc[w] : 0;
      total += wc[w];
    }
    if (s < n_slots) {
      const int i = off + __popc(m & ((1u << lane) - 1u));
      if (ok) live[i] = s;
      lidx[s] = ok ? i : -1;
    }
    base += total;
    __syncthreads();
  }
}

__global__ void row_of_slots(const int* __restrict__ indptr, int n_nodes,
                             int* __restrict__ rowof) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_nodes) return;
  for (int s = indptr[r]; s < indptr[r + 1]; ++s) rowof[s] = r;
}

struct Live {
  int *live, *lidx, *rowof, *counts, *n_live;
};

cudaError_t compact_live(const float* em, const int* indptr, int n_nodes,
                         int n_slots, const Live& L, cudaStream_t stream) {
  const int nb = (n_slots + SCAN_BLOCK - 1) / SCAN_BLOCK;
  if (nb > 0) {
    count_live<<<nb, THREADS, 0, stream>>>(em, indptr, n_nodes, L.counts);
  }
  scan_counts<<<1, 32, 0, stream>>>(L.counts, nb, L.n_live);
  if (nb > 0) {
    write_live<<<nb, THREADS, 0, stream>>>(em, indptr, n_nodes, n_slots,
                                           L.counts, L.live, L.lidx);
  }
  row_of_slots<<<(n_nodes + 255) / 256, 256, 0, stream>>>(indptr, n_nodes,
                                                         L.rowof);
  return cudaGetLastError();
}

// ------------------------------------------------------------ edge pieces
// per live edge i: E4[i] = (rel, d2) and, if T1 / SG are given, t1 =
// silu(pre1), silu'(pre1) with pre1 = ((P_r + Q_s) + d2 w1d) + b1
__global__ void edge_pre(const float* __restrict__ x,
                         const int* __restrict__ snd,
                         const int* __restrict__ live,
                         const int* __restrict__ rowof,
                         const int* __restrict__ n_live,
                         const float* __restrict__ P,
                         const float* __restrict__ Q,
                         const float* __restrict__ w1d,
                         const float* __restrict__ b1, int H,
                         float* __restrict__ E4, float* __restrict__ T1,
                         float* __restrict__ SG, int bf) {
  const long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int i = (int)(f / H), c = (int)(f % H);
  if (i >= *n_live) return;
  const int slot = live[i], r = rowof[slot], s = snd[slot];
  auto X = [&](int k) { return bf ? bf16_round(x[k]) : x[k]; };
  const float rel0 = X(3 * r) - X(3 * s), rel1 = X(3 * r + 1) - X(3 * s + 1),
              rel2 = X(3 * r + 2) - X(3 * s + 2);
  const float d2 = rel0 * rel0 + rel1 * rel1 + rel2 * rel2;
  if (c == 0)
    *reinterpret_cast<float4*>(E4 + 4 * (size_t)i) =
        make_float4(rel0, rel1, rel2, d2);
  const float u =
      ((P[(size_t)r * H + c] + Q[(size_t)s * H + c]) +
       (bf ? bf16_round(d2) * bf16_round(w1d[c]) : d2 * w1d[c])) +
      (bf ? bf16_round(b1[c]) : b1[c]);
  float t, dt;
  silu_both(u, t, dt);
  T1[(size_t)i * H + c] = t;
  if (SG) SG[(size_t)i * H + c] = dt;
}

// The gate modes: 'none', 'mlp', 'identity' (the width-1 message is the
// gate: column 0 of the M-padded message)
enum { GATE_NONE = 0, GATE_MLP = 1, GATE_IDENTITY = 2 };

// Forward gate, a warp a live edge: g = clip(sum_c silu(GP + bg1) wg2), or
// clip(msg) for the identity gate; the edge's dx term (rel or rel / (|rel|
// + 1)) g em into TERM
__global__ void edge_gate_fwd(const float* __restrict__ GP,
                              const float* __restrict__ bg1,
                              const float* __restrict__ wg2, int H,
                              const float* __restrict__ MSG, int M, int gate,
                              const float* __restrict__ E4,
                              const float* __restrict__ em,
                              const int* __restrict__ live,
                              const int* __restrict__ n_live, int rel_inv1p,
                              float clamp, float* __restrict__ TERM, int bf) {
  const int i = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= *n_live) return;
  auto rb = [&](float v) { return bf ? bf16_round(v) : v; };
  float s = 0.0f;
  if (gate == GATE_IDENTITY) {
    s = MSG[(size_t)i * M];
  } else {
    for (int c = lane; c < H; c += 32) {
      const float u = GP[(size_t)i * H + c] + rb(bg1[c]);
      s += __fmul_rn(rb(u * sigm(u)), rb(wg2[c]));
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  }
  if (lane < 3) {
    const float g = s < -clamp ? -clamp : (s > clamp ? clamp : s);
    const float4 e4 = *reinterpret_cast<const float4*>(E4 + 4 * (size_t)i);
    const float rl = lane == 0 ? e4.x : (lane == 1 ? e4.y : e4.z);
    const float kd = rel_inv1p ? sqrtf(e4.w + 1e-12f) + 1.0f : 1.0f;
    const float q = rel_inv1p ? rl / kd : rl;
    TERM[4 * (size_t)i + lane] = rb((q * g) * em[live[i]]);
  }
}

// Forward row sums, a warp a receiver row: its live slots in slot order,
// mh = sum msg em, deg = sum em, dx = sum TERM, over max(deg, 1)
__global__ void edge_rows_fwd(const float* __restrict__ MSG, int M,
                              const float* __restrict__ TERM,
                              const float* __restrict__ em,
                              const int* __restrict__ indptr,
                              const int* __restrict__ lidx, int n_nodes,
                              int gate, float* __restrict__ dx,
                              float* __restrict__ mh,
                              float* __restrict__ deg, int bf) {
  const int r = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= n_nodes) return;
  auto rb = [&](float v) { return bf ? bf16_round(v) : v; };
  const int e0 = indptr[r], e1 = indptr[r + 1];
  float dg = 0.0f, d = 0.0f;
  for (int s = e0; s < e1; ++s) {
    const int i = lidx[s];
    if (i < 0) continue;
    dg += rb(em[s]);
    if (gate && lane < 3) d += TERM[4 * (size_t)i + lane];
  }
  const float inv = 1.0f / fmaxf(dg, 1.0f);
  for (int c0 = 0; c0 < M; c0 += 32) {
    float a = 0.0f;
    for (int s = e0; s < e1; ++s) {
      const int i = lidx[s];
      if (i >= 0) a += rb(MSG[(size_t)i * M + c0 + lane] * em[s]);
    }
    mh[(size_t)r * M + c0 + lane] = a * inv;
  }
  if (lane < 3) dx[3 * r + lane] = gate ? d * inv : 0.0f;
  if (lane == 0) deg[r] = dg;
}

// Backward gate and upstream, a warp a live edge.  U4[i] = (u = g_dx[r]
// inv em, inv); with a gate GR4[i] = (the gate's g_rel, g_d2 part), and
// for 'mlp' GP becomes g_gp1 = (g_gate wg2) silu'(gp) and SV = silu(gp)
// g_gate, for 'identity' GGATE[i] = g_gate (g_msg's gate term)
__global__ void edge_gate_bwd(float* __restrict__ GP,
                              float* __restrict__ SV,
                              const float* __restrict__ bg1,
                              const float* __restrict__ wg2, int H,
                              const float* __restrict__ MSG, int M,
                              float* __restrict__ GGATE,
                              const float* __restrict__ E4,
                              const float* __restrict__ em,
                              const int* __restrict__ live,
                              const int* __restrict__ rowof,
                              const int* __restrict__ n_live,
                              const float* __restrict__ deg,
                              const float* __restrict__ gdx, int gate,
                              int rel_inv1p, float clamp,
                              float* __restrict__ U4,
                              float* __restrict__ GR4, int bf) {
  const int i = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= *n_live) return;
  auto rb = [&](float v) { return bf ? bf16_round(v) : v; };
  const int slot = live[i], r = rowof[slot];
  const float e = em[slot];
  // bf16: the gathered inv and g_dx are rounded, u = g_dx (inv em)
  const float inv = rb(1.0f / fmaxf(deg[r], 1.0f));
  float u0, u1, u2;
  if (bf) {
    u0 = rb(gdx[3 * r]) * (inv * e);
    u1 = rb(gdx[3 * r + 1]) * (inv * e);
    u2 = rb(gdx[3 * r + 2]) * (inv * e);
  } else {
    u0 = (gdx[3 * r] * inv) * e;
    u1 = (gdx[3 * r + 1] * inv) * e;
    u2 = (gdx[3 * r + 2] * inv) * e;
  }
  if (lane == 0)
    *reinterpret_cast<float4*>(U4 + 4 * (size_t)i) =
        make_float4(u0, u1, u2, inv);
  if (gate == GATE_NONE) {
    if (lane == 0)
      *reinterpret_cast<float4*>(GR4 + 4 * (size_t)i) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  float s = 0.0f;
  if (gate == GATE_IDENTITY) {
    s = MSG[(size_t)i * M];
  } else {
    for (int c = lane; c < H; c += 32) {
      const float gp = GP[(size_t)i * H + c] + rb(bg1[c]);
      s += rb(gp * sigm(gp)) * rb(wg2[c]);
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  }
  const float gate_v = fminf(fmaxf(s, -clamp), clamp);
  const float4 e4 = *reinterpret_cast<const float4*>(E4 + 4 * (size_t)i);
  float kf = 1.0f, sd = 0.0f;
  if (rel_inv1p) {
    sd = sqrtf(e4.w + 1e-12f);
    kf = 1.0f / (sd + 1.0f);
  }
  float g_gate = u0 * (e4.x * kf) + u1 * (e4.y * kf) + u2 * (e4.z * kf);
  if (!(s >= -clamp && s <= clamp)) g_gate = 0.0f;
  if (gate == GATE_IDENTITY && lane == 0) GGATE[i] = g_gate;
  for (int c = lane; gate == GATE_MLP && c < H; c += 32) {
    const float gp = GP[(size_t)i * H + c] + rb(bg1[c]);
    float sgp, dsgp;
    silu_both(gp, sgp, dsgp);
    SV[(size_t)i * H + c] = rb(sgp) * rb(g_gate);
    GP[(size_t)i * H + c] = (rb(g_gate) * rb(wg2[c])) * dsgp;
  }
  if (lane == 0) {
    const float gu0 = u0 * gate_v, gu1 = u1 * gate_v, gu2 = u2 * gate_v;
    float4 g;
    if (rel_inv1p) {
      g = make_float4(gu0 * kf, gu1 * kf, gu2 * kf,
                      (gu0 * e4.x + gu1 * e4.y + gu2 * e4.z) *
                          (-(kf * kf) / (2.0f * sd)));
    } else {
      g = make_float4(gu0, gu1, gu2, 0.0f);
    }
    *reinterpret_cast<float4*>(GR4 + 4 * (size_t)i) = g;
  }
}

// g_msg += g_mh[r] inv em (GM holds g_gp1.Wg1^T, or zeros without the
// mlp gate), then + g_gate in column 0 for the identity gate
__global__ void edge_gmsg(float* __restrict__ GM, int M,
                          const float* __restrict__ gmh,
                          const float* __restrict__ U4,
                          const float* __restrict__ em,
                          const int* __restrict__ live,
                          const int* __restrict__ rowof,
                          const int* __restrict__ n_live, int zero_first,
                          const float* __restrict__ GGATE, int bf) {
  const long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int i = (int)(f / M), c = (int)(f % M);
  if (i >= *n_live) return;
  const int slot = live[i], r = rowof[slot];
  const float g = gmh[(size_t)r * M + c], inv = U4[4 * (size_t)i + 3];
  // bf16: bf16(g_mh[r]) (bf16(inv) em)
  const float add = bf ? bf16_round(g) * (inv * em[slot]) : (g * inv) *
                                                                em[slot];
  const size_t k = (size_t)i * M + c;
  const float v = (zero_first ? 0.0f : GM[k]) + add;
  GM[k] = GGATE != nullptr && c == 0 ? v + GGATE[i] : v;
}

// g_pre1 = GPRE (= g_msg.W2^T) * silu'(pre1), in place; then, a warp a
// live edge, g_d2 = sum g_pre1 w1d and GREL[slot] = g_rel = gr + 2 rel g_d2
__global__ void edge_gpre(float* __restrict__ GPRE,
                          const float* __restrict__ SG, int H,
                          const float* __restrict__ w1d,
                          const float* __restrict__ E4,
                          const float* __restrict__ GR4,
                          const int* __restrict__ live,
                          const int* __restrict__ n_live,
                          float* __restrict__ GREL, int bf) {
  const int i = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= *n_live) return;
  auto rb = [&](float v) { return bf ? bf16_round(v) : v; };
  float s = 0.0f;
  for (int c = lane; c < H; c += 32) {
    const size_t k = (size_t)i * H + c;
    const float gp = GPRE[k] * SG[k];
    GPRE[k] = gp;
    s += rb(gp) * rb(w1d[c]);
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if (lane < 3) {
    const float4 e4 = *reinterpret_cast<const float4*>(E4 + 4 * (size_t)i);
    const float4 gr = *reinterpret_cast<const float4*>(GR4 + 4 * (size_t)i);
    const float g_d2 = gr.w + s;
    const float rl = lane == 0 ? e4.x : (lane == 1 ? e4.y : e4.z);
    const float g = lane == 0 ? gr.x : (lane == 1 ? gr.y : gr.z);
    GREL[4 * (size_t)live[i] + lane] = rb(g + 2.0f * rl * g_d2);
  }
}

// Per node, a warp: G = its receiver segment's g_pre1 (slot order), S =
// its sender segment's (sender-permutation order), gx = the receiver
// g_rel sum minus the sender one
__global__ void edge_nodes_bwd(const float* __restrict__ GPRE, int H,
                               const float* __restrict__ GREL,
                               const int* __restrict__ lidx,
                               const int* __restrict__ indptr,
                               const int* __restrict__ sperm,
                               const int* __restrict__ sptr, int n_nodes,
                               float* __restrict__ G, float* __restrict__ S,
                               float* __restrict__ gx) {
  const int r = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= n_nodes) return;
  const int e0 = indptr[r], e1 = indptr[r + 1];
  const int p0 = sptr[r], p1 = sptr[r + 1];
  float dr = 0.0f, ds = 0.0f;
  for (int c0 = 0; c0 < H; c0 += 32) {
    float a = 0.0f, b = 0.0f;
    for (int s = e0; s < e1; ++s) {
      const int i = lidx[s];
      if (i < 0) continue;
      a += GPRE[(size_t)i * H + c0 + lane];
      if (c0 == 0 && lane < 3) dr += GREL[4 * (size_t)s + lane];
    }
    for (int p = p0; p < p1; ++p) {
      const int s = sperm[p];
      const int i = lidx[s];
      if (i < 0) continue;
      b += GPRE[(size_t)i * H + c0 + lane];
      if (c0 == 0 && lane < 3) ds -= GREL[4 * (size_t)s + lane];
    }
    G[(size_t)r * H + c0 + lane] = a;
    S[(size_t)r * H + c0 + lane] = b;
  }
  if (lane < 3) gx[3 * r + lane] = dr + ds;
}

// bf16: per node, a warp: gh = its receiver segment's GHR rows (slot
// order) + its sender segment's GHS rows (sender-permutation order), the
// rows D wide, indexed by live index
__global__ void edge_nodes_gh(const float* __restrict__ GHR,
                              const float* __restrict__ GHS, int D,
                              const int* __restrict__ lidx,
                              const int* __restrict__ indptr,
                              const int* __restrict__ sperm,
                              const int* __restrict__ sptr, int n_nodes,
                              float* __restrict__ gh) {
  const int r = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= n_nodes) return;
  for (int c0 = 0; c0 < D; c0 += 32) {
    float a = 0.0f, b = 0.0f;
    for (int s = indptr[r]; s < indptr[r + 1]; ++s) {
      const int i = lidx[s];
      if (i >= 0) a += GHR[(size_t)i * D + c0 + lane];
    }
    for (int p = sptr[r]; p < sptr[r + 1]; ++p) {
      const int i = lidx[sperm[p]];
      if (i >= 0) b += GHS[(size_t)i * D + c0 + lane];
    }
    gh[(size_t)r * D + c0 + lane] = a + b;
  }
}

// X[f] = bf16(X[f]) (or of src into X), f < n
__global__ void round_bf16(float* __restrict__ X,
                           const float* __restrict__ src, long long n) {
  const long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (f < n) X[f] = bf16_round(src ? src[f] : X[f]);
}

// --------------------------------------------------------- virtual pieces
// rl4[i] = (x_i - z_c, d2); T1 = silu(PRE + d2 w1d + c1) and, if SP is
// given, SP = silu'(.)
__global__ void virt_pre(const float* __restrict__ x,
                         const float* __restrict__ z, int c, int n,
                         float* __restrict__ PRE, int H,
                         const float* __restrict__ w1d,
                         const float* __restrict__ c1,
                         float* __restrict__ T1, float* __restrict__ SP,
                         float* __restrict__ RL4, int bf) {
  const long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int i = (int)(f / H), j = (int)(f % H);
  if (i >= n) return;
  float r0, r1, r2, d2, u;
  const size_t k = (size_t)i * H + j;
  if (bf) {  // bfloat16 arithmetic: each op rounded
    r0 = bf16_round(bf16_round(x[3 * i]) - bf16_round(z[3 * c]));
    r1 = bf16_round(bf16_round(x[3 * i + 1]) - bf16_round(z[3 * c + 1]));
    r2 = bf16_round(bf16_round(x[3 * i + 2]) - bf16_round(z[3 * c + 2]));
    d2 = bf16_round((bf16_round(r0 * r0) + bf16_round(r1 * r1)) +
                    bf16_round(r2 * r2));
    u = (PRE[k] + bf16_round(d2 * bf16_round(w1d[j]))) + bf16_round(c1[j]);
  } else {
    r0 = x[3 * i] - z[3 * c];
    r1 = x[3 * i + 1] - z[3 * c + 1];
    r2 = x[3 * i + 2] - z[3 * c + 2];
    d2 = r0 * r0 + r1 * r1 + r2 * r2;
    u = (PRE[k] + d2 * w1d[j]) + c1[j];
  }
  if (j == 0)
    *reinterpret_cast<float4*>(RL4 + 4 * (size_t)i) =
        make_float4(r0, r1, r2, d2);
  float t, dt;
  silu_both(u, t, dt);
  T1[k] = t;
  if (SP) SP[k] = dt;
}

// Forward, a warp a node: the two gates' row sums; dx += rel gx; DZT =
// -(rel gz) m; mh += msg; WMS = msg m (the ms column sums' rows)
__global__ void virt_gates_fwd(const float* __restrict__ GX,
                               const float* __restrict__ GZ,
                               const float* __restrict__ MSG, int H,
                               const float* __restrict__ bg1,
                               const float* __restrict__ wg2,
                               const float* __restrict__ bz1,
                               const float* __restrict__ wz2,
                               const float* __restrict__ RL4,
                               const float* __restrict__ mask, int n,
                               int first, float* __restrict__ DX,
                               float* __restrict__ DZT,
                               float* __restrict__ MHA,
                               float* __restrict__ WMS, int bf) {
  const int i = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  auto rb = [&](float v) { return bf ? bf16_round(v) : v; };
  const float m = mask[i];
  float sx = 0.0f, sz = 0.0f;
  for (int j = lane; j < H; j += 32) {
    const size_t k = (size_t)i * H + j;
    const float u = GX[k] + rb(bg1[j]), v = GZ[k] + rb(bz1[j]);
    sx += __fmul_rn(rb(u * sigm(u)), rb(wg2[j]));
    sz += __fmul_rn(rb(v * sigm(v)), rb(wz2[j]));
    const float msg = MSG[k];
    MHA[k] = (first ? 0.0f : MHA[k]) + msg;
    WMS[k] = msg * m;
  }
  for (int o = 16; o > 0; o >>= 1) {
    sx += __shfl_xor_sync(FULL, sx, o);
    sz += __shfl_xor_sync(FULL, sz, o);
  }
  if (lane < 3) {
    const float rl = RL4[4 * (size_t)i + lane];
    DX[3 * i + lane] = (first ? 0.0f : DX[3 * i + lane]) + rl * sx;
    DZT[4 * (size_t)i + lane] = (-rl * sz) * m;
  }
}

// dx /= C, mh /= C (the channel mean)
__global__ void virt_finish_fwd(float* __restrict__ DX,
                                const float* __restrict__ MHA, int H, int n,
                                float inv_c, float* __restrict__ dx,
                                float* __restrict__ mh) {
  const long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (f < (long long)n * H) mh[f] = MHA[f] * inv_c;
  if (f < 3LL * n) dx[f] = DX[f] * inv_c;
}

// Backward gates, a warp a node: PX becomes q_x = (g_gx wg2) silu'(px),
// SXG = silu(px) g_gx (and the same for z); GXZ[i] = (gx, gz) row sums,
// with g_gx = u_x . rel, g_gz = (-m g_dz_c) . rel
__global__ void virt_gates_bwd(float* __restrict__ PX, float* __restrict__ PZ,
                               float* __restrict__ SXG,
                               float* __restrict__ SZG, int H,
                               const float* __restrict__ bg1,
                               const float* __restrict__ wg2,
                               const float* __restrict__ bz1,
                               const float* __restrict__ wz2,
                               const float* __restrict__ RL4,
                               const float* __restrict__ mask,
                               const float* __restrict__ gdx,
                               const float* __restrict__ gdz, int c, int n,
                               float inv_c, float* __restrict__ GXZ, int bf) {
  const int i = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  auto rb = [&](float v) { return bf ? bf16_round(v) : v; };
  const float4 rl = *reinterpret_cast<const float4*>(RL4 + 4 * (size_t)i);
  const float m = mask[i];
  const float ggx = (gdx[3 * i] * inv_c) * rl.x +
                    (gdx[3 * i + 1] * inv_c) * rl.y +
                    (gdx[3 * i + 2] * inv_c) * rl.z;
  const float ggz = (-m * gdz[3 * c]) * rl.x + (-m * gdz[3 * c + 1]) * rl.y +
                    (-m * gdz[3 * c + 2]) * rl.z;
  float sx = 0.0f, sz = 0.0f;
  for (int j = lane; j < H; j += 32) {
    const size_t k = (size_t)i * H + j;
    float ax, dax, az, daz;
    silu_both(PX[k] + rb(bg1[j]), ax, dax);
    silu_both(PZ[k] + rb(bz1[j]), az, daz);
    const float wx = rb(wg2[j]), wz = rb(wz2[j]);
    sx += rb(ax) * wx;
    sz += rb(az) * wz;
    PX[k] = (rb(ggx) * wx) * dax;
    PZ[k] = (rb(ggz) * wz) * daz;
    SXG[k] = rb(ax) * rb(ggx);
    SZG[k] = rb(az) * rb(ggz);
  }
  for (int o = 16; o > 0; o >>= 1) {
    sx += __shfl_xor_sync(FULL, sx, o);
    sz += __shfl_xor_sync(FULL, sz, o);
  }
  if (lane == 0)
    *reinterpret_cast<float2*>(GXZ + 2 * (size_t)i) = make_float2(sx, sz);
}

// g_msg += g_mh / C + m g_ms_c
__global__ void virt_gmsg(float* __restrict__ GM, int H,
                          const float* __restrict__ gmh,
                          const float* __restrict__ gms,
                          const float* __restrict__ mask, int c, int n,
                          float inv_c) {
  const long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int i = (int)(f / H), j = (int)(f % H);
  if (i >= n) return;
  GM[f] += gmh[f] * inv_c + mask[i] * gms[(size_t)c * H + j];
}

// Per node, a warp: g_pre = GP (= g_msg.W2^T) silu'(pre) in place, g_d2 =
// sum g_pre w1d, g_rel = u_x gx + u_z gz + 2 rel g_d2; gx += g_rel,
// GRM = g_rel (the dz sum's rows)
__global__ void virt_gpre(float* __restrict__ GP,
                          const float* __restrict__ SP, int H,
                          const float* __restrict__ w1d,
                          const float* __restrict__ RL4,
                          const float* __restrict__ GXZ,
                          const float* __restrict__ mask,
                          const float* __restrict__ gdx,
                          const float* __restrict__ gdz, int c, int n,
                          float inv_c, int first, float* __restrict__ gx,
                          float* __restrict__ GRM, int bf) {
  const int i = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  float s = 0.0f;
  for (int j = lane; j < H; j += 32) {
    const size_t k = (size_t)i * H + j;
    const float g = GP[k] * SP[k];
    GP[k] = g;
    s += g * (bf ? bf16_round(w1d[j]) : w1d[j]);
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if (lane < 3) {
    const float4 rl = *reinterpret_cast<const float4*>(RL4 + 4 * (size_t)i);
    const float2 gz2 = *reinterpret_cast<const float2*>(GXZ + 2 * (size_t)i);
    const float r = lane == 0 ? rl.x : (lane == 1 ? rl.y : rl.z);
    const float m = mask[i];
    const float ux = gdx[3 * i + lane] * inv_c;
    const float uz = -m * gdz[3 * c + lane];
    const float g_rel = ux * gz2.x + uz * gz2.y + 2.0f * r * s;
    gx[3 * i + lane] = (first ? 0.0f : gx[3 * i + lane]) + g_rel;
    GRM[4 * (size_t)i + lane] = g_rel;
  }
}

// ------------------------------------------------------------------- host
#define TRY(expr)                                   \
  do {                                              \
    const cudaError_t e_ = (expr);                  \
    if (e_ != cudaSuccess) return (int)e_;          \
  } while (0)

// Device scratch carved in order, each piece 16-byte aligned
struct Carver {
  float* base;
  size_t off = 0;
  float* take(size_t count) {
    float* p = base == nullptr ? nullptr : base + off;
    off += round4(count);
    return p;
  }
  int* itake(size_t count) { return reinterpret_cast<int*>(take(count)); }
};

Live carve_live(Carver& cv, int e) {
  Live L;
  L.live = cv.itake(e);
  L.lidx = cv.itake(e);
  L.rowof = cv.itake(e);
  L.counts = cv.itake((e + SCAN_BLOCK - 1) / SCAN_BLOCK + 1);
  L.n_live = cv.itake(1);
  return L;
}

unsigned blocks(long long threads, int per = 256) {
  return (unsigned)((threads + per - 1) / per);
}

struct EdgeFwd {
  float *P, *Q, *E4, *T1, *MSG, *GP, *TERM;
  Live L;
};

EdgeFwd carve_edge_fwd(Carver& cv, int n, int e, int H, int M) {
  EdgeFwd s;
  s.P = cv.take((size_t)n * H);
  s.Q = cv.take((size_t)n * H);
  s.L = carve_live(cv, e);
  s.E4 = cv.take((size_t)e * 4);
  s.T1 = cv.take((size_t)e * H);
  s.MSG = cv.take((size_t)e * M);
  s.GP = cv.take((size_t)e * H);
  s.TERM = cv.take((size_t)e * 4);
  return s;
}

struct EdgeBwd {
  float *P, *Q, *E4, *U4, *GR4, *GGATE, *T1, *SG, *MSG, *GP, *SV, *GM, *GPRE,
      *GREL, *G, *S, *part, *wpart, *HB, *GHR, *GHS;
  Live L;
};

EdgeBwd carve_edge_bwd(Carver& cv, int n, int e, int D, int H, int M,
                       bool bf) {
  EdgeBwd s;
  s.P = cv.take((size_t)n * H);
  s.Q = cv.take((size_t)n * H);
  s.L = carve_live(cv, e);
  s.E4 = cv.take((size_t)e * 4);
  s.U4 = cv.take((size_t)e * 4);
  s.GR4 = cv.take((size_t)e * 4);
  s.GGATE = cv.take((size_t)e);
  s.T1 = cv.take((size_t)e * H);
  s.SG = cv.take((size_t)e * H);
  s.MSG = cv.take((size_t)e * M);
  s.GP = cv.take((size_t)e * H);
  s.SV = cv.take((size_t)e * H);
  s.GM = cv.take((size_t)e * M);
  s.GPRE = cv.take((size_t)e * H);
  s.GREL = cv.take((size_t)e * 4);
  s.G = cv.take((size_t)n * H);
  s.S = cv.take((size_t)n * H);
  s.part = cv.take((size_t)CHUNKS * (H > M ? H : M));
  s.wpart = cv.take((size_t)SPLIT * max(H * M, D * H));
  s.HB = bf ? cv.take((size_t)n * D) : nullptr;
  s.GHR = bf ? cv.take((size_t)e * D) : nullptr;
  s.GHS = bf ? cv.take((size_t)e * D) : nullptr;
  return s;
}

struct VirtFwd {
  float *PRE, *T1, *MSG, *GX, *GZ, *RL4, *DX, *DZT, *MHA, *WMS, *part;
};

VirtFwd carve_virt_fwd(Carver& cv, int n, int H) {
  VirtFwd s;
  s.PRE = cv.take((size_t)n * H);
  s.T1 = cv.take((size_t)n * H);
  s.MSG = cv.take((size_t)n * H);
  s.GX = cv.take((size_t)n * H);
  s.GZ = cv.take((size_t)n * H);
  s.RL4 = cv.take((size_t)n * 4);
  s.DX = cv.take((size_t)n * 3);
  s.DZT = cv.take((size_t)n * 4);
  s.MHA = cv.take((size_t)n * H);
  s.WMS = cv.take((size_t)n * H);
  s.part = cv.take((size_t)CHUNKS * H);
  return s;
}

struct VirtBwd {
  float *PRE, *T1, *SP, *MSG, *PX, *PZ, *SXG, *SZG, *GM, *RL4, *GXZ, *GRM,
      *part, *wpart;
};

VirtBwd carve_virt_bwd(Carver& cv, int n, int D, int H) {
  VirtBwd s;
  s.PRE = cv.take((size_t)n * H);
  s.T1 = cv.take((size_t)n * H);
  s.SP = cv.take((size_t)n * H);
  s.MSG = cv.take((size_t)n * H);
  s.PX = cv.take((size_t)n * H);
  s.PZ = cv.take((size_t)n * H);
  s.SXG = cv.take((size_t)n * H);
  s.SZG = cv.take((size_t)n * H);
  s.GM = cv.take((size_t)n * H);
  s.RL4 = cv.take((size_t)n * 4);
  s.GXZ = cv.take((size_t)n * 2);
  s.GRM = cv.take((size_t)n * 4);
  s.part = cv.take((size_t)CHUNKS * H);
  s.wpart = cv.take((size_t)SPLIT * max(H * H, D * H));
  return s;
}

bool panel_widths(int D, int H, int M) {
  return D > 0 && H > 0 && M > 0 && D % P64 == 0 && H % P64 == 0 &&
         M % P64 == 0;
}

}  // namespace

extern "C" long long panel_edge_fwd_scratch_floats(int n, int e, int H,
                                                   int M) {
  Carver cv{nullptr};
  carve_edge_fwd(cv, n, e, H, M);
  return (long long)cv.off;
}

extern "C" long long panel_edge_bwd_scratch_floats(int n, int e, int D,
                                                   int H, int M, int bf) {
  Carver cv{nullptr};
  carve_edge_bwd(cv, n, e, D, H, M, bf != 0);
  return (long long)cv.off;
}

extern "C" long long panel_virtual_fwd_scratch_floats(int n, int H) {
  Carver cv{nullptr};
  carve_virt_fwd(cv, n, H);
  return (long long)cv.off;
}

extern "C" long long panel_virtual_bwd_scratch_floats(int n, int D, int H) {
  Carver cv{nullptr};
  carve_virt_bwd(cv, n, D, H);
  return (long long)cv.off;
}

// Edge forward: D, H, M (Dh, H1, M) multiples of 64, gate 0 'none', 1
// 'mlp', 2 'identity' (M = 64, the message's column 0 real); bf != 0: the
// bf16 mode; outputs dx (n x 3), mh (n x M), deg (n)
extern "C" int panel_edge_forward(
    const float* x, const float* h, const int* snd, const float* em,
    const int* indptr, const float* w1r, const float* w1s, const float* w1d,
    const float* b1, const float* w2, const float* b2, const float* wg1,
    const float* bg1, const float* wg2, float* dx, float* mh, float* deg,
    float* scratch, int n, int e, int D, int H, int M, int gate,
    int rel_inv1p, float clamp, int bf, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  if (!panel_widths(D, H, M)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  Carver cv{scratch};
  const EdgeFwd s = carve_edge_fwd(cv, n, e, H, M);
  const int* nl = s.L.n_live;
  TRY((gemm<false, false>(mm(h, D, w1r, H, s.P, H, n, H, D), n, st, bf)));
  TRY((gemm<false, false>(mm(h, D, w1s, H, s.Q, H, n, H, D), n, st, bf)));
  TRY(compact_live(em, indptr, n, e, s.L, st));
  if (e > 0) {
    edge_pre<<<blocks((long long)e * H), 256, 0, st>>>(
        x, snd, s.L.live, s.L.rowof, nl, s.P, s.Q, w1d, b1, H, s.E4, s.T1,
        nullptr, bf);
    TRY(cudaGetLastError());
    TRY((gemm<false, false, true>(
        mm(s.T1, H, w2, M, s.MSG, M, e, M, H, b2, 0, nl), e, st, bf)));
    if (gate == GATE_MLP)
      TRY((gemm<false, false, true>(
          mm(s.MSG, M, wg1, H, s.GP, H, e, H, M, nullptr, 0, nl), e, st,
          bf)));
    if (gate != GATE_NONE) {
      edge_gate_fwd<<<blocks((long long)e * 32), 256, 0, st>>>(
          s.GP, bg1, wg2, H, s.MSG, M, gate, s.E4, em, s.L.live, nl,
          rel_inv1p, clamp, s.TERM, bf);
      TRY(cudaGetLastError());
    }
  }
  edge_rows_fwd<<<blocks((long long)n * 32), 256, 0, st>>>(
      s.MSG, M, s.TERM, em, indptr, s.L.lidx, n, gate != GATE_NONE, dx, mh,
      deg, bf);
  return (int)cudaGetLastError();
}

// Edge backward: the 11 gradients (the gate's three not written without
// the gate), each of its padded shape
extern "C" int panel_edge_backward(
    const float* x, const float* h, const int* snd, const float* em,
    const int* indptr, const int* sperm, const int* sptr, const float* w1r,
    const float* w1s, const float* w1d, const float* b1, const float* w2,
    const float* b2, const float* wg1, const float* bg1, const float* wg2,
    const float* deg, const float* gdx, const float* gmh, float* gx,
    float* gh, float* gw1r, float* gw1s, float* gw1d, float* gb1, float* gw2,
    float* gb2, float* gwg1, float* gbg1, float* gwg2, float* scratch, int n,
    int e, int D, int H, int M, int gate, int rel_inv1p, float clamp, int bf,
    void* stream_ptr) {
  const bool gate_mlp = gate == GATE_MLP;
  cudaStream_t st = (cudaStream_t)stream_ptr;
  if (!panel_widths(D, H, M)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  Carver cv{scratch};
  const EdgeBwd s = carve_edge_bwd(cv, n, e, D, H, M, bf != 0);
  const int* nl = s.L.n_live;
  TRY((gemm<false, false>(mm(h, D, w1r, H, s.P, H, n, H, D), n, st, bf)));
  TRY((gemm<false, false>(mm(h, D, w1s, H, s.Q, H, n, H, D), n, st, bf)));
  TRY(compact_live(em, indptr, n, e, s.L, st));
  if (e > 0) {
    edge_pre<<<blocks((long long)e * H), 256, 0, st>>>(
        x, snd, s.L.live, s.L.rowof, nl, s.P, s.Q, w1d, b1, H, s.E4, s.T1,
        s.SG, bf);
    TRY(cudaGetLastError());
    TRY((gemm<false, false>(mm(s.T1, H, w2, M, s.MSG, M, e, M, H, b2, 0, nl),
                            e, st, bf)));
    if (gate_mlp)
      TRY((gemm<false, false>(
          mm(s.MSG, M, wg1, H, s.GP, H, e, H, M, nullptr, 0, nl), e, st,
          bf)));
    edge_gate_bwd<<<blocks((long long)e * 32), 256, 0, st>>>(
        s.GP, s.SV, bg1, wg2, H, s.MSG, M, s.GGATE, s.E4, em, s.L.live,
        s.L.rowof, nl, deg, gdx, gate, rel_inv1p, clamp, s.U4, s.GR4, bf);
    TRY(cudaGetLastError());
    // g_msg = (g_gp1.Wg1^T) + g_mh[r] inv em
    if (gate_mlp)
      TRY((gemm<false, true>(
          mm(s.GP, H, wg1, H, s.GM, M, e, M, H, nullptr, 0, nl), e, st,
          bf)));
    edge_gmsg<<<blocks((long long)e * M), 256, 0, st>>>(
        s.GM, M, gmh, s.U4, em, s.L.live, s.L.rowof, nl, !gate_mlp,
        gate == GATE_IDENTITY ? s.GGATE : nullptr, bf);
    TRY(cudaGetLastError());
    // g_pre1 = (g_msg.W2^T) silu'(pre1); g_rel
    TRY((gemm<false, true>(
        mm(s.GM, M, w2, M, s.GPRE, H, e, H, M, nullptr, 0, nl), e, st, bf)));
    edge_gpre<<<blocks((long long)e * 32), 256, 0, st>>>(
        s.GPRE, s.SG, H, w1d, s.E4, s.GR4, s.L.live, nl, s.GREL, bf);
    TRY(cudaGetLastError());
  }
  // weight gradients over the live edges, in their order
  TRY(weight_grad(s.T1, H, s.GM, M, gw2, H, M, 0, nl, s.wpart, st, bf));
  TRY(colsum(s.GM, M, M, nullptr, 0, 0, nl, s.part, gb2, st));
  TRY(colsum(s.GPRE, H, H, nullptr, 0, 0, nl, s.part, gb1, st));
  if (bf && e > 0) {  // g_pre1 enters every product below rounded
    round_bf16<<<blocks((long long)e * H), 256, 0, st>>>(s.GPRE, nullptr,
                                                          (long long)e * H);
    TRY(cudaGetLastError());
  }
  TRY(colsum(s.GPRE, H, H, s.E4 + 3, 4, 0, nl, s.part, gw1d, st, 1.0f, bf));
  if (gate_mlp) {
    TRY(weight_grad(s.MSG, M, s.GP, H, gwg1, M, H, 0, nl, s.wpart, st, bf));
    TRY(colsum(s.GP, H, H, nullptr, 0, 0, nl, s.part, gbg1, st));
    TRY(colsum(s.SV, H, H, nullptr, 0, 0, nl, s.part, gwg2, st));
  }
  // per node: G, S, gx; gh = G.W1r^T + S.W1s^T; W1r = h^T G, W1s = h^T S
  edge_nodes_bwd<<<blocks((long long)n * 32), 256, 0, st>>>(
      s.GPRE, H, s.GREL, s.L.lidx, indptr, sperm, sptr, n, s.G, s.S, gx);
  TRY(cudaGetLastError());
  const float* hw = h;
  if (bf) {
    // gh: the per-edge products bf16(g_pre1 W1r^T), bf16(g_pre1 W1s^T)
    // over the live edges, summed per receiver row and per sender
    if (e > 0) {
      Gemm gr = mm(s.GPRE, H, w1r, H, s.GHR, D, e, D, H, nullptr, 0, nl);
      Gemm gs = mm(s.GPRE, H, w1s, H, s.GHS, D, e, D, H, nullptr, 0, nl);
      gr.rnd_out = gs.rnd_out = 1;
      TRY((gemm<false, true>(gr, e, st, bf)));
      TRY((gemm<false, true>(gs, e, st, bf)));
    }
    edge_nodes_gh<<<blocks((long long)n * 32), 256, 0, st>>>(
        s.GHR, s.GHS, D, s.L.lidx, indptr, sperm, sptr, n, gh);
    TRY(cudaGetLastError());
    round_bf16<<<blocks((long long)n * D), 256, 0, st>>>(s.HB, h,
                                                         (long long)n * D);
    TRY(cudaGetLastError());
    hw = s.HB;  // h rounded; G and S enter in f32 (3xTF32)
  } else {
    TRY((gemm<false, true>(mm(s.G, H, w1r, H, gh, D, n, D, H), n, st, 0)));
    TRY((gemm<false, true>(mm(s.S, H, w1s, H, gh, D, n, D, H, nullptr, 1),
                           n, st, 0)));
  }
  TRY(weight_grad(hw, D, s.G, H, gw1r, D, H, n, nullptr, s.wpart, st, 0));
  TRY(weight_grad(hw, D, s.S, H, gw1s, D, H, n, nullptr, s.wpart, st, 0));
  return (int)cudaGetLastError();
}

// Virtual forward: D, H (Dh, hid) multiples of 64, channels in order
extern "C" int panel_virtual_forward(
    const float* x, const float* h, const float* z, const float* mask,
    const float* w1h, const float* w1d, const float* c1, const float* w2,
    const float* b2, const float* wg1, const float* bg1, const float* wg2,
    const float* wz1, const float* bz1, const float* wz2, float* dx,
    float* mh, float* dz, float* ms, float* scratch, int n, int n_chan,
    int D, int H, int bf, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  if (!panel_widths(D, H, H) || n_chan <= 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  Carver cv{scratch};
  const VirtFwd s = carve_virt_fwd(cv, n, H);
  const size_t HH = (size_t)H * H, DH = (size_t)D * H;
  for (int c = 0; c < n_chan; ++c) {
    TRY((gemm<false, false, true>(
        mm(h, D, w1h + c * DH, H, s.PRE, H, n, H, D), n, st, bf)));
    virt_pre<<<blocks((long long)n * H), 256, 0, st>>>(
        x, z, c, n, s.PRE, H, w1d + (size_t)c * H, c1 + (size_t)c * H, s.T1,
        nullptr, s.RL4, bf);
    TRY(cudaGetLastError());
    TRY((gemm<false, false, true>(
        mm(s.T1, H, w2 + c * HH, H, s.MSG, H, n, H, H, b2 + (size_t)c * H),
        n, st, bf)));
    TRY((gemm<false, false, true>(mm(s.MSG, H, wg1 + c * HH, H, s.GX, H, n,
                                     H, H), n, st, bf)));
    TRY((gemm<false, false, true>(mm(s.MSG, H, wz1 + c * HH, H, s.GZ, H, n,
                                     H, H), n, st, bf)));
    virt_gates_fwd<<<blocks((long long)n * 32), 256, 0, st>>>(
        s.GX, s.GZ, s.MSG, H, bg1 + (size_t)c * H, wg2 + (size_t)c * H,
        bz1 + (size_t)c * H, wz2 + (size_t)c * H, s.RL4, mask, n, c == 0,
        s.DX, s.DZT, s.MHA, s.WMS, bf);
    TRY(cudaGetLastError());
    TRY(colsum(s.WMS, H, H, nullptr, 0, n, nullptr, s.part,
               ms + (size_t)c * H, st));
    TRY(colsum(s.DZT, 4, 3, nullptr, 0, n, nullptr, s.part, dz + 3 * c, st));
  }
  virt_finish_fwd<<<blocks((long long)n * H), 256, 0, st>>>(
      s.DX, s.MHA, H, n, 1.0f / (float)n_chan, dx, mh);
  return (int)cudaGetLastError();
}

// Virtual backward: the 14 gradients, each of its padded shape
extern "C" int panel_virtual_backward(
    const float* x, const float* h, const float* z, const float* mask,
    const float* w1h, const float* w1d, const float* c1, const float* w2,
    const float* b2, const float* wg1, const float* bg1, const float* wg2,
    const float* wz1, const float* bz1, const float* wz2, const float* gdx,
    const float* gmh, const float* gdz, const float* gms, float* gx,
    float* gh, float* gz, float* gw1h, float* gw1d, float* gc1, float* gw2,
    float* gb2, float* gwg1, float* gbg1, float* gwg2, float* gwz1,
    float* gbz1, float* gwz2, float* scratch, int n, int n_chan, int D,
    int H, int bf, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  if (!panel_widths(D, H, H) || n_chan <= 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  Carver cv{scratch};
  const VirtBwd s = carve_virt_bwd(cv, n, D, H);
  const size_t HH = (size_t)H * H, DH = (size_t)D * H;
  const float inv_c = 1.0f / (float)n_chan;
  for (int c = 0; c < n_chan; ++c) {
    const size_t v = (size_t)c * H;
    TRY((gemm<false, false>(mm(h, D, w1h + c * DH, H, s.PRE, H, n, H, D), n,
                            st, bf)));
    virt_pre<<<blocks((long long)n * H), 256, 0, st>>>(
        x, z, c, n, s.PRE, H, w1d + v, c1 + v, s.T1, s.SP, s.RL4, bf);
    TRY(cudaGetLastError());
    TRY((gemm<false, false>(
        mm(s.T1, H, w2 + c * HH, H, s.MSG, H, n, H, H, b2 + v), n, st, bf)));
    TRY((gemm<false, false>(mm(s.MSG, H, wg1 + c * HH, H, s.PX, H, n, H, H),
                            n, st, bf)));
    TRY((gemm<false, false>(mm(s.MSG, H, wz1 + c * HH, H, s.PZ, H, n, H, H),
                            n, st, bf)));
    virt_gates_bwd<<<blocks((long long)n * 32), 256, 0, st>>>(
        s.PX, s.PZ, s.SXG, s.SZG, H, bg1 + v, wg2 + v, bz1 + v, wz2 + v,
        s.RL4, mask, gdx, gdz, c, n, inv_c, s.GXZ, bf);
    TRY(cudaGetLastError());
    TRY(colsum(s.PX, H, H, nullptr, 0, n, nullptr, s.part, gbg1 + v, st));
    TRY(colsum(s.PZ, H, H, nullptr, 0, n, nullptr, s.part, gbz1 + v, st));
    TRY(colsum(s.SXG, H, H, nullptr, 0, n, nullptr, s.part, gwg2 + v, st));
    TRY(colsum(s.SZG, H, H, nullptr, 0, n, nullptr, s.part, gwz2 + v, st));
    // g_msg = q_x.Wg1^T + q_z.Wz1^T + g_mh / C + m g_ms
    TRY((gemm<false, true>(mm(s.PX, H, wg1 + c * HH, H, s.GM, H, n, H, H),
                           n, st, bf)));
    TRY((gemm<false, true>(
        mm(s.PZ, H, wz1 + c * HH, H, s.GM, H, n, H, H, nullptr, 1), n, st,
        bf)));
    virt_gmsg<<<blocks((long long)n * H), 256, 0, st>>>(s.GM, H, gmh, gms,
                                                        mask, c, n, inv_c);
    TRY(cudaGetLastError());
    TRY(colsum(s.GM, H, H, nullptr, 0, n, nullptr, s.part, gb2 + v, st));
    TRY(weight_grad(s.MSG, H, s.PX, H, gwg1 + c * HH, H, H, n, nullptr,
                    s.wpart, st, bf));
    TRY(weight_grad(s.MSG, H, s.PZ, H, gwz1 + c * HH, H, H, n, nullptr,
                    s.wpart, st, bf));
    TRY(weight_grad(s.T1, H, s.GM, H, gw2 + c * HH, H, H, n, nullptr,
                    s.wpart, st, bf));
    // g_pre = (g_msg.W2^T) silu'(pre), into PRE; g_rel, gx
    TRY((gemm<false, true>(mm(s.GM, H, w2 + c * HH, H, s.PRE, H, n, H, H),
                           n, st, bf)));
    virt_gpre<<<blocks((long long)n * 32), 256, 0, st>>>(
        s.PRE, s.SP, H, w1d + v, s.RL4, s.GXZ, mask, gdx, gdz, c, n, inv_c,
        c == 0, gx, s.GRM, bf);
    TRY(cudaGetLastError());
    TRY(colsum(s.PRE, H, H, nullptr, 0, n, nullptr, s.part, gc1 + v, st));
    TRY(colsum(s.PRE, H, H, s.RL4 + 3, 4, n, nullptr, s.part, gw1d + v, st));
    TRY(colsum(s.GRM, 4, 3, nullptr, 0, n, nullptr, s.part, gz + 3 * c, st,
               -1.0f));
    // gh += g_pre.W1h^T (channels in order); W1h = h^T g_pre
    TRY((gemm<false, true>(
        mm(s.PRE, H, w1h + c * DH, H, gh, D, n, D, H, nullptr, c > 0), n,
        st, bf)));
    TRY(weight_grad(h, D, s.PRE, H, gw1h + c * DH, D, H, n, nullptr,
                    s.wpart, st, bf));
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
