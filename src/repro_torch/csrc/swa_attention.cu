// Flash-style causal sliding-window attention for Hopper (sm_90a), f32, on
// the tensor cores as 3xTF32.
//
//   o = softmax(mask(q k^T / sqrt(D))) v,   mask: k <= q (causal) and
//                                                 k >  q - window (windowed)
//
// Replaces the Pallas TPU kernel `swa_attention` (`_kernel`) of the JAX
// package's kernels/swa_attention.py for f32 inputs (bf16 inputs go to the
// kernel in swa_attention_wgmma.cu), generalised to the layout the
// transformer hands over: q (B, S, H, DQK), k (B, T, KV, DQK), v (B, T, KV,
// DV) and o (B, S, H, DV), head h reading KV head h / (H / KV), any element
// strides (multiples of 4) per batch, position and head of each, (DQK, DV)
// in {(64, 64), (128, 128), (256, 256)} and MLA's (192, 128), any S, T >= 1
// (the ragged last blocks are masked here; the Pallas kernel asserted
// S % block == 0).  T is the keys' own length (cross-attention over an
// encoder's states); the caller takes T != S only with causal = 0, and
// passes scale = 1 / sqrt(DQK).  Keys >= T are masked.  Below, D stands for
// DQK where it counts Q and K columns and for DV where it counts V and O
// columns; at MLA's (192, 128) the products take DQK / 8 = 24 k-steps for
// Q K^T and DV / 32 = 4 column groups for P V, and shared memory holds
// 102,400 + 25,600 + 16,896 = 144,896 B.
// As `_kernel`: masked scores get p = 0 by a select (m starts at -1e30,
// where exp(s - m) would be 1), online softmax, o = acc / max(l, 1e-30),
// and key blocks outside the causal / window band are skipped.
//
// Bound on an H100 (B = 1, S = 8,192, H = 16, KV = 8, D = 256): 4 D FLOP
// per visible (q, k) pair, 129 GFLOP for a 1,024 window and 550 GFLOP
// causal.  Every product runs as three TF32 MMAs (below), so the tensor
// cores do 3x that FLOP: 0.781 / 3.33 ms at the 495 TFLOP/s TF32 rate,
// against 0.120 ms for the 403 MB of q, k, v and o: bound by operations.
//
// Design:
// - Products on the tensor cores with mma.sync.m16n8k8 in TF32, each
//   operand split as it is loaded into a TF32 high and low part
//   (`split_tf32`, tf32.cuh) and each product taken as a_lo b_hi +
//   a_hi b_lo + a_hi b_hi: f32 accuracy (a single TF32 pass misses the f32
//   tolerance).  Not wgmma: in TF32 it wants both shared-memory operands
//   K-major, so V (keys x D, MN-major in P V) would need a transposed copy,
//   and 3xTF32 through wgmma needs hi and lo copies of K and V^T in shared
//   memory, which at D = 256 do not fit beside Q.  mma.sync takes its
//   operands from registers, so each is split there.
// - One CTA of 8 warps per (batch * head, 128-query block); warp w owns
//   query rows 16 w .. 16 w + 15 for both S = Q K^T (16 x 32 keys: four
//   n8 tiles) and O = P V (16 x D: D / 8 n8 tiles, D / 2 registers a
//   thread, 128 at D = 256).  Registers bound the rows a warp can own (at
//   D = 256, O, S and the split operands take all 255 a thread; ptxas
//   spills 24 B, three staging addresses kept across the block loop), and
//   shared memory the rows a CTA can keep (Q for 128 rows is 135 KB at
//   D = 256).  So one CTA of 8 warps an SM, each key block shared by all 8.
// - Key blocks of 32.  K and V have one buffer each and their loads
//   (cp.async) overlap the other half of the work: V of block j lands
//   while the warps compute Q K_j^T and the softmax, K of block j + 1 while
//   they compute P V_j; two __syncthreads() a block.  Q (128 x D) is loaded
//   once.  Shared memory at D = 256: 135,168 + 33,792 + 33,280 = 202,240 B.
// - P stays in registers.  The accumulator gives lane (g, t) the key
//   columns 2t and 2t + 1 of each n8 tile, and the A fragment of the next
//   MMA wants k-indices t and t + 4: reading V's B fragment rows in the
//   same order (row 2t for k-index t, 2t + 1 for t + 4) makes the
//   accumulator the A operand as it is.  P is split anew for each
//   32-column group of P V, which keeps 16 registers free.
// - Conflict-free fragment loads.  The contraction over D may run in any
//   order that Q and K share: k-step kk takes d = 8 kk + 2t for k-index t
//   and 8 kk + 2t + 1 for t + 4, one 8-byte load; Q and K rows are D + 8
//   floats apart, so the rows g of a half-warp land 8 banks apart.  V's B
//   fragment wants column g of each n8 tile: lane g loads columns 4g ..
//   4g + 3 of a 32-column group, one for each of four n8 tiles (16 bytes),
//   so a lane's outputs are 8 consecutive columns; V rows are D + 4 floats
//   apart (rows 2t of a quarter-warp 8 banks apart).
// - The tensor core rounds each MMA's result toward zero.  Each k-step of
//   Q K^T sums its three MMAs from zero and joins S by an f32 add (as
//   common.cuh's STEP_SUM); P V sums a block's 12 MMAs a tile from zero
//   and joins O by an f32 add: without that sum the roundings of O's
//   running sum bias the output toward zero by ~8e-6 relative for every
//   1,024 keys (the CPU model in tests/test_torch_swa.py), ~0.6 of the
//   f32 tolerance over 8,192.
// - A warp skips a key block that none of its rows sees (the same result:
//   alpha = 1, p = 0) and masks only the blocks that meet a band edge
//   (3-4 % of the time).  CTAs run the longest bands (the last query
//   blocks) first.
// - No atomics and a fixed summation order: a repeated run is bitwise
//   equal.  NaN: a NaN in q row i gives NaN in row i, one in k row j NaN
//   in the rows that see key j, as in the plain version; a NaN in v row j
//   reaches every row of the warps that compute j's block (the plain
//   version's every row of its query chunk).
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

constexpr int BQ = 128;        // query rows per CTA
constexpr int BK = 32;         // keys per block
constexpr int NT = BK / 8;     // n8 tiles of a warp's scores
constexpr int WARPS = BQ / 16;
constexpr int THREADS = 32 * WARPS;
constexpr float NEG = -1e30f;  // the Pallas kernel's _NEG
constexpr unsigned FULL = 0xffffffffu;

// shared-memory layout for head widths DQK (q, k) and DV (v, o) (floats)
template <int DQK, int DV>
struct Smem {
  static constexpr int LDQ = DQK + 8;  // row stride of Q and K
  static constexpr int LDV = DV + 4;   // row stride of V
  static constexpr int Q = 0, K = BQ * LDQ, V = K + BK * LDQ;
  static constexpr size_t BYTES = sizeof(float) * (V + BK * LDV);
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, T, H, group;          // T: the keys' length; group = H / KV
  long long q_sb, q_ss, q_sh;  // element strides of q
  long long k_sb, k_ss, k_sh;  // ... of k
  long long v_sb, v_ss, v_sh;  // ... of v
  long long o_sb, o_ss, o_sh;  // ... of o
  int causal, window;          // window <= 0: no window
  float scale;
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [r0, r0 + n) of src (row stride ss elements, D columns) into dst
// (row stride ld floats) by 16-byte cp.async; rows at or past S are filled
// with zeros
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, long long ss,
                                           int r0, int n, int S) {
  constexpr int C = D / 4;  // 16-byte chunks a row
  for (int f = threadIdx.x; f < n * C; f += THREADS) {
    const int r = f / C, c = (f % C) * 4;
    const bool ok = r0 + r < S;
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + r * ld + c);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src + (ok ? (long long)(r0 + r) * ss : 0LL) + c),
                 "r"(ok ? 16 : 0));
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
swa_attention_kernel(const Params p) {
  using L = Smem<DQK, DV>;
  constexpr int LDQ = L::LDQ, LDV = L::LDV, NG = DV / 32;
  extern __shared__ float4 smem4[];
  float* const sq = reinterpret_cast<float*>(smem4) + L::Q;
  float* const sk = reinterpret_cast<float*>(smem4) + L::K;
  float* const sv = reinterpret_cast<float*>(smem4) + L::V;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, kvh = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest bands first
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  // the key blocks that meet the band of rows [q0, q0 + BQ)
  const int q_last = min(q0 + BQ, p.S) - 1;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_hi = p.causal ? q_last : p.T - 1;
  const int kb0 = k_lo / BK, kb1 = k_hi / BK;

  stage_rows<DQK>(sq, LDQ, qg, p.q_ss, q0, BQ, p.S);
  stage_rows<DQK>(sk, LDQ, kg, p.k_ss, kb0 * BK, BK, p.T);
  async_commit();

  const int r0 = q0 + 16 * warp;           // this warp's first row
  const int row[2] = {r0 + g, r0 + g + 8};  // the rows this lane holds
  const float* qa = sq + (16 * warp + g) * LDQ + 2 * t;
  const float* ka = sk + g * LDQ + 2 * t;
  const float* va = sv + 2 * t * LDV + 4 * g;

  // o[c][i]: rows g (e = 0, 1) and g + 8 (e = 2, 3), columns
  // 32 c + 8 t + i (e even) and 32 c + 8 t + 4 + i (e odd)
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, o[NG][4][4];
#pragma unroll
  for (int c = 0; c < NG; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][i][e] = 0.f;

  for (int kb = kb0; kb <= kb1; ++kb) {
    const int k0 = kb * BK;
    async_wait_all();
    __syncthreads();  // K of this block is in; every warp is done with V
    stage_rows<DV>(sv, LDV, vg, p.v_ss, k0, BK, p.T);
    async_commit();

    // a warp skips a block none of its rows sees
    const bool live = r0 < p.S && !(p.causal && k0 > r0 + 15) &&
                      !(p.window > 0 && k0 + BK - 1 <= r0 - p.window);
    float pr[NT][4];  // P, the A fragments of the P V k-steps
    if (live) {
      // S = Q K^T: k-step kk covers d in [8 kk, 8 kk + 8), k-index t
      // <- d = 8 kk + 2t and t + 4 <- 8 kk + 2t + 1
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < DQK / 8; ++kk) {
        const float2 x0 = load2(qa + 8 * kk);
        const float2 x1 = load2(qa + 8 * LDQ + 8 * kk);
        uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
        split_tf32(x0.x, ah[0], al[0]);
        split_tf32(x1.x, ah[1], al[1]);
        split_tf32(x0.y, ah[2], al[2]);
        split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 y = load2(ka + 8 * j * LDQ + 8 * kk);
          split_tf32(y.x, bh[j][0], bl[j][0]);
          split_tf32(y.y, bh[j][1], bl[j][1]);
        }
        float d[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(d[j], al, bh[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(d[j], ah, bl[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(d[j], ah, bh[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += d[j][e];
      }

      // mask and scale; s[j][e]: row row[e >> 1], key k0 + 8 j + 2 t + (e & 1).
      // Only a block that meets a band edge or the end needs the mask.
      const bool edge = k0 + BK > p.T ||
                        (p.causal && k0 + BK - 1 > r0) ||
                        (p.window > 0 && k0 <= r0 + 15 - p.window);
      uint32_t vis = 0xffffffffu;  // bit 4 j + e
      if (edge) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t + (e & 1), q = row[e >> 1];
            const bool ok = key < p.T && (!p.causal || key <= q) &&
                            (p.window <= 0 || key > q - p.window);
            if (!ok) vis &= ~(1u << (4 * j + e));
          }
      }
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = (vis >> (4 * j + e)) & 1u ? s[j][e] * p.scale : NEG;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      // online softmax: a row's 32 scores lie on the 4 lanes of its g
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
        mx[r] = fmaxf(m[r], mx[r]);  // m_new
        alpha[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = (vis >> (4 * j + e)) & 1u ? expf(s[j][e] - m[e >> 1])
                                                : 0.f;
          rs[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(FULL, rs[r], 1);
        rs[r] += __shfl_xor_sync(FULL, rs[r], 2);
        l[r] = l[r] * alpha[r] + rs[r];
      }
#pragma unroll
      for (int c = 0; c < NG; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[c][i][e] *= alpha[e >> 1];
      // A fragment of k-step j: rows g, g + 8 at k-index t (key 2t) and
      // t + 4 (key 2t + 1)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        pr[j][0] = s[j][0];
        pr[j][1] = s[j][2];
        pr[j][2] = s[j][1];
        pr[j][3] = s[j][3];
      }
    }

    async_wait_all();
    __syncthreads();  // V of this block is in; every warp is done with K
    if (kb < kb1) stage_rows<DQK>(sk, LDQ, kg, p.k_ss, k0 + BK, BK, p.T);
    async_commit();

    if (live) {
      // O += P V, one 32-column group (four n8 tiles) at a time; the
      // block's 12 MMAs a tile sum from zero, then join O
#pragma unroll
      for (int c = 0; c < NG; ++c) {
        float d[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[i][e] = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float4 v0 = load4(va + 8 * j * LDV + 32 * c);
          const float4 v1 = load4(va + (8 * j + 1) * LDV + 32 * c);
          const float w0[4] = {v0.x, v0.y, v0.z, v0.w};
          const float w1[4] = {v1.x, v1.y, v1.z, v1.w};
          uint32_t ah[4], al[4], bh[4][2], bl[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(pr[j][i], ah[i], al[i]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            split_tf32(w0[i], bh[i][0], bl[i][0]);
            split_tf32(w1[i], bh[i][1], bl[i][1]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(d[i], al, bh[i]);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(d[i], ah, bl[i]);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(d[i], ah, bh[i]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[c][i][e] += d[i][e];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* dst = og + (long long)row[r] * p.o_ss + 8 * t;
#pragma unroll
    for (int c = 0; c < NG; ++c)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int e = 2 * r + half;
        store4(dst + 32 * c + 4 * half,
               make_float4(o[c][0][e] / den, o[c][1][e] / den,
                           o[c][2][e] / den, o[c][3][e] / den));
      }
  }
}

template <int DQK, int DV>
int launch(const Params& p, int n_bh, int n_q_blocks, cudaStream_t stream) {
  const size_t smem = Smem<DQK, DV>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      swa_attention_kernel<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  swa_attention_kernel<DQK, DV>
      <<<dim3(n_bh, n_q_blocks), THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// float32 only.  Strides are in elements; T != S only with causal = 0.
extern "C" int swa_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int T, int H, int KV, int DQK, int DV, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, float scale,
    void* stream_ptr) {
  const int n_q_blocks = (S + BQ - 1) / BQ;
  if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV != 0 ||
      n_q_blocks > 65535 || (causal && T != S))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, S, T, H, H / KV, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
           v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, causal, window, scale};
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int bh = B * H;
  if (DQK == 64 && DV == 64) return launch<64, 64>(p, bh, n_q_blocks, stream);
  if (DQK == 128 && DV == 128)
    return launch<128, 128>(p, bh, n_q_blocks, stream);
  if (DQK == 256 && DV == 256)
    return launch<256, 256>(p, bh, n_q_blocks, stream);
  if (DQK == 192 && DV == 128)
    return launch<192, 128>(p, bh, n_q_blocks, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
