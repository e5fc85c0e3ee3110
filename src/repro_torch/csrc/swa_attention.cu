// Flash-style causal sliding-window attention for Hopper (sm_90a), f32.
//
//   o = softmax(mask(q k^T / sqrt(D))) v,   mask: k <= q (causal) and
//                                                 k >  q - window (windowed)
//
// Replaces the Pallas TPU kernel `swa_attention` (`_kernel`) of the JAX
// package's kernels/swa_attention.py for f32 inputs (bf16 inputs go to the
// tensor-core kernel in swa_attention_wgmma.cu), generalised to the layout
// the transformer hands over: q and o (B, S, H, D), k and v (B, S, KV, D),
// head h reading KV head h / (H / KV), any element strides per batch,
// position and head (so the (H, S, D) layout of the Pallas kernel needs no
// transpose), D in {64, 128, 256}, any S >= 1 (the ragged last block is
// masked here; the Pallas kernel asserted S % block == 0).  Everything
// inside is f32.
//
// Design (right and simple first; f32 FMA units, no tensor cores):
// - One CTA of 256 threads per (batch * head, 64-query block).  The TPU
//   grid walked the key blocks sequentially and kept m / l / acc in VMEM
//   scratch; here the CTA loops over key blocks itself and keeps them in
//   registers: thread (ty, tx) owns query rows 4*ty .. 4*ty+3, the scores
//   of key columns 4*tx .. 4*tx+3, and the output columns
//   {4*tx + 64*c .. +3}.  A row's 16 owners are 16 lanes of one warp, so
//   the row max and row sum are shuffles.
// - The loop touches only the key blocks that meet the causal / window
//   band, [max(0, q0 - window + 1), min(S - 1, q0 + 63)] for a causal
//   window: what makes SWA linear in S (the Pallas pl.when(any(visible))).
// - q and k are staged transposed ([D][64]) and v row-major ([64][D])
//   through shared memory as f32; P goes through a [64][68] tile.  At
//   D = 256 that is 214,016 bytes, one CTA per SM.
// - Masked scores give p = 0 by an explicit select (as `_kernel`'s
//   jnp.where(visible, exp(s - m_new), 0)): with m = -1e30 for a row that
//   has seen nothing yet, exp(s - m) would be exp(0) = 1.  The output is
//   acc / max(l, 1e-30).
// - No atomics and a fixed summation order: a repeated run is bitwise
//   equal.
//
// Bound on an H100 (B = 1, S = 8,192, H = 16, KV = 8, D = 256): 4 D FLOP
// per visible (q, k) pair, 129 GFLOP for a 1,024 window and 550 GFLOP
// causal, i.e. 1.92 / 8.21 ms at the 67 TFLOP/s f32 rate this kernel
// computes at, against 0.120 ms for the 403 MB of f32 q, k, v and o: bound
// by operations.  It keeps f32 exact (no TF32), which is what the f32
// parity checks of the LM are placed on.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 64;         // keys per block
constexpr int PS = BK + 4;     // row stride of the P tile (float4-aligned)
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;  // the Pallas kernel's _NEG
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, H, group;           // group = H / KV
  long long q_sb, q_ss, q_sh;  // element strides of q and o
  long long k_sb, k_ss, k_sh;  // element strides of k and v
  int causal, window;        // window <= 0: no window
  float scale;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// max / sum over the 16 lanes that own one query row (lanes 0-15 or 16-31)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int m = 8; m > 0; m >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, m));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int m = 8; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  return v;
}

// 64 rows of `src` (row stride `ss` elements) from row `r0`, zero past `n`,
// into dst[d][r] (transposed).  Thread t stages row t % 64, four
// consecutive d at a time, so a warp writes 32 consecutive floats.
template <int D>
__device__ __forceinline__ void stage_transposed(float* dst, const float* src,
                                                 int r0, int n, long long ss) {
  const int r = threadIdx.x & 63;
  const bool ok = r0 + r < n;
  const float* row = src + (long long)(r0 + r) * ss;
#pragma unroll 4
  for (int d = (threadIdx.x >> 6) * 4; d < D; d += 16) {
    const float4 x = ok ? load4(row + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[(d + 0) * 64 + r] = x.x;
    dst[(d + 1) * 64 + r] = x.y;
    dst[(d + 2) * 64 + r] = x.z;
    dst[(d + 3) * 64 + r] = x.w;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
swa_attention_kernel(const Params p) {
  constexpr int NC = D / 64;  // float4 output columns per thread
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][BQ]
  float* kt = qt + D * BQ;                        // [D][BK]
  float* vs = kt + D * BK;                        // [BK][D]
  float* ps = vs + BK * D;                        // [BQ][PS]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H, kvh = h / p.group;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.k_sb + kvh * p.k_sh;
  float* og = static_cast<float*>(p.o) + b * p.q_sb + h * p.q_sh;

  stage_transposed<D>(qt, qg, q0, p.S, p.q_ss);

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  // the key blocks that meet the band of rows [q0, q0 + BQ)
  const int q_last = min(q0 + BQ, p.S) - 1;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_hi = p.causal ? q_last : p.S - 1;

  for (int kb = k_lo / BK; kb <= k_hi / BK; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous block's kt / vs / ps are consumed
    stage_transposed<D>(kt, kg, k0, p.S, p.k_ss);
    for (int i = tid; i < BK * D / 4; i += THREADS) {
      const int r = i / (D / 4), d = (i % (D / 4)) * 4;
      const float4 x = k0 + r < p.S ? load4(vg + (long long)(k0 + r) * p.k_ss + d)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
      store4(vs + r * D + d, x);
    }
    __syncthreads();

    // scores of rows 4ty.. against keys 4tx..
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = load4(qt + d * BQ + 4 * ty);
      const float4 c = load4(kt + d * BK + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // mask, online softmax, P into shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      bool vis[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 4 * tx + j;
        vis[j] = kpos < p.S && (!p.causal || kpos <= qpos) &&
                 (p.window <= 0 || kpos > qpos - p.window);
        s[i][j] = vis[j] ? s[i][j] * p.scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += s[i][j];
      }
      rs = row_sum(rs);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
      store4(ps + (4 * ty + i) * PS + 4 * tx,
             make_float4(s[i][0], s[i][1], s[i][2], s[i][3]));
    }
    __syncthreads();

    // acc += P V
#pragma unroll 2
    for (int k = 0; k < BK; k += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = load4(ps + (4 * ty + i) * PS + k);
        pr[i][0] = t.x; pr[i][1] = t.y; pr[i][2] = t.z; pr[i][3] = t.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = load4(vs + (k + kk) * D + 64 * c + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * c + 0] = fmaf(pr[i][kk], vv.x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = fmaf(pr[i][kk], vv.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(pr[i][kk], vv.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(pr[i][kk], vv.w, acc[i][4 * c + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= p.S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* row = og + (long long)qpos * p.q_ss;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store4(row + 64 * c + 4 * tx,
             make_float4(acc[i][4 * c + 0] / den, acc[i][4 * c + 1] / den,
                         acc[i][4 * c + 2] / den, acc[i][4 * c + 3] / den));
  }
}

constexpr size_t smem_bytes(int d) {
  return sizeof(float) * (size_t)(3 * 64 * d + BQ * PS);
}

template <int D>
int launch(const Params& p, int n_q_blocks, int n_bh, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      swa_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  swa_attention_kernel<D>
      <<<dim3(n_q_blocks, n_bh), THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// float32 only.  Strides are in elements.
extern "C" int swa_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B,
    int S, int H, int KV, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    int causal, int window, float scale, void* stream_ptr) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, S, H, H / KV, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
           causal, window, scale};
  const int n_q_blocks = (S + BQ - 1) / BQ;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  switch (D) {
    case 64: return launch<64>(p, n_q_blocks, B * H, stream);
    case 128: return launch<128>(p, n_q_blocks, B * H, stream);
    case 256: return launch<256>(p, n_q_blocks, B * H, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
