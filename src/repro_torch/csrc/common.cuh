// Helpers shared by the backward kernels (edge_message_bwd.cu,
// virtual_message_bwd.cu).  Header only; each including file gets its own
// copy inside an anonymous namespace.
//
// * tile helpers: a warp holds a tile of TILE = 8 rows (edges or nodes) of a
//   64-wide vector in a shared buffer laid out [k][t]; lane owns output
//   columns j = lane and j = lane + 32 of every 64x64 matvec over the tile.
// * outer_partials / sum_partials: a deterministic two-stage reduction of
//   sum_i a_i (x) b_i (a 64x64 outer-product sum) and sum_i b_i over the rows
//   of two row-major (rows x 64) arrays.  Stage one: block b adds rows
//   [b*OUTER_ROWS, (b+1)*OUTER_ROWS) in row order into a partial of
//   64*64 + 64 floats (each thread owns a 4x4 sub-block of the matrix);
//   stage two adds the partials in block order.  No atomics, so the result
//   depends only on the inputs and OUTER_ROWS, never on scheduling.
#pragma once
#include <cuda_runtime.h>

namespace {

constexpr int HID = 64;
constexpr int TILE = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr int OUTER_ROWS = 512;           // rows per stage-one block
constexpr int OUTER_W = HID * HID + HID;  // partial: matrix | column sums
constexpr int OUTER_THREADS = 256;
constexpr int OUTER_TR = 32;              // rows staged in shared memory

__device__ __forceinline__ float silu(float u) { return u / (1.0f + expf(-u)); }

// d silu(u) / du = s (1 + u (1 - s)), s = sigmoid(u)
__device__ __forceinline__ float silu_grad(float u) {
  const float s = 1.0f / (1.0f + expf(-u));
  return s * (1.0f + u * (1.0f - s));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  return v;  // identical bits on every lane
}

// acc{0,1}[t] += sum_k buf[k][t] * W[k][j], j = lane / lane + 32
__device__ __forceinline__ void tile_matvec(const float* __restrict__ buf,
                                            const float* __restrict__ W,
                                            int lane, float* acc0, float* acc1) {
#pragma unroll 8
  for (int k = 0; k < HID; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(buf + k * TILE);
    const float4 b = *reinterpret_cast<const float4*>(buf + k * TILE + 4);
    const float w0 = W[k * HID + lane];
    const float w1 = W[k * HID + lane + 32];
    const float v[TILE] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int t = 0; t < TILE; ++t) {
      acc0[t] = fmaf(v[t], w0, acc0[t]);
      acc1[t] = fmaf(v[t], w1, acc1[t]);
    }
  }
}

// buf[j][t] = v{0,1}[t] for this lane's two columns
__device__ __forceinline__ void tile_store(float* buf, int lane,
                                           const float* v0, const float* v1) {
  float4* p0 = reinterpret_cast<float4*>(buf + lane * TILE);
  float4* p1 = reinterpret_cast<float4*>(buf + (lane + 32) * TILE);
  p0[0] = make_float4(v0[0], v0[1], v0[2], v0[3]);
  p0[1] = make_float4(v0[4], v0[5], v0[6], v0[7]);
  p1[0] = make_float4(v1[0], v1[1], v1[2], v1[3]);
  p1[1] = make_float4(v1[4], v1[5], v1[6], v1[7]);
}

// out = buf . W over the tile (zero-initialised accumulators)
__device__ __forceinline__ void tile_product(float* buf, const float* W,
                                             int lane, const float* in0,
                                             const float* in1, float* out0,
                                             float* out1) {
#pragma unroll
  for (int t = 0; t < TILE; ++t) {
    out0[t] = 0.0f;
    out1[t] = 0.0f;
  }
  __syncwarp();
  tile_store(buf, lane, in0, in1);
  __syncwarp();
  tile_matvec(buf, W, lane, out0, out1);
}

// Stage one.  Rows i in [0, min(n_rows, *limit)) (limit may be null), row i
// counted only where mask is null or mask[i] != 0.  A may be null: then
// only the column sums of B are formed (the matrix part is not written).
__global__ void __launch_bounds__(OUTER_THREADS)
outer_partials(const float* __restrict__ A, const float* __restrict__ B,
               const float* __restrict__ mask, const int* __restrict__ limit,
               int n_rows, float* __restrict__ part) {
  __shared__ __align__(16) float sa[OUTER_TR * HID];
  __shared__ __align__(16) float sb[OUTER_TR * HID];
  const int tid = threadIdx.x;
  const int k0 = (tid >> 4) * 4;
  const int j0 = (tid & 15) * 4;
  int end = n_rows;
  if (limit != nullptr) end = min(end, *limit);
  const int row0 = blockIdx.x * OUTER_ROWS;
  end = min(end, row0 + OUTER_ROWS);
  float acc[4][4], cs[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    cs[a] = 0.0f;
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
  }
  for (int base = row0; base < end; base += OUTER_TR) {
    for (int f = tid; f < OUTER_TR * HID; f += OUTER_THREADS) {
      const int i = base + f / HID;
      const int k = f % HID;
      const bool ok = i < end && (mask == nullptr || mask[i] != 0.0f);
      sb[f] = ok ? B[(size_t)i * HID + k] : 0.0f;
      if (A != nullptr) sa[f] = ok ? A[(size_t)i * HID + k] : 0.0f;
    }
    __syncthreads();
    for (int r = 0; r < OUTER_TR; ++r) {
      const float4 bv = *reinterpret_cast<const float4*>(sb + r * HID + j0);
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int b = 0; b < 4; ++b) cs[b] += b4[b];
      if (A != nullptr) {
        const float4 av = *reinterpret_cast<const float4*>(sa + r * HID + k0);
        const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(a4[a], b4[b], acc[a][b]);
      }
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.x * OUTER_W;
  if (A != nullptr) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) out[(k0 + a) * HID + j0 + b] = acc[a][b];
  }
  if (k0 == 0) {
#pragma unroll
    for (int b = 0; b < 4; ++b) out[HID * HID + j0 + b] = cs[b];
  }
}

// Stage two: dst = sum over blocks 0..n_blocks-1, in order.  mat (64x64)
// and col (64) may each be null.
__global__ void sum_partials(const float* __restrict__ part, int n_blocks,
                             float* __restrict__ mat, float* __restrict__ col) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= OUTER_W) return;
  float* dst = f < HID * HID ? mat : col;
  if (dst == nullptr) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += part[(size_t)b * OUTER_W + f];
  dst[f < HID * HID ? f : f - HID * HID] = s;
}

inline int outer_blocks(int n_rows) {
  return (n_rows + OUTER_ROWS - 1) / OUTER_ROWS;
}

// Both stages on `stream`; `part` holds outer_blocks(n_rows) partials.
inline void outer_sum(const float* A, const float* B, const float* mask,
                      const int* limit, int n_rows, float* part, float* mat,
                      float* col, cudaStream_t stream) {
  const int nb = outer_blocks(n_rows);
  if (nb > 0) {
    outer_partials<<<nb, OUTER_THREADS, 0, stream>>>(A, B, mask, limit,
                                                     n_rows, part);
  }
  sum_partials<<<(OUTER_W + 255) / 256, 256, 0, stream>>>(part, nb, mat, col);
}

}  // namespace
