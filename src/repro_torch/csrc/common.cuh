// Tile machinery shared by the backward kernels (edge_message_bwd.cu,
// virtual_message_bwd.cu).  Header only; each including file gets its own
// copy inside an anonymous namespace.
//
// * A tile is 64 rows (nodes or edge slots) x 64 features of f32 in shared
//   memory, row-major with an XOR swizzle of 16-byte granules
//   (`swz`): element (r, c) lives at r*64 + (c ^ h(r)), h(r) =
//   8 (r & 3) + (r & 4).  With it every fragment load of `tile_mma` --
//   A or B, plain or transposed -- hits 32 distinct banks, so a matrix and
//   its transpose are the same 16 KB, read in two layouts.
// * CTAs have 8 warps.  Warp w owns rows 16 (w & 3) .. +15 and columns
//   32 (w >> 2) .. +31 of every 64 x 64 product: four m16n8 accumulator
//   tiles, 16 floats a thread (`Frag`).  Lane (g = lane / 4, t = lane % 4)
//   holds rows 16 (w & 3) + g (+ 8) and columns 32 (w >> 2) + 8 jn + 2 t
//   (+ 1) of accumulator tile jn, the layout of mma.m16n8k8.
// * `tile_mma` runs the products on the tensor cores with
//   mma.sync.m16n8k8 in TF32, split three ways ("3xTF32"): each operand
//   a = a_hi + a_lo, both parts cut to TF32 by a bit mask, and
//   acc += a_lo b_hi + a_hi b_lo + a_hi b_hi.  The dropped a_lo b_lo term
//   and the cut of a_lo leave ~2^-21 of each product, so the products keep
//   f32 accuracy (a single TF32 pass keeps ~3 digits and misses the f32
//   gradient tolerance).  Every sum runs in a fixed order: the MMA's own
//   k order, k-steps in order, and the butterfly row / column sums below.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HID = 64;                  // every width of both pathways
constexpr int TR = 64;                   // rows of a tile
constexpr int TILE_F = TR * HID;         // floats of a tile
constexpr int THREADS = 256;             // 8 warps
constexpr unsigned FULL = 0xffffffffu;

// sigmoid with the fast exponential and division (relative error ~1e-6,
// far inside the gradient tolerance); 0 where exp(-u) overflows
__device__ __forceinline__ float sigm(float u) {
  return __fdividef(1.0f, 1.0f + __expf(-u));
}

// silu(u) = u s and d silu / du = s (1 + u (1 - s)), s = sigmoid(u), from
// one exponential
__device__ __forceinline__ void silu_both(float u, float& f, float& df) {
  const float s = sigm(u);
  f = u * s;
  df = s * (1.0f + u * (1.0f - s));
}

// offset of element (r, c) of a swizzled tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * HID + (c ^ (((r & 3) << 3) | (r & 4)));
}

// this thread's place in the warp tiling of a 64 x 64 product
struct Lane {
  int rb, ch, g, t;
  __device__ __forceinline__ int row(int e) const {
    return 16 * rb + g + 8 * (e >> 1);
  }
  __device__ __forceinline__ int col(int jn, int e) const {
    return 32 * ch + 8 * jn + 2 * t + (e & 1);
  }
};

__device__ __forceinline__ Lane lane_of() {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  return Lane{w & 3, w >> 2, l >> 2, l & 3};
}

typedef float Frag[4][4];

__device__ __forceinline__ void frag_zero(Frag& a) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.0f;
}

__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t h = __float_as_uint(a) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(a - __uint_as_float(h)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += op(A) . op(B) over k = 0..63 (3xTF32 tensor-core MMAs), with
// op(A)[m][k] = TA ? A[k][m] : A[m][k] and op(B)[k][n] = TB ? B[n][k] :
// B[k][n]; A and B are swizzled tiles.
template <bool TA, bool TB>
__device__ __forceinline__ void tile_mma(Frag& acc, const float* A,
                                         const float* B, const Lane& L) {
  // Offsets hoisted out of the k loop.  Row m & 7 = g for every row this
  // lane reads as a fixed row (m0, m0 + 8, n0 + 8 jn), and k & 7 = t or
  // t + 4 for every row it reads at k = kk + t (+ 4), so the swizzle of a
  // read splits into a per-lane constant and a per-step term: kk ^ (h & 24)
  // along a fixed row, kk * 64 down a fixed column.
  const int m0 = 16 * L.rb + L.g, n0 = 32 * L.ch + L.g;
  const int tk[2] = {L.t, L.t + 4};
  const int hg = ((L.g & 3) << 3) | (L.g & 4);
  int a_off[2][2], b_off[4][2];  // [row i or tile jn][k half]
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int ht = ((tk[j] & 3) << 3) | (tk[j] & 4);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      a_off[i][j] = TA ? tk[j] * HID + ((m0 + 8 * i) ^ ht)
                       : (m0 + 8 * i) * HID + (tk[j] ^ (hg & 4));
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
      b_off[jn][j] = TB ? (n0 + 8 * jn) * HID + (tk[j] ^ (hg & 4))
                        : tk[j] * HID + ((n0 + 8 * jn) ^ ht);
  }
#pragma unroll 2
  for (int kk = 0; kk < HID; kk += 8) {
    const int sa = TA ? kk * HID : (kk ^ (hg & 24));
    const int sb = TB ? (kk ^ (hg & 24)) : kk * HID;
    const float av[4] = {A[a_off[0][0] + sa], A[a_off[1][0] + sa],
                         A[a_off[0][1] + sa], A[a_off[1][1] + sa]};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(av[i], ah[i], al[i]);
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        split_tf32(B[b_off[jn][j] + sb], bh[jn][j], bl[jn][j]);
    // the three passes in turn over the four accumulator tiles, so that
    // consecutive MMAs are independent
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) mma_tf32(acc[jn], al, bh[jn]);
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) mma_tf32(acc[jn], ah, bl[jn]);
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) mma_tf32(acc[jn], ah, bh[jn]);
  }
}

// tile[r][c] = v at this thread's fragment positions
__device__ __forceinline__ void frag_store(float* tile, const Frag& v,
                                           const Lane& L) {
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(tile + swz(L.row(2 * h), L.col(jn, 0))) =
          make_float2(v[jn][2 * h], v[jn][2 * h + 1]);
}

// a row-major 64 x 64 matrix in device memory = v (a weight partial)
__device__ __forceinline__ void frag_store_global(float* dst, const Frag& v,
                                                  const Lane& L) {
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(dst + L.row(2 * h) * HID + L.col(jn, 0)) =
          make_float2(v[jn][2 * h], v[jn][2 * h + 1]);
}

// Row sums over this warp's 32 columns: red[ch * 64 + row] (caller syncs;
// the row's sum is red[row] + red[64 + row]).
__device__ __forceinline__ void frag_rowsum(const Frag& v, const Lane& L,
                                            float* red) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.0f;
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) s += v[jn][2 * h] + v[jn][2 * h + 1];
    s += __shfl_xor_sync(FULL, s, 1);
    s += __shfl_xor_sync(FULL, s, 2);
    if (L.t == 0) red[64 * L.ch + L.row(2 * h)] = s;
  }
}

// Column sums over this warp's 16 rows: red[rb * 64 + col] (caller syncs;
// the column's sum is red[col] + red[64 + col] + red[128 + col] +
// red[192 + col], in that order: `colsum4`).
__device__ __forceinline__ void frag_colsum(const Frag& v, const Lane& L,
                                            float* red) {
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = v[jn][e] + v[jn][e + 2];
      s += __shfl_xor_sync(FULL, s, 4);
      s += __shfl_xor_sync(FULL, s, 8);
      s += __shfl_xor_sync(FULL, s, 16);
      if (L.g == 0) red[64 * L.rb + L.col(jn, e)] = s;
    }
}

__device__ __forceinline__ float colsum4(const float* red, int j) {
  return ((red[j] + red[64 + j]) + red[128 + j]) + red[192 + j];
}

// Fill a swizzled tile from rows of a (rows x 64) array in device memory:
// tile row i <- src[idx(i)] for i < n_rows with idx(i) >= 0, else zeros.
// 16-byte loads, 16 threads a row.
template <typename Idx>
__device__ __forceinline__ void tile_gather(float* tile, const float* src,
                                            Idx idx) {
  for (int f = threadIdx.x; f < TR * HID / 4; f += blockDim.x) {
    const int i = f >> 4, q = (f & 15) * 4;
    const int r = idx(i);
    const float4 v = r >= 0 ? *reinterpret_cast<const float4*>(
                                  src + (size_t)r * HID + q)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(tile + swz(i, q)) = v;
  }
}

// Asynchronous 16-byte copy of a row-major 64 x 64 matrix into a swizzled
// tile (cp.async; the caller commits and waits).
__device__ __forceinline__ void tile_load_async(float* tile, const float* src) {
  for (int f = threadIdx.x; f < HID * HID / 4; f += blockDim.x) {
    const int i = f >> 4, q = (f & 15) * 4;
    const unsigned dst =
        (unsigned)__cvta_generic_to_shared(tile + swz(i, q));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src + i * HID + q));
  }
}

__device__ __forceinline__ void vec_load_async(float* dst, const float* src,
                                               int n) {
  for (int f = threadIdx.x; f < n; f += blockDim.x) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + f);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src + f));
  }
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// sum over b < n of src[b * stride], added in b order; eight loads in
// flight (the last kernels add the CTAs' partials with it)
__device__ __forceinline__ float sum_strided(const float* __restrict__ src,
                                             size_t stride, int n) {
  float s = 0.0f;
  int b = 0;
  for (; b + 8 <= n; b += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = src[(b + u) * stride];
#pragma unroll
    for (int u = 0; u < 8; ++u) s += v[u];
  }
  for (; b < n; ++b) s += src[b * stride];
  return s;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

inline size_t round4(size_t v) { return (v + 3) & ~size_t(3); }

}  // namespace
