// Tile machinery shared by the FastEGNN kernels (edge_message.cu,
// edge_message_bwd.cu, virtual_message.cu, virtual_message_bwd.cu, and the
// identity gate's tile route in edge_identity.cu).  Header
// only; each including file gets its own copy inside an anonymous namespace.
//
// Everything is a template of the feature width W, 32 or 64: the kernels
// are compiled once for each, with every weight resident in shared
// memory.  A layer of another width is zero-padded up to the next of them
// by the caller (exact: a zero row or column adds +0 to every sum), and
// widths above 64 take the panel path of panel.cu, whose products are
// this file's at W = 64.
//
// * A row tile is 64 rows (nodes or edge slots) x W features of f32 in
//   shared memory, a weight tile W x W, both row-major with an XOR swizzle
//   of 16-byte granules (`swz`): element (r, c) lives at r*W + (c ^ h(r)),
//   h(r) = 8 (r & 3) + (r & 4) < 32.  With it every fragment load of
//   `tile_mma` -- A or B, plain or transposed -- hits 32 distinct banks, so
//   a matrix and its transpose are the same tile, read in two layouts.
// * CTAs have 8 warps.  Warp w owns rows 16 (w & 3) .. +15 and columns
//   (W/2) (w >> 2) .. +W/2-1 of every 64 x W product: W/16 m16n8
//   accumulator tiles, W/4 floats a thread (`Frag`).  Lane (g = lane / 4,
//   t = lane % 4) holds rows 16 (w & 3) + g (+ 8) and columns (W/2) (w >> 2)
//   + 8 jn + 2 t (+ 1) of accumulator tile jn, the layout of mma.m16n8k8.
//   A W x W product (a weight gradient, rows over the features) uses the
//   warps whose rows fall inside it.
// * `tile_mma` runs the products on the tensor cores with
//   mma.sync.m16n8k8 in TF32, split three ways ("3xTF32"): each operand
//   a = a_hi + a_lo, a_hi rounded to the nearest TF32 value and a_lo cut
//   to TF32 (`split_tf32`, tf32.cuh), and
//   acc += a_lo b_hi + a_hi b_lo + a_hi b_hi.
//   The dropped a_lo b_lo term and the cut of a_lo leave ~2^-21 of each
//   product, of either sign (cutting a_hi too would make every product a
//   little too small), so the products keep f32 accuracy; a single TF32
//   pass keeps ~3 digits and misses the f32 tolerances.  The tensor core
//   rounds each MMA's result toward zero: see STEP_SUM below.  Every sum
//   runs in a fixed order: the MMA's own k order, k-steps in order, and
//   the butterfly row / column sums below.
//   A row of a product depends on that row of A alone, wherever it sits
//   in the tile, so a per-edge result does not depend on how edges were
//   packed into tiles.
// * The bf16 mode (template parameter BF of every kernel; the reference's
//   `precision='bf16'`: matmul operands cast to bfloat16, products summed
//   in f32, DESIGN.md section 9.3): `tile_mma<..., true>` rounds each
//   operand to bf16 (`bf16_round`, tf32.cuh) as it reads it and runs ONE
//   TF32 MMA on those values.  A bf16 value is a TF32 value and the
//   product of two is exact in f32, so this is what a bf16 MMA with f32
//   accumulation computes; the fragments, the swizzle and STEP_SUM are the
//   f32 mode's.  The tiles stay f32 in shared memory: a tile read both as
//   an operand and elementwise (msg: rounded into msg.Wg1, f32 in the mh
//   sum) keeps its f32 values.  Vectors (biases, w1d, wg2) and
//   coordinates are rounded where they are loaded; the kernels round the
//   other elementwise values where the reference casts them.  The panel
//   path runs this mode.
// * The bf16 mode of #1, #2 (and their `node_proj`), #3, #4 and the
//   identity pair's projection and dh pass (edge_identity.cu) has tiles of
//   its own: bf16 in
//   shared memory (`Bf`), each value rounded once, as it is stored, under
//   a swizzle of 16-byte granules for 2-byte elements (`swz16`), read with
//   `ldmatrix` (`.trans` for the transposed operand layouts) into bf16
//   tensor-core products, mma.sync.m16n8k16 with f32
//   accumulation (`tile_mma_bf`): half the shared memory of the f32
//   tiles, one ldmatrix.x4 in place of eight 4-byte fragment loads, and
//   half the MMAs of the TF32 route's k8 shape.  The accumulator
//   fragments are the m16n8k8 ones above, so `frag_store`, the row and
//   column sums and STEP_SUM (per k16 step) are shared.
// * The edge pathway's pieces used by its forward and backward (and the
//   identity gate's tile route, edge_identity.cu): the node projection
//   `node_proj` (P = h.W1r, Q = h.W1s once per node; `padded_proj` for
//   widths zero-padded inside the kernel), `for_live_tiles`,
//   which packs the live slots of a slot range into 64-row tiles in slot
//   order, and the node passes' ordered segment sums of per-slot rows
//   (`segment_sum`).  The virtual pathway's: the per-channel vectors
//   `load_virtual_vecs` and the bf16 weight stacks `virtual_round_stacks`.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32.cuh"

namespace {

constexpr int TR = 64;                   // rows of a tile
constexpr int THREADS = 256;             // 8 warps
constexpr unsigned FULL = 0xffffffffu;

template <int W>
constexpr int RT = TR * W;  // floats of a row tile
template <int W>
constexpr int WT = W * W;   // floats of a weight tile
template <int W>
constexpr int JN = W / 16;  // accumulator tiles of a warp

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

// offset of element (r, c) of a swizzled tile of width W
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  return r * W + (c ^ (((r & 3) << 3) | (r & 4)));
}

// this thread's place in the warp tiling of a 64 x W product
struct Lane {
  int rb, ch, g, t;
  __device__ __forceinline__ int row(int e) const {
    return 16 * rb + g + 8 * (e >> 1);
  }
  template <int W>
  __device__ __forceinline__ int col(int jn, int e) const {
    return (W / 2) * ch + 8 * jn + 2 * t + (e & 1);
  }
};

__device__ __forceinline__ Lane lane_of() {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  return Lane{w & 3, w >> 2, l >> 2, l & 3};
}

template <int W>
using Frag = float[JN<W>][4];

template <int W>
__device__ __forceinline__ void frag_zero(Frag<W>& a) {
#pragma unroll
  for (int j = 0; j < JN<W>; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.0f;
}

// acc += op(A) . op(B) (3xTF32 tensor-core MMAs), with op(A)[m][k] = TA ?
// A[k][m] : A[m][k] and op(B)[k][n] = TB ? B[n][k] : B[k][n]; A and B are
// swizzled tiles of width W.  The products the kernels run: a row tile
// times a weight tile or its transpose (k over the W features), and a row
// tile's transpose times a row tile (TA: k over the 64 rows, a W x W
// result, which only the warps with 16 (w & 3) < W compute).
// STEP_SUM: each k-step's three MMAs start from zero and the step's sum
// joins acc by an f32 add.  The tensor core rounds an MMA's result toward
// zero, so the MMAs of a product into one accumulator leave every result
// a few ulp too small; a masked sum of thousands of them (the forwards'
// ms / dz sums) adds that bias up past the forward tolerance.  With
// STEP_SUM the round-to-nearest adds carry the running sum; it costs
// 4 W / 16 adds a k-step.
// BF: the bf16 mode (operands rounded to bf16, one TF32 MMA a k-step).
template <int W, bool TA, bool TB, bool STEP_SUM = false, bool BF = false>
__device__ __forceinline__ void tile_mma(Frag<W>& acc, const float* A,
                                         const float* B, const Lane& L) {
  constexpr int K = TA ? TR : W;
  if (TA && 16 * L.rb >= W) return;  // rows past a W x W result
  // Offsets hoisted out of the k loop.  Row m & 7 = g for every row this
  // lane reads as a fixed row (m0, m0 + 8, n0 + 8 jn), and k & 7 = t or
  // t + 4 for every row it reads at k = kk + t (+ 4), so the swizzle of a
  // read splits into a per-lane constant and a per-step term: kk ^ (h & 24)
  // along a fixed row, kk * W down a fixed column.
  const int m0 = 16 * L.rb + L.g, n0 = (W / 2) * L.ch + L.g;
  const int tk[2] = {L.t, L.t + 4};
  const int hg = ((L.g & 3) << 3) | (L.g & 4);
  int a_off[2][2], b_off[JN<W>][2];  // [row i or tile jn][k half]
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int ht = ((tk[j] & 3) << 3) | (tk[j] & 4);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      a_off[i][j] = TA ? tk[j] * W + ((m0 + 8 * i) ^ ht)
                       : (m0 + 8 * i) * W + (tk[j] ^ (hg & 4));
#pragma unroll
    for (int jn = 0; jn < JN<W>; ++jn)
      b_off[jn][j] = TB ? (n0 + 8 * jn) * W + (tk[j] ^ (hg & 4))
                        : tk[j] * W + ((n0 + 8 * jn) ^ ht);
  }
#pragma unroll 2
  for (int kk = 0; kk < K; kk += 8) {
    const int sa = TA ? kk * W : (kk ^ (hg & 24));
    const int sb = TB ? (kk ^ (hg & 24)) : kk * W;
    const float av[4] = {A[a_off[0][0] + sa], A[a_off[1][0] + sa],
                         A[a_off[0][1] + sa], A[a_off[1][1] + sa]};
    if (BF) {
      uint32_t ar[4], br[JN<W>][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) ar[i] = __float_as_uint(bf16_round(av[i]));
#pragma unroll
      for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          br[jn][j] = __float_as_uint(bf16_round(B[b_off[jn][j] + sb]));
      Frag<W> step;
      if (STEP_SUM) frag_zero<W>(step);
      float(&d)[JN<W>][4] = STEP_SUM ? step : acc;
#pragma unroll
      for (int jn = 0; jn < JN<W>; ++jn) mma_tf32(d[jn], ar, br[jn]);
      if (STEP_SUM) {
#pragma unroll
        for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[jn][e] += step[jn][e];
      }
      continue;
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(av[i], ah[i], al[i]);
    uint32_t bh[JN<W>][2], bl[JN<W>][2];
#pragma unroll
    for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        split_tf32(B[b_off[jn][j] + sb], bh[jn][j], bl[jn][j]);
    // the three passes in turn over the accumulator tiles, so that
    // consecutive MMAs are independent
    Frag<W> step;
    if (STEP_SUM) frag_zero<W>(step);
    float(&d)[JN<W>][4] = STEP_SUM ? step : acc;
#pragma unroll
    for (int jn = 0; jn < JN<W>; ++jn) mma_tf32(d[jn], al, bh[jn]);
#pragma unroll
    for (int jn = 0; jn < JN<W>; ++jn) mma_tf32(d[jn], ah, bl[jn]);
#pragma unroll
    for (int jn = 0; jn < JN<W>; ++jn) mma_tf32(d[jn], ah, bh[jn]);
    if (STEP_SUM) {
#pragma unroll
      for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jn][e] += step[jn][e];
    }
  }
}

// ------------------------------------------------------------ bf16 tiles
using Bf = __nv_bfloat16;

// offset of element (r, c) of a swizzled bf16 tile of width W: granule
// c / 8 (16 bytes) of row r XORed with the row's phase, r & 7 at W = 64
// (a row fills the 128 bytes of the 32 banks) and (r >> 1) & 3 at W = 32
// (two rows a line, the odd one in the upper half).  Eight consecutive
// rows (r0 a multiple of 8) then put one granule each in eight distinct
// bank groups: every `ldmatrix` phase of `tile_mma_bf`, plain or .trans,
// A or B, and every fragment store is free of bank conflicts.
template <int W>
__device__ __forceinline__ int swz16(int r, int c) {
  static_assert(W == 32 || W == 64, "bf16 tiles are 32 or 64 wide");
  const int ph = W == 64 ? (r & 7) : ((r >> 1) & 3);
  return r * W + ((((c >> 3) ^ ph) << 3) | (c & 7));
}

// bits of bf16(lo) | bf16(hi) << 16 (cvt.rn.bf16x2: ties to even, NaN kept)
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint2 bf16x4(float4 a) {
  return make_uint2(bf16x2(a.x, a.y), bf16x2(a.z, a.w));
}

// the two bf16 values of u (low half first), widened to f32 (exact)
__device__ __forceinline__ void bf16_widen(uint32_t u, float& lo, float& hi) {
  lo = __uint_as_float(u << 16);
  hi = __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const Bf* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const Bf* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += op(A) . op(B) on bf16 swizzled tiles of width W, as `tile_mma`
// (the same operand layouts, warp tiling, accumulator fragments and
// STEP_SUM, a step being k16) with one m16n8k16 bf16 MMA per accumulator
// tile and k-step: its products of bf16 values are exact, its sums f32.
// ldmatrix.x4 loads the A fragment (rows m, k-halves 0 / 8) and the B
// fragments of two accumulator tiles (n-tiles jn, jn + 1, k-halves 0 / 8);
// an operand stored k-major (op(A) = A^T, op(B) = B) takes .trans.
template <int W, bool TA, bool TB, bool STEP_SUM = false>
__device__ __forceinline__ void tile_mma_bf(Frag<W>& acc, const Bf* A,
                                            const Bf* B, const Lane& L) {
  constexpr int K = TA ? TR : W;
  if (TA && 16 * L.rb >= W) return;  // rows past a W x W result
  // lane l addresses row l & 7 of matrix l >> 3 of each x4 load
  const int l = threadIdx.x & 31, i8 = l & 7, hi = (l >> 3) & 1, q = l >> 4;
  const int mb = 16 * L.rb, nb = (W / 2) * L.ch;
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t a[4];
    if (TA)
      ldsm_x4_t(a, A + swz16<W>(kk + i8 + 8 * q, mb + 8 * hi));
    else
      ldsm_x4(a, A + swz16<W>(mb + i8 + 8 * hi, kk + 8 * q));
    uint32_t b[JN<W>][2];
#pragma unroll
    for (int p = 0; p < JN<W> / 2; ++p) {
      uint32_t r[4];
      const int n = nb + 8 * (2 * p + q);
      if (TB)
        ldsm_x4(r, B + swz16<W>(n + i8, kk + 8 * hi));
      else
        ldsm_x4_t(r, B + swz16<W>(kk + i8 + 8 * hi, n));
      b[2 * p][0] = r[0];
      b[2 * p][1] = r[1];
      b[2 * p + 1][0] = r[2];
      b[2 * p + 1][1] = r[3];
    }
    Frag<W> step;
    if (STEP_SUM) frag_zero<W>(step);
    float(&d)[JN<W>][4] = STEP_SUM ? step : acc;
#pragma unroll
    for (int jn = 0; jn < JN<W>; ++jn) mma_bf16(d[jn], a, b[jn][0], b[jn][1]);
    if (STEP_SUM) {
#pragma unroll
      for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jn][e] += step[jn][e];
    }
  }
}

// bf16 tile[r][c] = bf16(v) at this thread's fragment positions
template <int W>
__device__ __forceinline__ void frag_store_bf(Bf* tile, const Frag<W>& v,
                                              const Lane& L) {
#pragma unroll
  for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(tile + swz16<W>(L.row(2 * h),
                                                   L.col<W>(jn, 0))) =
          bf16x2(v[jn][2 * h], v[jn][2 * h + 1]);
}

// Fill a bf16 tile from rows of a (rows x W) f32 array in device memory,
// each value rounded: tile row i <- src[idx(i)] for i < nrows with
// idx(i) >= 0, else zeros (all threads; the caller syncs).  Two 16-byte
// loads and one 16-byte store a granule.  A weight tile is idx(i) = i.
template <int W, typename Idx>
__device__ __forceinline__ void tile_gather_bf(Bf* tile, const float* src,
                                               int nrows, Idx idx) {
  constexpr int G = W / 8;
  for (int f = threadIdx.x; f < nrows * G; f += blockDim.x) {
    const int i = f / G, q = (f % G) * 8;
    const int r = idx(i);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r >= 0) {
      const float4* p =
          reinterpret_cast<const float4*>(src + (size_t)r * W + q);
      const uint2 a = bf16x4(p[0]), b = bf16x4(p[1]);
      v = make_uint4(a.x, a.y, b.x, b.y);
    }
    *reinterpret_cast<uint4*>(tile + swz16<W>(i, q)) = v;
  }
}

template <int W>
__device__ __forceinline__ void tile_load_bf(Bf* tile, const float* src) {
  tile_gather_bf<W>(tile, src, W, [](int i) { return i; });
}

// tile[r][c] = v at this thread's fragment positions
template <int W>
__device__ __forceinline__ void frag_store(float* tile, const Frag<W>& v,
                                           const Lane& L) {
#pragma unroll
  for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(tile + swz<W>(L.row(2 * h),
                                               L.col<W>(jn, 0))) =
          make_float2(v[jn][2 * h], v[jn][2 * h + 1]);
}

// a row-major W x W matrix in device memory = v (a weight partial, the
// result of a TA product)
template <int W>
__device__ __forceinline__ void frag_store_global(float* dst,
                                                  const Frag<W>& v,
                                                  const Lane& L) {
  if (16 * L.rb >= W) return;
#pragma unroll
  for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(dst + L.row(2 * h) * W + L.col<W>(jn, 0)) =
          make_float2(v[jn][2 * h], v[jn][2 * h + 1]);
}

// Row sums over this warp's W/2 columns: red[ch * 64 + row] (caller syncs;
// the row's sum is red[row] + red[64 + row]).
template <int W>
__device__ __forceinline__ void frag_rowsum(const Frag<W>& v, const Lane& L,
                                            float* red) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.0f;
#pragma unroll
    for (int jn = 0; jn < JN<W>; ++jn) s += v[jn][2 * h] + v[jn][2 * h + 1];
    s += __shfl_xor_sync(FULL, s, 1);
    s += __shfl_xor_sync(FULL, s, 2);
    if (L.t == 0) red[TR * L.ch + L.row(2 * h)] = s;
  }
}

// Column sums over this warp's 16 rows: red[rb * 64 + col] (caller syncs;
// the column's sum is red[col] + red[64 + col] + red[128 + col] +
// red[192 + col], in that order: `colsum4`).
template <int W>
__device__ __forceinline__ void frag_colsum(const Frag<W>& v, const Lane& L,
                                            float* red) {
#pragma unroll
  for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = v[jn][e] + v[jn][e + 2];
      s += __shfl_xor_sync(FULL, s, 4);
      s += __shfl_xor_sync(FULL, s, 8);
      s += __shfl_xor_sync(FULL, s, 16);
      if (L.g == 0) red[TR * L.rb + L.col<W>(jn, e)] = s;
    }
}

__device__ __forceinline__ float colsum4(const float* red, int j) {
  return ((red[j] + red[TR + j]) + red[2 * TR + j]) + red[3 * TR + j];
}

// Fill a swizzled tile (f32, or bf16 with BF: `swz16`, each value rounded
// once) of W columns from rows of a (rows x ld) array of any width:
// tile row i < nrows <- src[idx(i) * ld + c] at columns c < cols, zeros
// at the columns past cols and in the rows with idx(i) < 0 (all threads;
// the caller syncs).  Element loads, two a thread-step: the tiles of
// layers narrower than W (zero-padded in the kernel: a zero row or column
// adds +0) and of weights (dh x h1) with idx(i) = i < dh ? i : -1.
template <int W, bool BF, typename Idx>
__device__ __forceinline__ void tile_gather_padded(void* tile,
                                                   const float* src,
                                                   int nrows, int ld,
                                                   int cols, Idx idx) {
  for (int f = threadIdx.x; f < nrows * W / 2; f += blockDim.x) {
    const int i = f / (W / 2), c = 2 * (f % (W / 2));
    const int r = idx(i);
    const float* row = src + (size_t)(r >= 0 ? r : 0) * ld;
    const float a = r >= 0 && c < cols ? row[c] : 0.0f;
    const float b = r >= 0 && c + 1 < cols ? row[c + 1] : 0.0f;
    if constexpr (BF)
      *reinterpret_cast<uint32_t*>(static_cast<Bf*>(tile) + swz16<W>(i, c)) =
          bf16x2(a, b);
    else
      *reinterpret_cast<float2*>(static_cast<float*>(tile) + swz<W>(i, c)) =
          make_float2(a, b);
  }
}

// Fill a swizzled row tile from rows of a (rows x W) array in device
// memory: tile row i <- src[idx(i)] for i < 64 with idx(i) >= 0, else
// zeros.  16-byte loads, W/4 threads a row.
// With BF the values are rounded to bf16 as they are stored.
template <int W, bool BF = false, typename Idx>
__device__ __forceinline__ void tile_gather(float* tile, const float* src,
                                            Idx idx) {
  constexpr int G = W / 4;
  for (int f = threadIdx.x; f < TR * G; f += blockDim.x) {
    const int i = f / G, q = (f % G) * 4;
    const int r = idx(i);
    float4 v = r >= 0 ? *reinterpret_cast<const float4*>(
                            src + (size_t)r * W + q)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    if (BF)
      v = make_float4(bf16_round(v.x), bf16_round(v.y), bf16_round(v.z),
                      bf16_round(v.w));
    *reinterpret_cast<float4*>(tile + swz<W>(i, q)) = v;
  }
}

// n floats of shared memory rounded to bf16 in place (all threads; the
// caller syncs before and after)
__device__ __forceinline__ void smem_round_bf16(float* p, int n) {
  for (int f = threadIdx.x; f < n; f += blockDim.x) p[f] = bf16_round(p[f]);
}

// Asynchronous 16-byte copy of a row-major W x W matrix into a swizzled
// weight tile (cp.async; the caller commits and waits).
template <int W>
__device__ __forceinline__ void tile_load_async(float* tile, const float* src) {
  constexpr int G = W / 4;
  for (int f = threadIdx.x; f < W * G; f += blockDim.x) {
    const int i = f / G, q = (f % G) * 4;
    const unsigned dst =
        (unsigned)__cvta_generic_to_shared(tile + swz<W>(i, q));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src + i * W + q));
  }
}

// The same for a row-major W x W matrix of bf16 values into a bf16 tile
// (`swz16`): one 16-byte copy a granule of 8.
template <int W>
__device__ __forceinline__ void tile_load_async_bf(Bf* tile, const Bf* src) {
  constexpr int G = W / 8;
  for (int f = threadIdx.x; f < W * G; f += blockDim.x) {
    const int i = f / G, q = (f % G) * 8;
    const unsigned dst =
        (unsigned)__cvta_generic_to_shared(tile + swz16<W>(i, q));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src + i * W + q));
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

// one asynchronous copy of 16 (4) bytes into shared memory, through L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
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

__host__ __device__ inline int n_tiles(int n) { return (n + TR - 1) / TR; }

// ------------------------------------------------------------ edge pathway
// The first layer splits per node: pre1 = ((P_r + Q_s) + d2 w1d) + b1 with
// P = h.W1r and Q = h.W1s.

// the length of the equal share of the live slot range [0, live_end) that
// each of `n_ctas` edge CTAs starts from
__device__ __forceinline__ int slot_share(int live_end, int n_ctas) {
  return max(1, (live_end + n_ctas - 1) / n_ctas);
}

template <int W, bool BF>
constexpr int PROJ_SMEM_FLOATS = (BF ? 1 : 2) * (RT<W> + 2 * WT<W>) / 2;

// The CSR by-products of the 64 nodes of node tile t, written by a CTA of
// THREADS (t = blockIdx.x when a CTA takes a 64-node tile): rowof[s] = the
// receiver row of every slot s of their CSR rows.  If `ctarow` is given,
// also the rows of a forward's `n_ctas`
// edge CTAs: ctarow[b] (0 < b < n_ctas) is the first row whose CSR
// segment starts at or after b * slot_share(indptr[N], n_ctas), else N;
// ctarow[0] = 0, ctarow[n_ctas] = N.  CTA b owns rows [ctarow[b],
// ctarow[b + 1]) -- whole rows, every row once, the last CTA also the
// empty rows at the end.  Row r writes the entries b in (c(r - 1), c(r)],
// c(r) = min(indptr[r] / share, n_ctas - 1), c(-1) = -1; row N writes
// (c(N - 1), n_ctas].
__device__ __forceinline__ void csr_rows(const int* __restrict__ indptr,
                                         int* __restrict__ rowof,
                                         int* __restrict__ ctarow,
                                         int n_nodes, int n_ctas, int t) {
  const int node0 = t * TR;
  // warp w: rows node0 + 8 w .. + 7; lane l <= 8 holds indptr[node0 + 8 w + l]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = node0 + 8 * warp;
  const int ip = lane <= 8 && r0 + lane <= n_nodes ? indptr[r0 + lane] : 0;
#pragma unroll 1
  for (int k = 0; k < 8; ++k) {
    const int beg = __shfl_sync(FULL, ip, k);
    const int end = __shfl_sync(FULL, ip, k + 1);
    if (r0 + k < n_nodes)
      for (int s = beg + lane; s < end; s += 32) rowof[s] = r0 + k;
  }
  if (ctarow != nullptr) {
    const int share = slot_share(indptr[n_nodes], n_ctas);
    const int hi = t == n_tiles(n_nodes) - 1 ? n_nodes + 1 : node0 + TR;
    for (int r = node0 + threadIdx.x; r < hi; r += blockDim.x) {
      const int lo = r == 0 ? -1 : min(indptr[r - 1] / share, n_ctas - 1);
      const int up =
          r == n_nodes ? n_ctas : min(indptr[r] / share, n_ctas - 1);
      for (int b = lo + 1; b <= up; ++b) ctarow[b] = r;
    }
  }
}

// One CTA per 64 nodes: P = h.W1r, Q = h.W1s for them (3xTF32 tile
// products; bf16: on bf16 tiles, `tile_mma_bf`), and their CSR
// by-products (`csr_rows`: rowof, and ctarow if given).
template <int W, bool BF>
__global__ void __launch_bounds__(THREADS)
node_proj(const float* __restrict__ h, const float* __restrict__ w1r,
          const float* __restrict__ w1s, const int* __restrict__ indptr,
          float* __restrict__ P, float* __restrict__ Q,
          int* __restrict__ rowof, int* __restrict__ ctarow, int n_nodes,
          int n_ctas) {
  extern __shared__ float4 smem4[];
  float* tH = reinterpret_cast<float*>(smem4);
  float* sWr = tH + RT<W>;
  float* sWs = sWr + WT<W>;
  Bf* bH = reinterpret_cast<Bf*>(smem4);  // bf16: the same three tiles
  Bf* bWr = bH + RT<W>;
  Bf* bWs = bWr + WT<W>;
  const int node0 = blockIdx.x * TR;
  auto node = [&](int i) { return node0 + i < n_nodes ? node0 + i : -1; };
  if constexpr (BF) {
    tile_load_bf<W>(bWr, w1r);
    tile_load_bf<W>(bWs, w1s);
    tile_gather_bf<W>(bH, h, TR, node);
  } else {
    tile_load_async<W>(sWr, w1r);
    tile_load_async<W>(sWs, w1s);
    async_commit();
    tile_gather<W>(tH, h, node);
  }
  csr_rows(indptr, rowof, ctarow, n_nodes, n_ctas, blockIdx.x);
  if (!BF) async_wait_all();
  __syncthreads();
  const Lane L = lane_of();
  float* dst[2] = {P, Q};
  const float* Wk[2] = {sWr, sWs};
  const Bf* bWk[2] = {bWr, bWs};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    Frag<W> a;
    frag_zero<W>(a);
    if constexpr (BF)
      tile_mma_bf<W, false, false>(a, bH, bWk[k], L);
    else
      tile_mma<W, false, false>(a, tH, Wk[k], L);
#pragma unroll
    for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int i = node0 + L.row(2 * h2);
        if (i < n_nodes)
          *reinterpret_cast<float2*>(dst[k] + (size_t)i * W +
                                     L.col<W>(jn, 0)) =
              make_float2(a[jn][2 * h2], a[jn][2 * h2 + 1]);
      }
  }
}

// P = h.W1r, Q = h.W1s for the layers of any width up to W (the identity
// gate's projection, edge_identity.cu): one CTA per 64 nodes, h (n x dh)
// and the weights (dh x h1) zero-padded to W inside the kernel, P and Q
// written as rows of ld floats (ld = h1, or W: zeros past h1).  3xTF32
// tile products; bf16: on bf16 tiles (`tile_mma_bf`), each operand
// rounded once as stored.  node_proj's products, and its CSR by-products
// if `rowof` is given (`csr_rows`).  vec (h and the weights 16-byte
// aligned): at dh = W node_proj's 16-byte loads of h, at dh = h1 = W its
// weight loads (cp.async in f32).
template <int W, bool BF>
constexpr int PAD_PROJ_SMEM_FLOATS = (RT<W> + 2 * WT<W>) / (BF ? 2 : 1);

template <int W, bool BF>
__global__ void __launch_bounds__(THREADS)
padded_proj(const float* __restrict__ h, const float* __restrict__ w1r,
            const float* __restrict__ w1s, float* __restrict__ P,
            float* __restrict__ Q, int n_nodes, int dh, int h1, int ld,
            int vec, const int* __restrict__ indptr, int* __restrict__ rowof,
            int* __restrict__ ctarow, int n_ctas) {
  extern __shared__ float4 smem4[];
  using T = std::conditional_t<BF, Bf, float>;
  T* tH = reinterpret_cast<T*>(smem4);
  T* sW[2] = {tH + RT<W>, tH + RT<W> + WT<W>};
  const int node0 = blockIdx.x * TR;
  const float* src[2] = {w1r, w1s};
  const bool full_w = vec && dh == W && h1 == W;
  if (full_w && !BF) {
    tile_load_async<W>(reinterpret_cast<float*>(sW[0]), w1r);
    tile_load_async<W>(reinterpret_cast<float*>(sW[1]), w1s);
    async_commit();
  }
  auto node = [&](int i) { return node0 + i < n_nodes ? node0 + i : -1; };
  if (vec && dh == W) {
    if constexpr (BF)
      tile_gather_bf<W>(tH, h, TR, node);
    else
      tile_gather<W>(tH, h, node);
  } else {
    tile_gather_padded<W, BF>(tH, h, TR, dh, dh, node);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (full_w && BF)
      tile_load_bf<W>(reinterpret_cast<Bf*>(sW[k]), src[k]);
    else if (!full_w)
      tile_gather_padded<W, BF>(sW[k], src[k], W, h1, h1,
                                [&](int i) { return i < dh ? i : -1; });
  }
  if (rowof != nullptr)
    csr_rows(indptr, rowof, ctarow, n_nodes, n_ctas, blockIdx.x);
  if (full_w && !BF) async_wait_all();
  __syncthreads();
  const Lane L = lane_of();
  float* dst[2] = {P, Q};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    Frag<W> a;
    frag_zero<W>(a);
    if constexpr (BF)
      tile_mma_bf<W, false, false>(a, tH, sW[k], L);
    else
      tile_mma<W, false, false>(a, tH, sW[k], L);
#pragma unroll
    for (int jn = 0; jn < JN<W>; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = node0 + L.row(e), c = L.col<W>(jn, e);
        if (i < n_nodes && c < ld)
          dst[k][(size_t)i * ld + c] = c < h1 ? a[jn][e] : 0.0f;
      }
  }
}

// The queue of live slots: slot, receiver row, sender and mask of each,
// `pend` entries apiece (PEND for `for_live_tiles`, PEND_AHEAD for
// `for_live_tiles_ahead`), and the per-warp counts of the block-wide scan.
constexpr int PEND = TR + THREADS;
constexpr int PEND_AHEAD = 2 * TR + THREADS;
constexpr int queue_words(int pend) { return 4 * pend + THREADS / 32; }
constexpr int QUEUE_WORDS = queue_words(PEND);

struct LiveQueue {
  int *slot, *row, *snd;
  float* em;
  int* wcount;
  __device__ explicit LiveQueue(int* base, int pend = PEND)
      : slot(base), row(base + pend), snd(base + 2 * pend),
        em(reinterpret_cast<float*>(base + 3 * pend)),
        wcount(base + 4 * pend) {}
};

// The live slots (em != 0) of [base, min(base + THREADS, end)) join the
// queue behind its `cnt` entries, in slot order (a block-wide ballot
// scan); returns how many joined.  Every thread calls it; it ends synced.
__device__ __forceinline__ int queue_live(const float* __restrict__ em,
                                          const int* __restrict__ rowof,
                                          const int* __restrict__ snd,
                                          int base, int end, int cnt,
                                          const LiveQueue& q) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slot = base + tid;
  const float e = slot < end ? em[slot] : 0.0f;
  const bool live = e != 0.0f;
  const unsigned m = __ballot_sync(FULL, live);
  if (lane == 0) q.wcount[warp] = __popc(m);
  __syncthreads();
  int off = cnt, total = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    off += w < warp ? q.wcount[w] : 0;
    total += q.wcount[w];
  }
  if (live) {
    const int k = off + __popc(m & ((1u << lane) - 1u));
    q.slot[k] = slot;
    q.row[k] = rowof[slot];
    q.snd[k] = snd[slot];
    q.em[k] = e;
  }
  __syncthreads();
  return total;
}

// The queue's first k of its cnt entries leave; the rest (at most
// PER * THREADS) move up.  Every thread calls it; it ends synced.
template <int PER>
__device__ __forceinline__ void queue_drop(const LiveQueue& q, int k,
                                           int cnt) {
  const int tid = threadIdx.x, rest = cnt - k;
  int v0[PER], v1[PER], v2[PER];
  float v3[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = tid + u * THREADS;
    v0[u] = v1[u] = v2[u] = 0;
    v3[u] = 0.0f;
    if (i < rest) {
      v0[u] = q.slot[k + i];
      v1[u] = q.row[k + i];
      v2[u] = q.snd[k + i];
      v3[u] = q.em[k + i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = tid + u * THREADS;
    if (i < rest) {
      q.slot[i] = v0[u];
      q.row[i] = v1[u];
      q.snd[i] = v2[u];
      q.em[i] = v3[u];
    }
  }
  __syncthreads();
}

// tile(cnt) over the live slots (em != 0) of [beg, end), in slot order:
// THREADS slots at a time join the queue (`queue_live`); whenever 64 are
// queued, tile(64) takes the first 64 and the rest move up; tile(cnt)
// takes the last cnt < 64.  Every thread of the CTA calls it; `tile` must
// end with a __syncthreads().
template <typename Tile>
__device__ __forceinline__ void for_live_tiles(
    const float* __restrict__ em, const int* __restrict__ rowof,
    const int* __restrict__ snd, int beg, int end, const LiveQueue& q,
    Tile&& tile) {
  int cnt = 0;  // queued live slots (the same on every thread)
  for (int base = beg; base < end; base += THREADS) {
    cnt += queue_live(em, rowof, snd, base, end, cnt, q);
    while (cnt >= TR) {
      tile(TR);
      queue_drop<1>(q, TR, cnt);
      cnt -= TR;
    }
  }
  if (cnt > 0) tile(cnt);
}

// for_live_tiles with one tile of lookahead (a queue of PEND_AHEAD): a
// tile runs once 2 x 64 slots are queued or the range is done, as
// tile(cnt, nxt) over the first cnt entries, while entries [64, 64 + nxt)
// are the next tile's (nxt = 0: none), so that `tile` can start the next
// tile's gathers, fetch(64, nxt), as soon as its own have been read;
// fetch(0, cnt) starts the first tile's.  The tiles, and the slots of
// each, are for_live_tiles' (the same slots in the same order).
template <typename Fetch, typename Tile>
__device__ __forceinline__ void for_live_tiles_ahead(
    const float* __restrict__ em, const int* __restrict__ rowof,
    const int* __restrict__ snd, int beg, int end, const LiveQueue& q,
    Fetch&& fetch, Tile&& tile) {
  int cnt = 0;
  bool fetched = false;  // the first tile's gathers are in flight
  auto take = [&](int c) {
    if (!fetched) fetch(0, c);
    const int nxt = min(cnt - c, TR);
    tile(c, nxt);
    fetched = nxt > 0;
    queue_drop<2>(q, c, cnt);
    cnt -= c;
  };
  for (int base = beg; base < end; base += THREADS) {
    cnt += queue_live(em, rowof, snd, base, end, cnt, q);
    while (cnt >= 2 * TR) take(TR);
  }
  while (cnt > 0) take(min(cnt, TR));
}

// Columns (W/8) gl .. (W/8) gl + W/8 - 1 of row s of a (rows x W) array
// of f32 or bf16 (widened, exactly), or zeros if !ok: one 16-byte load
// (bf16 at W = 32: 8 bytes) for every four (eight) of them.
template <int W, typename T>
__device__ __forceinline__ void row_cols(const T* __restrict__ a, int s,
                                         bool ok, int gl,
                                         float (&v)[W / 8]) {
  const size_t off = (size_t)(ok ? s : 0) * W + (W / 8) * gl;
  if constexpr (std::is_same<T, float>::value) {
    const float4* row = reinterpret_cast<const float4*>(a + off);
#pragma unroll
    for (int k = 0; k < W / 32; ++k) {
      const float4 t = ok ? row[k] : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * k] = t.x;
      v[4 * k + 1] = t.y;
      v[4 * k + 2] = t.z;
      v[4 * k + 3] = t.w;
    }
  } else {
    uint32_t u[W / 16];
    if constexpr (W == 64) {
      const uint4 t = ok ? *reinterpret_cast<const uint4*>(a + off)
                         : make_uint4(0u, 0u, 0u, 0u);
      u[0] = t.x;
      u[1] = t.y;
      u[2] = t.z;
      u[3] = t.w;
    } else {
      const uint2 t = ok ? *reinterpret_cast<const uint2*>(a + off)
                         : make_uint2(0u, 0u);
      u[0] = t.x;
      u[1] = t.y;
    }
#pragma unroll
    for (int k = 0; k < W / 16; ++k) bf16_widen(u[k], v[2 * k], v[2 * k + 1]);
  }
}

// A group of 8 lanes (lane gl owns columns (W/8) gl .. (W/8) gl + W/8 - 1)
// adds, in p order, the g_pre1 rows of the live slots s(p), p in [p0, p1)
// -- s(p) = p, or perm[p] -- into acc, the rows of X (if ROW2) into acc2,
// and lanes gl < 3 add sign * g_rel[gl] into d.  Eight masks are read at
// once and four rows are in flight.  The rows are f32, or bf16 (T = Bf).
template <int W, bool PERM, bool ROW2, typename T>
__device__ __forceinline__ void segment_sum(
    const int* __restrict__ perm, const float* __restrict__ em,
    const T* __restrict__ GPRE1, const float* __restrict__ GREL,
    const T* __restrict__ X, int p0, int p1, int gl, int grp,
    float sign, float (&acc)[W / 8], float (&acc2)[W / 8], float& d) {
  constexpr int C = W / 8;  // columns a lane
  const unsigned gm = 0xffu << (8 * grp);
  for (int b = p0; b < p1; b += 8) {
    const int p = b + gl;
    const int s = p < p1 ? (PERM ? perm[p] : p) : 0;
    const bool ok = p < p1 && em[s] != 0.0f;
    unsigned m = (__ballot_sync(gm, ok) >> (8 * grp)) & 0xffu;
    while (m) {
      int sl[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int v = __shfl_sync(gm, s, 8 * grp + (m ? __ffs(m) - 1 : 0));
        sl[u] = m ? v : -1;
        m &= m - 1;
      }
      float v[4][C], v2[ROW2 ? 4 : 1][C];
      float g[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        row_cols<W>(GPRE1, sl[u], sl[u] >= 0, gl, v[u]);
        if (ROW2) row_cols<W>(X, sl[u], sl[u] >= 0, gl, v2[ROW2 ? u : 0]);
        g[u] = sl[u] >= 0 && gl < 3 ? GREL[(size_t)sl[u] * 4 + gl] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (sl[u] >= 0) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            acc[c] += v[u][c];
            if (ROW2) acc2[c] += v2[ROW2 ? u : 0][c];
          }
          d += sign * g[u];
        }
    }
  }
}

// --------------------------------------------------------- virtual pathway
// The seven per-channel vectors, in this order
constexpr int NVEC = 7;
enum { V_W1D = 0, V_C1, V_B2, V_BG1, V_WG2, V_BZ1, V_WZ2 };

// dst[v * W + j] = vector v of channel c (cp.async; the caller commits)
template <int W>
__device__ __forceinline__ void load_virtual_vecs(
    float* dst, int c, const float* w1d, const float* c1, const float* b2,
    const float* bg1, const float* wg2, const float* bz1, const float* wz2) {
  const float* src[NVEC] = {w1d, c1, b2, bg1, wg2, bz1, wz2};
#pragma unroll
  for (int v = 0; v < NVEC; ++v)
    vec_load_async(dst + v * W, src[v] + (size_t)c * W, W);
}

// The weight tiles of a virtual channel, in the order of the bf16 stacks
enum { W_1H = 0, W_2, W_G1, W_Z1, W_N };

// The bf16 mode's weight stacks rounded once a call (virtual_message.cu,
// virtual_message_bwd.cu): wbf[c][k] = bf16 of channel c's W1h, W2, Wg1,
// Wz1 (k in that order, W x W each), so that the kernels stream 2-byte
// tiles by cp.async straight into their bf16 tiles.
template <int W>
__global__ void __launch_bounds__(THREADS)
virtual_round_stacks(const float* __restrict__ w1h,
                     const float* __restrict__ w2,
                     const float* __restrict__ wg1,
                     const float* __restrict__ wz1, Bf* __restrict__ wbf,
                     int n_chan) {
  constexpr int WW = W * W;
  const float* src[W_N] = {w1h, w2, wg1, wz1};
  const int n4 = n_chan * W_N * WW / 4;
  for (int f = blockIdx.x * blockDim.x + threadIdx.x; f < n4;
       f += gridDim.x * blockDim.x) {
    const int e = 4 * f, c = e / (W_N * WW), k = (e / WW) % W_N;
    const float4 v =
        *reinterpret_cast<const float4*>(src[k] + c * WW + e % WW);
    *reinterpret_cast<uint2*>(wbf + e) = bf16x4(v);
  }
}

template <int W>
cudaError_t launch_round_stacks(const float* w1h, const float* w2,
                                const float* wg1, const float* wz1, Bf* wbf,
                                int n_chan, cudaStream_t stream) {
  const int n4 = n_chan * W_N * W * W / 4;
  virtual_round_stacks<W><<<min((n4 + THREADS - 1) / THREADS, 1024), THREADS,
                            0, stream>>>(w1h, w2, wg1, wz1, wbf, n_chan);
  return cudaGetLastError();
}

// the floats of the bf16 stacks of n_chan channels (half a float an
// element)
inline long long round_stacks_floats(int n_chan, int width) {
  return (long long)n_chan * W_N * width * width / 2;
}

// Calls fn(w, bf) with w = std::integral_constant<int, W> for the compiled
// width W == width (32 or 64) and bf = std::integral_constant<bool, BF>
// for the precision (bf16 != 0: the bf16 mode); cudaErrorInvalidValue for
// any other width (the host entry points' dispatch)
template <typename Fn>
int with_width(int width, int bf16, Fn&& fn) {
  auto at = [&](auto bf) {
    if (width == 32) return fn(std::integral_constant<int, 32>(), bf);
    if (width == 64) return fn(std::integral_constant<int, 64>(), bf);
    return (int)cudaErrorInvalidValue;
  };
  return bf16 ? at(std::true_type()) : at(std::false_type());
}

}  // namespace
