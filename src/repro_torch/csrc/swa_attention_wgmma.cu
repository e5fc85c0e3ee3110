// Flash-style causal sliding-window attention for Hopper (sm_90a) in bf16,
// on the tensor cores (wgmma) with TMA staging.
//
//   o = softmax(mask(q k^T / sqrt(D))) v,   mask: k <= q (causal) and
//                                                 k >  q - window (windowed)
//
// Replaces the Pallas TPU kernel `swa_attention` (`_kernel`) of the JAX
// package's kernels/swa_attention.py for bf16 inputs; csrc/swa_attention.cu
// keeps f32.  Same contract as that kernel: q (B, S, H, DQK), k (B, T, KV,
// DQK), v (B, T, KV, DV) and o (B, S, H, DV), head h reading KV head
// h / (H / KV), any element strides that are multiples of 8 (TMA's 16-byte
// rule) per batch, position and head of each, (DQK, DV) in {(64, 64),
// (128, 128), (256, 256)} and MLA's (192, 128), any S, T >= 1 (T != S only
// with causal = 0: cross-attention over an encoder's states; keys >= T are
// masked), scale = 1 / sqrt(DQK) from the caller.  Scores, running max,
// normaliser and accumulator are f32; masked scores give p = 0 by a select;
// the output is acc / max(l, 1e-30), rounded to bf16 once.  Below, D is DQK
// where it counts Q and K columns and DV where it counts V and O columns: at
// (192, 128) S = Q K^T takes 12 k16 steps over three 64-column boxes, O =
// P V is wgmma n = 128, and shared memory holds Q (48 KB) and two stages of
// K (24 KB each) and V (16 KB each), 129 KB.
//
// Bound on an H100 (B = 1, S = 8,192, H = 16, KV = 8, D = 256): 4 D FLOP per
// visible (q, k) pair, 129 GFLOP for a 1,024 window and 550 GFLOP causal,
// i.e. 0.130 / 0.556 ms at the 989 TFLOP/s bf16 tensor-core rate, against
// 0.060 ms for the 201 MB of q, k, v and o: bound by operations.  The tensor
// work done is 6 D FLOP per pair of every whole 128 x 64 tile the band meets
// (Q K^T once, P V twice for the split P below), ~1.5-1.8x the bound's count.
//
// Design, against what held the f32 kernel (csrc/swa_attention.cu) at ~3 %
// of this bound:
// - Tensor cores instead of f32 FMA units.  S = Q K^T is
//   wgmma.m64n64k16 with both operands K-major in shared memory; P V is
//   wgmma.m64n{D}k16 with P from registers (the S accumulator of two n8
//   groups is exactly the A fragment of one k16 step) and V read MN-major
//   through the descriptor's transpose bit, so nothing is transposed.
// - bf16 P alone misses the kernel's tolerance against the f32 plain
//   version (one bf16 rounding of the output) by ~2x, so P is split:
//   P_hi = bf16(P), P_lo = bf16(P - P_hi), two P V products into one f32
//   accumulator; l sums the unrounded f32 P.
// - TMA instead of staging by hand: q, k and v stay bf16 in shared memory
//   (128B-swizzled, D / 64 boxes of 64 columns a tile), so Q (128 x D) and
//   a two-stage ring of K and V tiles (64 x D) fit 192 KB at D = 256.  A
//   producer warpgroup (one thread issuing TMA, 24 registers) runs ahead of
//   two consumer warpgroups (64 query rows each, 240 registers): the next
//   tile loads while this one is multiplied, and one warpgroup's softmax
//   overlaps the other's wgmma.  mbarriers (full / empty per stage) replace
//   the three __syncthreads a key block.
// - Only key blocks that meet the causal / window band are visited, per
//   warpgroup, and only blocks that cross the diagonal, the window's lower
//   edge or S are masked; keys >= S (zero-filled by TMA, score 0) are masked
//   there explicitly.
// - Grid (B * H, query blocks), query blocks in reverse, so the causal
//   layer's longest CTAs go first across all heads.
// - No atomics and a fixed summation order: a repeated run is bitwise equal.
#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;      // query rows per CTA, 64 per consumer warpgroup
constexpr int BK = 64;       // keys per block
constexpr int STAGES = 2;    // K / V ring depth
constexpr int THREADS = 384;  // producer + two consumer warpgroups
constexpr float NEG = -1e30f;  // the Pallas kernel's _NEG
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

template <int DQK, int DV>
struct Layout {
  static_assert(DV <= DQK, "the epilogue stages O in Q's tile");
  static constexpr uint32_t Q_BYTES = BQ * DQK * 2;
  static constexpr uint32_t K_BYTES = BK * DQK * 2;  // one stage of K
  static constexpr uint32_t V_BYTES = BK * DV * 2;   // one stage of V
  static constexpr uint32_t Q_CHUNK = BQ * 128;      // 64 columns of Q
  static constexpr uint32_t KV_CHUNK = BK * 128;     // 64 columns of K or V
  static constexpr uint32_t BARS = Q_BYTES + STAGES * (K_BYTES + V_BYTES);
  // 1 KB to align the tiles for the 128-byte swizzle, 9 mbarriers
  static constexpr uint32_t SMEM = 1024 + BARS + 9 * 8;
};

struct Params {
  void* o;
  int S, T, H, group;          // T: the keys' length; group = H / KV
  int causal, window;          // window <= 0: no window
  long long o_sb, o_ss, o_sh;  // element strides of o
  float scale_log2;            // log2(e) * scale
  // tensor-map axis of (head, position, batch) in q's, k's and v's maps
  int q_axis[3], k_axis[3], v_axis[3];
};

// ------------------------------------------------------------- PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits for the phase of parity `parity` to complete.  A wait of over ~10 s
// (a lost arrival) traps, so a fault fails the launch instead of hanging it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, const int (&c)[4]) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c[0]), "r"(c[1]),
      "r"(c[2]), "r"(c[3])
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of wgmma's registers across
// the asynchronous issue / wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// S[64 x 64] (+)= A B^T: A and B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O[64 x N] += A V for N = 64, 128, 256 (by the accumulator's size): A
// (64 x 16 bf16) in registers, V from shared memory read MN-major (the
// transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
swa_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Layout<DQK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - raw);
  const uint32_t sq = base;                      // Q: [DQK/64][BQ][64]
  const uint32_t sk = sq + L::Q_BYTES;           // K: [STAGES][DQK/64][BK][64]
  const uint32_t sv = sk + STAGES * L::K_BYTES;  // V: [STAGES][DV/64][BK][64]
  const uint32_t bars = base + L::BARS;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto k_empty = [&](int s) { return bars + 8u * (3 + s); };
  auto v_full = [&](int s) { return bars + 8u * (5 + s); };
  auto v_empty = [&](int s) { return bars + 8u * (7 + s); };

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, kvh = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  // the key blocks that meet the band of rows [q0, q0 + BQ)
  const int q_last = min(q0 + BQ, p.S) - 1;
  const int kb_lo = (p.window > 0 ? max(0, q0 - p.window + 1) : 0) / BK;
  const int kb_hi = (p.causal ? q_last : p.T - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);  // every consumer warp arrives
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int c[4];
      c[p.q_axis[0]] = h;
      c[p.q_axis[1]] = q0;
      c[p.q_axis[2]] = b;
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int j = 0; j < DQK / 64; ++j) {
        c[0] = 64 * j;
        tma_load(sq + j * L::Q_CHUNK, &tq, q_full, c);
      }
      int ck[4], cv[4];
      ck[p.k_axis[0]] = kvh;
      ck[p.k_axis[2]] = b;
      cv[p.v_axis[0]] = kvh;
      cv[p.v_axis[2]] = b;
      for (int kb = kb_lo, i = 0; kb <= kb_hi; ++kb, ++i) {
        const int s = i % STAGES;
        const uint32_t ph = (i / STAGES) & 1;
        ck[p.k_axis[1]] = kb * BK;
        cv[p.v_axis[1]] = kb * BK;
        mbar_wait(k_empty(s), ph ^ 1);
        mbar_expect_tx(k_full(s), L::K_BYTES);
        for (int j = 0; j < DQK / 64; ++j) {
          ck[0] = 64 * j;
          tma_load(sk + s * L::K_BYTES + j * L::KV_CHUNK, &tk, k_full(s), ck);
        }
        mbar_wait(v_empty(s), ph ^ 1);
        mbar_expect_tx(v_full(s), L::V_BYTES);
        for (int j = 0; j < DV / 64; ++j) {
          cv[0] = 64 * j;
          tma_load(sv + s * L::V_BYTES + j * L::KV_CHUNK, &tv, v_full(s), cv);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1, t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32, col = 2 * (lane % 4);
    const int r0 = q0 + 64 * cw;                // this warpgroup's rows
    const int row = r0 + 16 * warp + lane / 4;  // this thread's: row, row + 8
    // the key blocks that meet the band of this warpgroup's rows
    const int my_lo = (p.window > 0 ? max(0, r0 - p.window + 1) : 0) / BK;
    const int my_hi =
        r0 < p.S ? (p.causal ? min(r0 + 63, p.T - 1) : p.T - 1) / BK : -1;
    // accumulator: o[4j + e] is row (row + 8 (e / 2)), column 8j + col + e % 2
    float o[DV / 2], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    const uint32_t qa = sq + cw * 64 * 128;
    mbar_wait(q_full, 0);

    for (int kb = kb_lo, i = 0; kb <= kb_hi; ++kb, ++i) {
      const int s = i % STAGES;
      const uint32_t ph = (i / STAGES) & 1;
      const bool mine = kb >= my_lo && kb <= my_hi;
      const int k0 = kb * BK;
      // scores: sc[4j + e] is row (row + 8 (e / 2)), key k0 + 8j + col + e % 2
      float sc[32];
      mbar_wait(k_full(s), ph);
      if (mine) {
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] = 0.f;
        fence_regs(sc);
        wgmma_fence();
        const uint32_t kt = sk + s * L::K_BYTES;
#pragma unroll
        for (int kk = 0; kk < DQK / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;  // 16 columns into the chunk
          wgmma_ss_n64(sc, gmma_desc(qa + (kk / 4) * L::Q_CHUNK + off, 16, 1024),
                       gmma_desc(kt + (kk / 4) * L::KV_CHUNK + off, 16, 1024),
                       kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
      }
      if (lane == 0) mbar_arrive(k_empty(s));

      uint32_t p_hi[4][4], p_lo[4][4];
      if (mine) {
        // mask only blocks that cross the diagonal, the window's edge or S
        const bool edge = !(k0 + BK <= p.T &&
                            (!p.causal || k0 + BK - 1 <= r0) &&
                            (p.window <= 0 || k0 > r0 + 63 - p.window));
        uint32_t vis = FULL;
        float mx[2] = {NEG, NEG};
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          float x = sc[j] * p.scale_log2;
          if (edge) {
            const int kpos = k0 + 8 * (j / 4) + col + (j % 2);
            const int qpos = row + 8 * ((j / 2) % 2);
            const bool ok = kpos < p.T && (!p.causal || kpos <= qpos) &&
                            (p.window <= 0 || kpos > qpos - p.window);
            if (!ok) {
              vis &= ~(1u << j);
              x = NEG;
            }
          }
          sc[j] = x;
          mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], x);
        }
        float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[r], quad_max(mx[r]));
          alpha[r] = exp2f(m[r] - m_new);
          m[r] = m_new;
        }
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int r = (j / 2) % 2;
          sc[j] = (vis >> j) & 1u ? exp2f(sc[j] - m[r]) : 0.f;
          rs[r] += sc[j];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
        for (int j = 0; j < DV / 2; ++j) o[j] *= alpha[(j / 2) % 2];
        // A fragment of k16 step kk: n8 groups 2kk and 2kk + 1 of sc
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float a = sc[8 * kk + 2 * r], c = sc[8 * kk + 2 * r + 1];
            const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
            p_hi[kk][r] = bf16x2_bits(hi);
            p_lo[kk][r] = bf16x2_bits(__floats2bfloat162_rn(
                a - __low2float(hi), c - __high2float(hi)));
          }
      }

      mbar_wait(v_full(s), ph);
      if (mine) {
        fence_regs(o);
        wgmma_fence();
        const uint32_t vt = sv + s * L::V_BYTES;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // keys 16kk .. 16kk + 15: two 8-row groups of every 64-column chunk
          const uint64_t dv = gmma_desc(vt + kk * 16 * 128, L::KV_CHUNK, 1024);
          wgmma_rs(o, p_hi[kk], dv);
          wgmma_rs(o, p_lo[kk], dv);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      }
      if (lane == 0) mbar_arrive(v_empty(s));
    }

    // epilogue: o / max(l, 1e-30) in bf16 into this warpgroup's own Q rows
    // (XOR-swizzled 16-byte slots), then 16-byte stores of whole rows
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = fmaxf(quad_sum(l[r]), 1e-30f);
    uint8_t* stage = base_ptr + cw * 64 * 128;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rl = 16 * warp + lane / 4 + 8 * r;
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            o[4 * j + 2 * r] / l[r], o[4 * j + 2 * r + 1] / l[r]);
        *reinterpret_cast<__nv_bfloat162*>(
            stage + (j / 8) * L::Q_CHUNK + rl * 128 +
            (((j % 8) ^ (rl % 8)) * 16) + col * 2) = v;
      }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                        h * p.o_sh;
    for (int i = t; i < 64 * (DV / 8); i += 128) {
      const int rl = i / (DV / 8), g = i % (DV / 8);
      if (r0 + rl >= p.S) break;
      const uint4 v = *reinterpret_cast<const uint4*>(
          stage + (g / 8) * L::Q_CHUNK + rl * 128 + (((g % 8) ^ (rl % 8)) * 16));
      *reinterpret_cast<uint4*>(og + (long long)(r0 + rl) * p.o_ss + g * 8) = v;
    }
  }
}

// ------------------------------------------------------------------- host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 tensor map over (D, then head, position and batch in order of
// increasing stride) with boxes of 64 columns x `rows` positions; `axis`
// receives the map axis of (head, position, batch).  0 on success.
int make_map(CUtensorMap* map, const void* ptr, int d, int heads, int s,
             int b, long long s_head, long long s_pos, long long s_batch,
             int rows, int (&axis)[3]) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const long long size[3] = {heads, s, b}, stride[3] = {s_head, s_pos, s_batch};
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)  // stable insertion sort by stride
    for (int j = i; j > 0 && stride[order[j]] < stride[order[j - 1]]; --j) {
      const int tmp = order[j];
      order[j] = order[j - 1];
      order[j - 1] = tmp;
    }
  cuuint64_t dims[4] = {(cuuint64_t)d, 0, 0, 0}, strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1}, unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    axis[order[i]] = i + 1;
    dims[i + 1] = (cuuint64_t)size[order[i]];
    strides[i] = (cuuint64_t)stride[order[i]] * 2;
    if (order[i] == 1) box[i + 1] = (cuuint32_t)rows;
  }
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(ptr), dims, strides, box, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DQK, int DV>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const Params& p, int n_bh, int n_q_blocks, cudaStream_t stream) {
  const int smem = (int)Layout<DQK, DV>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      swa_wgmma_kernel<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  swa_wgmma_kernel<DQK, DV>
      <<<dim3(n_bh, n_q_blocks), THREADS, smem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

bool aligned(const void* ptr, long long a, long long b, long long c) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && a % 8 == 0 &&
         b % 8 == 0 && c % 8 == 0;
}

}  // namespace

// bf16 only.  Strides are in elements, multiples of 8, pointers 16-byte
// aligned; T != S only with causal = 0.
extern "C" int swa_attention_wgmma_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S, int T,
    int H, int KV, int DQK, int DV, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, float scale,
    void* stream_ptr) {
  const int n_q_blocks = (S + BQ - 1) / BQ;
  if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV != 0 ||
      n_q_blocks > 65535 || (causal && T != S) ||
      !aligned(q, q_sb, q_ss, q_sh) || !aligned(k, k_sb, k_ss, k_sh) ||
      !aligned(v, v_sb, v_ss, v_sh) || !aligned(o, o_sb, o_ss, o_sh))
    return (int)cudaErrorInvalidValue;
  const bool square = DQK == DV && (DQK == 64 || DQK == 128 || DQK == 256);
  if (!square && !(DQK == 192 && DV == 128)) return (int)cudaErrorInvalidValue;
  Params p{o, S, T, H, H / KV, causal, window, o_sb, o_ss, o_sh,
           scale * LOG2E, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}};
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, DQK, H, S, B, q_sh, q_ss, q_sb, BQ, p.q_axis);
  if (!err)
    err = make_map(&tk, k, DQK, KV, T, B, k_sh, k_ss, k_sb, BK, p.k_axis);
  if (!err)
    err = make_map(&tv, v, DV, KV, T, B, v_sh, v_ss, v_sb, BK, p.v_axis);
  if (err) return err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int bh = B * H;
  if (DQK == 64) return launch<64, 64>(tq, tk, tv, p, bh, n_q_blocks, stream);
  if (DQK == 128)
    return launch<128, 128>(tq, tk, tv, p, bh, n_q_blocks, stream);
  if (DQK == 192)
    return launch<192, 128>(tq, tk, tv, p, bh, n_q_blocks, stream);
  return launch<256, 256>(tq, tk, tv, p, bh, n_q_blocks, stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
