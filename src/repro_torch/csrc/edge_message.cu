// Real-real edge pathway forward (Eq. 3 + the real parts of Eqs. 6-7) for
// Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel `edge_pathway_fused` (`_edge_kernel`) of
// the JAX package's kernels/edge_message.py.  It computes the same
// function, not the same blocks: the TPU kernel regrouped edges into
// (receiver-window x sender-window) bands and gathered/scattered with
// one-hot matmuls on the MXU; here the layout is a receiver-sorted CSR
// (`indptr`, N+1 row offsets into the slot arrays) and a warp owns one
// receiver row at a time.
//
// Per receiver row r (one warp, rows strided over the grid):
//   A      = h_r . W1r                                    (once per row)
//   per live slot e in [indptr[r], indptr[r+1]) with em[e] != 0, in slot order:
//     d2   = |x_r - x_s|^2
//     msg  = SiLU(A + h_s . W1s + d2 * w1d + b1) . W2 + b2
//     mh  += msg * em ;  deg += em
//     gate = clip(SiLU(msg . Wg1 + bg1) . wg2, -clamp, clamp)   (gate 'mlp')
//     dx  += rel * gate * em   (rel = x_r - x_s, or rel / (|rel| + 1))
//   mh /= max(deg, 1) ; dx /= max(deg, 1)
// Slots with em == 0 (padding, Verlet candidates outside r, dropped edges)
// are skipped: they would add exact zeros.  Nothing of size E x 64 reaches
// device memory, the sums run in slot order with no atomics, so repeated
// runs are bitwise equal and independent of how many masked slots a row has.
//
// Tiling: the live slots of a row are compacted with a warp ballot into
// tiles of TE = 8 edges.  A tile's 64-wide input vectors sit in a per-warp
// shared buffer laid out [k][t]; each lane owns output columns j = lane and
// j = lane + 32, so one 64x64 matvec over the tile costs 64 x (two
// broadcast float4 reads + two weight reads) for 16 FMAs per lane.  W1r,
// W1s, W2 and Wg1 (4 x 16 KB) and the bias rows stay in shared memory for
// the life of the CTA.
//
// Bound on an H100: the function needs 2 dense 64x64 matvecs in f32 per
// live edge (.W2 and .Wg1: 16,384 FLOP) plus 2 per node (h.W1r and h.W1s,
// each computable once per node), against a 256-byte gather of h_s per
// edge.  That is ~64 FLOP per byte, above the f32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/B), so the bound is f32 operations on the CUDA
// cores.  This kernel does more than the bound counts: it recomputes
// h_s.W1s per edge (a third matvec) instead of in a per-node pre-pass, and
// its shared-memory reads are what limit the FMA rate.
#include <cuda_runtime.h>

namespace {

constexpr int HID = 64;    // Dh = H1 = M = HG
constexpr int TE = 8;      // live edges per warp tile
constexpr int WARPS = 8;   // warps per CTA
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_FLOATS = 4 * HID * HID + 5 * HID + WARPS * HID * TE;

__device__ __forceinline__ float silu(float u) { return u / (1.0f + expf(-u)); }

// acc{0,1}[t] += sum_k buf[k][t] * W[k][j], j = lane / lane + 32
__device__ __forceinline__ void tile_matvec(const float* __restrict__ buf,
                                            const float* __restrict__ W,
                                            int lane, float* acc0, float* acc1) {
#pragma unroll 8
  for (int k = 0; k < HID; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(buf + k * TE);
    const float4 b = *reinterpret_cast<const float4*>(buf + k * TE + 4);
    const float w0 = W[k * HID + lane];
    const float w1 = W[k * HID + lane + 32];
    const float v[TE] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int t = 0; t < TE; ++t) {
      acc0[t] = fmaf(v[t], w0, acc0[t]);
      acc1[t] = fmaf(v[t], w1, acc1[t]);
    }
  }
}

// buf[j][t] = v{0,1}[t] for this lane's two columns
__device__ __forceinline__ void tile_store(float* buf, int lane,
                                           const float* v0, const float* v1) {
  float4* p0 = reinterpret_cast<float4*>(buf + lane * TE);
  float4* p1 = reinterpret_cast<float4*>(buf + (lane + 32) * TE);
  p0[0] = make_float4(v0[0], v0[1], v0[2], v0[3]);
  p0[1] = make_float4(v0[4], v0[5], v0[6], v0[7]);
  p1[0] = make_float4(v1[0], v1[1], v1[2], v1[3]);
  p1[1] = make_float4(v1[4], v1[5], v1[6], v1[7]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  return v;  // identical bits on every lane (each step adds commuted pairs)
}

__global__ void __launch_bounds__(WARPS * 32, 2)
edge_fwd_kernel(const float* __restrict__ x, const float* __restrict__ h,
                const int* __restrict__ snd, const float* __restrict__ em,
                const int* __restrict__ indptr,
                const float* __restrict__ w1r, const float* __restrict__ w1s,
                const float* __restrict__ w1d, const float* __restrict__ b1,
                const float* __restrict__ w2, const float* __restrict__ b2,
                const float* __restrict__ wg1, const float* __restrict__ bg1,
                const float* __restrict__ wg2,
                float* __restrict__ dx, float* __restrict__ mh,
                float* __restrict__ deg,
                int n_nodes, int gate_mlp, int rel_inv1p, float clamp) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sW1r = smem;
  float* sW1s = sW1r + HID * HID;
  float* sW2 = sW1s + HID * HID;
  float* sWg1 = sW2 + HID * HID;
  float* sw1d = sWg1 + HID * HID;
  float* sb1 = sw1d + HID;
  float* sb2 = sb1 + HID;
  float* sbg1 = sb2 + HID;
  float* swg2 = sbg1 + HID;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* buf = swg2 + HID + warp * HID * TE;

  for (int i = tid; i < HID * HID; i += blockDim.x) {
    sW1r[i] = w1r[i];
    sW1s[i] = w1s[i];
    sW2[i] = w2[i];
    sWg1[i] = gate_mlp ? wg1[i] : 0.0f;
  }
  for (int i = tid; i < HID; i += blockDim.x) {
    sw1d[i] = w1d[i];
    sb1[i] = b1[i];
    sb2[i] = b2[i];
    sbg1[i] = gate_mlp ? bg1[i] : 0.0f;
    swg2[i] = gate_mlp ? wg2[i] : 0.0f;
  }
  __syncthreads();

  for (int row = blockIdx.x * WARPS + warp; row < n_nodes;
       row += gridDim.x * WARPS) {
    const int beg = indptr[row];
    const int end = indptr[row + 1];
    const float xr0 = x[3 * row], xr1 = x[3 * row + 1], xr2 = x[3 * row + 2];
    // receiver projection, j = lane / lane + 32
    const float* hr = h + (size_t)row * HID;
    float a0 = 0.0f, a1 = 0.0f;
    for (int k = 0; k < HID; ++k) {
      const float hk = hr[k];
      a0 = fmaf(hk, sW1r[k * HID + lane], a0);
      a1 = fmaf(hk, sW1r[k * HID + lane + 32], a1);
    }
    float mh0 = 0.0f, mh1 = 0.0f, dg = 0.0f;
    float dx0 = 0.0f, dx1 = 0.0f, dx2 = 0.0f;

    for (int base = beg; base < end; base += 32) {
      const int s = base + lane;
      const float e_l = s < end ? em[s] : 0.0f;
      const int snd_l = s < end ? snd[s] : 0;
      unsigned live = __ballot_sync(FULL, e_l != 0.0f);
      while (live) {  // `live` is warp-uniform: every lane takes this path
        int ts[TE];
        float te[TE];
#pragma unroll
        for (int t = 0; t < TE; ++t) {
          const int b = live ? __ffs(live) - 1 : 0;
          const float eb = __shfl_sync(FULL, e_l, b);
          ts[t] = __shfl_sync(FULL, snd_l, b);
          te[t] = live ? eb : 0.0f;
          live &= live - 1;
        }
        // gather the tile's sender features into buf[k][t]
        float v0[TE], v1[TE];
#pragma unroll
        for (int t = 0; t < TE; ++t) {
          const float* hs = h + (size_t)ts[t] * HID;
          v0[t] = te[t] != 0.0f ? hs[lane] : 0.0f;
          v1[t] = te[t] != 0.0f ? hs[lane + 32] : 0.0f;
        }
        __syncwarp();
        tile_store(buf, lane, v0, v1);
        __syncwarp();
        float p0[TE], p1[TE], d2[TE], r0[TE], r1[TE], r2[TE];
#pragma unroll
        for (int t = 0; t < TE; ++t) {
          p0[t] = 0.0f;
          p1[t] = 0.0f;
          const int sn = ts[t];
          r0[t] = xr0 - x[3 * sn];
          r1[t] = xr1 - x[3 * sn + 1];
          r2[t] = xr2 - x[3 * sn + 2];
          d2[t] = r0[t] * r0[t] + r1[t] * r1[t] + r2[t] * r2[t];
        }
        tile_matvec(buf, sW1s, lane, p0, p1);
#pragma unroll
        for (int t = 0; t < TE; ++t) {
          p0[t] = silu(((a0 + p0[t]) + d2[t] * sw1d[lane]) + sb1[lane]);
          p1[t] = silu(((a1 + p1[t]) + d2[t] * sw1d[lane + 32]) + sb1[lane + 32]);
        }
        __syncwarp();
        tile_store(buf, lane, p0, p1);
        __syncwarp();
        float m0[TE], m1[TE];
#pragma unroll
        for (int t = 0; t < TE; ++t) {
          m0[t] = 0.0f;
          m1[t] = 0.0f;
        }
        tile_matvec(buf, sW2, lane, m0, m1);
#pragma unroll
        for (int t = 0; t < TE; ++t) {
          m0[t] += sb2[lane];
          m1[t] += sb2[lane + 32];
        }
#pragma unroll
        for (int t = 0; t < TE; ++t) {  // slot order; te == 0 pads the tile
          if (te[t] != 0.0f) {
            mh0 += m0[t] * te[t];
            mh1 += m1[t] * te[t];
            dg += te[t];
          }
        }
        if (gate_mlp) {
          __syncwarp();
          tile_store(buf, lane, m0, m1);
          __syncwarp();
          float g0[TE], g1[TE];
#pragma unroll
          for (int t = 0; t < TE; ++t) {
            g0[t] = 0.0f;
            g1[t] = 0.0f;
          }
          tile_matvec(buf, sWg1, lane, g0, g1);
#pragma unroll
          for (int t = 0; t < TE; ++t) {
            const float part = silu(g0[t] + sbg1[lane]) * swg2[lane] +
                               silu(g1[t] + sbg1[lane + 32]) * swg2[lane + 32];
            float gate = warp_sum(part);
            gate = fminf(fmaxf(gate, -clamp), clamp);
            if (te[t] != 0.0f) {
              float q0 = r0[t], q1 = r1[t], q2 = r2[t];
              if (rel_inv1p) {
                const float k = sqrtf(d2[t] + 1e-12f) + 1.0f;
                q0 /= k;
                q1 /= k;
                q2 /= k;
              }
              dx0 += q0 * gate * te[t];
              dx1 += q1 * gate * te[t];
              dx2 += q2 * gate * te[t];
            }
          }
        }
        __syncwarp();
      }
    }
    const float inv = 1.0f / fmaxf(dg, 1.0f);
    mh[(size_t)row * HID + lane] = mh0 * inv;
    mh[(size_t)row * HID + lane + 32] = mh1 * inv;
    if (lane == 0) {
      dx[3 * row] = dx0 * inv;
      dx[3 * row + 1] = dx1 * inv;
      dx[3 * row + 2] = dx2 * inv;
      deg[row] = dg;
    }
  }
}

}  // namespace

extern "C" int edge_forward(const float* x, const float* h, const int* snd,
                            const float* em, const int* indptr,
                            const float* w1r, const float* w1s,
                            const float* w1d, const float* b1,
                            const float* w2, const float* b2,
                            const float* wg1, const float* bg1,
                            const float* wg2, float* dx, float* mh,
                            float* deg, int n_nodes, int gate_mlp,
                            int rel_inv1p, float clamp, int n_blocks,
                            void* stream) {
  const size_t smem = SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      edge_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n_nodes > 0 && n_blocks > 0) {
    edge_fwd_kernel<<<n_blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(
        x, h, snd, em, indptr, w1r, w1s, w1d, b1, w2, b2, wg1, bg1, wg2, dx,
        mh, deg, n_nodes, gate_mlp, rel_inv1p, clamp);
  }
  return (int)cudaGetLastError();
}

extern "C" int edge_rows_per_block() { return WARPS; }
extern "C" int edge_blocks_per_sm() { return 2; }

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
