// Real-real edge pathway backward for Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel `edge_pathway_bwd_fused` (its receiver
// pass `_edge_bwd_r_kernel` and sender pass `_edge_bwd_s_kernel`, sharing
// `_edge_bwd_common`) of the JAX package's kernels/edge_message.py.  Given
// the forward's primals, its `deg` output and the cotangents (g_dx, g_mh)
// it returns the 11 gradients (x, h, W1r, W1s, w1d, b1, W2, b2, Wg1, bg1,
// wg2).  Per live edge e = (r <- s) with upstream u = g_*[r] / max(deg_r, 1)
// * em_e it recomputes msg and gate and backpropagates exactly as
// `_edge_bwd_common` does (clip vjp passes only inside [-clamp, clamp],
// inv1p adds the d kf / d d2 term).
//
// Launch sequence (one stream, no atomics, fixed summation orders, so
// repeated runs are bitwise equal):
//   1. node_proj      P = h.W1r, Q = h.W1s per node (the forward's
//                     pre-activation is P_r + Q_s + d2 w1d + b1).
//   2. recv pass      one warp per receiver row of the CSR layout, live
//                     slots compacted into 8-edge tiles as in the forward.
//                     Per edge it recomputes t1, msg, the gate MLP, and
//                     backpropagates to g_pre1 (64) and g_rel_tot (3).  It
//                     writes per row G = sum g_pre1, D = sum d2 g_pre1,
//                     V = sum silu(gp1) g_gate and dx_r, and per live slot
//                     t1, g_msg, msg, g_gp1, g_pre1 and g_rel_tot.
//   3. send pass      one warp per sender node walks the sender
//                     permutation (slots stably sorted by sender) and sums
//                     the stored g_pre1 / g_rel_tot: S and dx_s.
//   4. nodes          gh = G.W1r^T + S.W1s^T, gx = dx_r + dx_s.
//   5. outer sums     the weight grads, each a two-stage block reduction
//                     (common.cuh): W1r = h^T G (+ b1 = sum G),
//                     W1s = h^T S, w1d = sum D, W2 = t1^T g_msg (+ b2),
//                     Wg1 = msg^T g_gp1 (+ bg1), wg2 = sum V.
// Unlike the TPU kernel's sender pass, which recomputes the chain, the
// receiver pass stores the per-edge cotangents it needs later (five
// 64-wide rows per live slot): simpler, and the outer-product sums then
// run as plain reductions over those rows.
//
// Bound on an H100: per live edge six 64x64 products (recompute .W2 and
// .Wg1; cotangents through Wg1^T and W2^T; the W2 and Wg1 outer products)
// and per node six (h.W1r, h.W1s, the W1r/W1s outer products, G.W1r^T,
// S.W1s^T) -- ~50K FLOP per edge against ~300 bytes of node gathers, far
// above the f32 ridge, so the function is bound by f32 operations.  This
// kernel also moves ~1.3 KB per live edge through the stored cotangents.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;  // warps per CTA of the row passes
constexpr int SMEM_FLOATS = 4 * HID * HID + 5 * HID + WARPS * HID * TILE;

inline size_t round4(size_t v) { return (v + 3) & ~size_t(3); }

// P[n][j] = sum_k h[n][k] W1r[k][j], Q likewise with W1s
__global__ void node_proj(const float* __restrict__ h,
                          const float* __restrict__ w1r,
                          const float* __restrict__ w1s, float* __restrict__ P,
                          float* __restrict__ Q, int n_nodes) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n_nodes * HID) return;
  const int n = f / HID, j = f % HID;
  const float* hn = h + (size_t)n * HID;
  float p = 0.0f, q = 0.0f;
  for (int k = 0; k < HID; ++k) {
    p = fmaf(hn[k], w1r[k * HID + j], p);
    q = fmaf(hn[k], w1s[k * HID + j], q);
  }
  P[f] = p;
  Q[f] = q;
}

__global__ void __launch_bounds__(WARPS * 32, 1)
edge_bwd_recv(const float* __restrict__ x, const int* __restrict__ snd,
              const float* __restrict__ em, const int* __restrict__ indptr,
              const float* __restrict__ P, const float* __restrict__ Q,
              const float* __restrict__ w1d, const float* __restrict__ b1,
              const float* __restrict__ w2, const float* __restrict__ b2,
              const float* __restrict__ wg1, const float* __restrict__ bg1,
              const float* __restrict__ wg2, const float* __restrict__ deg,
              const float* __restrict__ gdx, const float* __restrict__ gmh,
              float* __restrict__ G, float* __restrict__ D,
              float* __restrict__ V, float* __restrict__ dxr,
              float* __restrict__ T1, float* __restrict__ GMSG,
              float* __restrict__ MSG, float* __restrict__ GGP1,
              float* __restrict__ GPRE1, float* __restrict__ GREL,
              int n_nodes, int gate_mlp, int rel_inv1p, float clamp) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sW2 = smem;
  float* sW2T = sW2 + HID * HID;
  float* sWg1 = sW2T + HID * HID;
  float* sWg1T = sWg1 + HID * HID;
  float* sw1d = sWg1T + HID * HID;
  float* sb1 = sw1d + HID;
  float* sb2 = sb1 + HID;
  float* sbg1 = sb2 + HID;
  float* swg2 = sbg1 + HID;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* buf = swg2 + HID + warp * HID * TILE;

  for (int i = tid; i < HID * HID; i += blockDim.x) {
    const int k = i / HID, j = i % HID;
    sW2[i] = w2[i];
    sW2T[i] = w2[j * HID + k];
    sWg1[i] = gate_mlp ? wg1[i] : 0.0f;
    sWg1T[i] = gate_mlp ? wg1[j * HID + k] : 0.0f;
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
    const float inv = 1.0f / fmaxf(deg[row], 1.0f);
    const float gm0 = gmh[(size_t)row * HID + lane] * inv;
    const float gm1 = gmh[(size_t)row * HID + lane + 32] * inv;
    const float gd0 = gdx[3 * row] * inv, gd1 = gdx[3 * row + 1] * inv,
                gd2 = gdx[3 * row + 2] * inv;
    const float pr0 = P[(size_t)row * HID + lane];
    const float pr1 = P[(size_t)row * HID + lane + 32];
    const float xr0 = x[3 * row], xr1 = x[3 * row + 1], xr2 = x[3 * row + 2];
    float G0 = 0.0f, G1 = 0.0f, D0 = 0.0f, D1 = 0.0f, V0 = 0.0f, V1 = 0.0f;
    float dx0 = 0.0f, dx1 = 0.0f, dx2 = 0.0f;

    for (int base = beg; base < end; base += 32) {
      const int s = base + lane;
      const float e_l = s < end ? em[s] : 0.0f;
      const int snd_l = s < end ? snd[s] : 0;
      unsigned live = __ballot_sync(FULL, e_l != 0.0f);
      while (live) {  // warp-uniform
        int ts[TILE], tslot[TILE];
        float te[TILE];
#pragma unroll
        for (int t = 0; t < TILE; ++t) {
          const int b = live ? __ffs(live) - 1 : 0;
          const float eb = __shfl_sync(FULL, e_l, b);
          ts[t] = __shfl_sync(FULL, snd_l, b);
          tslot[t] = base + b;
          te[t] = live ? eb : 0.0f;
          live &= live - 1;
        }
        float r0[TILE], r1[TILE], r2[TILE], d2[TILE];
        float pre0[TILE], pre1[TILE], a0[TILE], a1[TILE];
#pragma unroll
        for (int t = 0; t < TILE; ++t) {
          const int sn = ts[t];
          r0[t] = xr0 - x[3 * sn];
          r1[t] = xr1 - x[3 * sn + 1];
          r2[t] = xr2 - x[3 * sn + 2];
          d2[t] = r0[t] * r0[t] + r1[t] * r1[t] + r2[t] * r2[t];
          const float q0 = te[t] != 0.0f ? Q[(size_t)sn * HID + lane] : 0.0f;
          const float q1 =
              te[t] != 0.0f ? Q[(size_t)sn * HID + lane + 32] : 0.0f;
          pre0[t] = ((pr0 + q0) + d2[t] * sw1d[lane]) + sb1[lane];
          pre1[t] = ((pr1 + q1) + d2[t] * sw1d[lane + 32]) + sb1[lane + 32];
          a0[t] = silu(pre0[t]);
          a1[t] = silu(pre1[t]);
        }
        float m0[TILE], m1[TILE];
        tile_product(buf, sW2, lane, a0, a1, m0, m1);
        float gg0[TILE], gg1[TILE];  // g_msg
        float gr0[TILE], gr1[TILE], gr2[TILE], gq2[TILE];  // g_d2 part
#pragma unroll
        for (int t = 0; t < TILE; ++t) {
          m0[t] += sb2[lane];
          m1[t] += sb2[lane + 32];
          gg0[t] = gm0 * te[t];
          gg1[t] = gm1 * te[t];
          gr0[t] = gr1[t] = gr2[t] = gq2[t] = 0.0f;
          if (te[t] != 0.0f) {
            const size_t o = (size_t)tslot[t] * HID;
            T1[o + lane] = a0[t];
            T1[o + lane + 32] = a1[t];
          }
        }
        if (gate_mlp) {
          float p0[TILE], p1[TILE];
          tile_product(buf, sWg1, lane, m0, m1, p0, p1);
          float q0[TILE], q1[TILE];  // g_gp1
#pragma unroll
          for (int t = 0; t < TILE; ++t) {
            const float gp0 = p0[t] + sbg1[lane];
            const float gp1 = p1[t] + sbg1[lane + 32];
            const float s0 = silu(gp0), s1 = silu(gp1);
            const float gate_pre = warp_sum(s0 * swg2[lane] + s1 * swg2[lane + 32]);
            const float gate = fminf(fmaxf(gate_pre, -clamp), clamp);
            const float u0 = gd0 * te[t], u1 = gd1 * te[t], u2 = gd2 * te[t];
            float kf = 1.0f, sd = 0.0f;
            if (rel_inv1p) {
              sd = sqrtf(d2[t] + 1e-12f);
              kf = 1.0f / (sd + 1.0f);
            }
            const float q0r = r0[t] * kf, q1r = r1[t] * kf, q2r = r2[t] * kf;
            float g_gate = u0 * q0r + u1 * q1r + u2 * q2r;
            if (!(gate_pre >= -clamp && gate_pre <= clamp)) g_gate = 0.0f;
            const float gu0 = u0 * gate, gu1 = u1 * gate, gu2 = u2 * gate;
            q0[t] = (g_gate * swg2[lane]) * silu_grad(gp0);
            q1[t] = (g_gate * swg2[lane + 32]) * silu_grad(gp1);
            if (rel_inv1p) {
              gr0[t] = gu0 * kf;
              gr1[t] = gu1 * kf;
              gr2[t] = gu2 * kf;
              gq2[t] = (gu0 * r0[t] + gu1 * r1[t] + gu2 * r2[t]) *
                       (-(kf * kf) / (2.0f * sd));
            } else {
              gr0[t] = gu0;
              gr1[t] = gu1;
              gr2[t] = gu2;
            }
            if (te[t] != 0.0f) {
              V0 += s0 * g_gate;
              V1 += s1 * g_gate;
              const size_t o = (size_t)tslot[t] * HID;
              MSG[o + lane] = m0[t];
              MSG[o + lane + 32] = m1[t];
              GGP1[o + lane] = q0[t];
              GGP1[o + lane + 32] = q1[t];
            }
          }
          tile_product(buf, sWg1T, lane, q0, q1, p0, p1);
#pragma unroll
          for (int t = 0; t < TILE; ++t) {
            gg0[t] += p0[t];
            gg1[t] += p1[t];
          }
        }
        float u0[TILE], u1[TILE];
        tile_product(buf, sW2T, lane, gg0, gg1, u0, u1);
#pragma unroll
        for (int t = 0; t < TILE; ++t) {
          const float gp0 = u0[t] * silu_grad(pre0[t]);
          const float gp1 = u1[t] * silu_grad(pre1[t]);
          const float g_d2 =
              gq2[t] + warp_sum(gp0 * sw1d[lane] + gp1 * sw1d[lane + 32]);
          const float gt0 = gr0[t] + 2.0f * r0[t] * g_d2;
          const float gt1 = gr1[t] + 2.0f * r1[t] * g_d2;
          const float gt2 = gr2[t] + 2.0f * r2[t] * g_d2;
          if (te[t] != 0.0f) {  // slot order
            G0 += gp0;
            G1 += gp1;
            D0 += d2[t] * gp0;
            D1 += d2[t] * gp1;
            dx0 += gt0;
            dx1 += gt1;
            dx2 += gt2;
            const size_t o = (size_t)tslot[t] * HID;
            GMSG[o + lane] = gg0[t];
            GMSG[o + lane + 32] = gg1[t];
            GPRE1[o + lane] = gp0;
            GPRE1[o + lane + 32] = gp1;
            if (lane == 0) {
              GREL[(size_t)tslot[t] * 4] = gt0;
              GREL[(size_t)tslot[t] * 4 + 1] = gt1;
              GREL[(size_t)tslot[t] * 4 + 2] = gt2;
            }
          }
        }
        __syncwarp();
      }
    }
    const size_t o = (size_t)row * HID;
    G[o + lane] = G0;
    G[o + lane + 32] = G1;
    D[o + lane] = D0;
    D[o + lane + 32] = D1;
    V[o + lane] = V0;
    V[o + lane + 32] = V1;
    if (lane == 0) {
      dxr[3 * row] = dx0;
      dxr[3 * row + 1] = dx1;
      dxr[3 * row + 2] = dx2;
    }
  }
}

// S[s] = sum of the stored g_pre1 over the live slots whose sender is s,
// dxs[s] = -sum of their g_rel_tot, in sender-permutation order
__global__ void edge_bwd_send(const float* __restrict__ em,
                              const int* __restrict__ sperm,
                              const int* __restrict__ sptr,
                              const float* __restrict__ GPRE1,
                              const float* __restrict__ GREL,
                              float* __restrict__ S, float* __restrict__ dxs,
                              int n_nodes) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int s = blockIdx.x * warps + (threadIdx.x >> 5); s < n_nodes;
       s += gridDim.x * warps) {
    float s0 = 0.0f, s1 = 0.0f, d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
    for (int k = sptr[s]; k < sptr[s + 1]; ++k) {
      const int e = sperm[k];
      if (em[e] != 0.0f) {
        s0 += GPRE1[(size_t)e * HID + lane];
        s1 += GPRE1[(size_t)e * HID + lane + 32];
        d0 -= GREL[(size_t)e * 4];
        d1 -= GREL[(size_t)e * 4 + 1];
        d2 -= GREL[(size_t)e * 4 + 2];
      }
    }
    S[(size_t)s * HID + lane] = s0;
    S[(size_t)s * HID + lane + 32] = s1;
    if (lane == 0) {
      dxs[3 * s] = d0;
      dxs[3 * s + 1] = d1;
      dxs[3 * s + 2] = d2;
    }
  }
}

// gh[n][j] = sum_k G[n][k] W1r[j][k] + sum_k S[n][k] W1s[j][k];
// gx = dx_r + dx_s
__global__ void edge_bwd_nodes(const float* __restrict__ G,
                               const float* __restrict__ S,
                               const float* __restrict__ w1r,
                               const float* __restrict__ w1s,
                               const float* __restrict__ dxr,
                               const float* __restrict__ dxs,
                               float* __restrict__ gh, float* __restrict__ gx,
                               int n_nodes) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n_nodes * HID) return;
  const int n = f / HID, j = f % HID;
  const float* gn = G + (size_t)n * HID;
  const float* sn = S + (size_t)n * HID;
  float a = 0.0f, b = 0.0f;
  for (int k = 0; k < HID; ++k) {
    a = fmaf(gn[k], w1r[j * HID + k], a);
    b = fmaf(sn[k], w1s[j * HID + k], b);
  }
  gh[f] = a + b;
  if (j < 3) gx[3 * n + j] = dxr[3 * n + j] + dxs[3 * n + j];
}

struct Scratch {
  float *P, *Q, *G, *D, *V, *S, *dxr, *dxs;
  float *T1, *GMSG, *MSG, *GGP1, *GPRE1, *GREL, *part;
  size_t total;
};

Scratch carve(float* base, int n, int e) {
  Scratch s;
  size_t off = 0;
  auto take = [&](size_t count) {
    float* p = base == nullptr ? nullptr : base + off;
    off += round4(count);
    return p;
  };
  const size_t nh = (size_t)n * HID, eh = (size_t)e * HID;
  s.P = take(nh);
  s.Q = take(nh);
  s.G = take(nh);
  s.D = take(nh);
  s.V = take(nh);
  s.S = take(nh);
  s.dxr = take((size_t)n * 3);
  s.dxs = take((size_t)n * 3);
  s.T1 = take(eh);
  s.GMSG = take(eh);
  s.MSG = take(eh);
  s.GGP1 = take(eh);
  s.GPRE1 = take(eh);
  s.GREL = take((size_t)e * 4);
  const int nb = outer_blocks(e) > outer_blocks(n) ? outer_blocks(e)
                                                   : outer_blocks(n);
  s.part = take((size_t)nb * OUTER_W);
  s.total = off;
  return s;
}

}  // namespace

extern "C" long long edge_bwd_scratch_floats(int n_nodes, int n_slots) {
  return (long long)carve(nullptr, n_nodes, n_slots).total;
}

extern "C" int edge_backward(
    const float* x, const float* h, const int* snd, const float* em,
    const int* indptr, const int* sperm, const int* sptr, const float* w1r,
    const float* w1s, const float* w1d, const float* b1, const float* w2,
    const float* b2, const float* wg1, const float* bg1, const float* wg2,
    const float* deg, const float* gdx, const float* gmh, float* gx,
    float* gh, float* gw1r, float* gw1s, float* gw1d, float* gb1, float* gw2,
    float* gb2, float* gwg1, float* gbg1, float* gwg2, float* scratch,
    int n_nodes, int n_slots, int gate_mlp, int rel_inv1p, float clamp,
    int n_blocks, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const size_t smem = SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      edge_bwd_recv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n_nodes <= 0) return (int)cudaGetLastError();
  Scratch s = carve(scratch, n_nodes, n_slots);
  const int nh_blocks = (n_nodes * HID + 255) / 256;
  node_proj<<<nh_blocks, 256, 0, stream>>>(h, w1r, w1s, s.P, s.Q, n_nodes);
  edge_bwd_recv<<<n_blocks, WARPS * 32, smem, stream>>>(
      x, snd, em, indptr, s.P, s.Q, w1d, b1, w2, b2, wg1, bg1, wg2, deg, gdx,
      gmh, s.G, s.D, s.V, s.dxr, s.T1, s.GMSG, s.MSG, s.GGP1, s.GPRE1, s.GREL,
      n_nodes, gate_mlp, rel_inv1p, clamp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  edge_bwd_send<<<(n_nodes + 7) / 8, 256, 0, stream>>>(
      em, sperm, sptr, s.GPRE1, s.GREL, s.S, s.dxs, n_nodes);
  edge_bwd_nodes<<<nh_blocks, 256, 0, stream>>>(s.G, s.S, w1r, w1s, s.dxr,
                                                s.dxs, gh, gx, n_nodes);
  const int* live_end = indptr + n_nodes;  // slots past it are never read
  outer_sum(h, s.G, nullptr, nullptr, n_nodes, s.part, gw1r, gb1, stream);
  outer_sum(h, s.S, nullptr, nullptr, n_nodes, s.part, gw1s, nullptr, stream);
  outer_sum(nullptr, s.D, nullptr, nullptr, n_nodes, s.part, nullptr, gw1d,
            stream);
  outer_sum(s.T1, s.GMSG, em, live_end, n_slots, s.part, gw2, gb2, stream);
  if (gate_mlp) {
    outer_sum(s.MSG, s.GGP1, em, live_end, n_slots, s.part, gwg1, gbg1,
              stream);
    outer_sum(nullptr, s.V, nullptr, nullptr, n_nodes, s.part, nullptr, gwg2,
              stream);
  }
  return (int)cudaGetLastError();
}

extern "C" int edge_bwd_rows_per_block() { return WARPS; }

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
