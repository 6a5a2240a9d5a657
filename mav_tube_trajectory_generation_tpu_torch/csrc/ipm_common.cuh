// Device code shared by the interior-point kernels (ipm_eval.cu,
// ipm_pipe.cu, ipm_solve.cu, gt_matvec.cu): lane-layout helpers, block
// reductions with a fixed order, the two matvec patterns against one
// scenario's G^T, the evaluation of a point (y, c, J^T weights, weighted-Gram
// band or full Gram), which the eval kernel, the pipelined step kernel and
// the whole-polish kernel all run, and the Newton and snap updates of a
// step, which the last two share.
//
// Lane layout (solver.qcqp._PadLayout): m_p lanes [ball-x | ball-y | ball-z |
// half]; each ball plane is nb_p lanes whose first n_ball carry the coupled
// components of the ball rows and whose tail carries packed half-space rows;
// the remaining half-space rows follow from lane 3 nb_p.
//
// NaN and inf.  The solvers rely on a blown-up Newton direction freezing its
// scenario (select, don't scale).  So min and max here propagate NaN like
// torch.minimum / jnp.minimum do (fminf / fmaxf drop it), and a comparison
// against NaN is false as in the plain version.
//
// Determinism.  Every reduction has a fixed order (warp butterfly, then a
// fixed number of partials); there are no float atomics.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>

namespace ipm {

constexpr int TILE = 64;           // lanes per weighted-Gram tile
constexpr int TILE_LD = TILE + 1;  // odd row stride: conflict-free columns
constexpr int KN = 10;             // band columns one work item accumulates

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline int row_groups(int threads, int m_p) {
  int g = threads / (m_p / 4);
  if (g < 1) g = 1;
  if (g > 8) g = 8;
  return g;
}

__device__ __forceinline__ float pmin(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fminf(a, b);
}

__device__ __forceinline__ float pmax(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fmaxf(a, b);
}

struct OpSum {
  static __device__ __forceinline__ float f(float a, float b) { return a + b; }
  static __device__ __forceinline__ float id() { return 0.0f; }
};
struct OpMin {
  static __device__ __forceinline__ float f(float a, float b) {
    return pmin(a, b);
  }
  static __device__ __forceinline__ float id() { return CUDART_INF_F; }
};
struct OpMax {
  static __device__ __forceinline__ float f(float a, float b) {
    return pmax(a, b);
  }
  static __device__ __forceinline__ float id() { return -CUDART_INF_F; }
};

template <class Op>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = Op::f(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Reduction over the block of one value per thread; every thread gets the
// result.  `red` holds 32 floats.  Must be reached by every thread.
template <class Op>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_reduce<Op>(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const float r = lane < nw ? red[lane] : Op::id();
  return warp_reduce<Op>(r);
}

// Is lane l a ball row?  j is its index inside its plane (-1 from 3 nb_p on).
__device__ __forceinline__ bool lane_ball(int l, int nb_p, int n_ball,
                                          int& j) {
  if (l >= 3 * nb_p) {
    j = -1;
    return false;
  }
  j = l - (l / nb_p) * nb_p;
  return j < n_ball;
}

// Constraint value at lane l from y: 0.5 (|y_j|^2 - rb_j^2) on ball lanes
// (the same value in the three planes), y itself elsewhere.
__device__ __forceinline__ float c_at(const float* y, const float* rb, int l,
                                      int nb_p, int n_ball) {
  int j;
  if (lane_ball(l, nb_p, n_ball, j)) {
    const float yx = y[j], yy = y[nb_p + j], yz = y[2 * nb_p + j];
    const float r = rb[j];
    return 0.5f * (yx * yx + yy * yy + yz * yz - r * r);
  }
  return y[l];
}

// The same at the moved point y + a g.
__device__ __forceinline__ float c_at_moved(const float* y, const float* g,
                                            float a, const float* rb, int l,
                                            int nb_p, int n_ball) {
  int j;
  if (lane_ball(l, nb_p, n_ball, j)) {
    const float yx = y[j] + a * g[j];
    const float yy = y[nb_p + j] + a * g[nb_p + j];
    const float yz = y[2 * nb_p + j] + a * g[2 * nb_p + j];
    const float r = rb[j];
    return 0.5f * (yx * yx + yy * yy + yz * yz - r * r);
  }
  return y[l] + a * g[l];
}

// (J dx) at lane l from gdx = G dx: sum_c y_c gdx_c on ball lanes.
__device__ __forceinline__ float jdx_at(const float* gdx, const float* y,
                                        int l, int nb_p, int n_ball) {
  int j;
  if (lane_ball(l, nb_p, n_ball, j))
    return y[j] * gdx[j] + y[nb_p + j] * gdx[nb_p + j] +
           y[2 * nb_p + j] * gdx[2 * nb_p + j];
  return gdx[l];
}

// part[g, l] = sum_{r = g, g+G, ...} gt[r, l] * x[r]: the rows are split
// over `groups` thread groups, each thread owning four neighbouring lanes.
__device__ inline void cols_dot(const float* __restrict__ gt, const float* x,
                                float* part, int nfd, int m_p, int groups) {
  const int nl4 = m_p >> 2;
  const float4* g4 = reinterpret_cast<const float4*>(gt);
  for (int idx = threadIdx.x; idx < groups * nl4; idx += blockDim.x) {
    const int g = idx / nl4, l4 = idx - g * nl4;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int r = g; r < nfd; r += groups) {
      const float4 a = __ldg(g4 + (size_t)r * nl4 + l4);
      const float xr = x[r];
      acc.x = fmaf(a.x, xr, acc.x);
      acc.y = fmaf(a.y, xr, acc.y);
      acc.z = fmaf(a.z, xr, acc.z);
      acc.w = fmaf(a.w, xr, acc.w);
    }
    reinterpret_cast<float4*>(part + (size_t)g * m_p)[l4] = acc;
  }
}

// sum_g part[g, l], in the fixed order g = 0 .. groups-1.
__device__ __forceinline__ float gather_groups(const float* part, int l,
                                               int m_p, int groups) {
  float acc = part[l];
  for (int g = 1; g < groups; ++g) acc += part[(size_t)g * m_p + l];
  return acc;
}

// d1[r] = sum_l gt[r, l] v1[l] and d2[r] = sum_l gt[r, l] v2[l]: one warp
// per row, float4 loads, butterfly reduce.
__device__ inline void rows_dot2(const float* __restrict__ gt, const float* v1,
                                 const float* v2, float* d1, float* d2,
                                 int nfd, int m_p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int nl4 = m_p >> 2;
  const float4* a4 = reinterpret_cast<const float4*>(v1);
  const float4* b4 = reinterpret_cast<const float4*>(v2);
  for (int r = warp; r < nfd; r += nw) {
    const float4* row = reinterpret_cast<const float4*>(gt + (size_t)r * m_p);
    float s1 = 0.0f, s2 = 0.0f;
    for (int l4 = lane; l4 < nl4; l4 += 32) {
      const float4 g = __ldg(row + l4);
      const float4 a = a4[l4];
      const float4 b = b4[l4];
      s1 = fmaf(g.x, a.x, s1); s2 = fmaf(g.x, b.x, s2);
      s1 = fmaf(g.y, a.y, s1); s2 = fmaf(g.y, b.y, s2);
      s1 = fmaf(g.z, a.z, s1); s2 = fmaf(g.z, b.z, s2);
      s1 = fmaf(g.w, a.w, s1); s2 = fmaf(g.w, b.w, s2);
    }
    s1 = warp_reduce<OpSum>(s1);
    s2 = warp_reduce<OpSum>(s2);
    if (lane == 0) {
      d1[r] = s1;
      d2[r] = s2;
    }
  }
}

// Shared-memory regions (float offsets) the evaluation needs.
struct EvalLayout {
  int y, c, wa, wj, wjs, wjb, jtwr2, jts, part, tile, wt, red;
  int total;
};

__host__ __device__ inline EvalLayout eval_layout(int base, int nfd, int m_p,
                                                  int blk, int nb_p,
                                                  int groups) {
  EvalLayout L;
  int o = base;
  L.y = o;     o += m_p;
  L.c = o;     o += m_p;
  L.wa = o;    o += m_p;          // term-1 lane weight
  L.wj = o;    o += m_p;          // J^T (w r2) lane weight
  L.wjs = o;   o += m_p;          // J^T (1/s) lane weight
  L.wjb = o;   o += round4(nb_p); // Jacobian-row weight per ball
  L.jtwr2 = o; o += round4(nfd);
  L.jts = o;   o += round4(nfd);
  L.part = o;  o += groups * m_p;
  // rows past nfd are read by the last block's items and never used
  L.tile = o;  o += round4((nfd + 2 * blk + KN) * TILE_LD);
  L.wt = o;    o += TILE;
  L.red = o;   o += 32;
  L.total = o;
  return L;
}

struct EvalDims {
  int nfd, m_p, blk, nb_p, n_ball, groups;
};

// Evaluation at (x, s, lam) of one scenario.  gt is that scenario's
// (nfd, m_p) matrix in global memory; b, rb, x, s, lam are in shared memory.
// Fills (shared) y = G x + b, c, jtwr2, jts and writes the band of the
// weighted Gram to hd (nfd, blk) and hu (nfd - blk, blk), in global or shared
// memory, plus ped + reg I and peu where ped is not null.  Where `gram` is not
// null the whole (nfd, nfd) weighted Gram goes there instead, both triangles
// computed, and hd, hu, ped, peu are not touched.
//
// The Gram.  With w = min(lam / s, w_cap) and curv = lam (or the clipped
// estimate under phr), the reference forms
//   (gt * lam_ball) gt^T + (aj * w_aj) aj^T
// where lam_ball is curv on ball lanes, aj holds the Jacobian rows
// J_j = sum_c y_jc gt[:, c nb_p + j] on plane-0 ball lanes and gt itself on
// every non-ball lane, and w_aj is w there.  Regrouped by lane that is
//   sum_l wa[l] gt[:, l] gt[:, l]^T  +  sum_{j < n_ball} w[j] J_j J_j^T
// with wa = curv on ball lanes and w elsewhere: one pass over the m_p lanes
// and one over the n_ball Jacobian rows, both through the same tile code.
// For the band only its blocks are formed: a work item owns a row r of the
// band and KN of its 2 blk columns (of all nfd columns for the full Gram),
// and keeps their sums in registers while the block walks G^T in tiles of
// TILE lanes through shared memory.
__device__ inline void eval_point(const float* __restrict__ gt,
                                  const float* b_s, const float* rb_s,
                                  const float* x_s, const float* s_s,
                                  const float* lam_s, float w_cap, bool phr,
                                  const EvalDims d, float* smem,
                                  const EvalLayout L, float* hd, float* hu,
                                  const float* ped, const float* peu,
                                  float reg, float* gram = nullptr) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nfd = d.nfd, m_p = d.m_p, blk = d.blk, nb_p = d.nb_p;
  const int n_ball = d.n_ball;
  float* y_s = smem + L.y;
  float* c_s = smem + L.c;
  float* wa_s = smem + L.wa;
  float* wj_s = smem + L.wj;
  float* wjs_s = smem + L.wjs;
  float* wjb_s = smem + L.wjb;
  float* part_s = smem + L.part;
  float* tile = smem + L.tile;
  float* wt = smem + L.wt;

  // y = G x + b
  __syncthreads();
  cols_dot(gt, x_s, part_s, nfd, m_p, d.groups);
  __syncthreads();
  for (int l = tid; l < m_p; l += nt)
    y_s[l] = gather_groups(part_s, l, m_p, d.groups) + b_s[l];
  __syncthreads();

  // lane weights
  for (int l = tid; l < m_p; l += nt) {
    int j;
    const bool ball = lane_ball(l, nb_p, n_ball, j);
    const float yl = y_s[l];
    const float c = c_at(y_s, rb_s, l, nb_p, n_ball);
    const float sl = s_s[l], ll = lam_s[l];
    const float s_safe = pmax(sl, 1e-14f);
    const float r2 = c + sl;
    const float w = pmin(ll / s_safe, w_cap);
    const float ymul = ball ? yl : 1.0f;
    const float wr2 = w * r2;
    const float m_est = pmax(wr2, 0.0f);
    c_s[l] = c;
    wj_s[l] = (phr ? m_est : wr2) * ymul;
    wjs_s[l] = ymul / s_safe;
    wa_s[l] = ball ? (phr ? m_est : ll) : w;
    if (l < nb_p) wjb_s[l] = ball ? w : 0.0f;
  }
  __syncthreads();

  rows_dot2(gt, wj_s, wjs_s, smem + L.jtwr2, smem + L.jts, nfd, m_p);

  // band of the weighted Gram, or all of it
  const bool full = gram != nullptr;
  const int n_kg = ((full ? nfd : 2 * blk) + KN - 1) / KN;
  const int n_items = nfd * n_kg;
  const int n_lt = (m_p + TILE - 1) / TILE;
  const int n_jt = (n_ball + TILE - 1) / TILE;
  for (int item0 = 0; item0 < n_items; item0 += nt) {
    const int item = item0 + tid;
    const bool active = item < n_items;
    const int kg = active ? item / nfd : 0;
    const int r = active ? item - kg * nfd : 0;
    const int ib = r / blk;
    // first column (row of G^T)
    const int c0 = full ? kg * KN : ib * blk + kg * KN;
    float acc[KN];
#pragma unroll
    for (int k = 0; k < KN; ++k) acc[k] = 0.0f;

    for (int t = 0; t < n_lt + n_jt; ++t) {
      __syncthreads();                        // the last tile has been read
      if (t < n_lt) {
        const int l0 = t * TILE;
        for (int idx = tid; idx < nfd * TILE; idx += nt) {
          const int rr = idx / TILE, jj = idx - rr * TILE;
          const int l = l0 + jj;
          tile[rr * TILE_LD + jj] =
              l < m_p ? __ldg(gt + (size_t)rr * m_p + l) : 0.0f;
        }
        if (tid < TILE) wt[tid] = l0 + tid < m_p ? wa_s[l0 + tid] : 0.0f;
      } else {
        const int j0 = (t - n_lt) * TILE;
        for (int idx = tid; idx < nfd * TILE; idx += nt) {
          const int rr = idx / TILE, jj = idx - rr * TILE;
          const int j = j0 + jj;
          float v = 0.0f;
          if (j < nb_p) {
            const float* row = gt + (size_t)rr * m_p;
            v = __ldg(row + j) * y_s[j] +
                __ldg(row + nb_p + j) * y_s[nb_p + j] +
                __ldg(row + 2 * nb_p + j) * y_s[2 * nb_p + j];
          }
          tile[rr * TILE_LD + jj] = v;
        }
        if (tid < TILE) wt[tid] = j0 + tid < nb_p ? wjb_s[j0 + tid] : 0.0f;
      }
      __syncthreads();
      if (active) {
        const float* rowp = tile + r * TILE_LD;
        const float* colp = tile + c0 * TILE_LD;
        for (int jj = 0; jj < TILE; ++jj) {
          const float a = rowp[jj] * wt[jj];
#pragma unroll
          for (int k = 0; k < KN; ++k)
            acc[k] = fmaf(a, colp[k * TILE_LD + jj], acc[k]);
        }
      }
    }

    if (active && full) {
#pragma unroll
      for (int k = 0; k < KN; ++k)
        if (c0 + k < nfd) gram[(size_t)r * nfd + c0 + k] = acc[k];
    } else if (active) {
      const int rr = r - ib * blk;
#pragma unroll
      for (int k = 0; k < KN; ++k) {
        const int kk = kg * KN + k;
        if (kk < blk) {
          float v = acc[k];
          if (ped) {
            v += ped[r * blk + kk];
            if (kk == rr) v += reg;
          }
          hd[r * blk + kk] = v;
        } else if (kk < 2 * blk && r < nfd - blk) {
          float v = acc[k];
          if (peu) v += peu[r * blk + kk - blk];
          hu[r * blk + kk - blk] = v;
        }
      }
    }
  }
  __syncthreads();
}

// out[r] = sum_c M[r, c] v[c] for one blk x blk block.
__device__ __forceinline__ float block_row_dot(const float* M, const float* v,
                                               int r, int blk) {
  float acc = 0.0f;
  for (int c = 0; c < blk; ++c) acc = fmaf(M[r * blk + c], v[c], acc);
  return acc;
}

// (kron-band(P) x)[r] = D_i x_i + U_i x_{i+1} + U_{i-1}^T x_{i-1} from the
// stacked objective band ped (m, blk, blk), peu (m - 1, blk, blk).
__device__ __forceinline__ float pe_band_mv_row(const float* ped,
                                                const float* peu,
                                                const float* x, int r, int blk,
                                                int m_blk) {
  const int i = r / blk, rr = r - i * blk, bb = blk * blk;
  float o = block_row_dot(ped + i * bb, x + i * blk, rr, blk);
  if (i + 1 < m_blk)
    o += block_row_dot(peu + i * bb, x + (i + 1) * blk, rr, blk);
  if (i) {
    const float* ut = peu + (i - 1) * bb;
    float acc = 0.0f;
    for (int c = 0; c < blk; ++c)
      acc = fmaf(ut[c * blk + rr], x[(i - 1) * blk + c], acc);
    o += acc;
  }
  return o;
}

// One scenario's running point and best iterate, in shared memory, with the
// lane constants and the scratch the updates need.
struct StepState {
  float *x, *s, *lam, *y, *bx, *by;        // x, bx: nfd; the others: m_p
  const float *act, *cw, *rb;
  const float *dx, *gdx;                   // direction and G dx
  float *ds, *dlam;                        // m_p scratch
  float* red;                              // 32 floats
  int nfd, m_p, nb_p, n_ball;
  float mc;
};

// Newton update along (dx, gdx) from the point whose matvec is y_ev (the
// running y itself, or a fresh evaluation of it): fraction-to-boundary step
// on (s, lam) capped at alpha_max, applied only where the direction is finite
// (select, never scale), then the merit and the best iterate.  Must be
// reached by every thread; ends with the block in step.
__device__ inline void newton_update(const StepState S, const float* y_ev,
                                     float sigma_min, float tau,
                                     float alpha_max, float w_cap,
                                     float& best_merit) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nfd = S.nfd, m_p = S.m_p, nb_p = S.nb_p, n_ball = S.n_ball;
  const float inf = CUDART_INF_F;
  float p_mu = 0.0f;
  for (int l = tid; l < m_p; l += nt) p_mu += S.cw[l] * S.s[l] * S.lam[l];
  const float mu = block_reduce<OpSum>(p_mu, S.red) / S.mc;
  const float sig_mu = sigma_min * mu;
  float min_s = inf, min_l = inf, fin = 1.0f;
  for (int l = tid; l < m_p; l += nt) {
    const float act = S.act[l], sl = S.s[l], ll = S.lam[l];
    const float c = c_at(y_ev, S.rb, l, nb_p, n_ball);
    const float r2 = (c + sl) * act;
    const float w = pmin(ll / sl, w_cap);
    const float jdx = jdx_at(S.gdx, y_ev, l, nb_p, n_ball);
    const float ds = (-r2 - jdx) * act;
    const float dlam = ((sig_mu - ll * sl) / sl - w * ds) * act;
    S.ds[l] = ds;
    S.dlam[l] = dlam;
    min_s = pmin(min_s, ds < 0.0f ? -sl / ds : inf);
    min_l = pmin(min_l, dlam < 0.0f ? -ll / dlam : inf);
    if (!(fabsf(ds) < inf) || !(fabsf(dlam) < inf)) fin = 0.0f;
  }
  min_s = block_reduce<OpMin>(min_s, S.red);
  min_l = block_reduce<OpMin>(min_l, S.red);
  fin = block_reduce<OpMin>(fin, S.red);
  const float alpha =
      pmin(pmin(pmin(1.0f, tau * min_s), pmin(1.0f, tau * min_l)), alpha_max);
  const bool upd = alpha > 0.0f && fin > 0.0f;
  if (upd) {
    for (int r = tid; r < nfd; r += nt) S.x[r] = S.x[r] + alpha * S.dx[r];
    for (int l = tid; l < m_p; l += nt) {
      S.s[l] = S.s[l] + alpha * S.ds[l];
      if (S.act[l] > 0.0f)
        S.lam[l] = pmax(S.lam[l] + alpha * S.dlam[l], 1e-16f);
      S.y[l] = S.y[l] + alpha * S.gdx[l];
    }
  }
  __syncthreads();
  float m1 = -inf, m2 = -inf, m3 = 0.0f;
  for (int l = tid; l < m_p; l += nt) {
    const float c = c_at(S.y, S.rb, l, nb_p, n_ball);
    if (S.act[l] > 0.0f) {
      m1 = pmax(m1, pmax(c, 0.0f));
      m2 = pmax(m2, fabsf(c + S.s[l]));
    }
    m3 += S.cw[l] * S.s[l] * S.lam[l];
  }
  m1 = block_reduce<OpMax>(m1, S.red);
  m2 = block_reduce<OpMax>(m2, S.red);
  m3 = block_reduce<OpSum>(m3, S.red) / S.mc;
  const float merit = m1 + m2 + m3;
  if (merit < best_merit) {
    best_merit = merit;
    for (int r = tid; r < nfd; r += nt) S.bx[r] = S.x[r];
    for (int l = tid; l < m_p; l += nt) S.by[l] = S.y[l];
  }
  __syncthreads();
}

// Snap update of the best iterate along (dx, gdx): seven-point line search
// on phi = sum cw max(c, 0)^2, the point moved only where a trial beats the
// start.  Must be reached by every thread; ends with the block in step.
__device__ inline void snap_update(const StepState S) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nb_p = S.nb_p, n_ball = S.n_ball;
  const float alphas[7] = {1.0f, 0.5f, 0.25f, 0.1f, 0.03f, 0.01f, 0.003f};
  float p[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] = 0.0f;
  for (int l = tid; l < S.m_p; l += nt) {
    const float cw = S.cw[l];
    float v = pmax(c_at(S.by, S.rb, l, nb_p, n_ball), 0.0f);
    p[0] += cw * v * v;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      v = pmax(c_at_moved(S.by, S.gdx, alphas[i], S.rb, l, nb_p, n_ball),
               0.0f);
      p[i + 1] += cw * v * v;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] = block_reduce<OpSum>(p[i], S.red);
  float best_a = 0.0f, best_p = p[0];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    if (p[i + 1] < best_p) {
      best_a = alphas[i];
      best_p = p[i + 1];
    }
  }
  if (best_a > 0.0f) {
    for (int r = tid; r < S.nfd; r += nt) S.bx[r] = S.bx[r] + best_a * S.dx[r];
    for (int l = tid; l < S.m_p; l += nt)
      S.by[l] = S.by[l] + best_a * S.gdx[l];
  }
  __syncthreads();
}

}  // namespace ipm
