// The whole plane-layout interior-point polish of one scenario in one launch,
// for Hopper (sm_90a).  Replaces the Pallas TPU kernel _solve_kernel
// (ipm_solve_fused) of the JAX package's ops/ipm_kernel.py.
//
// Per scenario (one thread block each), from the start point (x0, s0, lam0,
// y0):
//   n_iters single-direction Newton steps at fixed centring sigma_min: slack
//     floor, evaluation of the point (ipm_common.cuh, eval_point: y, c, the
//     two J^T reductions and the 2 m - 1 band blocks of the weighted Gram,
//     written to shared memory with the objective band and reg I added),
//     right-hand side -(P x + q + J^T (w r2) + sigma mu J^T (1/s)), the band
//     factor and solve below, G dx, then the gated update with best-iterate
//     tracking (ipm_common.cuh, newton_update);
//   snap_iters Gauss-Newton feasibility sweeps from the best iterate: clipped
//     multipliers on the near-boundary rows, the clipped-penalty evaluation
//     at weight snap_rho, reg 1e-6, the same factor and solve, and the
//     seven-point line search (ipm_common.cuh, snap_update).
//
// The band factor.  H = blocktridiag(hd, hu) is Jacobi-equilibrated (D H D,
// D = rsqrt(max(diag H, 1e-30)): load-bearing in float32, the unscaled factor
// flips dx to an ascent direction on stiff active sets) and factored by block
// Thomas elimination: S_0 = hd_0, W_i = S_i^-1 hu_i, S_{i+1} = hd_{i+1} -
// hu_i^T W_i, with each pivot block inverted by Gauss-Jordan elimination
// (diagonal pivots, no row swaps).  One thread owns one entry of the pivot
// block or of the running inverse; a pivot step reads one buffer and writes
// the other, so it costs one barrier.
//
// What bounds it on an H100: with every input read once, G^T is 0.28 MB a
// scenario while one step's band products are about 5 MFLOP, so a polish of
// twelve steps is bound by float32 arithmetic (about 0.9 us a scenario
// against 0.08 us of memory traffic).  One scenario's G^T does not fit a
// block's shared memory, so each step walks it four times (y, the J^T
// reductions, the Gram tiles, G dx) from L2 or device memory; the factor is
// a chain of 9 x 15 pivot steps and 16 block products with a barrier after
// each: latency, not arithmetic.  The factors live in the evaluation's tile
// buffer, which is idle between evaluations; with that a block takes 101 KB
// of shared memory at the flagship shape and two fit one SM.

#include "ipm_common.cuh"

namespace {

struct SolveArgs {
  // inputs
  const float *gt, *b, *rb, *pe_d, *pe_u, *q, *x0, *s0, *lam0, *y0, *act, *cw;
  // outputs
  float *x_fin, *y_fin, *s_fin, *lam_fin, *y_last, *merit, *lam_mid;
  float *lam_fin_max;
  int nfd, m_p, blk, nb_p, n_ball, mc, groups, n_iters, snap_iters;
  float sigma_min, tau, alpha_max, w_cap, reg, snap_rho, margin;
};

struct Layout {
  int b, act, cw, s, lam, y, by, rb;
  int x, bx, dx, rhs, u, z, dsc;
  int hd, hu, gj;
  ipm::EvalLayout ev;
  int sinv, wf;     // inside the evaluation's tile buffer
  int total;
};

__host__ __device__ inline Layout make_layout(int nfd, int m_p, int blk,
                                              int nb_p, int groups) {
  Layout L;
  const int m_blk = nfd / blk, bb = blk * blk;
  int o = 0;
  L.b = o;    o += m_p;
  L.act = o;  o += m_p;
  L.cw = o;   o += m_p;
  L.s = o;    o += m_p;
  L.lam = o;  o += m_p;
  L.y = o;    o += m_p;
  L.by = o;   o += m_p;
  L.rb = o;   o += ipm::round4(nb_p);
  L.x = o;    o += ipm::round4(nfd);
  L.bx = o;   o += ipm::round4(nfd);
  L.dx = o;   o += ipm::round4(nfd);
  L.rhs = o;  o += ipm::round4(nfd);
  L.u = o;    o += ipm::round4(nfd);
  L.z = o;    o += ipm::round4(nfd);
  L.dsc = o;  o += ipm::round4(nfd);
  L.hd = o;   o += ipm::round4(m_blk * bb);
  L.hu = o;   o += ipm::round4((m_blk - 1) * bb);
  L.gj = o;   o += ipm::round4(4 * bb);   // two buffers of [block | inverse]
  L.ev = ipm::eval_layout(o, nfd, m_p, blk, nb_p, groups);
  L.sinv = L.ev.tile;
  L.wf = L.sinv + m_blk * bb;
  L.total = L.ev.total;
  return L;
}

// Do the factors fit the tile buffer they share?
__host__ __device__ inline bool factors_fit(int nfd, int blk) {
  const int m_blk = nfd / blk, bb = blk * blk;
  return (2 * m_blk - 1) * bb <=
         ipm::round4((nfd + 2 * blk + ipm::KN) * ipm::TILE_LD);
}

// dx = H^-1 rhs for H = blocktridiag(hd, hu), as described at the top.  hd
// (m, blk, blk) and hu (m - 1, blk, blk) are scaled in place.  Must be
// reached by every thread; ends with the block in step.
__device__ void band_factor_solve(float* hd, float* hu, float* dsc, float* sinv,
                                  float* wf, float* gj, const float* rhs,
                                  float* u, float* z, float* dx, int nfd,
                                  int blk) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int m_blk = nfd / blk, bb = blk * blk;

  for (int r = tid; r < nfd; r += nt) {
    const int i = r / blk, rr = r - i * blk;
    dsc[r] = rsqrtf(ipm::pmax(hd[i * bb + rr * blk + rr], 1e-30f));
  }
  __syncthreads();
  for (int idx = tid; idx < m_blk * bb; idx += nt) {
    const int r = idx / blk, kk = idx - r * blk, i = r / blk;
    hd[idx] = hd[idx] * dsc[r] * dsc[i * blk + kk];
  }
  for (int idx = tid; idx < (m_blk - 1) * bb; idx += nt) {
    const int r = idx / blk, kk = idx - r * blk, i = r / blk;
    hu[idx] = hu[idx] * dsc[r] * dsc[(i + 1) * blk + kk];
  }
  __syncthreads();

  for (int i = 0; i < m_blk; ++i) {
    // pivot block S_i and the identity into buffer 0
    for (int e = tid; e < bb; e += nt) {
      const int r = e / blk, c = e - r * blk;
      float v = hd[i * bb + e];
      if (i) {
        const float* up = hu + (i - 1) * bb;
        const float* wp = wf + (i - 1) * bb;
        float acc = 0.0f;
        for (int k = 0; k < blk; ++k)
          acc = fmaf(up[k * blk + r], wp[k * blk + c], acc);
        v -= acc;
      }
      gj[e] = v;
      gj[bb + e] = r == c ? 1.0f : 0.0f;
    }
    __syncthreads();
    // Gauss-Jordan: row p scaled by 1 / pivot, every other row cleared in
    // column p; the same row operations on the running inverse
    int cur = 0;
    for (int p = 0; p < blk; ++p) {
      const float* src = gj + cur * 2 * bb;
      float* dst = gj + (1 - cur) * 2 * bb;
      for (int e2 = tid; e2 < 2 * bb; e2 += nt) {
        const int half = e2 >= bb ? bb : 0;
        const int e = e2 - half;
        const int r = e / blk, c = e - r * blk;
        const float prow = src[half + p * blk + c] / src[p * blk + p];
        dst[e2] = r == p ? prow : src[e2] - src[r * blk + p] * prow;
      }
      __syncthreads();
      cur ^= 1;
    }
    const float* inv = gj + cur * 2 * bb + bb;
    for (int e = tid; e < bb; e += nt) sinv[i * bb + e] = inv[e];
    __syncthreads();
    if (i + 1 < m_blk) {
      for (int e = tid; e < bb; e += nt) {
        const int r = e / blk, c = e - r * blk;
        const float* sp = sinv + i * bb + r * blk;
        const float* up = hu + i * bb;
        float acc = 0.0f;
        for (int k = 0; k < blk; ++k) acc = fmaf(sp[k], up[k * blk + c], acc);
        wf[i * bb + e] = acc;
      }
      __syncthreads();
    }
  }

  // forward: z_i = S_i^-1 (D rhs_i - hu_{i-1}^T z_{i-1})
  for (int i = 0; i < m_blk; ++i) {
    if (tid < blk) {
      float v = rhs[i * blk + tid] * dsc[i * blk + tid];
      if (i) {
        const float* up = hu + (i - 1) * bb;
        float acc = 0.0f;
        for (int k = 0; k < blk; ++k)
          acc = fmaf(up[k * blk + tid], z[(i - 1) * blk + k], acc);
        v -= acc;
      }
      u[i * blk + tid] = v;
    }
    __syncthreads();
    if (tid < blk)
      z[i * blk + tid] =
          ipm::block_row_dot(sinv + i * bb, u + i * blk, tid, blk);
    __syncthreads();
  }
  // backward: x_{m-1} = z_{m-1}; x_i = z_i - W_i x_{i+1}   (in u)
  for (int i = m_blk - 1; i >= 0; --i) {
    if (tid < blk) {
      float v = z[i * blk + tid];
      if (i + 1 < m_blk)
        v -= ipm::block_row_dot(wf + i * bb, u + (i + 1) * blk, tid, blk);
      u[i * blk + tid] = v;
    }
    __syncthreads();
  }
  for (int r = tid; r < nfd; r += nt) dx[r] = u[r] * dsc[r];
  __syncthreads();
}

__global__ void __launch_bounds__(512, 2)
ipm_solve_kernel(SolveArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int sc = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nfd = a.nfd, m_p = a.m_p, blk = a.blk, nb_p = a.nb_p;
  const int n_ball = a.n_ball;
  const int m_blk = nfd / blk;
  const Layout L = make_layout(nfd, m_p, blk, nb_p, a.groups);
  const float inf = CUDART_INF_F;
  const float mc = (float)a.mc;

  const float* gt = a.gt + (size_t)sc * nfd * m_p;
  const float* ped = a.pe_d + (size_t)sc * nfd * blk;
  const float* peu = a.pe_u + (size_t)sc * (nfd - blk) * blk;
  const float* q = a.q + (size_t)sc * nfd;
  float* b_s = smem + L.b;
  float* act_s = smem + L.act;
  float* cw_s = smem + L.cw;
  float* s_s = smem + L.s;
  float* lam_s = smem + L.lam;
  float* y_s = smem + L.y;
  float* by_s = smem + L.by;
  float* rb_s = smem + L.rb;
  float* x_s = smem + L.x;
  float* bx_s = smem + L.bx;
  float* dx_s = smem + L.dx;
  float* rhs_s = smem + L.rhs;
  float* hd_s = smem + L.hd;
  float* hu_s = smem + L.hu;
  // Live only between an evaluation and the next: gdx, ds and dlam share the
  // evaluation's lane-weight arrays, the factors its tile buffer.
  float* gdx_s = smem + L.ev.wjs;
  float* part_s = smem + L.ev.part;
  float* red_s = smem + L.ev.red;

  for (int l = tid; l < m_p; l += nt) {
    b_s[l] = a.b[(size_t)sc * m_p + l];
    act_s[l] = a.act[l];
    cw_s[l] = a.cw[l];
    s_s[l] = a.s0[(size_t)sc * m_p + l];
    lam_s[l] = a.lam0[(size_t)sc * m_p + l];
    const float y0 = a.y0[(size_t)sc * m_p + l];
    y_s[l] = y0;
    by_s[l] = y0;
  }
  for (int j = tid; j < nb_p; j += nt) rb_s[j] = a.rb[(size_t)sc * nb_p + j];
  for (int r = tid; r < nfd; r += nt) {
    const float x0 = a.x0[(size_t)sc * nfd + r];
    x_s[r] = x0;
    bx_s[r] = x0;
  }
  float best_merit = inf, lam_mid = 0.0f;
  __syncthreads();

  ipm::EvalDims d;
  d.nfd = nfd; d.m_p = m_p; d.blk = blk; d.nb_p = nb_p; d.n_ball = n_ball;
  d.groups = a.groups;
  ipm::StepState st;
  st.x = x_s; st.s = s_s; st.lam = lam_s; st.y = y_s; st.bx = bx_s;
  st.by = by_s; st.act = act_s; st.cw = cw_s; st.rb = rb_s; st.dx = dx_s;
  st.gdx = gdx_s; st.ds = smem + L.ev.wa; st.dlam = smem + L.ev.wj;
  st.red = red_s;
  st.nfd = nfd; st.m_p = m_p; st.nb_p = nb_p; st.n_ball = n_ball; st.mc = mc;

  // dx and gdx = G dx from the band in hd_s / hu_s and the right-hand side
  auto direction = [&]() {
    band_factor_solve(hd_s, hu_s, smem + L.dsc, smem + L.sinv, smem + L.wf,
                      smem + L.gj, rhs_s, smem + L.u, smem + L.z, dx_s, nfd,
                      blk);
    ipm::cols_dot(gt, dx_s, part_s, nfd, m_p, a.groups);
    __syncthreads();
    for (int l = tid; l < m_p; l += nt)
      gdx_s[l] = ipm::gather_groups(part_s, l, m_p, a.groups);
    __syncthreads();
  };

  // ---- Newton steps ----------------------------------------------------------
  for (int it = 0; it < a.n_iters; ++it) {
    for (int l = tid; l < m_p; l += nt) {
      const float act = act_s[l];
      s_s[l] = ipm::pmax(s_s[l], 1e-14f) * act + (1.0f - act);
    }
    ipm::eval_point(gt, b_s, rb_s, x_s, s_s, lam_s, a.w_cap, false, d, smem,
                    L.ev, hd_s, hu_s, ped, peu, a.reg);
    float p_mu = 0.0f;
    for (int l = tid; l < m_p; l += nt) p_mu += cw_s[l] * s_s[l] * lam_s[l];
    const float mu = ipm::block_reduce<ipm::OpSum>(p_mu, red_s) / mc;
    const float sig_mu = a.sigma_min * mu;
    for (int r = tid; r < nfd; r += nt) {
      const float o = ipm::pe_band_mv_row(ped, peu, x_s, r, blk, m_blk);
      rhs_s[r] = -(o + q[r] + smem[L.ev.jtwr2 + r] +
                   sig_mu * smem[L.ev.jts + r]);
    }
    __syncthreads();
    direction();
    ipm::newton_update(st, smem + L.ev.y, a.sigma_min, a.tau, a.alpha_max,
                       a.w_cap, best_merit);
    float ml = 0.0f;
    for (int l = tid; l < m_p; l += nt)
      ml = ipm::pmax(ml, act_s[l] > 0.0f ? lam_s[l] : 0.0f);
    ml = ipm::block_reduce<ipm::OpMax>(ml, red_s);
    if (it == a.n_iters / 2) lam_mid = ml;
  }

  // ---- the last Newton state leaves; s_s and lam_s become scratch -----------
  float ml = 0.0f;
  for (int l = tid; l < m_p; l += nt) {
    a.s_fin[(size_t)sc * m_p + l] = s_s[l];
    a.lam_fin[(size_t)sc * m_p + l] = lam_s[l];
    a.y_last[(size_t)sc * m_p + l] = y_s[l];
    ml = ipm::pmax(ml, act_s[l] > 0.0f ? lam_s[l] : 0.0f);
  }
  ml = ipm::block_reduce<ipm::OpMax>(ml, red_s);
  __syncthreads();

  // ---- snap sweeps from the best iterate ------------------------------------
  for (int j = 0; j < a.snap_iters; ++j) {
    for (int l = tid; l < m_p; l += nt) {
      const float c = ipm::c_at(by_s, rb_s, l, nb_p, n_ball);
      const float lam_e = (c > -a.margin && act_s[l] > 0.0f) ? 1e-6f : 0.0f;
      lam_s[l] = lam_e;
      s_s[l] = lam_e / a.snap_rho;
    }
    ipm::eval_point(gt, b_s, rb_s, bx_s, s_s, lam_s, a.snap_rho, true, d, smem,
                    L.ev, hd_s, hu_s, ped, peu, 1e-6f);
    for (int r = tid; r < nfd; r += nt) rhs_s[r] = -smem[L.ev.jtwr2 + r];
    __syncthreads();
    direction();
    ipm::snap_update(st);
  }

  for (int l = tid; l < m_p; l += nt) a.y_fin[(size_t)sc * m_p + l] = by_s[l];
  for (int r = tid; r < nfd; r += nt) a.x_fin[(size_t)sc * nfd + r] = bx_s[r];
  if (tid == 0) {
    a.merit[sc] = best_merit;
    a.lam_mid[sc] = lam_mid;
    a.lam_fin_max[sc] = ml;
  }
}

}  // namespace

// Dynamic shared memory, in bytes, that one block takes at these shapes.
extern "C" int ipm_solve_smem_bytes(int nfd, int m_p, int blk, int nb_p,
                                    int threads) {
  return make_layout(nfd, m_p, blk, nb_p, ipm::row_groups(threads, m_p))
             .total * (int)sizeof(float);
}

// Launches the whole polish for `batch` scenarios on `stream`.  Returns the
// CUDA error code of the launch (0 on success); does not synchronise.
extern "C" int ipm_solve_fused_launch(
    const float* gt, const float* b, const float* rb, const float* pe_d,
    const float* pe_u, const float* q, const float* x0, const float* s0,
    const float* lam0, const float* y0, const float* act, const float* cw,
    float* x_fin, float* y_fin, float* s_fin, float* lam_fin, float* y_last,
    float* merit, float* lam_mid, float* lam_fin_max, int batch, int nfd,
    int m_p, int blk, int nb_p, int n_ball, int mc, int n_iters,
    int snap_iters, float sigma_min, float tau, float alpha_max, float w_cap,
    float reg, float snap_rho, int threads, void* stream) {
  if (threads < 64 || threads > 512 || threads % 32 != 0 || m_p % 4 != 0 ||
      blk < 1 || threads < blk || nfd % blk != 0 || nfd < 2 * blk ||
      3 * nb_p > m_p || n_ball < 0 || n_ball > nb_p || batch < 1 || mc < 1 ||
      n_iters < 0 || snap_iters < 0 || !factors_fit(nfd, blk))
    return (int)cudaErrorInvalidValue;
  SolveArgs a;
  a.gt = gt; a.b = b; a.rb = rb; a.pe_d = pe_d; a.pe_u = pe_u; a.q = q;
  a.x0 = x0; a.s0 = s0; a.lam0 = lam0; a.y0 = y0; a.act = act; a.cw = cw;
  a.x_fin = x_fin; a.y_fin = y_fin; a.s_fin = s_fin; a.lam_fin = lam_fin;
  a.y_last = y_last; a.merit = merit; a.lam_mid = lam_mid;
  a.lam_fin_max = lam_fin_max;
  a.nfd = nfd; a.m_p = m_p; a.blk = blk; a.nb_p = nb_p; a.n_ball = n_ball;
  a.mc = mc; a.groups = ipm::row_groups(threads, m_p);
  a.n_iters = n_iters; a.snap_iters = snap_iters;
  a.sigma_min = sigma_min; a.tau = tau; a.alpha_max = alpha_max;
  a.w_cap = w_cap; a.reg = reg; a.snap_rho = snap_rho;
  a.margin = (float)(3.0 / (double)snap_rho);
  const size_t smem =
      (size_t)make_layout(nfd, m_p, blk, nb_p, a.groups).total * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ipm_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  ipm_solve_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
