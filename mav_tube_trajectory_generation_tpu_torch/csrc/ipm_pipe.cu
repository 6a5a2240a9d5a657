// One pipelined interior-point step per scenario, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel _pipe_kernel (ipm_pipe_step) of the JAX
// package's ops/ipm_kernel.py.
//
// Per scenario (one thread block each):
//   update (upd_mode newton or snap): finish the previous step from the
//     caller's equilibrated block-Thomas factors -- the column solve
//     dx = D (I+L)^-T S^-1 (I+L)^-1 D rhs as 3 m - 2 dependent blk x blk
//     matvecs, gdx = G dx, then
//       newton: fraction-to-boundary step on (s, lam), the update gated on a
//         finite direction (select, never scale), merit, best iterate;
//       snap: seven-point line search on phi = sum cw max(c, 0)^2 along gdx
//         from the best iterate;
//   evaluation (eval_mode newton or snap): the next point's y, c, J^T
//     weights and weighted-Gram band (ipm_common.cuh, eval_point), written
//     out as hd = band + pe_d + reg I, hu = band + pe_u, and the next
//     right-hand side.  eval_mode none writes zeros.
//
// What bounds it on an H100: the evaluation's band products (see
// ipm_eval.cu), plus one more matvec against G^T for gdx; with each input
// read once the memory traffic (0.35 MB a scenario, the factors and the
// objective band included) is a little ahead of the float32 arithmetic.  As
// built the block walks G^T four times (gdx, y, the J^T reductions, the Gram
// tiles), the last three from L2 or device memory.  The column solve is a chain of 25 dependent 15 x 15 matvecs on
// blk threads with a barrier between them: short, and latency-bound.

#include "ipm_common.cuh"

namespace {

enum Mode { kNone = 0, kNewton = 1, kSnap = 2 };

struct PipeArgs {
  // inputs
  const float *gt, *b, *rb, *pe_d, *pe_u, *q, *x, *s, *lam, *y, *bx, *by, *bm;
  const float *sinv, *t, *tt, *dsc, *rhs, *act, *cw;
  // outputs
  float *x_o, *s_o, *lam_o, *y_o, *bx_o, *by_o, *bm_o, *maxlam_o, *hd, *hu;
  float *rhs_o;
  int nfd, m_p, blk, nb_p, n_ball, mc, groups, upd_mode, eval_mode;
  float sigma_min, tau, alpha_max, w_cap, reg, snap_rho, margin;
};

struct Layout {
  int sinv, t, tt;
  int b, act, cw, s, lam, y, by, se, le, rb;
  int x, bx, dx, rs, u, z;
  ipm::EvalLayout ev;
  int total;
};

__host__ __device__ inline Layout make_layout(int nfd, int m_p, int blk,
                                              int nb_p, int groups) {
  Layout L;
  const int m_blk = nfd / blk, bb = blk * blk;
  int o = 0;
  L.sinv = o; o += ipm::round4(m_blk * bb);
  L.t = o;    o += ipm::round4((m_blk - 1) * bb);
  L.tt = o;   o += ipm::round4((m_blk - 1) * bb);
  L.b = o;    o += m_p;
  L.act = o;  o += m_p;
  L.cw = o;   o += m_p;
  L.s = o;    o += m_p;
  L.lam = o;  o += m_p;
  L.y = o;    o += m_p;
  L.by = o;   o += m_p;
  L.se = o;   o += m_p;
  L.le = o;   o += m_p;
  L.rb = o;   o += ipm::round4(nb_p);
  L.x = o;    o += ipm::round4(nfd);
  L.bx = o;   o += ipm::round4(nfd);
  L.dx = o;   o += ipm::round4(nfd);
  L.rs = o;   o += ipm::round4(nfd);
  L.u = o;    o += ipm::round4(nfd);
  L.z = o;    o += ipm::round4(nfd);
  L.ev = ipm::eval_layout(o, nfd, m_p, blk, nb_p, groups);
  L.total = L.ev.total;
  return L;
}

using ipm::block_row_dot;

__global__ void __launch_bounds__(512, 2)
ipm_pipe_kernel(PipeArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int sc = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nfd = a.nfd, m_p = a.m_p, blk = a.blk, nb_p = a.nb_p;
  const int n_ball = a.n_ball;
  const int m_blk = nfd / blk, bb = blk * blk;
  const Layout L = make_layout(nfd, m_p, blk, nb_p, a.groups);
  const float mc = (float)a.mc;

  const float* gt = a.gt + (size_t)sc * nfd * m_p;
  float* sinv_s = smem + L.sinv;
  float* t_s = smem + L.t;
  float* tt_s = smem + L.tt;
  float* b_s = smem + L.b;
  float* act_s = smem + L.act;
  float* cw_s = smem + L.cw;
  float* s_s = smem + L.s;
  float* lam_s = smem + L.lam;
  float* y_s = smem + L.y;
  float* by_s = smem + L.by;
  float* se_s = smem + L.se;
  float* le_s = smem + L.le;
  // Live only during the update, which ends before the evaluation writes
  // its lane weights: gdx, ds and dlam share the evaluation's arrays.
  float* gdx_s = smem + L.ev.wjs;
  float* ds_s = smem + L.ev.wa;
  float* dlam_s = smem + L.ev.wj;
  float* rb_s = smem + L.rb;
  float* x_s = smem + L.x;
  float* bx_s = smem + L.bx;
  float* dx_s = smem + L.dx;
  float* rs_s = smem + L.rs;
  float* u_s = smem + L.u;
  float* z_s = smem + L.z;
  float* part_s = smem + L.ev.part;
  float* red_s = smem + L.ev.red;

  // ---- load the scenario's state -------------------------------------------
  for (int l = tid; l < m_p; l += nt) {
    const float act = a.act[l];
    b_s[l] = a.b[(size_t)sc * m_p + l];
    act_s[l] = act;
    cw_s[l] = a.cw[l];
    s_s[l] = ipm::pmax(a.s[(size_t)sc * m_p + l], 1e-14f) * act + (1.0f - act);
    lam_s[l] = a.lam[(size_t)sc * m_p + l];
    y_s[l] = a.y[(size_t)sc * m_p + l];
    by_s[l] = a.by[(size_t)sc * m_p + l];
  }
  for (int j = tid; j < nb_p; j += nt) rb_s[j] = a.rb[(size_t)sc * nb_p + j];
  for (int r = tid; r < nfd; r += nt) {
    x_s[r] = a.x[(size_t)sc * nfd + r];
    bx_s[r] = a.bx[(size_t)sc * nfd + r];
  }
  float best_merit = a.bm[sc];
  __syncthreads();

  if (a.upd_mode != kNone) {
    // ---- dx: block-Thomas column solve against the given factors -----------
    for (int i = tid; i < m_blk * bb; i += nt)
      sinv_s[i] = a.sinv[(size_t)sc * m_blk * bb + i];
    for (int i = tid; i < (m_blk - 1) * bb; i += nt) {
      t_s[i] = a.t[(size_t)sc * (m_blk - 1) * bb + i];
      tt_s[i] = a.tt[(size_t)sc * (m_blk - 1) * bb + i];
    }
    for (int r = tid; r < nfd; r += nt)
      rs_s[r] = a.rhs[(size_t)sc * nfd + r] * a.dsc[(size_t)sc * nfd + r];
    __syncthreads();
    // forward: u_i = r_i - T_{i-1} u_{i-1}
    for (int i = 0; i < m_blk; ++i) {
      if (tid < blk) {
        float v = rs_s[i * blk + tid];
        if (i)
          v -= block_row_dot(t_s + (i - 1) * bb, u_s + (i - 1) * blk, tid, blk);
        u_s[i * blk + tid] = v;
      }
      __syncthreads();
    }
    // diagonal: z_i = S_i^-1 u_i
    for (int r = tid; r < nfd; r += nt) {
      const int i = r / blk;
      z_s[r] = block_row_dot(sinv_s + i * bb, u_s + i * blk, r - i * blk, blk);
    }
    __syncthreads();
    // backward: x_{m-1} = z_{m-1}; x_i = z_i - T_i^T x_{i+1}   (in u_s)
    for (int i = m_blk - 1; i >= 0; --i) {
      if (tid < blk) {
        float v = z_s[i * blk + tid];
        if (i + 1 < m_blk)
          v -= block_row_dot(tt_s + i * bb, u_s + (i + 1) * blk, tid, blk);
        u_s[i * blk + tid] = v;
      }
      __syncthreads();
    }
    for (int r = tid; r < nfd; r += nt)
      dx_s[r] = u_s[r] * a.dsc[(size_t)sc * nfd + r];
    __syncthreads();

    // ---- gdx = G dx ---------------------------------------------------------
    ipm::cols_dot(gt, dx_s, part_s, nfd, m_p, a.groups);
    __syncthreads();
    for (int l = tid; l < m_p; l += nt)
      gdx_s[l] = ipm::gather_groups(part_s, l, m_p, a.groups);
    __syncthreads();
  }

  ipm::StepState st;
  st.x = x_s; st.s = s_s; st.lam = lam_s; st.y = y_s; st.bx = bx_s;
  st.by = by_s; st.act = act_s; st.cw = cw_s; st.rb = rb_s; st.dx = dx_s;
  st.gdx = gdx_s; st.ds = ds_s; st.dlam = dlam_s; st.red = red_s;
  st.nfd = nfd; st.m_p = m_p; st.nb_p = nb_p; st.n_ball = n_ball; st.mc = mc;
  if (a.upd_mode == kNewton) {
    ipm::newton_update(st, y_s, a.sigma_min, a.tau, a.alpha_max, a.w_cap,
                       best_merit);
  } else if (a.upd_mode == kSnap) {
    ipm::snap_update(st);
  }

  // ---- evaluation at the (possibly moved) point ----------------------------
  ipm::EvalDims d;
  d.nfd = nfd; d.m_p = m_p; d.blk = blk; d.nb_p = nb_p; d.n_ball = n_ball;
  d.groups = a.groups;
  float* hd = a.hd + (size_t)sc * nfd * blk;
  float* hu = a.hu + (size_t)sc * (nfd - blk) * blk;
  float* rhs_o = a.rhs_o + (size_t)sc * nfd;
  const float* ped = a.pe_d + (size_t)sc * nfd * blk;
  const float* peu = a.pe_u + (size_t)sc * (nfd - blk) * blk;
  if (a.eval_mode == kNewton) {
    ipm::eval_point(gt, b_s, rb_s, x_s, s_s, lam_s, a.w_cap, false, d, smem,
                    L.ev, hd, hu, ped, peu, a.reg);
    float p_mu = 0.0f;
    for (int l = tid; l < m_p; l += nt) p_mu += cw_s[l] * s_s[l] * lam_s[l];
    const float mu = ipm::block_reduce<ipm::OpSum>(p_mu, red_s) / mc;
    const float sig_mu = a.sigma_min * mu;
    const float* q = a.q + (size_t)sc * nfd;
    for (int r = tid; r < nfd; r += nt) {
      const float o = ipm::pe_band_mv_row(ped, peu, x_s, r, blk, m_blk);
      rhs_o[r] = -(o + q[r] + smem[L.ev.jtwr2 + r] +
                   sig_mu * smem[L.ev.jts + r]);
    }
    for (int l = tid; l < m_p; l += nt) y_s[l] = smem[L.ev.y + l];
  } else if (a.eval_mode == kSnap) {
    for (int l = tid; l < m_p; l += nt) {
      const float c = ipm::c_at(by_s, rb_s, l, nb_p, n_ball);
      const float lam_e = (c > -a.margin && act_s[l] > 0.0f) ? 1e-6f : 0.0f;
      le_s[l] = lam_e;
      se_s[l] = lam_e / a.snap_rho;
    }
    ipm::eval_point(gt, b_s, rb_s, bx_s, se_s, le_s, a.snap_rho, true, d, smem,
                    L.ev, hd, hu, ped, peu, 1e-6f);
    for (int r = tid; r < nfd; r += nt) rhs_o[r] = -smem[L.ev.jtwr2 + r];
  } else {
    for (int i = tid; i < nfd * blk; i += nt) hd[i] = 0.0f;
    for (int i = tid; i < (nfd - blk) * blk; i += nt) hu[i] = 0.0f;
    for (int r = tid; r < nfd; r += nt) rhs_o[r] = 0.0f;
  }
  __syncthreads();

  // ---- outputs --------------------------------------------------------------
  float ml = 0.0f;
  for (int l = tid; l < m_p; l += nt) {
    a.s_o[(size_t)sc * m_p + l] = s_s[l];
    a.lam_o[(size_t)sc * m_p + l] = lam_s[l];
    a.y_o[(size_t)sc * m_p + l] = y_s[l];
    a.by_o[(size_t)sc * m_p + l] = by_s[l];
    ml = ipm::pmax(ml, act_s[l] > 0.0f ? lam_s[l] : 0.0f);
  }
  for (int r = tid; r < nfd; r += nt) {
    a.x_o[(size_t)sc * nfd + r] = x_s[r];
    a.bx_o[(size_t)sc * nfd + r] = bx_s[r];
  }
  ml = ipm::block_reduce<ipm::OpMax>(ml, red_s);
  if (tid == 0) {
    a.bm_o[sc] = best_merit;
    a.maxlam_o[sc] = ml;
  }
}

}  // namespace

// Dynamic shared memory, in bytes, that one block takes at these shapes.
extern "C" int ipm_pipe_smem_bytes(int nfd, int m_p, int blk, int nb_p,
                                   int threads) {
  return make_layout(nfd, m_p, blk, nb_p, ipm::row_groups(threads, m_p))
             .total * (int)sizeof(float);
}

// Launches one pipelined step for `batch` scenarios on `stream`.  Modes:
// 0 none, 1 newton, 2 snap.  Returns the CUDA error code of the launch (0 on
// success); does not synchronise.
extern "C" int ipm_pipe_step_launch(
    const float* gt, const float* b, const float* rb, const float* pe_d,
    const float* pe_u, const float* q, const float* x, const float* s,
    const float* lam, const float* y, const float* bx, const float* by,
    const float* bm, const float* sinv, const float* t, const float* tt,
    const float* dsc, const float* rhs, const float* act, const float* cw,
    float* x_o, float* s_o, float* lam_o, float* y_o, float* bx_o, float* by_o,
    float* bm_o, float* maxlam_o, float* hd, float* hu, float* rhs_o,
    int batch, int nfd, int m_p, int blk, int nb_p, int n_ball, int mc,
    float sigma_min, float tau, float alpha_max, float w_cap, float reg,
    float snap_rho, int upd_mode, int eval_mode, int threads, void* stream) {
  if (threads < 64 || threads > 512 || threads % 32 != 0 || m_p % 4 != 0 ||
      blk < 1 || threads < blk || nfd % blk != 0 || nfd < 2 * blk ||
      3 * nb_p > m_p || n_ball < 0 || n_ball > nb_p || batch < 1 || mc < 1 ||
      upd_mode < 0 || upd_mode > 2 || eval_mode < 0 || eval_mode > 2)
    return (int)cudaErrorInvalidValue;
  PipeArgs a;
  a.gt = gt; a.b = b; a.rb = rb; a.pe_d = pe_d; a.pe_u = pe_u; a.q = q;
  a.x = x; a.s = s; a.lam = lam; a.y = y; a.bx = bx; a.by = by; a.bm = bm;
  a.sinv = sinv; a.t = t; a.tt = tt; a.dsc = dsc; a.rhs = rhs; a.act = act;
  a.cw = cw;
  a.x_o = x_o; a.s_o = s_o; a.lam_o = lam_o; a.y_o = y_o; a.bx_o = bx_o;
  a.by_o = by_o; a.bm_o = bm_o; a.maxlam_o = maxlam_o; a.hd = hd; a.hu = hu;
  a.rhs_o = rhs_o;
  a.nfd = nfd; a.m_p = m_p; a.blk = blk; a.nb_p = nb_p; a.n_ball = n_ball;
  a.mc = mc; a.groups = ipm::row_groups(threads, m_p);
  a.upd_mode = upd_mode; a.eval_mode = eval_mode;
  a.sigma_min = sigma_min; a.tau = tau; a.alpha_max = alpha_max;
  a.w_cap = w_cap; a.reg = reg; a.snap_rho = snap_rho;
  a.margin = (float)(3.0 / (double)snap_rho);
  const size_t smem =
      (size_t)make_layout(nfd, m_p, blk, nb_p, a.groups).total * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ipm_pipe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ipm_pipe_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
