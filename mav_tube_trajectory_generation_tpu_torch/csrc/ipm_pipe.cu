// One pipelined interior-point step per scenario, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel _pipe_kernel (ipm_pipe_step) of the JAX
// package's ops/ipm_kernel.py.
//
// Per scenario:
//   update (upd_mode newton or snap): finish the previous step from the
//     caller's equilibrated block-Thomas factors -- the column solve
//     dx = D (I+L)^-T S^-1 (I+L)^-1 D rhs as 3 m - 2 blk x blk matvecs, 2 m - 1
//     of them dependent, gdx = G dx, then
//       newton: fraction-to-boundary step on (s, lam), the update gated on a
//         finite direction (select, never scale), merit, best iterate;
//       snap: seven-point line search on phi = sum cw max(c, 0)^2 along gdx
//         from the best iterate;
//   evaluation (eval_mode newton or snap): the next point's y, c, J^T
//     weights and weighted-Gram band, written out as hd = band + pe_d + reg I,
//     hu = band + pe_u, and the next right-hand side.  eval_mode none writes
//     zeros.
//
// What bounds it on an H100: the evaluation's band products (see
// ipm_eval.cu), plus one more matvec against G^T for gdx; with each input
// read once the memory traffic (0.35 MB a scenario, the factors and the
// objective band included) is a little ahead of the float32 arithmetic.
// The cluster design moves each input once, but runs at ~4x that bound:
// a scenario takes ~52k cycles in some twenty barrier-separated phases, the
// largest (the band products) under a fifth of it, each far from the SM's
// instruction and shared-memory rates; the chain of phases and its
// latencies, not bytes or arithmetic, bound it (stage_profile.py --kernel
// ipm_pipe, on an H100 80GB HBM3 at 700 W).
//
// Two designs (ipm_pipe_design names the one a shape takes):
//   cluster  one scenario a cluster of two blocks (ipm_cluster.cuh).  Each
//            block starts the copy of its half of G^T into shared memory on
//            entry (TMA), and runs the column solve while it lands: every
//            thread of the solve holds one row of one factor block in
//            registers, read from device memory once, so a step of the chain
//            is one register-by-shared dot and a barrier (one warp passing
//            the vector by shuffles took 14.6k cycles against 6.4k, its
//            chain exposed: H100 80GB HBM3 at 700 W, stage_profile.py).  G
//            dx, the update and the evaluation then read G^T from shared
//            memory; the lane sums of the update (mu, the step-length
//            minima, the merit, the line search's sums) and of the
//            evaluation are combined over the cluster.  G^T leaves device
//            memory once.
//   stream   one block a scenario (ipm_common.cuh), for shapes whose share
//            does not fit: the block walks G^T from L2 / device memory four
//            times (gdx, y, the J^T reductions, the Gram tiles), and the
//            column solve is a chain of dependent matvecs on blk threads
//            with the factors staged in shared memory.

#include "ipm_cluster.cuh"
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
  CUtensorMap gt_map;   // G^T for the cluster design's TMA boxes
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
  extern __shared__ __align__(128) float smem[];
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

// ---- the cluster design ----------------------------------------------------

using ipm::pmax;
using ipm::pmin;
using ipmc::BMAX;
using ipmc::Ctx;

// sum_c f[c] v[c] for a factor row held in registers, c < blk, as four
// interleaved partial sums (c mod 4) added in the order (0 + 1) + (2 + 3):
// a short dependent chain for a step of the column solve.
__device__ __forceinline__ float dotf(const float (&f)[BMAX], const float* v,
                                      int blk) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < BMAX; ++c)
    if (c < blk) acc[c & 3] = fmaf(f[c], v[c], acc[c & 3]);
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// One scenario a cluster of two blocks (blockIdx.x / 2).
__global__ void __launch_bounds__(512, 1)
ipm_pipe_cluster_kernel(const __grid_constant__ PipeArgs a) {
  extern __shared__ __align__(128) float smem[];
  IPM_PROF(-1);
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const Ctx C = ipmc::make_ctx(smem, ipmc::kPipe, a.nfd, a.m_p, a.blk,
                               a.nb_p, a.n_ball);
  const ipmc::CLayout& L = C.L;
  const int sc = blockIdx.x / ipmc::kCluster;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nfd = a.nfd, m_p = a.m_p, blk = a.blk, nb_p = a.nb_p;
  const int m_blk = nfd / blk, bb = blk * blk, nl = C.q.nl;
  const float mc = (float)a.mc;

  // ---- the factor rows of the column solve, one a thread, in registers ----
  // threads [0, m blk): row fk of S_fi^-1; then m - 1 blocks of T; then TT.
  // Loads in flight first: they are read first.
  const int mb = m_blk * blk, tb = (m_blk - 1) * blk;
  int role = 0, fi = 0, fk = 0;
  float f[BMAX];
  if (a.upd_mode != kNone) {
    const float* frow = nullptr;
    if (tid < mb) {
      role = 1; fi = tid / blk; fk = tid - fi * blk;
      frow = a.sinv + ((size_t)sc * m_blk + fi) * bb + fk * blk;
    } else if (tid < mb + tb) {
      role = 2; fi = (tid - mb) / blk; fk = tid - mb - fi * blk;
      frow = a.t + ((size_t)sc * (m_blk - 1) + fi) * bb + fk * blk;
    } else if (tid < mb + 2 * tb) {
      role = 3; fi = (tid - mb - tb) / blk; fk = tid - mb - tb - fi * blk;
      frow = a.tt + ((size_t)sc * (m_blk - 1) + fi) * bb + fk * blk;
    }
#pragma unroll
    for (int c = 0; c < BMAX; ++c)
      f[c] = (frow != nullptr && c < blk) ? __ldg(frow + c) : 0.0f;
  }

  // ---- the state (a cp.async group), then G^T's share (TMA) ---------------
  ipmc::ClVecs V;
  V.x = C.at(L.x); V.bx = C.at(L.bx); V.dx = C.at(L.dx); V.s = C.at(L.s);
  V.lam = C.at(L.lam); V.y = C.at(L.y); V.by = C.at(L.by);
  V.act = C.at(L.act); V.cw = C.at(L.cw); V.rb = C.at(L.rb);
  V.red = C.at(L.red); V.xch = C.at(L.xch);
  // Live only during the update, which ends before the evaluation writes
  // its lane weights: gdx, ds and dlam share the evaluation's arrays.
  V.gdx = C.at(L.wjs); V.ds = C.at(L.wa); V.dlam = C.at(L.wj);
  float* b_s = C.at(L.b);
  for (int l = tid; l < 4 * C.n4; l += nt) {
    if (l < nl) {
      const int gl = ipmc::lane_of(C.q, l, nb_p);
      const size_t g = (size_t)sc * m_p + gl;
      ipmc::cp_async4(b_s + l, a.b + g);
      ipmc::cp_async4(V.act + l, a.act + gl);
      ipmc::cp_async4(V.cw + l, a.cw + gl);
      ipmc::cp_async4(V.s + l, a.s + g);
      ipmc::cp_async4(V.lam + l, a.lam + g);
      ipmc::cp_async4(V.y + l, a.y + g);
      ipmc::cp_async4(V.by + l, a.by + g);
    } else {
      b_s[l] = 0.0f; V.act[l] = 0.0f; V.cw[l] = 0.0f; V.s[l] = 1.0f;
      V.lam[l] = 0.0f; V.y[l] = 0.0f; V.by[l] = 0.0f;
    }
    V.gdx[l] = 0.0f;
  }
  for (int l = tid; l < L.ldl; l += nt) C.at(L.lmask)[l] = 0.0f;
  for (int j = tid; j < C.q.hb; j += nt)
    ipmc::cp_async4(V.rb + j, a.rb + (size_t)sc * nb_p + C.q.j0 + j);
  for (int r = tid; r < nfd; r += nt) {
    ipmc::cp_async4(V.x + r, a.x + (size_t)sc * nfd + r);
    ipmc::cp_async4(V.bx + r, a.bx + (size_t)sc * nfd + r);
  }
  // this block's half of [pe_d | pe_u], added to the band it finishes
  const int e0 = C.rank == 0 ? 0 : L.eh, e1 = C.rank == 0 ? L.eh : L.nband;
  const float* ped = a.pe_d + (size_t)sc * nfd * blk;
  const float* peu = a.pe_u + (size_t)sc * (nfd - blk) * blk;
  float* pe_s = C.at(L.pe);
  if (a.eval_mode != kNone) {
    for (int e = e0 + tid; e < e1; e += nt)
      ipmc::cp_async4(pe_s + e - e0,
                      e < nfd * blk ? ped + e : peu + (e - nfd * blk));
  }
  ipmc::cp_async_commit();
  ipmc::start_gt_share(C, &a.gt_map, sc);
  float best_merit = a.bm[sc];
  IPM_PROF(15);

  // ---- dx: block-Thomas column solve against the factors, while the state
  // and G^T land (it reads only its registers, rhs and dsc) ----------------
  if (a.upd_mode != kNone) {
    float* rs = C.at(L.rs);    // D rhs, then the backward sweep's x
    float* u = C.at(L.u);
    float* z = C.at(L.z);
    const float* dsc = a.dsc + (size_t)sc * nfd;
    for (int r = tid; r < nfd; r += nt) {
      const float v = a.rhs[(size_t)sc * nfd + r] * dsc[r];
      rs[r] = v;
      if (r < blk) u[r] = v;
    }
    __syncthreads();
    // forward: u_i = r_i - T_{i-1} u_{i-1}
    for (int i = 1; i < m_blk; ++i) {
      if (role == 2 && fi == i - 1)
        u[i * blk + fk] = rs[i * blk + fk] - dotf(f, u + (i - 1) * blk, blk);
      __syncthreads();
    }
    // diagonal: z_i = S_i^-1 u_i;  x_{m-1} = z_{m-1}   (x in rs)
    if (role == 1) {
      const float v = dotf(f, u + fi * blk, blk);
      z[fi * blk + fk] = v;
      if (fi == m_blk - 1) rs[fi * blk + fk] = v;
    }
    __syncthreads();
    // backward: x_i = z_i - T_i^T x_{i+1}
    for (int i = m_blk - 2; i >= 0; --i) {
      if (role == 3 && fi == i)
        rs[i * blk + fk] = z[i * blk + fk] - dotf(f, rs + (i + 1) * blk, blk);
      __syncthreads();
    }
    for (int r = tid; r < nfd; r += nt) V.dx[r] = rs[r] * dsc[r];
    IPM_PROF(1);
  }

  ipmc::cp_async_wait_all();         // this thread's state has landed
  for (int l = tid; l < nl; l += nt)
    V.s[l] = pmax(V.s[l], 1e-14f) * V.act[l] + (1.0f - V.act[l]);

  // Both blocks have started (the other's shared memory is written from
  // now on) and the state is visible to every thread.
  cl.sync();
  IPM_PROF(0);
  int xb = 0;

  if (a.upd_mode != kNone) {
    ipmc::wait_gt_share(C);
    __syncthreads();
    IPM_PROF(2);
    // ---- gdx = G dx on this block's lanes -----------------------------------
    ipmc::col_dots(C, V.dx, nullptr, V.gdx);
    __syncthreads();
    IPM_PROF(3);
  } else {
    ipmc::wait_gt_share(C);
    __syncthreads();
  }

  if (a.upd_mode == kNewton) {
    ipmc::newton_update_cl(C, V, V.y, a.sigma_min, a.tau, a.alpha_max,
                           a.w_cap, mc, best_merit, xb);
  } else if (a.upd_mode == kSnap) {
    ipmc::snap_update_cl(C, V, xb);
  }
  IPM_PROF(4);

  // ---- evaluation at the (possibly moved) point ----------------------------
  // max lam over the lanes and (newton) sum cw s lam ride on its barrier
  float ext[2] = {0.0f, 0.0f};
  const int ext_op[2] = {ipmc::kMax, ipmc::kSum};
  for (int l = tid; l < nl; l += nt) {
    ext[0] = pmax(ext[0], V.act[l] > 0.0f ? V.lam[l] : 0.0f);
    ext[1] += V.cw[l] * V.s[l] * V.lam[l];
  }
  ipmc::block_reduce_n<2>(ext, ext_op, V.red);
  float* hd = a.hd + (size_t)sc * nfd * blk;
  float* hu = a.hu + (size_t)sc * (nfd - blk) * blk;
  float* rhs_o = a.rhs_o + (size_t)sc * nfd;
  const int r0 = C.rank == 0 ? 0 : L.rh, r1 = C.rank == 0 ? L.rh : nfd;
  const float* jt = C.at(L.jtp);
  if (a.eval_mode != kNone) {
    // one call site for both modes: the evaluation is the kernel's largest
    // code, inlined once
    const bool newton = a.eval_mode == kNewton;
    float* le = C.at(L.le);
    float* se = C.at(L.se);
    if (!newton) {
      for (int l = tid; l < 4 * C.n4; l += nt) {
        float lam_e = 0.0f;
        if (l < nl) {
          const float c = ipmc::c_loc(C, V.by, V.rb, l);
          lam_e = (c > -a.margin && V.act[l] > 0.0f) ? 1e-6f : 0.0f;
        }
        le[l] = lam_e;
        se[l] = l < nl ? lam_e / a.snap_rho : 1.0f;
      }
      __syncthreads();
    }
    IPM_PROF(11);
    ipmc::EvalIO io;
    io.pe = pe_s; io.hd = hd; io.hu = hu;
    io.x = newton ? V.x : V.bx;
    io.s = newton ? V.s : se;
    io.lam = newton ? V.lam : le;
    io.w_cap = newton ? a.w_cap : a.snap_rho;
    io.phr = !newton;
    io.y_out = newton ? V.y : C.at(L.ye);
    io.reg = newton ? a.reg : 1e-6f;
    ipmc::eval_point_cluster(C, io, ext, ext_op, xb);
    if (newton) {
      const float sig_mu = a.sigma_min * (ext[1] / mc);
      const float* q = a.q + (size_t)sc * nfd;
      for (int r = r0 + tid; r < r1; r += nt) {
        const float o = ipm::pe_band_mv_row(ped, peu, V.x, r, blk, m_blk);
        rhs_o[r] = -(o + q[r] + jt[r] + sig_mu * jt[L.ldw + r]);
      }
    } else {
      for (int r = r0 + tid; r < r1; r += nt) rhs_o[r] = -jt[r];
    }
  } else {
    ipmc::cluster_combine<2>(ext, ext_op, V.xch, C.rank, xb);
    for (int e = e0 + tid; e < e1; e += nt) {
      if (e < nfd * blk) hd[e] = 0.0f;
      else hu[e - nfd * blk] = 0.0f;
    }
    for (int r = r0 + tid; r < r1; r += nt) rhs_o[r] = 0.0f;
  }
  IPM_PROF(9);

  // ---- outputs --------------------------------------------------------------
  for (int l = tid; l < nl; l += nt) {
    const size_t g = (size_t)sc * m_p + ipmc::lane_of(C.q, l, nb_p);
    a.s_o[g] = V.s[l];
    a.lam_o[g] = V.lam[l];
    a.y_o[g] = V.y[l];
    a.by_o[g] = V.by[l];
  }
  for (int r = r0 + tid; r < r1; r += nt) {
    a.x_o[(size_t)sc * nfd + r] = V.x[r];
    a.bx_o[(size_t)sc * nfd + r] = V.bx[r];
  }
  if (C.rank == 0 && tid == 0) {
    a.bm_o[sc] = best_merit;
    a.maxlam_o[sc] = ext[0];
  }
  IPM_PROF(10);
  IPM_PROF_FLUSH();
}

size_t cluster_smem_of(int nfd, int m_p, int blk, int nb_p) {
  return (size_t)ipmc::make_cluster_layout(ipmc::kPipe, nfd, m_p, blk, nb_p)
             .total * sizeof(float);
}

}  // namespace

// Dynamic shared memory, in bytes, that one block takes at these shapes.
extern "C" int ipm_pipe_smem_bytes(int nfd, int m_p, int blk, int nb_p,
                                   int threads) {
  return make_layout(nfd, m_p, blk, nb_p, ipm::row_groups(threads, m_p))
             .total * (int)sizeof(float);
}

// The design the step takes at these shapes on the current device: 1 the
// cluster design, 0 the stream design.
extern "C" int ipm_pipe_design(int nfd, int m_p, int blk, int nb_p,
                               int threads) {
  return ipmc::cluster_fits(ipmc::kPipe, nfd, m_p, blk, nb_p, threads) ? 1
                                                                       : 0;
}

// Dynamic shared memory, in bytes, of one block of the cluster design.
extern "C" int ipm_pipe_cluster_smem_bytes(int nfd, int m_p, int blk,
                                           int nb_p) {
  return (int)cluster_smem_of(nfd, m_p, blk, nb_p);
}

// How many clusters of the cluster design the device holds at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error code.
extern "C" int ipm_pipe_cluster_occupancy(int nfd, int m_p, int blk,
                                          int nb_p, int threads) {
  const size_t smem = cluster_smem_of(nfd, m_p, blk, nb_p);
  cudaError_t e = cudaFuncSetAttribute(
      ipm_pipe_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      ipmc::cluster_config(1, threads, smem, nullptr, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, ipm_pipe_cluster_kernel, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// Launches one pipelined step for `batch` scenarios on `stream`, in the
// design ipm_pipe_design names.  Modes: 0 none, 1 newton, 2 snap.  Returns
// the CUDA error code of the launch (0 on success); does not synchronise.
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
  if (ipmc::cluster_fits(ipmc::kPipe, nfd, m_p, blk, nb_p, threads)) {
    const size_t csmem = cluster_smem_of(nfd, m_p, blk, nb_p);
    if (!ipmc::gt_tensor_map(
            &a.gt_map, gt, batch, nfd, m_p,
            ipmc::make_cluster_layout(ipmc::kPipe, nfd, m_p, blk, nb_p)
                .lds))
      return (int)cudaErrorNotSupported;
    cudaError_t e = cudaFuncSetAttribute(
        ipm_pipe_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)csmem);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        ipmc::cluster_config(batch, threads, csmem, stream, attr);
    e = cudaLaunchKernelEx(&cfg, ipm_pipe_cluster_kernel, a);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  const size_t smem =
      (size_t)make_layout(nfd, m_p, blk, nb_p, a.groups).total * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ipm_pipe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ipm_pipe_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#ifdef IPM_PIPE_PROFILE
// The phase profile's sums (2 x 32 counters: the first wave's block, then
// the middle scenario's), and their reset.
extern "C" int ipm_pipe_profile_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, ipmc::ipm_prof,
                                   sizeof(ipmc::ipm_prof));
}

extern "C" int ipm_pipe_profile_clear() {
  const unsigned long long zero[2][32] = {};
  return (int)cudaMemcpyToSymbol(ipmc::ipm_prof, zero, sizeof(zero));
}
#endif
