// The whole plane-layout interior-point polish of one scenario in one launch,
// for Hopper (sm_90a).  Replaces the Pallas TPU kernel _solve_kernel
// (ipm_solve_fused) of the JAX package's ops/ipm_kernel.py.
//
// Per scenario, from the start point (x0, s0, lam0, y0):
//   n_iters single-direction Newton steps at fixed centring sigma_min: slack
//     floor, evaluation of the point (y, c, the two J^T reductions and the
//     2 m - 1 band blocks of the weighted Gram, with the objective band and
//     reg I added), right-hand side -(P x + q + J^T (w r2) + sigma mu
//     J^T (1/s)), the band factor and solve below, G dx, then the gated
//     update with best-iterate tracking;
//   snap_iters Gauss-Newton feasibility sweeps from the best iterate: clipped
//     multipliers on the near-boundary rows, the clipped-penalty evaluation
//     at weight snap_rho, reg 1e-6, the same factor and solve, and the
//     seven-point line search.
//
// The band factor (the plain version's, ops/ipm_kernel.py,
// _band_factor_solve).  H = blocktridiag(hd, hu) is Jacobi-equilibrated
// (D H D, D = rsqrt(max(diag H, 1e-30)): load-bearing in float32, the
// unscaled factor flips dx to an ascent direction on stiff active sets) and
// factored from both ends towards the middle block (a twisted block
// Cholesky): each block's L_b with every pivot at least kPivotFloor (the
// equilibrated diagonal is 1), together with L_b^-1, C_b = L_b^-1 U_b (U_b
// its coupling to the next block of its sweep) and z_b, from one Gaussian
// elimination of [S_b | I | U_b | v_b], S_b = hd_b - C_p^T C_p, v_b =
// D rhs_b - C_p^T z_p (p the neighbour factored before it; the middle block
// takes both); then x outwards from the middle, x_b = L_b^-T (z_b - C_b x_p),
// dx = D x.  The floor makes the factor that of an SPD matrix H + E (E >= 0
// diagonal), so the direction descends on its model where float32 cannot
// resolve a pivot: the JAX kernel's Gauss-Jordan inverses of the pivot
// blocks lose the snap direction in rows whose snap Hessian nears a
// condition of 1e12 (chip_smoke.py's factor-alone check).  The whole block
// steps through a pivot block's elimination, a thread an entry and a
// barrier a pivot step (each step is short and issue-bound: one warp doing
// the chain alone in registers, as a Cholesky and substitutions or with
// shuffles, ran several times slower, each of its shuffles, loads and
// divisions waiting for the last, three of the SM's four schedulers idle).
//
// Two designs (ipm_solve_design names the one a shape takes):
//   cluster  one scenario a cluster of two blocks (ipm_cluster.cuh), both
//            running the polish in step.  Each block's half of G^T lands
//            once by TMA and stays in shared memory for every step (one read
//            of G^T from device memory a polish, where the one-block body
//            walks it four times a step); the evaluation is #8's and #9's
//            (lanes split by ball index, the band from the lanes that reach
//            each row block, partials summed rank 0 + rank 1), its band and
//            J^T rows then in both blocks; the twisted factor's two sweeps run
//            one a block, the blocks next to the middle exchanged, the middle
//            factored in both, each block finding its half of x and both
//            getting all of dx; G dx, the update and the line search on each
//            block's lanes, their sums combined over the cluster.
//   stream   one block a scenario for shapes whose share does not fit (K=12):
//            G^T from L2 / device memory four times a step (y, the J^T
//            reductions, the Gram tiles, G dx), both sweeps in turn.
//
// What bounds it on an H100: with every input read once, G^T is 0.28 MB a
// scenario while one step's band products are about 5 MFLOP, so a polish of
// twelve steps is bound by float32 arithmetic (about 0.9 us a scenario
// against 0.08 us of memory traffic).  The cluster design is bound by
// neither: a step is some thirty barrier-separated phases and the factor's
// chain of pivot steps, each short and latency-bound (stage_profile.py
// --kernel ipm_solve: cycles a step by part).

#include "ipm_cluster.cuh"
#include "ipm_common.cuh"

// The factor-alone check (chip_smoke.py builds this source with
// -DIPM_SOLVE_DUMP): the first snap sweep of every scenario writes the band
// it factors (hd then hu, with the objective band and reg I in, before the
// equilibration), its right-hand side and the direction dx the kernel's
// factor gives, (nband + 2 nfd) floats a scenario from ipm_solve_dump.  With
// -DIPM_SOLVE_STREAM every shape takes the one-block body (stage_profile.py
// --kernel ipm_solve times it against the cluster design on the same call).
#ifdef IPM_SOLVE_DUMP
__device__ float* ipm_solve_dump = nullptr;
#endif

namespace {

struct SolveArgs {
  // inputs
  const float *gt, *b, *rb, *pe_d, *pe_u, *q, *x0, *s0, *lam0, *y0, *act, *cw;
  // outputs
  float *x_fin, *y_fin, *s_fin, *lam_fin, *y_last, *merit, *lam_mid;
  float *lam_fin_max;
  int nfd, m_p, blk, nb_p, n_ball, mc, groups, n_iters, snap_iters;
  float sigma_min, tau, alpha_max, w_cap, reg, snap_rho, margin;
  CUtensorMap gt_map;   // G^T for the cluster design's TMA boxes
};

struct Layout {
  int b, act, cw, s, lam, y, by, rb;
  int x, bx, dx, rhs, z, dsc;
  int hd, hu;
  ipm::EvalLayout ev;
  int lf, cf;       // inside the evaluation's tile buffer
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
  L.z = o;    o += ipm::round4(nfd);
  L.dsc = o;  o += ipm::round4(nfd);
  L.hd = o;   o += ipm::round4(m_blk * bb);
  L.hu = o;   o += ipm::round4((m_blk - 1) * bb);
  L.ev = ipm::eval_layout(o, nfd, m_p, blk, nb_p, groups);
  L.lf = L.ev.tile;
  L.cf = L.lf + m_blk * bb;
  L.total = L.ev.total;
  return L;
}

// Do the factors fit the tile buffer they share?
__host__ __device__ inline bool factors_fit(int nfd, int blk) {
  const int m_blk = nfd / blk, bb = blk * blk;
  return (2 * m_blk - 1) * bb <=
         ipm::round4((nfd + 2 * blk + ipm::KN) * ipm::TILE_LD);
}

// The floor under the band factor's pivots (ops/ipm_kernel.py,
// PIVOT_FLOOR, and why): the equilibrated diagonal is 1.  A build may set
// another (-DIPM_PIVOT_FLOOR=1e-6f: pivot_floor_sweep.py's candidates);
// ipm_solve_pivot_floor says which one a library holds.
#ifndef IPM_PIVOT_FLOOR
#define IPM_PIVOT_FLOOR 1e-4f
#endif
constexpr float kPivotFloor = IPM_PIVOT_FLOOR;

// Jacobi equilibration of the band in place: dsc = rsqrt(max(diag, 1e-30)),
// hd and hu scaled to D H D.  Must be reached by every thread.
__device__ void equilibrate(float* hd, float* hu, float* dsc, int nfd,
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
}


// The band factor's pieces (as described at the top, in the order of the
// plain version, ops/ipm_kernel.py, _band_factor_solve).  The band is
// factored from both ends towards the middle block mid = (m - 1) / 2: the
// blocks 0 .. mid-1 top-down, the blocks m-1 .. mid+1 bottom-up, then mid.
// C_b, the coupling of block b to the next block of its sweep, lives in cf
// slot b (top) or b - 1 (bottom); L_b^-1 in lf block b; z_b, then x_b, in z
// block b.
struct Band {
  float *hd, *hu, *dsc, *lf, *cf, *w, *rhs, *z, *dx;
  int nfd, blk, m_blk, mid;
};

__device__ __forceinline__ int cslot(const Band& F, int b) {
  return b < F.mid ? b : b - 1;
}

// sum_k a[k * sa] b[k * sb], k0 <= k < blk, two partial sums (even and odd
// k) for a shorter chain
__device__ __forceinline__ float bdot(const float* a, int sa, const float* b,
                                      int sb, int k0, int blk) {
  float acc[2] = {0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < ipmc::BMAX; ++k)
    if (k >= k0 && k < blk)
      acc[k & 1] = fmaf(a[k * sa], b[k * sb], acc[k & 1]);
  return acc[0] + acc[1];
}

// Block b, its neighbours p0, p1 (-1: none) already factored, with a
// barrier after each phase:
//   1. into w (blk rows of lw = 3 blk + 1): [S_b | I | U_b | v_b] with S_b =
//      hd_b - C_p0^T C_p0 - C_p1^T C_p1, v_b = D rhs_b - C_p0^T z_p0 - ...,
//      U_b the super block toward the next block (hu_b; bottom-up hu_{b-1}
//      transposed; none for the middle);
//   2. blk steps of Gaussian elimination of w in place, pivots floored (the
//      pivots of the floored Cholesky: S_b + E = L_b L_b^T), a thread a
//      column and rows below the pivot: step k updates the rows below k,
//      its pivot row and column k untouched, so one barrier a step (two
//      steps a barrier, each thread recomputing what step k gives row k + 1
//      with the same rounded operations, gave the same bits but ran slower:
//      more live registers in the one kernel, more spills);
//   3. row r of the right-hand part over sqrt(pivot r) is row r of
//      [L_b^-1 | C_b | z_b].
// Each thread's indices are fixed (the steps are short and issue-bound).
// Must be reached by every thread.
__device__ void factor_block(const Band& F, int b, int p0, int p1) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int blk = F.blk, bb = blk * blk, lw = 3 * blk + 1;
  const bool top = b < F.mid, cpl = b != F.mid;
  float* w = F.w;
  float* piv_s = w + blk * lw;             // the block's pivots
  const float* c0 = p0 >= 0 ? F.cf + cslot(F, p0) * bb : nullptr;
  const float* c1 = p1 >= 0 ? F.cf + cslot(F, p1) * bb : nullptr;
  const float* u = F.hu + (top ? b : b - 1) * bb;
  // phase 1: S_b (thread e < bb), v_b (the next blk), I and U_b (all)
  if (tid < bb) {
    const int r = tid / blk, c = tid - r * blk;
    float v = F.hd[b * bb + tid];
    if (c0) v -= bdot(c0 + r, blk, c0 + c, blk, 0, blk);
    if (c1) v -= bdot(c1 + r, blk, c1 + c, blk, 0, blk);
    w[r * lw + c] = v;
  } else if (tid < bb + blk) {
    const int r = tid - bb;
    float v = F.rhs[b * blk + r] * F.dsc[b * blk + r];
    if (c0) v -= bdot(c0 + r, blk, F.z + p0 * blk, 1, 0, blk);
    if (c1) v -= bdot(c1 + r, blk, F.z + p1 * blk, 1, 0, blk);
    w[r * lw + 3 * blk] = v;
  }
  for (int t = tid; t < 2 * bb; t += nt) {
    const int e = t < bb ? t : t - bb, r = e / blk, c = e - r * blk;
    float v;
    if (t < bb) v = r == c ? 1.0f : 0.0f;
    else v = !cpl ? 0.0f : top ? u[e] : u[c * blk + r];
    w[r * lw + (t < bb ? blk : 2 * blk) + c] = v;
  }
  __syncthreads();
  IPM_PROF(29);
  // phase 2: the elimination (a product, then a difference, each rounded:
  // the plain version's); the columns <= k of the S part are not written at
  // step k
  const int je = tid % lw, ro = tid / lw, rs = nt / lw;
  const bool s_col = je < blk;
  for (int k = 0; k < blk; ++k) {
    float piv = w[k * lw + k];
    piv = piv < kPivotFloor ? kPivotFloor : piv;       // NaN stays NaN
    if (tid == 0) piv_s[k] = piv;
    if (ro < rs && (!s_col || je > k)) {
      const float rp = __frcp_rn(piv), wk = w[k * lw + je];
      for (int r = k + 1 + ro; r < blk; r += rs) {
        const float m = __fmul_rn(w[r * lw + k], rp);
        w[r * lw + je] = __fsub_rn(w[r * lw + je], __fmul_rn(m, wk));
      }
    }
    __syncthreads();
  }
  IPM_PROF(30);
  // phase 3: [L_b^-1 | C_b | z_b]
  for (int t = tid; t < 2 * bb + blk; t += nt) {
    const int r = t < 2 * bb ? (t < bb ? t : t - bb) / blk : t - 2 * bb;
    const float rd = __frcp_rn(sqrtf(piv_s[r]));
    if (t < bb) {
      F.lf[b * bb + t] = w[r * lw + blk + t % blk] * rd;
    } else if (t < 2 * bb) {
      if (cpl)
        F.cf[cslot(F, b) * bb + t - bb] = w[r * lw + 2 * blk + t % blk] * rd;
    } else {
      F.z[b * blk + r] = w[r * lw + 3 * blk] * rd;
    }
  }
  __syncthreads();
}

// The blocks of one sweep (top-down from 0 to mid - 1, or bottom-up from
// m - 1 to mid + 1).  Must be reached by every thread.
__device__ void factor_sweep(const Band& F, bool top) {
  if (top) {
    for (int b = 0; b < F.mid; ++b) factor_block(F, b, b - 1, -1);
  } else {
    for (int b = F.m_blk - 1; b > F.mid; --b)
      factor_block(F, b, b + 1 < F.m_blk ? b + 1 : -1, -1);
  }
}

// The middle block, then x = L^-T z outwards from it over the blocks of
// the top half (top) and of the bottom half (bottom), in warp 0 (15
// threads a product, __syncwarp between), dx = D x for those blocks and
// the middle, to dx and (not null) dx_r too.  Must be reached by every
// thread; ends with the block in step.
__device__ void factor_middle_and_back(const Band& F, bool top, bool bottom,
                                       float* dx_r) {
  const int tid = threadIdx.x;
  const int blk = F.blk, bb = blk * blk, mid = F.mid;
  factor_block(F, mid, mid > 0 ? mid - 1 : -1,
               mid + 1 < F.m_blk ? mid + 1 : -1);
  IPM_PROF(22);
  if (tid < 32) {
    const int r = tid;
    // x_b = L_b^-T (z_b - C_b x_p), p the block nearer the middle (none for
    // the middle), the difference staged in rhs (free now)
    auto back = [&](int b, int p) {
      if (r < blk)
        F.rhs[b * blk + r] =
            p < 0 ? F.z[b * blk + r]
                  : F.z[b * blk + r] - bdot(F.cf + cslot(F, b) * bb + r * blk,
                                            1, F.z + p * blk, 1, 0, blk);
      __syncwarp();
      if (r < blk) {
        const float x =
            bdot(F.lf + b * bb + r, blk, F.rhs + b * blk, 1, r, blk);
        F.z[b * blk + r] = x;
        const float d = x * F.dsc[b * blk + r];
        F.dx[b * blk + r] = d;
        if (dx_r && b != mid) dx_r[b * blk + r] = d;
      }
      __syncwarp();
    };
    back(mid, -1);
    if (top)
      for (int b = mid - 1; b >= 0; --b) back(b, b + 1);
    if (bottom)
      for (int b = mid + 1; b < F.m_blk; ++b) back(b, b - 1);
  }
  __syncthreads();
  IPM_PROF(23);
}

// dx = H^-1 rhs in one block: both sweeps in turn, then the middle and
// every block's x.  hd, hu, rhs are overwritten.  Must be reached by every
// thread; ends with the block in step.
__device__ __noinline__ void band_factor_solve(const Band& F) {
  equilibrate(F.hd, F.hu, F.dsc, F.nfd, F.blk);
  factor_sweep(F, true);
  factor_sweep(F, false);
  factor_middle_and_back(F, true, true, nullptr);
}

__global__ void __launch_bounds__(512, 2)
ipm_solve_kernel(SolveArgs a) {
  extern __shared__ __align__(128) float smem[];
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
    // the elimination's rows in the evaluation's partial sums, idle here
    Band F;
    F.hd = hd_s; F.hu = hu_s; F.dsc = smem + L.dsc; F.lf = smem + L.lf;
    F.cf = smem + L.cf; F.w = part_s; F.rhs = rhs_s; F.z = smem + L.z;
    F.dx = dx_s; F.nfd = nfd; F.blk = blk; F.m_blk = m_blk;
    F.mid = (m_blk - 1) / 2;
    band_factor_solve(F);
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
#ifdef IPM_SOLVE_DUMP
    const int nband = (2 * m_blk - 1) * blk * blk;
    float* dump = ipm_solve_dump + (size_t)sc * (nband + 2 * nfd);
    if (j == 0) {
      for (int e = tid; e < nband; e += nt)
        dump[e] = e < m_blk * blk * blk ? hd_s[e] : hu_s[e - m_blk * blk * blk];
      for (int r = tid; r < nfd; r += nt) dump[nband + r] = rhs_s[r];
    }
#endif
    direction();
#ifdef IPM_SOLVE_DUMP
    if (j == 0)
      for (int r = tid; r < nfd; r += nt) dump[nband + nfd + r] = dx_s[r];
#endif
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


// ---- the cluster design -----------------------------------------------------

using ipm::pmax;
using ipm::pmin;
using ipmc::Ctx;

// One scenario a cluster of two blocks (blockIdx.x / 2), both running the
// whole polish in step.
__global__ void __launch_bounds__(512, 1)
ipm_solve_cluster_kernel(const __grid_constant__ SolveArgs a) {
  extern __shared__ __align__(128) float smem[];
  IPM_PROF(-1);
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const Ctx C = ipmc::make_ctx(smem, ipmc::kSolve, a.nfd, a.m_p, a.blk,
                               a.nb_p, a.n_ball);
  const ipmc::CLayout& L = C.L;
  const int sc = blockIdx.x / ipmc::kCluster;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nfd = a.nfd, m_p = a.m_p, blk = a.blk, nb_p = a.nb_p;
  const int m_blk = nfd / blk, nl = C.q.nl, rank = C.rank;
  const float mc = (float)a.mc, inf = CUDART_INF_F;
  const float* ped = a.pe_d + (size_t)sc * nfd * blk;
  const float* peu = a.pe_u + (size_t)sc * (nfd - blk) * blk;
  const float* q = a.q + (size_t)sc * nfd;

  ipmc::ClVecs V;
  V.x = C.at(L.x); V.bx = C.at(L.bx); V.dx = C.at(L.dx); V.s = C.at(L.s);
  V.lam = C.at(L.lam); V.y = C.at(L.y); V.by = C.at(L.by);
  V.act = C.at(L.act); V.cw = C.at(L.cw); V.rb = C.at(L.rb);
  V.red = C.at(L.red); V.xch = C.at(L.xch);
  // Live only from a direction to its update, between two evaluations:
  // gdx, ds and dlam share the evaluation's lane-weight arrays.
  V.gdx = C.at(L.wjs); V.ds = C.at(L.wa); V.dlam = C.at(L.wj);
  float* ye = C.at(L.ye);                 // the evaluation's y = G x + b
  float* b_s = C.at(L.b);
  float* jr = C.at(L.jr);                 // the band, then its factors
  float* rhs = C.at(L.rs);
  const float* jt = C.at(L.jtp);

  // ---- the state (a cp.async group), then G^T's share (TMA) ---------------
  for (int l = tid; l < 4 * C.n4; l += nt) {
    if (l < nl) {
      const int gl = ipmc::lane_of(C.q, l, nb_p);
      const size_t g = (size_t)sc * m_p + gl;
      ipmc::cp_async4(b_s + l, a.b + g);
      ipmc::cp_async4(V.act + l, a.act + gl);
      ipmc::cp_async4(V.cw + l, a.cw + gl);
      ipmc::cp_async4(V.s + l, a.s0 + g);
      ipmc::cp_async4(V.lam + l, a.lam0 + g);
      ipmc::cp_async4(V.y + l, a.y0 + g);
      ipmc::cp_async4(V.by + l, a.y0 + g);
    } else {
      b_s[l] = 0.0f; V.act[l] = 0.0f; V.cw[l] = 0.0f; V.s[l] = 1.0f;
      V.lam[l] = 0.0f; V.y[l] = 0.0f; V.by[l] = 0.0f;
    }
  }
  for (int j = tid; j < C.q.hb; j += nt)
    ipmc::cp_async4(V.rb + j, a.rb + (size_t)sc * nb_p + C.q.j0 + j);
  for (int r = tid; r < nfd; r += nt) {
    ipmc::cp_async4(V.x + r, a.x0 + (size_t)sc * nfd + r);
    ipmc::cp_async4(V.bx + r, a.x0 + (size_t)sc * nfd + r);
  }
  // this block's half of [pe_d | pe_u], added to the band it finishes
  const int e0 = rank == 0 ? 0 : L.eh, e1 = rank == 0 ? L.eh : L.nband;
  float* pe_s = C.at(L.pe);
  for (int e = e0 + tid; e < e1; e += nt)
    ipmc::cp_async4(pe_s + e - e0,
                    e < nfd * blk ? ped + e : peu + (e - nfd * blk));
  ipmc::cp_async_commit();
  ipmc::start_gt_share(C, &a.gt_map, sc);
  ipmc::cp_async_wait_all();
  // Both blocks have started (the other's shared memory is written from
  // now on) and the state is visible to every thread.
  cl.sync();
  ipmc::wait_gt_share(C);
  // the share's row-block masks, for every evaluation
  unsigned* gmask = reinterpret_cast<unsigned*>(C.at(L.gmask));
  for (int l = tid; l < L.ldl; l += nt) gmask[l] = 0u;
  __syncthreads();
  ipmc::row_block_masks(C, gmask);
  __syncthreads();
  IPM_PROF(0);
  int xb = 0;
  float best_merit = inf, lam_mid = 0.0f;

  // The evaluation at (x, s, lam): the band (+ pe + reg I) in jr and every
  // row of J^T (w r2), J^T (1/s) in jtp, in both blocks; ext rides on its
  // barrier.
  auto evaluate = [&](const float* x, float w_cap, bool phr, float reg,
                      float (&ext)[1]) {
    const int ext_op[1] = {ipmc::kSum};
    ipmc::EvalIO io;
    io.x = x; io.s = V.s; io.lam = V.lam; io.w_cap = w_cap; io.phr = phr;
    io.y_out = ye; io.pe = pe_s; io.reg = reg;
    io.hd = io.hu = io.gram = nullptr;
    ipmc::eval_point_cluster<1, ipmc::kOutShared>(C, io, ext, ext_op, xb);
    IPM_PROF(20);
  };
  // dx from the band and rhs (the same bits in both blocks), then G dx on
  // this block's lanes; the first snap sweep's are written out with
  // IPM_SOLVE_DUMP
  auto direction = [&](bool first_sweep) {
#ifdef IPM_SOLVE_DUMP
    const int nband = (2 * m_blk - 1) * blk * blk;
    float* dump = ipm_solve_dump + (size_t)sc * (nband + 2 * nfd);
    if (first_sweep && rank == 0) {
      for (int e = tid; e < nband; e += nt) dump[e] = jr[e];
      for (int r = tid; r < nfd; r += nt) dump[nband + r] = rhs[r];
    }
#endif
    // the twisted factor: rank 0 sweeps the top half, rank 1 the bottom
    // half, each sends the other its block next to the middle (C and z),
    // both factor the middle, each finds its half's x (dx to both blocks)
    Band F;
    F.hd = jr; F.hu = jr + nfd * blk; F.dsc = C.at(L.dsc); F.lf = jr + L.lf;
    F.cf = jr + L.cf; F.w = C.at(L.brecv); F.rhs = rhs; F.z = C.at(L.z);
    F.dx = V.dx; F.nfd = nfd; F.blk = blk; F.m_blk = m_blk;
    F.mid = (m_blk - 1) / 2;
    equilibrate(F.hd, F.hu, F.dsc, nfd, blk);
    factor_sweep(F, rank == 0);
    const int nb = rank == 0 ? F.mid - 1 : F.mid + 1;
    if (nb >= 0 && nb < m_blk) {
      const float* cs = F.cf + cslot(F, nb) * blk * blk;
      float* cs_r = cl.map_shared_rank(const_cast<float*>(cs), rank ^ 1);
      for (int e = tid; e < blk * blk; e += nt) cs_r[e] = cs[e];
      float* zs_r = cl.map_shared_rank(F.z + nb * blk, rank ^ 1);
      for (int r = tid; r < blk; r += nt) zs_r[r] = F.z[nb * blk + r];
    }
    cl.sync();
    factor_middle_and_back(F, rank == 0, rank == 1,
                           cl.map_shared_rank(V.dx, rank ^ 1));
    cl.sync();
#ifdef IPM_SOLVE_DUMP
    if (first_sweep && rank == 0)
      for (int r = tid; r < nfd; r += nt) dump[nband + nfd + r] = V.dx[r];
#endif
    ipmc::col_dots(C, V.dx, nullptr, V.gdx);
    __syncthreads();
    IPM_PROF(24);
  };
  // max over this block's active lanes of lam, over the cluster
  auto max_lam = [&]() {
    float ml[1] = {0.0f};
    const int op[1] = {ipmc::kMax};
    for (int l = tid; l < nl; l += nt)
      ml[0] = pmax(ml[0], V.act[l] > 0.0f ? V.lam[l] : 0.0f);
    ipmc::block_reduce_n<1>(ml, op, V.red);
    ipmc::cluster_combine<1>(ml, op, V.xch, rank, xb);
    return ml[0];
  };

  // ---- Newton steps --------------------------------------------------------
  for (int it = 0; it < a.n_iters; ++it) {
    float ext[1] = {0.0f};                  // sum cw s lam, for mu
    for (int l = tid; l < nl; l += nt) {
      const float act = V.act[l];
      const float sl = pmax(V.s[l], 1e-14f) * act + (1.0f - act);
      V.s[l] = sl;
      ext[0] += V.cw[l] * sl * V.lam[l];
    }
    {
      const int op[1] = {ipmc::kSum};
      ipmc::block_reduce_n<1>(ext, op, V.red);
    }
    evaluate(V.x, a.w_cap, false, a.reg, ext);
    const float sig_mu = a.sigma_min * (ext[0] / mc);
    // P x by block rows, its three parts (D_i x_i, U_i x_{i+1},
    // U_{i-1}^T x_{i-1}) a thread each, added in ipm::pe_band_mv_row's
    // order (in brecv, idle between evaluations)
    float* part = C.at(L.brecv);
    for (int t = tid; t < 3 * nfd; t += nt) {
      const int p = t / nfd, r = t - p * nfd;
      const int i = r / blk, rr = r - i * blk, bbk = blk * blk;
      float acc = 0.0f;
      if (p == 0) {
        acc = ipm::block_row_dot(ped + i * bbk, V.x + i * blk, rr, blk);
      } else if (p == 1) {
        if (i + 1 < m_blk)
          acc = ipm::block_row_dot(peu + i * bbk, V.x + (i + 1) * blk, rr,
                                   blk);
      } else if (i) {
        const float* ut = peu + (i - 1) * bbk;
        for (int c = 0; c < blk; ++c)
          acc = fmaf(ut[c * blk + rr], V.x[(i - 1) * blk + c], acc);
      }
      part[t] = acc;
    }
    __syncthreads();
    for (int r = tid; r < nfd; r += nt) {
      const int i = r / blk;
      float o = part[r];
      if (i + 1 < m_blk) o += part[nfd + r];
      if (i) o += part[2 * nfd + r];
      rhs[r] = -(o + q[r] + jt[r] + sig_mu * jt[L.ldw + r]);
    }
    __syncthreads();
    IPM_PROF(21);
    direction(false);
    ipmc::newton_update_cl(C, V, ye, a.sigma_min, a.tau, a.alpha_max,
                           a.w_cap, mc, best_merit, xb, ext);
    IPM_PROF(25);
    if (it == a.n_iters / 2) lam_mid = max_lam();
  }

  // ---- the last Newton state leaves; s and lam become the snap's ----------
  for (int l = tid; l < nl; l += nt) {
    const size_t g = (size_t)sc * m_p + ipmc::lane_of(C.q, l, nb_p);
    a.s_fin[g] = V.s[l];
    a.lam_fin[g] = V.lam[l];
    a.y_last[g] = V.y[l];
  }
  const float lam_fin_max = max_lam();
  __syncthreads();

  // ---- snap sweeps from the best iterate ------------------------------------
  for (int j = 0; j < a.snap_iters; ++j) {
    for (int l = tid; l < 4 * C.n4; l += nt) {
      float lam_e = 0.0f;
      if (l < nl) {
        const float c = ipmc::c_loc(C, V.by, V.rb, l);
        lam_e = (c > -a.margin && V.act[l] > 0.0f) ? 1e-6f : 0.0f;
      }
      V.lam[l] = lam_e;
      V.s[l] = l < nl ? lam_e / a.snap_rho : 1.0f;
    }
    IPM_PROF(26);
    float ext[1] = {0.0f};
    evaluate(V.bx, a.snap_rho, true, 1e-6f, ext);
    for (int r = tid; r < nfd; r += nt) rhs[r] = -jt[r];
    __syncthreads();
    IPM_PROF(21);
    direction(j == 0);
    ipmc::snap_update_cl(C, V, xb);
    IPM_PROF(27);
  }

  for (int l = tid; l < nl; l += nt)
    a.y_fin[(size_t)sc * m_p + ipmc::lane_of(C.q, l, nb_p)] = V.by[l];
  const int r0 = rank == 0 ? 0 : L.rh, r1 = rank == 0 ? L.rh : nfd;
  for (int r = r0 + tid; r < r1; r += nt)
    a.x_fin[(size_t)sc * nfd + r] = V.bx[r];
  if (rank == 0 && tid == 0) {
    a.merit[sc] = best_merit;
    a.lam_mid[sc] = lam_mid;
    a.lam_fin_max[sc] = lam_fin_max;
  }
  IPM_PROF(28);
  IPM_PROF_FLUSH();
}

size_t cluster_smem_of(int nfd, int m_p, int blk, int nb_p) {
  return (size_t)ipmc::make_cluster_layout(ipmc::kSolve, nfd, m_p, blk, nb_p)
             .total * sizeof(float);
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
#ifdef IPM_SOLVE_STREAM
  // the one-block body at every shape (stage_profile.py times it against
  // the cluster design)
  const bool cluster = false;
#else
  const bool cluster =
      ipmc::cluster_fits(ipmc::kSolve, nfd, m_p, blk, nb_p, threads);
#endif
  if (cluster) {
    const size_t csmem = cluster_smem_of(nfd, m_p, blk, nb_p);
    if (!ipmc::gt_tensor_map(
            &a.gt_map, gt, batch, nfd, m_p,
            ipmc::make_cluster_layout(ipmc::kSolve, nfd, m_p, blk, nb_p).lds))
      return (int)cudaErrorNotSupported;
    cudaError_t e = cudaFuncSetAttribute(
        ipm_solve_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)csmem);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        ipmc::cluster_config(batch, threads, csmem, stream, attr);
    e = cudaLaunchKernelEx(&cfg, ipm_solve_cluster_kernel, a);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  // the one-block body's elimination rows live in the evaluation's partial
  // sums
  if (blk * (3 * blk + 2) > a.groups * m_p || threads < blk * blk + blk)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)make_layout(nfd, m_p, blk, nb_p, a.groups).total * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ipm_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  ipm_solve_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The floor under the band factor's pivots this library was built with.
extern "C" float ipm_solve_pivot_floor() { return kPivotFloor; }

// The design the polish takes at these shapes on the current device: 1 the
// cluster design, 0 the one-block body ("stream").
extern "C" int ipm_solve_design(int nfd, int m_p, int blk, int nb_p,
                                int threads) {
  return ipmc::cluster_fits(ipmc::kSolve, nfd, m_p, blk, nb_p, threads) ? 1
                                                                        : 0;
}

// Dynamic shared memory, in bytes, of one block of the cluster design.
extern "C" int ipm_solve_cluster_smem_bytes(int nfd, int m_p, int blk,
                                            int nb_p) {
  return (int)cluster_smem_of(nfd, m_p, blk, nb_p);
}

// How many clusters of the cluster design the device holds at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error code.
extern "C" int ipm_solve_cluster_occupancy(int nfd, int m_p, int blk,
                                           int nb_p, int threads) {
  const size_t smem = cluster_smem_of(nfd, m_p, blk, nb_p);
  cudaError_t e = cudaFuncSetAttribute(
      ipm_solve_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      ipmc::cluster_config(1, threads, smem, nullptr, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, ipm_solve_cluster_kernel, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

#ifdef IPM_SOLVE_DUMP
// Where the first snap sweep's band, right-hand side and direction go
// (device memory of batch x (nband + 2 nfd) floats).
extern "C" int ipm_solve_dump_set(float* dump) {
  return (int)cudaMemcpyToSymbol(ipm_solve_dump, &dump, sizeof(dump));
}
#endif

#ifdef IPM_SOLVE_PROFILE
// The phase profile's sums (2 x 32 counters: the first wave's block, then
// the middle scenario's), and their reset.
extern "C" int ipm_solve_profile_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, ipmc::ipm_prof,
                                   sizeof(ipmc::ipm_prof));
}

extern "C" int ipm_solve_profile_clear() {
  const unsigned long long zero[2][32] = {};
  return (int)cudaMemcpyToSymbol(ipmc::ipm_prof, zero, sizeof(zero));
}
#endif
