// The ADMM stage of the tube-constrained QCQP, per scenario, for Hopper
// (sm_90a): four entry points over one iteration phase ("stream", one block
// a scenario), and for each a second design ("cluster": two blocks a
// scenario for three of them, four for the stage entry point, below) that
// each takes wherever a block's share fits.
//
//   admm_stage_fused_factored_launch  replaces the Pallas TPU kernel
//       _kernel_fused_factored + _stage_core of the JAX package's
//       ops/admm_kernel.py (admm_stage_fused_factored);
//   admm_stage_fused_factored_ew_launch  replaces
//       _kernel_fused_factored_ew (admm_stage_fused_factored_ew): the same
//       stage with G^T given as its rank-1 row factors (below);
//   admm_stage_fused_launch           replaces _kernel_fused + _stage_core
//       (admm_stage_fused): the stage from a dense KKT inverse;
//   admm_stage_launch                 replaces _kernel (admm_stage): the
//       iterations from a given m1; its cluster design is given_stage.
//
// The stream design, per scenario (one thread block each; the grid runs
// over the batch):
//   1. m1 = W^-1 G^T, written to a scratch tensor the caller allocates:
//      - factored: block-Thomas sweeps over the block-LDL^T factors of the
//        KKT matrix W: forward y_i = gt_i - T_i y_{i-1}, diagonal
//        z_i = S_i^-1 y_i, backward x_i = z_i - T_{i+1}^T x_{i+1}, over m_blk
//        row blocks of (bsz, m_p).  Each lane (column of G^T) is an
//        independent solve, so a thread owns a lane and keeps the two live
//        (bsz)-vectors in shared-memory panels; the (bsz x bsz) factors are
//        broadcast reads.
//      - fused: m1 = winv gt from the dense (nfd x nfd) inverse, held in
//        shared memory (73 KB at nfd 135).  A thread owns a lane and walks
//        its column of gt once per chunk of ROW_CHUNK rows of m1, the chunk's
//        sums in registers, four winv entries a shared load.
//      - stage: m1 is the caller's; no phase 1.
//   2. z/u initialisation from the warm start x0 (init_z) or carried in; the
//      stage entry point starts from x = xq, z = z_prev = z0, u = u0.
//   3. n_iters over-relaxed ADMM steps (stage_iterations, shared by all
//      four)
//        v = z - u - b;  x = xq + rho (m1 v);  y = G x + b;
//        yr = alpha y + (1 - alpha) z;  z+ = Proj(yr + u);  u += yr - z+.
//   4. prim = max|y - z| (inf when n_iters == 0); the fused entry points
//      also give dual = max|G^T' (z - z_prev)| and y.
//
// Memory plan of the stream design.  One scenario's G^T and m1 are nfd x m_p
// floats each (2 x 270 KB at the flagship shape 135 x 512): more than one
// block's shared memory.  m1 therefore lives in device memory, and both
// matrices are re-read from L2 / device memory in every iteration; the
// vectors (b, z, u, v, y, x, xq) and the factors or the dense inverse stay in
// shared memory.  The iteration phase is bound by those bytes, not by
// arithmetic.
//
// G^T from its factors (the "ew" entry point).  Every constraint row of G^T
// is an outer product, gt[p*3 + d, l] = e[p, l] * w[d, l] for the nf = nfd/3
// free derivatives p and the three dimensions d (row order p-major).  In the
// stream design that entry point reads each G^T entry as the float32 product
// of the two factor entries, rounded once (__fmul_rn, never contracted into
// an FMA), where the others read the stored entry: every device function of
// that design takes its G^T through a source type (GtStored or GtFactors)
// and does the same arithmetic, in the same order, on what it reads, so it
// gives the bits of the factored entry point's stream design on the
// expanded G^T.  The cluster design keeps the factors on chip and forms each
// entry there, rounded the same way (below).
//
// The cluster design (admm_stage_fused_factored_launch,
// admm_stage_fused_launch and admm_stage_fused_factored_ew_launch, wherever
// a block's share fits; the stream design takes every other shape).  The
// same function in another order:
//   x = xq + rho W^-1 (G^T v)     in place of     xq + rho (W^-1 G^T) v,
// with the dense W^-1 (nfd x nfd, 73 KB at nfd 135) in shared memory, so
// there is no m1 at all.  One body, cluster_stage, generic over where W^-1
// comes from and over how G^T is held:
//   factored, ew  W^-1 formed once a scenario by the block-Thomas sweeps
//                 above run on the nfd unit columns (not the m_p lanes);
//   fused         W^-1 given: the caller's dense inverse copied in, its rows
//                 as given (4-byte cp.async: rows of 135 floats are not
//                 16-byte aligned), overlapping the first rows of G^T;
//   factored, fused  G^T's stored rows: each block keeps its half of the
//                 lanes' columns (135 x 256 floats, 138 KB at the flagship);
//   ew            G^T's row factors: each block keeps its lanes' share of e
//                 (nfd / 3 rows) and w (3 rows), 50 KB at the flagship, and
//                 forms each G^T entry in registers as the reference rounds
//                 it, fl(e[p, l] w[d, l]), one shared load of e feeding the
//                 three rows 3p .. 3p + 2: the arithmetic of the stored rows
//                 (G^T applied in factored form, w v first, read 3.3x the
//                 reference order's float32 error in x at the flagship on an
//                 H100, past the 3x its checks allow).
// Each scenario is a cluster of two blocks on neighbouring SMs; each keeps,
// for all iterations, its share of G^T beside the whole W^-1 and its lanes'
// vectors, loaded once with cp.async.  The lanes split so that a ball triple
// stays in one block: block 0 holds lanes j < ceil(nb_p / 2) of each of the
// three ball planes (and their rb[j]) and the first half of the final
// half-space plane, block 1 the rest (cluster_lane_split in
// ops/admm_kernel.py is the same map).  An iteration:
//   each block  g_c = G^T_c v_c  (its lanes' partial, nfd floats);
//   cluster barrier; each block reads the other's partial through
//   distributed shared memory and forms g = g_0 + g_1, so both hold the same
//   bits; x = xq + rho W^-1 g (in both blocks, identically); y_c = G_c x + b;
//   the projection and the z/u/v updates on its own lanes.
// Each block stores its partial to its own and to the other block's shared
// memory before the barrier, so that after it both read only their own.  The
// partials are double-buffered, so one cluster barrier an iteration
// suffices: a block writes buffer it & 1 only after the barrier of iteration
// it - 1, which the other block passes only once it has read that buffer in
// iteration it - 2.  prim and the dual matvec are combined the same way at
// the end.  Where W^-1 is formed, each block forms half of its columns (four
// columns a thread, the factor row broadcast) and stores them to both
// blocks' shared memory.  Device memory sees each input once (G^T's share
// with 16-byte cp.async where its segments are aligned).  What bounds it:
// not the bytes, and not shared-memory bandwidth (an iteration of the
// factored entry point reads about 350 KB a block, some 2.8k cycles at 128 B
// a cycle): measured with clock64 on an H100, an iteration takes about 9k
// cycles, each of the three products about 2k (instruction issue and latency
// at 16 warps an SM) and the cluster barrier about 1.2k; forming W^-1 about
// 45k cycles a scenario.
//
// Determinism.  Every reduction has a fixed order (warp butterfly, then a
// serial sum over a fixed number of partials; m1 = winv gt sums over the
// columns of winv in order; the cluster's two partials are added as rank 0's
// plus rank 1's); there are no float atomics, so two runs on the same inputs
// give the same bits.
//
// Nothing here assumes m_p == 512 or a multiple of 15: m_p % 4 == 0 (float4
// rows) is the only lane requirement, every loop strides by the block size,
// and a final half-space plane (m_p > 3 nb_p) may be absent.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

// How phase 1 gets m1.
enum Phase1 { kFactored = 0, kInverse = 1, kGiven = 2 };

// Rows of m1 a thread sums at once in the fused entry point's phase 1.
constexpr int ROW_CHUNK = 16;

struct StageArgs {
  // inputs
  const float* rho;   // (B)
  const float* sinv;  // (B, m_blk, bsz, bsz)   factored
  const float* t;     // (B, m_blk-1, bsz, bsz) factored: T_i
  const float* tt;    // (B, m_blk-1, bsz, bsz) factored: T_i^T
  const float* winv;  // (B, nfd, nfd)          fused
  const float* gt;    // (B, nfd, m_p), null for the ew entry point
  const float* e;     // (B, nfd / 3, m_p)       ew: G^T's row factors
  const float* w;     // (B, 3, m_p)             ew
  const float* b;     // (B, m_p)
  const float* rb;    // (B, nb_p)
  const float* xq;    // (B, nfd)
  const float* x0;    // (B, nfd), null for the stage entry point
  const float* z0;    // (B, m_p) or null when init_z
  const float* u0;    // (B, m_p) or null when init_z
  // scratch (the stage entry point: its input m1)
  float* m1;          // (B, nfd, m_p)
  // outputs
  float* x;           // (B, nfd)
  float* z;           // (B, m_p)
  float* zp;          // (B, m_p)
  float* u;           // (B, m_p)
  float* prim;        // (B)
  float* dual;        // (B), null for the stage entry point
  float* y;           // (B, m_p), null for the stage entry point
  int nfd, m_p, m_blk, bsz, nb_p, n_ball, n_iters, init_z, groups;
  float alpha;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Dimensions of the problem: rows of w, and G^T rows per free derivative.
constexpr int kDims = 3;

// G^T as stored, (nfd, m_p) row-major: the source of the factored, fused
// and stage entry points (and of m1 for rows_dot).
struct GtStored {
  const float* gt;
  __device__ __forceinline__ float at(int r, int l, int m_p) const {
    return gt[(size_t)r * m_p + l];
  }
  __device__ __forceinline__ const float4* row4(int r, int m_p) const {
    return reinterpret_cast<const float4*>(gt + (size_t)r * m_p);
  }
  // Read-only-cache load of lanes 4 l4 .. 4 l4 + 3 of row r (nl4 = m_p / 4).
  __device__ __forceinline__ float4 ldg4(int r, int l4, int nl4) const {
    return __ldg(reinterpret_cast<const float4*>(gt) + (size_t)r * nl4 + l4);
  }
};

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y),
                     __fmul_rn(a.z, b.z), __fmul_rn(a.w, b.w));
}

// Four lanes of G^T row r = p*3 + d formed from the factor rows e_p and w_d.
struct FactorRow {
  const float4* e;
  const float4* w;
  __device__ __forceinline__ float4 operator[](int l4) const {
    return mul4(e[l4], w[l4]);
  }
};

// G^T from its rank-1 row factors e (nfd / 3, m_p) and w (3, m_p).
struct GtFactors {
  const float* e;
  const float* w;
  __device__ __forceinline__ float at(int r, int l, int m_p) const {
    return __fmul_rn(e[(size_t)(r / kDims) * m_p + l], w[(r % kDims) * m_p + l]);
  }
  __device__ __forceinline__ FactorRow row4(int r, int m_p) const {
    return FactorRow{
        reinterpret_cast<const float4*>(e + (size_t)(r / kDims) * m_p),
        reinterpret_cast<const float4*>(w + (r % kDims) * m_p)};
  }
  __device__ __forceinline__ float4 ldg4(int r, int l4, int nl4) const {
    const float4* e4 = reinterpret_cast<const float4*>(e);
    const float4* w4 = reinterpret_cast<const float4*>(w);
    return mul4(__ldg(e4 + (size_t)(r / kDims) * nl4 + l4),
                __ldg(w4 + (r % kDims) * nl4 + l4));
  }
};

// Shared-memory layout in floats; every region starts 16-byte aligned.  The
// phase-1 region comes first, then the vectors every entry point uses.
struct Layout {
  int sinv, t, tt, panel0, panel1;          // phase 1, factored
  int winv, ldw;                            // phase 1, fused (row stride)
  int b, rb, z, zp, u, v, y, xq, x, tmp, part, red;
  int total;
};

__host__ __device__ inline Layout make_layout(int phase1, int nfd, int m_p,
                                              int m_blk, int bsz, int nb_p,
                                              int groups) {
  Layout L;
  int o = 0;
  const int bb = bsz * bsz;
  L.sinv = L.t = L.tt = L.panel0 = L.panel1 = L.winv = 0;
  L.ldw = round4(nfd);
  if (phase1 == kFactored) {
    L.sinv = o;   o += round4(m_blk * bb);
    L.t = o;      o += round4((m_blk - 1) * bb);
    L.tt = o;     o += round4((m_blk - 1) * bb);
    L.panel0 = o; o += bsz * m_p;
    L.panel1 = o; o += bsz * m_p;
  } else if (phase1 == kInverse) {
    L.winv = o;   o += nfd * L.ldw;
  }
  L.b = o;      o += m_p;
  L.rb = o;     o += round4(nb_p);
  L.z = o;      o += m_p;
  L.zp = o;     o += m_p;
  L.u = o;      o += m_p;
  L.v = o;      o += m_p;
  L.y = o;      o += m_p;
  L.xq = o;     o += round4(nfd);
  L.x = o;      o += round4(nfd);
  L.tmp = o;    o += round4(nfd);
  L.part = o;   o += groups * m_p;
  L.red = o;    o += 32;
  L.total = o;
  return L;
}

// The vector regions of one block's shared memory.
struct Vecs {
  float *b, *rb, *z, *zp, *u, *v, *y, *xq, *x, *tmp, *part, *red;
};

__device__ __forceinline__ Vecs vecs_of(float* smem, const Layout& L) {
  Vecs S;
  S.b = smem + L.b;     S.rb = smem + L.rb;   S.z = smem + L.z;
  S.zp = smem + L.zp;   S.u = smem + L.u;     S.v = smem + L.v;
  S.y = smem + L.y;     S.xq = smem + L.xq;   S.x = smem + L.x;
  S.tmp = smem + L.tmp; S.part = smem + L.part; S.red = smem + L.red;
  return S;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Max over the block of a non-negative per-thread value; every thread gets
// the result.  `red` holds 32 floats.
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = lane < nw ? red[lane] : 0.0f;
  return warp_max(r);
}

// dst[r] = base[r] + scale * sum_l M[r, l] * v[l] (just the sum when base is
// null): one warp per row, float4 loads, butterfly reduce.  M is global
// (nfd, m_p), read through its source (m1 or G^T); v, base and dst are
// shared.  m1 was written by this block earlier in the kernel, so no
// read-only-cache loads.
template <class Src>
__device__ void rows_dot(const Src& M, const float* v, float* dst, int nfd,
                         int m_p, const float* base, float scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int nl4 = m_p >> 2;
  const float4* v4 = reinterpret_cast<const float4*>(v);
  for (int r = warp; r < nfd; r += nw) {
    const auto row = M.row4(r, m_p);
    float acc = 0.0f;
    for (int l4 = lane; l4 < nl4; l4 += 32) {
      const float4 a = row[l4];
      const float4 w = v4[l4];
      acc = fmaf(a.x, w.x, acc);
      acc = fmaf(a.y, w.y, acc);
      acc = fmaf(a.z, w.z, acc);
      acc = fmaf(a.w, w.w, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) dst[r] = base ? base[r] + scale * acc : acc;
  }
}

// part[g, l] = sum_{r = g, g+G, ...} gt[r, l] * x[r]: the rows are split
// over `groups` thread groups, each thread owning four neighbouring lanes.
template <class G>
__device__ void cols_dot(const G& gt, const float* x, float* part, int nfd,
                         int m_p, int groups) {
  const int nl4 = m_p >> 2;
  for (int idx = threadIdx.x; idx < groups * nl4; idx += blockDim.x) {
    const int g = idx / nl4, l4 = idx - g * nl4;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int r = g; r < nfd; r += groups) {
      const float4 a = gt.ldg4(r, l4, nl4);
      const float xr = x[r];
      acc.x = fmaf(a.x, xr, acc.x);
      acc.y = fmaf(a.y, xr, acc.y);
      acc.z = fmaf(a.z, xr, acc.z);
      acc.w = fmaf(a.w, xr, acc.w);
    }
    reinterpret_cast<float4*>(part + (size_t)g * m_p)[l4] = acc;
  }
}

// y[l] = b[l] + sum_g part[g, l], in the fixed order g = 0 .. groups-1.
__device__ __forceinline__ float gather_y(const float* part, const float* b,
                                          int l, int m_p, int groups) {
  float acc = part[l];
  for (int g = 1; g < groups; ++g) acc += part[(size_t)g * m_p + l];
  return acc + b[l];
}

__device__ __forceinline__ float ball_scale(float wx, float wy, float wz,
                                            float rb) {
  const float sq = wx * wx + wy * wy + wz * wz;
  return sq > rb * rb ? rb * rsqrtf(fmaxf(sq, 1e-30f)) : 1.0f;
}

// Loads b, rb and xq of scenario s into shared memory.
__device__ __forceinline__ void load_vectors(const StageArgs& a, int s,
                                             const Vecs& S) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int l = tid; l < a.m_p; l += nt) S.b[l] = a.b[(size_t)s * a.m_p + l];
  for (int j = tid; j < a.nb_p; j += nt)
    S.rb[j] = a.rb[(size_t)s * a.nb_p + j];
  for (int r = tid; r < a.nfd; r += nt) S.xq[r] = a.xq[(size_t)s * a.nfd + r];
}

// Phase 1, factored: m1 = W^-1 G^T by block-Thomas sweeps, one independent
// column solve per lane.
template <class G>
__device__ __forceinline__ void m1_factored(
    const G& gt, float* m1, const float* sinv_s, const float* t_s,
    const float* tt_s, float* panel0, float* panel1, int m_p, int m_blk,
    int bsz) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int bb = bsz * bsz;
  for (int l = tid; l < m_p; l += nt) {
    float* prev = panel0;
    float* cur = panel1;
    // y_0 = gt_0;  z_0 = S_0^-1 y_0
    for (int r = 0; r < bsz; ++r) prev[r * m_p + l] = gt.at(r, l, m_p);
    for (int r = 0; r < bsz; ++r) {
      float acc = 0.0f;
      for (int c = 0; c < bsz; ++c)
        acc = fmaf(sinv_s[r * bsz + c], prev[c * m_p + l], acc);
      m1[(size_t)r * m_p + l] = acc;
    }
    // forward + diagonal
    for (int i = 1; i < m_blk; ++i) {
      const float* ti = t_s + (i - 1) * bb;
      const float* si = sinv_s + i * bb;
      for (int r = 0; r < bsz; ++r) {
        float acc = 0.0f;
        for (int c = 0; c < bsz; ++c)
          acc = fmaf(ti[r * bsz + c], prev[c * m_p + l], acc);
        cur[r * m_p + l] = gt.at(i * bsz + r, l, m_p) - acc;
      }
      for (int r = 0; r < bsz; ++r) {
        float acc = 0.0f;
        for (int c = 0; c < bsz; ++c)
          acc = fmaf(si[r * bsz + c], cur[c * m_p + l], acc);
        m1[(size_t)(i * bsz + r) * m_p + l] = acc;
      }
      float* sw = prev; prev = cur; cur = sw;
    }
    // backward: x_{m-1} = z_{m-1};  x_i = z_i - T_{i+1}^T x_{i+1}
    for (int r = 0; r < bsz; ++r)
      prev[r * m_p + l] = m1[(size_t)((m_blk - 1) * bsz + r) * m_p + l];
    for (int i = m_blk - 2; i >= 0; --i) {
      const float* tti = tt_s + i * bb;
      for (int r = 0; r < bsz; ++r) {
        float acc = 0.0f;
        for (int c = 0; c < bsz; ++c)
          acc = fmaf(tti[r * bsz + c], prev[c * m_p + l], acc);
        const float xv = m1[(size_t)(i * bsz + r) * m_p + l] - acc;
        cur[r * m_p + l] = xv;
        m1[(size_t)(i * bsz + r) * m_p + l] = xv;
      }
      float* sw = prev; prev = cur; cur = sw;
    }
  }
}

// Phase 1, fused: m1 = winv gt.  winv_s is (nfd, ldw) in shared memory with
// zero columns nfd..ldw-1.  m1[r, l] = sum_c winv[r, c] gt[c, l], c in order.
__device__ __forceinline__ void m1_inverse(const float* gt, float* m1,
                                           const float* winv_s, int nfd,
                                           int ldw, int m_p) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nc4 = ldw >> 2;
  for (int l = tid; l < m_p; l += nt) {
    for (int r0 = 0; r0 < nfd; r0 += ROW_CHUNK) {
      float acc[ROW_CHUNK];
#pragma unroll
      for (int i = 0; i < ROW_CHUNK; ++i) acc[i] = 0.0f;
      for (int c4 = 0; c4 < nc4; ++c4) {
        const int c = 4 * c4;
        const float g0 = gt[(size_t)c * m_p + l];
        const float g1 = c + 1 < nfd ? gt[(size_t)(c + 1) * m_p + l] : 0.0f;
        const float g2 = c + 2 < nfd ? gt[(size_t)(c + 2) * m_p + l] : 0.0f;
        const float g3 = c + 3 < nfd ? gt[(size_t)(c + 3) * m_p + l] : 0.0f;
#pragma unroll
        for (int i = 0; i < ROW_CHUNK; ++i) {
          const int r = min(r0 + i, nfd - 1);
          const float4 w =
              reinterpret_cast<const float4*>(winv_s + (size_t)r * ldw)[c4];
          acc[i] = fmaf(w.x, g0, acc[i]);
          acc[i] = fmaf(w.y, g1, acc[i]);
          acc[i] = fmaf(w.z, g2, acc[i]);
          acc[i] = fmaf(w.w, g3, acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < ROW_CHUNK; ++i)
        if (r0 + i < nfd) m1[(size_t)(r0 + i) * m_p + l] = acc[i];
    }
  }
}

// Phase 2 of the fused entry points: y0 = G x0 + b; z/u from the warm start
// (init_z) or carried in.  x0 is in S.x.
template <class G>
__device__ __forceinline__ void init_from_x0(const StageArgs& a, int s,
                                             const G& gt, const Vecs& S) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int m_p = a.m_p, nb_p = a.nb_p, n_ball = a.n_ball, groups = a.groups;
  cols_dot(gt, S.x, S.part, a.nfd, m_p, groups);
  __syncthreads();
  for (int j = tid; j < nb_p; j += nt) {
    const int lx = j, ly = nb_p + j, lz = 2 * nb_p + j;
    const float yx = gather_y(S.part, S.b, lx, m_p, groups);
    const float yy = gather_y(S.part, S.b, ly, m_p, groups);
    const float yz = gather_y(S.part, S.b, lz, m_p, groups);
    S.y[lx] = yx; S.y[ly] = yy; S.y[lz] = yz;
    float zx, zy, zz, ux = 0.0f, uy = 0.0f, uz = 0.0f;
    if (a.init_z) {
      if (j < n_ball) {
        const float sc = ball_scale(yx, yy, yz, S.rb[j]);
        zx = yx * sc; zy = yy * sc; zz = yz * sc;
      } else {
        zx = fminf(yx, 0.0f); zy = fminf(yy, 0.0f); zz = fminf(yz, 0.0f);
      }
    } else {
      const float* z0 = a.z0 + (size_t)s * m_p;
      const float* u0 = a.u0 + (size_t)s * m_p;
      zx = z0[lx]; zy = z0[ly]; zz = z0[lz];
      ux = u0[lx]; uy = u0[ly]; uz = u0[lz];
    }
    S.z[lx] = zx; S.z[ly] = zy; S.z[lz] = zz;
    S.zp[lx] = zx; S.zp[ly] = zy; S.zp[lz] = zz;
    S.u[lx] = ux; S.u[ly] = uy; S.u[lz] = uz;
    S.v[lx] = zx - ux - S.b[lx];
    S.v[ly] = zy - uy - S.b[ly];
    S.v[lz] = zz - uz - S.b[lz];
  }
  for (int l = 3 * nb_p + tid; l < m_p; l += nt) {
    const float yl = gather_y(S.part, S.b, l, m_p, groups);
    S.y[l] = yl;
    float zl, ul = 0.0f;
    if (a.init_z) {
      zl = fminf(yl, 0.0f);
    } else {
      zl = a.z0[(size_t)s * m_p + l];
      ul = a.u0[(size_t)s * m_p + l];
    }
    S.z[l] = zl; S.zp[l] = zl; S.u[l] = ul;
    S.v[l] = zl - ul - S.b[l];
  }
}

// Phase 3, shared by the three entry points: n_iters over-relaxed ADMM
// steps from the state in S (z, u, v = z - u - b).
template <class G>
__device__ __forceinline__ void stage_iterations(const StageArgs& a,
                                                 const float* m1, const G& gt,
                                                 float rho, const Vecs& S) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nfd = a.nfd, m_p = a.m_p, nb_p = a.nb_p, n_ball = a.n_ball;
  const int groups = a.groups;
  const float alpha = a.alpha, one_m_alpha = 1.0f - a.alpha;
  for (int it = 0; it < a.n_iters; ++it) {
    rows_dot(GtStored{m1}, S.v, S.x, nfd, m_p, S.xq, rho);
    __syncthreads();
    cols_dot(gt, S.x, S.part, nfd, m_p, groups);
    __syncthreads();
    for (int j = tid; j < nb_p; j += nt) {
      const int lx = j, ly = nb_p + j, lz = 2 * nb_p + j;
      const float yx = gather_y(S.part, S.b, lx, m_p, groups);
      const float yy = gather_y(S.part, S.b, ly, m_p, groups);
      const float yz = gather_y(S.part, S.b, lz, m_p, groups);
      const float zx0 = S.z[lx], zy0 = S.z[ly], zz0 = S.z[lz];
      const float rx = alpha * yx + one_m_alpha * zx0;
      const float ry = alpha * yy + one_m_alpha * zy0;
      const float rz = alpha * yz + one_m_alpha * zz0;
      const float ux = S.u[lx], uy = S.u[ly], uz = S.u[lz];
      const float wx = rx + ux, wy = ry + uy, wz = rz + uz;
      float zx, zy, zz;
      if (j < n_ball) {
        const float sc = ball_scale(wx, wy, wz, S.rb[j]);
        zx = wx * sc; zy = wy * sc; zz = wz * sc;
      } else {
        zx = fminf(wx, 0.0f); zy = fminf(wy, 0.0f); zz = fminf(wz, 0.0f);
      }
      const float nux = wx - zx, nuy = wy - zy, nuz = wz - zz;
      S.y[lx] = yx; S.y[ly] = yy; S.y[lz] = yz;
      S.zp[lx] = zx0; S.zp[ly] = zy0; S.zp[lz] = zz0;
      S.z[lx] = zx; S.z[ly] = zy; S.z[lz] = zz;
      S.u[lx] = nux; S.u[ly] = nuy; S.u[lz] = nuz;
      S.v[lx] = zx - nux - S.b[lx];
      S.v[ly] = zy - nuy - S.b[ly];
      S.v[lz] = zz - nuz - S.b[lz];
    }
    for (int l = 3 * nb_p + tid; l < m_p; l += nt) {
      const float yl = gather_y(S.part, S.b, l, m_p, groups);
      const float z0 = S.z[l];
      const float w = (alpha * yl + one_m_alpha * z0) + S.u[l];
      const float zl = fminf(w, 0.0f);
      const float nu = w - zl;
      S.y[l] = yl; S.zp[l] = z0; S.z[l] = zl; S.u[l] = nu;
      S.v[l] = zl - nu - S.b[l];
    }
    __syncthreads();
  }
}

// Phase 4: residuals and outputs.  The dual matvec and y only where the
// entry point has them (a.dual, a.y not null).
template <class G>
__device__ __forceinline__ void stage_finish(const StageArgs& a, int s,
                                             const G& gt, const Vecs& S) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nfd = a.nfd, m_p = a.m_p;
  const bool with_dual = a.dual != nullptr;
  float pmax = 0.0f;
  for (int l = tid; l < m_p; l += nt) {
    pmax = fmaxf(pmax, fabsf(S.y[l] - S.z[l]));
    S.v[l] = S.z[l] - S.zp[l];
  }
  float dmax = 0.0f;
  if (with_dual) {
    __syncthreads();
    rows_dot(gt, S.v, S.tmp, nfd, m_p, nullptr, 0.0f);
    __syncthreads();
    for (int r = tid; r < nfd; r += nt) dmax = fmaxf(dmax, fabsf(S.tmp[r]));
  }
  pmax = block_max(pmax, S.red);
  if (with_dual) dmax = block_max(dmax, S.red);
  if (tid == 0) {
    a.prim[s] = a.n_iters > 0 ? pmax : CUDART_INF_F;
    if (with_dual) a.dual[s] = dmax;
  }
  for (int r = tid; r < nfd; r += nt) a.x[(size_t)s * nfd + r] = S.x[r];
  for (int l = tid; l < m_p; l += nt) {
    a.z[(size_t)s * m_p + l] = S.z[l];
    a.zp[(size_t)s * m_p + l] = S.zp[l];
    a.u[(size_t)s * m_p + l] = S.u[l];
    if (a.y) a.y[(size_t)s * m_p + l] = S.y[l];
  }
}

// The factored stage of scenario blockIdx.x, G^T from `gt`.
template <class G>
__device__ __forceinline__ void factored_stage(const StageArgs& a,
                                               const G& gt) {
  extern __shared__ __align__(16) float smem[];
  const int s = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nfd = a.nfd, m_p = a.m_p, m_blk = a.m_blk, bsz = a.bsz;
  const int bb = bsz * bsz;
  const Layout L =
      make_layout(kFactored, nfd, m_p, m_blk, bsz, a.nb_p, a.groups);
  const Vecs S = vecs_of(smem, L);

  float* m1 = a.m1 + (size_t)s * nfd * m_p;

  float* sinv_s = smem + L.sinv;
  float* t_s = smem + L.t;
  float* tt_s = smem + L.tt;

  // ---- load the small per-scenario operands --------------------------------
  for (int i = tid; i < m_blk * bb; i += nt)
    sinv_s[i] = a.sinv[(size_t)s * m_blk * bb + i];
  for (int i = tid; i < (m_blk - 1) * bb; i += nt) {
    t_s[i] = a.t[(size_t)s * (m_blk - 1) * bb + i];
    tt_s[i] = a.tt[(size_t)s * (m_blk - 1) * bb + i];
  }
  load_vectors(a, s, S);
  for (int r = tid; r < nfd; r += nt) S.x[r] = a.x0[(size_t)s * nfd + r];
  const float rho = a.rho[s];
  __syncthreads();

  // ---- phase 1: m1 = W^-1 G^T, one independent column solve per lane -------
  m1_factored(gt, m1, sinv_s, t_s, tt_s, smem + L.panel0, smem + L.panel1,
              m_p, m_blk, bsz);
  // m1 is read by other threads of this block from here on.
  __syncthreads();

  // ---- phases 2-4 ------------------------------------------------------------
  init_from_x0(a, s, gt, S);
  __syncthreads();
  stage_iterations(a, m1, gt, rho, S);
  stage_finish(a, s, gt, S);
}

__global__ void __launch_bounds__(1024)
admm_stage_fused_factored_kernel(StageArgs a) {
  factored_stage(a, GtStored{a.gt + (size_t)blockIdx.x * a.nfd * a.m_p});
}

__global__ void __launch_bounds__(1024)
admm_stage_fused_factored_ew_kernel(StageArgs a) {
  const size_t s = blockIdx.x;
  factored_stage(a, GtFactors{a.e + s * (a.nfd / kDims) * a.m_p,
                              a.w + s * kDims * a.m_p});
}

__global__ void __launch_bounds__(1024)
admm_stage_fused_kernel(StageArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int s = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nfd = a.nfd, m_p = a.m_p;
  const Layout L = make_layout(kInverse, nfd, m_p, 0, 0, a.nb_p, a.groups);
  const Vecs S = vecs_of(smem, L);

  const float* gt = a.gt + (size_t)s * nfd * m_p;
  const GtStored g{gt};
  float* m1 = a.m1 + (size_t)s * nfd * m_p;
  float* winv_s = smem + L.winv;
  const int ldw = L.ldw;

  for (int i = tid; i < nfd * ldw; i += nt) {
    const int r = i / ldw, c = i - r * ldw;
    winv_s[i] = c < nfd ? a.winv[(size_t)s * nfd * nfd + r * nfd + c] : 0.0f;
  }
  load_vectors(a, s, S);
  for (int r = tid; r < nfd; r += nt) S.x[r] = a.x0[(size_t)s * nfd + r];
  const float rho = a.rho[s];
  __syncthreads();

  // ---- phase 1: m1 = winv gt ------------------------------------------------
  m1_inverse(gt, m1, winv_s, nfd, ldw, m_p);
  __syncthreads();

  // ---- phases 2-4 ------------------------------------------------------------
  init_from_x0(a, s, g, S);
  __syncthreads();
  stage_iterations(a, m1, g, rho, S);
  stage_finish(a, s, g, S);
}

__global__ void __launch_bounds__(1024)
admm_stage_iter_kernel(StageArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int s = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nfd = a.nfd, m_p = a.m_p;
  const Layout L = make_layout(kGiven, nfd, m_p, 0, 0, a.nb_p, a.groups);
  const Vecs S = vecs_of(smem, L);

  const GtStored gt{a.gt + (size_t)s * nfd * m_p};
  const float* m1 = a.m1 + (size_t)s * nfd * m_p;

  load_vectors(a, s, S);
  const float rho = a.rho[s];
  // x starts at xq; z = z_prev = z0, u = u0.
  for (int r = tid; r < nfd; r += nt) S.x[r] = a.xq[(size_t)s * nfd + r];
  for (int l = tid; l < m_p; l += nt) {
    const float zl = a.z0[(size_t)s * m_p + l];
    const float ul = a.u0[(size_t)s * m_p + l];
    S.z[l] = zl; S.zp[l] = zl; S.u[l] = ul; S.y[l] = 0.0f;
    S.v[l] = zl - ul - a.b[(size_t)s * m_p + l];
  }
  __syncthreads();

  stage_iterations(a, m1, gt, rho, S);
  stage_finish(a, s, gt, S);
}

// ---------------------------------------------------------------------------
// The cluster design of the factored, fused and ew entry points (see the
// top of the file).
// ---------------------------------------------------------------------------

constexpr int kCluster = 2;
// row_dots: threads a row, float4 of the vector each thread keeps in
// registers (so rows of up to 4 * KL * VMAX floats), and rows a thread sums
// at once (loads of PG rows in flight together).
constexpr int KL = 16;
constexpr int VMAX = 5;
constexpr int PG = 5;
// col_dots: row groups, one lane each of an aligned group of eight; rows a
// thread loads at once.
constexpr int RG = 8;
constexpr int CU = 4;

// One block's share of the lanes: hb lanes j0 .. j0 + hb - 1 of each ball
// plane, fb lanes f0 .. f0 + fb - 1 of the final plane; nl in all, in the
// local order [ball-x | ball-y | ball-z | half].
struct Split {
  int hb, j0, fb, f0, nl;
};

// The first and the count of n items that rank `rank` of `ranks` holds:
// n / ranks each, one more for the first n % ranks ranks.
__host__ __device__ inline int share_start(int rank, int ranks, int n) {
  const int extra = n % ranks;
  return rank * (n / ranks) + (rank < extra ? rank : extra);
}

__host__ __device__ inline int share_count(int rank, int ranks, int n) {
  return n / ranks + (rank < n % ranks ? 1 : 0);
}

// Rank `rank`'s share of the lanes in a cluster of `ranks` blocks: its share
// of the ball indices j of the three ball planes (a ball triple (j, nb_p + j,
// 2 nb_p + j) stays in one block) and the same share of the final plane.
// With two ranks, rank 0 takes the first ceil(n / 2) of each, rank 1 the
// rest.
__host__ __device__ inline Split split_of(int rank, int m_p, int nb_p,
                                          int ranks = kCluster) {
  const int nh = m_p - 3 * nb_p;
  Split q;
  q.hb = share_count(rank, ranks, nb_p);
  q.j0 = share_start(rank, ranks, nb_p);
  q.fb = share_count(rank, ranks, nh);
  q.f0 = share_start(rank, ranks, nh);
  q.nl = 3 * q.hb + q.fb;
  return q;
}

// Global lane of local lane l.
__device__ __forceinline__ int lane_of(const Split& q, int l, int nb_p) {
  if (l < 3 * q.hb) {
    const int d = l / q.hb;
    return d * nb_p + q.j0 + (l - d * q.hb);
  }
  return 3 * nb_p + q.f0 + (l - 3 * q.hb);
}

// The entry points of the cluster design, and for each where W^-1 comes from
// and how many rows (of ldl lanes) a block keeps of G^T's source: the
// factored one forms W^-1 and keeps G^T's nfd stored rows, the fused one is
// given W^-1 and keeps the same rows, the ew one forms W^-1 and keeps the nf
// = nfd / 3 rows of e, then the 3 of w.  The stage entry point (kEntryGiven)
// has a cluster body of its own, given_stage below: m1 given, no W^-1.
enum Entry { kEntryFactored = 0, kEntryFused = 1, kEntryEw = 2,
             kEntryGiven = 3 };
constexpr int kEntries = 4;

__host__ __device__ inline bool winv_given(int entry) {
  return entry == kEntryFused;
}

__host__ __device__ inline int source_rows(int entry, int nfd) {
  return entry == kEntryEw ? nfd / kDims + kDims : nfd;
}

// Shared-memory layout of one block of the cluster design, in floats.  Where
// W^-1 is formed, the region of G^T's source doubles, before it is complete,
// as the scratch of the W^-1 sweeps (the factors and two panels), placed at
// its end so that the rows before it (r_pre of them) load while W^-1 forms;
// where W^-1 is given there is no scratch and every row loads at once.
struct CLayout {
  int winv, ldw, gts, ldl, rows, scr, ncl, r_pre;
  int b, z, zp, u, v, y, rb, xq, x, g, gpart, red, xch, total;
};

__host__ __device__ inline CLayout make_cluster_layout(int entry, int nfd,
                                                       int m_p, int m_blk,
                                                       int bsz, int nb_p) {
  CLayout L;
  const int bb = bsz * bsz;
  const int nl = split_of(0, m_p, nb_p).nl;  // rank 0's share is the larger
  L.ldw = round4(nfd);
  // An odd number of float4 a row: the eight rows col_dots reads at once
  // fall in eight different bank groups.
  L.ldl = round4(nl);
  if ((L.ldl / 4) % 2 == 0) L.ldl += 4;
  L.rows = source_rows(entry, nfd);
  L.ncl = round4((nfd + 1) / 2);
  const int scr = winv_given(entry)
                      ? 0
                      : round4(m_blk * bb) + 2 * round4((m_blk - 1) * bb) +
                            2 * bsz * L.ncl;
  int o = 0;
  L.winv = o; o += nfd * L.ldw;
  L.gts = o;
  const int region = L.rows * L.ldl > scr ? L.rows * L.ldl : scr;
  L.scr = o + region - scr;
  L.r_pre = (L.scr - L.gts) / L.ldl;
  if (L.r_pre > L.rows) L.r_pre = L.rows;
  o += region;
  L.b = o;     o += L.ldl;
  L.z = o;     o += L.ldl;
  L.zp = o;    o += L.ldl;
  L.u = o;     o += L.ldl;
  L.v = o;     o += L.ldl;
  L.y = o;     o += L.ldl;
  L.rb = o;    o += round4((nb_p + 1) / 2);
  L.xq = o;    o += L.ldw;
  L.x = o;     o += L.ldw;
  L.g = o;     o += L.ldw;
  L.gpart = o; o += 2 * kCluster * L.ldw;
  L.red = o;   o += 32;
  L.xch = o;   o += 4;
  L.total = o;
  return L;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n floats from global src to shared dst, 4 bytes a copy, left in flight.
__device__ __forceinline__ void load_async(float* dst, const float* src,
                                          int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async4(dst + i, src + i);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Rows r0 .. r1-1 of this block's share of G^T's source (src.row(r): the
// global row, m_p lanes) to shared gts (rows, ldl), left in flight: 16 bytes
// a copy where the share's four segments (three ball planes and the final
// plane) start and end on 16-byte boundaries (nb_p and the halves multiples
// of 4), else 4.
template <class Src>
__device__ __forceinline__ void load_gt_rows(const Src& src, float* gts,
                                             const Split& q, int r0, int r1,
                                             int nb_p, int ldl) {
  if (nb_p % 4 == 0 && q.hb % 4 == 0 && q.j0 % 4 == 0 && q.fb % 4 == 0 &&
      q.f0 % 4 == 0) {
    const int hb4 = q.hb / 4, nl4 = q.nl / 4;
    const int n = (r1 - r0) * nl4;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = r0 + i / nl4, l4 = i % nl4;
      int lane;
      if (l4 < 3 * hb4) {
        const int d = l4 / hb4;
        lane = d * nb_p + q.j0 + 4 * (l4 - d * hb4);
      } else {
        lane = 3 * nb_p + q.f0 + 4 * (l4 - 3 * hb4);
      }
      cp_async16(gts + (size_t)r * ldl + 4 * l4, src.row(r) + lane);
    }
    return;
  }
  const int n = (r1 - r0) * q.nl;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = r0 + i / q.nl, l = i % q.nl;
    cp_async4(gts + (size_t)r * ldl + l, src.row(r) + lane_of(q, l, nb_p));
  }
}

// dst[r] = base[r] + scale * sum_c M[r, c] v[c] (the sum alone when base is
// null) for r < rows, stored also to dst_r where that is not null (the other
// block's copy); M (rows, ld) and v (n4 <= KL * NV float4, zero past the
// row's end) in shared memory.  KL threads a row; each keeps its NV float4
// of v in registers and sums PG rows at once, each row in the order j = 0,
// 1, ... of its float4; butterfly over the KL.  The loads are predicated,
// not branched around, so that the compiler can keep them in flight
// together; a float4 past n4 reads as zero and adds an exact 0.
template <int NV>
__device__ __forceinline__ void row_dots_nv(const float* M, int ld,
                                            const float* v, int n4, int rows,
                                            float* dst, float* dst_r,
                                            const float* base, float scale) {
  const int k = threadIdx.x % KL, rg = threadIdx.x / KL;
  const int nrg = blockDim.x / KL;
  const float4* v4 = reinterpret_cast<const float4*>(v);
  const float4* M4 = reinterpret_cast<const float4*>(M);
  const int ld4 = ld >> 2;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 vr[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c4 = k + KL * j;
    vr[j] = c4 < n4 ? v4[c4] : zero;
  }
  for (int r0 = 0; r0 < rows; r0 += PG * nrg) {
    float acc[PG];
#pragma unroll
    for (int p = 0; p < PG; ++p) acc[p] = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c4 = k + KL * j;
      float4 a[PG];
#pragma unroll
      for (int p = 0; p < PG; ++p) {
        const int r = r0 + rg + p * nrg;
        a[p] = (r < rows && c4 < n4) ? M4[(size_t)r * ld4 + c4] : zero;
      }
#pragma unroll
      for (int p = 0; p < PG; ++p) {
        acc[p] = fmaf(a[p].x, vr[j].x, acc[p]);
        acc[p] = fmaf(a[p].y, vr[j].y, acc[p]);
        acc[p] = fmaf(a[p].z, vr[j].z, acc[p]);
        acc[p] = fmaf(a[p].w, vr[j].w, acc[p]);
      }
    }
#pragma unroll
    for (int o = KL / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int p = 0; p < PG; ++p)
        acc[p] += __shfl_xor_sync(0xffffffffu, acc[p], o);
    }
    if (k == 0) {
#pragma unroll
      for (int p = 0; p < PG; ++p) {
        const int r = r0 + rg + p * nrg;
        if (r < rows) {
          const float val = base ? base[r] + scale * acc[p] : acc[p];
          dst[r] = val;
          if (dst_r) dst_r[r] = val;
        }
      }
    }
  }
}

// row_dots_nv with the fewest float4 a thread that cover n4 (<= KL * VMAX).
__device__ __forceinline__ void row_dots(const float* M, int ld,
                                         const float* v, int n4, int rows,
                                         float* dst, float* dst_r,
                                         const float* base, float scale) {
  if (n4 <= 3 * KL)
    row_dots_nv<3>(M, ld, v, n4, rows, dst, dst_r, base, scale);
  else if (n4 <= 4 * KL)
    row_dots_nv<4>(M, ld, v, n4, rows, dst, dst_r, base, scale);
  else
    row_dots_nv<VMAX>(M, ld, v, n4, rows, dst, dst_r, base, scale);
}

// y[l] = b[l] + sum_r M[r, l] x[r] for the n4 float4 columns of M (rows,
// ld) in shared memory: RG row groups (r = g, g + RG, ...), one lane each of
// an aligned group of RG lanes, four neighbouring columns a thread;
// butterfly over the group.
__device__ void col_dots(const float* M, int ld, const float* x, int n4,
                         int rows, const float* b, float* y) {
  const int ld4 = ld >> 2;
  const float4* M4 = reinterpret_cast<const float4*>(M);
  const int total = n4 * RG;
  for (int b0 = 0; b0 < total; b0 += blockDim.x) {
    const int idx = b0 + threadIdx.x;
    const int l4 = idx / RG, g = idx % RG;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (l4 < n4) {
      int r = g;
      for (; r + (CU - 1) * RG < rows; r += CU * RG) {
        float4 a[CU];
        float xr[CU];
#pragma unroll
        for (int i = 0; i < CU; ++i) {
          a[i] = M4[(size_t)(r + i * RG) * ld4 + l4];
          xr[i] = x[r + i * RG];
        }
#pragma unroll
        for (int i = 0; i < CU; ++i) {
          acc.x = fmaf(a[i].x, xr[i], acc.x);
          acc.y = fmaf(a[i].y, xr[i], acc.y);
          acc.z = fmaf(a[i].z, xr[i], acc.z);
          acc.w = fmaf(a[i].w, xr[i], acc.w);
        }
      }
      for (; r < rows; r += RG) {
        const float4 a = M4[(size_t)r * ld4 + l4];
        const float xr = x[r];
        acc.x = fmaf(a.x, xr, acc.x);
        acc.y = fmaf(a.y, xr, acc.y);
        acc.z = fmaf(a.z, xr, acc.z);
        acc.w = fmaf(a.w, xr, acc.w);
      }
    }
#pragma unroll
    for (int o = RG / 2; o > 0; o >>= 1) {
      acc.x += __shfl_xor_sync(0xffffffffu, acc.x, o);
      acc.y += __shfl_xor_sync(0xffffffffu, acc.y, o);
      acc.z += __shfl_xor_sync(0xffffffffu, acc.z, o);
      acc.w += __shfl_xor_sync(0xffffffffu, acc.w, o);
    }
    if (l4 < n4 && g == 0) {
      const float4 bb = reinterpret_cast<const float4*>(b)[l4];
      reinterpret_cast<float4*>(y)[l4] = make_float4(
          acc.x + bb.x, acc.y + bb.y, acc.z + bb.z, acc.w + bb.w);
    }
  }
}

// Sums each of the first N values of a (V of them) over the 32 lanes of a
// warp by halving: at the step of lane bit O each lane keeps half of its
// values and adds its partner's copy of that half, so that after the five
// steps every value's sum sits in one lane, in V + 5 shuffles or so in place
// of V log2(32).  Returns which value this lane holds at a[0] (its index,
// or -1 for none); the order of the sums is fixed.
template <int V, int N, int O>
struct WarpHalve {
  __device__ __forceinline__ static int run(float (&a)[V], int lane) {
    constexpr int H = (N + 1) / 2;
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float lo = a[i];
      const float hi = i + H < N ? a[i + H < N ? i + H : 0] : 0.0f;
      const float give = up ? lo : hi;
      const float keep = up ? hi : lo;
      a[i] = keep + __shfl_xor_sync(0xffffffffu, give, O);
    }
    // this lane's a[0] after the later steps, as an index of this step's
    // N values (at or past N: the padding of an odd N)
    const int rest = WarpHalve<V, H, O / 2>::run(a, lane);
    const int at = (up ? H : 0) + rest;
    return rest < 0 || at >= N ? -1 : at;
  }
};

template <int V, int N>
struct WarpHalve<V, N, 0> {
  __device__ __forceinline__ static int run(float (&)[V], int) { return 0; }
};

// Rows of E each warp of row_dots_ew sums at once.
constexpr int PE = 3;

// dst[3 p + d] = sum_c fl(E[p, c] Wf[d, c]) v[c] for p < nf, d < 3, stored
// also to dst_r (the other block's copy): G^T v with G^T's rows 3p .. 3p + 2
// formed from one row of E, each entry rounded once as the reference forms
// G^T (__fmul_rn, never contracted).  E (nf, ld), Wf (3, ld) and v (n4 <=
// 32 * NV float4, zero past the row's end) in shared memory.  A warp a row
// of E, PE rows at once (p = warp, warp + nw, ...); each lane keeps Wf's
// three rows and v at its NV float4 in registers, so that one load of E
// feeds three rows and the vectors are read once a warp, not once a row:
// what bounds this product is shared memory's bytes.  The PE * 3 sums of a
// lane, each in the order j = 0, 1, ... of its float4, are summed over the
// warp by WarpHalve.
template <int NV>
__device__ __forceinline__ void row_dots_ew_nv(const float* E,
                                               const float* Wf, int ld,
                                               const float* v, int n4,
                                               int nf, float* dst,
                                               float* dst_r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const float4* v4 = reinterpret_cast<const float4*>(v);
  const float4* E4 = reinterpret_cast<const float4*>(E);
  const float4* W4 = reinterpret_cast<const float4*>(Wf);
  const int ld4 = ld >> 2;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  constexpr int kSums = PE * kDims;
  float4 vr[NV], wr[kDims][NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c4 = lane + 32 * j;
    vr[j] = c4 < n4 ? v4[c4] : zero;
#pragma unroll
    for (int d = 0; d < kDims; ++d)
      wr[d][j] = c4 < n4 ? W4[d * ld4 + c4] : zero;
  }
  for (int p0 = warp; p0 < nf; p0 += PE * nw) {
    float acc[kSums];
#pragma unroll
    for (int q = 0; q < kSums; ++q) acc[q] = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c4 = lane + 32 * j;
      float4 a[PE];
#pragma unroll
      for (int i = 0; i < PE; ++i) {
        const int p = p0 + i * nw;
        a[i] = (p < nf && c4 < n4) ? E4[(size_t)p * ld4 + c4] : zero;
      }
#pragma unroll
      for (int i = 0; i < PE; ++i)
#pragma unroll
        for (int d = 0; d < kDims; ++d) {
          const float4 g = mul4(a[i], wr[d][j]);
          float& s = acc[i * kDims + d];
          s = fmaf(g.x, vr[j].x, s);
          s = fmaf(g.y, vr[j].y, s);
          s = fmaf(g.z, vr[j].z, s);
          s = fmaf(g.w, vr[j].w, s);
        }
    }
    const int q = WarpHalve<kSums, kSums, 16>::run(acc, lane);
    if (q >= 0 && q < kSums) {
      const int p = p0 + (q / kDims) * nw;
      if (p < nf) {
        dst[kDims * p + q % kDims] = acc[0];
        dst_r[kDims * p + q % kDims] = acc[0];
      }
    }
  }
}

// row_dots_ew_nv with the fewest float4 a lane that cover n4 (<= KL *
// VMAX <= 32 * 3).
__device__ __forceinline__ void row_dots_ew(const float* E, const float* Wf,
                                            int ld, const float* v, int n4,
                                            int nf, float* dst,
                                            float* dst_r) {
  static_assert(KL * VMAX <= 32 * 3, "row_dots_ew covers 96 float4");
  if (n4 <= 32)
    row_dots_ew_nv<1>(E, Wf, ld, v, n4, nf, dst, dst_r);
  else if (n4 <= 64)
    row_dots_ew_nv<2>(E, Wf, ld, v, n4, nf, dst, dst_r);
  else
    row_dots_ew_nv<3>(E, Wf, ld, v, n4, nf, dst, dst_r);
}

// y[l] = b[l] + sum_{p, d} fl(E[p, l] Wf[d, l]) x[3 p + d] for the n4 float4
// columns: G x with G^T's entries formed from its row factors as row_dots_ew
// forms them, E (nf, ld) and Wf (3, ld) in shared memory.  RG row groups of
// E (p = g, g + RG, ...), one lane each of an aligned group of RG lanes,
// four neighbouring columns a thread with Wf's three rows there in
// registers, one load of E feeding three rows (3p, 3p + 1, 3p + 2, in that
// order); butterfly over the group.
__device__ void col_dots_ew(const float* E, const float* Wf, int ld,
                            const float* x, int n4, int nf, const float* b,
                            float* y) {
  const int ld4 = ld >> 2;
  const float4* E4 = reinterpret_cast<const float4*>(E);
  const float4* W4 = reinterpret_cast<const float4*>(Wf);
  const int total = n4 * RG;
  for (int b0 = 0; b0 < total; b0 += blockDim.x) {
    const int idx = b0 + threadIdx.x;
    const int l4 = idx / RG, g = idx % RG;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (l4 < n4) {
      float4 wr[kDims];
#pragma unroll
      for (int d = 0; d < kDims; ++d) wr[d] = W4[d * ld4 + l4];
      int p = g;
      for (; p + (CU - 1) * RG < nf; p += CU * RG) {
        float4 a[CU];
        float xr[CU][kDims];
#pragma unroll
        for (int i = 0; i < CU; ++i) {
          a[i] = E4[(size_t)(p + i * RG) * ld4 + l4];
#pragma unroll
          for (int d = 0; d < kDims; ++d)
            xr[i][d] = x[kDims * (p + i * RG) + d];
        }
#pragma unroll
        for (int i = 0; i < CU; ++i)
#pragma unroll
          for (int d = 0; d < kDims; ++d) {
            const float4 gr = mul4(a[i], wr[d]);
            acc.x = fmaf(gr.x, xr[i][d], acc.x);
            acc.y = fmaf(gr.y, xr[i][d], acc.y);
            acc.z = fmaf(gr.z, xr[i][d], acc.z);
            acc.w = fmaf(gr.w, xr[i][d], acc.w);
          }
      }
      for (; p < nf; p += RG) {
        const float4 a = E4[(size_t)p * ld4 + l4];
#pragma unroll
        for (int d = 0; d < kDims; ++d) {
          const float4 gr = mul4(a, wr[d]);
          const float xr = x[kDims * p + d];
          acc.x = fmaf(gr.x, xr, acc.x);
          acc.y = fmaf(gr.y, xr, acc.y);
          acc.z = fmaf(gr.z, xr, acc.z);
          acc.w = fmaf(gr.w, xr, acc.w);
        }
      }
    }
#pragma unroll
    for (int o = RG / 2; o > 0; o >>= 1) {
      acc.x += __shfl_xor_sync(0xffffffffu, acc.x, o);
      acc.y += __shfl_xor_sync(0xffffffffu, acc.y, o);
      acc.z += __shfl_xor_sync(0xffffffffu, acc.z, o);
      acc.w += __shfl_xor_sync(0xffffffffu, acc.w, o);
    }
    if (l4 < n4 && g == 0) {
      const float4 bb = reinterpret_cast<const float4*>(b)[l4];
      reinterpret_cast<float4*>(y)[l4] = make_float4(
          acc.x + bb.x, acc.y + bb.y, acc.z + bb.z, acc.w + bb.w);
    }
  }
}

// How a block of the cluster design holds G^T: its share of the rows of a
// source, rows(nfd) of them, loaded once from row(r) (m_p lanes in device
// memory), and the two products on what it holds (ld = the layout's ldl,
// n4 = float4 of the block's lanes).
//   gt_v: dst[r] = sum_c G^T[r, c] v[c] over the block's lanes (its partial
//         of G^T v), stored also to dst_r;
//   g_x:  y[c] = b[c] + sum_r G^T[r, c] x[r] on the block's lanes.
// G^T's stored rows (the factored and fused entry points).
struct GtRowsOnChip {
  const float* gt;  // this scenario's (nfd, m_p)
  int m_p;
  __device__ __forceinline__ const float* row(int r) const {
    return gt + (size_t)r * m_p;
  }
  __device__ __forceinline__ static void gt_v(const float* G, int ld,
                                              const float* v, int n4,
                                              int nfd, float* dst,
                                              float* dst_r) {
    row_dots(G, ld, v, n4, nfd, dst, dst_r, nullptr, 0.0f);
  }
  __device__ __forceinline__ static void g_x(const float* G, int ld,
                                             const float* x, int n4, int nfd,
                                             const float* b, float* y) {
    col_dots(G, ld, x, n4, nfd, b, y);
  }
};

// G^T's row factors (the ew entry point): the nf = nfd / 3 rows of e, then
// the 3 rows of w; each G^T entry formed in registers, rounded once.
struct GtFactorsOnChip {
  const float* e;  // this scenario's (nf, m_p)
  const float* w;  // this scenario's (3, m_p)
  int m_p, nf;
  __device__ __forceinline__ const float* row(int r) const {
    return r < nf ? e + (size_t)r * m_p : w + (size_t)(r - nf) * m_p;
  }
  __device__ __forceinline__ static void gt_v(const float* G, int ld,
                                              const float* v, int n4,
                                              int nfd, float* dst,
                                              float* dst_r) {
    const int nf = nfd / kDims;
    row_dots_ew(G, G + (size_t)nf * ld, ld, v, n4, nf, dst, dst_r);
  }
  __device__ __forceinline__ static void g_x(const float* G, int ld,
                                             const float* x, int n4, int nfd,
                                             const float* b, float* y) {
    const int nf = nfd / kDims;
    col_dots_ew(G, G + (size_t)nf * ld, ld, x, n4, nf, b, y);
  }
};

__device__ __forceinline__ void put2(float* mine, float* theirs, int i,
                                     float v) {
  mine[i] = v;
  theirs[i] = v;
}

// acc + sum_c F[c] X[c, 4 q .. 4 q + 3] for c = 0 .. bsz - 1 in order: a row
// of a (bsz x bsz) factor (F, broadcast) against four neighbouring columns
// of a (bsz, ncl) panel (X, float4 rows).
__device__ __forceinline__ float4 quad_dot(const float* F, const float* X,
                                           int ncl, int q, int bsz) {
  const float4* X4 = reinterpret_cast<const float4*>(X);
  const int ncl4 = ncl >> 2;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 5
  for (int c = 0; c < bsz; ++c) {
    const float f = F[c];
    const float4 x = X4[c * ncl4 + q];
    acc.x = fmaf(f, x.x, acc.x);
    acc.y = fmaf(f, x.y, acc.y);
    acc.z = fmaf(f, x.z, acc.z);
    acc.w = fmaf(f, x.w, acc.w);
  }
  return acc;
}

__device__ __forceinline__ float comp(const float4& a, int t) {
  return t == 0 ? a.x : t == 1 ? a.y : t == 2 ? a.z : a.w;
}

// W^-1 columns c0 .. c0 + nc - 1 (unit right-hand sides) by the sweeps of
// m1_factored; a task is one row of a sweep step for four neighbouring
// columns.  Each column is stored to this block's winv and to the other
// block's (winv_r).  P and Q are (bsz, ncl) panels, ncl % 4 == 0; columns
// past nc carry zeros.
__device__ __forceinline__ void winv_columns(
    float* winv, float* winv_r, int ldw, int c0, int nc, int ncl,
    const float* sinv_s, const float* t_s, const float* tt_s, float* P,
    float* Q, int m_blk, int bsz) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int bb = bsz * bsz;
  const int nq = (nc + 3) / 4;
  const int tasks = bsz * nq;
  // y_0 = e_c restricted to block 0;  z_0 = S_0^-1 y_0
  for (int i = tid; i < bsz * ncl; i += nt) {
    const int r = i / ncl, cc = i - r * ncl;
    P[i] = cc < nc && r == c0 + cc ? 1.0f : 0.0f;
  }
  __syncthreads();
  // forward + diagonal: Q = e_c|block i - T_i P;  z_i = S_i^-1 Q.  The next
  // T step reads Q (synchronised before the S step) and overwrites the old
  // P, last read before that synchronisation; the last S step also keeps
  // z_{m-1} in the free panel P for the backward sweep.
  for (int blk = 0; blk < m_blk; ++blk) {
    const float* si = sinv_s + blk * bb;
    if (blk > 0) {
      const float* ti = t_s + (blk - 1) * bb;
      for (int i = tid; i < tasks; i += nt) {
        const int r = i / nq, q = i - r * nq;
        const float4 acc = quad_dot(ti + r * bsz, P, ncl, q, bsz);
        float4 y;
        const int col = c0 + 4 * q - (blk * bsz + r);
        y.x = (col == 0 ? 1.0f : 0.0f) - acc.x;
        y.y = (col == -1 ? 1.0f : 0.0f) - acc.y;
        y.z = (col == -2 ? 1.0f : 0.0f) - acc.z;
        y.w = (col == -3 ? 1.0f : 0.0f) - acc.w;
        reinterpret_cast<float4*>(Q)[r * (ncl >> 2) + q] = y;
      }
      __syncthreads();
      float* sw = P; P = Q; Q = sw;
    }
    // P holds y_blk; Q is free
    const bool last = blk == m_blk - 1;
    for (int i = tid; i < tasks; i += nt) {
      const int r = i / nq, q = i - r * nq;
      const float4 acc = quad_dot(si + r * bsz, P, ncl, q, bsz);
      if (last) reinterpret_cast<float4*>(Q)[r * (ncl >> 2) + q] = acc;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (4 * q + t < nc)
          put2(winv, winv_r, (blk * bsz + r) * ldw + c0 + 4 * q + t,
               comp(acc, t));
    }
    __syncthreads();
  }
  // backward: x_{m-1} = z_{m-1} (in Q);  x_i = z_i - T_{i+1}^T x_{i+1}
  float* prev = Q;
  float* cur = P;
  for (int blk = m_blk - 2; blk >= 0; --blk) {
    const float* tti = tt_s + blk * bb;
    for (int i = tid; i < tasks; i += nt) {
      const int r = i / nq, q = i - r * nq;
      const float4 acc = quad_dot(tti + r * bsz, prev, ncl, q, bsz);
      float4 x;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int at = (blk * bsz + r) * ldw + c0 + 4 * q + t;
        const float xv = 4 * q + t < nc ? winv[at] - comp(acc, t) : 0.0f;
        if (4 * q + t < nc) put2(winv, winv_r, at, xv);
        (t == 0 ? x.x : t == 1 ? x.y : t == 2 ? x.z : x.w) = xv;
      }
      reinterpret_cast<float4*>(cur)[r * (ncl >> 2) + q] = x;
    }
    __syncthreads();
    float* sw = prev; prev = cur; cur = sw;
  }
}

// The projection and the z/u/v updates of one iteration on this block's
// lanes (y in S.y); the arithmetic of stage_iterations.
__device__ __forceinline__ void cluster_update(const StageArgs& a,
                                               const Split& q, const Vecs& S) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const float alpha = a.alpha, one_m_alpha = 1.0f - a.alpha;
  const int hb = q.hb;
  for (int j = tid; j < hb; j += nt) {
    const int lx = j, ly = hb + j, lz = 2 * hb + j;
    const float yx = S.y[lx], yy = S.y[ly], yz = S.y[lz];
    const float zx0 = S.z[lx], zy0 = S.z[ly], zz0 = S.z[lz];
    const float rx = alpha * yx + one_m_alpha * zx0;
    const float ry = alpha * yy + one_m_alpha * zy0;
    const float rz = alpha * yz + one_m_alpha * zz0;
    const float ux = S.u[lx], uy = S.u[ly], uz = S.u[lz];
    const float wx = rx + ux, wy = ry + uy, wz = rz + uz;
    float zx, zy, zz;
    if (q.j0 + j < a.n_ball) {
      const float sc = ball_scale(wx, wy, wz, S.rb[j]);
      zx = wx * sc; zy = wy * sc; zz = wz * sc;
    } else {
      zx = fminf(wx, 0.0f); zy = fminf(wy, 0.0f); zz = fminf(wz, 0.0f);
    }
    const float nux = wx - zx, nuy = wy - zy, nuz = wz - zz;
    S.zp[lx] = zx0; S.zp[ly] = zy0; S.zp[lz] = zz0;
    S.z[lx] = zx; S.z[ly] = zy; S.z[lz] = zz;
    S.u[lx] = nux; S.u[ly] = nuy; S.u[lz] = nuz;
    S.v[lx] = zx - nux - S.b[lx];
    S.v[ly] = zy - nuy - S.b[ly];
    S.v[lz] = zz - nuz - S.b[lz];
  }
  for (int l = 3 * hb + tid; l < q.nl; l += nt) {
    const float z0 = S.z[l];
    const float w = (alpha * S.y[l] + one_m_alpha * z0) + S.u[l];
    const float zl = fminf(w, 0.0f);
    const float nu = w - zl;
    S.zp[l] = z0; S.z[l] = zl; S.u[l] = nu;
    S.v[l] = zl - nu - S.b[l];
  }
}

// z/u from the warm start (init_z) or carried in, on this block's lanes, from
// y = G x0 + b in S.y.
__device__ __forceinline__ void cluster_init(const StageArgs& a, int s,
                                             const Split& q, const Vecs& S) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int hb = q.hb, m_p = a.m_p, nb_p = a.nb_p;
  for (int j = tid; j < hb; j += nt) {
    const int lx = j, ly = hb + j, lz = 2 * hb + j;
    const float yx = S.y[lx], yy = S.y[ly], yz = S.y[lz];
    float zx, zy, zz, ux = 0.0f, uy = 0.0f, uz = 0.0f;
    if (a.init_z) {
      if (q.j0 + j < a.n_ball) {
        const float sc = ball_scale(yx, yy, yz, S.rb[j]);
        zx = yx * sc; zy = yy * sc; zz = yz * sc;
      } else {
        zx = fminf(yx, 0.0f); zy = fminf(yy, 0.0f); zz = fminf(yz, 0.0f);
      }
    } else {
      const size_t o = (size_t)s * m_p + q.j0 + j;
      zx = a.z0[o]; zy = a.z0[o + nb_p]; zz = a.z0[o + 2 * nb_p];
      ux = a.u0[o]; uy = a.u0[o + nb_p]; uz = a.u0[o + 2 * nb_p];
    }
    S.z[lx] = zx; S.z[ly] = zy; S.z[lz] = zz;
    S.zp[lx] = zx; S.zp[ly] = zy; S.zp[lz] = zz;
    S.u[lx] = ux; S.u[ly] = uy; S.u[lz] = uz;
    S.v[lx] = zx - ux - S.b[lx];
    S.v[ly] = zy - uy - S.b[ly];
    S.v[lz] = zz - uz - S.b[lz];
  }
  for (int l = 3 * hb + tid; l < q.nl; l += nt) {
    float zl, ul = 0.0f;
    if (a.init_z) {
      zl = fminf(S.y[l], 0.0f);
    } else {
      const size_t o = (size_t)s * m_p + 3 * nb_p + q.f0 + (l - 3 * hb);
      zl = a.z0[o];
      ul = a.u0[o];
    }
    S.z[l] = zl; S.zp[l] = zl; S.u[l] = ul;
    S.v[l] = zl - ul - S.b[l];
  }
}

// Phase profile of the cluster design (stage_profile.py at the top of the
// repository builds this source with -DADMM_STAGE_PROFILE): thread 0 of the
// grid's first block adds the clock64 cycles since its last mark to
// stage_prof[i] at mark i.  Without the macro the marks compile to nothing.
#ifdef ADMM_STAGE_PROFILE
__device__ unsigned long long stage_prof[16];
#define PROF_START long long prof_last = clock64()
#define PROF(i)                                                        \
  do {                                                                 \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                         \
      const long long c_ = clock64();                                  \
      stage_prof[i] += (unsigned long long)(c_ - prof_last);           \
      prof_last = c_;                                                  \
    }                                                                  \
  } while (0)
#else
#define PROF_START do {} while (0)
#define PROF(i) do {} while (0)
#endif

// One scenario a cluster of kCluster blocks (blockIdx.x / 2): the stage of
// entry point kEntry (Entry), G^T held as the source type G says.
template <int kEntry, class G>
__device__ __forceinline__ void cluster_stage(const StageArgs& a,
                                              const G& src) {
  extern __shared__ __align__(16) float smem[];
  PROF_START;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int other = rank ^ 1;
  const int s = blockIdx.x / kCluster;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nfd = a.nfd, m_p = a.m_p, nb_p = a.nb_p;
  const int m_blk = a.m_blk, bsz = a.bsz, bb = bsz * bsz;
  const CLayout L = make_cluster_layout(kEntry, nfd, m_p, m_blk, bsz, nb_p);
  const Split q = split_of(rank, m_p, nb_p);
  const int nl = q.nl, ldl = L.ldl, ldw = L.ldw, n4 = (nl + 3) / 4;
  const int rows = L.rows;
  Vecs S;
  S.b = smem + L.b;   S.rb = smem + L.rb; S.z = smem + L.z;
  S.zp = smem + L.zp; S.u = smem + L.u;   S.v = smem + L.v;
  S.y = smem + L.y;   S.xq = smem + L.xq; S.x = smem + L.x;
  S.tmp = smem + L.g; S.part = smem + L.gpart; S.red = smem + L.red;
  float* winv = smem + L.winv;
  float* gts = smem + L.gts;
  float* xch = smem + L.xch;

  // ---- copies in flight: W^-1 or the factors it is formed from, and the
  // vectors (group 1), then the rows of G^T's source before the scratch
  // (group 2; every row where W^-1 is given) ---------------------------------
  float* sinv_s = smem + L.scr;
  float* t_s = sinv_s + round4(m_blk * bb);
  float* tt_s = t_s + round4((m_blk - 1) * bb);
  float* P = tt_s + round4((m_blk - 1) * bb);
  float* Q = P + bsz * L.ncl;
  if (winv_given(kEntry)) {
    // the caller's rows as given, 4 bytes a copy (a row of nfd floats need
    // not start on a 16-byte boundary)
    const float* wg = a.winv + (size_t)s * nfd * nfd;
    for (int i = tid; i < nfd * nfd; i += nt) {
      const int r = i / nfd;
      cp_async4(winv + r * ldw + (i - r * nfd), wg + i);
    }
  } else {
    load_async(sinv_s, a.sinv + (size_t)s * m_blk * bb, m_blk * bb);
    load_async(t_s, a.t + (size_t)s * (m_blk - 1) * bb, (m_blk - 1) * bb);
    load_async(tt_s, a.tt + (size_t)s * (m_blk - 1) * bb, (m_blk - 1) * bb);
  }
  load_async(S.xq, a.xq + (size_t)s * nfd, nfd);
  load_async(S.x, a.x0 + (size_t)s * nfd, nfd);
  load_async(S.rb, a.rb + (size_t)s * nb_p + q.j0, q.hb);
  for (int l = tid; l < nl; l += nt)
    cp_async4(S.b + l, a.b + (size_t)s * m_p + lane_of(q, l, nb_p));
  cp_async_commit();
  load_gt_rows(src, gts, q, 0, L.r_pre, nb_p, ldl);
  cp_async_commit();

  // ---- zero padding ---------------------------------------------------------
  for (int i = tid; i < nfd * (ldw - nfd); i += nt) {
    const int r = i / (ldw - nfd);
    winv[r * ldw + nfd + (i - r * (ldw - nfd))] = 0.0f;
  }
  for (int l = tid; l < ldl; l += nt) {
    if (l >= nl) S.b[l] = 0.0f;
    S.z[l] = 0.0f; S.zp[l] = 0.0f; S.u[l] = 0.0f; S.v[l] = 0.0f;
    S.y[l] = 0.0f;
  }
  for (int r = nfd + tid; r < ldw; r += nt) {
    S.xq[r] = 0.0f; S.x[r] = 0.0f;
  }
  for (int r = tid; r < ldw; r += nt) S.tmp[r] = 0.0f;
  const float rho = a.rho[s];
  cp_async_wait<1>();
  // Both blocks have started (the other's shared memory is written next)
  // and this block's copies of group 1 are visible to all its threads.
  cluster.sync();
  PROF(0);

  // ---- W^-1 where it is formed: half of its columns here, stored to both
  // blocks --------------------------------------------------------------------
  if (!winv_given(kEntry)) {
    const int half = (nfd + 1) / 2;
    winv_columns(winv, cluster.map_shared_rank(winv, other), ldw,
                 rank == 0 ? 0 : half, rank == 0 ? half : nfd - half, L.ncl,
                 sinv_s, t_s, tt_s, P, Q, m_blk, bsz);
    cluster.sync();
  }
  PROF(1);

  // ---- the rest of G^T's source over the scratch ---------------------------
  load_gt_rows(src, gts, q, L.r_pre, rows, nb_p, ldl);
  cp_async_commit();
  for (int i = tid; i < rows * (4 * n4 - nl); i += nt) {
    const int r = i / (4 * n4 - nl);
    gts[(size_t)r * ldl + nl + (i - r * (4 * n4 - nl))] = 0.0f;
  }
  cp_async_wait<0>();
  __syncthreads();
  PROF(2);

  // ---- y = G x0 + b; z, u ---------------------------------------------------
  G::g_x(gts, ldl, S.x, n4, nfd, S.b, S.y);
  __syncthreads();
  cluster_init(a, s, q, S);
  __syncthreads();
  PROF(3);

  // ---- the iterations -------------------------------------------------------
  // part[(buf * kCluster + rank) * ldw + r]: rank's partial of buffer buf,
  // stored by its block to its own and to the other block's shared memory
  // before the barrier; after it each block reads both from its own.
  float* part_r = cluster.map_shared_rank(S.part, other);
  for (int it = 0; it < a.n_iters; ++it) {
    const int buf = (it & 1) * kCluster * ldw;
    G::gt_v(gts, ldl, S.v, n4, nfd, S.part + buf + rank * ldw,
            part_r + buf + rank * ldw);
    PROF(4);
    cluster.sync();
    PROF(5);
    for (int r = tid; r < nfd; r += nt)
      S.tmp[r] = S.part[buf + r] + S.part[buf + ldw + r];
    __syncthreads();
    PROF(6);
    row_dots(winv, ldw, S.tmp, ldw / 4, nfd, S.x, nullptr, S.xq, rho);
    __syncthreads();
    PROF(7);
    G::g_x(gts, ldl, S.x, n4, nfd, S.b, S.y);
    __syncthreads();
    PROF(8);
    cluster_update(a, q, S);
    __syncthreads();
    PROF(9);
  }

  // ---- residuals and outputs ------------------------------------------------
  float pmax = 0.0f;
  for (int l = tid; l < nl; l += nt) {
    pmax = fmaxf(pmax, fabsf(S.y[l] - S.z[l]));
    S.v[l] = S.z[l] - S.zp[l];
  }
  __syncthreads();
  // the other buffer than the last iteration's: see the top of the file
  const int dbuf = (a.n_iters & 1) * kCluster * ldw;
  G::gt_v(gts, ldl, S.v, n4, nfd, S.part + dbuf + rank * ldw,
          part_r + dbuf + rank * ldw);
  pmax = block_max(pmax, S.red);
  if (tid == 0) {
    xch[rank] = pmax;
    *cluster.map_shared_rank(xch + rank, other) = pmax;
  }
  cluster.sync();
  float dmax = 0.0f;
  for (int r = tid; r < nfd; r += nt)
    dmax = fmaxf(dmax, fabsf(S.part[dbuf + r] + S.part[dbuf + ldw + r]));
  dmax = block_max(dmax, S.red);
  if (rank == 0) {
    if (tid == 0) {
      a.prim[s] = a.n_iters > 0 ? fmaxf(xch[0], xch[1]) : CUDART_INF_F;
      a.dual[s] = dmax;
    }
    for (int r = tid; r < nfd; r += nt) a.x[(size_t)s * nfd + r] = S.x[r];
  }
  for (int l = tid; l < nl; l += nt) {
    const size_t o = (size_t)s * m_p + lane_of(q, l, nb_p);
    a.z[o] = S.z[l];
    a.zp[o] = S.zp[l];
    a.u[o] = S.u[l];
    a.y[o] = S.y[l];
  }
  // No block leaves while the other may still address its shared memory.
  cluster.sync();
  PROF(10);
}

// The three entry functions of the cluster design.
__global__ void __launch_bounds__(512, 1)
admm_stage_cluster_kernel(StageArgs a) {
  const size_t s = blockIdx.x / kCluster;
  cluster_stage<kEntryFactored>(
      a, GtRowsOnChip{a.gt + s * a.nfd * a.m_p, a.m_p});
}

__global__ void __launch_bounds__(512, 1)
admm_stage_fused_cluster_kernel(StageArgs a) {
  const size_t s = blockIdx.x / kCluster;
  cluster_stage<kEntryFused>(
      a, GtRowsOnChip{a.gt + s * a.nfd * a.m_p, a.m_p});
}

__global__ void __launch_bounds__(512, 1)
admm_stage_ew_cluster_kernel(StageArgs a) {
  const size_t s = blockIdx.x / kCluster;
  const int nf = a.nfd / kDims;
  cluster_stage<kEntryEw>(
      a, GtFactorsOnChip{a.e + s * nf * a.m_p, a.w + s * kDims * a.m_p,
                         a.m_p, nf});
}


// ---------------------------------------------------------------------------
// The cluster design of the stage entry point (admm_stage_launch): m1 is
// given, so an iteration is x = xq + rho (m1 v), y = G x + b, in the
// reference's order of operations, and needs no W^-1.  One scenario's m1 and
// G^T (2 x 270 KB at the flagship) fit on chip only split four ways: one
// scenario a cluster of kGivenRanks blocks, each keeping, for all
// iterations, its share of the lanes' columns of both (split_of with
// kGivenRanks ranks: 128 lanes, 2 x 135 x 132 floats, 152 KB a block at the
// flagship) beside its lanes' vectors and the nfd-vectors xq and x, each
// input loaded from device memory once by cp.async.  An iteration:
//   each block  p_k = m1_k v_k  (its lanes' partial, nfd floats), stored to
//   every block's shared memory (double-buffered, as the other cluster
//   design's partials); one cluster barrier; each block forms
//   g = ((p_0 + p_1) + p_2) + p_3 in rank order, so all hold the same bits,
//   and x = xq + rho g; y_k = G_k x + b_k; the projection and the z/u/v
//   updates on its own lanes (cluster_update).
// prim = max|y - z| is combined over the blocks in rank order; with no
// iterations the outputs are exactly (xq, z0, z0, u0, inf).  What bounds
// it: not the bytes (read once) and not the 2 x 2 nfd m_p multiply-adds an
// iteration, but an iteration's latency (two short products over 128 lanes,
// the partials' stores to the other blocks and the cluster barrier) with
// one block an SM, 33 clusters in flight on an H100.
// -DADMM_STAGE_GIVEN_RANKS=n builds it with clusters of n blocks (2, 4 or
// 8; stage_profile.py --designs); -DADMM_STAGE_CONTROL_DROP_RANK3 leaves
// rank 3's partial out of g (a negative control of chip_smoke.py).
// ---------------------------------------------------------------------------

#ifndef ADMM_STAGE_GIVEN_RANKS
#define ADMM_STAGE_GIVEN_RANKS 4
#endif
constexpr int kGivenRanks = ADMM_STAGE_GIVEN_RANKS;
static_assert(kGivenRanks == 2 || kGivenRanks == 4 || kGivenRanks == 8,
              "a portable cluster of 2, 4 or 8 blocks");

// Shared-memory layout of one block of the stage entry point's cluster
// design, in floats: m1's and G^T's shares (nfd rows of ldl lanes each),
// the lane vectors, rb of its balls, xq, x, g, the partials (two buffers of
// one nfd-vector a rank), the block reduction's scratch, prim's exchange.
struct GLayout {
  int ldl, ldw, m1s, gts, b, z, zp, u, v, y, rb, xq, x, g, gpart, red, xch;
  int total;
};

__host__ __device__ inline GLayout make_given_layout(int nfd, int m_p,
                                                     int nb_p) {
  GLayout L;
  const Split q0 = split_of(0, m_p, nb_p, kGivenRanks);  // the largest share
  L.ldw = round4(nfd);
  L.ldl = round4(q0.nl);
  if ((L.ldl / 4) % 2 == 0) L.ldl += 4;   // as the other cluster design
  int o = 0;
  L.m1s = o;   o += nfd * L.ldl;
  L.gts = o;   o += nfd * L.ldl;
  L.b = o;     o += L.ldl;
  L.z = o;     o += L.ldl;
  L.zp = o;    o += L.ldl;
  L.u = o;     o += L.ldl;
  L.v = o;     o += L.ldl;
  L.y = o;     o += L.ldl;
  L.rb = o;    o += round4(q0.hb);
  L.xq = o;    o += L.ldw;
  L.x = o;     o += L.ldw;
  L.g = o;     o += L.ldw;
  L.gpart = o; o += 2 * kGivenRanks * L.ldw;
  L.red = o;   o += 32;
  L.xch = o;   o += round4(kGivenRanks);
  L.total = o;
  return L;
}

// dst[r] = sum_c M[r, c] v[c] for r < rows (row_dots_nv with the fewest
// float4 a thread that cover n4 <= KL * VMAX).
__device__ __forceinline__ void given_row_dots(const float* M, int ld,
                                               const float* v, int n4,
                                               int rows, float* dst) {
  if (n4 <= KL)
    row_dots_nv<1>(M, ld, v, n4, rows, dst, nullptr, nullptr, 0.0f);
  else if (n4 <= 2 * KL)
    row_dots_nv<2>(M, ld, v, n4, rows, dst, nullptr, nullptr, 0.0f);
  else
    row_dots(M, ld, v, n4, rows, dst, nullptr, nullptr, 0.0f);
}

// The stage of scenario blockIdx.x / kGivenRanks from the caller's m1.
__device__ __forceinline__ void given_stage(const StageArgs& a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = kGivenRanks;
  PROF_START;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int s = blockIdx.x / R;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nfd = a.nfd, m_p = a.m_p, nb_p = a.nb_p;
  const GLayout L = make_given_layout(nfd, m_p, nb_p);
  const Split q = split_of(rank, m_p, nb_p, R);
  const int nl = q.nl, ldl = L.ldl, ldw = L.ldw, n4 = (nl + 3) / 4;
  Vecs S;
  S.b = smem + L.b;   S.rb = smem + L.rb; S.z = smem + L.z;
  S.zp = smem + L.zp; S.u = smem + L.u;   S.v = smem + L.v;
  S.y = smem + L.y;   S.xq = smem + L.xq; S.x = smem + L.x;
  S.tmp = smem + L.g; S.part = smem + L.gpart; S.red = smem + L.red;
  float* m1s = smem + L.m1s;
  float* gts = smem + L.gts;
  float* xch = smem + L.xch;
  const size_t so = (size_t)s * m_p;

  // ---- copies: the vectors, then m1's and G^T's shares -----------------------
  load_async(S.xq, a.xq + (size_t)s * nfd, nfd);
  load_async(S.rb, a.rb + (size_t)s * nb_p + q.j0, q.hb);
  for (int l = tid; l < nl; l += nt) {
    const int lane = lane_of(q, l, nb_p);
    cp_async4(S.b + l, a.b + so + lane);
    cp_async4(S.z + l, a.z0 + so + lane);
    cp_async4(S.u + l, a.u0 + so + lane);
  }
  cp_async_commit();
  load_gt_rows(GtRowsOnChip{a.m1 + (size_t)s * nfd * m_p, m_p}, m1s, q, 0,
               nfd, nb_p, ldl);
  load_gt_rows(GtRowsOnChip{a.gt + (size_t)s * nfd * m_p, m_p}, gts, q, 0,
               nfd, nb_p, ldl);
  cp_async_commit();

  // ---- zero padding: lanes past nl, rows past nfd ---------------------------
  const int pad = 4 * n4 - nl;
  for (int i = tid; i < nfd * pad; i += nt) {
    const int r = i / pad, c = nl + (i - r * pad);
    m1s[(size_t)r * ldl + c] = 0.0f;
    gts[(size_t)r * ldl + c] = 0.0f;
  }
  for (int l = nl + tid; l < ldl; l += nt) {
    S.b[l] = 0.0f; S.z[l] = 0.0f; S.zp[l] = 0.0f; S.u[l] = 0.0f;
    S.v[l] = 0.0f;
  }
  for (int l = tid; l < ldl; l += nt) S.y[l] = 0.0f;
  for (int r = nfd + tid; r < ldw; r += nt) {
    S.xq[r] = 0.0f; S.x[r] = 0.0f;
  }
  for (int r = tid; r < ldw; r += nt) S.tmp[r] = 0.0f;
  const float rho = a.rho[s];
  cp_async_wait<1>();
  __syncthreads();
  // x = xq, z_prev = z0, v = z - u - b
  for (int r = tid; r < nfd; r += nt) S.x[r] = S.xq[r];
  for (int l = tid; l < nl; l += nt) {
    S.zp[l] = S.z[l];
    S.v[l] = S.z[l] - S.u[l] - S.b[l];
  }
  cp_async_wait<0>();
  // Every block has started (the others' shared memory is written next) and
  // this block's copies are visible to all its threads.
  cluster.sync();
  PROF(0);

  // ---- the iterations -------------------------------------------------------
  // part[(buf * R + k) * ldw + r]: rank k's partial of buffer buf, stored by
  // its block to every block's shared memory before the barrier.
  for (int it = 0; it < a.n_iters; ++it) {
    const int buf = (it & 1) * R * ldw;
    float* own = S.part + buf + rank * ldw;
    given_row_dots(m1s, ldl, S.v, n4, nfd, own);
    __syncthreads();
    PROF(1);
    for (int i = tid; i < (R - 1) * nfd; i += nt) {
      const int j = i / nfd, r = i - j * nfd;
      const int k = rank + 1 + j < R ? rank + 1 + j : rank + 1 + j - R;
      cluster.map_shared_rank(S.part, k)[buf + rank * ldw + r] = own[r];
    }
    PROF(2);
    cluster.sync();
    PROF(3);
    for (int r = tid; r < nfd; r += nt) {
      float g = S.part[buf + r];
#pragma unroll
      for (int k = 1; k < R; ++k) {
#ifdef ADMM_STAGE_CONTROL_DROP_RANK3
        if (k == 3) continue;
#endif
        g += S.part[buf + k * ldw + r];
      }
      S.x[r] = S.xq[r] + __fmul_rn(rho, g);
    }
    __syncthreads();
    PROF(4);
    col_dots(gts, ldl, S.x, n4, nfd, S.b, S.y);
    __syncthreads();
    PROF(5);
    cluster_update(a, q, S);
    __syncthreads();
    PROF(6);
  }

  // ---- prim, combined in rank order, and the outputs --------------------------
  float pmax = 0.0f;
  for (int l = tid; l < nl; l += nt) pmax = fmaxf(pmax, fabsf(S.y[l] - S.z[l]));
  pmax = block_max(pmax, S.red);
  if (tid < R) *cluster.map_shared_rank(xch + rank, tid) = pmax;
  cluster.sync();
  if (rank == 0) {
    if (tid == 0) {
      float p = xch[0];
      for (int k = 1; k < R; ++k) p = fmaxf(p, xch[k]);
      a.prim[s] = a.n_iters > 0 ? p : CUDART_INF_F;
    }
    for (int r = tid; r < nfd; r += nt) a.x[(size_t)s * nfd + r] = S.x[r];
  }
  for (int l = tid; l < nl; l += nt) {
    const size_t o = so + lane_of(q, l, nb_p);
    a.z[o] = S.z[l];
    a.zp[o] = S.zp[l];
    a.u[o] = S.u[l];
  }
  // No block leaves while another may still address its shared memory.
  cluster.sync();
  PROF(7);
}

__global__ void __launch_bounds__(512, 1)
admm_stage_given_cluster_kernel(StageArgs a) {
  given_stage(a);
}

void (*cluster_kernel_of(int entry))(StageArgs) {
  return entry == kEntryFused   ? admm_stage_fused_cluster_kernel
         : entry == kEntryEw    ? admm_stage_ew_cluster_kernel
         : entry == kEntryGiven ? admm_stage_given_cluster_kernel
                                : admm_stage_cluster_kernel;
}

// Blocks a scenario's cluster takes in entry point `entry`'s design.
int cluster_size_of(int entry) {
  return entry == kEntryGiven ? kGivenRanks : kCluster;
}

size_t cluster_smem_of(int entry, int nfd, int m_p, int m_blk, int bsz,
                       int nb_p) {
  if (entry == kEntryGiven)
    return (size_t)make_given_layout(nfd, m_p, nb_p).total * sizeof(float);
  return (size_t)make_cluster_layout(entry, nfd, m_p, m_blk, bsz, nb_p)
             .total *
         sizeof(float);
}

// The current device's shared memory as the runtime reports it: what a
// block may take, what an SM holds, what the card keeps for each block.
struct SmemLimits {
  int optin, per_sm, reserved;
};

constexpr int kMaxDevices = 64;

// Read once a device and kept (a launch asks for them every time): the
// three limits, published by `known` after they are stored.
std::atomic<int> limits_optin[kMaxDevices], limits_per_sm[kMaxDevices],
    limits_reserved[kMaxDevices];
std::atomic<bool> limits_known[kMaxDevices];

bool smem_limits(SmemLimits* out) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return false;
  if (!limits_known[dev].load(std::memory_order_acquire)) {
    int optin = 0, per_sm = 0, reserved = 0;
    if (cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&per_sm,
                               cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                               dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&reserved,
                               cudaDevAttrReservedSharedMemoryPerBlock,
                               dev) != cudaSuccess)
      return false;
    limits_optin[dev].store(optin, std::memory_order_relaxed);
    limits_per_sm[dev].store(per_sm, std::memory_order_relaxed);
    limits_reserved[dev].store(reserved, std::memory_order_relaxed);
    limits_known[dev].store(true, std::memory_order_release);
  }
  out->optin = limits_optin[dev].load(std::memory_order_relaxed);
  out->per_sm = limits_per_sm[dev].load(std::memory_order_relaxed);
  out->reserved = limits_reserved[dev].load(std::memory_order_relaxed);
  return true;
}

// Whether a block's share of entry point `entry`'s stage fits the cluster
// design on the current device: its shared memory, and rows of G^T's share
// (or of its factors) and of W^-1 short enough for the row products'
// registers.
bool cluster_fits(int entry, int nfd, int m_p, int m_blk, int bsz, int nb_p,
                  int threads) {
#ifdef ADMM_STAGE_STREAM
  // every shape takes the stream design (stage_profile.py --designs times
  // the two designs on the same call)
  return false;
#endif
  SmemLimits lim;
  if (!smem_limits(&lim)) return false;
  const int n4 = (split_of(0, m_p, nb_p, cluster_size_of(entry)).nl + 3) / 4;
  return cluster_smem_of(entry, nfd, m_p, m_blk, bsz, nb_p) <=
             (size_t)lim.optin &&
         n4 <= KL * VMAX && round4(nfd) / 4 <= KL * VMAX && threads <= 512 &&
         threads % KL == 0;
}

// Fewest threads a block of the cluster design takes.
constexpr int kMinClusterThreads = 64;

// Threads a block of the cluster design takes, given at most max_threads:
// max_threads an SM, spread over as many blocks as the SM's shared memory
// holds at once at this entry point's share (halving the block while its
// half stays a multiple of 32 and at least kMinClusterThreads).  Every sum
// keeps its order whatever the block size (a row's sum runs over KL threads,
// a lane group's over RG), so the bits do not depend on it.  Measured on an
// H100: the flagship's share takes a whole SM's shared memory (512
// threads), K=4's a fifth (128) and the fused entry point's K=2 an eighth
// (64), where 512 threads a block left an iteration's fixed cost (the
// barriers, the short phases) to 66 clusters in flight and ran 5x slower.
int cluster_threads_of(int entry, int nfd, int m_p, int m_blk, int bsz,
                       int nb_p, int max_threads) {
#ifdef ADMM_STAGE_CLUSTER_THREADS
  // one block size at every shape (stage_profile.py --designs times each)
  return ADMM_STAGE_CLUSTER_THREADS;
#endif
  SmemLimits lim;
  if (!smem_limits(&lim)) return max_threads;
  const size_t blocks =
      (size_t)lim.per_sm / (cluster_smem_of(entry, nfd, m_p, m_blk, bsz, nb_p) +
                            (size_t)lim.reserved);
  int t = max_threads;
  while (t / 2 >= kMinClusterThreads && (t / 2) % 32 == 0 &&
         (size_t)t * blocks > (size_t)max_threads)
    t /= 2;
  return t;
}

cudaLaunchConfig_t cluster_config(int batch, int threads, size_t smem,
                                  void* stream, cudaLaunchAttribute* attr,
                                  int ranks) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks * batch, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The most dynamic shared memory each entry point's cluster kernel has been
// allowed on each device, so that a launch sets the attribute only when it
// needs more.
std::atomic<int> cluster_smem_allowed[kEntries][kMaxDevices];

cudaError_t allow_cluster_smem(int entry, size_t smem) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && cluster_smem_allowed[entry][dev].load(
                    std::memory_order_acquire) >= (int)smem)
    return cudaSuccess;
  e = cudaFuncSetAttribute(cluster_kernel_of(entry),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess && cached) {
    int seen = cluster_smem_allowed[entry][dev].load();
    while (seen < (int)smem &&
           !cluster_smem_allowed[entry][dev].compare_exchange_weak(
               seen, (int)smem)) {
    }
  }
  return e;
}

cudaError_t launch_cluster(int entry, const StageArgs& a, int batch,
                           int threads, void* stream) {
  const size_t smem =
      cluster_smem_of(entry, a.nfd, a.m_p, a.m_blk, a.bsz, a.nb_p);
  void (*kernel)(StageArgs) = cluster_kernel_of(entry);
  cudaError_t e = allow_cluster_smem(entry, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      batch,
      cluster_threads_of(entry, a.nfd, a.m_p, a.m_blk, a.bsz, a.nb_p,
                         threads),
      smem, stream, attr, cluster_size_of(entry));
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

int row_groups(int threads, int m_p) {
  int g = threads / (m_p / 4);
  if (g < 1) g = 1;
  if (g > 8) g = 8;
  return g;
}

size_t smem_of(int phase1, int nfd, int m_p, int m_blk, int bsz, int nb_p,
               int threads) {
  const Layout L = make_layout(phase1, nfd, m_p, m_blk, bsz, nb_p,
                               row_groups(threads, m_p));
  return (size_t)L.total * sizeof(float);
}

cudaError_t launch(void (*kernel)(StageArgs), const StageArgs& a, int batch,
                   int threads, size_t smem, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}

bool bad_shape(int batch, int nfd, int m_p, int nb_p, int n_ball,
               int threads) {
  return threads < 32 || threads > 1024 || threads % 32 != 0 ||
         m_p % 4 != 0 || 3 * nb_p > m_p || n_ball < 0 || n_ball > nb_p ||
         nfd < 1 || batch < 1;
}

}  // namespace

// Dynamic shared memory, in bytes, that one block of the factored stage
// kernel (either source of G^T) takes at these shapes.
extern "C" int admm_stage_smem_bytes(int nfd, int m_p, int m_blk, int bsz,
                                     int nb_p, int threads) {
  return (int)smem_of(kFactored, nfd, m_p, m_blk, bsz, nb_p, threads);
}

// The same for the fused (dense-inverse) stage kernel and for the stage
// from a given m1.
extern "C" int admm_stage_fused_smem_bytes(int nfd, int m_p, int nb_p,
                                           int threads) {
  return (int)smem_of(kInverse, nfd, m_p, 0, 0, nb_p, threads);
}

extern "C" int admm_stage_iter_smem_bytes(int nfd, int m_p, int nb_p,
                                          int threads) {
  return (int)smem_of(kGiven, nfd, m_p, 0, 0, nb_p, threads);
}

// The design each entry point takes at these shapes on the current device:
// 1 the cluster design (no m1), 0 the stream design (m1 scratch).
extern "C" int admm_stage_factored_design(int nfd, int m_p, int m_blk,
                                          int bsz, int nb_p, int threads) {
  return cluster_fits(kEntryFactored, nfd, m_p, m_blk, bsz, nb_p, threads)
             ? 1
             : 0;
}

extern "C" int admm_stage_fused_design(int nfd, int m_p, int nb_p,
                                       int threads) {
  return cluster_fits(kEntryFused, nfd, m_p, 0, 0, nb_p, threads) ? 1 : 0;
}

extern "C" int admm_stage_fused_factored_ew_design(int nfd, int m_p,
                                                   int m_blk, int bsz,
                                                   int nb_p, int threads) {
  return nfd % kDims == 0 &&
                 cluster_fits(kEntryEw, nfd, m_p, m_blk, bsz, nb_p, threads)
             ? 1
             : 0;
}

extern "C" int admm_stage_given_design(int nfd, int m_p, int nb_p,
                                       int threads) {
  return cluster_fits(kEntryGiven, nfd, m_p, 0, 0, nb_p, threads) ? 1 : 0;
}

// Blocks a scenario's cluster takes in the cluster design of entry point
// `entry` (0 factored, 1 fused, 2 ew, 3 the stage from a given m1).
extern "C" int admm_stage_cluster_ranks(int entry) {
  return cluster_size_of(entry);
}

// Dynamic shared memory, in bytes, of one block of the cluster design of
// entry point `entry` (0 factored, 1 fused, 2 ew, 3 the stage from a given
// m1; m_blk and bsz are read where W^-1 is formed).
extern "C" int admm_stage_cluster_smem_bytes(int entry, int nfd, int m_p,
                                             int m_blk, int bsz, int nb_p) {
  return (int)cluster_smem_of(entry, nfd, m_p, m_blk, bsz, nb_p);
}

// Threads a block of entry point `entry`'s cluster design takes at these
// shapes on the current device, given at most `threads`.
extern "C" int admm_stage_cluster_threads(int entry, int nfd, int m_p,
                                          int m_blk, int bsz, int nb_p,
                                          int threads) {
  return cluster_threads_of(entry, nfd, m_p, m_blk, bsz, nb_p, threads);
}

// How many clusters of entry point `entry`'s cluster design the device
// holds at once (cudaOccupancyMaxActiveClusters) at the block size it takes
// given at most `threads`, or minus the CUDA error code.
extern "C" int admm_stage_cluster_occupancy(int entry, int nfd, int m_p,
                                            int m_blk, int bsz, int nb_p,
                                            int threads) {
  const size_t smem = cluster_smem_of(entry, nfd, m_p, m_blk, bsz, nb_p);
  void (*kernel)(StageArgs) = cluster_kernel_of(entry);
  cudaError_t e = allow_cluster_smem(entry, smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      1, cluster_threads_of(entry, nfd, m_p, m_blk, bsz, nb_p, threads),
      smem, nullptr, attr, cluster_size_of(entry));
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// Launches one stage for `batch` scenarios on `stream`, in the design
// admm_stage_factored_design names (m1 is read only by the stream design
// and may be null for the cluster one).  Returns the CUDA error code of the
// launch (0 on success); does not synchronise.
extern "C" int admm_stage_fused_factored_launch(
    const float* rho, const float* sinv, const float* t, const float* tt,
    const float* gt, const float* b, const float* rb, const float* xq,
    const float* x0, const float* z0, const float* u0, float* m1, float* x,
    float* z, float* zp, float* u, float* prim, float* dual, float* y,
    int batch, int nfd, int m_p, int m_blk, int bsz, int nb_p, int n_ball,
    int n_iters, float alpha, int init_z, int threads, void* stream) {
  if (bad_shape(batch, nfd, m_p, nb_p, n_ball, threads) ||
      m_blk * bsz != nfd)
    return (int)cudaErrorInvalidValue;
  StageArgs a = {};
  a.rho = rho; a.sinv = sinv; a.t = t; a.tt = tt; a.gt = gt; a.b = b;
  a.rb = rb; a.xq = xq; a.x0 = x0; a.z0 = z0; a.u0 = u0; a.m1 = m1;
  a.x = x; a.z = z; a.zp = zp; a.u = u; a.prim = prim; a.dual = dual;
  a.y = y;
  a.nfd = nfd; a.m_p = m_p; a.m_blk = m_blk; a.bsz = bsz; a.nb_p = nb_p;
  a.n_ball = n_ball; a.n_iters = n_iters; a.init_z = init_z;
  a.groups = row_groups(threads, m_p);
  a.alpha = alpha;
  if (cluster_fits(kEntryFactored, nfd, m_p, m_blk, bsz, nb_p, threads))
    return (int)launch_cluster(kEntryFactored, a, batch, threads, stream);
  if (m1 == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch(admm_stage_fused_factored_kernel, a, batch, threads,
                     smem_of(kFactored, nfd, m_p, m_blk, bsz, nb_p, threads),
                     stream);
}

// The factored stage with G^T given as its rank-1 row factors e
// (B, nfd / 3, m_p) and w (B, 3, m_p): gt[p*3 + d, l] = e[p, l] * w[d, l],
// in the design admm_stage_fused_factored_ew_design names (m1 as in the
// factored entry point).  The stream design takes the factored entry
// point's shared memory (admm_stage_smem_bytes).
extern "C" int admm_stage_fused_factored_ew_launch(
    const float* rho, const float* sinv, const float* t, const float* tt,
    const float* e, const float* w, const float* b, const float* rb,
    const float* xq, const float* x0, const float* z0, const float* u0,
    float* m1, float* x, float* z, float* zp, float* u, float* prim,
    float* dual, float* y, int batch, int nfd, int m_p, int m_blk, int bsz,
    int nb_p, int n_ball, int n_iters, float alpha, int init_z, int threads,
    void* stream) {
  if (bad_shape(batch, nfd, m_p, nb_p, n_ball, threads) ||
      m_blk * bsz != nfd || nfd % kDims != 0)
    return (int)cudaErrorInvalidValue;
  StageArgs a = {};
  a.rho = rho; a.sinv = sinv; a.t = t; a.tt = tt; a.e = e; a.w = w;
  a.b = b; a.rb = rb; a.xq = xq; a.x0 = x0; a.z0 = z0; a.u0 = u0; a.m1 = m1;
  a.x = x; a.z = z; a.zp = zp; a.u = u; a.prim = prim; a.dual = dual;
  a.y = y;
  a.nfd = nfd; a.m_p = m_p; a.m_blk = m_blk; a.bsz = bsz; a.nb_p = nb_p;
  a.n_ball = n_ball; a.n_iters = n_iters; a.init_z = init_z;
  a.groups = row_groups(threads, m_p);
  a.alpha = alpha;
  if (cluster_fits(kEntryEw, nfd, m_p, m_blk, bsz, nb_p, threads))
    return (int)launch_cluster(kEntryEw, a, batch, threads, stream);
  if (m1 == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch(admm_stage_fused_factored_ew_kernel, a, batch, threads,
                     smem_of(kFactored, nfd, m_p, m_blk, bsz, nb_p, threads),
                     stream);
}

// One stage from the dense KKT inverse winv (B, nfd, nfd), in the design
// admm_stage_fused_design names: the cluster design (winv's rows as given,
// no m1; m1 may be null), or the stream one (m1 = winv gt in the kernel,
// then the same phases 2-4).
extern "C" int admm_stage_fused_launch(
    const float* rho, const float* winv, const float* gt, const float* b,
    const float* rb, const float* xq, const float* x0, const float* z0,
    const float* u0, float* m1, float* x, float* z, float* zp, float* u,
    float* prim, float* dual, float* y, int batch, int nfd, int m_p,
    int nb_p, int n_ball, int n_iters, float alpha, int init_z, int threads,
    void* stream) {
  if (bad_shape(batch, nfd, m_p, nb_p, n_ball, threads))
    return (int)cudaErrorInvalidValue;
  StageArgs a = {};
  a.rho = rho; a.winv = winv; a.gt = gt; a.b = b; a.rb = rb; a.xq = xq;
  a.x0 = x0; a.z0 = z0; a.u0 = u0; a.m1 = m1;
  a.x = x; a.z = z; a.zp = zp; a.u = u; a.prim = prim; a.dual = dual;
  a.y = y;
  a.nfd = nfd; a.m_p = m_p; a.m_blk = 0; a.bsz = 0; a.nb_p = nb_p;
  a.n_ball = n_ball; a.n_iters = n_iters; a.init_z = init_z;
  a.groups = row_groups(threads, m_p);
  a.alpha = alpha;
  if (cluster_fits(kEntryFused, nfd, m_p, 0, 0, nb_p, threads))
    return (int)launch_cluster(kEntryFused, a, batch, threads, stream);
  if (m1 == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch(admm_stage_fused_kernel, a, batch, threads,
                     smem_of(kInverse, nfd, m_p, 0, 0, nb_p, threads),
                     stream);
}

// The iterations from the caller's m1 (B, nfd, m_p): x from xq, z and
// z_prev from z0, u from u0; outputs x, z, z_prev, u, prim; in the design
// admm_stage_given_design names (the cluster design of given_stage, or the
// stream one).
extern "C" int admm_stage_launch(
    const float* rho, const float* m1, const float* gt, const float* b,
    const float* rb, const float* xq, const float* z0, const float* u0,
    float* x, float* z, float* zp, float* u, float* prim, int batch,
    int nfd, int m_p, int nb_p, int n_ball, int n_iters, float alpha,
    int threads, void* stream) {
  if (bad_shape(batch, nfd, m_p, nb_p, n_ball, threads))
    return (int)cudaErrorInvalidValue;
  StageArgs a = {};
  a.rho = rho; a.gt = gt; a.b = b; a.rb = rb; a.xq = xq; a.z0 = z0;
  a.u0 = u0; a.m1 = const_cast<float*>(m1);
  a.x = x; a.z = z; a.zp = zp; a.u = u; a.prim = prim;
  a.nfd = nfd; a.m_p = m_p; a.nb_p = nb_p; a.n_ball = n_ball;
  a.n_iters = n_iters; a.init_z = 0;
  a.groups = row_groups(threads, m_p);
  a.alpha = alpha;
  if (cluster_fits(kEntryGiven, nfd, m_p, 0, 0, nb_p, threads))
    return (int)launch_cluster(kEntryGiven, a, batch, threads, stream);
  return (int)launch(admm_stage_iter_kernel, a, batch, threads,
                     smem_of(kGiven, nfd, m_p, 0, 0, nb_p, threads), stream);
}

#ifdef ADMM_STAGE_PROFILE
// The phase profile's sums (16 counters), and their reset.
extern "C" int admm_stage_profile_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, stage_prof, sizeof(stage_prof));
}

extern "C" int admm_stage_profile_clear() {
  const unsigned long long zero[16] = {0};
  return (int)cudaMemcpyToSymbol(stage_prof, zero, sizeof(zero));
}
#endif
