// One fused ADMM stage of the tube-constrained QCQP, per scenario, for
// Hopper (sm_90a).  Replaces the Pallas TPU kernel _kernel_fused_factored +
// _stage_core of the JAX package's ops/admm_kernel.py.
//
// Per scenario (one thread block each; the grid runs over the batch):
//   1. m1 = W^-1 G^T by block-Thomas sweeps over the block-LDL^T factors of
//      the KKT matrix W: forward y_i = gt_i - T_i y_{i-1}, diagonal
//      z_i = S_i^-1 y_i, backward x_i = z_i - T_{i+1}^T x_{i+1}, over m_blk
//      row blocks of (bsz, m_p).  Each lane (column of G^T) is an independent
//      solve, so a thread owns a lane and keeps the two live (bsz)-vectors in
//      shared-memory panels; the (bsz x bsz) factors are broadcast reads.
//   2. z/u initialisation from the warm start x0 (init_z) or carried in.
//   3. n_iters over-relaxed ADMM steps
//        v = z - u - b;  x = xq + rho (m1 v);  y = G x + b;
//        yr = alpha y + (1 - alpha) z;  z+ = Proj(yr + u);  u += yr - z+.
//   4. prim = max|y - z|, dual = max|G^T' (z - z_prev)|.
//
// Memory plan.  One scenario's G^T and m1 are nfd x m_p floats each (2 x
// 270 KB at the flagship shape 135 x 512): more than one block's shared
// memory.  m1 is therefore written once to a scratch tensor the caller
// allocates, and both matrices are re-read from L2 / device memory in every
// iteration; the vectors (b, z, u, v, y, x, xq) and the factors stay in
// shared memory.  The iteration phase is bound by those bytes, not by
// arithmetic.
//
// Determinism.  Every reduction has a fixed order (warp butterfly, then a
// serial sum over a fixed number of partials); there are no float atomics,
// so two runs on the same inputs give the same bits.
//
// Nothing here assumes m_p == 512: m_p % 4 == 0 (float4 rows) is the only
// lane requirement and every loop strides by the block size.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>

namespace {

struct StageArgs {
  // inputs
  const float* rho;   // (B)
  const float* sinv;  // (B, m_blk, bsz, bsz)
  const float* t;     // (B, m_blk-1, bsz, bsz)   T_i
  const float* tt;    // (B, m_blk-1, bsz, bsz)   T_i^T
  const float* gt;    // (B, nfd, m_p)
  const float* b;     // (B, m_p)
  const float* rb;    // (B, nb_p)
  const float* xq;    // (B, nfd)
  const float* x0;    // (B, nfd)
  const float* z0;    // (B, m_p) or null when init_z
  const float* u0;    // (B, m_p) or null when init_z
  // scratch
  float* m1;          // (B, nfd, m_p)
  // outputs
  float* x;           // (B, nfd)
  float* z;           // (B, m_p)
  float* zp;          // (B, m_p)
  float* u;           // (B, m_p)
  float* prim;        // (B)
  float* dual;        // (B)
  float* y;           // (B, m_p)
  int nfd, m_p, m_blk, bsz, nb_p, n_ball, n_iters, init_z, groups;
  float alpha;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Shared-memory layout in floats; every region starts 16-byte aligned.
struct Layout {
  int sinv, t, tt, panel0, panel1;          // phase 1
  int b, rb, z, zp, u, v, y, xq, x, tmp, part, red;
  int total;
};

__host__ __device__ inline Layout make_layout(int nfd, int m_p, int m_blk,
                                              int bsz, int nb_p, int groups) {
  Layout L;
  int o = 0;
  const int bb = bsz * bsz;
  L.sinv = o;   o += round4(m_blk * bb);
  L.t = o;      o += round4((m_blk - 1) * bb);
  L.tt = o;     o += round4((m_blk - 1) * bb);
  L.panel0 = o; o += bsz * m_p;
  L.panel1 = o; o += bsz * m_p;
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
// (nfd, m_p); v, base and dst are shared.  M may have been written by this
// block earlier in the kernel, so no read-only-cache loads.
__device__ void rows_dot(const float* M, const float* v, float* dst, int nfd,
                         int m_p, const float* base, float scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int nl4 = m_p >> 2;
  const float4* v4 = reinterpret_cast<const float4*>(v);
  for (int r = warp; r < nfd; r += nw) {
    const float4* row = reinterpret_cast<const float4*>(M + (size_t)r * m_p);
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
__device__ void cols_dot(const float* __restrict__ gt, const float* x,
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

__global__ void __launch_bounds__(1024)
admm_stage_kernel(StageArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int s = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nfd = a.nfd, m_p = a.m_p, m_blk = a.m_blk, bsz = a.bsz;
  const int nb_p = a.nb_p, n_ball = a.n_ball, groups = a.groups;
  const int bb = bsz * bsz;
  const Layout L = make_layout(nfd, m_p, m_blk, bsz, nb_p, groups);

  const float* gt = a.gt + (size_t)s * nfd * m_p;
  float* m1 = a.m1 + (size_t)s * nfd * m_p;

  float* sinv_s = smem + L.sinv;
  float* t_s = smem + L.t;
  float* tt_s = smem + L.tt;
  float* b_s = smem + L.b;
  float* rb_s = smem + L.rb;
  float* z_s = smem + L.z;
  float* zp_s = smem + L.zp;
  float* u_s = smem + L.u;
  float* v_s = smem + L.v;
  float* y_s = smem + L.y;
  float* xq_s = smem + L.xq;
  float* x_s = smem + L.x;
  float* tmp_s = smem + L.tmp;
  float* part_s = smem + L.part;
  float* red_s = smem + L.red;

  // ---- load the small per-scenario operands --------------------------------
  for (int i = tid; i < m_blk * bb; i += nt)
    sinv_s[i] = a.sinv[(size_t)s * m_blk * bb + i];
  for (int i = tid; i < (m_blk - 1) * bb; i += nt) {
    t_s[i] = a.t[(size_t)s * (m_blk - 1) * bb + i];
    tt_s[i] = a.tt[(size_t)s * (m_blk - 1) * bb + i];
  }
  for (int l = tid; l < m_p; l += nt) b_s[l] = a.b[(size_t)s * m_p + l];
  for (int j = tid; j < nb_p; j += nt) rb_s[j] = a.rb[(size_t)s * nb_p + j];
  for (int r = tid; r < nfd; r += nt) {
    xq_s[r] = a.xq[(size_t)s * nfd + r];
    x_s[r] = a.x0[(size_t)s * nfd + r];
  }
  const float rho = a.rho[s];
  __syncthreads();

  // ---- phase 1: m1 = W^-1 G^T, one independent column solve per lane -------
  for (int l = tid; l < m_p; l += nt) {
    float* prev = smem + L.panel0;
    float* cur = smem + L.panel1;
    // y_0 = gt_0;  z_0 = S_0^-1 y_0
    for (int r = 0; r < bsz; ++r) prev[r * m_p + l] = gt[(size_t)r * m_p + l];
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
        cur[r * m_p + l] = gt[(size_t)(i * bsz + r) * m_p + l] - acc;
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
  // m1 is read by other threads of this block from here on.
  __syncthreads();

  // ---- phase 2: y0 = G x0 + b; z/u from the warm start or carried in -------
  cols_dot(gt, x_s, part_s, nfd, m_p, groups);
  __syncthreads();
  for (int j = tid; j < nb_p; j += nt) {
    const int lx = j, ly = nb_p + j, lz = 2 * nb_p + j;
    const float yx = gather_y(part_s, b_s, lx, m_p, groups);
    const float yy = gather_y(part_s, b_s, ly, m_p, groups);
    const float yz = gather_y(part_s, b_s, lz, m_p, groups);
    y_s[lx] = yx; y_s[ly] = yy; y_s[lz] = yz;
    float zx, zy, zz, ux = 0.0f, uy = 0.0f, uz = 0.0f;
    if (a.init_z) {
      if (j < n_ball) {
        const float sc = ball_scale(yx, yy, yz, rb_s[j]);
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
    z_s[lx] = zx; z_s[ly] = zy; z_s[lz] = zz;
    zp_s[lx] = zx; zp_s[ly] = zy; zp_s[lz] = zz;
    u_s[lx] = ux; u_s[ly] = uy; u_s[lz] = uz;
    v_s[lx] = zx - ux - b_s[lx];
    v_s[ly] = zy - uy - b_s[ly];
    v_s[lz] = zz - uz - b_s[lz];
  }
  for (int l = 3 * nb_p + tid; l < m_p; l += nt) {
    const float yl = gather_y(part_s, b_s, l, m_p, groups);
    y_s[l] = yl;
    float zl, ul = 0.0f;
    if (a.init_z) {
      zl = fminf(yl, 0.0f);
    } else {
      zl = a.z0[(size_t)s * m_p + l];
      ul = a.u0[(size_t)s * m_p + l];
    }
    z_s[l] = zl; zp_s[l] = zl; u_s[l] = ul;
    v_s[l] = zl - ul - b_s[l];
  }
  __syncthreads();

  // ---- phase 3: the iteration chain ----------------------------------------
  const float alpha = a.alpha, one_m_alpha = 1.0f - a.alpha;
  for (int it = 0; it < a.n_iters; ++it) {
    rows_dot(m1, v_s, x_s, nfd, m_p, xq_s, rho);
    __syncthreads();
    cols_dot(gt, x_s, part_s, nfd, m_p, groups);
    __syncthreads();
    for (int j = tid; j < nb_p; j += nt) {
      const int lx = j, ly = nb_p + j, lz = 2 * nb_p + j;
      const float yx = gather_y(part_s, b_s, lx, m_p, groups);
      const float yy = gather_y(part_s, b_s, ly, m_p, groups);
      const float yz = gather_y(part_s, b_s, lz, m_p, groups);
      const float zx0 = z_s[lx], zy0 = z_s[ly], zz0 = z_s[lz];
      const float rx = alpha * yx + one_m_alpha * zx0;
      const float ry = alpha * yy + one_m_alpha * zy0;
      const float rz = alpha * yz + one_m_alpha * zz0;
      const float ux = u_s[lx], uy = u_s[ly], uz = u_s[lz];
      const float wx = rx + ux, wy = ry + uy, wz = rz + uz;
      float zx, zy, zz;
      if (j < n_ball) {
        const float sc = ball_scale(wx, wy, wz, rb_s[j]);
        zx = wx * sc; zy = wy * sc; zz = wz * sc;
      } else {
        zx = fminf(wx, 0.0f); zy = fminf(wy, 0.0f); zz = fminf(wz, 0.0f);
      }
      const float nux = wx - zx, nuy = wy - zy, nuz = wz - zz;
      y_s[lx] = yx; y_s[ly] = yy; y_s[lz] = yz;
      zp_s[lx] = zx0; zp_s[ly] = zy0; zp_s[lz] = zz0;
      z_s[lx] = zx; z_s[ly] = zy; z_s[lz] = zz;
      u_s[lx] = nux; u_s[ly] = nuy; u_s[lz] = nuz;
      v_s[lx] = zx - nux - b_s[lx];
      v_s[ly] = zy - nuy - b_s[ly];
      v_s[lz] = zz - nuz - b_s[lz];
    }
    for (int l = 3 * nb_p + tid; l < m_p; l += nt) {
      const float yl = gather_y(part_s, b_s, l, m_p, groups);
      const float z0 = z_s[l];
      const float w = (alpha * yl + one_m_alpha * z0) + u_s[l];
      const float zl = fminf(w, 0.0f);
      const float nu = w - zl;
      y_s[l] = yl; zp_s[l] = z0; z_s[l] = zl; u_s[l] = nu;
      v_s[l] = zl - nu - b_s[l];
    }
    __syncthreads();
  }

  // ---- phase 4: residuals and outputs --------------------------------------
  float pmax = 0.0f;
  for (int l = tid; l < m_p; l += nt) {
    pmax = fmaxf(pmax, fabsf(y_s[l] - z_s[l]));
    v_s[l] = z_s[l] - zp_s[l];
  }
  __syncthreads();
  rows_dot(gt, v_s, tmp_s, nfd, m_p, nullptr, 0.0f);
  __syncthreads();
  float dmax = 0.0f;
  for (int r = tid; r < nfd; r += nt) dmax = fmaxf(dmax, fabsf(tmp_s[r]));
  pmax = block_max(pmax, red_s);
  dmax = block_max(dmax, red_s);
  if (tid == 0) {
    a.prim[s] = a.n_iters > 0 ? pmax : CUDART_INF_F;
    a.dual[s] = dmax;
  }
  for (int r = tid; r < nfd; r += nt) a.x[(size_t)s * nfd + r] = x_s[r];
  for (int l = tid; l < m_p; l += nt) {
    a.z[(size_t)s * m_p + l] = z_s[l];
    a.zp[(size_t)s * m_p + l] = zp_s[l];
    a.u[(size_t)s * m_p + l] = u_s[l];
    a.y[(size_t)s * m_p + l] = y_s[l];
  }
}

int row_groups(int threads, int m_p) {
  int g = threads / (m_p / 4);
  if (g < 1) g = 1;
  if (g > 8) g = 8;
  return g;
}

}  // namespace

// Dynamic shared memory, in bytes, that one block of the stage kernel takes
// at these shapes.
extern "C" int admm_stage_smem_bytes(int nfd, int m_p, int m_blk, int bsz,
                                     int nb_p, int threads) {
  const Layout L =
      make_layout(nfd, m_p, m_blk, bsz, nb_p, row_groups(threads, m_p));
  return L.total * (int)sizeof(float);
}

// Launches one stage for `batch` scenarios on `stream`.  Returns the CUDA
// error code of the launch (0 on success); does not synchronise.
extern "C" int admm_stage_fused_factored_launch(
    const float* rho, const float* sinv, const float* t, const float* tt,
    const float* gt, const float* b, const float* rb, const float* xq,
    const float* x0, const float* z0, const float* u0, float* m1, float* x,
    float* z, float* zp, float* u, float* prim, float* dual, float* y,
    int batch, int nfd, int m_p, int m_blk, int bsz, int nb_p, int n_ball,
    int n_iters, float alpha, int init_z, int threads, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || m_p % 4 != 0 ||
      m_blk * bsz != nfd || 3 * nb_p > m_p || batch < 1)
    return (int)cudaErrorInvalidValue;
  StageArgs a;
  a.rho = rho; a.sinv = sinv; a.t = t; a.tt = tt; a.gt = gt; a.b = b;
  a.rb = rb; a.xq = xq; a.x0 = x0; a.z0 = z0; a.u0 = u0; a.m1 = m1;
  a.x = x; a.z = z; a.zp = zp; a.u = u; a.prim = prim; a.dual = dual;
  a.y = y;
  a.nfd = nfd; a.m_p = m_p; a.m_blk = m_blk; a.bsz = bsz; a.nb_p = nb_p;
  a.n_ball = n_ball; a.n_iters = n_iters; a.init_z = init_z;
  a.groups = row_groups(threads, m_p);
  a.alpha = alpha;
  const Layout L = make_layout(nfd, m_p, m_blk, bsz, nb_p, a.groups);
  const size_t smem = (size_t)L.total * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      admm_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  admm_stage_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
