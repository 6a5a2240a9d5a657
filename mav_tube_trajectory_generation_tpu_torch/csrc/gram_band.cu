// The block-tridiagonal band of the Gram G^T G of the tube-constrained QCQP,
// per scenario, for Hopper (sm_90a).  Three entry points:
//
//   gram_band_launch          replaces the Pallas TPU kernel
//       _kernel_gram_band of the JAX package's ops/admm_kernel.py
//       (gram_band; both of its per_block code paths compute the same band);
//   gram_band_factors_launch  replaces _kernel_gram_band_factors
//       (gram_band_factors): the KKT band db = pb_d + rho gd + sigma I,
//       ub = pb_u + rho gu, added as the band is stored;
//   gram_band_factors_ew_launch  replaces _kernel_gram_band_factors_ew
//       (gram_band_factors_ew): the same KKT band with G^T given as its
//       rank-1 row factors e (nfd/3, m_p) and w (3, m_p),
//       gt[p*3 + d, l] = e[p, l] * w[d, l].  A slab entry is that product
//       rounded once (__fmul_rn).  A 15-row block is 5 free derivatives x 3
//       dimensions.
//
// With A_r = gt[r*blk:(r+1)*blk, :] (blk rows of G^T, m_p lanes):
//   gd[r] = A_r A_r^T          (r = 0 .. m_blk-1)
//   gu[r] = A_r A_{r+1}^T      (r = 0 .. m_blk-2)
// Only these 2 m_blk - 1 blocks are formed (17 of the 81 at the flagship
// shape), never the full (nfd, nfd) Gram.
//
// What bounds it on an H100: G^T is read once (1.7 GB at batch 6144, nfd
// 135, m_p 512) and the work is 2 blk^2 m_p multiply-adds a block pair
// (24 GFLOP in all at that shape, 0.36 ms on the CUDA cores against 0.56 ms
// for the bytes), so it is bound by bytes.  Two designs, chosen by shape by
// the caller (ops/admm_kernel.py band_design), both in full float32 on the
// CUDA cores, sums in a fixed order (no atomics: the same bits every run):
//
// "ring" (gram_band_ring_kernel, blk 15: every assembly of the solver),
// the design of #5 and #6.  What it does about the four limits of the
// window body below:
//   * loads behind the arithmetic: each block keeps a ring of `slots` G^T
//     slabs (blk rows of m_p lanes) in shared memory, fed by the Tensor
//     Memory Accelerator: one thread of a producer warp, the block's last,
//     issues one 1-D bulk copy a row (cp.async.bulk, 2 KB at the flagship)
//     into a padded row, completing on the slot's mbarrier; no other thread
//     spends an instruction on a copy (the 15 issues of a slab take ~2.3k
//     cycles: on a computing warp they would hold it and, at the barriers,
//     the block).
//     Step r reads slabs r and r+1 while slab r+slots-1 lands.  A block
//     walks its scenarios (one, or with `per_block` 0 as many as the card
//     leaves it) as one sequence of slabs, so the next scenario's first
//     slabs load behind this one's last steps;
//   * register tiles, not a shared-memory read a multiply-add: the lanes
//     are split over lane groups (two a computing warp, quads of lanes g,
//     g + G, ... for group g of G), and in a group each of 15 threads owns a
//     TR x TC tile of gd and the same tile of gu.  For 4 lanes it reads
//     TR + 2 TC float4 (13 LDS.128 at 3 x 5) for 8 TR TC = 120
//     multiply-adds.  Rows are padded to ld = round_up(m_p, 32) + 8 floats
//     (ld / 4 = 2 mod 8 in 16-byte units), so a warp's tile reads fall in
//     distinct banks or are broadcasts;
//   * threads: 30 of a computing warp's 32 own tiles (two groups of 15);
//   * occupancy: at the flagship three slabs and four computing warps'
//     partials take 100,824 B, two blocks of 160 threads an SM.
// Each entry is summed over its group's lanes in lane order, then over the
// warp's two groups (shuffle), then over the warps in warp order (shared
// memory), and only then is the KKT band's pb, rho, sigma added as it is
// stored, coalesced.  gd is exactly symmetric: entries (i, j) and (j, i)
// take the same products in the same order.
//
// "window" (band<G>, gram_band_kernel and gram_band_ew_kernel): the design
// of #4, and of #5 and #6 at shapes the ring's tiles do not fit (blk other
// than 15).  One block a scenario; a window of two blk x m_p slabs, slab r+1
// loaded element by element before step r computes; a thread owns entry
// (i, j) of both blocks of a step and reduces over the lanes, four
// interleaved partial sums combined as (p0 + p1) + (p2 + p3).  Every
// multiply-add reads its operands from shared memory, which bounds it
// there; nothing of a block's own copy overlaps its arithmetic.
//
// -DGRAM_BAND_PROFILE: thread 0 of block 0 adds the clock64 cycles of each
// phase of the ring, and its producer the cycles of its copies' issue
// (stage_profile.py --kernel gram_band).
// -DGRAM_BAND_CONTROL_SKIP_COMBINE: the ring leaves the last warp's partial
// out of every entry (a negative control of chip_smoke.py).

#include <cuda_runtime.h>
#include <stddef.h>

#include <atomic>

namespace {

struct GramArgs {
  const float* gt;    // (B, nfd, m_p), or null (ew)
  const float* e;     // (B, nfd/3, m_p)        ew: G^T's row factors
  const float* w;     // (B, 3, m_p)            ew
  const float* pb_d;  // (B, m_blk, blk, blk) or null (gram_band)
  const float* pb_u;  // (B, m_blk-1, blk, blk) or null
  const float* rho;   // (B) or null
  float* d;           // (B, m_blk, blk, blk): gd, or db
  float* u;           // (B, m_blk-1, blk, blk): gu, or ub
  int batch, nfd, m_p, blk;
  float sigma;
};

// Dimensions of the problem: rows of w, and G^T rows per free derivative.
constexpr int kDims = 3;

// ---- the window design -----------------------------------------------------

// G^T of one scenario as stored, (nfd, m_p) row-major.
struct GtStored {
  const float* gt;
  __device__ __forceinline__ float at(int r, int l, int m_p) const {
    return gt[(size_t)r * m_p + l];
  }
};

// G^T of one scenario from its row factors e (nfd/3, m_p) and w (3, m_p).
struct GtFactors {
  const float* e;
  const float* w;
  __device__ __forceinline__ float at(int r, int l, int m_p) const {
    return __fmul_rn(e[(size_t)(r / kDims) * m_p + l], w[(r % kDims) * m_p + l]);
  }
};

template <class G>
__device__ __forceinline__ void load_slab(const G& gt, float* slab, int row0,
                                          int blk, int m_p, int ld) {
  for (int idx = threadIdx.x; idx < blk * m_p; idx += blockDim.x) {
    const int i = idx / m_p, l = idx - i * m_p;
    slab[i * ld + l] = gt.at(row0 + i, l, m_p);
  }
}

// The band of scenario blockIdx.x, G^T from `gt`.
template <class G>
__device__ __forceinline__ void band(const GramArgs& a, const G& gt) {
  extern __shared__ __align__(16) float smem[];
  const int s = blockIdx.x;
  const int blk = a.blk, m_p = a.m_p, ld = m_p + 1;
  const int m_blk = a.nfd / blk, bb = blk * blk;
  const bool factors = a.pb_d != nullptr;
  const float rho = factors ? a.rho[s] : 1.0f;
  float* slab[2] = {smem, smem + blk * ld};

  load_slab(gt, slab[0], 0, blk, m_p, ld);
  for (int r = 0; r < m_blk; ++r) {
    const float* cur = slab[r & 1];
    float* nxt = slab[(r + 1) & 1];
    const bool upper = r + 1 < m_blk;
    if (upper) load_slab(gt, nxt, (r + 1) * blk, blk, m_p, ld);
    __syncthreads();
    for (int e = threadIdx.x; e < bb; e += blockDim.x) {
      const int i = e / blk, j = e - i * blk;
      const float* ai = cur + i * ld;
      const float* aj = cur + j * ld;
      const float* bj = nxt + j * ld;
      float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;
      float u0 = 0.0f, u1 = 0.0f, u2 = 0.0f, u3 = 0.0f;
      if (upper) {
        for (int l = 0; l < m_p; l += 4) {
          const float x0 = ai[l], x1 = ai[l + 1], x2 = ai[l + 2],
                      x3 = ai[l + 3];
          d0 = fmaf(x0, aj[l], d0);
          d1 = fmaf(x1, aj[l + 1], d1);
          d2 = fmaf(x2, aj[l + 2], d2);
          d3 = fmaf(x3, aj[l + 3], d3);
          u0 = fmaf(x0, bj[l], u0);
          u1 = fmaf(x1, bj[l + 1], u1);
          u2 = fmaf(x2, bj[l + 2], u2);
          u3 = fmaf(x3, bj[l + 3], u3);
        }
      } else {
        for (int l = 0; l < m_p; l += 4) {
          d0 = fmaf(ai[l], aj[l], d0);
          d1 = fmaf(ai[l + 1], aj[l + 1], d1);
          d2 = fmaf(ai[l + 2], aj[l + 2], d2);
          d3 = fmaf(ai[l + 3], aj[l + 3], d3);
        }
      }
      const float gd = (d0 + d1) + (d2 + d3);
      const size_t od = ((size_t)s * m_blk + r) * bb + e;
      if (factors) {
        float v = a.pb_d[od] + rho * gd;
        if (i == j) v += a.sigma;
        a.d[od] = v;
      } else {
        a.d[od] = gd;
      }
      if (upper) {
        const float gu = (u0 + u1) + (u2 + u3);
        const size_t ou = ((size_t)s * (m_blk - 1) + r) * bb + e;
        a.u[ou] = factors ? a.pb_u[ou] + rho * gu : gu;
      }
    }
    // the next step loads into the slab read here
    __syncthreads();
  }
}

__global__ void __launch_bounds__(1024) gram_band_kernel(GramArgs a) {
  band(a, GtStored{a.gt + (size_t)blockIdx.x * a.nfd * a.m_p});
}

__global__ void __launch_bounds__(1024) gram_band_ew_kernel(GramArgs a) {
  const size_t s = blockIdx.x;
  band(a, GtFactors{a.e + s * (a.nfd / kDims) * a.m_p,
                    a.w + s * kDims * a.m_p});
}

size_t window_smem_of(int m_p, int blk) {
  return (size_t)2 * blk * (m_p + 1) * sizeof(float);
}

// ---- the ring design -------------------------------------------------------

// The ring's band block, and the limits of its launch parameters.
constexpr int kRingBlk = 15;
constexpr int kRingBB = kRingBlk * kRingBlk;
constexpr int kRingMinThreads = 96;
constexpr int kRingMaxThreads = 288;
constexpr int kRingMaxSlots = 4;
// Entries (of gd and gu) a thread stores at the fewest threads.
constexpr int kRingEpi = (2 * kRingBB + kRingMinThreads - 1) / kRingMinThreads;

// Floats between two rows of a slab: a multiple of 8 (16-byte rows) that is
// 2 mod 8 in 16-byte units.
__host__ __device__ __forceinline__ int ring_ld(int m_p) {
  return (m_p + 31) / 32 * 32 + 8;
}

// Shared memory of a ring block: the slabs, the computing warps' partials
// of gd and gu (every warp but the producer), one mbarrier a slot.
size_t ring_smem_of(int m_p, int threads, int slots) {
  return ((size_t)slots * kRingBlk * ring_ld(m_p) +
          (size_t)(threads / 32 - 1) * 2 * kRingBB) * sizeof(float) +
         (size_t)slots * sizeof(unsigned long long);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// One 1-D bulk copy of `bytes` (a multiple of 16) from global src to shared
// dst (both 16-byte aligned), completing on bar.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Waits until phase `parity` of bar has completed.  Bounded: after about
// 2^31 polls the kernel traps (an error the launcher's caller sees), so a
// copy that never lands cannot hang the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_u32(bar);
  for (unsigned n = 0;; ++n) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (n > (1u << 31)) asm volatile("trap;");
  }
}

#ifdef GRAM_BAND_PROFILE
// thread 0's start, slab_wait, products, combine, epilogue; scenarios; its
// cycles from entry to exit; the producer's cycles issuing copies
constexpr int kProfPhases = 5;
__device__ unsigned long long g_band_prof[8];
#define BAND_PROF(i)                        \
  do {                                      \
    if (prof) {                             \
      const long long t_ = clock64();       \
      prof_acc[i] += t_ - prof_t;           \
      prof_t = t_;                          \
    }                                       \
  } while (0)
#else
#define BAND_PROF(i) do {} while (0)
#endif

// The products of one step for one thread: its TR x TC tile of gd (rows of
// `rows`, columns of `cols`) and, with U, of gu (columns of `ncols`), over
// the lane quads q0, q0 + dq, ... < nq, each entry summed in lane order.
template <int TR, int TC, bool U>
__device__ __forceinline__ void tile_products(
    const float4* __restrict__ rows, const float4* __restrict__ cols,
    const float4* __restrict__ ncols, int ld4, int q0, int dq, int nq,
    float (&d)[TR][TC], float (&u)[TR][TC]) {
  for (int q = q0; q < nq; q += dq) {
    float4 x[TR], y[TC], z[TC];
#pragma unroll
    for (int i = 0; i < TR; ++i) x[i] = rows[i * ld4 + q];
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      y[j] = cols[j * ld4 + q];
      if (U) z[j] = ncols[j * ld4 + q];
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        d[i][j] = fmaf(x[i].x, y[j].x, d[i][j]);
        d[i][j] = fmaf(x[i].y, y[j].y, d[i][j]);
        d[i][j] = fmaf(x[i].z, y[j].z, d[i][j]);
        d[i][j] = fmaf(x[i].w, y[j].w, d[i][j]);
        if (U) {
          u[i][j] = fmaf(x[i].x, z[j].x, u[i][j]);
          u[i][j] = fmaf(x[i].y, z[j].y, u[i][j]);
          u[i][j] = fmaf(x[i].z, z[j].z, u[i][j]);
          u[i][j] = fmaf(x[i].w, z[j].w, u[i][j]);
        }
      }
    }
  }
}

// The warp's lane groups' sums of one tile entry, in group order, in lane
// tau < T of the warp (every lane must call it).
template <int T, int SG>
__device__ __forceinline__ float warp_groups_sum(float v, int lane) {
  float s = v;
#pragma unroll
  for (int k = 1; k < SG; ++k) {
    const float o = __shfl_down_sync(0xffffffffu, v, k * T);
    if (lane < T) s += o;
  }
  return s;
}

// The band of the scenarios blockIdx.x, blockIdx.x + gridDim.x, ... < batch
// from the ring of `slots` slabs; tiles of TR x TC entries; the last warp
// the producer.
template <int TR, int TC>
__global__ void __launch_bounds__(kRingMaxThreads)
    gram_band_ring_kernel(GramArgs a, int slots) {
  constexpr int NCG = kRingBlk / TC, T = (kRingBlk / TR) * NCG, SG = 32 / T;
  static_assert(kRingBlk % TR == 0 && kRingBlk % TC == 0 && SG >= 1,
                "tiles must cover the band block within a warp");
  extern __shared__ __align__(16) float smem[];
  const int m_p = a.m_p, m_blk = a.nfd / kRingBlk, ld = ring_ld(m_p);
  const int ld4 = ld / 4, nq = m_p / 4, slab = kRingBlk * ld;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = (blockDim.x >> 5) - 1;   // computing warps
  const bool producer = tid == warps * 32;
  float* part = smem + (size_t)slots * slab;
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(part + warps * 2 * kRingBB);
  const bool factors = a.pb_d != nullptr;
  const int nsc = (a.batch - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int nslab = nsc * m_blk;
  const unsigned slab_bytes = (unsigned)(kRingBlk * m_p * sizeof(float));

  // this thread's tile and lane group
  const int grp = lane / T, tau = lane - grp * T;
  const bool active = grp < SG && warp < warps;
  const int r0 = (tau / NCG) * TR, c0 = (tau % NCG) * TC;
  const int g = warp * SG + grp, ngroups = warps * SG;

#ifdef GRAM_BAND_PROFILE
  const bool prof = blockIdx.x == 0 && tid == 0;
  long long prof_t = clock64(), prof_acc[kProfPhases] = {}, prof_issue = 0;
  const long long prof_t0 = prof_t;
#endif

  // Slab n of the block's sequence: step n % m_blk of its (n / m_blk)-th
  // scenario, into slot n % slots.
  auto issue = [&](int n) {
    const int sc = blockIdx.x + (n / m_blk) * gridDim.x, r = n % m_blk;
    const float* src = a.gt + ((size_t)sc * a.nfd + r * kRingBlk) * m_p;
    float* dst = smem + (size_t)(n % slots) * slab;
    unsigned long long* bar = full + n % slots;
    mbar_expect_tx(bar, slab_bytes);
    for (int i = 0; i < kRingBlk; ++i)
      bulk_copy(dst + i * ld, src + (size_t)i * m_p, slab_bytes / kRingBlk,
                bar);
  };
  if (producer) {
    for (int k = 0; k < slots; ++k) mbar_init(full + k);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (producer)
    for (int n = 0; n < slots - 1 && n < nslab; ++n) issue(n);
  BAND_PROF(0);

  for (int n = 0; n < nslab; ++n) {
    const int sc = blockIdx.x + (n / m_blk) * gridDim.x, r = n % m_blk;
    const bool upper = r + 1 < m_blk;
    // the slot of slab n - 1 is free: every thread left step n - 1
    if (producer && n + slots - 1 < nslab) {
#ifdef GRAM_BAND_PROFILE
      const long long t_ = clock64();
      issue(n + slots - 1);
      if (blockIdx.x == 0) prof_issue += clock64() - t_;
#else
      issue(n + slots - 1);
#endif
    }

    // this thread's entries of the KKT band's objective part, loaded while
    // the products run
    const int n_out = upper ? 2 * kRingBB : kRingBB;
    const size_t od0 = ((size_t)sc * m_blk + r) * kRingBB;
    const size_t ou0 = ((size_t)sc * (m_blk - 1) + r) * kRingBB;
    float pre[kRingEpi];
    float rho = 1.0f;
    if (factors) {
      rho = a.rho[sc];
#pragma unroll
      for (int k = 0; k < kRingEpi; ++k) {
        const int e = tid + k * blockDim.x;
        pre[k] = e >= n_out ? 0.0f
                 : e < kRingBB ? a.pb_d[od0 + e] : a.pb_u[ou0 + e - kRingBB];
      }
    }

    mbar_wait(full + n % slots, (unsigned)(n / slots) & 1u);
    if (upper) mbar_wait(full + (n + 1) % slots, (unsigned)((n + 1) / slots) & 1u);
    BAND_PROF(1);

    const float4* cur =
        reinterpret_cast<const float4*>(smem + (size_t)(n % slots) * slab);
    const float4* nxt = reinterpret_cast<const float4*>(
        smem + (size_t)((n + 1) % slots) * slab);
    float dacc[TR][TC] = {}, uacc[TR][TC] = {};
    if (active) {
      if (upper)
        tile_products<TR, TC, true>(cur + r0 * ld4, cur + c0 * ld4,
                                    nxt + c0 * ld4, ld4, g, ngroups, nq, dacc,
                                    uacc);
      else
        tile_products<TR, TC, false>(cur + r0 * ld4, cur + c0 * ld4, nullptr,
                                     ld4, g, ngroups, nq, dacc, uacc);
    }
    BAND_PROF(2);

    // the warp's partials: its lane groups summed in group order
    float* pw = part + warp * 2 * kRingBB;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int e = (r0 + i) * kRingBlk + c0 + j;
        const float dv = warp_groups_sum<T, SG>(dacc[i][j], lane);
        if (lane < T && active) pw[e] = dv;
        if (upper) {
          const float uv = warp_groups_sum<T, SG>(uacc[i][j], lane);
          if (lane < T && active) pw[kRingBB + e] = uv;
        }
      }
    }
    __syncthreads();
    BAND_PROF(3);

    // the warps' partials in warp order, then the KKT band's terms, stored
#ifdef GRAM_BAND_CONTROL_SKIP_COMBINE
    const int summed = warps - 1;
#else
    const int summed = warps;
#endif
#pragma unroll
    for (int k = 0; k < kRingEpi; ++k) {
      const int e = tid + k * blockDim.x;
      if (e < n_out) {
        float v = part[e];
        for (int w = 1; w < summed; ++w) v += part[w * 2 * kRingBB + e];
        if (e < kRingBB) {
          if (factors) {
            float x = pre[k] + rho * v;
            if (e / kRingBlk == e % kRingBlk) x += a.sigma;
            v = x;
          }
          a.d[od0 + e] = v;
        } else {
          a.u[ou0 + e - kRingBB] = factors ? pre[k] + rho * v : v;
        }
      }
    }
    // the partials are written again in the next step
    __syncthreads();
    BAND_PROF(4);
  }
#ifdef GRAM_BAND_PROFILE
  if (prof) {
    for (int i = 0; i < kProfPhases; ++i) g_band_prof[i] += prof_acc[i];
    g_band_prof[5] += nsc;
    g_band_prof[6] += clock64() - prof_t0;
  }
  if (producer && blockIdx.x == 0) g_band_prof[7] += prof_issue;
#endif
}

// The tile shapes the ring is built with, by the launcher's `tile` code.
constexpr int kTiles = 2;
void (*const ring_kernels[kTiles])(GramArgs, int) = {
    gram_band_ring_kernel<5, 3>, gram_band_ring_kernel<3, 5>};

constexpr int kMaxDevices = 64;
// The dynamic shared memory each ring kernel has been allowed on each
// device, so that a launch sets the attribute only when it needs more.
std::atomic<int> ring_smem_allowed[kTiles][kMaxDevices];

cudaError_t allow_smem(int tile, size_t smem, int* dev_out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  *dev_out = dev;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && ring_smem_allowed[tile][dev].load(
                    std::memory_order_acquire) >= (int)smem)
    return cudaSuccess;
  e = cudaFuncSetAttribute(ring_kernels[tile],
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess && cached) {
    int seen = ring_smem_allowed[tile][dev].load();
    while (seen < (int)smem &&
           !ring_smem_allowed[tile][dev].compare_exchange_weak(seen,
                                                               (int)smem)) {
    }
  }
  return e;
}

bool bad_ring(int m_p, int threads, int slots, int per_block, int tile) {
  return threads < kRingMinThreads || threads > kRingMaxThreads ||
         threads % 32 != 0 || slots < 2 || slots > kRingMaxSlots ||
         per_block < 0 || tile < 0 || tile >= kTiles ||
         ring_smem_of(m_p, threads, slots) > (size_t)232448;
}

// Blocks of the ring kernel an SM holds at once on the current device
// (<= 0: a CUDA error, negated).
int ring_blocks_per_sm(int m_p, int threads, int slots, int tile) {
  const size_t smem = ring_smem_of(m_p, threads, slots);
  int dev = 0, n = 0;
  cudaError_t e = allow_smem(tile, smem, &dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ring_kernels[tile],
                                                      threads, smem);
  return e == cudaSuccess ? n : -(int)e;
}

// Blocks the ring launch takes: one a `per_block` scenarios, or with 0 one
// for each block the card holds at once (each then walks the scenarios
// gridDim.x apart); <= 0: a CUDA error, negated.
int ring_grid(int batch, int m_p, int threads, int slots, int per_block,
              int tile) {
  if (per_block > 0) return (batch + per_block - 1) / per_block;
  const int per_sm = ring_blocks_per_sm(m_p, threads, slots, tile);
  if (per_sm <= 0) return per_sm == 0 ? -(int)cudaErrorInvalidConfiguration
                                      : per_sm;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  const int all = per_sm * sms;
  return batch < all ? batch : all;
}

// The designs as the launchers number them.
constexpr int kWindow = 0, kRing = 1;

bool bad_shape(int batch, int nfd, int m_p, int blk, int threads) {
  return threads < 32 || threads > 1024 || threads % 32 != 0 || batch < 1 ||
         blk < 1 || nfd < blk || nfd % blk != 0 || m_p < 4 || m_p % 4 != 0;
}

cudaError_t launch_window(void (*kernel)(GramArgs), const GramArgs& a,
                          int threads, void* stream) {
  const size_t smem = window_smem_of(a.m_p, a.blk);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<a.batch, threads, smem, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch(const GramArgs& a, int design, int threads, int slots,
                   int per_block, int tile, void* stream) {
  if (bad_shape(a.batch, a.nfd, a.m_p, a.blk, threads))
    return cudaErrorInvalidValue;
  if (design == kWindow) return launch_window(gram_band_kernel, a, threads,
                                              stream);
  if (design != kRing || a.blk != kRingBlk ||
      bad_ring(a.m_p, threads, slots, per_block, tile))
    return cudaErrorInvalidValue;
  const int grid = ring_grid(a.batch, a.m_p, threads, slots, per_block, tile);
  if (grid <= 0) return (cudaError_t)(-grid);
  ring_kernels[tile]<<<grid, threads, ring_smem_of(a.m_p, threads, slots),
                       (cudaStream_t)stream>>>(a, slots);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory, in bytes, that one block of `design` (0 window,
// 1 ring) takes at these shapes (`threads` and `slots` read by the ring).
extern "C" int gram_band_smem_bytes(int design, int m_p, int blk,
                                    int threads, int slots) {
  return (int)(design == kRing ? ring_smem_of(m_p, threads, slots)
                               : window_smem_of(m_p, blk));
}

// Blocks of the ring an SM holds at once on the current device, and the
// blocks a launch of `batch` scenarios takes (<= 0: a CUDA error, negated).
extern "C" int gram_band_ring_blocks_per_sm(int m_p, int threads, int slots,
                                            int tile) {
  if (bad_ring(m_p, threads, slots, 0, tile))
    return -(int)cudaErrorInvalidValue;
  return ring_blocks_per_sm(m_p, threads, slots, tile);
}

extern "C" int gram_band_ring_grid(int batch, int m_p, int threads,
                                   int slots, int per_block, int tile) {
  if (batch < 1 || bad_ring(m_p, threads, slots, per_block, tile))
    return -(int)cudaErrorInvalidValue;
  return ring_grid(batch, m_p, threads, slots, per_block, tile);
}

// gd (B, m_blk, blk, blk), gu (B, m_blk-1, blk, blk) from gt (B, nfd, m_p),
// in `design` (0 window, 1 ring; the ring takes blk 15, `slots` slabs, tile
// code `tile` and `per_block` scenarios a block, 0 for as many blocks as
// the card holds).  Returns the CUDA error code of the launch (0 on
// success); does not synchronise.
extern "C" int gram_band_launch(const float* gt, float* gd, float* gu,
                                int batch, int nfd, int m_p, int blk,
                                int design, int threads, int slots,
                                int per_block, int tile, void* stream) {
  GramArgs a = {};
  a.gt = gt; a.d = gd; a.u = gu;
  a.batch = batch; a.nfd = nfd; a.m_p = m_p; a.blk = blk; a.sigma = 0.0f;
  return (int)launch(a, design, threads, slots, per_block, tile, stream);
}

// db = pb_d + rho gd + sigma I, ub = pb_u + rho gu; rho is (B).
extern "C" int gram_band_factors_launch(
    const float* gt, const float* pb_d, const float* pb_u, const float* rho,
    float* db, float* ub, int batch, int nfd, int m_p, int blk, float sigma,
    int design, int threads, int slots, int per_block, int tile,
    void* stream) {
  GramArgs a = {};
  a.gt = gt; a.pb_d = pb_d; a.pb_u = pb_u; a.rho = rho; a.d = db; a.u = ub;
  a.batch = batch; a.nfd = nfd; a.m_p = m_p; a.blk = blk; a.sigma = sigma;
  return (int)launch(a, design, threads, slots, per_block, tile, stream);
}

// The same band with G^T given as its row factors e (B, nfd/3, m_p) and
// w (B, 3, m_p), in the window design.
extern "C" int gram_band_factors_ew_launch(
    const float* e, const float* w, const float* pb_d, const float* pb_u,
    const float* rho, float* db, float* ub, int batch, int nfd, int m_p,
    int blk, float sigma, int threads, void* stream) {
  if (bad_shape(batch, nfd, m_p, blk, threads) || nfd % kDims != 0)
    return (int)cudaErrorInvalidValue;
  GramArgs a = {};
  a.e = e; a.w = w; a.pb_d = pb_d; a.pb_u = pb_u; a.rho = rho; a.d = db;
  a.u = ub;
  a.batch = batch; a.nfd = nfd; a.m_p = m_p; a.blk = blk; a.sigma = sigma;
  return (int)launch_window(gram_band_ew_kernel, a, threads, stream);
}

#ifdef GRAM_BAND_PROFILE
// The ring's counters of block 0: thread 0's cycles of start, slab_wait,
// products, combine, epilogue; scenarios; thread 0's cycles from entry to
// exit; the producer's cycles issuing the copies of its steps.
extern "C" int gram_band_profile_clear() {
  unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(g_band_prof, zero, sizeof(zero));
}

extern "C" int gram_band_profile_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_band_prof,
                                   8 * sizeof(unsigned long long));
}
#endif
