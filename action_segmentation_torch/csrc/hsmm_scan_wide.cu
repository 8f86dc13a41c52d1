// The banded semi-Markov forward scan for a DP wider than the narrow
// template's 128 classes: two routes, each one template with three
// instances.
//
// Replaces, for a wide DP, the functions of
// action_segmentation_tpu/ops/hsmm_pallas.py `_viterbi_kernel` (K6: the
// max scan with backpointer codes), `_gamma_kernel` in the log semiring
// (K2-log: the gamma and alphas planes of the training forward) and
// `_forward_kernel` (K1: the alphas of the partition's primal). The JAX
// package runs a DP above its 128 lanes through the jnp scans of
// ops/hsmm.py (`_forward_scan_single`), which compute the same functions.
//
// Per chain n, with W the (Km, C) carry of the last Km boundary scores
// minus the emission prefix sum (logical row 0 starts as `init`):
//   cum        += emit[t]
//   alpha[c]    = reduce_j (W[j, c] + dur[j, c]) + cum[c]
//   gamma[t, c] = reduce_c' trans[c, c'] + alpha[c']
//   push gamma - cum as W's new row 0 (the oldest row drops out)
// where reduce is the max, with (kViterbi) its FIRST argmax j and c' in
// index order packed as bp = bp_d * radix + bp_c, or in the log semiring
// m + log(sum(exp(x - m))) with m the max and the sum taken in index
// order. Every float operation is the plain version's
// (ops/hsmm_cuda.py `_viterbi_scan_plain`, `_gamma_scan_plain`) in its
// order, with expf/logf and no fast math, so the outputs are its bits.
// A max is exact, so the combine takes it in four interleaved chains of
// c' (k mod 4) and merges them, the equal maxima by the least index: the
// same max and the same first argmax as one chain in index order. The
// log semiring's sum stays one chain in index order.
//
// What bounds it: the T dependent steps. A step is, on each thread, one
// reduction of C transition terms (two passes in the log semiring: the
// max, then the ordered sum of expf), so a step costs C terms of one
// thread's instructions, whatever the chain count; the step's bytes and
// operations at the card's peaks are far below that
// (tools/scan_floor.py reads a step's instructions and chain from the
// SASS; at the S6 shape the cluster route runs at about twice that
// floor, PERF.md).
//
// The cluster route (`wide_cluster_scan_kernel`, where a chain's table
// fits the shared memory of at most 8 blocks): the chain's cluster of
// `cluster` blocks holds its transition table in shared memory for the
// whole scan, so that no step reads it from L2. Block r owns the classes
// [r * slab, r * slab + slab); thread j owns class c = r * slab + j, and
// holds its row trans[c, :] (read once, before the time loop, from the
// transposed table's column c: coalesced across the warp) at a stride of
// 4 words past a multiple of 32, so that the combine reads it 16 bytes a
// load with no bank conflict, beside 16-byte loads of the alpha row (a
// broadcast). Its column of the carry's ring (Km rows of the block's
// width) is in shared memory too; only thread j touches its row and its
// ring column, so neither needs a barrier. Its duration scores are read
// from global memory (a column of Km floats, L1-resident). Each step
// the thread pushes its alpha into the step's buffer of the
// double-buffered alpha row of every block of the cluster, by `st.async`
// through distributed shared memory (`mapa`), each store completing 4
// bytes on that block's mbarrier for the buffer; one thread a block
// expects 4 C bytes a phase, and every thread waits on its own block's
// mbarrier (no cluster barrier a step: a release at cluster scope would
// fence the step's global stores). Each thread then reduces c' = 0 ..
// C-1 from local shared memory. The double buffer needs nothing more: a
// block pushes into buffer t&1 at step t only after its wait at step
// t-1, which needs every block's step-(t-1) pushes, each made after that
// block's reads of buffer t&1 at step t-2. The threads past C in the
// last slab compute nothing but wait every step. A first cluster barrier
// lets no block push into another before its mbarriers are made, a last
// one keeps each block's shared memory alive until the others are done.
// The template is compiled for a cluster of one block (kMulti false: the
// alpha row stored locally, a block barrier a step) and of more.
//
// The L2 route (`wide_scan_kernel`, past the cluster route: a table a
// portable cluster of 8 does not hold, or a ring that does not fit
// beside it): one block a chain of min(C, 1,024) threads in whole warps;
// thread j owns the classes c = j + k * blockDim.x, ceil(C / blockDim.x)
// of them (two at 1,577 classes), and runs each one's duration reduce and
// transition combine in turn. Each class's emission prefix sum (cum) and
// duration argmax (carried across the step's barrier) sit in shared
// memory beside the double-buffered alpha row, and its column of the
// ring too where it fits, else in a global scratch the wrapper allocates
// (the same code through a generic pointer); only the class's thread
// touches them. One barrier a step. The combine reads trans transposed
// from global memory, so that a warp's loads of one c' are one coalesced
// line; the table stays in L2 across the steps, and a step waits on each
// thread's C dependent-latency L2 loads a class, about eight in flight.
// Past 14,528 classes the alpha rows and the per-class state do not fit
// a block's shared memory, and the entry refuses the launch.
//
// A chain's table: `group` chains share one, chain n reading table
// n / group of trans_t (1: a table a chain; N: every chain one table, as
// a model's expanded transition view gives it, so that one copy of a
// wide table stays in L2 for the whole batch: at 18 chains of 1,577
// classes on an H100 the max scan ran 1.75x faster so than with a table a
// chain, which streams 179 MB a step from HBM; PERF.md section 6).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <limits>

namespace {

constexpr float kBigNeg = -1e9f;
constexpr float kNegInf = -std::numeric_limits<float>::infinity();
constexpr int kMaxThreads = 1024;  // the L2 route's block
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic shared memory
// the cluster route's slab: at most 256 classes a block (a cluster of one
// holds at most 228 classes' table; a wider DP splits it over blocks)
constexpr int kMaxSlabThreads = 256;

// kViterbi: alphas and codes (K6's function); kLog: gamma and alphas
// (K2-log's); kForward: alphas only (K1's)
enum class Scan { kViterbi, kLog, kForward };

// the alpha row's stride: C rounded up to 4 floats, so that every buffer
// and every 4-float group of it is 16-byte aligned
__host__ __device__ inline int alpha_stride(int C) { return (C + 3) & ~3; }

// a thread's row of the table in the cluster route: alpha_stride(C)
// rounded up to 4 words past a multiple of 32, so that the 16-byte loads
// of 8 lanes (one shared-memory wavefront) at one k fall in distinct banks
__host__ __device__ inline int table_stride(int C) {
  const int Cp = alpha_stride(C);
  return Cp + (36 - Cp % 32) % 32;
}

// The duration reduce of class c, j in logical order: the ring's logical
// row j at physical (head + j) mod Km, `ring` and `du` at column c with
// row strides `rs` and `ds`. Returns the semiring's reduce; `bd` gets the
// first argmax (kViterbi).
template <Scan kS, typename Ring>
__device__ __forceinline__ float duration_reduce(Ring ring, int rs,
                                                 const float* __restrict__ du,
                                                 int ds, int Km, int head,
                                                 int& bd) {
  // the physical row of logical row j, from j alone (no chain across j)
  const auto row = [&](int j) { return head + j < Km ? head + j : head + j - Km; };
  float m = kNegInf;
  for (int j = 0; j < Km; ++j) {
    const float x = ring[row(j) * rs] + du[j * ds];
    if constexpr (kS == Scan::kViterbi) {
      if (x > m) {
        m = x;
        bd = j;
      }
    } else {
      m = fmaxf(m, x);
    }
  }
  if constexpr (kS == Scan::kViterbi) return m;
  float s = 0.f;
  for (int j = 0; j < Km; ++j) s += expf(ring[row(j) * rs] + du[j * ds] - m);
  return m + logf(s);
}

// one (max, first argmax) chain of the combine: a later term takes the
// chain only above its max, so the chain keeps its first maximum
__device__ __forceinline__ void arg_step(float x, int k, float& m, int& b) {
  if (x > m) {
    m = x;
    b = k;
  }
}

// merges chain (mi, bi) into (m, b): the larger max, of equal maxima the
// least index (the first maximum over both chains)
__device__ __forceinline__ void arg_merge(float mi, int bi, float& m, int& b) {
  if (mi > m || (mi == m && bi < b)) {
    m = mi;
    b = bi;
  }
}

// The transition combine of one class from shared memory: tr its row of
// the table (trans[c, c'] over c', 16-byte aligned), a the whole alpha
// row (16-byte aligned), both read 4 floats a load. Returns gamma; `bc`
// gets the first argmax c' (kViterbi).
template <Scan kS>
__device__ __forceinline__ float combine(const float* __restrict__ tr,
                                         const float* __restrict__ a, int C,
                                         int& bc) {
  float m0 = kNegInf, m1 = kNegInf, m2 = kNegInf, m3 = kNegInf;
  int b0 = 0, b1 = 0, b2 = 0, b3 = 0;
  int k = 0;
#pragma unroll 4
  for (; k + 4 <= C; k += 4) {
    const float4 tv = *reinterpret_cast<const float4*>(tr + k);
    const float4 av = *reinterpret_cast<const float4*>(a + k);
    const float x0 = tv.x + av.x;
    const float x1 = tv.y + av.y;
    const float x2 = tv.z + av.z;
    const float x3 = tv.w + av.w;
    if constexpr (kS == Scan::kViterbi) {
      arg_step(x0, k, m0, b0);
      arg_step(x1, k + 1, m1, b1);
      arg_step(x2, k + 2, m2, b2);
      arg_step(x3, k + 3, m3, b3);
    } else {
      m0 = fmaxf(m0, x0);
      m1 = fmaxf(m1, x1);
      m2 = fmaxf(m2, x2);
      m3 = fmaxf(m3, x3);
    }
  }
#pragma unroll 1
  for (; k < C; ++k) {  // the last C mod 4 terms, into chain 0 (ascending)
    const float x = tr[k] + a[k];
    if constexpr (kS == Scan::kViterbi) {
      arg_step(x, k, m0, b0);
    } else {
      m0 = fmaxf(m0, x);
    }
  }
  if constexpr (kS == Scan::kViterbi) {
    arg_merge(m1, b1, m0, b0);
    arg_merge(m2, b2, m0, b0);
    arg_merge(m3, b3, m0, b0);
    bc = b0;
    return m0;
  }
  const float m = fmaxf(fmaxf(m0, m1), fmaxf(m2, m3));
  float s = 0.f;  // one chain, c' ascending
  k = 0;
#pragma unroll 4
  for (; k + 4 <= C; k += 4) {
    const float4 tv = *reinterpret_cast<const float4*>(tr + k);
    const float4 av = *reinterpret_cast<const float4*>(a + k);
    s += expf(tv.x + av.x - m);
    s += expf(tv.y + av.y - m);
    s += expf(tv.z + av.z - m);
    s += expf(tv.w + av.w - m);
  }
#pragma unroll 1
  for (; k < C; ++k) s += expf(tr[k] + a[k] - m);
  return m + logf(s);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// `addr` (this block's shared memory) in block `rank`'s shared memory
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// an asynchronous store of `v` to `addr` (a block's shared memory in the
// cluster) that completes 4 bytes of the transaction count of the
// mbarrier at `bar` (the same block's)
__device__ __forceinline__ void push_async(uint32_t addr, float v,
                                           uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbarrier_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbarrier_arrive_expect_tx(uint32_t bar,
                                                          int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// every thread of every block of the cluster; the stores before it
// (distributed shared memory too) are seen by the loads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::
          : "memory");
}

// trans_t (N, C, C) [from][to]; init (N, C); dur (N, Km, C); emit (N, T, C);
// gamma (kLog), alphas (N, T, C) float32; bp (N, T, C) int32 (kViterbi).
// Grid N * cluster blocks in clusters of `cluster`, ceil(slab / 32) warps
// a block; shared memory (in floats): the two alpha rows' mbarriers (4),
// [2][alpha_stride(C)] alpha rows, the table's rows of the block's
// classes [min(slab, C)][table_stride(C)], the ring's [Km][slab].
// kMulti: a cluster of more than one block (the alpha row pushed to every
// block by st.async, each block waiting on its own mbarrier); else one
// block a chain and a block barrier a step.
template <Scan kS, bool kMulti>
__global__ void __launch_bounds__(kMaxSlabThreads, 1)
    wide_cluster_scan_kernel(const float* __restrict__ trans_t,
                             const float* __restrict__ init,
                             const float* __restrict__ dur,
                             const float* __restrict__ emit,
                             float* __restrict__ gamma,
                             float* __restrict__ alphas,
                             int32_t* __restrict__ bp, int T, int C, int Km,
                             int radix, int cluster, int slab, int group) {
  extern __shared__ __align__(16) float smem[];
  const int Cp = alpha_stride(C);
  const int rs = table_stride(C);
  float* const alpha_s = smem + 4;                         // [2][Cp]
  float* const trans_s = alpha_s + 2 * Cp;                 // [rows][rs]
  float* const ring = trans_s + (size_t)min(slab, C) * rs;  // [Km][slab]
  const int rank = kMulti ? (int)cluster_rank() : 0;
  const int n = blockIdx.x / cluster;
  const int j = threadIdx.x;
  const int c0 = rank * slab;
  const int c = c0 + j;
  const bool live = j < slab && c < C;

  // the table's row of each class of the block (trans[c, :], read from
  // the transposed table's column c), once; a thread reads back only its
  // own row and ring column
  if (live) {
    const float* const src = trans_t + (size_t)(n / group) * C * C + c;
    float* const row = trans_s + (size_t)j * rs;
#pragma unroll 8
    for (int k = 0; k < C; ++k) row[k] = src[(size_t)k * C];
    ring[j] = init[(size_t)n * C + c];
    for (int r = 1; r < Km; ++r) ring[r * slab + j] = kBigNeg;
  }
  const float* const du = dur + (size_t)n * Km * C + c;
  const size_t plane = (size_t)n * T * C;
  const float* const e_col = emit + plane + c;
  const uint32_t bar_addr = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t alpha_addr = (uint32_t)__cvta_generic_to_shared(alpha_s + c);
  if constexpr (kMulti) {
    if (threadIdx.x == 0) {
      mbarrier_init(bar_addr);
      mbarrier_init(bar_addr + 8);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // no block pushes into another before its mbarriers are made
    cluster_sync();
  }
  float e_next = live && T > 0 ? e_col[0] : 0.f;
  float cum = 0.f;
  int head = 0;
  for (int t = 0; t < T; ++t) {
    const int b = t & 1;
    const int buf = b * Cp;
    // every class's alpha (4 C bytes) completes this step's phase
    if constexpr (kMulti) {
      if (threadIdx.x == 0) mbarrier_arrive_expect_tx(bar_addr + 8 * b, 4 * C);
    }
    int bd = 0;
    if (live) {
      cum += e_next;
      if (t + 1 < T) e_next = e_col[(size_t)(t + 1) * C];
      const float a = duration_reduce<kS>(ring + j, slab, du, C, Km, head, bd);
      const float alpha = a + cum;
      alphas[plane + (size_t)t * C + c] = alpha;
      if constexpr (kMulti) {
        const uint32_t at = alpha_addr + 4u * buf;
        for (int r = 0; r < cluster; ++r)
          push_async(map_rank(at, (uint32_t)r), alpha,
                     map_rank(bar_addr + 8 * b, (uint32_t)r));
      } else {
        alpha_s[buf + c] = alpha;
      }
    }
    if constexpr (kMulti) {
      mbarrier_wait(bar_addr + 8 * b, (t >> 1) & 1);
    } else {
      __syncthreads();
    }
    if (!live) continue;

    int bc = 0;
    const float g = combine<kS>(trans_s + (size_t)j * rs, alpha_s + buf, C, bc);
    const size_t at = plane + (size_t)t * C + c;
    if constexpr (kS == Scan::kViterbi) {
      bp[at] = bd * radix + bc;
    } else if constexpr (kS == Scan::kLog) {
      gamma[at] = g;
    }
    // the push: the oldest row's slot becomes logical row 0
    head = head == 0 ? Km - 1 : head - 1;
    ring[head * slab + j] = g - cum;
  }
  if constexpr (kMulti) cluster_sync();
}

// The L2 route. trans_t, init, dur, emit, gamma, alphas, bp as above;
// ring_g (N, Km, C) float32 scratch, or null for the ring in shared memory.
// Shared memory (in floats): [2][C] alpha rows, [C] cum, [C] duration
// argmax (int), then the ring's [Km][C] where ring_g is null.
template <Scan kS>
__global__ void __launch_bounds__(kMaxThreads, 1)
    wide_scan_kernel(const float* __restrict__ trans_t,
                     const float* __restrict__ init,
                     const float* __restrict__ dur,
                     const float* __restrict__ emit, float* __restrict__ gamma,
                     float* __restrict__ alphas, int32_t* __restrict__ bp,
                     float* __restrict__ ring_g, int T, int C, int Km,
                     int radix, int group) {
  extern __shared__ float smem[];
  float* const alpha_s = smem;          // [2][C]
  float* const cum_s = smem + 2 * C;    // [C]
  int* const bd_s = reinterpret_cast<int*>(smem + 3 * C);  // [C]
  const int n = blockIdx.x;
  const int step = blockDim.x;
  float* const ring =
      ring_g != nullptr ? ring_g + (size_t)n * Km * C : smem + 4 * C;
  const float* const table = trans_t + (size_t)(n / group) * C * C;
  const float* const du = dur + (size_t)n * Km * C;
  const size_t plane = (size_t)n * T * C;

  // the ring: logical row j at physical (head + j) mod Km
  for (int c = threadIdx.x; c < C; c += step) {
    ring[c] = init[(size_t)n * C + c];
    for (int j = 1; j < Km; ++j) ring[(size_t)j * C + c] = kBigNeg;
    cum_s[c] = 0.f;
  }
  int head = 0;
  for (int t = 0; t < T; ++t) {
    float* const a_buf = alpha_s + (t & 1) * C;
    const size_t at = plane + (size_t)t * C;
    for (int c = threadIdx.x; c < C; c += step) {
      int bd = 0;
      const float e = emit[at + c];
      const float r = duration_reduce<kS>(ring + c, C, du + c, C, Km, head, bd);
      const float cum = cum_s[c] + e;
      cum_s[c] = cum;
      const float alpha = r + cum;
      alphas[at + c] = alpha;
      a_buf[c] = alpha;
      if constexpr (kS == Scan::kViterbi) bd_s[c] = bd;
    }
    __syncthreads();

    // the push: the oldest row's slot becomes logical row 0
    const int next = head == 0 ? Km - 1 : head - 1;
    for (int c = threadIdx.x; c < C; c += step) {
      const float* const tr = table + c;  // column c: trans[c, c'] over c'
      // the transition combine, c' ascending
      float m = kNegInf;
      int bc = 0;
#pragma unroll 8
      for (int k = 0; k < C; ++k) {
        const float x = tr[(size_t)k * C] + a_buf[k];
        if constexpr (kS == Scan::kViterbi) {
          if (x > m) {
            m = x;
            bc = k;
          }
        } else {
          m = fmaxf(m, x);
        }
      }
      float g = m;
      if constexpr (kS != Scan::kViterbi) {
        float s = 0.f;
#pragma unroll 8
        for (int k = 0; k < C; ++k) s += expf(tr[(size_t)k * C] + a_buf[k] - m);
        g = m + logf(s);
      }
      if constexpr (kS == Scan::kViterbi) {
        bp[at + c] = bd_s[c] * radix + bc;
      } else if constexpr (kS == Scan::kLog) {
        gamma[at + c] = g;
      }
      ring[(size_t)next * C + c] = g - cum_s[c];
    }
    head = next;
  }
}

// the cluster route's shared memory in bytes (the kernel's layout)
long cluster_smem(int C, int Km, int slab) {
  return 4L * (4L + 2L * alpha_stride(C) +
               (long)(slab < C ? slab : C) * table_stride(C) + (long)Km * slab);
}

// cluster > 0: the cluster route, `cluster` blocks of `slab` classes a
// chain; 0: the L2 route (ring null for the ring in shared memory).
template <Scan kS>
int launch(const void* trans_t, const void* init, const void* dur,
           const void* emit, void* gamma, void* alphas, void* bp, void* ring,
           int N, int T, int C, int Km, int radix, int cluster, int slab,
           int smem, int group, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool clustered = cluster > 0;
  const long need =
      clustered ? cluster_smem(C, Km, slab)
                : 4L * (4L * C + (ring == nullptr ? (long)Km * C : 0L));
  if (C < 1 || Km < 1 || cluster < 0 || group < 1 || smem < need ||
      smem > kMaxSmem ||
      (clustered &&
       (ring != nullptr || slab < 1 || slab > kMaxSlabThreads ||
        (long)(cluster - 1) * slab >= C || (long)cluster * slab < C)) ||
      (kS == Scan::kViterbi && (radix < C || (long)Km * radix > INT_MAX)))
    return (int)cudaErrorInvalidValue;
  if (N == 0 || T == 0) return 0;
  if (!clustered) {
    auto kernel = wide_scan_kernel<kS>;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
    }
    const int threads = C < kMaxThreads ? (C + 31) / 32 * 32 : kMaxThreads;
    kernel<<<N, threads, smem, (cudaStream_t)stream>>>(
        (const float*)trans_t, (const float*)init, (const float*)dur,
        (const float*)emit, (float*)gamma, (float*)alphas, (int32_t*)bp,
        (float*)ring, T, C, Km, radix, group);
    return (int)cudaGetLastError();
  }
  auto kernel = cluster > 1 ? wide_cluster_scan_kernel<kS, true>
                            : wide_cluster_scan_kernel<kS, false>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)N * cluster);
  config.blockDim = dim3((slab + 31) / 32 * 32);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, (const float*)trans_t,
                           (const float*)init, (const float*)dur,
                           (const float*)emit, (float*)gamma, (float*)alphas,
                           (int32_t*)bp, T, C, Km, radix, cluster, slab, group);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <Scan kS>
int max_active_clusters(int cluster, int slab, int smem, int device,
                        int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto kernel = cluster > 1 ? wide_cluster_scan_kernel<kS, true>
                            : wide_cluster_scan_kernel<kS, false>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)cluster);
  config.blockDim = dim3((slab + 31) / 32 * 32);
  config.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &config);
}

}  // namespace

extern "C" {

// trans_t (G, C, C) [from][to] (trans transposed), G = ceil(N / group):
// chain n reads table n / group; init (N, C); dur (N, Km, C); emit (N, T,
// C); alphas (N, T, C) out; all float32. bp (N, T, C) int32 out, bp =
// bp_d * radix + bp_c (radix >= C, Km * radix in int32). cluster > 0: the
// cluster route, `cluster` blocks of `slab` classes a chain ((cluster - 1)
// * slab < C <= cluster * slab, slab <= 256), ring null, smem the shared
// memory of a block (2 * alpha_stride(C) + (C + Km) * slab floats).
// cluster 0: the L2 route, slab ignored; ring (N, Km, C) float32 scratch,
// or null for the ring in shared memory; smem 4 * C floats plus, with no
// scratch, the ring's Km * C (ops/hsmm_cuda.py `wide_scan_instance` sizes
// both), at most a block's 232,448 bytes. All contiguous, on `device`.
// Launches on `stream`; returns the CUDA error code (cudaErrorInvalidValue
// for arguments it does not take, the launch's error where CUDA refuses
// the cluster; 0 on success).
int hsmm_wide_viterbi_scan(const void* trans_t, const void* init,
                           const void* dur, const void* emit, void* alphas,
                           void* bp, void* ring, int N, int T, int C, int Km,
                           int radix, int cluster, int slab, int smem,
                           int group, int device, void* stream) {
  return launch<Scan::kViterbi>(trans_t, init, dur, emit, nullptr, alphas, bp,
                                ring, N, T, C, Km, radix, cluster, slab, smem,
                                group, device, stream);
}

// The log semiring with the same inputs: gamma and alphas (N, T, C) out.
int hsmm_wide_log_scan(const void* trans_t, const void* init, const void* dur,
                       const void* emit, void* gamma, void* alphas, void* ring,
                       int N, int T, int C, int Km, int cluster, int slab,
                       int smem, int group, int device, void* stream) {
  return launch<Scan::kLog>(trans_t, init, dur, emit, gamma, alphas, nullptr,
                            ring, N, T, C, Km, 0, cluster, slab, smem, group,
                            device, stream);
}

// The log semiring's alphas alone (the partition's primal).
int hsmm_wide_forward_scan(const void* trans_t, const void* init,
                           const void* dur, const void* emit, void* alphas,
                           void* ring, int N, int T, int C, int Km,
                           int cluster, int slab, int smem, int group,
                           int device, void* stream) {
  return launch<Scan::kForward>(trans_t, init, dur, emit, nullptr, alphas,
                                nullptr, ring, N, T, C, Km, 0, cluster, slab,
                                smem, group, device, stream);
}

// cudaOccupancyMaxActiveClusters of instance `scan` (0 kViterbi, 1 kLog,
// 2 kForward) on the cluster route at (cluster, slab, smem): *out the
// clusters the card holds at once. Returns the CUDA error code.
int hsmm_wide_max_active_clusters(int scan, int cluster, int slab, int smem,
                                  int device, int* out) {
  if (scan == 0)
    return max_active_clusters<Scan::kViterbi>(cluster, slab, smem, device,
                                               out);
  if (scan == 1)
    return max_active_clusters<Scan::kLog>(cluster, slab, smem, device, out);
  if (scan == 2)
    return max_active_clusters<Scan::kForward>(cluster, slab, smem, device,
                                               out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
