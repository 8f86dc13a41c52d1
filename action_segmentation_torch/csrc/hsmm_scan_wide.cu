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
// (ops/hsmm_cuda.py `_viterbi_scan_plain`, `_scan_plain`) in its
// order, with expf/logf and no fast math, so the outputs are its bits.
// A max is exact, so the combine takes it in four interleaved chains of
// c' (k mod 4) and merges them, the equal maxima by the least index: the
// same max and the same first argmax as one chain in index order. The
// log semiring's sum stays one chain in index order.
//
// The log semiring (kLog, kForward) folds the carry as the narrow
// template does (csrc/hsmm_scan_core.cuh, ops/hsmm_cuda.py `_scan_plain`
// with fold): within a step, after the alpha and before the push, a class
// whose |cum| exceeds kFoldLimit takes it into its own ring column (W +=
// cum, cum = 0); after step t with t % kFold == kFold - 1 and t + 1 < T
// the chain takes s, the max of the step's alphas over its C classes (0
// where none is above BIG_NEG / 2), every ring row becomes (W + cum) - s,
// cum = 0, and s goes to offsets[n, (t + 1) / kFold] (column 0 is 0). The
// planes are then relative to the chain's offset, which the caller adds in
// float64, and no float32 value of the scan grows with the video's length.
// A max is exact, so every thread (every pair on the grid route) takes s
// from the step's alpha row itself, the same bits in every block.
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
// The grid route (`wide_grid_scan_kernel`, past the cluster route: a
// table a portable cluster of 8 does not hold, or a ring that does not fit
// beside it) spreads a launch over every SM of the card: one cooperative
// grid of at most one block an SM (cudaLaunchAttributeCooperative, so that
// every block is resident at once or the launch is refused). Block b owns
// the (chain, class) pairs of one group of `chains` consecutive chains and
// one slab of `slab` classes; pair p is chain p / slab and class p % slab of
// the block's, a thread taking the pairs p = tid, tid + blockDim.x, ...
// (one at 1,577 classes and 18 chains). Where every chain of a block reads
// one table and it fits, the block holds its slab's rows of that table in
// shared memory for the whole scan (read once before the time loop);
// otherwise the same code reads them from global memory (the table a
// chain of a wide batch, which no card's shared memory holds). Rows are
// trans[c, :] at table_stride(C), so that the combine is the cluster
// route's `combine`, the same loads and the same bits. A step:
//   (a) each pair's duration reduce; its alpha to the output plane and to
//       the exchange row of its chain (xchg, [N][2][table_stride(C)]
//       floats in global memory, double-buffered by the step's parity, so
//       that the rows are 16-byte aligned where the plane's are not);
//   (b) one grid barrier: after a block barrier, thread 0 adds 1 to the
//       launch's step counter (`red.release.gpu`, the wrapper's scratch,
//       zeroed by the launch on its stream) and spins (`ld.acquire.gpu`)
//       until every block of the step has arrived;
//   (c) the block's chains' alpha rows read back from the exchange rows
//       (16-byte loads that bypass L1, `ld.global.cg`) into shared memory;
//   (d) each pair's transition combine from shared memory (its table row,
//       its chain's alpha row) and (e) its code or gamma stored and its
//       ring pushed.
// Each pair's emission prefix sum and duration argmax sit in shared memory
// (across the barrier), and its column of the ring too where it fits, else
// in a global scratch the wrapper allocates (a block's region), through
// the same code. The exchange row of step t is written again at step t + 2
// only after barrier t + 1, which no block passes before its reads of step
// t; so one barrier a step suffices. What bounds it: a step's C terms a
// pair, over every SM's schedulers, plus the barrier and the alpha rows'
// bytes from L2 (tools/scan_floor.py reads the terms' instructions from
// the SASS; tools/scan_ab.py's empty-step probe times the barrier alone).
// ops/hsmm_cuda.py `wide_grid_instance` picks the tiling (the chains a
// block, the slab, where the table and the ring live), the least of a
// block's terms plus its bytes from L2 a step, and splits a batch whose
// chains no grid holds over several launches.

// A chain's table: `group` chains share one, chain n reading table
// n / group (1: a table a chain; N: every chain one table, as a model's
// expanded transition view gives it; B of 2B: the stacked forward and
// reversed chains' two). A shared table is read once: on the grid route
// its slabs sit in the shared memory of the blocks whose chains read it,
// where they fit beside the alpha rows; a table a chain at 1,577 classes
// (179 MB for 18 chains) fits no card's shared memory, and its slabs
// stream from HBM each step (the max scan 6.5x slower so on an H100,
// PERF.md section 6).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <limits>

namespace {

constexpr float kBigNeg = -1e9f;
constexpr float kNegInf = -std::numeric_limits<float>::infinity();
constexpr int kGridThreads = 512;  // the grid route's block at most
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic shared memory
// the cluster route's slab: at most 256 classes a block (a cluster of one
// holds at most 228 classes' table; a wider DP splits it over blocks)
constexpr int kMaxSlabThreads = 256;

// the log scans' fold period (a power of 2) and per-class fold bound:
// csrc/hsmm_scan_core.cuh's, ops/hsmm_cuda.py SCAN_FOLD, SCAN_FOLD_LIMIT
constexpr int kFold = 64;
constexpr float kFoldLimit = 4096.f;

// kViterbi: alphas and codes (K6's function); kLog: gamma and alphas
// (K2-log's); kForward: alphas only (K1's). The last two fold.
enum class Scan { kViterbi, kLog, kForward };

// the alpha row's stride: C rounded up to 4 floats, so that every buffer
// and every 4-float group of it is 16-byte aligned
__host__ __device__ inline int alpha_stride(int C) { return (C + 3) & ~3; }

// a class's row of the table (both routes): alpha_stride(C)
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

// the chain fold's s: the max of an alpha row's C values (16-byte aligned;
// the padding past C is not read), 0 where none is above BIG_NEG / 2
__device__ __forceinline__ float fold_shift(const float* __restrict__ a, int C) {
  float m0 = kNegInf, m1 = kNegInf, m2 = kNegInf, m3 = kNegInf;
  int k = 0;
  for (; k + 4 <= C; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(a + k);
    m0 = fmaxf(m0, v.x);
    m1 = fmaxf(m1, v.y);
    m2 = fmaxf(m2, v.z);
    m3 = fmaxf(m3, v.w);
  }
  for (; k < C; ++k) m0 = fmaxf(m0, a[k]);
  const float s = fmaxf(fmaxf(m0, m1), fmaxf(m2, m3));
  return s > 0.5f * kBigNeg ? s : 0.f;  // no live alpha: cum alone
}

// a class's own fold, on its ring column (Km rows at stride rs), after its
// alpha and before its push: where |cum| passes kFoldLimit, W += cum and
// cum = 0
template <typename Ring>
__device__ __forceinline__ void fold_class(Ring ring, int rs, int Km, float& cum) {
  if (fabsf(cum) > kFoldLimit) {
    for (int r = 0; r < Km; ++r) ring[r * rs] += cum;
    cum = 0.f;
  }
}

// the chain's fold on a class's ring column, after the push of a fold
// step: W = (W + cum) - s and cum = 0
template <typename Ring>
__device__ __forceinline__ void fold_chain(Ring ring, int rs, int Km, float& cum,
                                           float s) {
  for (int r = 0; r < Km; ++r) ring[r * rs] = (ring[r * rs] + cum) - s;
  cum = 0.f;
}

// true after step t of T where the log scans fold the chain
__device__ __forceinline__ bool fold_step(int t, int T) {
  return (t & (kFold - 1)) == kFold - 1 && t + 1 < T;
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
// gamma (kLog), alphas (N, T, C) float32; bp (N, T, C) int32 (kViterbi);
// offsets (N, ceil(T / kFold)) float32 (kLog, kForward).
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
                             int32_t* __restrict__ bp,
                             float* __restrict__ offsets, int T, int C, int Km,
                             int radix, int cluster, int slab, int group) {
  constexpr bool kFolds = kS != Scan::kViterbi;
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
  const int n_blocks = (T + kFold - 1) / kFold;  // offsets' columns
  if (kFolds && c == 0) offsets[(size_t)n * n_blocks] = 0.f;
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
    if constexpr (kFolds) fold_class(ring + j, slab, Km, cum);
    // the push: the oldest row's slot becomes logical row 0
    head = head == 0 ? Km - 1 : head - 1;
    ring[head * slab + j] = g - cum;
    // the chain's fold: s from this step's alpha row, read before this
    // thread's push of step t + 1 (the row's next writer is a push of
    // step t + 2, which waits for it; see the top)
    if constexpr (kFolds) {
      if (fold_step(t, T)) {
        const float s = fold_shift(alpha_s + buf, C);
        fold_chain(ring + j, slab, Km, cum, s);
        if (c == 0) offsets[(size_t)n * n_blocks + (t + 1) / kFold] = s;
      }
    }
  }
  if constexpr (kMulti) cluster_sync();
}

// one arrival of the block at the grid barrier of step t (the counter's
// target (t + 1) * gridDim.x): every thread's stores before it are seen by
// every thread of every block after it
__device__ __forceinline__ void grid_barrier(unsigned* counter, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(counter)
                 : "memory");
    unsigned seen = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(counter)
                   : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

// The grid route. table (G, C, table_stride(C)): table g's rows trans[c, :]
// ([to][from], padded); init, dur, emit, gamma, alphas, bp, offsets as
// above (the block of class slab 0 writes its chains' offsets); xchg
// (N, 2, table_stride(C)) float32 scratch; ring_g (gridDim.x, Km, chains *
// slab) float32 scratch, or null for the ring in shared memory; counter one
// uint32, 0 at the launch. kTableShared: the block's slab of its table in
// shared memory (every chain of a block reads table n0 / group), else read
// from global memory. Shared memory (in floats): the table slab's
// [slab][rs] (kTableShared), the chains' alpha rows [chains][rs], each
// pair's cum and duration argmax (int) [pairs] each, then the ring's
// [Km][pairs] where ring_g is null.
template <Scan kS, bool kTableShared>
__global__ void __launch_bounds__(kGridThreads, 1)
    wide_grid_scan_kernel(const float* __restrict__ table,
                          const float* __restrict__ init,
                          const float* __restrict__ dur,
                          const float* __restrict__ emit,
                          float* __restrict__ gamma,
                          float* __restrict__ alphas,
                          int32_t* __restrict__ bp,
                          float* __restrict__ offsets, float* __restrict__ xchg,
                          float* __restrict__ ring_g,
                          unsigned* __restrict__ counter, int N, int T, int C,
                          int Km, int radix, int slab, int chains, int group) {
  constexpr bool kFolds = kS != Scan::kViterbi;
  extern __shared__ __align__(16) float smem[];
  const int rs = table_stride(C);
  const int q = rs / 4;  // a row's 16-byte words
  const int slabs = (C + slab - 1) / slab;
  const int n0 = (int)blockIdx.x / slabs * chains;
  const int c0 = (int)blockIdx.x % slabs * slab;
  const int pairs = chains * slab;
  float* const trans_s = smem;  // [slab][rs] (kTableShared)
  float* const alpha_s = smem + (kTableShared ? (size_t)slab * rs : 0);  // [chains][rs]
  float* const cum_s = alpha_s + (size_t)chains * rs;  // [pairs]
  int* const bd_s = reinterpret_cast<int*>(cum_s + pairs);  // [pairs]
  float* const ring = ring_g != nullptr
                          ? ring_g + (size_t)blockIdx.x * Km * pairs
                          : cum_s + 2 * (size_t)pairs;  // [Km][pairs]
  const int step = blockDim.x;
  const int n_blocks = (T + kFold - 1) / kFold;  // offsets' columns

  if constexpr (kTableShared) {  // the slab's rows of the block's table, once
    const float4* const src = reinterpret_cast<const float4*>(
        table + ((size_t)(n0 / group) * C + c0) * rs);
    float4* const dst = reinterpret_cast<float4*>(trans_s);
    const int rows = min(slab, C - c0);
    for (int k = threadIdx.x; k < rows * q; k += step) dst[k] = src[k];
  }
  for (int p = threadIdx.x; p < pairs; p += step) {
    const int n = n0 + p / slab, c = c0 + p % slab;
    if (n >= N || c >= C) continue;
    ring[p] = init[(size_t)n * C + c];
    for (int j = 1; j < Km; ++j) ring[(size_t)j * pairs + p] = kBigNeg;
    cum_s[p] = 0.f;
    if (kFolds && c == 0) offsets[(size_t)n * n_blocks] = 0.f;
  }
  const int live_chains = min(chains, N - n0);
  int head = 0;
  for (int t = 0; t < T; ++t) {
    const int b = t & 1;
    // (a) the duration reduce; alpha to the plane and the exchange row
    for (int p = threadIdx.x; p < pairs; p += step) {
      const int n = n0 + p / slab, c = c0 + p % slab;
      if (n >= N || c >= C) continue;
      const size_t at = ((size_t)n * T + t) * C + c;
      const float e = emit[at];
      int bd = 0;
      const float r = duration_reduce<kS>(ring + p, pairs,
                                          dur + (size_t)n * Km * C + c, C, Km,
                                          head, bd);
      const float cum = cum_s[p] + e;
      cum_s[p] = cum;
      const float alpha = r + cum;
      alphas[at] = alpha;
      xchg[((size_t)n * 2 + b) * rs + c] = alpha;
      if constexpr (kS == Scan::kViterbi) bd_s[p] = bd;
    }
    // (b) every block's alphas of step t written
    grid_barrier(counter, (unsigned)(t + 1) * gridDim.x);
    // (c) the block's chains' alpha rows, past L1
    {
      const float4* const src =
          reinterpret_cast<const float4*>(xchg + ((size_t)n0 * 2 + b) * rs);
      float4* const dst = reinterpret_cast<float4*>(alpha_s);
      const int words = live_chains * q;
      int k = threadIdx.x;
      for (; k + 3 * step < words; k += 4 * step) {  // four loads in flight
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int w = k + u * step;
          v[u] = __ldcg(src + (size_t)(w / q) * 2 * q + w % q);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) dst[k + u * step] = v[u];
      }
      for (; k < words; k += step) dst[k] = __ldcg(src + (size_t)(k / q) * 2 * q + k % q);
    }
    __syncthreads();
    // (d) the transition combine, (e) the outputs, the fold and the push
    // (alpha_s is next written at (c) of step t + 1, past barrier t + 1)
    const int next = head == 0 ? Km - 1 : head - 1;
    const bool folds = kFolds && fold_step(t, T);
    for (int p = threadIdx.x; p < pairs; p += step) {
      const int i = p / slab, j = p % slab;
      const int n = n0 + i, c = c0 + j;
      if (n >= N || c >= C) continue;
      const float* const tr =
          kTableShared ? trans_s + (size_t)j * rs
                       : table + ((size_t)(n / group) * C + c) * rs;
      int bc = 0;
      const float g = combine<kS>(tr, alpha_s + (size_t)i * rs, C, bc);
      const size_t at = ((size_t)n * T + t) * C + c;
      if constexpr (kS == Scan::kViterbi) {
        bp[at] = bd_s[p] * radix + bc;
      } else if constexpr (kS == Scan::kLog) {
        gamma[at] = g;
      }
      if constexpr (kFolds) {
        float cum = cum_s[p];
        fold_class(ring + p, pairs, Km, cum);
        ring[(size_t)next * pairs + p] = g - cum;
        if (folds) {
          const float s = fold_shift(alpha_s + (size_t)i * rs, C);
          fold_chain(ring + p, pairs, Km, cum, s);
          if (c == 0) offsets[(size_t)n * n_blocks + (t + 1) / kFold] = s;
        }
        cum_s[p] = cum;
      } else {
        ring[(size_t)next * pairs + p] = g - cum_s[p];
      }
    }
    head = next;
  }
}

// T steps of the grid barrier alone (tools/scan_ab.py's empty-step probe)
__global__ void __launch_bounds__(kGridThreads, 1)
    grid_barrier_probe(unsigned* __restrict__ counter, int T) {
  for (int t = 0; t < T; ++t) grid_barrier(counter, (unsigned)(t + 1) * gridDim.x);
}

// the cluster route's shared memory in bytes (the kernel's layout)
long cluster_smem(int C, int Km, int slab) {
  return 4L * (4L + 2L * alpha_stride(C) +
               (long)(slab < C ? slab : C) * table_stride(C) + (long)Km * slab);
}

// the grid route's shared memory in bytes (the kernel's layout)
long grid_smem(int C, int Km, int slab, int chains, bool table_shared,
               bool ring_shared) {
  const long pairs = (long)chains * slab;
  return 4L * ((table_shared ? (long)slab * table_stride(C) : 0L) +
               (long)chains * table_stride(C) + 2L * pairs +
               (ring_shared ? (long)Km * pairs : 0L));
}

// the grid route's block: a thread a pair up to kGridThreads, in whole warps
int grid_threads(int slab, int chains) {
  const long pairs = (long)slab * chains;
  return pairs < kGridThreads ? (int)(pairs + 31) / 32 * 32 : kGridThreads;
}

// a cooperative launch of `kernel` in `blocks` blocks, after zeroing the
// step counter on the stream; refused (cudaErrorCooperativeLaunchTooLarge)
// where the card does not hold every block at once
template <typename... Params, typename... Args>
int launch_cooperative(void (*kernel)(Params...), unsigned* counter,
                       int blocks, int threads, int smem, int device,
                       cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0, sms = 0, coop = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return (int)err;
  if (!coop || blocks > per_sm * sms)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaMemsetAsync(counter, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)blocks);
  config.blockDim = dim3((unsigned)threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// cluster > 0: the cluster route, `cluster` blocks of `slab` classes a
// chain (table the transposed tables; xchg, ring and counter null); 0 and
// -1: the grid route, blocks of `chains` chains and `slab` classes, the
// table slab in shared memory (0) or read from global memory (-1).
template <Scan kS>
int launch(const void* table, const void* init, const void* dur,
           const void* emit, void* gamma, void* alphas, void* bp,
           void* offsets, void* xchg, void* ring, void* counter, int N, int T,
           int C, int Km, int radix,
           int cluster, int slab, int chains, int smem, int group, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool clustered = cluster > 0;
  const bool table_shared = cluster == 0;
  if (C < 1 || Km < 1 || cluster < -1 || group < 1 || slab < 1 ||
      smem > kMaxSmem ||
      (kS == Scan::kViterbi && (radix < C || (long)Km * radix > INT_MAX)) ||
      (kS != Scan::kViterbi && offsets == nullptr))
    return (int)cudaErrorInvalidValue;
  if (clustered &&
      (ring != nullptr || xchg != nullptr || counter != nullptr ||
       slab > kMaxSlabThreads || (long)(cluster - 1) * slab >= C ||
       (long)cluster * slab < C || smem < cluster_smem(C, Km, slab)))
    return (int)cudaErrorInvalidValue;
  if (!clustered &&
      (chains < 1 || xchg == nullptr || counter == nullptr ||
       smem < grid_smem(C, Km, slab, chains, table_shared, ring == nullptr) ||
       (table_shared && group < N && group % chains != 0)))
    return (int)cudaErrorInvalidValue;
  if (N == 0 || T == 0) return 0;
  if (!clustered) {
    const int blocks = (N + chains - 1) / chains * ((C + slab - 1) / slab);
    auto kernel = table_shared ? wide_grid_scan_kernel<kS, true>
                               : wide_grid_scan_kernel<kS, false>;
    return launch_cooperative(
        kernel, (unsigned*)counter, blocks, grid_threads(slab, chains), smem,
        device, (cudaStream_t)stream, (const float*)table, (const float*)init,
        (const float*)dur, (const float*)emit, (float*)gamma, (float*)alphas,
        (int32_t*)bp, (float*)offsets, (float*)xchg, (float*)ring,
        (unsigned*)counter, N, T, C, Km, radix, slab, chains, group);
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
  err = cudaLaunchKernelEx(&config, kernel, (const float*)table,
                           (const float*)init, (const float*)dur,
                           (const float*)emit, (float*)gamma, (float*)alphas,
                           (int32_t*)bp, (float*)offsets, T, C, Km, radix,
                           cluster, slab, group);
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

// The log scans' fold interval (kFold steps, the wrappers' SCAN_FOLD): a
// build whose log scans fold exports it, an earlier one does not
// (tools/scan_ab.py reads it to tell the two interfaces apart).
extern const int hsmm_wide_fold_steps = kFold;

// table: on the cluster route (cluster > 0) the tables transposed, (G, C,
// C) [from][to]; on the grid route (cluster 0 or -1) the tables' rows, (G,
// C, table_stride(C)) [to][from] padded; G = ceil(N / group): chain n
// reads table n / group. init (N, C); dur (N, Km, C); emit (N, T, C);
// alphas (N, T, C) out; all float32. bp (N, T, C) int32 out, bp = bp_d *
// radix + bp_c (radix >= C, Km * radix in int32); the log scans' offsets
// (N, ceil(T / 64)) float32 out, their planes relative to them (the fold
// at the top). cluster > 0: the cluster
// route, `cluster` blocks of `slab` classes a chain ((cluster - 1) * slab <
// C <= cluster * slab, slab <= 256), xchg, ring and counter null, `chains`
// ignored, smem a block's shared memory (4 + 2 * alpha_stride(C) + min(slab,
// C) * table_stride(C) + Km * slab floats). cluster 0 (the table slab in
// shared memory; every block's chains on one table: group >= N or a
// multiple of `chains`) or -1 (the table read from global memory): the
// grid route, ceil(N / chains) * ceil(C / slab) blocks of `chains` chains
// and `slab` classes, all resident at once; xchg (N, 2, table_stride(C))
// float32 scratch; ring (blocks, Km, chains * slab) float32 scratch, or
// null for the ring in shared memory; counter one uint32 of scratch (the
// launch zeroes it on `stream`); smem as `grid_smem` (ops/hsmm_cuda.py
// `wide_grid_instance` sizes all of it), at most a block's 232,448 bytes.
// All contiguous, on `device`. Launches on `stream`; returns the CUDA
// error code (cudaErrorInvalidValue for arguments it does not take,
// cudaErrorCooperativeLaunchTooLarge for a grid the card does not hold at
// once, the launch's error where CUDA refuses the cluster; 0 on success).
int hsmm_wide_viterbi_scan(const void* table, const void* init,
                           const void* dur, const void* emit, void* alphas,
                           void* bp, void* xchg, void* ring, void* counter,
                           int N, int T, int C, int Km, int radix, int cluster,
                           int slab, int chains, int smem, int group,
                           int device, void* stream) {
  return launch<Scan::kViterbi>(table, init, dur, emit, nullptr, alphas, bp,
                                nullptr, xchg, ring, counter, N, T, C, Km,
                                radix, cluster, slab, chains, smem, group,
                                device, stream);
}

// The log semiring with the same inputs, folded: gamma and alphas (N, T, C)
// relative to each chain's offsets, and the offsets (N, ceil(T / 64)) out.
int hsmm_wide_log_scan(const void* table, const void* init, const void* dur,
                       const void* emit, void* gamma, void* alphas,
                       void* offsets, void* xchg, void* ring, void* counter,
                       int N, int T, int C, int Km, int cluster, int slab,
                       int chains, int smem, int group, int device,
                       void* stream) {
  return launch<Scan::kLog>(table, init, dur, emit, gamma, alphas, nullptr,
                            offsets, xchg, ring, counter, N, T, C, Km, 0,
                            cluster, slab, chains, smem, group, device, stream);
}

// The log semiring's alphas and offsets alone (the partition's primal).
int hsmm_wide_forward_scan(const void* table, const void* init,
                           const void* dur, const void* emit, void* alphas,
                           void* offsets, void* xchg, void* ring,
                           void* counter, int N, int T, int C, int Km,
                           int cluster, int slab, int chains, int smem,
                           int group, int device, void* stream) {
  return launch<Scan::kForward>(table, init, dur, emit, nullptr, alphas,
                                nullptr, offsets, xchg, ring, counter, N, T,
                                C, Km, 0, cluster, slab, chains, smem, group,
                                device, stream);
}

// T steps of the grid route's barrier alone, a cooperative launch of
// `blocks` blocks of `threads` threads (counter one uint32 of scratch,
// zeroed on `stream`): tools/scan_ab.py's empty-step probe. Returns the
// CUDA error code.
int hsmm_wide_grid_barrier(void* counter, int blocks, int threads, int T,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (counter == nullptr || blocks < 1 || threads < 1 ||
      threads > kGridThreads || T < 0)
    return (int)cudaErrorInvalidValue;
  return launch_cooperative(grid_barrier_probe, (unsigned*)counter, blocks,
                            threads, 0, device, (cudaStream_t)stream,
                            (unsigned*)counter, T);
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
