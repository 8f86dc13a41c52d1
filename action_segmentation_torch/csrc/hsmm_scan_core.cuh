// The banded semi-Markov forward scan, one template for the three scans:
// the max and log semirings of csrc/hsmm_scan.cu (K2, K1) and the max
// semiring with backpointer codes of csrc/hsmm_viterbi.cu (K6).
//
// Per chain n, with W the (Km, C) carry of the last Km boundary scores
// minus the emission prefix sum (logical row 0 starts as `init`):
//   cum       += emit[t]
//   alpha[c]   = reduce_j (W[j, c] + dur[j, c]) + cum[c]
//   gamma[t,c] = reduce_c' trans[c, c'] + alpha[c']
//   push gamma - cum as W's new row 0 (the oldest row drops out)
// where reduce is JAX's `_semiring_reduce`: the max, or in the log
// semiring m + log(sum(exp(x - m))) with m the max and the sum taken in
// index order (j, then c'), or (K6) the max with its FIRST argmax, j in
// logical duration order (j = 0 is duration 1) and c' ascending.
//
// The log semiring folds the carry every kFold steps: after step t with
// t % kFold == kFold - 1 (and t + 1 < T) it takes s, the max of the step's
// alpha row over the live classes (0 where none is above BIG_NEG / 2), sets
// every carry row, the tail's included, to (W + cum) - s and cum to 0, and
// writes s to offsets[n, (t + 1) / kFold] (column 0 is 0). So cum spans at
// most kFold frames and the planes stay near 0 however long the video: a
// plane's row t is relative to the chain's offset, the sum of its offsets'
// columns 0 .. t / kFold, which the caller adds in float64. The steps run
// in blocks of kFold with the fold between two blocks (the max semirings
// in one block of T). Within a block a class folds alone, with no
// barrier: where its cum lies outside [-kFoldLimit, kFoldLimit] after the
// step's alpha, its carry rows (the tail's included) take it in, W +=
// cum, and cum = 0, before the push. Emissions of 1e4 nats a frame (the
// compound model's at its first steps) thus reach no carry row through a
// prefix sum of thousands of frames (the branch is taken at 41% of a
// class's steps there, tools/fold_sweep.py; rarely on the model's centred
// emissions at the D=300 scale). The max semirings do not fold.
//
// Every chain is serial in t, so a step's dependent chain (and, with one
// warp per chain, the step's instruction count) bounds the scan, not bytes
// or FLOPs. The layout keeps both short:
//
// * One block per chain of 1, 2 or 4 warps (C <= 32, 64, 128); thread c
//   holds class c. Threads past C compute class C - 1's values and store
//   no output, so every lane runs the same code.
// * The carry's newest kCarry = 24 rows and their duration scores sit in
//   registers (the default longest span, 20, gives Km = 19). The register
//   index is the logical duration; the push shifts W by one register a
//   step. With Km > 24 (kTail) the older rows 24 .. Km - 1 form the tail:
//   a shared-memory ring of Km - 24 rows whose head index rotates, fed by
//   the row that shifts out of the registers, with their duration scores
//   staged in shared memory beside it (measured on the H100 1.1-2x faster
//   a step than reading them from global memory). Where that would not
//   fit a block (C <= 9 with spans of thousands of frames) they are read
//   from global memory, so every shape the earlier all-shared layout (W,
//   dur, trans and alpha in shared memory) took still runs.
// * One warp: its class's trans row sits in kRow = 24 or 32 registers,
//   and alpha goes through a double-buffered shared row, one store,
//   __syncwarp and kRow / 4 broadcast 16-byte loads (measured on the H100
//   4-11% faster a step than 32 warp shuffles). 2-4 warps: trans
//   transposed in shared memory and alpha double-buffered there, one
//   barrier per step.
// * No branch inside a step's register work. A register reduction is
//   unrolled over its bucket and the terms past the real ones are -inf:
//   `dur` rows past Km and trans entries past C are -inf, so W + dur and
//   trans + alpha are -inf there. That is exact: fmaxf(m, -inf) = m, no
//   -inf equals a real maximum, expf(-inf) = +0 and s + 0 = s, and every
//   padded term comes after the real ones. (BIG_NEG padding would not be:
//   BIG_NEG + dur can win a column that is all BIG_NEG.) The reductions of
//   run-time length (the tail; 2-4 warps' transition combine over C) run
//   over their real terms in a loop unrolled by 8, whose loads issue
//   ahead of the compare chain (measured on the H100 against groups of
//   16 loads reduced by trees: the tail 1.02-2.07x faster at Km = 25-100,
//   the combine 1.5x faster at C = 33; at C = 128 10% faster in the log
//   semiring, 6-9% slower in the max and argmax ones).
// * Trees, not chains, in registers: the max is a balanced tree of fmaxf
//   (exact in any order); K6's first argmax is the least index whose term
//   equals the max (a min-tree of indices), which is the first maximum a
//   strict `>` scan keeps: j in logical duration order, then c'
//   ascending. In the log semiring the exponentials are independent and
//   issue back to back; the one serial chain is their sum, in index
//   order, as the plain version takes it.
// * Every float operation is the plain version's, so the outputs are
//   bit-exact with it. expf/logf, no fast math; there are no multiplies to
//   contract.
// * The emission column is staged kWindow - 1 = 15 steps ahead by
//   cp.async into a per-thread shared-memory window. At the fastest
//   instance's 0.14 us a step that is 2 us ahead, more than a global
//   load's latency (under 1 us from HBM), so the load never sets the pace.
//
// ptxas (-Xptxas -v, sm_90a; chip_smoke.py's build phase prints every
// instance): the serving instances (C=19, Km=19: one warp, row 24, no
// tail) take 118 (max), 166 (log) and 133 (argmax) registers, no
// spills.
//
// BIG_NEG (-1e9) stands for an impossible score in the inputs; -inf only
// pads the reductions (-inf - -inf is NaN, but no real term is -inf).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <limits>

namespace hsmm_scan {

constexpr float kBigNeg = -1e9f;
constexpr float kNegInf = -std::numeric_limits<float>::infinity();
constexpr int kCodeRadix = 128;  // bp = bp_d * 128 + bp_c (JAX's LANES)
constexpr int kCarry = 24;       // carry rows in registers
constexpr int kWindow = 16;      // emission window slots (a power of 2)
constexpr int kMaxClasses = 128;
constexpr int kFold = 64;        // the log scans' fold period (a power of 2)
constexpr float kFoldLimit = 4096.f;  // the log scans' per-class fold bound

enum class Semiring { kMax, kLog, kArgmax };

// ---- cp.async --------------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// ---- reductions ------------------------------------------------------------
// In registers, trees, not chains: the max is exact in any order, so it is
// a balanced tree of fmaxf; K6's first argmax is then the least index
// whose term equals that max (a min-tree of indices), which is the first
// maximum a strict `>` scan in index order keeps.

// The max of v[kLo .. kLo + kCount - 1], a balanced tree.
template <int kLo, int kCount>
__device__ __forceinline__ float tree_max(const float* v) {
  if constexpr (kCount == 1) {
    return v[kLo];
  } else {
    return fmaxf(tree_max<kLo, kCount / 2>(v),
                 tree_max<kLo + kCount / 2, kCount - kCount / 2>(v));
  }
}

// The least of k[kLo .. kLo + kCount - 1], a balanced tree.
template <int kLo, int kCount>
__device__ __forceinline__ int tree_min(const int* k) {
  if constexpr (kCount == 1) {
    return k[kLo];
  } else {
    return min(tree_min<kLo, kCount / 2>(k),
               tree_min<kLo + kCount / 2, kCount - kCount / 2>(k));
  }
}

// The max of v[0 .. kN - 1] and (kArg) the first index j0 + j attaining it.
template <bool kArg, int kN>
__device__ __forceinline__ float max_first(const float* v, int j0, int& arg) {
  const float m = tree_max<0, kN>(v);
  if constexpr (kArg) {
    int key[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) key[j] = v[j] == m ? j : kN;
    arg = j0 + tree_min<0, kN>(key);
  }
  return m;
}

// The semiring reduce of kN terms x(0..kN-1), unrolled, with no branch:
// the terms past the real ones are -inf. *arg gets the argmax (kArgmax).
template <Semiring kS, int kN, class X>
__device__ __forceinline__ float reduce_unrolled(X&& x, int& arg) {
  float v[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) v[j] = x(j);
  const float m = max_first<kS == Semiring::kArgmax, kN>(v, 0, arg);
  if constexpr (kS != Semiring::kLog) {
    return m;
  } else {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kN; ++j) s += expf(v[j] - m);
    return m + logf(s);
  }
}

// The max of m and x(0 .. n - 1), and (kArg) the first index attaining
// it (a: m's index; x(k) takes index i0 + k, and a strict `>` keeps the
// first maximum). A loop unrolled by 8, so the loads issue ahead of the
// compare chain.
template <bool kArg, class X>
__device__ __forceinline__ float loop_max(int n, X& x, int i0, float m,
                                          int& a) {
#pragma unroll 8
  for (int k = 0; k < n; ++k) {
    const float xk = x(k);
    if constexpr (kArg) {
      const bool larger = xk > m;
      a = larger ? i0 + k : a;
      m = larger ? xk : m;
    } else {
      m = fmaxf(m, xk);
    }
  }
  return m;
}

// s + exp(x(0) - m) + ... + exp(x(n - 1) - m), one chain in index order.
template <class X>
__device__ __forceinline__ float loop_sum(int n, X& x, float m, float s) {
#pragma unroll 8
  for (int k = 0; k < n; ++k) s += expf(x(k) - m);
  return s;
}

// The semiring reduce of x(0 .. n - 1), n >= 1 known at run time.
template <Semiring kS, class X>
__device__ __forceinline__ float reduce_runtime(int n, X&& x, int& arg) {
  const float m = loop_max<kS == Semiring::kArgmax>(n, x, 0, kNegInf, arg);
  if constexpr (kS != Semiring::kLog) {
    return m;
  } else {
    return m + logf(loop_sum(n, x, m, 0.f));
  }
}

// The semiring reduce of v[0 .. kN - 1] followed by x(0 .. n - 1) (n >= 1,
// indices kN ..): one reduce over both in index order.
template <Semiring kS, int kN, class X>
__device__ __forceinline__ float reduce_split(const float* v, int n, X&& x,
                                              int& arg) {
  constexpr bool kArg = kS == Semiring::kArgmax;
  float m = max_first<kArg, kN>(v, 0, arg);
  m = loop_max<kArg>(n, x, kN, m, arg);
  if constexpr (kS != Semiring::kLog) {
    return m;
  } else {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kN; ++j) s += expf(v[j] - m);
    return m + logf(loop_sum(n, x, m, s));
  }
}

// ---- the scan ----------------------------------------------------------------

// trans (N, C, C) [to, from]; init (N, C); dur (N, Km, C); emit (N, T, C);
// gamma, alphas (N, T, C) float32 or null; bp (N, T, C) int32 (kArgmax);
// offsets (N, ceil(T / kFold)) float32 (kLog).
// One block of 32 * kWarps threads per chain; kRow: the register bucket
// of the trans row (one warp; else 0); kTail: Km > kCarry, the carry's
// older rows in the shared-memory tail, their duration scores staged in
// shared memory (tail == 1) or read from global memory (tail == 2, where
// staging them would not fit a block).
template <Semiring kS, int kWarps, int kRow, bool kTail>
__global__ void __launch_bounds__(32 * kWarps, 1)
    scan_kernel(const float* __restrict__ trans, const float* __restrict__ init,
                const float* __restrict__ dur, const float* __restrict__ emit,
                float* __restrict__ gamma, float* __restrict__ alphas,
                int32_t* __restrict__ bp, float* __restrict__ offsets, int T,
                int C, int Km, int tail) {
  constexpr int kThreads = 32 * kWarps;
  constexpr bool kRowRegs = kRow > 0;
  static_assert(kRowRegs == (kWarps == 1), "a register row is one warp's");

  // the layout ops/hsmm_cuda.py `scan_instance` sizes
  extern __shared__ float smem[];
  float* next = smem;
  float* transT = nullptr;   // [from][to]           (2-4 warps)
  float* alpha_s = nullptr;  // [2][C]; one warp: [2][32], 16-byte aligned
  if constexpr (kRowRegs) {
    alpha_s = next;
    next += 64;
  } else {
    transT = next;
    alpha_s = transT + C * C;
    next = alpha_s + 2 * C;
  }
  float* window = next;                         // [kWindow][kThreads]
  float* tail_s = window + kWindow * kThreads;  // ring [Km - kCarry][C]
  const int n_tail = Km - kCarry;               // (kTail)
  float* dur_s = tail_s + n_tail * C;           // [Km - kCarry][C] (tail 1)

  const int n = blockIdx.x;
  const int c = threadIdx.x;
  const bool live = c < C;
  const int cc = live ? c : C - 1;
  const size_t plane = (size_t)n * T * C;
  trans += (size_t)n * C * C;
  dur += (size_t)n * Km * C;

  float tr[kRowRegs ? kRow : 1];  // trans[c, :], -inf past C (one warp)
  if constexpr (kRowRegs) {
#pragma unroll
    for (int j = 0; j < kRow; ++j) tr[j] = j < C ? trans[cc * C + j] : kNegInf;
  } else {
    for (int i = threadIdx.x; i < C * C; i += kThreads) {
      const int to = i / C;
      transT[(i - to * C) * C + to] = trans[i];
    }
  }
  float W[kCarry];  // W[j] = logical row j
  float D[kCarry];  // dur[j, c], -inf past Km
#pragma unroll
  for (int j = 0; j < kCarry; ++j) {
    D[j] = j < Km ? dur[j * C + cc] : kNegInf;
    W[j] = kBigNeg;
  }
  W[0] = init[(size_t)n * C + cc];
  const float* dur_g = dur + kCarry * C + cc;  // logical row kCarry + k
  const int n_blocks = (T + kFold - 1) / kFold;  // offsets' columns (kLog)
  if constexpr (kS == Semiring::kLog) {
    if (c == 0) offsets[(size_t)n * n_blocks] = 0.f;
  }
  if constexpr (kTail) {
    if (live) {
      for (int k = 0; k < n_tail; ++k) {
        tail_s[k * C + c] = kBigNeg;
        if (tail == 1) dur_s[k * C + c] = dur[(kCarry + k) * C + c];
      }
    }
  }

  // the emission column: slot t % kWindow of this thread's window holds
  // step t; the copy of step t + kWindow - 1 goes into the slot step t - 1
  // read (its value is already in cum, so the slot is free)
  const float* e_col = emit + plane + cc;
  float* my_window = window + c;
#pragma unroll
  for (int s = 0; s < kWindow - 1; ++s) {
    if (s < T) cp_async4(my_window + s * kThreads, e_col + (size_t)s * C);
    cp_async_commit();
  }
  __syncthreads();

  float cum = 0.f;
  int head = 0;  // the tail's physical row of logical row kCarry
  // the steps in blocks of kFold for the log semiring (the max semirings:
  // one block of T), the fold between two blocks
  constexpr bool kLogS = kS == Semiring::kLog;
  const int block = kLogS ? kFold : T;
  for (int t0 = 0; t0 < T; t0 += block) {
    const int t_end = min(t0 + block, T);
    for (int t = t0; t < t_end; ++t) {
      cp_async_wait<kWindow - 2>();  // step t's copy has landed
      cum += my_window[(t & (kWindow - 1)) * kThreads];
      const int ahead = t + kWindow - 1;
      if (ahead < T) {
        cp_async4(my_window + (ahead & (kWindow - 1)) * kThreads,
                  e_col + (size_t)ahead * C);
      }
      cp_async_commit();

      // the duration reduce
      int bd = 0;
      float a;
      if constexpr (kTail) {
        float v[kCarry];
#pragma unroll
        for (int j = 0; j < kCarry; ++j) v[j] = W[j] + D[j];
        auto ring = [&](int k) {
          int p = head + k;
          if (p >= n_tail) p -= n_tail;
          return tail_s[p * C + cc];
        };
        if (tail == 1) {
          a = reduce_split<kS, kCarry>(
              v, n_tail, [&](int k) { return ring(k) + dur_s[k * C + cc]; },
              bd);
        } else {
          a = reduce_split<kS, kCarry>(
              v, n_tail, [&](int k) { return ring(k) + dur_g[k * C]; }, bd);
        }
      } else {
        a = reduce_unrolled<kS, kCarry>([&](int j) { return W[j] + D[j]; }, bd);
      }
      const float alpha = a + cum;
      const size_t at = plane + (size_t)t * C + c;
      if (alphas != nullptr && live) alphas[at] = alpha;

      // the transition combine
      int bc = 0;
      float g;
      if constexpr (kRowRegs) {
        // alpha through a double-buffered shared row: one store, a warp
        // barrier, kRow / 4 broadcast 16-byte loads
        float* a_buf = alpha_s + (t & 1) * 32;
        a_buf[c] = alpha;
        __syncwarp();
        float av[kRow];
#pragma unroll
        for (int q = 0; q < kRow / 4; ++q) {
          const float4 f = reinterpret_cast<const float4*>(a_buf)[q];
          av[4 * q] = f.x;
          av[4 * q + 1] = f.y;
          av[4 * q + 2] = f.z;
          av[4 * q + 3] = f.w;
        }
        g = reduce_unrolled<kS, kRow>([&](int j) { return tr[j] + av[j]; }, bc);
      } else {
        float* a_buf = alpha_s + (t & 1) * C;
        if (live) a_buf[c] = alpha;
        __syncthreads();
        g = reduce_runtime<kS>(
            C, [&](int j) { return transT[j * C + cc] + a_buf[j]; }, bc);
      }
      if (live) {
        if constexpr (kS == Semiring::kArgmax) {
          bp[at] = bd * kCodeRadix + bc;
        } else if (gamma != nullptr) {
          gamma[at] = g;
        }
      }

      // this class's fold (see the top): after its alpha, before the push
      if constexpr (kLogS) {
        if (fabsf(cum) > kFoldLimit) {
#pragma unroll
          for (int j = 0; j < kCarry; ++j) W[j] += cum;
          if constexpr (kTail) {
            if (live) {
              for (int k = 0; k < n_tail; ++k) tail_s[k * C + c] += cum;
            }
          }
          cum = 0.f;
        }
      }

      // the push: the row leaving the registers becomes the tail's newest
      if constexpr (kTail) {
        head = head == 0 ? n_tail - 1 : head - 1;
        if (live) tail_s[head * C + c] = W[kCarry - 1];
      }
#pragma unroll
      for (int j = kCarry - 1; j > 0; --j) W[j] = W[j - 1];
      W[0] = g - cum;
    }

    // the fold between two blocks: s, the max over the live classes of the
    // last step's alpha row in the exchange (one warp: lanes past C stored
    // there too, and are skipped; the next store to this row comes after
    // the next step's barrier), cum and s into every carry row, the tail's
    // ring included, and s to the offsets
    if constexpr (kLogS) {
      if (t_end == T) break;
      const float* a_last = alpha_s + ((t_end - 1) & 1) * (kRowRegs ? 32 : C);
      float s = kNegInf;
      for (int j = 0; j < C; ++j) s = fmaxf(s, a_last[j]);
      s = s > 0.5f * kBigNeg ? s : 0.f;  // no live alpha: cum alone
#pragma unroll
      for (int j = 0; j < kCarry; ++j) W[j] = (W[j] + cum) - s;
      if constexpr (kTail) {
        if (live) {
          for (int k = 0; k < n_tail; ++k) {
            tail_s[k * C + c] = (tail_s[k * C + c] + cum) - s;
          }
        }
      }
      cum = 0.f;
      if (c == 0) offsets[(size_t)n * n_blocks + t_end / kFold] = s;
    }
  }
}

template <Semiring kS, int kWarps, int kRow, bool kTail>
int launch_instance(const void* trans, const void* init, const void* dur,
                    const void* emit, void* gamma, void* alphas, void* bp,
                    void* offsets, int N, int T, int C, int Km, int tail,
                    size_t smem, cudaStream_t stream) {
  auto kernel = scan_kernel<kS, kWarps, kRow, kTail>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<N, 32 * kWarps, smem, stream>>>(
      (const float*)trans, (const float*)init, (const float*)dur,
      (const float*)emit, (float*)gamma, (float*)alphas, (int32_t*)bp,
      (float*)offsets, T, C, Km, tail);
  return (int)cudaGetLastError();
}

// One launch of the instance (warps, row, tail: 0 none, 1 or 2 as the
// kernel's) with `smem` bytes of dynamic shared memory, as
// ops/hsmm_cuda.py `scan_instance` picks and sizes them for (C, Km);
// the log semiring needs `offsets`. Returns the CUDA error code (0 on
// success).
template <Semiring kS>
int launch_scan(const void* trans, const void* init, const void* dur,
                const void* emit, void* gamma, void* alphas, void* bp,
                void* offsets, int N, int T, int C, int Km, int warps, int row,
                int tail, int smem, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C < 1 || C > kMaxClasses || Km < 1 || 32 * warps < C ||
      (row > 0 && row < C) || (tail != 0) != (Km > kCarry) || tail < 0 ||
      tail > 2 || smem < 0 || (kS == Semiring::kLog && offsets == nullptr))
    return (int)cudaErrorInvalidValue;
  if (N == 0 || T == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream_ptr;
#define HSMM_SCAN_CASE(W, R, K)                                        \
  if (warps == W && row == R && (tail != 0) == K)                      \
    return launch_instance<kS, W, R, K>(trans, init, dur, emit, gamma, \
                                        alphas, bp, offsets, N, T, C, Km, \
                                        tail, (size_t)smem, s);
  HSMM_SCAN_CASE(1, 24, false)
  HSMM_SCAN_CASE(1, 32, false)
  HSMM_SCAN_CASE(1, 24, true)
  HSMM_SCAN_CASE(1, 32, true)
  HSMM_SCAN_CASE(2, 0, false)
  HSMM_SCAN_CASE(2, 0, true)
  HSMM_SCAN_CASE(4, 0, false)
  HSMM_SCAN_CASE(4, 0, true)
#undef HSMM_SCAN_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace hsmm_scan
