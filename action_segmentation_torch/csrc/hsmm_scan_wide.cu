// The banded semi-Markov forward scan for a DP wider than the narrow
// template's 128 classes (128 < C <= 1024): one template, three instances.
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
//
// Layout: one block per chain, one thread per class (C rounded up to
// whole warps; the threads past C only cross the barriers). Thread c owns
// column c of the carry: a ring of Km rows whose head rotates, in shared
// memory where it fits beside the alpha rows, else in a global scratch
// the wrapper allocates (the same code through a generic pointer; only
// thread c touches its column, so the ring needs no barrier). Its
// duration scores are read from global memory (a column of Km floats,
// L1-resident). alpha goes through a double-buffered shared row, one
// barrier a step. The transition combine reads trans transposed
// ([from][to], made by the wrapper) so that a warp's loads of one c' are
// one coalesced line; it is 4 C^2 bytes a chain (468 KB at C = 342), too
// large for shared memory, and stays in L2 across the steps.
//
// What bounds it: like the narrow scans, the T dependent steps. A step is
// one serial reduction of C terms on each thread (two passes in the log
// semiring: the max, then the ordered sum of expf), each term an L2 load
// of trans, a broadcast shared load of alpha and a compare or an expf;
// at C = 342 and 11 warps a block that is thousands of issue slots a step,
// far above the step's bytes and operations at the card's peaks. Speed is
// for a later change: this is the simple form.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <limits>

namespace {

constexpr float kBigNeg = -1e9f;
constexpr float kNegInf = -std::numeric_limits<float>::infinity();
constexpr int kMaxClasses = 1024;
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic shared memory

// kViterbi: alphas and codes (K6's function); kLog: gamma and alphas
// (K2-log's); kForward: alphas only (K1's)
enum class Scan { kViterbi, kLog, kForward };

// trans_t (N, C, C) [from][to]; init (N, C); dur (N, Km, C); emit (N, T, C);
// gamma (kLog), alphas (N, T, C) float32; bp (N, T, C) int32 (kViterbi);
// ring_g (N, Km, C) float32 scratch, or null for the ring in shared memory.
template <Scan kS>
__global__ void __launch_bounds__(kMaxClasses, 1)
    wide_scan_kernel(const float* __restrict__ trans_t,
                     const float* __restrict__ init,
                     const float* __restrict__ dur,
                     const float* __restrict__ emit, float* __restrict__ gamma,
                     float* __restrict__ alphas, int32_t* __restrict__ bp,
                     float* __restrict__ ring_g, int T, int C, int Km,
                     int radix) {
  extern __shared__ float smem[];
  float* const alpha_s = smem;  // [2][C]
  const int n = blockIdx.x;
  const int c = threadIdx.x;
  const bool live = c < C;
  float* const ring =
      ring_g != nullptr ? ring_g + (size_t)n * Km * C : smem + 2 * C;
  const float* const tr = trans_t + (size_t)n * C * C + c;  // column c
  const float* const du = dur + (size_t)n * Km * C + c;
  const size_t plane = (size_t)n * T * C;
  const float* const e_col = emit + plane + c;

  // the ring: logical row j at physical (head + j) mod Km
  if (live) {
    ring[c] = init[(size_t)n * C + c];
    for (int j = 1; j < Km; ++j) ring[j * C + c] = kBigNeg;
  }
  float e_next = live && T > 0 ? e_col[0] : 0.f;
  float cum = 0.f;
  int head = 0;
  for (int t = 0; t < T; ++t) {
    float* const a_buf = alpha_s + (t & 1) * C;
    int bd = 0;
    if (live) {
      cum += e_next;
      if (t + 1 < T) e_next = e_col[(size_t)(t + 1) * C];
      // the duration reduce, j in logical order
      float m = kNegInf;
      int p = head;
      for (int j = 0; j < Km; ++j) {
        const float x = ring[p * C + c] + du[j * C];
        if constexpr (kS == Scan::kViterbi) {
          if (x > m) {
            m = x;
            bd = j;
          }
        } else {
          m = fmaxf(m, x);
        }
        p = p + 1 == Km ? 0 : p + 1;
      }
      float a = m;
      if constexpr (kS != Scan::kViterbi) {
        float s = 0.f;
        p = head;
        for (int j = 0; j < Km; ++j) {
          s += expf(ring[p * C + c] + du[j * C] - m);
          p = p + 1 == Km ? 0 : p + 1;
        }
        a = m + logf(s);
      }
      const float alpha = a + cum;
      alphas[plane + (size_t)t * C + c] = alpha;
      a_buf[c] = alpha;
    }
    __syncthreads();
    if (!live) continue;

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
    const size_t at = plane + (size_t)t * C + c;
    if constexpr (kS == Scan::kViterbi) {
      bp[at] = bd * radix + bc;
    } else if constexpr (kS == Scan::kLog) {
      gamma[at] = g;
    }
    // the push: the oldest row's slot becomes logical row 0
    head = head == 0 ? Km - 1 : head - 1;
    ring[head * C + c] = g - cum;
  }
}

template <Scan kS>
int launch(const void* trans_t, const void* init, const void* dur,
           const void* emit, void* gamma, void* alphas, void* bp, void* ring,
           int N, int T, int C, int Km, int radix, int smem, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long need = 4L * (2L * C + (ring == nullptr ? (long)Km * C : 0L));
  if (C < 1 || C > kMaxClasses || Km < 1 || smem < need || smem > kMaxSmem ||
      (kS == Scan::kViterbi && (radix < C || (long)Km * radix > INT_MAX)))
    return (int)cudaErrorInvalidValue;
  if (N == 0 || T == 0) return 0;
  auto kernel = wide_scan_kernel<kS>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = (C + 31) / 32 * 32;
  kernel<<<N, threads, smem, (cudaStream_t)stream>>>(
      (const float*)trans_t, (const float*)init, (const float*)dur,
      (const float*)emit, (float*)gamma, (float*)alphas, (int32_t*)bp,
      (float*)ring, T, C, Km, radix);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// trans_t (N, C, C) [from][to] (trans transposed); init (N, C); dur (N, Km,
// C); emit (N, T, C); alphas (N, T, C) out; all float32. bp (N, T, C)
// int32 out, bp = bp_d * radix + bp_c (radix >= C, Km * radix in int32).
// ring: (N, Km, C) float32 scratch, or null for the ring in shared memory.
// smem: the dynamic shared memory in bytes, 2 * C floats plus, with no
// scratch, the ring's Km * C (ops/hsmm_cuda.py `wide_scan_instance`). All
// contiguous, on `device`, 1 <= C <= 1024. Launches on `stream`; returns
// the CUDA error code (cudaErrorInvalidValue for arguments it does not
// take; 0 on success).
int hsmm_wide_viterbi_scan(const void* trans_t, const void* init,
                           const void* dur, const void* emit, void* alphas,
                           void* bp, void* ring, int N, int T, int C, int Km,
                           int radix, int smem, int device, void* stream) {
  return launch<Scan::kViterbi>(trans_t, init, dur, emit, nullptr, alphas, bp,
                                ring, N, T, C, Km, radix, smem, device,
                                stream);
}

// The log semiring with the same inputs: gamma and alphas (N, T, C) out.
int hsmm_wide_log_scan(const void* trans_t, const void* init, const void* dur,
                       const void* emit, void* gamma, void* alphas, void* ring,
                       int N, int T, int C, int Km, int smem, int device,
                       void* stream) {
  return launch<Scan::kLog>(trans_t, init, dur, emit, gamma, alphas, nullptr,
                            ring, N, T, C, Km, 0, smem, device, stream);
}

// The log semiring's alphas alone (the partition's primal).
int hsmm_wide_forward_scan(const void* trans_t, const void* init,
                           const void* dur, const void* emit, void* alphas,
                           void* ring, int N, int T, int C, int Km, int smem,
                           int device, void* stream) {
  return launch<Scan::kForward>(trans_t, init, dur, emit, nullptr, alphas,
                                nullptr, ring, N, T, C, Km, 0, smem, device,
                                stream);
}

}  // extern "C"
