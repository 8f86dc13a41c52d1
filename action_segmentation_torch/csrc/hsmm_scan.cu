// Banded semi-Markov forward scan that emits the gamma plane, in the max
// or the log semiring.
//
// Replaces action_segmentation_tpu/ops/hsmm_pallas.py `_gamma_kernel`
// (launched through `_launch_scan` from `_scan_packed_fb`): the max
// instance serves decode, the log instance with the alphas output serves
// the training forward (`_fb_fwd` in ops/hsmm_grad.py). The log instance
// with the gamma store skipped (`hsmm_forward_scan_log`) replaces
// `_forward_kernel`, the alphas-only scan behind the partition's primal
// (`hsmm_alphas_pallas`). The TPU kernels pack up to 8 videos onto 128
// lanes with a block-diagonal transition matrix and inject each reversed
// chain's start mid-buffer; here every chain (forward or time-reversed,
// stacked on the batch axis by the caller) starts at t = 0 and owns one
// thread block, so neither the packing nor the injection exists.
//
// Per chain n, with W the (Km, C) carry of the last Km boundary scores
// minus the emission prefix sum (row 0 starts as `init`):
//   cum       += emit[t]
//   alpha[c]   = reduce_j (W[j, c] + dur[j, c]) + cum[c]
//   gamma[t,c] = reduce_c' trans[c, c'] + alpha[c']
//   push gamma - cum as W's new row 0 (the oldest row drops out)
// where reduce is JAX's `_semiring_reduce`: the max, or in the log
// semiring m + log(sum(exp(x - m))) with m the max and the sum taken in
// index order (j, then c'). expf/logf, no fast math, so the kernel and its
// plain version differ by libm ulps at most.
//
// What bounds it: not bytes or FLOPs (about 6 MB and 55 M operations at
// the serving shape, a couple of microseconds at the card's peaks) but the
// T dependent steps, each a chain of shared-memory reads and one block
// barrier; the log semiring adds a second pass and one expf per term. The
// design keeps every step's working set on chip: thread c holds its
// running prefix sum in a register and its W column in shared memory as a
// ring buffer (a head index rotates; nothing shifts); `dur` and the
// transposed `trans` sit in shared memory so neighbouring threads read
// neighbouring words; alpha is double-buffered in shared memory so each
// step needs one barrier, not two; the next step's emission is loaded
// before the current step's reductions so its latency hides behind them.
//
// BIG_NEG (-1e9) stands for an impossible score; -inf is never used
// (-inf - -inf is NaN). A column that is all BIG_NEG reduces to
// BIG_NEG + log(n) in the log semiring, as in JAX.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kBigNeg = -1e9f;

template <bool kLog>
__global__ void gamma_scan_kernel(const float* __restrict__ trans,
                                  const float* __restrict__ init,
                                  const float* __restrict__ dur,
                                  const float* __restrict__ emit,
                                  float* __restrict__ gamma,
                                  float* __restrict__ alphas, int T, int C,
                                  int Km) {
  extern __shared__ float smem[];
  float* transT = smem;              // [from][to]
  float* W = transT + C * C;         // ring buffer [Km][C]
  float* durs = W + Km * C;          // [Km][C]
  float* alpha_s = durs + Km * C;    // [2][C]

  const int n = blockIdx.x;
  const int c = threadIdx.x;
  const bool live = c < C;
  const size_t plane = (size_t)n * T * C;

  trans += (size_t)n * C * C;
  for (int i = threadIdx.x; i < C * C; i += blockDim.x) {
    const int to = i / C;
    const int from = i - to * C;
    transT[from * C + to] = trans[i];
  }
  if (live) {
    for (int j = 0; j < Km; ++j) {
      durs[j * C + c] = dur[(size_t)n * Km * C + j * C + c];
      W[j * C + c] = j == 0 ? init[(size_t)n * C + c] : kBigNeg;
    }
  }
  __syncthreads();

  const float* e_ptr = emit + plane + c;
  float e_next = (live && T > 0) ? e_ptr[0] : 0.f;
  float cum = 0.f;
  int head = 0;  // physical row of logical row 0
  for (int t = 0; t < T; ++t) {
    float* a_buf = alpha_s + (t & 1) * C;
    if (live) {
      cum += e_next;
      if (t + 1 < T) e_next = e_ptr[(size_t)(t + 1) * C];
      float acc = W[head * C + c] + durs[c];
      int p = head;
      for (int j = 1; j < Km; ++j) {
        if (++p == Km) p = 0;
        acc = fmaxf(acc, W[p * C + c] + durs[j * C + c]);
      }
      if (kLog) {
        float s = 0.f;
        p = head;
        for (int j = 0; j < Km; ++j) {
          s += expf(W[p * C + c] + durs[j * C + c] - acc);
          if (++p == Km) p = 0;
        }
        acc = acc + logf(s);
      }
      const float alpha = acc + cum;
      a_buf[c] = alpha;
      if (alphas != nullptr) alphas[plane + (size_t)t * C + c] = alpha;
    }
    __syncthreads();
    if (live) {
      float g = transT[c] + a_buf[0];
      for (int cp = 1; cp < C; ++cp) {
        g = fmaxf(g, transT[cp * C + c] + a_buf[cp]);
      }
      if (kLog) {
        float s = 0.f;
        for (int cp = 0; cp < C; ++cp) {
          s += expf(transT[cp * C + c] + a_buf[cp] - g);
        }
        g = g + logf(s);
      }
      if (gamma != nullptr) gamma[plane + (size_t)t * C + c] = g;
      head = head == 0 ? Km - 1 : head - 1;
      W[head * C + c] = g - cum;
    }
  }
}

// Shared memory the kernel needs for C classes and Km durations.
size_t smem_bytes(int C, int Km) {
  return sizeof(float) * ((size_t)C * C + 2 * (size_t)Km * C + 2 * (size_t)C);
}

template <bool kLog>
int launch(const void* trans, const void* init, const void* dur,
           const void* emit, void* gamma, void* alphas, int N, int T, int C,
           int Km, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0 || T == 0) return 0;
  const size_t smem = smem_bytes(C, Km);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(gamma_scan_kernel<kLog>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = (C + 31) / 32 * 32;
  gamma_scan_kernel<kLog><<<N, threads, smem, (cudaStream_t)stream>>>(
      (const float*)trans, (const float*)init, (const float*)dur,
      (const float*)emit, (float*)gamma, (float*)alphas, T, C, Km);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for C classes and Km durations.
size_t hsmm_gamma_scan_smem_bytes(int C, int Km) { return smem_bytes(C, Km); }

// trans (N, C, C) [to, from]; init (N, C); dur (N, Km, C); emit (N, T, C);
// gamma (N, T, C) out; alphas (N, T, C) out or null. All float32,
// contiguous, on `device`. Launches on `stream`; returns the CUDA error
// code of the launch (0 on success).
int hsmm_gamma_scan_max(const void* trans, const void* init, const void* dur,
                        const void* emit, void* gamma, void* alphas, int N,
                        int T, int C, int Km, int device, void* stream) {
  return launch<false>(trans, init, dur, emit, gamma, alphas, N, T, C, Km,
                       device, stream);
}

// The log-semiring instance with the same arguments (alphas may be null).
int hsmm_gamma_scan_log(const void* trans, const void* init, const void* dur,
                        const void* emit, void* gamma, void* alphas, int N,
                        int T, int C, int Km, int device, void* stream) {
  return launch<true>(trans, init, dur, emit, gamma, alphas, N, T, C, Km,
                      device, stream);
}

// The forward-only form (the partition's primal): the log-semiring scan
// writing alphas (N, T, C) and no gamma plane.
int hsmm_forward_scan_log(const void* trans, const void* init,
                          const void* dur, const void* emit, void* alphas,
                          int N, int T, int C, int Km, int device,
                          void* stream) {
  return launch<true>(trans, init, dur, emit, nullptr, alphas, N, T, C, Km,
                      device, stream);
}

}  // extern "C"
