// Exact Viterbi spans: the max-semiring forward scan that writes packed
// backpointer codes, and the traceback that walks them into spans.
//
// Replaces action_segmentation_tpu/ops/hsmm_pallas.py `_viterbi_kernel`
// (launched through `_launch_viterbi` -> `_launch_scan` from
// `hsmm_viterbi_pallas`) and the jnp traceback of that function (a vmapped
// while-loop). The TPU kernel packs up to 8 videos onto 128 lanes with a
// block-diagonal transition matrix; here each video owns one thread block
// and one thread per class, as in csrc/hsmm_scan.cu. It is a source of its
// own, not a third instance of that file's scan template: the argmax
// changes the inner loop of both reductions (a first-maximum index in
// logical order beside the value), it stores an int32 plane the template
// has no slot for, and the traceback that reads that plane lives with it.
//
// Scan, per video n, with W the (Km, C) carry of the last Km boundary
// scores minus the emission prefix sum (logical row 0 starts as `init`):
//   cum        += emit[t]
//   alpha[c]    = max_j (W[j, c] + dur[j, c]) + cum[c]
//   bp_d[t, c]  = argmax_j of the same      (j = 0 is duration 1)
//   gamma[c]    = max_c' trans[c, c'] + alpha[c']
//   bp_c[t, c]  = argmax_c' of the same
//   bp[t, c]    = bp_d * 128 + bp_c          (JAX's packed int32 code)
//   push gamma - cum as W's new logical row 0
// Both argmaxes return the FIRST maximum, as jnp.argmax and torch.argmax
// do: j runs in logical duration order (the ring buffer's slots rotate, so
// the slot index is not the duration) and c' ascending, each with a
// strict `>`. Every float operation is the plain version's, in its order,
// so alphas and codes are bit-exact with it.
//
// Traceback, per video: every thread fills the spans row with -1, then
// thread 0 walks from (t = length, c = the best final class): d = bp_d + 1
// at (t - 1, c), s = t - d, spans[s] = c, and for s > 0 the previous class
// is bp_c at (s - 1, c). No copy to the host, no per-segment launch.
//
// Codes: bp_c < 128 because C <= 128, and bp_d < Km; the code stays in
// int32 for every Km the shared-memory carry admits (the same Km range as
// the other scans: C * C + 2 * Km * C + 2 * C floats in 227 KB).
//
// What bounds it: like the other scans, not bytes (emit in, alphas and
// codes out: about 4 MB at the serving shape) but the T dependent steps,
// each a chain of shared-memory reads and one block barrier. The design is
// csrc/hsmm_scan.cu's (one barrier per step, alpha double-buffered,
// the next emission loaded ahead); the argmax adds one compare and select
// per term. The traceback is a serial chain of dependent global reads,
// two per segment: it is latency-bound, one block per video.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kBigNeg = -1e9f;
constexpr int kLanes = 128;  // the code's class radix (JAX's LANES)

__global__ void viterbi_scan_kernel(const float* __restrict__ trans,
                                    const float* __restrict__ init,
                                    const float* __restrict__ dur,
                                    const float* __restrict__ emit,
                                    float* __restrict__ alphas,
                                    int32_t* __restrict__ bp, int T, int C,
                                    int Km) {
  extern __shared__ float smem[];
  float* transT = smem;            // [from][to]
  float* W = transT + C * C;       // ring buffer [Km][C]
  float* durs = W + Km * C;        // [Km][C]
  float* alpha_s = durs + Km * C;  // [2][C]

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
  int bd = 0;
  for (int t = 0; t < T; ++t) {
    float* a_buf = alpha_s + (t & 1) * C;
    if (live) {
      cum += e_next;
      if (t + 1 < T) e_next = e_ptr[(size_t)(t + 1) * C];
      float best = W[head * C + c] + durs[c];
      bd = 0;
      int p = head;
      for (int j = 1; j < Km; ++j) {
        if (++p == Km) p = 0;
        const float v = W[p * C + c] + durs[j * C + c];
        if (v > best) {
          best = v;
          bd = j;
        }
      }
      const float alpha = best + cum;
      a_buf[c] = alpha;
      alphas[plane + (size_t)t * C + c] = alpha;
    }
    __syncthreads();
    if (live) {
      float g = transT[c] + a_buf[0];
      int bc = 0;
      for (int cp = 1; cp < C; ++cp) {
        const float v = transT[cp * C + c] + a_buf[cp];
        if (v > g) {
          g = v;
          bc = cp;
        }
      }
      bp[plane + (size_t)t * C + c] = bd * kLanes + bc;
      head = head == 0 ? Km - 1 : head - 1;
      W[head * C + c] = g - cum;
    }
  }
}

__global__ void viterbi_traceback_kernel(const int32_t* __restrict__ bp,
                                         const int64_t* __restrict__ lengths,
                                         const int64_t* __restrict__ c_last,
                                         int64_t* __restrict__ spans, int T,
                                         int C) {
  const int b = blockIdx.x;
  int64_t* row = spans + (size_t)b * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x) row[t] = -1;
  __syncthreads();
  if (threadIdx.x != 0) return;
  const int32_t* plane = bp + (size_t)b * T * C;
  int t = (int)lengths[b];
  int c = (int)c_last[b];
  while (t > 0) {
    const int d = plane[(size_t)(t - 1) * C + c] / kLanes + 1;
    const int s = t - d;
    // a start before frame 0 can only come from an impossible (BIG_NEG)
    // path; it wraps like the reference's negative index and ends the walk
    const int w = s >= 0 ? s : s + T;
    if (w >= 0) row[w] = c;
    if (s > 0) c = plane[(size_t)(s - 1) * C + c] % kLanes;
    t = s;
  }
}

size_t scan_smem_bytes(int C, int Km) {
  return sizeof(float) * ((size_t)C * C + 2 * (size_t)Km * C + 2 * (size_t)C);
}

constexpr int kTracebackThreads = 256;

}  // namespace

extern "C" {

// Shared memory the scan needs for C classes and Km durations.
size_t hsmm_viterbi_scan_smem_bytes(int C, int Km) {
  return scan_smem_bytes(C, Km);
}

// trans (N, C, C) [to, from]; init (N, C); dur (N, Km, C); emit (N, T, C)
// float32; alphas (N, T, C) float32 out; bp (N, T, C) int32 out. All
// contiguous, on `device`. Launches on `stream`; returns the CUDA error
// code of the launch (0 on success).
int hsmm_viterbi_scan(const void* trans, const void* init, const void* dur,
                      const void* emit, void* alphas, void* bp, int N, int T,
                      int C, int Km, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0 || T == 0) return 0;
  const size_t smem = scan_smem_bytes(C, Km);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(viterbi_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = (C + 31) / 32 * 32;
  viterbi_scan_kernel<<<N, threads, smem, (cudaStream_t)stream>>>(
      (const float*)trans, (const float*)init, (const float*)dur,
      (const float*)emit, (float*)alphas, (int32_t*)bp, T, C, Km);
  return (int)cudaGetLastError();
}

// bp (N, T, C) int32 from hsmm_viterbi_scan; lengths (N,) int64, each in
// [1, T]; c_last (N,) int64, the best final class; spans (N, T) int64 out:
// the class at each span start, -1 elsewhere.
int hsmm_viterbi_traceback(const void* bp, const void* lengths,
                           const void* c_last, void* spans, int N, int T,
                           int C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0 || T == 0) return 0;
  viterbi_traceback_kernel<<<N, kTracebackThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)bp, (const int64_t*)lengths, (const int64_t*)c_last,
      (int64_t*)spans, T, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
