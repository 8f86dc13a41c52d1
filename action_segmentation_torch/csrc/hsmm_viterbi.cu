// Exact Viterbi spans: the max-semiring forward scan that writes packed
// backpointer codes, and the traceback that walks them into spans.
//
// Replaces action_segmentation_tpu/ops/hsmm_pallas.py `_viterbi_kernel`
// (launched through `_launch_viterbi` -> `_launch_scan` from
// `hsmm_viterbi_pallas`) and the jnp traceback of that function (a vmapped
// while-loop). The TPU kernel packs up to 8 videos onto 128 lanes with a
// block-diagonal transition matrix; here each video owns one thread block
// and one thread per class.
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
// do: j in logical duration order and c' ascending. The scan is the
// argmax instance of csrc/hsmm_scan_core.cuh's template (the one the
// gamma scans of csrc/hsmm_scan.cu use): the register carry's index is
// the logical duration, the max is a tree of fmaxf, and the code's index
// is the least one whose term equals that max, which is the first
// maximum. Every float operation is the plain version's, so alphas and
// codes are bit-exact with it.
//
// Traceback, per video: every thread fills the spans row with -1, then
// thread 0 walks from (t = length, c = the best final class): d = bp_d + 1
// at (t - 1, c), s = t - d, spans[s] = c, and for s > 0 the previous class
// is bp_c at (s - 1, c). No copy to the host, no per-segment launch.
//
// Codes: bp_c < 128 because C <= 128, and bp_d < Km; the code stays in
// int32 for every Km the shared-memory tail admits.
//
// What bounds it: like the gamma scans, not bytes (emit in, alphas and
// codes out: about 4 MB at the serving shape) but the T dependent steps,
// each one chain of dependent instructions; the earlier shared-memory
// layout with a compare-select chain per term took 0.87 us a step. The
// template's design (csrc/hsmm_scan_core.cuh: the carry's newest 24
// rows, their dur and the trans row in registers, alpha through one
// shared row, branch-free trees, the emissions staged 15 steps ahead)
// keeps the argmax off the step's
// dependent chain: the index search reads the max but feeds only the
// code's store. What it adds is instructions to issue (one warp issues
// at most one a cycle). The traceback is a serial chain of dependent
// global reads, two per segment: it is latency-bound, one block per
// video.
//
// ptxas (-Xptxas -v, sm_90a): the serving instance (one warp, row 24,
// no tail) takes 133 registers, no spills; chip_smoke.py's build phase
// prints every instance.

#include "hsmm_scan_core.cuh"

namespace {

constexpr int kLanes = hsmm_scan::kCodeRadix;

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

constexpr int kTracebackThreads = 256;

}  // namespace

extern "C" {

// trans (N, C, C) [to, from]; init (N, C); dur (N, Km, C); emit (N, T, C)
// float32; alphas (N, T, C) float32 out; bp (N, T, C) int32 out. All
// contiguous, on `device`. (warps, row, tail) name the template's
// instance and smem its dynamic shared memory in bytes, as
// ops/hsmm_cuda.py `scan_instance` gives them. Launches on `stream`;
// returns the CUDA error code of the launch (0 on success).
int hsmm_viterbi_scan(const void* trans, const void* init, const void* dur,
                      const void* emit, void* alphas, void* bp, int N, int T,
                      int C, int Km, int warps, int row, int tail, int smem,
                      int device, void* stream) {
  return hsmm_scan::launch_scan<hsmm_scan::Semiring::kArgmax>(
      trans, init, dur, emit, nullptr, alphas, bp, N, T, C, Km, warps, row,
      tail, smem, device, stream);
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
