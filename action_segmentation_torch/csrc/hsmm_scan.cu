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
// The recurrence and the kernel are csrc/hsmm_scan_core.cuh's template
// (shared with K6 in csrc/hsmm_viterbi.cu); this file instantiates it for
// the max and log semirings. The log instances fold their carry every 64
// steps and write the chain's offsets beside the planes (the template's
// header says how).
//
// What bounds it: not bytes or FLOPs (about 6 MB and 55 M operations at
// the serving shape, a couple of microseconds at the card's peaks) but
// the T dependent steps, each one chain of dependent instructions: the
// duration reduce, the alpha exchange, the transition combine and the
// push. The earlier layout (W, dur, trans and alpha in shared memory,
// runtime loops, one compare per term in a serial chain) took 1.10 us
// (max) and 2.03 us (log) a step on the H100. The template keeps a step's
// working set in registers (the carry's newest 24 rows and their duration
// scores; at C <= 32 the trans row in 24 or 32), exchanges alpha through
// one shared row behind a warp barrier, reduces in branch-free trees over
// the buckets, and stages the emissions 15 steps ahead with cp.async.
// Rows past 24 go to a shared-memory tail reduced in groups of 16. The
// log semiring's remaining chain is its expf issue and the ordered sum.
//
// ptxas (-Xptxas -v, sm_90a): the serving instances (one warp, row 24,
// no tail) take 118 (max) and 166 (log) registers, no spills;
// chip_smoke.py's build phase prints every instance's registers and
// spills.

#include "hsmm_scan_core.cuh"

using hsmm_scan::Semiring;
using hsmm_scan::launch_scan;

extern "C" {

// trans (N, C, C) [to, from]; init (N, C); dur (N, Km, C); emit (N, T, C);
// gamma (N, T, C) out; alphas (N, T, C) out or null. All float32,
// contiguous, on `device`. (warps, row, tail) name the template's
// instance and smem its dynamic shared memory in bytes, as
// ops/hsmm_cuda.py `scan_instance` gives them. Launches on `stream`;
// returns the CUDA error code of the launch (0 on success).
int hsmm_gamma_scan_max(const void* trans, const void* init, const void* dur,
                        const void* emit, void* gamma, void* alphas, int N,
                        int T, int C, int Km, int warps, int row, int tail,
                        int smem, int device, void* stream) {
  return launch_scan<Semiring::kMax>(trans, init, dur, emit, gamma, alphas,
                                     nullptr, nullptr, N, T, C, Km, warps, row,
                                     tail, smem, device, stream);
}

// The log-semiring instance with the same arguments (alphas may be null)
// and offsets (N, ceil(T / 64)) float32 out.
int hsmm_gamma_scan_log(const void* trans, const void* init, const void* dur,
                        const void* emit, void* gamma, void* alphas,
                        void* offsets, int N, int T, int C, int Km, int warps,
                        int row, int tail, int smem, int device,
                        void* stream) {
  return launch_scan<Semiring::kLog>(trans, init, dur, emit, gamma, alphas,
                                     nullptr, offsets, N, T, C, Km, warps, row,
                                     tail, smem, device, stream);
}

// The forward-only form (the partition's primal): the log-semiring scan
// writing alphas (N, T, C) and offsets, and no gamma plane.
int hsmm_forward_scan_log(const void* trans, const void* init,
                          const void* dur, const void* emit, void* alphas,
                          void* offsets, int N, int T, int C, int Km,
                          int warps, int row, int tail, int smem, int device,
                          void* stream) {
  return launch_scan<Semiring::kLog>(trans, init, dur, emit, nullptr, alphas,
                                     nullptr, offsets, N, T, C, Km, warps, row,
                                     tail, smem, device, stream);
}

}  // extern "C"
