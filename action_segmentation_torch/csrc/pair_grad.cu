// The partition's transition cotangent: the pair posteriors of every
// interior boundary summed over frames, in one launch,
//
//   out[b, i, j] = sum_{t = 1 .. L_b - 1} exp(((X[b, t, j] + trans[b, i, j])
//                                               + Y[b, t, i]) - Z[b])
//
// with X the forward alphas shifted one frame (the prefix mass before the
// boundary, in class j), Y the suffix mass from the boundary without the
// transition (in class i) and Z the partition (0 where the backward
// anchors X and Y per chunk instead; hsmm_grad._pair_inputs).
//
// Replaces no Pallas kernel: on the TPU, XLA fuses the broadcast of
// action_segmentation_tpu/ops/hsmm_grad.py `_fb_bwd_packed` (the pair
// exponent, :246-256) into its sum over frames, so the (B, T, C, C)
// exponent is never held. The port's torch form of the same expression
// held it, 4 B T C^2 bytes (8.6 GB at 342 classes and 18 videos of 1,024
// frames); this kernel keeps each term in a register.
//
// trans stays inside the exponential, as JAX's comment (:236-242) says:
// the whole exponent is a log pair posterior (<= ~0, representable under
// BIG_NEG masks), while exp(trans) pulled out overflows where a masked
// transition separates a dominant class from the class it cannot reach.
// So this is no matrix product; a tensor-core form would need a rescaling
// that keeps that guarantee. Each exponent is formed in the plain
// version's order, ((X + trans) + Y) - Z, each add rounded as written
// (__fadd_rn, so that no add contracts with expf's last multiply): the
// terms are the plain version's bits where expf is torch's, and only the
// sum over frames is associated otherwise. Regrouped as X + (trans - Z)
// + Y, a term at the D=300 emission scale (|X|, |Z| ~ 1e4 over 64
// frames) would move by an ulp of 1e4 in its exponent, far past the
// tolerance the card holds the kernel to.
//
// A block owns one video, a tile of 32 x 32 (i, j) pairs and a run of
// frames; 256 threads, thread (tx, ty) the pairs (4 ty + k, tx), k < 4.
// Each pass stages 32 frames of the tile's X columns (j) and Y columns (i)
// in shared memory (one 128-byte row a frame each), then every thread adds
// its four terms a frame into a pass sum, and the pass sum into its total:
// two levels, so that no float32 sum runs over more than 32 frames or
// over more than ceil(T / 32) passes. `hsmm_cuda.pair_grad_tile` picks
// the runs a video (each of at least 32 frames, their partials within one
// (B, T, C) plane) that cost the least in rounds of the card's resident
// block slots: 29 runs at 19 classes and 18 videos of 1,024 frames (522
// blocks for 528 slots), 2 at 342 classes (one run would leave 2,178
// blocks for 528 slots, five rounds, the last nearly empty), 1 at 1,577
// (45,000 blocks). Past one run each block writes its partial sums,
// fences, and one thread takes a ticket on the (video, tile)'s counter;
// the block that takes the last ticket sums the partials in run order (no
// float atomics: two runs give the same bits) and sets the counter back to
// 0 for the next launch.
//
// What bounds it: the special-function unit. A term takes one expf, whose
// MUFU.EX2 issues at 16 a clock per SM: B (L - 1) C^2 / (16 x 132 x clock)
// s, 0.52 ms at 342 classes and 18 videos of 1,024 frames. The bytes are
// X, Y, trans and the output once, 0.02 ms there. A term issues about a
// dozen instructions (the three adds, expf's range reduction around its
// MUFU, the sum's add), so the schedulers' issue sits above the MUFU
// bound; the tile reads X and Y once a pass for 1,024 terms a thread row.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kTile = 32;             // a tile's classes on each side
constexpr int kRowsY = 8;             // threadIdx.y
constexpr int kPairs = kTile / kRowsY;  // the i's a thread owns: 4
constexpr int kThreads = kTile * kRowsY;
constexpr int kFrames = 32;           // the frames a pass stages
constexpr int kMaxDevices = 64;

// At most 64 registers a thread, so that four blocks of 256 threads fit an
// SM: hsmm_cuda.pair_grad_tile assumes it (PAIR_GRAD_REGS).
__global__ void __launch_bounds__(kThreads, 4)
    pair_grad_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ trans,
                     const float* __restrict__ z,
                     const int* __restrict__ lengths, float* __restrict__ out,
                     float* __restrict__ part,
                     unsigned int* __restrict__ tickets, int T, int C,
                     int sb, int si, int sj, int frames) {
  __shared__ __align__(16) float xs[kFrames][kTile];
  __shared__ __align__(16) float ys[kFrames][kTile];
  __shared__ bool last;
  const int sides = (C + kTile - 1) / kTile;
  const int i_tile = (blockIdx.x / sides) * kTile;
  const int j_tile = (blockIdx.x % sides) * kTile;
  const int run = blockIdx.y;
  const int runs = gridDim.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int j = j_tile + tx;
  const int i0 = i_tile + kPairs * ty;
  const bool live_j = j < C;

  const float zb = z[b];
  float tr[kPairs], acc[kPairs];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int i = i0 + k;
    tr[k] = live_j && i < C ? trans[(size_t)b * sb + (size_t)i * si + (size_t)j * sj]
                            : 0.f;
    acc[k] = 0.f;
  }
  // the interior boundaries t = 1 .. L - 1 within the run's frames
  const int L = min(max(lengths[b], 1), T);
  const int t_lo = max(run * frames, 1);
  const int t_hi = min(run * frames + frames, L);
  const float* xb = x + (size_t)b * T * C;
  const float* yb = y + (size_t)b * T * C;
  for (int f0 = t_lo; f0 < t_hi; f0 += kFrames) {
    const int nf = min(kFrames, t_hi - f0);
    __syncthreads();  // the pass before has read the stage
    for (int k = tid; k < nf * kTile; k += kThreads) {
      const int f = k / kTile, c = k % kTile;
      const size_t row = (size_t)(f0 + f) * C;
      xs[f][c] = j_tile + c < C ? xb[row + j_tile + c] : 0.f;
      ys[f][c] = i_tile + c < C ? yb[row + i_tile + c] : 0.f;
    }
    __syncthreads();
    float pass[kPairs] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int f = 0; f < nf; ++f) {
      const float xv = xs[f][tx];
      const float4 yv = *reinterpret_cast<const float4*>(&ys[f][kPairs * ty]);
      const float yk[kPairs] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const float e = __fsub_rn(__fadd_rn(__fadd_rn(xv, tr[k]), yk[k]), zb);
        pass[k] = __fadd_rn(pass[k], expf(e));
      }
    }
#pragma unroll
    for (int k = 0; k < kPairs; ++k) acc[k] = __fadd_rn(acc[k], pass[k]);
  }

  const size_t plane = (size_t)C * C;
  if (runs == 1) {
#pragma unroll
    for (int k = 0; k < kPairs; ++k)
      if (live_j && i0 + k < C) out[b * plane + (size_t)(i0 + k) * C + j] = acc[k];
    return;
  }
  // the run's partial, then the (video, tile)'s runs summed by the block
  // that comes last
  float* p = part + ((size_t)b * runs + run) * plane;
#pragma unroll
  for (int k = 0; k < kPairs; ++k)
    if (live_j && i0 + k < C) p[(size_t)(i0 + k) * C + j] = acc[k];
  __threadfence();
  __syncthreads();  // every partial of the block is written and fenced
  if (tid == 0) {
    unsigned int* ticket = tickets + (size_t)b * gridDim.x + blockIdx.x;
    last = atomicAdd(ticket, 1u) == (unsigned int)runs - 1;
    if (last) {
      *ticket = 0;  // every run has taken its ticket
      __threadfence();
    }
  }
  __syncthreads();
  if (!last) return;
  const float* q = part + (size_t)b * runs * plane;
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    if (!live_j || i0 + k >= C) continue;
    const size_t at = (size_t)(i0 + k) * C + j;
    float s = __ldcg(q + at);
    for (int r = 1; r < runs; ++r) s += __ldcg(q + (size_t)r * plane + at);
    out[b * plane + at] = s;
  }
}

}  // namespace

extern "C" {

// x, y (B, T, C) float32, contiguous; trans (B, C, C) float32 read through
// its element strides (sb, si, sj): a stride-0 expanded table is read in
// place; z (B,) float32; lengths (B,) int32; out (B, C, C) float32. part:
// scratch of B * runs * C * C floats where runs = ceil(T / frames) > 1
// (else unused, may be null); tickets: B * ceil(C / 32)^2 uint32 counters,
// all 0 (each launch leaves them 0; unused, may be null, for one run).
// `frames`: a run's frames, from hsmm_cuda.pair_grad_tile. Launches one
// kernel on `stream`; returns the CUDA error code (cudaErrorInvalidValue
// for arguments it does not take; 0 on success).
int hsmm_pair_grad(const void* x, const void* y, const void* trans,
                   const void* z, const void* lengths, void* out, void* part,
                   void* tickets, int B, int T, int C, int sb, int si, int sj,
                   int frames, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 0 || T < 0 || C < 0 || frames < 1 || sb < 0 || si < 0 || sj < 0 ||
      device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0) return 0;
  const long sides = (C + kTile - 1) / kTile;
  const long runs = T > frames ? (T + (long)frames - 1) / frames : 1;
  if (B > 65535 || runs > 65535 || sides * sides > INT_MAX ||
      (runs > 1 && (!part || !tickets)))
    return (int)cudaErrorInvalidValue;
  pair_grad_kernel<<<dim3((unsigned int)(sides * sides), (unsigned int)runs,
                          B),
                     dim3(kTile, kRowsY), 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (const float*)trans, (const float*)z,
      (const int*)lengths, (float*)out, (float*)part, (unsigned int*)tickets,
      T, C, sb, si, sj, frames);
  return (int)cudaGetLastError();
}

}  // extern "C"
