// Log-semiring duration-band sweep for the partition's gradient: the span
// posteriors' start, stop and per-duration masses and the suffix
// log-sum-exp, in one launch.
//
// Replaces action_segmentation_tpu/ops/hsmm_pallas.py
// `_band_grad_packed_kernel` (launched by `_band_grad_packed`). On the TPU
// whole lane-packed planes sit in VMEM, behind a VMEM gate with an
// unpacked jnp fallback past it; here the kernel streams T in row tiles
// from device memory, so one kernel serves any T.
//
// In the unpacked (B, T, C) layout, with G1m (B, T, C) = G1 - logZ,
// G2p (B, T2, C) where T2 >= T + Km (row e scores boundary e), and
// dur (B, Km, C) (row j scores duration j + 1), the span posterior of
// (start s, duration j + 1) is M[s, j] = exp(G1m[s] + dur[j] + G2p[s+j+1])
// and the kernel writes
//   qg[s] = LSE_j dur[j] + G2p[s + j + 1]   (running logaddexp)
//   sa[s] = sum_j M[s, j]                    (span-start mass)
//   st[i] = sum_j M[i - j - 1, j]            (span-stop mass)
//   lg[j] = sum_s M[s, j]                    (per-duration mass)
// in JAX's order of operations: r from Km - 1 down to 0, qg folded by
// jnp.logaddexp's formula (max + log1p(exp(-|a - b|))), each sum from 0.
//
// A block owns `rows` whole time rows of one video, one thread per (t, c).
// The stop mass of frame i gathers spans that started r + 1 rows earlier,
// possibly in an earlier block: the thread recomputes those M from G1m and
// its own G2p[i] (the same two adds and expf, so the same bits) instead of
// exchanging a halo. lg is a reduction over T across blocks: each block
// writes its per-(r, c) partial (a fixed-order sum over its rows through
// shared memory), and a second pass sums the partials in block order, so
// two runs give the same bits (no float atomics).
//
// What bounds it: device-memory bytes (G1m, G2p and three (B, T, C)
// outputs once each, about 7 MB at the serving shape) against about
// 2 Km expf per output; at the serving shape both are a few microseconds.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kBigNeg = -1e9f;
constexpr int kMaxThreads = 512;

int rows_per_block(int C) { return C >= kMaxThreads ? 1 : kMaxThreads / C; }

__device__ __forceinline__ float log_add_exp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__global__ void band_grad_kernel(const float* __restrict__ g1m,
                                 const float* __restrict__ g2p,
                                 const float* __restrict__ dur,
                                 float* __restrict__ qg,
                                 float* __restrict__ sa,
                                 float* __restrict__ st,
                                 float* __restrict__ lg_part, int T, int T2,
                                 int C, int Km, int rows) {
  extern __shared__ float m_s[];  // [rows][C]: this r's M of the block
  const int b = blockIdx.y;
  const int i = threadIdx.x;  // blockDim.x == rows * C
  const int c = i % C;
  const int t = blockIdx.x * rows + i / C;
  const bool live = t < T;
  const int f = t * C + c;
  g1m += (size_t)b * T * C;
  g2p += (size_t)b * T2 * C;
  dur += (size_t)b * Km * C;
  lg_part += (size_t)(b * gridDim.x + blockIdx.x) * Km * C;

  const float g1 = live ? g1m[f] : 0.f;
  const float g2_here = live ? g2p[f] : 0.f;  // boundary e = t
  float q = kBigNeg, start = 0.f, stop = 0.f;
  for (int r = Km - 1; r >= 0; --r) {
    const float d = dur[r * C + c];
    float m = 0.f;
    if (live) {
      // the span that starts at t with duration r + 1
      const float x = d + g2p[f + (r + 1) * C];
      q = log_add_exp(q, x);
      m = expf(g1 + x);
      start += m;
      // the span of duration r + 1 that stops at boundary t
      if (t - r - 1 >= 0) stop += expf(g1m[f - (r + 1) * C] + (d + g2_here));
    }
    m_s[i] = m;
    __syncthreads();
    if (i < C) {
      float sum = m_s[i];
      for (int row = 1; row < rows; ++row) sum += m_s[row * C + i];
      lg_part[r * C + i] = sum;
    }
    __syncthreads();
  }
  if (live) {
    const size_t o = (size_t)b * T * C + f;
    qg[o] = q;
    sa[o] = start;
    st[o] = stop;
  }
}

// lg[b, k] = sum over blocks, in block order, of lg_part[b, blk, k]
__global__ void lg_reduce_kernel(const float* __restrict__ lg_part,
                                 float* __restrict__ lg, int nblk, int KmC) {
  const int b = blockIdx.y;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= KmC) return;
  const float* p = lg_part + (size_t)b * nblk * KmC + k;
  float s = p[0];
  for (int j = 1; j < nblk; ++j) s += p[(size_t)j * KmC];
  lg[(size_t)b * KmC + k] = s;
}

}  // namespace

extern "C" {

// Thread blocks along T for C classes: the scratch `lg_part` holds
// (B, blocks, Km, C) floats.
int hsmm_band_grad_blocks(int T, int C) {
  const int rows = rows_per_block(C);
  return (T + rows - 1) / rows;
}

// g1m (B, T, C); g2p (B, T2, C) with T2 >= T + Km; dur (B, Km, C);
// qg, sa, st (B, T, C) out; lg (B, Km, C) out; lg_part scratch of
// B * hsmm_band_grad_blocks(T, C) * Km * C floats. All float32,
// contiguous, on `device`; C <= 1024. Launches on `stream`; returns the
// CUDA error code of the launches (0 on success).
int hsmm_band_grad(const void* g1m, const void* g2p, const void* dur,
                   void* qg, void* sa, void* st, void* lg, void* lg_part,
                   int B, int T, int T2, int C, int Km, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || T == 0 || C == 0) return 0;
  const int rows = rows_per_block(C);
  const int nblk = hsmm_band_grad_blocks(T, C);
  const size_t smem = sizeof(float) * (size_t)rows * C;
  band_grad_kernel<<<dim3(nblk, B), rows * C, smem, (cudaStream_t)stream>>>(
      (const float*)g1m, (const float*)g2p, (const float*)dur, (float*)qg,
      (float*)sa, (float*)st, (float*)lg_part, T, T2, C, Km, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess || Km == 0) return (int)err;
  const int KmC = Km * C;
  const int threads = 256;
  lg_reduce_kernel<<<dim3((KmC + threads - 1) / threads, B), threads, 0,
                     (cudaStream_t)stream>>>((const float*)lg_part,
                                             (float*)lg, nblk, KmC);
  return (int)cudaGetLastError();
}

}  // extern "C"
