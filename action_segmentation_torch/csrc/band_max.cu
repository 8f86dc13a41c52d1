// Max-marginal duration-band combine: per-frame best score of any span
// covering the frame.
//
// Replaces action_segmentation_tpu/ops/hsmm_pallas.py
// `_band_max_packed_kernel` (launched by `_band_max_packed`) and its
// long-T twin `_band_max_kernel` (launched by `_band_max_pallas`). On the
// TPU both keep whole (T, 128-lane) planes resident in VMEM, which is why
// there are two of them and a VMEM gate between; here the kernel streams
// T in tiles from device memory, so one kernel serves any T.
//
// In the unpacked (B, T, C) layout, with G1 (B, T, C), G2p (B, T2, C)
// where T2 >= T + Km, and dur (B, Km, C) (row j scores duration j + 1):
//   fm[t, c] = max over s <= t < s + d, 1 <= d <= Km of
//              G1[s, c] + dur[d - 1, c] + G2p[s + d, c]
// computed in the running form
//   H_r[s] = max_{j >= r} dur[j] + G2p[s + j + 1]   (r from Km - 1 down)
//   fm[t]  = max_r G1[t - r] + H_r[t - r].
//
// Flattening (t, c) to f = t * C + c makes every shift a stride of C, so a
// block owns blockDim consecutive outputs of one batch row plus a halo of
// (Km - 1) * C running-H entries to its left, all in shared memory. Each r
// step updates the block's H slice (one add and one max per entry, reading
// G2p and dur through the L1 cache), then every thread folds its frame's
// G1 + H into a register; two barriers per r keep the reads of H_r apart
// from the writes of H_{r-1}.
//
// What bounds it: device-memory bytes (G1, G2p and fm once each, about
// 4 MB at the serving shape); the running form does about 4 Km operations
// per output (two per H entry, two per fold) instead of the band's
// Km (Km + 1) / 2 triangle.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kBigNeg = -1e9f;

__global__ void band_max_kernel(const float* __restrict__ g1,
                                const float* __restrict__ g2p,
                                const float* __restrict__ dur,
                                float* __restrict__ fm, int T, int T2, int C,
                                int Km) {
  extern __shared__ float H[];
  const int b = blockIdx.y;
  const int TC = T * C;
  const int base = blockIdx.x * blockDim.x;
  const int halo = (Km > 0 ? Km - 1 : 0) * C;
  const int lo = base - halo;  // flat index of H[0]
  const int nH = blockDim.x + halo;
  g1 += (size_t)b * TC;
  g2p += (size_t)b * T2 * C;
  dur += (size_t)b * Km * C;

  for (int i = threadIdx.x; i < nH; i += blockDim.x) H[i] = kBigNeg;
  const int f = base + threadIdx.x;
  float acc = kBigNeg;
  for (int r = Km - 1; r >= 0; --r) {
    // each thread updates the same H entries it initialised, so the first
    // pass needs no barrier before it
    for (int i = threadIdx.x; i < nH; i += blockDim.x) {
      const int fi = lo + i;
      if (fi >= 0 && fi < TC) {
        const float x = dur[r * C + fi % C] + g2p[fi + (r + 1) * C];
        H[i] = fmaxf(H[i], x);
      }
    }
    __syncthreads();
    const int fs = f - r * C;
    if (f < TC && fs >= 0) acc = fmaxf(acc, g1[fs] + H[fs - lo]);
    __syncthreads();
  }
  if (f < TC) fm[(size_t)b * TC + f] = acc;
}

constexpr int kThreads = 512;

}  // namespace

extern "C" {

// Shared memory the kernel needs for C classes and Km durations.
size_t hsmm_band_max_smem_bytes(int C, int Km) {
  return sizeof(float) * ((size_t)kThreads + (size_t)(Km > 0 ? Km - 1 : 0) * C);
}

// g1 (B, T, C); g2p (B, T2, C) with T2 >= T + Km; dur (B, Km, C);
// fm (B, T, C) out. All float32, contiguous, on `device`. Launches on
// `stream`; returns the CUDA error code of the launch (0 on success).
int hsmm_band_max(const void* g1, const void* g2p, const void* dur, void* fm,
                  int B, int T, int T2, int C, int Km, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || T == 0) return 0;
  const size_t smem = hsmm_band_max_smem_bytes(C, Km);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(band_max_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((T * C + kThreads - 1) / kThreads, B);
  band_max_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)g1, (const float*)g2p, (const float*)dur, (float*)fm, T,
      T2, C, Km);
  return (int)cudaGetLastError();
}

}  // extern "C"
