// Max-marginal duration-band combine: per-frame best score of any span
// covering the frame.
//
// Replaces action_segmentation_tpu/ops/hsmm_pallas.py
// `_band_max_packed_kernel` (launched by `_band_max_packed`) and its
// long-T twin `_band_max_kernel` (launched by `_band_max_pallas`). On the
// TPU both keep whole (T, 128-lane) planes resident in VMEM, which is why
// there are two of them and a VMEM gate between; here the kernel streams
// T in row tiles from device memory, so one kernel serves any T.
//
// In the unpacked (B, T, C) layout, with G1 (B, T, C), G2p (B, T2, C)
// where T2 >= T + Km, and dur (B, Km, C) (row j scores duration j + 1):
//   fm[t, c] = max over s <= t < s + d, 1 <= d <= Km of
//              G1[s, c] + dur[d - 1, c] + G2p[s + d, c]
// computed in the running form
//   H_r[s] = max_{j >= r} dur[j] + G2p[s + j + 1]   (r from Km - 1 down)
//   fm[t]  = max_{r <= t} G1[t - r] + H_r[t - r]
// with the plain version's float32 operations (one add, then a max; the
// maxima start at BIG_NEG), so the two agree to the bit.
//
// A block owns a tile of `rows` whole time rows of one video, one thread
// per output (t, c); `hsmm_cuda.band_max_tile` sizes the tile and the
// slab. The tile's outputs need the starts s in [t0 - Km + 1, t0 + rows)
// (those before frame 0 or past T do not exist). Each start is owned by
// one thread, whose class is its output's (the starts are dealt out in
// whole rows, rows * C items at a time), so no thread takes an index
// modulo C in a loop. Phase 1: the owner runs r down the slab's
// durations with no barrier, keeping H in a register, and writes
// A = G1[s] + H_r[s] into a shared slab at the output row s + r it
// serves, where that row is in the tile. Phase 2, after one barrier: each
// output thread folds its row's slab entries into a register, and a
// second barrier frees the slab. One slab holds every duration where the
// SM's resident blocks leave room (the serving shape: two barriers a
// block); past that the slabs go from the top down, and each start's H
// waits for the next slab in a shared carry beside the slab, read and
// written by its owner only. A halo start stops at the least duration
// that reaches the tile.
//
// What bounds it: device-memory bytes (G1, G2p and fm once each, about
// 4 MB at the serving shape); in issue, a start's duration is two loads,
// two adds, a max and a shared store, an output's a shared load and a
// max, so the tile's halo (Km - 1 rows of starts, Km / 2 durations each
// on average) is the only work beyond one pass of each per (t, c, r).
// tools/scan_floor.py `band_max_floor` reads the duration loops from the
// SASS. A start's pointers begin at int offsets from the kernel's
// parameters and step down one duration at a time; the offsets are why
// the entry refuses planes of 2^31 floats or more.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr float kBigNeg = -1e9f;
constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic shared memory
constexpr int kMaxDevices = 64;

// At most 32 registers a thread, so that two blocks of 1,024 threads fit
// an SM: hsmm_cuda.band_max_tile assumes it (BAND_MAX_REGS). kSlabs: the
// band takes several slabs (slab < Km), with the carry; else one pass.
template <bool kSlabs>
__global__ void __launch_bounds__(kMaxThreads, 2)
    band_max_kernel(const float* __restrict__ g1, const float* __restrict__ g2p,
                    const float* __restrict__ dur, float* __restrict__ fm, int T,
                    int T2, int C, int Km, int rows, int slab) {
  // [slab][rows * C]: A by (duration - lo, output row - t0, class); then,
  // with several slabs, the carry: H by (start - s_lo, class)
  extern __shared__ float a_s[];
  float* carry = a_s + slab * blockDim.x;
  const int b = blockIdx.y;
  const int n = blockDim.x;  // rows * C
  const int c = threadIdx.x % C;
  const int row = threadIdx.x / C;
  const int t0 = blockIdx.x * rows;
  const int t_end = min(t0 + rows, T);  // the tile's outputs: [t0, t_end)
  const int s_lo = max(t0 - Km + 1, 0);  // its starts: [s_lo, t_end)
  // int offsets (the entry refuses planes of 2^31 floats or more): G1 and
  // fm at row 0, G2p at boundary 0 and dur at row 0, all of class c
  const int o1 = b * T * C + c;
  const int o2 = b * T2 * C + c;
  const int od = b * Km * C + c;

  float acc = kBigNeg;
  for (int hi = Km; hi > 0; hi -= slab) {
    const int lo = kSlabs ? max(hi - slab, 0) : 0;
    // phase 1: this thread's starts s = s_lo + row + j * rows, items
    // k = (s - s_lo) * C + c = threadIdx.x + j * n
    for (int s = s_lo + row, k = threadIdx.x; s < t_end; s += rows, k += n) {
      float h = kSlabs && hi < Km ? carry[k] : kBigNeg;
      const float g = g1[o1 + s * C];
      // durations whose output row s + r is in the tile: [r_end, r_top]
      const int r_top = min(hi, t_end - s) - 1;
      const int r_end = max(lo, t0 - s);
      int r = hi - 1;
      const float* d = dur + (od + r * C);        // dur[r]
      const float* e = g2p + (o2 + (s + hi) * C);  // G2p[s + r + 1]
#pragma unroll 1
      for (; r > r_top && r >= r_end; --r, d -= C, e -= C) h = fmaxf(h, *d + *e);
      // the slab entry of (r, output row s + r, c)
      float* a = a_s + ((r - lo) * n + (s + r - t0) * C + c);
#pragma unroll(kSlabs ? 1 : 4)
      for (; r >= r_end; --r, d -= C, e -= C, a -= n + C) {
        h = fmaxf(h, *d + *e);
        *a = g + h;
      }
      if (kSlabs && lo > 0) carry[k] = h;
    }
    __syncthreads();
    // phase 2: the output (t, c) folds its row's entries, r <= t
    const int t = t0 + row;
    if (t < t_end) {
      const float* a = a_s + threadIdx.x;
#pragma unroll 4
      for (int r = min(hi - 1, t); r >= lo; --r) acc = fmaxf(acc, a[(r - lo) * n]);
    }
    if (!kSlabs) break;
    if (lo > 0) __syncthreads();
  }
  const int t = t0 + row;
  if (t < t_end) fm[o1 + t * C] = acc;
}

}  // namespace

extern "C" {

// g1 (B, T, C); g2p (B, T2, C) with T2 >= T + Km; dur (B, Km, C);
// fm (B, T, C) out. All float32, contiguous, on `device`, each plane
// under 2^31 floats. The tile from hsmm_cuda.band_max_tile: `rows` time
// rows a block (rows * C <= 1024 threads), the span terms staged in slabs
// of `slab` durations (>= 1 when Km > 0) in `smem` bytes of shared
// memory, which must hold slab * rows * C floats and, where slab < Km,
// the carry's min(rows + Km - 1, T) * C. Launches one kernel on `stream`;
// returns the CUDA error code (cudaErrorInvalidValue for a tile that does
// not fit; 0 on success).
int hsmm_band_max(const void* g1, const void* g2p, const void* dur, void* fm,
                  int B, int T, int T2, int C, int Km, int rows, int slab,
                  int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || T == 0 || C == 0) return 0;
  const long carry = slab < Km ? (long)(rows + Km - 1 < T ? rows + Km - 1 : T) * C : 0;
  if (C < 0 || Km < 0 || T2 < T + Km || rows < 1 || (long)rows * C > kMaxThreads ||
      (long)B * T2 * C > INT_MAX || (long)B * Km * C > INT_MAX ||
      slab < (Km > 0 ? 1 : 0) || smem > kMaxSmem ||
      (long)smem < 4L * ((long)slab * rows * C + carry) || device < 0 ||
      device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  const bool slabs = slab < Km;
  auto kernel = slabs ? band_max_kernel<true> : band_max_kernel<false>;
  // the opt-in past 48 KB, once per device, instance and size
  static int opted[2][kMaxDevices];
  if (smem > 48 * 1024 && smem > opted[slabs][device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    opted[slabs][device] = smem;
  }
  const int tiles = (T + rows - 1) / rows;
  kernel<<<dim3(tiles, B), rows * C, smem, (cudaStream_t)stream>>>(
      (const float*)g1, (const float*)g2p, (const float*)dur, (float*)fm, T,
      T2, C, Km, rows, slab);
  return (int)cudaGetLastError();
}

}  // extern "C"
