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
// A block owns a tile of `rows` whole time rows of one video and one chunk
// of at most 1,024 classes (all C where C <= 1,024; past that C split
// evenly, two chunks of 789 and 788 at 1,577 classes, on the grid's third
// axis), one thread per (t, c); `hsmm_cuda.band_grad_tile` sizes the tile
// (so that the launch's warps spread evenly over the SMs), the chunk and
// the slab. No term of a class reads another class, so a chunk runs on
// its own. Each thread
// runs the duration loop with no barrier in it: q and the start and stop
// sums stay in registers, and each M goes to a shared slab of `slab`
// durations. At a slab's end the block crosses one barrier, its threads
// sum the slab's (r, c) pairs over the tile's rows in parallel (each in
// row order from row 0) into the tile's lg partial in device memory, and
// a second barrier frees the slab. The stop mass of frame i gathers spans
// that started r + 1 rows earlier, possibly in an earlier tile: the
// thread recomputes those M from G1m and its own G2p[i] (the same two
// adds and expf, so the same bits) instead of exchanging a halo.
//
// lg across a video's tiles, in the same launch: each tile writes its
// chunk's columns of the partial, fences, and one thread takes a ticket
// on the (video, chunk)'s counter; the block that takes the last ticket
// sums the chunk's partials in tile order, writes them to lg and sets the
// counter back to 0 for the next launch. Two runs give the same bits (no
// float atomics).
//
// What bounds it: the special-function units. A (t, c, r) term of the
// function takes three transcendentals (the exp and the log1p of the
// logaddexp, the exp of M; the stop's recomputed M is another term's),
// at 16 a clock per SM: about 4.8 us at the serving shape, above the
// ~2 us of device-memory bytes. The kernel issues more than that: 87
// instructions a duration (log1pf alone about 30), so the schedulers'
// issue is its floor (tools/scan_floor.py `band_grad_floor`). Under the
// 32-register cap every address in the duration loop is an int offset
// from a kernel parameter, one multiply-add each; 64-bit pointers held
// across the loop spilled, and rebuilt from the block index they cost
// a quarter more instructions. The offsets are why the entry refuses
// planes of 2^31 floats or more.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr float kBigNeg = -1e9f;
constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic shared memory
constexpr int kMaxDevices = 64;

// Every add that takes a transcendental's result is __fadd_rn: left to
// itself the compiler contracts the add with the last multiply of expf or
// log1pf into one FFMA, whose single rounding differs from the plain
// version's where the product is denormal (a span posterior under 2^-126).
__device__ __forceinline__ float log_add_exp(float a, float b) {
  const float m = fmaxf(a, b);
  return __fadd_rn(m, log1pf(expf(-fabsf(a - b))));
}

// At most 32 registers a thread, so that two blocks of 1,024 threads fit
// an SM: hsmm_cuda.band_grad_tile assumes it (BAND_GRAD_REGS).
__global__ void __launch_bounds__(kMaxThreads, 2)
    band_grad_kernel(const float* __restrict__ g1m,
                     const float* __restrict__ g2p,
                     const float* __restrict__ dur, float* __restrict__ qg,
                     float* __restrict__ sa, float* __restrict__ st,
                     float* __restrict__ lg, float* __restrict__ lg_part,
                     unsigned int* __restrict__ tickets, int T, int T2, int C,
                     int Km, int rows, int slab, int W) {
  extern __shared__ float m_s[];  // [slab][rows * W]: the slab's M
  __shared__ bool last;
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int tiles = gridDim.x;
  const int c0 = blockIdx.z * W;  // the chunk's classes [c0, c0 + W)
  const int n = blockDim.x;  // rows * W
  const int i = threadIdx.x;
  const int t = tile * rows + i / W;
  const int c = c0 + i % W;
  const bool live = t < T && c < C;
  // a row past T computes row T - 1's terms, a class past C class C - 1's;
  // neither stores an output, and both put 0 in the slab
  const int tl = t < T ? t : T - 1;
  const int cc = c < C ? c : C - 1;
  const int f = tl * C + cc;
  // int offsets (the entry refuses planes of 2^31 floats or more): G1m at
  // start t, G2p at boundary t, and dur's row r at od + (r + 1) * C
  const int o1 = b * T * C + f;
  const int o2 = b * T2 * C + f;
  const int od = b * Km * C + cc - C;

  const float g1 = g1m[o1];
  const float g2_here = g2p[o2];  // boundary e = t
  float q = kBigNeg, start = 0.f, stop = 0.f;
  for (int hi = Km; hi > 0; hi -= slab) {
    const int lo = max(hi - slab, 0);
#pragma unroll 1
    for (int r = hi - 1; r >= lo; --r) {
      const int rc = (r + 1) * C;
      const float d = dur[od + rc];
      // the span that starts at t with duration r + 1
      const float x = d + g2p[o2 + rc];
      q = log_add_exp(q, x);
      const float m = expf(g1 + x);
      start = __fadd_rn(start, m);
      // the span of duration r + 1 that stops at boundary t
      if (r < tl) stop = __fadd_rn(stop, expf(g1m[o1 - rc] + (d + g2_here)));
      m_s[(r - lo) * n + i] = live ? m : 0.f;
    }
    __syncthreads();
    // the slab's (r, c) pairs of the chunk, each summed over the tile's
    // rows from row 0
    float* part = lg_part + ((size_t)b * tiles + tile) * Km * C + lo * C + c0;
    for (int k = i; k < (hi - lo) * W; k += n) {
      const int kc = k % W;
      const float* col = m_s + (k / W) * n + kc;
      float sum = col[0];
      for (int row = 1; row < rows; ++row) sum += col[row * W];
      if (c0 + kc < C) part[(k / W) * C + kc] = sum;
    }
    if (hi - slab > 0) __syncthreads();
  }
  if (live) {
    qg[o1] = q;
    sa[o1] = start;
    st[o1] = stop;
  }
  if (Km == 0) return;

  // the partials of the (video, chunk)'s tiles, summed by the block that
  // comes last
  if (i < slab * W) __threadfence();  // the threads that wrote partials
  __syncthreads();  // every partial of the tile is written and fenced
  if (i == 0) {
    unsigned int* ticket = tickets + (size_t)b * gridDim.z + blockIdx.z;
    last = atomicAdd(ticket, 1u) == (unsigned int)tiles - 1;
    if (last) {
      *ticket = 0;  // every tile has taken its ticket
      __threadfence();
    }
  }
  __syncthreads();
  if (!last) return;
  const int KmC = Km * C;
  const float* p = lg_part + (size_t)b * tiles * KmC;
  for (int k = i; k < Km * W; k += n) {
    const int kc = c0 + k % W;
    if (kc >= C) continue;
    const int at = (k / W) * C + kc;
    float s = __ldcg(p + at);
#pragma unroll 8
    for (int j = 1; j < tiles; ++j) s += __ldcg(p + (size_t)j * KmC + at);
    lg[(size_t)b * KmC + at] = s;
  }
}

}  // namespace

extern "C" {

// g1m (B, T, C); g2p (B, T2, C) with T2 >= T + Km; dur (B, Km, C);
// qg, sa, st (B, T, C) out; lg (B, Km, C) out; lg_part scratch of
// B * tiles * Km * C floats, tiles = ceil(T / rows); tickets B * chunks
// uint32 counters, chunks = ceil(C / chunk), all 0 (each launch leaves
// them 0). All float32, contiguous, on `device`, each plane under 2^31
// floats. The tile from hsmm_cuda.band_grad_tile: `rows` time rows and
// `chunk` classes a block (rows * chunk <= 1024 threads), M staged in
// slabs of `slab` durations (>= 1 when Km > 0) in `smem` bytes of shared
// memory, which must hold slab * rows * chunk floats. Launches one kernel
// on `stream`; returns the CUDA error code (cudaErrorInvalidValue for a
// tile that does not fit; 0 on success).
int hsmm_band_grad(const void* g1m, const void* g2p, const void* dur,
                   void* qg, void* sa, void* st, void* lg, void* lg_part,
                   void* tickets, int B, int T, int T2, int C, int Km,
                   int rows, int slab, int smem, int chunk, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || T == 0 || C == 0) return 0;
  if (C < 0 || rows < 1 || chunk < 1 || (long)rows * chunk > kMaxThreads ||
      (C + chunk - 1) / chunk > 65535 ||
      (long)B * T2 * C > INT_MAX || (long)B * Km * C > INT_MAX ||
      slab < (Km > 0 ? 1 : 0) || smem > kMaxSmem ||
      (long)smem < 4L * slab * rows * chunk || device < 0 ||
      device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  // the opt-in past 48 KB, once per device and size
  static int opted[kMaxDevices];
  if (smem > 48 * 1024 && smem > opted[device]) {
    err = cudaFuncSetAttribute(band_grad_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    opted[device] = smem;
  }
  const int tiles = (T + rows - 1) / rows;
  const int chunks = (C + chunk - 1) / chunk;
  band_grad_kernel<<<dim3(tiles, B, chunks), rows * chunk, smem,
                     (cudaStream_t)stream>>>(
      (const float*)g1m, (const float*)g2p, (const float*)dur, (float*)qg,
      (float*)sa, (float*)st, (float*)lg, (float*)lg_part,
      (unsigned int*)tickets, T, T2, C, Km, rows, slab, chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
