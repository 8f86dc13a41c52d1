// Log-semiring duration-band sweep for the partition's gradient: the span
// posteriors' start, stop and per-duration masses and the suffix
// log-sum-exp, in one launch.
//
// Replaces action_segmentation_tpu/ops/hsmm_pallas.py
// `_band_grad_packed_kernel` (launched by `_band_grad_packed`). On the TPU
// whole lane-packed planes sit in VMEM, behind a VMEM gate with an
// unpacked jnp fallback past it (and above 128 lanes JAX computes the
// function in jnp); here the kernels stream T in row tiles from device
// memory, so one kernel serves any T.
//
// In the unpacked (B, T, C) layout, with G1m (B, T, C) = G1 - logZ,
// G2p (B, T2, C) where T2 >= T + Km (row e scores boundary e), and
// dur (B, Km, C) (row j scores duration j + 1), the span posterior of
// (start s, duration j + 1) is M[s, j] = exp(G1m[s] + dur[j] + G2p[s+j+1])
// and the kernels write
//   qg[s] = LSE_j dur[j] + G2p[s + j + 1]   (running logaddexp)
//   sa[s] = sum_j M[s, j]                    (span-start mass)
//   st[i] = sum_j M[i - j - 1, j]            (span-stop mass)
//   lg[j] = sum_s M[s, j]                    (per-duration mass)
// in JAX's order of operations: r from Km - 1 down to 0, qg folded by
// jnp.logaddexp's formula (max + log1p(exp(-|a - b|))), each sum from 0.
// Two kernels, picked by C (hsmm_cuda.hsmm_band_grad): `band_grad_kernel`
// up to 128 classes, `band_grad_wide_kernel` past them.
//
// band_grad_kernel. A block owns a tile of `rows` whole time rows of one
// video and one chunk of at most 1,024 classes (all C where C <= 1,024;
// past that C split evenly on the grid's third axis), one thread per
// (t, c); `hsmm_cuda.band_grad_tile` sizes the tile (so that the launch's
// warps spread evenly over the SMs), the chunk and the slab. No term of a
// class reads another class, so a chunk runs on its own. Each thread
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
// band_grad_wide_kernel (C > 128). A thread a (row, class) gives a wide
// class chunk one or two rows a block, so the tiles, and with them the lg
// partials (Km floats a class a tile: Km / rows planes) and the one block
// that sums them a (video, chunk), grow with T. Here a block owns 32
// classes (a warp's lanes, one coalesced row) and a run of `rows` time
// rows of one video; its warps walk the run, warp w rows w, w + warps,
// ..., each row's duration loop as the narrow kernel's (the same adds in
// the same order, so qg, sa and st keep their bits). Each thread adds its
// rows' M into its own shared column of the slab's durations (row order
// from 0), so a (r, class)'s lg over the run adds up inside the block;
// after one barrier the block sums each column over its warps in warp
// order. `hsmm_cuda.band_grad_wide_tile` sizes the runs so that every
// resident block slot of the card has a block and the rounds of them stay
// few (10 runs a video at 342 classes and 18 videos of 1,024 frames, 7 at
// 1,577), at most T / Km of them, so the partials (B x tiles x Km x C
// floats, none for one run) stay within one (B, T, C) plane; past one run
// they are summed by the ticket above, the last block of a (video,
// chunk) adding its few partials in run order with all its threads. lg is associated per thread (its rows), per block
// (its warps) and per video (its runs): the same bits in two runs. Where
// the slab holds fewer durations than Km (27 a pass at 256 threads, so
// that 8 blocks fit an SM), the block walks its run once a slab, each
// row's q, start and stop carried in qg, sa and st between passes.
//
// What bounds them: the special-function units. A (t, c, r) term of the
// function takes three transcendentals (the exp and the log1p of the
// logaddexp, the exp of M; the stop's recomputed M is another term's),
// at 16 a clock per SM: about 4.8 us at the serving shape, above the
// ~2 us of device-memory bytes. The kernels issue more than that: 87
// instructions a duration (log1pf alone about 30), so the schedulers'
// issue is their floor (tools/scan_floor.py `band_grad_floor`). Under the
// 32-register cap every address in the duration loop is an int offset
// from a kernel parameter, one multiply-add each; 64-bit pointers held
// across the loop spilled, and rebuilt from the block index they cost
// a quarter more instructions. The offsets are why the entries refuse
// planes of 2^31 floats or more.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr float kBigNeg = -1e9f;
constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic shared memory
constexpr int kMaxDevices = 64;
constexpr int kWideClasses = 32;      // a wide block's classes: a warp's lanes
constexpr int kWideMaxThreads = 256;  // a wide block's warps walk its run

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

// At most 32 registers a thread, so that eight blocks of 256 threads fit
// an SM: hsmm_cuda.band_grad_wide_tile assumes it (BAND_GRAD_WIDE_REGS).
__global__ void __launch_bounds__(kWideMaxThreads, 8)
    band_grad_wide_kernel(const float* __restrict__ g1m,
                          const float* __restrict__ g2p,
                          const float* __restrict__ dur,
                          float* __restrict__ qg, float* __restrict__ sa,
                          float* __restrict__ st, float* __restrict__ lg,
                          float* __restrict__ lg_part,
                          unsigned int* __restrict__ tickets, int T, int T2,
                          int C, int Km, int rows, int slab) {
  extern __shared__ float acc_s[];  // [slab][n]: each thread's lg column
  __shared__ bool last;
  const int b = blockIdx.z;
  const int tile = blockIdx.x;
  const int tiles = gridDim.x;
  const int c0 = blockIdx.y * kWideClasses;  // the block's classes
  const int n = blockDim.x;  // warps * 32
  const int warps = n / kWideClasses;
  const int i = threadIdx.x;
  const int c = c0 + i % kWideClasses;
  const bool live = c < C;
  const int t_end = min(tile * rows + rows, T);
  // int offsets (the entry refuses planes of 2^31 floats or more): dur's
  // row r at od + (r + 1) * C
  const int od = b * Km * C + c - C;
  float* acc = acc_s + i;

  for (int hi = Km;; hi -= slab) {
    const int lo = max(hi - slab, 0);
    for (int r = lo; r < hi; ++r) acc[(r - lo) * n] = 0.f;
    // a class past C walks no row and leaves its column 0
    for (int t = live ? tile * rows + i / kWideClasses : t_end; t < t_end;
         t += warps) {
      // G1m at start t, G2p at boundary t
      const int o1 = (b * T + t) * C + c;
      const int o2 = (b * T2 + t) * C + c;
      float q = kBigNeg, start = 0.f, stop = 0.f;
      if (hi < Km) {  // the row's sums from the slab above
        q = qg[o1];
        start = sa[o1];
        stop = st[o1];
      }
      const float g1 = g1m[o1];
      const float g2_here = g2p[o2];  // boundary e = t
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
        if (r < t) stop = __fadd_rn(stop, expf(g1m[o1 - rc] + (d + g2_here)));
        float* a = acc + (r - lo) * n;
        *a = __fadd_rn(*a, m);
      }
      qg[o1] = q;
      sa[o1] = start;
      st[o1] = stop;
    }
    __syncthreads();
    // the slab's (r, class) pairs over the run: each column summed over
    // the warps in warp order, into lg (one run a video) or the run's
    // partial
    for (int k = i; k < (hi - lo) * kWideClasses; k += n) {
      const int kc = k % kWideClasses;
      const float* col = acc_s + (k / kWideClasses) * n + kc;
      float sum = col[0];
      for (int w = 1; w < warps; ++w) sum += col[w * kWideClasses];
      if (c0 + kc < C) {
        const size_t at = (size_t)(lo + k / kWideClasses) * C + c0 + kc;
        if (tiles == 1)
          lg[(size_t)b * Km * C + at] = sum;
        else
          lg_part[((size_t)b * tiles + tile) * Km * C + at] = sum;
      }
    }
    if (lo == 0) break;
    __syncthreads();  // every column is read before the next slab zeroes it
  }
  if (Km == 0 || tiles == 1) return;

  // the partials of the (video, chunk)'s runs, summed by the block that
  // comes last
  __threadfence();
  __syncthreads();  // every partial of the run is written and fenced
  if (i == 0) {
    unsigned int* ticket = tickets + (size_t)b * gridDim.y + blockIdx.y;
    last = atomicAdd(ticket, 1u) == (unsigned int)tiles - 1;
    if (last) {
      *ticket = 0;  // every run has taken its ticket
      __threadfence();
    }
  }
  __syncthreads();
  if (!last) return;
  const int KmC = Km * C;
  const float* p = lg_part + (size_t)b * tiles * KmC;
  for (int k = i; k < Km * kWideClasses; k += n) {
    const int kc = c0 + k % kWideClasses;
    if (kc >= C) continue;
    const int at = (k / kWideClasses) * C + kc;
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

// The wide route's launch (C > 128), the same arrays as hsmm_band_grad's:
// lg_part scratch of B * tiles * Km * C floats where tiles =
// ceil(T / rows) > 1 (else unused, may be null); tickets B * groups
// uint32 counters, groups = ceil(C / 32), all 0. The tile from
// hsmm_cuda.band_grad_wide_tile: runs of `rows` time rows, blocks of
// `warps` warps over 32 classes, slabs of `slab` durations (>= 1 when Km
// > 0) in `smem` bytes of shared memory, which must hold slab * warps * 32
// floats. Launches one kernel on `stream`; returns the CUDA error code
// (cudaErrorInvalidValue for a tile that does not fit; 0 on success).
int hsmm_band_grad_wide(const void* g1m, const void* g2p, const void* dur,
                        void* qg, void* sa, void* st, void* lg, void* lg_part,
                        void* tickets, int B, int T, int T2, int C, int Km,
                        int rows, int warps, int slab, int smem, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || T == 0 || C == 0) return 0;
  const int tiles = rows < 1 ? 0 : (T + rows - 1) / rows;
  const long threads = (long)warps * kWideClasses;
  if (C < 0 || rows < 1 || warps < 1 || threads > kWideMaxThreads ||
      B > 65535 || (C + kWideClasses - 1) / kWideClasses > 65535 ||
      (long)B * T2 * C > INT_MAX || (long)B * Km * C > INT_MAX ||
      slab < (Km > 0 ? 1 : 0) || smem > kMaxSmem ||
      (long)smem < 4L * slab * threads || (tiles > 1 && Km > 0 && !lg_part) ||
      device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  // the opt-in past 48 KB, once per device and size
  static int opted[kMaxDevices];
  if (smem > 48 * 1024 && smem > opted[device]) {
    err = cudaFuncSetAttribute(band_grad_wide_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    opted[device] = smem;
  }
  const int groups = (C + kWideClasses - 1) / kWideClasses;
  band_grad_wide_kernel<<<dim3(tiles, groups, B), (int)threads, smem,
                          (cudaStream_t)stream>>>(
      (const float*)g1m, (const float*)g2p, (const float*)dur, (float*)qg,
      (float*)sa, (float*)st, (float*)lg, (float*)lg_part,
      (unsigned int*)tickets, T, T2, C, Km, rows, slab);
  return (int)cudaGetLastError();
}

}  // extern "C"
