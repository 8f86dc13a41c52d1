// The partition's transition cotangent: the pair posteriors of every
// interior boundary summed over frames, in one launch,
//
//   out[b, i, j] = sum_{t = 1 .. L_b - 1} exp(X[b, t, j] + trans[b, i, j]
//                                               + Y[b, t, i] - Z[b])
//
// with X the forward alphas shifted one frame (the prefix mass before the
// boundary, in class j), Y the suffix mass from the boundary without the
// transition (in class i) and Z the partition (0 where the backward
// anchors X and Y per chunk instead; hsmm_grad._pair_inputs).
//
// Replaces no Pallas kernel: on the TPU, XLA fuses the broadcast of
// action_segmentation_tpu/ops/hsmm_grad.py `_fb_bwd_packed` (the pair
// exponent, :242-256) into its sum over frames, so the (B, T, C, C)
// exponent is never held. The port's torch form of the same expression
// held it, 4 B T C^2 bytes (8.6 GB at 342 classes and 18 videos of 1,024
// frames); this kernel holds one tile's operands in shared memory.
//
// The sum as a product. For a tile of classes I x J and a frame t, with
// a_t = max_{j in J} X[t, j], b_t = max_{i in I} Y[t, i], tau the tile's
// largest trans and the gap g_t = a_t + b_t + tau - Z (in float64 from the
// float32 inputs),
//
//   exp(X[t, j] + trans[i, j] + Y[t, i] - Z)
//     = B[t, i] A[t, j] exp(trans[i, j] - tau),
//   A[t, j] = exp(X[t, j] - a_t) <= 1,  B[t, i] = exp(Y[t, i] + a_t + tau - Z) <= exp(g_t),
//
// so out = (sum_t B[t, i] A[t, j]) exp(trans - tau): a (I x T) by (T x J)
// product with a float64 accumulator on the FP64 tensor cores (mma.sync
// m16n8k8 .f64), scaled once. JAX's comment (:236-242) warns that
// exp(trans) pulled out overflows where a BIG_NEG transition masks the
// frame's dominant pair; in float32 (+-87 nats) any rank-1 rescale of a
// frame meets that. Here the rescale is per tile and frame, and float64
// holds +-708 nats: a masked pair's product is A B <= exp(g_t), large but
// finite, and exp(trans - tau) = exp(-1e9) = 0 takes it out exactly as the
// plain version's exp(-1e9) does. An unmasked pair's exponent e is
// (X - a_t) + (Y - b_t) + (trans - tau) + g_t <= g_t, each bracket <= 0.
//
// theta: a tile-frame goes into the product where g_t <= theta = 600.
// (1) Nothing overflows: every operand and product is at most exp(theta),
// and a run's sum at most T exp(theta), finite for T < exp(709.78 -
// theta) = exp(109), past any int32 T. (2) Every term that float32 can
// hold (e >= -103.3, its least denormal) keeps its operands and its scale
// normal in float64 (>= exp(-708.4)): A = exp(e - (Y - b_t) - (trans -
// tau) - g_t) >= exp(e - theta) >= exp(-703.3), and likewise B >= exp(e)
// and exp(trans - tau) >= exp(e - g_t); the tile's trans spread enters
// there, an unmasked entry's trans - tau >= e - theta. Smaller terms may
// flush to 0 (the operands carry no float64 denormals): each is below
// exp(-103.3), none of them more than T exp(-103.3) together. A
// tile-frame with g_t > theta, where a masked pair dominates by more than
// 600 nats, goes through the exact path instead: its terms one by one,
// each exponent in the plain version's order ((X + trans) + Y) - Z, in
// float64, expf of it, summed in float64. One with g_t < -750 is left
// out: its every term is below float64's least (exp(-745.1)).
//
// NaN: a tile-frame whose X, Y or Z holds a NaN (its maxima are taken
// with max.NaN, so its gap is NaN) goes through the exact path, which
// gives NaN where the plain version does and its sum elsewhere; a NaN in
// trans makes exp(trans - tau) NaN, and the entry NaN wherever the run
// has an interior frame, as in the plain version. The product's operands
// need no test for NaN.
//
// The operands: exp(d) with d formed in float64 (a float32 difference such
// as X - a_t at |X| ~ 1e4 would round by 1e-3 nats), 2^f with f in
// [-1/2, 1/2] from the special-function unit (MUFU.EX2, float32, relative
// error ~2^-22) and the binary exponent written by bits: one MUFU an
// operand, I + J a tile-frame, where the plain form takes I J.
//
// Precision: a term's exponent is exact to float64 rounding on both paths
// (where the float32 plain version rounds ((X + trans) + Y) to an ulp of
// 1e4 at the D=300 scale's T <= 64, unanchored); each operand carries the
// MUFU's ~2.4e-7, an exact-path term expf's few ulps. The kernel is held
// to float64 plain within the looser of rtol 1e-5 / atol 1e-4 and the
// float32 plain version's own error.
//
// A block owns one video, a tile of 64 x 64 (i, j) pairs and a run of
// frames; 8 warps, warp w the pairs of rows 32 (w / 4) .. + 32 and columns
// 16 (w % 4) .. + 16 (2 x 2 tiles of the mma's 16 x 8). Each pass stages
// 32 frames of the tile's X and Y columns (float32), takes each frame's
// maxima (8 lanes a frame) and its state (product, exact or left out),
// writes the operands (float64, rows of 68 doubles: the fragment loads
// are free of bank conflicts) and runs the product over the pass's
// frames, then the pass's exact frames, if any. `hsmm_cuda.pair_grad_tile`
// picks the runs a video (each of at least 32 frames, their partials
// within two (B, T, C) planes of floats) that cost the least in rounds of
// the card's resident block slots (two an SM: 256 threads of at most 128
// registers, 103 KB of shared memory). Past one run each block writes its
// partial sums (float64), fences, and one thread takes a ticket on the
// (video, tile)'s counter; the block that takes the last ticket sums the
// partials in run order (no float atomics: two runs give the same bits)
// and sets the counter back to 0 for the next launch.
//
// What bounds it: the FP64 tensor rate, 2 B (L - 1) C^2 flops at 67
// TFLOP/s (0.064 ms at 342 classes and 18 videos of 1,024 frames; the
// tiles' padding to 64 adds its share), beside the operands' exps (one
// MUFU an operand, I + J a tile-frame, with their float64 conversions,
// loads and stores) and the exact path's frames (one expf a term, as the
// plain form; none on the model's inputs). As built it runs at several
// times the tensor bound: the pass's four barriers keep its phases
// (stage, maxima, operands, product) apart, so the product, the operands
// and the staging each add their time (tools/pair_times.py --cuts).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kTile = 64;              // a tile's classes on each side
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpI = 32;             // a warp's rows (i) ...
constexpr int kWarpJ = 16;             // ... and columns (j)
constexpr int kFrames = 32;            // the frames a pass stages
constexpr int kOpLd = kTile + 4;       // an operand row, doubles
constexpr int kStageLd = kTile + 8;    // a staged row, floats
constexpr double kTheta = 600.0;
constexpr double kDead = -750.0;
constexpr double kLog2e = 1.4426950408889634;
constexpr double kRound = 6755399441055744.0;  // 1.5 * 2^52
constexpr int kMaxDevices = 64;
constexpr int kKm = 8;                 // the mma's depth, frames (m16n8k8)

static_assert(kFrames == 4 * kWarps, "a warp takes the maxima of 4 frames");
static_assert(kThreads == 4 * kTile, "a thread stages one class of every fourth frame");

enum : int { kSkip = 0, kProduct = 1, kExact = 2 };

struct Smem {
  double aop[kFrames][kOpLd];      // A[t, j]: the product's B operand
  double bop[kFrames][kOpLd];      // B[t, i]: its A operand
  double exact[kTile][kTile];      // the exact path's sums, a thread its own
  double ya[kFrames];              // -a_t log2(e)
  double yb[kFrames];              // (a_t + tau - Z) log2(e)
  float xs[2][kFrames][kStageLd];  // X[t, j], a stage a pass, two in turn
  float ys[2][kFrames][kStageLd];  // Y[t, i]
  float wmax[kWarps];
  unsigned int wexact[kWarps];     // a warp's frames on the exact path, as bits
  int state[kFrames];
  int last;
};

// 2^y for y <= 1000, as a float64: 2^f (f in [-1/2, 1/2]) from the
// special-function unit, the binary exponent written by bits; 0 below
// 2^-1022. y is not NaN (a product frame's operands hold none: a NaN among
// the frame's X, Y or Z sends it to the exact path; the epilogue tests its
// trans before the call)
__device__ __forceinline__ double exp2_by_bits(double y) {
  y = fmax(y, -1600.0);
  const double r = y + kRound;  // y rounded to an integer n, in the low word
  const int n = __double2loint(r);
  const float f = (float)(y - (r - kRound));
  float m;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(m) : "f"(f));
  const unsigned int mb = __float_as_uint(m);
  const int e = (int)(mb >> 23) + n + (1023 - 127);
  return e > 0 ? __hiloint2double((e << 20) | (int)((mb >> 3) & 0xFFFFFu), (int)(mb << 29))
               : 0.0;
}

// the larger of a and b, NaN where either is NaN (fmaxf ignores a NaN)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// a 4-byte copy from global to shared memory, 0 where `live` is false
__device__ __forceinline__ void copy4(float* dst, const float* src, bool live) {
  const unsigned int to = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(to), "l"(src),
               "r"(live ? 4 : 0));
}

// D += A B on the FP64 tensor cores, m16n8k8: A 16 x 8 (row), B 8 x 8
// (col). A thread's fragments, g = lane / 4, q = lane % 4: a[r] the element
// (g + 8 (r % 2), q + 4 (r / 2)), b[r] (q + 4 r, g), c[e] (g + 8 (e / 2),
// 2 q + e % 2)
__device__ __forceinline__ void mma_k8(double (&c)[4], const double (&a)[4],
                                       const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// At most 128 registers a thread, so that two blocks of 256 threads fit an
// SM: hsmm_cuda.pair_grad_tile assumes it (PAIR_REGS).
__global__ void __launch_bounds__(kThreads, 2)
    pair_grad_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ trans,
                     const float* __restrict__ z,
                     const int* __restrict__ lengths, float* __restrict__ out,
                     double* __restrict__ part,
                     unsigned int* __restrict__ tickets, int T, int C,
                     int sb, int si, int sj, int frames) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int sides = (C + kTile - 1) / kTile;
  const int i_tile = (blockIdx.x / sides) * kTile;
  const int j_tile = (blockIdx.x % sides) * kTile;
  const int run = blockIdx.y;
  const int runs = gridDim.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wi = (warp / (kTile / kWarpJ)) * kWarpI;
  const int wj = (warp % (kTile / kWarpJ)) * kWarpJ;
  const int ci = min(kTile, C - i_tile), cj = min(kTile, C - j_tile);  // live classes
  const float* tb = trans + (size_t)b * sb + (size_t)i_tile * si + (size_t)j_tile * sj;

  // the interior boundaries t = 1 .. L - 1 within the run's frames
  const int L = min(max(lengths[b], 1), T);
  const int t_lo = max(run * frames, 1);
  const int t_hi = min(run * frames + frames, L);
  // a thread stages class c of frames f0 + 4 m of a pass
  const int sc = tid % kTile, sf = tid / kTile;
  const float* xsrc = x + ((size_t)b * T + t_lo + sf) * C + j_tile + sc;
  const float* ysrc = y + ((size_t)b * T + t_lo + sf) * C + i_tile + sc;
  auto stage = [&](int pass, int buf) {
    const int nf = t_hi - t_lo - pass * kFrames;
    const size_t at = (size_t)pass * kFrames * C;
#pragma unroll
    for (int m = 0; m < kFrames / 4; ++m) {
      const bool live = sf + 4 * m < nf;
      copy4(&s.xs[buf][sf + 4 * m][sc], live && sc < cj ? xsrc + at + (size_t)4 * m * C : x,
            live && sc < cj);
      copy4(&s.ys[buf][sf + 4 * m][sc], live && sc < ci ? ysrc + at + (size_t)4 * m * C : y,
            live && sc < ci);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  const int passes = t_hi > t_lo ? (t_hi - t_lo + kFrames - 1) / kFrames : 0;
  if (passes > 0) stage(0, 0);

  // the tile's largest trans, tau (0 where every entry is -inf); the exact
  // path's sums at 0
  float mx = -INFINITY;
  for (int k = tid; k < kTile * kTile; k += kThreads) {
    const int i = k / kTile, j = k % kTile;
    if (i < ci && j < cj) mx = fmaxf(mx, tb[(size_t)i * si + (size_t)j * sj]);
    s.exact[i][j] = 0.0;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) s.wmax[warp] = mx;
  __syncthreads();
  mx = s.wmax[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, s.wmax[w]);
  const double tau = mx > -INFINITY ? (double)mx : 0.0;
  const double zb = (double)z[b];

  double acc[2][2][4];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mb][nb][e] = 0.0;

  for (int pass = 0; pass < passes; ++pass) {
    const int buf = pass & 1;
    const int f0 = t_lo + pass * kFrames;
    const int nf = min(kFrames, t_hi - f0);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // the pass's stage has landed; the pass before is done
    if (pass + 1 < passes) stage(pass + 1, buf ^ 1);
    const float(*xs)[kStageLd] = s.xs[buf];
    const float(*ys)[kStageLd] = s.ys[buf];
    {  // a frame's maxima, its gap and its state: 8 lanes a frame
      const int f = warp * 4 + (lane >> 3), p = lane & 7;
      float ax = -INFINITY, by = -INFINITY;
#pragma unroll
      for (int c = p; c < kTile; c += 8) {
        if (c < cj) ax = max_nan(ax, xs[f][c]);
        if (c < ci) by = max_nan(by, ys[f][c]);
      }
#pragma unroll
      for (int o = 4; o; o >>= 1) {
        ax = max_nan(ax, __shfl_xor_sync(0xffffffffu, ax, o));
        by = max_nan(by, __shfl_xor_sync(0xffffffffu, by, o));
      }
      const double a = (double)ax;
      const double gap = a + (double)by + tau - zb;
      int state = kSkip;
      if (f < nf) {
        if (gap != gap)  // a NaN among the frame's X, Y or in Z: term by term
          state = kExact;
        else if (ax > -INFINITY && by > -INFINITY)
          state = gap > kTheta ? kExact : gap >= kDead ? kProduct : kSkip;
      }
      const unsigned int hot = __ballot_sync(0xffffffffu, p == 0 && state == kExact);
      if (p == 0) {
        s.state[f] = state;
        s.ya[f] = -a * kLog2e;
        s.yb[f] = (a + tau - zb) * kLog2e;
      }
      if (lane == 0)  // lanes 0, 8, 16, 24: the warp's frames 4 warp + 0 .. 3
        s.wexact[warp] = ((hot & 1u) | ((hot >> 7) & 2u) | ((hot >> 14) & 4u) |
                          ((hot >> 21) & 8u)) << (4 * warp);
    }
    __syncthreads();
    // the operands, 0 off the product's frames and classes
#pragma unroll 2
    for (int m = 0; m < kFrames / 4; ++m) {
      const int f = sf + 4 * m;
      double av = 0.0, bv = 0.0;
      if (s.state[f] == kProduct) {
        if (sc < cj) av = exp2_by_bits(fma((double)xs[f][sc], kLog2e, s.ya[f]));
        if (sc < ci) bv = exp2_by_bits(fma((double)ys[f][sc], kLog2e, s.yb[f]));
      }
      s.aop[f][sc] = av;
      s.bop[f][sc] = bv;
    }
    __syncthreads();
    for (int k0 = 0; k0 < nf; k0 += kKm) {
      double af[2][kKm / 2], bf[2][kKm / 4];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int r = 0; r < kKm / 2; ++r)
          af[mb][r] = s.bop[k0 + q + 4 * (r >> 1)][wi + 16 * mb + g + 8 * (r & 1)];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int r = 0; r < kKm / 4; ++r) bf[nb][r] = s.aop[k0 + q + 4 * r][wj + 8 * nb + g];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) mma_k8(acc[mb][nb], af[mb], bf[nb]);
    }
    // the exact path: the pass's frames past theta, term by term
    unsigned int hot = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) hot |= s.wexact[w];
    while (hot) {
      const int f = __ffs(hot) - 1;
      hot &= hot - 1;
#pragma unroll 1
      for (int k = 0; k < 16; ++k) {  // the thread's (mb, nb, e) = (k / 8, k / 4 % 2, k % 4)
        const int i = wi + 16 * (k >> 3) + g + 8 * ((k >> 1) & 1);
        const int j = wj + 8 * ((k >> 2) & 1) + 2 * q + (k & 1);
        if (i >= ci || j >= cj) continue;
        const double ex = (((double)xs[f][j] + (double)tb[(size_t)i * si + (size_t)j * sj]) +
                           (double)ys[f][i]) - zb;
        s.exact[i][j] += (double)expf((float)ex);
      }
    }
  }

  // the run's sums: the product scaled by exp(trans - tau) where the run
  // has interior frames (a NaN trans gives NaN there only), plus the exact
  // path's
  const size_t plane = (size_t)C * C;
  double* p = runs > 1 ? part + ((size_t)b * runs + run) * plane : nullptr;
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = wi + 16 * mb + g + 8 * (e >> 1);
        const int j = wj + 8 * nb + 2 * q + (e & 1);
        if (i >= ci || j >= cj) continue;
        const double d = (double)tb[(size_t)i * si + (size_t)j * sj] - tau;
        const double scaled =
            passes > 0 ? acc[mb][nb][e] * (d != d ? d : exp2_by_bits(d * kLog2e)) : 0.0;
        const double v = scaled + s.exact[i][j];
        const size_t at = (size_t)(i_tile + i) * C + j_tile + j;
        if (runs == 1)
          out[b * plane + at] = (float)v;
        else
          p[at] = v;
      }
  if (runs == 1) return;
  // the (video, tile)'s runs summed by the block that comes last
  __threadfence();
  __syncthreads();  // every partial of the block is written and fenced
  if (tid == 0) {
    unsigned int* ticket = tickets + (size_t)b * gridDim.x + blockIdx.x;
    s.last = atomicAdd(ticket, 1u) == (unsigned int)runs - 1;
    if (s.last) {
      *ticket = 0;  // every run has taken its ticket
      __threadfence();
    }
  }
  __syncthreads();
  if (!s.last) return;
  const double* r0 = part + (size_t)b * runs * plane;
  for (int k = tid; k < kTile * kTile; k += kThreads) {
    const int i = k / kTile, j = k % kTile;
    if (i >= ci || j >= cj) continue;
    const size_t at = (size_t)(i_tile + i) * C + j_tile + j;
    double v = __ldcg(r0 + at);
#pragma unroll 4
    for (int r = 1; r < runs; ++r) v += __ldcg(r0 + (size_t)r * plane + at);
    out[b * plane + at] = (float)v;
  }
}

int launch(const void* x, const void* y, const void* trans, const void* z,
           const void* lengths, void* out, void* part, void* tickets, int B, int T,
           int C, int sb, int si, int sj, int frames, int device, void* stream) {
  // the opt-in past 48 KB, once per device
  static bool opted[kMaxDevices];
  if (!opted[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        pair_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
    if (err != cudaSuccess) return (int)err;
    opted[device] = true;
  }
  const long sides = (C + kTile - 1) / kTile;
  const long runs = T > frames ? (T + (long)frames - 1) / frames : 1;
  pair_grad_kernel<<<dim3((unsigned int)(sides * sides), (unsigned int)runs, B), kThreads,
                      sizeof(Smem), (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (const float*)trans, (const float*)z,
      (const int*)lengths, (float*)out, (double*)part, (unsigned int*)tickets, T, C, sb, si,
      sj, frames);
  return (int)cudaGetLastError();
}

// The scalar route (C <= 32): a block a video, a 32 x 32 tile of (i, j)
// and a run of frames; 256 threads, thread (tx, ty) the pairs (4 ty + k,
// tx), k < 4. Each pass stages 32 frames of the tile's X columns (j) and Y
// columns (i) in shared memory, then every thread adds its four terms a
// frame, each formed in the plain version's order ((X + trans) + Y) - Z
// with every add __fadd_rn and one expf, into a pass sum (float32), and the
// pass sum into its total. Runs past one meet by the same tickets, their
// partials float32. One expf a term bounds it (the special-function unit,
// 16 a clock per SM), but at the serving shape and the CrossTask fit
// batches its launch is latency-bound and shorter than the product's.
namespace scalar {

constexpr int kTile = 32;             // a tile's classes on each side
constexpr int kRowsY = 8;             // threadIdx.y
constexpr int kPairs = kTile / kRowsY;  // the i's a thread owns: 4
constexpr int kThreads = kTile * kRowsY;
constexpr int kFrames = 32;           // the frames a pass stages

// At most 64 registers a thread, so that four blocks of 256 threads fit an
// SM: hsmm_cuda.pair_grad_tile assumes it (PAIR_SCALAR_REGS).
__global__ void __launch_bounds__(kThreads, 4)
    pair_grad_scalar_kernel(const float* __restrict__ x, const float* __restrict__ y,
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

}  // namespace scalar

}  // namespace

extern "C" {

// x, y (B, T, C) float32, contiguous; trans (B, C, C) float32 read through
// its element strides (sb, si, sj): a stride-0 expanded table is read in
// place; z (B,) float32; lengths (B,) int32; out (B, C, C) float32. part:
// scratch of B * runs * C * C doubles where runs = ceil(T / frames) > 1
// (else unused, may be null); tickets: B * ceil(C / 64)^2 uint32 counters,
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
  return launch(x, y, trans, z, lengths, out, part, tickets, B, T, C, sb, si, sj, frames,
                device, stream);
}

// The scalar route's launch, any C (hsmm_cuda routes C <= 32 to it): the
// arguments as hsmm_pair_grad's, `part` B * runs * C * C floats, `tickets`
// B * ceil(C / 32)^2 counters, `frames` from hsmm_cuda.pair_grad_tile.
int hsmm_pair_grad_scalar(const void* x, const void* y, const void* trans,
                          const void* z, const void* lengths, void* out, void* part,
                          void* tickets, int B, int T, int C, int sb, int si, int sj,
                          int frames, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 0 || T < 0 || C < 0 || frames < 1 || sb < 0 || si < 0 || sj < 0 ||
      device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0) return 0;
  const long sides = (C + scalar::kTile - 1) / scalar::kTile;
  const long runs = T > frames ? (T + (long)frames - 1) / frames : 1;
  if (B > 65535 || runs > 65535 || sides * sides > INT_MAX ||
      (runs > 1 && (!part || !tickets)))
    return (int)cudaErrorInvalidValue;
  scalar::pair_grad_scalar_kernel<<<dim3((unsigned int)(sides * sides), (unsigned int)runs, B),
                                    dim3(scalar::kTile, scalar::kRowsY), 0,
                                    (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (const float*)trans, (const float*)z,
      (const int*)lengths, (float*)out, (float*)part, (unsigned int*)tickets, T, C, sb, si,
      sj, frames);
  return (int)cudaGetLastError();
}

}  // extern "C"
