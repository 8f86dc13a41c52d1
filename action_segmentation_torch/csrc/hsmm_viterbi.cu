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
// Traceback, per video (one block): the walk from (t = length, c = the
// best final class) reads d = bp_d + 1 at (t - 1, c), sets s = t - d,
// spans[s] = c, and for s > 0 takes the previous class bp_c at (s - 1, c)
// and that class's duration from the same row. The walk only moves back in
// time, so the block stages the code rows it can still reach, [0, length),
// in shared memory, in tiles of R rows from the top down (R from
// ops/hsmm_cuda.py `traceback_tile`). One thread issues a tile's
// contiguous R * C codes as a 1-D bulk copy (cp.async.bulk, completing on
// an mbarrier; the at most 3 + 3 words outside its 16-byte-aligned body
// by plain loads). Then the block's 16 staging warps rewrite each row r
// in place into the pair the walk needs,
//   g(r, c) = (c' = bp_c(r, c), d' = bp_d(r, c') + 1),
// a gather within the row. Warp 0 does nothing but walk, on one lane: in
// state (u = s - 1, c) it reads g(u, c), stores spans[u + 1 - d'] = c' and
// moves to (u - d', c'). The first segment reads its code from global
// memory while tile 0 lands. Two buffers: while the walker runs in one
// tile, the staging warps fill the other with the tile below; a jump that
// lands below it costs one round in which the wanted tile is staged and
// the walker waits. Each hand-off is a named barrier over the block
// (bar 1); the staging warps meet on their own (bar 2), never with the
// walker mid-tile. Every thread fills the spans row with -1 first, and
// the span stores are fire-and-forget.
//
// Codes: bp_c < 128 because C <= 128, and bp_d < Km; the code stays in
// int32 for every Km the shared-memory tail admits. g keeps d' << 9 and
// c' << 2 (the walker's byte offset) in one int32.
//
// A wide DP (C > 128, csrc/hsmm_scan_wide.cu's codes) packs its codes at
// a power-of-two radix >= C (ops/hsmm_cuda.py `code_radix`: 1,024 up to
// 1,024 classes, 2,048 at 1,577) and takes its own traceback,
// `traceback_wide_kernel` (W2), two warps a video, which takes the radix
// as a launch argument, its log2 (`shift`), and decodes a code by that
// shift and a mask: one instance for every wide radix, the walk's chain
// unchanged (the shift and the mask sit in registers, not in the
// instructions' immediates). A video's plane is then up to 1,024 times as
// many codes as the walk reads (350,208 at 342 classes and 1,024 frames
// for about 900 segments), so rewriting each code into g, as the narrow
// kernel does, cost more than the walk: W2 reads the raw codes. In state
// (u, c) the walker loads bp(u, c), whose class part is c', then bp(u, c')
// in the same row, whose duration part gives d'; two dependent
// shared-memory loads a segment and no pass over the plane. The rows it
// can reach, [0, length - 1) (the first segment reads row length - 1 from
// global memory while the first tiles land), stream from the top down
// through a ring of S slots of R rows (R and S from ops/hsmm_cuda.py
// `wide_traceback_tile`). Each tile is one cp.async.bulk, widened to the
// 16-byte lines around its rows so that it needs no fix-up loads (the
// codes tensor is 16-byte aligned, so the widened copy stays within it),
// onto its slot's `full` mbarrier. One lane of warp 1 issues them: the
// first S at once, then tile j once the walker has arrived on the `empty`
// mbarrier of tile j - S's slot (the usual producer and consumer pair: the
// arrive orders the walker's reads before the copy, with no proxy fence).
// The walker, lane 0 of warp 0, waits on a tile's `full` mbarrier only
// when it enters that tile; a jump longer than a tile leaves the tiles it
// passes over once they have landed, so that each mbarrier moves one
// round at a time. The other lanes only fill the spans row with -1. In
// the walk loop the next load's address is bp(u, c')'s address less d'
// rows, and the load is predicated on the next row being in the tile, a
// compare of the code itself against (u - lo) << 10 beside the address's
// arithmetic; a segment's span is stored one link later, while the next
// loads are in flight, and only the last, which alone can start before
// frame 0, takes the wrap. A slot holds at least one row: past 14,521
// classes a row of codes does not fit one of 4 slots, and the wrapper
// refuses the plane. The chain is then the two loads, a mask and a
// multiply-add for c', a shift and a multiply-add for the next address.
// Nothing is packed, so W2 takes any T.
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
// at most one a cycle). The traceback is a serial chain too, one link a
// segment: a shared-memory load of g, a shift and a subtract for u, a
// clamp into the tile and the next address (u * 4C + 4c'). The next load
// issues before the span's store and the tile check, so that in-order
// issue keeps their instructions off the chain (behind them it took 123
// cycles a segment, not 82). So the video with the most segments, times
// that chain's latency, bounds it, plus staging its first tile
// (tools/scan_floor.py reads the chain from the SASS: 46 cycles at its
// assumed latencies). W2 is bound the same way, by its longest video's
// segments times its two-load chain, plus its first tile's arrival.
//
// ptxas (-Xptxas -v, sm_90a): the serving instance (one warp, row 24,
// no tail) takes 133 registers, the traceback 41, no spills;
// chip_smoke.py's build phase prints every kernel.

#include <climits>

#include "hsmm_scan_core.cuh"

namespace {

constexpr int kLanes = hsmm_scan::kCodeRadix;

// the traceback's block: warp 0 walks, kStageWarps warps stage
constexpr int kStageWarps = 16;
constexpr int kStageThreads = 32 * kStageWarps;
constexpr int kTracebackThreads = 32 + kStageThreads;
// dynamic shared memory: the mbarrier and two hand-off slots, then two
// tile buffers of buffer_words(R, C) words each
constexpr int kHeaderBytes = 16;
// named barriers (0 is __syncthreads)
constexpr int kHandoff = 1;  // the whole block, between rounds
constexpr int kStaged = 2;   // the staging warps, once a tile has landed

// a tile of R rows, placed 0-3 words in so that its 16-byte-aligned body
// lands 16-byte-aligned, in a buffer that keeps the next one aligned
__host__ __device__ constexpr int buffer_words(int rows, int C) {
  return (rows * C + 3 + 3) & ~3;
}

__host__ __device__ constexpr int traceback_smem(int rows, int C) {
  return kHeaderBytes + 2 * 4 * buffer_words(rows, C);
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ int ld_shared(uint32_t addr) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("barrier.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void mbarrier_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbarrier_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbarrier_arrive_expect_tx(uint32_t bar,
                                                          int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// a fire-and-forget store of `value` to `p`, skipped unless `ok`: a
// predicated store with no branch around it
__device__ __forceinline__ void store_if(int64_t* p, int64_t value, bool ok) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "@p st.global.b64 [%0], %1;\n"
      "}\n" ::"l"(p),
      "l"(value), "r"((int)ok)
      : "memory");
}

// global -> shared, `bytes` a multiple of 16 from 16-byte-aligned
// addresses, counted against the mbarrier's expected bytes
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the words a tile of `plane` starting at row `lo` sits in from its buffer
__device__ __forceinline__ int tile_pad(const int32_t* plane, int lo, int C) {
  return (int)((reinterpret_cast<uintptr_t>(plane + (size_t)lo * C) >> 2) & 3);
}

// log2 of the walker's g shift: 4 * kRadix, the byte offsets' span
__host__ __device__ constexpr int shift_of(int radix) {
  return radix == 1 ? 2 : 1 + shift_of(radix / 2);
}

// The walk with codes at radix kRadix (bp = bp_d * kRadix + bp_c).
template <int kRadix>
__device__ __forceinline__ void traceback(const int32_t* __restrict__ bp,
                                          const int64_t* __restrict__ lengths,
                                          const int64_t* __restrict__ c_last,
                                          int64_t* __restrict__ spans, int T,
                                          int C, int R) {
  constexpr int kPerLane = kRadix / 32;  // a staging group's codes a lane
  constexpr int kShift = shift_of(kRadix);
  // (not `smem`: the scan template's kernel declares that one as float)
  extern __shared__ __align__(16) unsigned char tb_smem[];
  const uint32_t bar = shared_addr(tb_smem);
  volatile int* need = reinterpret_cast<volatile int*>(tb_smem + 8);
  int32_t* const buf0 = reinterpret_cast<int32_t*>(tb_smem + kHeaderBytes);
  const int words = buffer_words(R, C);

  const int b = blockIdx.x;
  const int32_t* plane = bp + (size_t)b * T * C;
  int64_t* row = spans + (size_t)b * T;
  const int length = (int)lengths[b];
  const int lane = threadIdx.x & 31;
  const bool walker = threadIdx.x < 32;
  const int st = threadIdx.x - 32;  // the staging thread's index
  // tile k holds rows [lo(k), length - k R)
  auto tile_lo = [&](int k) { return max(0, length - (k + 1) * R); };

  for (int t = threadIdx.x; t < T; t += kTracebackThreads) row[t] = -1;
  if (st == 0) mbarrier_init(bar);
  __syncthreads();

  // staging: this lane's entries in a group of whole rows (at most kRadix
  // entries, kPerLane a lane) and their rows' first entries (at radix 1024
  // worked out as needed, not held in 32 registers)
  const int per = (kRadix / C) * C;
  int eq[kPerLane], rq[kPerLane <= 4 ? kPerLane : 1];
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    eq[q] = lane + 32 * q;
    if constexpr (kPerLane <= 4) rq[q] = eq[q] / C * C;
  }
  auto row_first = [&](int q) {
    if constexpr (kPerLane <= 4) {
      return rq[q];
    } else {
      return eq[q] / C * C;
    }
  };
  uint32_t parity = 0;
  auto stage = [&](int k, int32_t* buf) {
    const int lo = tile_lo(k);
    const int n = (length - k * R - lo) * C;
    const int32_t* src = plane + (size_t)lo * C;
    const int pad = tile_pad(plane, lo, C);
    int32_t* tile = buf + pad;
    const int head = min(n, (4 - pad) & 3);
    const int body = (n - head) & ~3;
    if (st == 0) {
      if (body > 0) {
        mbarrier_arrive_expect_tx(bar, 4 * body);
        bulk_copy(shared_addr(tile + head), src + head, 4 * body, bar);
      } else {
        mbarrier_arrive(bar);
      }
    }
    if (st < head) tile[st] = src[st];
    if (st >= 32 && head + body + st - 32 < n)
      tile[head + body + st - 32] = src[head + body + st - 32];
    mbarrier_wait(bar, parity);
    parity ^= 1;
    named_sync(kStaged, kStageThreads);
    // g in place, a warp per group of rows: every lane reads its entries
    // and their gathers before any lane of the warp writes
    for (int base = (st >> 5) * per; base < n; base += kStageWarps * per) {
      int g[kPerLane];
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int e = base + eq[q];
        if (eq[q] < per && e < n) {
          const int cp = tile[e] & (kRadix - 1);
          const int d = tile[base + row_first(q) + cp] / kRadix + 1;
          g[q] = d << kShift | cp << 2;
        }
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int e = base + eq[q];
        if (eq[q] < per && e < n) tile[e] = g[q];
      }
    }
    // these generic writes come before the bulk copy that next fills it
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  };

  // the walker's state (lane 0): row u = s - 1 of the segment that starts
  // at s, its class as a byte offset c4 = 4c; done when u < 0
  int u = -1, c4 = 0;
  auto put = [&](int s, int c) {
    // a start before frame 0 can only come from an impossible (BIG_NEG)
    // path; it wraps like the reference's negative index and ends the walk
    const int w = s >= 0 ? s : s + T;
    store_if(row + w, c, w >= 0);
  };
  auto wanted = [&]() { return u < 0 ? -1 : (length - 1 - u) / R; };

  // round 0: tile 0 lands while the walker takes the first segment from
  // global memory
  int slot = 0;
  if (walker) {
    if (lane == 0) {
      if (length > 0) {
        const int c = (int)c_last[b];
        const int s = length - (plane[(size_t)(length - 1) * C + c] / kRadix + 1);
        put(s, c);
        u = s - 1;
        c4 = 4 * c;
      }
      need[slot] = wanted();
    }
    __syncwarp();
  } else if (length > 0) {
    stage(0, buf0);
  }
  named_sync(kHandoff, kTracebackThreads);

  // each round: the walker walks the tile it wants if the last round
  // staged it, while the staging warps fill the other buffer with the
  // tile below it (or, if not, with the tile it wants)
  int staged = 0, sb = 0;
  for (;;) {
    const int want = need[slot];
    slot ^= 1;
    if (want < 0) break;
    const bool ready = want == staged;
    const int next = !ready ? want : tile_lo(want) > 0 ? want + 1 : -1;
    if (walker) {
      if (lane == 0) {
        if (ready) {
          const int lo = tile_lo(want);
          const uint32_t rowb = 4 * C;
          const uint32_t base =
              shared_addr(buf0 + sb * words + tile_pad(plane, lo, C)) -
              (uint32_t)lo * rowb;
          // one link a segment: the next load issues before the span
          // store and the exit test (in-order issue would otherwise put
          // their instructions on the chain); past the tile's bottom it
          // reads row lo, unused
          int v = ld_shared(base + (uint32_t)u * rowb + c4);
          for (;;) {
            u -= v >> kShift;
            c4 = v & (4 * kRadix - 4);
            v = ld_shared(base + (uint32_t)max(u, lo) * rowb + c4);
            put(u + 1, c4 >> 2);
            if (u < lo) break;
          }
        }
        need[slot] = wanted();
      }
      __syncwarp();
    } else if (next >= 0) {
      stage(next, buf0 + (sb ^ 1) * words);
    }
    named_sync(kHandoff, kTracebackThreads);
    staged = next;
    sb ^= 1;
  }
}

__global__ void __launch_bounds__(kTracebackThreads)
    viterbi_traceback_kernel(const int32_t* __restrict__ bp,
                             const int64_t* __restrict__ lengths,
                             const int64_t* __restrict__ c_last,
                             int64_t* __restrict__ spans, int T, int C,
                             int R) {
  traceback<kLanes>(bp, lengths, c_last, spans, T, C, R);
}

// ---- W2: the wide traceback (codes at radix 1 << shift), one warp a video ----

// W2's block: warp 0's lane 0 walks, warp 1's lane 0 issues the copies
constexpr int kWideThreads = 64;
constexpr int kWideMaxStages = 16;

// a slot: R rows of C codes widened to the 16-byte lines around them
__host__ __device__ constexpr long long wide_slot_words(long long rows,
                                                        long long C) {
  return (rows * C + 6) & ~3LL;
}

// dynamic shared memory: two mbarriers a slot, then the S slots
__host__ __device__ constexpr long long wide_header_bytes(long long stages) {
  return 16 * stages;
}

__host__ __device__ constexpr long long wide_traceback_smem(long long rows,
                                                            long long stages,
                                                            long long C) {
  return wide_header_bytes(stages) + stages * 4 * wide_slot_words(rows, C);
}

__device__ __forceinline__ void mbarrier_wait_round(uint32_t bar, int round) {
  mbarrier_wait(bar, (uint32_t)round & 1);
}

// v = the shared word at `addr` if code < lim, else v unchanged: the walk's
// next load, issued only when the next row is in the tile
__device__ __forceinline__ int ld_shared_if_below(int v, uint32_t addr,
                                                  int code, int lim) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.lt.s32 p, %2, %3;\n"
      "@p ld.shared.b32 %0, [%1];\n"
      "}\n"
      : "+r"(v)
      : "r"(addr), "r"(code), "r"(lim));
  return v;
}

// a plain store of a span, in program order with the walk's loads
__device__ __forceinline__ void store_span(int64_t* p, int64_t value) {
  asm volatile("st.global.b64 [%0], %1;" ::"l"(p), "l"(value) : "memory");
}

__global__ void __launch_bounds__(kWideThreads)
    traceback_wide_kernel(const int32_t* __restrict__ bp,
                          const int64_t* __restrict__ lengths,
                          const int64_t* __restrict__ c_last,
                          int64_t* __restrict__ spans, int T, int C, int R,
                          int S, int shift) {
  extern __shared__ __align__(16) unsigned char tb_smem[];
  // slot i's mbarriers: `full` at 8i (its tile landed), `empty` at 8(S + i)
  // (the walker left it)
  const uint32_t full = shared_addr(tb_smem);
  const uint32_t empty = full + 8 * S;
  const uint32_t ring = full + (uint32_t)wide_header_bytes(S);
  const uint32_t slot_bytes = 4 * (uint32_t)wide_slot_words(R, C);
  const uint32_t row_bytes = 4 * (uint32_t)C;
  const uint32_t neg_row = 0u - row_bytes;
  const int mask = (1 << shift) - 1;  // a code's class part

  const int b = blockIdx.x;
  const int32_t* plane = bp + (size_t)b * T * C;
  int64_t* row = spans + (size_t)b * T;
  const int length = (int)lengths[b];
  // the shared walk reads rows [0, top): tile k holds rows [max(0, hi - R),
  // hi) with hi = top - k R, in slot k mod S
  const int top = length - 1;
  const int tiles = top > 0 ? (top + R - 1) / R : 0;
  // the plane from the 16-byte line it starts in: row r's codes start at
  // word r C + off of `lines`
  const int off = (int)((reinterpret_cast<uintptr_t>(plane) >> 2) & 3);
  const int32_t* lines = plane - off;
  const bool walker = threadIdx.x == 0, producer = threadIdx.x == 32;
  // the tile below row hi into slot `s`: one bulk copy of its rows' lines
  auto issue = [&](int hi, int s) {
    const long long first = ((long long)max(0, hi - R) * C + off) & ~3LL;
    const int bytes = (int)(4 * ((((long long)hi * C + off + 3) & ~3LL) - first));
    mbarrier_arrive_expect_tx(full + 8 * s, bytes);
    bulk_copy(ring + s * slot_bytes, lines + first, bytes, full + 8 * s);
  };

  // the producer issues the first S tiles at once, the walker takes the
  // first segment's code from global memory while they land, and every
  // thread fills the spans row with -1
  int c = (int)c_last[b], code0 = 0;
  int issued = 0, ihi = top;  // the producer's next tile and its top row
  if (producer && length > 0) {
    for (int s = 0; s < S; ++s) {
      mbarrier_init(full + 8 * s);
      mbarrier_init(empty + 8 * s);
    }
    for (; issued < min(S, tiles); ++issued, ihi -= R) issue(ihi, issued);
  }
  if (walker && length > 0) code0 = plane[(size_t)top * C + c];
  for (int t = threadIdx.x; t < T; t += kWideThreads) row[t] = -1;
  __syncthreads();  // the mbarriers and the fill before any use
  if (length <= 0 || !(walker || producer)) return;
  if (producer) {
    // tile j into slot j mod S once the walker has left tile j - S
    for (int is = issued % S, ir = issued / S; issued < tiles; ++issued, ihi -= R) {
      mbarrier_wait_round(empty + 8 * is, ir - 1);
      issue(ihi, is);
      if (++is == S) is = 0, ++ir;
    }
    return;
  }

  // the walk's state: u = s - 1 for the segment that starts at s with
  // class c; that segment's span is stored one link later (when the loads
  // of the next are in flight), and the last one's, which alone can start
  // before frame 0, after the walk
  int u = length - (code0 >> shift) - 2;
  int64_t* pending = row + (u + 1);
  int64_t pending_c = c;
  // the walker's tile: its index, top row, slot and round, and whether it
  // has waited for it
  int k = 0, hi = top, ks = 0, kr = 0;
  bool landed = false;
  // leave tile k: free its slot (a tile jumped over once it has landed,
  // so that each slot's mbarriers move one round at a time)
  auto leave = [&]() {
    if (!landed) mbarrier_wait_round(full + 8 * ks, kr);
    mbarrier_arrive(empty + 8 * ks);
    landed = false;
    ++k;
    hi -= R;
    if (++ks == S) ks = 0, ++kr;
  };
  while (u >= 0) {
    while (u < max(0, hi - R)) leave();
    if (!landed) mbarrier_wait_round(full + 8 * ks, kr);
    landed = true;
    // walk tile k: a1 is bp(u, c)'s shared address (row lo sits 0-3 words
    // into the slot)
    const int lo = max(0, hi - R);
    const uint32_t base =
        ring + ks * slot_bytes + 4 * (((uint32_t)lo * (uint32_t)C + off) & 3);
    uint32_t a1 = base + (uint32_t)(u - lo) * row_bytes + 4 * c;
    int v1 = ld_shared(a1);
    for (;;) {
      // c' from bp(u, c), then d' from bp(u, c') in the same row: the
      // mask and a multiply-add (PTX, so that it stays two steps)
      uint32_t a2;
      asm("{\n"
          ".reg .b32 m;\n"
          "and.b32 m, %1, %3;\n"
          "mad.lo.s32 %0, m, 4, %2;\n"
          "}\n"
          : "=r"(a2)
          : "r"(v1), "r"(a1 - 4 * c), "r"(mask));
      const int v2 = ld_shared(a2);
      store_span(pending, pending_c);
      // the next row u - d' is in the tile iff v2 < (u - lo) << shift; the
      // next load, bp(u - d', c') at a2 less d' rows (a shift and a
      // multiply-add by -4C), issues before the exit test
      const int lim = (u - lo) << shift;
      c = v1 & mask;
      asm("{\n"
          ".reg .s32 d;\n"
          "shr.s32 d, %1, %4;\n"
          "mad.lo.s32 %0, d, %2, %3;\n"
          "}\n"
          : "=r"(a1)
          : "r"(v2), "r"(neg_row), "r"(a2 + neg_row), "r"(shift));
      v1 = ld_shared_if_below(v1, a1, v2, lim);
      u -= (v2 >> shift) + 1;
      pending = row + (u + 1);
      pending_c = c;
      if (v2 >= lim) break;
    }
  }
  // the last span: a start before frame 0 can only come from an impossible
  // (BIG_NEG) path; it wraps like the reference's negative index
  const int w = u + 1 >= 0 ? u + 1 : u + 1 + T;
  store_if(row + w, pending_c, w >= 0);
  // leave every tile left, so that the producer issues them all and each
  // copy lands before the block exits
  while (k < tiles) leave();
}

// One launch of `kernel` over codes of at most `max_c` classes.
int launch_traceback(void (*kernel)(const int32_t*, const int64_t*,
                                    const int64_t*, int64_t*, int, int, int),
                     int max_c, const void* bp, const void* lengths,
                     const void* c_last, void* spans, int N, int T, int C,
                     int rows, int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C < 1 || C > max_c || rows < 1 || smem < traceback_smem(rows, C))
    return (int)cudaErrorInvalidValue;
  if (N == 0 || T == 0) return 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<N, kTracebackThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)bp, (const int64_t*)lengths, (const int64_t*)c_last,
      (int64_t*)spans, T, C, rows);
  return (int)cudaGetLastError();
}

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
      trans, init, dur, emit, nullptr, alphas, bp, nullptr, N, T, C, Km, warps,
      row, tail, smem, device, stream);
}

// bp (N, T, C) int32 from hsmm_viterbi_scan; lengths (N,) int64, each in
// [1, T]; c_last (N,) int64, the best final class; spans (N, T) int64 out:
// the class at each span start, -1 elsewhere. rows is the tile's code rows
// and smem its dynamic shared memory in bytes, as ops/hsmm_cuda.py
// `traceback_tile` gives them; a launch whose smem cannot hold two tiles
// of rows is refused.
int hsmm_viterbi_traceback(const void* bp, const void* lengths,
                           const void* c_last, void* spans, int N, int T,
                           int C, int rows, int smem, int device,
                           void* stream) {
  return launch_traceback(viterbi_traceback_kernel, kLanes, bp, lengths,
                          c_last, spans, N, T, C, rows, smem, device, stream);
}

// The same for a wide DP's codes (C > 128, radix 1 << shift >= C) from
// csrc/hsmm_scan_wide.cu's `hsmm_wide_viterbi_scan`, by W2: rows and stages
// are the ring's slot rows and slot count and smem its dynamic shared
// memory in bytes, as ops/hsmm_cuda.py `wide_traceback_tile` gives them.
// bp must be 16-byte aligned (each tile is copied in whole 16-byte lines);
// a launch whose smem cannot hold the ring, whose radix is below C, or
// whose slot rows at that radix pass int32 is refused.
int hsmm_viterbi_traceback_wide(const void* bp, const void* lengths,
                                const void* c_last, void* spans, int N, int T,
                                int C, int rows, int stages, int smem,
                                int shift, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C <= kLanes || shift < 0 || shift > 30 || (1LL << shift) < C ||
      rows < 1 || ((long long)rows << shift) > INT_MAX || stages < 1 ||
      stages > kWideMaxStages || (reinterpret_cast<uintptr_t>(bp) & 15) ||
      smem < wide_traceback_smem(rows, stages, C))
    return (int)cudaErrorInvalidValue;
  if (N == 0 || T == 0) return 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(traceback_wide_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  traceback_wide_kernel<<<N, kWideThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)bp, (const int64_t*)lengths, (const int64_t*)c_last,
      (int64_t*)spans, T, C, rows, stages, shift);
  return (int)cudaGetLastError();
}

}  // extern "C"
