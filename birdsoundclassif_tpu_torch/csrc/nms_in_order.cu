// Greedy in-order NMS over a valid prefix, for Hopper (sm_90a).
//
// Replaces the TPU kernel birdsoundclassif_tpu/ops/pallas_nms.py:
// nms_in_order_pallas (body _make_kernel). Semantics are those of
// greedy_nms_in_order(valid_prefix=True) in both packages' ops/nms.py:
// boxes (B, N, 4) float32 arrive already in greedy order with the valid
// entries as a prefix of length n_valid[b]; box j is dropped iff some KEPT
// i < j has IoU(i, j) >= iou_thresh, where
// IoU = inter / (area_i + area_j - inter) with +1 widths and heights.
// Entries at or past n_valid are never kept. Output: keep (B, N) bool.
//
// What bounds it on this card. Two things, and they are kept apart:
//  (a) the chain: whether box i is kept depends on every earlier decision,
//      so n_valid decisions are made one after another whatever else is
//      parallel. This is latency, not bytes (17 bytes a box) and not
//      arithmetic.
//  (b) the IoU compares, about 16 float operations and one IEEE division a
//      pair, up to n_valid^2 / 2 pairs a row: FP32 operations outside the
//      tensor cores. There is no matrix product here, so wgmma has nothing
//      to do and the kernels use no tensor cores.
//
// Design: the IoU work is taken out of the chain.
//  1. Mask phase (nms_mask_kernel), parallel over the card. For every pair
//     i < j < n_valid one bit, IoU(i, j) >= thresh, packed in 64-bit words:
//     word w of pivot i holds columns 64w .. 64w+63. The grid is
//     (column tile, row tile, batch row) of 64x64 tiles, sized from N with
//     no host read of n_valid; a block below the diagonal or wholly at or
//     past n_valid returns at once. The tile's 64 pivot boxes and 64 column
//     boxes (and areas) are staged in shared memory; each of 512 threads
//     compares one pivot with 8 columns, the bytes meet in shared memory
//     and 64 threads write the tile's 64 words, which lie together in
//     device memory. At N >= 2,600 that is hundreds of blocks for each
//     batch row, not one. A quick test in front of the exact compare (see
//     QuickTest) keeps the IEEE division, whose slow-path branch stops
//     neighbouring compares from overlapping, for the pairs near the
//     threshold.
//  2. Scan phase (nms_scan_kernel), one block a batch row, 64 pivots a
//     step. A `removed` bitset of N/64 words lives in shared memory. For a
//     chunk of 64 pivots the keep decisions depend only on the incoming
//     removed word and the chunk's diagonal 64x64 bits, so one warp
//     resolves them in registers with no barrier: in a few data-parallel
//     rounds where the data allow, else in 64 dependent bit tests. Then
//     each warp takes removed words to the right of the chunk and ORs the
//     KEPT pivots' words into them (a dropped pivot's word is ignored).
//     Two block barriers a chunk, none a pivot, no atomics.
//  3. The mask does not depend on the decisions, so the scan has the rows
//     of the next chunks copied into a ring of shared-memory buffers while
//     it decides the current one: one TMA bulk copy a segment
//     (cp.async.bulk) that completes a transaction barrier (mbarrier), out
//     of L2, where the mask phase left the words. The tiles of one row
//     tile lie together, diagonal first, so what a chunk needs is one
//     contiguous run whatever n_valid is. No thread spends instructions or
//     waits on the copy, and the trip to L2 is off the chain. A chunk needs
//     its diagonal tile alone to decide, and the tiles right of it only to
//     OR the kept pivots' words into `removed`; so a row too long for two
//     buffers of its whole run (N > 14,400) streams the run through the
//     ring in segments of a fixed number of tiles, and shared memory holds
//     N / 8 bytes of `removed` and a fixed ring whatever N is.
//  4. Small rows (nms_fused_kernel): where one block is quick enough for
//     all the compares of its row, one launch, one block a batch row, does
//     both phases in shared memory and writes no mask to device memory.
//  The mask scratch is uninitialised memory. The scan reads only tiles the
//  mask phase wrote: row tile <= column tile, column tile below n_valid.
//
// Bit-exact keep masks: ties at the threshold flip boxes, so the IoU uses
// the reference's operation order with explicit round-to-nearest
// intrinsics (no FMA contraction; the build also passes --fmad=false),
// IEEE division, and a float32 compare against a float32 threshold. A NaN
// IoU (0/0) compares false. Bits are combined with OR only, so the result
// does not depend on the order in which threads arrive.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kWord = 64;          // pivots a chunk, columns a mask word, words a tile
constexpr int kThreads = 512;      // scan and fused kernels
constexpr int kPiece = 8;          // columns a thread of the mask kernel compares
constexpr int kMaskThreads = kWord * (kWord / kPiece);  // 512: one 64x64 tile a block
constexpr int kMaxSmem = 232448;   // 227 KB: the most one Hopper block may use
constexpr int kFusedMaxN = 1024;   // the longest row nms_fused_launch takes
constexpr int kMaxRing = 4;        // buffers of the scan's ring, at most
constexpr int kMaxSegment = kThreads;  // tiles a buffer, at most: 16 warps OR at most 32
                                       // words each in one go, one result a lane
constexpr int kRounds = 12;        // rounds of the warp resolve before the serial walk
constexpr int kMaxDevices = 64;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kCopier = 32;        // the thread that hands out the copies: not in warp 0,
                                   // which resolves the chunk and must not wait for it

__host__ __device__ __forceinline__ int words_of(int n) { return (n + kWord - 1) / kWord; }

// The mask of one batch row is the upper triangle of a wmax x wmax grid of
// tiles, wmax = words_of(N). Tile (rt, ct), rt <= ct, is 64 words: word r is
// pivot 64 rt + r against columns 64 ct .. 64 ct + 63. Row tile rt's tiles
// lie together, ct = rt first. tile_index is the tile's place in the row's
// scratch, in tiles.
__host__ __device__ __forceinline__ int tile_index(int rt, int ct, int wmax) {
  return rt * wmax - rt * (rt - 1) / 2 + (ct - rt);
}
__host__ __device__ __forceinline__ int tiles_of(int wmax) { return wmax * (wmax + 1) / 2; }

__device__ __forceinline__ int clamp_n_valid(int nv, int n) {
  return nv < 0 ? 0 : (nv > n ? n : nv);
}

__device__ __forceinline__ float area_plus1(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

__device__ __forceinline__ bool iou_ge(float4 bi, float ai, float4 bj, float aj,
                                       float iou_thresh) {
  const float iw = fmaxf(
      __fadd_rn(__fsub_rn(fminf(bj.z, bi.z), fmaxf(bj.x, bi.x)), 1.0f), 0.0f);
  const float ih = fmaxf(
      __fadd_rn(__fsub_rn(fminf(bj.w, bi.w), fmaxf(bj.y, bi.y)), 1.0f), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float iou = __fdiv_rn(inter, __fsub_rn(__fadd_rn(aj, ai), inter));
  return iou >= iou_thresh;
}

// A quick test in front of the exact compare. The exact IoU ends in an
// IEEE division whose slow-path branch keeps neighbouring compares from
// overlapping; most pairs are nowhere near the threshold and need no
// exact quotient. q = inter * rcp.approx(union) is within 2^-21 of the
// real quotient (reciprocal 1 ulp, product half an ulp), and the exact
// compare looks at that quotient rounded to nearest. So q > t (1 + 2^-16)
// means the exact compare holds, and q < t (1 - 2^-16) means it does not;
// whatever lies between, and whatever is NaN, is `unsure` and goes through
// iou_ge itself. Ranges where the approximation flushes to zero: a union
// below the normal range gives q = +-inf or NaN, which agree with the exact
// quotient's side for a threshold within [2^-20, 2^20] because inter is 0
// or at least 2^-48 (each side of the overlap is 0 or at least 2^-24 after
// the +1); a union of 2^100 or more is never called "below". A threshold
// outside [2^-20, 2^20] sets the bounds to -inf and +inf: every pair is
// unsure and the result is the exact compare's, only slower.
struct QuickTest {
  float below, above;
};

__device__ __forceinline__ QuickTest quick_test(float iou_thresh) {
  const bool ok = iou_thresh >= 0x1p-20f && iou_thresh <= 0x1p20f;
  QuickTest t;
  t.below = ok ? __fmul_rn(iou_thresh, 1.0f - 0x1p-16f) : -__int_as_float(0x7f800000);
  t.above = ok ? __fmul_rn(iou_thresh, 1.0f + 0x1p-16f) : __int_as_float(0x7f800000);
  return t;
}

// ge: the exact compare surely holds. unsure: ask iou_ge.
__device__ __forceinline__ void iou_quick(float4 bi, float ai, float4 bj, float aj, QuickTest t,
                                          bool& ge, bool& unsure) {
  const float iw = fmaxf(
      __fadd_rn(__fsub_rn(fminf(bj.z, bi.z), fmaxf(bj.x, bi.x)), 1.0f), 0.0f);
  const float ih = fmaxf(
      __fadd_rn(__fsub_rn(fminf(bj.w, bi.w), fmaxf(bj.y, bi.y)), 1.0f), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(aj, ai), inter);
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(uni));
  const float q = __fmul_rn(inter, y);
  ge = q > t.above;
  unsure = !(ge || (q < t.below && fabsf(uni) < 0x1p100f));
}

// Eight suppression bits of one pivot against the eight columns whose
// boxes and areas are cbox[0..7] and carea[0..7]: bit k is set iff
// IoU(pivot, column k) >= thresh. Fixed bounds and no branch inside, so the
// compares unroll and overlap; the unsure ones are settled afterwards.
__device__ __forceinline__ unsigned mask_piece(float4 bi, float ai, const float4* cbox,
                                               const float* carea, float iou_thresh) {
  const QuickTest t = quick_test(iou_thresh);
  unsigned bits = 0, open = 0;
#pragma unroll
  for (int k = 0; k < kPiece; ++k) {
    bool ge, unsure;
    iou_quick(bi, ai, cbox[k], carea[k], t, ge, unsure);
    bits |= static_cast<unsigned>(ge) << k;
    open |= static_cast<unsigned>(unsure) << k;
  }
  while (open != 0u) {
    const int k = __ffs(open) - 1;
    open &= open - 1u;
    bits |= static_cast<unsigned>(iou_ge(bi, ai, cbox[k], carea[k], iou_thresh)) << k;
  }
  return bits;
}

// Clears, in pivot i's word over columns j0 .. j0+63, the bits at or left
// of the diagonal (j <= i) and at or past nv; j0 < nv.
__device__ __forceinline__ u64 clear_outside(u64 bits, int i, int j0, int nv) {
  const int lo = i + 1 - j0;  // first column right of the diagonal
  const int hi = nv - j0;     // first column at or past nv, at least 1
  if (lo > 0) bits &= lo >= kWord ? 0ull : ~0ull << lo;
  if (hi < kWord) bits &= ~(~0ull << hi);
  return bits;
}

// The removed word a chunk starts from: columns at or past nv count as
// removed, so they are never kept and never act as pivots.
__device__ __forceinline__ u64 initial_removed(int w, int nv) {
  const int left = nv - w * kWord;  // valid columns in this word
  return left >= kWord ? 0ull : (left <= 0 ? ~0ull : ~0ull << left);
}

// One 64-bit word from shared memory (32-bit address), as a load the
// compiler neither moves under a branch nor predicates.
__device__ __forceinline__ void lds64(unsigned addr, unsigned& lo, unsigned& hi) {
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];" : "=r"(lo), "=r"(hi) : "r"(addr));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Keep decisions of one chunk of 64 pivots, the serial way. diag[i] is
// pivot i's word over the chunk's own columns (bits j <= i are 0). Pivot i
// is kept iff bit i of `removed` is clear when its turn comes; a kept pivot
// ORs its word in, a dropped one is ignored. Bit i cannot change after
// step i, so the kept set is the complement of the final word. A step is
// one bit test and one select-and-OR, in 32-bit halves; the low half of
// words 32..63 is 0 (bits j <= i).
__device__ __forceinline__ u64 resolve_serial(const u64* diag, u64 removed) {
  unsigned dlo[kWord], dhi[kWord];
  const unsigned base = smem_addr(diag);
#pragma unroll
  for (int i = 0; i < kWord; ++i) {
    lds64(base + static_cast<unsigned>(i * sizeof(u64)), dlo[i], dhi[i]);
  }
  unsigned lo = static_cast<unsigned>(removed);
  unsigned hi = static_cast<unsigned>(removed >> 32);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (!(lo & (1u << i))) {
      lo |= dlo[i];
      hi |= dhi[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (!(hi & (1u << i))) hi |= dhi[32 + i];
  }
  return ~((static_cast<u64>(hi) << 32) | lo);
}

// The same decisions by one whole warp, in rounds. The kept set K is the
// one solution of K[j] = !removed[j] && no kept i < j has bit j in its
// word (one solution, because position j depends on earlier positions
// only). A round recomputes every position at once from the last guess:
// each lane holds two pivots' words, the words of the pivots kept in the
// guess are ORed across the warp (redux.sync), and the complement is the
// next guess. Starting from "all kept", round t makes positions 0..t
// right, and a guess that a round leaves unchanged is the solution. The
// rounds needed are the longest chain of boxes each dropped or saved by
// the one before, a handful in real data, so this is the short way through
// the serial chain; after kRounds without a fixed point the serial walk
// decides. Both give the same set.
__device__ __forceinline__ u64 resolve_chunk(const u64* diag, u64 removed) {
  const int lane = threadIdx.x & 31;
  const u64 d0 = diag[lane], d1 = diag[lane + 32];
  u64 kept = ~removed;
  for (int round = 0; round < kRounds; ++round) {
    const u64 mine = (((kept >> lane) & 1ull) ? d0 : 0ull) |
                     (((kept >> (lane + 32)) & 1ull) ? d1 : 0ull);
    const unsigned lo = __reduce_or_sync(kFullWarp, static_cast<unsigned>(mine));
    const unsigned hi = __reduce_or_sync(kFullWarp, static_cast<unsigned>(mine >> 32));
    const u64 next = ~(removed | (static_cast<u64>(hi) << 32) | lo);
    if (next == kept) return kept;  // the same in every lane
    kept = next;
  }
  return resolve_serial(diag, removed);
}

// Warp 0 decides chunk c from its diagonal tile `diag` and the incoming
// removed word; the whole block reads the result. The caller puts a block
// barrier between two chunks.
__device__ __forceinline__ u64 decide_chunk(const u64* diag, int c, const u64* removed,
                                            u64* kept_s) {
  if ((threadIdx.x >> 5) == 0) {
    const u64 k = resolve_chunk(diag, removed[c]);
    if (threadIdx.x == 0) *kept_s = k;
  }
  __syncthreads();
  return *kept_s;
}

// ORs the kept pivots' words of one chunk into removed[w0 .. w1 - 1], run by
// the whole block: tiles[(w - w0) * 64 + r] is word w of the chunk's pivot r.
// A word's 64 pivots lie together, so a warp reads them as one row of
// 16-byte loads, two pivots a lane, and combines them with two warp-wide
// ORs; one warp owns a removed word, so there are no atomics. A dropped
// pivot's word is ignored.
__device__ __forceinline__ void or_kept_words(const u64* tiles, int w0, int w1, u64 kept,
                                              u64* removed) {
  if (kept == 0ull) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const unsigned mine = static_cast<unsigned>(kept >> (2 * lane)) & 3u;
  const u64 on0 = 0ull - (mine & 1u), on1 = 0ull - ((mine >> 1) & 1u);
  // The warp's k-th word is w0 + warp + k * nwarps; lane k keeps its
  // result, and the removed words are written after the loop, so that no
  // store stands between one word's loads and the next one's.
  u64 result = 0;
  int k = 0;
#pragma unroll 4
  for (int w = w0 + warp; w < w1; w += nwarps, ++k) {
    const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(tiles + (w - w0) * kWord + 2 * lane);
    const u64 both = (v.x & on0) | (v.y & on1);
    const unsigned lo = __reduce_or_sync(kFullWarp, static_cast<unsigned>(both));
    const unsigned hi = __reduce_or_sync(kFullWarp, static_cast<unsigned>(both >> 32));
    if (lane == k) result = (static_cast<u64>(hi) << 32) | lo;
  }
  // at most kMaxSegment words over 16 warps: k <= 32 lanes
  if (lane < k && result != 0ull) removed[w0 + warp + lane * nwarps] |= result;
}

__device__ __forceinline__ void write_keep_chunk(bool* out, int c, int n, u64 kept) {
  if (threadIdx.x < kWord) {
    const int j = c * kWord + threadIdx.x;
    if (j < n) out[j] = (kept >> threadIdx.x) & 1ull;
  }
}

// Everything from the first chunk the scan did not visit is not kept.
__device__ __forceinline__ void write_keep_tail(bool* out, int wn, int n) {
  for (int j = wn * kWord + threadIdx.x; j < n; j += blockDim.x) out[j] = false;
}

// ---- mask phase: one block a 64x64 tile of (pivot row, column) pairs ----

__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float4* __restrict__ boxes, const int* __restrict__ n_valid,
                int n, float iou_thresh, u64* __restrict__ mask) {
  const int ct = blockIdx.x, rt = blockIdx.y, b = blockIdx.z;
  if (ct < rt) return;
  const int nv = clamp_n_valid(n_valid[b], n);
  if (ct * kWord >= nv) return;  // rt <= ct, so the row tile starts below nv too

  // [0]: the tile's pivot rows, [1]: its columns
  __shared__ float4 sbox[2][kWord];
  __shared__ float sarea[2][kWord];
  __shared__ u64 sword[kWord];
  const float4* row = boxes + static_cast<size_t>(b) * n;
  const int t = threadIdx.x;
  if (t < 2 * kWord) {
    const int side = t / kWord, k = t % kWord;
    const int j = (side ? ct : rt) * kWord + k;
    const float4 bj = j < nv ? row[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    sbox[side][k] = bj;
    sarea[side][k] = area_plus1(bj);
  }
  __syncthreads();

  // Thread (r, seg): pivot row r against columns 8 seg .. 8 seg + 7, one
  // byte of the row's word. A warp shares seg, so the column boxes are
  // broadcasts.
  const int r = t % kWord, seg = t / kWord;
  reinterpret_cast<unsigned char*>(sword)[r * (kWord / kPiece) + seg] =
      static_cast<unsigned char>(mask_piece(sbox[0][r], sarea[0][r], sbox[1] + seg * kPiece,
                                            sarea[1] + seg * kPiece, iou_thresh));
  __syncthreads();

  if (t < kWord) {
    const int i = rt * kWord + t;
    const u64 bits = i < nv ? clear_outside(sword[t], i, ct * kWord, nv) : 0ull;
    const int wmax = words_of(n);
    const size_t tile = static_cast<size_t>(b) * tiles_of(wmax) + tile_index(rt, ct, wmax);
    mask[tile * kWord + t] = bits;
  }
}

// ---- scan phase: one block a batch row, the next chunks' tiles in flight ----

// A transaction barrier (mbarrier) that one thread arms and the copy engine
// completes: a phase ends when the armed byte count has arrived.
__device__ __forceinline__ void mbar_init(u64* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arm(u64* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of the given parity to end. The wait is bounded: a
// copy that never lands is a fault in this file, and a trap reports it
// where a spin would hang the card.
__device__ __forceinline__ void mbar_wait(u64* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  for (int spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1 << 22)) __trap();
  }
}

// The scan's copies, in order: chunk c needs the tiles (c, c) .. (c, wn - 1),
// one contiguous run in the scratch, diagonal first. The run is cut into
// segments of at most `seg` tiles, and the segments of all chunks go one
// after another through the ring. Segment (c, t) holds the tiles of words
// t .. min(t + seg, wn) - 1; a chunk's first segment starts at t = c.
struct Segment {
  int c, t;
  __device__ __forceinline__ void next(int wn, int seg) {
    t += seg;
    if (t >= wn) t = ++c;
  }
};

// Start the copy of segment `s` into buf: one thread arms the barrier with
// the byte count and hands the run to the copy engine (one TMA bulk copy;
// bytes a multiple of 512, both addresses 16-byte aligned). No thread
// waits on the way: the engine moves the bytes while the block decides
// earlier chunks.
__device__ __forceinline__ void prefetch_segment(u64* buf, u64* bar, const u64* row_tiles,
                                                 int wmax, Segment s, int wn, int seg) {
  const int tiles = min(wn, s.t + seg) - s.t;
  const unsigned bytes = static_cast<unsigned>(tiles * kWord * sizeof(u64));
  const u64* src = row_tiles + static_cast<size_t>(tile_index(s.c, s.t, wmax)) * kWord;
  mbar_arm(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(buf)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The ring's place: `cur`, the buffer of the segment being read, in its
// phase of the given parity (a buffer's k-th use is phase k); `fill`, the
// buffer the segment ring - 1 places later goes to.
struct RingPos {
  int cur, fill, ring;
  unsigned parity;
  __device__ __forceinline__ void advance() {
    fill = fill + 1 == ring ? 0 : fill + 1;
    if (++cur == ring) {
      cur = 0;
      parity ^= 1u;
    }
  }
};

// `ring` buffers of `seg` tiles each (2 to kMaxRing buffers), each with its
// barrier: the copies run ring - 1 segments ahead of the scan, because one
// trip to L2 and back takes longer than one chunk's decisions. The launch
// picks the plan (scan_plan below): where a whole row of tiles
// fits twice (N <= 14,400), seg = wmax and a chunk is one segment
// (kStream false: one copy, one wait and one barrier a chunk, no more);
// longer rows take kMaxRing buffers of as many tiles as fit, so shared
// memory no longer grows with N but for the removed bitset, N / 8 bytes
// (kStream true: a chunk's first segment decides and ORs, the rest OR).
template <bool kStream>
__global__ void __launch_bounds__(kThreads)
nms_scan_kernel(const u64* __restrict__ mask, const int* __restrict__ n_valid, int n, int seg,
                int ring, bool* __restrict__ keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wmax = words_of(n);
  u64* bufs = reinterpret_cast<u64*>(smem_raw);
  const int buf_words = seg * kWord;
  u64* removed = bufs + static_cast<size_t>(ring) * buf_words;
  u64* kept_s = removed + wmax;
  u64* bars = kept_s + 1;

  const int b = blockIdx.x;
  const int nv = clamp_n_valid(n_valid[b], n);
  const int wn = words_of(nv);
  const u64* row_tiles = mask + static_cast<size_t>(b) * tiles_of(wmax) * kWord;
  bool* out = keep + static_cast<size_t>(b) * n;

  for (int w = threadIdx.x; w < wn; w += blockDim.x) removed[w] = initial_removed(w, nv);
  const int ahead = ring - 1;
  Segment fetch = {0, 0};  // the next segment to hand out: the copier's alone
  if (threadIdx.x == kCopier) {
    for (int k = 0; k < ring; ++k) mbar_init(bars + k);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < ahead && fetch.c < wn; ++k) {
      prefetch_segment(bufs + k * buf_words, bars + k, row_tiles, wmax, fetch, wn, seg);
      fetch.next(wn, seg);
    }
  }
  __syncthreads();

  RingPos pos = {0, ahead, ring, 0u};
  // Every segment that was handed out is waited for here, so no copy is in
  // flight when the block ends. After the block barrier the removed words
  // of the segment before are complete and nobody reads its buffer any
  // more: it takes the next segment to hand out.
  auto next_segment = [&]() -> const u64* {
    mbar_wait(bars + pos.cur, pos.parity);
    __syncthreads();
    if (threadIdx.x == kCopier && fetch.c < wn) {
      prefetch_segment(bufs + pos.fill * buf_words, bars + pos.fill, row_tiles, wmax, fetch, wn,
                       seg);
      fetch.next(wn, seg);
    }
    return bufs + pos.cur * buf_words;
  };
  for (int c = 0; c < wn; ++c) {
    const u64* tiles = next_segment();  // the diagonal tile comes first
    const u64 kept = decide_chunk(tiles, c, removed, kept_s);
    or_kept_words(tiles + kWord, c + 1, kStream ? min(wn, c + seg) : wn, kept, removed);
    pos.advance();
    if (kStream) {
      for (int t = c + seg; t < wn; t += seg) {
        tiles = next_segment();
        or_kept_words(tiles, t, min(wn, t + seg), kept, removed);
        pos.advance();
      }
    }
    write_keep_chunk(out, c, n, kept);
  }
  write_keep_tail(out, wn, n);
}

// ---- small rows: both phases in one block's shared memory ----

__global__ void __launch_bounds__(kThreads)
nms_fused_kernel(const float4* __restrict__ boxes, const int* __restrict__ n_valid, int n,
                 float iou_thresh, bool* __restrict__ keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wmax = words_of(n);
  const int rows = wmax * kWord;
  float4* sbox = reinterpret_cast<float4*>(smem_raw);
  u64* smask = reinterpret_cast<u64*>(sbox + rows);  // tiles, as in device memory
  u64* removed = smask + static_cast<size_t>(tiles_of(wmax)) * kWord;
  u64* kept_s = removed + wmax;
  float* sarea = reinterpret_cast<float*>(kept_s + 1);

  const int b = blockIdx.x;
  const int nv = clamp_n_valid(n_valid[b], n);
  const int wn = words_of(nv);
  const float4* row = boxes + static_cast<size_t>(b) * n;
  bool* out = keep + static_cast<size_t>(b) * n;

  const int vrows = wn * kWord;  // the rows and columns the scan visits
  for (int j = threadIdx.x; j < vrows; j += blockDim.x) {
    const float4 bj = j < nv ? row[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    sbox[j] = bj;
    sarea[j] = area_plus1(bj);
  }
  for (int w = threadIdx.x; w < wn; w += blockDim.x) removed[w] = initial_removed(w, nv);
  __syncthreads();

  // Mask phase: one (pivot i, word w) item a warp, each lane two of the 64
  // columns, the word put together by two ballots. A row this short has
  // few items, so spreading an item over a warp is what shortens it.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const QuickTest quick = quick_test(iou_thresh);
  for (int item = warp; item < vrows * wn; item += nwarps) {
    const int i = item % vrows, w = item / vrows;
    if (w < i / kWord) continue;
    unsigned lo = 0, hi = 0;
    if (i < nv) {
      const float4 bi = sbox[i];
      const float ai = sarea[i];
      const int j = w * kWord + lane;
      bool ge0, ge1, open0, open1;
      iou_quick(bi, ai, sbox[j], sarea[j], quick, ge0, open0);
      iou_quick(bi, ai, sbox[j + 32], sarea[j + 32], quick, ge1, open1);
      if (open0) ge0 = iou_ge(bi, ai, sbox[j], sarea[j], iou_thresh);
      if (open1) ge1 = iou_ge(bi, ai, sbox[j + 32], sarea[j + 32], iou_thresh);
      lo = __ballot_sync(kFullWarp, ge0 && j > i && j < nv);
      hi = __ballot_sync(kFullWarp, ge1 && j + 32 > i && j + 32 < nv);
    }
    if (lane == 0) {
      smask[static_cast<size_t>(tile_index(i / kWord, w, wmax)) * kWord + i % kWord] =
          (static_cast<u64>(hi) << 32) | lo;
    }
  }
  __syncthreads();

  for (int c = 0; c < wn; ++c) {
    const u64* tiles = smask + static_cast<size_t>(tile_index(c, c, wmax)) * kWord;
    const u64 kept = decide_chunk(tiles, c, removed, kept_s);
    or_kept_words(tiles + kWord, c + 1, wn, kept, removed);
    write_keep_chunk(out, c, n, kept);
    __syncthreads();
  }
  write_keep_tail(out, wn, n);
}

size_t fused_smem_bytes(int n) {
  const size_t w = words_of(n), rows = w * kWord;
  // the boxes, the tiles, the removed words and the kept word, the areas
  return rows * sizeof(float4) + tiles_of(w) * kWord * sizeof(u64) + (w + 1) * sizeof(u64) +
         rows * sizeof(float);
}

size_t scan_smem_bytes(int n, int seg, int ring) {
  // the buffers, the removed words, the kept word, the barriers
  const size_t w = words_of(n);
  return (static_cast<size_t>(ring) * seg * kWord + w + 1 + ring) * sizeof(u64);
}

// The scan's ring for rows of n boxes: `ring` buffers of `seg` tiles. Where
// a whole row of tiles fits in at least two buffers (n <= 14,400), a buffer
// holds it whole, with as many buffers as fit up to kMaxRing. A longer row
// streams through kMaxRing buffers of as many tiles as fit beside the
// removed bitset, which grows by n / 8 bytes: a tile a buffer still fits at
// n = 1,842,880, far beyond the mask scratch the call needs first (212 GB
// a row there). False when not even that fits.
static_assert(kMaxSmem / (2 * kWord * sizeof(u64)) <= kMaxSegment,
              "a buffer that fits twice in shared memory holds at most kMaxSegment tiles");
bool scan_plan(int n, int* seg, int* ring) {
  const int w = words_of(n);
  for (int r = kMaxRing; r >= 2; --r) {
    if (scan_smem_bytes(n, w, r) <= static_cast<size_t>(kMaxSmem)) {
      *seg = w;
      *ring = r;
      return true;
    }
  }
  const size_t fixed = scan_smem_bytes(n, 0, kMaxRing);
  if (fixed >= static_cast<size_t>(kMaxSmem)) return false;
  *seg = static_cast<int>((kMaxSmem - fixed) / (static_cast<size_t>(kMaxRing) * kWord *
                                                sizeof(u64)));
  *ring = kMaxRing;
  return *seg >= 1;
}

// Raise a kernel's dynamic shared memory limit to the card's most, once a
// device: the launches after the first pay nothing for it.
template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

}  // namespace

extern "C" {

// Every function launches on `stream` and returns cudaGetLastError() (0 on
// success). boxes: (batch, n, 4) float32, contiguous, 16-byte aligned;
// n_valid: (batch,) int32; keep: (batch, n) bool; mask: scratch of
// batch * w (w + 1) / 2 tiles of 64 64-bit words, w = ceil(n / 64),
// 16-byte aligned, uninitialised. All are device pointers.

// One launch, rows of at most 1,024 boxes.
int nms_fused_launch(const void* boxes, const void* n_valid, int batch, int n,
                     float iou_thresh, void* keep, void* stream) {
  static bool done[kMaxDevices] = {};
  if (n > kFusedMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_max_smem(nms_fused_kernel, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_fused_kernel<<<batch, kThreads, fused_smem_bytes(n), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const int*>(n_valid), n, iou_thresh,
      static_cast<bool*>(keep));
  return static_cast<int>(cudaGetLastError());
}

// First of two launches: the suppression bitmask of every valid pair.
int nms_mask_launch(const void* boxes, const void* n_valid, int batch, int n,
                    float iou_thresh, void* mask, void* stream) {
  const dim3 grid(words_of(n), words_of(n), batch);
  nms_mask_kernel<<<grid, kMaskThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const int*>(n_valid), n, iou_thresh,
      static_cast<u64*>(mask));
  return static_cast<int>(cudaGetLastError());
}

// Second of two launches: the chunked scan over the bitmask, with the ring
// scan_plan picks for n.
int nms_scan_launch(const void* mask, const void* n_valid, int batch, int n, void* keep,
                    void* stream) {
  static bool done[2][kMaxDevices] = {};
  int seg = 0, ring = 0;
  if (!scan_plan(n, &seg, &ring)) return static_cast<int>(cudaErrorInvalidValue);
  // a whole row of tiles a buffer, or the row streamed in segments
  const bool stream_row = seg < words_of(n);
  auto kernel = stream_row ? &nms_scan_kernel<true> : &nms_scan_kernel<false>;
  const cudaError_t err = allow_max_smem(kernel, done[stream_row]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, kThreads, scan_smem_bytes(n, seg, ring), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(mask), static_cast<const int*>(n_valid), n, seg, ring,
      static_cast<bool*>(keep));
  return static_cast<int>(cudaGetLastError());
}

// The scan's plan for rows of n boxes, for reports: tiles a buffer and
// buffers. Launches nothing; cudaErrorInvalidValue where no plan fits.
int nms_scan_plan(int n, int* seg, int* ring) {
  return scan_plan(n, seg, ring) ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
