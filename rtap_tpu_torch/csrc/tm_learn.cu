// The Temporal Memory learning pass for a group of G streams, on Hopper:
// persistent blocks over (stream, chunk of rows) work items, segment rows
// streamed into shared memory by bulk asynchronous copies, and perm read and
// pools written only for the rows that need it.
//
// Replaces: the Pallas TPU kernel rtap_tpu/ops/pallas_tm.py::_mega_kernel
// (called by tm_learn_pallas, pallas_call at pallas_tm.py:320). It computes
// exactly what that kernel computes, per segment row of the [n_seg, M] pools
// (n_seg = C*K*S): alloc-clear; reinforce (+inc toward prev-active cells,
// -dec on the other existing synapses, clip [0, one]); grow toward the
// previous winner cells, evicting the weakest occupied slots (stable by
// (perm, slot)) when free slots run short and filling free slots ascending
// with eligible winners ascending at p_init; punish (-pdec, floor 0) on
// matching segments of non-active columns; death at perm <= 0; and the
// dendrite nsyn/conn/pot counts for t+1. Its output equals the plain
// version's (ops/tm_learn.tm_learn_plain) bit for bit, f32 signed zeros and
// infinities included; f32 NaN permanences are outside that (the clip maps
// NaN to 0, and NaN payloads differ between CPU and CUDA arithmetic).
//
// Bound on an H100 SXM (3.35 TB/s): bytes, and which bytes depends on the data
// (ops/tm_learn.pass_bytes counts both; chip_smoke.py reports both).
// * Every row, every slot in full ("full-row"): both pools read and
//   written, meta read, counts written; (2 + 2) * M * 2 B + 4 B + 3 B per
//   row at int16 presyn / uint16 perm: 13.84 GB, a 4.13 ms bound, for
//   cluster_preset at G = 32,768 (n_seg = 4096, M = 12).
// * What these inputs need ("data-dependent"): every presyn and meta byte
//   read (the dendrite counts come from presyn); a row's perm only if the
//   row holds a synapse or has a learn/alloc/grow/punish bit; a row's
//   presyn, and its perm, written only where the pass changed that pool;
//   the counts written. On the replayed main-path state about 2.6% of rows
//   hold a synapse or a flag and 0.6% change: 4.28 GB, a 1.28 ms bound
//   (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W).
//
// What the design does about that bound:
// * Persistent blocks. The grid is (blocks per SM by occupancy) x (SMs).
//   Each block walks its share of the work items, an item being a stream's
//   rows or, where there are fewer than two streams a block (NAB: one
//   stream of 1,048,576 rows; small groups), a chunk of a stream. An
//   item's setup is paid once: the previous/current active cells become
//   N-bit bitmaps in shared memory (a membership probe is one shared load
//   and a shift), and the winner list is copied there. Its inputs are
//   fetched by cp.async when the item starts and waited for only when they
//   are first needed.
// * A bulk-copy ring. Rows go through tiles of blockDim.x = 128 rows (one
//   row per thread; fewer where two blocks would not fit an SM), presyn
//   and meta, in a ring of kStages stages. One thread issues cp.async.bulk
//   copies completed on an mbarrier per stage; a stage is refilled with
//   the tile kStages ahead as soon as its tile is read, across item
//   boundaries, so kStages - 1 tiles stay in flight. A tile whose source
//   or size is not 16-byte aligned (rows of 10 B, a ragged last tile) is
//   copied by the block itself with the widest aligned vector loads: a
//   second path inside the kernel, on the same ring.
// * Bytes only where rows need them. A thread tests its row's presyn sign
//   bits word by word in the stage. A row without a synapse and without a
//   learn/alloc/grow/punish bit writes its three zero counts and nothing
//   else: its perm is never read. Any other row goes on the block's work
//   list in shared memory, with a copy of its presyn, and its perm is
//   fetched into the list by cp.async as it is listed (read straight from
//   device memory when its chunks are under 4 bytes). The list is worked
//   off at the item's end, or when one more tile could overflow it, so a
//   device-memory latency is not paid per tile (the designs that waited
//   for perm once per tile ran at 3-5x the bound on NVIDIA H100 80GB HBM3
//   at 700 W, PERF.md). A row writes a chunk of presyn or perm back only
//   if its bits changed: compared before and after, never inferred from
//   meta (death also kills live synapses at perm <= 0 on flagless rows,
//   and the clip rewrites an f32 empty slot's perm outside [0, 1]).
// * Growth, warp by warp. The common path (alloc, reinforce, punish, death,
//   counts) is one thread per row and elementwise per slot. Growing rows
//   (grow bit and n_grow > 0) fill the list from its other end, their perm
//   arrives with the others', and then a warp takes each, lanes over slots:
//   winners are tested 32 at a time against the row's slots (shuffles),
//   ballot + popc prefix sums pick the first n_grow eligible winners in
//   list order, lanes rank their slot by (perm, slot) for eviction, and the
//   chosen winners fill the free slots ascending. The item's winner list is
//   compacted once to its valid ids (< N), in order, so a row scans only
//   those (about 10 of W = 80 at the cluster shape). W is a run-time bound;
//   NAB's W = 1280 runs.
// * Wide accesses. A row is handled in chunks of E = 8, 4, 2 or 1 slots,
//   the largest that divides M and the pools' alignment, each chunk one
//   (or, at 32 B, two) vector access held in registers. 24-byte rows in a
//   stage, read as 8-byte chunks, hit distinct banks in each half-warp, so
//   that conflict is not paid; where rows are a multiple of 128 B (all
//   threads would start on one bank) each thread starts at its own chunk.
//
// Built by rtap_tpu_torch/ops/_build.py with nvcc for sm_90a (ptxas -v
// printed) into a plain-C shared library; rtap_tpu_torch/ops/tm_learn.py
// binds it with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStages = 4;               // tiles in the ring
constexpr int kMaxThreads = 128;         // rows (= threads) per tile, at most
constexpr int kWholeStreamRows = 4096;   // streams longer than this split ...
constexpr int kMinChunkRows = 2048;      // ... into chunks of at least this many rows
constexpr int kSmemPerSM = 233472;       // H100: 228 KB of shared memory per SM
constexpr int kSmemReservedPerBlock = 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Consts {
  float p_inc, p_dec, p_init, p_one, p_zero, p_thr, pdec;
  int has_pdec;
};

struct Shape {
  int G, n_seg, M, K, N, W, Ac;
  int chunk;   // rows per work item
  int chunks;  // work items per stream
  int rot;     // 1: threads start their row at their own chunk (bank spread)
};

// Byte offsets of the dynamic shared memory, the same on host and device.
// The work list holds WL = 2 * TR rows: an entry (row, meta) and the row's
// presyn and perm (the perm of growing rows only, where perm chunks are too
// small for cp.async).
struct Layout {
  int bars, tcount, bitmaps, wids, lists, chosen, entries, list_presyn, list_perm, ring, stage_meta,
      stage, total;
};

__host__ __device__ __forceinline__ int round_up(int x, int a) { return (x + a - 1) / a * a; }

// psize/vsize: bytes per presyn/perm element
__host__ __device__ __forceinline__ Layout make_layout(int M, int psize, int vsize, int N, int W,
                                                       int Ac, int TR) {
  Layout L;
  const int WL = 2 * TR;
  int off = 0;
  L.bars = off;         off += kStages * 8;
  L.tcount = off;       off += 3 * 2 * 4 + 4;  // and the valid winners' count
  L.bitmaps = off;      off += 2 * ((N + 31) / 32) * 4;
  L.wids = off;         off += W * 4;
  L.lists = off;        off += 4 * Ac * 4;
  L.chosen = off;       off += TR / 32 * 32 * 4;
  off = round_up(off, 16);
  L.entries = off;      off += WL * 8;
  L.list_presyn = off;  off += round_up(WL * M * psize, 16);
  L.list_perm = off;    off += WL * M * vsize;
  off = round_up(off, 128);
  L.ring = off;
  L.stage_meta = round_up(TR * M * psize, 16);
  L.stage = round_up(L.stage_meta + TR * 4, 128);
  L.total = L.ring + kStages * L.stage;
  return L;
}

// ---- PTX: mbarriers and bulk copies ---------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(b)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(b)), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(b)) : "memory");
}

// cp.async (4, 8 or 16 bytes a thread), completed per thread
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_u32(dst)), "l"(src), "n"(B)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// ---- vector chunks ----------------------------------------------------------

template <int B> struct Vec;
template <> struct Vec<1> { using T = uint8_t; };
template <> struct Vec<2> { using T = uint16_t; };
template <> struct Vec<4> { using T = uint32_t; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<16> { using T = uint4; };

// The sign bits (mask m) that are clear in a vector's 32-bit words.
__device__ __forceinline__ unsigned sign_clear(uint32_t x, unsigned m) { return ~x & m; }
__device__ __forceinline__ unsigned sign_clear(uint2 x, unsigned m) { return ~(x.x & x.y) & m; }
__device__ __forceinline__ unsigned sign_clear(uint4 x, unsigned m) {
  return ~(x.x & x.y & x.z & x.w) & m;
}

// E elements of T, moved as one or two vector accesses (aligned to
// min(16, E * sizeof(T))) and read element by element in registers.
template <typename T, int E>
struct Chunk {
  static constexpr int B = E * (int)sizeof(T), U = B < 16 ? B : 16;
  using V = typename Vec<U>::T;
  union {
    V v[B / U];
    T e[E];
  };
  __device__ __forceinline__ void load(const T* s) {
#pragma unroll
    for (int i = 0; i < B / U; ++i) v[i] = reinterpret_cast<const V*>(s)[i];
  }
  __device__ __forceinline__ void store(T* s) const {
#pragma unroll
    for (int i = 0; i < B / U; ++i) reinterpret_cast<V*>(s)[i] = v[i];
  }
  // does any element have its sign bit clear (a presyn >= 0)?
  __device__ __forceinline__ bool any_nonnegative() const {
    if constexpr (B % 4 == 0) {
      constexpr unsigned sign = sizeof(T) == 2 ? 0x80008000u : 0x80000000u;  // int16 / int32
      unsigned clear = 0;
#pragma unroll
      for (int i = 0; i < B / U; ++i) clear |= sign_clear(v[i], sign);
      return clear != 0;
    } else {
      bool any = false;
#pragma unroll
      for (int i = 0; i < E; ++i) any |= e[i] >= 0;
      return any;
    }
  }
};

// Can a row's perm be fetched by cp.async? Only in chunks of at least 4
// bytes (its smallest copy).
template <typename PermT, int E>
__host__ __device__ constexpr bool perm_async() { return E * sizeof(PermT) >= 4; }

// Start the copy of a row of M perms, in chunks of E, into shared memory.
template <typename PermT, int E>
__device__ __forceinline__ void cp_async_row(PermT* dst, const PermT* src, int M) {
  constexpr int B = E * (int)sizeof(PermT), U = B < 16 ? B : 16;
  for (int c = 0; c < M / E; ++c)
#pragma unroll
    for (int i = 0; i < B / U; ++i)
      cp_async<U>(reinterpret_cast<char*>(dst + c * E) + i * U,
                  reinterpret_cast<const char*>(src + c * E) + i * U);
}

// Copy `bytes` from device memory to 16-aligned shared memory with the
// widest access that the source address and the size allow.
template <typename V>
__device__ __forceinline__ void copy_as(void* dst, const void* src, size_t bytes) {
  const V* s = static_cast<const V*>(src);
  V* d = static_cast<V*>(dst);
  for (size_t i = threadIdx.x; i < bytes / sizeof(V); i += blockDim.x) d[i] = s[i];
}
__device__ __forceinline__ void copy_tile(void* dst, const void* src, size_t bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) | bytes;
  if (a % 16 == 0) copy_as<uint4>(dst, src, bytes);
  else if (a % 8 == 0) copy_as<uint2>(dst, src, bytes);
  else if (a % 4 == 0) copy_as<uint32_t>(dst, src, bytes);
  else if (a % 2 == 0) copy_as<uint16_t>(dst, src, bytes);
  else copy_as<uint8_t>(dst, src, bytes);
}

// ---- the pass ---------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T to_storage(float v) {
  return static_cast<T>(v);  // quantized domains hold integer-valued floats
}
template <>
__device__ __forceinline__ float to_storage<float>(float v) { return v; }

template <typename T>
__device__ __forceinline__ bool same_bits(T a, T b) { return a == b; }
template <>
__device__ __forceinline__ bool same_bits<float>(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

// Reinforce one slot of a learning row: clip(v + p_inc*act - p_dec*(exists
// & ~act), 0, one), with the reference's 0/1 factors and its order of
// operations. Each product is exact (so a contraction to fma rounds alike),
// and adding the +0 products is not dropped: it turns an f32 -0.0 into
// +0.0 as the reference does, which a select form would not.
__device__ __forceinline__ float reinforce(float v, bool act, bool exists, const Consts& cs) {
  const float x = v + cs.p_inc * (act ? 1.f : 0.f) - cs.p_dec * (exists && !act ? 1.f : 0.f);
  return fminf(fmaxf(x, 0.f), cs.p_one);
}

// Is presynaptic cell p in a packed cell set, held as an N-bit bitmap? The
// -1 sentinel is tested BEFORE any decoding: JAX floors -1 // K to column
// -1, which matches nothing, while C would truncate -1 / K to column 0.
__device__ __forceinline__ bool cell_in(const unsigned* bm, int p, int N) {
  return p >= 0 && p < N && ((bm[p >> 5] >> (p & 31)) & 1u);
}

// Build a stream's packed cell set (column ids [Ac] ascending with fills
// >= C, K-bit int32 masks [Ac]) into a zeroed N-bit bitmap. Mask bit 31
// (K = 32) makes the int32 negative; >> then & 1 still reads it. Column ids
// are unique, so OR equals the reference's mask sum.
__device__ __forceinline__ void fill_bitmap(unsigned* bm, const int* ids, const int* masks,
                                            int Ac, int K, int C) {
  for (int j = threadIdx.x; j < Ac * K; j += blockDim.x) {
    const int i = j / K;
    const int k = j - i * K;
    const int c = ids[i];
    if (c >= 0 && c < C && ((masks[i] >> k) & 1)) {
      const int cell = c * K + k;
      atomicOr(&bm[cell >> 5], 1u << (cell & 31));
    }
  }
}

// Does a row need its perm: does it hold a synapse, or carry a learn /
// alloc / grow / punish bit? Otherwise the pass leaves it as it is and its
// counts are 0.
template <typename PresynT, int E>
__device__ __forceinline__ bool needs_perm(const PresynT* sp, int mt, int M, int rot) {
  const int nch = M / E;
  bool has_syn = false;
  for (int cc = 0; cc < nch; ++cc) {
    int c = cc + rot;
    if (c >= nch) c -= nch;
    Chunk<PresynT, E> p;
    p.load(sp + c * E);
    has_syn |= p.any_nonnegative();
  }
  return has_syn || (mt & 15);
}

// The pass on a row that does not grow, one thread: sp is the row's presyn
// in shared memory, vp its perm (staged in shared memory, or in device
// memory), gp/gv where both pools write back. Every step is per slot, so
// the row is walked chunk by chunk and a chunk is written back only if its
// bits changed. Returns nsyn | conn << 8 | pot << 16.
template <typename PresynT, typename PermT, int E>
__device__ __forceinline__ int learn_row(const PresynT* sp, const PermT* vp, PresynT* gp,
                                         PermT* gv, int mt, const unsigned* prev,
                                         const unsigned* cur, int M, int N, int rot,
                                         const Consts& cs) {
  const int nch = M / E;
  const bool learn = mt & 1;
  const bool alloc = (mt >> 1) & 1;
  const bool do_punish = cs.has_pdec && ((mt >> 3) & 1);
  int nsyn = 0, conn = 0, pot = 0;
  for (int cc = 0; cc < nch; ++cc) {
    int c = cc + rot;
    if (c >= nch) c -= nch;
    Chunk<PresynT, E> p0, p1;
    Chunk<PermT, E> v0, v1;
    p0.load(sp + c * E);
    v0.load(vp + c * E);
    bool p_changed = false, v_changed = false;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      // burst-new allocation clears the slot; reinforce
      int p = alloc ? -1 : static_cast<int>(p0.e[e]);
      float v = alloc ? 0.f : static_cast<float>(v0.e[e]);
      const bool a = cell_in(prev, p, N);
      if (learn) v = reinforce(v, a, p >= 0, cs);
      // punish matching segments in non-active columns (pre-grow
      // membership); synapse death at perm <= 0 (perm stays); the counts
      if (do_punish && a) v = fmaxf(v - cs.pdec, cs.p_zero);
      if (p >= 0 && v <= cs.p_zero) p = -1;
      nsyn += p >= 0;
      const bool d = cell_in(cur, p, N);
      pot += d;
      conn += d && v >= cs.p_thr;
      p1.e[e] = static_cast<PresynT>(p);
      v1.e[e] = to_storage<PermT>(v);
      p_changed |= p1.e[e] != p0.e[e];
      v_changed |= !same_bits(v1.e[e], v0.e[e]);
    }
    if (p_changed) p1.store(gp + c * E);
    if (v_changed) v1.store(gv + c * E);
  }
  return nsyn | (conn << 8) | (pot << 16);
}

// The pass on a growing row (grow bit set, n_grow = mt >> 4 > 0), one warp,
// lane m on slot m: sp/vp the row's presyn/perm to read (shared or device
// memory), gp/gv where they write back. `chosen` is the warp's 32 ints of
// shared memory.
template <typename PresynT, typename PermT>
__device__ __forceinline__ void grow_row(const PresynT* sp, const PermT* vp, PresynT* gp,
                                         PermT* gv, int mt, const unsigned* prev,
                                         const unsigned* cur, const int* wids, int* chosen,
                                         int M, int N, int W, const Consts& cs, uint8_t* nsyn_out,
                                         uint8_t* conn_out, uint8_t* pot_out) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const bool in = lane < M;
  const bool learn = mt & 1;
  const bool alloc = (mt >> 1) & 1;
  const bool do_punish = cs.has_pdec && ((mt >> 3) & 1);
  const int n_grow = mt >> 4;

  const PresynT p0 = in ? sp[lane] : static_cast<PresynT>(-1);
  const PermT v0 = in ? vp[lane] : to_storage<PermT>(0.f);
  int p = alloc ? -1 : static_cast<int>(p0);
  float v = alloc ? 0.f : static_cast<float>(v0);
  const bool a = in && cell_in(prev, p, N);
  if (learn && in) v = reinforce(v, a, p >= 0, cs);
  const int occupied = __popc(__ballot_sync(kFull, in && p >= 0));

  // eligible winners: valid, not already presynaptic on the pre-eviction
  // row, in list order; the first min(n_grow, M) fill the free slots. The
  // list is tested 32 winners at a time until n_grow are found.
  const int cap = min(n_grow, M);
  int cnt = 0;
  for (int w0 = 0; w0 < W && cnt < n_grow; w0 += 32) {
    const int w = w0 + lane;
    const int wid = w < W ? wids[w] : 0;
    bool e = w < W && wid < N;
    for (int j = 0; j < M; ++j) e &= __shfl_sync(kFull, p, j) != wid;
    const unsigned bm = __ballot_sync(kFull, e);
    if (e) {
      const int r = cnt + __popc(bm & lt);
      if (r < cap) chosen[r] = wid;
    }
    cnt += __popc(bm);
  }
  const int n_new = min(cnt, n_grow);

  // evict the weakest occupied slots when free slots run short: stable
  // ascending rank by (perm, slot), a free slot keyed +inf as the
  // reference keys it (an occupied slot at perm +inf ties with it)
  const int short_by = n_new - (M - occupied);
  if (short_by > 0) {
    const float key = p >= 0 ? v : INFINITY;
    int rank = 0;
    for (int j = 0; j < M; ++j) {
      const float kj = __shfl_sync(kFull, key, j);
      rank += kj < key || (kj == key && j < lane);
    }
    if (in && p >= 0 && rank < short_by) {
      p = -1;
      v = 0.f;
    }
  }
  __syncwarp();

  // fill free slots ascending with the chosen winners ascending
  const bool free_slot = in && p < 0;
  const int fr = __popc(__ballot_sync(kFull, free_slot) & lt);
  if (free_slot && fr < n_new) {
    p = chosen[fr];
    v = cs.p_init;
  }

  // punish (pre-grow membership: punished columns never learn, so `a` is
  // exact there); death; the counts on the updated row
  if (do_punish && a) v = fmaxf(v - cs.pdec, cs.p_zero);
  if (p >= 0 && v <= cs.p_zero) p = -1;
  const bool d = in && cell_in(cur, p, N);
  const int nsyn = __popc(__ballot_sync(kFull, in && p >= 0));
  const int pot = __popc(__ballot_sync(kFull, d));
  const int conn = __popc(__ballot_sync(kFull, d && v >= cs.p_thr));
  const PresynT p1 = static_cast<PresynT>(p);
  const PermT v1 = to_storage<PermT>(v);
  if (in && p1 != p0) gp[lane] = p1;
  if (in && !same_bits(v1, v0)) gv[lane] = v1;
  if (lane == 0) {
    *nsyn_out = static_cast<uint8_t>(nsyn);
    *conn_out = static_cast<uint8_t>(conn);
    *pot_out = static_cast<uint8_t>(pot);
  }
  __syncwarp();  // `chosen` is free for the warp's next row
}

// A position in a block's walk over its work items (items blockIdx.x,
// blockIdx.x + gridDim.x, ...; tiles of blockDim.x rows within each).
struct Walk {
  int item, tile;
  int g, r0, nrows;  // the tile: stream, first row in the stream, rows

  __device__ __forceinline__ void locate(const Shape& s) {
    g = item / s.chunks;
    const int row0 = (item - g * s.chunks) * s.chunk;
    r0 = row0 + tile * (int)blockDim.x;
    nrows = min((int)blockDim.x, min(s.chunk, s.n_seg - row0) - tile * (int)blockDim.x);
  }
  __device__ __forceinline__ void next(const Shape& s) {
    if (r0 + nrows < min(s.n_seg, (item - g * s.chunks + 1) * s.chunk)) {
      ++tile;
    } else {
      item += gridDim.x;
      tile = 0;
    }
    locate(s);
  }
  __device__ __forceinline__ size_t row(const Shape& s) const { return (size_t)g * s.n_seg + r0; }
};

template <typename PresynT>
__device__ __forceinline__ bool bulk_ok(const PresynT* src_p, const int32_t* src_m, int nrows,
                                        int M) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src_p) | reinterpret_cast<uintptr_t>(src_m) |
                      (uintptr_t)(nrows * M * (int)sizeof(PresynT)) | (uintptr_t)(nrows * 4);
  return a % 16 == 0;
}

// The kernel: persistent blocks, each walking its work items tile by tile.
// Per tile: wait for the tile's stage; one thread per row reads the row's
// presyn and meta from the stage; a row that needs nothing writes its zero
// counts, any other row goes on the block's work list (with a copy of its
// presyn); a barrier frees the stage, and thread 0 refills it with the tile
// kStages ahead. At an item's end, or when the list could overflow with the
// next tile, the block works the list off: threads over the listed rows
// (perm straight from device memory, one latency for the whole list), then
// warps over the growing ones. So a device-memory latency is paid once per
// list, not once per tile, and the ring keeps kStages - 1 tiles in flight
// meanwhile.
template <typename PresynT, typename PermT, int E>
__global__ void __launch_bounds__(kMaxThreads)
tm_learn_kernel(PresynT* __restrict__ presyn, PermT* __restrict__ perm,
                const int32_t* __restrict__ meta,
                const int32_t* __restrict__ pids, const int32_t* __restrict__ pmasks,
                const int32_t* __restrict__ wids,
                const int32_t* __restrict__ aids, const int32_t* __restrict__ amasks,
                uint8_t* __restrict__ nsyn_out, uint8_t* __restrict__ conn_out,
                uint8_t* __restrict__ pot_out, Shape s, Consts cs) {
  constexpr bool kAsyncPerm = perm_async<PermT, E>();
  extern __shared__ __align__(128) unsigned char smem[];
  const int TR = blockDim.x, WL = 2 * TR;
  const int M = s.M, Ac = s.Ac;
  const Layout L = make_layout(M, sizeof(PresynT), sizeof(PermT), s.N, s.W, Ac, TR);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  // rows a tile put on the list [tile % 3][front, back]; three buffers, so a
  // tile's counters are cleared two barriers after their last reader
  int* tcount = reinterpret_cast<int*>(smem + L.tcount);
  int* n_wids = tcount + 6;  // the item's valid winners (ids < N), first in s_wids
  const int nw = (s.N + 31) >> 5;
  unsigned* prev = reinterpret_cast<unsigned*>(smem + L.bitmaps);
  unsigned* cur = prev + nw;
  int* s_wids = reinterpret_cast<int*>(smem + L.wids);
  int* s_lists = reinterpret_cast<int*>(smem + L.lists);  // pids | pmasks | aids | amasks
  int2* entries = reinterpret_cast<int2*>(smem + L.entries);
  PresynT* list_presyn = reinterpret_cast<PresynT*>(smem + L.list_presyn);
  PermT* list_perm = reinterpret_cast<PermT*>(smem + L.list_perm);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = TR >> 5;
  int* chosen = reinterpret_cast<int*>(smem + L.chosen) + warp * 32;
  const int items = s.G * s.chunks;
  if ((int)blockIdx.x >= items) return;

  auto stage_presyn = [&](unsigned t) {
    return reinterpret_cast<PresynT*>(smem + L.ring + (t % kStages) * L.stage);
  };
  auto stage_meta = [&](unsigned t) {
    return reinterpret_cast<int32_t*>(smem + L.ring + (t % kStages) * L.stage + L.stage_meta);
  };
  // one thread puts tile t (at w) on its way: bulk copies when the tile
  // allows them, else a bare arrival (the block then copies it itself)
  auto issue = [&](unsigned t, const Walk& w) {
    const PresynT* sp = presyn + w.row(s) * M;
    const int32_t* sm = meta + w.row(s);
    uint64_t* bar = &bars[t % kStages];
    if (bulk_ok(sp, sm, w.nrows, M)) {
      const unsigned pb = w.nrows * M * sizeof(PresynT), mb = w.nrows * 4;
      mbar_expect_tx(bar, pb + mb);
      bulk_load(stage_presyn(t), sp, pb, bar);
      bulk_load(stage_meta(t), sm, mb, bar);
    } else {
      mbar_arrive(bar);
    }
  };

  const Walk start{(int)blockIdx.x, 0};
  Walk pw = start, cw = start;  // issue and compute cursors
  pw.locate(s);
  cw.locate(s);
  unsigned issued = 0;
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&bars[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < 6; ++i) tcount[i] = 0;
    for (; issued < kStages && pw.item < items; ++issued) {
      issue(issued, pw);
      pw.next(s);
    }
  }
  __syncthreads();

  const int rot = s.rot ? tid % (M / E) : 0;
  bool bitmaps_ready = false;
  int n_front = 0, n_back = 0;  // rows on the work list, the same in every thread
  for (unsigned t = 0; cw.item < items; ++t) {
    const int g = cw.g;
    if (cw.tile == 0) {
      // the item's setup starts: zero the cell bitmaps; fetch the winner
      // list and the packed lists, waited for only when the list is worked
      // off (the previous item's work is done: its last barrier is behind)
      cp_async_wait_all();
      for (int i = tid; i < 2 * nw; i += TR) prev[i] = 0u;
      for (int i = tid; i < s.W; i += TR) cp_async<4>(&s_wids[i], &wids[(size_t)g * s.W + i]);
      for (int i = tid; i < 4 * Ac; i += TR) {
        const int32_t* src = i < Ac ? pids : i < 2 * Ac ? pmasks : i < 3 * Ac ? aids : amasks;
        cp_async<4>(&s_lists[i], &src[(size_t)g * Ac + i % Ac]);
      }
      cp_async_commit();
      bitmaps_ready = false;
    }

    mbar_wait(&bars[t % kStages], (t / kStages) & 1);
    const size_t row = cw.row(s);
    if (!bulk_ok(presyn + row * M, meta + row, cw.nrows, M)) {
      copy_tile(stage_presyn(t), presyn + row * M, (size_t)cw.nrows * M * sizeof(PresynT));
      copy_tile(stage_meta(t), meta + row, (size_t)cw.nrows * 4);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // before a bulk copy reuses the stage
      __syncthreads();
    }

    // the tile's rows: zero counts, or onto the work list (growing rows
    // from the back, the others from the front; one atomic per warp each)
    {
      const PresynT* sp = stage_presyn(t) + tid * M;
      const int mt = tid < cw.nrows ? stage_meta(t)[tid] : 0;
      const bool need = tid < cw.nrows && needs_perm<PresynT, E>(sp, mt, M, rot);
      const bool grows = need && ((mt >> 2) & 1) && (mt >> 4) > 0;
      const unsigned lt = (1u << lane) - 1u;
      const unsigned front_bits = __ballot_sync(kFull, need && !grows);
      const unsigned back_bits = __ballot_sync(kFull, grows);
      int* tc = tcount + (t % 3) * 2;
      int base_f = 0, base_b = 0;
      if (lane == 0) {
        if (front_bits) base_f = atomicAdd(&tc[0], __popc(front_bits));
        if (back_bits) base_b = atomicAdd(&tc[1], __popc(back_bits));
      }
      base_f = n_front + __shfl_sync(kFull, base_f, 0);
      base_b = n_back + __shfl_sync(kFull, base_b, 0);
      if (need) {
        const int slot = grows ? WL - 1 - (base_b + __popc(back_bits & lt))
                               : base_f + __popc(front_bits & lt);
        entries[slot] = make_int2(cw.r0 + tid, mt);
        for (int c = 0; c < M / E; ++c) {
          Chunk<PresynT, E> p;
          p.load(sp + c * E);
          p.store(list_presyn + slot * M + c * E);
        }
        if constexpr (kAsyncPerm)  // in flight until the list is worked off
          cp_async_row<PermT, E>(list_perm + slot * M, perm + (row + tid) * M, M);
      } else if (tid < cw.nrows) {
        nsyn_out[row + tid] = 0;
        conn_out[row + tid] = 0;
        pot_out[row + tid] = 0;
      }
      if constexpr (kAsyncPerm) cp_async_commit();
    }
    const bool item_ends = cw.r0 + cw.nrows == min(s.n_seg, (cw.item - g * s.chunks + 1) * s.chunk);
    if (tid == 0) tcount[(t + 1) % 3 * 2] = tcount[(t + 1) % 3 * 2 + 1] = 0;
    __syncthreads();  // the stage is read; the list is complete
    n_front += tcount[t % 3 * 2];
    n_back += tcount[t % 3 * 2 + 1];
    if (tid == 0 && pw.item < items) {
      issue(issued++, pw);
      pw.next(s);
    }
    cw.next(s);
    if (!(item_ends || n_front + n_back > WL - TR) || n_front + n_back == 0) continue;

    // work the list off: the item's lists and the listed rows' perm have
    // arrived (each thread waits for its own copies, the barrier for all)
    cp_async_wait_all();
    __syncthreads();
    if (!bitmaps_ready) {
      fill_bitmap(prev, s_lists, s_lists + Ac, Ac, s.K, s.N / s.K);
      fill_bitmap(cur, s_lists + 2 * Ac, s_lists + 3 * Ac, Ac, s.K, s.N / s.K);
      if (warp == 0) {  // keep the valid winners, in list order (growth skips the rest)
        const unsigned lt = (1u << lane) - 1u;
        int n = 0;
        for (int w0 = 0; w0 < s.W; w0 += 32) {
          const int wid = w0 + lane < s.W ? s_wids[w0 + lane] : s.N;
          const unsigned ok = __ballot_sync(kFull, wid < s.N);
          if (wid < s.N) s_wids[n + __popc(ok & lt)] = wid;  // at or before where it was read
          n += __popc(ok);
        }
        if (lane == 0) *n_wids = n;
      }
      bitmaps_ready = true;
      __syncthreads();
    }
    const size_t base = (size_t)g * s.n_seg;
    for (int i = tid; i < (kAsyncPerm ? n_front : n_front + n_back); i += TR) {
      const int slot = i < n_front ? i : WL - 1 - (i - n_front);
      const int2 e = entries[slot];
      const size_t r = base + e.x;
      if (i < n_front) {
        const PermT* vp = kAsyncPerm ? list_perm + slot * M : perm + r * M;
        const int c = learn_row<PresynT, PermT, E>(list_presyn + slot * M, vp, presyn + r * M,
                                                   perm + r * M, e.y, prev, cur, M, s.N, rot, cs);
        nsyn_out[r] = static_cast<uint8_t>(c);
        conn_out[r] = static_cast<uint8_t>(c >> 8);
        pot_out[r] = static_cast<uint8_t>(c >> 16);
      } else if (!kAsyncPerm) {
        for (int c = 0; c < M / E; ++c) {  // a growing row's perm, for its warp
          Chunk<PermT, E> v;
          v.load(perm + r * M + c * E);
          v.store(list_perm + slot * M + c * E);
        }
      }
    }
    if (!kAsyncPerm && n_back > 0) __syncthreads();  // the growing rows' perm is staged
    for (int q = warp; q < n_back; q += nwarps) {
      const int slot = WL - 1 - q;
      const int2 e = entries[slot];
      const size_t r = base + e.x;
      grow_row<PresynT, PermT>(list_presyn + slot * M, list_perm + slot * M, presyn + r * M,
                               perm + r * M, e.y, prev, cur, s_wids, chosen, M, s.N, *n_wids, cs,
                               nsyn_out + r, conn_out + r, pot_out + r);
    }
    __syncthreads();  // the list and the bitmaps are free again
    n_front = n_back = 0;
  }
  cp_async_wait_all();
}

template <typename PresynT, typename PermT, int E>
cudaError_t launch(void* presyn, void* perm, const void* meta, const void* pids,
                   const void* pmasks, const void* wids, const void* aids,
                   const void* amasks, void* nsyn, void* conn, void* pot, Shape s,
                   Consts cs, cudaStream_t stream) {
  auto kern = tm_learn_kernel<PresynT, PermT, E>;
  // rows (= threads) per tile: 128, halved (down to a warp) until two
  // blocks fit in an SM's shared memory
  int TR = 128;
  Layout L = make_layout(s.M, sizeof(PresynT), sizeof(PermT), s.N, s.W, s.Ac, TR);
  while (TR > 32 && 2 * (L.total + kSmemReservedPerBlock) > kSmemPerSM) {
    TR /= 2;
    L = make_layout(s.M, sizeof(PresynT), sizeof(PermT), s.N, s.W, s.Ac, TR);
  }
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (e != cudaSuccess) return e;
  int dev, sms, per_sm;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, TR, L.total)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long blocks = (long long)per_sm * sms;
  // work items: whole streams, or chunks of streams when there are fewer
  // than two streams a block: chunks of at least kMinChunkRows rows for
  // streams longer than kWholeStreamRows (each item pays the setup), of at
  // least a tile for shorter ones
  const int min_rows = s.n_seg > kWholeStreamRows ? kMinChunkRows : TR;
  const long long want = (2 * blocks + s.G - 1) / s.G;
  const long long most = (s.n_seg + min_rows - 1) / min_rows;
  const int chunks = (int)(want < 1 ? 1 : (want > most ? most : want));
  s.chunk = round_up((s.n_seg + chunks - 1) / chunks, TR);
  s.chunks = (s.n_seg + s.chunk - 1) / s.chunk;
  const long long items = (long long)s.G * s.chunks;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  s.rot = (s.M * (int)sizeof(PresynT)) % 128 == 0;
  const int grid = (int)(items < blocks ? items : blocks);
  kern<<<grid, TR, L.total, stream>>>(
      static_cast<PresynT*>(presyn), static_cast<PermT*>(perm),
      static_cast<const int32_t*>(meta), static_cast<const int32_t*>(pids),
      static_cast<const int32_t*>(pmasks), static_cast<const int32_t*>(wids),
      static_cast<const int32_t*>(aids), static_cast<const int32_t*>(amasks),
      static_cast<uint8_t*>(nsyn), static_cast<uint8_t*>(conn), static_cast<uint8_t*>(pot), s, cs);
  return cudaGetLastError();
}

// The chunk width E: the largest of 8, 4, 2, 1 slots that divides M and
// keeps both pools' chunks aligned for their vector accesses.
template <typename PresynT, typename PermT>
cudaError_t launch_chunked(void* presyn, void* perm, const void* meta, const void* pids,
                           const void* pmasks, const void* wids, const void* aids,
                           const void* amasks, void* nsyn, void* conn, void* pot, Shape s,
                           Consts cs, cudaStream_t stream) {
  auto aligned = [](const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % (bytes < 16 ? bytes : 16) == 0;
  };
  int E = 8;
  while (E > 1 && (s.M % E != 0 || !aligned(presyn, E * (int)sizeof(PresynT)) ||
                   !aligned(perm, E * (int)sizeof(PermT))))
    E >>= 1;
  switch (E) {
    case 8:
      return launch<PresynT, PermT, 8>(presyn, perm, meta, pids, pmasks, wids, aids, amasks,
                                       nsyn, conn, pot, s, cs, stream);
    case 4:
      return launch<PresynT, PermT, 4>(presyn, perm, meta, pids, pmasks, wids, aids, amasks,
                                       nsyn, conn, pot, s, cs, stream);
    case 2:
      return launch<PresynT, PermT, 2>(presyn, perm, meta, pids, pmasks, wids, aids, amasks,
                                       nsyn, conn, pot, s, cs, stream);
    default:
      return launch<PresynT, PermT, 1>(presyn, perm, meta, pids, pmasks, wids, aids, amasks,
                                       nsyn, conn, pot, s, cs, stream);
  }
}

template <typename PresynT>
cudaError_t launch_perm(int perm_kind, void* presyn, void* perm, const void* meta,
                        const void* pids, const void* pmasks, const void* wids,
                        const void* aids, const void* amasks, void* nsyn, void* conn,
                        void* pot, Shape s, Consts cs, cudaStream_t stream) {
  switch (perm_kind) {
    case 0:
      return launch_chunked<PresynT, float>(presyn, perm, meta, pids, pmasks, wids, aids,
                                            amasks, nsyn, conn, pot, s, cs, stream);
    case 16:
      return launch_chunked<PresynT, uint16_t>(presyn, perm, meta, pids, pmasks, wids, aids,
                                               amasks, nsyn, conn, pot, s, cs, stream);
    case 8:
      return launch_chunked<PresynT, uint8_t>(presyn, perm, meta, pids, pmasks, wids, aids,
                                              amasks, nsyn, conn, pot, s, cs, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch the pass on `stream`, updating presyn/perm in place. Returns the
// cudaError_t of the launch (cudaGetLastError() right after it), 0 = success.
extern "C" int rtap_tm_learn(int presyn_bits, int perm_kind, void* presyn, void* perm,
                             const void* meta, const void* pids, const void* pmasks,
                             const void* wids, const void* aids, const void* amasks,
                             void* nsyn, void* conn, void* pot, int G, int n_seg, int M,
                             int K, int N, int W, int Ac, float p_inc, float p_dec,
                             float p_init, float p_one, float p_zero, float p_thr,
                             float pdec, int has_pdec, void* stream) {
  if (M < 1 || M > 32 || K < 1 || K > 32 || N < K || N % K != 0 || Ac < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  if (G == 0 || n_seg == 0) return 0;
  const Consts cs{p_inc, p_dec, p_init, p_one, p_zero, p_thr, pdec, has_pdec};
  const Shape s{G, n_seg, M, K, N, W, Ac, 0, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (presyn_bits == 16)
    return (int)launch_perm<int16_t>(perm_kind, presyn, perm, meta, pids, pmasks, wids, aids,
                                     amasks, nsyn, conn, pot, s, cs, st);
  if (presyn_bits == 32)
    return (int)launch_perm<int32_t>(perm_kind, presyn, perm, meta, pids, pmasks, wids, aids,
                                     amasks, nsyn, conn, pot, s, cs, st);
  return (int)cudaErrorInvalidValue;
}
