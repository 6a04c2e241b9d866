// The Temporal Memory learning pass for a group of G streams, one thread
// per segment row.
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
// dendrite nsyn/conn/pot counts for t+1.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s f32): bytes. Each pool byte is
// read once and written once, plus the per-row meta word and counts: per
// row (2 + 2) * M * 2 B + 4 B meta + 3 B counts at int16 presyn / uint16
// perm -- about 0.42 MB per cluster-preset stream per learning tick (n_seg =
// 4096, M = 12), about 13.8 GB (about 4.1 ms) at G = 32,768. Rows are short
// (24 bytes), so how rows are moved and how many instructions a row costs
// decide how close the kernel gets to that bound.
//
// What the design does about that bound:
// * a block stages its rows (one per thread) through shared memory: the
//   pools are read and written once, in place, with coalesced element
//   loads and stores in their storage dtypes (int16/int32 presyn; float,
//   uint16 or uint8 perm). This replaces the TPU harness's i32/f32 casts
//   and the caller's round-back. Staged rows are padded to an odd number
//   of 32-bit words, so a warp's 32 rows fall in distinct banks.
// * one thread owns one row and walks its M slots, so one warp instruction
//   serves 32 rows; the common path (alloc, reinforce, punish, death,
//   counts) is two passes over the row.
// * the packed cell sets (previous and current active cells) become N-bit
//   bitmaps in shared memory, built once per block: a membership probe is
//   one shared load and a shift, where the TPU form compares against all
//   Ac column ids.
// * growth (at most learn_cap rows per stream) runs one pass over the
//   winner list that stops once n_grow eligible winners are found (the TPU
//   kernel unrolled two full passes); W is a run-time loop bound, so the
//   NAB shape (W = 1280), which the TPU kernel refused past 512, runs. Rows
//   whose grow flag is off or whose n_grow <= 0 skip it: they add and evict
//   nothing. The scan is serial in the row's thread, W x M compares: cheap
//   at the cluster shape (80 x 12), the tail of the NAB shape (1280 x 32).
//
// Built by rtap_tpu_torch/ops/_build.py with nvcc for sm_90a into a plain-C
// shared library; rtap_tpu_torch/ops/tm_learn.py binds it with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;           // rows (= threads) per block, at most
constexpr int kStageBytes = 32 * 1024;     // staged row bytes per block, about

struct Consts {
  float p_inc, p_dec, p_init, p_one, p_zero, p_thr, pdec;
  int has_pdec;
};

// Is presynaptic cell p in a packed cell set, held as an N-bit bitmap? The
// -1 sentinel is tested BEFORE any decoding: JAX floors -1 // K to column
// -1, which matches nothing, while C would truncate -1 / K to column 0.
__device__ __forceinline__ bool cell_in(const unsigned* bm, int p, int N) {
  return p >= 0 && p < N && ((bm[p >> 5] >> (p & 31)) & 1u);
}

// Build a stream's packed cell set (column ids [Ac] ascending with fills
// >= C, K-bit int32 masks [Ac]) as a bitmap of N = C*K bits in shared
// memory. Mask bit 31 (K = 32) makes the int32 negative; >> then & 1 still
// reads it. Column ids are unique, so OR equals the reference's mask sum.
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

template <typename T>
__device__ __forceinline__ T to_storage(float v) {
  return static_cast<T>(v);  // quantized domains hold integer-valued floats
}
template <>
__device__ __forceinline__ float to_storage<float>(float v) { return v; }

// Elements per staged row: >= M, and an odd number of 32-bit words.
template <typename T>
__host__ __device__ __forceinline__ int staged_stride(int M) {
  const int per_word = 4 / (int)sizeof(T);
  int words = (M + per_word - 1) / per_word;
  if ((words & 1) == 0) ++words;
  return words * per_word;
}

// Element i of a block's [rows, M] slice lies in row i / M: the division
// as a multiply-high by mdiv = ceil(2^32 / M), exact for i < 2^32 / M.
// M = 1, whose factor 2^32 does not fit in 32 bits, is its own row.
__device__ __forceinline__ int row_of(int i, int M, unsigned mdiv) {
  return M == 1 ? i : (int)__umulhi((unsigned)i, mdiv);
}

// The learning pass on one staged row: P/V are the row's M slots in shared
// memory, updated in place; returns the counts packed as nsyn | conn << 8 |
// pot << 16.
template <typename PresynT, typename PermT>
__device__ __forceinline__ int learn_row(PresynT* P, PermT* V, int mt, const unsigned* prev,
                                         const unsigned* cur, const int* wids, int M, int N,
                                         int W, const Consts& cs) {
  const bool learn = mt & 1;
  const bool alloc = (mt >> 1) & 1;
  const bool grow = (mt >> 2) & 1;
  const bool punish = (mt >> 3) & 1;
  const int n_grow = mt >> 4;  // clamped at 0 by the wrapper

  // pass 1: burst-new allocation clears the slots; reinforce. The
  // reference writes clip(perm + p_inc*act - p_dec*(exists & ~act), 0, one)
  // with 0/1 factors: each product is exact (so an FMA contraction changes
  // nothing) and adding or subtracting an exact 0 leaves perm as it is, so
  // this select form gives the same bits. `act` (pre-grow membership) is
  // kept per slot for the punish stage.
  unsigned act = 0;
  int occupied = 0;
  for (int m = 0; m < M; ++m) {
    int p = alloc ? -1 : static_cast<int>(P[m]);
    float v = alloc ? 0.f : static_cast<float>(V[m]);
    const bool a = cell_in(prev, p, N);
    if (learn) {
      const float x = a ? v + cs.p_inc : (p >= 0 ? v - cs.p_dec : v);
      v = fminf(fmaxf(x, 0.f), cs.p_one);
    }
    act |= (unsigned)a << m;
    occupied += p >= 0;
    P[m] = static_cast<PresynT>(p);
    V[m] = to_storage<PermT>(v);
  }

  if (grow && n_grow > 0) {
    // eligible winners: valid, not already presynaptic on the pre-eviction
    // row, in list order; the first min(n_grow, M) fill the free slots
    int chosen[32];
    const int cap = min(n_grow, M);
    int cnt = 0;
    for (int w = 0; w < W && cnt < n_grow; ++w) {
      const int wid = wids[w];
      if (wid >= N) continue;
      bool already = false;
      for (int m = 0; m < M; ++m) already |= static_cast<int>(P[m]) == wid;
      if (already) continue;
      if (cnt < cap) chosen[cnt] = wid;
      ++cnt;
    }
    const int n_new = min(cnt, n_grow);

    // evict the weakest occupied slots when free slots run short: stable
    // ascending rank by (perm, slot) among the occupied slots
    const int short_by = n_new - (M - occupied);
    if (short_by > 0) {
      unsigned evict = 0;
      for (int m = 0; m < M; ++m) {
        if (static_cast<int>(P[m]) < 0) continue;
        const float key = static_cast<float>(V[m]);
        int rank = 0;
        for (int j = 0; j < M; ++j) {
          if (static_cast<int>(P[j]) < 0) continue;
          const float kj = static_cast<float>(V[j]);
          rank += (kj < key) || (kj == key && j < m);
        }
        evict |= (unsigned)(rank < short_by) << m;
      }
      for (int m = 0; m < M; ++m) {
        if ((evict >> m) & 1) {
          P[m] = static_cast<PresynT>(-1);
          V[m] = to_storage<PermT>(0.f);
        }
      }
    }

    // fill free slots ascending with the chosen winners ascending
    int f = 0;
    for (int m = 0; m < M && f < n_new; ++m) {
      if (static_cast<int>(P[m]) < 0) {
        P[m] = static_cast<PresynT>(chosen[f++]);
        V[m] = to_storage<PermT>(cs.p_init);
      }
    }
  }

  // pass 2: punish matching segments in non-active columns (pre-grow
  // membership: punished columns never learn, so `act` is exact there);
  // synapse death at perm <= 0 (the permanence stays as it is); the
  // dendrite counts for t+1 on the updated row
  const bool do_punish = cs.has_pdec && punish;
  int nsyn = 0, conn = 0, pot = 0;
  for (int m = 0; m < M; ++m) {
    int p = static_cast<int>(P[m]);
    float v = static_cast<float>(V[m]);
    if (do_punish && ((act >> m) & 1)) v = fmaxf(v - cs.pdec, cs.p_zero);
    if (p >= 0 && v <= cs.p_zero) p = -1;
    nsyn += p >= 0;
    const bool d = cell_in(cur, p, N);
    pot += d;
    conn += d && v >= cs.p_thr;
    P[m] = static_cast<PresynT>(p);
    V[m] = to_storage<PermT>(v);
  }
  return nsyn | (conn << 8) | (pot << 16);
}

template <typename PresynT, typename PermT>
__global__ void __launch_bounds__(kMaxThreads)
tm_learn_kernel(PresynT* __restrict__ presyn, PermT* __restrict__ perm,
                const int32_t* __restrict__ meta,
                const int32_t* __restrict__ pids, const int32_t* __restrict__ pmasks,
                const int32_t* __restrict__ wids,
                const int32_t* __restrict__ aids, const int32_t* __restrict__ amasks,
                uint8_t* __restrict__ nsyn_out, uint8_t* __restrict__ conn_out,
                uint8_t* __restrict__ pot_out,
                int G, int n_seg, int M, int K, int N, int W, int Ac, Consts cs) {
  // shared memory: [prev bitmap | cur bitmap | wids W | lists 4*Ac |
  //                 presyn RB x SP | perm RB x SV], RB = blockDim.x rows
  extern __shared__ __align__(16) unsigned smem[];
  const int RB = blockDim.x;
  const int tid = threadIdx.x;
  const int nw = (N + 31) >> 5;
  const int SP = staged_stride<PresynT>(M);
  const int SV = staged_stride<PermT>(M);
  unsigned* prev = smem;
  unsigned* cur = smem + nw;
  int* s_wids = reinterpret_cast<int*>(smem + 2 * nw);
  int* s_lists = s_wids + W;
  PresynT* s_p = reinterpret_cast<PresynT*>(s_lists + 4 * Ac);
  PermT* s_v = reinterpret_cast<PermT*>(s_p + RB * SP);
  const int row0 = blockIdx.x * RB;
  const int nrows = min(RB, n_seg - row0);
  const unsigned mdiv = 0xFFFFFFFFu / (unsigned)M + 1u;

  for (int g = blockIdx.y; g < G; g += gridDim.y) {
    const size_t base = (size_t)g * n_seg + row0;
    __syncthreads();  // the previous stream's rows are stored
    for (int i = tid; i < 2 * nw; i += RB) smem[i] = 0u;
    for (int i = tid; i < W; i += RB) s_wids[i] = wids[(size_t)g * W + i];
    for (int i = tid; i < Ac; i += RB) {
      const size_t j = (size_t)g * Ac + i;
      s_lists[i] = pids[j];
      s_lists[Ac + i] = pmasks[j];
      s_lists[2 * Ac + i] = aids[j];
      s_lists[3 * Ac + i] = amasks[j];
    }
    // the rows, coalesced: consecutive threads take consecutive elements
    for (int i = tid; i < nrows * M; i += RB) {
      const int r = row_of(i, M, mdiv);
      const int m = i - r * M;
      s_p[r * SP + m] = presyn[base * M + i];
      s_v[r * SV + m] = perm[base * M + i];
    }
    const int mt = tid < nrows ? meta[base + tid] : 0;
    __syncthreads();
    fill_bitmap(prev, s_lists, s_lists + Ac, Ac, K, N / K);
    fill_bitmap(cur, s_lists + 2 * Ac, s_lists + 3 * Ac, Ac, K, N / K);
    __syncthreads();

    if (tid < nrows) {
      const int c = learn_row(s_p + tid * SP, s_v + tid * SV, mt, prev, cur, s_wids, M, N, W, cs);
      nsyn_out[base + tid] = static_cast<uint8_t>(c);
      conn_out[base + tid] = static_cast<uint8_t>(c >> 8);
      pot_out[base + tid] = static_cast<uint8_t>(c >> 16);
    }
    __syncthreads();
    for (int i = tid; i < nrows * M; i += RB) {
      const int r = row_of(i, M, mdiv);
      const int m = i - r * M;
      presyn[base * M + i] = s_p[r * SP + m];
      perm[base * M + i] = s_v[r * SV + m];
    }
  }
}

template <typename PresynT, typename PermT>
cudaError_t launch(void* presyn, void* perm, const void* meta, const void* pids,
                   const void* pmasks, const void* wids, const void* aids,
                   const void* amasks, void* nsyn, void* conn, void* pot, int G,
                   int n_seg, int M, int K, int N, int W, int Ac, Consts cs,
                   cudaStream_t stream) {
  auto kern = tm_learn_kernel<PresynT, PermT>;
  // rows (= threads) per block: as many as ~32 KB of staged rows holds, a
  // multiple of 32, at most kMaxThreads
  const size_t row_bytes = (size_t)staged_stride<PresynT>(M) * sizeof(PresynT) +
                           (size_t)staged_stride<PermT>(M) * sizeof(PermT);
  int RB = (int)(kStageBytes / row_bytes) / 32 * 32;
  RB = RB < 32 ? 32 : (RB > kMaxThreads ? kMaxThreads : RB);
  const size_t shm = (size_t)(2 * ((N + 31) / 32) + W + 4 * Ac) * sizeof(int) +
                     (size_t)RB * row_bytes;
  if (shm > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((n_seg + RB - 1) / RB, G < 65535 ? G : 65535);
  kern<<<grid, RB, shm, stream>>>(
      static_cast<PresynT*>(presyn), static_cast<PermT*>(perm),
      static_cast<const int32_t*>(meta), static_cast<const int32_t*>(pids),
      static_cast<const int32_t*>(pmasks), static_cast<const int32_t*>(wids),
      static_cast<const int32_t*>(aids), static_cast<const int32_t*>(amasks),
      static_cast<uint8_t*>(nsyn), static_cast<uint8_t*>(conn),
      static_cast<uint8_t*>(pot), G, n_seg, M, K, N, W, Ac, cs);
  return cudaGetLastError();
}

template <typename PresynT>
cudaError_t launch_perm(int perm_kind, void* presyn, void* perm, const void* meta,
                        const void* pids, const void* pmasks, const void* wids,
                        const void* aids, const void* amasks, void* nsyn, void* conn,
                        void* pot, int G, int n_seg, int M, int K, int N, int W,
                        int Ac, Consts cs, cudaStream_t stream) {
  switch (perm_kind) {
    case 0:
      return launch<PresynT, float>(presyn, perm, meta, pids, pmasks, wids, aids, amasks,
                                    nsyn, conn, pot, G, n_seg, M, K, N, W, Ac, cs, stream);
    case 16:
      return launch<PresynT, uint16_t>(presyn, perm, meta, pids, pmasks, wids, aids, amasks,
                                       nsyn, conn, pot, G, n_seg, M, K, N, W, Ac, cs, stream);
    case 8:
      return launch<PresynT, uint8_t>(presyn, perm, meta, pids, pmasks, wids, aids, amasks,
                                      nsyn, conn, pot, G, n_seg, M, K, N, W, Ac, cs, stream);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (presyn_bits == 16) {
    e = launch_perm<int16_t>(perm_kind, presyn, perm, meta, pids, pmasks, wids, aids, amasks,
                             nsyn, conn, pot, G, n_seg, M, K, N, W, Ac, cs, s);
  } else if (presyn_bits == 32) {
    e = launch_perm<int32_t>(perm_kind, presyn, perm, meta, pids, pmasks, wids, aids, amasks,
                             nsyn, conn, pot, G, n_seg, M, K, N, W, Ac, cs, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return (int)e;
}
