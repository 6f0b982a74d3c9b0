// Single-token GQA decode attention against a KV cache, for Hopper (sm_90a).
//
//   out[b, h*G+g, :] = softmax_j( q[b, h*G+g, :] . k[b, j, h, :] / sqrt(D) ) v[b, j, h, :]
//                      over the valid prefix j < kv_len[b]
//
// Replaces the Pallas kernel `repro.kernels.decode_attention
// .decode_attention` (body `_kernel`).  What changed on the way:
//   * The caches are read in their native (B, Sk, Hkv, D) layout; the TPU
//     wrapper transposes (copies) both caches on every call.
//   * The TPU grid's second dimension runs in order and carries (m, l, acc)
//     in scratch; here that dimension is a loop inside the block.
//   * B*Hkv blocks alone leave most of the 132 SMs idle, so Sk is split
//     over blocks (flash-decoding) in one launch: a row whose keys lie in
//     one split is written by that split's block; otherwise each live
//     block writes a partial (m, l, acc), and the last of them to arrive
//     (a counter a row, zero before the launch and left zero after it)
//     merges the partials in split order.  The split is a function of the
//     shapes only, never of kv_len, and no value is summed with atomics,
//     so a row's result does not depend on the other rows of the batch,
//     on its slot, or on which block came last.
//   * No restriction on Sk; kv_len is clamped to [0, Sk]; keys at or past it
//     are never read.  A split that lies wholly past kv_len returns at once
//     and writes nothing, and the merge reads only the splits that hold keys
//     (the same bits as merging empty partials, which weigh 0).  kv_len == 0
//     gives zeros (l floored at 1e-30, as the TPU kernel does).
//   * D = 32, 64 and 128 have exact instances.  Any other D that is a
//     multiple of the 16-byte vector and at most 128 (zamba2-7b's and
//     kimi-k2's 112) runs the padded instance: its register and shared-memory
//     rows are 128 wide, rows are read at their native stride D, and the
//     lanes at or past D load zeros and store nothing.
//
// Bound by bytes: the valid prefix of K and V is read once,
// 2 * sum_b kv_len[b] * Hkv * D * itemsize.
//
// bf16 with G >= 3 (`decode_bf16_tc_kernel`: granite-3-2b's G 4 at D 64;
// dbrx-132b, nemotron-4-15b and qwen2-vl-2b's G 6 and qwen1.5-110b's G 8 at
// D 128; kimi-k2's G 8 at D 112): the G-fold reuse of each K and V element
// runs on the tensor cores, with mma.sync m16n8k16 (bf16 operands, fp32
// accumulators), keys on the M dimension and the group's heads on n8:
//   S^T (16 keys x 8 heads) = K (16 x D) . Q^T (D x 8), and
//   O^T (D x 8 heads)      += V^T (D x 16 keys) . P^T (16 keys x 8 heads).
// q's B fragments are loaded once from device memory (heads G..7 zero: at
// G 6 two of eight columns idle).  Each product of two bf16 is exact in
// fp32, so S^T needs no split.  P^T is split into three bf16 parts (hi +
// mid + lo: all 24 bits of P), and the three products of a 16-key step go
// to a fresh accumulator that is then added to O^T in fp32.  With P in two
// parts (16 bits), as the flash kernel has it, and the products accumulated
// into O^T by the mma itself, many times more bf16 outputs than the plain
// version's were off the correctly rounded value (tests/test_torch_decode.py
// emulates both splits), and the routing of a 2-layer dbrx cut parted from
// the plain path's; now no more than the plain version's (chip_smoke.py's
// `kernels` phase counts them).  The extra products cost nothing that
// shows: the kernel waits on memory.  The C fragment of
// S^T holds (key, head) pairs; movmatrix.trans turns each packed 8 x 8 half
// into the (key, head) B fragment of P^T, so P never leaves registers.
// What held the SIMT kernel back, and what this one does about it:
//   1. Registers: every thread kept G x VEC of q and of the accumulator
//      (255 registers at G 8, 2 blocks an SM, and G 6 ran at G 8).  Here a
//      thread holds D / 8 registers of q, D / 4 of O^T, four scores and
//      P's three parts.  Shared memory sets the blocks an SM (D 128: 2,
//      D 64: 3), and the launch bound asks for just those, so registers
//      cost no block (the build line: about 170 at D 128, 105 at D 64, no
//      spills; held to 128, D 128 spilled).
//   2. No overlap of loads and arithmetic: K and V tiles of 64 keys go
//      through a 3-stage cp.async ring in dynamic shared memory (D 128: 34
//      KB a stage with the pads), so two tiles are in flight while the
//      third is used: 4 x 34 KB on a D-128 SM, 6 x 18 KB on a D-64 SM.
//   3. The reuse of K and V ran as scalar FMAs and shuffles on every lane,
//      at G rounded up to 1, 2, 4 or 8: here a 16-key step of a warp is
//      D / 16 products for S^T and 3 D / 16 for O^T, then 6 shuffles for
//      the heads' maxima; all eight heads cost the same.
//   4. Two launches, the splits' and the merge's, on every call: now one.
//      The merge is the last live block's (above); at served lengths a
//      row's keys lie in split 0, whose block writes the output itself, and
//      the empty splits' blocks return at once.  The counters belong to the
//      caller's stream (kernels/decode_attention.py), so two streams never
//      share one.
// Each of the 4 warps of a block takes its own 16 keys of every tile and
// keeps its own (m, l, O^T); the warps merge in shared memory in warp
// order at the end.  Scores are prescaled by log2(e) / sqrt(D) and
// exponentiated with exp2, as in `flash_fwd_wgmma_kernel`, so its partial
// m are in log2 units.  Rows of the ring are padded by 16 bytes (D + 8
// bf16), so ldmatrix and ldmatrix.trans hit no bank twice.
//
// fp32, and bf16 with G <= 2 (`decode_partial_kernel`, SIMT): kept from
// earlier.  G 1 (zamba2-7b's MHA, qwen1.5-0.5b's) has no grouping to move
// onto the tensor cores, and runs at 81 % of its bound; fp32 is held to
// 2e-5 and would need tf32 splits.  Both products in fp32 on the ALUs:
// TPK = D / VEC threads share one key row with one 16-byte load each, so a
// warp reads 32/TPK whole rows a step; every thread keeps G partial dot
// products, reduced over the TPK lanes with shuffles, and its own slice of
// the G accumulators.  UNROLL rows are loaded before any is used, to keep
// loads in flight.

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro::Vec16;

constexpr float NEG_INF = -1e30f;

// ------------------------------------------------------- the splits --
constexpr int kMaxGroup = 8;     // q heads a kv head
constexpr int kMaxSplits = 64;   // kernels/decode_attention.py, _MAX_SPLITS
// merge_if_last's static shared memory: m and l of every live split, a flag.
constexpr size_t kMergeSmem = 2 * sizeof(float) * kMaxGroup * kMaxSplits + 16;

// Split s of a row covers keys [s * chunk, (s + 1) * chunk); the live ones
// hold keys (at least split 0, which writes a kv_len-0 row's zeros).
__device__ __forceinline__ int live_splits(int len, int chunk, int n_splits) {
  return max(1, min(n_splits, (len + chunk - 1) / chunk));
}

// A block's (M, L, A) for element (g, d) of its split of (b, h): the output
// (out_bh: the row's G x dd values) when the split is the row's only live
// one, else its partial; part_* rows are indexed (first + split) * G + g,
// first = (b * Hkv + h) * n_splits.
template <typename T>
__device__ __forceinline__ void store_split(T* out_bh, float* part_m, float* part_l,
                                            float* part_acc, size_t first, int split, int live,
                                            int G, int dd, int g, int d, float M, float L,
                                            float A) {
  if (live == 1) {
    out_bh[g * dd + d] = Vec16<T>::one(A / fmaxf(L, 1e-30f));
    return;
  }
  const size_t idx = (first + split) * G + g;
  part_acc[idx * dd + d] = A;
  if (d == 0) {
    part_m[idx] = M;
    part_l[idx] = L;
  }
}

// After every block of a row with live > 1 splits has stored its partial,
// the last to arrive (counted on the row's counter, which is zero before
// the launch and left zero after it) folds the live partials together in
// split order: the same arithmetic whichever block is last, and no value
// is summed with atomics.  Every live split's m and l are staged in shared
// memory first, and the accumulators are read four values a load, so the
// merge's loads are in flight together.  LOG2: the partials' m are in log2
// units.
template <typename T, bool LOG2>
__device__ void merge_if_last(T* out_bh, const float* part_m, const float* part_l,
                              const float* part_acc, int* counter, size_t first, int live,
                              int G, int dd) {
  __shared__ int last;
  __shared__ float sm_m[kMaxGroup * kMaxSplits], sm_l[kMaxGroup * kMaxSplits];
  __threadfence();   // this block's partials are visible before it is counted
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == live - 1;
    if (last) {
      *counter = 0;
      __threadfence();
    }
  }
  __syncthreads();
  if (!last) return;
  // Through L2 (ld.global.cg): this SM's L1 may hold the lines of an
  // earlier call's partials.
  for (int i = threadIdx.x; i < G * live; i += blockDim.x) {
    const int g = i / live, s = i % live;
    sm_m[g * kMaxSplits + s] = __ldcg(part_m + (first + s) * G + g);
    sm_l[g * kMaxSplits + s] = __ldcg(part_l + (first + s) * G + g);
  }
  __syncthreads();
  const int quads = dd / 4;
  for (int e = threadIdx.x; e < G * quads; e += blockDim.x) {
    const int g = e / quads, d = 4 * (e % quads);
    const float* ms = sm_m + g * kMaxSplits;
    const float* ls = sm_l + g * kMaxSplits;
    float M = NEG_INF;
    for (int s = 0; s < live; ++s) M = fmaxf(M, ms[s]);
    float L = 0.f, A[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int s = 0; s < live; ++s) {
      const float w = LOG2 ? exp2f(ms[s] - M) : expf(ms[s] - M);
      const float4 x =
          __ldcg(reinterpret_cast<const float4*>(part_acc + ((first + s) * G + g) * dd + d));
      L += ls[s] * w;
      A[0] += x.x * w;
      A[1] += x.y * w;
      A[2] += x.z * w;
      A[3] += x.w * w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) out_bh[g * dd + d + i] = Vec16<T>::one(A[i] / fmaxf(L, 1e-30f));
  }
}

// ------------------------------------------------- SIMT: fp32, bf16 G <= 2 --
constexpr int THREADS = 128;
constexpr int UNROLL = 4;

// D is the width of a row in registers and shared memory; dd the row's
// length and stride in device memory: D itself, or with PAD the runtime
// d_rt <= D, the lanes at or past it masked.
template <typename T, int D, int GMAX, bool PAD>
__global__ void __launch_bounds__(THREADS)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ kv_len,
                      T* __restrict__ out, float* __restrict__ part_m,
                      float* __restrict__ part_l, float* __restrict__ part_acc,
                      int* __restrict__ counters, int Sk, int Hkv, int G, int chunk,
                      int n_splits, float scale, int d_rt) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int TPK = D / VEC;       // threads that share one key row
  constexpr int NG = THREADS / TPK;  // key rows the block reads a step
  static_assert(TPK >= 1 && TPK <= 32 && (TPK & (TPK - 1)) == 0, "D / VEC must be a power of two");

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int grp = tid / TPK, lane = tid % TPK;
  const int Hq = Hkv * G;
  const int dd = PAD ? d_rt : D;
  const bool lane_ok = !PAD || lane * VEC < dd;

  const int len = min(max(kv_len[b], 0), Sk);
  const int start = split * chunk;
  const int end = min(start + chunk, len);  // this block's keys: [start, end)
  const int live = live_splits(len, chunk, n_splits);
  if (split >= live) return;   // no keys here: the merge reads only the live splits

  // The G query heads of this kv head, this thread's slice of each.
  float qf[GMAX][VEC];
  float m[GMAX], l[GMAX], acc[GMAX][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      acc[g][i] = 0.f;
      qf[g][i] = 0.f;
    }
    if (g < G && lane_ok)
      Vec16<T>::unpack(repro::load16_ro(q + ((size_t)b * Hq + h * G + g) * dd + lane * VEC), qf[g]);
  }

  const size_t row_stride = (size_t)Hkv * dd;
  const T* kb = k + ((size_t)b * Sk * Hkv + h) * dd + lane * VEC;
  const T* vb = v + ((size_t)b * Sk * Hkv + h) * dd + lane * VEC;

  // Every thread of the block takes the same number of trips, so that the
  // shuffles below always find their whole warp.
  for (int base = start; base < end; base += NG * UNROLL) {
    uint4 kr[UNROLL], vr[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + u * NG + grp;
      ok[u] = j < end;
      if (ok[u] && lane_ok) {
        kr[u] = repro::load16_ro(kb + (size_t)j * row_stride);
        vr[u] = repro::load16_ro(vb + (size_t)j * row_stride);
      } else {
        kr[u] = make_uint4(0u, 0u, 0u, 0u);
        vr[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }

    // s[u][g] = q_g . k_u * scale, or NEG_INF past the end.
    float s[UNROLL][GMAX];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[VEC];
      Vec16<T>::unpack(kr[u], kf);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) dot += qf[g][i] * kf[i];
#pragma unroll
        for (int off = TPK / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u][g] = ok[u] ? dot * scale : NEG_INF;
      }
    }

    // Online softmax, one rescale for the UNROLL rows; s becomes p.
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) m_new = fmaxf(m_new, s[u][g]);
      const float corr = expf(m[g] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        s[u][g] = ok[u] ? expf(s[u][g] - m_new) : 0.f;
        psum += s[u][g];
      }
      l[g] = l[g] * corr + psum;
      m[g] = m_new;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] *= corr;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float vf[VEC];
      Vec16<T>::unpack(vr[u], vf);
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] += s[u][g] * vf[i];
    }
  }

  // Merge the block's NG row groups through shared memory.
  __shared__ float sm_m[NG][GMAX];
  __shared__ float sm_l[NG][GMAX];
  __shared__ float sm_acc[NG][GMAX][D];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (lane == 0) {
      sm_m[grp][g] = m[g];
      sm_l[grp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) sm_acc[grp][g][lane * VEC + i] = acc[g][i];
  }
  __syncthreads();

  T* out_bh = out + ((size_t)b * Hq + h * G) * dd;
  const size_t first = ((size_t)b * Hkv + h) * n_splits;
  for (int e = tid; e < G * dd; e += THREADS) {
    const int g = e / dd, d = e % dd;
    float M = NEG_INF;
    for (int n = 0; n < NG; ++n) M = fmaxf(M, sm_m[n][g]);
    float L = 0.f, A = 0.f;
    for (int n = 0; n < NG; ++n) {
      const float w = expf(sm_m[n][g] - M);
      L += sm_l[n][g] * w;
      A += sm_acc[n][g][d] * w;
    }
    store_split(out_bh, part_m, part_l, part_acc, first, split, live, G, dd, g, d, M, L, A);
  }
  if (live > 1)
    merge_if_last<T, false>(out_bh, part_m, part_l, part_acc, counters + b * Hkv + h, first,
                            live, G, dd);
}

// ----------------------------------------- tensor cores: bf16, G 3 to 8 --
constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_BK = 64;                  // keys a tile
constexpr int TC_KW = TC_BK / TC_WARPS;    // keys a warp takes of a tile: one m16
constexpr int TC_STAGES = 3;
constexpr int TC_HEADS = 8;                // the group's heads on n8
static_assert(TC_KW == 16, "a warp's share of a tile is one m16 tile of keys");

// Shared memory of an instance: TC_STAGES stages of a K and a V tile, rows
// of D + 8 bf16 (the 16-byte pad shifts each row by four banks); after the
// loop the same bytes hold the warps' (m, l, O) for their merge.
template <int D>
struct DecTile {
  static constexpr int LD = D + 8;
  static constexpr int KV = TC_BK * LD;          // one K (or V) tile, bf16
  static constexpr int STAGE = 2 * KV;
  static constexpr size_t BYTES = sizeof(__nv_bfloat16) * (size_t)TC_STAGES * STAGE;
  static constexpr size_t MERGE = sizeof(float) * (size_t)TC_WARPS * TC_HEADS * (D + 2);
  static_assert(MERGE <= BYTES, "the warps' merge fits in the ring");
  // Blocks that fit an SM's 228 KB of shared memory (with the merge's
  // static arrays and the 1 KB reserved a block), at most 4: the launch
  // bound, so that registers cost no block that fits (D 128: 2, D 64: 3).
  static constexpr size_t SM_BYTES = BYTES + kMergeSmem + 1024;
  static constexpr int BLOCKS_PER_SM = 233472 / SM_BYTES < 4 ? 233472 / SM_BYTES : 4;
};

// Keys [r0, r0 + TC_BK) of one kv head into a tile; keys at or past `end`
// and (with PAD) columns at or past dd are zero-filled and not read.
template <int D, bool PAD>
__device__ __forceinline__ void dec_load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                              size_t stride, int r0, int end, int dd) {
  constexpr int CH = D / 8;   // 16-byte pieces of a row
  static_assert(TC_BK * CH % TC_THREADS == 0, "a tile is whole rounds of the block");
#pragma unroll
  for (int i = 0; i < TC_BK * CH / TC_THREADS; ++i) {
    const int e = threadIdx.x + i * TC_THREADS;
    const int r = e / CH, c = e % CH;
    const int row = r0 + r;
    const bool ok = row < end && (!PAD || c * 8 < dd);
    repro::cp_async16(dst + r * DecTile<D>::LD + c * 8,
                      src + (ok ? (size_t)row * stride + c * 8 : 0), ok);
  }
}

// D is the width of a row in registers and shared memory; dd the row's
// length and stride in device memory (D, or with PAD the runtime d_rt).
template <int D, bool PAD>
__global__ void __launch_bounds__(TC_THREADS, DecTile<D>::BLOCKS_PER_SM)
decode_bf16_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_len,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ part_m,
                      float* __restrict__ part_l, float* __restrict__ part_acc,
                      int* __restrict__ counters, int Sk, int Hkv, int G, int chunk,
                      int n_splits, float scale_log2, int d_rt) {
  constexpr int LD = DecTile<D>::LD;
  constexpr int KS = D / 16;   // k-steps of S^T, and m16 tiles of O^T
  static_assert(D % 16 == 0 && D <= 128, "D must be a multiple of 16 up to 128");

  extern __shared__ __align__(16) unsigned char dec_smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(dec_smem);

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int Hq = Hkv * G;
  const int dd = PAD ? d_rt : D;

  const int len = min(max(kv_len[b], 0), Sk);
  const int start = split * chunk;
  const int end = min(start + chunk, len);  // this block's keys: [start, end)
  const int live = live_splits(len, chunk, n_splits);
  if (split >= live) return;   // no keys here: the merge reads only the live splits
  const int n_tiles = end > start ? (end - start + TC_BK - 1) / TC_BK : 0;

  const size_t kv_row = (size_t)Hkv * dd;
  const __nv_bfloat16* kb = k + (size_t)b * Sk * kv_row + (size_t)h * dd;
  const __nv_bfloat16* vb = v + (size_t)b * Sk * kv_row + (size_t)h * dd;
  auto load = [&](int j) {
    __nv_bfloat16* st = ring + (j % TC_STAGES) * DecTile<D>::STAGE;
    dec_load_tile<D, PAD>(st, kb, kv_row, start + j * TC_BK, end, dd);
    dec_load_tile<D, PAD>(st + DecTile<D>::KV, vb, kv_row, start + j * TC_BK, end, dd);
  };
#pragma unroll
  for (int j = 0; j < TC_STAGES - 1; ++j) {
    if (j < n_tiles) load(j);
    repro::cp_async_commit();
  }

  // Q^T's B fragments (k = d, n = head g; heads at or past G zero),
  // straight from device memory while the first tiles load.
  uint32_t qb[KS][2];
  const __nv_bfloat16* qrow = q + ((size_t)b * Hq + h * G + min(g, G - 1)) * dd;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int d = kk * 16 + 2 * t + 8 * i;
      qb[kk][i] = g < G && (!PAD || d < dd) ? *reinterpret_cast<const uint32_t*>(qrow + d) : 0u;
    }

  // O^T: m16 tile kk holds d = kk*16 + g (+8), heads 2t and 2t + 1, as do
  // the scores' C fragment (keys g, g + 8) and m, l: every value of a head
  // that a thread needs is its own.
  float o[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[kk][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // l: this thread's keys only

  for (int j = 0; j < n_tiles; ++j) {
    repro::cp_async_wait<TC_STAGES - 2>();   // tile j has landed (this thread's copies)
    __syncthreads();                         // ... everyone's; stage j - 1 is free
    if (j + TC_STAGES - 1 < n_tiles) load(j + TC_STAGES - 1);
    repro::cp_async_commit();                // empty near the end, so the wait counts stay right
    const __nv_bfloat16* skt = ring + (j % TC_STAGES) * DecTile<D>::STAGE + warp * TC_KW * LD;
    const __nv_bfloat16* svt = skt + DecTile<D>::KV;

    // S^T = K Q^T over this warp's 16 keys.
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      repro::ldmatrix_x4(a, skt + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
      repro::mma_bf16_16816(s, a, qb[kk][0], qb[kk][1]);
    }

    // Scale into log2 units; mask keys at or past the end.
    const int key0 = start + j * TC_BK + warp * TC_KW + g;
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = key0 + (e >> 1) * 8 < end ? s[e] * scale_log2 : NEG_INF;

    // Online softmax over the 16 keys: a head's max over the warp's 8 key
    // rows g (the lanes of equal t).
    float corr[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float mx = fmaxf(m[c], fmaxf(s[c], s[c + 2]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      corr[c] = exp2f(m[c] - mx);
      m[c] = mx;
      l[c] *= corr[c];
    }
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = s[e] > 0.5f * NEG_INF ? exp2f(s[e] - m[e & 1]) : 0.f;
      l[e & 1] += p[e];
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[kk][e] *= corr[e & 1];

    // P^T's B fragments (k = key, n = head): the packed (key, head) halves
    // of the C fragment (keys g and g + 8), transposed; P = hi + mid + lo,
    // each bf16, which keeps all of P's 24 bits.
    uint32_t pb[3][2];   // hi, mid, lo
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      pb[0][i] = repro::pack_bf16x2(p[2 * i], p[2 * i + 1]);
      repro::split_bf16x2(p[2 * i] - __uint_as_float(pb[0][i] << 16),
                          p[2 * i + 1] - __uint_as_float(pb[0][i] & 0xffff0000u), pb[1][i],
                          pb[2][i]);
#pragma unroll
      for (int part = 0; part < 3; ++part) pb[part][i] = repro::movmatrix_trans(pb[part][i]);
    }

    // O^T += V^T P^T: V^T's A fragments by ldmatrix.trans of the V rows.
    // The three products, smallest first, go to a fresh accumulator, which
    // is added to O^T in fp32 (rounded to nearest): the mma's own
    // accumulation into a long-lived O^T drifted it from the plain version.
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      repro::ldmatrix_x4_trans(a, svt + ((lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                                      ((lane >> 3) & 1) * 8);
      float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int part = 2; part >= 0; --part) repro::mma_bf16_16816(t, a, pb[part][0], pb[part][1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) o[kk][e] += t[e];
    }
  }

  // The warps' states into shared memory (the ring is done with), then
  // merged in warp order.
  repro::cp_async_wait<0>();
  __syncthreads();
  float* sm_o = reinterpret_cast<float*>(dec_smem);     // [warp][head][D]
  float* sm_m = sm_o + TC_WARPS * TC_HEADS * D;          // [warp][head]
  float* sm_l = sm_m + TC_WARPS * TC_HEADS;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    l[c] += __shfl_xor_sync(0xffffffffu, l[c], 4);
    l[c] += __shfl_xor_sync(0xffffffffu, l[c], 8);
    l[c] += __shfl_xor_sync(0xffffffffu, l[c], 16);
    if (g == 0) {
      sm_m[warp * TC_HEADS + 2 * t + c] = m[c];
      sm_l[warp * TC_HEADS + 2 * t + c] = l[c];
    }
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sm_o[(warp * TC_HEADS + 2 * t + (e & 1)) * D + kk * 16 + g + (e >> 1) * 8] = o[kk][e];
  __syncthreads();

  __nv_bfloat16* out_bh = out + ((size_t)b * Hq + h * G) * dd;
  const size_t first = ((size_t)b * Hkv + h) * n_splits;
  for (int e = tid; e < G * dd; e += TC_THREADS) {
    const int hg = e / dd, d = e % dd;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w) M = fmaxf(M, sm_m[w * TC_HEADS + hg]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w) {
      const float wt = exp2f(sm_m[w * TC_HEADS + hg] - M);
      L += sm_l[w * TC_HEADS + hg] * wt;
      A += sm_o[(w * TC_HEADS + hg) * D + d] * wt;
    }
    store_split(out_bh, part_m, part_l, part_acc, first, split, live, G, dd, hg, d, M, L, A);
  }
  if (live > 1)
    merge_if_last<__nv_bfloat16, true>(out_bh, part_m, part_l, part_acc, counters + b * Hkv + h,
                                       first, live, G, dd);
}

struct Args {
  const void *q, *k, *v;
  const int* kv_len;
  void* out;
  float *part_m, *part_l, *part_acc;
  int* counters;
  int B, Sk, Hq, Hkv, D, chunk, n_splits, tensor_cores;
  cudaStream_t stream;
};

template <typename T, int D, int GMAX, bool PAD>
int launch(const Args& a) {
  const int G = a.Hq / a.Hkv;
  const dim3 grid(a.n_splits, a.Hkv, a.B);
  decode_partial_kernel<T, D, GMAX, PAD><<<grid, THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.kv_len, static_cast<T*>(a.out), a.part_m, a.part_l, a.part_acc, a.counters, a.Sk,
      a.Hkv, G, a.chunk, a.n_splits, 1.0f / sqrtf((float)a.D), a.D);
  return (int)cudaGetLastError();
}

template <int D, bool PAD>
int launch_tc(const Args& a) {
  constexpr size_t smem = DecTile<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(decode_bf16_tc_kernel<D, PAD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.n_splits, a.Hkv, a.B);
  decode_bf16_tc_kernel<D, PAD><<<grid, TC_THREADS, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.kv_len, static_cast<__nv_bfloat16*>(a.out),
      a.part_m, a.part_l, a.part_acc, a.counters, a.Sk, a.Hkv, a.Hq / a.Hkv, a.chunk,
      a.n_splits, 1.4426950408889634f / sqrtf((float)a.D), a.D);
  return (int)cudaGetLastError();
}

// The caller chooses the instance (a.tensor_cores) and plans the splits for
// it; a choice with no instance here is refused.  bf16 has the tensor-core
// instance for groups of 3 to 8 and SIMT ones for 1 and 2; fp32 only SIMT.
template <typename T, int D, bool PAD = false>
int launch_g(const Args& a) {
  const int G = a.Hq / a.Hkv;
  if (G > 8) return -1;
  if constexpr (sizeof(T) == 2) {
    if (a.tensor_cores) return G >= 3 ? launch_tc<D, PAD>(a) : -1;
    if (G == 1) return launch<T, D, 1, PAD>(a);
    if (G == 2) return launch<T, D, 2, PAD>(a);
    return -1;
  } else {
    if (a.tensor_cores) return -1;
    if (G == 1) return launch<T, D, 1, PAD>(a);
    if (G == 2) return launch<T, D, 2, PAD>(a);
    if (G <= 4) return launch<T, D, 4, PAD>(a);
    return launch<T, D, 8, PAD>(a);
  }
}

template <typename T>
int launch_d(const Args& a) {
  if (a.D == 32) return launch_g<T, 32>(a);
  if (a.D == 64) return launch_g<T, 64>(a);
  if (a.D == 128) return launch_g<T, 128>(a);
  if (repro::padded_head_dim<T>(a.D)) return launch_g<T, repro::kMaxHeadDim, true>(a);
  return -1;
}

}  // namespace

// Returns the launch's cudaError_t (0 on success), or -1 for arguments the
// kernel does not take.  q, out: (B, 1, Hq, D); k, v: (B, Sk, Hkv, D);
// kv_len: (B,) int32; all contiguous, on the device, 16-byte aligned; D a
// multiple of the 16-byte vector (8 bf16, 4 fp32) and at most 128; G = Hq /
// Hkv at most 8.  Split s covers keys [s*chunk, (s+1)*chunk).  With
// n_splits > 1 (at most 64) the scratch holds part_m, part_l: (B, Hkv,
// n_splits, G) and part_acc: (B, Hkv, n_splits, G, D), fp32 (part_acc
// 16-byte aligned), and counters (B * Hkv) int32 is
// zero, and left zero when the kernel ends: launches that share it must be
// ordered (one stream); with n_splits == 1 neither is touched.  tensor_cores
// picks decode_bf16_tc_kernel (bf16, G 3 to 8) over decode_partial_kernel.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* kv_len, void* out, void* part_m,
                                      void* part_l, void* part_acc, void* counters, int B,
                                      int Sk, int Hq, int Hkv, int D, int chunk, int n_splits,
                                      int is_bf16, int tensor_cores, void* stream) {
  if (B <= 0 || Sk <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || chunk <= 0 ||
      n_splits <= 0 || n_splits > kMaxSplits || (long long)chunk * n_splits < Sk ||
      Hkv > 65535 || B > 65535)
    return -1;
  Args a{q, k, v, static_cast<const int*>(kv_len), out, static_cast<float*>(part_m),
         static_cast<float*>(part_l), static_cast<float*>(part_acc), static_cast<int*>(counters),
         B, Sk, Hq, Hkv, D, chunk, n_splits, tensor_cores, static_cast<cudaStream_t>(stream)};
  if (is_bf16) return launch_d<__nv_bfloat16>(a);
  return launch_d<float>(a);
}
