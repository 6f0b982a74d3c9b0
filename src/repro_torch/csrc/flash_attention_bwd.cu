// The gradient of the causal or non-causal GQA flash-attention forward
// (csrc/flash_attention.cu), for Hopper (sm_90a).  With scale = D^-0.5, the
// forward's lse (natural log, fp32, (B, Hkv, G, Sq) = (B, Hq, Sq)) and the
// output's gradient dout:
//
//   delta[b, h, i] = sum_d dout[b, i, h, d] * out[b, i, h, d]
//   P[i, j]  = exp(q_i . k_j * scale - lse[b, h, i])   over the visible pairs
//              (j < Sk, and j <= i when causal), 0 elsewhere
//   dS[i, j] = P[i, j] * (dout_i . v_j - delta[b, h, i])
//   dq_i = scale * sum_j dS[i, j] k_j
//   dk_j = scale * sum_{h of j's group, i} dS[i, j] q_i
//   dv_j = sum_{h of j's group, i} P[i, j] dout_i
//
// each accumulated in fp32 and rounded once to q's type.  Replaces the
// reference's `custom_vjp` rule of `repro.models.attention
// .flash_attention_jnp` (`_flash_bwd_rule`), the gradient of the Pallas
// forward `repro.kernels.flash_attention.flash_attention`; the TPU runs
// that rule as XLA ops, the port ran its plain PyTorch copy.
//
// Two passes, two kernels, and no unordered atomics: each gradient element
// is summed in a fixed order, so two calls give the same bits (a sharded
// step on a (1, 1) mesh is held bit for bit against the unsharded one).
//   * dq (`flash_bwd_dq_*`): a block per (query tile, query head) walks the
//     key tiles; it first computes its rows' delta from out and dout, and
//     writes delta and the lse (in the units the second kernel reads) into
//     a scratch of (B, Hq, Sq_pad) rows, Sq_pad = Sq rounded up to 128.
//   * dk/dv (`flash_bwd_dkdv_*`): fp32 a block per (key tile, kv head)
//     walks the query tiles of every query head of the group.  bf16 a
//     block is a piece of that walk (below).
// Under causality tiles wholly above the diagonal are not visited.  No
// divisibility is asked: ragged tiles are masked, rows past Sq read an lse
// that makes P 0, and rows and columns past the tensors are not stored.
//
// Bound, at granite-3-2b's training shape (B 2, S 4096, Hq 32, Hkv 8, D 64,
// bf16, causal): by operations, five products over the visible pairs,
// 10 * pairs * Hq * D = 3.44e11 FLOPs (0.3475 ms at the bf16 tensor-core
// peak), against about 170 MB moved (0.051 ms).  The bf16 kernels do 8
// products where the bound counts 5 (S and dP in both passes; dS split in
// two for dK), so they can reach at most 5/8 of it.
//
// bf16 (`*_wgmma_kernel`), for Hopper: a producer warpgroup (registers
// lowered to 24) issues TMA loads from one thread, the block's own tiles
// once and the streamed tiles into a ring of 4 stages, each with a full and
// an empty mbarrier; consumer warpgroups, 64 rows of the block's tile each,
// compute on wgmma.
//   * dq: at D 64 three consumers (192 query rows a block, 160 registers
//     each), at D 128 two (128 rows, 240 registers); K and V streamed in
//     tiles of 64 keys.  S = Q K^T and dP = dO V^T from shared memory
//     (K-major, TMA's 128-byte swizzle), dS in registers as the A operand,
//     dQ += dS K with K read MN-major through wgmma's transpose.
//   * dk/dv: two consumers, 64 of a key block's 128 keys each (K and V
//     kept); Q and dO streamed in tiles of 64 queries with the tile's lse
//     and delta (1-D bulk copies from the scratch).  S^T = K Q^T and dP^T =
//     V dO^T from shared memory, then dV += P^T dO and dK += dS^T Q from
//     registers, dO and Q read MN-major.
// Rounding.  P is rounded once to bf16 for dV, and dS once for dQ, as
// FlashAttention-2 and -3 do.  dS is split into bf16 hi + lo for dK, two
// products (about 16 of its bits): rounded once it moved qwen2-vl's bf16
// step-1 loss past train_vs_fp32 on an H100, since a K projection's bias
// has the gradient sum_j dk_j = scale sum_i (sum_j dS_ij) q_i, whose rows
// of dS sum to zero and cancel.  dQ's bias gradient sums dS down its
// columns, which do not cancel (tests/test_torch_flash_bwd.py holds both).
// Every sum is fp32; scores are scaled into log2 units (exp2), the lse by
// log2(e) once a row.  D 64 and 128 are the instances; any other multiple
// of 8 up to 128 runs the one above it (zamba2-7b's 112 the 128 instance)
// with zero columns.
// Overlap.  Every wgmma commit group is waited for in the loop step that
// issues it: a first version that left S and dP in flight across the
// loop's back edge was serialized by ptxas (C7514 / C7515).  S and dP are
// two groups, so P is computed while dP runs.
//   * dq, and dk/dv at D 64: a step issues tile j + 1's S and dP and tile
//     j's second products together, then computes P and dS of tile j + 1
//     as they land and puts them in the other of two sets of A-operand
//     registers while tile j's products still read theirs.
//   * dk/dv at D 128: within a tile (dV issued before dS is computed, dK
//     after): two tiles' operands (96 registers) beside tile j + 1's
//     accumulators (64) and dK and dV's (128) would not fit in 240.
// Measured (tools/flash_bwd_phases.py, granite's shape, an H100): against
// the earlier kernels (S and dP waited for, then P and dS, then the second
// products waited for), the dq pass's busiest SM 1.21M -> 0.83-0.89M
// cycles and the dk/dv pass's 1.26M -> 1.09-1.13M; a tile's wait for its
// loads is 140-215 cycles and the issue of its products 500-850, the
// tensor pipe's queue being full.  Tried and not kept: the two consumers
// taking turns to issue on named barriers (no change beyond noise, as in
// the earlier kernels); half the exponentials on the FMA pipe by a
// polynomial (slower: 1.53-1.65 against 1.34-1.38 ms at granite's shape);
// dS's hi cut rather than rounded, a byte permute for a conversion (no
// faster); eight ring stages at D 64 (the dq pass 2 % fewer cycles, within
// the 5 % the same code moves between runs).
// Balance.  Under causality the dk/dv key blocks' walks differ: the first
// of qwen2-vl-2b's (Hkv 2, G 6, S 4096) visits 384 query tiles, the last
// 12, and its 128 blocks, one an SM, left the pass's busiest SM at 1.92
// times the median SM's cycles.  So a key block whose walk holds more than
// half an SM's even share is cut into pieces of at most `cap` tiles
// (`kv_item`; the wrapper sets cap, see kernels/flash_attention.py),
// launched longest block first: there 576 pieces, the busiest SM at 1.18
// times the median.  A cut block's pieces write fp32 partial sums into a
// slot each; the piece that takes the block's last ticket (an atomic
// counter, no wait) adds the slots in piece order, stores, and puts the
// ticket back to 0, so the order and the bits are fixed.  The other paths'
// blocks (whose longest walk is at most half an SM's share) stay whole.
// Not taken: one pass over key blocks adding each dQ share to an fp32
// accumulator (FlashAttention-3's), which saves S and dP of the dq pass (2
// of the 8 products) but at granite's shape adds about 67,600 tile adds of
// 16 KB, 2.2 GB read and written against a 67 MB accumulator larger than
// the 50 MB L2, in a fixed key-block order that blocks wait on.
//
// fp32 (`flash_bwd_dq_kernel`, `flash_bwd_dkdv_kernel`): the same two
// passes on the fp32 cores, for the 2e-5-class checks and the fp32 cuts.  A
// group of TPR = D / 32 neighbouring threads owns one row (a query's, or a
// key's), 32 of its values in registers each; the streamed tiles are staged
// in shared memory and the dot products summed over the group by shuffles.
// D = 32, 64 and 128 are exact; any other multiple of 4 up to 128 runs the
// 128 instance with the lanes past D zero and unstored.

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
// The lse of a row past Sq: every P of the row is then exp(s - BIG) = 0.
constexpr float BIG = 1e30f;
// Rows of the scratch a (b, h): Sq rounded up to a multiple of this.
constexpr int SQ_PAD = 128;

// ------------------------------------------------------------- fp32 path --
constexpr int THREADS = 128;
constexpr int PER = 32;    // values of a row a thread holds
constexpr int NQ = PER / 4;

__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  f[0] = r.x;
  f[1] = r.y;
  f[2] = r.z;
  f[3] = r.w;
}

// The dot product of a row's values in registers (this thread's share)
// with a row in shared memory, summed over the TPR threads of the row.
template <int TPR>
__device__ __forceinline__ float row_dot(const float (&x)[NQ][4], const float* s, int part) {
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < NQ; ++c) {
    const float4 y = *reinterpret_cast<const float4*>(s + 4 * (c * TPR + part));
    dot = fmaf(x[c][0], y.x, dot);
    dot = fmaf(x[c][1], y.y, dot);
    dot = fmaf(x[c][2], y.z, dot);
    dot = fmaf(x[c][3], y.w, dot);
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
  return dot;
}

// acc += w * (the row in shared memory), this thread's share.
__device__ __forceinline__ void row_axpy(float (&acc)[NQ][4], float w, const float* s, int part,
                                         int tpr) {
#pragma unroll
  for (int c = 0; c < NQ; ++c) {
    const float4 y = *reinterpret_cast<const float4*>(s + 4 * (c * tpr + part));
    acc[c][0] = fmaf(w, y.x, acc[c][0]);
    acc[c][1] = fmaf(w, y.y, acc[c][1]);
    acc[c][2] = fmaf(w, y.z, acc[c][2]);
    acc[c][3] = fmaf(w, y.w, acc[c][3]);
  }
}

// This thread's share of a row of length dd in device memory (zeros where
// the row is not there or past dd).  Quad c holds values 4 * (c * TPR +
// part) + 0..3, so the TPR threads of a row read neighbouring pieces.
template <int TPR, bool PAD>
__device__ __forceinline__ void load_row(float (&x)[NQ][4], const float* row, bool ok, int part,
                                         int dd) {
#pragma unroll
  for (int c = 0; c < NQ; ++c) {
    if (ok && (!PAD || 4 * (c * TPR + part) < dd)) {
      load4(row + 4 * (c * TPR + part), x[c]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[c][e] = 0.f;
    }
  }
}

template <int TPR, bool PAD>
__device__ __forceinline__ void store_row(float* row, const float (&x)[NQ][4], float mul,
                                          int part, int dd) {
#pragma unroll
  for (int c = 0; c < NQ; ++c) {
    if (PAD && 4 * (c * TPR + part) >= dd) continue;
    *reinterpret_cast<float4*>(row + 4 * (c * TPR + part)) =
        make_float4(x[c][0] * mul, x[c][1] * mul, x[c][2] * mul, x[c][3] * mul);
  }
}

// A (rows, dd) slice of a (.., H, dd) tensor into shared memory as rows of
// D values, zeros past dd and for rows at or past `end`.
template <int D, bool PAD>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, size_t row_stride,
                                           int first, int rows, int end, int dd) {
  constexpr int RV = D / 4;
  for (int e = threadIdx.x; e < rows * RV; e += THREADS) {
    const int r = e / RV, c = e % RV;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (first + r < end && (!PAD || c * 4 < dd)) {
      const uint4 u = repro::load16_ro(src + (size_t)(first + r) * row_stride + c * 4);
      f = make_float4(__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
                      __uint_as_float(u.w));
    }
    *reinterpret_cast<float4*>(dst + r * D + c * 4) = f;
  }
}

// dq, and each row's delta into the scratch.  A block: BQ query rows of one
// (b, h); K and V tiles of BK keys staged in shared memory.
template <int D, bool PAD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ out,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta_out, float* __restrict__ dq, int Sq, int Sk,
                    int Sq_pad, int Hq, int Hkv, int causal, float scale, int d_rt) {
  constexpr int TPR = D / PER;
  constexpr int BQ = THREADS / TPR;
  constexpr int BK = 2048 / D;
  static_assert(TPR >= 1 && TPR <= 4, "D must be 32, 64 or 128");

  __shared__ __align__(16) float sk[BK * D];
  __shared__ __align__(16) float sv[BK * D];

  const int tid = threadIdx.x;
  const int row = tid / TPR, part = tid % TPR;
  const int q0 = blockIdx.x * BQ;
  const int qi = q0 + row;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const bool q_ok = qi < Sq;
  const int dd = PAD ? d_rt : D;

  const size_t q_at = (((size_t)b * Sq + (q_ok ? qi : 0)) * Hq + h) * dd;
  float qf[NQ][4], dof[NQ][4], acc[NQ][4];
  load_row<TPR, PAD>(qf, q + q_at, q_ok, part, dd);
  load_row<TPR, PAD>(dof, dout + q_at, q_ok, part, dd);
  load_row<TPR, PAD>(acc, out + q_at, q_ok, part, dd);     // out, for delta
  float delta = 0.f;
#pragma unroll
  for (int c = 0; c < NQ; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      delta = fmaf(dof[c][e], acc[c][e], delta);
      acc[c][e] = 0.f;
    }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) delta += __shfl_xor_sync(0xffffffffu, delta, off);
  const float L = q_ok ? lse[((size_t)b * Hq + h) * Sq + qi] : BIG;
  if (q_ok && part == 0) delta_out[((size_t)b * Hq + h) * Sq_pad + qi] = delta;

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const size_t kv_row = (size_t)Hkv * dd;
  const float* kb = k + (size_t)b * Sk * kv_row + (size_t)hk * dd;
  const float* vb = v + (size_t)b * Sk * kv_row + (size_t)hk * dd;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    stage_rows<D, PAD>(sk, kb, kv_row, k0, BK, Sk, dd);
    stage_rows<D, PAD>(sv, vb, kv_row, k0, BK, Sk, dd);
    __syncthreads();
    // The same trip count for every thread: the shuffles need the warp.
    const int n = min(BK, k_end - k0);
    for (int j = 0; j < n; ++j) {
      const float s = row_dot<TPR>(qf, sk + j * D, part);
      const float dp = row_dot<TPR>(dof, sv + j * D, part);
      const int key = k0 + j;
      const bool ok = q_ok && (!causal || key <= qi);
      const float p = ok ? expf(fmaf(s, scale, -L)) : 0.f;
      row_axpy(acc, p * (dp - delta), sk + j * D, part, TPR);
    }
  }
  if (q_ok) store_row<TPR, PAD>(dq + q_at, acc, scale, part, dd);
}

// dk and dv.  A block: BKR key rows of one (b, hk); the query tiles of each
// head of the group (rows, dout, lse, delta) staged in shared memory.
template <int D, bool PAD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk,
                      int Sq_pad, int Hq, int Hkv, int causal, float scale, int d_rt) {
  constexpr int TPR = D / PER;
  constexpr int BKR = THREADS / TPR;
  constexpr int BQT = 2048 / D;
  static_assert(TPR >= 1 && TPR <= 4, "D must be 32, 64 or 128");

  __shared__ __align__(16) float sq[BQT * D];
  __shared__ __align__(16) float sdo[BQT * D];
  __shared__ float sl[BQT], sd[BQT];

  const int tid = threadIdx.x;
  const int row = tid / TPR, part = tid % TPR;
  const int k0 = blockIdx.x * BKR;
  const int kj = k0 + row;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const bool k_ok = kj < Sk;
  const int dd = PAD ? d_rt : D;

  const size_t k_at = (((size_t)b * Sk + (k_ok ? kj : 0)) * Hkv + hk) * dd;
  float kf[NQ][4], vf[NQ][4], dka[NQ][4], dva[NQ][4];
  load_row<TPR, PAD>(kf, k + k_at, k_ok, part, dd);
  load_row<TPR, PAD>(vf, v + k_at, k_ok, part, dd);
#pragma unroll
  for (int c = 0; c < NQ; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[c][e] = dva[c][e] = 0.f;

  // Causal: no query before the block's first key sees it.
  const int q_begin = causal ? min(Sq, k0 / BQT * BQT) : 0;
  const size_t q_row = (size_t)Hq * dd;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const float* qb = q + (size_t)b * Sq * q_row + (size_t)h * dd;
    const float* dob = dout + (size_t)b * Sq * q_row + (size_t)h * dd;
    const float* lb = lse + ((size_t)b * Hq + h) * Sq;
    const float* db = delta + ((size_t)b * Hq + h) * Sq_pad;
    for (int i0 = q_begin; i0 < Sq; i0 += BQT) {
      __syncthreads();
      stage_rows<D, PAD>(sq, qb, q_row, i0, BQT, Sq, dd);
      stage_rows<D, PAD>(sdo, dob, q_row, i0, BQT, Sq, dd);
      for (int e = tid; e < BQT; e += THREADS) {
        const bool ok = i0 + e < Sq;
        sl[e] = ok ? lb[i0 + e] : BIG;
        sd[e] = ok ? db[i0 + e] : 0.f;
      }
      __syncthreads();
      const int n = min(BQT, Sq - i0);
      for (int i = 0; i < n; ++i) {
        const float s = row_dot<TPR>(kf, sq + i * D, part);
        const float dp = row_dot<TPR>(vf, sdo + i * D, part);
        const bool ok = k_ok && (!causal || kj <= i0 + i);
        const float p = ok ? expf(fmaf(s, scale, -sl[i])) : 0.f;
        row_axpy(dva, p, sdo + i * D, part, TPR);
        row_axpy(dka, p * (dp - sd[i]), sq + i * D, part, TPR);
      }
    }
  }
  if (!k_ok) return;
  store_row<TPR, PAD>(dk + k_at, dka, scale, part, dd);
  store_row<TPR, PAD>(dv + k_at, dva, 1.f, part, dd);
}

template <int D, bool PAD = false>
int launch_f32(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const void* lse, void* dq, void* dk, void* dv, float* delta, int B, int Sq,
               int Sk, int Sq_pad, int Hq, int Hkv, int d, int causal, cudaStream_t stream) {
  constexpr int ROWS = THREADS / (D / PER);
  const float scale = 1.0f / sqrtf((float)d);
  const dim3 grid_q((Sq + ROWS - 1) / ROWS, Hq, B);
  flash_bwd_dq_kernel<D, PAD><<<grid_q, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(out), static_cast<const float*>(dout),
      static_cast<const float*>(lse), delta, static_cast<float*>(dq), Sq, Sk, Sq_pad, Hq, Hkv,
      causal, scale, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k((Sk + ROWS - 1) / ROWS, Hkv, B);
  flash_bwd_dkdv_kernel<D, PAD><<<grid_k, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse), delta,
      static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk, Sq_pad, Hq, Hkv, causal, scale,
      d);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- bf16 path --
constexpr int WG = 128;        // threads of a warpgroup
constexpr int BOX = 64;        // columns of a TMA box: one 128-byte swizzled row
constexpr int DQ_BK = 64;      // keys a K / V tile of the dq kernel
constexpr int KV_BK = 128;     // keys a dk/dv key block, 64 for each consumer
constexpr int KV_BQ = 64;      // queries a Q / dO tile of the dk/dv kernel
constexpr int STAGES = 4;      // of each ring
static_assert(SQ_PAD % KV_BQ == 0, "the scratch's rows");

// The dq kernel's consumers (64 query rows each, a block's rows BQ), their
// registers after the hand-over, and its shared memory: Q's and dO's
// tiles, then the K and V rings.  At D 64 three consumers fit (160
// registers each beside the producer's 24); at D 128 two (240).
template <int D>
struct DqTile {
  static constexpr int NC = D <= 64 ? 3 : 2;
  static constexpr int BQ = 64 * NC;
  static constexpr int REGS = NC == 3 ? 160 : 240;
  static constexpr int THREADS = (NC + 1) * WG;
  static constexpr int NB = D / BOX;
  static constexpr int Q_BOX = BQ * 128;
  static constexpr int KV_BOX = DQ_BK * 128;
  static constexpr int Q_BYTES = NB * Q_BOX;
  static constexpr int KV_BYTES = NB * KV_BOX;
  // + 1024: the dynamic base is moved up to the swizzle atom's alignment
  static constexpr size_t SMEM = 1024 + 2 * Q_BYTES + 2 * STAGES * (size_t)KV_BYTES;
  static_assert(D % BOX == 0 && SMEM <= 232448, "shared memory of an instance");
};

// The dk/dv kernel's: K's and V's tiles, the Q and dO rings, then the lse
// and delta rings (KV_BQ fp32 a stage each).
template <int D>
struct KvTile {
  static constexpr int NB = D / BOX;
  static constexpr int K_BOX = KV_BK * 128;
  static constexpr int Q_BOX = KV_BQ * 128;
  static constexpr int K_BYTES = NB * K_BOX;
  static constexpr int Q_BYTES = NB * Q_BOX;
  static constexpr int ROW_BYTES = KV_BQ * 4;
  static constexpr size_t SMEM =
      1024 + 2 * K_BYTES + 2 * STAGES * (size_t)Q_BYTES + 2 * STAGES * ROW_BYTES;
  static_assert(D % BOX == 0 && SMEM <= 232448, "shared memory of an instance");
};

// The dk/dv grid's items.  Key block z (KV_BK keys) of a (kv head, batch)
// visits w(z) = G * (n_qt - qt0(z)) query tiles of KV_BQ, every head of the
// group in turn (qt0: under causality the first tile that reaches the
// block); it is cut into n(z) = ceil(w(z) / cap) pieces (at least one) of
// near-equal length, piece p taking tiles [w p / n, w (p + 1) / n).  Items
// are the pieces in key-block order, the longest blocks first under
// causality; the cut blocks come first (w falls with z), so their items
// are 0 .. n_split - 1 and index the partial sums' slots.  Mirrored by
// `kernels.flash_attention.dkdv_items`, which the tests hold to cover
// every visible (query tile, key block) pair once.
struct Item {
  int z;      // key block
  int t0;     // the piece's first tile of the block's sequence
  int t1;     // one past its last
  int p;      // the piece
  int n;      // the block's pieces
  int first;  // the block's first item
};

__host__ __device__ __forceinline__ int kv_tiles(int z, int n_qt, int G, int causal) {
  return G * (n_qt - (causal ? min(z * (KV_BK / KV_BQ), n_qt) : 0));
}

__host__ __device__ __forceinline__ int kv_pieces(int w, int cap) {
  return max(1, (w + cap - 1) / cap);
}

__device__ __forceinline__ Item kv_item(int x, int n_qt, int G, int causal, int cap) {
  Item it;
  it.z = 0;
  it.first = 0;
  it.n = kv_pieces(kv_tiles(0, n_qt, G, causal), cap);
  if (!causal) {
    it.z = x / it.n;
    it.first = it.z * it.n;
  } else {
    while (x >= it.first + it.n) {
      it.first += it.n;
      ++it.z;
      it.n = kv_pieces(kv_tiles(it.z, n_qt, G, causal), cap);
      if (it.n == 1) {        // w falls with z: one item a block from here on
        it.z += x - it.first;
        it.first = x;
        break;
      }
    }
  }
  const int w = kv_tiles(it.z, n_qt, G, causal);
  it.p = x - it.first;
  it.t0 = w * it.p / it.n;
  it.t1 = w * (it.p + 1) / it.n;
  return it;
}

// (items, cut items) of a (kv head, batch): what `kv_item` decodes.
inline void kv_count(int n_kb, int n_qt, int G, int causal, int cap, int* items, int* split) {
  *items = *split = 0;
  for (int z = 0; z < n_kb; ++z) {
    const int n = kv_pieces(kv_tiles(z, n_qt, G, causal), cap);
    *items += n;
    if (n > 1) *split += n;
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// acc (64 x 64, fp32) = A B^T over D: A's 64 rows at a_at (K-major, boxes of
// a_box bytes), B's 64 rows at b_at (K-major, boxes of b_box bytes); D / 16
// k-steps of m64n64k16.  The descriptors are made anew on every call
// (`repro::opaque`): hoisted out of the loops they spill.
template <int D, int A_BOX, int B_BOX>
__device__ __forceinline__ void rows_by_rows(float (&acc)[32], uint32_t a_at, uint32_t b_at) {
  const uint64_t ad = repro::wgmma_desc(repro::opaque(a_at), 16, 1024);
  const uint64_t bd = repro::wgmma_desc(repro::opaque(b_at), 16, 1024);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 32 bytes a k-step inside a 128-byte row, then the next 64-column box
    const uint32_t at = (kk % 4) * 32;
    repro::wgmma_ss(acc, ad + (((kk / 4) * A_BOX + at) >> 4), bd + (((kk / 4) * B_BOX + at) >> 4),
                    kk > 0);
  }
}

// A 64 x 64 fp32 tile in the accumulator layout as the A operands (bf16)
// of the 4 k-steps of a product over its columns: the C layout of the n8
// tiles 2kk and 2kk + 1 is the A layout of k-step kk (hopper.cuh).
__device__ __forceinline__ void to_a_operand(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* y = x + 4 * (2 * kk + (e >> 1)) + 2 * (e & 1);
      a[kk][e] = repro::pack_bf16x2(y[0], y[1]);
    }
    repro::fence_regs(a[kk]);
  }
}

// The same, each value split into bf16 hi + lo (a[0] and a[1]).
__device__ __forceinline__ void to_a_split(const float (&x)[32], uint32_t (&a)[2][4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* y = x + 4 * (2 * kk + (e >> 1)) + 2 * (e & 1);
      repro::split_bf16x2(y[0], y[1], a[0][kk][e], a[1][kk][e]);
    }
    repro::fence_regs(a[0][kk]);
    repro::fence_regs(a[1][kk]);
  }
}

// acc (64 x D) += A (64 x 64 in registers) B, B's 64 rows at b_at stored
// (rows, D) in boxes of b_box bytes and read MN-major: 4 k-steps of 16 rows.
template <int D, int B_BOX>
__device__ __forceinline__ void regs_by_rows(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                             uint32_t b_at) {
  const uint64_t bd = repro::wgmma_desc(repro::opaque(b_at), B_BOX, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) repro::wgmma_rs_tn(acc, a[kk], bd + ((kk * 16 * 128) >> 4));
}

// Stores a 64 x D accumulator's rows (first_row + the layout's row) that
// lie below `rows`, columns below d_rt, times mul, as bf16 rows of stride
// `stride` at base.
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* base, size_t stride, const float* acc,
                                          float mul, int row0, int rows, int t, int d_rt) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= rows) continue;
    __nv_bfloat16* dst = base + (size_t)row * stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col >= d_rt) continue;
      *reinterpret_cast<uint32_t*>(dst + col) =
          repro::pack_bf16x2(acc[4 * n + 2 * r] * mul, acc[4 * n + 2 * r + 1] * mul);
    }
  }
}

// dq, with each row's delta and lse (log2 units) into the scratch.  q, dout,
// k and v arrive through tensor maps (D, H, S, B); out and lse are read
// directly for the prologue's delta.
template <int D>
__global__ void __launch_bounds__(DqTile<D>::THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __nv_bfloat16* __restrict__ out,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                          float* __restrict__ lse2_out, float* __restrict__ delta_out,
                          __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int Sq_pad, int Hq,
                          int Hkv, int causal, float scale_log2, float scale, int d_rt) {
  using T = DqTile<D>;
  extern __shared__ unsigned char dq_smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  const uint32_t raw = repro::smem_addr(dq_smem_raw);
  unsigned char* sq = dq_smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* sdo = sq + T::Q_BYTES;
  unsigned char* sk = sdo + T::Q_BYTES;
  unsigned char* sv = sk + STAGES * T::KV_BYTES;
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;           // TMA has landed K and V of stage s
  uint64_t* empty = full + STAGES;     // every consumer is done with stage s

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * T::BQ;   // the longest rows first
  const int hk = h / (Hq / Hkv);
  const int k_end = causal ? min(Sk, q0 + T::BQ) : Sk;
  const int n_tiles = (k_end + DQ_BK - 1) / DQ_BK;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    repro::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      repro::mbar_init(&full[s], 1);
      repro::mbar_init(&empty[s], T::NC);
    }
    repro::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    repro::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      repro::prefetch_tensor_map(&tq);
      repro::prefetch_tensor_map(&tdo);
      repro::prefetch_tensor_map(&tk);
      repro::prefetch_tensor_map(&tv);
      repro::mbar_arrive_expect_tx(q_full, 2 * T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < T::NB; ++c) {
        repro::tma_load_4d(sq + c * T::Q_BOX, &tq, q_full, c * BOX, h, q0, b);
        repro::tma_load_4d(sdo + c * T::Q_BOX, &tdo, q_full, c * BOX, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        repro::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        repro::mbar_arrive_expect_tx(&full[s], 2 * T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < T::NB; ++c) {
          repro::tma_load_4d(sk + s * T::KV_BYTES + c * T::KV_BOX, &tk, &full[s], c * BOX, hk,
                             j * DQ_BK, b);
          repro::tma_load_4d(sv + s * T::KV_BYTES + c * T::KV_BOX, &tv, &full[s], c * BOX, hk,
                             j * DQ_BK, b);
        }
      }
    }
    return;
  }

  repro::setmaxnreg_inc<T::REGS>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int first_row = q0 + cw * 64;
  const int row0 = first_row + warp * 16 + g;              // and row0 + 8

  // Prologue: delta and the lse (log2 units) of rows row0 and row0 + 8, each
  // summed over the quad that holds the row (8-column pieces t, t + 4, ..).
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const bool ok = row < Sq;
    float part = 0.f;
    if (ok) {
      const size_t at = (((size_t)b * Sq + row) * Hq + h) * d_rt;
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        const int col = 8 * (t + 4 * i);
        if (col >= d_rt) continue;
        float o[8], d[8];
        repro::Vec16<__nv_bfloat16>::unpack(repro::load16_ro(out + at + col), o);
        repro::Vec16<__nv_bfloat16>::unpack(repro::load16_ro(dout + at + col), d);
#pragma unroll
        for (int e = 0; e < 8; ++e) part = fmaf(o[e], d[e], part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    dl[r] = ok ? part : 0.f;
    lse2[r] = ok ? lse[((size_t)b * Hq + h) * Sq + row] * LOG2E : BIG;
    if (t == 0 && row < Sq_pad) {
      const size_t at = ((size_t)b * Hq + h) * Sq_pad + row;
      lse2_out[at] = lse2[r];
      delta_out[at] = dl[r];
    }
  }

  const uint32_t q_at = repro::smem_addr(sq) + cw * 64 * 128;
  const uint32_t do_at = repro::smem_addr(sdo) + cw * 64 * 128;
  const uint32_t k_at = repro::smem_addr(sk), v_at = repro::smem_addr(sv);
  float acc[D / 2] = {};
  float sc[32], dp[32];
  uint32_t a0[4][4], a1[4][4];           // dS rounded once to bf16, two tiles' in turn

  // S = Q K^T, then dP = dO V^T, of tile j: two commit groups, once the
  // tile's K and V have landed.
  auto first = [&](int j) {
    const int s = j % STAGES;
    repro::mbar_wait(&full[s], (j / STAGES) & 1);
    repro::wgmma_fence();
    rows_by_rows<D, T::Q_BOX, T::KV_BOX>(sc, q_at, k_at + s * T::KV_BYTES);
    repro::wgmma_commit();
    rows_by_rows<D, T::Q_BOX, T::KV_BOX>(dp, do_at, v_at + s * T::KV_BYTES);
    repro::wgmma_commit();
  };
  // P = 2^(S scale_log2 - lse2) of tile j into sc, 0 where masked.
  auto probs = [&](int j) {
    const int k0 = j * DQ_BK;
    const bool edge = k0 + DQ_BK > Sk || (causal && k0 + DQ_BK - 1 > first_row);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = ex2(fmaf(sc[4 * n + e], scale_log2, -lse2[r]));
        if (edge) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          if (key >= Sk || (causal && key > row0 + 8 * r)) p = 0.f;
        }
        sc[4 * n + e] = p;
      }
  };
  // dS = P (dP - delta) into sc.
  auto grads = [&]() {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[4 * n + e] *= dp[4 * n + e] - dl[e >> 1];
  };
  // dQ += dS K of tile j, dS in `a`: one commit group.
  auto second = [&](int j, uint32_t (&a)[4][4]) {
    repro::fence_regs(acc);
    repro::wgmma_fence();
    regs_by_rows<D, T::KV_BOX>(acc, a, k_at + (j % STAGES) * T::KV_BYTES);
    repro::wgmma_commit();
  };
  // Tile j + 1's S and dP and tile j's dQ product (dS in `cur`) are issued
  // together; P and dS of tile j + 1 are computed as they land, and put in
  // `nxt` while the dQ product still reads `cur`.
  auto step = [&](int j, uint32_t (&cur)[4][4], uint32_t (&nxt)[4][4]) {
    first(j + 1);
    second(j, cur);
    repro::wgmma_wait<2>();
    repro::fence_regs(sc);
    probs(j + 1);
    repro::wgmma_wait<1>();
    repro::fence_regs(dp);
    grads();
    to_a_operand(sc, nxt);
    repro::wgmma_wait<0>();           // tile j's dQ product: its stage is free
    repro::fence_regs(acc);
    if (tid == 0) repro::mbar_arrive(&empty[j % STAGES]);
  };

  // Every commit group is waited for in the step that issues it (ptxas
  // serializes the products where groups stay in flight across a loop's
  // back edge); the steps go two at a time, the dS operands in turn.
  repro::mbar_wait(q_full, 0);
  first(0);
  repro::wgmma_wait<1>();
  repro::fence_regs(sc);
  probs(0);
  repro::wgmma_wait<0>();
  repro::fence_regs(dp);
  grads();
  to_a_operand(sc, a0);
  int j = 0;
  for (; j + 2 < n_tiles; j += 2) {
    step(j, a0, a1);
    step(j + 1, a1, a0);
  }
  if (j + 1 < n_tiles) {
    step(j, a0, a1);
    second(j + 1, a1);
  } else {
    second(j, a0);
  }
  repro::wgmma_wait<0>();
  repro::fence_regs(acc);

  store_acc<D>(dq + (size_t)b * Sq * Hq * d_rt + (size_t)h * d_rt, (size_t)Hq * d_rt, acc, scale,
               row0, Sq, t, d_rt);
}

// dk and dv.  k and v (the block's tiles) and q and dout (the streamed ones)
// arrive through tensor maps (D, H, S, B); each Q / dO tile's lse (log2
// units) and delta by 1-D bulk copies from the scratch the dq kernel wrote.
// A block is one item (`kv_item`): a piece of a key block's tiles.  A key
// block cut into pieces sums them through `parts` (fp32, a slot an item,
// the accumulators in their register layout) and `count` (a ticket a key
// block): the piece that takes the last ticket adds the slots in piece
// order, stores, and puts the ticket back to 0.
template <int D>
__global__ void __launch_bounds__(3 * WG, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const float* __restrict__ lse2, const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                            float4* __restrict__ parts, int* __restrict__ count, int Sq, int Sk,
                            int Sq_pad, int Hq, int Hkv, int causal, int cap, int n_split,
                            float scale_log2, float scale, int d_rt) {
  using T = KvTile<D>;
  extern __shared__ unsigned char kv_smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  __shared__ int last_piece;
  const uint32_t raw = repro::smem_addr(kv_smem_raw);
  unsigned char* sk = kv_smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* sv = sk + T::K_BYTES;
  unsigned char* sq = sv + T::K_BYTES;
  unsigned char* sdo = sq + STAGES * T::Q_BYTES;
  float* sl = reinterpret_cast<float*>(sdo + STAGES * T::Q_BYTES);
  float* sd = sl + STAGES * KV_BQ;
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;           // Q, dO, lse and delta of stage s have landed
  uint64_t* empty = full + STAGES;     // both consumers are done with stage s

  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const int n_qt = (Sq + KV_BQ - 1) / KV_BQ;
  const Item it = kv_item(blockIdx.z, n_qt, G, causal, cap);
  const int k0 = it.z * KV_BK;
  // Causal: no query tile wholly before the block's first key sees it.
  const int qt0 = causal ? min(it.z * (KV_BK / KV_BQ), n_qt) : 0;
  const int per_head = n_qt - qt0;
  const int n_tiles = it.t1 - it.t0;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    repro::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      repro::mbar_init(&full[s], 1);
      repro::mbar_init(&empty[s], 2);
    }
    repro::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    repro::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      repro::prefetch_tensor_map(&tq);
      repro::prefetch_tensor_map(&tdo);
      repro::prefetch_tensor_map(&tk);
      repro::prefetch_tensor_map(&tv);
      repro::mbar_arrive_expect_tx(kv_full, 2 * T::K_BYTES);
#pragma unroll
      for (int c = 0; c < T::NB; ++c) {
        repro::tma_load_4d(sk + c * T::K_BOX, &tk, kv_full, c * BOX, hk, k0, b);
        repro::tma_load_4d(sv + c * T::K_BOX, &tv, kv_full, c * BOX, hk, k0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const int h = hk * G + (it.t0 + j) / per_head;
        const int i0 = (qt0 + (it.t0 + j) % per_head) * KV_BQ;
        repro::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        repro::mbar_arrive_expect_tx(&full[s], 2 * T::Q_BYTES + 2 * T::ROW_BYTES);
#pragma unroll
        for (int c = 0; c < T::NB; ++c) {
          repro::tma_load_4d(sq + s * T::Q_BYTES + c * T::Q_BOX, &tq, &full[s], c * BOX, h, i0,
                             b);
          repro::tma_load_4d(sdo + s * T::Q_BYTES + c * T::Q_BOX, &tdo, &full[s], c * BOX, h,
                             i0, b);
        }
        const size_t at = ((size_t)b * Hq + h) * Sq_pad + i0;
        repro::bulk_load(sl + s * KV_BQ, lse2 + at, T::ROW_BYTES, &full[s]);
        repro::bulk_load(sd + s * KV_BQ, delta + at, T::ROW_BYTES, &full[s]);
      }
    }
    return;
  }

  repro::setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int first_key = k0 + cw * 64;
  const int key0 = first_key + warp * 16 + g;              // and key0 + 8

  const uint32_t k_at = repro::smem_addr(sk) + cw * 64 * 128;
  const uint32_t v_at = repro::smem_addr(sv) + cw * 64 * 128;
  const uint32_t q_at = repro::smem_addr(sq), do_at = repro::smem_addr(sdo);
  float dka[D / 2] = {}, dva[D / 2] = {};
  float st[32], dpt[32];
  // P, and dS in bf16 hi + lo, as A operands; at D 64 two tiles' in turn.
  uint32_t ap0[4][4], as0[2][4][4], ap1[4][4], as1[2][4][4];

  // S^T = K Q^T, then dP^T = V dO^T, of tile j: two commit groups, once
  // the tile has landed.
  auto first = [&](int j) {
    const int s = j % STAGES;
    repro::mbar_wait(&full[s], (j / STAGES) & 1);
    repro::wgmma_fence();
    rows_by_rows<D, T::K_BOX, T::Q_BOX>(st, k_at, q_at + s * T::Q_BYTES);
    repro::wgmma_commit();
    rows_by_rows<D, T::K_BOX, T::Q_BOX>(dpt, v_at, do_at + s * T::Q_BYTES);
    repro::wgmma_commit();
  };
  // P^T of tile j into st; columns are queries, whose lse the stage holds.
  auto probs = [&](int j) {
    const int i0 = (qt0 + (it.t0 + j) % per_head) * KV_BQ;
    const float* L = sl + (j % STAGES) * KV_BQ;
    const bool edge = causal && i0 < first_key + 63;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(L + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(st[4 * n + e], scale_log2, -((e & 1) ? l2.y : l2.x)));
        if (edge && key0 + 8 * (e >> 1) > i0 + 8 * n + 2 * t + (e & 1)) p = 0.f;
        st[4 * n + e] = p;
      }
    }
  };
  // dS^T = P^T (dP^T - delta) of tile j into dpt.
  auto grads = [&](int j) {
    const float* Dl = sd + (j % STAGES) * KV_BQ;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 d2 = *reinterpret_cast<const float2*>(Dl + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * n + e] = st[4 * n + e] * (dpt[4 * n + e] - ((e & 1) ? d2.y : d2.x));
    }
  };
  // dV += P^T dO, then dK += dS^T Q (lo's product first), of tile j.
  auto dv_product = [&](int j, uint32_t (&ap)[4][4]) {
    repro::fence_regs(dva);
    repro::wgmma_fence();
    regs_by_rows<D, T::Q_BOX>(dva, ap, do_at + (j % STAGES) * T::Q_BYTES);
  };
  auto dk_product = [&](int j, uint32_t (&as)[2][4][4]) {
    const uint32_t qs = q_at + (j % STAGES) * T::Q_BYTES;
    repro::fence_regs(dka);
    repro::wgmma_fence();
    regs_by_rows<D, T::Q_BOX>(dka, as[1], qs);
    regs_by_rows<D, T::Q_BOX>(dka, as[0], qs);
  };
  auto release = [&](int j) {
    if (tid == 0) repro::mbar_arrive(&empty[j % STAGES]);
  };

  // Every commit group is waited for in the iteration that issues it
  // (ptxas serializes the products where groups stay in flight across the
  // loop's back edge).
  repro::mbar_wait(kv_full, 0);
  if constexpr (D <= 64) {
    // Tile j + 1's S^T and dP^T and tile j's dV and dK products (operands
    // in `cp`, `cs`) are issued together; P^T and dS^T of tile j + 1 are
    // computed as they land, and put in `np`, `ns` while tile j's products
    // still read theirs.  (At D 128 two tiles' operands (96 registers) would
    // not fit beside the accumulators.)
    auto step = [&](int j, uint32_t (&cp)[4][4], uint32_t (&cs)[2][4][4], uint32_t (&np)[4][4],
                    uint32_t (&ns)[2][4][4]) {
      first(j + 1);
      dv_product(j, cp);
      dk_product(j, cs);
      repro::wgmma_commit();
      repro::wgmma_wait<2>();
      repro::fence_regs(st);
      probs(j + 1);
      repro::wgmma_wait<1>();
      repro::fence_regs(dpt);
      grads(j + 1);
      to_a_operand(st, np);
      to_a_split(dpt, ns);
      repro::wgmma_wait<0>();         // tile j's products: its stage is free
      repro::fence_regs(dva);
      repro::fence_regs(dka);
      release(j);
    };
    auto last = [&](int j, uint32_t (&cp)[4][4], uint32_t (&cs)[2][4][4]) {
      dv_product(j, cp);
      dk_product(j, cs);
      repro::wgmma_commit();
    };
    if (n_tiles > 0) {
      first(0);
      repro::wgmma_wait<1>();
      repro::fence_regs(st);
      probs(0);
      repro::wgmma_wait<0>();
      repro::fence_regs(dpt);
      grads(0);
      to_a_operand(st, ap0);
      to_a_split(dpt, as0);
      int j = 0;
      for (; j + 2 < n_tiles; j += 2) {
        step(j, ap0, as0, ap1, as1);
        step(j + 1, ap1, as1, ap0, as0);
      }
      if (j + 1 < n_tiles) {
        step(j, ap0, as0, ap1, as1);
        last(j + 1, ap1, as1);
      } else {
        last(j, ap0, as0);
      }
    }
  } else {
    // Within a tile: P^T is computed while dP^T runs, dS^T while dV's
    // product runs.
    for (int j = 0; j < n_tiles; ++j) {
      first(j);
      repro::wgmma_wait<1>();
      repro::fence_regs(st);
      probs(j);
      to_a_operand(st, ap0);
      dv_product(j, ap0);
      repro::wgmma_commit();
      repro::wgmma_wait<1>();
      repro::fence_regs(dpt);
      grads(j);
      to_a_split(dpt, as0);
      dk_product(j, as0);
      repro::wgmma_commit();
      repro::wgmma_wait<0>();
      repro::fence_regs(dva);
      repro::fence_regs(dka);
      release(j);
    }
  }
  repro::wgmma_wait<0>();
  repro::fence_regs(dva);
  repro::fence_regs(dka);

  const size_t base = (size_t)b * Sk * Hkv * d_rt + (size_t)hk * d_rt;
  if (it.n == 1) {
    store_acc<D>(dk + base, (size_t)Hkv * d_rt, dka, scale, key0, Sk, t, d_rt);
    store_acc<D>(dv + base, (size_t)Hkv * d_rt, dva, 1.f, key0, Sk, t, d_rt);
    return;
  }

  // A piece of a cut key block: its sums into its slot, then a ticket.
  // Slot layout: (cw, dk or dv, D / 8 float4 a thread, WG threads).
  constexpr int V4 = D / 8;
  const size_t bh = (size_t)b * Hkv + hk;
  float4* slot = parts + ((bh * n_split + blockIdx.z) * 2 + cw) * 2 * V4 * WG;
#pragma unroll
  for (int c = 0; c < V4; ++c) {
    __stcg(slot + c * WG + tid, make_float4(dka[4 * c], dka[4 * c + 1], dka[4 * c + 2],
                                            dka[4 * c + 3]));
    __stcg(slot + (V4 + c) * WG + tid, make_float4(dva[4 * c], dva[4 * c + 1], dva[4 * c + 2],
                                                   dva[4 * c + 3]));
  }
  __threadfence();
  repro::named_bar_sync(1, 2 * WG);
  int* ticket = count + bh * ((Sk + KV_BK - 1) / KV_BK) + it.z;
  if (threadIdx.x == WG) last_piece = atomicAdd(ticket, 1) == it.n - 1;
  repro::named_bar_sync(1, 2 * WG);
  if (!last_piece) return;
  __threadfence();
  // The last piece: every slot of the block, in piece order.
#pragma unroll
  for (int c = 0; c < V4; ++c) {
    float4 sk4 = make_float4(0.f, 0.f, 0.f, 0.f), sv4 = sk4;
    for (int p = 0; p < it.n; ++p) {
      const float4* other = parts + ((bh * n_split + it.first + p) * 2 + cw) * 2 * V4 * WG;
      const float4 a = __ldcg(other + c * WG + tid), v4 = __ldcg(other + (V4 + c) * WG + tid);
      if (p == 0) {
        sk4 = a;
        sv4 = v4;
      } else {
        sk4 = make_float4(sk4.x + a.x, sk4.y + a.y, sk4.z + a.z, sk4.w + a.w);
        sv4 = make_float4(sv4.x + v4.x, sv4.y + v4.y, sv4.z + v4.z, sv4.w + v4.w);
      }
    }
    dka[4 * c] = sk4.x;
    dka[4 * c + 1] = sk4.y;
    dka[4 * c + 2] = sk4.z;
    dka[4 * c + 3] = sk4.w;
    dva[4 * c] = sv4.x;
    dva[4 * c + 1] = sv4.y;
    dva[4 * c + 2] = sv4.z;
    dva[4 * c + 3] = sv4.w;
  }
  store_acc<D>(dk + base, (size_t)Hkv * d_rt, dka, scale, key0, Sk, t, d_rt);
  store_acc<D>(dv + base, (size_t)Hkv * d_rt, dva, 1.f, key0, Sk, t, d_rt);
  if (threadIdx.x == WG) *ticket = 0;   // for the next call
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* out, const void* dout,
                const void* lse, void* dq, void* dk, void* dv, float* lse2, float* delta,
                float4* parts, int* count, int B, int Sq, int Sk, int Sq_pad, int Hq, int Hkv,
                int d, int causal, int cap, int items, int n_split, cudaStream_t stream) {
  const int blocks_q = (Sq + DqTile<D>::BQ - 1) / DqTile<D>::BQ;
  const int n_kb = (Sk + KV_BK - 1) / KV_BK;
  int want_items, want_split;
  kv_count(n_kb, (Sq + KV_BQ - 1) / KV_BQ, Hq / Hkv, causal, cap, &want_items, &want_split);
  if (blocks_q > 65535 || items > 65535 || cap < 1 || items != want_items ||
      n_split != want_split)
    return -1;
  CUtensorMap tq_dq, tdo_dq, tk_dq, tv_dq, tq_kv, tdo_kv, tk_kv, tv_kv;
  if (!repro::bf16_bshd_map(&tq_dq, q, B, Sq, Hq, d, DqTile<D>::BQ) ||
      !repro::bf16_bshd_map(&tdo_dq, dout, B, Sq, Hq, d, DqTile<D>::BQ) ||
      !repro::bf16_bshd_map(&tk_dq, k, B, Sk, Hkv, d, DQ_BK) ||
      !repro::bf16_bshd_map(&tv_dq, v, B, Sk, Hkv, d, DQ_BK) ||
      !repro::bf16_bshd_map(&tq_kv, q, B, Sq, Hq, d, KV_BQ) ||
      !repro::bf16_bshd_map(&tdo_kv, dout, B, Sq, Hq, d, KV_BQ) ||
      !repro::bf16_bshd_map(&tk_kv, k, B, Sk, Hkv, d, KV_BK) ||
      !repro::bf16_bshd_map(&tv_kv, v, B, Sk, Hkv, d, KV_BK))
    return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)d), scale_log2 = scale * LOG2E;

  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)DqTile<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  // x: heads (neighbours share a kv head, hence its tiles in L2); z: query
  // blocks, taken in reverse inside the kernel.
  flash_bwd_dq_wgmma_kernel<D><<<dim3(Hq, B, blocks_q), DqTile<D>::THREADS, DqTile<D>::SMEM,
                                 stream>>>(
      tq_dq, tdo_dq, tk_dq, tv_dq, static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse), lse2, delta,
      static_cast<__nv_bfloat16*>(dq), Sq, Sk, Sq_pad, Hq, Hkv, causal, scale_log2, scale, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)KvTile<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  // z: the items, the longest first; x, y: kv heads and batches.
  flash_bwd_dkdv_wgmma_kernel<D><<<dim3(Hkv, B, items), 3 * WG, KvTile<D>::SMEM, stream>>>(
      tq_kv, tdo_kv, tk_kv, tv_kv, lse2, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), parts, count, Sq, Sk, Sq_pad, Hq, Hkv, causal, cap,
      n_split, scale_log2, scale, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the first failed launch's cudaError_t (0 when both launched), or
// -1 for arguments the kernels do not take.  q, out, dout, dq: (B, Sq, Hq,
// D); k, v, dk, dv: (B, Sk, Hkv, D); lse: (B, Hkv, Hq / Hkv, Sq) fp32;
// scratch: 2 * B * Hq * Sq_pad fp32 (Sq_pad = Sq rounded up to 128), the
// lse and delta rows the first kernel writes for the second.  bf16 only:
// the dk/dv items (`kv_item`) under the piece cap `cap`, `items` of them and
// `n_split` cut a (kv head, batch), which the launcher recomputes and
// refuses if they differ; parts: B * Hkv * n_split slots of 128 * D * 2
// fp32; count: B * Hkv * ceil(Sk / 128) int32 tickets, zero (each call
// leaves them zero).  All contiguous, on the device, 16-byte aligned; D a
// multiple of the 16-byte vector (8 bf16, 4 fp32) and at most 128.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* out, const void* dout, const void* lse,
                                         void* dq, void* dk, void* dv, void* scratch,
                                         void* parts, void* count, int B, int Sq, int Sk, int Hq,
                                         int Hkv, int D, int causal, int cap, int items,
                                         int n_split, int is_bf16, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || Hq > 65535 ||
      B > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Sq_pad = (Sq + SQ_PAD - 1) / SQ_PAD * SQ_PAD;
  float* lse2 = static_cast<float*>(scratch);
  float* delta = lse2 + (size_t)B * Hq * Sq_pad;
  if (is_bf16) {
    if (D <= 0 || D % 8 != 0 || D > repro::kMaxHeadDim) return -1;
    float4* p = static_cast<float4*>(parts);
    int* c = static_cast<int*>(count);
    if (D <= 64)
      return launch_bf16<64>(q, k, v, out, dout, lse, dq, dk, dv, lse2, delta, p, c, B, Sq, Sk,
                             Sq_pad, Hq, Hkv, D, causal, cap, items, n_split, s);
    return launch_bf16<128>(q, k, v, out, dout, lse, dq, dk, dv, lse2, delta, p, c, B, Sq, Sk,
                            Sq_pad, Hq, Hkv, D, causal, cap, items, n_split, s);
  }
  if (D == 32)
    return launch_f32<32>(q, k, v, out, dout, lse, dq, dk, dv, delta, B, Sq, Sk, Sq_pad, Hq,
                          Hkv, D, causal, s);
  if (D == 64)
    return launch_f32<64>(q, k, v, out, dout, lse, dq, dk, dv, delta, B, Sq, Sk, Sq_pad, Hq,
                          Hkv, D, causal, s);
  if (D == 128)
    return launch_f32<128>(q, k, v, out, dout, lse, dq, dk, dv, delta, B, Sq, Sk, Sq_pad, Hq,
                           Hkv, D, causal, s);
  if (repro::padded_head_dim<float>(D))
    return launch_f32<repro::kMaxHeadDim, true>(q, k, v, out, dout, lse, dq, dk, dv, delta, B,
                                                Sq, Sk, Sq_pad, Hq, Hkv, D, causal, s);
  return -1;
}
