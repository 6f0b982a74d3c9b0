// Causal or non-causal GQA flash-attention forward, for Hopper (sm_90a).
//
//   out[b, i, h, :] = sum_j softmax_j( q[b, i, h, :] . k[b, j, h/G, :] * D^-0.5 ) v[b, j, h/G, :]
//   lse[b, h, i]    = log sum_j exp( q[b, i, h, :] . k[b, j, h/G, :] * D^-0.5 )
//   over the keys j < Sk, and j <= i when causal
//
// Replaces the Pallas kernel `repro.kernels.flash_attention.flash_attention`
// (body `_kernel`), and also writes what `repro.models.attention
// ._flash_fwd_math` returns beside the output: the log-sum-exp, fp32, laid
// out (B, Hkv, G, Sq), which is (B, Hq, Sq) since h = hk * G + g.  The
// training backward reads it instead of storing the probabilities.
// What changed on the way, for both instances:
//   * q, k and v are read in their native (B, S, H, D) layout; the TPU
//     wrapper transposes (copies) all three on every call.
//   * The TPU grid's third dimension runs in order and carries (m, l, acc)
//     in scratch; here it is a loop over key tiles inside the block.
//   * No divisibility: the ragged last query block and key tile are
//     masked; the TPU wrapper raises unless the blocks divide the lengths.
//   * Under causality the tiles wholly above the diagonal are not visited
//     (the loop ends at the block's last query row), as `pl.when` skips them.
//   * Softmax state (m, l, acc) is fp32; l is floored at 1e-30 at the end.
//
// Bound: at the training shape (B 2, S 4096, Hq 32, Hkv 8, D 64, bf16,
// causal) by operations, 4 * B * Hq * D * S^2 / 2 = 1.37e11 (0.139 ms at
// the bf16 tensor-core peak), against about 85 MB moved (0.025 ms).
//
// bf16 (`flash_fwd_bf16_kernel`): FlashAttention-2 on the tensor cores with
// mma.sync.  A block of 4 warps takes 64 query rows, 16 a warp; q's
// fragments are loaded once with ldmatrix.  K and V tiles of 64 keys go
// into shared memory as bf16 through a two-stage cp.async ring (tile j + 1
// loads while tile j computes), rows padded by 16 bytes so that ldmatrix
// and ldmatrix.trans hit no bank twice.  S = Q K^T is m16n8k16 bf16 with
// fp32 accumulators (each product of two bf16 is exact in fp32); the
// online softmax runs on the accumulator fragments in registers (exp2 of
// scores prescaled by log2(e) / sqrt(D)), a row's max and sum reduced over
// the four threads of a quad; P is packed in registers straight into the
// A fragments of P V (the C layout of two neighbouring m16n8 tiles is the A
// layout of one m16k16 tile), split into bf16 hi + lo for two products, V's
// B fragments come from ldmatrix.trans, and l sums the fp32 P.  P rounded
// once to bf16 (as FlashAttention-2 does) passed every per-call check but
// drifted the training checks to their limits on an H100 (granite's loss
// 1.0e-3 from the plain path's in train_vs_plain, zamba2's gradient norm
// 1.1 % from fp32's, against 1e-3 and 1 %); the split costs two more
// products a k-step and keeps about 16 of P's bits.  D = 32, 64, 112 and 128
// are exact instances (112 = 7 k-steps of 16 for Q K^T and 14 n8 tiles for
// P V); any other multiple of 8 up to 128 runs the 128 instance with the
// columns at or past D zero-filled by cp.async and not stored.  Query
// blocks run longest first under causality, so the last wave is not all
// long rows.  What holds it back now: mma.sync issues from registers at a
// fraction of the wgmma rate, and one warp's softmax waits on its own
// products (no ping-pong between warpgroups); TMA and wgmma are the next
// step.
//
// fp32 (`flash_fwd_kernel`): both products on the fp32 cores, held to the
// 2e-5 checks.  K and V tiles of BK keys are staged in shared memory (4096
// values each); a group of TPR = D / 32 neighbouring threads owns one query
// row, 32 of its values of q and of the accumulator in registers each, and
// the partial dot products are summed over the group with shuffles.  D =
// 32, 64 and 128 are exact; any other multiple of 4 up to 128 runs the 128
// instance with the lanes past D zero and unstored.

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ------------------------------------------------------------- fp32 path --
constexpr int THREADS = 128;
constexpr int KC = 16;     // keys between two rescales of the accumulator
constexpr int PER = 32;    // values of a row a thread holds (of q, and of acc)
constexpr int NQ = PER / 4;

__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  f[0] = r.x;
  f[1] = r.y;
  f[2] = r.z;
  f[3] = r.w;
}

// D is the width of a row in registers and shared memory; dd the row's
// length and stride in device memory: D itself, or with PAD the runtime
// d_rt <= D, the values at or past it masked.
template <int D, bool PAD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
                 int Sq, int Sk, int Hq, int Hkv, int causal, float scale, int d_rt) {
  constexpr int TPR = D / PER;          // threads that share one query row
  constexpr int BQ = THREADS / TPR;     // query rows a block
  constexpr int BK = 4096 / D;          // keys a tile in shared memory
  constexpr int RV = D / 4;             // 16-byte loads a key row
  static_assert(TPR >= 1 && TPR <= 4 && BK % KC == 0, "D must be 32, 64 or 128");

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

  // Quad c of this thread holds the row's values 4 * (c * TPR + part) + 0..3:
  // the TPR threads of a row read neighbouring 16-byte pieces of a key row
  // in shared memory at once, so no two of them wait on one bank.
  float qf[NQ][4], acc[NQ][4];
  const size_t q_at = (((size_t)b * Sq + (q_ok ? qi : 0)) * Hq + h) * dd;
#pragma unroll
  for (int c = 0; c < NQ; ++c) {
    if (q_ok && (!PAD || 4 * (c * TPR + part) < dd)) {
      load4(q + q_at + 4 * (c * TPR + part), qf[c]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) qf[c][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  // Causal: no key past the block's last row is needed.
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const size_t kv_row = (size_t)Hkv * dd;
  const float* kb = k + (size_t)b * Sk * kv_row + (size_t)hk * dd;
  const float* vb = v + (size_t)b * Sk * kv_row + (size_t)hk * dd;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = tid; e < BK * RV; e += THREADS) {
      const int r = e / RV, c = e % RV;
      const int key = k0 + r;
      float4 fk = make_float4(0.f, 0.f, 0.f, 0.f), fv = fk;
      if (key < Sk && (!PAD || c * 4 < dd)) {
        const uint4 rk = repro::load16_ro(kb + key * kv_row + c * 4);
        const uint4 rv = repro::load16_ro(vb + key * kv_row + c * 4);
        fk = make_float4(__uint_as_float(rk.x), __uint_as_float(rk.y), __uint_as_float(rk.z),
                         __uint_as_float(rk.w));
        fv = make_float4(__uint_as_float(rv.x), __uint_as_float(rv.y), __uint_as_float(rv.z),
                         __uint_as_float(rv.w));
      }
      *reinterpret_cast<float4*>(sk + r * D + c * 4) = fk;
      *reinterpret_cast<float4*>(sv + r * D + c * 4) = fv;
    }
    __syncthreads();

    // The same trip count for every thread of the block, so that the
    // shuffles always find their whole warp; keys past k_end (up to the
    // next multiple of KC) are in the tile and masked below.
    const int n = min(BK, k_end - k0);
    for (int c0 = 0; c0 < n; c0 += KC) {
      float s[KC];
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float* kr = sk + (c0 + j) * D;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < NQ; ++c) {
          const float4 kk = *reinterpret_cast<const float4*>(kr + 4 * (c * TPR + part));
          dot = fmaf(qf[c][0], kk.x, dot);
          dot = fmaf(qf[c][1], kk.y, dot);
          dot = fmaf(qf[c][2], kk.z, dot);
          dot = fmaf(qf[c][3], kk.w, dot);
        }
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const int key = k0 + c0 + j;
        const bool ok = key < Sk && (!causal || key <= qi);
        s[j] = ok ? dot * scale : NEG_INF;
      }

      // Online softmax over the KC keys; s becomes p (0 where masked).
      float m_new = m;
#pragma unroll
      for (int j = 0; j < KC; ++j) m_new = fmaxf(m_new, s[j]);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        s[j] = s[j] > 0.5f * NEG_INF ? expf(s[j] - m_new) : 0.f;
        psum += s[j];
      }
      l = l * corr + psum;
      m = m_new;
#pragma unroll
      for (int c = 0; c < NQ; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] *= corr;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float* vr = sv + (c0 + j) * D;
#pragma unroll
        for (int c = 0; c < NQ; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + 4 * (c * TPR + part));
          acc[c][0] = fmaf(s[j], vv.x, acc[c][0]);
          acc[c][1] = fmaf(s[j], vv.y, acc[c][1]);
          acc[c][2] = fmaf(s[j], vv.z, acc[c][2]);
          acc[c][3] = fmaf(s[j], vv.w, acc[c][3]);
        }
      }
    }
  }

  if (!q_ok) return;
  const float L = fmaxf(l, 1e-30f);
  float* orow = out + (((size_t)b * Sq + qi) * Hq + h) * dd;
#pragma unroll
  for (int c = 0; c < NQ; ++c) {
    if (PAD && 4 * (c * TPR + part) >= dd) continue;
    *reinterpret_cast<float4*>(orow + 4 * (c * TPR + part)) =
        make_float4(acc[c][0] / L, acc[c][1] / L, acc[c][2] / L, acc[c][3] / L);
  }
  if (part == 0) lse[((size_t)b * Hq + h) * Sq + qi] = m + logf(L);
}

template <int D, bool PAD = false>
int launch_f32(const void* q, const void* k, const void* v, void* out, void* lse, int B,
               int Sq, int Sk, int Hq, int Hkv, int d, int causal, cudaStream_t stream) {
  constexpr int BQ = THREADS / (D / PER);
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<D, PAD><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), Sq, Sk, Hq, Hkv, causal,
      1.0f / sqrtf((float)d), d);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- bf16 path --
constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_BQ = 16 * TC_WARPS;    // query rows a block, 16 a warp
constexpr int TC_BK = 64;               // keys a tile
constexpr float LN2 = 0.6931471805599453f;

// Shared memory of an instance: q's tile and two stages of K and V, rows of
// D + 8 bf16 (the 16-byte pad shifts each row by four banks).
template <int D>
struct TcTile {
  static constexpr int LD = D + 8;
  static constexpr int Q = TC_BQ * LD;
  static constexpr int KV = TC_BK * LD;
  static constexpr size_t BYTES = sizeof(__nv_bfloat16) * (size_t)(Q + 4 * KV);
};

// rows [r0, r0 + R) of a (rows, D) bf16 matrix with row stride `stride`
// into a tile of row stride LD; rows at or past `rows` and (with PAD)
// columns at or past dd are zero-filled.
template <int D, bool PAD, int R>
__device__ __forceinline__ void tc_load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                             size_t stride, int r0, int rows, int dd) {
  constexpr int CH = D / 8;   // 16-byte pieces of a row
  static_assert(R * CH % TC_THREADS == 0, "a tile is whole rounds of the block");
#pragma unroll
  for (int i = 0; i < R * CH / TC_THREADS; ++i) {
    const int e = threadIdx.x + i * TC_THREADS;
    const int r = e / CH, c = e % CH;
    const int row = r0 + r;
    const bool ok = row < rows && (!PAD || c * 8 < dd);
    repro::cp_async16(dst + r * TcTile<D>::LD + c * 8,
                      src + (ok ? (size_t)row * stride + c * 8 : 0), ok);
  }
}

template <int D, bool PAD>
// Two blocks an SM at least: without it ptxas held D 64 at 128 registers and spilled.
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int causal,
                      float scale_log2, int d_rt) {
  constexpr int LD = TcTile<D>::LD;
  constexpr int KS = D / 16;       // k-steps of Q K^T
  constexpr int NT = D / 8;        // n8 tiles of the output
  constexpr int NS = TC_BK / 8;    // n8 tiles of S
  static_assert(D % 16 == 0 && D <= 128, "D must be a multiple of 16 up to 128");

  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* sk = sq + TcTile<D>::Q;                  // 2 stages
  __nv_bfloat16* sv = sk + 2 * TcTile<D>::KV;             // 2 stages

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TC_BQ;   // the longest rows first
  const int hk = h / (Hq / Hkv);
  const int dd = PAD ? d_rt : D;

  const size_t q_row = (size_t)Hq * dd, kv_row = (size_t)Hkv * dd;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * q_row + (size_t)h * dd;
  const __nv_bfloat16* kb = k + (size_t)b * Sk * kv_row + (size_t)hk * dd;
  const __nv_bfloat16* vb = v + (size_t)b * Sk * kv_row + (size_t)hk * dd;

  // Causal: no key past the block's last row is needed.
  const int k_end = causal ? min(Sk, q0 + TC_BQ) : Sk;
  const int n_tiles = (k_end + TC_BK - 1) / TC_BK;

  tc_load_tile<D, PAD, TC_BQ>(sq, qb, q_row, q0, Sq, dd);
  tc_load_tile<D, PAD, TC_BK>(sk, kb, kv_row, 0, Sk, dd);
  tc_load_tile<D, PAD, TC_BK>(sv, vb, kv_row, 0, Sk, dd);
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    repro::ldmatrix_x4(qf[kk], sq + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // rows g and g + 8; l per thread
  const int row0 = q0 + warp * 16 + g;

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      const int next = (j + 1) * TC_BK;
      tc_load_tile<D, PAD, TC_BK>(sk + (stage ^ 1) * TcTile<D>::KV, kb, kv_row, next, Sk, dd);
      tc_load_tile<D, PAD, TC_BK>(sv + (stage ^ 1) * TcTile<D>::KV, vb, kv_row, next, Sk, dd);
    }
    repro::cp_async_commit();   // empty on the last tile, so that wait<1> means tile j
    repro::cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* skt = sk + stage * TcTile<D>::KV;
    const __nv_bfloat16* svt = sv + stage * TcTile<D>::KV;

    // S = Q K^T: 16 rows x 64 keys a warp.
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kf[4];
        repro::ldmatrix_x4(kf, skt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                                   kk * 16 + ((lane >> 3) & 1) * 8);
        repro::mma_bf16_16816(s[2 * np], qf[kk], kf[0], kf[1]);
        repro::mma_bf16_16816(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // Scale into log2 units; mask the ragged tile and the diagonal.
    const int k0 = j * TC_BK;
    const bool edge = k0 + TC_BK > Sk || (causal && k0 + TC_BK - 1 > q0);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (key >= Sk || (causal && key > row)) x = NEG_INF;
        }
        s[n][e] = x;
      }

    // Online softmax over the tile, a row's max over its quad.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = s[n][e] > 0.5f * NEG_INF ? exp2f(s[n][e] - mx[r]) : 0.f;
        l[r] += p;
        s[n][e] = p;
      }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V: P's accumulators, split into bf16 hi + lo, are the A
    // fragments of two products (V is exact in bf16).
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* p = s[2 * kk + (e >> 1)] + 2 * (e & 1);   // a0..a3: see mma.cuh
        repro::split_bf16x2(p[0], p[1], hi[e], lo[e]);
      }
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        uint32_t vf[4];
        repro::ldmatrix_x4_trans(vf, svt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                         dp * 16 + (lane >> 4) * 8);
        repro::mma_bf16_16816(o[2 * dp], lo, vf[0], vf[1]);
        repro::mma_bf16_16816(o[2 * dp], hi, vf[0], vf[1]);
        repro::mma_bf16_16816(o[2 * dp + 1], lo, vf[2], vf[3]);
        repro::mma_bf16_16816(o[2 * dp + 1], hi, vf[2], vf[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + r * 8;
    if (row >= Sq) continue;
    const float L = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / L;
    __nv_bfloat16* orow = out + (((size_t)b * Sq + row) * Hq + h) * dd;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * t;
      if (PAD && col >= dd) continue;
      *reinterpret_cast<uint32_t*>(orow + col) =
          repro::pack_bf16x2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
    if (t == 0) lse[((size_t)b * Hq + h) * Sq + row] = (m[r] + log2f(L)) * LN2;
  }
}

template <int D, bool PAD = false>
int launch_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                int Sq, int Sk, int Hq, int Hkv, int d, int causal, cudaStream_t stream) {
  const int blocks_q = (Sq + TC_BQ - 1) / TC_BQ;
  if (blocks_q > 65535) return -1;
  constexpr size_t smem = TcTile<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D, PAD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // x: heads (neighbours share a kv head, hence its tiles in L2); z: query
  // blocks, taken in reverse inside the kernel.
  const dim3 grid(Hq, B, blocks_q);
  flash_fwd_bf16_kernel<D, PAD><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Sq, Sk, Hq, Hkv, causal,
      1.4426950408889634f / sqrtf((float)d), d);
  return (int)cudaGetLastError();
}

int launch_d_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                  int Sq, int Sk, int Hq, int Hkv, int D, int causal, cudaStream_t s) {
  if (D == 32) return launch_bf16<32>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal, s);
  if (D == 64) return launch_bf16<64>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal, s);
  if (D == 112) return launch_bf16<112>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal, s);
  if (D == 128) return launch_bf16<128>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal, s);
  if (repro::padded_head_dim<__nv_bfloat16>(D))
    return launch_bf16<repro::kMaxHeadDim, true>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D,
                                                 causal, s);
  return -1;
}

int launch_d_f32(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                 int Sq, int Sk, int Hq, int Hkv, int D, int causal, cudaStream_t s) {
  if (D == 32) return launch_f32<32>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal, s);
  if (D == 64) return launch_f32<64>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal, s);
  if (D == 128) return launch_f32<128>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal, s);
  if (repro::padded_head_dim<float>(D))
    return launch_f32<repro::kMaxHeadDim, true>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D,
                                                causal, s);
  return -1;
}

}  // namespace

// Returns the launch's cudaError_t (0 on success), or -1 for arguments the
// kernel does not take.  q, out: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D);
// lse: (B, Hkv, Hq / Hkv, Sq) fp32; all contiguous, on the device, 16-byte
// aligned; D a multiple of the 16-byte vector (8 bf16, 4 fp32) and at
// most 128.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     void* lse, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                                     int causal, int is_bf16, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || Hq > 65535 ||
      B > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_d_bf16(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal, s);
  return launch_d_f32(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal, s);
}
