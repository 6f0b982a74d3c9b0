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
// Hopper's machinery (TMA, mbarriers, wgmma, setmaxnreg) is in hopper.cuh.
//
// bf16 (`flash_fwd_wgmma_kernel`), for Hopper: bound by operations, and
// P V is done twice (P split into bf16 hi + lo, below), so the kernel does
// 1.5 times the bound's products and can reach at most 2/3 of it.  A block
// takes 128 query rows of one (b, h) with three warpgroups:
//   * A producer (registers lowered to 24 by setmaxnreg) whose one thread
//     issues TMA loads: Q's tile once, then K and V tiles of 128 keys into
//     rings of 4 stages (D 64) or 2 (D 128), each stage with its own full and
//     empty mbarriers for K and for V, so Q K^T starts before V lands and a
//     load waits only for a stage to be free, never on math.  The tensor maps
//     are 4-dimensional (D, H, S, B), so rows past a batch's S and columns
//     past d_head arrive as zeros, not as the next batch's rows.
//   * Two consumers (registers raised to 240) of 64 rows each.  S = Q K^T is
//     wgmma m64n128k16 with both operands in shared memory (128-byte swizzle,
//     as TMA wrote them); the online softmax runs on the fp32 accumulators
//     (exp2 of scores scaled into log2 units, a row's max and sum over the
//     four threads that hold it); P, split into bf16 hi + lo in the
//     A-operand register layout, goes into two wgmma products from
//     registers, P_lo V then P_hi V, V read in its stored (keys, D) layout
//     through wgmma's transpose.
//   * Overlap, both kinds built: tile j's Q K^T and tile j - 1's P V are
//     issued together, the split of tile j's P goes into the other of two
//     register buffers, and the two consumers take turns to issue on named
//     barriers (ping-pong), so one's products run while the other computes
//     its softmax.  The wait for tile j - 1's P V is placed by ptxas ahead of
//     the softmax (SASS), so the overlap comes from the ping-pong.
// D 64 and 128 are the instances; any other multiple of 8 up to 128 runs
// the one above it (zamba2-7b's 112 the 128 instance) with zero columns.
// Registers are pinned around each wgmma wait (`fence_regs`), so that no
// read of an accumulator moves ahead of its wait, and the descriptors are
// rebuilt each tile (`opaque`): hoisted out of the loop, one for each
// k-step and stage, they spilled 670-880 bytes at D 128.  P rounded
// once to bf16 (as FlashAttention does) passed every per-call check but
// drifted the training checks to their limits on an H100 (granite's loss
// 1.0e-3 from the plain path's in train_vs_plain, zamba2's gradient norm
// 1.1 % from fp32's, against 1e-3 and 1 %); the split keeps about 16 of P's
// bits, and l sums the fp32 P.  Query blocks run longest first under
// causality, heads that share a kv head are neighbours in the grid (L2).
//
// fp32 (`flash_fwd_kernel`): both products on the fp32 cores, held to the
// 2e-5 checks.  K and V tiles of BK keys are staged in shared memory (4096
// values each); a group of TPR = D / 32 neighbouring threads owns one query
// row, 32 of its values of q and of the accumulator in registers each, and
// the partial dot products are summed over the group with shuffles.  D =
// 32, 64 and 128 are exact; any other multiple of 4 up to 128 runs the 128
// instance with the lanes past D zero and unstored.

#include "common.cuh"
#include "hopper.cuh"
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
constexpr int WG = 128;                 // threads of a warpgroup
constexpr int FA_BQ = 128;              // query rows a block, 64 for each consumer warpgroup
constexpr int FA_BK = 128;              // keys a tile
constexpr int FA_BOX = 64;              // columns of a TMA box: one 128-byte swizzled row
constexpr float LN2 = 0.6931471805599453f;

// An instance (D 64 or 128): the stages of the K and V rings and its shared
// memory, q's tile and then the rings; each tile is D / 64 boxes of (rows,
// 64) bf16, 128 bytes a row.
template <int D>
struct FaTile {
  static constexpr int NB = D / FA_BOX;
  static constexpr int STAGES = D == 64 ? 4 : 2;
  static constexpr int Q_BOX = FA_BQ * 128;
  static constexpr int KV_BOX = FA_BK * 128;
  static constexpr int Q_BYTES = NB * Q_BOX;
  static constexpr int KV_BYTES = NB * KV_BOX;
  // + 1024: the dynamic base is moved up to the swizzle atom's alignment
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * (size_t)KV_BYTES;
  static_assert(D % FA_BOX == 0 && SMEM <= 232448, "shared memory of an instance");
};

// A consumer thread's place in the scores: keys at or past Sk, and under
// causality keys past the row, are masked.
struct Masking {
  int Sk, causal, first_row, row0, t;   // first_row: the warpgroup's; row0: the thread's
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T for 64 query rows (q_at, the warpgroup's rows of Q's tile) and
// 128 keys (k_at, a stage of the K ring): D / 16 k-steps of m64n128k16.
// Each k-step's descriptors are the tile's plus an offset; the tile's are
// made anew on every call (`repro::opaque`), since descriptors hoisted
// out of the loop, one for each k-step and stage, spill registers.
template <int D>
__device__ __forceinline__ void qk_tile(float (&sc)[FA_BK / 2], uint32_t q_at, uint32_t k_at) {
  const uint64_t qd = repro::wgmma_desc(repro::opaque(q_at), 16, 1024);
  const uint64_t kd = repro::wgmma_desc(repro::opaque(k_at), 16, 1024);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 32 bytes a k-step inside a 128-byte row, then the next 64-column box
    const uint32_t at = (kk % 4) * 32;
    repro::wgmma_ss(sc, qd + (((kk / 4) * FaTile<D>::Q_BOX + at) >> 4),
                    kd + (((kk / 4) * FaTile<D>::KV_BOX + at) >> 4), kk > 0);
  }
}

// P's split: hi and lo, each the A operands of the 8 k-steps of P V.
using PSplit = uint32_t[2][FA_BK / 16][4];

// O += P V: P's bf16 hi and lo parts are the A operands of two products
// from registers (V is exact in bf16, lo first); V (v_at, a stage of the V
// ring) is read in its stored (keys, D) layout and transposed by wgmma.
template <int D>
__device__ __forceinline__ void pv_tile(float (&o)[D / 2], const PSplit& p, uint32_t v_at) {
  const uint64_t vd = repro::wgmma_desc(repro::opaque(v_at), FaTile<D>::KV_BOX, 1024);
#pragma unroll
  for (int kk = 0; kk < FA_BK / 16; ++kk) {
    repro::wgmma_rs_tn(o, p[1][kk], vd + ((kk * 16 * 128) >> 4));   // 16 keys a k-step
    repro::wgmma_rs_tn(o, p[0][kk], vd + ((kk * 16 * 128) >> 4));
  }
}

// The online softmax over a tile of scores (keys k0 ..), in place: scales
// them into log2 units (as the CPU tests' emulation does), masks, takes
// each row's max m over its quad, and leaves p = 2^(s - m) (0 where
// masked); l gains the tile's fp32 p (two partial sums a row), corr is the
// factor that rescales what came before.
__device__ __forceinline__ void online_softmax(float (&sc)[FA_BK / 2], float (&m)[2],
                                               float (&l)[2], float (&corr)[2],
                                               const Masking& mk, int k0, float scale_log2) {
#pragma unroll
  for (int i = 0; i < FA_BK / 2; ++i) sc[i] *= scale_log2;
  if (k0 + FA_BK > mk.Sk || (mk.causal && k0 + FA_BK - 1 > mk.first_row)) {
#pragma unroll
    for (int n = 0; n < FA_BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * mk.t + (e & 1);
        const int row = mk.row0 + (e >> 1) * 8;
        if (key >= mk.Sk || (mk.causal && key > row)) sc[4 * n + e] = NEG_INF;
      }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < FA_BK / 8; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * n], sc[4 * n + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= corr[r];
    // A row with no key yet: every score is NEG_INF, and each p must be 0.
    base[r] = mx[r] == NEG_INF ? 0.f : mx[r];
  }
  float ps[2][2] = {};
#pragma unroll
  for (int n = 0; n < FA_BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float p = ex2(sc[4 * n + e] - base[r]);
      ps[r][n % 2] += p;
      sc[4 * n + e] = p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] += (ps[r][0] + ps[r][1]);
}

// P (fp32, the accumulator layout of S) into the A operands of P V, each
// value split into bf16 hi + lo: the C layout of the n8 tiles 2kk and
// 2kk + 1 is the A layout of k-step kk (hopper.cuh).
__device__ __forceinline__ void split_p(const float (&sc)[FA_BK / 2], PSplit& p) {
#pragma unroll
  for (int kk = 0; kk < FA_BK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* x = sc + 4 * (2 * kk + (e >> 1)) + 2 * (e & 1);
      repro::split_bf16x2(x[0], x[1], p[0][kk][e], p[1][kk][e]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int kk = 0; kk < FA_BK / 16; ++kk) repro::fence_regs(p[h][kk]);
}

// What a consumer warpgroup holds and does: O's accumulators, each row's
// running max and sum, and the steps of its loop over the key tiles.  Tile
// j's Q K^T and tile j - 1's P V are issued together; tile j's softmax and
// the split of its P (into the other of two register buffers) follow.  The
// two warpgroups take turns to issue (named barriers 1 and 2), so that one's
// products run on the tensor cores while the other computes its softmax.
template <int D>
struct Consumer {
  static constexpr int ST = FaTile<D>::STAGES;
  // At D 128 the rescale is 64 multiplies a tile, and a warp whose rows all
  // keep their max skips it; at D 64 the vote costs more than it saves.
  static constexpr bool SKIP_EXACT_RESCALE = D == 128;
  uint32_t q_at, k_at, v_at;
  uint64_t *k_full, *v_full, *k_empty, *v_empty;
  Masking mask;
  float scale_log2;
  int cw, tid;
  float o[D / 2] = {};
  // rows g and g + 8: the running max (log2 units) and, per thread, sum
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float sc[FA_BK / 2];

  __device__ __forceinline__ uint32_t k_stage(int j) const {
    return k_at + (j % ST) * FaTile<D>::KV_BYTES;
  }
  __device__ __forceinline__ uint32_t v_stage(int j) const {
    return v_at + (j % ST) * FaTile<D>::KV_BYTES;
  }
  __device__ __forceinline__ uint32_t parity(int j) const { return (j / ST) & 1; }

  // This warpgroup's turn to issue, then the other's (which is not waited
  // for after its last turn: `more` false).
  __device__ __forceinline__ void turn() const { repro::named_bar_sync(1 + cw, 2 * WG); }
  __device__ __forceinline__ void pass(bool more) const {
    if (cw == 0 || more) repro::named_bar_arrive(2 - cw, 2 * WG);
  }
  __device__ __forceinline__ void release(uint64_t* bar) const {
    if (tid == 0) repro::mbar_arrive(bar);
  }

  // O *= corr (exact where skipped: every corr of the warp is 1).
  __device__ __forceinline__ void rescale(const float (&corr)[2]) {
    if (SKIP_EXACT_RESCALE && __all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) return;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n] *= corr[0];
      o[4 * n + 1] *= corr[0];
      o[4 * n + 2] *= corr[1];
      o[4 * n + 3] *= corr[1];
    }
  }

  // Tile 0: its scores, softmax and P's split into pn.
  __device__ __forceinline__ void first(PSplit& pn) {
    repro::mbar_wait(&k_full[0], 0);
    turn();
    repro::wgmma_fence();
    qk_tile<D>(sc, q_at, k_stage(0));
    repro::wgmma_commit();
    pass(true);
    repro::wgmma_wait<0>();
    repro::fence_regs(sc);
    release(&k_empty[0]);
    float corr[2];
    online_softmax(sc, m, l, corr, mask, 0, scale_log2);
    split_p(sc, pn);
  }

  // Tile j >= 1: P V of tile j - 1 with pp, tile j's P split into pn.
  __device__ __forceinline__ void step(int j, const PSplit& pp, PSplit& pn) {
    repro::mbar_wait(&k_full[j % ST], parity(j));
    repro::mbar_wait(&v_full[(j - 1) % ST], parity(j - 1));
    turn();
    repro::fence_regs(o);
    repro::wgmma_fence();
    qk_tile<D>(sc, q_at, k_stage(j));
    repro::wgmma_commit();
    pv_tile<D>(o, pp, v_stage(j - 1));
    repro::wgmma_commit();
    pass(true);
    repro::wgmma_wait<1>();          // Q K^T of tile j is done
    repro::fence_regs(sc);
    release(&k_empty[j % ST]);
    float corr[2];
    online_softmax(sc, m, l, corr, mask, j * FA_BK, scale_log2);
    split_p(sc, pn);
    repro::wgmma_wait<0>();          // P V of tile j - 1 is done
    repro::fence_regs(o);
    release(&v_empty[(j - 1) % ST]);
    rescale(corr);
  }

  // P V of the last tile, n_tiles - 1, with pp.
  __device__ __forceinline__ void last(int n_tiles, const PSplit& pp) {
    repro::mbar_wait(&v_full[(n_tiles - 1) % ST], parity(n_tiles - 1));
    turn();
    repro::fence_regs(o);
    repro::wgmma_fence();
    pv_tile<D>(o, pp, v_stage(n_tiles - 1));
    repro::wgmma_commit();
    pass(false);
    repro::wgmma_wait<0>();
    repro::fence_regs(o);
  }
};

// Three warpgroups: the first issues the TMA loads (one thread) with its
// registers lowered; the other two each take 64 of the block's 128 query
// rows with theirs raised.  q, k and v arrive through the tensor maps
// (D, H, S, B) of the launcher; columns at or past d_rt and rows at or past
// a batch's S read as zeros.
template <int D>
__global__ void __launch_bounds__(3 * WG, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int causal,
                       float scale_log2, int d_rt) {
  using T = FaTile<D>;
  constexpr int ST = T::STAGES;
  extern __shared__ unsigned char fa_smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 4 * ST];
  const uint32_t raw = repro::smem_addr(fa_smem_raw);
  unsigned char* sq = fa_smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* sk = sq + T::Q_BYTES;
  unsigned char* sv = sk + ST * T::KV_BYTES;
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;      // TMA has landed K / V of stage s
  uint64_t* v_full = k_full + ST;
  uint64_t* k_empty = v_full + ST;  // both consumers are done with K / V of stage s
  uint64_t* v_empty = k_empty + ST;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * FA_BQ;   // the longest rows first
  const int hk = h / (Hq / Hkv);
  // Causal: no key past the block's last row is needed.
  const int k_end = causal ? min(Sk, q0 + FA_BQ) : Sk;
  const int n_tiles = (k_end + FA_BK - 1) / FA_BK;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    repro::mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      repro::mbar_init(&k_full[s], 1);
      repro::mbar_init(&v_full[s], 1);
      repro::mbar_init(&k_empty[s], 2);
      repro::mbar_init(&v_empty[s], 2);
    }
    repro::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: loads never wait on math, only on a stage being free.
    repro::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      repro::prefetch_tensor_map(&tq);
      repro::prefetch_tensor_map(&tk);
      repro::prefetch_tensor_map(&tv);
      repro::mbar_arrive_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < T::NB; ++c)
        repro::tma_load_4d(sq + c * T::Q_BOX, &tq, q_full, c * FA_BOX, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        const uint32_t parity = (j / ST) & 1;
        repro::mbar_wait(&k_empty[s], parity ^ 1);
        repro::mbar_arrive_expect_tx(&k_full[s], T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < T::NB; ++c)
          repro::tma_load_4d(sk + s * T::KV_BYTES + c * T::KV_BOX, &tk, &k_full[s], c * FA_BOX,
                             hk, j * FA_BK, b);
        repro::mbar_wait(&v_empty[s], parity ^ 1);
        repro::mbar_arrive_expect_tx(&v_full[s], T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < T::NB; ++c)
          repro::tma_load_4d(sv + s * T::KV_BYTES + c * T::KV_BOX, &tv, &v_full[s], c * FA_BOX,
                             hk, j * FA_BK, b);
      }
    }
    return;
  }

  // Consumers.
  repro::setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int first_row = q0 + cw * 64;
  const int row0 = first_row + warp * 16 + g;              // and row0 + 8
  Consumer<D> c{repro::smem_addr(sq) + cw * 64 * 128, repro::smem_addr(sk), repro::smem_addr(sv),
                k_full, v_full, k_empty, v_empty, Masking{Sk, causal, first_row, row0, t},
                scale_log2, cw, tid};
  if (cw == 1) repro::named_bar_arrive(1, 2 * WG);       // warpgroup 0 issues first
  PSplit pa, pb;                                           // P's split for two tiles in turn

  repro::mbar_wait(q_full, 0);
  c.first(pa);
  int j = 1;
  for (; j + 1 < n_tiles; j += 2) {
    c.step(j, pa, pb);
    c.step(j + 1, pb, pa);
  }
  if (j < n_tiles) {
    c.step(j, pa, pb);
    c.last(n_tiles, pb);
  } else {
    c.last(n_tiles, pa);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = c.l[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + r * 8;
    if (row >= Sq) continue;
    const float L = fmaxf(l, 1e-30f);
    const float inv = 1.f / L;
    __nv_bfloat16* orow = out + (((size_t)b * Sq + row) * Hq + h) * d_rt;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col >= d_rt) continue;
      *reinterpret_cast<uint32_t*>(orow + col) =
          repro::pack_bf16x2(c.o[4 * n + 2 * r] * inv, c.o[4 * n + 2 * r + 1] * inv);
    }
    if (t == 0) lse[((size_t)b * Hq + h) * Sq + row] = (c.m[r] + log2f(L)) * LN2;
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                int Sq, int Sk, int Hq, int Hkv, int d, int causal, cudaStream_t stream) {
  const int blocks_q = (Sq + FA_BQ - 1) / FA_BQ;
  if (blocks_q > 65535) return -1;
  CUtensorMap tq, tk, tv;
  if (!repro::bf16_bshd_map(&tq, q, B, Sq, Hq, d, FA_BQ) ||
      !repro::bf16_bshd_map(&tk, k, B, Sk, Hkv, d, FA_BK) ||
      !repro::bf16_bshd_map(&tv, v, B, Sk, Hkv, d, FA_BK))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = FaTile<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // x: heads (neighbours share a kv head, hence its tiles in L2); z: query
  // blocks, taken in reverse inside the kernel.
  const dim3 grid(Hq, B, blocks_q);
  flash_fwd_wgmma_kernel<D><<<grid, 3 * WG, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Sq, Sk, Hq, Hkv,
      causal, 1.4426950408889634f / sqrtf((float)d), d);
  return (int)cudaGetLastError();
}

// d_head up to 64 runs the 64 instance, up to 128 the 128 instance; the
// columns past d read as zeros and are not stored.
int launch_d_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                  int Sq, int Sk, int Hq, int Hkv, int D, int causal, cudaStream_t s) {
  if (D <= 0 || D % 8 != 0 || D > repro::kMaxHeadDim) return -1;
  if (D <= 64) return launch_bf16<64>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal, s);
  return launch_bf16<128>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal, s);
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
