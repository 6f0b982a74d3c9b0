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
// What changed on the way:
//   * q, k and v are read in their native (B, S, H, D) layout; the TPU
//     wrapper transposes (copies) all three on every call.
//   * The TPU grid's third dimension runs in order and carries (m, l, acc)
//     in scratch; here it is a loop over key tiles inside the block.
//   * No divisibility: the ragged last query block and key tile are
//     masked; the TPU wrapper raises unless the blocks divide the lengths.
//   * Under causality the tiles wholly above the diagonal are not visited
//     (the loop ends at the block's last query row), as `pl.when` skips them.
//   * Softmax state (m, l, acc) is fp32; l is floored at 1e-30 at the end.
//   * D = 32, 64 and 128 have exact instances.  Any other D that is a
//     multiple of the 16-byte vector and at most 128 (zamba2-7b's 112) runs
//     the padded instance: its register and shared-memory rows are 128
//     wide, rows are read at their native stride D, and the values at or
//     past D are zeros in q, k and v and are not stored.
//
// Bound: at the training shape (B 2, S 4096, Hq 32, Hkv 8, D 64, bf16,
// causal) by operations, 4 * B * Hq * D * S^2 / 2 = 1.37e11, against about
// 85 MB moved.  This first version is plain and right rather than fast:
// both products run on the fp32 cores (no tensor cores, for bf16 as for
// fp32), which caps it near the fp32 rate.  K and V tiles of BK keys are
// staged in shared memory as fp32 (4096 values each, 32 KB together); a
// group of TPR = D / 32 neighbouring threads owns one query row, 32 of its
// values of q and of the accumulator in registers each, and the partial dot
// products are summed over the group with shuffles.  Scores go through the
// online softmax KC keys at a time, one rescale of the accumulator each.

#include "common.cuh"

namespace {

using repro::Vec16;

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int KC = 16;     // keys between two rescales of the accumulator
constexpr int PER = 32;    // values of a row a thread holds (of q, and of acc)
constexpr int NQ = PER / 4;

// Four neighbouring values of T <-> four fp32 registers.
template <typename T>
struct Quad;

template <>
struct Quad<float> {
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Quad<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* f) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    f[0] = __uint_as_float(r.x << 16);
    f[1] = __uint_as_float(r.x & 0xffff0000u);
    f[2] = __uint_as_float(r.y << 16);
    f[3] = __uint_as_float(r.y & 0xffff0000u);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* f) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(repro::pack_bf16x2(f[0], f[1]), repro::pack_bf16x2(f[2], f[3]));
  }
};

// D is the width of a row in registers and shared memory; dd the row's
// length and stride in device memory: D itself, or with PAD the runtime
// d_rt <= D, the values at or past it masked.
template <typename T, int D, bool PAD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                 int causal, float scale, int d_rt) {
  constexpr int TPR = D / PER;          // threads that share one query row
  constexpr int BQ = THREADS / TPR;     // query rows a block
  constexpr int BK = 4096 / D;          // keys a tile in shared memory
  constexpr int VEC = Vec16<T>::N;      // values of a 16-byte load
  constexpr int RV = D / VEC;           // 16-byte loads a key row
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
      Quad<T>::load(q + q_at + 4 * (c * TPR + part), qf[c]);
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
  const T* kb = k + (size_t)b * Sk * kv_row + (size_t)hk * dd;
  const T* vb = v + (size_t)b * Sk * kv_row + (size_t)hk * dd;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = tid; e < BK * RV; e += THREADS) {
      const int r = e / RV, c = e % RV;
      const int key = k0 + r;
      float fk[VEC], fv[VEC];
      if (key < Sk && (!PAD || c * VEC < dd)) {
        Vec16<T>::unpack(repro::load16_ro(kb + key * kv_row + c * VEC), fk);
        Vec16<T>::unpack(repro::load16_ro(vb + key * kv_row + c * VEC), fv);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) fk[i] = fv[i] = 0.f;
      }
      float4* dk = reinterpret_cast<float4*>(sk + r * D + c * VEC);
      float4* dv = reinterpret_cast<float4*>(sv + r * D + c * VEC);
#pragma unroll
      for (int i = 0; i < VEC / 4; ++i) {
        dk[i] = make_float4(fk[4 * i], fk[4 * i + 1], fk[4 * i + 2], fk[4 * i + 3]);
        dv[i] = make_float4(fv[4 * i], fv[4 * i + 1], fv[4 * i + 2], fv[4 * i + 3]);
      }
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
  T* orow = out + (((size_t)b * Sq + qi) * Hq + h) * dd;
#pragma unroll
  for (int c = 0; c < NQ; ++c) {
    if (PAD && 4 * (c * TPR + part) >= dd) continue;
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = acc[c][e] / L;
    Quad<T>::store(orow + 4 * (c * TPR + part), f);
  }
  if (part == 0) lse[((size_t)b * Hq + h) * Sq + qi] = m + logf(L);
}

template <typename T, int D, bool PAD = false>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B, int Sq,
           int Sk, int Hq, int Hkv, int d, int causal, cudaStream_t stream) {
  constexpr int BQ = THREADS / (D / PER);
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T, D, PAD><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), Sq, Sk, Hq, Hkv, causal,
      1.0f / sqrtf((float)d), d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, void* lse, int B, int Sq,
             int Sk, int Hq, int Hkv, int D, int causal, cudaStream_t stream) {
  if (D == 32) return launch<T, 32>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal, stream);
  if (D == 64) return launch<T, 64>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal, stream);
  if (D == 128) return launch<T, 128>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal, stream);
  if (repro::padded_head_dim<T>(D))
    return launch<T, repro::kMaxHeadDim, true>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal,
                                               stream);
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
  if (is_bf16)
    return launch_d<__nv_bfloat16>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal, s);
  return launch_d<float>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal, s);
}
