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
//     over blocks (flash-decoding): each block writes a partial (m, l, acc)
//     and a second small kernel merges the splits.  The split is a function
//     of the shapes only, never of kv_len, so a row's result does not
//     depend on the other rows of the batch.
//   * No restriction on Sk; kv_len is clamped to [0, Sk]; a split that
//     lies wholly past kv_len loads nothing and writes an empty partial;
//     kv_len == 0 gives zeros (l floored at 1e-30, as the TPU kernel does).
//   * D = 32, 64 and 128 have exact instances.  Any other D that is a
//     multiple of the 16-byte vector and at most 128 (zamba2-7b's 112) runs
//     the padded instance: its register and shared-memory rows are 128
//     wide, rows are read at their native stride D, and the lanes at or
//     past D load zeros and store nothing.
//
// Bound by bytes: the valid prefix of K and V is read once,
// 2 * sum_b kv_len[b] * Hkv * D * itemsize.  Both products (q.k^T and p.v)
// are computed here in fp32.  TPK = D / VEC threads share one key row with
// one 16-byte load each, so a warp reads 32/TPK whole rows a step; every
// thread keeps G partial dot products, reduced over the TPK lanes with
// shuffles, and its own slice of the G accumulators.  UNROLL rows are
// loaded before any is used, to keep loads in flight.

#include "common.cuh"

namespace {

using repro::Vec16;

constexpr float NEG_INF = -1e30f;
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
                      float* __restrict__ part_l, float* __restrict__ part_acc, int Sk,
                      int Hkv, int G, int chunk, int n_splits, float scale, int d_rt) {
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
    if (n_splits == 1) {
      out[((size_t)b * Hq + h * G + g) * dd + d] = Vec16<T>::one(A / fmaxf(L, 1e-30f));
    } else {
      const size_t idx = (((size_t)b * Hkv + h) * n_splits + split) * G + g;
      part_acc[idx * dd + d] = A;
      if (d == 0) {
        part_m[idx] = M;
        part_l[idx] = L;
      }
    }
  }
}

// One block for each (batch, kv head, q head of the group); thread d owns
// output element d and folds the splits' partials together.
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ part_m,
                                    const float* __restrict__ part_l,
                                    const float* __restrict__ part_acc, T* __restrict__ out,
                                    int n_splits, int G, int D) {
  const size_t bh = blockIdx.x;
  const int g = blockIdx.y, d = threadIdx.x;
  float M = NEG_INF;
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, part_m[(bh * n_splits + s) * G + g]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const size_t idx = (bh * n_splits + s) * G + g;
    const float w = expf(part_m[idx] - M);
    L += part_l[idx] * w;
    A += part_acc[idx * D + d] * w;
  }
  out[(bh * G + g) * D + d] = Vec16<T>::one(A / fmaxf(L, 1e-30f));
}

struct Args {
  const void *q, *k, *v;
  const int* kv_len;
  void* out;
  float *part_m, *part_l, *part_acc;
  int B, Sk, Hq, Hkv, D, chunk, n_splits;
  cudaStream_t stream;
};

template <typename T, int D, int GMAX, bool PAD>
int launch(const Args& a) {
  const int G = a.Hq / a.Hkv;
  const dim3 grid(a.n_splits, a.Hkv, a.B);
  decode_partial_kernel<T, D, GMAX, PAD><<<grid, THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.kv_len, static_cast<T*>(a.out), a.part_m, a.part_l, a.part_acc, a.Sk, a.Hkv, G,
      a.chunk, a.n_splits, 1.0f / sqrtf((float)a.D), a.D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return (int)err;
  decode_merge_kernel<T><<<dim3(a.B * a.Hkv, G), a.D, 0, a.stream>>>(
      a.part_m, a.part_l, a.part_acc, static_cast<T*>(a.out), a.n_splits, G, a.D);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool PAD = false>
int launch_g(const Args& a) {
  const int G = a.Hq / a.Hkv;
  if (G == 1) return launch<T, D, 1, PAD>(a);
  if (G == 2) return launch<T, D, 2, PAD>(a);
  if (G <= 4) return launch<T, D, 4, PAD>(a);
  if (G <= 8) return launch<T, D, 8, PAD>(a);
  return -1;
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
// kernels do not take.  q, out: (B, 1, Hq, D); k, v: (B, Sk, Hkv, D);
// kv_len: (B,) int32; all contiguous, on the device, 16-byte aligned; D a
// multiple of the 16-byte vector (8 bf16, 4 fp32) and at most 128.
// Split s covers keys [s*chunk, (s+1)*chunk).  With n_splits > 1 the
// scratch holds part_m, part_l: (B, Hkv, n_splits, G) and part_acc:
// (B, Hkv, n_splits, G, D), fp32; with n_splits == 1 it is not touched.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* kv_len, void* out, void* part_m,
                                      void* part_l, void* part_acc, int B, int Sk, int Hq,
                                      int Hkv, int D, int chunk, int n_splits, int is_bf16,
                                      void* stream) {
  if (B <= 0 || Sk <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || chunk <= 0 ||
      n_splits <= 0 || (long long)chunk * n_splits < Sk || Hkv > 65535 || B > 65535)
    return -1;
  Args a{q, k, v, static_cast<const int*>(kv_len), out, static_cast<float*>(part_m),
         static_cast<float*>(part_l), static_cast<float*>(part_acc), B, Sk, Hq, Hkv, D,
         chunk, n_splits, static_cast<cudaStream_t>(stream)};
  if (is_bf16) return launch_d<__nv_bfloat16>(a);
  return launch_d<float>(a);
}
