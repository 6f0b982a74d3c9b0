// Mamba2 SSD chunked scan (zero initial state), for Hopper (sm_90a).
//
// Per (batch b, head h), over the chunks of L steps in order, with the
// (P, N) fp32 state S carried from chunk to chunk:
//
//   cum_i  = sum_{k <= i} A dt_k                   A = -exp(A_log[h])
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//            + exp(cum_i) C_i . S^T + D[h] x_i
//   S     <- exp(cum_L) S + sum_j exp(cum_L - cum_j) dt_j x_j (x) B_j
//
// and at the end the state, fp32 (B, H, P, N).  y is written in x's type.
//
// Replaces the Pallas kernel `repro.kernels.ssm_scan.ssm_scan` (body
// `_kernel`).  What changed on the way:
//   * The TPU grid's second dimension runs in order and carries the state
//     in VMEM scratch; here it is a loop over the chunks inside the block,
//     the state in shared memory.  One block for each (head, batch).
//   * x (B, S, H, P) and B, C (B, S, N) are read at their own batch and
//     sequence strides: in `mamba2_block` they are column slices of one
//     conv output, and the TPU wrapper's transposed copies are not made.
//   * -exp(A_log) and D are computed per head here, not tiled per batch by
//     the wrapper.
//
// Bound: at zamba2-7b's training shape (B 2, S 4096, H 112, P 64, N 64,
// chunk 64, bf16) by bytes: x read and y written once (235 MB), B, C, dt
// and the state 9.4 MB, 0.073 ms at 3.35 TB/s; the four 64x64x64 products
// of each of the 14,336 (b, h, chunk) steps are 3.0e10 operations, 0.030
// ms at the bf16 tensor-core peak, 0.45 ms on the fp32 cores.  This first
// version is plain rather than fast: one chunk's x, B, C and dt are staged
// in shared memory as fp32 (scalar loads, coalesced along P and N), the
// products run on the fp32 cores, a 16 x 16 grid of threads each owning a
// 4 x 4 tile of the product (rows ty + 16 r, columns tx + 16 q, so that a
// warp reads neighbouring columns), with the rows of B, C and the state
// padded by one float against bank conflicts.  The cumulative sum is one
// thread's loop, in the plain version's order.  Tensor cores, cp.async /
// TMA and splitting the chunk loop over blocks are later work.

#include "common.cuh"

namespace {

constexpr int TG = 16;             // threads along each side of the thread grid
constexpr int THREADS = TG * TG;
constexpr int MT = 4;              // a thread's tile: MT x MT
constexpr int MAXD = TG * MT;      // chunk, P and N at most 64

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// acc[r][q] += sum_{k < K} A(m_r, k) * B(k, n_q), with A(m, k) = a[m * am + k * ak]
// and B(k, n) = b[k * bk + n * bn]; m_r and n_q are the thread's (clamped)
// rows and columns.
__device__ __forceinline__ void tile_product(float (&acc)[MT][MT], const float* a, int am,
                                             int ak, const float* b, int bk, int bn, int K,
                                             const int (&m)[MT], const int (&n)[MT]) {
  for (int k = 0; k < K; ++k) {
    float av[MT], bv[MT];
#pragma unroll
    for (int r = 0; r < MT; ++r) av[r] = a[m[r] * am + k * ak];
#pragma unroll
    for (int q = 0; q < MT; ++q) bv[q] = b[k * bk + n[q] * bn];
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int q = 0; q < MT; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[MT][MT]) {
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int q = 0; q < MT; ++q) acc[r][q] = 0.f;
}

// The thread's rows (ty + 16 r) or columns (tx + 16 q), clamped into
// [0, lim) so that every shared-memory read stays in bounds; a clamped
// entry is computed and never stored.
__device__ __forceinline__ void lanes(int (&idx)[MT], bool (&ok)[MT], int t, int lim) {
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    const int v = t + TG * r;
    ok[r] = v < lim;
    idx[r] = min(v, lim - 1);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ dt, const float* __restrict__ a_log,
                const float* __restrict__ d_skip, T* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int P, int N, int L,
                long long x_sb, long long x_ss, long long b_sb, long long b_ss,
                long long c_sb, long long c_ss) {
  extern __shared__ __align__(16) float smem[];
  const int ldn = N + 1, ldl = L + 1;
  float* xs = smem;             // [L][P]     x of the chunk
  float* bs = xs + L * P;       // [L][ldn]   B, then B_j * wl_j
  float* cs = bs + L * ldn;     // [L][ldn]   C
  float* st = cs + L * ldn;     // [P][ldn]   the carried state
  float* ws = st + P * ldn;     // [L][ldl]   (C_i . B_j) exp(cum_i - cum_j) dt_j, j <= i
  float* dts = ws + L * ldl;    // [L]
  float* cum = dts + L;         // [L]
  float* ecum = cum + L;        // [L]        exp(cum_i)
  float* wl = ecum + L;         // [L]        exp(cum_L - cum_j) dt_j
  __shared__ float decay_end;   // exp(cum_L)

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % TG, ty = tid / TG;
  const float A = -expf(a_log[h]);
  const float Dh = d_skip[h];

  const T* xb = x + b * x_sb + (long long)h * P;
  const T* bb = bm + b * b_sb;
  const T* cb = cm + b * c_sb;
  const float* dtb = dt + (size_t)b * S * H + h;
  const size_t y_row = (size_t)H * P;
  T* yb = y + (size_t)b * S * y_row + (size_t)h * P;

  for (int e = tid; e < P * ldn; e += THREADS) st[e] = 0.f;

  int li[MT], lj[MT], pi[MT], pj[MT], nj[MT];
  bool li_ok[MT], lj_ok[MT], pi_ok[MT], pj_ok[MT], nj_ok[MT];
  lanes(li, li_ok, ty, L);   // rows i of (i, j) and (i, p)
  lanes(lj, lj_ok, tx, L);   // columns j of (i, j)
  lanes(pi, pi_ok, ty, P);   // rows p of (p, n)
  lanes(pj, pj_ok, tx, P);   // columns p of (i, p)
  lanes(nj, nj_ok, tx, N);   // columns n of (p, n)

  for (int c0 = 0; c0 < S; c0 += L) {
    __syncthreads();  // the previous chunk is done with xs, bs, cs, dts and st
    for (int e = tid; e < L * P; e += THREADS) {
      const int i = e / P, p = e % P;
      xs[e] = to_f32(xb[(c0 + i) * x_ss + p]);
    }
    for (int e = tid; e < L * N; e += THREADS) {
      const int i = e / N, n = e % N;
      bs[i * ldn + n] = to_f32(bb[(c0 + i) * b_ss + n]);
      cs[i * ldn + n] = to_f32(cb[(c0 + i) * c_ss + n]);
    }
    if (tid < L) dts[tid] = dtb[(size_t)(c0 + tid) * H];
    __syncthreads();

    // cum: the inclusive sum of A dt, added in order by one thread, as the
    // plain version's cumsum adds it.  Its rounding must match: exp(cum_i -
    // cum_j) cancels two nearly equal sums, and a scan in another order
    // moves y by some 1e-5 of itself.
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < L; ++i) cum[i] = run += A * dts[i];
    }
    __syncthreads();

    // Phase 1: the decays, and W = (C B^T) masked and weighted.
    if (tid < L) {
      const float cl = cum[L - 1];
      ecum[tid] = expf(cum[tid]);
      wl[tid] = expf(cl - cum[tid]) * dts[tid];
      if (tid == 0) decay_end = expf(cl);
    }
    {
      float g[MT][MT];
      zero(g);
      tile_product(g, cs, ldn, 1, bs, 1, ldn, N, li, lj);
#pragma unroll
      for (int r = 0; r < MT; ++r)
#pragma unroll
        for (int q = 0; q < MT; ++q) {
          const int i = li[r], j = lj[q];
          if (li_ok[r] && lj_ok[q])
            ws[i * ldl + j] = j <= i ? g[r][q] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
    }
    __syncthreads();

    // Phase 2: y = W x + exp(cum) (C S^T) + D x; B_j is scaled by wl_j for
    // phase 3 (no product of this phase reads B).
    for (int e = tid; e < L * N; e += THREADS) {
      const int i = e / N, n = e % N;
      bs[i * ldn + n] *= wl[i];
    }
    {
      float yi[MT][MT], ys[MT][MT];
      zero(yi);
      zero(ys);
      tile_product(yi, ws, ldl, 1, xs, P, 1, L, li, pj);
      tile_product(ys, cs, ldn, 1, st, 1, ldn, N, li, pj);
#pragma unroll
      for (int r = 0; r < MT; ++r)
#pragma unroll
        for (int q = 0; q < MT; ++q) {
          const int i = li[r], p = pj[q];
          if (li_ok[r] && pj_ok[q]) {
            const float v = yi[r][q] + ecum[i] * ys[r][q] + Dh * xs[i * P + p];
            yb[(size_t)(c0 + i) * y_row + p] = repro::Vec16<T>::one(v);
          }
        }
    }
    __syncthreads();

    // Phase 3: S <- exp(cum_L) S + x^T (wl B); each thread updates its own
    // entries of S.
    {
      float ds[MT][MT];
      zero(ds);
      tile_product(ds, xs, 1, P, bs, ldn, 1, L, pi, nj);
#pragma unroll
      for (int r = 0; r < MT; ++r)
#pragma unroll
        for (int q = 0; q < MT; ++q)
          if (pi_ok[r] && nj_ok[q]) {
            float& s = st[pi[r] * ldn + nj[q]];
            s = decay_end * s + ds[r][q];
          }
    }
  }
  __syncthreads();
  float* so = state_out + ((size_t)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += THREADS) so[e] = st[(e / N) * ldn + e % N];
}

size_t smem_bytes(int L, int P, int N) {
  return sizeof(float) * ((size_t)L * P + 2 * (size_t)L * (N + 1) + (size_t)P * (N + 1) +
                          (size_t)L * (L + 1) + 4 * (size_t)L);
}

template <typename T>
int launch(const void* x, const void* bm, const void* cm, const void* dt, const void* a_log,
           const void* d, void* y, void* state, int B, int S, int H, int P, int N, int L,
           long long x_sb, long long x_ss, long long b_sb, long long b_ss, long long c_sb,
           long long c_ss, cudaStream_t stream) {
  const size_t smem = smem_bytes(L, P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssm_scan_kernel<T><<<dim3(H, B), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const float*>(dt), static_cast<const float*>(a_log),
      static_cast<const float*>(d), static_cast<T*>(y), static_cast<float*>(state), S, H, P,
      N, L, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success), or -1 for arguments the
// kernel does not take.  x: (B, S, H, P) with strides (x_sb, x_ss, P, 1);
// bm, cm: (B, S, N) with strides (b_sb, b_ss, 1) and (c_sb, c_ss, 1), in
// x's type; dt: (B, S, H) contiguous, a_log and d: (H,), fp32; y: (B, S, H,
// P) contiguous in x's type; state: (B, H, P, N) fp32.  Strides count
// elements.  chunk, P and N in [1, 64]; S a multiple of chunk.
extern "C" int repro_ssm_scan(const void* x, const void* bm, const void* cm, const void* dt,
                              const void* a_log, const void* d, void* y, void* state, int B,
                              int S, int H, int P, int N, int chunk, long long x_sb,
                              long long x_ss, long long b_sb, long long b_ss, long long c_sb,
                              long long c_ss, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || chunk <= 0 || chunk > MAXD || P <= 0 ||
      P > MAXD || N <= 0 || N > MAXD || S % chunk != 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, bm, cm, dt, a_log, d, y, state, B, S, H, P, N, chunk,
                                 x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, s);
  return launch<float>(x, bm, cm, dt, a_log, d, y, state, B, S, H, P, N, chunk, x_sb, x_ss,
                       b_sb, b_ss, c_sb, c_ss, s);
}
