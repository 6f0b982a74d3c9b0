// Fused RMSNorm over the last dimension, for Hopper (sm_90a).
//
//   out = x * rsqrt(mean(x^2) + eps) * scale      fp32 math, output in x's type
//
// Replaces the Pallas kernel `repro.kernels.rmsnorm.rms_norm` (body
// `_kernel`).  That kernel pads the rows to a multiple of its row block;
// here the ragged tail is masked and nothing is padded.
//
// Bound by bytes: every element is read once and written once.  A group of
// TPR threads owns one row; each thread keeps its part of the row in
// registers, as raw 16-byte vectors, between the sum of squares and the
// scaled write, so the row is not read twice, and loads its part of the
// scale beside it, so that no load waits for the reduction.  With many
// rows a warp takes a row of up to 256 vectors (no block-wide barrier);
// with few rows (a decode step has one a slot) a row is spread over up to
// MAX_TPR threads, a vector each if they reach, because then only the
// latency counts.
//
// A row split over several ranks (the Mamba2 and xLSTM mixers' gated norms
// under tensor parallelism: each rank holds its heads' channels of the row)
// takes two more entries of the same kernel: `repro_rms_sumsq` writes each
// row's fp32 sum of squares over the rank's channels; the caller sums that
// over the ranks; `repro_rms_norm_sumsq` scales the rank's channels by
// rsqrt(sum / d_norm + eps), d_norm the whole row's width.

#include "common.cuh"

namespace {

using repro::Vec16;

constexpr int MAXV = 8;       // 16-byte vectors a thread holds (of x, and of scale)
constexpr int MAX_TPR = 256;  // threads a row; the registers of more do not fit an SM

// What a launch computes: the whole norm; a row's sum of squares alone
// (written to `sumsq`); the norm from a sum of squares read from `sumsq`.
enum Mode { NORM = 0, SUMSQ = 1, FROM_SUMSQ = 2 };

template <typename T, int MODE>
__global__ void __launch_bounds__(MAX_TPR)
rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ out,
                float* __restrict__ sumsq, int rows, int d, int d_norm, float eps) {
  constexpr int VEC = Vec16<T>::N;
  const int tpr = blockDim.x;  // threads per row, a multiple of 32
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const int nvec = d / VEC;
  const bool active = row < rows;  // the ragged tail of the last block

  uint4 xr[MAXV], sr[MAXV];
  float ss = 0.f;
  if (active) {
    const T* xp = x + (size_t)row * d;
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int c = threadIdx.x + i * tpr;
      if (c < nvec) {
        xr[i] = repro::load16(xp + (size_t)c * VEC);
        if (MODE != SUMSQ) sr[i] = repro::load16_ro(scale + (size_t)c * VEC);
      }
    }
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int c = threadIdx.x + i * tpr;
      if (MODE != FROM_SUMSQ && c < nvec) {
        float f[VEC];
        Vec16<T>::unpack(xr[i], f);
#pragma unroll
        for (int j = 0; j < VEC; ++j) ss += f[j] * f[j];
      }
    }
  }

  if (MODE != FROM_SUMSQ) {
    // Sum over the row's threads: within the warp, then across warps.
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (tpr > 32) {  // one row a block (blockDim.y == 1)
      __shared__ float warp_sum[32];
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      if (lane == 0) warp_sum[warp] = ss;
      __syncthreads();
      ss = 0.f;
      for (int w = 0; w < (tpr >> 5); ++w) ss += warp_sum[w];
    }
  }
  if (!active) return;
  if (MODE == SUMSQ) {
    if (threadIdx.x == 0) sumsq[row] = ss;
    return;
  }
  if (MODE == FROM_SUMSQ) ss = sumsq[row];

  const float inv = rsqrtf(ss / (float)d_norm + eps);
  T* op = out + (size_t)row * d;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int c = threadIdx.x + i * tpr;
    if (c < nvec) {
      float f[VEC], s[VEC];
      Vec16<T>::unpack(xr[i], f);
      Vec16<T>::unpack(sr[i], s);
#pragma unroll
      for (int j = 0; j < VEC; ++j) f[j] = (f[j] * inv) * s[j];
      repro::store16(op + (size_t)c * VEC, Vec16<T>::pack(f));
    }
  }
}

template <typename T, int MODE>
int launch(const void* x, const void* scale, void* out, float* sumsq, int rows, int d,
           int d_norm, float eps, cudaStream_t stream) {
  constexpr int VEC = Vec16<T>::N;
  if (rows <= 0 || d <= 0 || d % VEC != 0 || d_norm < d) return -1;
  const int nvec = d / VEC;
  // Many rows: as few threads a row as can hold it.  Few rows: a vector a
  // thread, as far as a block goes.
  const int per_thread = rows >= 2048 ? MAXV : 1;
  int tpr = 32;
  while (tpr * per_thread < nvec && tpr < MAX_TPR) tpr *= 2;
  if (tpr * MAXV < nvec) return -1;
  // A warp a row: four rows a block; one row a block when a row takes more.
  const int rows_per_block = tpr == 32 ? 4 : 1;
  const dim3 block(tpr, rows_per_block);
  const dim3 grid((rows + rows_per_block - 1) / rows_per_block);
  rms_norm_kernel<T, MODE><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<T*>(out), sumsq,
      rows, d, d_norm, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success), or -1 for arguments the
// kernel does not take.  x, out: (rows, d) contiguous; scale: (d,); all of
// one type and 16-byte aligned, d a multiple of the vector width.
extern "C" int repro_rms_norm(const void* x, const void* scale, void* out, int rows, int d,
                              float eps, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16, NORM>(x, scale, out, nullptr, rows, d, d, eps, s);
  return launch<float, NORM>(x, scale, out, nullptr, rows, d, d, eps, s);
}

// sumsq: (rows,) fp32, each row's sum of x^2 over its d channels.
extern "C" int repro_rms_sumsq(const void* x, void* sumsq, int rows, int d, int is_bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ss = static_cast<float*>(sumsq);
  if (is_bf16) return launch<__nv_bfloat16, SUMSQ>(x, nullptr, nullptr, ss, rows, d, d, 0.f, s);
  return launch<float, SUMSQ>(x, nullptr, nullptr, ss, rows, d, d, 0.f, s);
}

// out = x * rsqrt(sumsq / d_norm + eps) * scale, with sumsq (rows,) fp32 the
// whole row's sum of squares, of which x holds d of the d_norm channels.
extern "C" int repro_rms_norm_sumsq(const void* x, const void* scale, const void* sumsq,
                                    void* out, int rows, int d, int d_norm, float eps,
                                    int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ss = const_cast<float*>(static_cast<const float*>(sumsq));
  if (is_bf16)
    return launch<__nv_bfloat16, FROM_SUMSQ>(x, scale, out, ss, rows, d, d_norm, eps, s);
  return launch<float, FROM_SUMSQ>(x, scale, out, ss, rows, d, d_norm, eps, s);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
