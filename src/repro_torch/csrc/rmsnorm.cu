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

#include "common.cuh"

namespace {

using repro::Vec16;

constexpr int MAXV = 8;       // 16-byte vectors a thread holds (of x, and of scale)
constexpr int MAX_TPR = 256;  // threads a row; the registers of more do not fit an SM

template <typename T>
__global__ void __launch_bounds__(MAX_TPR)
rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ out,
                int rows, int d, float eps) {
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
        sr[i] = repro::load16_ro(scale + (size_t)c * VEC);
      }
    }
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int c = threadIdx.x + i * tpr;
      if (c < nvec) {
        float f[VEC];
        Vec16<T>::unpack(xr[i], f);
#pragma unroll
        for (int j = 0; j < VEC; ++j) ss += f[j] * f[j];
      }
    }
  }

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
  if (!active) return;

  const float inv = rsqrtf(ss / (float)d + eps);
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

template <typename T>
int launch(const void* x, const void* scale, void* out, int rows, int d, float eps,
           cudaStream_t stream) {
  constexpr int VEC = Vec16<T>::N;
  if (rows <= 0 || d <= 0 || d % VEC != 0) return -1;
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
  rms_norm_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<T*>(out), rows,
      d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success), or -1 for arguments the
// kernel does not take.  x, out: (rows, d) contiguous; scale: (d,); all of
// one type and 16-byte aligned, d a multiple of the vector width.
extern "C" int repro_rms_norm(const void* x, const void* scale, void* out, int rows, int d,
                              float eps, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, s);
  return launch<float>(x, scale, out, rows, d, eps, s);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
