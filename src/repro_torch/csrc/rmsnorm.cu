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
//
// The gradient (`repro_rms_norm_bwd`, then `repro_rms_dscale_sum`; whole
// rows) and an empty kernel that measures the launch floor follow the
// forward below; each has its own note.

#include "common.cuh"
#include "hopper.cuh"

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

// ------------------------------------------------------------- gradient --
// rms_norm's gradient over whole rows.  It replaces no Pallas kernel: the
// reference has no Pallas backward, and XLA differentiates its jnp
// `rms_norm` (src/repro/models/layers.py:72) and fuses the result; this is
// how the card does the same work in one pass.  With r = rsqrt(mean(x^2) +
// eps), in fp32 as the plain formula (`rms_norm_backward_plain`):
//   dx     = r * (dy*s - (x*r) * (r * sum(dy*s*x) / d))     in x's type
//   dscale = sum over the rows of dy * (x*r)                  in scale's type
// sum(x^2) and sum(dy*s*x) do not depend on r, so one block-wide reduction
// a row gives both.
//
// Bound by bytes: x and dy read once and dx written once, 6 bytes an
// element in bf16 (the plain chain of fp32 ops moves about 106).  Persistent
// blocks, a fixed multiple of the SMs that the wrapper chooses, walk over the
// rows blockIdx.x, blockIdx.x + gridDim.x, ...; a block takes one row at a
// time with all its threads (a block a row at every width, as the
// forward's launcher gives wide rows), thread t owning the same 16-byte
// vectors t, t + blockDim.x, ... of every row it visits.  So its dscale
// partials stay in fp32 registers; each block writes its row of partials,
// (blocks, d) fp32, at the end, and `rms_dscale_sum_kernel` sums them over
// the blocks in a fixed order (two calls give the same bits).
//
// Thread 0 keeps `stages` rows in flight.  Each row's x and dy arrive by
// two 1-D bulk copies (TMA, cp.async.bulk) into a ring of stages in shared
// memory, completed on a stage's mbarrier, so the next rows' bytes are in
// flight while this row is reduced.  A stage is refilled with the row
// `stages` ahead as soon as the block's reduction barrier shows that every
// thread holds its vectors of it in registers.

constexpr int BWD_THREADS = 256;    // the most threads a block
constexpr int BWD_MAX_STAGES = 3;
constexpr int SUM_WARPS = 16;       // rms_dscale_sum_kernel: warps a block

// Two blocks an SM up to four vectors a thread (every bf16 width up to
// 8192, fp32 up to 4096); one above, where the registers would spill.
template <typename T, int PER>
__global__ void __launch_bounds__(BWD_THREADS, PER <= 4 ? 2 : 1)
rms_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    const T* __restrict__ scale, T* __restrict__ dx,
                    float* __restrict__ partial, int rows, int d, float eps, int stages) {
  constexpr int VEC = Vec16<T>::N;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ uint64_t full[BWD_MAX_STAGES];
  __shared__ float2 warp_sums[2][BWD_THREADS / 32];
  const int nvec = d / VEC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int first = blockIdx.x, grid = gridDim.x;
  const uint32_t row_bytes = (uint32_t)d * sizeof(T);

  uint4 sr[PER];
  float acc[PER][VEC];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = tid + i * blockDim.x;
    if (c < nvec) sr[i] = repro::load16_ro(scale + (size_t)c * VEC);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[i][j] = 0.f;
  }

  // Stage `stage` <- row `row` of x and of dy (thread 0 only).
  auto issue = [&](int stage, int row) {
    unsigned char* dst = ring + (size_t)stage * 2 * row_bytes;
    repro::mbar_arrive_expect_tx(&full[stage], 2 * row_bytes);
    repro::bulk_load(dst, x + (size_t)row * d, row_bytes, &full[stage]);
    repro::bulk_load(dst + row_bytes, dy + (size_t)row * d, row_bytes, &full[stage]);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) repro::mbar_init(&full[s], 1);
    repro::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < stages; ++s)
      if (first + s * grid < rows) issue(s, first + s * grid);

  int k = 0;  // the block's k-th row
  for (int row = first; row < rows; row += grid, ++k) {
    const int stage = k % stages;
    repro::mbar_wait(&full[stage], (uint32_t)(k / stages) & 1u);
    const T* xs = reinterpret_cast<const T*>(ring + (size_t)stage * 2 * row_bytes);
    const T* gs = reinterpret_cast<const T*>(ring + (size_t)stage * 2 * row_bytes + row_bytes);
    uint4 xr[PER], gr[PER];
    float ss = 0.f, sg = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + i * blockDim.x;
      if (c < nvec) {
        xr[i] = repro::load16(xs + (size_t)c * VEC);
        gr[i] = repro::load16(gs + (size_t)c * VEC);
      }
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + i * blockDim.x;
      if (c < nvec) {
        float f[VEC], g[VEC], s[VEC];
        Vec16<T>::unpack(xr[i], f);
        Vec16<T>::unpack(gr[i], g);
        Vec16<T>::unpack(sr[i], s);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          ss += f[j] * f[j];
          sg += (g[j] * s[j]) * f[j];
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      sg += __shfl_xor_sync(0xffffffffu, sg, off);
    }
    // Double-buffered by row: a thread writes row k + 2's sums only after
    // every thread has passed row k + 1's barrier, so after it read row k's.
    if (lane == 0) warp_sums[k & 1][warp] = make_float2(ss, sg);
    __syncthreads();
    if (tid == 0 && row + stages * grid < rows) {
      repro::fence_proxy_async();   // this block's reads of the stage before the copy's writes
      issue(stage, row + stages * grid);
    }
    ss = 0.f;
    sg = 0.f;
    for (int w = 0; w < warps; ++w) {
      const float2 v = warp_sums[k & 1][w];
      ss += v.x;
      sg += v.y;
    }
    const float r = rsqrtf(ss / (float)d + eps);
    const float m = r * sg / (float)d;  // mean(dy*s * x*r)
    T* op = dx + (size_t)row * d;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + i * blockDim.x;
      if (c < nvec) {
        float f[VEC], g[VEC], s[VEC], o[VEC];
        Vec16<T>::unpack(xr[i], f);
        Vec16<T>::unpack(gr[i], g);
        Vec16<T>::unpack(sr[i], s);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xhat = f[j] * r;
          o[j] = r * (g[j] * s[j] - xhat * m);
          acc[i][j] += g[j] * xhat;
        }
        repro::store16(op + (size_t)c * VEC, Vec16<T>::pack(o));
      }
    }
  }

  float* pp = partial + (size_t)first * d;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = tid + i * blockDim.x;
    if (c < nvec) {
#pragma unroll
      for (int q = 0; q < VEC; q += 4)
        *reinterpret_cast<float4*>(pp + (size_t)c * VEC + q) =
            make_float4(acc[i][q], acc[i][q + 1], acc[i][q + 2], acc[i][q + 3]);
    }
  }
}

// dscale[c] = sum over b of partial[b][c], b in a fixed order: warp w of a
// block sums the rows w, w + SUM_WARPS, ... of its 128 columns (four a
// lane), then warp 0 adds the warps' sums in order and casts.
template <typename T>
__global__ void __launch_bounds__(SUM_WARPS * 32)
rms_dscale_sum_kernel(const float* __restrict__ partial, T* __restrict__ dscale, int blocks,
                      int d) {
  __shared__ float4 sums[SUM_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = (blockIdx.x * 32 + lane) * 4;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < d) {
#pragma unroll 4
    for (int b = warp; b < blocks; b += SUM_WARPS) {
      const float4 v = *reinterpret_cast<const float4*>(partial + (size_t)b * d + col);
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
  }
  sums[warp][lane] = a;
  __syncthreads();
  if (warp == 0 && col < d) {
    float4 t = sums[0][lane];
    for (int w = 1; w < SUM_WARPS; ++w) {
      const float4 v = sums[w][lane];
      t.x += v.x;
      t.y += v.y;
      t.z += v.z;
      t.w += v.w;
    }
    dscale[col] = Vec16<T>::one(t.x);
    dscale[col + 1] = Vec16<T>::one(t.y);
    dscale[col + 2] = Vec16<T>::one(t.z);
    dscale[col + 3] = Vec16<T>::one(t.w);
  }
}

template <typename T, int PER>
cudaError_t launch_bwd_instance(const T* x, const T* dy, const T* scale, T* dx, float* partial,
                                int rows, int d, float eps, int blocks, int threads,
                                int stages, size_t smem, cudaStream_t stream) {
  auto kernel = rms_norm_bwd_kernel<T, PER>;
  // Dynamic shared memory past 48 KB a block (the static barriers and sums
  // included) needs the attribute; a ring that may reach it sets it.
  if (smem > 32 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, smem, stream>>>(x, dy, scale, dx, partial, rows, d, eps, stages);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* dy, const void* scale, void* dx, float* partial,
               int rows, int d, float eps, int blocks, cudaStream_t s) {
  constexpr int VEC = Vec16<T>::N;
  if (rows <= 0 || d <= 0 || d % VEC != 0 || blocks <= 0 || blocks > rows) return -1;
  const int nvec = d / VEC;
  // Vectors a thread (1, 2, 4 or 8): the fewest that BWD_THREADS threads
  // cover the row with; then as few whole warps as hold it.
  int per = 1;
  while (per * BWD_THREADS < nvec && per < 8) per *= 2;
  if (per * BWD_THREADS < nvec) return -1;
  const int threads = ((nvec + per - 1) / per + 31) / 32 * 32;
  // Three stages where two blocks an SM still fit, else two.
  const size_t row_bytes = (size_t)d * sizeof(T);
  const int stages = 6 * row_bytes <= 110 * 1024 ? 3 : 2;
  const size_t smem = (size_t)stages * 2 * row_bytes;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(dy);
  const T* st = static_cast<const T*>(scale);
  T* ot = static_cast<T*>(dx);
  cudaError_t err;
  switch (per) {
    case 1: err = launch_bwd_instance<T, 1>(xt, gt, st, ot, partial, rows, d, eps, blocks,
                                            threads, stages, smem, s); break;
    case 2: err = launch_bwd_instance<T, 2>(xt, gt, st, ot, partial, rows, d, eps, blocks,
                                            threads, stages, smem, s); break;
    case 4: err = launch_bwd_instance<T, 4>(xt, gt, st, ot, partial, rows, d, eps, blocks,
                                            threads, stages, smem, s); break;
    default: err = launch_bwd_instance<T, 8>(xt, gt, st, ot, partial, rows, d, eps, blocks,
                                             threads, stages, smem, s);
  }
  return (int)err;
}

// ---------------------------------------------------------- launch floor --
// A kernel that does nothing, reached by the same ctypes route as the
// kernels above.  It replaces no TPU kernel: it was added to measure the
// floor under one launch of this route (one block of 32 threads), beside
// rms_norm's and decode_attention's decode-shape times.
__global__ void empty_kernel() {}

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

// rms_norm's gradient, whole rows: dx (rows, d) in x's type, and each of
// `blocks` persistent blocks' dscale partials, partial (blocks, d) fp32.
// x, dy, dx: (rows, d) contiguous; scale: (d,); all of one type and 16-byte
// aligned; 1 <= blocks <= rows.
extern "C" int repro_rms_norm_bwd(const void* x, const void* dy, const void* scale, void* dx,
                                  void* partial, int rows, int d, float eps, int blocks,
                                  int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  if (is_bf16) return launch_bwd<__nv_bfloat16>(x, dy, scale, dx, p, rows, d, eps, blocks, s);
  return launch_bwd<float>(x, dy, scale, dx, p, rows, d, eps, blocks, s);
}

// dscale (d,) in scale's type = the sum over the first `blocks` rows of
// partial (blocks, d) fp32, in a fixed order.
extern "C" int repro_rms_dscale_sum(const void* partial, void* dscale, int blocks, int d,
                                    int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks <= 0 || d <= 0 || d % 4 != 0) return -1;
  const float* p = static_cast<const float*>(partial);
  const dim3 grid((d + 127) / 128);
  if (is_bf16)
    rms_dscale_sum_kernel<__nv_bfloat16><<<grid, SUM_WARPS * 32, 0, s>>>(
        p, static_cast<__nv_bfloat16*>(dscale), blocks, d);
  else
    rms_dscale_sum_kernel<float><<<grid, SUM_WARPS * 32, 0, s>>>(
        p, static_cast<float*>(dscale), blocks, d);
  return (int)cudaGetLastError();
}

// The empty kernel on `stream`: the launch floor of this route.
extern "C" int repro_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
