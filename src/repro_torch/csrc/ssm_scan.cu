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
// `_kernel`).  What changed on the way, for both instances:
//   * The TPU grid's second dimension runs in order and carries the state
//     in VMEM scratch; here it is a loop over the chunks inside the block,
//     the state in shared memory.  One block for each (head, batch).
//   * x (B, S, H, P) and B, C (B, S, N) are read at their own batch and
//     sequence strides: in `mamba2_block` they are column slices of one
//     conv output, and the TPU wrapper's transposed copies are not made.
//   * -exp(A_log) and D are computed per head here, not tiled per batch by
//     the wrapper.
//   * The cumulative sum is one thread's loop, in the plain version's
//     order: exp(cum_i - cum_j) cancels two running sums of up to ~50, and
//     a scan in another order moves y by some 1e-5 of itself.
//
// Bound: at zamba2-7b's training shape (B 2, S 4096, H 112, P 64, N 64,
// chunk 64, bf16) by bytes: x read and y written once (235 MB), B, C, dt
// and the state 9.4 MB, 0.073 ms at 3.35 TB/s; the four 64x64x64 products
// of each of the 14,336 (b, h, chunk) steps are 3.0e10 operations, 0.030
// ms at the bf16 tensor-core peak, 0.45 ms on the fp32 cores.
//
// bf16 (`ssm_scan_bf16_kernel`): the four products of a chunk on the tensor
// cores with mma.sync, 8 warps each owning a 16 x 32 slice of every 64 x 64
// output (16 accumulator registers a product).  What each product reads:
//   * G = C B^T: m16n8k16 bf16, C and B as loaded (ldmatrix); exact products.
//   * W x, with W = G exp(cum_i - cum_j) dt_j (j <= i) in shared memory as
//     fp32: m16n8k8 tf32, W split into hi + lo tf32 and x exact (a bf16 is
//     a tf32), two products; the k-steps above the diagonal are skipped.
//   * C S^T: tf32, C exact, the fp32 state split into hi + lo.
//   * the state update x^T (wl B), wl_j = exp(cum_L - cum_j) dt_j: tf32, x
//     exact, wl B split into hi + lo.
// Cut once to tf32, W, S and wl B move y beyond the bf16 allowance (1.4
// times it in tests/test_torch_ssm.py's CPU emulation at the training
// shape's P, N and chunk), hence the split: hi + lo keeps about 21 bits,
// split by masks rather than cvt.rna (see mma.cuh).  Every tile is 64 x 64
// in shared memory; a chunk, P or N below 64 is zero-padded there, so every
// shape takes the same products.  A two-stage cp.async ring loads the next
// chunk's x, B, C (bf16 as they are, rows padded by 16 bytes against bank
// conflicts) and dt while this chunk computes; strides or a P / N that are
// no multiple of 8 bf16 take plain loads instead.  91 KB of shared memory
// and at most 128 registers a thread let two blocks share an SM, so the 224
// (b, h) blocks of the training shape run in one wave.  What holds it back
// now: a block walks its 64 chunks in order, four barriers a chunk, and
// within a chunk each warp's products wait on their own loads and mma
// latencies (16 warps an SM hide little of it); 224 blocks fill 85 % of the
// 264 slots. Splitting the sequence over blocks is the next step.
//
// fp32 (`ssm_scan_kernel`): held to the 2e-5 checks on the fp32 cores.  One
// chunk's x, B, C and dt staged in shared memory (scalar loads, coalesced
// along P and N), a 16 x 16 grid of threads each owning a 4 x 4 tile of
// the product (rows ty + 16 r, columns tx + 16 q, so that a warp reads
// neighbouring columns), with the rows of B, C and the state padded by one
// float against bank conflicts.

#include "common.cuh"
#include "mma.cuh"

namespace {

// ------------------------------------------------------------- fp32 path --
constexpr int TG = 16;             // threads along each side of the thread grid
constexpr int THREADS = TG * TG;
constexpr int MT = 4;              // a thread's tile: MT x MT
constexpr int MAXD = TG * MT;      // chunk, P and N at most 64

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

__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                const float* __restrict__ cm, const float* __restrict__ dt,
                const float* __restrict__ a_log, const float* __restrict__ d_skip,
                float* __restrict__ y, float* __restrict__ state_out, int S, int H, int P,
                int N, int L, long long x_sb, long long x_ss, long long b_sb, long long b_ss,
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

  const float* xb = x + b * x_sb + (long long)h * P;
  const float* bb = bm + b * b_sb;
  const float* cb = cm + b * c_sb;
  const float* dtb = dt + (size_t)b * S * H + h;
  const size_t y_row = (size_t)H * P;
  float* yb = y + (size_t)b * S * y_row + (size_t)h * P;

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
      xs[e] = xb[(c0 + i) * x_ss + p];
    }
    for (int e = tid; e < L * N; e += THREADS) {
      const int i = e / N, n = e % N;
      bs[i * ldn + n] = bb[(c0 + i) * b_ss + n];
      cs[i * ldn + n] = cb[(c0 + i) * c_ss + n];
    }
    if (tid < L) dts[tid] = dtb[(size_t)(c0 + tid) * H];
    __syncthreads();

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
          if (li_ok[r] && pj_ok[q])
            yb[(size_t)(c0 + i) * y_row + p] =
                yi[r][q] + ecum[i] * ys[r][q] + Dh * xs[i * P + p];
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

size_t smem_bytes_f32(int L, int P, int N) {
  return sizeof(float) * ((size_t)L * P + 2 * (size_t)L * (N + 1) + (size_t)P * (N + 1) +
                          (size_t)L * (L + 1) + 4 * (size_t)L);
}

// ------------------------------------------------------------- bf16 path --
constexpr int TC_THREADS = 256;    // 8 warps: 4 row slices of 16 x 2 column slices of 32
constexpr int T = 64;              // every tile is T x T in shared memory
constexpr int LDH = T + 8;         // row stride (bf16) of the x, B and C tiles
constexpr int LDF = T + 4;         // row stride (fp32) of W and the state

struct ScanSmem {
  uint16_t x[2][T * LDH];     // bf16 bits, [i][p], two stages
  uint16_t bm[2][T * LDH];    // [i][n]
  uint16_t cm[2][T * LDH];    // [i][n]
  float dt[2][T];
  float st[T * LDF];          // the carried state [p][n]
  float w[T * LDF];           // W [i][j]
  float cum[T], ecum[T], wl[T];
  float decay_end;
};

__device__ __forceinline__ float bf16_to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

__device__ __forceinline__ uint16_t f32_to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Chunk rows [c0, c0 + L) of x, B, C and dt into stage sg, zero-filled past
// L, P and N.  With `vec` (P and N multiples of 8, strides and bases
// 16-byte aligned) by cp.async; otherwise by plain loads.
__device__ __forceinline__ void load_chunk(ScanSmem& sm, int sg, const uint16_t* xb,
                                           const uint16_t* bb, const uint16_t* cb,
                                           const float* dtb, int c0, int L, int P, int N,
                                           int H, long long x_ss, long long b_ss,
                                           long long c_ss, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int k = 0; k < T * T / 8 / TC_THREADS; ++k) {
      const int e = tid + k * TC_THREADS;
      const int r = e / 8, c = (e % 8) * 8;
      const bool okx = r < L && c < P, okn = r < L && c < N;
      repro::cp_async16(&sm.x[sg][r * LDH + c], okx ? xb + (c0 + r) * x_ss + c : xb, okx);
      repro::cp_async16(&sm.bm[sg][r * LDH + c], okn ? bb + (c0 + r) * b_ss + c : bb, okn);
      repro::cp_async16(&sm.cm[sg][r * LDH + c], okn ? cb + (c0 + r) * c_ss + c : cb, okn);
    }
  } else {
    for (int e = tid; e < T * T; e += TC_THREADS) {
      const int r = e / T, c = e % T;
      sm.x[sg][r * LDH + c] = r < L && c < P ? xb[(c0 + r) * x_ss + c] : 0;
      sm.bm[sg][r * LDH + c] = r < L && c < N ? bb[(c0 + r) * b_ss + c] : 0;
      sm.cm[sg][r * LDH + c] = r < L && c < N ? cb[(c0 + r) * c_ss + c] : 0;
    }
  }
  if (tid < T) repro::cp_async4(&sm.dt[sg][tid], tid < L ? dtb + (size_t)(c0 + tid) * H : dtb,
                                tid < L);
}

__global__ void __launch_bounds__(TC_THREADS, 2)
ssm_scan_bf16_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ bm,
                     const uint16_t* __restrict__ cm, const float* __restrict__ dt,
                     const float* __restrict__ a_log, const float* __restrict__ d_skip,
                     uint16_t* __restrict__ y, float* __restrict__ state_out, int S, int H,
                     int P, int N, int L, long long x_sb, long long x_ss, long long b_sb,
                     long long b_ss, long long c_sb, long long c_ss, int vec) {
  extern __shared__ __align__(16) unsigned char scan_smem[];
  ScanSmem& sm = *reinterpret_cast<ScanSmem*>(scan_smem);

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int mr = 16 * (warp & 3), nc = 32 * (warp >> 2);   // the warp's rows and columns
  const float A = -expf(a_log[h]);
  const float Dh = d_skip[h];

  const uint16_t* xb = x + b * x_sb + (long long)h * P;
  const uint16_t* bb = bm + b * b_sb;
  const uint16_t* cb = cm + b * c_sb;
  const float* dtb = dt + (size_t)b * S * H + h;
  const size_t y_row = (size_t)H * P;
  uint16_t* yb = y + (size_t)b * S * y_row + (size_t)h * P;

  for (int e = tid; e < T * LDF; e += TC_THREADS) sm.st[e] = 0.f;
  const int n_chunks = S / L;
  load_chunk(sm, 0, xb, bb, cb, dtb, 0, L, P, N, H, x_ss, b_ss, c_ss, vec);
  repro::cp_async_commit();

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int sg = ch & 1, c0 = ch * L;
    repro::cp_async_wait<0>();
    __syncthreads();   // chunk ch is in; chunk ch - 1 is done with every buffer
    if (ch + 1 < n_chunks)
      load_chunk(sm, sg ^ 1, xb, bb, cb, dtb, c0 + L, L, P, N, H, x_ss, b_ss, c_ss, vec);
    repro::cp_async_commit();
    const uint16_t* xs = sm.x[sg];
    const uint16_t* bs = sm.bm[sg];
    const uint16_t* cs = sm.cm[sg];
    const float* dts = sm.dt[sg];

    // cum: A dt added in order by one thread (dt is 0 past L, so the padded
    // steps repeat cum_{L-1}); product and sum each rounded, as the plain
    // version's.
    if (tid == 0) {
      float run = 0.f;
#pragma unroll
      for (int i = 0; i < T; ++i) {
        run = __fadd_rn(run, __fmul_rn(A, dts[i]));
        sm.cum[i] = run;
      }
    }

    // G = C B^T, the warp's 16 x 32 slice (rows i, columns j).
    float acc[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
      uint32_t a[4];
      repro::ldmatrix_x4(a, cs + (mr + (lane & 15)) * LDH + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        repro::ldmatrix_x4(bf, bs + (nc + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDH +
                                   kk * 16 + ((lane >> 3) & 1) * 8);
        repro::mma_bf16_16816(acc[2 * np], a, bf[0], bf[1]);
        repro::mma_bf16_16816(acc[2 * np + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();   // cum is written

    if (tid < T) {
      const float cl = sm.cum[L - 1];
      sm.ecum[tid] = expf(sm.cum[tid]);
      sm.wl[tid] = expf(cl - sm.cum[tid]) * dts[tid];
      if (tid == 0) sm.decay_end = expf(cl);
    }
    // W = G exp(cum_i - cum_j) dt_j where j <= i, else 0.
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = mr + g + 8 * r, j = nc + 8 * q + 2 * t;
        const float ci = sm.cum[i];
        const float w0 = j <= i ? acc[q][2 * r] * (expf(ci - sm.cum[j]) * dts[j]) : 0.f;
        const float w1 = j + 1 <= i ? acc[q][2 * r + 1] * (expf(ci - sm.cum[j + 1]) * dts[j + 1])
                                    : 0.f;
        *reinterpret_cast<float2*>(&sm.w[i * LDF + j]) = make_float2(w0, w1);
      }
    __syncthreads();   // W, ecum, wl and decay_end are written

    // y = exp(cum_i) (C S^T) + W x + D x: the warp's rows i, columns p, in
    // one set of accumulators (C S^T first, scaled by exp(cum_i), then W x).
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
#pragma unroll 2   // fully unrolled, the loads run ahead and spill past 128 registers
    for (int k0 = 0; k0 < T; k0 += 8) {
      uint32_t ca[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ca[e] = repro::bf16_bits_to_tf32(cs[(mr + g + 8 * (e & 1)) * LDH + k0 + t + 4 * (e >> 1)]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = nc + 8 * q + g;
        uint32_t s0h, s0l, s1h, s1l;
        repro::split_tf32(sm.st[p * LDF + k0 + t], s0h, s0l);
        repro::split_tf32(sm.st[p * LDF + k0 + t + 4], s1h, s1l);
        repro::mma_tf32_1688(acc[q], ca, s0l, s1l);
        repro::mma_tf32_1688(acc[q], ca, s0h, s1h);
      }
    }
    const float ec[2] = {sm.ecum[mr + g], sm.ecum[mr + g + 8]};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] *= ec[e >> 1];
    // W is lower triangular: the warp's rows i < mr + 16 see no j past them.
#pragma unroll 2   // fully unrolled, the loads run ahead and spill past 128 registers
    for (int k0 = 0; k0 < mr + 16; k0 += 8) {
      uint32_t whi[4], wlo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        repro::split_tf32(sm.w[(mr + g + 8 * (e & 1)) * LDF + k0 + t + 4 * (e >> 1)], whi[e],
                          wlo[e]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = nc + 8 * q + g;
        const uint32_t x0 = repro::bf16_bits_to_tf32(xs[(k0 + t) * LDH + p]);
        const uint32_t x1 = repro::bf16_bits_to_tf32(xs[(k0 + t + 4) * LDH + p]);
        repro::mma_tf32_1688(acc[q], wlo, x0, x1);
        repro::mma_tf32_1688(acc[q], whi, x0, x1);
      }
    }
    const bool pairs = (P & 1) == 0;   // y's rows start on 4-byte boundaries
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = mr + g + 8 * r, p = nc + 8 * q + 2 * t;
        if (i >= L || p >= P) continue;
        const float v0 = acc[q][2 * r] + Dh * bf16_to_f32(xs[i * LDH + p]);
        const float v1 = acc[q][2 * r + 1] + Dh * bf16_to_f32(xs[i * LDH + p + 1]);
        uint16_t* dst = yb + (size_t)(c0 + i) * y_row + p;
        if (pairs) {
          *reinterpret_cast<uint32_t*>(dst) = repro::pack_bf16x2(v0, v1);
        } else {
          dst[0] = f32_to_bf16(v0);
          if (p + 1 < P) dst[1] = f32_to_bf16(v1);
        }
      }

    // dS = x^T (wl B): the warp's rows p, columns n.
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
#pragma unroll 2   // fully unrolled, the loads run ahead and spill past 128 registers
    for (int k0 = 0; k0 < T; k0 += 8) {
      uint32_t xa[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xa[e] = repro::bf16_bits_to_tf32(
            xs[(k0 + t + 4 * (e >> 1)) * LDH + mr + g + 8 * (e & 1)]);
      const float wl0 = sm.wl[k0 + t], wl1 = sm.wl[k0 + t + 4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = nc + 8 * q + g;
        uint32_t b0h, b0l, b1h, b1l;
        repro::split_tf32(wl0 * bf16_to_f32(bs[(k0 + t) * LDH + n]), b0h, b0l);
        repro::split_tf32(wl1 * bf16_to_f32(bs[(k0 + t + 4) * LDH + n]), b1h, b1l);
        repro::mma_tf32_1688(acc[q], xa, b0l, b1l);
        repro::mma_tf32_1688(acc[q], xa, b0h, b1h);
      }
    }
    __syncthreads();   // every warp has read the old state
    const float dec = sm.decay_end;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2* s = reinterpret_cast<float2*>(&sm.st[(mr + g + 8 * r) * LDF + nc + 8 * q + 2 * t]);
        const float2 old = *s;
        *s = make_float2(dec * old.x + acc[q][2 * r], dec * old.y + acc[q][2 * r + 1]);
      }
  }
  __syncthreads();
  float* so = state_out + ((size_t)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += TC_THREADS) so[e] = sm.st[(e / N) * LDF + e % N];
}

int launch_f32(const void* x, const void* bm, const void* cm, const void* dt,
               const void* a_log, const void* d, void* y, void* state, int B, int S, int H,
               int P, int N, int L, long long x_sb, long long x_ss, long long b_sb,
               long long b_ss, long long c_sb, long long c_ss, cudaStream_t stream) {
  const size_t smem = smem_bytes_f32(L, P, N);
  cudaError_t err = cudaFuncSetAttribute(ssm_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssm_scan_kernel<<<dim3(H, B), THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const float*>(d), static_cast<float*>(y),
      static_cast<float*>(state), S, H, P, N, L, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* x, const void* bm, const void* cm, const void* dt,
                const void* a_log, const void* d, void* y, void* state, int B, int S, int H,
                int P, int N, int L, long long x_sb, long long x_ss, long long b_sb,
                long long b_ss, long long c_sb, long long c_ss, cudaStream_t stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = P % 8 == 0 && N % 8 == 0 && x_sb % 8 == 0 && x_ss % 8 == 0 &&
                   b_sb % 8 == 0 && b_ss % 8 == 0 && c_sb % 8 == 0 && c_ss % 8 == 0 &&
                   aligned(x) && aligned(bm) && aligned(cm);
  constexpr size_t smem = sizeof(ScanSmem);
  cudaError_t err = cudaFuncSetAttribute(ssm_scan_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssm_scan_bf16_kernel<<<dim3(H, B), TC_THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(bm),
      static_cast<const uint16_t*>(cm), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const float*>(d), static_cast<uint16_t*>(y),
      static_cast<float*>(state), S, H, P, N, L, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, (int)vec);
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
    return launch_bf16(x, bm, cm, dt, a_log, d, y, state, B, S, H, P, N, chunk, x_sb, x_ss,
                       b_sb, b_ss, c_sb, c_ss, s);
  return launch_f32(x, bm, cm, dt, a_log, d, y, state, B, S, H, P, N, chunk, x_sb, x_ss, b_sb,
                    b_ss, c_sb, c_ss, s);
}
