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
//     in VMEM scratch.  fp32: a loop over the chunks inside the block, the
//     state in shared memory, one block for each (head, batch).  bf16: the
//     sequence split over blocks, the state carried between them (below).
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
// bf16 (`ssm_scan_wgmma_kernel`), designed for Hopper.  Its predecessor
// (mma.sync, bf16 + tf32 hi + lo) took 0.625 ms at the training
// shape, 11.7 % of the bound, held back by its grid and by the work around
// its products: one block a (b, h), 224 blocks walking their 64 chunks in
// order (85 % of the 264 slots of two blocks an SM; 5.75 us a chunk on an
// SM, of which the tensor cores' share was about 0.75 us), one thread's
// 64-step cumulative sum with the other 255 waiting at a barrier, four
// barriers a chunk, W's 4,096 exp, and the fp32 operands read from shared
// memory and split into tf32 hi + lo anew by each warp that read them.
// What each part of this design does about that:
//   * The sequence split over blocks, with a look-back for the carried
//     state.  A block takes one segment of SEG chunks of one (b, h), so the
//     training shape runs 3,584 blocks.  Sweep 1 computes the segment's own
//     end state from a zero start, S_loc, and its decay dseg = prod of the
//     chunks' exp(cum_L).  The look-back then waits for segment k - 1's
//     inclusive state S_in (a fp32 scratch the wrapper allocates, two
//     slots a head) and publishes its own, dseg S_in + S_loc: the state
//     written and fenced, then a flag stored with release semantics, read
//     with acquire semantics.  Segment k always combines with segment
//     k - 1's state, so the result does not depend on timing (the recompute
//     under remat gives the forward's y bit for bit).  Sweep 2 recomputes
//     each chunk's y from the true start state.  Blocks take their segment
//     from an atomic ticket in the order (segment, head), so a block waits
//     only on blocks that started before it, and every wait ends in a trap
//     after a bounded number of polls instead of hanging the card.  The
//     call's last block to finish sets the ticket, the flags and its count
//     of finished blocks back to zero, so the wrapper keeps the counters
//     from call to call and launches no zeroing.  One launch; sweep 2
//     re-reads its segment, from L2.
//   * The products on wgmma, from TMA loads.  A chunk is 64 rows, one
//     warpgroup's M: a block is one warpgroup, three blocks an SM (168
//     registers a thread, 72 KB of shared memory).  x (as a 4-D map over
//     (P, H, S, B), so its batch and sequence strides are the conv
//     output's), B and C (3-D maps over (N, S, B)) arrive by TMA into a
//     ring of STAGES stages, 128-byte swizzled, rows past the chunk and
//     columns past P and N zero; lane 0 of three warps each issue one tile
//     (an issue takes its thread some hundreds of cycles), sweep 2's while
//     its first products run.  Per chunk: G = C B^T and C S^T with C read
//     once into registers (ldmatrix) as A, B and the state's tiles K-major;
//     then W x and the state update with A from registers (B MN-major,
//     transposed by wgmma).  The state lives in the warpgroup's
//     accumulator registers, scaled by the chunk's decay and accumulated
//     into; its split is written to two shared tiles for C S^T.  W x and
//     the update are issued one after the other, so that W's and
//     (wl x)^T's splits are not live together.  ptxas serializes every
//     wgmma of the kernel where it runs short of registers for the wgmma
//     pipeline or finds a wgmma under a branch (sweep 2's step is
//     straight-line code in two instances, with and without the update),
//     and at 168 registers a thread small changes tip it either way:
//     `chip_smoke.py`'s build fails on it.  y + D x (D x in fp32 after the
//     products, in the plain version's order) is staged in the chunk's C
//     tile (its products are done), each warp its own rows, and written
//     whole rows a warp.
//   * The fp32 operands in two bf16 parts.  W (after the exp), the state
//     and (wl x)^T are each split into bf16 hi + lo (about 16 of 24 bits)
//     and multiplied with exact bf16 x, C and B, two products each at the
//     bf16 rate: one rounding misses the allowance, even of the state alone
//     (tests/test_torch_ssm.py), and tf32 hi + lo would cost twice as much
//     and need K-major x and B.
//   * The cumulative sums, in the plain version's order (product and sum
//     each rounded), are the loops of the segment's chunks, one thread
//     each, all at once.  W's exp(cum_i - cum_j) is exp(cum_i) exp(-cum_j)
//     from the segment's tables where the chunk's decay keeps both factors
//     in fp32's normal range (MILD), else one ex2 a value on the
//     special-function unit.  Three barriers a chunk.
// Where TMA cannot take a stride, an alignment or a width (P or N no
// multiple of 8), the same kernel loads its tiles by plain loads into the
// same swizzled layout and writes y from its registers.  Per chunk it runs
// 8.5 products of 64 x 64 x 64 on average (sweep 1: the update; sweep 2: G,
// C S^T, W x and, but for the last chunk, the update; each but G in two
// parts), 2.1 times the four the bound counts.  What holds it back now
// (tools/ssm_scan_phases.py: clock64 stamps on the card, three blocks an
// SM): a segment takes about 41,000 cycles, 13 % of them its setup (the
// dt loads' latency), 20 % sweep 1, 10 % the look-back and publish, 56 %
// sweep 2; each chunk of sweep 2 is a chain of waits (wgmma bursts of three
// blocks queueing on the tensor cores, a TMA issue, barriers, shared-memory
// latency) with the tensor cores busy about a third of the time.  Tried
// and dropped: persistent blocks that fetch the next ticket and dt early
// (700 bytes of spills, slower), stmatrix for the state tiles and y
// (spills), D folded into W's diagonal (as close to float64 and as fast, but
// zamba2's fp32 check moved past its margin: rounding noise, PERF.md).
//
// fp32 (`ssm_scan_kernel`): held to the 2e-5 checks on the fp32 cores.  One
// chunk's x, B, C and dt staged in shared memory (scalar loads, coalesced
// along P and N), a 16 x 16 grid of threads each owning a 4 x 4 tile of
// the product (rows ty + 16 r, columns tx + 16 q, so that a warp reads
// neighbouring columns), with the rows of B, C and the state padded by one
// float against bank conflicts.

#include "common.cuh"
#include "hopper.cuh"
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
constexpr int WG = 128;                // a block: one warpgroup
constexpr int T = 64;                  // every tile is 64 rows of 64 bf16 (128 bytes)
constexpr int TILE = T * 128;          // bytes of a tile
constexpr int STAGES = 2;              // the ring of x, B and C tiles
constexpr int STAGE_BYTES = 3 * TILE;
constexpr int SEG = 4;                 // chunks a segment
constexpr int ACC = 32;                // fp32 accumulators a thread holds of a 64 x 64 product
constexpr long long MAX_POLLS = 1ll << 22;   // then the look-back traps (seconds)

// A chunk whose cumulative sum stays above this (its decay at least
// exp(MILD)) takes W's exp(cum_i - cum_j) as exp(cum_i) exp(-cum_j), neither
// factor past fp32's normal range.
constexpr float MILD = -80.f;

// What the block keeps beside its tiles: the segment's dt and cumulative
// sums, exp(cum), wl_j = exp(cum_L - cum_j) dt_j, rw_j = exp(-cum_j) dt_j
// (where the chunk is mild) and each chunk's decay.
struct ScanAux {
  float dt[SEG][T], cum[SEG][T], ecum[SEG][T], wl[SEG][T], rw[SEG][T];
  float dec[SEG];
  uint64_t full[STAGES];   // TMA has landed stage s
  int ticket;
};

constexpr size_t SCAN_SMEM = 1024 + STAGES * STAGE_BYTES + 2 * TILE + sizeof(ScanAux);
static_assert(SCAN_SMEM <= 232448 / 3, "three blocks an SM");

// Byte offset of 16-byte piece c of row r in a 128-byte-swizzled tile.
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }


__device__ __forceinline__ uint16_t f32_to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// exp(x) as 2^(x log2 e) on the special-function unit (ex2.approx, about
// 2^-22 relative): W's 32 a thread a chunk, whose two bf16 parts keep 16
// bits.
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// rows x cols of a (rows, stride) bf16 matrix into a tile, zeros past them;
// the plain-load route.
__device__ __forceinline__ void load_tile(unsigned char* tile, const uint16_t* src,
                                          long long stride, int rows, int cols) {
  for (int e = threadIdx.x; e < T * T; e += WG) {
    const int r = e / T, c = e % T;
    *reinterpret_cast<uint16_t*>(tile + swz(r, c >> 3) + (c & 7) * 2) =
        r < rows && c < cols ? src[r * stride + c] : 0;
  }
}

// Where a block is and what it reads.
struct Seg {
  int b, h, first, n;   // batch, head, first chunk, chunks
};

// The loads of one block, items q = 0 .. 2n - 1: sweep 1 reads chunk q's x
// and B, sweep 2 chunk q - n's x, B and C; item q in stage q % STAGES.
struct Loader {
  const CUtensorMap *tx, *tb, *tc;
  const uint16_t *x, *bm, *cm;
  long long x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;
  int L, P, N;
  bool tma;
  unsigned char* ring;
  uint64_t* full;
  Seg sg;

  __device__ __forceinline__ unsigned char* stage(int q) const {
    return ring + (q % STAGES) * STAGE_BYTES;
  }
  __device__ __forceinline__ int row0(int q) const { return (sg.first + q % sg.n) * L; }

  // TMA route: item q's tiles into its stage (free: the item STAGES before
  // it is done), one tile from lane 0 of each of the first three warps, whose
  // issue takes some hundreds of cycles each.  Warp 0 announces the bytes;
  // a tile that lands first takes the count below zero, which the mbarrier
  // allows, and the phase completes only once all have landed.
  __device__ __forceinline__ void issue(int q) const {
    const int warp = threadIdx.x / 32;
    if (!tma || q >= 2 * sg.n || threadIdx.x % 32 != 0 || warp > 2) return;
    const bool with_c = q >= sg.n;
    unsigned char* st = stage(q);
    uint64_t* bar = &full[q % STAGES];
    if (warp == 0) {
      repro::mbar_arrive_expect_tx(bar, (with_c ? 3 : 2) * L * 128);
      repro::tma_load_4d(st, tx, bar, 0, sg.h, row0(q), sg.b);
    } else if (warp == 1) {
      repro::tma_load_3d(st + TILE, tb, bar, 0, row0(q), sg.b);
    } else if (with_c) {
      repro::tma_load_3d(st + 2 * TILE, tc, bar, 0, row0(q), sg.b);
    }
  }

  // Item q's tiles are in its stage, for every thread and for wgmma.
  __device__ __forceinline__ void wait(int q) const {
    if (tma) {
      // bounded, as the look-back's waits are: a fault traps, not hangs
      for (long long polls = 0; !repro::mbar_try_wait(&full[q % STAGES], (q / STAGES) & 1);
           ++polls)
        if (polls > MAX_POLLS) __trap();
      return;
    }
    unsigned char* st = stage(q);
    const long long r0 = row0(q);
    load_tile(st, x + sg.b * x_sb + r0 * x_ss + (long long)sg.h * P, x_ss, L, P);
    load_tile(st + TILE, bm + sg.b * b_sb + r0 * b_ss, b_ss, L, N);
    if (q >= sg.n) load_tile(st + 2 * TILE, cm + sg.b * c_sb + r0 * c_ss, c_ss, L, N);
    repro::fence_proxy_async();
    __syncthreads();
  }
};

__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile) {
  return repro::wgmma_desc(repro::opaque(repro::smem_addr(tile)), 16, 1024);
}

__device__ __forceinline__ uint64_t mnmajor(const unsigned char* tile) {
  return repro::wgmma_desc(repro::opaque(repro::smem_addr(tile)), TILE, 1024);
}

// An A operand from registers, split into bf16 hi ([0]) and lo ([1]): the
// four k-steps of 16 of a 64-deep product.
using Split = uint32_t[2][4][4];

// acc (the accumulator layout, 64 x 64 fp32) into the A operands of a
// product over its columns, each value split into bf16 hi + lo: the C
// layout of the n8 tiles 2kk and 2kk + 1 is the A layout of k-step kk.
__device__ __forceinline__ void split_acc(const float (&acc)[ACC], Split& a) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* v = acc + 4 * (2 * kk + (e >> 1)) + 2 * (e & 1);
      repro::split_bf16x2(v[0], v[1], a[0][kk][e], a[1][kk][e]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) repro::fence_regs(a[h][kk]);
}

// (wl x)^T, rows p and columns j, as the A operands of the state update:
// x's tile read transposed (ldmatrix.trans), scaled by wl_j, split.
__device__ __forceinline__ void split_xt(const unsigned char* xt, const float* wl, Split& a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const int m = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t r[4];
    const int j = 16 * kk + 8 * (m >> 1) + (lane & 7);
    repro::ldmatrix_x4_trans(r, xt + swz(j, 2 * warp + (m & 1)));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j0 = 16 * kk + 8 * (e >> 1) + 2 * t;
      repro::split_bf16x2(__uint_as_float(r[e] << 16) * wl[j0],
                          __uint_as_float(r[e] & 0xffff0000u) * wl[j0 + 1], a[0][kk][e],
                          a[1][kk][e]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) repro::fence_regs(a[h][kk]);
}

// d += a b over 64, a split (lo first), b a tile read MN-major.
__device__ __forceinline__ void product_rs(float (&d)[ACC], const Split& a, uint64_t bd) {
#pragma unroll
  for (int h = 1; h >= 0; --h)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) repro::wgmma_rs_tn(d, a[h][kk], bd + ((kk * 16 * 128) >> 4));
}

// d (=|+=) a b^T over 64, a from registers (`load_a`), b a tile read K-major.
__device__ __forceinline__ void product_rk(float (&d)[ACC], const uint32_t (&a)[4][4], uint64_t bd,
                                           bool acc) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) repro::wgmma_rs(d, a[kk], bd + 2 * kk, acc || kk > 0);
}

// A tile (rows i, 64 bf16 columns) as the A operands of the four k-steps of
// a product over its columns (ldmatrix), bf16 as it is.
__device__ __forceinline__ void load_a(const unsigned char* tile, uint32_t (&a)[4][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, m = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    repro::ldmatrix_x4(a[kk], tile + swz(16 * warp + 8 * (m & 1) + (lane & 7), 2 * kk + (m >> 1)));
}

// The state's split into its two shared tiles (rows p, columns n), for C S^T.
__device__ __forceinline__ void store_state(const float (&s)[ACC], unsigned char* hi,
                                            unsigned char* lo) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int off = swz(16 * warp + g + 8 * r, j) + 4 * t;
      uint32_t h, l;
      repro::split_bf16x2(s[4 * j + 2 * r], s[4 * j + 2 * r + 1], h, l);
      *reinterpret_cast<uint32_t*>(hi + off) = h;
      *reinterpret_cast<uint32_t*>(lo + off) = l;
    }
  repro::fence_proxy_async();
}

// What sweep 2 reads for one chunk, and where its y goes.
struct ChunkIn {
  const unsigned char *st, *s_hi;                  // the stage (x, B, C); the state's tiles
  const ScanAux* ax;                               // the segment's tables, chunk c's
  int c;
  float Dh;
  uint16_t* y;                                     // the chunk's first row, this head
  int y_row, L, P;
  bool staged;                                     // y's rows 16-byte aligned
  const Loader* ld;                                // and the item it loads meanwhile
  int next;
};

// One chunk of sweep 2: y = exp(cum_i) (C S^T) + W x + D x, in bf16; with
// UPDATE, also S <- dec S + (wl x)^T B.  Straight-line code in both
// instances: a wgmma under a branch makes ptxas serialize every wgmma of
// the kernel.
template <bool UPDATE>
__device__ __forceinline__ void chunk_y(float (&s)[ACC], const ChunkIn& in) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int i0 = 16 * warp + g;       // the thread's rows i0 and i0 + 8

  // G = C B^T and C S^T (lo first), issued together, C from registers (read
  // from shared memory once rather than three times).
  float gw[ACC], yy[ACC];
  uint32_t ca[4][4];
  load_a(in.st + 2 * TILE, ca);
  repro::wgmma_fence();
  product_rk(gw, ca, kmajor(in.st + TILE), false);
  repro::wgmma_commit();
  product_rk(yy, ca, kmajor(in.s_hi + TILE), false);
  product_rk(yy, ca, kmajor(in.s_hi), true);
  repro::wgmma_commit();
  // The next item's TMA loads, issued while the products run: their issue
  // takes its thread some hundreds of cycles.
  in.ld->issue(in.next);
  repro::wgmma_wait<1>();
  repro::fence_regs(gw);

  // W = G exp(cum_i - cum_j) dt_j where j <= i, else 0; split.  A mild
  // chunk (the usual one) factors the exp: no exp a value.  (The `+ 0.f`
  // changes no value that reaches y, but without it ptxas, at 168
  // registers a thread, allocates this step so that it serializes every
  // wgmma of the kernel; `chip_smoke.py`'s build fails on that.)
  const float* cum = in.ax->cum[in.c];
  const float ec[2] = {in.ax->ecum[in.c][i0], in.ax->ecum[in.c][i0 + 8]};
  if (cum[T - 1] > MILD) {
    const float* rw = in.ax->rw[in.c];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 8 * (e >> 1), jj = 8 * j + 2 * t + (e & 1);
        gw[4 * j + e] = (jj <= i ? gw[4 * j + e] * (ec[e >> 1] * rw[jj]) : 0.f) +
                        0.f;
      }
  } else {
    const float* dt = in.ax->dt[in.c];
    const float ci[2] = {cum[i0], cum[i0 + 8]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 8 * (e >> 1), jj = 8 * j + 2 * t + (e & 1);
        gw[4 * j + e] =
            (jj <= i ? gw[4 * j + e] * (exp_fast(ci[e >> 1] - cum[jj]) * dt[jj]) : 0.f) +
            0.f;
      }
  }
  Split wa, ua;
  split_acc(gw, wa);
  repro::wgmma_wait<0>();
  repro::fence_regs(yy);

  // y = exp(cum_i) (C S^T) + W x, then S <- dec S + (wl x)^T B: one after
  // the other, so that W's and (wl x)^T's splits are not live together.
#pragma unroll
  for (int e = 0; e < ACC; ++e) yy[e] *= ec[(e >> 1) & 1];
  repro::fence_regs(yy);
  repro::wgmma_fence();
  product_rs(yy, wa, mnmajor(in.st));
  repro::wgmma_commit();
  if (UPDATE) {
    split_xt(in.st, in.ax->wl[in.c], ua);
#pragma unroll
    for (int e = 0; e < ACC; ++e) s[e] *= in.ax->dec[in.c];
    repro::fence_regs(s);
  }
  repro::wgmma_wait<0>();
  repro::fence_regs(yy);
  if (UPDATE) {
    repro::wgmma_fence();
    product_rs(s, ua, mnmajor(in.st + TILE));
    repro::wgmma_commit();
    repro::wgmma_wait<0>();
    repro::fence_regs(s);
  }

  // y + D x (in fp32, after the products, in the plain version's order),
  // in bf16: staged in the C tile (its products are done), each
  // warp its own 16 rows, and written a 16-byte piece a lane, whole rows
  // a warp, where y's rows start on 16-byte boundaries (P a multiple of 8,
  // as the TMA route needs); else from the accumulators' layout.
  if (in.staged) {
    unsigned char* yt = const_cast<unsigned char*>(in.st) + 2 * TILE;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t xv = *reinterpret_cast<const uint32_t*>(in.st + swz(i0 + 8 * r, j) + 4 * t);
        *reinterpret_cast<uint32_t*>(yt + swz(i0 + 8 * r, j) + 4 * t) =
            repro::pack_bf16x2(yy[4 * j + 2 * r] + in.Dh * __uint_as_float(xv << 16),
                               yy[4 * j + 2 * r + 1] + in.Dh * __uint_as_float(xv & 0xffff0000u));
      }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 16 * 8 / 32; ++k) {
      const int e = lane + 32 * k, r = 16 * warp + e / 8, c = e % 8;
      if (r < in.L && 8 * c < in.P)
        repro::store16(in.y + r * in.y_row + 8 * c, repro::load16(yt + swz(r, c)));
    }
    repro::fence_proxy_async();   // before TMA writes the stage again
    return;
  }
  const bool pairs = (in.P & 1) == 0;   // y's rows start on 4-byte boundaries
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 8 * r, p = 8 * j + 2 * t;
      if (i >= in.L || p >= in.P) continue;
      const uint32_t xv = *reinterpret_cast<const uint32_t*>(in.st + swz(i, j) + 4 * t);
      const float v0 = yy[4 * j + 2 * r] + in.Dh * __uint_as_float(xv << 16);
      const float v1 = yy[4 * j + 2 * r + 1] + in.Dh * __uint_as_float(xv & 0xffff0000u);
      uint16_t* dst = in.y + i * in.y_row + p;
      if (pairs) {
        *reinterpret_cast<uint32_t*>(dst) = repro::pack_bf16x2(v0, v1);
      } else {
        dst[0] = f32_to_bf16(v0);
        if (p + 1 < in.P) dst[1] = f32_to_bf16(v1);
      }
    }
}

__global__ void __launch_bounds__(WG, 3)
ssm_scan_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tb,
                      const __grid_constant__ CUtensorMap tc, const uint16_t* __restrict__ x,
                      const uint16_t* __restrict__ bm, const uint16_t* __restrict__ cm,
                      const float* __restrict__ dt, const float* __restrict__ a_log,
                      const float* __restrict__ d_skip, uint16_t* __restrict__ y,
                      float* __restrict__ state_out, float* __restrict__ carry,
                      int* __restrict__ sync, int B, int S, int H, int P, int N, int L,
                      long long x_sb, long long x_ss, long long b_sb, long long b_ss,
                      long long c_sb, long long c_ss, int use_tma) {
  extern __shared__ unsigned char scan_smem_raw[];
  const uint32_t raw = repro::smem_addr(scan_smem_raw);
  unsigned char* ring = scan_smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* s_hi = ring + STAGES * STAGE_BYTES;
  unsigned char* s_lo = s_hi + TILE;
  ScanAux& ax = *reinterpret_cast<ScanAux*>(s_lo + TILE);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;

  if (tid == 0) {
    ax.ticket = atomicAdd(sync, 1);
    for (int s = 0; s < STAGES; ++s) repro::mbar_init(&ax.full[s], 1);
    repro::fence_barrier_init();
  }
  // TMA writes L rows of each tile: the rows past them stay zero.
  if (use_tma && L < T) {
    for (int e = tid; e < STAGES * STAGE_BYTES / 16; e += WG)
      reinterpret_cast<uint4*>(ring)[e] = make_uint4(0, 0, 0, 0);
    repro::fence_proxy_async();
  }
  __syncthreads();

  // The ticket's segment, in the order (segment, head).
  const int BH = B * H, nc = S / L, n_seg = (nc + SEG - 1) / SEG;
  const int seg = ax.ticket / BH, bh = ax.ticket % BH;
  Seg sg{bh / H, bh % H, seg * SEG, min(SEG, nc - seg * SEG)};
  const int n = sg.n;
  Loader ld{&tx, &tb, &tc, x, bm, cm, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, L, P, N,
            use_tma != 0, ring, ax.full, sg};
  if (use_tma && tid == 0) {
    repro::prefetch_tensor_map(&tx);
    repro::prefetch_tensor_map(&tb);
    repro::prefetch_tensor_map(&tc);
  }
  for (int q = 0; q < STAGES - 1; ++q) ld.issue(q);
  const float A = -expf(a_log[sg.h]);
  const float Dh = d_skip[sg.h];

  // The segment's dt (0 past L), each chunk's cum by one thread in the
  // plain version's order (product and sum each rounded), then the exps.
  for (int e = tid; e < n * T; e += WG) {
    const int c = e / T, i = e % T;
    ax.dt[c][i] = i < L ? dt[((size_t)sg.b * S + (size_t)(sg.first + c) * L + i) * H + sg.h]
                        : 0.f;
  }
  __syncthreads();
  if (tid < n) {
    float d[T];
#pragma unroll
    for (int k = 0; k < T / 4; ++k) {
      const float4 v = reinterpret_cast<const float4*>(ax.dt[tid])[k];
      d[4 * k] = v.x;
      d[4 * k + 1] = v.y;
      d[4 * k + 2] = v.z;
      d[4 * k + 3] = v.w;
    }
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < T; ++i) {
      run = __fadd_rn(run, __fmul_rn(A, d[i]));
      ax.cum[tid][i] = run;
    }
  }
  __syncthreads();
  for (int e = tid; e < n * T; e += WG) {
    const int c = e / T, i = e % T;
    const float cl = ax.cum[c][T - 1];    // cum_{L-1}: dt is 0 past L
    ax.ecum[c][i] = expf(ax.cum[c][i]);
    ax.wl[c][i] = expf(cl - ax.cum[c][i]) * ax.dt[c][i];
    ax.rw[c][i] = cl > MILD ? expf(-ax.cum[c][i]) * ax.dt[c][i] : 0.f;
    if (i == 0) ax.dec[c] = expf(cl);
  }
  __syncthreads();

  // Sweep 1: S_loc, the segment's end state from a zero start.
  float s[ACC];
#pragma unroll
  for (int e = 0; e < ACC; ++e) s[e] = 0.f;
  float dseg = 1.f;
  for (int c = 0; c < n; ++c) {
    ld.wait(c);
    ld.issue(c + STAGES - 1);
    const unsigned char* st = ld.stage(c);
    Split ua;
    split_xt(st, ax.wl[c], ua);
    const float dec = ax.dec[c];
#pragma unroll
    for (int e = 0; e < ACC; ++e) s[e] *= dec;
    dseg *= dec;
    repro::fence_regs(s);
    repro::wgmma_fence();
    product_rs(s, ua, mnmajor(st + TILE));
    repro::wgmma_commit();
    repro::wgmma_wait<0>();
    repro::fence_regs(s);
    __syncthreads();   // every thread is done with the stage
  }

  // The look-back: segment k - 1's inclusive state (0 before the first).
  float s_in[ACC];
  const size_t slot = (size_t)WG * ACC;
  if (seg > 0) {
    if (tid == 0) {
      const int* flag = sync + 1 + bh;
      for (long long polls = 0; ld_acquire(flag) < seg; ++polls) {
        if (polls > MAX_POLLS) __trap();
        __nanosleep(128);
      }
    }
    __syncthreads();
    const float4* src = reinterpret_cast<const float4*>(carry + (2 * (size_t)bh + (seg - 1) % 2) * slot);
#pragma unroll
    for (int k = 0; k < ACC / 4; ++k) {
      const float4 v = __ldcg(src + k * WG + tid);
      s_in[4 * k] = v.x;
      s_in[4 * k + 1] = v.y;
      s_in[4 * k + 2] = v.z;
      s_in[4 * k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < ACC; ++e) s_in[e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < ACC; ++e) s[e] = dseg * s_in[e] + s[e];
  if (seg + 1 < n_seg) {
    // Publish: the state, a barrier, then one thread fences and stores the
    // flag with release semantics.
    float4* dst = reinterpret_cast<float4*>(carry + (2 * (size_t)bh + seg % 2) * slot);
#pragma unroll
    for (int k = 0; k < ACC / 4; ++k)
      __stcg(dst + k * WG + tid, make_float4(s[4 * k], s[4 * k + 1], s[4 * k + 2], s[4 * k + 3]));
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      st_release(sync + 1 + bh, seg + 1);
    }
  } else {
    float* so = state_out + (size_t)bh * P * N;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 16 * warp + g + 8 * (e >> 1), nn = 8 * j + 2 * t + (e & 1);
        if (p < P && nn < N) so[p * N + nn] = s[4 * j + e];
      }
  }

  // Sweep 2: each chunk's y from its true start state, carried in s.
#pragma unroll
  for (int e = 0; e < ACC; ++e) s[e] = s_in[e];
  const size_t y_row = (size_t)H * P;
  uint16_t* yb = y + (size_t)sg.b * S * y_row + (size_t)sg.h * P;
  for (int c = 0; c < n; ++c) {
    const int q = n + c;
    store_state(s, s_hi, s_lo);
    __syncthreads();   // the state's tiles are written
    ld.wait(q);
    const ChunkIn in{ld.stage(q), s_hi, &ax, c, Dh, yb + (size_t)(sg.first + c) * L * y_row,
                     (int)y_row, L, P, ld.tma, &ld, q + STAGES - 1};
    if (c + 1 < n)
      chunk_y<true>(s, in);
    else
      chunk_y<false>(s, in);   // the segment's last chunk: no state to carry on
    __syncthreads();   // every thread is done with the stage and the state's tiles
  }

  // The call's last block leaves the counters zero for the next call.  B * H
  // is read from the parameters here (opaque): a register holding it from
  // the top of the kernel made ptxas spill 36 bytes and the kernel 3 %
  // slower (H100).
  if (threadIdx.x == 0) {
    const int bhs = (int)(repro::opaque((uint32_t)B) * repro::opaque((uint32_t)H));
    __threadfence();
    if (atomicAdd(sync + 1 + bhs, 1) == (int)gridDim.x - 1) {
      for (int e = 0; e < 2 + bhs; ++e) sync[e] = 0;
      __threadfence();
    }
  }
}

// The map of a bf16 matrix read in boxes of 64 columns x `rows` rows,
// 128-byte swizzled; dims and byte strides (all but the innermost), `rank`
// of them; false on failure.
bool bf16_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  const repro::EncodeTiled encode = repro::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
                const void* a_log, const void* d, void* y, void* state, void* carry,
                void* sync, int B, int S, int H, int P, int N, int L, long long x_sb,
                long long x_ss, long long b_sb, long long b_ss, long long c_sb, long long c_ss,
                cudaStream_t stream) {
  const long long blocks = (long long)B * H * ((S / L + SEG - 1) / SEG);
  if (blocks > 0x7fffffffll) return -1;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  // TMA: byte strides multiples of 16 (x's head stride is P), bases aligned.
  bool tma = P % 8 == 0 && N % 8 == 0 && x_sb % 8 == 0 && x_ss % 8 == 0 && b_sb % 8 == 0 &&
             b_ss % 8 == 0 && c_sb % 8 == 0 && c_ss % 8 == 0 && aligned(x) && aligned(bm) &&
             aligned(cm);
  CUtensorMap tx{}, tb{}, tc{};
  if (tma) {
    const cuuint64_t xd[4] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t xs[3] = {(cuuint64_t)P * 2, (cuuint64_t)x_ss * 2, (cuuint64_t)x_sb * 2};
    const cuuint32_t xbox[4] = {T, 1, (cuuint32_t)L, 1};
    const cuuint64_t nd[3] = {(cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t bs[2] = {(cuuint64_t)b_ss * 2, (cuuint64_t)b_sb * 2};
    const cuuint64_t cs[2] = {(cuuint64_t)c_ss * 2, (cuuint64_t)c_sb * 2};
    const cuuint32_t nbox[3] = {T, (cuuint32_t)L, 1};
    if (!bf16_map(&tx, x, 4, xd, xs, xbox) || !bf16_map(&tb, bm, 3, nd, bs, nbox) ||
        !bf16_map(&tc, cm, 3, nd, cs, nbox))
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(ssm_scan_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SCAN_SMEM);
  if (err != cudaSuccess) return (int)err;
  ssm_scan_wgmma_kernel<<<(unsigned)blocks, WG, SCAN_SMEM, stream>>>(
      tx, tb, tc, static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(bm),
      static_cast<const uint16_t*>(cm), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const float*>(d), static_cast<uint16_t*>(y),
      static_cast<float*>(state), static_cast<float*>(carry), static_cast<int*>(sync), B, S, H,
      P, N, L, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, (int)tma);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success), or -1 for arguments the
// kernel does not take.  x: (B, S, H, P) with strides (x_sb, x_ss, P, 1);
// bm, cm: (B, S, N) with strides (b_sb, b_ss, 1) and (c_sb, c_ss, 1), in
// x's type; dt: (B, S, H) contiguous, a_log and d: (H,), fp32; y: (B, S, H,
// P) contiguous in x's type; state: (B, H, P, N) fp32.  Strides count
// elements.  chunk, P and N in [1, 64]; S a multiple of chunk.  bf16 also
// takes the look-back's scratch: carry, fp32, two 64 x 64 states a (b, h)
// (unused where the sequence is one segment); sync, 2 + B * H ints (a
// ticket counter, each (b, h)'s flag, a count of finished blocks), zero, and
// left zero by the call's last block.
extern "C" int repro_ssm_scan(const void* x, const void* bm, const void* cm, const void* dt,
                              const void* a_log, const void* d, void* y, void* state,
                              void* carry, void* sync, int B, int S, int H, int P, int N,
                              int chunk, long long x_sb, long long x_ss, long long b_sb,
                              long long b_ss, long long c_sb, long long c_ss, int is_bf16,
                              void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || chunk <= 0 || chunk > MAXD || P <= 0 ||
      P > MAXD || N <= 0 || N > MAXD || S % chunk != 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bf16(x, bm, cm, dt, a_log, d, y, state, carry, sync, B, S, H, P, N, chunk,
                       x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, s);
  return launch_f32(x, bm, cm, dt, a_log, d, y, state, B, S, H, P, N, chunk, x_sb, x_ss, b_sb,
                    b_ss, c_sb, c_ss, s);
}
