// The gradient of the Mamba2 SSD chunked scan (csrc/ssm_scan.cu), for
// Hopper (sm_90a).  Per (batch b, head h) and chunk of L steps, with
// A = -exp(A_log[h]), cum_i the inclusive sum of A dt_k over the chunk (one
// thread's loop in the plain version's order, as the forward has it),
// w_ij = exp(cum_i - cum_j) dt_j for j <= i, wl_j = exp(cum_L - cum_j) dt_j
// and dec = exp(cum_L), S_c the state at chunk c's start and G_c the
// gradient of the state at its end (the last chunk's is the final state's
// gradient, or zero; G_{c-1} = dec G_c + sum_i exp(cum_i) dy_i (x) C_i):
//
//   dx_j = sum_{i>=j} (C_i.B_j) w_ij dy_i + wl_j G_c B_j + D dy_j
//   dC_i = sum_{j<=i} w_ij (dy_i.x_j) B_j + exp(cum_i) dy_i S_c
//   dB_j = sum_{i>=j} w_ij (dy_i.x_j) C_i + wl_j x_j G_c
//
// dB and dC summed over the heads, which share B and C; ddt and dA_log from
// the gradient of cum, gathered from every term where it appears (w,
// exp(cum_i), wl, dec), summed in reverse within the chunk:
// ddt_k = (direct terms) + A rc_k, dA_log[h] = A sum dt_k rc_k over (b, s);
// dD[h] = sum dy.x.  Written as `ssm_scan_bwd_plain`
// (kernels/ssm_scan.py) writes it, whose oracle is autograd through
// `ssd_chunked`.  The reference has no backward kernel: it trains by
// jax.grad of its jnp `ssd_chunked` (src/repro/models/ssm.py:65), the
// gradient of the Pallas kernel's function (src/repro/kernels/ssm_scan.py).
//
// Bound: at zamba2-7b's training shape (B 2, S 4096, H 112, P 64, N 64,
// chunk 64, bf16) by bytes: x and dy read and dx written once, 352 MB, B, C,
// dt and their gradients 11.5 MB, 0.109 ms at 3.35 TB/s; the ten 64x64x64
// products of each of the 14,336 (b, h, chunk) steps are 7.5e10 operations,
// 0.076 ms at the bf16 tensor-core peak (`work_bwd`).
//
// Three launches, one a pass, no atomics on any value:
//   1. The state chains (`ssm_bwd_state_*`).  Each chunk's start state S_c
//      and end gradient G_c, fp32, written as 64 x 64 tiles in the order the
//      products' accumulators hold them (a thread's 32 values as 8 float4)
//      into a scratch the wrapper allocates: 2 x 235 MB at zamba2's shape,
//      written here and read once by pass 2.  Half the blocks run the
//      forward chain of states, half the reverse chain of gradients, each a
//      segment of SEG chunks of one (b, h), as the forward kernel's look-back
//      has it: sweep 1 from a zero start (S <- dec S + (wl x)^T B; in
//      reverse, G <- dec G + (e^cum dy)^T C), the look-back (wait for the
//      neighbouring segment's inclusive state: the one before for states,
//      after for gradients; combine, publish), sweep 2 from the true start
//      writing each chunk's tile.  A segment combines always with its
//      neighbour's state, so the result does not depend on timing; each
//      chain takes tickets from its own counter in its own order, so a block
//      waits only on a block that started before it, and every wait traps
//      after a bounded number of polls.  The inclusive state is published
//      into the scratch tile the neighbour then owns (no carry of its own).
//      The call's last block leaves the counters zero, so the wrapper keeps
//      them and no call launches a zeroing.  The states could instead be
//      kept a segment apart (58.7 MB each) and recomputed a chunk at a time
//      in pass 2; that costs pass 2 a carried state and its loop, and is
//      left for a later change.
//   2. The chunks' gradients (`ssm_bwd_chunk_*`): a block per (b, chunk,
//      group of HG heads), the heads in turn, dB and dC summed over the
//      group in the block's accumulators (no per-head partials: those would
//      be 2 x 235 MB in fp32), each group's sums written in fp32 (2 x 29 MB
//      at zamba2's shape, 14 groups).  dx and ddt are written per head; the
//      sums for dA_log and dD per (b, chunk, head).
//   3. The sums (`ssm_bwd_sum_kernel`): dB and dC over the groups, dA_log
//      and dD over (b, chunk), each element by one thread in a fixed order,
//      so remat's recompute and two calls on the same inputs give the same
//      bits.
//
// bf16 (`*_wgmma_kernel`): one warpgroup a block, every product on wgmma
// (64 x 64 x 64, fp32 accumulators), x, dy, B and C loaded by TMA
// (128-byte swizzled tiles; x at its own batch and sequence strides, as the
// conv output's view hands it).  Precision as the forward's: a product of
// two bf16 inputs (C B^T, dy x^T) is taken as it is; a product with an fp32
// operand (w-weighted matrices, S_c, G_c, e^cum dy and wl x) takes it split
// into bf16 hi + lo, two products.  In pass 2 each head runs 14 products:
// C B^T and dy x^T, then the weighted matrices Wg = (C B^T) w (for dx) and
// Wm = (dy x^T) w (for dB and dC) are split into shared tiles; dy S (dC's
// state term), Wm B and Wm^T C (accumulated over the group in registers);
// B G^T (dx's state term) and x G (dB's); Wg^T dy.  The A operand is read
// from shared memory, transposed by wgmma where the tile holds it K-rows
// first.  The gradient of cum (row and column sums of (C B^T)(dy x^T) e,
// the row dots of dy S with C and of B G^T with x, the sum of S_c G_c) and
// its reverse sum stay in fp32 throughout: ddt and dA_log are sums that
// cancel.  Where TMA cannot take a stride or alignment, the same kernels
// load their tiles by plain loads into the same layout.
//
// Each head of the chunk pass reads S_c and G_c at its start (G_c held in
// registers until S_c's product is done, its load under the first
// products), and the gradient of cum and its reverse sum are one warp's
// shuffles.  On an H100 (700 W) the three launches take 1.07 ms at zamba2's
// training shape, 10 % of the bound; before the last two changes the
// profiler gave the chunk pass 0.755 ms, the chains 0.336 and the sums
// 0.048.  What holds it back: the per-chunk states (940 MB moved against
// the bound's 364), and the chunk pass's one warpgroup a block (254
// registers, 109 KB: two blocks an SM) waiting on each of its phases in
// turn.  Tried: head groups of 4 and of 16 (1.22 and 1.45 ms against 8's
// 1.15); the reverse sums by one thread (1.17 ms).
//
// fp32 (`ssm_bwd_state_kernel`, `ssm_bwd_chunk_kernel`): the same passes,
// step for step, with each product on the fp32 cores (a thread computes the
// accumulator elements a wgmma would give it, from fp32 tiles in shared
// memory), for the fp32 checks.

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

#include <cuda_bf16.h>

#include <type_traits>

namespace {

constexpr int WG = 128;                // a block: one warpgroup
constexpr int T = 64;                  // every tile is 64 x 64
constexpr int ACC = 32;                // fp32 accumulators a thread holds of a 64 x 64 product
constexpr int TILE = T * 128;          // bytes of a bf16 tile (rows of 128 bytes, swizzled)
constexpr int LDF = 68;                // row stride (floats) of an fp32 tile
constexpr int FTILE = T * LDF * 4;     // bytes of an fp32 tile
constexpr int SEG = 4;                 // chunks a segment of the state chains
constexpr int HG = 8;                  // heads a block of the chunk pass
constexpr int STATE = T * T;           // floats of a state tile in the scratch
constexpr long long MAX_POLLS = 1ll << 22;   // then a wait traps (seconds)
// A chunk whose cumulative sum stays above this takes exp(cum_i - cum_j) as
// exp(cum_i) exp(-cum_j), as the forward does.
constexpr float MILD = -80.f;

// ------------------------------------------------------------- helpers --
// Byte offset of 16-byte piece c of row r in a 128-byte-swizzled tile.
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

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

// The accumulator layout of a 64 x 64 product (hopper.cuh): value e of the
// thread is at row acc_row(e), column acc_col(e).
struct Lane {
  int warp, g, t;
  __device__ __forceinline__ Lane() : warp(threadIdx.x / 32), g(threadIdx.x % 32 / 4),
                                      t(threadIdx.x % 4) {}
  __device__ __forceinline__ int row(int e) const { return 16 * warp + g + 8 * ((e >> 1) & 1); }
  __device__ __forceinline__ int col(int e) const { return 8 * (e >> 2) + 2 * t + (e & 1); }
};

__device__ __forceinline__ void zero(float (&d)[ACC]) {
#pragma unroll
  for (int e = 0; e < ACC; ++e) d[e] = 0.f;
}

// An input tile's value at (r, c): a swizzled bf16 tile or an fp32 one.
template <bool BF>
__device__ __forceinline__ float at(const unsigned char* tile, int r, int c) {
  if constexpr (BF) {
    const uint16_t v = *reinterpret_cast<const uint16_t*>(tile + swz(r, c >> 3) + (c & 7) * 2);
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  } else {
    return reinterpret_cast<const float*>(tile)[r * LDF + c];
  }
}

// rows x cols of a matrix (row stride `stride`) into a tile, zeros past
// them; the plain-load route.
template <bool BF>
__device__ __forceinline__ void load_tile(unsigned char* tile, const void* src, long long stride,
                                          int rows, int cols) {
  for (int e = threadIdx.x; e < T * T; e += WG) {
    const int r = e / T, c = e % T;
    const bool in = r < rows && c < cols;
    if constexpr (BF) {
      *reinterpret_cast<uint16_t*>(tile + swz(r, c >> 3) + (c & 7) * 2) =
          in ? static_cast<const uint16_t*>(src)[r * stride + c] : 0;
    } else {
      reinterpret_cast<float*>(tile)[r * LDF + c] =
          in ? static_cast<const float*>(src)[r * stride + c] : 0.f;
    }
  }
}

// An fp32 operand, from the accumulator layout, into its tile: bf16 hi
// (first tile) + lo (the next), or fp32.
template <bool BF>
__device__ __forceinline__ void store_acc(const float (&v)[ACC], unsigned char* tile) {
  const Lane ln;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * ln.warp + ln.g + 8 * r, col = 8 * j + 2 * ln.t;
      const float a = v[4 * j + 2 * r], b = v[4 * j + 2 * r + 1];
      if constexpr (BF) {
        const int off = swz(row, j) + 4 * ln.t;
        uint32_t h, l;
        repro::split_bf16x2(a, b, h, l);
        *reinterpret_cast<uint32_t*>(tile + off) = h;
        *reinterpret_cast<uint32_t*>(tile + TILE + off) = l;
      } else {
        float* f = reinterpret_cast<float*>(tile) + row * LDF + col;
        f[0] = a;
        f[1] = b;
      }
    }
  if constexpr (BF) repro::fence_proxy_async();
}

// A 64 x 64 fp32 tile of the scratch (a thread's 32 values as 8 float4).
__device__ __forceinline__ void read_state(const float* src, float (&v)[ACC]) {
  const float4* p = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int k = 0; k < ACC / 4; ++k) {
    const float4 q = __ldcg(p + k * WG + threadIdx.x);
    v[4 * k] = q.x;
    v[4 * k + 1] = q.y;
    v[4 * k + 2] = q.z;
    v[4 * k + 3] = q.w;
  }
}

__device__ __forceinline__ void write_state(float* dst, const float (&v)[ACC]) {
  float4* p = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int k = 0; k < ACC / 4; ++k)
    __stcg(p + k * WG + threadIdx.x, make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]));
}

// --------------------------------------------------------------- products --
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile) {
  return repro::wgmma_desc(repro::opaque(repro::smem_addr(tile)), 16, 1024);
}

__device__ __forceinline__ uint64_t mnmajor(const unsigned char* tile) {
  return repro::wgmma_desc(repro::opaque(repro::smem_addr(tile)), TILE, 1024);
}

// d (+)= a b: m64n64k16, both operands from shared memory; TA: A is held K
// rows first (MN-major, transposed by wgmma), TB the same for B.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[32], uint64_t a, uint64_t b, bool acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(int(acc)), "n"(TA), "n"(TB));
}

// d (+)= A B over 64 (d overwritten when !acc): A(m, k) is a[m][k], or
// a[k][m] with TA; B(k, n) is b[n][k], or b[k][n] with TB.  bf16: issued on
// wgmma (the caller fences, commits and waits); fp32: on the fp32 cores,
// each thread its accumulator elements.
template <bool BF, int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[ACC], const unsigned char* a,
                                    const unsigned char* b, bool acc) {
  if constexpr (BF) {
    const uint64_t da = TA ? mnmajor(a) : kmajor(a), db = TB ? mnmajor(b) : kmajor(b);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_t<TA, TB>(d, da + (TA ? 128 : 2) * kk, db + (TB ? 128 : 2) * kk, acc || kk > 0);
  } else {
    const Lane ln;
    const float* fa = reinterpret_cast<const float*>(a);
    const float* fb = reinterpret_cast<const float*>(b);
    const int r0 = 16 * ln.warp + ln.g;
    if (!acc) zero(d);
    for (int k = 0; k < T; ++k) {
      float av[2], bv[16];
#pragma unroll
      for (int r = 0; r < 2; ++r) av[r] = TA ? fa[k * LDF + r0 + 8 * r] : fa[(r0 + 8 * r) * LDF + k];
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int c = 8 * (q >> 1) + 2 * ln.t + (q & 1);
        bv[q] = TB ? fb[k * LDF + c] : fb[c * LDF + k];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            d[4 * j + 2 * r + u] = fmaf(av[r], bv[2 * j + u], d[4 * j + 2 * r + u]);
    }
  }
}

// The same with A an fp32 operand (two bf16 tiles, lo then hi, or one fp32).
template <bool BF, int TA, int TB>
__device__ __forceinline__ void mma_fa(float (&d)[ACC], const unsigned char* a,
                                       const unsigned char* b, bool acc) {
  if constexpr (BF) {
    mma<BF, TA, TB>(d, a + TILE, b, acc);
    mma<BF, TA, TB>(d, a, b, true);
  } else {
    mma<BF, TA, TB>(d, a, b, acc);
  }
}

// The same with B an fp32 operand.
template <bool BF, int TA, int TB>
__device__ __forceinline__ void mma_fb(float (&d)[ACC], const unsigned char* a,
                                       const unsigned char* b, bool acc) {
  if constexpr (BF) {
    mma<BF, TA, TB>(d, a, b + TILE, acc);
    mma<BF, TA, TB>(d, a, b, true);
  } else {
    mma<BF, TA, TB>(d, a, b, acc);
  }
}

template <bool BF>
__device__ __forceinline__ void issue_begin() {
  if constexpr (BF) repro::wgmma_fence();
}

template <bool BF>
__device__ __forceinline__ void issue_end() {
  if constexpr (BF) {
    repro::wgmma_commit();
    repro::wgmma_wait<0>();
  }
}

// A chain's update: d += (sc_j a_j)^T b_j over the chunk's steps j, a's
// rows j (columns p) scaled and split (bf16: read transposed by ldmatrix
// into the A operand's registers), b's rows j (columns n).
template <bool BF>
__device__ __forceinline__ void chain_update(float (&d)[ACC], const unsigned char* a,
                                             const unsigned char* b, const float* sc) {
  if constexpr (BF) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4, m = lane >> 3;
    uint32_t ua[2][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t r[4];
      const int j = 16 * kk + 8 * (m >> 1) + (lane & 7);
      repro::ldmatrix_x4_trans(r, a + swz(j, 2 * warp + (m & 1)));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j0 = 16 * kk + 8 * (e >> 1) + 2 * t;
        repro::split_bf16x2(__uint_as_float(r[e] << 16) * sc[j0],
                            __uint_as_float(r[e] & 0xffff0000u) * sc[j0 + 1], ua[0][kk][e],
                            ua[1][kk][e]);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) repro::fence_regs(ua[hh][kk]);
    repro::fence_regs(d);
    repro::wgmma_fence();
    const uint64_t bd = mnmajor(b);
#pragma unroll
    for (int hh = 1; hh >= 0; --hh)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) repro::wgmma_rs_tn(d, ua[hh][kk], bd + 128 * kk);
    repro::wgmma_commit();
    repro::wgmma_wait<0>();
    repro::fence_regs(d);
  } else {
    const Lane ln;
    const float* fa = reinterpret_cast<const float*>(a);
    const float* fb = reinterpret_cast<const float*>(b);
    const int r0 = 16 * ln.warp + ln.g;
    for (int k = 0; k < T; ++k) {
      const float av[2] = {sc[k] * fa[k * LDF + r0], sc[k] * fa[k * LDF + r0 + 8]};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float bv = fb[k * LDF + 8 * j + 2 * ln.t + u];
#pragma unroll
          for (int r = 0; r < 2; ++r) d[4 * j + 2 * r + u] = fmaf(av[r], bv, d[4 * j + 2 * r + u]);
        }
    }
  }
}

// What the kernels take.
struct Args {
  const void *x, *bm, *cm, *dy;
  const float *dt, *a_log, *d_skip, *dstate;
  void *dx, *dbm, *dcm;
  float *ddt, *da_log, *dd;
  float* states;   // 2 x (B, nc, H) tiles: S_c, then G_c
  float* parts;    // dB's and dC's group sums, then dA_log's and dD's (b, chunk, head) sums
  int* sync;       // the chains' tickets, finished blocks, and each (b, h)'s flags
  int B, S, H, P, N, L;
  long long x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;
  int groups;
  int tma;        // x, dy, B and C by TMA (else plain loads)
  int out_bf16;   // dB and dC in bf16 (else fp32)
};

// The chunk's cumulative sums by one thread, in the plain version's order
// (product and sum each rounded; dt is 0 past L).
__device__ __forceinline__ void cum_loop(const float* dt, float* cum, float A) {
  float run = 0.f;
  for (int i = 0; i < T; ++i) {
    run = __fadd_rn(run, __fmul_rn(A, dt[i]));
    cum[i] = run;
  }
}

// ----------------------------------------------------- pass 1: the chains --
struct ChainAux {
  float dt[SEG][T], cum[SEG][T], sc[SEG][T];   // sc: wl (states) or exp(cum) (gradients)
  float dec[SEG];
  uint64_t full;
  int ticket;
};

template <bool BF>
__device__ __forceinline__ void chain_body(const Args& g, const CUtensorMap* t_a,
                                           const CUtensorMap* t_b, unsigned char* smem) {
  constexpr int TB_ = BF ? TILE : FTILE;
  unsigned char* tiles = smem;                              // chunk c: a at 2c, b at 2c + 1
  ChainAux& ax = *reinterpret_cast<ChainAux*>(smem + 2 * SEG * TB_);
  const int tid = threadIdx.x;
  const int role = blockIdx.x & 1;                          // 0: states, 1: gradients
  const int BH = g.B * g.H, nc = g.S / g.L, n_seg = (nc + SEG - 1) / SEG;
  if (tid == 0) {
    ax.ticket = atomicAdd(g.sync + role, 1);
    if constexpr (BF) {
      repro::mbar_init(&ax.full, 1);
      repro::fence_barrier_init();
    }
  }
  const bool tma = BF && g.tma;
  if (tma && g.L < T) {
    // TMA writes L rows of a tile: the rows past them stay zero.
    for (int e = tid; e < 2 * SEG * TB_ / 16; e += WG)
      reinterpret_cast<uint4*>(tiles)[e] = make_uint4(0, 0, 0, 0);
    repro::fence_proxy_async();
  }
  __syncthreads();
  const int pos = ax.ticket / BH, bh = ax.ticket % BH;
  const int seg = role ? n_seg - 1 - pos : pos;
  const int b = bh / g.H, h = bh % g.H, first = seg * SEG, n = min(SEG, nc - first);

  // The segment's tiles: x and B (states), dy and C (gradients).
  const void* a_src = role ? g.dy : g.x;
  const void* b_src = role ? g.cm : g.bm;
  const long long a_sb = role ? (long long)g.S * g.H * g.P : g.x_sb;
  const long long a_ss = role ? (long long)g.H * g.P : g.x_ss;
  const long long b_sb = role ? g.c_sb : g.b_sb, b_ss = role ? g.c_ss : g.b_ss;
  if (tma) {
    if (tid == 0) {
      repro::mbar_arrive_expect_tx(&ax.full, 2 * n * g.L * 128);
      for (int c = 0; c < n; ++c) {
        const int r0 = (first + c) * g.L;
        repro::tma_load_4d(tiles + 2 * c * TILE, t_a, &ax.full, 0, h, r0, b);
        repro::tma_load_3d(tiles + (2 * c + 1) * TILE, t_b, &ax.full, 0, r0, b);
      }
    }
  } else {
    const int esz = BF ? 2 : 4;
    for (int c = 0; c < n; ++c) {
      const long long r0 = (long long)(first + c) * g.L;
      load_tile<BF>(tiles + 2 * c * TB_,
                    static_cast<const char*>(a_src) + (b * a_sb + r0 * a_ss + (long long)h * g.P) * esz,
                    a_ss, g.L, g.P);
      load_tile<BF>(tiles + (2 * c + 1) * TB_,
                    static_cast<const char*>(b_src) + (b * b_sb + r0 * b_ss) * esz, b_ss, g.L,
                    g.N);
    }
    if constexpr (BF) repro::fence_proxy_async();
  }

  // dt, cum (one thread a chunk), then the chain's scale and each decay.
  const float A = -expf(g.a_log[h]);
  for (int e = tid; e < n * T; e += WG) {
    const int c = e / T, i = e % T;
    ax.dt[c][i] = i < g.L ? g.dt[((size_t)b * g.S + (size_t)(first + c) * g.L + i) * g.H + h] : 0.f;
  }
  __syncthreads();
  if (tid < n) cum_loop(ax.dt[tid], ax.cum[tid], A);
  __syncthreads();
  for (int e = tid; e < n * T; e += WG) {
    const int c = e / T, i = e % T;
    const float cl = ax.cum[c][T - 1];
    ax.sc[c][i] = role ? expf(ax.cum[c][i]) : expf(cl - ax.cum[c][i]) * ax.dt[c][i];
    if (i == 0) ax.dec[c] = expf(cl);
  }
  if (tma)
    for (long long polls = 0; !repro::mbar_try_wait(&ax.full, 0); ++polls)
      if (polls > MAX_POLLS) __trap();
  __syncthreads();

  // Sweep 1: the segment's own state from zero, in the chain's order.
  float s[ACC];
  zero(s);
  float dseg = 1.f;
  for (int k = 0; k < n; ++k) {
    const int c = role ? n - 1 - k : k;
    const float dec = ax.dec[c];
#pragma unroll
    for (int e = 0; e < ACC; ++e) s[e] *= dec;
    dseg *= dec;
    chain_update<BF>(s, tiles + 2 * c * TB_, tiles + (2 * c + 1) * TB_, ax.sc[c]);
  }

  // The look-back: the neighbour's inclusive state (states: the segment
  // before's, zero before the first; gradients: the segment after's, the
  // final state's gradient (or zero) after the last).
  const size_t chain = (size_t)role * g.B * nc;
  auto tile_of = [&](int c) { return g.states + ((chain + (size_t)b * nc + c) * g.H + h) * STATE; };
  int* flag = g.sync + 3 + role * BH + bh;
  float s_in[ACC];
  const bool waits = pos > 0;
  if (waits) {
    if (tid == 0)
      for (long long polls = 0; ld_acquire(flag) < pos; ++polls) {
        if (polls > MAX_POLLS) __trap();
        __nanosleep(128);
      }
    __syncthreads();
    read_state(tile_of(role ? first + n - 1 : first), s_in);
  } else if (role && g.dstate != nullptr) {
    const Lane ln;
    const float* src = g.dstate + (size_t)bh * g.P * g.N;
#pragma unroll
    for (int e = 0; e < ACC; ++e) {
      const int p = ln.row(e), nn = ln.col(e);
      s_in[e] = p < g.P && nn < g.N ? src[p * g.N + nn] : 0.f;
    }
  } else {
    zero(s_in);
  }
  if (pos + 1 < n_seg) {
#pragma unroll
    for (int e = 0; e < ACC; ++e) s[e] = dseg * s_in[e] + s[e];
    write_state(tile_of(role ? first - 1 : first + n), s);
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      st_release(flag, pos + 1);
    }
  }

  // Sweep 2: each chunk's tile from the true start (the neighbour wrote the
  // first one where there is a neighbour).
#pragma unroll
  for (int e = 0; e < ACC; ++e) s[e] = s_in[e];
  for (int k = 0; k < n; ++k) {
    const int c = role ? n - 1 - k : k;
    if (k > 0 || !waits) write_state(tile_of(first + c), s);
    if (k + 1 < n) {
      const float dec = ax.dec[c];
#pragma unroll
      for (int e = 0; e < ACC; ++e) s[e] *= dec;
      chain_update<BF>(s, tiles + 2 * c * TB_, tiles + (2 * c + 1) * TB_, ax.sc[c]);
    }
  }

  // The call's last block leaves the counters zero for the next call.
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(g.sync + 2, 1) == (int)gridDim.x - 1) {
      for (int e = 0; e < 3 + 2 * BH; ++e) g.sync[e] = 0;
      __threadfence();
    }
  }
}

__global__ void __launch_bounds__(WG) ssm_bwd_state_kernel(const Args g) {
  extern __shared__ __align__(16) unsigned char chain_smem_f32[];
  chain_body<false>(g, nullptr, nullptr, chain_smem_f32);
}

__global__ void __launch_bounds__(WG, 3)
ssm_bwd_state_wgmma_kernel(const Args g, const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tdy,
                           const __grid_constant__ CUtensorMap tb,
                           const __grid_constant__ CUtensorMap tc) {
  extern __shared__ unsigned char chain_smem_raw[];
  const uint32_t raw = repro::smem_addr(chain_smem_raw);
  unsigned char* smem = chain_smem_raw + (((raw + 1023) & ~1023u) - raw);
  const bool role = blockIdx.x & 1;
  chain_body<true>(g, role ? &tdy : &tx, role ? &tc : &tb, smem);
}

size_t chain_smem(bool bf) {
  return (bf ? 1024 + 2 * SEG * TILE : 2 * SEG * FTILE) + sizeof(ChainAux);
}

// ------------------------------------------------- pass 2: the chunks --
struct ChunkAux {
  float dt[HG][T], cum[HG][T], ec[HG][T], er[HG][T], el[HG][T];
  float dec[HG];
  float rowq[T], colr[4][T], decum[T], dwl[T];
  float ddec[4], dd[4];
  uint64_t full[3];   // B and C; x and dy, two stages
};

// Sum over the four threads of a row (lanes t) and over the 8 rows of a
// warp's column (lanes g).
__device__ __forceinline__ float sum_t(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float sum_g(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

__device__ __forceinline__ float sum_warp(float v) { return sum_g(sum_t(v)); }

template <bool BF>
__device__ __forceinline__ void chunk_body(const Args& g, const CUtensorMap* tx,
                                           const CUtensorMap* tdy, const CUtensorMap* tb,
                                           const CUtensorMap* tc, unsigned char* smem) {
  using OutT = typename std::conditional<BF, __nv_bfloat16, float>::type;
  constexpr int TB_ = BF ? TILE : FTILE;          // an input tile
  constexpr int TF_ = BF ? 2 * TILE : FTILE;      // an fp32 operand's tile(s)
  constexpr int STAGES = BF ? 2 : 1;
  unsigned char* t_b = smem;
  unsigned char* t_c = t_b + TB_;
  unsigned char* ring = t_c + TB_;                // stage s: x at 2s, dy at 2s + 1
  unsigned char* t_sg = ring + 2 * STAGES * TB_;  // S_c, then G_c
  unsigned char* t_wg = t_sg + TF_;               // (C B^T) w
  unsigned char* t_wm = t_wg + TF_;               // (dy x^T) w
  ChunkAux& ax = *reinterpret_cast<ChunkAux*>(t_wm + TF_);
  const int tid = threadIdx.x;
  const Lane ln;
  const int nc = g.S / g.L;
  const int grp = blockIdx.x % g.groups, bc = blockIdx.x / g.groups;
  const int b = bc / nc, c = bc % nc;
  const int h0 = grp * HG, nh = min(HG, g.H - h0);
  const long long r0 = (long long)c * g.L;
  const bool tma = BF && g.tma;
  const long long dy_ss = (long long)g.H * g.P, dy_sb = (long long)g.S * dy_ss;

  if (tid == 0 && tma) {
    for (int s = 0; s < 3; ++s) repro::mbar_init(&ax.full[s], 1);
    repro::fence_barrier_init();
  }
  if (tma && g.L < T) {
    // TMA writes L rows of a tile: the rows past them stay zero.
    for (int e = tid; e < (2 + 2 * STAGES) * TB_ / 16; e += WG)
      reinterpret_cast<uint4*>(t_b)[e] = make_uint4(0, 0, 0, 0);
    repro::fence_proxy_async();
  }
  __syncthreads();

  // Head hh's x and dy into stage hh % STAGES (TMA: issued ahead; plain:
  // loaded when needed).
  auto issue = [&](int hh) {
    if (!tma || hh >= nh || tid != 0) return;
    unsigned char* st = ring + 2 * (hh % STAGES) * TB_;
    uint64_t* bar = &ax.full[1 + hh % STAGES];
    repro::mbar_arrive_expect_tx(bar, 2 * g.L * 128);
    repro::tma_load_4d(st, tx, bar, 0, h0 + hh, (int)r0, b);
    repro::tma_load_4d(st + TB_, tdy, bar, 0, h0 + hh, (int)r0, b);
  };
  const int esz = BF ? 2 : 4;
  if (tma) {
    if (tid == 0) {
      repro::mbar_arrive_expect_tx(&ax.full[0], 2 * g.L * 128);
      repro::tma_load_3d(t_b, tb, &ax.full[0], 0, (int)r0, b);
      repro::tma_load_3d(t_c, tc, &ax.full[0], 0, (int)r0, b);
    }
    issue(0);
  } else {
    load_tile<BF>(t_b, static_cast<const char*>(g.bm) + (b * g.b_sb + r0 * g.b_ss) * esz, g.b_ss,
                  g.L, g.N);
    load_tile<BF>(t_c, static_cast<const char*>(g.cm) + (b * g.c_sb + r0 * g.c_ss) * esz, g.c_ss,
                  g.L, g.N);
  }

  // The group's dt, cum (one thread a head), and the tables of exps.
  for (int e = tid; e < nh * T; e += WG) {
    const int hh = e / T, i = e % T;
    ax.dt[hh][i] = i < g.L ? g.dt[((size_t)b * g.S + r0 + i) * g.H + h0 + hh] : 0.f;
  }
  __syncthreads();
  if (tid < nh) cum_loop(ax.dt[tid], ax.cum[tid], -expf(g.a_log[h0 + tid]));
  __syncthreads();
  for (int e = tid; e < nh * T; e += WG) {
    const int hh = e / T, i = e % T;
    const float cl = ax.cum[hh][T - 1], cu = ax.cum[hh][i];
    ax.ec[hh][i] = expf(cu);
    ax.er[hh][i] = cl > MILD ? expf(-cu) : 0.f;
    ax.el[hh][i] = expf(cl - cu);
    if (i == 0) ax.dec[hh] = expf(cl);
  }
  if (tma)
    for (long long polls = 0; !repro::mbar_try_wait(&ax.full[0], 0); ++polls)
      if (polls > MAX_POLLS) __trap();
  __syncthreads();

  // dB and dC of the chunk, summed over the group's heads.
  float db[ACC], dc[ACC];
  zero(db);
  zero(dc);
  const size_t slot = ((size_t)b * nc + c) * g.H;
  const size_t g_chain = (size_t)g.B * nc * g.H;

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    const float A = -expf(g.a_log[h]);
    const float Dh = g.d_skip[h];
    const float* dt = ax.dt[hh];
    const float* cum = ax.cum[hh];
    const float* ec = ax.ec[hh];
    const float* er = ax.er[hh];
    const bool mild = cum[T - 1] > MILD;
    unsigned char* t_x = ring + 2 * (hh % STAGES) * TB_;
    unsigned char* t_dy = t_x + TB_;
    issue(hh + 1);
    if (!tma) {
      const long long xo = (b * g.x_sb + r0 * g.x_ss + (long long)h * g.P) * esz;
      const long long yo = (b * dy_sb + r0 * dy_ss + (long long)h * g.P) * esz;
      load_tile<BF>(t_x, static_cast<const char*>(g.x) + xo, g.x_ss, g.L, g.P);
      load_tile<BF>(t_dy, static_cast<const char*>(g.dy) + yo, dy_ss, g.L, g.P);
      if constexpr (BF) repro::fence_proxy_async();
    }
    // S_c into its tile; G_c read now (its latency under the first
    // products) and kept in registers until S_c's product is done; the sum
    // of S_c G_c (dec's gradient).
    float gv[ACC];
    {
      float sv[ACC];
      read_state(g.states + (slot + h) * STATE, sv);
      read_state(g.states + (g_chain + slot + h) * STATE, gv);
      float dd = 0.f;
#pragma unroll
      for (int e = 0; e < ACC; ++e) dd += sv[e] * gv[e];
      dd = sum_warp(dd);
      if ((tid & 31) == 0) ax.ddec[ln.warp] = dd;
      store_acc<BF>(sv, t_sg);
    }
    if (tma)
      for (long long polls = 0; !repro::mbar_try_wait(&ax.full[1 + hh % STAGES], (hh / STAGES) & 1);
           ++polls)
        if (polls > MAX_POLLS) __trap();
    __syncthreads();

    // C B^T and dy x^T, then the weighted matrices and the sums of cum's
    // gradient from w.
    float gm[ACC], mm[ACC];
    issue_begin<BF>();
    mma<BF, 0, 0>(gm, t_c, t_b, false);
    mma<BF, 0, 0>(mm, t_dy, t_x, false);
    issue_end<BF>();
    if constexpr (BF) {
      repro::fence_regs(gm);
      repro::fence_regs(mm);
    }
    float rq[2] = {0.f, 0.f}, cr[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) cr[q] = 0.f;
#pragma unroll
    for (int e = 0; e < ACC; ++e) {
      const int i = ln.row(e), j = ln.col(e);
      float wg = 0.f, wm = 0.f;
      if (j <= i) {
        const float ee = mild ? ec[i] * er[j] : exp_fast(cum[i] - cum[j]);
        const float w = ee * dt[j];
        const float r = gm[e] * mm[e] * ee;
        wg = gm[e] * w;
        wm = mm[e] * w;
        rq[(e >> 1) & 1] += r * dt[j];
        cr[2 * (e >> 2) + (e & 1)] += r;
      }
      gm[e] = wg;
      mm[e] = wm;
    }
    store_acc<BF>(gm, t_wg);
    store_acc<BF>(mm, t_wm);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float v = sum_t(rq[r]);
      if (ln.t == 0) ax.rowq[16 * ln.warp + ln.g + 8 * r] = v;
    }
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const float v = sum_g(cr[q]);
      if (ln.g == 0) ax.colr[ln.warp][8 * (q >> 1) + 2 * ln.t + (q & 1)] = v;
    }
    __syncthreads();

    // dy S (dC's state term), and the group's Wm B and Wm^T C.
    float uu[ACC];
    issue_begin<BF>();
    mma_fb<BF, 0, 1>(uu, t_dy, t_sg, false);
    mma_fa<BF, 0, 1>(dc, t_wm, t_b, true);
    mma_fa<BF, 1, 1>(db, t_wm, t_c, true);
    issue_end<BF>();
    if constexpr (BF) {
      repro::fence_regs(uu);
      repro::fence_regs(dc);
      repro::fence_regs(db);
    }
    {
      float de[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < ACC; ++e) {
        const int i = ln.row(e), n = ln.col(e);
        de[(e >> 1) & 1] += uu[e] * at<BF>(t_c, i, n);
        dc[e] += ec[i] * uu[e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = sum_t(de[r]);
        if (ln.t == 0) ax.decum[16 * ln.warp + ln.g + 8 * r] = v;
      }
    }

    // G_c in place of S_c.
    __syncthreads();
    store_acc<BF>(gv, t_sg);
    __syncthreads();

    // B G^T (dx's state term) and x G (dB's).
    float vx[ACC], yy[ACC];
    issue_begin<BF>();
    mma_fb<BF, 0, 0>(vx, t_b, t_sg, false);
    mma_fb<BF, 0, 1>(yy, t_x, t_sg, false);
    issue_end<BF>();
    if constexpr (BF) {
      repro::fence_regs(vx);
      repro::fence_regs(yy);
    }
    {
      const float* el = ax.el[hh];
      float dw[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < ACC; ++e) {
        const int j = ln.row(e), p = ln.col(e);
        const float wl = el[j] * dt[j];
        dw[(e >> 1) & 1] += vx[e] * at<BF>(t_x, j, p);
        vx[e] *= wl;
        db[e] += wl * yy[e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = sum_t(dw[r]);
        if (ln.t == 0) ax.dwl[16 * ln.warp + ln.g + 8 * r] = v;
      }
    }

    // dx = Wg^T dy + wl (B G^T) + D dy.
    issue_begin<BF>();
    if constexpr (BF) repro::fence_regs(vx);
    mma_fa<BF, 1, 1>(vx, t_wg, t_dy, true);
    issue_end<BF>();
    if constexpr (BF) repro::fence_regs(vx);
    {
      OutT* dxb = static_cast<OutT*>(g.dx) + ((size_t)b * g.S + r0) * g.H * g.P + (size_t)h * g.P;
      float dd = 0.f;
#pragma unroll
      for (int e = 0; e < ACC; e += 2) {
        const int j = ln.row(e), p = ln.col(e);
        const float y0 = at<BF>(t_dy, j, p), y1 = at<BF>(t_dy, j, p + 1);
        dd += y0 * at<BF>(t_x, j, p) + y1 * at<BF>(t_x, j, p + 1);
        if (j >= g.L || p >= g.P) continue;
        const float v0 = vx[e] + Dh * y0, v1 = vx[e + 1] + Dh * y1;
        OutT* dst = dxb + (size_t)j * g.H * g.P + p;
        if constexpr (BF) {
          dst[0] = __float2bfloat16_rn(v0);
          if (p + 1 < g.P) dst[1] = __float2bfloat16_rn(v1);
        } else {
          dst[0] = v0;
          if (p + 1 < g.P) dst[1] = v1;
        }
      }
      dd = sum_warp(dd);
      if ((tid & 31) == 0) ax.dd[ln.warp] = dd;
    }
    __syncthreads();

    // The gradient of cum and its sum in reverse within the chunk, by the
    // first warp, rows lane and lane + 32 (all of them 0 past L): each
    // half's suffix sums by shuffles, the upper half's total carried into
    // the lower; the tail's and the decay's terms stand at row L - 1 and so
    // reach every row.  Then ddt, and the (b, chunk, head)'s sums for
    // dA_log and dD.
    if (tid < 32) {
      const float* el = ax.el[hh];
      float rc[2], col[2], tw = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = tid + 32 * r;
        col[r] = ax.colr[0][i] + ax.colr[1][i] + ax.colr[2][i] + ax.colr[3][i];
        const float t = ax.dwl[i] * (el[i] * dt[i]);
        rc[r] = ax.rowq[i] - dt[i] * col[r] + ax.decum[i] * ec[i] - t;
        tw += t;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float v = __shfl_down_sync(0xffffffffu, rc[r], off);
          if (tid + off < 32) rc[r] += v;
        }
      }
      rc[0] += __shfl_sync(0xffffffffu, rc[1], 0);
      const float tail = sum_warp(tw) +
                         (ax.ddec[0] + ax.ddec[1] + ax.ddec[2] + ax.ddec[3]) * ax.dec[hh];
      float da = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = tid + 32 * r;
        if (i < g.L) {
          rc[r] += tail;
          g.ddt[((size_t)b * g.S + r0 + i) * g.H + h] = col[r] + ax.dwl[i] * el[i] + A * rc[r];
          da += dt[i] * rc[r];
        }
      }
      da = sum_warp(da);
      if (tid == 0) {
        float* pa = g.parts + 2 * (size_t)g.B * g.S * g.groups * g.N;
        const size_t k = slot + h;
        pa[k] = da;
        pa[(size_t)g.B * nc * g.H + k] = ax.dd[0] + ax.dd[1] + ax.dd[2] + ax.dd[3];
      }
    }
    if constexpr (BF) repro::fence_proxy_async();   // before TMA writes the stage again
    __syncthreads();   // the stage, the tiles and the sums are free for the next head
  }

  // The group's dB and dC, fp32.
  float* pb = g.parts + (((size_t)b * g.S + r0) * g.groups + grp) * g.N;
  float* pc = pb + (size_t)g.B * g.S * g.groups * g.N;
#pragma unroll
  for (int e = 0; e < ACC; ++e) {
    const int i = ln.row(e), n = ln.col(e);
    if (i < g.L && n < g.N) {
      pb[(size_t)i * g.groups * g.N + n] = db[e];
      pc[(size_t)i * g.groups * g.N + n] = dc[e];
    }
  }
}

__global__ void __launch_bounds__(WG) ssm_bwd_chunk_kernel(const Args g) {
  extern __shared__ __align__(16) unsigned char chunk_smem_f32[];
  chunk_body<false>(g, nullptr, nullptr, nullptr, nullptr, chunk_smem_f32);
}

__global__ void __launch_bounds__(WG, 2)
ssm_bwd_chunk_wgmma_kernel(const Args g, const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tdy,
                           const __grid_constant__ CUtensorMap tb,
                           const __grid_constant__ CUtensorMap tc) {
  extern __shared__ unsigned char chunk_smem_raw[];
  const uint32_t raw = repro::smem_addr(chunk_smem_raw);
  unsigned char* smem = chunk_smem_raw + (((raw + 1023) & ~1023u) - raw);
  chunk_body<true>(g, &tx, &tdy, &tb, &tc, smem);
}

size_t chunk_smem(bool bf) {
  return (bf ? 1024 + (2 + 4) * TILE + 3 * 2 * TILE : (2 + 2 + 3) * FTILE) + sizeof(ChunkAux);
}

// ----------------------------------------------------- pass 3: the sums --
// dB and dC: each (b, s, n) over the groups in order; then dA_log and dD:
// each head over (b, chunk) in order.
__global__ void __launch_bounds__(256) ssm_bwd_sum_kernel(const Args g, int elems) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  const size_t half = (size_t)g.B * g.S * g.groups * g.N;
  if (e < elems) {
    const int bs = e / g.N, n = e % g.N;
    const float* pb = g.parts + (size_t)bs * g.groups * g.N + n;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < g.groups; ++k) {
      sb += pb[(size_t)k * g.N];
      sc += pb[half + (size_t)k * g.N];
    }
    if (g.out_bf16) {
      static_cast<__nv_bfloat16*>(g.dbm)[e] = __float2bfloat16_rn(sb);
      static_cast<__nv_bfloat16*>(g.dcm)[e] = __float2bfloat16_rn(sc);
    } else {
      static_cast<float*>(g.dbm)[e] = sb;
      static_cast<float*>(g.dcm)[e] = sc;
    }
    return;
  }
  const int h = e - elems;
  if (h >= g.H) return;
  const int nc = g.S / g.L;
  const float* pa = g.parts + 2 * half;
  const size_t count = (size_t)g.B * nc;
  float sa = 0.f, sd = 0.f;
  for (size_t k = 0; k < count; ++k) {
    sa += pa[k * g.H + h];
    sd += pa[count * g.H + k * g.H + h];
  }
  g.da_log[h] = -expf(g.a_log[h]) * sa;
  g.dd[h] = sd;
}

// The map of a bf16 matrix read in boxes of 64 columns x `rows` rows,
// 128-byte swizzled; false on failure.
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

}  // namespace

// Returns the first failed launch's cudaError_t (0 on success), or -1 for
// arguments the kernels do not take.  x: (B, S, H, P) with strides (x_sb,
// x_ss, P, 1); bm, cm: (B, S, N) with strides (b_sb, b_ss, 1) and (c_sb,
// c_ss, 1); dy and dx: (B, S, H, P) contiguous; all in x's type.  dt and
// ddt: (B, S, H); a_log, d, da_log, dd: (H,); dstate: (B, H, P, N)
// contiguous or null (zero); fp32.  dbm, dcm: (B, S, N) contiguous in x's
// type.  Scratch: states, 2 * B * (S / chunk) * H * 4096 fp32; parts,
// 2 * B * S * ceil(H / 8) * N + 2 * B * (S / chunk) * H fp32; sync,
// 3 + 2 * B * H ints, zero (and left zero).  Strides count elements.
// chunk, P and N in [1, 64]; S a multiple of chunk.
extern "C" int repro_ssm_scan_bwd(const void* x, const void* bm, const void* cm, const void* dt,
                                  const void* a_log, const void* d, const void* dy,
                                  const void* dstate, void* dx, void* dbm, void* dcm, void* ddt,
                                  void* da_log, void* dd, void* states, void* parts, void* sync,
                                  int B, int S, int H, int P, int N, int chunk, long long x_sb,
                                  long long x_ss, long long b_sb, long long b_ss, long long c_sb,
                                  long long c_ss, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || chunk <= 0 || chunk > T || P <= 0 || P > T || N <= 0 ||
      N > T || S % chunk != 0)
    return -1;
  const int nc = S / chunk, n_seg = (nc + SEG - 1) / SEG, groups = (H + HG - 1) / HG;
  const long long chain_blocks = 2ll * B * H * n_seg, chunk_blocks = (long long)B * nc * groups;
  const long long elems = (long long)B * S * N;
  if (chain_blocks > 0x7fffffffll || chunk_blocks > 0x7fffffffll || elems + H > 0x7fffffffll)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args g{x, bm, cm, dy, static_cast<const float*>(dt), static_cast<const float*>(a_log),
         static_cast<const float*>(d), static_cast<const float*>(dstate), dx, dbm, dcm,
         static_cast<float*>(ddt), static_cast<float*>(da_log), static_cast<float*>(dd),
         static_cast<float*>(states), static_cast<float*>(parts), static_cast<int*>(sync),
         B, S, H, P, N, chunk, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, groups, 0, is_bf16 != 0};
  cudaError_t err;
  if (is_bf16) {
    const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    // TMA: byte strides multiples of 16 (x's head stride is P), bases aligned.
    const bool tma = P % 8 == 0 && N % 8 == 0 && x_sb % 8 == 0 && x_ss % 8 == 0 &&
                     b_sb % 8 == 0 && b_ss % 8 == 0 && c_sb % 8 == 0 && c_ss % 8 == 0 &&
                     aligned(x) && aligned(bm) && aligned(cm) && aligned(dy);
    CUtensorMap tx{}, tdy{}, tb{}, tc{};
    if (tma) {
      const cuuint64_t xd[4] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
      const cuuint64_t xs[3] = {(cuuint64_t)P * 2, (cuuint64_t)x_ss * 2, (cuuint64_t)x_sb * 2};
      const cuuint64_t ys[3] = {(cuuint64_t)P * 2, (cuuint64_t)H * P * 2,
                                (cuuint64_t)S * H * P * 2};
      const cuuint32_t xbox[4] = {T, 1, (cuuint32_t)chunk, 1};
      const cuuint64_t nd[3] = {(cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)B};
      const cuuint64_t bs[2] = {(cuuint64_t)b_ss * 2, (cuuint64_t)b_sb * 2};
      const cuuint64_t cs[2] = {(cuuint64_t)c_ss * 2, (cuuint64_t)c_sb * 2};
      const cuuint32_t nbox[3] = {T, (cuuint32_t)chunk, 1};
      if (!bf16_map(&tx, x, 4, xd, xs, xbox) || !bf16_map(&tdy, dy, 4, xd, ys, xbox) ||
          !bf16_map(&tb, bm, 3, nd, bs, nbox) || !bf16_map(&tc, cm, 3, nd, cs, nbox))
        return (int)cudaErrorInvalidValue;
    }
    g.tma = tma ? 1 : 0;
    const size_t s1 = chain_smem(true), s2 = chunk_smem(true);
    err = cudaFuncSetAttribute(ssm_bwd_state_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(ssm_bwd_chunk_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
    if (err != cudaSuccess) return (int)err;
    ssm_bwd_state_wgmma_kernel<<<(unsigned)chain_blocks, WG, s1, st>>>(g, tx, tdy, tb, tc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssm_bwd_chunk_wgmma_kernel<<<(unsigned)chunk_blocks, WG, s2, st>>>(g, tx, tdy, tb, tc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  } else {
    const size_t s1 = chain_smem(false), s2 = chunk_smem(false);
    err = cudaFuncSetAttribute(ssm_bwd_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)s1);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(ssm_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)s2);
    if (err != cudaSuccess) return (int)err;
    ssm_bwd_state_kernel<<<(unsigned)chain_blocks, WG, s1, st>>>(g);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssm_bwd_chunk_kernel<<<(unsigned)chunk_blocks, WG, s2, st>>>(g);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  ssm_bwd_sum_kernel<<<(unsigned)((elems + H + 255) / 256), 256, 0, st>>>(g, (int)elems);
  return (int)cudaGetLastError();
}
