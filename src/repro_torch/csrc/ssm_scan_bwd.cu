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
//   1. The state chains (`ssm_bwd_state_*`): half the blocks the forward
//      chain of states, half the reverse chain of gradients, each a segment
//      of SEG chunks of one (b, h), as the forward kernel's look-back has it.
//      A block sweeps its segment from a zero start (S <- dec S + (wl x)^T B;
//      in reverse, G <- dec G + (e^cum dy)^T C), waits for the neighbouring
//      segment's inclusive state (the one before for states, after for
//      gradients), combines it with its own and publishes the result into
//      the neighbour's boundary tile.  Only the states R chunks apart are
//      kept: the start state of every group of R chunks and the gradient at
//      its end, fp32 64 x 64 tiles in the products' accumulator order (a
//      thread's 32 values as 8 float4), 2 x 117 MB at zamba2's shape (R
//      2).  A segment of two groups
//      keeps its sweep's state after the first group in the chain's order,
//      so the inner boundary costs a combine and a write, no product.  A
//      segment combines always with its neighbour's state, so the result
//      does not depend on timing; each chain takes tickets from its own
//      counter in its own order, so a block waits only on a block that
//      started before it, and every wait traps after a bounded number of
//      polls.  The call's last block leaves the counters zero, so the
//      wrapper keeps them and no call launches a zeroing.  bf16 streams the
//      segment's chunks through three TMA slots (four blocks an SM), dt
//      read ahead of them.
//   2. The chunks' gradients (`ssm_bwd_chunk_*`): a block per (b, chunk,
//      group of HB heads).  S_c and G_c are recomputed on chip from the
//      chunk's group: one chain update over the group's other chunk (its x
//      and B for a state, dy and C for a gradient; mostly L2 hits, the
//      neighbouring block's own tiles).  dB and dC are summed over the
//      group's heads, each group's sums written in fp32 (2 x 14.7 MB at
//      zamba2's shape, 7 groups); dx per head; each head's gradient of cum
//      row by row, summed in reverse at the block's end (a warp a head)
//      into ddt and the (b, chunk, head)'s sums for dA_log and dD.
//   3. The sums (`ssm_bwd_sum_kernel`): dB and dC over the groups, dA_log
//      and dD over (b, chunk), each element by one thread in a fixed order,
//      so remat's recompute and two calls on the same inputs give the same
//      bits.
//
// bf16 (`*_wgmma_kernel`): every product on wgmma (64 x 64 x 64, fp32
// accumulators), x, dy, B and C loaded by TMA (128-byte swizzled tiles; x at
// its own batch and sequence strides, as the conv output's view hands it).
// Precision as the forward's: a product of two bf16 inputs (C B^T, dy x^T)
// is taken as it is; a product with an fp32 operand (w-weighted matrices,
// S_c, G_c, e^cum dy and wl x) takes it split into bf16 hi + lo, two
// products.  The chunk pass: the chunk's B and C and the neighbouring
// chunk's loaded once, then two warpgroups take the group's heads in
// turn, so one's elementwise phases run under the other's products, and
// add their dB and dC in a fixed order at the block's end.  Each keeps a
// ring of two stages for x and dy, whose next loads its first thread
// issues once a head is done with a stage, and its next head's kept state,
// kept gradient (bulk copies) and neighbouring tile (TMA) go into the
// tiles the products are done with.  A head: the recompute's chain update
// (A from registers); dy S alone (its 32 accumulators beside C B^T's and
// dy x^T's would leave too few registers), dC's state term; C B^T and
// dy x^T; w, the splits of (C B^T) w and (dy x^T) w; Wm B, Wm^T C, B G^T
// and x G; wl (B G^T) in registers, then Wg^T dy onto it; dx staged in
// shared memory and written by one TMA store.  The gradient of cum (row and
// column sums of (C B^T)(dy x^T) e, the row dots of dy S with C and of
// B G^T with x, the sum of S_c G_c) stays in fp32.  The A operand is read
// from shared memory, transposed by wgmma where the tile holds it K-rows
// first.  Where TMA cannot take a stride or alignment, the warpgroups load
// the same tiles by plain loads into the same layout.  Registers: 255, no
// spill, no serialized wgmma; a producer warp or warpgroup (a block of 288
// or 384 threads) left ptxas 168 registers a thread, and it spilled 2 KB
// and serialized the products.
//
// What holds it back (tools/ssm_bwd_phases.py, an H100 at 700 W): at
// zamba2's training shape 0.82-0.89 ms (by the SM clock), 12 % of the
// bound; the chunk pass's head 13.4k cycles on each of two warpgroups (the
// recompute 2.2k, products 5.2k, the elementwise phases 4.7k), its block's
// prologue 7k (the tables of cum and exps); the chains 24.9k cycles a
// block, 9.1k of it the publish (its 16 KB drained to L2 before the flag).
// Both passes wait on latencies, not on the tensor cores or on bytes.  R 4
// (2 x 58.7 MB) would recompute over up to three chunks a head and does not
// fit shared memory with two consumers and rings of two stages (296 KB).
//
// fp32 (`ssm_bwd_state_kernel`, `ssm_bwd_chunk_kernel`): the same passes,
// step for step, with each product on the fp32 cores (a thread computes the
// accumulator elements a wgmma would give it, from fp32 tiles in shared
// memory), one consumer warpgroup, for the fp32 checks.

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

#include <cuda_bf16.h>

#include <type_traits>

namespace {

constexpr int WG = 128;                // a warpgroup
constexpr int T = 64;                  // every tile is 64 x 64
constexpr int ACC = 32;                // fp32 accumulators a thread holds of a 64 x 64 product
constexpr int TILE = T * 128;          // bytes of a bf16 tile (rows of 128 bytes, swizzled)
constexpr int LDF = 68;                // row stride (floats) of an fp32 tile
constexpr int FTILE = T * LDF * 4;     // bytes of an fp32 tile
constexpr int SEG = 4;                 // chunks a segment of the state chains
constexpr int R = 2;                   // chunks between two kept states
constexpr int HB = 16;                 // heads a block of the chunk pass
constexpr int STATE = T * T;           // floats of a state tile in the scratch
constexpr long long MAX_POLLS = 1ll << 22;   // then a wait traps (seconds)
static_assert(SEG == 2 * R, "a segment holds two groups of R chunks");
static_assert(R == 2, "the chunk pass recomputes over one neighbouring chunk");

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

// *p += v, ordered after this thread's earlier writes (and those a barrier
// ordered before them) and before its later reads; returns the old value.
__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// A branch never taken, at the edge of two phases of the chunk pass: the
// compiler schedules each side on its own, where interleaving the phases
// would hold more values than the accumulators leave registers for
// (without these edges ptxas spilled 956 bytes of the bf16 chunk kernel).
__device__ __forceinline__ void phase_edge() {
  if (repro::opaque(threadIdx.x) == 0xffffffffu) __trap();
}

// A box of shared memory (laid out as the map's loads lay it out) into a
// 4-dimensional tensor at coordinates (c0 innermost .. c3), by TMA; the
// issuing thread commits it as a bulk group, and waits for the group's
// reads of shared memory (`bulk_wait_read`) before the box is written
// again, for its writes (`bulk_wait`) before the block ends.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(repro::smem_addr(src))
      : "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Waits for a phase of an mbarrier; traps after a bounded number of polls.
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  for (long long polls = 0; !repro::mbar_try_wait(bar, parity); ++polls)
    if (polls > MAX_POLLS) __trap();
}

// A thread's place in its warpgroup, and the accumulator layout of a
// 64 x 64 product (hopper.cuh): value e of the thread is at row row(e),
// column col(e).
struct Lane {
  int tid, warp, g, t;
  __device__ __forceinline__ Lane() : tid(threadIdx.x % WG), warp(threadIdx.x % WG / 32),
                                      g(threadIdx.x % 32 / 4), t(threadIdx.x % 4) {}
  __device__ __forceinline__ int row(int e) const { return 16 * warp + g + 8 * ((e >> 1) & 1); }
  __device__ __forceinline__ int col(int e) const { return 8 * (e >> 2) + 2 * t + (e & 1); }
};

__device__ __forceinline__ void zero(float (&d)[ACC]) {
#pragma unroll
  for (int e = 0; e < ACC; ++e) d[e] = 0.f;
}

// rows x cols of a matrix (row stride `stride`) into a tile, zeros past
// them, by the 128 threads of one warpgroup; the plain-load route.
template <bool BF>
__device__ __forceinline__ void load_tile(unsigned char* tile, const void* src, long long stride,
                                          int rows, int cols) {
  for (int e = threadIdx.x % WG; e < T * T; e += WG) {
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
// (first tile) + lo (the next), or fp32; a pair of the thread's values, e
// and e + 1 (e even), or all of them.  The caller fences the proxy before
// wgmma reads the tile (once for several tiles).
template <bool BF>
__device__ __forceinline__ void store_pair(unsigned char* tile, int e, float a, float b) {
  const Lane ln;
  const int row = ln.row(e), j = e >> 2;
  if constexpr (BF) {
    const int off = swz(row, j) + 4 * ln.t;
    uint32_t h, l;
    repro::split_bf16x2(a, b, h, l);
    *reinterpret_cast<uint32_t*>(tile + off) = h;
    *reinterpret_cast<uint32_t*>(tile + TILE + off) = l;
  } else {
    float* f = reinterpret_cast<float*>(tile) + row * LDF + ln.col(e);
    f[0] = a;
    f[1] = b;
  }
}

template <bool BF>
__device__ __forceinline__ void store_acc(const float (&v)[ACC], unsigned char* tile) {
#pragma unroll
  for (int e = 0; e < ACC; e += 2) store_pair<BF>(tile, e, v[e], v[e + 1]);
}

// A 64 x 64 fp32 tile in the scratch (a thread's 32 values as 8 float4).
__device__ __forceinline__ void read_state(const float* src, float (&v)[ACC]) {
  const float4* p = reinterpret_cast<const float4*>(src) + threadIdx.x % WG;
#pragma unroll
  for (int k = 0; k < ACC / 4; ++k) {
    const float4 q = __ldcg(p + k * WG);
    v[4 * k] = q.x;
    v[4 * k + 1] = q.y;
    v[4 * k + 2] = q.z;
    v[4 * k + 3] = q.w;
  }
}

__device__ __forceinline__ void write_state(float* dst, const float (&v)[ACC]) {
  float4* p = reinterpret_cast<float4*>(dst) + threadIdx.x % WG;
#pragma unroll
  for (int k = 0; k < ACC / 4; ++k)
    __stcg(p + k * WG, make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]));
}

// The same layout in shared memory.
__device__ __forceinline__ void write_smem_acc(float* dst, const float (&v)[ACC]) {
  float4* p = reinterpret_cast<float4*>(dst) + threadIdx.x % WG;
#pragma unroll
  for (int k = 0; k < ACC / 4; ++k)
    p[k * WG] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

__device__ __forceinline__ void add_smem_acc(const float* src, float (&v)[ACC]) {
  const float4* p = reinterpret_cast<const float4*>(src) + threadIdx.x % WG;
#pragma unroll
  for (int k = 0; k < ACC / 4; ++k) {
    const float4 q = p[k * WG];
    v[4 * k] += q.x;
    v[4 * k + 1] += q.y;
    v[4 * k + 2] += q.z;
    v[4 * k + 3] += q.w;
  }
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
    const int lane = threadIdx.x % 32, warp = threadIdx.x % WG / 32, t = lane % 4, m = lane >> 3;
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
  float* states;   // 2 x (B, ceil(nc / R), H) tiles: each group's S at its start, then G at its end
  float* parts;    // dB's and dC's group sums, then dA_log's and dD's (b, chunk, head) sums
  int* sync;       // the chains' tickets, finished blocks, and each (b, h)'s flags
  int B, S, H, P, N, L;
  long long x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;
  int groups;
  int tma;        // x, dy, B and C by TMA (else plain loads)
  int out_bf16;   // dB and dC in bf16 (else fp32)

  // The kept state tile of chain `role` (0: states, 1: gradients) for
  // group r of R chunks of (b, h).
  __device__ __forceinline__ float* kept(int role, int b, int r, int h) const {
    const int nr = (S / L + R - 1) / R;
    return states + ((((size_t)role * B + b) * nr + r) * H + h) * STATE;
  }
};

// The chunk's cumulative sums by one thread, in the plain version's order
// (product and sum each rounded; dt is 0 past L).  dt is read into
// registers first: read step by step, each read waited behind the last
// step's write (the compiler cannot tell the two rows apart).
__device__ __forceinline__ void cum_loop(const float* dt, float* cum, float A) {
  float d[T];
#pragma unroll
  for (int i = 0; i < T; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(dt + i);
    d[i] = v.x, d[i + 1] = v.y, d[i + 2] = v.z, d[i + 3] = v.w;
  }
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < T; i += 4) {
    float4 v;
    v.x = run = __fadd_rn(run, __fmul_rn(A, d[i]));
    v.y = run = __fadd_rn(run, __fmul_rn(A, d[i + 1]));
    v.z = run = __fadd_rn(run, __fmul_rn(A, d[i + 2]));
    v.w = run = __fadd_rn(run, __fmul_rn(A, d[i + 3]));
    *reinterpret_cast<float4*>(cum + i) = v;
  }
}

// ----------------------------------------------------- pass 1: the chains --
// Tile slots of a chain block: bf16 streams the segment's chunks through
// three (four blocks an SM), fp32 holds all of them.
__host__ __device__ constexpr int chain_slots(bool bf) { return bf ? 3 : SEG; }

struct ChainAux {
  float dt[SEG][T], cum[SEG][T], sc[SEG][T];   // sc: wl (states) or exp(cum) (gradients)
  float dec[SEG];
  uint64_t full[SEG];   // each slot's tiles
  int ticket;
};

template <bool BF>
__device__ __forceinline__ void chain_body(const Args& g, const CUtensorMap* t_a,
                                           const CUtensorMap* t_b, unsigned char* smem) {
  constexpr int TB_ = BF ? TILE : FTILE;
  constexpr int NS = chain_slots(BF);
  unsigned char* tiles = smem;                              // slot u: a at 2u, b at 2u + 1
  ChainAux& ax = *reinterpret_cast<ChainAux*>(smem + 2 * NS * TB_);
  const int tid = threadIdx.x;
  const int role = blockIdx.x & 1;                          // 0: states, 1: gradients
  const int BH = g.B * g.H, nc = g.S / g.L, n_seg = (nc + SEG - 1) / SEG;
  if (tid == 0) {
    ax.ticket = atomicAdd(g.sync + role, 1);
    if constexpr (BF) {
      for (int u = 0; u < NS; ++u) repro::mbar_init(&ax.full[u], 1);
      repro::fence_barrier_init();
    }
  }
  const bool tma = BF && g.tma;
  if (tma && g.L < T) {
    // TMA writes L rows of a tile: the rows past them stay zero.
    for (int e = tid; e < 2 * NS * TB_ / 16; e += WG)
      reinterpret_cast<uint4*>(tiles)[e] = make_uint4(0, 0, 0, 0);
    repro::fence_proxy_async();
  }
  __syncthreads();
  const int pos = ax.ticket / BH, bh = ax.ticket % BH;
  const int seg = role ? n_seg - 1 - pos : pos;
  const int b = bh / g.H, h = bh % g.H, first = seg * SEG, n = min(SEG, nc - first);

  // The segment's tiles, x and B (states) or dy and C (gradients), chunk k
  // of the chain's order into slot k % NS.
  const void* a_src = role ? g.dy : g.x;
  const void* b_src = role ? g.cm : g.bm;
  const long long a_sb = role ? (long long)g.S * g.H * g.P : g.x_sb;
  const long long a_ss = role ? (long long)g.H * g.P : g.x_ss;
  const long long b_sb = role ? g.c_sb : g.b_sb, b_ss = role ? g.c_ss : g.b_ss;
  auto load_chunk = [&](int k) {
    const int c = role ? n - 1 - k : k, u = k % NS;
    const long long r0 = (long long)(first + c) * g.L;
    if (tma) {
      if (tid == 0) {
        repro::mbar_arrive_expect_tx(&ax.full[u], 2 * g.L * 128);
        repro::tma_load_4d(tiles + 2 * u * TILE, t_a, &ax.full[u], 0, h, (int)r0, b);
        repro::tma_load_3d(tiles + (2 * u + 1) * TILE, t_b, &ax.full[u], 0, (int)r0, b);
      }
    } else {
      const int esz = BF ? 2 : 4;
      load_tile<BF>(tiles + 2 * u * TB_,
                    static_cast<const char*>(a_src) + (b * a_sb + r0 * a_ss + (long long)h * g.P) * esz,
                    a_ss, g.L, g.P);
      load_tile<BF>(tiles + (2 * u + 1) * TB_,
                    static_cast<const char*>(b_src) + (b * b_sb + r0 * b_ss) * esz, b_ss, g.L,
                    g.N);
      if constexpr (BF) repro::fence_proxy_async();
    }
  };
  // dt (read ahead of the tiles, which would queue it behind them), cum
  // (one thread a chunk), then the chain's scale and each decay.
  float dv[SEG * T / WG];
#pragma unroll
  for (int u = 0; u < SEG * T / WG; ++u) {
    const int e = tid + u * WG, c = e / T, i = e % T;
    dv[u] = c < n && i < g.L
                ? g.dt[((size_t)b * g.S + (size_t)(first + c) * g.L + i) * g.H + h] : 0.f;
  }
  const float A = -expf(g.a_log[h]);
  for (int k = 0; k < min(NS, n); ++k) load_chunk(k);
#pragma unroll
  for (int u = 0; u < SEG * T / WG; ++u) (&ax.dt[0][0])[tid + u * WG] = dv[u];
  __syncthreads();
  if (tid < n) cum_loop(ax.dt[tid], ax.cum[tid], A);
  __syncthreads();
  for (int e = tid; e < n * T; e += WG) {
    const int c = e / T, i = e % T;
    const float cl = ax.cum[c][T - 1];
    ax.sc[c][i] = role ? expf(ax.cum[c][i]) : expf(cl - ax.cum[c][i]) * ax.dt[c][i];
    if (i == 0) ax.dec[c] = expf(cl);
  }
  __syncthreads();

  // Sweep: the segment's own state from zero, in the chain's order; `mid`
  // keeps it after the segment's first group of R chunks in that order
  // (states: the first R chunks; gradients: the chunks past the last
  // multiple of R), where the segment holds a second.
  const int n_first = role ? n - R * ((n - 1) / R) : min(R, n);
  float s[ACC], mid[ACC];
  zero(s);
  float dseg = 1.f, dmid = 1.f;
  for (int k = 0; k < n; ++k) {
    const int c = role ? n - 1 - k : k, u = k % NS;
    const float dec = ax.dec[c];
#pragma unroll
    for (int e = 0; e < ACC; ++e) s[e] *= dec;
    dseg *= dec;
    if (tma) wait_phase(&ax.full[u], (k / NS) & 1);
    chain_update<BF>(s, tiles + 2 * u * TB_, tiles + (2 * u + 1) * TB_, ax.sc[c]);
    if (k == n_first - 1) {
#pragma unroll
      for (int e = 0; e < ACC; ++e) mid[e] = s[e];
      dmid = dseg;
    }
    if (k + NS < n) {
      // The slot is free once every warp's update has read it.
      if constexpr (BF) repro::fence_proxy_async();
      __syncthreads();
      load_chunk(k + NS);
      if (!tma) __syncthreads();
    }
  }

  // The look-back: the neighbour's inclusive state (states: the segment
  // before's, zero before the first; gradients: the segment after's, the
  // final state's gradient (or zero) after the last), which the neighbour
  // wrote into this segment's boundary tile.
  const int r_near = role ? (first + n - 1) / R : first / R;
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
    read_state(g.kept(role, b, r_near, h), s_in);
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

  // The inclusive state into the neighbour's boundary tile.
  if (pos + 1 < n_seg) {
#pragma unroll
    for (int e = 0; e < ACC; ++e) s[e] = dseg * s_in[e] + s[e];
    write_state(g.kept(role, b, role ? (first - 1) / R : (first + n) / R, h), s);
    __syncthreads();
    // A release store: the block's writes above (ordered before it by the
    // barrier) are seen by the neighbour that acquires the flag.
    if (tid == 0) st_release(flag, pos + 1);
  }
  // The block is done with the counters; the call's last block leaves them
  // zero for the next call (every block has then passed its wait and its
  // publish: the count is released after both).
  if (tid == 0 && atom_add_acq_rel(g.sync + 2, 1) == (int)gridDim.x - 1) {
    for (int e = 0; e < 3 + 2 * BH; ++e) g.sync[e] = 0;
    __threadfence();
  }

  // The boundary states: the near group's (where no neighbour wrote it),
  // and the far group's from `mid`.
  if (!waits) write_state(g.kept(role, b, r_near, h), s_in);
  if (n > R) {
#pragma unroll
    for (int e = 0; e < ACC; ++e) mid[e] = dmid * s_in[e] + mid[e];
    write_state(g.kept(role, b, role ? first / R : first / R + 1, h), mid);
  }
}

__global__ void __launch_bounds__(WG) ssm_bwd_state_kernel(const Args g) {
  extern __shared__ __align__(16) unsigned char chain_smem_f32[];
  chain_body<false>(g, nullptr, nullptr, chain_smem_f32);
}

__global__ void __launch_bounds__(WG, 4)
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
  return (bf ? 1024 + 2 * chain_slots(true) * TILE : 2 * SEG * FTILE) + sizeof(ChainAux);
}

// ------------------------------------------------- pass 2: the chunks --
// The shape of a chunk block: NCW consumer warpgroups, each with its own
// ring of two head stages (x and dy, loaded two heads ahead by its first
// thread); bf16 two, fp32 one.
template <bool BF>
struct ChunkCfg {
  static constexpr int NCW = BF ? 2 : 1;            // consumer warpgroups
  static constexpr int TB = BF ? TILE : FTILE;      // an input tile
  static constexpr int TF = BF ? 2 * TILE : FTILE;  // an fp32 operand's tile(s)
  static constexpr int THREADS = NCW * WG;
};

// Named barriers: 0 is __syncthreads's; consumer cw's own is 1 + cw.
constexpr int BAR_CONSUMERS = 3;   // both consumers

// The block's tables, per head of its group: chunk c's dt, cum, exp(cum)
// and decay; the neighbouring chunk's chain scale (wl for a state,
// exp(cum) for a gradient) and decay.
struct HeadTables {
  float dt[HB][T], cum[HB][T], ec[HB][T], sc[HB][T];
  float dec[HB], decn[HB];
};

// A consumer's sums of its current head for cum's gradient, by warp.
struct HeadSums {
  float rowq[T], colr[4][T], decum[T], dwl[T], ddec[4], dd[4];
};

// A head's gradient of cum, before its sum in reverse at the block's end:
// each row's term (dcum), the terms of ddt outside the sum (direct), wl's
// tail terms, which stand at row L - 1 (tv), and the decay's (tail).
struct HeadOut {
  float dcum[T], direct[T], tv[T];
  float tail;
};

struct ChunkAux {
  HeadTables tb;
  HeadSums sums[2];      // [consumer]
  HeadOut out[HB];       // before the first head, the neighbour's cum
  // [consumer][stage]: x and dy; [consumer]: S, G and the neighbouring tile
  uint64_t bc_full, full[2][2], head_full[2];
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

// The sums over the 8 rows (lanes g) of a thread's 16 columns (v[q]:
// column 8 (q >> 1) + 2t + (q & 1)), scattered: lane (g, t) is left with
// columns 8g + 2t and 8g + 2t + 1, in out[0] and out[1].  Three halvings
// of 8, 4 and 2 shuffles, each lane keeping the half its g bit names.
__device__ __forceinline__ void col_sums(const float (&v)[16], float (&out)[2]) {
  const int g = threadIdx.x % 32 / 4;
  float a[8], b[4];
  const bool b2 = g & 4, b1 = g & 2, b0 = g & 1;
#pragma unroll
  for (int m = 0; m < 8; ++m)
    a[m] = (b2 ? v[m + 8] : v[m]) + __shfl_xor_sync(0xffffffffu, b2 ? v[m] : v[m + 8], 16);
#pragma unroll
  for (int m = 0; m < 4; ++m)
    b[m] = (b1 ? a[m + 4] : a[m]) + __shfl_xor_sync(0xffffffffu, b1 ? a[m] : a[m + 4], 8);
#pragma unroll
  for (int m = 0; m < 2; ++m)
    out[m] = (b0 ? b[m + 2] : b[m]) + __shfl_xor_sync(0xffffffffu, b0 ? b[m] : b[m + 2], 4);
}

// Where a chunk block's work lies.
struct ChunkPlace {
  int b, c, grp, h0, nh, near;   // near: the chunk the states are recomputed over, or -1
  bool fwd;                      // near is before c (the state), else after (the gradient)
  long long r0;
};

__device__ __forceinline__ ChunkPlace chunk_place(const Args& g) {
  ChunkPlace p;
  const int nc = g.S / g.L;
  p.grp = blockIdx.x % g.groups;
  const int bc = blockIdx.x / g.groups;
  p.b = bc / nc;
  p.c = bc % nc;
  p.h0 = p.grp * HB;
  p.nh = min(HB, g.H - p.h0);
  p.fwd = p.c % R > 0;
  p.near = p.fwd ? p.c - 1 : (p.c + 1 < nc ? p.c + 1 : -1);
  p.r0 = (long long)p.c * g.L;
  return p;
}

// The tensor maps of x, dy, B and C (null on the plain-load route).
struct Maps {
  const CUtensorMap *x, *dy, *b, *c, *dx;
};

// A consumer warpgroup's place in the block: its tiles, its heads, and the
// loads its first thread issues ahead of them.
template <bool BF>
struct Consumer {
  using C = ChunkCfg<BF>;
  const Args& g;
  const ChunkPlace& pl;
  const Maps& m;
  ChunkAux& ax;
  int cw, n_mine;
  unsigned char* ring;   // stage s: x, dy
  unsigned char* t_sg;   // S's fp32 tile on arrival; S_c split; (dy x^T) w split
  unsigned char* t_wg;   // (C B^T) w split; dx staged (hi half), the neighbour's x or dy (lo)
  unsigned char* t_wm;   // G's fp32 tile on arrival; G_c split
  bool tma, near_tma;
  const float *ks, *kg;  // the kept state and gradient of the first head; the next NCW tiles on

  __device__ __forceinline__ int head(int k) const { return pl.h0 + cw + C::NCW * k; }
  // Where the neighbouring tile lands: beside the staged dx.
  __device__ __forceinline__ unsigned char* t_near() const { return t_wg + (BF ? TILE : 0); }

  // Head k's x and dy into stage k % 2.
  __device__ __forceinline__ void issue_tiles(int k) const {
    if (!tma || threadIdx.x % WG != 0 || k >= n_mine) return;
    unsigned char* st = ring + (k % 2) * 2 * C::TB;
    uint64_t* full = &ax.full[cw][k % 2];
    repro::mbar_arrive_expect_tx(full, 2 * g.L * 128);
    repro::tma_load_4d(st, m.x, full, 0, head(k), (int)pl.r0, pl.b);
    repro::tma_load_4d(st + C::TB, m.dy, full, 0, head(k), (int)pl.r0, pl.b);
  }
  // Head k's kept state and gradient (into t_sg and t_wm) and neighbouring
  // tile, once the previous head's products are done with those tiles.
  __device__ __forceinline__ void issue_head(int k) const {
    if (threadIdx.x % WG != 0 || k >= n_mine) return;
    uint64_t* full = &ax.head_full[cw];
    const size_t at = (size_t)k * C::NCW * STATE;
    repro::mbar_arrive_expect_tx(full, 2 * STATE * 4 + (near_tma ? T * 128 : 0));
    repro::bulk_load(t_sg, ks + at, STATE * 4, full);
    repro::bulk_load(t_wm, kg + at, STATE * 4, full);
    if (near_tma)
      repro::tma_load_4d(t_near(), pl.fwd ? m.x : m.dy, full, 0, head(k), pl.near * g.L, pl.b);
  }
};

// The sum in reverse within the chunk of head i's gradient of cum, by one
// warp: rows lane and lane + 32 (all of them 0 past L); each half's suffix
// sums by shuffles, the upper half's total carried into the lower; the
// tail's terms stand at row L - 1 and so reach every row.  Then ddt, and
// the (b, chunk, head)'s sum for dA_log.
__device__ __forceinline__ void reverse_sum(const Args& g, const ChunkPlace& pl,
                                            const HeadTables& tb, const HeadOut& out, int i) {
  const int lane = threadIdx.x % 32, h = pl.h0 + i, nc = g.S / g.L;
  const float* dt = tb.dt[i];
  float rc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rc[r] = out.dcum[lane + 32 * r];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_down_sync(0xffffffffu, rc[r], off);
      if (lane + off < 32) rc[r] += v;
    }
  }
  rc[0] += __shfl_sync(0xffffffffu, rc[1], 0);
  const float tail = sum_warp(out.tv[lane] + out.tv[lane + 32]) + out.tail;
  const float A = -expf(g.a_log[h]);
  float da = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i_ = lane + 32 * r;
    if (i_ < g.L) {
      rc[r] += tail;
      g.ddt[((size_t)pl.b * g.S + pl.r0 + i_) * g.H + h] = out.direct[i_] + A * rc[r];
      da += dt[i_] * rc[r];
    }
  }
  da = sum_warp(da);
  if (lane == 0)
    g.parts[2 * (size_t)g.B * g.S * g.groups * g.N + ((size_t)pl.b * nc + pl.c) * g.H + h] = da;
}

// Two neighbouring values (c even) of an input tile's row r.
template <bool BF>
__device__ __forceinline__ float2 at2(const unsigned char* tile, int r, int c) {
  if constexpr (BF) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(tile + swz(r, c >> 3) + (c & 7) * 2);
    return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
  } else {
    return *reinterpret_cast<const float2*>(reinterpret_cast<const float*>(tile) + r * LDF + c);
  }
}

// A consumer: the heads cw, cw + NCW, ... of the block's group.
template <bool BF>
__device__ __forceinline__ void chunk_consumer(const Consumer<BF>& q, const unsigned char* t_bc,
                                               unsigned char* work) {
  using C = ChunkCfg<BF>;
  using OutT = typename std::conditional<BF, __nv_bfloat16, float>::type;
  const Args& g = q.g;
  const ChunkPlace& pl = q.pl;
  ChunkAux& ax = q.ax;
  const int cw = q.cw, n_mine = q.n_mine;
  const int tid = threadIdx.x % WG;
  const Lane ln;
  const int bar = 1 + cw;
  const int b = pl.b, nc = g.S / g.L;
  const unsigned char* t_b = t_bc;
  const unsigned char* t_c = t_bc + C::TB;
  const unsigned char* t_n = t_bc + 2 * C::TB;    // B or C of the neighbouring chunk
  unsigned char* t_sg = q.t_sg;
  unsigned char* t_wg = q.t_wg;
  unsigned char* t_wm = q.t_wm;
  unsigned char* t_nn = q.t_near();                // x or dy of the neighbouring chunk
  const HeadTables& tb = ax.tb;
  HeadSums& sm = ax.sums[cw];
  const int esz = BF ? 2 : 4;
  const long long dy_ss = (long long)g.H * g.P, dy_sb = (long long)g.S * dy_ss;
  const long long rn = (long long)pl.near * g.L;
  const int row0 = 16 * ln.warp + ln.g;           // the thread's rows: row0, row0 + 8

  if (q.tma) wait_phase(&ax.bc_full, 0);
  float db[ACC], dc[ACC];
  zero(db);
  zero(dc);
  for (int k = 0; k < n_mine; ++k) {
    const int i = cw + C::NCW * k, h = pl.h0 + i, s = k % 2;
    const float Dh = g.d_skip[h];
    const float* dt = tb.dt[i];
    const float* cum = tb.cum[i];
    const float* ec = tb.ec[i];
    const float cl = cum[T - 1];
    unsigned char* t_x = q.ring + s * 2 * C::TB;
    unsigned char* t_dy = t_x + C::TB;

    // The head's tiles and states.
    if (!q.tma) {
      const char* x = static_cast<const char*>(g.x) + (b * g.x_sb + (long long)h * g.P) * esz;
      load_tile<BF>(t_x, x + pl.r0 * g.x_ss * esz, g.x_ss, g.L, g.P);
      const char* dy = static_cast<const char*>(g.dy) + (b * dy_sb + (long long)h * g.P) * esz;
      load_tile<BF>(t_dy, dy + pl.r0 * dy_ss * esz, dy_ss, g.L, g.P);
    }
    if (pl.near >= 0 && !q.near_tma) {
      if (pl.fwd) {
        const char* x = static_cast<const char*>(g.x) + (b * g.x_sb + (long long)h * g.P) * esz;
        load_tile<BF>(t_nn, x + rn * g.x_ss * esz, g.x_ss, g.L, g.P);
      } else {
        const char* dy = static_cast<const char*>(g.dy) + (b * dy_sb + (long long)h * g.P) * esz;
        load_tile<BF>(t_nn, dy + rn * dy_ss * esz, dy_ss, g.L, g.P);
      }
    }
    float sv[ACC], gv[ACC];
    wait_phase(&ax.head_full[cw], k & 1);
    {
      const float4* ps = reinterpret_cast<const float4*>(t_sg) + tid;
      const float4* pg = reinterpret_cast<const float4*>(t_wm) + tid;
#pragma unroll
      for (int kk = 0; kk < ACC / 4; ++kk) {
        const float4 a = ps[kk * WG], c4 = pg[kk * WG];
        sv[4 * kk] = a.x, sv[4 * kk + 1] = a.y, sv[4 * kk + 2] = a.z, sv[4 * kk + 3] = a.w;
        gv[4 * kk] = c4.x, gv[4 * kk + 1] = c4.y, gv[4 * kk + 2] = c4.z, gv[4 * kk + 3] = c4.w;
      }
    }
    if (q.tma) wait_phase(&ax.full[cw][s], (k / 2) & 1);
    if constexpr (BF) repro::fence_proxy_async();
    if (tid == 0) bulk_wait_read();   // the last head's dx store is done with its tile
    repro::named_bar_sync(bar, WG);   // the states are read, the plain loads written

    phase_edge();
    // The chunk's states, recomputed over the neighbouring chunk of its
    // group: S_c = dec S + (wl x)^T B from the group's start, or G_c = dec G
    // + (e^cum dy)^T C from its end.
    if (pl.near >= 0) {
      const float d = tb.decn[i];
      if (pl.fwd) {
#pragma unroll
        for (int e = 0; e < ACC; ++e) sv[e] *= d;
        chain_update<BF>(sv, t_nn, t_n, tb.sc[i]);
      } else {
#pragma unroll
        for (int e = 0; e < ACC; ++e) gv[e] *= d;
        chain_update<BF>(gv, t_nn, t_n, tb.sc[i]);
      }
    }
    float dsg = 0.f;   // this thread's part of the sum of S_c G_c (dec's gradient)
#pragma unroll
    for (int e = 0; e < ACC; ++e) dsg += sv[e] * gv[e];
    store_acc<BF>(sv, t_sg);
    store_acc<BF>(gv, t_wm);
    if constexpr (BF) repro::fence_proxy_async();
    repro::named_bar_sync(bar, WG);

    phase_edge();
    // C B^T and dy x^T, then the weighted matrices and the sums of cum's
    // gradient from w.
    // dy S first, alone (with the next two products its accumulators would
    // leave too few registers): dC's state term and the row dots of dy S
    // with C.
    float gm[ACC], mm[ACC], uu[ACC];
    issue_begin<BF>();
    mma_fb<BF, 0, 1>(uu, t_dy, t_sg, false);
    issue_end<BF>();
    if constexpr (BF) repro::fence_regs(uu);
    const float ecr[2] = {ec[row0], ec[row0 + 8]};
    float de[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < ACC; e += 2) {
      const int r = (e >> 1) & 1;
      const float2 cv = at2<BF>(t_c, row0 + 8 * r, ln.col(e));
      de[r] += uu[e] * cv.x + uu[e + 1] * cv.y;
      dc[e] += ecr[r] * uu[e];
      dc[e + 1] += ecr[r] * uu[e + 1];
    }
    issue_begin<BF>();
    mma<BF, 0, 0>(gm, t_c, t_b, false);
    mma<BF, 0, 0>(mm, t_dy, t_x, false);
    issue_end<BF>();
    if constexpr (BF) {
      repro::fence_regs(gm);
      repro::fence_regs(mm);
    }
    phase_edge();
    repro::named_bar_sync(bar, WG);   // every warp's products are done with S_c
    {
      const float cumr[2] = {cum[row0], cum[row0 + 8]};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = sum_t(de[r]);
        if (ln.t == 0) sm.decum[row0 + 8 * r] = v;
      }
      float rq[2] = {0.f, 0.f}, cr[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) cr[u] = 0.f;
#pragma unroll
      for (int e = 0; e < ACC; e += 2) {
        const int r = (e >> 1) & 1, i_ = row0 + 8 * r, j = ln.col(e);
        const float2 cj = *reinterpret_cast<const float2*>(cum + j);
        const float2 dtj = *reinterpret_cast<const float2*>(dt + j);
        float wg[2], wm[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          wg[u] = 0.f;
          wm[u] = 0.f;
          if (j + u <= i_) {
            const float ee = exp_fast(cumr[r] - (u ? cj.y : cj.x));
            const float dtv = u ? dtj.y : dtj.x;
            const float w = ee * dtv;
            const float rr = gm[e + u] * mm[e + u] * ee;
            wg[u] = gm[e + u] * w;
            wm[u] = mm[e + u] * w;
            rq[r] += rr * dtv;
            cr[2 * (e >> 2) + u] += rr;
          }
        }
        store_pair<BF>(t_wg, e, wg[0], wg[1]);
        store_pair<BF>(t_sg, e, wm[0], wm[1]);
      }
      if constexpr (BF) repro::fence_proxy_async();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = sum_t(rq[r]);
        if (ln.t == 0) sm.rowq[row0 + 8 * r] = v;
      }
      float cs[2];
      col_sums(cr, cs);
      *reinterpret_cast<float2*>(&sm.colr[ln.warp][8 * ln.g + 2 * ln.t]) = make_float2(cs[0], cs[1]);
    }
    repro::named_bar_sync(bar, WG);

    phase_edge();
    // The group's Wm B and Wm^T C; B G^T (dx's state term) and x G (dB's).
    float vx[ACC], yy[ACC];
    issue_begin<BF>();
    mma_fa<BF, 0, 1>(dc, t_sg, t_b, true);
    mma_fa<BF, 1, 1>(db, t_sg, t_c, true);
    mma_fb<BF, 0, 0>(vx, t_b, t_wm, false);
    mma_fb<BF, 0, 1>(yy, t_x, t_wm, false);
    issue_end<BF>();
    if constexpr (BF) {
      repro::fence_regs(dc);
      repro::fence_regs(db);
      repro::fence_regs(vx);
      repro::fence_regs(yy);
    }

    phase_edge();
    // dB's state term, the sums of wl's and D's gradients, wl (B G^T).
    float wl[2], dw[2] = {0.f, 0.f}, dd = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) wl[r] = expf(cl - cum[row0 + 8 * r]) * dt[row0 + 8 * r];
#pragma unroll
    for (int e = 0; e < ACC; e += 2) {
      const int r = (e >> 1) & 1, j = row0 + 8 * r, p = ln.col(e);
      const float2 y = at2<BF>(t_dy, j, p), x = at2<BF>(t_x, j, p);
      dd += y.x * x.x + y.y * x.y;
      dw[r] += vx[e] * x.x + vx[e + 1] * x.y;
      db[e] += wl[r] * yy[e];
      db[e + 1] += wl[r] * yy[e + 1];
      vx[e] *= wl[r];
      vx[e + 1] *= wl[r];
    }

    phase_edge();
    // dx = wl (B G^T) + Wg^T dy + D dy.
    issue_begin<BF>();
    if constexpr (BF) repro::fence_regs(vx);
    mma_fa<BF, 1, 1>(vx, t_wg, t_dy, true);
    issue_end<BF>();
    if constexpr (BF) repro::fence_regs(vx);
    repro::named_bar_sync(bar, WG);   // every warp is done with the Wm, G and Wg tiles
    phase_edge();
    q.issue_head(k + 1);
    {
      OutT* dxb = static_cast<OutT*>(g.dx) + ((size_t)b * g.S + pl.r0) * g.H * g.P + (size_t)h * g.P;
#pragma unroll
      for (int e = 0; e < ACC; e += 2) {
        const int j = row0 + 8 * ((e >> 1) & 1), p = ln.col(e);
        const float2 y = at2<BF>(t_dy, j, p);
        const float v0 = vx[e] + Dh * y.x, v1 = vx[e + 1] + Dh * y.y;
        if constexpr (BF) {
          *reinterpret_cast<uint32_t*>(t_wg + swz(j, p >> 3) + (p & 7) * 2) =
              repro::pack_bf16x2(v0, v1);
        } else {
          if (j >= g.L || p >= g.P) continue;
          OutT* dst = dxb + (size_t)j * g.H * g.P + p;
          dst[0] = v0;
          if (p + 1 < g.P) dst[1] = v1;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = sum_t(dw[r]);
        if (ln.t == 0) sm.dwl[row0 + 8 * r] = v;
      }
      dd = sum_warp(dd);
      dsg = sum_warp(dsg);
      if (ln.g == 0 && ln.t == 0) {
        sm.dd[ln.warp] = dd;
        sm.ddec[ln.warp] = dsg;
      }
      if constexpr (BF) repro::fence_proxy_async();   // the staged dx, before TMA reads it
      repro::named_bar_sync(bar, WG);   // dx is staged, the head's sums are in
      if constexpr (BF) {
        // dx's rows from the staged tile: by TMA, or 16 bytes a thread at a time.
        const bool whole = g.P % 8 == 0;
        if (q.tma) {
          if (tid == 0) tma_store_4d(q.m.dx, t_wg, 0, h, (int)pl.r0, b);
        } else {
          for (int u = tid; u < T * 8; u += WG) {
            const int j = u / 8, pc = u % 8;
            if (j >= g.L || 8 * pc >= g.P) continue;
            const uint4 v = *reinterpret_cast<const uint4*>(t_wg + swz(j, pc));
            __nv_bfloat16* dst = dxb + (size_t)j * g.H * g.P + 8 * pc;
            if (whole) {
              *reinterpret_cast<uint4*>(dst) = v;
            } else {
              const uint16_t* w = reinterpret_cast<const uint16_t*>(&v);
              for (int e = 0; e < 8 && 8 * pc + e < g.P; ++e)
                reinterpret_cast<uint16_t*>(dst)[e] = w[e];
            }
          }
        }
      }
    }
    phase_edge();
    // The gradient of cum row by row, for its sum in reverse at the
    // block's end; D's gradient.
    if (tid < T) {
      HeadOut& o = ax.out[i];
      const float col = sm.colr[0][tid] + sm.colr[1][tid] + sm.colr[2][tid] + sm.colr[3][tid];
      const float el = expf(cl - cum[tid]);
      const float t = sm.dwl[tid] * (el * dt[tid]);
      o.dcum[tid] = sm.rowq[tid] - dt[tid] * col + sm.decum[tid] * ec[tid] - t;
      o.direct[tid] = col + sm.dwl[tid] * el;
      o.tv[tid] = t;
      if (tid == 0) {
        o.tail = (sm.ddec[0] + sm.ddec[1] + sm.ddec[2] + sm.ddec[3]) * tb.dec[i];
        g.parts[2 * (size_t)g.B * g.S * g.groups * g.N + (size_t)g.B * nc * g.H +
                ((size_t)b * nc + pl.c) * g.H + h] = sm.dd[0] + sm.dd[1] + sm.dd[2] + sm.dd[3];
      }
    }
    if constexpr (BF) repro::fence_proxy_async();   // before TMA writes the stage again
    repro::named_bar_sync(bar, WG);
    q.issue_tiles(k + 2);                            // into the stage this head is done with
    phase_edge();
    // The head is done.
  }

  // The consumer's dB and dC, summed over the consumers in order (the
  // second's handed over in its working tiles), fp32; then each head's sum
  // in reverse, a warp a head.
  float* hand = reinterpret_cast<float*>(work + 3 * C::TF);
  if (tid == 0) bulk_wait();        // dx's last stores are written and done with their tile
  repro::named_bar_sync(bar, WG);
  if (C::NCW == 2 && cw == 1) {
    write_smem_acc(hand, db);
    write_smem_acc(hand + STATE, dc);
  }
  if constexpr (C::NCW == 2) repro::named_bar_sync(BAR_CONSUMERS, 2 * WG);
  else repro::named_bar_sync(bar, WG);
  for (int hh = threadIdx.x / 32; hh < pl.nh; hh += C::THREADS / 32)
    reverse_sum(g, pl, tb, ax.out[hh], hh);
  if (cw == 1) return;
  if constexpr (C::NCW == 2) {
    add_smem_acc(hand, db);
    add_smem_acc(hand + STATE, dc);
  }
  float* pb = g.parts + (((size_t)b * g.S + pl.r0) * g.groups + pl.grp) * g.N;
  float* pc = pb + (size_t)g.B * g.S * g.groups * g.N;
  const bool pairs = g.N % 2 == 0;
#pragma unroll
  for (int e = 0; e < ACC; e += 2) {
    const int i_ = ln.row(e), n = ln.col(e);
    if (i_ >= g.L || n >= g.N) continue;
    const size_t at = (size_t)i_ * g.groups * g.N + n;
    if (pairs) {
      *reinterpret_cast<float2*>(pb + at) = make_float2(db[e], db[e + 1]);
      *reinterpret_cast<float2*>(pc + at) = make_float2(dc[e], dc[e + 1]);
    } else {
      pb[at] = db[e];
      pc[at] = dc[e];
      if (n + 1 < g.N) {
        pb[at + 1] = db[e + 1];
        pc[at + 1] = dc[e + 1];
      }
    }
  }
}

template <bool BF>
__device__ __forceinline__ void chunk_body(const Args& g, const Maps& m, unsigned char* smem) {
  using C = ChunkCfg<BF>;
  unsigned char* t_bc = smem;                         // B, C, and B or C of the neighbour
  unsigned char* ring = t_bc + 3 * C::TB;             // per consumer, stage s: x, dy
  unsigned char* work = ring + C::NCW * 4 * C::TB;    // per consumer: S / G, Wg, Wm
  ChunkAux& ax = *reinterpret_cast<ChunkAux*>(work + C::NCW * 3 * C::TF);
  float* cumn = &ax.out[0].dcum[0];                   // the neighbour's cum, before any head
  static_assert(sizeof(ax.out) >= HB * T * 4, "the neighbour's cum fits the heads' outputs");
  const int tid = threadIdx.x;
  const ChunkPlace pl = chunk_place(g);
  const bool tma = BF && g.tma;
  const int cw = tid / WG;
  const Consumer<BF> q{g, pl, m, ax, cw, (pl.nh - cw + C::NCW - 1) / C::NCW,
                       ring + cw * 4 * C::TB, work + cw * 3 * C::TF,
                       work + cw * 3 * C::TF + C::TF, work + cw * 3 * C::TF + 2 * C::TF,
                       tma, tma && g.L == T && pl.near >= 0,
                       g.kept(0, pl.b, pl.c / R, pl.h0 + cw), g.kept(1, pl.b, pl.c / R, pl.h0 + cw)};

  if (tid == 0) {
    repro::mbar_init(&ax.bc_full, 1);
    for (int w = 0; w < 2; ++w) {
      repro::mbar_init(&ax.full[w][0], 1);
      repro::mbar_init(&ax.full[w][1], 1);
      repro::mbar_init(&ax.head_full[w], 1);
    }
    repro::fence_barrier_init();
  }
  if (tma && g.L < T) {
    // TMA writes L rows of a tile: the rows past them stay zero.
    for (int e = tid; e < (3 + C::NCW * 4) * C::TB / 16; e += C::THREADS)
      reinterpret_cast<uint4*>(t_bc)[e] = make_uint4(0, 0, 0, 0);
    repro::fence_proxy_async();
  }
  __syncthreads();

  // The tables of the group's heads: dt of the chunk and of the neighbour
  // (read ahead of the first loads, which would queue it behind them), each
  // cum by one thread, then the exps.
  HeadTables& tab = ax.tb;
  constexpr int PER = HB * T / C::THREADS;    // dt values a thread reads, of each chunk
  const long long rn = (long long)pl.near * g.L;
  float dv[PER], dn[PER];
  // A of the head whose cum this thread sums (below).
  const int cum_head = tid < pl.nh ? tid : (tid >= 64 && tid < 64 + pl.nh ? tid - 64 : -1);
  const float a_cum = cum_head >= 0 ? -expf(g.a_log[pl.h0 + cum_head]) : 0.f;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = tid + u * C::THREADS, hh = e % HB, i = e / HB;   // neighbours on neighbouring heads
    const size_t col = (size_t)pl.h0 + hh;
    const bool in = hh < pl.nh && i < g.L;
    dv[u] = in ? g.dt[((size_t)pl.b * g.S + pl.r0 + i) * g.H + col] : 0.f;
    dn[u] = in && pl.near >= 0 ? g.dt[((size_t)pl.b * g.S + rn + i) * g.H + col] : 0.f;
  }

  // The first loads, under the tables: B and C of the chunk and of its
  // neighbour, each consumer's first two heads' tiles and first states.
  const int esz = BF ? 2 : 4;
  if (tma) {
    if (tid == 0) {
      repro::mbar_arrive_expect_tx(&ax.bc_full, (2 + (pl.near >= 0)) * g.L * 128);
      repro::tma_load_3d(t_bc, m.b, &ax.bc_full, 0, (int)pl.r0, pl.b);
      repro::tma_load_3d(t_bc + C::TB, m.c, &ax.bc_full, 0, (int)pl.r0, pl.b);
      if (pl.near >= 0)
        repro::tma_load_3d(t_bc + 2 * C::TB, pl.fwd ? m.b : m.c, &ax.bc_full, 0, (int)rn, pl.b);
    }
  } else if (tid < WG) {
    const char* bm = static_cast<const char*>(g.bm) + pl.b * g.b_sb * esz;
    const char* cm = static_cast<const char*>(g.cm) + pl.b * g.c_sb * esz;
    load_tile<BF>(t_bc, bm + pl.r0 * g.b_ss * esz, g.b_ss, g.L, g.N);
    load_tile<BF>(t_bc + C::TB, cm + pl.r0 * g.c_ss * esz, g.c_ss, g.L, g.N);
    if (pl.near >= 0) {
      if (pl.fwd) load_tile<BF>(t_bc + 2 * C::TB, bm + rn * g.b_ss * esz, g.b_ss, g.L, g.N);
      else load_tile<BF>(t_bc + 2 * C::TB, cm + rn * g.c_ss * esz, g.c_ss, g.L, g.N);
    }
    if constexpr (BF) repro::fence_proxy_async();
  }
  q.issue_tiles(0);
  q.issue_tiles(1);
  q.issue_head(0);

#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = tid + u * C::THREADS, hh = e % HB, i = e / HB;
    tab.dt[hh][i] = dv[u];
    tab.sc[hh][i] = dn[u];
  }
  __syncthreads();
  if (tid < pl.nh) {
    cum_loop(tab.dt[tid], tab.cum[tid], a_cum);
  } else if (tid >= 64 && tid < 64 + pl.nh && pl.near >= 0) {
    cum_loop(tab.sc[cum_head], cumn + cum_head * T, a_cum);
  }
  __syncthreads();
  for (int e = tid; e < pl.nh * T; e += C::THREADS) {
    const int hh = e / T, i = e % T;
    const float cl = tab.cum[hh][T - 1], cu = tab.cum[hh][i];
    tab.ec[hh][i] = expf(cu);
    if (i == 0) tab.dec[hh] = expf(cl);
    if (pl.near >= 0) {
      const float* cn = cumn + hh * T;
      tab.sc[hh][i] = pl.fwd ? expf(cn[T - 1] - cn[i]) * tab.sc[hh][i] : expf(cn[i]);
      if (i == 0) tab.decn[hh] = expf(cn[T - 1]);
    }
  }
  __syncthreads();

  chunk_consumer<BF>(q, t_bc, work);
}

__global__ void __launch_bounds__(ChunkCfg<false>::THREADS, 1) ssm_bwd_chunk_kernel(const Args g) {
  extern __shared__ __align__(16) unsigned char chunk_smem_f32[];
  chunk_body<false>(g, Maps{nullptr, nullptr, nullptr, nullptr, nullptr}, chunk_smem_f32);
}

__global__ void __launch_bounds__(ChunkCfg<true>::THREADS, 1)
ssm_bwd_chunk_wgmma_kernel(const Args g, const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tdy,
                           const __grid_constant__ CUtensorMap tb,
                           const __grid_constant__ CUtensorMap tc,
                           const __grid_constant__ CUtensorMap tdx) {
  extern __shared__ unsigned char chunk_smem_raw[];
  const uint32_t raw = repro::smem_addr(chunk_smem_raw);
  unsigned char* smem = chunk_smem_raw + (((raw + 1023) & ~1023u) - raw);
  chunk_body<true>(g, Maps{&tx, &tdy, &tb, &tc, &tdx}, smem);
}

template <bool BF>
size_t chunk_smem_of() {
  using C = ChunkCfg<BF>;
  return (BF ? 1024 : 0) + (3 + C::NCW * 4) * C::TB + C::NCW * 3 * C::TF + sizeof(ChunkAux);
}

size_t chunk_smem(bool bf) { return bf ? chunk_smem_of<true>() : chunk_smem_of<false>(); }

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
// type.  Scratch: states, 2 * B * ceil(S / chunk / 2) * H * 4096 fp32 (the
// states two chunks apart); parts, 2 * B * S * ceil(H / 16) * N
// + 2 * B * (S / chunk) * H fp32; sync, 3 + 2 * B * H ints, zero (and left
// zero).  Strides count elements.  chunk, P and N in [1, 64]; S a multiple
// of chunk.
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
  const int nc = S / chunk, n_seg = (nc + SEG - 1) / SEG, groups = (H + HB - 1) / HB;
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
                     aligned(x) && aligned(bm) && aligned(cm) && aligned(dy) && aligned(dx);
    CUtensorMap tx{}, tdy{}, tb{}, tc{}, tdx{};
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
          !bf16_map(&tdx, dx, 4, xd, ys, xbox) ||
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
    ssm_bwd_chunk_wgmma_kernel<<<(unsigned)chunk_blocks, ChunkCfg<true>::THREADS, s2, st>>>(
        g, tx, tdy, tb, tc, tdx);
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
    ssm_bwd_chunk_kernel<<<(unsigned)chunk_blocks, ChunkCfg<false>::THREADS, s2, st>>>(g);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  ssm_bwd_sum_kernel<<<(unsigned)((elems + H + 255) / 256), 256, 0, st>>>(g, (int)elems);
  return (int)cudaGetLastError();
}
