// Blockwise attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention  (_flash_kernel,
//   pallas_call at :127)
//
//   o[b, h, i] = sum_j softmax_j(s_ij) v[b, h / rep, j],
//   s_ij = softcap * tanh(scale * q_i . k_j / softcap)   (softcap optional)
//
// q [B, Hq, Tq, D], k and v [B, Hkv, Tk, D] (GQA: rep = Hq / Hkv), queries
// right-aligned against the keys (q_pos = i + Tk - Tq; Tq > Tk only with
// no mask, an enc-dec model's cross-attention), causal and
// sliding-window masks (keys in (q_pos - window, q_pos]), m, l and the
// accumulator in f32, a row with no visible key written as 0 (the l == 0
// guard), output in q's type (f32 or bf16). Every tensor is addressed
// through strides in elements (the last axis contiguous, the others and
// the base 16-byte aligned), so the callers' [B, T, H, D] projections are
// read in place and the output is written straight into the
// [B, Tq, Hq, D] layout the output projection reads.
//
// Two bodies, one per type; a call takes its type's body or fails:
//
// * bf16 (every serving prefill): flash_tc, on the tensor cores.
// * f32 (an enc-dec model's encoder and cross-attention over f32 frames):
//   flash_simt, f32 FMAs on the CUDA cores, with keys split across blocks
//   when a call has few query tiles, and flash_simt_merge (held to its
//   plain version at 2e-5, which bf16 operands, or one TF32 pass, could
//   not meet).
//
// Bound: at a prefill of Tq = Tk = 1024 with granite's 32/8 heads and
// D = 64 the kernel does 4*32*1024^2*64/2 = 4.3 GFLOP of visible pairs over
// 10.5 MB of q, k, v and o: about 410 FLOP per byte, above the card's
// ridge, so it is bound by operations (4.3 us at the bf16 tensor-core
// peak).
//
// Design of the bf16 body. The Pallas grid (B, Hq, nq, nk) carried m, l
// and acc in VMEM scratch along the sequential nk axis. Blocks on this
// card run in no order, so one block owns one (b, head, 64-query tile)
// and loops over the 64-key tiles itself, with m, l and the accumulator
// in registers. The block is one consumer warpgroup (4 warps, 128
// threads, 16 query rows a warp) and one producer warp:
//
// * The producer issues TMA loads (cp.async.bulk.tensor, 4-d maps of the
//   callers' strides, 128-byte swizzle) of the Q tile once and of the K
//   and V tiles into a ring of 2-4 stages; each stage has a "full" (K and
//   V landed) and an "empty" (one arrival a consumer warp) mbarrier. Rows
//   past Tq or Tk arrive as zeros (TMA's out-of-bounds fill) and are
//   masked, so there is no padding and no read across heads.
// * S = Q K^T: wgmma m64n64k16, both operands K-major from shared
//   memory, f32 accumulator. Products of bf16 values are exact in f32; only
//   the order of the sums differs from the reference's f32 dot, which
//   scales q before it (the kernel scales S, folding log2(e) in for exp2).
// * Scale, softcap (tanhf, accurate to 2 ulp), the causal, window and
//   Tk masks apply to the accumulator fragments in registers (the masks
//   only on the tiles they cut, each choice made once a tile and not per
//   element); the online softmax runs in f32, exp2 on the MUFU unit.
// * O += P V: wgmma with P from registers (the RS form: the S
//   accumulator's layout is the A fragment's, so P needs no shuffle) and V
//   from shared memory through the transpose bit (V is MN-major).
// * The tiles that the causal or window mask leaves empty are neither
//   loaded nor computed; the blocks of the longest rows start first.
// * The consumer runs each tile in order (Q K^T, softmax, P V). On an
//   H100 SXM (700 W) a block's tile took about 2,900 cycles at granite's
//   1024-token prefill with 3 blocks a SM; overlapping the next tile's
//   Q K^T and softmax with this tile's P V (a second S and P in
//   registers) made the kernel slower, as did separate accumulators for
//   P_hi V and P_lo V.
//
// Precision plan for P V. The reference multiplies P in f32. Rounding P
// once to bf16 (8 bits) misses the serving limit (rtol 2^-6 of each
// output) by far, and a tf32 product would need V as f32 and K-major (tf32
// wgmma has no transpose). So P is split into two bf16 parts, P_hi =
// bf16(P) and P_lo = bf16(P - P_hi), and both are multiplied into the same
// f32 accumulator: P_hi + P_lo keeps 16 significant bits (|error| <=
// 2^-17 |P|), V in bf16 is exact, and the sums are f32. It doubles the P V
// products: 1.5x the work of one bf16 pass.
//
// Head dims. The tiles are held as 64-column panels of 128-byte rows (one
// swizzle atom width); D = 16, 32 and 64 take one panel, 80 and 128 two,
// 256 four. D = 80 is a 64-column panel plus a second 64-column panel whose
// last 48 columns TMA fills with zeros (globalDim is 80): one swizzle mode
// and one descriptor form for every D, against 6 KB more shared memory a
// tile and 48 wasted columns in P V's second panel. Q K^T runs only the
// ceil(D/16) k-steps that hold data (5 at D = 80), P V one m64n64 wgmma
// per panel, and only the D real columns are stored. Shared memory: a Q
// tile and kStages K and V tiles of 8 KB a panel (TcShape); registers: O
// is 32 f32 a thread per panel (128 at D = 256), S 32, P 32.

// Design of the f32 body. At few queries an f32 call is bound by bytes
// (seamless's cross-attention, 1 or 4 queries over 1000 keys and 16 heads:
// 8.2 MB, 2.5 us at 3.35 TB/s); at many by the CUDA cores' 67 TFLOP/s
// (its encoder, 1000 x 1000: 4.1 GFLOP, 61 us).
//
// * Keys split across blocks (flash-decoding). The wrapper's plan
//   (flash_attention.split_plan) gives each 64-query tile n_splits ranges
//   of its visible keys, whole 128-key chunks each, from Tq, Tk and the
//   masks alone: never from B, the heads or the card, so a row's bits do
//   not depend on its batch. The grid is (b * head, query tile, split);
//   at 1 x 1000 over 16 heads that is 128 blocks where one block a head
//   walked all keys. With one split (the encoder) a block writes o; with
//   more, each writes its rows' m, l and unnormalized acc into the
//   wrapper's f32 workspace, and flash_simt_merge folds them in split
//   order, without atomics.
// * Register tiles. A block is 256 threads over 64 query rows; thread
//   (ty, tx) holds a 4 x (BK / 16) tile of S = Q K^T and a 4 x 4
//   ceil(D / 64) tile of O in registers (both 4 x 4 at D 64), its
//   operands float4 loads from shared memory: Q rows (q scaled on load,
//   as the Pallas kernel scales q before the dot) and K rows for S, P
//   columns and V rows for O, 8 loads a 64 FMAs of S and 2 a 16 of O.
//   The 16 lanes that share a row sit in one half-warp: a load of a Q
//   row or a P column is one broadcast, the row max takes 4 shuffles, and
//   the row sum stays per lane until the end. The masks and their
//   arithmetic run only on a tile that Tk, the split's end or a causal
//   or window mask cuts. P goes through shared memory key-major, and a
//   warp reads back only its own rows (a __syncwarp, not a block
//   barrier). Warps whose 8 rows all lie past Tq skip the arithmetic (a
//   decode tile: one warp of eight works). Against 4 x 8 tiles on 128
//   threads (208 registers, 8 warps a SM) and 32-key tiles at D 64 (80
//   registers, three blocks a SM), this shape (125 registers, two blocks
//   and 16 warps a SM) was the fastest at seamless's encoder on an H100
//   SXM (700 W).
// * K/V ring. Two slots of BK keys (64 at D <= 64, else 32), filled by
//   16-byte cp.async.cg copies: the next tile's copies fly while this one
//   is computed, one barrier a tile. Keys past a split's range are
//   zero-filled and masked. A row of Q, K or V takes D + 4 floats, an odd
//   count of 16-byte units, so the 16 K rows a half-warp reads fill the 8
//   bank groups twice (the 256 bytes' own two passes). Shared memory
//   (F32Shape): 104 KB at D 64 (two blocks a SM), 110 KB at D 128, 208 KB
//   at D 256 (one). Exponentials are exp2f of log2(e)-scaled differences.

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <climits>

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// bf16: the tensor-core body
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;              // query rows of a block: one warpgroup
constexpr int kTcKeys = 64;              // keys of a tile
constexpr int kConsumers = 128;          // the consumer warpgroup
constexpr int kTcThreads = kConsumers + 32;   // + the producer warp
constexpr int kPanel = 64 * 128;         // bytes of a 64-row, 64-column panel
constexpr int kAtom = 8 * 128;           // 128-byte swizzle atom: 8 rows
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct TcShape {
  static constexpr int kPanels = (D + 63) / 64;
  static constexpr int kSteps = (D + 15) / 16;        // k16 steps of Q K^T
  static constexpr int kTile = kPanels * kPanel;      // bytes of a Q, K or V tile
  // the K/V ring's depth and the blocks a SM holds (shared memory: 73 KB
  // a block at D <= 64, 3 blocks of 128 registers a thread; 81 KB at 80 and
  // 128, 2 blocks; 225 KB at 256, 1 block)
  static constexpr int kStages = D <= 64 ? 4 : D <= 128 ? 2 : 3;
  static constexpr int kMinBlocks = D <= 64 ? 3 : D <= 128 ? 2 : 1;
  static constexpr int kSmem = kTile * (1 + 2 * kStages) + 1024;   // + alignment
};

struct TcArgs {
  void* o;
  long long ob, oh, ot;                  // element strides of o
  int Hq, rep, Tq, Tk, n_qtiles;
  int q_pos[3], k_pos[3], v_pos[3];      // map coordinate slot of t, h, b
  float scale_log2;                      // scale * log2(e)    (no softcap)
  float cap_in, cap_out;                 // scale / softcap, softcap * log2(e)
  int softcap, causal;
  int window;                            // <= 0: none
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}
// returns once the phase of the given parity has completed; a wait that
// outlasts 2^26 polls (far beyond any load) traps, so a lost arrival ends
// the launch with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// one 64-row tile of `panels` 64-column panels: TMA box (64 columns, 64
// rows along t), coordinates in the map's axis order
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, const int (&pos)[3], int t,
                                         int h, int b, int panels) {
  const int c1 = pos[0] == 1 ? t : pos[1] == 1 ? h : b;
  const int c2 = pos[0] == 2 ? t : pos[1] == 2 ? h : b;
  const int c3 = pos[0] == 3 ? t : pos[1] == 3 ? h : b;
  for (int p = 0; p < panels; ++p)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6}], [%2];"
        :: "r"(dst + p * kPanel), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(64 * p), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle (layout type 1):
// start address, leading and stride byte offsets, in 16-byte units
__device__ __forceinline__ uint64_t sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep registers that an asynchronous wgmma reads or writes where they are
// until its wait
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define WG_D32                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
  "+f"(d[31])
#define WG_R32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A B over one k16 step, A [64 x 16] and B^T [64 x 16] both K-major in
// shared memory; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", %32, %33, p, 1, 1, 0, 0;\n\t}"
      : WG_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B over one k16 step, A [64 x 16] from registers, B [16 x 64]
// MN-major in shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// the online softmax state of a consumer thread's rows r0 and r0 + 8: max
// (log2 units, -inf before any visible key), this thread's share of the
// sum, and the last tile's factor for the accumulator
struct Rows {
  float m0, m1, l0, l1, al0, al1;
};
// where a consumer thread's accumulator fragment lies
struct Tile {
  int q0, r0, c, shift;
};
// P as two bf16 parts in the A fragment's layout: k-step kk holds keys
// 16kk..16kk+15, register r the pair at accumulator 8kk + 2r
struct PFrag {
  uint32_t hi[4][4], lo[4][4];
};

__device__ __forceinline__ void keep(PFrag& p) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    keep(p.hi[kk]);
    keep(p.lo[kk]);
  }
}
template <int P>
__device__ __forceinline__ void keep(float (&o)[P][32]) {
#pragma unroll
  for (int p = 0; p < P; ++p) keep(o[p]);
}

// issue S = Q K^T over `steps` k16 steps (no commit)
template <int steps>
__device__ __forceinline__ void qk(float (&x)[32], uint32_t sq, uint32_t sk) {
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < steps; ++ks) {
    const uint32_t off = (ks / 4) * kPanel + (ks % 4) * 32;
    wgmma_ss(x, sw128(sq + off, 16, kAtom), sw128(sk + off, 16, kAtom), ks > 0);
  }
}

// issue O += P V, each 64-column panel of V in turn (no commit)
template <int P>
__device__ __forceinline__ void pv(float (&o)[P][32], const PFrag& pf, uint32_t sv) {
  wg_fence();
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = sw128(sv + p * kPanel + kk * 2 * kAtom, kPanel, kAtom);
      wgmma_rs(o[p], pf.hi[kk], dv);
      wgmma_rs(o[p], pf.lo[kk], dv);
    }
}

// 2^x, one MUFU instruction (relative error about 2^-22; results below
// 2^-126 flush to 0, as a masked key's -inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S of the tile at key k0 -> P, in place: scaled (and capped) logits in
// log2 units, the masks where they cut the tile (masked: -inf), the
// online softmax. Each branch is uniform and taken once a tile, outside
// the loops over the fragment.
__device__ __forceinline__ void softmax(float (&x)[32], const TcArgs& a, const Tile& t,
                                        int k0, Rows& st) {
  if (a.softcap) {
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = a.cap_out * tanhf(x[i] * a.cap_in);
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] *= a.scale_log2;
  }
  const bool edge = k0 + kTcKeys > a.Tk ||
                    (a.causal && k0 + kTcKeys - 1 > t.q0 + t.shift) ||
                    (a.window > 0 && k0 + a.window <= t.q0 + kTcRows - 1 + t.shift);
  if (edge) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int kp = k0 + 8 * (i / 4) + t.c + (i % 2);
      const int qp = t.r0 + 8 * ((i / 2) % 2) + t.shift;
      bool ok = kp < a.Tk;
      if (a.causal) ok = ok && kp <= qp;
      if (a.window > 0) ok = ok && kp > qp - a.window;
      x[i] = ok ? x[i] : -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x[i]);
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {     // the 4 lanes of a row
    mx[0] = fmaxf(mx[0], __shfl_xor_sync(kFull, mx[0], sh));
    mx[1] = fmaxf(mx[1], __shfl_xor_sync(kFull, mx[1], sh));
  }
  const float mn0 = fmaxf(st.m0, mx[0]), mn1 = fmaxf(st.m1, mx[1]);
  // a row that has seen no key yet keeps 0 as its reference: -inf - -inf
  // would be NaN
  const float base0 = mn0 == -INFINITY ? 0.f : mn0, base1 = mn1 == -INFINITY ? 0.f : mn1;
  st.al0 = ex2(st.m0 - base0);
  st.al1 = ex2(st.m1 - base1);
  st.m0 = mn0;
  st.m1 = mn1;
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i / 2) % 2;
    x[i] = ex2(x[i] - (r ? base1 : base0));
    ps[r] += x[i];
  }
  st.l0 = st.l0 * st.al0 + ps[0];       // this thread's columns; the row's
  st.l1 = st.l1 * st.al1 + ps[1];       // sum is taken at the end
}

__device__ __forceinline__ void split(const float (&x)[32], PFrag& pf) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e0 = x[8 * kk + 2 * r], e1 = x[8 * kk + 2 * r + 1];
      const __nv_bfloat162 hi2 = __floats2bfloat162_rn(e0, e1);
      const float2 back = __bfloat1622float2(hi2);
      pf.hi[kk][r] = bf16x2_bits(hi2);
      pf.lo[kk][r] = bf16x2_bits(__floats2bfloat162_rn(e0 - back.x, e1 - back.y));
    }
}

template <int P>
__device__ __forceinline__ void rescale(float (&o)[P][32], const Rows& st) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[p][4 * j] *= st.al0;
      o[p][4 * j + 1] *= st.al0;
      o[p][4 * j + 2] *= st.al1;
      o[p][4 * j + 3] *= st.al1;
    }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, TcShape<D>::kMinBlocks)
flash_tc(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
         const __grid_constant__ CUtensorMap mv, const TcArgs a) {
  using S = TcShape<D>;
  extern __shared__ uint8_t smem_raw[];
  // q full; full (K and V landed) and empty per stage
  __shared__ __align__(8) uint64_t bars[1 + 2 * S::kStages];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;   // swizzle atoms
  const uint32_t sk0 = sq + S::kTile, sv0 = sk0 + S::kStages * S::kTile;
  const uint32_t q_full = smem_u32(&bars[0]), full0 = smem_u32(&bars[1]);
  const uint32_t empty0 = full0 + 8 * S::kStages;

  const int b = blockIdx.x / a.Hq, h = blockIdx.x % a.Hq, hk = h / a.rep;
  const int q0 = (a.n_qtiles - 1 - (int)blockIdx.y) * kTcRows;   // longest first
  const int shift = a.Tk - a.Tq;
  // the key tiles any row of the block sees
  const int q_last = min(q0 + kTcRows, a.Tq) - 1;
  const int kend = a.causal ? min(a.Tk, q_last + shift + 1) : a.Tk;
  const int kbeg = a.window > 0 ? max(0, q0 + shift - a.window + 1) : 0;
  const int t_beg = kbeg / kTcKeys;
  const int n_tiles = (kend + kTcKeys - 1) / kTcKeys - t_beg;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {       // the producer warp: one lane loads
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, S::kTile);
      tma_tile(sq, &mq, q_full, a.q_pos, q0, h, b, S::kPanels);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S::kStages;
        const int k0 = (t_beg + it) * kTcKeys;
        mbar_wait(empty0 + 8 * s, ((it / S::kStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 2 * S::kTile);
        tma_tile(sk0 + s * S::kTile, &mk, full0 + 8 * s, a.k_pos, k0, hk, b, S::kPanels);
        tma_tile(sv0 + s * S::kTile, &mv, full0 + 8 * s, a.v_pos, k0, hk, b, S::kPanels);
      }
    }
    return;
  }

  // the consumer warpgroup. Accumulator fragment of a thread: rows r0 and
  // r0 + 8, and in each 8-column chunk j the columns 8j + c and 8j + c + 1;
  // element 4j + e is at row r0 + 8 * (e / 2), column 8j + c + e % 2
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = q0 + 16 * warp + lane / 4, c = 2 * (lane % 4);
  float o[S::kPanels][32];
#pragma unroll
  for (int p = 0; p < S::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
  Rows st{-INFINITY, -INFINITY, 0.f, 0.f, 1.f, 1.f};
  const Tile tile{q0, r0, c, shift};
  auto sk = [&](int it) { return sk0 + (it % S::kStages) * S::kTile; };
  auto sv = [&](int it) { return sv0 + (it % S::kStages) * S::kTile; };
  auto bar = [&](uint32_t bar0, int it) { return bar0 + 8 * (it % S::kStages); };
  auto parity = [&](int it) { return (uint32_t)((it / S::kStages) & 1); };
  auto key0 = [&](int it) { return (t_beg + it) * kTcKeys; };
  float x[32] = {};
  PFrag pf;

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    mbar_wait(bar(full0, it), parity(it));
    qk<S::kSteps>(x, sq, sk(it));
    wg_commit();
    wg_wait();
    keep(x);
    softmax(x, a, tile, key0(it), st);
    split(x, pf);
    rescale(o, st);
    pv(o, pf, sv(it));
    wg_commit();
    wg_wait();
    keep(o);
    keep(pf);
    if (lane == 0) mbar_arrive(bar(empty0, it));   // the stage may be reloaded
  }
  float l0 = st.l0, l1 = st.l1;

#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, sh);
    l1 += __shfl_xor_sync(kFull, l1, sh);
  }
  const float d0 = l0 == 0.f ? 1.f : l0, d1 = l1 == 0.f ? 1.f : l1;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o) + b * a.ob + h * a.oh;
#pragma unroll
  for (int p = 0; p < S::kPanels; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * p + 8 * j + c;
      if (col >= D) continue;
      if (r0 < a.Tq)
        *reinterpret_cast<__nv_bfloat162*>(og + r0 * a.ot + col) =
            __floats2bfloat162_rn(o[p][4 * j] / d0, o[p][4 * j + 1] / d0);
      if (r0 + 8 < a.Tq)
        *reinterpret_cast<__nv_bfloat162*>(og + (r0 + 8) * a.ot + col) =
            __floats2bfloat162_rn(o[p][4 * j + 2] / d1, o[p][4 * j + 3] / d1);
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no libcuda link)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-d map of one bf16 operand [B, H, T, D] through its element strides
// (b, h, t): a box of 64 columns by 64 rows along t, 128-byte swizzle,
// zeros out of bounds. The outer axes go in order of stride (axes of
// extent 1, whose stride is never used, last), so the map's strides grow;
// pos[i] is the coordinate slot of t (i = 0), h (1) and b (2).
bool encode_map(CUtensorMap* map, int (&pos)[3], const void* base, long long D,
                const long long (&ext)[3], const long long (&st)[3]) {
  int ord[3] = {0, 1, 2};
  auto key = [&](int i) { return ext[i] > 1 ? st[i] : LLONG_MAX; };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && key(ord[j]) < key(ord[j - 1]); --j) {
      const int t = ord[j];
      ord[j] = ord[j - 1];
      ord[j - 1] = t;
    }
  cuuint64_t dims[4] = {(cuuint64_t)D, 0, 0, 0}, strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  long long span = D;
  for (int r = 0; r < 3; ++r) {
    const int i = ord[r];
    const long long s = ext[i] > 1 ? st[i] : span;
    dims[1 + r] = (cuuint64_t)ext[i];
    strides[r] = (cuuint64_t)(s * 2);
    box[1 + r] = i == 0 ? 64 : 1;
    pos[i] = 1 + r;
    span = s * ext[i];
  }
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_tc(const CUtensorMap (&m)[3], const TcArgs& a, long long BH,
                      cudaStream_t s) {
  constexpr int smem = TcShape<D>::kSmem;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  flash_tc<D><<<dim3((unsigned)BH, (unsigned)a.n_qtiles), kTcThreads, smem, s>>>(
      m[0], m[1], m[2], a);
  return cudaGetLastError();
}

cudaError_t flash_bf16(const void* q, const void* k, const void* v, void* o,
                       long long B, long long Hq, long long Hkv, long long Tq,
                       long long Tk, long long D, const long long* st, float scale,
                       float softcap, int causal, long long window, cudaStream_t s) {
  const long long n_qtiles = (Tq + kTcRows - 1) / kTcRows;
  if (Tk > INT_MAX - 2 * kTcKeys || n_qtiles > 65535) return cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  TcArgs a{};
  a.o = o;
  a.ob = st[9];
  a.oh = st[10];
  a.ot = st[11];
  a.Hq = (int)Hq;
  a.rep = (int)(Hq / Hkv);
  a.Tq = (int)Tq;
  a.Tk = (int)Tk;
  a.n_qtiles = (int)n_qtiles;
  a.scale_log2 = scale * kLog2e;
  a.softcap = softcap > 0.f;
  a.cap_in = a.softcap ? scale / softcap : 0.f;
  a.cap_out = softcap * kLog2e;
  a.causal = causal;
  a.window = window > 0 && window <= Tk ? (int)window : 0;   // wider: no effect
  CUtensorMap m[3];
  const long long ext_q[3] = {Tq, Hq, B}, ext_kv[3] = {Tk, Hkv, B};
  const long long st_q[3] = {st[2], st[1], st[0]}, st_k[3] = {st[5], st[4], st[3]},
                  st_v[3] = {st[8], st[7], st[6]};
  if (!encode_map(&m[0], a.q_pos, q, D, ext_q, st_q) ||
      !encode_map(&m[1], a.k_pos, k, D, ext_kv, st_k) ||
      !encode_map(&m[2], a.v_pos, v, D, ext_kv, st_v))
    return cudaErrorInvalidValue;
  const long long BH = B * Hq;
  switch (D) {
    case 16: return launch_tc<16>(m, a, BH, s);
    case 32: return launch_tc<32>(m, a, BH, s);
    case 64: return launch_tc<64>(m, a, BH, s);
    case 80: return launch_tc<80>(m, a, BH, s);
    case 128: return launch_tc<128>(m, a, BH, s);
    case 256: return launch_tc<256>(m, a, BH, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// f32: the CUDA-core body
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;         // 8 warps
constexpr int kF32Rows = 64;             // query rows of a block: 8 a warp, 4 a thread
constexpr int kF32Stages = 2;            // depth of the K/V ring

template <int D>
struct F32Shape {
  static constexpr int kKeys = D <= 64 ? 64 : 32;     // keys of a K/V tile
  static constexpr int kCols = kKeys / 16;            // S columns of a thread
  static constexpr int kGroups = (D + 63) / 64;       // float4 columns of O a thread
  static constexpr int kPitch = D + 4;                // floats a row of Q, K, V: an
                                                      // odd count of 16-byte units
  static constexpr int kPPitch = kF32Rows + 4;        // floats a key of P
  static constexpr int kMinBlocks = D <= 128 ? 2 : 1;
  static constexpr int kSmem =
      (int)sizeof(float) * (kF32Rows * kPitch + kF32Stages * 2 * kKeys * kPitch +
                            kKeys * kPPitch);
};

struct F32Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* acc;                            // [B * Hq, n_splits, Tq, D] partial sums
  float* ml;                             // [B * Hq, n_splits, Tq, 2] partial m, l
  const int* plan;                       // [n_qtiles, n_splits, 2] key ranges
  long long Hq, rep, Tq, Tk;
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;  // strides
  float scale, softcap;                  // softcap <= 0: none
  int causal, n_splits;
  long long window;                      // <= 0: none
};

// 16 bytes global -> shared, bypassing L1; `fill` false writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// over the 16 lanes that share a row (xor 8, 4, 2, 1 stays in a half-warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// The online softmax of one S tile, in place: s becomes P. The masks
// apply only where kCut (a tile that Tk, the split's end or a causal or
// window mask cuts); the row max is reduced over the row's 16 lanes, the
// row sum kept per lane until the end. Row i of the thread sits at
// position qpos + i, its column j at key + 16 j.
template <bool kCut, int C, int G>
__device__ __forceinline__ void softmax_tile(float (&s)[4][C], float (&m)[4],
                                             float (&l)[4], float (&o)[4][G][4],
                                             const F32Args& a, long long qpos,
                                             long long key, long long kend) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bool ok[C];
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      ok[j] = true;
      if (kCut) {
        const long long kj = key + 16 * j;
        ok[j] = kj < kend;
        if (a.causal) ok[j] = ok[j] && kj <= qpos + i;
        if (a.window > 0) ok[j] = ok[j] && kj > qpos + i - a.window;
      }
      float x = s[i][j];
      if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
      s[i][j] = ok[j] ? x : kNeg;
      mx = fmaxf(mx, s[i][j]);
    }
    const float m_new = fmaxf(m[i], row_max(mx));
    const float alpha = exp2f((m[i] - m_new) * kLog2e);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      s[i][j] = ok[j] ? exp2f((s[i][j] - m_new) * kLog2e) : 0.f;
      sum += s[i][j];
    }
    l[i] = l[i] * alpha + sum;
    m[i] = m_new;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][g][e] *= alpha;
  }
}

// One block per (b, head, 64-query tile, key split). Thread (ty, tx), ty =
// 2 warp + lane / 16 and tx = lane % 16, owns query rows 4 ty .. 4 ty + 3,
// the S columns (keys) tx + 16 j of a tile and the O columns 64 g + 4 tx
// .. + 3; so the 16 lanes that share a row sit in one half-warp.
template <int D>
__global__ void __launch_bounds__(kF32Threads, F32Shape<D>::kMinBlocks)
flash_simt(const F32Args a) {
  using Sh = F32Shape<D>;
  constexpr int BK = Sh::kKeys, C = Sh::kCols, G = Sh::kGroups;
  constexpr int P = Sh::kPitch, PP = Sh::kPPitch, D4 = D / 4;
  extern __shared__ float4 f32_smem[];
  float* s_q = reinterpret_cast<float*>(f32_smem);    // [kF32Rows][P], scaled
  float* s_kv = s_q + kF32Rows * P;                    // [stage][K, V][BK][P]
  float* s_p = s_kv + kF32Stages * 2 * BK * P;         // [BK][PP]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = 2 * warp + lane / 16, tx = lane % 16;
  const long long bh = blockIdx.x, b = bh / a.Hq, h = bh % a.Hq;
  const long long hk = h / a.rep;
  const long long q0 = (long long)blockIdx.y * kF32Rows;
  const int* range = a.plan + 2 * ((long long)blockIdx.y * a.n_splits + blockIdx.z);
  const long long kbeg = range[0], kend = range[1];
  const float* qg = a.q + b * a.qb + h * a.qh;
  const float* kg = a.k + b * a.kb + hk * a.kh;
  const float* vg = a.v + b * a.vb + hk * a.vh;

  // keys k0 .. k0 + BK of K and V into a ring slot; keys past the split's
  // range are zero-filled (and masked)
  auto load = [&](int slot, long long k0) {
    float* dk = s_kv + slot * 2 * BK * P;
    float* dv = dk + BK * P;
    for (int e = threadIdx.x; e < BK * D4; e += kF32Threads) {
      const int j = e / D4, c = 4 * (e % D4);
      const bool in = k0 + j < kend;
      const long long key = in ? k0 + j : kbeg;
      cp_async16(smem_u32(dk + j * P + c), kg + key * a.kt + c, in);
      cp_async16(smem_u32(dv + j * P + c), vg + key * a.vt + c, in);
    }
  };
  const int n_tiles = kend > kbeg ? (int)((kend - kbeg + BK - 1) / BK) : 0;
  if (n_tiles > 0) load(0, kbeg);
  cp_commit();

  // the query tile, scaled as the Pallas kernel scales it (before the dot)
  for (int e = threadIdx.x; e < kF32Rows * D4; e += kF32Threads) {
    const int r = e / D4, c = 4 * (e % D4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < a.Tq) {
      x = *reinterpret_cast<const float4*>(qg + (q0 + r) * a.qt + c);
      x.x *= a.scale;
      x.y *= a.scale;
      x.z *= a.scale;
      x.w *= a.scale;
    }
    *reinterpret_cast<float4*>(s_q + r * P + c) = x;
  }

  const bool live = q0 + 8 * warp < a.Tq;   // warp-uniform: a row of the warp is real
  const long long shift = a.Tk - a.Tq;
  const float* q_t = s_q + 4 * ty * P;
  float o[4][G][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][g][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_wait_all();
    __syncthreads();            // tile t has landed; tile t - 1's slot and P are free
    if (t + 1 < n_tiles) load((t + 1) % kF32Stages, kbeg + (long long)(t + 1) * BK);
    cp_commit();
    if (!live) continue;
    const float* s_k = s_kv + (t % kF32Stages) * 2 * BK * P;
    const float* s_v = s_k + BK * P;
    const long long k0 = kbeg + (long long)t * BK;

    // S = Q K^T, a 4 x C tile a thread from float4 operands along D
    float s[4][C];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[C];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = lds4(q_t + i * P + d);
#pragma unroll
      for (int j = 0; j < C; ++j) kv[j] = lds4(s_k + (tx + 16 * j) * P + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // softcap, masks (only on a tile they cut) and the online softmax
    const bool cut = k0 + BK > kend || (a.causal && k0 + BK - 1 > q0 + shift) ||
                     (a.window > 0 && k0 <= q0 + kF32Rows - 1 + shift - a.window);
    const long long qpos = q0 + 4 * ty + shift, key = k0 + tx;
    if (cut)
      softmax_tile<true>(s, m, l, o, a, qpos, key, kend);
    else
      softmax_tile<false>(s, m, l, o, a, qpos, key, kend);
    // P to shared memory, key-major: a warp writes and reads only its rows
#pragma unroll
    for (int j = 0; j < C; ++j)
      *reinterpret_cast<float4*>(s_p + (tx + 16 * j) * PP + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncwarp();

    // O += P V, a 4 x 4G tile a thread
#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      const float4 pj = lds4(s_p + j * PP + 4 * ty);
      const float pr[4] = {pj.x, pj.y, pj.z, pj.w};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int c = 64 * g + 4 * tx;
        if (D % 64 == 0 || c < D) {
          const float4 vv = lds4(s_v + j * P + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            o[i][g][0] = fmaf(pr[i], vv.x, o[i][g][0]);
            o[i][g][1] = fmaf(pr[i], vv.y, o[i][g][1]);
            o[i][g][2] = fmaf(pr[i], vv.z, o[i][g][2]);
            o[i][g][3] = fmaf(pr[i], vv.w, o[i][g][3]);
          }
        }
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) l[i] = row_sum(l[i]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long qi = q0 + 4 * ty + i;
    if (qi >= a.Tq) break;
    if (a.n_splits == 1) {               // the whole range: o itself
      const float den = l[i] == 0.f ? 1.f : l[i];
      float* out = a.o + b * a.ob + h * a.oh + qi * a.ot;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int c = 64 * g + 4 * tx;
        if (D % 64 == 0 || c < D)
          *reinterpret_cast<float4*>(out + c) =
              make_float4(o[i][g][0] / den, o[i][g][1] / den, o[i][g][2] / den,
                          o[i][g][3] / den);
      }
    } else {                             // a split: its partial m, l, acc
      const long long row = (bh * a.n_splits + blockIdx.z) * a.Tq + qi;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int c = 64 * g + 4 * tx;
        if (D % 64 == 0 || c < D)
          *reinterpret_cast<float4*>(a.acc + row * D + c) =
              make_float4(o[i][g][0], o[i][g][1], o[i][g][2], o[i][g][3]);
      }
      if (tx == 0) {
        a.ml[2 * row] = m[i];
        a.ml[2 * row + 1] = l[i];
      }
    }
  }
}

// The splits' partials of each row merged in split order (no atomics):
// m = max m_s, l = sum l_s e^(m_s - m), o = sum acc_s e^(m_s - m) / l. A
// split that saw no key of the row (m_s = kNeg, l_s = 0, acc_s = 0) adds
// nothing; a row that saw none at all is written as 0. A thread per
// (b, head, query, 4 columns).
__global__ void __launch_bounds__(256)
flash_simt_merge(const F32Args a, int D, long long n) {
  const int D4 = D / 4;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long row = e / D4, bh = row / a.Tq, qi = row % a.Tq;
    const int c = 4 * (int)(e % D4);
    const long long first = bh * a.n_splits * a.Tq + qi;  // split s: + s Tq
    float m = kNeg;
    for (int s = 0; s < a.n_splits; ++s) m = fmaxf(m, a.ml[2 * (first + s * a.Tq)]);
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < a.n_splits; ++s) {
      const long long r = first + s * a.Tq;
      const float w = expf(a.ml[2 * r] - m);
      const float4 x = *reinterpret_cast<const float4*>(a.acc + r * D + c);
      l = fmaf(a.ml[2 * r + 1], w, l);
      acc.x = fmaf(x.x, w, acc.x);
      acc.y = fmaf(x.y, w, acc.y);
      acc.z = fmaf(x.z, w, acc.z);
      acc.w = fmaf(x.w, w, acc.w);
    }
    const float den = l == 0.f ? 1.f : l;
    const long long b = bh / a.Hq, h = bh % a.Hq;
    *reinterpret_cast<float4*>(a.o + b * a.ob + h * a.oh + qi * a.ot + c) =
        make_float4(acc.x / den, acc.y / den, acc.z / den, acc.w / den);
  }
}

template <int D>
cudaError_t launch_simt(const F32Args& a, long long BH, long long n_qtiles,
                        cudaStream_t s) {
  constexpr int smem = F32Shape<D>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      flash_simt<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  flash_simt<D><<<dim3((unsigned)BH, (unsigned)n_qtiles, (unsigned)a.n_splits),
                  kF32Threads, smem, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.n_splits == 1) return e;
  const long long n = BH * a.Tq * (D / 4);
  const long long blocks = (n + 255) / 256 < 0x7fffffffLL ? (n + 255) / 256 : 0x7fffffffLL;
  flash_simt_merge<<<(unsigned)blocks, 256, 0, s>>>(a, D, n);
  return cudaGetLastError();
}

cudaError_t flash_f32(const void* q, const void* k, const void* v, void* o,
                      long long B, long long Hq, long long Hkv, long long Tq,
                      long long Tk, long long D, const long long* st, float scale,
                      float softcap, int causal, long long window, const int* plan,
                      long long n_splits, void* acc, void* ml, cudaStream_t s) {
  const long long n_qtiles = (Tq + kF32Rows - 1) / kF32Rows;
  if (n_qtiles > 65535 || n_splits < 1 || n_splits > 65535 || plan == nullptr ||
      (n_splits > 1 && (acc == nullptr || ml == nullptr)))
    return cudaErrorInvalidValue;
  const F32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(o),
                  static_cast<float*>(acc), static_cast<float*>(ml), plan,
                  Hq, Hq / Hkv, Tq, Tk,
                  st[0], st[1], st[2], st[3], st[4], st[5],
                  st[6], st[7], st[8], st[9], st[10], st[11],
                  scale, softcap, causal, (int)n_splits, window};
  const long long BH = B * Hq;
  switch (D) {
    case 16: return launch_simt<16>(a, BH, n_qtiles, s);
    case 32: return launch_simt<32>(a, BH, n_qtiles, s);
    case 64: return launch_simt<64>(a, BH, n_qtiles, s);
    case 80: return launch_simt<80>(a, BH, n_qtiles, s);
    case 128: return launch_simt<128>(a, BH, n_qtiles, s);
    case 256: return launch_simt<256>(a, BH, n_qtiles, s);
    default: return cudaErrorInvalidValue;
  }
}

// Tq > Tk only without a mask: every key is visible, and the bodies read
// the right-alignment shift Tk - Tq only under a causal or window mask
bool valid(long long B, long long Hq, long long Hkv, long long Tq, long long Tk,
           int causal, long long window) {
  return B >= 1 && Hkv >= 1 && Hq % Hkv == 0 && Tq >= 1 && Tk >= 1 &&
         (Tk >= Tq || (!causal && window <= 0)) && B * Hq <= 0x7fffffffLL;
}

}  // namespace

extern "C" {

// strides: 12 element strides (b, h, t) of q, k, v and o, in that order;
// the last axis of each is contiguous. Returns the cudaError_t of the launch.
// plan: [ceil(Tq / 64), n_splits, 2] int32 key ranges of each query tile's
// splits (flash_attention.split_plan); acc [B * Hq, n_splits, Tq, D] and ml
// [B * Hq, n_splits, Tq, 2] f32 workspace, unused (may be null) at one split.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        long long B, long long Hq, long long Hkv, long long Tq,
                        long long Tk, long long D, const long long* strides,
                        float scale, float softcap, int causal, long long window,
                        const void* plan, long long n_splits, void* acc, void* ml,
                        void* stream) {
  if (!valid(B, Hq, Hkv, Tq, Tk, causal, window)) return (int)cudaErrorInvalidValue;
  return (int)flash_f32(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, strides, scale, softcap,
                        causal, window, static_cast<const int*>(plan), n_splits, acc,
                        ml, (cudaStream_t)stream);
}

// the same, bf16, on the tensor-core body; every stride but the last and
// every base address 16-byte aligned (the TMA maps)
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         long long B, long long Hq, long long Hkv, long long Tq,
                         long long Tk, long long D, const long long* strides,
                         float scale, float softcap, int causal, long long window,
                         void* stream) {
  if (!valid(B, Hq, Hkv, Tq, Tk, causal, window)) return (int)cudaErrorInvalidValue;
  return (int)flash_bf16(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, strides, scale, softcap,
                         causal, window, (cudaStream_t)stream);
}

const char* camr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
