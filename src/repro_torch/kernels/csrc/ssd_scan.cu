// Mamba2 SSD (state-space duality) chunked scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/ssd_scan.py::ssd_scan  (_ssd_kernel, pallas_call at :98)
//
//   h_t = exp(a_t) h_{t-1} + b_t x_t^T,   y_t = c_t^T h_t
//
// per (batch, head), with x [B, T, H, P], a [B, T, H] (log-decay, f32),
// b and c [B, T, H, S] (per-head) or [B, T, S] (group-shared: a head
// stride of 0, never broadcast in memory), h an f32 [S, P] state carried
// across chunks of C = 64 steps, and y [B, T, H, P] in x's type (f32 or
// bf16). Per chunk, with cum the in-chunk cumulative sum of a:
//
//   M[t, s] = (c_t . b_s) exp(cum_t - cum_s)  for s <= t, else 0
//   y_t     = exp(cum_t) (c_t . h) + sum_s M[t, s] x_s
//   h      <- exp(cum_end) h + sum_s exp(cum_end - cum_s) b_s x_s^T
//
// The decay ratio is exponentiated only where s <= t (it overflows above
// the diagonal), and every weight is <= 1.
//
// Two bodies, one per type; a call takes its type's body or fails:
//
// * bf16 (every serving prefill): ssd_tc, on the tensor cores.
// * f32: ssd_gram_f32, ssd_state_f32, then ssd_out_f32, f32 FMAs on the
//   CUDA cores (held to an f64 evaluation at 1e-5 x max|y|, bitwise from
//   run to run).
//
// Bound: at mamba2's serving prefill (T = 1024, 64 heads of P = 64, S = 128,
// bf16, group-shared b/c) one layer needs 2.29 GFLOP (c b^T once a chunk
// and M x per head, both on and below the diagonal; c h past the first
// chunk and the state update before the last, per head) over 17.6 MB (x
// and y 8.4 MB each; a, b, c 0.26 MB each): 2.3 us at the bf16 tensor-core
// peak, 5.2 us at 3.35 TB/s, so it is bound by bytes. In f32 the same 2.29
// GFLOP take 34 us at the CUDA cores' 67 TFLOP/s against 10.4 us for its
// 34.9 MB, so the f32 body is bound by operations. (The Pallas kernel's
// count, c b^T per head and the whole M x, is 3.76 GFLOP.)
//
// Design of the f32 body. The Pallas grid (B, H, n_chunks) carried h in
// VMEM scratch along the sequential chunk axis. Only the state update needs
// that order: the outputs of a chunk need nothing but the state entering
// it, and G = c b^T depends on no head when b and c are group-shared. So
// the body is three kernels on the caller's stream:
//
// * ssd_gram_f32: G of every chunk, once per head of b and c (once in all
//   for group-shared b/c), one block per 16 x 16 sub-tile on or below the
//   diagonal; 0.01 GFLOP at mamba2's shape.
// * ssd_state_f32, the recurrence alone: one block owns one (b, head, 64
//   state rows, 32 state columns) tile of h, 256 blocks at mamba2's B = 1,
//   and walks the chunks in order with the tile in registers (4 x 4 a
//   consumer thread, 4 consumer warps). Per chunk it applies h <-
//   exp(cum_end) h + b^T (w x), w = exp(cum_end - cum_s) (64 FMAs in order
//   per element), and stores h, the state entering the next chunk, to the
//   scratch h_in. A producer warp keeps a 4-slot ring of b and x tiles
//   filled by TMA and finishes each chunk (its table, x scaled by w in
//   place) two chunks behind its loads. The last chunk's update, which
//   nobody reads, is not run: n_chunks - 1 steps, 1.0 GFLOP at mamba2's
//   shape.
// * ssd_out_f32, the outputs: one block (256 threads, 8 warps) per (b,
//   head, chunk, 64 output columns), 1,024 independent blocks at mamba2's
//   B = 1, three resident a SM. c h_in runs over S in slices of 32 rows,
//   double-buffered by TMA (4 x 4 register tiles), while G and x land;
//   then M = G exp(cum_t - cum_s), the ratio exponentiated only where s <=
//   t, and y = exp(cum_t) (c h_in) + M x, the M x loop of a warp ending at
//   its rows' diagonal; y is stored once. Chunk 0 reads no h_in (the state
//   entering it is 0). About 1.4 GFLOP at mamba2's shape.
//
// What bounds it on the card (device time at mamba2's T = 1024, H100 SXM,
// scripts/ssd_bench.py): the FMAs run at 25-40% of the CUDA cores' rate,
// and the recurrence's 15 steps are a chain, about 2.8 us each. Loads
// issued 16 bytes a thread (cp.async) held each step to about 4 us; TMA
// tiles took the recurrence from 61 to 43 us. Forming G per head and chunk
// in the output kernel (a third of its FMAs, c and b read by every head)
// cost 95 us there; the Gram kernel cut it to 63. Larger register tiles
// (8 x 4), more warps (2 x 4 tiles; the recurrence's steps split over two
// warp groups) and bulk copies of single rows were each slower.
//
// Scratch, allocated by the wrapper: h_in [B, H, n_chunks - 1, S, Pp] f32
// (Pp: P rounded up to 4, so rows are 16-byte aligned), the state entering
// chunks 1 .. n_chunks - 1 (33.5 MB at mamba2's T = 1024, written and read
// once), and G [B, Hbc, n_chunks, 64, 64] f32 (Hbc: 1 for group-shared b
// and c, else H; 0.26 MB there). Every sum runs in a fixed order and
// nothing is atomic, so two calls give the same bits. Rows past T and
// columns past S or P arrive as zeros (TMA's out-of-bounds fill,
// cp.async's zero fill): a = 0, x = 0 past T, as the Pallas kernel pads,
// so nothing is copied or padded in memory. The wrapper passes x, b and c
// with 16-byte-aligned bases and strides (copying a tensor that lacks
// them), as TMA and cp.async need.
//
// Design of the bf16 body. One block owns one (b, head, tile of kCols = 32
// state columns), as above: 128 blocks at mamba2's B = 1 (16-column tiles,
// 256 blocks two a SM, were slower: each block recomputes c b^T and M).
// It has one consumer warpgroup (4 warps, 128 threads, 16 rows of a 64-row
// tile a warp) and one producer warp:
//
// * The producer issues TMA loads (cp.async.bulk.tensor) of each chunk's c
//   and b (64 rows by S in 64-column panels, K-major, 128-byte swizzle; 3-d
//   maps of the callers' strides for group-shared [B, T, S], 4-d for
//   per-head [B, T, H, S]) and of the block's x tile (64 rows by kCols,
//   MN-major, 64-byte swizzle, a 4-d map) into a ring of 3 stages (2 at
//   S > 128), each with a "full" and an "empty" (one arrival a consumer
//   warp) mbarrier. Rows past T and columns past S or P arrive as zeros
//   (TMA's out-of-bounds fill): a = 0, x = 0 past T, as the Pallas kernel
//   pads, and the wgmma padding of S and P is zero-filled. The producer
//   also writes each chunk's table into its stage (the in-chunk cumulative
//   sum of a, read with plain loads a chunk ahead; exp(cum); w =
//   exp(cum_end - cum)) and arrives on "full" once it is written.
// * G = c b^T: wgmma m64n64k16 over S, both operands K-major.
// * M = tril(G) exp(cum_t - cum_s) on G's accumulator fragments in
//   registers, passed as A fragments (the RS form: the accumulator's layout
//   is the A fragment's).
// * y = exp(cum_t) (c h) + M x: c h with A = c and B = h (MN-major, the
//   transpose bit), M x with B = the x tile as TMA placed it; stored once,
//   in bf16.
// * The f32 state h [S, kCols] stays in registers as the accumulator of the
//   update h <- exp(cum_end) h (in registers) + b^T (w x): A = b's panels
//   through the transpose bit (M-major), B = w x (MN-major), written by
//   the consumers from the x tile in the x tile's layout. Before each
//   chunk's products the consumers write h's bf16 parts to shared memory
//   for c h. Nothing but x, a, b, c and y touches device memory.
// * The consumer loop is pipelined by a chunk: at chunk i it stores y of
//   chunk i - 1 and frees its stage, writes h's parts, forms M, issues c h,
//   M x and the update of chunk i (their k16 steps in turn: independent
//   accumulator chains), then G of chunk i + 1, and writes w x of chunk
//   i + 1 into the other of two buffers.
// * ptxas serializes every wgmma of a kernel (a wait after each) if one is
//   issued on a path it cannot prove uniform, or if an instruction other
//   than a wgmma defines an accumulator between a wgmma and its wait. So
//   no wgmma is under a branch (the first chunk's c h runs on h = 0, the
//   last chunk's update and a G after the last chunk run on values nobody
//   reads) and the accumulators' zeros are pinned before the first wgmma.
// * Where the time goes (clock reads around each phase at mamba2's
//   prefill on an H100 SXM): in each chunk the products and the
//   consumers' own work (y's store, h's and w x's parts, M) take turns: a
//   warp waits at each wgmma until the tensor cores take it, so the
//   consumers cannot work while the products run. Writing w x on the
//   producer warp instead was slower (its stores slow the products'
//   shared-memory reads).
//
// Precision plan of the bf16 body. M, h and w x are f32 values multiplied
// by bf16 operands. Each is split into kParts = 3 bf16 parts, each the
// leading 8 significant bits of what the parts before it left (a
// truncation: the three hold all 24 bits, so the split is exact), and the
// parts' products go into one accumulator. So the operands are exact; the
// sums are the tensor core's f32 accumulation, which is not IEEE f32
// addition, in another order than the f32 body's. The card tests hold the
// result to the serving limit (tests/test_torch_cuda.py). A CPU model of
// the plans with IEEE f32 sums (tests/test_torch_ssm.py) shows why: one bf16
// part of each misses the serving limit (rtol 2^-6 of each output + 2e-5 x
// max|y|) by about 40x; two parts (16 bits) meet it at about half, but miss
// the card tests' limit (rtol 2^-6 + atol 1e-4) at mamba2's prefill shapes
// by up to 5.5x; three meet both. The products are 2.5x the Pallas count of
// 3.76 GFLOP at mamba2's prefill: still 9.5 us at the bf16 tensor-core
// peak.
//
// Shapes: S up to kMaxS = 256 in 1, 2 or 4 panels (TcShape<SP>), any P in
// tiles of kCols. TMA needs 16-byte-aligned bases and strides; the wrapper
// copies a tensor that lacks them into an aligned, zero-padded buffer, and
// the padding is never read (the maps' extents are S and P).

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <climits>

namespace {

constexpr int kC = 64;          // chunk length
constexpr int kMaxS = 256;

// ---------------------------------------------------------------------------
// bf16: the tensor-core body
// ---------------------------------------------------------------------------

constexpr int kCols = 32;                // state / output columns of a block
constexpr int kAcc = kCols / 2;          // accumulators a thread holds per m64 x kCols
constexpr int kParts = 3;                // bf16 parts of an f32 operand
constexpr int kConsumers = 128;          // the consumer warpgroup
constexpr int kTcThreads = kConsumers + 32;   // + the producer warp
constexpr int kPanel = 64 * 128;         // bytes of a 64-row, 64-column bf16 panel
constexpr int kAtom = 8 * 128;           // 128-byte swizzle atom: 8 rows
// x, w x and h are kept with their kCols columns contiguous (MN-major), in
// rows of kRow = 64 bytes swizzled in 16-byte chunks as TMA's 64-byte
// swizzle places them
constexpr int kRow = kCols * 2;
constexpr int kXTile = kC * kRow;        // 64 rows: an x tile, a part of w x
constexpr uint64_t kLayout = 2;          // wgmma's 64-byte swizzle
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// shared memory of the bf16 body with SP 64-column panels of the state: a
// ring of chunks (c, b, x and the table), h in kParts bf16 parts, two
// buffers of w x in kParts parts
template <int SP>
struct TcShape {
  // a ring of 3 chunks (2 at S > 128, to fit): a chunk's load has a
  // chunk's time to land
  static constexpr int kStages = SP <= 2 ? 3 : 2;
  static constexpr int kCB = SP * kPanel;            // a chunk of c or of b
  static constexpr int kTable = 1024;                // cum, exp(cum), w
  static constexpr int kStage = 2 * kCB + kXTile + kTable;   // c, b, x, the table
  static constexpr int kH = SP * kXTile;             // one part of h (64 SP rows)
  static constexpr int kX = kParts * kXTile;         // the parts of w x
  static constexpr int kSmem =
      kStages * kStage + kParts * kH + 2 * kX + 1024;   // + alignment
};

struct TcArgs {
  const float* a;
  __nv_bfloat16* y;                      // contiguous [B, T, H, P]
  long long ab, at, ah;                  // element strides of a
  int T, H, P, n_chunks;
  int x_pos[3], b_pos[3], c_pos[3];      // map coordinate slot of t, h, b (0: none)
  int b_rank, c_rank;                    // 3: group-shared, 4: per-head
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

// one box of a 3-d or 4-d map into shared memory: inner coordinate c0, then
// t, h and b in the map's slots (an axis the map lacks has slot 0)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int rank, const int (&pos)[3], int c0, int t, int h,
                                         int b) {
  const int c1 = pos[0] == 1 ? t : pos[1] == 1 ? h : b;
  const int c2 = pos[0] == 2 ? t : pos[1] == 2 ? h : b;
  const int c3 = pos[0] == 3 ? t : pos[1] == 3 ? h : b;
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if (rank == 3)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];"
        :: "r"(dst), "l"(m), "r"(bar), "r"(c0), "r"(c1), "r"(c2) : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6}], [%2];"
        :: "r"(dst), "l"(m), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle (layout type 1):
// start address, leading and stride byte offsets, in 16-byte units
__device__ __forceinline__ uint64_t sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand of 64-column panels `panel` bytes apart, at k16 step ks
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int panel, int ks) {
  return sw128(base + (ks / 4) * panel + (ks % 4) * 32, 16, kAtom);
}
// MN-major operand of kCols columns in rows of kRow bytes, at k16 step ks:
// 8-row groups 8 kRow apart (the leading offset, between column blocks of
// the swizzle's width, is unused: kCols is one block)
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int ks) {
  const uint32_t addr = base + ks * 16 * kRow;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kXTile >> 4) << 16) |
         ((uint64_t)((8 * kRow) >> 4) << 32) | (kLayout << 62);
}
// byte offset of 16-byte chunk `chunk` of row `row` in an MN-major operand
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kRow + ((chunk ^ ((row * kRow >> 7) & (kCols / 8 - 1))) << 4);
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
// the consumer warpgroup's own barrier (the producer warp is not in it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kConsumers) : "memory");
}
// shared-memory writes of this thread visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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
template <int N, int M>
__device__ __forceinline__ void keep(float (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) keep(r[i]);
}
template <int N, int M, int K>
__device__ __forceinline__ void keep(uint32_t (&r)[N][M][K]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) keep(r[i][j]);
}

#define WG_D16                                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),       \
  "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define WG_D32                                                               \
  WG_D16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),    \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),            \
  "+f"(d[31])
#define WG_R16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_R32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// G (+)= c b^T over one k16 step: m64n64k16, both operands K-major in
// shared memory; accumulate = 0 overwrites d
__device__ __forceinline__ void mma_g(float (&d)[32], uint64_t da, uint64_t db,
                                      int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", %32, %33, p, 1, 1, 0, 0;\n\t}"
      : WG_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B over one k16 step, m64 x kCols: A from shared memory (tA = 1:
// M-major, through the transpose bit), B MN-major in shared memory (the
// transpose bit)
template <int tA>
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t da, uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %18, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_R16
      ", %16, %17, p, 1, 1, %19, 1;\n\t}"
      : WG_D16
      : "l"(da), "l"(db), "r"(accumulate), "n"(tA));
}

// d (+)= A B over one k16 step, m64 x kCols: A [64 x 16] from registers, B
// MN-major in shared memory
__device__ __forceinline__ void mma_rs(float (&d)[16], const uint32_t (&a)[4],
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %21, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_R16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n\t}"
      : WG_D16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// 2^x, one MUFU instruction (relative error about 2^-22). exp(d) as
// ex2(d log2(e)) for the decay ratio d = cum_t - cum_s <= 0: the product's
// rounding is relative to d, so the ratio's error stays below about
// e^-1 2^-24 absolute however far apart t and s are
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two f32 values as kParts bf16 pairs: each part the leading 8 significant
// bits of what the parts before it left (a truncation, so each remainder
// is exact in f32 and three parts hold all 24 bits), packed by one byte
// permute; no conversion instruction, which issues at a quarter of the
// integer rate
__device__ __forceinline__ void split(float e0, float e1, uint32_t (&out)[kParts]) {
#pragma unroll
  for (int q = 0; q < kParts; ++q) {
    const uint32_t u0 = __float_as_uint(e0), u1 = __float_as_uint(e1);
    out[q] = __byte_perm(u0, u1, 0x7632);   // the upper halves, e0's low
    e0 -= __uint_as_float(u0 & 0xffff0000u);
    e1 -= __uint_as_float(u1 & 0xffff0000u);
  }
}

// G = c b^T over the chunk whose c panels start at sc (b at sb), in one
// group (committed here)
template <int SP>
__device__ __forceinline__ void issue_g(float (&gm)[32], uint32_t sc, uint32_t sb) {
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < 4 * SP; ++ks)
    mma_g(gm, kmajor(sc, kPanel, ks), kmajor(sb, kPanel, ks), ks > 0);
  wg_commit();
}

template <int SP>
__global__ void __launch_bounds__(kTcThreads, SP == 1 ? 2 : 1)
ssd_tc(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mb,
       const __grid_constant__ CUtensorMap mc, const TcArgs g) {
  using Sh = TcShape<SP>;
  constexpr int kS = Sh::kStages;
  extern __shared__ uint8_t smem_raw[];
  // per stage: full (the TMA bytes and the table), empty (the consumers
  // are done with it)
  __shared__ __align__(8) uint64_t bars[2 * kS];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s0 = (raw + 1023) & ~1023u;           // swizzle atoms
  uint8_t* const gen0 = smem_raw + (s0 - raw);         // the same, generic
  const uint32_t s_h = s0 + kS * Sh::kStage;           // h, kParts parts
  const uint32_t s_x = s_h + kParts * Sh::kH;          // 2 x w x, kParts parts
  uint8_t* const gen_h = gen0 + (s_h - s0);
  const uint32_t full0 = smem_u32(&bars[0]), empty0 = full0 + 8 * kS;
  // stage of chunk `it`: c panels, b panels, the x tile, then its table of
  // cum, exp(cum) and w = exp(cum_end - cum)
  auto stage = [&](int it) { return s0 + (it % kS) * Sh::kStage; };
  auto table = [&](int it) {
    return reinterpret_cast<float*>(gen0 + (it % kS) * Sh::kStage + 2 * Sh::kCB + kXTile);
  };

  const int bi = blockIdx.x / g.H, hh = blockIdx.x % g.H;
  const int p0 = blockIdx.y * kCols;
  const int n = g.n_chunks, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full0 + 8 * s, 2);                  // the loads, the table
      mbar_init(empty0 + 8 * s, kConsumers / 32);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer warp: lane 0 issues the loads of a chunk, then the warp
    // takes the in-chunk cumulative sum of a (2 steps a lane) into the
    // stage's table, a read a chunk ahead
    const float* ag = g.a + bi * g.ab + hh * g.ah;
    auto a_at = [&](int t) { return t < g.T ? ag[(long long)t * g.at] : 0.f; };
    float a0 = a_at(2 * lane), a1 = a_at(2 * lane + 1);
    for (int it = 0; it < n; ++it) {
      const uint32_t sc = stage(it), full = full0 + 8 * (it % kS);
      mbar_wait(empty0 + 8 * (it % kS), ((it / kS) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(full, Sh::kStage - Sh::kTable);
        for (int p = 0; p < SP; ++p) {
          tma_load(sc + p * kPanel, &mc, full, g.c_rank, g.c_pos, 64 * p, it * kC, hh, bi);
          tma_load(sc + Sh::kCB + p * kPanel, &mb, full, g.b_rank, g.b_pos, 64 * p,
                   it * kC, hh, bi);
        }
        tma_load(sc + 2 * Sh::kCB, &mx, full, 4, g.x_pos, p0, it * kC, hh, bi);
      }
      float run = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(kFull, run, o);
        if (lane >= o) run += v;
      }
      const float end = __shfl_sync(kFull, run, 31);
      const float c0 = run - a1;
      float* tab = table(it);
      tab[2 * lane] = c0;
      tab[2 * lane + 1] = run;
      tab[kC + 2 * lane] = expf(c0);
      tab[kC + 2 * lane + 1] = expf(run);
      tab[2 * kC + 2 * lane] = expf(end - c0);
      tab[2 * kC + 2 * lane + 1] = expf(end - run);
      a0 = a_at((it + 1) * kC + 2 * lane);
      a1 = a_at((it + 1) * kC + 2 * lane + 1);
      __syncwarp();                      // the warp's table writes before the arrival
      if (lane == 0) mbar_arrive(full);
    }
    return;
  }

  // the consumer warpgroup. Accumulator fragment of a thread (m64 tiles):
  // rows r0 and r0 + 8, and in each 8-column group j the columns 8j + cq and
  // 8j + cq + 1; element 4j + e is at row r0 + 8 * (e / 2), column
  // 8j + cq + e % 2
  const int warp = threadIdx.x / 32;
  const int r0 = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  float h[SP][kAcc], ys[kAcc] = {}, yi[kAcc] = {}, gm[32] = {};
  uint32_t mf[kParts][4][4];             // M's parts as A fragments, by k16 step
#pragma unroll
  for (int m = 0; m < SP; ++m)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) h[m][i] = 0.f;

  // w x of chunk `it` in kParts parts, from its x tile into operand buffer
  // it % 2 at the same offsets (the same layout): 16 bytes (8 columns of
  // one row) a load and a store
  auto write_wx = [&](int it) {
    const uint8_t* xs = gen0 + (it % kS) * Sh::kStage + 2 * Sh::kCB;
    const float* w = table(it) + 2 * kC;
    uint8_t* const gx = gen0 + (s_x - s0) + (it % 2) * Sh::kX;
#pragma unroll
    for (int i = 0; i < kXTile / 16 / kConsumers; ++i) {
      const int off = 16 * (threadIdx.x + kConsumers * i);
      const float ws = w[off / kRow];
      const uint4 v = *reinterpret_cast<const uint4*>(xs + off);
      const uint32_t in[4] = {v.x, v.y, v.z, v.w};
      uint32_t out[kParts][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&in[q]));
        uint32_t pw[kParts];
        split(ws * f.x, ws * f.y, pw);
#pragma unroll
        for (int k = 0; k < kParts; ++k) out[k][q] = pw[k];
      }
#pragma unroll
      for (int k = 0; k < kParts; ++k)
        *reinterpret_cast<uint4*>(gx + k * kXTile + off) =
            make_uint4(out[k][0], out[k][1], out[k][2], out[k][3]);
    }
  };
  // h [S][kCols] in kParts parts: a thread's pairs of neighbouring columns
  auto write_h = [&]() {
#pragma unroll
    for (int m = 0; m < SP; ++m)
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int off = m * kXTile + swz(r0 + 8 * half, j) + 2 * cq;
          uint32_t pk[kParts];
          split(h[m][4 * j + 2 * half], h[m][4 * j + 2 * half + 1], pk);
#pragma unroll
          for (int q = 0; q < kParts; ++q)
            *reinterpret_cast<uint32_t*>(gen_h + q * Sh::kH + off) = pk[q];
        }
  };
  // y of chunk `it` = exp(cum_t) (c h) + M x, rounded once to bf16
  __nv_bfloat16* const y0 = g.y + ((long long)bi * g.T * g.H + hh) * g.P;
  const long long y_t = (long long)g.H * g.P;
  auto store_y = [&](int it) {
    const float* dec = table(it) + kC;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = it * kC + r0 + 8 * half;
      if (t >= g.T) continue;
      const float d = dec[r0 + 8 * half];
      __nv_bfloat16* row = y0 + t * y_t;
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const int p = p0 + 8 * j + cq;
        const float v0 = d * ys[4 * j + 2 * half] + yi[4 * j + 2 * half];
        const float v1 = d * ys[4 * j + 2 * half + 1] + yi[4 * j + 2 * half + 1];
        if (g.P % 2 == 0 && p + 1 < g.P) {
          *reinterpret_cast<__nv_bfloat162*>(row + p) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (p < g.P) row[p] = __float2bfloat16_rn(v0);
          if (p + 1 < g.P) row[p + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  };

  // chunk 0's G and w x; h = 0. The accumulators' zeros are set
  // before the first wgmma: ptxas serializes every wgmma of a kernel that
  // defines an accumulator between a wgmma and its wait
  keep(gm);
  keep(ys);
  keep(yi);
  keep(h);
  mbar_wait(full0, 0);
  issue_g<SP>(gm, stage(0), stage(0) + Sh::kCB);
  write_wx(0);
  write_h();
  // Chunk `it`: its G is in flight, its w x and h's parts are written; y
  // of chunk it - 1 waits in ys, yi. The tensor cores run c h, M x and the
  // update of chunk it, then G of chunk it + 1, while the consumers write
  // w x of chunk it + 1.
  for (int it = 0; it < n; ++it) {
    const uint32_t sc = stage(it), sb = sc + Sh::kCB;
    const float* tab = table(it);
    wg_wait();
    keep(gm);
    keep(ys);
    keep(yi);
    keep(h);
    keep(mf);
    consumers_sync();                    // every warp is past the products
    if (it > 0) {
      store_y(it - 1);
      __syncwarp();                      // the warp's reads of the stage are done
      if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % kS));   // may be reloaded
      write_h();
    }
    // M = tril(G) exp(cum_t - cum_s), as kParts A fragments: group j of the
    // accumulator is k16 step j / 2, registers 2 (j % 2) (row r0) and
    // 2 (j % 2) + 1 (row r0 + 8)
    {
      const float ct0 = tab[r0], ct1 = tab[r0 + 8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = 8 * j + cq;
        const float cs0 = tab[s], cs1 = tab[s + 1];
        const float m0 = s <= r0 ? gm[4 * j] * ex2((ct0 - cs0) * kLog2e) : 0.f;
        const float m1 = s + 1 <= r0 ? gm[4 * j + 1] * ex2((ct0 - cs1) * kLog2e) : 0.f;
        const float m2 = s <= r0 + 8 ? gm[4 * j + 2] * ex2((ct1 - cs0) * kLog2e) : 0.f;
        const float m3 = s + 1 <= r0 + 8 ? gm[4 * j + 3] * ex2((ct1 - cs1) * kLog2e) : 0.f;
        uint32_t top[kParts], bot[kParts];
        split(m0, m1, top);
        split(m2, m3, bot);
#pragma unroll
        for (int q = 0; q < kParts; ++q) {
          mf[q][j / 2][2 * (j % 2)] = top[q];
          mf[q][j / 2][2 * (j % 2) + 1] = bot[q];
        }
      }
    }
    const float dend = tab[2 * kC - 1];
#pragma unroll
    for (int m = 0; m < SP; ++m)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) h[m][i] *= dend;
    fence_async_smem();                  // h's parts and w x's, for the async proxy
    consumers_sync();

    // c h, M x and the state update in one group, the k16 steps of their
    // accumulators in turn (a step waits on the one before it into the same
    // accumulator, so independent chains keep the tensor cores busy). No
    // wgmma is under a branch: ptxas serializes every wgmma of a kernel
    // that issues one on a path it cannot prove uniform. So the last
    // chunk's update, which nothing reads, runs too, and so does a G after
    // the last chunk, on a stale stage.
    const uint32_t sx = sc + 2 * Sh::kCB, swx = s_x + (it % 2) * Sh::kX;
    wg_fence();
#pragma unroll
    for (int i = 0; i < 4 * kParts * SP; ++i) {
      const int ks = i % (4 * SP), q = i / (4 * SP);   // c h: part q, k16 step ks
      const int m = i % SP, u = i / SP;                // update of panel m, its step u
      mma_ss<0>(ys, kmajor(sc, kPanel, ks), mnmajor(s_h + q * Sh::kH, ks), i > 0);
      if (m == 0) mma_rs(yi, mf[u / 4][u % 4], mnmajor(sx, u % 4), u > 0);
      mma_ss<1>(h[m], sw128(sb + m * kPanel + (u % 4) * 2 * kAtom, kPanel, kAtom),
                mnmajor(swx + (u / 4) * kXTile, u % 4), 1);
    }
    wg_commit();
    const bool more = it + 1 < n;
    if (more) mbar_wait(full0 + 8 * ((it + 1) % kS), ((it + 1) / kS) & 1);
    issue_g<SP>(gm, stage(it + 1), stage(it + 1) + Sh::kCB);
    if (more) write_wx(it + 1);
  }
  wg_wait();
  keep(gm);
  keep(ys);
  keep(yi);
  keep(h);
  keep(mf);
  store_y(n - 1);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime (no link to it)
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

// A map of one bf16 operand whose last axis (`inner` elements) is
// contiguous: boxes of `box0` of its elements by 64 rows along t, over the
// outer axes t, h and b with their extents and element strides (ext 0: the
// operand lacks the axis). The outer axes go in order of stride (axes of
// extent 1, whose stride is never used, last), so the map's strides grow;
// pos[i] is the coordinate slot of axis i (0 when absent). Returns the
// map's rank, 0 if the encoding is refused.
int encode_map(CUtensorMap* map, int (&pos)[3], const void* base, long long inner, int box0,
               const long long (&ext)[3], const long long (&st)[3],
               CUtensorMapSwizzle swizzle) {
  int ord[3], n = 0;
  for (int i = 0; i < 3; ++i) {
    pos[i] = 0;
    if (ext[i] > 0) ord[n++] = i;
  }
  auto key = [&](int i) { return ext[i] > 1 ? st[i] : LLONG_MAX; };
  for (int i = 1; i < n; ++i)
    for (int j = i; j > 0 && key(ord[j]) < key(ord[j - 1]); --j) {
      const int t = ord[j];
      ord[j] = ord[j - 1];
      ord[j - 1] = t;
    }
  cuuint64_t dims[4] = {(cuuint64_t)inner, 1, 1, 1}, strides[3];
  cuuint32_t box[4] = {(cuuint32_t)box0, 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  long long span = (inner + 7) / 8 * 8;  // a 16-byte multiple
  for (int r = 0; r < n; ++r) {
    const int i = ord[r];
    const long long s = ext[i] > 1 ? st[i] : span;
    dims[1 + r] = (cuuint64_t)ext[i];
    strides[r] = (cuuint64_t)(s * 2);
    box[1 + r] = i == 0 ? kC : 1;
    pos[i] = 1 + r;
    span = s * ext[i];
  }
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 1 + n, const_cast<void*>(base),
                        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 1 + n
             : 0;
}

template <int SP>
cudaError_t launch_tc(const CUtensorMap (&m)[3], const TcArgs& g, long long BH,
                      cudaStream_t s) {
  constexpr int smem = TcShape<SP>::kSmem;
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_tc<SP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)BH, (unsigned)((g.P + kCols - 1) / kCols));
  ssd_tc<SP><<<grid, kTcThreads, smem, s>>>(m[0], m[1], m[2], g);
  return cudaGetLastError();
}

cudaError_t ssd_bf16(const void* x, const float* a, const void* b, const void* c, void* y,
                     long long B, long long T, long long H, long long P, long long S,
                     const long long* st, cudaStream_t s) {
  if (T > INT_MAX - kC || H > INT_MAX || P > INT_MAX ||
      (P + kCols - 1) / kCols > 65535)
    return cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  TcArgs g{};
  g.a = a;
  g.y = static_cast<__nv_bfloat16*>(y);
  g.ab = st[3];
  g.at = st[4];
  g.ah = st[5];
  g.T = (int)T;
  g.H = (int)H;
  g.P = (int)P;
  g.n_chunks = (int)((T + kC - 1) / kC);
  // outer axes in the order t, h, b; group-shared b and c lack h
  const long long ext_x[3] = {T, H, B}, st_x[3] = {st[1], st[2], st[0]};
  const long long ext_b[3] = {T, st[8] ? H : 0, B}, st_b[3] = {st[7], st[8], st[6]};
  const long long ext_c[3] = {T, st[11] ? H : 0, B}, st_c[3] = {st[10], st[11], st[9]};
  CUtensorMap m[3];
  g.b_rank = encode_map(&m[1], g.b_pos, b, S, 64, ext_b, st_b, CU_TENSOR_MAP_SWIZZLE_128B);
  g.c_rank = encode_map(&m[2], g.c_pos, c, S, 64, ext_c, st_c, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!encode_map(&m[0], g.x_pos, x, P, kCols, ext_x, st_x, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !g.b_rank || !g.c_rank)
    return cudaErrorInvalidValue;
  const long long BH = B * H;
  if (S <= 64) return launch_tc<1>(m, g, BH, s);
  if (S <= 128) return launch_tc<2>(m, g, BH, s);
  return launch_tc<4>(m, g, BH, s);
}

// ---------------------------------------------------------------------------
// f32: the CUDA-core body (ssd_gram_f32, ssd_state_f32, then ssd_out_f32)
// ---------------------------------------------------------------------------

constexpr int kStRows = 64;              // state rows of a state block
constexpr int kStCols = 32;              // state columns of a state block
constexpr int kStR = 4;                  // state rows a consumer thread (by 4 columns)
constexpr int kStConsumers = kStRows / kStR * (kStCols / 4);
constexpr int kStThreads = kStConsumers + 32;             // + the producer warp
constexpr int kStStages = 4;             // ring slots of b, x, a and the table
constexpr int kStLag = 2;                // a chunk's loads land while the next 2 are issued
constexpr int kTab = kC + 4;             // w by step, then exp(cum_end)
constexpr int kStTile = kC * (kStRows + kStCols);         // a slot's b and x tiles
constexpr int kStBytes = 4 * kStTile;                     // what TMA brings a chunk
constexpr int kStSmem = kStStages * (kStTile + kC + kTab) * 4 + 128;   // + alignment
constexpr int kGT = 16;                  // rows and columns of a Gram sub-tile
constexpr int kGThreads = 64;            // 2 x 2 of the sub-tile a thread
constexpr int kGSub = (kC / kGT) * (kC / kGT + 1) / 2;    // sub-tiles on or below the diagonal
constexpr int kOutCols = 64;             // output columns of an output block
constexpr int kOutR = 4;                 // rows of each tile a thread (by 4 columns)
constexpr int kBands = kC / (4 * kOutR);                  // row bands of 4 kOutR rows
constexpr int kOutThreads = 64 * kBands;                  // bands x 2 column halves
constexpr int kSlice = 32;               // state rows a step of the k loop
constexpr int kMP = kC + 4;              // pitch of M (17 float4s)
constexpr int kSlot = kC * kSlice + kSlice * kOutCols;    // c and h_in slices
constexpr int kOutBytes = 4 * kSlot;                      // what TMA brings a slice
constexpr int kOutSmem = (2 * kSlot + kC * kC + kC * kOutCols + 2 * kC) * 4 + 1024;
static_assert(kC * kMP <= 2 * kSlot, "M lies over the two slots");

struct F32Args {
  const float* x;
  const float* a;
  const float* b;
  const float* c;
  float* y;                     // contiguous [B, T, H, P]
  float* h;                     // h_in [B * H, n_chunks - 1, S, Pp]
  float* gram;                  // c b^T [B * Hbc, n_chunks, kC, kC]
  long long T, H, P, S, Pp;
  long long Hbc;                // heads of b and c: 1 when group-shared, else H
  int gpitch;                   // row pitch of the Gram kernel's staged c and b
  int b_rank;                   // the b map's rank: 3 group-shared, 4 per head
  int c_rank;                   // the c map's rank
  // map coordinate slot of t, h, b (0: none) of the b, x, c, h_in and G maps
  int b_pos[3], x_pos[3], c_pos[3], h_pos[3], g_pos[3];
  long long xb, xt, xh;         // element strides (b, t, h); p contiguous
  long long ab, at, ah;
  long long bb, bt, bh;         // bh == 0: group-shared
  long long cb, ct, ch;
  int n_chunks;
};

// 16 bytes global -> shared, bypassing L1; the first `bytes` (0 to 16) are
// read and the rest written as zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {      // all but the N newest groups
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}
// 4 bytes global -> shared
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// bytes of a 16-byte unit that lie before `left` remaining elements
__device__ __forceinline__ int unit_bytes(long long left) {
  return left <= 0 ? 0 : left >= 4 ? 16 : 4 * (int)left;
}
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// the in-chunk cumulative sum of a by one warp, lane l holding the steps
// 2 l and 2 l + 1 (a0, a1; 0 past T): c0, c1 at those steps and the sum
// over the chunk
__device__ __forceinline__ void chunk_cum(float a0, float a1, int lane, float& c0,
                                          float& c1, float& end) {
  float run = a0 + a1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(kFull, run, o);
    if (lane >= o) run += v;
  }
  end = __shfl_sync(kFull, run, 31);
  c0 = run - a1;
  c1 = run;
}

// The recurrence: block (b h, column tile, row tile) carries its 64 x 32
// tile of h through chunks 0 .. n_chunks - 2 and stores, after chunk i, the
// state entering chunk i + 1 to h_in[b h, i]. The last warp is the
// producer. As soon as the consumers have left a ring slot ("empty"
// mbarrier) it loads the next chunk's b and x tiles into it by TMA
// ("loaded"; columns past S or P arrive as zeros) and its a by cp.async,
// and it finishes the chunk loaded kStLag chunks before: it makes that
// chunk's table (w = exp(cum_end - cum_s) by step, then exp(cum_end)),
// scales its x rows by w in place and marks its slot "full". Consumer
// thread (ki, pi) = (tid / 8, tid % 8) owns rows kStR ki .. + kStR - 1 and
// columns 4 pi .. + 3 of the tile.
__global__ void __launch_bounds__(kStThreads)
ssd_state_f32(const __grid_constant__ CUtensorMap mb, const __grid_constant__ CUtensorMap mx,
              const F32Args g) {
  extern __shared__ float4 st_smem[];
  // tiles first, each slot's 128-byte aligned (TMA): b [kC][kStRows], x
  // [kC][kStCols] by slot, then a [kC] and the table [kTab] by slot
  float* const ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(st_smem) + 127) & ~uintptr_t(127));
  __shared__ __align__(8) uint64_t bars[3 * kStStages];    // loaded, full, empty
  const uint32_t loaded0 = smem_u32(&bars[0]), full0 = loaded0 + 8 * kStStages,
                 empty0 = full0 + 8 * kStStages;
  const int tid = threadIdx.x, lane = tid % 32;
  const long long bh = blockIdx.x, bi = bh / g.H, hi = bh % g.H;
  const int p0 = blockIdx.y * kStCols, k0 = blockIdx.z * kStRows;
  const int n_upd = g.n_chunks - 1;      // every updated chunk is whole
  auto sb = [&](int slot) { return ring + slot * kStTile; };
  auto sx = [&](int slot) { return ring + slot * kStTile + kC * kStRows; };
  auto sa = [&](int slot) { return ring + kStStages * kStTile + slot * (kC + kTab); };
  auto sw = [&](int slot) { return sa(slot) + kC; };

  if (tid == 0) {
    for (int s = 0; s < kStStages; ++s) {
      mbar_init(loaded0 + 8 * s, 1);                   // the expect-tx arrival
      mbar_init(full0 + 8 * s, 1);                     // the producer, once finished
      mbar_init(empty0 + 8 * s, kStConsumers / 32);    // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kStConsumers) {             // the producer warp
    const float* ag = g.a + bi * g.ab + hi * g.ah;
    for (int it = 0; it < n_upd + kStLag; ++it) {
      if (it < n_upd) {                  // load chunk it
        const int slot = it % kStStages;
        const long long t0 = (long long)it * kC;
        mbar_wait(empty0 + 8 * slot, ((it / kStStages) & 1) ^ 1);
        if (lane == 0) {
          // the slot's last generic writes (the scale) before the async proxy's
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          const uint32_t bar = loaded0 + 8 * slot;
          mbar_expect_tx(bar, kStBytes);
          tma_load(smem_u32(sb(slot)), &mb, bar, g.b_rank, g.b_pos, k0, (int)t0, (int)hi,
                   (int)bi);
          tma_load(smem_u32(sx(slot)), &mx, bar, 4, g.x_pos, p0, (int)t0, (int)hi, (int)bi);
        }
        for (int t = lane; t < kC; t += 32) cp_async4(sa(slot) + t, ag + (t0 + t) * g.at);
      }
      cp_commit();                       // one group an iteration, empty past the end
      const int j = it - kStLag;         // finish chunk j
      if (j < 0) continue;
      const int slot = j % kStStages;
      cp_wait<kStLag>();
      __syncwarp();                      // every lane's copies of chunk j's a have landed
      const float* a = sa(slot);
      float c0, c1, end;
      chunk_cum(a[2 * lane], a[2 * lane + 1], lane, c0, c1, end);
      float* w = sw(slot);
      w[2 * lane] = expf(end - c0);
      w[2 * lane + 1] = expf(end - c1);
      if (lane == 0) w[kC] = expf(end);
      mbar_wait(loaded0 + 8 * slot, (j / kStStages) & 1);   // chunk j's tiles
      __syncwarp();
      float* xs = sx(slot);
#pragma unroll
      for (int e = lane; e < kC * kStCols / 4; e += 32) {   // w x in place
        float4 v = lds4(xs + 4 * e);
        const float ws = w[e / (kStCols / 4)];
        v.x *= ws;
        v.y *= ws;
        v.z *= ws;
        v.w *= ws;
        *reinterpret_cast<float4*>(xs + 4 * e) = v;
      }
      __syncwarp();                      // the warp's writes before the arrival
      if (lane == 0) mbar_arrive(full0 + 8 * slot);
    }
    return;
  }

  const int ki = tid / (kStCols / 4), pi = tid % (kStCols / 4);
  float h[kStR][4] = {};
  for (int it = 0; it < n_upd; ++it) {
    const int slot = it % kStStages;
    mbar_wait(full0 + 8 * slot, (it / kStStages) & 1);
    // h <- exp(cum_end) h + b^T (w x)
    const float dend = sw(slot)[kC];
#pragma unroll
    for (int r = 0; r < kStR; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) h[r][q] *= dend;
    const float* bs = sb(slot) + kStR * ki;
    const float* xw = sx(slot) + 4 * pi;
#pragma unroll
    for (int s = 0; s < kC; ++s) {
      const float4 xv = lds4(xw + s * kStCols);
#pragma unroll
      for (int u = 0; u < kStR / 4; ++u) {
        const float4 bv = lds4(bs + s * kStRows + 4 * u);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float br = comp(bv, r);
          h[4 * u + r][0] = fmaf(br, xv.x, h[4 * u + r][0]);
          h[4 * u + r][1] = fmaf(br, xv.y, h[4 * u + r][1]);
          h[4 * u + r][2] = fmaf(br, xv.z, h[4 * u + r][2]);
          h[4 * u + r][3] = fmaf(br, xv.w, h[4 * u + r][3]);
        }
      }
    }
    __syncwarp();                        // the warp's reads of the slot are done
    if (lane == 0) mbar_arrive(empty0 + 8 * slot);
    // the state entering chunk it + 1 (columns past P hold zeros)
    const int p = p0 + 4 * pi;
    if (p < g.Pp) {
      float* hg = g.h + ((bh * n_upd + it) * g.S + k0 + kStR * ki) * g.Pp + p;
#pragma unroll
      for (int r = 0; r < kStR; ++r)
        if (k0 + kStR * ki + r < g.S)
          *reinterpret_cast<float4*>(hg + r * g.Pp) =
              make_float4(h[r][0], h[r][1], h[r][2], h[r][3]);
    }
  }
}

// G = c b^T of one chunk, per (b, head of b and c): one block per 16 x 16
// sub-tile on or below the diagonal (blockIdx.z numbers them row by row).
// Thread (tr, tc) = (tid / 8, tid % 8) owns rows tr, tr + 8 and columns
// tc, tc + 8 of the sub-tile; each sum runs over k in order. Sub-tiles
// above the diagonal are not written (no one reads them).
__global__ void __launch_bounds__(kGThreads) ssd_gram_f32(const F32Args g) {
  extern __shared__ float4 gr_smem[];
  const int pitch = g.gpitch;
  float* const cs = reinterpret_cast<float*>(gr_smem);   // [kGT][pitch]
  float* const bs = cs + kGT * pitch;                     // [kGT][pitch]
  const int tid = threadIdx.x;
  const long long bq = blockIdx.x, bi = bq / g.Hbc, hi = bq % g.Hbc;
  const int it = blockIdx.y;
  int ti = 0, si = blockIdx.z;
  while (si > ti) si -= ++ti;
  const long long t0 = (long long)it * kC;
  const float* cg = g.c + bi * g.cb + hi * g.ch + (t0 + kGT * ti) * g.ct;
  const float* bg = g.b + bi * g.bb + hi * g.bh + (t0 + kGT * si) * g.bt;
  const int S4 = (int)((g.S + 3) / 4);
  for (int e = tid; e < kGT * S4; e += kGThreads) {
    const int r = e / S4, k = 4 * (e % S4);
    const int nc = t0 + kGT * ti + r < g.T ? unit_bytes(g.S - k) : 0;
    const int nb = t0 + kGT * si + r < g.T ? unit_bytes(g.S - k) : 0;
    cp_async16(cs + r * pitch + k, nc ? cg + r * g.ct + k : g.c, nc);
    cp_async16(bs + r * pitch + k, nb ? bg + r * g.bt + k : g.b, nb);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  const int tr = tid / 8, tc = tid % 8;
  float acc[2][2] = {};
  for (int k = 0; k < 4 * S4; k += 4) {
    float4 cv[2], bv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) cv[i] = lds4(cs + (tr + 8 * i) * pitch + k);
#pragma unroll
    for (int j = 0; j < 2; ++j) bv[j] = lds4(bs + (tc + 8 * j) * pitch + k);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float v = acc[i][j];
        v = fmaf(cv[i].x, bv[j].x, v);
        v = fmaf(cv[i].y, bv[j].y, v);
        v = fmaf(cv[i].z, bv[j].z, v);
        acc[i][j] = fmaf(cv[i].w, bv[j].w, v);
      }
  }
  float* out = g.gram + ((bq * g.n_chunks + it) * kC + kGT * ti) * kC + kGT * si;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) out[(tr + 8 * i) * kC + tc + 8 * j] = acc[i][j];
}

// The outputs of one (b h, chunk, 64 output columns). Warp w owns rows
// 4 kOutR (w % kBands) + lr + 4 i (lr = lane / 8, i < kOutR) and the y
// columns 32 (w / kBands) + 4 lc .. + 3 (lc = lane % 8) of the tile:
// kOutR x 4 a thread. c h_in runs over S in slices of kSlice rows, double-
// buffered; G (the Gram kernel's) and x arrive meanwhile. One thread
// issues every load by TMA (out of bounds: zeros), on mbarriers: a slot's
// "full", and "gx" for G and x. c's 128-byte rows come 128-byte swizzled
// (16-byte unit j of row r at j ^ (r % 8)), so that the 4 rows a read
// spans fall in distinct banks.
__global__ void __launch_bounds__(kOutThreads, 3)
ssd_out_f32(const __grid_constant__ CUtensorMap mc, const __grid_constant__ CUtensorMap mh,
            const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mg,
            const F32Args g) {
  extern __shared__ float4 out_smem[];
  float* const slots = reinterpret_cast<float*>(     // [2][kSlot]: c [kC][kSlice], h_in
      (reinterpret_cast<uintptr_t>(out_smem) + 1023) & ~uintptr_t(1023));
  float* const sm = slots;                   // M [kC][kMP], over the slots after the k loop
  float* const sg = slots + 2 * kSlot;       // G [kC][kC]
  float* const sx = sg + kC * kC;            // [kC][kOutCols]
  float* const scum = sx + kC * kOutCols;    // [kC]
  float* const sdec = scum + kC;             // exp(cum)
  __shared__ __align__(8) uint64_t bars[3];  // full[2], gx
  const uint32_t full0 = smem_u32(&bars[0]), gx = full0 + 16;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long bh = blockIdx.x, bi = bh / g.H, hi = bh % g.H;
  const int it = blockIdx.y, p0 = blockIdx.z * kOutCols;
  const long long t0 = (long long)it * kC;
  const int tc = (int)min((long long)kC, g.T - t0);
  const bool carry = it > 0;                 // a nonzero state enters the chunk
  const int n_slices = carry ? (int)((g.S + kSlice - 1) / kSlice) : 0;

  if (tid == 0) {
    for (int s = 0; s < 3; ++s) mbar_init(full0 + 8 * s, 1);   // the expect-tx arrival
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // thread 0: state rows k0 .. k0 + kSlice of c and h_in into slot `slot`
  auto load = [&](int slot, int k0) {
    const uint32_t bar = full0 + 8 * slot;
    float* dc = slots + slot * kSlot;
    mbar_expect_tx(bar, kOutBytes);
    tma_load(smem_u32(dc), &mc, bar, g.c_rank, g.c_pos, k0, (int)t0, (int)hi, (int)bi);
    // h_in as [B H (n_chunks - 1)][S][Pp]: rows past S are out of bounds
    tma_load(smem_u32(dc + kC * kSlice), &mh, bar, 3, g.h_pos, p0, k0, 0,
             (int)(bh * (g.n_chunks - 1) + it - 1));
  };
  float a0 = 0.f, a1 = 0.f;                  // warp 0: a, for the table after the k loop
  if (warp == 0) {
    if (lane == 0) {
      for (int ks = 0; ks < min(n_slices, 2); ++ks) load(ks, ks * kSlice);
      mbar_expect_tx(gx, 4 * kC * (kC + kOutCols));
      tma_load(smem_u32(sg), &mg, gx, 3, g.g_pos, 0, 0, 0,
               (int)((bi * g.Hbc + (g.Hbc == 1 ? 0 : hi)) * g.n_chunks + it));
      tma_load(smem_u32(sx), &mx, gx, 4, g.x_pos, p0, (int)t0, (int)hi, (int)bi);
    }
    const float* ag = g.a + bi * g.ab + hi * g.ah;
    if (2 * lane < tc) a0 = ag[(t0 + 2 * lane) * g.at];
    if (2 * lane + 1 < tc) a1 = ag[(t0 + 2 * lane + 1) * g.at];
  }

  const int band = warp % kBands, side = warp / kBands, lr = lane / 8, lc = lane % 8;
  const int row0 = 4 * kOutR * band + lr;    // rows row0 + 4 i
  const int row_end = 4 * kOutR * (band + 1);
  float yacc[kOutR][4] = {};
  for (int ks = 0; ks < n_slices; ++ks) {
    mbar_wait(full0 + 8 * (ks & 1), (ks / 2) & 1);   // slice ks landed
    // c h_in over the slice's rows (c's rows swizzled, see above)
    const float* cs = slots + (ks & 1) * kSlot + row0 * kSlice;
    const float* hs = slots + (ks & 1) * kSlot + kC * kSlice + 32 * side + 4 * lc;
#pragma unroll
    for (int kk = 0; kk < kSlice; kk += 4) {
      float4 cv[kOutR];
#pragma unroll
      for (int i = 0; i < kOutR; ++i)
        cv[i] = lds4(cs + 4 * i * kSlice + 4 * ((kk / 4) ^ ((lr + 4 * i) & 7)));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 hv = lds4(hs + (kk + r) * kOutCols);
#pragma unroll
        for (int i = 0; i < kOutR; ++i) {
          const float cr = comp(cv[i], r);
          yacc[i][0] = fmaf(cr, hv.x, yacc[i][0]);
          yacc[i][1] = fmaf(cr, hv.y, yacc[i][1]);
          yacc[i][2] = fmaf(cr, hv.z, yacc[i][2]);
          yacc[i][3] = fmaf(cr, hv.w, yacc[i][3]);
        }
      }
    }
    if (ks + 2 < n_slices) {                 // slice ks + 2 into this slot
      __syncthreads();                       // every warp is done with it
      if (tid == 0) load(ks & 1, (ks + 2) * kSlice);
    }
  }
  mbar_wait(gx, 0);                          // G and x
  if (warp == 0) {                           // cum and exp(cum) of the chunk
    float c0, c1, end;
    chunk_cum(a0, a1, lane, c0, c1, end);
    scum[2 * lane] = c0;
    scum[2 * lane + 1] = c1;
    sdec[2 * lane] = expf(c0);
    sdec[2 * lane + 1] = expf(c1);
  }
  __syncthreads();
  // M = tril(G) exp(cum_t - cum_s), over the slots
  for (int e = tid; e < kC * kC; e += kOutThreads) {
    const int t = e / kC, s = e % kC;
    sm[t * kMP + s] = s <= t ? sg[e] * expf(scum[t] - scum[s]) : 0.f;
  }
  __syncthreads();
  // y = exp(cum_t) (c h_in) + M x, M x over the steps up to the band's
  // diagonal (M is 0 past it)
#pragma unroll
  for (int i = 0; i < kOutR; ++i) {
    const float d = sdec[row0 + 4 * i];
#pragma unroll
    for (int q = 0; q < 4; ++q) yacc[i][q] *= d;
  }
  const float* ms = sm + row0 * kMP;
  const float* xs = sx + 32 * side + 4 * lc;
#pragma unroll
  for (int s = 0; s < kC; s += 4) {
    if (s >= row_end) break;
    float4 mv[kOutR];
#pragma unroll
    for (int i = 0; i < kOutR; ++i) mv[i] = lds4(ms + 4 * i * kMP + s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 xv = lds4(xs + (s + r) * kOutCols);
#pragma unroll
      for (int i = 0; i < kOutR; ++i) {
        const float m = comp(mv[i], r);
        yacc[i][0] = fmaf(m, xv.x, yacc[i][0]);
        yacc[i][1] = fmaf(m, xv.y, yacc[i][1]);
        yacc[i][2] = fmaf(m, xv.z, yacc[i][2]);
        yacc[i][3] = fmaf(m, xv.w, yacc[i][3]);
      }
    }
  }
  const long long p = p0 + 32 * side + 4 * lc;
  const bool vec = g.P % 4 == 0;
#pragma unroll
  for (int i = 0; i < kOutR; ++i) {
    const int t = row0 + 4 * i;
    if (t >= tc || p >= g.P) continue;
    float* out = g.y + ((bi * g.T + t0 + t) * g.H + hi) * g.P + p;
    if (vec) {
      *reinterpret_cast<float4*>(out) =
          make_float4(yacc[i][0], yacc[i][1], yacc[i][2], yacc[i][3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (p + q < g.P) out[q] = yacc[i][q];
    }
  }
}

// A map of one f32 operand whose last axis (`inner` elements) is
// contiguous: boxes of `box0` of its elements by `rows` rows along t,
// zeros out of bounds; the outer axes t, h and b as encode_map orders them.
// Returns the map's rank, 0 if the encoding is refused.
int encode_f32(CUtensorMap* map, int (&pos)[3], const void* base, long long inner, int box0,
               int rows, const long long (&ext)[3], const long long (&st)[3],
               CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  int ord[3], n = 0;
  for (int i = 0; i < 3; ++i) {
    pos[i] = 0;
    if (ext[i] > 0) ord[n++] = i;
  }
  auto key = [&](int i) { return ext[i] > 1 ? st[i] : LLONG_MAX; };
  for (int i = 1; i < n; ++i)
    for (int j = i; j > 0 && key(ord[j]) < key(ord[j - 1]); --j) {
      const int t = ord[j];
      ord[j] = ord[j - 1];
      ord[j - 1] = t;
    }
  cuuint64_t dims[4] = {(cuuint64_t)inner, 1, 1, 1}, strides[3];
  cuuint32_t box[4] = {(cuuint32_t)box0, 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  long long span = (inner + 3) / 4 * 4;  // a 16-byte multiple
  for (int r = 0; r < n; ++r) {
    const int i = ord[r];
    const long long s = ext[i] > 1 ? st[i] : span;
    dims[1 + r] = (cuuint64_t)ext[i];
    strides[r] = (cuuint64_t)(s * 4);
    box[1 + r] = i == 0 ? rows : 1;
    pos[i] = 1 + r;
    span = s * ext[i];
  }
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1 + n, const_cast<void*>(base),
                        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 1 + n
             : 0;
}

bool valid_shape(long long B, long long T, long long H, long long P, long long S) {
  return B >= 1 && T >= 1 && H >= 1 && P >= 1 && S >= 1 && S <= kMaxS &&
         B * H <= 0x7fffffffLL && (P + 31) / 32 <= 65535;
}

cudaError_t ssd_f32(const float* x, const float* a, const float* b, const float* c,
                    float* y, long long B, long long T, long long H, long long P,
                    long long S, const long long* st, float* h_in, float* gram,
                    cudaStream_t s) {
  const long long n_chunks = (T + kC - 1) / kC;
  if (!valid_shape(B, T, H, P, S) || n_chunks > 65535) return cudaErrorInvalidValue;
  // TMA and cp.async: x, b and c need 16-byte-aligned bases and
  // strides (those of axes of extent 1 are never used)
  const long long ext[3] = {B, T, H};
  auto aligned = [&](const float* p, const long long* str) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
    for (int i = 0; i < 3; ++i)
      if (ext[i] > 1 && str[i] % 4) return false;
    return true;
  };
  if (!aligned(x, st) || !aligned(b, st + 6) || !aligned(c, st + 9))
    return cudaErrorMisalignedAddress;
  // the Gram kernel's staged rows: a whole number of float4s, odd, so that
  // eight neighbouring rows start in eight distinct 16-byte bank groups
  int units = (int)((S + 3) / 4) + 1;
  if (units % 2 == 0) ++units;
  const long long Hbc = st[8] == 0 && st[11] == 0 ? 1 : H;
  F32Args g{};
  g.x = x;
  g.a = a;
  g.b = b;
  g.c = c;
  g.y = y;
  g.h = h_in;
  g.gram = gram;
  g.T = T;
  g.H = H;
  g.P = P;
  g.S = S;
  g.Pp = (P + 3) / 4 * 4;
  g.Hbc = Hbc;
  g.gpitch = 4 * units;
  g.xb = st[0], g.xt = st[1], g.xh = st[2];
  g.ab = st[3], g.at = st[4], g.ah = st[5];
  g.bb = st[6], g.bt = st[7], g.bh = st[8];
  g.cb = st[9], g.ct = st[10], g.ch = st[11];
  g.n_chunks = (int)n_chunks;
  const unsigned BH = (unsigned)(B * H);
  {
    const dim3 grid((unsigned)(B * Hbc), (unsigned)n_chunks, kGSub);
    ssd_gram_f32<<<grid, kGThreads, 2 * kGT * g.gpitch * 4, s>>>(g);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (n_chunks > 1) {
    // TMA maps of b (rows along t, kStRows state columns) and x (kStCols)
    if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
    const long long ext_b[3] = {T, st[8] ? H : 0, B}, st_b[3] = {st[7], st[8], st[6]};
    const long long ext_x[3] = {T, H, B}, st_x[3] = {st[1], st[2], st[0]};
    CUtensorMap mb, mx;
    g.b_rank = encode_f32(&mb, g.b_pos, b, S, kStRows, kC, ext_b, st_b);
    if (!g.b_rank || !encode_f32(&mx, g.x_pos, x, P, kStCols, kC, ext_x, st_x))
      return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        ssd_state_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, kStSmem);
    if (e != cudaSuccess) return e;
    const dim3 grid(BH, (unsigned)((P + kStCols - 1) / kStCols),
                    (unsigned)((S + kStRows - 1) / kStRows));
    ssd_state_f32<<<grid, kStThreads, kStSmem, s>>>(mb, mx, g);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  // TMA maps of c (kSlice columns, 128-byte swizzle), h_in, x (kOutCols)
  // and G
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap mc, mh, mx, mg;
  const long long ext_c[3] = {T, st[11] ? H : 0, B}, st_c[3] = {st[10], st[11], st[9]};
  const long long ext_x[3] = {T, H, B}, st_x[3] = {st[1], st[2], st[0]};
  g.c_rank = encode_f32(&mc, g.c_pos, c, S, kSlice, kC, ext_c, st_c,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  // h_in [B H (n_chunks - 1)][S][Pp] by kSlice rows; G [B Hbc n_chunks][kC][kC]
  const long long ext_h[3] = {S, 0, B * H * (n_chunks - 1)}, st_h[3] = {g.Pp, 0, S * g.Pp};
  const long long ext_g[3] = {kC, 0, B * Hbc * n_chunks}, st_g[3] = {kC, 0, kC * kC};
  if (!g.c_rank || !encode_f32(&mx, g.x_pos, x, P, kOutCols, kC, ext_x, st_x) ||
      !encode_f32(&mg, g.g_pos, gram, kC, kC, kC, ext_g, st_g) ||
      (n_chunks > 1 &&
       !encode_f32(&mh, g.h_pos, h_in, g.Pp, kOutCols, kSlice, ext_h, st_h)))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_out_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, kOutSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid(BH, (unsigned)n_chunks, (unsigned)((P + kOutCols - 1) / kOutCols));
  ssd_out_f32<<<grid, kOutThreads, kOutSmem, s>>>(mc, n_chunks > 1 ? mh : mg, mx, mg, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 12 element strides (b, t, h) of x, a, b and c, in that order
// (b's and c's head stride 0 when they are group-shared [B, T, S]); the
// last axis of x, b and c is contiguous, their bases and other strides
// 16-byte aligned; y is a contiguous [B, T, H, P]; the scratch h_in holds
// B * H * (ceil(T / 64) - 1) * S * Pp floats (Pp: P rounded up to 4), gram
// B * Hbc * ceil(T / 64) * 64 * 64 (Hbc: 1 for group-shared b and c, else
// H). Returns the cudaError_t of the launches.
int ssd_scan_f32(const void* x, const void* a, const void* b, const void* c, void* y,
                 long long B, long long T, long long H, long long P, long long S,
                 const long long* strides, void* h_in, void* gram, void* stream) {
  return (int)ssd_f32(static_cast<const float*>(x), static_cast<const float*>(a),
                      static_cast<const float*>(b), static_cast<const float*>(c),
                      static_cast<float*>(y), B, T, H, P, S, strides,
                      static_cast<float*>(h_in), static_cast<float*>(gram),
                      (cudaStream_t)stream);
}

// the same, bf16, on the tensor-core body; the base addresses of x, b and c
// and their strides but the last 16-byte aligned (the TMA maps)
int ssd_scan_bf16(const void* x, const void* a, const void* b, const void* c, void* y,
                  long long B, long long T, long long H, long long P, long long S,
                  const long long* strides, void* stream) {
  if (!valid_shape(B, T, H, P, S)) return (int)cudaErrorInvalidValue;
  return (int)ssd_bf16(x, static_cast<const float*>(a), b, c, y, B, T, H, P, S, strides,
                       (cudaStream_t)stream);
}

const char* camr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
