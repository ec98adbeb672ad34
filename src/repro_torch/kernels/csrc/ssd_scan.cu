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
// * f32: ssd_kernel, f32 FMAs on the CUDA cores (held to an f64 evaluation
//   at 1e-5 x max|y|).
//
// Bound: at mamba2's serving prefill (T = 1024, 64 heads of P = 64, S = 128,
// bf16, group-shared b/c) one layer does 3.76 GFLOP the way the Pallas
// kernel counts it (c b^T, M x, c h and the state update per head and
// chunk) over 17.6 MB (x and y 8.4 MB each; a, b, c 0.26 MB each): 3.8 us
// at the bf16 tensor-core peak, 5.2 us at 3.35 TB/s, so it is bound by
// bytes.
//
// Design of the f32 body. The Pallas grid (B, H, n_chunks) carried h in
// VMEM scratch along the sequential chunk axis. Blocks on this card run in
// no order, so one block owns one (b, head, tile of 32 state columns) and
// loops over the chunks itself, with h in shared memory: the P columns of h
// and y are independent, so the tiles give a B = 1 prefill 128 blocks on
// 132 SMs. Per chunk the block stages c, b (f32, rows padded so that float4
// reads of eight neighbouring rows hit distinct banks) and its x columns,
// takes the cumulative sum of a, then forms M (a 4x4 register tile per
// thread), y (a 2x4 tile: c h and M x) and the state update (a 4x4 tile of
// h). Rows past T in the last chunk are staged as zeros (a = 0, x = 0, as
// the Pallas kernel pads), so nothing is copied or padded in memory, and
// the last chunk skips the state update nobody reads. At S = 128 the
// staging takes 109 KB of shared memory, above the 48 KB default: the
// launcher raises the limit with cudaFuncSetAttribute.
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
constexpr int kPT = 32;         // state / output columns per block
constexpr int kThreads = 256;
constexpr int kMaxS = 256;

struct Args {
  const void* x;
  const float* a;
  const void* b;
  const void* c;
  void* y;
  long long T, H, P, S;
  long long xb, xt, xh;         // element strides of x (p contiguous)
  long long ab, at, ah;
  long long bb, bt, bh;         // bh == 0: group-shared
  long long cb, ct, ch;
  int sw;                       // padded row stride of staged b, c (floats)
};

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// floats of dynamic shared memory for a padded row stride sw
__host__ __device__ constexpr long long smem_floats(int sw, long long S) {
  return 2LL * kC * sw + kC * kPT + S * kPT + kC * kC + 3 * kC;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_kernel(const Args g) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int sw = g.sw;
  const int S = (int)g.S;
  const int S4 = (S + 3) / 4 * 4;             // staged columns (zero-padded)
  float* cs = sm;                             // [kC][sw]
  float* bs = cs + kC * sw;                   // [kC][sw]
  float* xs = bs + kC * sw;                   // [kC][kPT]
  float* hs = xs + kC * kPT;                  // [S][kPT]
  float* ms = hs + (long long)S * kPT;        // [kC][kC]
  float* cum = ms + kC * kC;                  // [kC]
  float* dec = cum + kC;                      // exp(cum_t)
  float* wts = dec + kC;                      // exp(cum_end - cum_s)

  const int tid = threadIdx.x;
  const long long bh = blockIdx.x;
  const long long bi = bh / g.H, hi = bh % g.H;
  const int p0 = blockIdx.y * kPT;
  const T* xg = static_cast<const T*>(g.x) + bi * g.xb + hi * g.xh + p0;
  const float* ag = g.a + bi * g.ab + hi * g.ah;
  const T* bg = static_cast<const T*>(g.b) + bi * g.bb + hi * g.bh;
  const T* cg = static_cast<const T*>(g.c) + bi * g.cb + hi * g.ch;
  T* yg = static_cast<T*>(g.y) + (bi * g.T * g.H + hi) * g.P + p0;
  const long long yt = g.H * g.P;

  for (int e = tid; e < S * kPT; e += kThreads) hs[e] = 0.f;

  for (long long t0 = 0; t0 < g.T; t0 += kC) {
    const int tc = (int)min((long long)kC, g.T - t0);
    const bool last = t0 + kC >= g.T;
    // ---- stage the chunk (rows >= tc as zeros) ----
    for (int e = tid; e < kC * S4; e += kThreads) {
      const int t = e / S4, k = e % S4;
      float bv = 0.f, cv = 0.f;
      if (t < tc && k < S) {
        bv = load1(bg + (t0 + t) * g.bt + k);
        cv = load1(cg + (t0 + t) * g.ct + k);
      }
      bs[t * sw + k] = bv;
      cs[t * sw + k] = cv;
    }
    for (int e = tid; e < kC * kPT; e += kThreads) {
      const int t = e / kPT, p = e % kPT;
      xs[e] = (t < tc && p0 + p < g.P) ? load1(xg + (t0 + t) * g.xt + p) : 0.f;
    }
    if (tid < 32) {        // in-chunk cumulative sum of a: one warp, 2 a lane
      const int t = 2 * tid;
      const float a0 = t < tc ? ag[(t0 + t) * g.at] : 0.f;
      const float a1 = t + 1 < tc ? ag[(t0 + t + 1) * g.at] : 0.f;
      float run = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, run, o);
        if (tid >= o) run += v;
      }
      const float end = __shfl_sync(0xffffffffu, run, 31);
      const float c0 = run - a1;
      cum[t] = c0;
      cum[t + 1] = run;
      dec[t] = expf(c0);
      dec[t + 1] = expf(run);
      wts[t] = expf(end - c0);
      wts[t + 1] = expf(end - run);
    }
    __syncthreads();

    // ---- M = tril(c b^T * exp(cum_t - cum_s)): rows ti + 16i, cols si + 16j
    {
      const int ti = tid / 16, si = tid % 16;
      float acc[4][4] = {};
      for (int k = 0; k < S4; k += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = *reinterpret_cast<const float4*>(cs + (ti + 16 * i) * sw + k);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(bs + (si + 16 * j) * sw + k);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] += cv[i].x * bv[j].x + cv[i].y * bv[j].y +
                         cv[i].z * bv[j].z + cv[i].w * bv[j].w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ti + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = si + 16 * j;
          ms[t * kC + s] = s <= t ? acc[i][j] * expf(cum[t] - cum[s]) : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y = exp(cum_t) (c_t . h) + M x: rows ti + 32i, cols 4pi..4pi+3
    {
      const int ti = tid / 8, pi = tid % 8;
      float st[2][4] = {}, in[2][4] = {};
      for (int k = 0; k < S4; k += 4) {
        float4 cv[2], hv[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          cv[i] = *reinterpret_cast<const float4*>(cs + (ti + 32 * i) * sw + k);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          hv[r] = k + r < S ? *reinterpret_cast<const float4*>(hs + (k + r) * kPT + 4 * pi)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float cr[4] = {cv[i].x, cv[i].y, cv[i].z, cv[i].w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            st[i][0] += cr[r] * hv[r].x;
            st[i][1] += cr[r] * hv[r].y;
            st[i][2] += cr[r] * hv[r].z;
            st[i][3] += cr[r] * hv[r].w;
          }
        }
      }
      const int smax = min(ti + 32, tc - 1);  // M is 0 past the diagonal
      for (int s = 0; s <= smax; ++s) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + s * kPT + 4 * pi);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float m = ms[(ti + 32 * i) * kC + s];
          in[i][0] += m * xv.x;
          in[i][1] += m * xv.y;
          in[i][2] += m * xv.z;
          in[i][3] += m * xv.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = ti + 32 * i;
        if (t >= tc) continue;
        T* out = yg + (t0 + t) * yt;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = 4 * pi + q;
          if (p0 + p < g.P) store1(out + p, dec[t] * st[i][q] + in[i][q]);
        }
      }
    }
    if (last) break;
    __syncthreads();

    // ---- h = exp(cum_end) h + sum_s exp(cum_end - cum_s) b_s x_s^T:
    //      rows 4ki..4ki+3, cols 4pi..4pi+3
    {
      const float dend = dec[kC - 1];
      for (int e = tid; e < (S4 / 4) * (kPT / 4); e += kThreads) {
        const int ki = e / (kPT / 4), pi = e % (kPT / 4);
        float acc[4][4] = {};
        for (int s = 0; s < tc; ++s) {
          const float4 bv = *reinterpret_cast<const float4*>(bs + s * sw + 4 * ki);
          float4 xv = *reinterpret_cast<const float4*>(xs + s * kPT + 4 * pi);
          const float w = wts[s];
          xv.x *= w;
          xv.y *= w;
          xv.z *= w;
          xv.w *= w;
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[r][0] += br[r] * xv.x;
            acc[r][1] += br[r] * xv.y;
            acc[r][2] += br[r] * xv.z;
            acc[r][3] += br[r] * xv.w;
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int k = 4 * ki + r;
          if (k >= S) break;
          float4* hp = reinterpret_cast<float4*>(hs + k * kPT + 4 * pi);
          float4 hv = *hp;
          hv.x = dend * hv.x + acc[r][0];
          hv.y = dend * hv.y + acc[r][1];
          hv.z = dend * hv.z + acc[r][2];
          hv.w = dend * hv.w + acc[r][3];
          *hp = hv;
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const Args& g, long long B, cudaStream_t s) {
  const size_t smem = (size_t)smem_floats(g.sw, g.S) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)(B * g.H), (unsigned)((g.P + kPT - 1) / kPT));
  ssd_kernel<T><<<grid, kThreads, smem, s>>>(g);
  return cudaGetLastError();
}

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

int ssd_any(bool bf16, const void* x, const float* a, const void* b, const void* c,
            void* y, long long B, long long T, long long H, long long P,
            long long S, const long long* st, void* stream) {
  if (B < 1 || T < 1 || H < 1 || P < 1 || S < 1 || S > kMaxS ||
      B * H > 0x7fffffffLL || (P + kPT - 1) / kPT > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) return (int)ssd_bf16(x, a, b, c, y, B, T, H, P, S, st, s);
  // staged rows: a multiple of 4 floats (float4 reads) whose quarter is odd,
  // so eight neighbouring rows start in eight distinct 16-byte bank groups
  int sw = (int)((S + 3) / 4) + 1;
  if (sw % 2 == 0) ++sw;
  Args g{x, a, b, c, y, T, H, P, S,
         st[0], st[1], st[2], st[3], st[4], st[5],
         st[6], st[7], st[8], st[9], st[10], st[11], 4 * sw};
  return (int)launch<float>(g, B, s);
}

}  // namespace

extern "C" {

// strides: 12 element strides (b, t, h) of x, a, b and c, in that order
// (b's and c's head stride 0 when they are group-shared [B, T, S]); the
// last axis of x, b and c is contiguous; y is a contiguous [B, T, H, P].
// Returns the cudaError_t of the launch.
int ssd_scan_f32(const void* x, const void* a, const void* b, const void* c, void* y,
                 long long B, long long T, long long H, long long P, long long S,
                 const long long* strides, void* stream) {
  return ssd_any(false, x, static_cast<const float*>(a), b, c, y, B, T, H, P, S,
                 strides, stream);
}

// the same, bf16, on the tensor-core body; the base addresses of x, b and c
// and their strides but the last 16-byte aligned (the TMA maps)
int ssd_scan_bf16(const void* x, const void* a, const void* b, const void* c, void* y,
                  long long B, long long T, long long H, long long P, long long S,
                  const long long* strides, void* stream) {
  return ssd_any(true, x, static_cast<const float*>(a), b, c, y, B, T, H, P, S,
                 strides, stream);
}

const char* camr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
