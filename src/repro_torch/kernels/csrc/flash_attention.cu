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
// * f32: flash_kernel, f32 FMAs on the CUDA cores (held to its plain
//   version at 2e-5, which bf16 operands could not meet).
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
// f32: the CUDA-core body (one block per (b, head, 32-query tile), 4 warps
// of 8 rows, 32-key tiles staged in shared memory as f32; lane j scores key
// j, lane d accumulates output dims d, d + 32, ...)
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kRows = 8;                 // query rows per warp
constexpr int kBQ = kWarps * kRows;      // query rows per block
constexpr int kBK = 32;                  // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long Hq, rep, Tq, Tk;
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;  // strides
  float scale, softcap;                  // softcap <= 0: none
  int causal;
  long long window;                      // <= 0: none
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  // q tile [kBQ][D], K tile as float4 columns [D/4][kBK], V tile
  // [kBK][D], probabilities [kWarps][kBK][kRows]
  return sizeof(float) * (kBQ * D + D * kBK + kBK * D + kWarps * kBK * kRows);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const Args a) {
  constexpr int DQ = D / 4;
  constexpr int DPL = (D + 31) / 32;     // output dims per lane
  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);
  float4* s_k = reinterpret_cast<float4*>(s_q + kBQ * D);   // [DQ][kBK]
  float* s_v = reinterpret_cast<float*>(s_k + DQ * kBK);    // [kBK][D]
  float* s_p = s_v + kBK * D;                               // [w][kBK][kRows]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long b = blockIdx.x / a.Hq, h = blockIdx.x % a.Hq;
  const long long hk = h / a.rep;
  const long long q0 = (long long)blockIdx.y * kBQ;
  const long long shift = a.Tk - a.Tq;
  const T* qg = static_cast<const T*>(a.q) + b * a.qb + h * a.qh;
  const T* kg = static_cast<const T*>(a.k) + b * a.kb + hk * a.kh;
  const T* vg = static_cast<const T*>(a.v) + b * a.vb + hk * a.vh;
  T* og = static_cast<T*>(a.o) + b * a.ob + h * a.oh;

  // the query tile, scaled as the Pallas kernel scales it (before the dot)
  for (int e = threadIdx.x; e < kBQ * DQ; e += kThreads) {
    const int r = e / DQ, dq = e % DQ;
    const long long qi = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < a.Tq) {
      x = load4(qg + qi * a.qt + 4 * dq);
      x.x *= a.scale; x.y *= a.scale; x.z *= a.scale; x.w *= a.scale;
    }
    reinterpret_cast<float4*>(s_q)[e] = x;
  }

  // the keys any row of the block sees
  const long long last_q = (q0 + kBQ < a.Tq ? q0 + kBQ : a.Tq) - 1;
  long long kbeg = 0, kend = a.Tk;
  if (a.causal && last_q + shift + 1 < kend) kend = last_q + shift + 1;
  if (a.window > 0 && q0 + shift - a.window + 1 > 0) kbeg = q0 + shift - a.window + 1;
  kbeg = kbeg / kBK * kBK;
  // the rows of this warp
  const long long wq0 = q0 + warp * kRows;
  const long long wq1 = (wq0 + kRows < a.Tq ? wq0 + kRows : a.Tq) - 1;

  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  const float4* q4 = reinterpret_cast<const float4*>(s_q) + warp * kRows * DQ;
  float* p_w = s_p + warp * kBK * kRows;
  for (long long k0 = kbeg; k0 < kend; k0 += kBK) {
    __syncthreads();                     // the previous tile is consumed
    for (int e = threadIdx.x; e < kBK * DQ; e += kThreads) {
      const int j = e / DQ, dq = e % DQ;
      const long long kj = k0 + j;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (kj < a.Tk) {
        kx = load4(kg + kj * a.kt + 4 * dq);
        vx = load4(vg + kj * a.vt + 4 * dq);
      }
      s_k[dq * kBK + j] = kx;
      reinterpret_cast<float4*>(s_v)[e] = vx;
    }
    __syncthreads();

    // does any row of this warp see any key of this tile?
    bool live = wq0 < a.Tq;
    if (a.causal) live = live && k0 <= wq1 + shift;
    if (a.window > 0) live = live && k0 + kBK - 1 > wq0 + shift - a.window;
    if (!live) continue;                 // warp-uniform

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int dq = 0; dq < DQ; ++dq) {
      const float4 kx = s_k[dq * kBK + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qx = q4[r * DQ + dq];
        s[r] = fmaf(qx.x, kx.x, s[r]);
        s[r] = fmaf(qx.y, kx.y, s[r]);
        s[r] = fmaf(qx.z, kx.z, s[r]);
        s[r] = fmaf(qx.w, kx.w, s[r]);
      }
    }

    const long long kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long qi = wq0 + r, qpos = qi + shift;
      bool ok = kpos < a.Tk && qi < a.Tq;
      if (a.causal) ok = ok && kpos <= qpos;
      if (a.window > 0) ok = ok && kpos > qpos - a.window;
      float x = s[r];
      if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
      x = ok ? x : kNeg;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float alpha = expf(m[r] - m_new);
      const float p = ok ? expf(x - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      p_w[lane * kRows + r] = p;
    }
    __syncwarp();
    for (int j = 0; j < kBK; ++j) {
      const float4 pa = reinterpret_cast<const float4*>(p_w + j * kRows)[0];
      const float4 pb = reinterpret_cast<const float4*>(p_w + j * kRows)[1];
      const float pr[kRows] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (D % 32 == 0 || d < D) {
          const float vv = s_v[j * D + d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][i] = fmaf(pr[r], vv, acc[r][i]);
        }
      }
    }
    __syncwarp();                        // p_w is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long qi = wq0 + r;
    if (qi >= a.Tq) break;
    const float den = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (D % 32 == 0 || d < D) store1(og + qi * a.ot + d, acc[r][i] / den);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, long long B, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)(B * a.Hq), (unsigned)((a.Tq + kBQ - 1) / kBQ));
  flash_kernel<T, D><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

cudaError_t flash_f32(const void* q, const void* k, const void* v, void* o,
                      long long B, long long Hq, long long Hkv, long long Tq,
                      long long Tk, long long D, const long long* st, float scale,
                      float softcap, int causal, long long window, cudaStream_t s) {
  if ((Tq + kBQ - 1) / kBQ > 65535) return cudaErrorInvalidValue;
  const Args a{q, k, v, o, Hq, Hq / Hkv, Tq, Tk,
               st[0], st[1], st[2], st[3], st[4], st[5],
               st[6], st[7], st[8], st[9], st[10], st[11],
               scale, softcap, causal, window};
  switch (D) {
    case 16: return launch<float, 16>(a, B, s);
    case 32: return launch<float, 32>(a, B, s);
    case 64: return launch<float, 64>(a, B, s);
    case 80: return launch<float, 80>(a, B, s);
    case 128: return launch<float, 128>(a, B, s);
    case 256: return launch<float, 256>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

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
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        long long B, long long Hq, long long Hkv, long long Tq,
                        long long Tk, long long D, const long long* strides,
                        float scale, float softcap, int causal, long long window,
                        void* stream) {
  if (!valid(B, Hq, Hkv, Tq, Tk, causal, window)) return (int)cudaErrorInvalidValue;
  return (int)flash_f32(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, strides, scale, softcap,
                        causal, window, (cudaStream_t)stream);
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
