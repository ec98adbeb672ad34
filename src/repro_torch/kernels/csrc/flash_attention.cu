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
// right-aligned against the keys (q_pos = i + Tk - Tq), causal and
// sliding-window masks (keys in (q_pos - window, q_pos]), m, l and the
// accumulator in f32, a row with no visible key written as 0 (the l == 0
// guard), output in q's type (f32 or bf16). Every tensor is addressed
// through strides in elements (the last axis contiguous), so the callers'
// [B, T, H, D] projections are read in place and the output can be
// written straight into the [B, Tq, Hq, D] layout the output projection
// reads.
//
// Bound: at a prefill of Tq = Tk = 1024 with granite's 32/8 heads and
// D = 64 the kernel does 4*32*1024^2*64/2 = 4.3 GFLOP of visible pairs over
// 10.5 MB of q, k, v and o: about 410 FLOP per byte, above the card's
// ridge, so it is bound by operations (4.3 us at the bf16 tensor-core
// peak). This first version does its products as f32 FMAs on the CUDA
// cores (67 TFLOP/s peak), not on the tensor cores: it is right first,
// and the wgmma/TMA version is later work.
//
// Design. The Pallas grid (B, Hq, nq, nk) carried m, l and acc in VMEM
// scratch along the sequential nk axis. Blocks on this card run in no
// order, so one block owns one (b, h, 32-query tile) and loops over the
// K/V tiles itself, with m, l and acc in registers: 4 warps of 8 query
// rows each. Per 32-key tile the block stages K (as float4 columns, so a
// lane reads its key's 4 dims at once without bank conflicts) and V in
// shared memory as f32; lane j scores key j against the warp's 8 rows
// (q read as broadcast float4 from shared memory), the row max and sum go
// through warp shuffles, the probabilities through a per-warp shared
// table, and lane d accumulates output dims d, d + 32, ... The block skips
// the key tiles that the causal and window masks leave empty (the Pallas
// kernel's pl.when on the block indices), a warp skips a tile none of its
// rows sees, and the ragged edges of Tq and Tk are masked in place (no
// padding). For D = 256 the staged tiles take 100 KB of shared memory,
// above the 48 KB default: the launcher raises the limit with
// cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 8;                 // query rows per warp
constexpr int kBQ = kWarps * kRows;      // query rows per block
constexpr int kBK = 32;                  // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

template <typename T>
cudaError_t by_dim(const Args& a, long long B, long long D, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(a, B, s);
    case 32: return launch<T, 32>(a, B, s);
    case 64: return launch<T, 64>(a, B, s);
    case 128: return launch<T, 128>(a, B, s);
    case 256: return launch<T, 256>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

int flash_any(bool bf16, const void* q, const void* k, const void* v, void* o,
              long long B, long long Hq, long long Hkv, long long Tq, long long Tk,
              long long D, const long long* st, float scale, float softcap,
              int causal, long long window, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv || Tq < 1 || Tk < Tq || B * Hq > 0x7fffffffLL ||
      (Tq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, Hq, Hq / Hkv, Tq, Tk,
         st[0], st[1], st[2], st[3], st[4], st[5],
         st[6], st[7], st[8], st[9], st[10], st[11],
         scale, softcap, causal, window};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? by_dim<__nv_bfloat16>(a, B, D, s) : by_dim<float>(a, B, D, s));
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
  return flash_any(false, q, k, v, o, B, Hq, Hkv, Tq, Tk, D, strides, scale, softcap,
                   causal, window, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         long long B, long long Hq, long long Hkv, long long Tq,
                         long long Tk, long long D, const long long* strides,
                         float scale, float softcap, int causal, long long window,
                         void* stream) {
  return flash_any(true, q, k, v, o, B, Hq, Hkv, Tq, Tk, D, strides, scale, softcap,
                   causal, window, stream);
}

const char* camr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
