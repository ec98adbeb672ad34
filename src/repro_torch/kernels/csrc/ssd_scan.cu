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
// Bound: at mamba2's serving prefill (T = 1024, 64 heads of P = 64, S = 128,
// bf16, group-shared b/c) one layer does 3.76 GFLOP the way the Pallas
// kernel counts it (c b^T, M x, c h and the state update per head and
// chunk) over 17.6 MB (x and y 8.4 MB each; a, b, c 0.26 MB each): 3.8 us
// at the bf16 tensor-core peak, 5.2 us at 3.35 TB/s, so it is bound by
// bytes. This first version does every product as f32 FMAs on the CUDA
// cores and recomputes c b^T in every head's block; tensor cores (wgmma),
// TMA and one c b^T per chunk shared by the heads are later work.
//
// Design. The Pallas grid (B, H, n_chunks) carried h in VMEM scratch along
// the sequential chunk axis. Blocks on this card run in no order, so one
// block owns one (b, head, tile of 32 state columns) and loops over the
// chunks itself, with h in shared memory: the P columns of h and y are
// independent, so the tiles give a B = 1 prefill 128 blocks on 132 SMs. Per
// chunk the block stages c, b (f32, rows padded so that float4 reads of
// eight neighbouring rows hit distinct banks) and its x columns, takes the
// cumulative sum of a, then forms M (a 4x4 register tile per thread), y (a
// 2x4 tile: c h and M x) and the state update (a 4x4 tile of h). Rows past
// T in the last chunk are staged as zeros (a = 0, x = 0, as the Pallas
// kernel pads), so nothing is copied or padded in memory, and the last
// chunk skips the state update nobody reads. At S = 128 the staging takes
// 109 KB of shared memory, above the 48 KB default: the launcher raises the
// limit with cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

int ssd_any(bool bf16, const void* x, const float* a, const void* b, const void* c,
            void* y, long long B, long long T, long long H, long long P,
            long long S, const long long* st, void* stream) {
  if (B < 1 || T < 1 || H < 1 || P < 1 || S < 1 || S > kMaxS ||
      B * H > 0x7fffffffLL || (P + kPT - 1) / kPT > 65535)
    return (int)cudaErrorInvalidValue;
  // staged rows: a multiple of 4 floats (float4 reads) whose quarter is odd,
  // so eight neighbouring rows start in eight distinct 16-byte bank groups
  int sw = (int)((S + 3) / 4) + 1;
  if (sw % 2 == 0) ++sw;
  Args g{x, a, b, c, y, T, H, P, S,
         st[0], st[1], st[2], st[3], st[4], st[5],
         st[6], st[7], st[8], st[9], st[10], st[11], 4 * sw};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? launch<__nv_bfloat16>(g, B, s) : launch<float>(g, B, s));
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
