// The alpha-combiner of the CAMR map phase, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/aggregate.py::aggregate (_agg_kernel)
//
//   out[s, :] = sum of values[r, :] over rows r with ids[r] == s,
//               for 0 <= s < S; rows whose id lies outside [0, S) drop.
//
// values T[n, d], ids i32[n] -> out T[S, d], T float32 (aggregate_f32) or
// bfloat16 (aggregate_bf16, the bf16 grad-sync lane's memo rows). Sums
// are taken in f32 registers either way and a bf16 result is rounded once,
// to nearest even, on the store: the Pallas kernel's f32 accumulation and
// final astype.
//
// Bound: device memory bandwidth. The least traffic is each row with a
// valid id read once and each output row written once; the work is one
// f32 add per valid value.
//
// Design. The Pallas kernel summed through one-hot matrix products on
// the MXU, carrying the output tile in VMEM across the sequential n-axis
// of its grid. Hopper blocks run in no fixed order, so here one thread
// owns a column group (16 bytes of adjacent columns, four f32 or eight
// bf16, when d is a multiple of the group and both pointers are 16-byte
// aligned; else one column) and walks the n rows in ascending order,
// adding row r into a register accumulator of segment ids[r]. Segments
// are taken kSegTile at a time, so each row is still read once in all: a
// row is loaded only in the pass of its segment tile. There are no
// atomics and no tensor-core or TF32 products, so the result is
// deterministic, each segment is 0.0f + its rows in ascending order, and
// it is bit-exact when every segment holds one row (the trainer's
// gamma = 1 case; -0.0 becomes +0.0 there, as in the Pallas kernel).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSegTile = 8;

// V adjacent values of type T <-> f32 registers.
template <typename T, int V>
struct Io;
template <>
struct Io<float, 1> {
  __device__ static void load(const float* p, float* v) { v[0] = *p; }
  __device__ static void store(float* p, const float* v) { *p = v[0]; }
};
template <>
struct Io<float, 4> {
  __device__ static void load(const float* p, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Io<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    *p = __float2bfloat16_rn(v[0]);
  }
};
template <>
struct Io<__nv_bfloat16, 8> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 f = __bfloat1622float2(h[u]);
      v[2 * u] = f.x;
      v[2 * u + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      h[u].x = __float2bfloat16_rn(v[2 * u]);
      h[u].y = __float2bfloat16_rn(v[2 * u + 1]);
    }
    *reinterpret_cast<uint4*>(p) = x;
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
aggregate_kernel(const T* __restrict__ values, const int32_t* __restrict__ ids,
                 T* __restrict__ out, long long n, long long d, int S) {
  const long long c = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (c >= d) return;
  for (int s0 = 0; s0 < S; s0 += kSegTile) {
    float acc[kSegTile][V];
#pragma unroll
    for (int t = 0; t < kSegTile; ++t)
#pragma unroll
      for (int u = 0; u < V; ++u) acc[t][u] = 0.0f;
    for (long long r = 0; r < n; ++r) {
      const int id = __ldg(ids + r);
      if (id < s0 || id >= S || id - s0 >= kSegTile) continue;
      float v[V];
      Io<T, V>::load(values + r * d + c, v);
#pragma unroll
      for (int t = 0; t < kSegTile; ++t) {
        if (t == id - s0) {
#pragma unroll
          for (int u = 0; u < V; ++u) acc[t][u] += v[u];
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kSegTile; ++t) {
      if (s0 + t < S) Io<T, V>::store(out + (long long)(s0 + t) * d + c, acc[t]);
    }
  }
}

// V: columns per thread for the wide path (1 when vec is 1).
template <typename T, int V>
int launch(const void* values, const void* ids, void* out, long long n, long long d,
           long long S, int vec, cudaStream_t s) {
  if (vec != V && vec != 1) return (int)cudaErrorInvalidValue;
  const long long cols = vec == V ? d / V : d;
  const dim3 grid((unsigned)((cols + kThreads - 1) / kThreads));
  if (vec == V) {
    aggregate_kernel<T, V><<<grid, kThreads, 0, s>>>(
        (const T*)values, (const int32_t*)ids, (T*)out, n, d, (int)S);
  } else {
    aggregate_kernel<T, 1><<<grid, kThreads, 0, s>>>(
        (const T*)values, (const int32_t*)ids, (T*)out, n, d, (int)S);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// vec: 4 (float4 accesses) or 1. Returns the cudaError_t of the launch.
int aggregate_f32(const void* values, const void* ids, void* out, long long n,
                  long long d, long long S, int vec, void* stream) {
  return launch<float, 4>(values, ids, out, n, d, S, vec, (cudaStream_t)stream);
}

// vec: 8 (16-byte accesses of eight bf16) or 1.
int aggregate_bf16(const void* values, const void* ids, void* out, long long n,
                   long long d, long long S, int vec, void* stream) {
  return launch<__nv_bfloat16, 8>(values, ids, out, n, d, S, vec, (cudaStream_t)stream);
}

const char* camr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
