// The alpha-combiner of the CAMR map phase, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/aggregate.py::aggregate (_agg_kernel)
//
//   out[s, :] = sum of values[r, :] over rows r with ids[r] == s,
//               for 0 <= s < S; rows whose id lies outside [0, S) drop.
//
// values f32[n, d], ids i32[n] -> out f32[S, d].
//
// Bound: device memory bandwidth. The least traffic is each row with a
// valid id read once and each output row written once; the work is one
// f32 add per valid value.
//
// Design. The Pallas kernel summed through one-hot matrix products on
// the MXU, carrying the output tile in VMEM across the sequential n-axis
// of its grid. Hopper blocks run in no fixed order, so here one thread
// owns a column (four adjacent columns as a float4 when d % 4 == 0 and
// both pointers are 16-byte aligned) and walks the n rows in ascending
// order, adding row r into a register accumulator of segment ids[r].
// Segments are taken kSegTile at a time, so each row is still read once
// in all: a row is loaded only in the pass of its segment tile. There
// are no atomics and no tensor-core or TF32 products, so the result is
// deterministic, each segment is 0.0f + its rows in ascending order, and
// it is bit-exact when every segment holds one row (the trainer's
// gamma = 1 case).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSegTile = 8;

template <int V>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void load(const float* p, float* v) { v[0] = *p; }
  __device__ static void store(float* p, const float* v) { *p = v[0]; }
};
template <>
struct Vec<4> {
  __device__ static void load(const float* p, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <int V>
__global__ void __launch_bounds__(kThreads)
aggregate_kernel(const float* __restrict__ values, const int32_t* __restrict__ ids,
                 float* __restrict__ out, long long n, long long d, int S) {
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
      Vec<V>::load(values + r * d + c, v);
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
      if (s0 + t < S) Vec<V>::store(out + (long long)(s0 + t) * d + c, acc[t]);
    }
  }
}

}  // namespace

extern "C" {

// vec: 4 (float4 accesses) or 1. Returns the cudaError_t of the launch.
int aggregate_f32(const void* values, const void* ids, void* out, long long n,
                  long long d, long long S, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long cols = vec == 4 ? d / 4 : d;
  const dim3 grid((unsigned)((cols + kThreads - 1) / kThreads));
  if (vec == 4) {
    aggregate_kernel<4><<<grid, kThreads, 0, s>>>(
        (const float*)values, (const int32_t*)ids, (float*)out, n, d, (int)S);
  } else {
    aggregate_kernel<1><<<grid, kThreads, 0, s>>>(
        (const float*)values, (const int32_t*)ids, (float*)out, n, d, (int)S);
  }
  return (int)cudaGetLastError();
}

const char* camr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
