// Fused gather-XOR codec of the CAMR coded shuffle, for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   src/repro/kernels/xor_code.py::xor_encode_gather (_encode_gather_kernel)
//   src/repro/kernels/xor_code.py::xor_decode_gather (_decode_gather_kernel)
//
//   encode: out[v, i] = XOR_j { chunks[v, idx[v, i, j]] : mask[v, i, j] }
//   decode: out[v, i] = recv[v, rsel[v, i]]
//                       ^ XOR_j { chunks[v, idx[v, i, j]] : mask[v, i, j] }
//
// with a leading virtual-device axis v: chunks u32[K, P, pk], idx
// i32[K, rows, m], mask bool[K, rows, m], recv u32[K, Rr, pk], rsel
// i32[K, rows]. One launch covers all K virtual workers.
//
// Bound: pure data movement with one XOR per word, so device memory
// bandwidth. The least traffic is each VALID source row read once, each
// recv row read once (decode) and each output row written once.
//
// Design. Grid (word-blocks of pk, rows, K). The Pallas kernel fetched
// sources through scalar-prefetched BlockSpec index maps with the source
// axis innermost; here each block loads its own m indices and mask bytes
// into shared memory and runs the loop over sources inside the block, so
// every output word is written once. A masked-off source skips its load
// (AND with 0 and skipping give the same bits), so invalid rows cost no
// traffic. Each thread moves one vector word W per source: uint4 (16 B)
// when pk % 4 == 0 and every base pointer is 16-byte aligned, uint2
// (8 B) when pk % 2 == 0 and 8-byte aligned, else one u32; the wrapper
// picks W. Indices must be in range for every valid source; masked-off
// entries are never dereferenced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSrc = 64;

__device__ __forceinline__ uint32_t xorw(uint32_t a, uint32_t b) { return a ^ b; }
__device__ __forceinline__ uint2 xorw(uint2 a, uint2 b) {
  return make_uint2(a.x ^ b.x, a.y ^ b.y);
}
__device__ __forceinline__ uint4 xorw(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

template <typename W> __device__ __forceinline__ W zerow();
template <> __device__ __forceinline__ uint32_t zerow<uint32_t>() { return 0u; }
template <> __device__ __forceinline__ uint2 zerow<uint2>() { return make_uint2(0u, 0u); }
template <> __device__ __forceinline__ uint4 zerow<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}

// Loads this block's m source rows and mask bytes into shared memory.
__device__ __forceinline__ void load_sources(const int32_t* __restrict__ idx,
                                             const uint8_t* __restrict__ mask,
                                             long long tab, int m,
                                             int32_t* s_idx, uint8_t* s_ok) {
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    s_idx[j] = idx[tab + j];
    s_ok[j] = mask[tab + j];
  }
  __syncthreads();
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
encode_gather_kernel(const W* __restrict__ chunks, const int32_t* __restrict__ idx,
                     const uint8_t* __restrict__ mask, W* __restrict__ out,
                     long long P, int rows, int m, long long pkw) {
  __shared__ int32_t s_idx[kMaxSrc];
  __shared__ uint8_t s_ok[kMaxSrc];
  const long long dev = blockIdx.z;
  const long long row = dev * rows + blockIdx.y;
  load_sources(idx, mask, row * m, m, s_idx, s_ok);
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= pkw) return;
  const W* base = chunks + dev * P * pkw + col;
  W acc = zerow<W>();
  for (int j = 0; j < m; ++j) {
    if (s_ok[j]) acc = xorw(acc, base[(long long)s_idx[j] * pkw]);
  }
  out[row * pkw + col] = acc;
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
decode_gather_kernel(const W* __restrict__ recv, const W* __restrict__ chunks,
                     const int32_t* __restrict__ rsel, const int32_t* __restrict__ idx,
                     const uint8_t* __restrict__ mask, W* __restrict__ out,
                     long long P, long long Rr, int rows, int m, long long pkw) {
  __shared__ int32_t s_idx[kMaxSrc];
  __shared__ uint8_t s_ok[kMaxSrc];
  const long long dev = blockIdx.z;
  const long long row = dev * rows + blockIdx.y;
  load_sources(idx, mask, row * m, m, s_idx, s_ok);
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= pkw) return;
  const W* base = chunks + dev * P * pkw + col;
  W acc = recv[(dev * Rr + rsel[row]) * pkw + col];
  for (int j = 0; j < m; ++j) {
    if (s_ok[j]) acc = xorw(acc, base[(long long)s_idx[j] * pkw]);
  }
  out[row * pkw + col] = acc;
}

dim3 grid_for(long long pkw, int rows, int K) {
  return dim3((unsigned)((pkw + kThreads - 1) / kThreads), (unsigned)rows, (unsigned)K);
}

}  // namespace

extern "C" {

// vec: 4, 2 or 1 u32 words per thread access. pk counts u32 words.
// Returns the cudaError_t of the launch (0 on success).
int xor_encode_gather(const void* chunks, const void* idx, const void* mask, void* out,
                      long long K, long long P, long long rows, long long m,
                      long long pk, int vec, void* stream) {
  if (m > kMaxSrc) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* ix = (const int32_t*)idx;
  const auto* mk = (const uint8_t*)mask;
  if (vec == 4) {
    encode_gather_kernel<uint4><<<grid_for(pk / 4, (int)rows, (int)K), kThreads, 0, s>>>(
        (const uint4*)chunks, ix, mk, (uint4*)out, P, (int)rows, (int)m, pk / 4);
  } else if (vec == 2) {
    encode_gather_kernel<uint2><<<grid_for(pk / 2, (int)rows, (int)K), kThreads, 0, s>>>(
        (const uint2*)chunks, ix, mk, (uint2*)out, P, (int)rows, (int)m, pk / 2);
  } else {
    encode_gather_kernel<uint32_t><<<grid_for(pk, (int)rows, (int)K), kThreads, 0, s>>>(
        (const uint32_t*)chunks, ix, mk, (uint32_t*)out, P, (int)rows, (int)m, pk);
  }
  return (int)cudaGetLastError();
}

int xor_decode_gather(const void* recv, const void* chunks, const void* rsel,
                      const void* idx, const void* mask, void* out, long long K,
                      long long P, long long Rr, long long rows, long long m,
                      long long pk, int vec, void* stream) {
  if (m > kMaxSrc) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* rs = (const int32_t*)rsel;
  const auto* ix = (const int32_t*)idx;
  const auto* mk = (const uint8_t*)mask;
  if (vec == 4) {
    decode_gather_kernel<uint4><<<grid_for(pk / 4, (int)rows, (int)K), kThreads, 0, s>>>(
        (const uint4*)recv, (const uint4*)chunks, rs, ix, mk, (uint4*)out, P, Rr,
        (int)rows, (int)m, pk / 4);
  } else if (vec == 2) {
    decode_gather_kernel<uint2><<<grid_for(pk / 2, (int)rows, (int)K), kThreads, 0, s>>>(
        (const uint2*)recv, (const uint2*)chunks, rs, ix, mk, (uint2*)out, P, Rr,
        (int)rows, (int)m, pk / 2);
  } else {
    decode_gather_kernel<uint32_t><<<grid_for(pk, (int)rows, (int)K), kThreads, 0, s>>>(
        (const uint32_t*)recv, (const uint32_t*)chunks, rs, ix, mk, (uint32_t*)out, P,
        Rr, (int)rows, (int)m, pk);
  }
  return (int)cudaGetLastError();
}

const char* camr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
