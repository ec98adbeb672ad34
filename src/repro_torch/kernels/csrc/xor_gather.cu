// Fused gather-XOR codec of the CAMR coded shuffle, for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   src/repro/kernels/xor_code.py::xor_encode_gather   (_encode_gather_kernel)
//   src/repro/kernels/xor_code.py::xor_decode_gather   (_decode_gather_kernel)
//   src/repro/kernels/xor_code.py::xor_encode_gather16 (the packed 16-bit lane)
//   src/repro/kernels/xor_code.py::xor_decode_gather16 (the packed 16-bit lane)
//
//   encode: out[v, i] = XOR_j { chunks[v, idx[v, i, j]] : mask[v, i, j] }
//   decode: out[v, i] = recv[v, rsel[v, i]]
//                       ^ XOR_j { chunks[v, idx[v, i, j]] : mask[v, i, j] }
//
// with a leading virtual-device axis v: chunks [K, P, row], idx
// i32[K, rows, m], mask bool[K, rows, m], recv [K, Rr, row], rsel
// i32[K, rows]. One launch covers all K virtual workers. A row is pk
// u32 words (xor_*_gather) or 2pk u16 lanes (xor_*_gather16, the bf16/f16
// payloads of the packed wire lane, two lanes per u32 wire word; the lane
// count must be even, as in the Pallas kernels).
//
// Bound: pure data movement with one XOR per word, so device memory
// bandwidth. The least traffic is each VALID source row read once, each
// recv row read once (decode) and each output row written once.
//
// Design. Grid (word-blocks of the row, rows, K). The Pallas kernels
// fetched sources through scalar-prefetched BlockSpec index maps with the
// source axis innermost; here each block loads its own m indices and mask
// bytes into shared memory and runs the loop over sources inside the
// block, so every output word is written once. A masked-off source skips
// its load (AND with 0 and skipping give the same bits), so invalid rows
// cost no traffic. XOR commutes with any split of a row into lanes, so
// both lane widths run one body, templated on the access word W that each
// thread moves per source: uint4 (16 B), uint2 (8 B), u32 or u16 (2 B, the
// 16-bit lane only). The wrapper picks the widest W that divides the row
// and to which every base pointer is aligned; rows of an odd number of
// 8-byte units (the smoke cell's bf16 rows) take 4-byte accesses.
// Indices must be in range for every valid source; masked-off entries are
// never dereferenced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSrc = 64;

__device__ __forceinline__ uint16_t xorw(uint16_t a, uint16_t b) {
  return (uint16_t)(a ^ b);
}
__device__ __forceinline__ uint32_t xorw(uint32_t a, uint32_t b) { return a ^ b; }
__device__ __forceinline__ uint2 xorw(uint2 a, uint2 b) {
  return make_uint2(a.x ^ b.x, a.y ^ b.y);
}
__device__ __forceinline__ uint4 xorw(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

template <typename W> __device__ __forceinline__ W zerow();
template <> __device__ __forceinline__ uint16_t zerow<uint16_t>() { return 0; }
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

dim3 grid_for(long long pkw, long long rows, long long K) {
  return dim3((unsigned)((pkw + kThreads - 1) / kThreads), (unsigned)rows, (unsigned)K);
}

template <typename W>
cudaError_t encode_as(const void* chunks, const int32_t* idx, const uint8_t* mask,
                      void* out, long long K, long long P, long long rows, long long m,
                      long long row_bytes, cudaStream_t s) {
  const long long pkw = row_bytes / (long long)sizeof(W);
  encode_gather_kernel<W><<<grid_for(pkw, rows, K), kThreads, 0, s>>>(
      (const W*)chunks, idx, mask, (W*)out, P, (int)rows, (int)m, pkw);
  return cudaGetLastError();
}

template <typename W>
cudaError_t decode_as(const void* recv, const void* chunks, const int32_t* rsel,
                      const int32_t* idx, const uint8_t* mask, void* out, long long K,
                      long long P, long long Rr, long long rows, long long m,
                      long long row_bytes, cudaStream_t s) {
  const long long pkw = row_bytes / (long long)sizeof(W);
  decode_gather_kernel<W><<<grid_for(pkw, rows, K), kThreads, 0, s>>>(
      (const W*)recv, (const W*)chunks, rsel, idx, mask, (W*)out, P, Rr, (int)rows,
      (int)m, pkw);
  return cudaGetLastError();
}

// Launch with accesses of `bytes` (16, 8, 4 or 2) over rows of row_bytes.
int encode_any(int bytes, const void* chunks, const void* idx, const void* mask,
               void* out, long long K, long long P, long long rows, long long m,
               long long row_bytes, void* stream) {
  if (m > kMaxSrc || row_bytes % bytes) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* ix = (const int32_t*)idx;
  const auto* mk = (const uint8_t*)mask;
  switch (bytes) {
    case 16: return (int)encode_as<uint4>(chunks, ix, mk, out, K, P, rows, m, row_bytes, s);
    case 8: return (int)encode_as<uint2>(chunks, ix, mk, out, K, P, rows, m, row_bytes, s);
    case 4: return (int)encode_as<uint32_t>(chunks, ix, mk, out, K, P, rows, m, row_bytes, s);
    case 2: return (int)encode_as<uint16_t>(chunks, ix, mk, out, K, P, rows, m, row_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int decode_any(int bytes, const void* recv, const void* chunks, const void* rsel,
               const void* idx, const void* mask, void* out, long long K, long long P,
               long long Rr, long long rows, long long m, long long row_bytes,
               void* stream) {
  if (m > kMaxSrc || row_bytes % bytes) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* rs = (const int32_t*)rsel;
  const auto* ix = (const int32_t*)idx;
  const auto* mk = (const uint8_t*)mask;
  switch (bytes) {
    case 16:
      return (int)decode_as<uint4>(recv, chunks, rs, ix, mk, out, K, P, Rr, rows, m,
                                   row_bytes, s);
    case 8:
      return (int)decode_as<uint2>(recv, chunks, rs, ix, mk, out, K, P, Rr, rows, m,
                                   row_bytes, s);
    case 4:
      return (int)decode_as<uint32_t>(recv, chunks, rs, ix, mk, out, K, P, Rr, rows, m,
                                      row_bytes, s);
    case 2:
      return (int)decode_as<uint16_t>(recv, chunks, rs, ix, mk, out, K, P, Rr, rows, m,
                                      row_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The u32 word lane. vec: 4, 2 or 1 u32 words per thread access; pk
// counts u32 words. Returns the cudaError_t of the launch (0 on success).
int xor_encode_gather(const void* chunks, const void* idx, const void* mask, void* out,
                      long long K, long long P, long long rows, long long m,
                      long long pk, int vec, void* stream) {
  if (vec != 4 && vec != 2 && vec != 1) return (int)cudaErrorInvalidValue;
  return encode_any(4 * vec, chunks, idx, mask, out, K, P, rows, m, 4 * pk, stream);
}

int xor_decode_gather(const void* recv, const void* chunks, const void* rsel,
                      const void* idx, const void* mask, void* out, long long K,
                      long long P, long long Rr, long long rows, long long m,
                      long long pk, int vec, void* stream) {
  if (vec != 4 && vec != 2 && vec != 1) return (int)cudaErrorInvalidValue;
  return decode_any(4 * vec, recv, chunks, rsel, idx, mask, out, K, P, Rr, rows, m,
                    4 * pk, stream);
}

// The packed 16-bit lane. lanes counts u16 lanes per row (even); vec: 8,
// 4, 2 or 1 lanes per thread access.
int xor_encode_gather16(const void* chunks, const void* idx, const void* mask, void* out,
                        long long K, long long P, long long rows, long long m,
                        long long lanes, int vec, void* stream) {
  if (lanes % 2 || (vec != 8 && vec != 4 && vec != 2 && vec != 1))
    return (int)cudaErrorInvalidValue;
  return encode_any(2 * vec, chunks, idx, mask, out, K, P, rows, m, 2 * lanes, stream);
}

int xor_decode_gather16(const void* recv, const void* chunks, const void* rsel,
                        const void* idx, const void* mask, void* out, long long K,
                        long long P, long long Rr, long long rows, long long m,
                        long long lanes, int vec, void* stream) {
  if (lanes % 2 || (vec != 8 && vec != 4 && vec != 2 && vec != 1))
    return (int)cudaErrorInvalidValue;
  return decode_any(2 * vec, recv, chunks, rsel, idx, mask, out, K, P, Rr, rows, m,
                    2 * lanes, stream);
}

const char* camr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
