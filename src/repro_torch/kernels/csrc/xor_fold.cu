// Dense XOR fold and decode of the multipass codec, for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   src/repro/kernels/xor_code.py::xor_fold    (_fold_kernel)
//   src/repro/kernels/xor_code.py::xor_decode  (_decode_kernel)
//   src/repro/kernels/xor_code.py::xor_encode  (_xor_kernel)
//
//   fold:   out[r] = XOR_i packets[r, i]
//   decode: out[r] = recv[r] ^ XOR_i { packets[r, i] : mask[r, i] }
//
// over u32 wire words: packets [R, m, n], recv and out [R, n], mask
// bool[R, m]. These are the multipass codec's building blocks: the caller
// has already gathered each row's packets into one dense table, so the
// addressing is strided and no index table is read (row r, source i at
// packets + (r*m + i)*n). The encode, packets [m, n] -> [n], is the fold
// with R = 1: its wrapper calls xor_fold.
//
// Bound: pure data movement with one XOR per word, so device memory
// bandwidth. The least traffic is every packet row read once (the fold;
// for the decode only the rows its mask selects), recv read once and each
// output row written once.
//
// Design. Grid (word-blocks of a row, rows). Each thread owns one access
// word of one output row and loops over the m sources, so every output
// word is written once and no partial sum leaves registers (the Pallas
// kernels held a (1, m, block) tile in VMEM; here the loop over sources
// takes its place). The decode skips the load of a masked-off packet
// (AND with 0 and skipping give the same bits), so it reads nothing it
// does not XOR. XOR commutes with any split of a row into words, so one
// body serves every access width W (uint4, uint2 or u32): the wrapper
// picks the widest W that divides the row and to which every base pointer
// is aligned (8 bytes at the smoke cell's f32 rows of 18,547,542 words,
// 4 bytes at its bf16-lane rows of 9,273,771 words).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSrc = 64;
constexpr long long kMaxRows = 65535;  // gridDim.y

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

// recv == nullptr: a fold from zero; mask == nullptr: every source counts.
template <typename W>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const W* __restrict__ packets, const W* __restrict__ recv,
            const uint8_t* __restrict__ mask, W* __restrict__ out, int m, long long nw) {
  __shared__ uint8_t s_ok[kMaxSrc];
  const long long row = blockIdx.y;
  for (int i = threadIdx.x; i < m; i += blockDim.x)
    s_ok[i] = mask == nullptr ? 1 : mask[row * m + i];
  __syncthreads();
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= nw) return;
  const W* base = packets + row * m * nw + col;
  W acc = recv == nullptr ? zerow<W>() : recv[row * nw + col];
  for (int i = 0; i < m; ++i) {
    if (s_ok[i]) acc = xorw(acc, base[i * nw]);
  }
  out[row * nw + col] = acc;
}

template <typename W>
cudaError_t fold_as(const void* packets, const void* recv, const uint8_t* mask, void* out,
                    long long rows, long long m, long long n_words, cudaStream_t s) {
  const long long nw = n_words * 4 / (long long)sizeof(W);
  const dim3 grid((unsigned)((nw + kThreads - 1) / kThreads), (unsigned)rows);
  fold_kernel<W><<<grid, kThreads, 0, s>>>((const W*)packets, (const W*)recv, mask,
                                           (W*)out, (int)m, nw);
  return cudaGetLastError();
}

// vec: u32 words per thread access (4, 2 or 1); n counts u32 words.
int fold_any(const void* packets, const void* recv, const void* mask, void* out,
             long long rows, long long m, long long n, int vec, void* stream) {
  if (m < 1 || m > kMaxSrc || rows < 1 || rows > kMaxRows || n < 1 || n % vec)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* mk = (const uint8_t*)mask;
  switch (vec) {
    case 4: return (int)fold_as<uint4>(packets, recv, mk, out, rows, m, n, s);
    case 2: return (int)fold_as<uint2>(packets, recv, mk, out, rows, m, n, s);
    case 1: return (int)fold_as<uint32_t>(packets, recv, mk, out, rows, m, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// packets [R, m, n] -> out [R, n]. Returns the cudaError_t of the launch.
int xor_fold(const void* packets, void* out, long long R, long long m, long long n,
             int vec, void* stream) {
  return fold_any(packets, nullptr, nullptr, out, R, m, n, vec, stream);
}

// recv [R, n], packets [R, m, n], mask bool[R, m] -> out [R, n].
int xor_decode(const void* recv, const void* packets, const void* mask, void* out,
               long long R, long long m, long long n, int vec, void* stream) {
  return fold_any(packets, recv, mask, out, R, m, n, vec, stream);
}

const char* camr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
