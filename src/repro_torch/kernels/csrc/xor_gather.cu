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
// The u32 lane. Grid (word-blocks of the row, rows, K). The Pallas
// kernels fetched sources through scalar-prefetched BlockSpec index maps
// with the source axis innermost; here each block loads its own m indices
// and mask bytes into shared memory and runs the loop over sources inside
// the block, so every output word is written once. A masked-off source
// skips its load (AND with 0 and skipping give the same bits), so invalid
// rows cost no traffic. One body, templated on the access word W that each
// thread moves per source: uint4 (16 B), uint2 (8 B) or u32; the wrapper
// picks the widest W that divides the row and to which every base pointer
// is aligned.
//
// The 16-bit lane (gather16_kernel). Its rows hold an odd number of 4-byte
// words at the training cell (37,095,084 bytes, 12 mod 16), so row p of a
// buffer starts at the 16-byte phase 12p mod 16 and no access wider than
// 4 bytes divides every row; with 4-byte accesses a thread keeps too few
// bytes in flight to fill the card's memory pipe. So the body is written
// for the phase: each thread owns 16-byte units of the OUTPUT row, counted
// from the row's first 16-byte boundary, and stores each with one 16-byte
// store. A source row's offset from the output row, modulo 16, is one
// value delta for the whole row (block-uniform: no divergence). For delta
// 0 a unit is one aligned 16-byte load; otherwise a thread loads the
// aligned 16 bytes under its unit, takes the next aligned 16 bytes from
// its neighbour lane (a shuffle; a lane whose neighbour has not loaded
// them, lane 31 or the row's last unit, loads them itself) and cuts its
// 16 bytes out of the 32 at delta (word selects, and a 16-bit funnel
// shift when delta is 2 mod 4). Each aligned vector that is loaded holds a
// byte of its row, so no load leaves the tensor's allocation. DRAM still
// reads each valid source row once. A thread issues the loads of kUnits
// units for up to kGroup valid sources (the block's valid sources,
// compacted into shared memory, recv first) before it combines any: 128
// bytes in flight a thread at 80 registers, three blocks an SM; the step's
// rows have at most two valid sources (recv counted), so one group. On an
// H100, groups of 4 (143 registers, one block an SM) ran 14-28% slower.
// A block covers kThreads * kUnits units (16 KB) of a row. The head (up to
// 14 bytes before the first boundary) and the tail (under 16 bytes) are
// XORed lane by lane by a few threads of the row's first block. Rows with
// no valid source store zeros. Two instantiations: every base pointer
// 4-byte aligned (delta in {0, 4, 8, 12}, the training step), or only
// 2-byte aligned (a tensor one lane off its buffer).
//
// Indices must be in range for every valid source; masked-off entries are
// never dereferenced.

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

// Launch with accesses of `bytes` (16, 8 or 4) over rows of row_bytes.
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
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- the packed 16-bit lane: a phase-aware body ---------------------------

constexpr int kUnits = 4;                    // 16-byte output units a thread
constexpr int kGroup = 2;                    // sources loaded before combining
constexpr int kTile = kThreads * kUnits;     // units a block

__device__ __forceinline__ uint4 ldg16(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint4 shfl16(uint4 v, int src_lane) {
  return make_uint4(__shfl_sync(0xffffffffu, v.x, src_lane),
                    __shfl_sync(0xffffffffu, v.y, src_lane),
                    __shfl_sync(0xffffffffu, v.z, src_lane),
                    __shfl_sync(0xffffffffu, v.w, src_lane));
}

// Bytes [delta, delta + 16) of the 32 bytes a (first) and b. kAlign = 4:
// delta is a multiple of 4 (word selects only); kAlign = 2: delta is even.
template <int kAlign>
__device__ __forceinline__ uint4 window(uint4 a, uint4 b, int delta) {
  uint32_t w0, w1, w2, w3, w4;
  switch (delta >> 2) {
    case 0: w0 = a.x; w1 = a.y; w2 = a.z; w3 = a.w; w4 = b.x; break;
    case 1: w0 = a.y; w1 = a.z; w2 = a.w; w3 = b.x; w4 = b.y; break;
    case 2: w0 = a.z; w1 = a.w; w2 = b.x; w3 = b.y; w4 = b.z; break;
    default: w0 = a.w; w1 = b.x; w2 = b.y; w3 = b.z; w4 = b.w; break;
  }
  if (kAlign == 4) return make_uint4(w0, w1, w2, w3);
  const int sh = (delta & 3) * 8;            // 0 or 16
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

// One block: kTile units of output row (blockIdx.z, blockIdx.y); recv is
// null for encode. Row starts are kAlign-byte aligned.
template <int kAlign>
__global__ void __launch_bounds__(kThreads)
gather16_kernel(const uint8_t* __restrict__ recv, const uint8_t* __restrict__ chunks,
                const int32_t* __restrict__ rsel, const int32_t* __restrict__ idx,
                const uint8_t* __restrict__ mask, uint8_t* __restrict__ out,
                long long P, long long Rr, int rows, int m, long long row_bytes) {
  __shared__ const uint8_t* s_src[kMaxSrc + 1];
  __shared__ int s_nv;
  const long long dev = blockIdx.z;
  const long long row = dev * rows + blockIdx.y;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {                    // compact the valid sources
    int nv = 0;
    if (recv != nullptr) {
      if (lane == 0) s_src[0] = recv + (dev * Rr + rsel[row]) * row_bytes;
      nv = 1;
    }
    const uint8_t* base = chunks + dev * P * row_bytes;
    for (int j0 = 0; j0 < m; j0 += 32) {
      const int j = j0 + lane;
      const bool ok = j < m && mask[row * m + j];
      const unsigned bal = __ballot_sync(0xffffffffu, ok);
      if (ok)
        s_src[nv + __popc(bal & ((1u << lane) - 1u))] =
            base + (long long)idx[row * m + j] * row_bytes;
      nv += __popc(bal);
    }
    if (lane == 0) s_nv = nv;
  }
  __syncthreads();
  const int nv = s_nv;
  uint8_t* orow = out + row * row_bytes;
  const long long head =
      min((long long)((16 - (reinterpret_cast<uintptr_t>(orow) & 15)) & 15), row_bytes);
  const long long nunits = (row_bytes - head) >> 4;

  // this thread's units u0 + 32k; kx: the one unit (if any) whose next
  // aligned vector no neighbour lane loads (lane 31's last, the row's last)
  const long long u0 =
      (long long)blockIdx.x * kTile + (threadIdx.x >> 5) * (32 * kUnits) + lane;
  int kx = -1;
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const long long u = u0 + 32 * k;
    if (u < nunits && (u + 1 == nunits || (lane == 31 && k == kUnits - 1))) kx = k;
  }
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 acc[kUnits];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) acc[k] = zero;

  for (int g = 0; g < nv; g += kGroup) {
    uint4 v[kGroup][kUnits], ex[kGroup];
    int delta[kGroup];
#pragma unroll
    for (int s = 0; s < kGroup; ++s) {       // every load before any XOR
      if (g + s >= nv) break;
      const uint8_t* src = s_src[g + s] + head;
      delta[s] = (int)((reinterpret_cast<uintptr_t>(src) -
                        reinterpret_cast<uintptr_t>(orow + head)) & 15);
      const uint8_t* a = src - delta[s];     // 16-byte aligned
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        const long long u = u0 + 32 * k;
        v[s][k] = u < nunits ? ldg16(a + 16 * u) : zero;
      }
      ex[s] = (delta[s] != 0 && kx >= 0) ? ldg16(a + 16 * (u0 + 32 * kx + 1)) : zero;
    }
#pragma unroll
    for (int s = 0; s < kGroup; ++s) {
      if (g + s >= nv) break;
      if (delta[s] == 0) {
#pragma unroll
        for (int k = 0; k < kUnits; ++k) acc[k] = xorw(acc[k], v[s][k]);
        continue;
      }
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        // lane L reads lane L+1's vector of unit k; lane 31 reads lane 0's
        // vector of unit k+1, which is the unit after its own
        const uint4 send = (lane == 0 && k + 1 < kUnits) ? v[s][k + 1] : v[s][k];
        uint4 next = shfl16(send, (lane + 1) & 31);
        if (k == kx) next = ex[s];
        acc[k] = xorw(acc[k], window<kAlign>(v[s][k], next, delta[s]));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const long long u = u0 + 32 * k;
    if (u < nunits) *reinterpret_cast<uint4*>(orow + head + 16 * u) = acc[k];
  }

  // head lanes (threads 0-6) and tail lanes (threads 8-14), one u16 each
  if (blockIdx.x == 0 && threadIdx.x < 16) {
    const long long b = threadIdx.x < 8 ? 2 * (long long)threadIdx.x
                                        : head + 16 * nunits + 2 * (threadIdx.x - 8);
    const bool mine = threadIdx.x < 8 ? b < head : b < row_bytes;
    if (mine) {
      uint16_t x = 0;
      for (int s = 0; s < nv; ++s)
        x ^= *reinterpret_cast<const uint16_t*>(s_src[s] + b);
      *reinterpret_cast<uint16_t*>(orow + b) = x;
    }
  }
}

template <int kAlign>
cudaError_t gather16_as(const void* recv, const void* chunks, const void* rsel,
                        const void* idx, const void* mask, void* out, long long K,
                        long long P, long long Rr, long long rows, long long m,
                        long long row_bytes, cudaStream_t s) {
  const long long tiles = (row_bytes / 16 + kTile - 1) / kTile;
  gather16_kernel<kAlign><<<dim3((unsigned)(tiles > 0 ? tiles : 1), (unsigned)rows,
                                 (unsigned)K),
                            kThreads, 0, s>>>(
      (const uint8_t*)recv, (const uint8_t*)chunks, (const int32_t*)rsel,
      (const int32_t*)idx, (const uint8_t*)mask, (uint8_t*)out, P, Rr, (int)rows,
      (int)m, row_bytes);
  return cudaGetLastError();
}

// The 16-bit lane over rows of `lanes` u16 lanes; vec 2: every base pointer
// 4-byte aligned, 1: 2-byte aligned. recv null for encode.
int gather16(int vec, const void* recv, const void* chunks, const void* rsel,
             const void* idx, const void* mask, void* out, long long K, long long P,
             long long Rr, long long rows, long long m, long long lanes, void* stream) {
  if (m > kMaxSrc || lanes % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (vec) {
    case 2:
      return (int)gather16_as<4>(recv, chunks, rsel, idx, mask, out, K, P, Rr, rows,
                                 m, 2 * lanes, s);
    case 1:
      return (int)gather16_as<2>(recv, chunks, rsel, idx, mask, out, K, P, Rr, rows,
                                 m, 2 * lanes, s);
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

// The packed 16-bit lane. lanes counts u16 lanes per row (even); vec: 2
// when every base pointer is 4-byte aligned, 1 when some is only 2-byte
// aligned (the lanes of the alignment every row start shares).
int xor_encode_gather16(const void* chunks, const void* idx, const void* mask, void* out,
                        long long K, long long P, long long rows, long long m,
                        long long lanes, int vec, void* stream) {
  return gather16(vec, nullptr, chunks, nullptr, idx, mask, out, K, P, 0, rows, m, lanes,
                  stream);
}

int xor_decode_gather16(const void* recv, const void* chunks, const void* rsel,
                        const void* idx, const void* mask, void* out, long long K,
                        long long P, long long Rr, long long rows, long long m,
                        long long lanes, int vec, void* stream) {
  return gather16(vec, recv, chunks, rsel, idx, mask, out, K, P, Rr, rows, m, lanes,
                  stream);
}

const char* camr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
