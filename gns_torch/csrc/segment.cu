// K1 (segment-sum) and K2 (row gather) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of gns_tpu/ops/pallas_segment.py:
//   K1  _seg_sum_kernel (:29), reached through pallas_segment_sum (:83);
//   K2  _gather_kernel  (:45), reached through pallas_gather (:100).
// The TPU kernels built a one-hot (N, E) incidence in VMEM and let the MXU
// contract it. Here the graph is read as a CSR by destination instead, which
// needs no matrix and no atomics.
//
// Built by gns_torch/ops/segment_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes. Each
// entry point launches on the stream it is given, allocates nothing and
// returns cudaGetLastError(); the Python wrapper checks shapes, types,
// devices and contiguity before it calls, and raises on a non-zero return.
//
// What bounds them on an H100 (3.35 TB/s HBM, 50 MB L2): both are
// memory-bound. K1 does one add per input element (S*E*D adds against
// S*E*D + S*N*D elements moved), K2 none; at case300, S=1024, D=60 f32, K1
// reads 101 MB and writes 74 MB, about 52 us at the HBM rate, and K2 for
// m[dst] at D=20 moves about 58 MB, about 17 us. What the design does:
//   K1: one thread per output element (s, n, d), neighbouring threads on
//       neighbouring d, then n, so the output store is coalesced and the D
//       threads of one (s, n) read one contiguous edge row together. Each
//       thread walks its bus's edge list (order[indptr[n]:indptr[n+1]]) in
//       edge order and accumulates in f32, so the result is deterministic
//       and equal, add for add, to a sequential scatter (index_add_ on the
//       CPU). Ids outside [0, N) were left out of the CSR by the host.
//   K2: a copy of rows. Each thread moves one 16-, 8-, 4- or 2-byte word of
//       an output row (the widest that divides the row), neighbouring
//       threads on neighbouring words, then rows, so loads and stores are
//       coalesced and every load is as wide as the row allows.
// Neither stages data in shared memory: each input row is read by the few
// threads of one output row, so there is no reuse for shared memory to
// capture, and the edge lists of a case (max in-degree < 10) are short.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;  // grid-stride beyond this

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// out[s, n, d] = sum over j in [indptr[n], indptr[n+1]) of data[s, order[j], d]
template <typename T>
__global__ void segment_sum_csr(const T* __restrict__ data,
                                const int* __restrict__ order,
                                const int* __restrict__ indptr,
                                float* __restrict__ out,
                                long long S, long long E, long long N, long long D) {
  const long long total = S * N * D;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const long long d = i % D;
    const long long sn = i / D;
    const long long n = sn % N;
    const long long s = sn / N;
    const T* col = data + s * E * D + d;
    const int lo = indptr[n];
    const int hi = indptr[n + 1];
    float acc = 0.0f;
    for (int j = lo; j < hi; ++j) {
      acc += to_f32(col[(long long)order[j] * D]);
    }
    out[i] = acc;
  }
}

// out[s, e, w] = data[s, ids[e], w] over rows of W words of type V.
template <typename V>
__global__ void gather_rows(const V* __restrict__ data,
                            const int* __restrict__ ids,
                            V* __restrict__ out,
                            long long S, long long R, long long E, long long W) {
  const long long total = S * E * W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const long long w = i % W;
    const long long se = i / W;
    const long long e = se % E;
    const long long s = se / E;
    out[i] = data[(s * R + ids[e]) * W + w];
  }
}

inline unsigned int blocks_for(long long total) {
  long long b = (total + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return (unsigned int)(b < 1 ? 1 : b);
}

template <typename V>
int launch_gather(const void* data, const int* ids, void* out,
                  long long S, long long R, long long E, long long row_bytes,
                  cudaStream_t stream) {
  const long long W = row_bytes / (long long)sizeof(V);
  const long long total = S * E * W;
  gather_rows<V><<<blocks_for(total), kThreads, 0, stream>>>(
      static_cast<const V*>(data), ids, static_cast<V*>(out), S, R, E, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1. dtype: 0 = float32 data, 1 = bfloat16 data; out is float32 (S, N, D).
// order (n_kept,) and indptr (N + 1,) are the CSR of the segment ids.
int gns_segment_sum(const void* data, int dtype, const int* order, const int* indptr,
                    float* out, long long S, long long E, long long N, long long D,
                    void* stream) {
  const long long total = S * N * D;
  if (total == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    segment_sum_csr<float><<<blocks_for(total), kThreads, 0, st>>>(
        static_cast<const float*>(data), order, indptr, out, S, E, N, D);
  } else if (dtype == 1) {
    segment_sum_csr<__nv_bfloat16><<<blocks_for(total), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(data), order, indptr, out, S, E, N, D);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K2. data (S, R, row_bytes) -> out (S, E, row_bytes), rows picked by
// ids (E,) in [0, R). row_bytes must be a multiple of 2 and both pointers
// aligned to the word width this picks (the wrapper checks).
int gns_gather(const void* data, const int* ids, void* out,
               long long S, long long R, long long E, long long row_bytes,
               void* stream) {
  if (S * E * row_bytes == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(data) | reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && align % 16 == 0)
    return launch_gather<uint4>(data, ids, out, S, R, E, row_bytes, st);
  if (row_bytes % 8 == 0 && align % 8 == 0)
    return launch_gather<uint2>(data, ids, out, S, R, E, row_bytes, st);
  if (row_bytes % 4 == 0 && align % 4 == 0)
    return launch_gather<unsigned int>(data, ids, out, S, R, E, row_bytes, st);
  if (row_bytes % 2 == 0 && align % 2 == 0)
    return launch_gather<unsigned short>(data, ids, out, S, R, E, row_bytes, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
