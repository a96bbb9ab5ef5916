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
//   K1: each segment is summed in f32 in edge order (order[indptr[n]] ..
//       order[indptr[n+1] - 1]) with no atomics, so the result is
//       deterministic and equal, add for add, to a sequential scatter
//       (index_add_ on the CPU). Ids outside [0, N) were left out of the
//       CSR by the host. Samples run on blockIdx.y (a stride loop past
//       65535); all index arithmetic inside a sample is 32-bit (the host
//       refuses E*D or N*D of 2^31 or more), with no div / mod per element.
//       Wide rows (D > 4; the phi aggregate, D=60 f32 and D=30 bf16): one
//       warp per bus and group of samples. indptr[n] and each order[j] are
//       warp-uniform, so every lane runs the same trip count; a sample's
//       row takes the widest words the row and its alignment allow (float4
//       for a 240-byte f32 row, 4 bytes for a 60-byte bf16 row) on a
//       power-of-two share of the lanes (16 for those 15-word rows, so two
//       samples fill a warp); four edge rows are loaded before they are
//       added, in order, and the output row is stored in the same words.
//       Narrow rows (D <= 4; generator init D=4, physics pairs D=2, pg and
//       in-degree D=1): one thread per (sample, bus) holds the whole row in
//       registers, loaded as one float4 / float2 where aligned.
//       K1 stages nothing in shared memory: each input row is read by the
//       few threads of one output row, so there is no reuse to capture, and
//       the edge lists of a case (max in-degree < 10) are short.
//   K2: a copy of rows, bit for bit. Samples run on blockIdx.y (a stride
//       loop past 65535), all index math inside a sample is 32-bit, and the
//       variant is picked by the row's size and the pointers' alignment
//       (gather_plan, mirrored by ops/segment_kernels.py gather_plan):
//       Narrow rows (2 to 16 bytes, but not one aligned 8- or 16-byte
//       word: D=1 and D=3 f32, D <= 8 bf16 but D=4 and D=8; the pg and Q2
//       delta gathers, bf16 (v, theta)): a row is too small to keep a
//       thread busy, so each thread writes one aligned 16-byte chunk of
//       the sample's output (several consecutive edges;
//       the sample's first and last chunk, which it may share with the
//       neighbouring sample, unit by unit), so stores are 16-byte and
//       coalesced. Units are 4 bytes where the row and pointers allow,
//       else 2; the units per row are a template constant, so finding a
//       unit's edge is a multiply and a shift. An id is loaded once per
//       chunk it reaches. The source table is read in place: a sample's
//       table (1.2 to 1.6 KB on the serving path) stays in L1 / L2 while the block
//       reads it, and copying it into shared memory first (as the TPU
//       kernel kept the whole (1, N, D) block in VMEM) was slower or no
//       faster on the card at the serving path's shapes (PERF.md).
//       Word rows (one aligned 8- or 16-byte word: D=2 and D=4 f32, D=4
//       and D=8 bf16) and wide rows (> 16 bytes: m[dst] at D=20 f32): one
//       block per tile of edges of a sample stages the tile's ids in
//       shared memory once, and its threads copy the tile's words (16-byte
//       where the row and pointers allow) in order, neighbouring threads
//       on neighbouring words, rows back to back; the row of a word is a
//       32-bit multiply-high by a host-made reciprocal, exact for the
//       tile's word count. For a row of one word the copy is a thread per
//       row, which on the card beat 16-byte chunks of two 8-byte rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kNarrowGatherThreads = 256;    // K2, rows of 2-16 bytes but one 8- or 16-byte word
constexpr int kChunksPerThread = 2;          // K2, narrow: 16-byte chunks per thread and block pass
constexpr int kWideThreads = 256;            // K2, rows of whole 8- or 16-byte words, or > 16 bytes
constexpr int kWideWordsPerThread = 4;       // K2, wide: words per thread in a tile
constexpr int kMaxTileEdges = 1024;          // K2, wide: ids staged per block
constexpr int kWarpsPerBlock = 8;            // K1, wide rows: buses per block
constexpr int kNarrowThreads = 128;          // K1, narrow rows: buses per block
constexpr long long kMaxGridY = 65535;       // K1: samples per launch row, then a stride loop

// VEC elements of a row at p (aligned to VEC elements) as floats.
template <typename T, int VEC>
__device__ __forceinline__ void load_words(const T* __restrict__ p, float* v) {
  if constexpr (std::is_same_v<T, float>) {
    if constexpr (VEC == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else if constexpr (VEC == 2) {
      const float2 q = *reinterpret_cast<const float2*>(p);
      v[0] = q.x; v[1] = q.y;
    } else {
      v[0] = *p;
    }
  } else {
    if constexpr (VEC == 4) {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
      const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
      v[0] = __low2float(a); v[1] = __high2float(a); v[2] = __low2float(b); v[3] = __high2float(b);
    } else if constexpr (VEC == 2) {
      const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(p);
      v[0] = __low2float(a); v[1] = __high2float(a);
    } else {
      v[0] = __bfloat162float(*p);
    }
  }
}

template <int VEC>
__device__ __forceinline__ void store_words(float* __restrict__ p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// Wide rows: out[s, n, :] = sum over j in [indptr[n], indptr[n+1]) of
// data[s, order[j], :]. One warp per bus n and group of 32 >> plog samples:
// each sample's row gets 1 << plog lanes (the row's VEC-element words
// rounded up to a power of two, at most 32), so a 15-word row shares the
// warp with the next sample's instead of idling 17 lanes. The edge list is
// the same for every lane, so all run the same trip count.
template <typename T, int VEC>
__global__ void segment_sum_warp(const T* __restrict__ data, const int* __restrict__ order,
                                 const int* __restrict__ indptr, float* __restrict__ out,
                                 int S, int E, int N, int D, int plog) {
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= N) return;
  const int lane = threadIdx.x & 31;
  const int lo = indptr[n], hi = indptr[n + 1];  // warp-uniform
  const int words = D / VEC, per = 32 >> plog;
  for (int s = blockIdx.y * per + (lane >> plog); s < S; s += gridDim.y * per) {
    const T* x = data + (long long)s * E * D;
    float* o = out + ((long long)s * N + n) * D;
    for (int w = lane & ((1 << plog) - 1); w < words; w += 1 << plog) {
      const int c = w * VEC;
      float acc[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = 0.0f;
      int j = lo;
      for (; j + 4 <= hi; j += 4) {  // four rows in flight, added in edge order
        float v[4][VEC];
#pragma unroll
        for (int r = 0; r < 4; ++r) load_words<T, VEC>(x + order[j + r] * D + c, v[r]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < VEC; ++q) acc[q] += v[r][q];
      }
      float v[3][VEC];  // the last 0-3 rows, all loaded before any is added
#pragma unroll
      for (int r = 0; r < 3; ++r)
        if (j + r < hi) load_words<T, VEC>(x + order[j + r] * D + c, v[r]);
#pragma unroll
      for (int r = 0; r < 3; ++r)
        if (j + r < hi)
#pragma unroll
          for (int q = 0; q < VEC; ++q) acc[q] += v[r][q];
      store_words<VEC>(o + c, acc);
    }
  }
}

// Narrow rows (D <= 4): one thread per (s, n) holds the whole row.
template <typename T, int D, int VEC>
__global__ void segment_sum_narrow(const T* __restrict__ data, const int* __restrict__ order,
                                   const int* __restrict__ indptr, float* __restrict__ out,
                                   int S, int E, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int lo = indptr[n], hi = indptr[n + 1];
  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    const T* x = data + (long long)s * E * D;
    float acc[D];
#pragma unroll
    for (int q = 0; q < D; ++q) acc[q] = 0.0f;
    int j = lo;
    for (; j + 2 <= hi; j += 2) {  // two rows in flight, added in edge order
      float v[2][D];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int q = 0; q < D; q += VEC) load_words<T, VEC>(x + order[j + r] * D + q, v[r] + q);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int q = 0; q < D; ++q) acc[q] += v[r][q];
    }
    if (j < hi) {
      float v[D];
#pragma unroll
      for (int q = 0; q < D; q += VEC) load_words<T, VEC>(x + order[j] * D + q, v + q);
#pragma unroll
      for (int q = 0; q < D; ++q) acc[q] += v[q];
    }
    float* o = out + ((long long)s * N + n) * D;
#pragma unroll
    for (int q = 0; q < D; q += VEC) store_words<VEC>(o + q, acc + q);
  }
}

// C units of type U (16 bytes) stored as one 16-byte word.
template <typename U>
__device__ __forceinline__ void store_chunk(U* p, const U* v) {
  if constexpr (sizeof(U) == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = (uint32_t)v[2 * q] | ((uint32_t)v[2 * q + 1] << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// K2, rows of W units of type U, W * sizeof(U) <= 16: out[s, e, :] =
// data[s, ids[e], :]. A sample's output is cut into the 16-byte chunks of
// its address range; chunk k covers its units [k C - head, k C - head + C).
// Block (x, y) writes chunks [x per, (x + 1) per) of samples y, y + gridDim.y, ...
template <typename U, int W>
__global__ void __launch_bounds__(kNarrowGatherThreads) gns_gather_narrow(
    const U* __restrict__ data, const int* __restrict__ ids, U* __restrict__ out,
    int S, int R, int E, int per) {
  constexpr int C = 16 / sizeof(U);
  const int units = E * W;
  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    const U* tab = data + (long long)s * R * W;
    U* dst = out + (long long)s * units;
    const int head = (int)((reinterpret_cast<uintptr_t>(dst) & 15) / sizeof(U));
    const int chunks = (head + units + C - 1) / C;
    const int k1 = min(chunks, (int)(blockIdx.x + 1) * per);
    for (int k = blockIdx.x * per + threadIdx.x; k < k1; k += blockDim.x) {
      const int h0 = k * C - head;
      if (h0 >= 0 && h0 + C <= units) {
        U v[C];
        int last = -1, id = 0;
#pragma unroll
        for (int q = 0; q < C; ++q) {
          const int e = (h0 + q) / W;  // W is a constant: a multiply and a shift
          if (e != last) { id = __ldg(ids + e); last = e; }
          v[q] = tab[id * W + (h0 + q - e * W)];
        }
        store_chunk<U>(dst + h0, v);
      } else {  // the sample's first or last chunk: only its own units
        for (int q = 0; q < C; ++q) {
          const int h = h0 + q;
          if (h < 0 || h >= units) continue;
          const int e = h / W;
          dst[h] = tab[__ldg(ids + e) * W + (h - e * W)];
        }
      }
    }
  }
}

// K2, rows of W words of type V (one aligned 8- or 16-byte word, or rows
// over 16 bytes): block (x, y) copies edges [x tile, x tile + tile) of
// samples y, y + gridDim.y, ...; the tile's ids are staged once. Word f of
// the tile is word f - r W of its row r = f / W: f itself for W = 1, else
// umulhi(f, magic), exact while tile * W * W < 2^32 (host).
template <typename V>
__global__ void __launch_bounds__(kWideThreads) gns_gather_wide(
    const V* __restrict__ data, const int* __restrict__ ids, V* __restrict__ out,
    int S, int R, int E, int W, int tile, unsigned int magic) {
  __shared__ int sid[kMaxTileEdges];
  const int e0 = blockIdx.x * tile;
  const int n = min(tile, E - e0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) sid[i] = ids[e0 + i];
  __syncthreads();
  const int words = n * W;
  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    const V* src = data + (long long)s * R * W;
    V* dst = out + ((long long)s * E + e0) * W;
#pragma unroll 4
    for (int f = threadIdx.x; f < words; f += blockDim.x) {
      const int r = W == 1 ? f : (int)__umulhi((unsigned int)f, magic);
      dst[f] = src[sid[r] * W + (f - r * W)];
    }
  }
}

// K2's launch plan, a pure function of the shape and the two addresses;
// ops/segment_kernels.py gather_plan mirrors it and chip_smoke.py checks the
// two agree. variant 0: narrow; 1: word / wide.
struct GatherPlan {
  int variant, unit, units_per_row, grid_x, grid_y, per;
  unsigned int magic;
};

GatherPlan gather_plan(long long S, long long E, long long row_bytes, uintptr_t data,
                       uintptr_t out) {
  GatherPlan p{};
  const uintptr_t align = data | out;
  p.grid_y = (int)(S < kMaxGridY ? S : kMaxGridY);
  if (row_bytes <= 16 && !((row_bytes == 8 || row_bytes == 16) && align % row_bytes == 0)) {
    p.unit = (row_bytes % 4 == 0 && align % 4 == 0) ? 4 : 2;
    p.units_per_row = (int)(row_bytes / p.unit);
    const long long c = 16 / p.unit, units = E * p.units_per_row;
    const long long chunks = (units + c - 1) / c + 1;  // most a sample's range can touch
    p.per = kNarrowGatherThreads * kChunksPerThread;
    p.grid_x = (int)((chunks + p.per - 1) / p.per);
    return p;
  }
  p.variant = 1;
  p.unit = (row_bytes % 16 == 0 && align % 16 == 0) ? 16
         : (row_bytes % 8 == 0 && align % 8 == 0) ? 8
         : (row_bytes % 4 == 0 && align % 4 == 0) ? 4 : 2;
  p.units_per_row = (int)(row_bytes / p.unit);
  long long most = (long long)kWideThreads * kWideWordsPerThread / p.units_per_row;
  most = most < 1 ? 1 : (most > kMaxTileEdges ? kMaxTileEdges : most);
  const long long tiles = (E + most - 1) / most;
  p.per = (int)((E + tiles - 1) / tiles);  // balanced tiles
  p.grid_x = (int)((E + p.per - 1) / p.per);
  p.magic = p.units_per_row == 1 ? 0u
                                 : (unsigned int)((1ULL << 32) / (unsigned long long)p.units_per_row + 1);
  return p;
}

// The narrow kernel for the plan's units per row W (1 .. 16 / sizeof(U)).
template <typename U, int W = 1>
int launch_narrow_gather(const GatherPlan& p, const void* data, const int* ids, void* out,
                         int S, int R, int E, cudaStream_t st) {
  if constexpr (W * sizeof(U) > 16) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (p.units_per_row != W)
      return launch_narrow_gather<U, W + 1>(p, data, ids, out, S, R, E, st);
    gns_gather_narrow<U, W><<<dim3(p.grid_x, p.grid_y), kNarrowGatherThreads, 0, st>>>(
        static_cast<const U*>(data), ids, static_cast<U*>(out), S, R, E, p.per);
    return (int)cudaGetLastError();
  }
}

template <typename V>
int launch_wide_gather(const GatherPlan& p, const void* data, const int* ids, void* out,
                       int S, int R, int E, cudaStream_t st) {
  gns_gather_wide<V><<<dim3(p.grid_x, p.grid_y), kWideThreads, 0, st>>>(
      static_cast<const V*>(data), ids, static_cast<V*>(out), S, R, E, p.units_per_row, p.per,
      p.magic);
  return (int)cudaGetLastError();
}

// Words of VEC elements fit a row of D when D is a multiple of VEC and
// both base pointers are aligned to a word (then every row start is too).
template <typename T>
bool fits(int vec, long long D, const void* data, const float* out) {
  return D % vec == 0 && reinterpret_cast<uintptr_t>(data) % (vec * sizeof(T)) == 0 &&
         reinterpret_cast<uintptr_t>(out) % (vec * sizeof(float)) == 0;
}

template <typename T, int D>
void launch_narrow(const T* data, const int* order, const int* indptr, float* out, int S, int E,
                   int N, dim3 grid, cudaStream_t st) {
  if constexpr (D % 4 == 0) {
    if (fits<T>(4, D, data, out)) {
      segment_sum_narrow<T, D, 4><<<grid, kNarrowThreads, 0, st>>>(data, order, indptr, out, S, E, N);
      return;
    }
  }
  if constexpr (D % 2 == 0) {
    if (fits<T>(2, D, data, out)) {
      segment_sum_narrow<T, D, 2><<<grid, kNarrowThreads, 0, st>>>(data, order, indptr, out, S, E, N);
      return;
    }
  }
  segment_sum_narrow<T, D, 1><<<grid, kNarrowThreads, 0, st>>>(data, order, indptr, out, S, E, N);
}

template <typename T>
int launch_sum(const T* data, const int* order, const int* indptr, float* out, long long S,
               long long E, long long N, long long D, cudaStream_t st) {
  const int s = (int)S, e = (int)E, n = (int)N, d = (int)D;
  if (D <= 4) {
    const dim3 grid((unsigned int)((N + kNarrowThreads - 1) / kNarrowThreads),
                    (unsigned int)(S < kMaxGridY ? S : kMaxGridY));
    switch (d) {
      case 1: launch_narrow<T, 1>(data, order, indptr, out, s, e, n, grid, st); break;
      case 2: launch_narrow<T, 2>(data, order, indptr, out, s, e, n, grid, st); break;
      case 3: launch_narrow<T, 3>(data, order, indptr, out, s, e, n, grid, st); break;
      default: launch_narrow<T, 4>(data, order, indptr, out, s, e, n, grid, st); break;
    }
    return (int)cudaGetLastError();
  }
  const int vec = fits<T>(4, D, data, out) ? 4 : (fits<T>(2, D, data, out) ? 2 : 1);
  int plog = 0;  // lanes per sample: the row's words rounded up to a power of two, <= 32
  while ((1 << plog) < 32 && (1 << plog) < d / vec) ++plog;
  const long long groups = (S + (32 >> plog) - 1) >> (5 - plog);
  const dim3 grid((unsigned int)((N + kWarpsPerBlock - 1) / kWarpsPerBlock),
                  (unsigned int)(groups < kMaxGridY ? groups : kMaxGridY));
  const int threads = kWarpsPerBlock * 32;
  if (vec == 4)
    segment_sum_warp<T, 4><<<grid, threads, 0, st>>>(data, order, indptr, out, s, e, n, d, plog);
  else if (vec == 2)
    segment_sum_warp<T, 2><<<grid, threads, 0, st>>>(data, order, indptr, out, s, e, n, d, plog);
  else
    segment_sum_warp<T, 1><<<grid, threads, 0, st>>>(data, order, indptr, out, s, e, n, d, plog);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1. dtype: 0 = float32 data, 1 = bfloat16 data; out is float32 (S, N, D).
// order (n_kept,) and indptr (N + 1,) are the CSR of the segment ids.
int gns_segment_sum(const void* data, int dtype, const int* order, const int* indptr,
                    float* out, long long S, long long E, long long N, long long D,
                    void* stream) {
  if (S * N * D == 0) return 0;
  if (E * D >= (1LL << 31) || N * D >= (1LL << 31) || S >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_sum(static_cast<const float*>(data), order, indptr, out, S, E, N, D, st);
  if (dtype == 1)
    return launch_sum(static_cast<const __nv_bfloat16*>(data), order, indptr, out, S, E, N, D, st);
  return (int)cudaErrorInvalidValue;
}

// K2's launch plan for these arguments, as the 7 ints variant, unit bytes,
// units per row, grid x, grid y, per (chunks per block, or edges per
// tile), magic (as a signed int). Returns 0.
int gns_gather_plan(long long S, long long E, long long row_bytes, const void* data,
                    const void* out, int* plan) {
  const GatherPlan p = gather_plan(S, E, row_bytes, reinterpret_cast<uintptr_t>(data),
                                   reinterpret_cast<uintptr_t>(out));
  const int v[7] = {p.variant, p.unit, p.units_per_row, p.grid_x, p.grid_y, p.per, (int)p.magic};
  for (int i = 0; i < 7; ++i) plan[i] = v[i];
  return 0;
}

// K2. data (S, R, row_bytes) -> out (S, E, row_bytes), rows picked by
// ids (E,) in [0, R). row_bytes must be a multiple of 2 and both pointers
// 2-byte aligned; R * row_bytes and E * row_bytes under 2^31 (the wrapper
// checks).
int gns_gather(const void* data, const int* ids, void* out,
               long long S, long long R, long long E, long long row_bytes,
               void* stream) {
  if (S * E * row_bytes == 0) return 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(data) | reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 2 != 0 || align % 2 != 0 || R * row_bytes >= (1LL << 31) ||
      E * row_bytes >= (1LL << 31) || row_bytes >= (1LL << 16) || S >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const GatherPlan p = gather_plan(S, E, row_bytes, reinterpret_cast<uintptr_t>(data),
                                   reinterpret_cast<uintptr_t>(out));
  const int s = (int)S, r = (int)R, e = (int)E;
  switch (p.variant * 32 + p.unit) {
    case 0 * 32 + 4: return launch_narrow_gather<uint32_t>(p, data, ids, out, s, r, e, st);
    case 0 * 32 + 2: return launch_narrow_gather<uint16_t>(p, data, ids, out, s, r, e, st);
    case 1 * 32 + 16: return launch_wide_gather<uint4>(p, data, ids, out, s, r, e, st);
    case 1 * 32 + 8: return launch_wide_gather<uint2>(p, data, ids, out, s, r, e, st);
    case 1 * 32 + 4: return launch_wide_gather<uint32_t>(p, data, ids, out, s, r, e, st);
    case 1 * 32 + 2: return launch_wide_gather<uint16_t>(p, data, ids, out, s, r, e, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
