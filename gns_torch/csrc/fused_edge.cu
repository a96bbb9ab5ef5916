// K3: the fused edge stage of one GNS correction step, for NVIDIA Hopper
// (sm_90a), in exact float32.
//
// Replaces the Pallas TPU kernel gns_tpu/ops/pallas_fused.py `_fused_kernel`
// (:50, pallas_call :116, public fused_edge_stage :146). Per sample s:
//   edge_in = concat(m[s, dst], feats[s])                     (E, L + 5)
//   for head h in (phi_v, phi_theta, phi_m):
//     x = LReLU(edge_in W1^T + b1); x = LReLU(x W2^T + b2); x = x W4^T + b4
//     out_h[s] = segment-sum over dst of x * line_mask[s]     (N, L)
// The TPU kernel gathered and aggregated with one-hot (E, N) incidences on
// the MXU, and compiled Mosaic truncated the f32 operands to bf16
// (pallas_fused.py:22-28). This kernel does neither: it indexes m[dst]
// directly, multiplies in full float32 on the CUDA cores (no TF32, no bf16)
// and aggregates by walking a CSR of the edges by destination, in edge
// order, with no atomics. The sums are then deterministic and equal, add
// for add, to the plain twin's (index_add_ over the same CSR); only the
// dot products of the MLP may round differently from a GEMM library.
//
// What bounds it on an H100: at case300, S=1024, L=20, H=10 it reads m,
// feats and the mask (about 34 MB) and writes three (S, N, L) sums (74 MB):
// about 32 us at 3.35 TB/s, against 1.39 GFLOP, about 21 us at the 67
// TFLOP/s of float32 outside the tensor cores. So it is bound by bytes.
// What the design does:
//   * one block per sample, so every intermediate stays on chip: the three
//     heads' weights (3 * 590 floats at L=20, H=10) and one head's masked
//     edge outputs (E * L floats, 33 KB at case300) live in shared memory,
//     and nothing of size E leaves the SM;
//   * one thread per edge runs a head's whole MLP in registers (L and H are
//     template constants, so the loops unroll and the activations stay in
//     registers); every thread reads the same weight at the same time, a
//     shared-memory broadcast;
//   * then one thread per output element (n, l) sums its bus's edge rows in
//     CSR order, neighbouring threads on neighbouring l, so the output
//     store is coalesced;
//   * the heads run one after the other, reusing the E * L buffer.
//
// Built by gns_torch/ops/segment_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes. The
// entry point launches on the stream it is given, allocates nothing and
// returns a cudaError_t; the Python wrapper (gns_torch/ops/fused.py) checks
// shapes, types, devices and contiguity before it calls.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxShared = 232448;  // 227 KB, the most a block may use

// Weights of one head, packed by the wrapper in torch's (out, in) layout:
// w1 (H, F), b1 (H), w2 (H, H), b2 (H), w4 (L, H), b4 (L).
template <int L, int H>
struct Head {
  static constexpr int F = L + 5;
  static constexpr int kW1 = 0, kB1 = H * F, kW2 = kB1 + H, kB2 = kW2 + H * H;
  static constexpr int kW4 = kB2 + H, kB4 = kW4 + L * H, kSize = kB4 + L;
};

__device__ __forceinline__ float lrelu(float x, float slope) { return x >= 0.0f ? x : slope * x; }

template <int L, int H>
__global__ void __launch_bounds__(kThreads) fused_edge_kernel(
    const float* __restrict__ m, const float* __restrict__ feats,
    const float* __restrict__ mask, const int* __restrict__ dst,
    const int* __restrict__ order, const int* __restrict__ indptr,
    const float* __restrict__ weights, float* __restrict__ out0,
    float* __restrict__ out1, float* __restrict__ out2, int N, int E, float slope) {
  using Hd = Head<L, H>;
  constexpr int F = Hd::F;
  extern __shared__ float smem[];
  float* w = smem;                    // 3 heads
  float* rows = smem + 3 * Hd::kSize; // (E, L): one head's masked edge outputs
  const long long s = blockIdx.x;
  for (int i = threadIdx.x; i < 3 * Hd::kSize; i += blockDim.x) w[i] = weights[i];
  __syncthreads();

  const float* ms = m + s * N * L;
  const float* fs = feats + s * E * 5;
  const float* mk = mask + s * E;
  float* outs[3] = {out0, out1, out2};

  for (int h = 0; h < 3; ++h) {
    const float* hw = w + h * Hd::kSize;
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      float x[F];
      const float* mrow = ms + (long long)dst[e] * L;
#pragma unroll
      for (int l = 0; l < L; ++l) x[l] = mrow[l];
#pragma unroll
      for (int j = 0; j < 5; ++j) x[L + j] = fs[e * 5 + j];
      float h1[H], h2[H];
#pragma unroll
      for (int j = 0; j < H; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < F; ++i) acc = fmaf(x[i], hw[Hd::kW1 + j * F + i], acc);
        h1[j] = lrelu(acc + hw[Hd::kB1 + j], slope);
      }
#pragma unroll
      for (int j = 0; j < H; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < H; ++i) acc = fmaf(h1[i], hw[Hd::kW2 + j * H + i], acc);
        h2[j] = lrelu(acc + hw[Hd::kB2 + j], slope);
      }
      const float me = mk[e];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < H; ++i) acc = fmaf(h2[i], hw[Hd::kW4 + l * H + i], acc);
        rows[e * L + l] = (acc + hw[Hd::kB4 + l]) * me;
      }
    }
    __syncthreads();
    float* o = outs[h] + s * N * L;
    for (int i = threadIdx.x; i < N * L; i += blockDim.x) {
      const int n = i / L, l = i - (i / L) * L;
      float acc = 0.0f;
      for (int j = indptr[n]; j < indptr[n + 1]; ++j) acc += rows[order[j] * L + l];
      o[i] = acc;
    }
    __syncthreads();
  }
}

template <int L, int H>
int launch(const float* m, const float* feats, const float* mask, const int* dst,
           const int* order, const int* indptr, const float* weights, float* out0,
           float* out1, float* out2, long long S, int N, int E, float slope,
           cudaStream_t stream) {
  const long long shared = (3LL * Head<L, H>::kSize + (long long)E * L) * sizeof(float);
  if (shared > kMaxShared) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_edge_kernel<L, H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shared);
  if (err != cudaSuccess) return (int)err;
  fused_edge_kernel<L, H><<<(unsigned int)S, kThreads, (size_t)shared, stream>>>(
      m, feats, mask, dst, order, indptr, weights, out0, out1, out2, N, E, slope);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of shared memory a block needs, or -1 for an unsupported (L, H).
// Built for the shipped checkpoints' (L, H) = (20, 10) only: another width
// gets its instantiation together with a check of it on the card.
long long gns_fused_edge_shared_bytes(int E, int L, int H) {
  if (L != 20 || H != 10) return -1;
  return (3LL * Head<20, 10>::kSize + (long long)E * L) * (long long)sizeof(float);
}

// m (S, N, L), feats (S, E, 5), mask (S, E), dst (E,) in [0, N); order /
// indptr (N + 1,) the CSR of dst; weights the three heads packed as Head;
// out0..2 (S, N, L). Supported (L, H): (20, 10).
int gns_fused_edge(const float* m, const float* feats, const float* mask, const int* dst,
                   const int* order, const int* indptr, const float* weights, float* out0,
                   float* out1, float* out2, long long S, int N, int E, int L, int H,
                   float slope, void* stream) {
  if (S == 0 || N == 0) return 0;
  if (L != 20 || H != 10) return (int)cudaErrorInvalidValue;
  return launch<20, 10>(m, feats, mask, dst, order, indptr, weights, out0, out1, out2, S, N, E,
                        slope, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
