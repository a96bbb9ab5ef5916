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
// about 32 us at 3.35 TB/s, against 1.39 GFLOP (1650 FMAs per edge), about
// 21 us at the 67 TFLOP/s of float32 outside the tensor cores. So it is
// bound by bytes, with the arithmetic close behind. On the card, what sets
// its pace is shared memory: every weight reaches the FMAs as a broadcast
// from shared memory, and a 16-byte broadcast costs the crossbar as much as
// 16 bytes to every lane, so each weight has to feed as many FMAs as the
// registers allow. The design:
//   * Work is cut into units of (sample, work item). A work item is a run
//     of at most 64 whole buses whose in-edges fill at most 64 dst-CSR
//     rows (or one bus with more, over several 64-row tiles), made once per
//     topology on the host (ops/segment.py schedule_items, a (T, 4) table
//     of first bus, end bus, first row, end row). One warp runs a unit: lane
//     r takes CSR rows r and r + 32. A persistent grid (as many blocks as
//     the card keeps resident) hands units to warps in turn, sample-major,
//     so neighbouring warps share a sample's m in L2.
//   * A lane gathers its two edges' inputs once for all three heads:
//     m[s, bus] as five 16-byte loads (the bus is the row's own, from
//     row_bus), the five features and the mask, 50 inputs in registers.
//   * Weights: the three heads, repacked on the host with each matrix
//     transposed to (in, out) and its rows padded to 16-byte words, sit in
//     shared memory. For input i every lane reads the same word of four
//     (or, for the last two of 10 outputs, two) outputs' weights, and each
//     word feeds the FMAs of both edges: 8 FMAs per 16-byte load, no FMA on
//     padding. At (L, H) = (20, 10): 147 registers, 4 warps a block, 3
//     blocks per SM, no spill. At (40, 10) (the deep checkpoints) a lane
//     holds 90 inputs and its block 57,408 bytes of shared memory, so the
//     instance asks for 2 blocks per SM (MinBlocks), which leaves it up to
//     255 registers.
//   * Shared memory is dynamic (SharedLayout): at L = 40 it is over the 48
//     KB a block may hold statically.
//   * Per head, each lane writes its two rows of 20 masked outputs into
//     the warp's own 64 x 20 staging rows (16-byte stores), then lane i
//     sums bus b0 + i (and b0 + i + 32): its rows in CSR order from 0.0f in
//     float32, the order of segment_sum_plain, kept in registers, stored
//     as five 16-byte words. A run of buses is contiguous in out_h[s], so
//     the warp's stores cover one contiguous range. A hub bus over several
//     tiles carries its sums across tiles in shared memory.
//   * No block barrier after the weights' load: each warp syncs only itself.
//   * With a `clocks` buffer the launch takes a second instance of the
//     kernel (CLOCKS = true) whose warps also record their SM cycles
//     reading inputs, in the MLPs and summing and storing, and their units
//     (chip_smoke.py prints them); the default instance reads no clock.
// Tried on the card and dropped (see PERF.md): the
// weights as constant-bank operands (slower: the constant cache misses),
// one edge per lane (the same time at half the FMAs per load), three edges
// per lane (too few warps), bulk (TMA) stores of the sums, and fetching the
// next unit's indices and inputs ahead (cp.async): each moved time between
// the phases and not out of the kernel.
//
// Built by gns_torch/ops/segment_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes. The
// entry point launches on the stream it is given, allocates nothing and
// returns a cudaError_t; the Python wrapper (gns_torch/ops/fused.py) checks
// shapes, types, devices, contiguity and alignment before it calls.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kEdges = 2;       // dst-CSR rows per lane
constexpr int kRows = 32 * kEdges;  // rows per warp tile
constexpr int kMaxDevices = 64;

// Blocks resident per SM that an instance's __launch_bounds__ asks for:
// 3 (at most 170 registers a thread) at L = 20; 2 at L = 40, whose lane
// holds 90 inputs across the three heads.
template <int L>
constexpr int MinBlocks() { return L <= 20 ? 3 : 2; }
// `clocks` per warp: cycles reading inputs, in the MLPs, summing and
// storing, and the units run.
constexpr int kPhases = 4;

constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// One head's weights as ops/fused.py pack_weights lays them out: each
// matrix transposed to (in, out), its rows padded with zeros to a multiple
// of 4 floats, and each bias padded the same way, so that the weights of
// four consecutive outputs for one input are one 16-byte word.
template <int L, int H>
struct Pack {
  static constexpr int F = L + 5, HP = round4(H), LP = round4(L);
  static constexpr int kW1 = 0, kB1 = F * HP, kW2 = kB1 + HP, kB2 = kW2 + H * HP;
  static constexpr int kW4 = kB2 + HP, kB4 = kW4 + H * LP, kSize = kB4 + LP;
};

// A block's dynamic shared memory, in floats: the three heads' weights, each
// warp's staging rows and hub sums, then each warp's tile row pointers.
template <int L, int H>
struct SharedLayout {
  static constexpr int kW = 0, kStage = kW + 3 * Pack<L, H>::kSize;
  static constexpr int kHub = kStage + kWarps * kRows * L, kPtr = kHub + kWarps * 3 * L;
  static constexpr int kBytes = (kPtr + kWarps * (kRows + 1)) * 4;
  static_assert(kStage % 4 == 0 && kHub % 4 == 0, "16-byte aligned rows");
};

__device__ __forceinline__ float lrelu(float x, float slope) { return x >= 0.0f ? x : slope * x; }

// The SM clock where CLOCKS, else 0 and no clock read.
template <bool CLOCKS>
__device__ __forceinline__ long long stamp() {
  if constexpr (CLOCKS) return clock64();
  else return 0;
}

// Outputs [o0, o0 + V) (V = 4 or 2) of a layer with N inputs, for the
// lane's kEdges edges: sum_i x[e][i] w[i][o] from 0.0f in order of i, plus
// the bias; w (N, OUTP) and the bias b in shared memory, read as 16- or
// 8-byte words, every lane the same word (a broadcast), one word feeding
// V kEdges FMAs.
template <int N, int OUTP, int V>
__device__ __forceinline__ void layer(const float* w, const float* b, float (&x)[kEdges][N], int o0,
                                      float (&acc)[kEdges][4]) {
  static_assert(V == 4 || V == 2, "16- or 8-byte words");
#pragma unroll
  for (int e = 0; e < kEdges; ++e)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[e][k] = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float t[4];
    if constexpr (V == 4) {
      const float4 q = *reinterpret_cast<const float4*>(w + i * OUTP + o0);
      t[0] = q.x; t[1] = q.y; t[2] = q.z; t[3] = q.w;
    } else {
      const float2 q = *reinterpret_cast<const float2*>(w + i * OUTP + o0);
      t[0] = q.x; t[1] = q.y;
    }
#pragma unroll
    for (int e = 0; e < kEdges; ++e)
#pragma unroll
      for (int k = 0; k < V; ++k) acc[e][k] = fmaf(x[e][i], t[k], acc[e][k]);
  }
  float t[4];
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(b + o0);
    t[0] = q.x; t[1] = q.y; t[2] = q.z; t[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(b + o0);
    t[0] = q.x; t[1] = q.y;
  }
#pragma unroll
  for (int k = 0; k < V; ++k)
#pragma unroll
    for (int e = 0; e < kEdges; ++e) acc[e][k] += t[k];
}

// A hidden layer (OUT = H outputs, LReLU) in words of 4 outputs, the last
// word 2 wide where H % 4 <= 2 (10 = 4 + 4 + 2: no FMA on padding).
template <int N, int H, int OUTP>
__device__ __forceinline__ void hidden(const float* w, const float* b, float (&x)[kEdges][N],
                                       float slope, float (&y)[kEdges][H]) {
  float acc[kEdges][4];
#pragma unroll
  for (int o0 = 0; o0 < H; o0 += 4) {
    constexpr int kTail = H % 4 == 0 ? 4 : (H % 4 <= 2 ? 2 : 4);
    const bool full = o0 + 4 <= H;
    if (full) layer<N, OUTP, 4>(w, b, x, o0, acc);
    else layer<N, OUTP, kTail>(w, b, x, o0, acc);
#pragma unroll
    for (int e = 0; e < kEdges; ++e)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (o0 + k < H) y[e][o0 + k] = lrelu(acc[e][k], slope);
  }
}

// One head's MLP on the lane's edges (inputs x, masks me); edge e's L
// outputs times its mask go to row lane + 32 e of buf (16-byte words).
template <int L, int H>
__device__ __forceinline__ void head_mlp(const float* hw, float (&x)[kEdges][L + 5],
                                         const float (&me)[kEdges], float slope, float* buf,
                                         int lane) {
  using P = Pack<L, H>;
  float h1[kEdges][H], h2[kEdges][H], acc[kEdges][4];
  hidden<P::F, H, P::HP>(hw + P::kW1, hw + P::kB1, x, slope, h1);
  hidden<H, H, P::HP>(hw + P::kW2, hw + P::kB2, h1, slope, h2);
#pragma unroll
  for (int g = 0; g < L / 4; ++g) {
    layer<H, P::LP, 4>(hw + P::kW4, hw + P::kB4, h2, 4 * g, acc);
#pragma unroll
    for (int e = 0; e < kEdges; ++e)
      reinterpret_cast<float4*>(buf + (lane + 32 * e) * L)[g] =
          make_float4(acc[e][0] * me[e], acc[e][1] * me[e], acc[e][2] * me[e], acc[e][3] * me[e]);
  }
}

// Inputs for dst-CSR row j of sample s: m[s, bus] then feats[s, e];
// returns the mask.
template <int L>
__device__ __forceinline__ float load_edge(const float* __restrict__ m,
                                           const float* __restrict__ feats,
                                           const float* __restrict__ mask,
                                           const int* __restrict__ order,
                                           const int* __restrict__ row_bus, long long s, int N,
                                           int E, int j, bool m_vec, float* x) {
  const int e = __ldg(order + j), bus = __ldg(row_bus + j) >> 1;
  const float* mr = m + (s * N + bus) * L;
  if (m_vec) {
#pragma unroll
    for (int q = 0; q < L / 4; ++q) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(mr) + q);
      x[4 * q] = t.x; x[4 * q + 1] = t.y; x[4 * q + 2] = t.z; x[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int l = 0; l < L; ++l) x[l] = __ldg(mr + l);
  }
  const float* fr = feats + (s * E + e) * 5;
#pragma unroll
  for (int k = 0; k < 5; ++k) x[L + k] = __ldg(fr + k);
  return __ldg(mask + s * E + e);
}

template <int L, int H, bool CLOCKS>
__global__ void __launch_bounds__(kThreads, MinBlocks<L>()) fused_edge_kernel(
    const float* __restrict__ m, const float* __restrict__ feats,
    const float* __restrict__ mask, const int* __restrict__ order,
    const int* __restrict__ indptr, const int4* __restrict__ items,
    const int* __restrict__ row_bus, const float* __restrict__ weights,
    float* __restrict__ out0, float* __restrict__ out1, float* __restrict__ out2,
    long long S, int N, int E, int T, float slope, long long* __restrict__ clocks) {
  static_assert(L % 4 == 0, "outputs are stored as 16-byte words");
  using P = Pack<L, H>;
  using SL = SharedLayout<L, H>;
  constexpr int G = L / 4;  // 16-byte words of an output row
  extern __shared__ float4 smem[];
  float* const w = reinterpret_cast<float*>(smem) + SL::kW;
  for (int i = threadIdx.x; i < 3 * P::kSize / 4; i += blockDim.x)
    reinterpret_cast<float4*>(w)[i] = __ldg(reinterpret_cast<const float4*>(weights) + i);
  __syncthreads();

  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  float* buf = reinterpret_cast<float*>(smem) + SL::kStage + wid * kRows * L;  // (kRows, L)
  float* hub = reinterpret_cast<float*>(smem) + SL::kHub + wid * 3 * L;  // a hub bus's sums
  int* bp = reinterpret_cast<int*>(smem) + SL::kPtr + wid * (kRows + 1);
  const bool m_vec = (reinterpret_cast<uintptr_t>(m) & 15) == 0;
  const long long units = S * T, warps = (long long)gridDim.x * kWarps;
  long long spent[kPhases] = {0, 0, 0, 0};  // CLOCKS: SM cycles per phase, and units
  for (long long u = (long long)blockIdx.x * kWarps + wid; u < units; u += warps) {
    const long long s = u / T;
    const int4 it = __ldg(items + (u - s * T));  // first bus, end bus, first row, end row
    const int b0 = it.x, b1 = it.y, r0 = it.z, r1 = it.w;
    const long long base = s * N * L;
    if constexpr (CLOCKS) ++spent[3];
    // one tile for a run of whole buses; several for a hub bus
    for (int r = r0; r == r0 || r < r1; r += kRows) {
      const int t1 = min(r1, r + kRows);
      long long t0 = stamp<CLOCKS>();
      float x[kEdges][P::F], me[kEdges];
#pragma unroll
      for (int e = 0; e < kEdges; ++e) {
        me[e] = 0.0f;
        if (r + lane + 32 * e < t1)
          me[e] = load_edge<L>(m, feats, mask, order, row_bus, s, N, E, r + lane + 32 * e, m_vec,
                               x[e]);
        else
#pragma unroll
          for (int i = 0; i < P::F; ++i) x[e][i] = 0.0f;  // a row past the tile: never read
      }
      // the tile's rows of each bus of the item, relative to r
      for (int i = lane; i <= b1 - b0; i += 32)
        bp[i] = min(max(__ldg(indptr + b0 + i), r), t1) - r;
      __syncwarp();
      if constexpr (CLOCKS) spent[0] += stamp<CLOCKS>() - t0;
#pragma unroll 1
      for (int h = 0; h < 3; ++h) {
        t0 = stamp<CLOCKS>();
        if (r + lane < t1) head_mlp<L, H>(w + h * P::kSize, x, me, slope, buf, lane);
        __syncwarp();
        const long long t2 = stamp<CLOCKS>();
        if constexpr (CLOCKS) spent[1] += t2 - t0;
        // lane i (and i + 32) sums bus b0 + i: its rows of this tile in CSR
        // order, from 0.0f at the item's first tile (or from a hub bus's
        // running sums), and stores the row at the item's last tile
        for (int i = lane; i < b1 - b0; i += 32) {
          float acc[L];
#pragma unroll
          for (int l = 0; l < L; ++l) acc[l] = r == r0 ? 0.0f : hub[h * L + l];
          for (int k = bp[i]; k < bp[i + 1]; ++k) {
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const float4 v = reinterpret_cast<const float4*>(buf + k * L)[g];
              acc[4 * g] += v.x; acc[4 * g + 1] += v.y; acc[4 * g + 2] += v.z; acc[4 * g + 3] += v.w;
            }
          }
          if (t1 == r1) {
            float4* o = reinterpret_cast<float4*>((h == 0 ? out0 : h == 1 ? out1 : out2) + base +
                                                  (b0 + i) * L);
#pragma unroll
            for (int g = 0; g < G; ++g)
              o[g] = make_float4(acc[4 * g], acc[4 * g + 1], acc[4 * g + 2], acc[4 * g + 3]);
          } else {  // a hub item (one bus, lane 0): the next tile goes on
#pragma unroll
            for (int l = 0; l < L; ++l) hub[h * L + l] = acc[l];
          }
        }
        __syncwarp();
        if constexpr (CLOCKS) spent[2] += stamp<CLOCKS>() - t2;
      }
    }
  }
  if constexpr (CLOCKS) {
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kPhases; ++k) clocks[(blockIdx.x * kWarps + wid) * kPhases + k] = spent[k];
    }
  }
}

// Blocks of fused_edge_kernel<L, H, false> the card keeps resident per SM,
// and the SM count, cached per device; the first call on a device also lets
// both instances take their dynamic shared memory. The grid of either
// instance is sized by these (the CLOCKS instance only measures; were it to
// keep fewer blocks resident, the rest would wait their turn).
template <int L, int H>
cudaError_t residency(int* per_sm, int* sms) {
  static int cached[kMaxDevices][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev][0] == 0) {
    constexpr int bytes = SharedLayout<L, H>::kBytes;
    err = cudaFuncSetAttribute(fused_edge_kernel<L, H, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fused_edge_kernel<L, H, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached[dev][0],
                                                        fused_edge_kernel<L, H, false>, kThreads,
                                                        bytes);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&cached[dev][1], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *per_sm = cached[dev][0];
  *sms = cached[dev][1];
  return cudaSuccess;
}

template <int L, int H>
int launch(const float* m, const float* feats, const float* mask, const int* order,
           const int* indptr, const int4* items, const int* row_bus, const float* weights,
           float* out0, float* out1, float* out2, long long S, int N, int E, int T, float slope,
           long long* clocks, cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  cudaError_t err = residency<L, H>(&per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long want = (S * T + kWarps - 1) / kWarps;
  const long long most = (long long)per_sm * sms;
  const unsigned int grid = (unsigned int)(want < most ? want : most);
  constexpr size_t bytes = SharedLayout<L, H>::kBytes;
  if (clocks == nullptr)
    fused_edge_kernel<L, H, false><<<grid, kThreads, bytes, stream>>>(
        m, feats, mask, order, indptr, items, row_bus, weights, out0, out1, out2, S, N, E, T,
        slope, nullptr);
  else
    fused_edge_kernel<L, H, true><<<grid, kThreads, bytes, stream>>>(
        m, feats, mask, order, indptr, items, row_bus, weights, out0, out1, out2, S, N, E, T,
        slope, clocks);
  return (int)cudaGetLastError();
}

template <int L, int H>
int occupancy(int* out) {
  int per_sm = 0, sms = 0;
  const cudaError_t err = residency<L, H>(&per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  out[0] = SharedLayout<L, H>::kBytes;
  out[1] = per_sm;
  out[2] = kThreads;
  out[3] = sms;
  return 0;
}

}  // namespace

extern "C" {

// Floats of the three heads' packed weights, or -1 for an unsupported
// (L, H). Built for the shipped checkpoints' widths, (L, H) = (20, 10) and
// (40, 10): another width gets its instantiation together with a check of
// it on the card.
int gns_fused_edge_weight_floats(int L, int H) {
  if (L == 20 && H == 10) return 3 * Pack<20, 10>::kSize;
  if (L == 40 && H == 10) return 3 * Pack<40, 10>::kSize;
  return -1;
}

// out: shared bytes per block, blocks resident per SM, threads per block,
// SMs. At most out[1] * out[3] blocks run (a persistent grid), so a
// `clocks` buffer of out[1] * out[3] * out[2] / 32 warps always suffices.
// Returns a cudaError_t.
int gns_fused_edge_occupancy(int L, int H, int* out) {
  if (L == 20 && H == 10) return occupancy<20, 10>(out);
  if (L == 40 && H == 10) return occupancy<40, 10>(out);
  return (int)cudaErrorInvalidValue;
}

// m (S, N, L), feats (S, E, 5), mask (S, E); order / indptr (N + 1,) the
// CSR of dst; items (T, 4) the work items (first bus, end bus, first row,
// end row; 16-byte aligned) and row_bus (E,) each CSR row's bus << 1
// (ops/segment.py schedule_items); weights the
// three heads packed as Pack, on the card; out0..2 (S, N, L), 16-byte
// aligned; clocks null, or (warps of the grid, kPhases) int64 to receive
// each warp's cycles per phase. Supported (L, H): (20, 10), (40, 10).
int gns_fused_edge(const float* m, const float* feats, const float* mask, const int* order,
                   const int* indptr, const int* items, const int* row_bus,
                   const float* weights, float* out0, float* out1, float* out2, long long S,
                   int N, int E, int T, int L, int H, float slope, long long* clocks,
                   void* stream) {
  if (S == 0 || N == 0) return 0;
  if (T < 1) return (int)cudaErrorInvalidValue;
  const int4* it = reinterpret_cast<const int4*>(items);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L == 20 && H == 10)
    return launch<20, 10>(m, feats, mask, order, indptr, it, row_bus, weights, out0, out1, out2,
                          S, N, E, T, slope, clocks, st);
  if (L == 40 && H == 10)
    return launch<40, 10>(m, feats, mask, order, indptr, it, row_bus, weights, out0, out1, out2,
                          S, N, E, T, slope, clocks, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
