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
//     padding where a layer's last word is 2 wide. At (L, H) = (20, 10):
//     148 registers (nvcc 12.9), 4 warps a block, 3 blocks per SM, no
//     spill. At (40,
//     10) (the deep checkpoints) a lane holds 90 inputs and its block
//     57,408 bytes of shared memory, so the instance asks for 2 blocks per
//     SM, which leaves it up to 255 registers.
//   * One library per width: ops/segment_kernels.py builds this file for
//     each (L, H) a caller needs (any L, H >= 1, segment_kernels.
//     check_width), with GNS_LATENT, GNS_HIDDEN, GNS_MIN_BLOCKS (the blocks
//     per SM __launch_bounds__ asks for, segment_kernels.min_blocks: 3
//     while 2 (L + 5) + 4 H <= 90 and L <= 25, else 2; 4 for the wide
//     design, 3 for the workspace one), GNS_ROWS (64 for this design, 16
//     for the other two, segment_kernels.k3_rows) and, for the workspace
//     design, GNS_WORKSPACE=1, defined on the command line.
//   * Two edges' 2 (L + 5) inputs and 4 H activations stay in a lane's
//     registers up to (33, 24)'s 172 floats (198 registers, no spill); at
//     (64, 32) they would be 266. Past 172 the library is the wide design
//     (GNS_ROWS 16, fused_edge_kernel_wide below): 16-row tiles whose
//     inputs and activations sit in the warp's scratch, each row's outputs
//     split over lanes, the weights read from L2 through L1, the sums taken
//     a lane per output column; the same bits as this design. Its lanes'
//     registers do not grow with the width: a layer runs in passes of 64
//     output columns, each a loop over its inputs, and every other loop
//     over L or H is rolled past a fixed count. Its scratch does: a warp's
//     16 x (L + 5 + max(H, L) + H) floats, 106,304 bytes for a block's four
//     warps at (128, 128), 210,752 at (256, 256), 304,960 at (512, 64).
//     So the scratch sits in shared memory (the wide design) while four
//     warps' fit a block, and past that (the workspace design,
//     GNS_WORKSPACE) in a global workspace the wrapper allocates, a warp's
//     slice for every warp of the persistent grid, the block taking no
//     shared memory: that holds any width. Of the other ways past a block,
//     fewer rows a tile would cut the 8 rows that each weight word a lane
//     reads feeds (8 x 4 FMAs a word), and fewer warps a block (down to
//     one, 105 KB at (512, 512)) would hold 1-2 warps an SM and still stop
//     near (1,200, 1,200); the workspace keeps 4 warps a block, and
//     registers, not memory, set its blocks per SM (3: at 4, 128 registers,
//     ptxas spilled at some widths).
//     Its scratch is written and read back by the same warp, so it stays
//     in L1 / L2 while the warps' slices fit there (104,912 bytes a warp
//     at (512, 512); ptxas used 125 registers there, so the H100's 132 SMs
//     kept 4 blocks each, 2,112 warps and 221,574,144 bytes of workspace
//     for the grid: past L2, slow, not wrong).
//   * Shared memory is dynamic (SharedLayout): at L = 40 it is over the 48
//     KB a block may hold statically.
//   * Per head, each lane writes its two rows of masked outputs into the
//     warp's own 64 staging rows of round4(L) floats (16-byte stores, zeros
//     past L), then lane i sums bus b0 + i (and b0 + i + 32): its rows in
//     CSR order from 0.0f in float32, the order of segment_sum_plain, kept
//     in registers, and stores its L sums into the contiguous (S, N, L)
//     output in the widest word a row's start allows: 16 bytes where L % 4
//     == 0, 8 where L is even, else 4. (Not a padded (S, N, round4(L))
//     output and a copy: that would write the sums twice.) A run of buses
//     is contiguous in out_h[s], so the warp's stores cover one contiguous
//     range. A hub bus over several tiles carries its sums across tiles in
//     shared memory.
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

#if !defined(GNS_LATENT) || !defined(GNS_HIDDEN) || !defined(GNS_MIN_BLOCKS) || !defined(GNS_ROWS)
#error "built per width: nvcc -DGNS_LATENT=L -DGNS_HIDDEN=H -DGNS_MIN_BLOCKS=B -DGNS_ROWS=R \
[-DGNS_WORKSPACE=1] (ops/segment_kernels.py)"
#endif
#ifndef GNS_WORKSPACE
#define GNS_WORKSPACE 0
#endif

namespace {

constexpr int kLatent = GNS_LATENT, kHidden = GNS_HIDDEN;
static_assert(kLatent >= 1 && kHidden >= 1, "K3 takes L >= 1, H >= 1");
static_assert(GNS_ROWS == 64 || GNS_ROWS == 16, "rows per warp tile: 64 (registers) or 16 (wide)");
// The design this library's width takes (segment_kernels.k3_design): two
// edges a lane in registers (64-row tiles), or the wide one (16-row tiles)
// with its warps' scratch in shared memory or, kGlobal, in the workspace.
constexpr bool kWide = GNS_ROWS == 16;
constexpr bool kGlobal = GNS_WORKSPACE != 0;
static_assert(kWide || !kGlobal, "the workspace holds the wide design's scratch");

constexpr int kThreads = 128;   // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kEdges = 2;       // dst-CSR rows per lane
constexpr int kRows = 32 * kEdges;  // rows per warp tile
constexpr int kMaxDevices = 64;

// Blocks resident per SM that the kernel's __launch_bounds__ asks for:
// 3 (at most 170 registers a thread) at L = 20; 2 at L = 40, whose lane
// holds 90 inputs across the three heads.
constexpr int kMinBlocks = GNS_MIN_BLOCKS;
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
// warp's staging rows (kRows x round4(L)) and hub sums, then each warp's
// tile row pointers.
template <int L, int H>
struct SharedLayout {
  static constexpr int kW = 0, kStage = kW + 3 * Pack<L, H>::kSize;
  static constexpr int kHub = kStage + kWarps * kRows * round4(L), kPtr = kHub + kWarps * 3 * L;
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
// outputs times its mask go to row lane + 32 e of buf, whose rows are
// round4(L) floats (16-byte words, zeros past L). The last word is
// computed 2 wide where L % 4 <= 2, as in `hidden`.
template <int L, int H>
__device__ __forceinline__ void head_mlp(const float* hw, float (&x)[kEdges][L + 5],
                                         const float (&me)[kEdges], float slope, float* buf,
                                         int lane) {
  using P = Pack<L, H>;
  float h1[kEdges][H], h2[kEdges][H], acc[kEdges][4];
  hidden<P::F, H, P::HP>(hw + P::kW1, hw + P::kB1, x, slope, h1);
  hidden<H, H, P::HP>(hw + P::kW2, hw + P::kB2, h1, slope, h2);
#pragma unroll
  for (int g = 0; g < P::LP / 4; ++g) {
    constexpr int kTail = L % 4 == 0 ? 4 : (L % 4 <= 2 ? 2 : 4);
    if (4 * g + 4 <= L) layer<H, P::LP, 4>(hw + P::kW4, hw + P::kB4, h2, 4 * g, acc);
    else layer<H, P::LP, kTail>(hw + P::kW4, hw + P::kB4, h2, 4 * g, acc);
#pragma unroll
    for (int e = 0; e < kEdges; ++e) {
      float o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] = 4 * g + k < L ? acc[e][k] * me[e] : 0.0f;
      reinterpret_cast<float4*>(buf + (lane + 32 * e) * P::LP)[g] = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

// Floats per word in which a row of L floats is read from m and written to
// the outputs: a row starts on a 16-byte word where L % 4 == 0 (the base
// pointers being 16-byte aligned), on an 8-byte word where L is even.
template <int L>
__host__ __device__ constexpr int row_word() { return L % 4 == 0 ? 4 : (L % 2 == 0 ? 2 : 1); }

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
  if (m_vec && row_word<L>() == 4) {
#pragma unroll
    for (int q = 0; q < L / 4; ++q) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(mr) + q);
      x[4 * q] = t.x; x[4 * q + 1] = t.y; x[4 * q + 2] = t.z; x[4 * q + 3] = t.w;
    }
  } else if (m_vec && row_word<L>() == 2) {
#pragma unroll
    for (int q = 0; q < L / 2; ++q) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(mr) + q);
      x[2 * q] = t.x; x[2 * q + 1] = t.y;
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
__global__ void __launch_bounds__(kThreads, kMinBlocks) fused_edge_kernel(
    const float* __restrict__ m, const float* __restrict__ feats,
    const float* __restrict__ mask, const int* __restrict__ order,
    const int* __restrict__ indptr, const int4* __restrict__ items,
    const int* __restrict__ row_bus, const float* __restrict__ weights,
    float* __restrict__ out0, float* __restrict__ out1, float* __restrict__ out2,
    long long S, int N, int E, int T, float slope, long long* __restrict__ clocks) {
  using P = Pack<L, H>;
  using SL = SharedLayout<L, H>;
  constexpr int G = P::LP / 4;  // 16-byte words of a staging row
  constexpr int W = row_word<L>();  // floats per word of an output row
  extern __shared__ float4 smem[];
  float* const w = reinterpret_cast<float*>(smem) + SL::kW;
  for (int i = threadIdx.x; i < 3 * P::kSize / 4; i += blockDim.x)
    reinterpret_cast<float4*>(w)[i] = __ldg(reinterpret_cast<const float4*>(weights) + i);
  __syncthreads();

  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  float* buf = reinterpret_cast<float*>(smem) + SL::kStage + wid * kRows * P::LP;  // (kRows, LP)
  float* hub = reinterpret_cast<float*>(smem) + SL::kHub + wid * 3 * L;  // a hub bus's sums
  int* bp = reinterpret_cast<int*>(smem) + SL::kPtr + wid * (kRows + 1);
  const bool m_vec = (reinterpret_cast<uintptr_t>(m) & (4 * W - 1)) == 0;
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
          float acc[P::LP];
#pragma unroll
          for (int l = 0; l < P::LP; ++l) acc[l] = r == r0 || l >= L ? 0.0f : hub[h * L + l];
          for (int k = bp[i]; k < bp[i + 1]; ++k) {
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const float4 v = reinterpret_cast<const float4*>(buf + k * P::LP)[g];
              acc[4 * g] += v.x; acc[4 * g + 1] += v.y; acc[4 * g + 2] += v.z; acc[4 * g + 3] += v.w;
            }
          }
          if (t1 == r1) {
            float* o = (h == 0 ? out0 : h == 1 ? out1 : out2) + base + (b0 + i) * L;
            if constexpr (W == 4) {
#pragma unroll
              for (int g = 0; g < L / 4; ++g)
                reinterpret_cast<float4*>(o)[g] =
                    make_float4(acc[4 * g], acc[4 * g + 1], acc[4 * g + 2], acc[4 * g + 3]);
            } else if constexpr (W == 2) {
#pragma unroll
              for (int g = 0; g < L / 2; ++g)
                reinterpret_cast<float2*>(o)[g] = make_float2(acc[2 * g], acc[2 * g + 1]);
            } else {
#pragma unroll
              for (int l = 0; l < L; ++l) o[l] = acc[l];
            }
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

// ---- the wide design (kWide: 2 (L + 5) + 4 H past the registers) ----
// A warp's tile is 16 dst-CSR rows. Its inputs sit in the warp's shared
// memory a column of 16 rows per input (16-byte words of 4 rows), and each
// layer's outputs likewise: lane (rg, cg) = (lane / 16, lane % 16) computes
// rows 8 rg .. 8 rg + 7 of outputs 4 cg .. 4 cg + 3 of each 64, reading per
// input two words of rows (a broadcast to half the warp) and one word of
// four outputs' weights: 32 FMAs per 48 bytes. The weights are read from
// global memory (ld.global.nc, kept in L1 / L2), not staged: a head's
// weights are up to 200 KB at (128, 128), and staging them per layer would
// tie a block's warps, whose units differ in rows, to one another by
// barriers. Each output is the sum of x[i] w[i][o] from 0.0f in order of i,
// plus the bias, as `layer` computes it, and the sums of a bus are taken
// in CSR order, so the two designs give the same bits at one width.
constexpr int kWideRows = 16;

template <int L, int H>
struct WideLayout {  // one warp's shared memory, in floats
  static constexpr int F = L + 5, HL = H > L ? H : L;
  static constexpr int kIn = 0;                         // (F, 16): the tile's inputs
  static constexpr int kA = kIn + F * kWideRows;        // (max(H, L), 16): layer 1, then the outputs
  static constexpr int kB = kA + HL * kWideRows;        // (H, 16): layer 2
  static constexpr int kHub = kB + H * kWideRows;       // 3 L: a hub bus's sums
  static constexpr int kMask = kHub + round4(3 * L);    // 16 line masks
  static constexpr int kPtr = kMask + kWideRows;        // 17 ints: each bus's first row
  static constexpr int kWarp = round4(kPtr + kWideRows + 1);
  static constexpr int kBytes = kWarps * kWarp * 4;
};

// One layer on a 16-row tile: out[o][r] = act(sum_i in[i][r] w[i][o] + b[o])
// (ACT: LReLU, else times the row's mask) for o < O; w (N, OP) and b (OP,)
// in global memory, OP = round4(O), zeros past O.
template <int N, int O, int OP, bool ACT>
__device__ __forceinline__ void wide_layer(const float* __restrict__ w, const float* __restrict__ b,
                                           const float* in, float* out, const float* mask,
                                           float slope, int lane) {
  const int rg = lane >> 4, cg = lane & 15;
#pragma unroll 1
  for (int c0 = 0; c0 < O; c0 += 64) {
    const int col = c0 + 4 * cg;
    if (col >= O) continue;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][k] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < N; ++i) {
      const float4 xa = *reinterpret_cast<const float4*>(in + i * kWideRows + 8 * rg);
      const float4 xb = *reinterpret_cast<const float4*>(in + i * kWideRows + 8 * rg + 4);
      const float4 q = __ldg(reinterpret_cast<const float4*>(w + i * OP + col));
      const float x[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float t[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[j][k] = fmaf(x[j], t[k], acc[j][k]);
    }
    const float4 q = __ldg(reinterpret_cast<const float4*>(b + col));
    const float t[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (col + k >= O) break;
      float o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = acc[j][k] + t[k];
        o[j] = ACT ? lrelu(v, slope) : v * mask[8 * rg + j];
      }
      float4* dst = reinterpret_cast<float4*>(out + (col + k) * kWideRows + 8 * rg);
      dst[0] = make_float4(o[0], o[1], o[2], o[3]);
      dst[1] = make_float4(o[4], o[5], o[6], o[7]);
    }
  }
}

template <int L, int H, bool CLOCKS>
__global__ void __launch_bounds__(kThreads, kMinBlocks) fused_edge_kernel_wide(
    const float* __restrict__ m, const float* __restrict__ feats,
    const float* __restrict__ mask, const int* __restrict__ order,
    const int* __restrict__ indptr, const int4* __restrict__ items,
    const int* __restrict__ row_bus, const float* __restrict__ weights,
    float* __restrict__ out0, float* __restrict__ out1, float* __restrict__ out2,
    long long S, int N, int E, int T, float slope, long long* __restrict__ clocks,
    float* __restrict__ workspace) {
  using P = Pack<L, H>;
  using WL = WideLayout<L, H>;
  constexpr int W = row_word<L>();  // floats per word of an m row
  constexpr int NA = (L + 31) / 32;  // output columns a lane sums
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  // the warp's scratch: in shared memory, or its slice of the workspace
  float* const ws = kGlobal ? workspace + ((long long)blockIdx.x * kWarps + wid) * WL::kWarp
                            : reinterpret_cast<float*>(smem) + wid * WL::kWarp;
  float* in = ws + WL::kIn;
  float* xa = ws + WL::kA;
  float* xb = ws + WL::kB;
  float* hub = ws + WL::kHub;
  float* msk = ws + WL::kMask;
  int* bp = reinterpret_cast<int*>(ws + WL::kPtr);
  const bool m_vec = (reinterpret_cast<uintptr_t>(m) & (4 * W - 1)) == 0;
  const long long units = S * T, warps = (long long)gridDim.x * kWarps;
  long long spent[kPhases] = {0, 0, 0, 0};  // CLOCKS: SM cycles per phase, and units
  for (long long u = (long long)blockIdx.x * kWarps + wid; u < units; u += warps) {
    const long long s = u / T;
    const int4 it = __ldg(items + (u - s * T));  // first bus, end bus, first row, end row
    const int b0 = it.x, b1 = it.y, r0 = it.z, r1 = it.w;
    const long long base = s * N * L;
    if constexpr (CLOCKS) ++spent[3];
    for (int r = r0; r == r0 || r < r1; r += kWideRows) {
      const int t1 = min(r1, r + kWideRows);
      long long t0 = stamp<CLOCKS>();
      // lane j < 16 stages row r + j: m[s, bus] then feats[s, e], and its
      // mask; zeros past the tile's rows
      if (lane < kWideRows) {
        float me = 0.0f;
        const int j = r + lane;
        if (j < t1) {
          const int e = __ldg(order + j), bus = __ldg(row_bus + j) >> 1;
          const float* mr = m + (s * N + bus) * L;
          // staging loops unrolled whole up to L = 128, by 8 past it (where
          // a 32-deep unroll spilled at 128 registers)
          if (m_vec && W == 4) {
#pragma unroll (L <= 128 ? 32 : 8)
            for (int q = 0; q < L / 4; ++q) {
              const float4 t = __ldg(reinterpret_cast<const float4*>(mr) + q);
              in[(4 * q) * kWideRows + lane] = t.x;
              in[(4 * q + 1) * kWideRows + lane] = t.y;
              in[(4 * q + 2) * kWideRows + lane] = t.z;
              in[(4 * q + 3) * kWideRows + lane] = t.w;
            }
          } else if (m_vec && W == 2) {
#pragma unroll (L <= 128 ? 64 : 8)
            for (int q = 0; q < L / 2; ++q) {
              const float2 t = __ldg(reinterpret_cast<const float2*>(mr) + q);
              in[(2 * q) * kWideRows + lane] = t.x;
              in[(2 * q + 1) * kWideRows + lane] = t.y;
            }
          } else {
#pragma unroll 4
            for (int l = 0; l < L; ++l) in[l * kWideRows + lane] = __ldg(mr + l);
          }
          const float* fr = feats + (s * E + e) * 5;
#pragma unroll
          for (int k = 0; k < 5; ++k) in[(L + k) * kWideRows + lane] = __ldg(fr + k);
          me = __ldg(mask + s * E + e);
        } else {
#pragma unroll 4
          for (int i = 0; i < P::F; ++i) in[i * kWideRows + lane] = 0.0f;  // never summed
        }
        msk[lane] = me;
      }
      // the tile's rows of each bus of the item, relative to r
      for (int i = lane; i <= b1 - b0; i += 32)
        bp[i] = min(max(__ldg(indptr + b0 + i), r), t1) - r;
      __syncwarp();
      if constexpr (CLOCKS) spent[0] += stamp<CLOCKS>() - t0;
#pragma unroll 1
      for (int h = 0; h < 3; ++h) {
        t0 = stamp<CLOCKS>();
        const float* hw = weights + h * P::kSize;
        if (t1 > r) {  // a tile with rows (an item of buses with no line has none)
          wide_layer<P::F, H, P::HP, true>(hw + P::kW1, hw + P::kB1, in, xa, msk, slope, lane);
          __syncwarp();
          wide_layer<H, H, P::HP, true>(hw + P::kW2, hw + P::kB2, xa, xb, msk, slope, lane);
          __syncwarp();
          wide_layer<H, L, P::LP, false>(hw + P::kW4, hw + P::kB4, xb, xa, msk, slope, lane);
          __syncwarp();
        }
        const long long t2 = stamp<CLOCKS>();
        if constexpr (CLOCKS) spent[1] += t2 - t0;
        // lane c sums columns c, c + 32, ... of each bus of the item in
        // turn: its rows of this tile in CSR order, from 0.0f at the item's
        // first tile (or from a hub bus's running sums), stored at the
        // item's last tile
        for (int i = 0; i < b1 - b0; ++i) {
          const int k0 = bp[i], k1 = bp[i + 1];
#pragma unroll 4
          for (int q = 0; q < NA; ++q) {
            const int col = lane + 32 * q;
            if (col < L) {
              float acc = r == r0 ? 0.0f : hub[h * L + col];
              for (int k = k0; k < k1; ++k) acc += xa[col * kWideRows + k];
              if (t1 == r1)
                (h == 0 ? out0 : h == 1 ? out1 : out2)[base + (long long)(b0 + i) * L + col] = acc;
              else  // a hub item (one bus): the next tile goes on
                hub[h * L + col] = acc;
            }
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

// The design's kernel (CLOCKS: the instrumented instance) and its shared
// bytes per block.
template <int L, int H, bool CLOCKS>
constexpr auto kernel_of() {
  if constexpr (kWide) return &fused_edge_kernel_wide<L, H, CLOCKS>;
  else return &fused_edge_kernel<L, H, CLOCKS>;
}

template <int L, int H>
constexpr int block_bytes() {
  if constexpr (kGlobal) return 0;
  else if constexpr (kWide) return WideLayout<L, H>::kBytes;
  else return SharedLayout<L, H>::kBytes;
}

// Workspace floats a warp of the grid takes: the workspace design's scratch,
// else none.
template <int L, int H>
constexpr long long warp_workspace() {
  if constexpr (kGlobal) return WideLayout<L, H>::kWarp;
  else return 0;
}

// Blocks of the design's kernel (kernel_of<L, H, false>) the card keeps resident per SM,
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
    constexpr int bytes = block_bytes<L, H>();
    err = cudaFuncSetAttribute(kernel_of<L, H, false>(),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel_of<L, H, true>(),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached[dev][0], kernel_of<L, H, false>(),
                                                        kThreads, bytes);
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
           long long* clocks, float* workspace, cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  cudaError_t err = residency<L, H>(&per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (kGlobal != (workspace != nullptr)) return (int)cudaErrorInvalidValue;
  const long long want = (S * T + kWarps - 1) / kWarps;
  const long long most = (long long)per_sm * sms;
  const unsigned int grid = (unsigned int)(want < most ? want : most);
  constexpr size_t bytes = block_bytes<L, H>();
#define GNS_K3_ARGS \
  m, feats, mask, order, indptr, items, row_bus, weights, out0, out1, out2, S, N, E, T, slope, clocks
  if constexpr (kWide) {
    if (clocks == nullptr)
      fused_edge_kernel_wide<L, H, false><<<grid, kThreads, bytes, stream>>>(GNS_K3_ARGS, workspace);
    else
      fused_edge_kernel_wide<L, H, true><<<grid, kThreads, bytes, stream>>>(GNS_K3_ARGS, workspace);
  } else {
    if (clocks == nullptr)
      fused_edge_kernel<L, H, false><<<grid, kThreads, bytes, stream>>>(GNS_K3_ARGS);
    else
      fused_edge_kernel<L, H, true><<<grid, kThreads, bytes, stream>>>(GNS_K3_ARGS);
  }
#undef GNS_K3_ARGS
  return (int)cudaGetLastError();
}

template <int L, int H>
int occupancy(long long* out) {
  int per_sm = 0, sms = 0;
  const cudaError_t err = residency<L, H>(&per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  out[0] = block_bytes<L, H>();
  out[1] = per_sm;
  out[2] = kThreads;
  out[3] = sms;
  out[4] = warp_workspace<L, H>() * 4;
  return 0;
}

}  // namespace

extern "C" {

// Floats of the three heads' packed weights, or -1 for a width this
// library was not built for (each width is a library of its own).
int gns_fused_edge_weight_floats(int L, int H) {
  if (L != kLatent || H != kHidden) return -1;
  return 3 * Pack<kLatent, kHidden>::kSize;
}

// out (5 int64): shared bytes per block, blocks resident per SM, threads
// per block, SMs, workspace bytes per warp (the workspace design's
// scratch, else 0). At most out[1] * out[3] blocks run (a persistent
// grid), so a `clocks` buffer, or a workspace, of out[1] * out[3] * out[2]
// / 32 warps always suffices. Returns a cudaError_t.
int gns_fused_edge_occupancy(int L, int H, long long* out) {
  if (L != kLatent || H != kHidden) return (int)cudaErrorInvalidValue;
  return occupancy<kLatent, kHidden>(out);
}

// m (S, N, L), feats (S, E, 5), mask (S, E); order / indptr (N + 1,) the
// CSR of dst; items (T, 4) the work items (first bus, end bus, first row,
// end row; 16-byte aligned) and row_bus (E,) each CSR row's bus << 1
// (ops/segment.py schedule_items); weights the
// three heads packed as Pack, on the card; out0..2 (S, N, L), 16-byte
// aligned; clocks null, or (warps of the grid, kPhases) int64 to receive
// each warp's cycles per phase; workspace null, or for the workspace
// design gns_fused_edge_occupancy's bytes per warp for every warp the grid
// can hold. (L, H) must be the library's width.
int gns_fused_edge(const float* m, const float* feats, const float* mask, const int* order,
                   const int* indptr, const int* items, const int* row_bus,
                   const float* weights, float* out0, float* out1, float* out2, long long S,
                   int N, int E, int T, int L, int H, float slope, long long* clocks,
                   float* workspace, void* stream) {
  if (L != kLatent || H != kHidden) return (int)cudaErrorInvalidValue;
  if (S == 0 || N == 0) return 0;
  if (T < 1) return (int)cudaErrorInvalidValue;
  return launch<kLatent, kHidden>(m, feats, mask, order, indptr,
                                  reinterpret_cast<const int4*>(items), row_bus, weights, out0,
                                  out1, out2, S, N, E, T, slope, clocks, workspace,
                                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
