// K4: the whole GNS forward of one grid in one block, for NVIDIA Hopper
// (sm_90a). Serving only (no backward), multiple_phi + reference_parity.
//
// Replaces the Pallas TPU kernel gns_tpu/ops/pallas_megakernel.py `_kernel`
// (:88, pallas_call :337, public megakernel_forward_batch :250). Per grid:
// state init (generator -> bus scatter, v = 1 where no generator), then K x
// (gather m[dst]; the three phi heads; masked aggregation at dst; the three
// L heads; PV freeze; the reference-parity physics refresh with the quirk-Q2
// gathers and the lambda dispatch; the gamma^(K-k) discounted loss), then
// the last loss and the v clamp. Outputs v, theta, delta_p, delta_q (S, N)
// and (total, last) loss (S, 2).
//
// Numerics, as the TPU kernel's: the MLPs take bf16 operands with float32
// accumulation and float32 bias and LeakyReLU; the physics is float32. The
// MLP products run on the tensor cores (mma.sync m16n8k16, bf16 -> f32), so
// a dot product adds in the tensor core's order, not the plain twin's
// (gns_torch/ops/megakernel.py megakernel_plain); every activation is
// rounded to bf16 where the twin rounds it. Where the TPU kernel gathered
// and summed with 0/1 incidence matmuls, split into hi + lo bf16 halves
// (_oh_dot_exact :56-63, exact only to about 2^-16 relative), this kernel
// indexes directly and sums in float32 in CSR edge order, with no atomics,
// add for add as the twin does. Built without --use_fast_math (sinf / cosf /
// division / sqrt stay IEEE-accurate) and with --fmad=false, so that the
// physics rounds after every operation as the twin does; mma is unaffected.
//
// What bounds it on an H100: at case300 (N=300, E=411, G=69), S=1024, K=4,
// L=20, H=10 the model's heads do, per step, 1650 MACs per edge (three phi
// heads: 3 (H (L + 5) + H H + L H)) and 1840 per bus (three L heads, each
// reading 4 + 2L of the 4 + 4L node inputs: 3 H (4 + 2L) + 3 H H + H (2 + L)),
// 10.08 GFLOP per batch: 10.2 us on the bf16 tensor cores (989 TFLOP/s). It
// moves about 29 MB (the grids in, the outputs out), 8.7 us at 3.35 TB/s. By
// its work it is bound by operations. The padded tiles below multiply about
// 25 GFLOP (27 mma per 16-row phi tile, 29 per 16-bus L tile), 26 us on the
// tensor cores. What sets the pace now is the work around the mma inside a
// block: building the operands from shared memory, bias + LeakyReLU + bf16
// packing in the accumulators, the per-bus float32 scan of the phi outputs,
// the physics (eight sinf / cosf and four divisions per line) and the
// block barriers, with 16 warps per SM and 27 work items on 8 warps per
// grid (so the last of four rounds runs 3 warps). chip_smoke.py reads each
// stage's share from the kernel's own clocks (gns_megakernel's `clocks`).
// What the design does:
//   * MLPs on the tensor cores, per head: a warp owns a tile of 16 edges
//     (phi) or 16 buses (L); rows and K are padded to 16, N to 8; each
//     head's hidden width is padded to whole 16-wide k-tiles (one up to H =
//     16, two up to 32), so a layer's accumulators (n-tiles 2j and 2j + 1)
//     become k-tile j of the next layer's A fragments in registers (bias,
//     LeakyReLU and the bf16 rounding applied there). The fused layout's
//     block-diagonal zeros are never multiplied: phi w2 / w4 and L w2 / w4
//     run as three per-head blocks, and each L head's first layer reads only
//     its 4 + 2L inputs (v, theta, dp, dq, m and its own phi aggregate);
//   * the weights come tile-packed from the host (ops/megakernel.py
//     pack_step_weights, once per model): B fragments in lane order, per
//     head, zero-padded, bf16, so a lane reads its fragment as one 8-byte
//     word; each step's pack is copied to shared memory as it is;
//   * the edge and node stages run per work item of whole buses
//     (ops/segment.py schedule_items at 16: at most 16 buses whose edges fill at
//     most 16 rows, or one bus of more): bus n's messages read m[n] only, so
//     one warp runs the phi heads over its buses' edges in dst-CSR order,
//     sums the masked outputs (o + b4) * line_mask per bus in that order in
//     float32 (a scan down each column, stored as bf16 at the bus's last
//     row), runs the L heads on the same buses from those bf16 aggregates
//     (the twin rounds node_in to bf16 too) and updates their state. No
//     aggregate leaves the warp and no block barrier separates the stages;
//   * about 112 KB of shared memory per case300 grid at (L, H) = (20, 10)
//     (one step's tiles, the per-bus state rows, the bus / line / generator
//     arrays, scratch that the physics and the warps' tiles share), so two
//     256-thread blocks share an SM; at (40, 10), the deep checkpoints'
//     width, 193,664 bytes, so that instance asks for one block per SM
//     (MinGrids). This is plan 0, for H <= 32 wherever a grid fits it;
//   * past that, one grid is still one block, in one of two wide plans
//     (megakernel<L, H, true>, built beside plan 0 in every library):
//     plan 1 reads each step's weight tiles from global memory
//     (ld.global.nc: a step's tiles are shared by every grid and stay in
//     the 50 MB L2; 651 KB at (128, 128)) and runs the three phi heads one
//     at a time, each followed by the L head that reads its aggregate, so a
//     warp's scratch holds one head's outputs and aggregates (Dims::
//     kWarpWide, LE columns, not 3 LE) and one head's fragments are live
//     at a time (KH up to 8 k-tiles at H = 128); a first layer runs k-tile
//     by k-tile, its n-tiles' accumulators live and one k-tile of its input
//     (up to 17 at L = 128), not the whole input; plan 2 is plan 1 with the
//     grid's state rows (v, theta, dp, dq, m: N x NBW floats) in a
//     per-grid workspace in global memory that the wrapper allocates, the
//     rest of the grid staying in shared memory. A case300 grid takes
//     157,184 bytes at (64, 32) (plan 1), 226,048 at (97, 40) (plan 1)
//     and 131,392 at (128, 128) (plan 2, whose 158 KB of state rows a grid
//     stay in L2: 132 resident grids hold 21 MB). The library picks the
//     first plan that fits (gns_megakernel_plan); a grid no plan holds is
//     refused (the wrapper raises with its bytes), never run elsewhere.
//     The wide plans do every operation plan 0 does, in the same order, so
//     at one width all three give the same bits. A thread-block cluster
//     that splits a grid's buses over 2-8 blocks (distributed shared
//     memory) was the other way past one block: its physics would read
//     v / theta at both ends of every line and its CSR sums rows written
//     by any block, remotely, with a cluster barrier at each phase and
//     cluster-wide reductions for the loss and the lambda dispatch. The
//     workspace keeps one block a grid, one code path for the physics and
//     the twin's order of adds;
//   * where the wide instance's footprint would grow without bound
//     (Dims::kPass: a hidden layer past 16 n-tiles, H > 128, whose
//     accumulators and fragments it keeps in registers, 4 NH floats a lane;
//     or its eight warps' scratch past half a block, L > 146) the wide
//     instance is the pass instance, whose registers and code do not grow
//     with the width:
//     a layer's n-tiles run in passes of kPassTiles (8: 32 accumulators a
//     lane), each pass reading its input k-tile by k-tile, a first layer's
//     built as above, a hidden layer's from the bf16 tile the layer before
//     wrote to the warp's scratch (16 x (HP + 8), two of them: act's
//     rounding, stored rather than carried in registers); the aggregate's
//     scan takes the lane's columns one at a time, its running sums in the
//     scratch; every loop over L or H is rolled past a fixed count. Each
//     sum adds its k-tiles and its rows in the register instances' order,
//     so the same bits (probe_k4_pass.py builds the pass instance where the
//     wide one is chosen, -DGNS_PASS=1, and holds the two to each other and
//     times them). Its scratch grows with the width (a warp's 16 x (LE
//     + HS) + 8.5 LE floats, 344,576 bytes a block at (256, 256)), so it
//     has plan 3 beside 1 and 2: as 2, with the warps' scratch and the
//     step's biases in the per-grid workspace too, which leaves in shared
//     memory only the grid's inputs and physics rows (about 30 KB at
//     case300 at any width). A case300 grid takes the wide instance's plan
//     2 at (129, 8) and the pass instance's plan 3 at (200, 136) and past;
//   * the aggregate's 3L columns are spread over a warp's lanes, lane c
//     summing columns c, c + 32, ... (Dims::NA of them: 2 at L = 20, 4 at
//     L = 40);
//   * operands are read from shared memory as column pairs (4-byte bf16
//     pairs, 8-byte float pairs), so at an odd L the state row's m, the phi
//     input's m and each aggregate block carry one zero column (Dims::LE),
//     which the tile plan gives zero weights;
//   * one library per width: ops/segment_kernels.py builds this file for
//     each (L, H) a caller needs (any L, H >= 1, segment_kernels.
//     check_width), with GNS_LATENT, GNS_HIDDEN and GNS_MIN_BLOCKS (grids
//     per SM plan 0's __launch_bounds__ asks for: 2 up to L = 20 with H <=
//     16, else 1; the wide plans ask for 1) on the command line;
//   * physics, CSR sums and scalar block reductions in float32, in the
//     twin's order, deterministic; each line's results are written at its
//     rows of the dst and src CSRs, so a bus sums a contiguous run.
//
// Built by gns_torch/ops/segment_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC --fmad=false
// into a shared library with a plain C interface, loaded with ctypes. The
// entry point launches on the stream it is given, allocates nothing and
// returns a cudaError_t; the Python wrapper checks shapes, types, devices
// and contiguity before it calls.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#if !defined(GNS_LATENT) || !defined(GNS_HIDDEN) || !defined(GNS_MIN_BLOCKS)
#error "built per width: nvcc -DGNS_LATENT=L -DGNS_HIDDEN=H -DGNS_MIN_BLOCKS=B (ops/segment_kernels.py)"
#endif

namespace {

constexpr int kLatent = GNS_LATENT, kHidden = GNS_HIDDEN;
static_assert(kLatent >= 1 && kHidden >= 1, "K4 takes L >= 1, H >= 1");

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxShared = 232448;  // 227 KB, the most a block may use
constexpr int kRed = 4 * 32 + 4;    // block-reduction scratch (floats)
constexpr int kRows = 16;           // rows of an mma tile
constexpr int kPassTiles = 8;       // n-tiles of a layer's pass in the pass instance
// Stages whose SM clock cycles a launch with a clocks buffer records per
// grid: inputs and state init, the step's weights, the edge and node stages,
// the physics refresh and loss (the last three summed over K steps).
constexpr int kStages = 4;

__host__ __device__ constexpr int up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr long long upll(long long x, long long m) { return (x + m - 1) / m * m; }

// Tile and bias layout of one step's pack (ops/megakernel.py _tile_plan
// builds the same). A tile is a 16 x 8 (k x n) B operand: 32 lanes x 4 bf16.
// Every tile a layer multiplies comes KH k-tiles deep where its input is a
// hidden layer (tile (..., kt) at index (...) * KH + kt).
template <int L, int H>
struct Dims {
  static constexpr int LE = up(L, 2);          // m, and each aggregate block, in column pairs
  static constexpr int NBW = 4 + LE;           // a bus's state row: v, theta, dp, dq, m
  static constexpr int HP = up(H, 16);         // a head's hidden width, padded
  static constexpr int KH = HP / 16;           // k-tiles of a hidden layer, as an input
  static constexpr int NH = HP / 8;            // n-tiles of a hidden layer
  static constexpr int LP = up(L, 8);          // a phi head's output, padded
  static constexpr int NL = LP / 8;
  static constexpr int PF = LE + 5;            // phi input: m, then the line features
  static constexpr int KP = up(PF, 16) / 16;   // k-tiles of phi's first layer
  static constexpr int LI = NBW + LE;          // one L head's input: the state row, its aggregate
  static constexpr int KL = up(LI, 16) / 16;   // k-tiles of L's first layer
  static constexpr int tPW1 = 0, tPW2 = tPW1 + 3 * NH * KP, tPW4 = tPW2 + 3 * NH * KH;
  static constexpr int tLW1 = tPW4 + 3 * NL * KH, tLW2 = tLW1 + 3 * NH * KL;
  static constexpr int tLW4 = tLW2 + 3 * NH * KH;
  static constexpr int kTiles = tLW4 + (2 + NL) * KH;  // L_theta, L_v: one n-tile each
  static constexpr int bPB1 = 0, bPB2 = bPB1 + 3 * HP, bPB4 = bPB2 + 3 * HP;
  static constexpr int bLB1 = bPB4 + 3 * LP, bLB2 = bLB1 + 3 * HP, bLB4 = bLB2 + 3 * HP;
  static constexpr int kBias = bLB4 + 16 + LP;  // L_theta, L_v: 8 each, then L_m
  // a row of the phi outputs and of the aggregate: three blocks of LE
  static constexpr int AW = 3 * LE;
  // aggregate columns per lane: lane c sums columns c, c + 32, ... of AW
  static constexpr int NA = (AW + 31) / 32;
  // one warp's scratch (floats): a tile's phi outputs (16 x AW f32), the
  // rows' aggregate slots (16 ints), the item's buses' aggregates and a
  // spare row (17 x AW bf16)
  static constexpr int kWarp = kRows * AW + kRows + (kRows + 1) * AW / 2;
  // the wide plans' per-warp scratch, one head at a time: the same with LE
  // columns for AW, and NA1 aggregate columns a lane
  static constexpr int kWarpWide = kRows * LE + kRows + (kRows + 1) * LE / 2;
  static constexpr int NA1 = (LE + 31) / 32;
  // whether plan 0 (tiles and three heads' scratch in shared memory) is
  // built: for H <= 32, where its tiles and scratch can fit a block at all
  static constexpr bool kPlan0 = H <= 32 && kTiles * 256LL + kWarps * kWarp * 4LL <= kMaxShared;
  // whether the wide instance is the pass instance: where the wide one
  // would keep more than 16 n-tiles of a hidden layer live (4 NH floats a
  // lane of accumulators, as many of fragments: 64 at H = 128, where it
  // already spills) or its warps' scratch would take more than half a
  // block (L > 146), the other half left for the grid's own rows under
  // plan 2. The pass instance runs a layer's n-tiles in passes of
  // kPassTiles and puts a hidden layer's bf16 output in the warp's scratch
  // (16 x HS, HS = HP + 8 columns, a row padded off the banks of the
  // next), which adds the running column sums (LE) and two such tiles to
  // kWarpWide's. -DGNS_PASS=1 builds the pass instance at any width
  // (probe_k4_pass.py).
#if defined(GNS_PASS) && GNS_PASS
  static constexpr bool kPass = true;
#else
  static constexpr bool kPass = NH > 16 || kWarps * kWarpWide * 4 > kMaxShared / 2;
#endif
  static constexpr int HS = HP + 8;
  static constexpr int kWarpPass = kRows * LE + kRows + (kRows + 1) * LE / 2 + LE + kRows * HS;
  static constexpr int kWarpW = kPass ? kWarpPass : kWarpWide;  // the wide instance's scratch
  // the last plan: 3, the warps' scratch and the biases in the workspace
  // too, in the pass instance only
  static constexpr int kLastPlan = kPass ? 3 : 2;
  static_assert(kBias % 4 == 0, "biases are copied as float4");
  static_assert(bPB2 % 2 == 0 && bPB4 % 2 == 0 && bLB1 % 2 == 0 && bLB2 % 2 == 0 && HP % 2 == 0,
                "bias pairs are read as float2");
};

// Byte offsets of one grid's shared memory under a plan: 0, the step's
// tiles, the three heads' warp scratch and the state rows in shared memory;
// 1, tiles read from L2, one head's scratch; 2, as 1 with the state rows in
// the global workspace (none in shared memory); 3 (the pass instance), as
// 2 with the warps' scratch and the step's biases in global memory too.
template <int L, int H>
struct Layout {
  long long b, u, m, f, lf, total;
  __host__ __device__ Layout(int N, int E, int G, int plan) {
    using D = Dims<L, H>;
    b = plan == 0 ? (long long)D::kTiles * 256 : 0;  // plan 0: the step's tiles come first
    u = b + (plan == 3 ? 0 : upll(D::kBias * 4LL, 16));
    const long long warps = plan == 3 ? 0 : (long long)kWarps * (plan == 0 ? D::kWarp : D::kWarpW) * 4;
    const long long phys = 5LL * E * 4;
    m = u + upll(warps > phys ? warps : phys, 16);
    f = m + (plan >= 2 ? 0 : upll((long long)N * D::NBW * 4, 16));
    lf = f + upll((6LL * N + 5LL * E + 5LL * G + kRed) * 4, 16);
    total = lf + upll(6LL * E * 2, 16);
  }
};

// Floats of one grid's workspace under a plan: plan 2 its state rows (N x
// NBW), plan 3 those (padded to 16 bytes), then its warps' scratch; else 0.
template <int L, int H>
__host__ __device__ long long workspace_floats(int N, int plan) {
  using D = Dims<L, H>;
  if (plan == 2) return (long long)N * D::NBW;
  if (plan == 3) return upll((long long)N * D::NBW, 4) + upll((long long)kWarps * D::kWarpPass, 4);
  return 0;
}

// LeakyReLU for a slope in [0, 1] (the wrapper checks): max(x, slope x)
// picks x where x >= 0 and slope x below 0, as x >= 0 ? x : slope x does.
__device__ __forceinline__ float lrelu(float x, float slope) { return fmaxf(x, slope * x); }

// Two floats rounded to bf16, the lower column in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The accumulators of n-tile `half` (0 or 1) of a 16-wide hidden layer, plus
// bias (b[col], b[col + 1]), through LeakyReLU and rounded to bf16, as half
// of the next layer's A fragment: rows g (a[2 half]) and g + 8 (a[2 half + 1]).
__device__ __forceinline__ void act(uint32_t (&a)[4], int half, const float (&c)[4],
                                    const float* b, int col, float slope) {
  const float2 bb = *reinterpret_cast<const float2*>(b + col);  // col is even, b 8-byte aligned
  a[2 * half] = pack2(lrelu(c[0] + bb.x, slope), lrelu(c[1] + bb.y, slope));
  a[2 * half + 1] = pack2(lrelu(c[2] + bb.x, slope), lrelu(c[3] + bb.y, slope));
}

// ---- the pass instance's layers (Dims::kPass) ----
// A (16 x 16) A fragment of k-tile kt from a warp's bf16 scratch tile h (16
// rows, row stride hs): rows g and g + 8, columns 16 kt + 2 tq (+ 8), as a
// hidden layer's outputs are chained into the next layer in registers.
__device__ __forceinline__ void frag(uint32_t (&x)[4], const __nv_bfloat16* h, int hs, int kt, int g,
                                     int tq) {
  const int c = kt * 16 + 2 * tq;
  x[0] = *reinterpret_cast<const uint32_t*>(h + g * hs + c);
  x[1] = *reinterpret_cast<const uint32_t*>(h + (g + 8) * hs + c);
  x[2] = *reinterpret_cast<const uint32_t*>(h + g * hs + c + 8);
  x[3] = *reinterpret_cast<const uint32_t*>(h + (g + 8) * hs + c + 8);
}

// One pass of a layer: for n-tiles nt0 + j < n_out (j < kPassTiles),
// c[j] = the sum over k-tiles kt < k_in, in order, of A(kt) . tile(first +
// (nt0 + j) k_in + kt), A(kt) read by in(kt, x): each sum adds its k-tiles
// in the order the register instances do.
template <class In, class Tile>
__device__ __forceinline__ void pass_mma(float (&c)[kPassTiles][4], In in, Tile tile, int first,
                                         int k_in, int nt0, int n_out) {
#pragma unroll
  for (int j = 0; j < kPassTiles; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[j][q] = 0.0f;
#pragma unroll 2
  for (int kt = 0; kt < k_in; ++kt) {
    uint32_t x[4];
    in(kt, x);
#pragma unroll
    for (int j = 0; j < kPassTiles; ++j)
      if (nt0 + j < n_out) mma(c[j], x, tile(first + (nt0 + j) * k_in + kt));
  }
}

// A hidden layer of n_out n-tiles in passes: each output through bias b,
// LeakyReLU and bf16 (act) into the warp's scratch tile out (16 x hs).
template <class In, class Tile>
__device__ __forceinline__ void hidden_pass(In in, Tile tile, int first, int k_in, int n_out,
                                            const float* b, float slope, __nv_bfloat16* out, int hs,
                                            int g, int tq) {
#pragma unroll 1
  for (int nt0 = 0; nt0 < n_out; nt0 += kPassTiles) {
    float c[kPassTiles][4];
    pass_mma(c, in, tile, first, k_in, nt0, n_out);
#pragma unroll
    for (int j = 0; j < kPassTiles; ++j) {
      if (nt0 + j < n_out) {
        const int col = (nt0 + j) * 8 + 2 * tq;
        uint32_t a[4];
        act(a, 0, c[j], b, col, slope);
        *reinterpret_cast<uint32_t*>(out + g * hs + col) = a[0];
        *reinterpret_cast<uint32_t*>(out + (g + 8) * hs + col) = a[1];
      }
    }
  }
}

// Sum NV per-thread values over the block; every thread gets the totals.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < NV; ++k) red[warp * NV + k] = v[k];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float x = lane < kWarps ? red[lane * NV + k] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
      if (lane == 0) red[32 * NV + k] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = red[32 * NV + k];
}

struct Topo {
  const int *src, *dst, *srcq, *dstq;   // (E,): bus ids, and bus ids as line rows (Q2)
  const int *dst_order, *dst_indptr;    // CSR of the edges by dst
  const int* src_indptr;                // CSR of the edges by src (its row pointers)
  const int *gen_order, *gen_indptr;    // CSR of the generators by bus
  const int *dst_pos, *src_pos;         // (E,): each line's row in the dst / src CSR
  const int* gen_pos;                   // (G,): each generator's row in its CSR
  const int4* items;                    // (T,): work items (first bus, end bus, first row, end row)
  const int* row_bus;                   // (E,) per dst-CSR row: bus << 1 | last row of its bus
  int n_items;
};

// Grids resident per SM that the kernel's __launch_bounds__ asks for: two
// at L = 20 (114,176 bytes per case300 grid), one at L = 40 (193,664).
constexpr int kMinGrids = GNS_MIN_BLOCKS;

// Wide = false: plan 0; true: plans 1 (ws null) and 2 (ws the workspace,
// (S, N, NBW) float32).
template <int L, int H, bool Wide>
__global__ void __launch_bounds__(kThreads, Wide ? 1 : kMinGrids) megakernel(
    const float* __restrict__ buses, const float* __restrict__ lines,
    const float* __restrict__ gens, const float* __restrict__ bus_mask,
    const float* __restrict__ line_mask, const float* __restrict__ gen_mask, Topo tp,
    const __nv_bfloat16* __restrict__ wpack, const float* __restrict__ bpack,
    const float* __restrict__ disc, float* __restrict__ v_out, float* __restrict__ th_out,
    float* __restrict__ dp_out, float* __restrict__ dq_out, float* __restrict__ loss_out,
    long long* __restrict__ clocks, float* ws, int N, int E, int G, int K, float slope, int plan) {
  using D = Dims<L, H>;
  extern __shared__ uint4 smem16[];
  const Layout<L, H> lay(N, E, G, plan);
  char* base = reinterpret_cast<char*>(smem16);
  const uint2* WT = reinterpret_cast<const uint2*>(base);  // tile t, lane l: WT[t * 32 + l]
  float* BIAS = reinterpret_cast<float*>(base + lay.b);
  float* U = reinterpret_cast<float*>(base + lay.u);       // staging, then physics rows
  float* NB = reinterpret_cast<float*>(base + lay.m);  // (N, 4 + L): v, theta, dp, dq, m
  float* scratch = U;  // the wide instance's warps' scratch
  if constexpr (Wide) {
    if (plan >= 2) {  // plans 2 and 3: the state rows in the workspace
      NB = ws + blockIdx.x * workspace_floats<L, H>(N, plan);
      if (plan == 3) scratch = NB + upll((long long)N * D::NBW, 4);  // and the warps' scratch
    }
  }
  const auto V = [NB](int n) -> float& { return NB[n * D::NBW]; };
  const auto TH = [NB](int n) -> float& { return NB[n * D::NBW + 1]; };
  const auto DP = [NB](int n) -> float& { return NB[n * D::NBW + 2]; };
  const auto DQ = [NB](int n) -> float& { return NB[n * D::NBW + 3]; };
  const auto M = [NB](int n, int l) -> float& { return NB[n * D::NBW + 4 + l]; };
  float* PD = reinterpret_cast<float*>(base + lay.f);
  float* QD = PD + N;
  float* GS = QD + N;
  float* BSH = GS + N;
  float* BM = BSH + N;
  float* ISG = BM + N;
  float* LM = ISG + N;
  float* Y = LM + E;       // per line: 1 / |z|, tau, shift, b (the Q2 gathers read them)
  float* TAU = Y + E;
  float* SH = TAU + E;
  float* BB = SH + E;
  float* PGS = BB + E;     // masked Pg_set, Pmin, Pmax, the mask, the new Pg
  float* PMN = PGS + G;
  float* PMX = PMN + G;
  float* GM = PMX + G;
  float* PGN = GM + G;
  float* RED = PGN + G;
  // (E, 6) bf16: the line features r, x, b, tau, shift, then a zero column
  __nv_bfloat16* LF = reinterpret_cast<__nv_bfloat16*>(base + lay.lf);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;  // mma fragment row group, column pair
  const long long s = blockIdx.x;
  // Stage clocks (only with a clocks buffer): thread 0 reads clock64() after
  // each stage's closing barrier, so a stage's count is its slowest warp's.
  const bool timed = clocks != nullptr && threadIdx.x == 0;
  long long cyc[kStages] = {0, 0, 0, 0};
  long long tick = timed ? clock64() : 0;
  const auto mark = [&](int stage) {
    if (timed) {
      const long long now = clock64();
      cyc[stage] += now - tick;
      tick = now;
    }
  };
  const float* bus = buses + s * N * 6;
  const float* lin = lines + s * E * 7;
  const float* gen = gens + s * G * 7;

  // ---- per-grid inputs into shared memory ----
  for (int n = threadIdx.x; n < N; n += kThreads) {
    PD[n] = bus[n * 6 + 2];
    QD[n] = bus[n * 6 + 3];
    GS[n] = bus[n * 6 + 4];
    BSH[n] = bus[n * 6 + 5];
    BM[n] = bus_mask[s * N + n];
  }
  for (int e = threadIdx.x; e < E; e += kThreads) {
    const float* l = lin + e * 7;
#pragma unroll
    for (int j = 0; j < 6; ++j) LF[e * 6 + j] = __float2bfloat16_rn(j < 5 ? l[2 + j] : 0.0f);
    LM[e] = line_mask[s * E + e];
    const float r = l[2], x = l[3];
    const float z2 = r * r + x * x;
    Y[e] = 1.0f / sqrtf(z2);
    TAU[e] = l[5];
    SH[e] = l[6];
    BB[e] = l[4];
  }
  for (int i = threadIdx.x; i < G; i += kThreads) {
    const float gm = gen_mask[s * G + i];
    PGS[i] = gen[i * 7 + 3] * gm;
    PMN[i] = gen[i * 7 + 2] * gm;
    PMX[i] = gen[i * 7 + 1] * gm;
    GM[i] = gm;
  }
  __syncthreads();

  // ---- state init (main.py:141-153): generator sums per bus, CSR order ----
  for (int n = threadIdx.x; n < N; n += kThreads) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    for (int j = tp.gen_indptr[n]; j < tp.gen_indptr[n + 1]; ++j) {
      const int i = tp.gen_order[j];
      a0 += gen[i * 7 + 4] * GM[i];
      a1 += gen[i * 7 + 6] * GM[i];
      a2 += gen[i * 7 + 5] * GM[i];
      a3 += GM[i];
    }
    const float v = a0 == 0.0f ? 1.0f : a0;
    const float v2 = v * v;
    V(n) = v;
    ISG[n] = a3 > 0.0f ? 1.0f : 0.0f;
    TH(n) = 0.0f;
    DP(n) = (a1 - PD[n]) - GS[n] * v2;
    DQ(n) = (a2 - QD[n]) + BSH[n] * v2;
    if constexpr (D::kPass) {
      for (int l = 0; l < D::LE; ++l) M(n, l) = 0.0f;  // a zero column past an odd L
    } else {
#pragma unroll
      for (int l = 0; l < D::LE; ++l) M(n, l) = 0.0f;
    }
  }
  float sums[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // n_real, s_set, s_min, s_max
  for (int n = threadIdx.x; n < N; n += kThreads) sums[0] += BM[n];
  for (int i = threadIdx.x; i < G; i += kThreads) {
    sums[1] += PGS[i];
    sums[2] += PMN[i];
    sums[3] += PMX[i];
  }
  block_sum<4>(sums, RED);
  mark(0);
  const float n_real = sums[0], s_set = sums[1], s_min = sums[2], s_max = sums[3];
  float total_loss = 0.0f, last_loss = 0.0f;

  for (int k = 0; k < K; ++k) {
    // ---- this step's tiles and biases, as packed ----
    {
      if constexpr (!Wide) {  // the wide plans read the tiles from global memory
        const uint4* wsrc = reinterpret_cast<const uint4*>(wpack + (long long)k * D::kTiles * 128);
        for (int i = threadIdx.x; i < D::kTiles * 16; i += kThreads) smem16[i] = wsrc[i];
      }
      const float4* bsrc = reinterpret_cast<const float4*>(bpack + (long long)k * D::kBias);
      if (!D::kPass || plan != 3)  // plan 3 reads the biases from global memory
        for (int i = threadIdx.x; i < D::kBias / 4; i += kThreads)
          reinterpret_cast<float4*>(BIAS)[i] = bsrc[i];
    }
    __syncthreads();
    mark(1);

    // ---- edge and node stages, per work item of whole buses ----
    // Bus n's messages read m[n] only (phi's input is m[dst]), so a warp runs
    // the phi heads over its buses' edges, sums them, then runs the L heads
    // on the same buses and updates their state, with no block barrier.
    if constexpr (Wide && D::kPass) {
      // ---- the pass instance (Dims::kPass): the wide plans' order of
      // work, each layer's n-tiles in passes of kPassTiles, a hidden layer's
      // output through the warp's scratch; tiles from global memory (L2),
      // the biases from global memory too under plan 3 ----
      const uint2* WG = reinterpret_cast<const uint2*>(wpack + (long long)k * D::kTiles * 128);
      const auto tile = [WG, lane](int t) { return __ldg(WG + t * 32 + lane); };
      const float* bias = plan == 3 ? bpack + (long long)k * D::kBias : BIAS;
      float* stage = scratch + warp * D::kWarpPass;  // (16, LE) f32: a tile's masked outputs of one phi head
      int* sofs = reinterpret_cast<int*>(stage + kRows * D::LE);  // (16,): slot of the bus ending at row r, or -1
      // (16 + 1, LE): the buses' bf16(agg) of one head, then a spare row
      __nv_bfloat16* aggw = reinterpret_cast<__nv_bfloat16*>(sofs + kRows);
      float* carry = reinterpret_cast<float*>(aggw + (kRows + 1) * D::LE);  // (LE,): the bus in progress
      __nv_bfloat16* hA = reinterpret_cast<__nv_bfloat16*>(carry + D::LE);  // (16, HS): layer 1's output
      __nv_bfloat16* hB = hA + kRows * D::HS;                               // (16, HS): layer 2's output
      const auto from_a = [hA, g, tq](int kt, uint32_t (&x)[4]) { frag(x, hA, D::HS, kt, g, tq); };
      const auto from_b = [hB, g, tq](int kt, uint32_t (&x)[4]) { frag(x, hB, D::HS, kt, g, tq); };
      for (int it = warp; it < tp.n_items; it += kWarps) {
        const int4 item = tp.items[it];
        const int b0 = item.x, b1 = item.y, r0 = item.z, r1 = item.w;
        const int sa = b0 + g, sb = sa + 8;  // the L tile's buses: rows g, g + 8
        const bool ua = sa < b1, ub = sb < b1;
        float o0[2], o1[2];  // column 0 of L_theta's and L_v's outputs
#pragma unroll 1
        for (int p = 0; p < 3; ++p) {  // phi_v, phi_theta, phi_m
          __syncwarp();  // the last reads of aggw (an L head's inputs) are done
          for (int i = lane; i < kRows * D::LE / 2; i += 32) reinterpret_cast<uint32_t*>(aggw)[i] = 0u;
          for (int c = lane; c < D::LE; c += 32) carry[c] = 0.0f;
          for (int row0 = r0; row0 < r1; row0 += kRows) {
            const int rows = min(kRows, r1 - row0);
            const int my_e = lane < rows ? tp.dst_order[row0 + lane] : 0;
            const int my_be = lane < rows ? tp.row_bus[row0 + lane] : 0;
            if (lane < kRows) sofs[lane] = lane < rows && (my_be & 1) ? (my_be >> 1) - b0 : -1;
            const bool va = g < rows, vb = g + 8 < rows;
            const int ea = __shfl_sync(0xffffffffu, my_e, g), eb = __shfl_sync(0xffffffffu, my_e, g + 8);
            const int na = __shfl_sync(0xffffffffu, my_be, g) >> 1;
            const int nb = __shfl_sync(0xffffffffu, my_be, g + 8) >> 1;
            const float lma = va ? LM[ea] : 0.0f, lmb = vb ? LM[eb] : 0.0f;
            // layer 1's input k-tile kt, as plan 0 builds it: bf16(m[dst]),
            // bf16(line features), zero-padded
            const auto phi_in = [&](int kt, uint32_t (&x)[4]) {
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const bool hi = r & 1;
                const int n = hi ? nb : na, e = hi ? eb : ea;
                const int c = kt * 16 + (r >> 1) * 8 + 2 * tq;
                uint32_t w = 0u;
                if (c < D::LE) {
                  const float2 q = *reinterpret_cast<const float2*>(&M(n, c));
                  w = pack2(q.x, q.y);
                } else if (c < D::LE + 6) {
                  w = *reinterpret_cast<const uint32_t*>(LF + e * 6 + c - D::LE);
                }
                x[r] = (hi ? vb : va) ? w : 0u;
              }
            };
            hidden_pass(phi_in, tile, D::tPW1 + p * D::NH * D::KP, D::KP, D::NH,
                        bias + D::bPB1 + p * D::HP, slope, hA, D::HS, g, tq);
            __syncwarp();
            hidden_pass(from_a, tile, D::tPW2 + p * D::NH * D::KH, D::KH, D::NH,
                        bias + D::bPB2 + p * D::HP, slope, hB, D::HS, g, tq);
            __syncwarp();
            const float* b4 = bias + D::bPB4 + p * D::LP;
#pragma unroll 1
            for (int nt0 = 0; nt0 < D::NL; nt0 += kPassTiles) {
              float c[kPassTiles][4];
              pass_mma(c, from_b, tile, D::tPW4 + p * D::NL * D::KH, D::KH, nt0, D::NL);
#pragma unroll
              for (int j = 0; j < kPassTiles; ++j) {
#pragma unroll
                for (int jj = 0; jj < 2; ++jj) {
                  const int col = (nt0 + j) * 8 + 2 * tq + jj;
                  if (nt0 + j < D::NL && col < D::LE) {
                    stage[g * D::LE + col] = (c[j][jj] + b4[col]) * lma;
                    stage[(g + 8) * D::LE + col] = (c[j][2 + jj] + b4[col]) * lmb;
                  }
                }
              }
            }
            __syncwarp();
            // the aggregate of this head, as plan 0's scan over its block,
            // a column of the lane's at a time, the bus in progress carried
#pragma unroll 1
            for (int c = lane; c < D::LE; c += 32) {
              float acc = carry[c];
#pragma unroll
              for (int r = 0; r < kRows; ++r) {
                const int slot = sofs[r];
                const int at = (slot >= 0 ? slot : kRows) * D::LE;
                acc += stage[r * D::LE + c];
                aggw[at + c] = __float2bfloat16_rn(acc);
                acc = slot >= 0 ? 0.0f : acc;
              }
              carry[c] = acc;
            }
            __syncwarp();
          }
          __syncwarp();  // the aggregates (zero for a bus with no line) are in

          // the L head that reads this phi head's aggregate block
          const int h = p == 0 ? 1 : (p == 1 ? 0 : 2);  // L_v <- phi_v, L_theta <- phi_theta, L_m <- phi_m
          // layer 1's input k-tile kt: the state row, then the head's aggregate block
          const auto l_in = [&](int kt, uint32_t (&x)[4]) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int c = kt * 16 + (r >> 1) * 8 + 2 * tq;
              const int n = r & 1 ? sb : sa, slot = r & 1 ? g + 8 : g;
              uint32_t w = 0u;
              if (c < D::NBW) {
                if (r & 1 ? ub : ua) {
                  const float2 q = *reinterpret_cast<const float2*>(NB + n * D::NBW + c);
                  w = pack2(q.x, q.y);
                }
              } else if (c < D::LI) {  // rows past the item's buses hold zeros
                w = *reinterpret_cast<const uint32_t*>(aggw + slot * D::LE + c - D::NBW);
              }
              x[r] = w;
            }
          };
          hidden_pass(l_in, tile, D::tLW1 + h * D::NH * D::KL, D::KL, D::NH,
                      bias + D::bLB1 + h * D::HP, slope, hA, D::HS, g, tq);
          __syncwarp();  // every lane has read its rows' state before L_m updates m
          hidden_pass(from_a, tile, D::tLW2 + h * D::NH * D::KH, D::KH, D::NH,
                      bias + D::bLB2 + h * D::HP, slope, hB, D::HS, g, tq);
          __syncwarp();
          if (h < 2) {
            float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
            for (int kt = 0; kt < D::KH; ++kt) {
              uint32_t x[4];
              from_b(kt, x);
              mma(c, x, tile(D::tLW4 + h * D::KH + kt));
            }
            if (h == 0) {
              o0[0] = c[0];
              o0[1] = c[2];
            } else {
              o1[0] = c[0];
              o1[1] = c[2];
            }
          } else {  // L_m, the last head: m is read no more in this item
            const float* b4 = bias + D::bLB4;
#pragma unroll 1
            for (int nt0 = 0; nt0 < D::NL; nt0 += kPassTiles) {
              float c[kPassTiles][4];
              pass_mma(c, from_b, tile, D::tLW4 + 2 * D::KH, D::KH, nt0, D::NL);
#pragma unroll
              for (int j = 0; j < kPassTiles; ++j) {
#pragma unroll
                for (int jj = 0; jj < 2; ++jj) {
                  const int col = (nt0 + j) * 8 + 2 * tq + jj;
                  if (nt0 + j < D::NL && col < L) {
                    const float b = b4[16 + col];
                    if (ua) M(sa, col) = M(sa, col) + (c[j][jj] + b);
                    if (ub) M(sb, col) = M(sb, col) + (c[j][2 + jj] + b);
                  }
                }
              }
            }
          }
        }
        const float* b4 = bias + D::bLB4;
        if (tq == 0) {  // column 0 of L_theta's and L_v's outputs; PV freeze
          if (ua) {
            TH(sa) = TH(sa) + (o0[0] + b4[0]);
            if (ISG[sa] == 0.0f) V(sa) = V(sa) + (o1[0] + b4[8]);
          }
          if (ub) {
            TH(sb) = TH(sb) + (o0[1] + b4[0]);
            if (ISG[sb] == 0.0f) V(sb) = V(sb) + (o1[1] + b4[8]);
          }
        }
      }
    } else if constexpr (Wide) {
      // ---- the wide plans: per phi head, then the L head reading its
      // aggregate; tiles from global memory (L2) ----
      const uint2* WG = reinterpret_cast<const uint2*>(wpack + (long long)k * D::kTiles * 128);
      const auto tile = [WG, lane](int t) { return __ldg(WG + t * 32 + lane); };
      float* stage = U + warp * D::kWarpWide;  // (16, LE) f32: a tile's masked outputs of one phi head
      int* sofs = reinterpret_cast<int*>(stage + kRows * D::LE);  // (16,): slot of the bus ending at row r, or -1
      // (16 + 1, LE): the buses' bf16(agg) of one head, then a spare row
      __nv_bfloat16* aggw = reinterpret_cast<__nv_bfloat16*>(sofs + kRows);
      for (int it = warp; it < tp.n_items; it += kWarps) {
        const int4 item = tp.items[it];
        const int b0 = item.x, b1 = item.y, r0 = item.z, r1 = item.w;
        const int sa = b0 + g, sb = sa + 8;  // the L tile's buses: rows g, g + 8
        const bool ua = sa < b1, ub = sb < b1;
        float o0[2], o1[2];  // column 0 of L_theta's and L_v's outputs
#pragma unroll 1
        for (int p = 0; p < 3; ++p) {  // phi_v, phi_theta, phi_m
          __syncwarp();  // the last reads of aggw (an L head's inputs) are done
          for (int i = lane; i < kRows * D::LE / 2; i += 32) reinterpret_cast<uint32_t*>(aggw)[i] = 0u;
          float acc[D::NA1];  // columns lane + 32 j: the bus in progress
#pragma unroll
          for (int j = 0; j < D::NA1; ++j) acc[j] = 0.0f;
          for (int row0 = r0; row0 < r1; row0 += kRows) {
            const int rows = min(kRows, r1 - row0);
            const int my_e = lane < rows ? tp.dst_order[row0 + lane] : 0;
            const int my_be = lane < rows ? tp.row_bus[row0 + lane] : 0;
            if (lane < kRows) sofs[lane] = lane < rows && (my_be & 1) ? (my_be >> 1) - b0 : -1;
            const bool va = g < rows, vb = g + 8 < rows;
            const int ea = __shfl_sync(0xffffffffu, my_e, g), eb = __shfl_sync(0xffffffffu, my_e, g + 8);
            const int na = __shfl_sync(0xffffffffu, my_be, g) >> 1;
            const int nb = __shfl_sync(0xffffffffu, my_be, g + 8) >> 1;
            const float lma = va ? LM[ea] : 0.0f, lmb = vb ? LM[eb] : 0.0f;
            // layer 1 k-tile by k-tile, every n-tile's accumulators live and
            // one k-tile of the input (as plan 0: bf16(m[dst]), bf16(line
            // features)): each sum still adds its k-tiles in order
            float acc1[D::NH][4];
#pragma unroll
            for (int nt = 0; nt < D::NH; ++nt)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc1[nt][q] = 0.0f;
#pragma unroll
            for (int kt = 0; kt < D::KP; ++kt) {
              uint32_t x[4];
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const bool hi = r & 1;
                const int n = hi ? nb : na, e = hi ? eb : ea;
                const int c = kt * 16 + (r >> 1) * 8 + 2 * tq;
                uint32_t w = 0u;
                if (c < D::LE) {
                  const float2 q = *reinterpret_cast<const float2*>(&M(n, c));
                  w = pack2(q.x, q.y);
                } else if (c < D::LE + 6) {
                  w = *reinterpret_cast<const uint32_t*>(LF + e * 6 + c - D::LE);
                }
                x[r] = (hi ? vb : va) ? w : 0u;
              }
#pragma unroll
              for (int nt = 0; nt < D::NH; ++nt)
                mma(acc1[nt], x, tile(D::tPW1 + (p * D::NH + nt) * D::KP + kt));
            }
            uint32_t h1[D::KH][4], h2[D::KH][4];
#pragma unroll
            for (int nt = 0; nt < D::NH; ++nt)
              act(h1[nt / 2], nt % 2, acc1[nt], BIAS + D::bPB1 + p * D::HP, nt * 8 + 2 * tq, slope);
#pragma unroll
            for (int nt = 0; nt < D::NH; ++nt) {
              float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
              for (int kt = 0; kt < D::KH; ++kt) mma(c, h1[kt], tile(D::tPW2 + (p * D::NH + nt) * D::KH + kt));
              act(h2[nt / 2], nt % 2, c, BIAS + D::bPB2 + p * D::HP, nt * 8 + 2 * tq, slope);
            }
            const float* b4 = BIAS + D::bPB4 + p * D::LP;
#pragma unroll
            for (int nt = 0; nt < D::NL; ++nt) {
              float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
              for (int kt = 0; kt < D::KH; ++kt) mma(c, h2[kt], tile(D::tPW4 + (p * D::NL + nt) * D::KH + kt));
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int col = nt * 8 + 2 * tq + j;
                if (col < D::LE) {
                  stage[g * D::LE + col] = (c[j] + b4[col]) * lma;
                  stage[(g + 8) * D::LE + col] = (c[2 + j] + b4[col]) * lmb;
                }
              }
            }
            __syncwarp();
            // the aggregate of this head, as plan 0's scan over its block
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const int slot = sofs[r];
              const int at = (slot >= 0 ? slot : kRows) * D::LE;
#pragma unroll
              for (int j = 0; j < D::NA1; ++j) {
                const int col = 32 * j + lane;
                if (32 * (j + 1) <= D::LE || col < D::LE) {
                  acc[j] += stage[r * D::LE + col];
                  aggw[at + col] = __float2bfloat16_rn(acc[j]);
                  acc[j] = slot >= 0 ? 0.0f : acc[j];
                }
              }
            }
            __syncwarp();
          }
          __syncwarp();  // the aggregates (zero for a bus with no line) are in

          // the L head that reads this phi head's aggregate block
          const int h = p == 0 ? 1 : (p == 1 ? 0 : 2);  // L_v <- phi_v, L_theta <- phi_theta, L_m <- phi_m
          // layer 1 k-tile by k-tile, as the phi head's: one k-tile of the
          // input (the state row, then the head's aggregate block) at a time
          float acc1[D::NH][4];
#pragma unroll
          for (int nt = 0; nt < D::NH; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc1[nt][q] = 0.0f;
#pragma unroll
          for (int kt = 0; kt < D::KL; ++kt) {
            uint32_t x[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int c = kt * 16 + (r >> 1) * 8 + 2 * tq;
              const int n = r & 1 ? sb : sa, slot = r & 1 ? g + 8 : g;
              uint32_t w = 0u;
              if (c < D::NBW) {
                if (r & 1 ? ub : ua) {
                  const float2 q = *reinterpret_cast<const float2*>(NB + n * D::NBW + c);
                  w = pack2(q.x, q.y);
                }
              } else if (c < D::LI) {  // rows past the item's buses hold zeros
                w = *reinterpret_cast<const uint32_t*>(aggw + slot * D::LE + c - D::NBW);
              }
              x[r] = w;
            }
#pragma unroll
            for (int nt = 0; nt < D::NH; ++nt)
              mma(acc1[nt], x, tile(D::tLW1 + (h * D::NH + nt) * D::KL + kt));
          }
          __syncwarp();  // every lane has read its rows' state before L_m updates m
          uint32_t h1[D::KH][4], h2[D::KH][4];
#pragma unroll
          for (int nt = 0; nt < D::NH; ++nt)
            act(h1[nt / 2], nt % 2, acc1[nt], BIAS + D::bLB1 + h * D::HP, nt * 8 + 2 * tq, slope);
#pragma unroll
          for (int nt = 0; nt < D::NH; ++nt) {
            float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int kt = 0; kt < D::KH; ++kt) mma(c, h1[kt], tile(D::tLW2 + (h * D::NH + nt) * D::KH + kt));
            act(h2[nt / 2], nt % 2, c, BIAS + D::bLB2 + h * D::HP, nt * 8 + 2 * tq, slope);
          }
          if (h < 2) {
            float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int kt = 0; kt < D::KH; ++kt) mma(c, h2[kt], tile(D::tLW4 + h * D::KH + kt));
            if (h == 0) {
              o0[0] = c[0];
              o0[1] = c[2];
            } else {
              o1[0] = c[0];
              o1[1] = c[2];
            }
          } else {  // L_m, the last head: m is read no more in this item
            const float* b4 = BIAS + D::bLB4;
#pragma unroll
            for (int nt = 0; nt < D::NL; ++nt) {
              float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
              for (int kt = 0; kt < D::KH; ++kt) mma(c, h2[kt], tile(D::tLW4 + (2 + nt) * D::KH + kt));
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int col = nt * 8 + 2 * tq + j;
                if (col < L) {
                  const float b = b4[16 + col];
                  if (ua) M(sa, col) = M(sa, col) + (c[j] + b);
                  if (ub) M(sb, col) = M(sb, col) + (c[2 + j] + b);
                }
              }
            }
          }
        }
        const float* b4 = BIAS + D::bLB4;
        if (tq == 0) {  // column 0 of L_theta's and L_v's outputs; PV freeze
          if (ua) {
            TH(sa) = TH(sa) + (o0[0] + b4[0]);
            if (ISG[sa] == 0.0f) V(sa) = V(sa) + (o1[0] + b4[8]);
          }
          if (ub) {
            TH(sb) = TH(sb) + (o0[1] + b4[0]);
            if (ISG[sb] == 0.0f) V(sb) = V(sb) + (o1[1] + b4[8]);
          }
        }
      }
    } else {
      float* stage = U + warp * D::kWarp;  // (16, AW) f32: a tile's masked phi outputs
      int* sofs = reinterpret_cast<int*>(stage + kRows * D::AW);  // (16,): slot of the bus ending at row r, or -1
      // (16 + 1, AW): the buses' bf16(agg), then a spare row the scan writes
      // where no bus ends
      __nv_bfloat16* aggw = reinterpret_cast<__nv_bfloat16*>(sofs + kRows);
      for (int it = warp; it < tp.n_items; it += kWarps) {
        const int4 item = tp.items[it];
        const int b0 = item.x, b1 = item.y, r0 = item.z, r1 = item.w;
        for (int i = lane; i < kRows * D::AW / 2; i += 32) reinterpret_cast<uint32_t*>(aggw)[i] = 0u;
        float acc[D::NA];  // columns lane + 32 j: the bus in progress
#pragma unroll
        for (int j = 0; j < D::NA; ++j) acc[j] = 0.0f;
        for (int row0 = r0; row0 < r1; row0 += kRows) {
          const int rows = min(kRows, r1 - row0);
          // lane r < rows holds row r's edge and (bus << 1 | last row of its bus)
          const int my_e = lane < rows ? tp.dst_order[row0 + lane] : 0;
          const int my_be = lane < rows ? tp.row_bus[row0 + lane] : 0;
          if (lane < kRows) sofs[lane] = lane < rows && (my_be & 1) ? (my_be >> 1) - b0 : -1;
          const bool va = g < rows, vb = g + 8 < rows;
          const int ea = __shfl_sync(0xffffffffu, my_e, g), eb = __shfl_sync(0xffffffffu, my_e, g + 8);
          const int na = __shfl_sync(0xffffffffu, my_be, g) >> 1;
          const int nb = __shfl_sync(0xffffffffu, my_be, g + 8) >> 1;
          const float lma = va ? LM[ea] : 0.0f, lmb = vb ? LM[eb] : 0.0f;
          // A: concat(bf16(m[dst]), bf16(line features)), zero-padded (m to LE)
          uint32_t x[D::KP][4];
#pragma unroll
          for (int kt = 0; kt < D::KP; ++kt)
#pragma unroll
            for (int r = 0; r < 4; ++r) {  // columns (c, c + 1) of row g (+ 8)
              const bool hi = r & 1;
              const int n = hi ? nb : na, e = hi ? eb : ea;
              const int c = kt * 16 + (r >> 1) * 8 + 2 * tq;
              uint32_t w = 0u;
              if (c < D::LE) {
                const float2 q = *reinterpret_cast<const float2*>(&M(n, c));
                w = pack2(q.x, q.y);
              } else if (c < D::LE + 6) {
                w = *reinterpret_cast<const uint32_t*>(LF + e * 6 + c - D::LE);
              }
              x[kt][r] = (hi ? vb : va) ? w : 0u;
            }
          uint32_t h1[3][D::KH][4];  // layer 1 (all heads read x), per-head A fragments
#pragma unroll
          for (int nt = 0; nt < 3 * D::NH; ++nt) {
            float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int kt = 0; kt < D::KP; ++kt) mma(c, x[kt], WT[(D::tPW1 + nt * D::KP + kt) * 32 + lane]);
            act(h1[nt / D::NH][nt % D::NH / 2], nt % 2, c, BIAS + D::bPB1, nt * 8 + 2 * tq, slope);
          }
#pragma unroll
          for (int h = 0; h < 3; ++h) {
            uint32_t h2[D::KH][4];
#pragma unroll
            for (int nt = 0; nt < D::NH; ++nt) {
              float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
              for (int kt = 0; kt < D::KH; ++kt)
                mma(c, h1[h][kt], WT[(D::tPW2 + (h * D::NH + nt) * D::KH + kt) * 32 + lane]);
              act(h2[nt / 2], nt % 2, c, BIAS + D::bPB2 + h * D::HP, nt * 8 + 2 * tq, slope);
            }
            const float* b4 = BIAS + D::bPB4 + h * D::LP;
#pragma unroll
            for (int nt = 0; nt < D::NL; ++nt) {
              float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
              for (int kt = 0; kt < D::KH; ++kt)
                mma(c, h2[kt], WT[(D::tPW4 + (h * D::NL + nt) * D::KH + kt) * 32 + lane]);
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int col = nt * 8 + 2 * tq + j;
                // rows past the tile's end have line mask 0; a column past
                // an odd L has zero weights and bias, so it stores 0
                if (col < D::LE) {
                  stage[g * D::AW + h * D::LE + col] = (c[j] + b4[col]) * lma;
                  stage[(g + 8) * D::AW + h * D::LE + col] = (c[2 + j] + b4[col]) * lmb;
                }
              }
            }
          }
          __syncwarp();
          // the aggregate: lane c sums columns c, c + 32, ... down the rows
          // in dst-CSR order, from 0, and stores bf16(sum) at its bus's last
          // row; a bus spanning tiles carries its sums to the next tile
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int slot = sofs[r];
            const int at = (slot >= 0 ? slot : kRows) * D::AW;  // else the spare row
#pragma unroll
            for (int j = 0; j < D::NA; ++j) {
              const int col = 32 * j + lane;
              if (32 * (j + 1) <= D::AW || col < D::AW) {
                acc[j] += stage[r * D::AW + col];
                aggw[at + col] = __float2bfloat16_rn(acc[j]);
                acc[j] = slot >= 0 ? 0.0f : acc[j];
              }
            }
          }
          __syncwarp();
        }
        __syncwarp();  // the aggregates (zero for a bus with no line) are in

        // L heads over the item's buses (rows g, g + 8 of one tile); PV freeze
        const int na = b0 + g, nb = na + 8;
        const bool va = na < b1, vb = nb < b1;
        // A: bf16 of (v, theta, dp, dq, m), the state row every head reads,
        // then each head's own aggregate block (already bf16), zero-padded
        uint32_t xs[D::KL][4];
#pragma unroll
        for (int kt = 0; kt < D::KL; ++kt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {  // columns (c, c + 1) of row g (+ 8)
            const int c = kt * 16 + (r >> 1) * 8 + 2 * tq;
            const int n = r & 1 ? nb : na;
            uint32_t w = 0u;
            if (c < D::NBW && (r & 1 ? vb : va)) {
              const float2 q = *reinterpret_cast<const float2*>(NB + n * D::NBW + c);
              w = pack2(q.x, q.y);
            }
            xs[kt][r] = w;
          }
        float o0[2], o1[2], om[D::NL][4];
#pragma unroll
        for (int h = 0; h < 3; ++h) {
          const int blk = h == 0 ? 1 : (h == 1 ? 0 : 2);  // L_theta <- phi_theta, L_v <- phi_v
          uint32_t x[D::KL][4];
#pragma unroll
          for (int kt = 0; kt < D::KL; ++kt)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int c = kt * 16 + (r >> 1) * 8 + 2 * tq;
              const int slot = r & 1 ? g + 8 : g;
              x[kt][r] = xs[kt][r];
              if (c >= D::NBW && c < D::LI)  // rows past the item's buses hold zeros
                x[kt][r] = *reinterpret_cast<const uint32_t*>(aggw + slot * D::AW + blk * D::LE + c - D::NBW);
            }
          uint32_t h1[D::KH][4], h2[D::KH][4];
#pragma unroll
          for (int nt = 0; nt < D::NH; ++nt) {
            float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int kt = 0; kt < D::KL; ++kt)
              mma(c, x[kt], WT[(D::tLW1 + (h * D::NH + nt) * D::KL + kt) * 32 + lane]);
            act(h1[nt / 2], nt % 2, c, BIAS + D::bLB1 + h * D::HP, nt * 8 + 2 * tq, slope);
          }
#pragma unroll
          for (int nt = 0; nt < D::NH; ++nt) {
            float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int kt = 0; kt < D::KH; ++kt)
              mma(c, h1[kt], WT[(D::tLW2 + (h * D::NH + nt) * D::KH + kt) * 32 + lane]);
            act(h2[nt / 2], nt % 2, c, BIAS + D::bLB2 + h * D::HP, nt * 8 + 2 * tq, slope);
          }
          if (h < 2) {
            float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int kt = 0; kt < D::KH; ++kt) mma(c, h2[kt], WT[(D::tLW4 + h * D::KH + kt) * 32 + lane]);
            if (h == 0) {
              o0[0] = c[0];
              o0[1] = c[2];
            } else {
              o1[0] = c[0];
              o1[1] = c[2];
            }
          } else {
#pragma unroll
            for (int nt = 0; nt < D::NL; ++nt) {
#pragma unroll
              for (int q = 0; q < 4; ++q) om[nt][q] = 0.0f;
#pragma unroll
              for (int kt = 0; kt < D::KH; ++kt)
                mma(om[nt], h2[kt], WT[(D::tLW4 + (2 + nt) * D::KH + kt) * 32 + lane]);
            }
          }
        }
        __syncwarp();  // every lane has read its rows' state before any is updated
        const float* b4 = BIAS + D::bLB4;
        if (tq == 0) {  // column 0 of L_theta's and L_v's outputs
          if (va) {
            TH(na) = TH(na) + (o0[0] + b4[0]);
            if (ISG[na] == 0.0f) V(na) = V(na) + (o1[0] + b4[8]);  // PV freeze (main.py:184)
          }
          if (vb) {
            TH(nb) = TH(nb) + (o0[1] + b4[0]);
            if (ISG[nb] == 0.0f) V(nb) = V(nb) + (o1[1] + b4[8]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < D::NL; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = nt * 8 + 2 * tq + j;
            if (col < L) {
              const float b = b4[16 + col];
              if (va) M(na, col) = M(na, col) + (om[nt][j] + b);
              if (vb) M(nb, col) = M(nb, col) + (om[nt][2 + j] + b);
            }
          }
        __syncwarp();  // the item's reads of aggw are done before the next item clears it
      }
    }
    __syncthreads();
    mark(2);

    // ---- physics refresh (physics/fused.py, reference parity) ----
    float* TSD = U;  // delta = theta[src] - theta[dst], per line
    float* PF = U + E;
    float* QF = U + 2 * E;
    float* PT = U + 3 * E;
    float* QT = U + 4 * E;
    for (int e = threadIdx.x; e < E; e += kThreads) TSD[e] = TH(tp.src[e]) - TH(tp.dst[e]);
    __syncthreads();
    float part[2] = {0.0f, 0.0f};  // p_joule, sum(pd bm + v2 bm gs)
    for (int e = threadIdx.x; e < E; e += kThreads) {
      const float v_s = V(tp.src[e]), v_d = V(tp.dst[e]);
      const float th_sd = TSD[e];
      const int qs_row = tp.srcq[e], qd_row = tp.dstq[e];
      const int jd = tp.dst_pos[e], js = tp.src_pos[e];
      const float d_s = TSD[qs_row];    // Q2: delta[src]
      const float dj_d = -TSD[qd_row];  // Q2: (-delta)[dst]
      const float y_s = Y[qs_row], tau_s = TAU[qs_row], sh_s = SH[qs_row], b_s = BB[qs_row];
      const float y_d = Y[qd_row], tau_d = TAU[qd_row], sh_d = SH[qd_row], b_d = BB[qd_row];
      const float ang_s = (th_sd - d_s) - sh_s;
      const float ang_d = (-th_sd - dj_d) - sh_d;
      const float sin_ds = sinf(d_s), cos_ds = cosf(d_s), sin_djd = sinf(dj_d);
      const float sin_as = sinf(ang_s), cos_as = cosf(ang_s);
      const float sin_ad = sinf(ang_d), cos_ad = cosf(ang_d);
      const float vv_s = ((v_s * v_d) * y_s) / tau_s;
      const float vv_d = ((v_d * v_s) * y_d) / tau_d;
      const float vd2 = v_d * v_d;
      // second term uses v_s / tau^2, not (v_s / tau)^2 (author quirk)
      const float msg_joule = fabsf(
          (vv_s * (sin_as + sinf((-th_sd - d_s) + sh_s)) + ((v_s / (tau_s * tau_s)) * y_s) * sin_ds)
          + (vd2 * y_s) * sin_ds);
      const float lm = LM[e];
      part[0] += msg_joule * lm;
      const float qs = v_s / tau_s;
      const float p_from = vv_s * sin_as + ((qs * qs) * y_s) * sin_ds;
      const float p_to = vv_d * sin_ad + (vd2 * y_d) * sin_djd;
      const float q_from = (-vv_s) * cos_as + (qs * qs) * (y_s * cos_ds - b_s / 2.0f);
      const float q_to = (-vv_d) * cos_ad + vd2 * (y_d * sin_djd - b_d / 2.0f);
      PF[jd] = p_from * lm;  // at the line's rows of the dst and src CSRs
      QF[jd] = q_from * lm;
      PT[js] = p_to * lm;
      QT[js] = q_to * lm;
    }
    for (int n = threadIdx.x; n < N; n += kThreads) {
      const float v2 = V(n) * V(n);
      part[1] += PD[n] * BM[n] + (v2 * BM[n]) * GS[n];
    }
    block_sum<2>(part, RED);  // its barriers also publish PF..QT
    const float p_global = part[1] + part[0];
    const float lam_lo = (p_global - s_min) / (2.0f * (s_set - s_min));
    const float lam_hi = ((p_global - 2.0f * s_set) + s_max) / (2.0f * (s_max - s_set));
    const float lam = p_global < s_set ? lam_lo : lam_hi;
    for (int i = threadIdx.x; i < G; i += kThreads) {
      const float pg_lo = PMN[i] + (2.0f * (PGS[i] - PMN[i])) * lam;
      const float pg_hi = (2.0f * PGS[i] - PMX[i]) + (2.0f * (PMX[i] - PGS[i])) * lam;
      PGN[tp.gen_pos[i]] = (lam < 0.5f ? pg_lo : pg_hi) * GM[i];  // at its generator-CSR row
    }
    __syncthreads();
    float loss[1] = {0.0f};
    for (int n = threadIdx.x; n < N; n += kThreads) {
      float pd_sum = 0.0f, qd_sum = 0.0f, ps_sum = 0.0f, qs_sum = 0.0f, pg_bus = 0.0f;
      // the CSR sums, in edge order: the rows were written at their positions
      const int d0 = tp.dst_indptr[n], d1 = tp.dst_indptr[n + 1];
      const int s0 = tp.src_indptr[n], s1 = tp.src_indptr[n + 1];
      const int g0 = tp.gen_indptr[n], g1 = tp.gen_indptr[n + 1];
      for (int j = d0; j < d1; ++j) {
        pd_sum += PF[j];
        qd_sum += QF[j];
      }
      for (int j = s0; j < s1; ++j) {
        ps_sum += PT[j];
        qs_sum += QT[j];
      }
      for (int j = g0; j < g1; ++j) pg_bus += PGN[j];
      const float p_sum = pd_sum + ps_sum, q_sum = qd_sum + qs_sum;
      const float v2 = V(n) * V(n);
      const float qg_new = (QD[n] - BSH[n] * v2) - q_sum;
      const float dp = (((pg_bus - PD[n]) - GS[n] * v2) + p_sum) * BM[n];
      const float dq = (((qg_new - QD[n]) + BSH[n] * v2) + q_sum) * BM[n];
      DP(n) = dp;
      DQ(n) = dq;
      loss[0] += (dp * dp + dq * dq) * BM[n];
    }
    block_sum<1>(loss, RED);
    total_loss = total_loss + (disc[k] * loss[0]) / n_real;
    last_loss = loss[0] / n_real;
    __syncthreads();
    mark(3);
  }

  // ---- outputs; the clamp comes after the last loss (main.py:201) ----
  for (int n = threadIdx.x; n < N; n += kThreads) {
    v_out[s * N + n] = fmaxf(V(n), 0.0f);
    th_out[s * N + n] = TH(n);
    dp_out[s * N + n] = DP(n);
    dq_out[s * N + n] = DQ(n);
  }
  if (threadIdx.x == 0) {
    loss_out[2 * s] = total_loss;
    loss_out[2 * s + 1] = last_loss;
  }
  if (timed)
#pragma unroll
    for (int i = 0; i < kStages; ++i) clocks[s * kStages + i] = cyc[i];
}

// The first plan that holds an N, E, G grid in a block's shared memory, or
// -1.
template <int L, int H>
int choose_plan(int N, int E, int G) {
  if (Dims<L, H>::kPlan0 && Layout<L, H>(N, E, G, 0).total <= kMaxShared) return 0;
  for (int plan = 1; plan <= Dims<L, H>::kLastPlan; ++plan)
    if (Layout<L, H>(N, E, G, plan).total <= kMaxShared) return plan;
  return -1;
}

// `want` (0 to kLastPlan) if it holds the grid, the library's choice for
// -1, else -1.
template <int L, int H>
int resolve_plan(int N, int E, int G, int want) {
  if (want < 0) return choose_plan<L, H>(N, E, G);
  if (want > Dims<L, H>::kLastPlan || (want == 0 && !Dims<L, H>::kPlan0)) return -1;
  return Layout<L, H>(N, E, G, want).total <= kMaxShared ? want : -1;
}

template <int L, int H, bool Wide>
cudaError_t prepare(long long shared) {
  if (shared > kMaxShared) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(megakernel<L, H, Wide>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(megakernel<L, H, Wide>, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int L, int H, bool Wide>
int launch_plan(const float* buses, const float* lines, const float* gens, const float* bm,
                const float* lm, const float* gm, const Topo& tp, const void* wpack,
                const float* bpack, const float* disc, float* v, float* th, float* dp, float* dq,
                float* loss, long long* clocks, float* ws, long long S, int N, int E, int G, int K,
                float slope, int plan, long long shared, cudaStream_t stream) {
  const cudaError_t err = prepare<L, H, Wide>(shared);
  if (err != cudaSuccess) return (int)err;
  megakernel<L, H, Wide><<<(unsigned int)S, kThreads, (size_t)shared, stream>>>(
      buses, lines, gens, bm, lm, gm, tp, static_cast<const __nv_bfloat16*>(wpack), bpack,
      disc, v, th, dp, dq, loss, clocks, ws, N, E, G, K, slope, plan);
  return (int)cudaGetLastError();
}

template <int L, int H>
int launch(const float* buses, const float* lines, const float* gens, const float* bm,
           const float* lm, const float* gm, const Topo& tp, const void* wpack,
           const float* bpack, const float* disc, float* v, float* th, float* dp, float* dq,
           float* loss, long long* clocks, float* ws, long long S, int N, int E, int G, int K,
           float slope, int want, cudaStream_t stream) {
  const int plan = resolve_plan<L, H>(N, E, G, want);
  if (plan < 0 || (plan >= 2) != (ws != nullptr)) return (int)cudaErrorInvalidValue;
  const long long shared = Layout<L, H>(N, E, G, plan).total;
  if (plan > 0)
    return launch_plan<L, H, true>(buses, lines, gens, bm, lm, gm, tp, wpack, bpack, disc, v, th,
                                   dp, dq, loss, clocks, ws, S, N, E, G, K, slope, plan, shared,
                                   stream);
  if constexpr (Dims<L, H>::kPlan0)
    return launch_plan<L, H, false>(buses, lines, gens, bm, lm, gm, tp, wpack, bpack, disc, v, th,
                                    dp, dq, loss, clocks, ws, S, N, E, G, K, slope, plan, shared,
                                    stream);
  return (int)cudaErrorInvalidValue;
}

template <int L, int H>
int blocks_per_sm(int N, int E, int G, int want) {
  const int plan = resolve_plan<L, H>(N, E, G, want);
  if (plan < 0) return 0;
  const long long shared = Layout<L, H>(N, E, G, plan).total;
  int blocks = 0;
  cudaError_t err = cudaSuccess;
  if (plan > 0) {
    err = prepare<L, H, true>(shared);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, megakernel<L, H, true>, kThreads,
                                                          (size_t)shared);
  } else if constexpr (Dims<L, H>::kPlan0) {
    err = prepare<L, H, false>(shared);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, megakernel<L, H, false>, kThreads,
                                                          (size_t)shared);
  }
  return err == cudaSuccess ? blocks : -(int)err;
}

// Whether (L, H) is this library's width (each width is a library of its
// own).
bool built_for(int L, int H) { return L == kLatent && H == kHidden; }

}  // namespace

extern "C" {

// The plan for an N, E, G grid: `want` (0 to 3) if it holds the grid, the
// library's choice (the first that holds it) for -1. out (4 int64): the
// plan (0: tiles, three heads' scratch and the state rows in shared
// memory; 1: tiles read from L2, one head's scratch, the state rows in
// shared memory; 2: as 1, the state rows in a global workspace; 3, the
// pass instance only (Dims::kPass: H > 128 or L > 146): as 2, with the
// warps' scratch and the biases in global memory too), shared bytes a block, blocks a grid (1), workspace bytes a
// grid (workspace_floats, 0 for plans 0 and 1). Returns the plan; -1
// where no plan holds the grid (out then describes the last plan, the
// leanest) or `want` is not built at this width (plan 0 only for H <= 32,
// plan 3 only in the pass instance); -2 for another width.
int gns_megakernel_plan(int N, int E, int G, int L, int H, int want, long long* out) {
  if (!built_for(L, H)) return -2;
  const int plan = resolve_plan<kLatent, kHidden>(N, E, G, want);
  const int shown = plan < 0 ? Dims<kLatent, kHidden>::kLastPlan : plan;
  out[0] = plan;
  out[1] = Layout<kLatent, kHidden>(N, E, G, shown).total;
  out[2] = 1;
  out[3] = workspace_floats<kLatent, kHidden>(N, shown) * 4;
  return plan;
}

// Blocks (grids) the card keeps resident per SM at this grid size under
// `want` (-1: the library's plan), from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; 0 if no plan holds a grid,
// -1 for another width, -(cudaError) if the query fails.
int gns_megakernel_blocks_per_sm(int N, int E, int G, int L, int H, int want) {
  if (!built_for(L, H)) return -1;
  return blocks_per_sm<kLatent, kHidden>(N, E, G, want);
}

// Sizes of one packed step: bf16 tile elements (biases 0) or f32 biases
// (biases 1); -1 for another width.
long long gns_megakernel_step_sizes(int L, int H, int biases) {
  if (!built_for(L, H)) return -1;
  using D = Dims<kLatent, kHidden>;
  return biases ? D::kBias : D::kTiles * 128LL;
}

// buses (S, N, 6), lines (S, E, 7), gens (S, G, 7), masks (S, N) (S, E)
// (S, G) float32; topo: (E,) src, dst, srcq, dstq in range; the CSR by dst
// (order, indptr), the src CSR's indptr, the generator CSR (order, indptr);
// each line's row in the dst and src CSRs and each generator's in its CSR;
// the work items (n_items, 4) (first bus, end bus, first dst-CSR row, end
// row), 16-byte aligned, and each dst-CSR row's bus << 1 | last row of its
// bus (E,); wpack (K, tiles x 128) bf16 and bpack (K, kBias) f32
// as ops/megakernel.py pack_step_weights lays them out, 16-byte aligned;
// disc (K,) the loss discounts. Outputs v, theta, dp, dq (S, N), loss (S, 2);
// clocks, when not null, (S, 4) int64: each grid's SM cycles per stage
// (kStages), an instrument for chip_smoke.py; null in serving. ws: null, or
// for plans 2 and 3 the float32 workspace, gns_megakernel_plan's bytes a
// grid for each of the S grids. plan: -1 for the library's plan for the
// grid, or 0 to 3 to run that one (chip_smoke.py holds the plans to each
// other). (L, H) must be the library's width.
int gns_megakernel(const float* buses, const float* lines, const float* gens, const float* bm,
                   const float* lm, const float* gm, const int* src, const int* dst,
                   const int* srcq, const int* dstq, const int* dst_order,
                   const int* dst_indptr, const int* src_indptr, const int* gen_order,
                   const int* gen_indptr, const int* dst_pos, const int* src_pos,
                   const int* gen_pos, const int* items, const int* row_bus, int n_items,
                   const void* wpack, const float* bpack, const float* disc, float* v,
                   float* th, float* dp, float* dq, float* loss, long long* clocks, float* ws,
                   long long S, int N, int E, int G, int K, int L, int H, float slope, int plan,
                   void* stream) {
  if (!built_for(L, H)) return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  const Topo tp{src,     dst,        srcq,    dstq,    dst_order,
                dst_indptr, src_indptr, gen_order, gen_indptr, dst_pos,
                src_pos, gen_pos,    reinterpret_cast<const int4*>(items), row_bus, n_items};
  return launch<kLatent, kHidden>(buses, lines, gens, bm, lm, gm, tp, wpack, bpack, disc, v, th,
                                  dp, dq, loss, clocks, ws, S, N, E, G, K, slope, plan,
                                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
