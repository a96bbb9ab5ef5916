// K4: the whole GNS forward of one grid in one block, for NVIDIA Hopper
// (sm_90a). Serving only (no backward), multiple_phi + reference_parity.
//
// Replaces the Pallas TPU kernel gns_tpu/ops/pallas_megakernel.py `_kernel`
// (:88, pallas_call :337, public megakernel_forward_batch :250). Per grid:
// state init (generator -> bus scatter, v = 1 where no generator), then K x
// (gather m[dst]; fused phi MLP; masked aggregation at dst; fused L MLP;
// PV freeze; the reference-parity physics refresh with the quirk-Q2 gathers
// and the lambda dispatch; the gamma^(K-k) discounted loss), then the last
// loss and the v clamp. Outputs v, theta, delta_p, delta_q (S, N) and
// (total, last) loss (S, 2).
//
// Numerics, as the TPU kernel's: the MLPs take bf16 operands with float32
// accumulation and float32 bias and LeakyReLU; the physics is float32. A
// bf16 x bf16 product is exact in float32, so each dot product here is a
// chain of float32 FMAs on bf16-rounded operands. Where the TPU kernel
// gathered and summed with 0/1 incidence matmuls, split into hi + lo bf16
// halves (_oh_dot_exact :56-63, exact only to about 2^-16 relative), this
// kernel indexes directly and sums exactly in float32 by walking a CSR in
// edge order, with no atomics: the sums equal, add for add, those of the
// plain twin (gns_torch/ops/megakernel.py megakernel_forward_plain). Build
// without --use_fast_math (sinf / cosf / division / sqrt stay IEEE-accurate)
// and with --fmad=false, so that the physics rounds after every operation
// as the twin does; the MLP dot products call fmaf explicitly.
//
// What bounds it on an H100: at case300 (N=300, E=411, G=69), S=1024, K=4,
// L=20, H=10 the model's heads do, per step, 1650 MACs per edge (three phi
// heads: 3 (H (L + 5) + H H + L H)) and 1840 per bus (three L heads, each
// reading 4 + 2L of the 4 + 4L node inputs: 3 H (4 + 2L) + 3 H H + H (2 + L)),
// 10.08 GFLOP per batch: 10.2 us on the bf16 tensor cores (989 TFLOP/s),
// 150 us on the float32 CUDA cores (67 TFLOP/s). It moves about 29 MB (the
// grids in, the outputs out), 8.7 us at 3.35 TB/s. By its work it is bound
// by operations. This first version runs the dense fused layout on the CUDA
// cores, block-diagonal zeros included (3450 MACs per edge and 4080 per bus,
// 21.6 GFLOP), so 323 us is the least it can take; skipping the zeros and
// moving the products to mma / wgmma are the next steps.
// What the design does:
//   * one block of 512 threads per grid; the grid's whole state lives in
//     shared memory for the K steps (about 190 KB at case300: the masked
//     phi output E x 3L, 99 KB, which the physics then reuses; m, N x L;
//     one step's weights, transposed and padded to float4 rows; bus, line,
//     Q2 and generator arrays). A grid that does not fit is refused (the
//     wrapper raises), never run elsewhere;
//   * the phi MLP runs one thread per edge, the L MLP one thread per bus,
//     with activations in registers; each weight row is read as float4
//     broadcasts from shared memory, four FMAs per load;
//   * the L MLP's first layer streams its input: the phi aggregate of a bus
//     is summed over the bus's CSR edge list as each column is consumed, so
//     no N x 3L aggregate is stored;
//   * scalar sums (n_real, the generator sums, p_global, the loss) are
//     block reductions in a fixed order, so a run is deterministic.
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

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxShared = 232448;  // 227 KB, the most a block may use
constexpr int kRed = 4 * 32 + 4;    // block-reduction scratch (floats)

__host__ __device__ constexpr int up4(int x) { return (x + 3) / 4 * 4; }
__host__ __device__ constexpr long long up4ll(long long x) { return (x + 3) / 4 * 4; }

// Layer sizes of the fused layout and the shared-memory weight image of one
// step: each (out, in) weight stored transposed, in rows of `in` padded to a
// multiple of 4 floats, then the biases, each padded the same way.
template <int L, int H>
struct Dims {
  static constexpr int PF = L + 5, PH = 3 * H, PO = 3 * L;      // phi: in, hidden, out
  static constexpr int LI = 4 + 4 * L, LH = 3 * H, LO = 2 + L;  // L: in, hidden, out
  static constexpr int PHP = up4(PH), POP = up4(PO), LHP = up4(LH), LOP = up4(LO);
  // offsets (floats) in the shared image
  static constexpr int oPW1 = 0, oPW2 = oPW1 + PF * PHP, oPW4 = oPW2 + PH * PHP;
  static constexpr int oLW1 = oPW4 + PH * POP, oLW2 = oLW1 + LI * LHP, oLW4 = oLW2 + LH * LHP;
  static constexpr int oPB1 = oLW4 + LH * LOP, oPB2 = oPB1 + PHP, oPB4 = oPB2 + PHP;
  static constexpr int oLB1 = oPB4 + POP, oLB2 = oLB1 + LHP, oLB4 = oLB2 + LHP;
  static constexpr int kImage = oLB4 + LOP;
  // the packed step in device memory: bf16 weights (out, in), f32 biases
  static constexpr int kW = PH * PF + PH * PH + PO * PH + LH * LI + LH * LH + LO * LH;
  static constexpr int kB = PH + PH + PO + LH + LH + LO;
  static constexpr int CH = 12;  // phi output columns per register chunk
  static_assert(PO % CH == 0, "phi output width must be a multiple of the chunk");
};

__device__ __forceinline__ float bf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
__device__ __forceinline__ float lrelu(float x, float slope) { return x >= 0.0f ? x : slope * x; }

// acc[q] += x * WT[row + q] for q < CH, as float4 loads (row 16-byte aligned).
template <int CH>
__device__ __forceinline__ void axpy(float (&acc)[CH], float x, const float* __restrict__ row) {
#pragma unroll
  for (int q = 0; q < CH; q += 4) {
    const float4 w = *reinterpret_cast<const float4*>(row + q);
    acc[q] = fmaf(x, w.x, acc[q]);
    acc[q + 1] = fmaf(x, w.y, acc[q + 1]);
    acc[q + 2] = fmaf(x, w.z, acc[q + 2]);
    acc[q + 3] = fmaf(x, w.w, acc[q + 3]);
  }
}

// acc = x[0:I] . WT[:, j0:j0+CH] (WT transposed, row stride OP), from 0,
// adding inputs in order.
template <int I, int IA, int OP, int CH>
__device__ __forceinline__ void dense(float (&acc)[CH], const float (&x)[IA],
                                      const float* __restrict__ wt, int j0) {
#pragma unroll
  for (int q = 0; q < CH; ++q) acc[q] = 0.0f;
#pragma unroll
  for (int i = 0; i < I; ++i) axpy<CH>(acc, x[i], wt + i * OP + j0);
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

// Weight layer (O, I) bf16 in (out, in) order -> transposed float rows of OP.
__device__ __forceinline__ void load_layer(float* dst, const __nv_bfloat16* __restrict__ src,
                                           int O, int I, int OP) {
  for (int idx = threadIdx.x; idx < I * OP; idx += blockDim.x) {
    const int i = idx / OP, j = idx - (idx / OP) * OP;
    dst[idx] = j < O ? __bfloat162float(src[j * I + i]) : 0.0f;
  }
}

__device__ __forceinline__ void load_bias(float* dst, const float* __restrict__ src, int O, int OP) {
  for (int j = threadIdx.x; j < OP; j += blockDim.x) dst[j] = j < O ? src[j] : 0.0f;
}

struct Topo {
  const int *src, *dst, *srcq, *dstq;   // (E,): bus ids, and bus ids as line rows (Q2)
  const int *dst_order, *dst_indptr;    // CSR of the edges by dst
  const int *src_order, *src_indptr;    // CSR of the edges by src
  const int *gen_order, *gen_indptr;    // CSR of the generators by bus
};

template <int L, int H>
__global__ void __launch_bounds__(kThreads, 1) megakernel(
    const float* __restrict__ buses, const float* __restrict__ lines,
    const float* __restrict__ gens, const float* __restrict__ bus_mask,
    const float* __restrict__ line_mask, const float* __restrict__ gen_mask, Topo tp,
    const __nv_bfloat16* __restrict__ wpack, const float* __restrict__ bpack,
    const float* __restrict__ disc, float* __restrict__ v_out, float* __restrict__ th_out,
    float* __restrict__ dp_out, float* __restrict__ dq_out, float* __restrict__ loss_out,
    int N, int E, int G, int K, float slope) {
  using D = Dims<L, H>;
  extern __shared__ float4 smem4[];
  float* W = reinterpret_cast<float*>(smem4);  // one step's weight image
  float* A = W + D::kImage;                     // E x PO phi rows; then physics rows
  float* M = A + up4ll((long long)E * D::PO > 5LL * E ? (long long)E * D::PO : 5LL * E);
  float* V = M + N * L;
  float* TH = V + N;
  float* DP = TH + N;
  float* DQ = DP + N;
  float* PD = DQ + N;
  float* QD = PD + N;
  float* GS = QD + N;
  float* BS = GS + N;
  float* BM = BS + N;
  float* ISG = BM + N;
  float* LF = ISG + N;         // (E, 5) line features, bf16-rounded
  float* Q2 = LF + 5 * E;      // (8, E): y, tau, shift, b at src row; then at dst row
  float* LM = Q2 + 8 * E;
  float* PGS = LM + E;         // masked Pg_set, Pmin, Pmax, the mask, the new Pg
  float* PMN = PGS + G;
  float* PMX = PMN + G;
  float* GM = PMX + G;
  float* PGN = GM + G;
  float* RED = PGN + G;

  const long long s = blockIdx.x;
  const float* bus = buses + s * N * 6;
  const float* lin = lines + s * E * 7;
  const float* gen = gens + s * G * 7;

  // ---- per-grid inputs into shared memory ----
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    PD[n] = bus[n * 6 + 2];
    QD[n] = bus[n * 6 + 3];
    GS[n] = bus[n * 6 + 4];
    BS[n] = bus[n * 6 + 5];
    BM[n] = bus_mask[s * N + n];
  }
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
#pragma unroll
    for (int j = 0; j < 5; ++j) LF[e * 5 + j] = bf(lin[e * 7 + 2 + j]);
    LM[e] = line_mask[s * E + e];
    // quirk Q2: per-line y / tau / shift / b of line src[e] (resp. dst[e]),
    // bus ids used as line rows (clipped to [0, E) on the host, E >= N)
    const int rows[2] = {tp.srcq[e], tp.dstq[e]};
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const float* l = lin + rows[side] * 7;
      const float r = l[2], x = l[3];
      const float z2 = r * r + x * x;
      Q2[(4 * side + 0) * E + e] = 1.0f / sqrtf(z2);
      Q2[(4 * side + 1) * E + e] = l[5];
      Q2[(4 * side + 2) * E + e] = l[6];
      Q2[(4 * side + 3) * E + e] = l[4];
    }
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const float gm = gen_mask[s * G + g];
    PGS[g] = gen[g * 7 + 3] * gm;
    PMN[g] = gen[g * 7 + 2] * gm;
    PMX[g] = gen[g * 7 + 1] * gm;
    GM[g] = gm;
  }
  __syncthreads();

  // ---- state init (main.py:141-153): generator sums per bus, CSR order ----
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    for (int j = tp.gen_indptr[n]; j < tp.gen_indptr[n + 1]; ++j) {
      const int g = tp.gen_order[j];
      a0 += gen[g * 7 + 4] * GM[g];
      a1 += gen[g * 7 + 6] * GM[g];
      a2 += gen[g * 7 + 5] * GM[g];
      a3 += GM[g];
    }
    const float v = a0 == 0.0f ? 1.0f : a0;
    const float v2 = v * v;
    V[n] = v;
    ISG[n] = a3 > 0.0f ? 1.0f : 0.0f;
    TH[n] = 0.0f;
    DP[n] = (a1 - PD[n]) - GS[n] * v2;
    DQ[n] = (a2 - QD[n]) + BS[n] * v2;
#pragma unroll
    for (int l = 0; l < L; ++l) M[n * L + l] = 0.0f;
  }
  float sums[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // n_real, s_set, s_min, s_max
  for (int n = threadIdx.x; n < N; n += blockDim.x) sums[0] += BM[n];
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    sums[1] += PGS[g];
    sums[2] += PMN[g];
    sums[3] += PMX[g];
  }
  block_sum<4>(sums, RED);
  const float n_real = sums[0], s_set = sums[1], s_min = sums[2], s_max = sums[3];
  float total_loss = 0.0f, last_loss = 0.0f;

  for (int k = 0; k < K; ++k) {
    // ---- this step's weights ----
    const __nv_bfloat16* wk = wpack + (long long)k * D::kW;
    const float* bk = bpack + (long long)k * D::kB;
    load_layer(W + D::oPW1, wk, D::PH, D::PF, D::PHP);
    wk += D::PH * D::PF;
    load_layer(W + D::oPW2, wk, D::PH, D::PH, D::PHP);
    wk += D::PH * D::PH;
    load_layer(W + D::oPW4, wk, D::PO, D::PH, D::POP);
    wk += D::PO * D::PH;
    load_layer(W + D::oLW1, wk, D::LH, D::LI, D::LHP);
    wk += D::LH * D::LI;
    load_layer(W + D::oLW2, wk, D::LH, D::LH, D::LHP);
    wk += D::LH * D::LH;
    load_layer(W + D::oLW4, wk, D::LO, D::LH, D::LOP);
    load_bias(W + D::oPB1, bk, D::PH, D::PHP);
    load_bias(W + D::oPB2, bk + D::PH, D::PH, D::PHP);
    load_bias(W + D::oPB4, bk + 2 * D::PH, D::PO, D::POP);
    load_bias(W + D::oLB1, bk + 2 * D::PH + D::PO, D::LH, D::LHP);
    load_bias(W + D::oLB2, bk + 2 * D::PH + D::PO + D::LH, D::LH, D::LHP);
    load_bias(W + D::oLB4, bk + 2 * D::PH + D::PO + 2 * D::LH, D::LO, D::LOP);
    __syncthreads();

    // ---- edge stage: phi(concat(bf16(m)[dst], feats)) * line_mask ----
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      float x[D::PF];
      const float* mrow = M + tp.dst[e] * L;
#pragma unroll
      for (int l = 0; l < L; ++l) x[l] = bf(mrow[l]);
#pragma unroll
      for (int j = 0; j < 5; ++j) x[L + j] = LF[e * 5 + j];
      float h1[D::PHP], h2[D::PHP];
      dense<D::PF, D::PF, D::PHP, D::PHP>(h1, x, W + D::oPW1, 0);
#pragma unroll
      for (int j = 0; j < D::PHP; ++j) h1[j] = bf(lrelu(h1[j] + W[D::oPB1 + j], slope));
      dense<D::PH, D::PHP, D::PHP, D::PHP>(h2, h1, W + D::oPW2, 0);
#pragma unroll
      for (int j = 0; j < D::PHP; ++j) h2[j] = bf(lrelu(h2[j] + W[D::oPB2 + j], slope));
      const float lm = LM[e];
#pragma unroll
      for (int c0 = 0; c0 < D::PO; c0 += D::CH) {
        float o[D::CH];
        dense<D::PH, D::PHP, D::POP, D::CH>(o, h2, W + D::oPW4, c0);
#pragma unroll
        for (int q = 0; q < D::CH; ++q) A[e * D::PO + c0 + q] = (o[q] + W[D::oPB4 + c0 + q]) * lm;
      }
    }
    __syncthreads();

    // ---- node stage: L(v, theta, dp, dq, m, aggregate); PV freeze ----
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      float h1[D::LHP];
#pragma unroll
      for (int j = 0; j < D::LHP; ++j) h1[j] = 0.0f;
      const float* w1 = W + D::oLW1;
      axpy<D::LHP>(h1, bf(V[n]), w1);
      axpy<D::LHP>(h1, bf(TH[n]), w1 + D::LHP);
      axpy<D::LHP>(h1, bf(DP[n]), w1 + 2 * D::LHP);
      axpy<D::LHP>(h1, bf(DQ[n]), w1 + 3 * D::LHP);
#pragma unroll
      for (int l = 0; l < L; ++l) axpy<D::LHP>(h1, bf(M[n * L + l]), w1 + (4 + l) * D::LHP);
      const int lo = tp.dst_indptr[n], hi = tp.dst_indptr[n + 1];
      for (int c = 0; c < D::PO; ++c) {
        float agg = 0.0f;
        for (int j = lo; j < hi; ++j) agg += A[tp.dst_order[j] * D::PO + c];
        axpy<D::LHP>(h1, bf(agg), w1 + (4 + L + c) * D::LHP);
      }
#pragma unroll
      for (int j = 0; j < D::LHP; ++j) h1[j] = bf(lrelu(h1[j] + W[D::oLB1 + j], slope));
      float h2[D::LHP];
      dense<D::LH, D::LHP, D::LHP, D::LHP>(h2, h1, W + D::oLW2, 0);
#pragma unroll
      for (int j = 0; j < D::LHP; ++j) h2[j] = bf(lrelu(h2[j] + W[D::oLB2 + j], slope));
      float o[D::LOP];
      dense<D::LH, D::LHP, D::LOP, D::LOP>(o, h2, W + D::oLW4, 0);
      TH[n] = TH[n] + (o[0] + W[D::oLB4]);
      if (ISG[n] == 0.0f) V[n] = V[n] + (o[1] + W[D::oLB4 + 1]);  // PV freeze (main.py:184)
#pragma unroll
      for (int l = 0; l < L; ++l) M[n * L + l] = M[n * L + l] + (o[2 + l] + W[D::oLB4 + 2 + l]);
    }
    __syncthreads();

    // ---- physics refresh (physics/fused.py, reference parity) ----
    float* TSD = A;  // delta = theta[src] - theta[dst], per line
    float* PF = A + E;
    float* QF = A + 2 * E;
    float* PT = A + 3 * E;
    float* QT = A + 4 * E;
    for (int e = threadIdx.x; e < E; e += blockDim.x) TSD[e] = TH[tp.src[e]] - TH[tp.dst[e]];
    __syncthreads();
    float part[2] = {0.0f, 0.0f};  // p_joule, sum(pd bm + v2 bm gs)
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      const float v_s = V[tp.src[e]], v_d = V[tp.dst[e]];
      const float th_sd = TSD[e];
      const float d_s = TSD[tp.srcq[e]];    // Q2: delta[src]
      const float dj_d = -TSD[tp.dstq[e]];  // Q2: (-delta)[dst]
      const float y_s = Q2[e], tau_s = Q2[E + e], sh_s = Q2[2 * E + e], b_s = Q2[3 * E + e];
      const float y_d = Q2[4 * E + e], tau_d = Q2[5 * E + e], sh_d = Q2[6 * E + e],
                  b_d = Q2[7 * E + e];
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
      PF[e] = p_from * lm;
      QF[e] = q_from * lm;
      PT[e] = p_to * lm;
      QT[e] = q_to * lm;
    }
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      const float v2 = V[n] * V[n];
      part[1] += PD[n] * BM[n] + (v2 * BM[n]) * GS[n];
    }
    block_sum<2>(part, RED);  // its barriers also publish PF..QT
    const float p_global = part[1] + part[0];
    const float lam_lo = (p_global - s_min) / (2.0f * (s_set - s_min));
    const float lam_hi = ((p_global - 2.0f * s_set) + s_max) / (2.0f * (s_max - s_set));
    const float lam = p_global < s_set ? lam_lo : lam_hi;
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      const float pg_lo = PMN[g] + (2.0f * (PGS[g] - PMN[g])) * lam;
      const float pg_hi = (2.0f * PGS[g] - PMX[g]) + (2.0f * (PMX[g] - PGS[g])) * lam;
      PGN[g] = (lam < 0.5f ? pg_lo : pg_hi) * GM[g];
    }
    __syncthreads();
    float loss[1] = {0.0f};
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      float pd_sum = 0.0f, qd_sum = 0.0f, ps_sum = 0.0f, qs_sum = 0.0f, pg_bus = 0.0f;
      for (int j = tp.dst_indptr[n]; j < tp.dst_indptr[n + 1]; ++j) {
        const int e = tp.dst_order[j];
        pd_sum += PF[e];
        qd_sum += QF[e];
      }
      for (int j = tp.src_indptr[n]; j < tp.src_indptr[n + 1]; ++j) {
        const int e = tp.src_order[j];
        ps_sum += PT[e];
        qs_sum += QT[e];
      }
      for (int j = tp.gen_indptr[n]; j < tp.gen_indptr[n + 1]; ++j) pg_bus += PGN[tp.gen_order[j]];
      const float p_sum = pd_sum + ps_sum, q_sum = qd_sum + qs_sum;
      const float v2 = V[n] * V[n];
      const float qg_new = (QD[n] - BS[n] * v2) - q_sum;
      const float dp = (((pg_bus - PD[n]) - GS[n] * v2) + p_sum) * BM[n];
      const float dq = (((qg_new - QD[n]) + BS[n] * v2) + q_sum) * BM[n];
      DP[n] = dp;
      DQ[n] = dq;
      loss[0] += (dp * dp + dq * dq) * BM[n];
    }
    block_sum<1>(loss, RED);
    total_loss = total_loss + (disc[k] * loss[0]) / n_real;
    last_loss = loss[0] / n_real;
    __syncthreads();
  }

  // ---- outputs; the clamp comes after the last loss (main.py:201) ----
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    v_out[s * N + n] = fmaxf(V[n], 0.0f);
    th_out[s * N + n] = TH[n];
    dp_out[s * N + n] = DP[n];
    dq_out[s * N + n] = DQ[n];
  }
  if (threadIdx.x == 0) {
    loss_out[2 * s] = total_loss;
    loss_out[2 * s + 1] = last_loss;
  }
}

template <int L, int H>
long long shared_floats(int N, int E, int G) {
  using D = Dims<L, H>;
  const long long a = up4ll(((long long)E * D::PO > 5LL * E) ? (long long)E * D::PO : 5LL * E);
  return D::kImage + a + (long long)N * L + 10LL * N + 14LL * E + 5LL * G + kRed;
}

template <int L, int H>
int launch(const float* buses, const float* lines, const float* gens, const float* bm,
           const float* lm, const float* gm, const Topo& tp, const void* wpack,
           const float* bpack, const float* disc, float* v, float* th, float* dp, float* dq,
           float* loss, long long S, int N, int E, int G, int K, float slope,
           cudaStream_t stream) {
  const long long shared = shared_floats<L, H>(N, E, G) * (long long)sizeof(float);
  if (shared > kMaxShared) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(megakernel<L, H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shared);
  if (err != cudaSuccess) return (int)err;
  megakernel<L, H><<<(unsigned int)S, kThreads, (size_t)shared, stream>>>(
      buses, lines, gens, bm, lm, gm, tp, static_cast<const __nv_bfloat16*>(wpack), bpack,
      disc, v, th, dp, dq, loss, N, E, G, K, slope);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of shared memory one grid needs, or -1 for an unsupported (L, H).
// Built for the shipped checkpoints' (L, H) = (20, 10) only: another width
// gets its instantiation together with a check of it on the card.
long long gns_megakernel_shared_bytes(int N, int E, int G, int L, int H) {
  if (L != 20 || H != 10) return -1;
  return shared_floats<20, 10>(N, E, G) * (long long)sizeof(float);
}

// Weight counts of one packed step: bf16 weights, f32 biases; -1 if unsupported.
long long gns_megakernel_step_sizes(int L, int H, int biases) {
  if (L != 20 || H != 10) return -1;
  return biases ? Dims<20, 10>::kB : Dims<20, 10>::kW;
}

// buses (S, N, 6), lines (S, E, 7), gens (S, G, 7), masks (S, N) (S, E)
// (S, G) float32; topo: (E,) src, dst, srcq, dstq in range, and the CSRs
// by dst, src and generator bus; wpack (K, kW) bf16 and bpack (K, kB) f32,
// per step [phi w1 w2 w4, L w1 w2 w4] in (out, in) order and their biases;
// disc (K,) the loss discounts. Outputs v, theta, dp, dq (S, N), loss (S, 2).
int gns_megakernel(const float* buses, const float* lines, const float* gens, const float* bm,
                   const float* lm, const float* gm, const int* src, const int* dst,
                   const int* srcq, const int* dstq, const int* dst_order,
                   const int* dst_indptr, const int* src_order, const int* src_indptr,
                   const int* gen_order, const int* gen_indptr, const void* wpack,
                   const float* bpack, const float* disc, float* v, float* th, float* dp,
                   float* dq, float* loss, long long S, int N, int E, int G, int K, int L,
                   int H, float slope, void* stream) {
  if (S == 0) return 0;
  const Topo tp{src, dst, srcq, dstq, dst_order, dst_indptr,
                src_order, src_indptr, gen_order, gen_indptr};
  if (L != 20 || H != 10) return (int)cudaErrorInvalidValue;
  return launch<20, 10>(buses, lines, gens, bm, lm, gm, tp, wpack, bpack, disc, v, th, dp, dq,
                        loss, S, N, E, G, K, slope, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
