// gridpack: the host data-loader of gns_torch (grown from the JAX package's
// native/gridpack.cpp; the entry points differ).
//
// Converts raw MATPOWER-style case arrays (float64 bus/branch/gen tables)
// into the port's padded, masked, static-shape float32 grid batches (the
// prepare_case transform of gns_torch/utils/prepare.py, reference
// GNS/utils.py:17-41, plus bucket padding), multithreaded across grids,
// and builds CSR edge orderings (edges sorted by destination bus).
// gridpack_prepare_cases reads each grid's tables where they lie in memory
// (utils/native.py pack_batch, the port's packer).
//
// Exposed as a C ABI for ctypes; no Python dependencies. The wrapper,
// gns_torch/utils/native.py, builds this file with the host C++ compiler
// at first use into build/torch_kernels/. Its flags keep ISO C++17
// (-std=c++17, not gnu++17) and no -ffast-math: in ISO mode GCC leaves
// -ffp-contract=off, so no multiply and add are fused into an FMA and each
// float32 operation rounds as numpy's does. The output is then bit-equal to
// prepare_case + _stack_to_batch, which the tests check.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// Column layout constants (see gns_torch/utils/schema.py).
constexpr int kBusCols = 6;   // bus_i, type, Pd, Qd, Gs, Bs
constexpr int kLineCols = 7;  // f_bus, t_bus, r, x, b, tau, theta_shift
constexpr int kGenCols = 7;   // bus_i, Pmax, Pmin, Pg_set, vg, qg, Pg

// The raw columns prepare_one reads: bus 0-5, branch up to 9 (tau 8,
// shift 9), gen up to 9 (Pmax 8, Pmin 9). A narrower table is refused.
constexpr int64_t kRawWidth[3] = {6, 10, 10};

// prepare one grid: raw MATPOWER rows -> framework tensors (float32),
// written into pre-padded output slabs.
void prepare_one(
    const double* bus_raw, int64_t nb, int64_t bus_stride,
    const double* br_raw, int64_t ne, int64_t br_stride,
    const double* gen_raw, int64_t ng, int64_t gen_stride,
    double base_mva, int paper_shunts,
    int64_t pad_n, int64_t pad_e, int64_t pad_g,
    float* buses, float* lines, float* gens,
    float* bus_mask, float* line_mask, float* gen_mask) {
  // divide (not multiply-by-reciprocal) to match numpy's f32 division ULPs
  const float fbase = static_cast<float>(base_mva);

  // --- buses: cols [0..5]; Gs->1, Bs->-1 (paper defaults); /baseMVA ---
  for (int64_t i = 0; i < nb; ++i) {
    const double* row = bus_raw + i * bus_stride;
    float* out = buses + i * kBusCols;
    out[0] = static_cast<float>(row[0]);
    out[1] = static_cast<float>(row[1]);
    const float gs = paper_shunts ? 1.0f : static_cast<float>(row[4]);
    const float bs = paper_shunts ? -1.0f : static_cast<float>(row[5]);
    out[2] = static_cast<float>(row[2]) / fbase;
    out[3] = static_cast<float>(row[3]) / fbase;
    out[4] = gs / fbase;
    out[5] = bs / fbase;
    bus_mask[i] = 1.0f;
  }
  for (int64_t i = nb; i < pad_n; ++i) {
    float* out = buses + i * kBusCols;
    std::memset(out, 0, kBusCols * sizeof(float));
    out[0] = static_cast<float>(i + 1);  // 1-based ids continue
    bus_mask[i] = 0.0f;
  }

  // --- lines: cols [0,1,2,3,4,8,9]; tau 0->1; shift deg->rad ---
  for (int64_t i = 0; i < ne; ++i) {
    const double* row = br_raw + i * br_stride;
    float* out = lines + i * kLineCols;
    out[0] = static_cast<float>(row[0]);
    out[1] = static_cast<float>(row[1]);
    out[2] = static_cast<float>(row[2]);
    out[3] = static_cast<float>(row[3]);
    out[4] = static_cast<float>(row[4]);
    const float tau = static_cast<float>(row[8]);
    out[5] = (tau == 0.0f) ? 1.0f : tau;
    // match numpy: float32(deg2rad(float32(x))) — cast first, then scale
    out[6] = static_cast<float>(row[9]) * static_cast<float>(kPi / 180.0);
    line_mask[i] = 1.0f;
  }
  for (int64_t i = ne; i < pad_e; ++i) {
    float* out = lines + i * kLineCols;
    out[0] = static_cast<float>(pad_n);  // dead-bus slot (1-based)
    out[1] = static_cast<float>(pad_n);
    out[2] = 1.0f;
    out[3] = 1.0f;
    out[4] = 0.0f;
    out[5] = 1.0f;
    out[6] = 0.0f;
    line_mask[i] = 0.0f;
  }

  // --- gens: cols [0,8,9,1,5,2] + duplicated Pg; power cols /baseMVA ---
  for (int64_t i = 0; i < ng; ++i) {
    const double* row = gen_raw + i * gen_stride;
    float* out = gens + i * kGenCols;
    out[0] = static_cast<float>(row[0]);
    out[1] = static_cast<float>(row[8]) / fbase;  // Pmax
    out[2] = static_cast<float>(row[9]) / fbase;  // Pmin
    out[3] = static_cast<float>(row[1]) / fbase;  // Pg_set
    out[4] = static_cast<float>(row[5]);          // vg (not normalized)
    out[5] = static_cast<float>(row[2]) / fbase;  // qg
    out[6] = out[3];                                 // Pg (mutable copy)
    gen_mask[i] = 1.0f;
  }
  for (int64_t i = ng; i < pad_g; ++i) {
    float* out = gens + i * kGenCols;
    std::memset(out, 0, kGenCols * sizeof(float));
    out[0] = static_cast<float>(pad_n);  // dead bus
    gen_mask[i] = 0.0f;
  }
}

}  // namespace

extern "C" {

// Prepare S grids in parallel from their tables where they lie: no staging.
//
// tables (S, 3) holds the addresses of each grid's float64 bus, branch and
// gen tables, each C-contiguous, rows (S, 3) their row counts and cols
// (S, 3) their column counts (the row strides). Outputs are float32 slabs
// shaped (S, pad_n, 6), (S, pad_e, 7), (S, pad_g, 7), masks (S, pad_n),
// (S, pad_e), (S, pad_g) and each grid's bus count. Every input is checked
// before anything is written; on a bad one the index of the first bad grid goes to *bad and
// the return is 1 (pad_e < pad_n), 2 (a grid larger than the pad sizes),
// 3 (a table narrower than the columns read: bus 6, branch 10, gen 10) or
// 4 (a negative count, or rows at a null address). Returns 0 on success.
int gridpack_prepare_cases(
    const int64_t* tables, const int64_t* rows, const int64_t* cols,
    const double* base_mva,  // (S,)
    int64_t s, int paper_shunts,
    int64_t pad_n, int64_t pad_e, int64_t pad_g,
    float* buses, float* lines, float* gens,
    float* bus_mask, float* line_mask, float* gen_mask,
    int32_t* n_bus_out, int64_t* bad,
    int n_threads) {
  *bad = -1;
  if (pad_e < pad_n) return 1;  // E >= N invariant (SURVEY.md Q2)
  const int64_t pads[3] = {pad_n, pad_e, pad_g};
  for (int64_t i = 0; i < s; ++i) {
    for (int k = 0; k < 3; ++k) {
      const int64_t n = rows[i * 3 + k], w = cols[i * 3 + k];
      int rc = 0;
      if (n < 0 || w < 0 || (n > 0 && tables[i * 3 + k] == 0)) rc = 4;
      else if (n > pads[k]) rc = 2;
      else if (w < kRawWidth[k]) rc = 3;
      if (rc != 0) {
        *bad = i;
        return rc;
      }
    }
  }

  auto table = [&](int64_t i, int k) {
    return reinterpret_cast<const double*>(static_cast<uintptr_t>(tables[i * 3 + k]));
  };
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t nb = rows[i * 3 + 0];
      prepare_one(
          table(i, 0), nb, cols[i * 3 + 0],
          table(i, 1), rows[i * 3 + 1], cols[i * 3 + 1],
          table(i, 2), rows[i * 3 + 2], cols[i * 3 + 2],
          base_mva[i], paper_shunts, pad_n, pad_e, pad_g,
          buses + i * pad_n * kBusCols,
          lines + i * pad_e * kLineCols,
          gens + i * pad_g * kGenCols,
          bus_mask + i * pad_n,
          line_mask + i * pad_e,
          gen_mask + i * pad_g);
      n_bus_out[i] = static_cast<int32_t>(nb);
    }
  };

  // Up to n_threads contiguous chunks of grids.
  if (n_threads <= 1 || s < 4) {
    work(int64_t{0}, s);
    return 0;
  }
  const int nt = static_cast<int>(std::min<int64_t>(n_threads, s));
  const int64_t chunk = (s + nt - 1) / nt;
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min<int64_t>(lo + chunk, s);
    if (lo < hi) threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
  return 0;
}

// Build a CSR ordering of edges sorted by destination bus (stable), from a
// prepared lines slab of one topology. Outputs:
//   order   (E,) int32 — permutation of edge indices, sorted by dst
//   indptr  (N+1,) int32 — CSR row pointers over destination buses
// Padded edges (dst == pad dead bus) sort to the end like any other dst.
int gridpack_csr_by_dst(
    const float* lines, int64_t e, int64_t n,
    int32_t* order, int32_t* indptr) {
  std::vector<int32_t> dst(e);
  for (int64_t i = 0; i < e; ++i) {
    dst[i] = static_cast<int32_t>(lines[i * kLineCols + 1]) - 1;
    if (dst[i] < 0 || dst[i] >= n) return 1;
  }
  for (int64_t i = 0; i < e; ++i) order[i] = static_cast<int32_t>(i);
  std::stable_sort(order, order + e,
                   [&](int32_t a, int32_t b) { return dst[a] < dst[b]; });
  std::vector<int32_t> counts(n + 1, 0);
  for (int64_t i = 0; i < e; ++i) counts[dst[i] + 1]++;
  indptr[0] = 0;
  for (int64_t i = 0; i < n; ++i) indptr[i + 1] = indptr[i] + counts[i + 1];
  return 0;
}

}  // extern "C"
