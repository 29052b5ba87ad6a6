// Native host runtime for spmv-topk: fast MTX parsing and SELL packing.
//
// Counterpart of the reference's host-side preprocessing, the
// hot O(nnz) loops that dominate setup time:
//   - MTX parsing: /root/reference/src/common/utils/mmio.hpp +
//     readMtx (/root/reference/src/common/utils/utils.hpp:475-520)
//   - BS-CSR packing: packet_coo_partition
//     (/root/reference/src/fpga/src/host_spmv_bscsr.cpp:189-248)
//
// Exposed as a C ABI consumed from Python via ctypes
// (spmv_topk/utils/native.py); the NumPy implementations remain the
// portable fallback and the differential oracle for these routines.
//
// Build: make -C runtime   (g++ -O3 -march=native -shared -fPIC)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kLanes = 128;

// Round-to-nearest-even bfloat16 bit pattern of a float.
inline uint16_t bf16_bits(float v) {
  uint32_t bits;
  std::memcpy(&bits, &v, 4);
  if ((bits & 0x7FFFFFFFu) > 0x7F800000u) return uint16_t(bits >> 16);  // NaN
  uint32_t rounded = bits + 0x7FFFu + ((bits >> 16) & 1u);
  return uint16_t(rounded >> 16);
}

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// MTX parsing
// ---------------------------------------------------------------------------

// Parse a coordinate-real/integer/pattern general MTX file.
// Two-phase API: call with rows=nullptr to get sizes, then with buffers.
// Returns 0 on success, negative on error.
int mtx_parse(const char* path, int64_t* out_num_rows, int64_t* out_num_cols,
              int64_t* out_nnz, int32_t* rows, int32_t* cols, float* vals) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (std::fread(buf.data(), 1, size, f) != size_t(size)) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);
  buf[size] = '\0';

  char* p = buf.data();
  char* end = buf.data() + size;

  bool pattern = false;
  {  // banner
    char* eol = static_cast<char*>(std::memchr(p, '\n', end - p));
    if (!eol) return -3;
    *eol = '\0';
    if (std::strstr(p, "MatrixMarket") == nullptr) return -3;
    if (std::strstr(p, "pattern")) pattern = true;
    if (std::strstr(p, "symmetric")) return -4;  // handled in Python fallback
    p = eol + 1;
  }
  while (p < end && *p == '%') {  // comments
    char* eol = static_cast<char*>(std::memchr(p, '\n', end - p));
    if (!eol) return -3;
    p = eol + 1;
  }
  int64_t nr = std::strtoll(p, &p, 10);
  int64_t nc = std::strtoll(p, &p, 10);
  int64_t nnz = std::strtoll(p, &p, 10);
  *out_num_rows = nr;
  *out_num_cols = nc;
  *out_nnz = nnz;
  if (rows == nullptr) return 0;  // size query

  for (int64_t i = 0; i < nnz; i++) {
    long r = std::strtol(p, &p, 10);
    long c = std::strtol(p, &p, 10);
    rows[i] = int32_t(r - 1);
    cols[i] = int32_t(c - 1);
    vals[i] = pattern ? 1.0f : std::strtof(p, &p);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Row-major COO sort (by (row, col)), returning the permutation.
// ---------------------------------------------------------------------------

void coo_sort_perm(const int32_t* rows, const int32_t* cols, int64_t nnz,
                   int64_t num_cols, int64_t* perm) {
  for (int64_t i = 0; i < nnz; i++) perm[i] = i;
  std::sort(perm, perm + nnz, [&](int64_t a, int64_t b) {
    if (rows[a] != rows[b]) return rows[a] < rows[b];
    return cols[a] < cols[b];
  });
  (void)num_cols;
}

// Row-major sortedness check (allowing duplicate (row, col) keys).
// Parallel short-circuit scan — the NumPy int64-key formulation costs
// ~3.5 s / 100M nnz of temporaries; this is memory-free and threaded.
// Returns 1 if sorted, 0 otherwise.
int32_t coo_is_sorted(const int32_t* rows, const int32_t* cols, int64_t nnz,
                      int32_t n_threads) {
  if (nnz < 2) return 1;
  if (n_threads <= 0) n_threads = int32_t(std::thread::hardware_concurrency());
  n_threads = std::max(1, std::min(64, int(n_threads)));
  std::atomic<int32_t> ok{1};
  std::vector<std::thread> ts;
  int64_t chunk = cdiv(nnz - 1, n_threads);
  for (int t = 0; t < n_threads; t++) {
    int64_t lo = t * chunk, hi = std::min(nnz - 1, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=, &ok]() {
      for (int64_t i = lo; i < hi; i++) {
        if (rows[i] > rows[i + 1] ||
            (rows[i] == rows[i + 1] && cols[i] > cols[i + 1])) {
          ok.store(0, std::memory_order_relaxed);
          return;
        }
        if ((i & 0xFFFF) == 0 && !ok.load(std::memory_order_relaxed)) return;
      }
    });
  }
  for (auto& th : ts) th.join();
  return ok.load();
}

// ---------------------------------------------------------------------------
// SELL-128 packing (see spmv_topk/formats/sell.py for the format spec).
// ---------------------------------------------------------------------------

// Phase 1: sigma-sort rows by degree (stable desc), compute slice widths.
// degrees: (num_rows), perm/rank out: (num_rows), slice_w out: (num_slices).
void sell_plan(const int32_t* degrees, int64_t num_rows, int64_t width_quantum,
               int32_t sigma_sort, int64_t* perm, int64_t* rank,
               int64_t* slice_w /* num_slices */) {
  for (int64_t i = 0; i < num_rows; i++) perm[i] = i;
  if (sigma_sort) {
    std::stable_sort(perm, perm + num_rows, [&](int64_t a, int64_t b) {
      return degrees[a] > degrees[b];
    });
  }
  for (int64_t i = 0; i < num_rows; i++) rank[perm[i]] = i;
  int64_t num_slices = cdiv(num_rows, kLanes);
  for (int64_t t = 0; t < num_slices; t++) {
    int32_t mx = 0;
    int64_t lo = t * kLanes, hi = std::min(num_rows, lo + kLanes);
    for (int64_t i = lo; i < hi; i++) mx = std::max(mx, degrees[perm[i]]);
    int64_t w = cdiv(std::max<int64_t>(mx, 1), width_quantum) * width_quantum;
    slice_w[t] = w;
  }
}

// Phase 2: scatter nnz into packed words (parallel over nnz ranges).
// rows/cols/vals must be row-major sorted. words: (total_sub * 128) int32
// zero-initialized by the caller. row_start: CSR offsets (num_rows+1).
// slice_off: per-slice word-row offsets (num_slices+1).
void sell_scatter(const int32_t* rows, const int32_t* cols, const float* vals,
                  int64_t nnz, const int64_t* row_start, const int64_t* rank,
                  const int64_t* slice_off, int32_t* words, int32_t n_threads) {
  if (n_threads <= 0) n_threads = int32_t(std::thread::hardware_concurrency());
  n_threads = std::max(1, std::min(64, int(n_threads)));
  std::vector<std::thread> ts;
  int64_t chunk = cdiv(nnz, n_threads);
  for (int t = 0; t < n_threads; t++) {
    int64_t lo = t * chunk, hi = std::min(nnz, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=]() {
      for (int64_t i = lo; i < hi; i++) {
        int32_t r = rows[i];
        int64_t rk = rank[r];
        int64_t lane = rk % kLanes;
        int64_t within = i - row_start[r];
        int64_t sub = slice_off[rk / kLanes] + within;
        uint32_t w = (uint32_t(cols[i]) << 16) | bf16_bits(vals[i]);
        words[sub * kLanes + lane] = int32_t(w);
      }
    });
  }
  for (auto& th : ts) th.join();
}

// ---------------------------------------------------------------------------
// h16 pair-scatter: two nnz per 32-bit word (col10 | val6 per 16-bit
// half, see spmv_topk/formats/sell_buckets.py::_scatter_h16 for the
// layout spec — that NumPy routine stays as the differential oracle, but
// its temporaries cost ~9x the packed size and ~445 s at 1G nnz; this
// in-place threaded loop packs 2G nnz in seconds, the 100M-row BASELINE
// config's setup path).
// ---------------------------------------------------------------------------

// rows/cols/vals row-major sorted. row_start: CSR offsets (num_rows+1).
// rank: sigma-sort rank per row. slice_off: per-slice word-row offsets in
// WORD units (num_slices+1), built from pair degrees ceil(d/2).
// inv_scale = 1 / value_scale. words: (total_sub * 128) int32, zeroed by
// the caller. Threads split on nnz ranges aligned so no (row, pair)
// straddles a boundary (the high half |=s into the low half's word).
void h16_scatter(const int32_t* rows, const int32_t* cols, const float* vals,
                 int64_t nnz, const int64_t* row_start, const int64_t* rank,
                 const int64_t* slice_off, float inv_scale, int32_t* words,
                 int32_t n_threads) {
  if (n_threads <= 0) n_threads = int32_t(std::thread::hardware_concurrency());
  n_threads = std::max(1, std::min(64, int(n_threads)));
  std::vector<int64_t> bounds(n_threads + 1, nnz);
  bounds[0] = 0;
  int64_t chunk = cdiv(nnz, n_threads);
  for (int t = 1; t < n_threads; t++) {
    int64_t lo = std::min(nnz, t * chunk);
    // keep both halves of a pair in one thread: push an odd within-row
    // offset up by one so the partner stays behind the boundary
    if (lo < nnz && ((lo - row_start[rows[lo]]) & 1)) lo++;
    bounds[t] = lo;
  }
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; t++) {
    int64_t lo = bounds[t], hi = bounds[t + 1];
    if (lo >= hi) continue;
    ts.emplace_back([=]() {
      for (int64_t i = lo; i < hi; i++) {
        int32_t r = rows[i];
        int64_t within = i - row_start[r];
        int64_t rk = rank[r];
        int64_t sub = slice_off[rk / kLanes] + (within >> 1);
        float q = std::nearbyint(vals[i] * inv_scale);
        int32_t v6 = int32_t(std::max(-31.0f, std::min(31.0f, q)));
        uint32_t half = uint32_t(cols[i]) | ((uint32_t(v6) & 0x3Fu) << 10);
        uint32_t* w =
            reinterpret_cast<uint32_t*>(words) + sub * kLanes + rk % kLanes;
        if (within & 1) {
          *w |= half << 16;
        } else {
          *w = half;  // low half written first (row-major order)
        }
      }
    });
  }
  for (auto& th : ts) th.join();
}

// ---------------------------------------------------------------------------
// Exact candidate rescoring: per-row CSR dot products against a dense
// query. Serving hot path (api.exact_rescore): the device sweep proposes
// a few hundred candidate rows; their exact f32 scores are ~10^4 FLOPs —
// all overhead in Python, ~5 us here.
// ---------------------------------------------------------------------------

// indptr: (num_rows+1) int64; indices: int32; data: f32; sel: (n_sel)
// int64 row ids (caller guarantees in-range); out: (n_sel) f32 scores.
void csr_rescore(const int64_t* indptr, const int32_t* indices,
                 const float* data, const float* vec, const int64_t* sel,
                 int64_t n_sel, float* out) {
  for (int64_t i = 0; i < n_sel; i++) {
    int64_t r = sel[i];
    float acc = 0.0f;
    for (int64_t j = indptr[r]; j < indptr[r + 1]; j++) {
      acc += data[j] * vec[indices[j]];
    }
    out[i] = acc;
  }
}

// ---------------------------------------------------------------------------
// Multithreaded CPU Top-K SpMV baseline: the role of the reference's
// sparse_dot_topn anchor (awesome_cossim_topn x 40 Xeon threads,
// /root/reference/test_cpu.py:104; 0.4 Gnnz/s on 2x Xeon 6248,
// plot_roofline.py:180-183) — that library is not installable in this
// image, so the fused "SpMV + running top-k, no materialized score
// vector" CPU loop lives here instead. Each thread sweeps a contiguous
// row range of the CSR keeping a k-element min-heap; heaps are merged
// and sorted by (value desc, index asc) at the end.
// ---------------------------------------------------------------------------

void cpu_topk_spmv(const int64_t* indptr, const int32_t* indices,
                   const float* data, const float* vec, int64_t num_rows,
                   int32_t k, int32_t n_threads, int32_t* out_idx,
                   float* out_val) {
  if (n_threads <= 0) n_threads = int32_t(std::thread::hardware_concurrency());
  n_threads = std::max(1, std::min(64, int(n_threads)));
  using Cand = std::pair<float, int32_t>;
  auto better = [](const Cand& a, const Cand& b) {
    // heap comparator: "a ranks before b": heap front = the WORST kept candidate
    return a.first > b.first ||
           (a.first == b.first && a.second < b.second);
  };
  std::vector<std::vector<Cand>> heaps(n_threads);
  std::vector<std::thread> ts;
  int64_t chunk = cdiv(num_rows, n_threads);
  for (int t = 0; t < n_threads; t++) {
    int64_t lo = t * chunk, hi = std::min(num_rows, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=, &heaps]() {
      auto& heap = heaps[t];
      heap.reserve(k + 1);
      for (int64_t r = lo; r < hi; r++) {
        float acc = 0.0f;
        for (int64_t j = indptr[r]; j < indptr[r + 1]; j++) {
          acc += data[j] * vec[indices[j]];
        }
        Cand c{acc, int32_t(r)};
        if (int64_t(heap.size()) < k) {
          heap.push_back(c);
          std::push_heap(heap.begin(), heap.end(), better);
        } else if (better(c, heap.front())) {
          std::pop_heap(heap.begin(), heap.end(), better);
          heap.back() = c;
          std::push_heap(heap.begin(), heap.end(), better);
        }
      }
    });
  }
  for (auto& th : ts) th.join();
  std::vector<Cand> all;
  for (auto& h : heaps) all.insert(all.end(), h.begin(), h.end());
  int64_t kk = std::min<int64_t>(k, all.size());
  std::partial_sort(all.begin(), all.begin() + kk, all.end(), better);
  for (int64_t i = 0; i < kk; i++) {
    out_idx[i] = all[i].second;
    out_val[i] = all[i].first;
  }
  for (int64_t i = kk; i < k; i++) {
    out_idx[i] = -1;
    out_val[i] = 0.0f;
  }
}

}  // extern "C"
