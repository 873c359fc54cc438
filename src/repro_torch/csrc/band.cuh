// The band mask of the SWAT attention kernels (element_mask,
// src/repro/kernels/swat_attention.py:39), shared by the forward and
// backward sources: per element, and over whole tiles for the tensor-core
// kernels, which skip tiles with no visible pair and drop the mask on tiles
// where every pair is visible.
#pragma once
#include <limits.h>

constexpr int PAD_KIND = 0;
constexpr int RANDOM_KIND = 3;

struct Spec {
  int sparse, window, causal, num_global, num_random;
  int q_offset, kv_offset, seq_kv;
  float scale, softcap;
};

// Is key k_idx visible to query q_idx (global coordinates) in a slot of
// kind `kind`?
__device__ __forceinline__ bool visible(const Spec& sp, int q_idx, int k_idx,
                                        int kind) {
  bool vis = k_idx < sp.seq_kv && k_idx >= 0;
  if (sp.sparse) {
    bool band = k_idx >= q_idx - sp.window;
    if (!sp.causal) band = band && k_idx <= q_idx + sp.window;
    const bool allowed = band || (sp.num_global && k_idx < sp.num_global) ||
                         (sp.num_random && kind == RANDOM_KIND);
    vis = vis && allowed;
  }
  if (sp.causal) vis = vis && k_idx <= q_idx;
  return vis;
}

// Is some key of [k0, k1] visible to some query of [q0, q1]? The queries'
// bands [q - window, q (+ window)] tile one interval, so the test is exact.
__device__ __forceinline__ bool any_visible(const Spec& sp, int q0, int q1,
                                            int k0, int k1, int kind) {
  if (k1 < 0 || k0 >= sp.seq_kv) return false;
  if (sp.causal && k0 > q1) return false;
  if (!sp.sparse) return true;
  if (sp.num_random && kind == RANDOM_KIND) return true;
  if (sp.num_global && k0 < sp.num_global) return true;
  if (k1 < q0 - sp.window) return false;
  return sp.causal || k0 <= q1 + sp.window;
}

// Is every key of [k0, k1] visible to every query of [q0, q1]?
__device__ __forceinline__ bool all_visible(const Spec& sp, int q0, int q1,
                                            int k0, int k1, int kind) {
  if (k0 < 0 || k1 >= sp.seq_kv) return false;
  if (sp.causal && k1 > q0) return false;
  if (!sp.sparse) return true;
  if (sp.num_random && kind == RANDOM_KIND) return true;
  if (sp.num_global && k1 < sp.num_global) return true;
  return k0 >= q1 - sp.window && (sp.causal || k1 <= q0 + sp.window);
}

// A thread of a wgmma accumulator (m64nN) holds, in each of its rows, the
// columns off + 8 * (j / 2) + j % 2 for j < N / 4 (off = 2 * (lane % 4)).
// Bit j of the result is set when that column, counted from off, lies in
// [a, b]. For N <= 64.
__device__ __forceinline__ uint32_t cols_in(int a, int b) {
  auto below = [](int x) {  // how many of the thread's columns are < x
    x = min(max(x, 0), 64);
    return 2 * (x >> 3) + min(x & 7, 2);
  };
  const int lo = below(a), hi = below(b + 1);
  return hi > lo ? ((1u << hi) - 1u) & ~((1u << lo) - 1u) : 0u;
}

// The keys of [k0, k0 + ncol) visible to query q, in tile columns c
// (key k0 + c): those with lo <= c <= hi and (c <= ghi or blo <= c <= bhi)
// (bounds and causality; then the global columns or the band).
struct KeyRange {
  int lo, hi, ghi, blo, bhi;
  // as cols_in's bits, for a tile whose column 0 is this thread's first
  __device__ __forceinline__ uint32_t bits() const {
    return cols_in(lo, min(hi, ghi)) | cols_in(max(lo, blo), min(hi, bhi));
  }
};

__device__ __forceinline__ KeyRange key_range(const Spec& sp, int q, int k0,
                                              int ncol, int kind) {
  KeyRange r;
  r.lo = max(0, -k0);
  r.hi = min(ncol, sp.seq_kv - k0) - 1;
  if (sp.causal) r.hi = min(r.hi, q - k0);
  if (!sp.sparse || (sp.num_random && kind == RANDOM_KIND)) {
    r.ghi = INT_MAX;  // no band restriction
    r.blo = 0;
    r.bhi = -1;
  } else {
    r.ghi = sp.num_global ? sp.num_global - 1 - k0 : -1;
    r.blo = q - sp.window - k0;
    r.bhi = sp.causal ? INT_MAX : q + sp.window - k0;
  }
  return r;
}

// The queries of [q0, q0 + nq) that see key k, in tile columns c (query
// q0 + c): lo <= c <= hi. A global key is seen by every query the bounds
// and causality allow, so the range is one interval.
__device__ __forceinline__ int2 query_range(const Spec& sp, int k, int q0,
                                            int nq, int kind) {
  int lo = 0, hi = nq - 1;
  if (k < 0 || k >= sp.seq_kv) hi = -1;
  if (sp.causal) lo = max(lo, k - q0);
  if (sp.sparse && !(sp.num_global && k < sp.num_global) &&
      !(sp.num_random && kind == RANDOM_KIND)) {
    hi = min(hi, k + sp.window - q0);
    if (!sp.causal) lo = max(lo, k - sp.window - q0);
  }
  return make_int2(lo, hi);
}
