// SWAT ring-decode kernels for Hopper (sm_90a), two modes of one TPU kernel.
//
// Fused (`swat_decode_fused`): the step's new K/V rows are written into their
// ring slots and the window is attended in the same kernel, one CTA per
// (slot, kv-head). Replaces src/repro/kernels/swat_decode.py::_decode_kernel
// in fused mode (the `swat_decode_fused` pallas_call), reached by
// ops.decode_attention(new_kv=...) on every decode token of every layer.
//
// Plain (`swat_decode_plain`): attention of the cache's newest T tokens over
// a cache that already holds them, nothing inserted. Replaces the same
// _decode_kernel with fuse=False (the `swat_decode` pallas_call,
// swat_decode.py:368), reached by ops.decode_attention without new_kv: the
// whisper decoder's cross-attention against the encoder's K/V on every decode
// token of every decoder layer.
//
// What bounds both on an H100: bytes. A CTA reads its K and V rows once and
// does 4*rows*D flops per row, far below the ~295 flops/byte the card needs
// to be compute bound. The designs therefore stream each K/V row from device
// memory exactly once (coalesced tile loads into shared memory), keep scores,
// probabilities and the accumulator in registers (nothing intermediate goes
// back to device memory), and write only the output (plus, fused, the T new
// cache rows; plain, one fp32 partial state per row and kv split).
//
// Layout: in packed mode the GQA group of query heads and the T tokens are
// packed into `rows = group*T` query rows per CTA, as the TPU kernel packs
// its MXU tile; unpacked (plain mode only, pack_gqa=False) a CTA serves one
// q head's T rows and reads kv head h / group. 128 threads: thread (s, r)
// owns query row r (< rows_pad, rows rounded up to a power of two) and the
// kv columns c with c % split == s of every tile, where split =
// 128 / rows_pad. Each thread keeps its own online-softmax state (max, sum,
// fp32 accumulator of D values); the `split` partial states of a row are
// merged through shared memory at the end.
//
// Fused: all of this stays inside one CTA, so the ring insert needs no
// cross-CTA ordering: new rows are written to device memory, then
// __syncthreads() makes them visible to the CTA's own tile loads (the caches
// are never read through the non-coherent read-only path). Known limit: at
// the serving shapes (B=4 slots, 8 kv heads) this launches 32 CTAs on 132
// SMs; splitting a (slot, kv-head) across CTAs needs a cross-CTA combine and
// an ordered insert, which is later work.
//
// Plain: nothing is written to the cache, so the kv range is split across
// CTAs (grid: kv splits x (slot, head)); the wrapper picks the split count so
// that the grid covers the card's SMs about twice (whisper-tiny's cross
// attention at 8 clips: 48 (slot, head) pairs x 6 splits of 256 of the 1500
// encoder rows). Each CTA writes its rows' merged (max, sum, accumulator)
// partial state in fp32; a second small kernel combines the splits in a
// fixed order, so the result is deterministic.
//
// Masks are rebuilt per column from pos, num_new, ring_cap, num_global and
// window exactly as _decode_kernel does (slot_visible); plain mode takes
// total = pos and q0 = pos - T (the queries are the newest tokens).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int KT = 64;  // kv rows per shared-memory tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ int pmod(int x, int m) {
  int r = x % m;
  return r < 0 ? r + m : r;
}

// Is cache slot s visible to query token qp, with `total` tokens in the
// cache? Pinned slot s < g holds token s; ring slot s holds the newest
// token congruent to s (mod ring) below `total` (swat_decode.py:168-188).
__device__ __forceinline__ bool slot_visible(int s, int g, int ring,
                                             int total, int qp, int causal,
                                             int window) {
  const int last = total - 1;
  const bool pinned = s < g;
  const int t_ring = last - pmod((last - g) - (s - g), ring);
  const int t_s = pinned ? s : t_ring;
  bool vis = pinned ? s < total : t_ring >= g;
  if (causal) vis = vis && t_s <= qp;
  if (window) vis = vis && (t_s >= qp - window || pinned);
  return vis;
}

// One visible kv column (K row kr, V row vr, in shared memory) into a
// thread's online-softmax state (m, l, acc) for its pre-scaled query row.
template <int D>
__device__ __forceinline__ void online_column(const float* qr,
                                              const float* kr,
                                              const float* vr, float softcap,
                                              float& m, float& l,
                                              float* acc) {
  float sc = 0.f;
#pragma unroll
  for (int e = 0; e < D; ++e) sc = fmaf(qr[e], kr[e], sc);
  if (softcap != 0.f) sc = softcap * tanhf(sc / softcap);
  if (sc > m) {
    const float alpha = expf(m - sc);
    l = l * alpha + 1.f;
#pragma unroll
    for (int e = 0; e < D; ++e) acc[e] = fmaf(acc[e], alpha, vr[e]);
    m = sc;
  } else {
    const float pr = expf(sc - m);
    l += pr;
#pragma unroll
    for (int e = 0; e < D; ++e) acc[e] = fmaf(pr, vr[e], acc[e]);
  }
}

// Every thread's state into shared memory (cm, cl: (THREADS,); ca:
// (THREADS, D+1)), for merge_row after a __syncthreads().
template <int D>
__device__ __forceinline__ void stash_state(float* smem, int tid, float m,
                                            float l, const float* acc) {
  smem[tid] = m;
  smem[THREADS + tid] = l;
#pragma unroll
  for (int e = 0; e < D; ++e) smem[2 * THREADS + tid * (D + 1) + e] = acc[e];
}

// The `split` stashed states of row rr merged in a fixed order: the row's
// max, its sum, and element e of its (unnormalised) accumulator.
template <int D>
__device__ __forceinline__ void merge_row(const float* smem, int split,
                                          int rows_pad, int rr, int e,
                                          float& mm, float& ll, float& aa) {
  const float* cm = smem;
  const float* cl = smem + THREADS;
  const float* ca = smem + 2 * THREADS;
  mm = NEG_INF;
  for (int s = 0; s < split; ++s) mm = fmaxf(mm, cm[s * rows_pad + rr]);
  ll = 0.f;
  aa = 0.f;
  for (int s = 0; s < split; ++s) {
    const int src = s * rows_pad + rr;
    const float f = expf(cm[src] - mm);
    ll = fmaf(cl[src], f, ll);
    aa = fmaf(ca[src * (D + 1) + e], f, aa);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) decode_fused_kernel(
    const T* __restrict__ q,  // (B, Hkv, rows, D), rows = group*T
    T* kc, T* vc,             // (B, Hkv, W, D), updated in place
    const T* __restrict__ nk, const T* __restrict__ nv,  // (B, Hkv, T, D)
    const int* __restrict__ pos, const int* __restrict__ num_new,
    T* __restrict__ out,  // (B, Hkv, rows, D)
    int hkv, int rows, int rows_pad, int tspan, int w, int cap, int g,
    int window, int causal, float scale, float softcap) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;  // b * hkv + h
  const int b = bh / hkv;
  const int tid = threadIdx.x;
  const int split = THREADS / rows_pad;
  const int r = tid % rows_pad;
  const int sidx = tid / rows_pad;
  const bool live = r < rows;
  const int p = pos[b];
  const int nn = num_new[b];
  const int ring = cap - g;
  T* kb = kc + (size_t)bh * w * D;
  T* vb = vc + (size_t)bh * w * D;

  // 1. ring insert: token p+j -> slot g + (p+j-g) mod ring (pinned below g);
  //    rows j >= num_new are not written. T <= ring, so slots are distinct.
  for (int j = 0; j < tspan && j < nn; ++j) {
    const int pj = p + j;
    const int slot = pj < g ? pj : g + pmod(pj - g, ring);
    const T* sk = nk + ((size_t)bh * tspan + j) * D;
    const T* sv = nv + ((size_t)bh * tspan + j) * D;
    for (int e = tid; e < D; e += THREADS) {
      kb[(size_t)slot * D + e] = sk[e];
      vb[(size_t)slot * D + e] = sv[e];
    }
  }
  __syncthreads();  // the inserted rows are visible to this CTA's loads

  // 2. this thread's query row, pre-scaled, in registers
  float qr[D];
  float acc[D];
#pragma unroll
  for (int e = 0; e < D; ++e) {
    qr[e] = live ? to_f(q[((size_t)bh * rows + r) * D + e]) * scale : 0.f;
    acc[e] = 0.f;
  }
  float m = NEG_INF, l = 0.f;
  const int total = p + nn;
  const int qp = p + r % tspan;  // absolute token index of this query row

  float* ks = smem;                 // (KT, D+1)
  float* vs = smem + KT * (D + 1);  // (KT, D+1)
  const int ntiles = (cap + KT - 1) / KT;  // rows >= cap are never visible
  for (int t = 0; t < ntiles; ++t) {
    const int base = t * KT;
    for (int idx = tid; idx < KT * D; idx += THREADS) {
      const int c = idx / D, e = idx % D;
      const int row = base + c;
      const bool in = row < w;
      ks[c * (D + 1) + e] = in ? to_f(kb[(size_t)row * D + e]) : 0.f;
      vs[c * (D + 1) + e] = in ? to_f(vb[(size_t)row * D + e]) : 0.f;
    }
    __syncthreads();
    if (live) {
      for (int c = sidx; c < KT; c += split) {
        const int s = base + c;
        if (s >= cap || !slot_visible(s, g, ring, total, qp, causal, window))
          continue;
        online_column<D>(qr, ks + c * (D + 1), vs + c * (D + 1), softcap, m,
                         l, acc);
      }
    }
    __syncthreads();
  }

  // 3. merge the `split` partial states of each row, normalise, store
  stash_state<D>(smem, tid, m, l, acc);
  __syncthreads();
  for (int idx = tid; idx < rows * D; idx += THREADS) {
    const int rr = idx / D, e = idx % D;
    float mm, ll, aa;
    merge_row<D>(smem, split, rows_pad, rr, e, mm, ll, aa);
    out[((size_t)bh * rows + rr) * D + e] = from_f<T>(aa / fmaxf(ll, 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, void* kc, void* vc, const void* nk, const void* nv,
           const int* pos, const int* nn, void* out, int b, int hkv, int rows,
           int tspan, int w, int cap, int g, int window, int causal,
           float scale, float softcap, cudaStream_t stream) {
  int rows_pad = 1;
  while (rows_pad < rows) rows_pad <<= 1;
  const size_t tile = 2 * KT * (D + 1) * sizeof(float);
  const size_t comb = (2 * THREADS + THREADS * (D + 1)) * sizeof(float);
  const size_t smem = tile > comb ? tile : comb;
  auto kern = decode_fused_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<b * hkv, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(kc), static_cast<T*>(vc),
      static_cast<const T*>(nk), static_cast<const T*>(nv), pos, nn,
      static_cast<T*>(out), hkv, rows, rows_pad, tspan, w, cap, g, window,
      causal, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* q, void* kc, void* vc, const void* nk,
               const void* nv, const int* pos, const int* nn, void* out,
               int b, int hkv, int rows, int tspan, int w, int cap, int g,
               int window, int causal, float scale, float softcap,
               cudaStream_t stream) {
#define SWAT_DECODE_CASE(DD)                                                 \
  case DD:                                                                   \
    return launch<T, DD>(q, kc, vc, nk, nv, pos, nn, out, b, hkv, rows,      \
                         tspan, w, cap, g, window, causal, scale, softcap,   \
                         stream);
  switch (d) {
    SWAT_DECODE_CASE(16)
    SWAT_DECODE_CASE(32)
    SWAT_DECODE_CASE(64)
    SWAT_DECODE_CASE(128)
    SWAT_DECODE_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SWAT_DECODE_CASE
}


// ------------------------------------------------------------ plain mode ---

// kv rows per shared-memory tile in plain mode: one row per thread at D <= 64
// (whisper's single-row cross attention keeps all 128 threads busy), fewer
// where two fp32 (KT, D+1) tiles would outgrow shared memory
template <int D>
__host__ __device__ constexpr int plain_kt() { return D <= 64 ? 128 : (D <= 128 ? 64 : 32); }

// 16 bytes of T (8 bf16 or 4 fp32 values) widened to fp32
__device__ __forceinline__ void widen(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen(const uint4& u, float* f,
                                      __nv_bfloat16) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Rows [row0, row0 + KT) of a (rows, D) slice into a (KT, D+1) fp32 shared
// tile, with 16-byte loads (the wrapper checks the alignment); rows at or
// past `hi` read as zeros.
template <typename T, int D, int KT>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int hi, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  constexpr int NV = KT * PER_ROW;
  static_assert(D % VEC == 0 && NV % THREADS == 0, "tile shape");
#pragma unroll
  for (int it = 0; it < NV / THREADS; ++it) {
    const int i = it * THREADS + tid;
    const int c = i / PER_ROW, e0 = (i % PER_ROW) * VEC;
    const int row = row0 + c;
    float f[VEC];
    if (row < hi) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(
          src + (size_t)row * D + e0));
      widen(u, f, T());
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) f[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[c * (D + 1) + e0 + j] = f[j];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) decode_plain_partial_kernel(
    const T* __restrict__ q,  // (B, grid_h, rows, D)
    const T* __restrict__ kc, const T* __restrict__ vc,  // (B, Hkv, W, D)
    const int* __restrict__ pos,  // (B,) tokens in the cache
    float* __restrict__ part_m, float* __restrict__ part_l,  // (BH, S, rows)
    float* __restrict__ part_acc,  // (BH, S, rows, D)
    int grid_h, int heads_per_kv, int hkv, int rows, int rows_pad, int tspan,
    int w, int cap, int g, int window, int causal, int chunk, float scale,
    float softcap) {
  constexpr int KT = plain_kt<D>();
  extern __shared__ float smem[];
  const int split_idx = blockIdx.x;
  const int nsplit = gridDim.x;
  const int bh = blockIdx.y;  // b * grid_h + h
  const int b = bh / grid_h;
  const int kvh = (bh % grid_h) / heads_per_kv;
  const int tid = threadIdx.x;
  const int split = THREADS / rows_pad;
  const int r = tid % rows_pad;
  const int sidx = tid / rows_pad;
  const bool live = r < rows;
  const int total = pos[b];
  const int ring = cap - g;
  const int qp = total - tspan + r % tspan;  // this query row's token index
  const T* kb = kc + ((size_t)b * hkv + kvh) * w * D;
  const T* vb = vc + ((size_t)b * hkv + kvh) * w * D;
  const int lo = split_idx * chunk;
  const int hi = min(lo + chunk, cap);  // slots >= cap are never visible

  float qr[D];
  float acc[D];
#pragma unroll
  for (int e = 0; e < D; ++e) {
    qr[e] = live ? to_f(q[((size_t)bh * rows + r) * D + e]) * scale : 0.f;
    acc[e] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  float* ks = smem;                 // (KT, D+1)
  float* vs = smem + KT * (D + 1);  // (KT, D+1)
  for (int base = lo; base < hi; base += KT) {
    load_tile<T, D, KT>(ks, kb, base, hi, tid);
    load_tile<T, D, KT>(vs, vb, base, hi, tid);
    __syncthreads();
    if (live) {
      for (int c = sidx; c < KT; c += split) {
        const int s = base + c;
        if (s >= hi) break;
        if (!slot_visible(s, g, ring, total, qp, causal, window)) continue;
        online_column<D>(qr, ks + c * (D + 1), vs + c * (D + 1), softcap, m,
                         l, acc);
      }
    }
    __syncthreads();
  }

  // merge the `split` thread states of each row into this CTA's partial
  // state (unnormalised)
  stash_state<D>(smem, tid, m, l, acc);
  __syncthreads();
  const size_t prow = ((size_t)bh * nsplit + split_idx) * rows;
  for (int idx = tid; idx < rows * D; idx += THREADS) {
    const int rr = idx / D, e = idx % D;
    float mm, ll, aa;
    merge_row<D>(smem, split, rows_pad, rr, e, mm, ll, aa);
    part_acc[(prow + rr) * D + e] = aa;
    if (e == 0) {
      part_m[prow + rr] = mm;
      part_l[prow + rr] = ll;
    }
  }
}

// out[row] = sum_s acc_s exp(m_s - M) / sum_s l_s exp(m_s - M), splits in
// order; one thread per output element
template <typename T, int D>
__global__ void decode_plain_combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, T* __restrict__ out, int n_rows,
    int rows, int nsplit) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_rows * D) return;
  const int row = idx / D, e = idx % D;  // row = bh * rows + rr
  const int bh = row / rows, rr = row % rows;
  const size_t p0 = (size_t)bh * nsplit * rows + rr;
  float mm = NEG_INF;
  for (int s = 0; s < nsplit; ++s) mm = fmaxf(mm, part_m[p0 + s * rows]);
  float ll = 0.f, aa = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const size_t src = p0 + (size_t)s * rows;
    const float f = expf(part_m[src] - mm);
    ll = fmaf(part_l[src], f, ll);
    aa = fmaf(part_acc[src * D + e], f, aa);
  }
  out[(size_t)row * D + e] = from_f<T>(aa / fmaxf(ll, 1e-30f));
}

struct PlainArgs {
  const void *q, *kc, *vc;
  const int* pos;
  float *part_m, *part_l, *part_acc;
  void* out;
  int b, grid_h, heads_per_kv, hkv, rows, tspan, w, cap, g, window, causal,
      chunk, nsplit;
  float scale, softcap;
};

template <typename T, int D>
int launch_plain(const PlainArgs& a, cudaStream_t stream) {
  constexpr int KT = plain_kt<D>();
  int rows_pad = 1;
  while (rows_pad < a.rows) rows_pad <<= 1;
  const size_t tile = 2 * KT * (D + 1) * sizeof(float);
  const size_t comb = (2 * THREADS + THREADS * (D + 1)) * sizeof(float);
  const size_t smem = tile > comb ? tile : comb;
  auto kern = decode_plain_partial_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_bh = a.b * a.grid_h;
  dim3 grid(a.nsplit, n_bh);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kc),
      static_cast<const T*>(a.vc), a.pos, a.part_m, a.part_l, a.part_acc,
      a.grid_h, a.heads_per_kv, a.hkv, a.rows, rows_pad, a.tspan, a.w,
      a.cap, a.g, a.window, a.causal, a.chunk, a.scale, a.softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_rows = n_bh * a.rows;
  const int cthreads = 256;
  decode_plain_combine_kernel<T, D>
      <<<(n_rows * D + cthreads - 1) / cthreads, cthreads, 0, stream>>>(
          a.part_m, a.part_l, a.part_acc, static_cast<T*>(a.out), n_rows,
          a.rows, a.nsplit);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_plain(int d, const PlainArgs& a, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_plain<T, 16>(a, stream);
    case 32: return launch_plain<T, 32>(a, stream);
    case 64: return launch_plain<T, 64>(a, stream);
    case 128: return launch_plain<T, 128>(a, stream);
    case 256: return launch_plain<T, 256>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, caches, new rows and out share it).
// pos / num_new: int32 (B,) device arrays. Returns cudaGetLastError().
extern "C" int swat_decode_fused(const void* q, void* k_cache, void* v_cache,
                                 const void* new_k, const void* new_v,
                                 const void* pos, const void* num_new,
                                 void* out, int b, int hkv, int rows,
                                 int tspan, int d, int w, int cap, int g,
                                 int window, int causal, float scale,
                                 float softcap, int dtype, void* stream) {
  if (rows < 1 || rows > THREADS || tspan < 1 || cap > w || cap <= g)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* n = static_cast<const int*>(num_new);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k_cache, v_cache, new_k, new_v, p, n, out,
                             b, hkv, rows, tspan, w, cap, g, window, causal,
                             scale, softcap, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k_cache, v_cache, new_k, new_v, p,
                                     n, out, b, hkv, rows, tspan, w, cap, g,
                                     window, causal, scale, softcap, st);
  return (int)cudaErrorInvalidValue;
}

// Plain mode's kv rows per tile at head dim d (a split's chunk must be a
// whole number of tiles), or -1 for a head dim it does not take.
extern "C" int swat_decode_plain_tile(int d) {
  switch (d) {
    case 16: return plain_kt<16>();
    case 32: return plain_kt<32>();
    case 64: return plain_kt<64>();
    case 128: return plain_kt<128>();
    case 256: return plain_kt<256>();
    default: return -1;
  }
}

// Plain mode. q / out: (B, grid_h, rows, D), grid_h = Hkv and rows = group*T
// when packed (heads_per_kv = 1), grid_h = Hq and rows = T when not
// (heads_per_kv = group). pos: int32 (B,) tokens in the cache. part_m /
// part_l: fp32 (B*grid_h, nsplit, rows); part_acc: fp32 (B*grid_h, nsplit,
// rows, D) scratch; split i covers cache rows [i*chunk, (i+1)*chunk) of
// [0, cap), a whole number of swat_decode_plain_tile(d) rows. Launches the
// partial kernel and the combine kernel on `stream`.
// Returns cudaGetLastError().
extern "C" int swat_decode_plain(
    const void* q, const void* k_cache, const void* v_cache, const void* pos,
    void* part_m, void* part_l, void* part_acc, void* out, int b, int grid_h,
    int heads_per_kv, int hkv, int rows, int tspan, int d, int w, int cap,
    int g, int window, int causal, int chunk, int nsplit, float scale,
    float softcap, int dtype, void* stream) {
  if (rows < 1 || rows > THREADS || tspan < 1 || cap > w || cap <= g ||
      chunk < 1 || nsplit < 1 || (long)chunk * nsplit < cap ||
      swat_decode_plain_tile(d) < 1 || chunk % swat_decode_plain_tile(d) ||
      heads_per_kv < 1 || grid_h != hkv * heads_per_kv)
    return (int)cudaErrorInvalidValue;
  PlainArgs a{q, k_cache, v_cache, static_cast<const int*>(pos),
              static_cast<float*>(part_m), static_cast<float*>(part_l),
              static_cast<float*>(part_acc), out, b, grid_h, heads_per_kv,
              hkv, rows, tspan, w, cap, g, window, causal, chunk, nsplit,
              scale, softcap};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_plain<float>(d, a, st);
  if (dtype == 1) return dispatch_plain<__nv_bfloat16>(d, a, st);
  return (int)cudaErrorInvalidValue;
}
