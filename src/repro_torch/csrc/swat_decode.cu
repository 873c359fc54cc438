// SWAT fused ring-decode kernel for Hopper (sm_90a): the step's new K/V rows
// are written into their ring slots and the window is attended in the same
// kernel, one CTA per (slot, kv-head).
//
// Replaces: src/repro/kernels/swat_decode.py::_decode_kernel in fused mode
// (the `swat_decode_fused` pallas_call), reached by
// ops.decode_attention(new_kv=...) on every decode token of every layer.
//
// What bounds it on an H100: bytes. A CTA reads its (slot, kv-head) ring of
// `cap` rows of K and V once and does 4*rows*D flops per row, far below the
// ~295 flops/byte the card needs to be compute bound. The design therefore
// streams each K/V row from device memory exactly once (coalesced tile loads
// into shared memory), keeps scores, probabilities and the accumulator in
// registers (nothing intermediate goes back to device memory), and writes
// only the T new rows of the caches plus the output.
//
// Layout: the GQA group of query heads and the T new tokens are packed into
// `rows = group*T` query rows per CTA, as the TPU kernel packs its MXU tile.
// 128 threads: thread (s, r) owns query row r (< rows_pad, rows rounded up to
// a power of two) and the kv columns c with c % split == s of every tile,
// where split = 128 / rows_pad. Each thread keeps its own online-softmax
// state (max, sum, fp32 accumulator of D values); the `split` partial states
// of a row are merged through shared memory at the end. All of this stays
// inside one CTA, so the ring insert needs no cross-CTA ordering: new rows
// are written to device memory, then __syncthreads() makes them visible to
// the CTA's own tile loads (the caches are never read through the
// non-coherent read-only path).
//
// Known limit: at the serving shapes (B=4 slots, 8 kv heads) this launches
// 32 CTAs on 132 SMs. Splitting a (slot, kv-head) across CTAs needs a
// cross-CTA combine and an ordered insert; that is later work.
//
// Masks are rebuilt per column from pos, num_new, ring_cap, num_global and
// window exactly as _decode_kernel does (swat_decode.py:168-188).
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
  const int last = total - 1;
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
        const bool pinned = s < g;
        const int t_ring = last - pmod((last - g) - (s - g), ring);
        const int t_s = pinned ? s : t_ring;
        bool vis = (pinned ? s < total : t_ring >= g) && s < cap;
        if (causal) vis = vis && t_s <= qp;
        if (window) vis = vis && (t_s >= qp - window || pinned);
        if (!vis) continue;
        const float* kr = ks + c * (D + 1);
        float sc = 0.f;
#pragma unroll
        for (int e = 0; e < D; ++e) sc = fmaf(qr[e], kr[e], sc);
        if (softcap != 0.f) sc = softcap * tanhf(sc / softcap);
        const float* vr = vs + c * (D + 1);
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
    }
    __syncthreads();
  }

  // 3. merge the `split` partial states of each row, normalise, store
  float* cm = smem;                      // (THREADS,)
  float* cl = smem + THREADS;            // (THREADS,)
  float* ca = smem + 2 * THREADS;        // (THREADS, D+1)
  cm[tid] = m;
  cl[tid] = l;
#pragma unroll
  for (int e = 0; e < D; ++e) ca[tid * (D + 1) + e] = acc[e];
  __syncthreads();
  for (int idx = tid; idx < rows * D; idx += THREADS) {
    const int rr = idx / D, e = idx % D;
    float mm = NEG_INF;
    for (int s = 0; s < split; ++s) mm = fmaxf(mm, cm[s * rows_pad + rr]);
    float ll = 0.f, aa = 0.f;
    for (int s = 0; s < split; ++s) {
      const int src = s * rows_pad + rr;
      const float f = expf(cm[src] - mm);
      ll = fmaf(cl[src], f, ll);
      aa = fmaf(ca[src * (D + 1) + e], f, aa);
    }
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
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SWAT_DECODE_CASE
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
