// SWAT block-sparse banded attention forward for Hopper (sm_90a): the
// paper's row-wise fused band (Eq. 1) — QK^T, exp and the V accumulation in
// one kernel, visiting only the kv blocks of the host-built block pattern.
//
// Replaces: src/repro/kernels/swat_attention.py::_attention_fwd_kernel (the
// `swat_attention_fwd` pallas_call), reached by ops._pallas_attention. In the
// port it carries prefill's attention on the card.
//
// What bounds it on an H100: the work is 4*D flops per visible (query, key)
// pair, ~(window+1) pairs per causal row, against Q, K, V, O and the LSE
// moved once. At the serving prefill shapes (L=512, window 256, head dim 64)
// the two bounds (bytes at 3.35 TB/s, bf16 flops at the tensor-core peak)
// are of the same order. At head dim 256 (gemma2-2b) a thread's q row and
// accumulator (2 x 256 floats) exceed the 255-register limit and live in
// local memory: right, and slow. This first version computes QK^T and PV with plain
// fp32 FMAs from shared-memory tiles (no tensor cores, no TMA), so its real
// ceiling is the fp32 FMA rate: it is compute bound. The design keeps every
// intermediate (scores, probabilities, the running max, sum and accumulator)
// in registers, reads each visited K/V tile from device memory once per CTA
// with coalesced loads, and writes only O and the fp32 row LSE. Moving
// QK^T/PV onto wgmma is later work.
//
// Layout: one CTA per (q block, q head, batch); thread r owns query row
// i*block_q + r and its online-softmax state. The CTA reads its own row of
// kv_block_map / slot_kinds (device arrays uploaded once per pattern) and
// loops over those kv blocks in KT-row shared-memory tiles; PAD slots are
// skipped. GQA maps q head h to kv head h / group. The per-element mask is
// element_mask (swat_attention.py:39): band (causal or bidirectional), global
// columns, whole-block RANDOM visibility, causality and kv bounds, in global
// token coordinates (q_offset / kv_offset / seq_kv_bound hooks). K/V rows past
// the buffer read as zeros, as the TPU wrapper's zero padding does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int KT = 32;  // kv rows per shared-memory tile
constexpr int RANDOM_KIND = 3;
constexpr int PAD_KIND = 0;

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

struct Spec {
  int sparse, window, causal, num_global, num_random;
  int q_offset, kv_offset, seq_kv;
  float scale, softcap;
};

template <typename T, int D>
__global__ void attention_fwd_kernel(
    const T* __restrict__ q,  // (B, Hq, Lq, D)
    const T* __restrict__ k,  // (B, Hkv, Lkv, D)
    const T* __restrict__ v,  // (B, Hkv, Lkv, D)
    const int* __restrict__ kv_map,  // (nq, num_slots)
    const int* __restrict__ kinds,   // (nq, num_slots)
    T* __restrict__ out,             // (B, Hq, Lq, D)
    float* __restrict__ lse,         // (B, Hq, Lq)
    int hq, int hkv, int lq, int lkv, int num_slots, int block_q,
    int block_kv, Spec sp) {
  extern __shared__ float smem[];
  float* ks = smem;           // (KT, D)
  float* vs = smem + KT * D;  // (KT, D)
  const int i = blockIdx.x;   // q block
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int r = threadIdx.x;
  const int nthreads = blockDim.x;
  const int hk = h / (hq / hkv);
  const int row = i * block_q + r;
  const bool live = r < block_q && row < lq;
  const size_t qrow = ((size_t)b * hq + h) * lq + row;
  const T* kb = k + ((size_t)b * hkv + hk) * lkv * D;
  const T* vb = v + ((size_t)b * hkv + hk) * lkv * D;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int e = 0; e < D; ++e) {
    qr[e] = live ? to_f(q[qrow * D + e]) * sp.scale : 0.f;
    acc[e] = 0.f;
  }
  float m = NEG_INF, l = 0.f;
  const int q_idx = sp.q_offset + row;

  for (int s = 0; s < num_slots; ++s) {
    const int kind = kinds[i * num_slots + s];
    if (kind == PAD_KIND) continue;  // uniform across the CTA
    const int j = kv_map[i * num_slots + s];
    for (int t0 = 0; t0 < block_kv; t0 += KT) {
      const int ncol = min(KT, block_kv - t0);
      for (int idx = threadIdx.x; idx < KT * D; idx += nthreads) {
        const int c = idx / D, e = idx % D;
        const int lr = j * block_kv + t0 + c;
        const bool in = c < ncol && lr < lkv;
        ks[idx] = in ? to_f(kb[(size_t)lr * D + e]) : 0.f;
        vs[idx] = in ? to_f(vb[(size_t)lr * D + e]) : 0.f;
      }
      __syncthreads();
      if (live) {
        for (int c = 0; c < ncol; ++c) {
          const int k_idx = sp.kv_offset + j * block_kv + t0 + c;
          bool vis = k_idx < sp.seq_kv && k_idx >= 0;
          if (sp.sparse) {
            bool band = k_idx >= q_idx - sp.window;
            if (!sp.causal) band = band && k_idx <= q_idx + sp.window;
            const bool allowed =
                band || (sp.num_global && k_idx < sp.num_global) ||
                (sp.num_random && kind == RANDOM_KIND);
            vis = vis && allowed;
          }
          if (sp.causal) vis = vis && k_idx <= q_idx;
          if (!vis) continue;
          const float* kr = ks + c * D;
          float sc = 0.f;
#pragma unroll
          for (int e = 0; e < D; ++e) sc = fmaf(qr[e], kr[e], sc);
          if (sp.softcap != 0.f) sc = sp.softcap * tanhf(sc / sp.softcap);
          const float* vr = vs + c * D;
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
  }
  if (live) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int e = 0; e < D; ++e) out[qrow * D + e] = from_f<T>(acc[e] * inv);
    lse[qrow] = m + logf(fmaxf(l, 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* kv_map,
           const int* kinds, void* out, float* lse, int b, int hq, int hkv,
           int lq, int lkv, int nq, int num_slots, int block_q, int block_kv,
           Spec sp, cudaStream_t stream) {
  const int threads = ((block_q + 31) / 32) * 32;
  const size_t smem = 2 * KT * D * sizeof(float);
  auto kern = attention_fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(nq, hq, b);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_map, kinds, static_cast<T*>(out), lse, hq,
      hkv, lq, lkv, num_slots, block_q, block_kv, sp);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v,
               const int* kv_map, const int* kinds, void* out, float* lse,
               int b, int hq, int hkv, int lq, int lkv, int nq, int num_slots,
               int block_q, int block_kv, Spec sp, cudaStream_t stream) {
#define SWAT_FWD_CASE(DD)                                                    \
  case DD:                                                                   \
    return launch<T, DD>(q, k, v, kv_map, kinds, out, lse, b, hq, hkv, lq,   \
                         lkv, nq, num_slots, block_q, block_kv, sp, stream);
  switch (d) {
    SWAT_FWD_CASE(16)
    SWAT_FWD_CASE(32)
    SWAT_FWD_CASE(64)
    SWAT_FWD_CASE(128)
    SWAT_FWD_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SWAT_FWD_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it); lse is fp32.
// kv_map / kinds: int32 (nq, num_slots) device arrays. block_q <= 256.
// Returns cudaGetLastError().
extern "C" int swat_attention_fwd(
    const void* q, const void* k, const void* v, const void* kv_map,
    const void* kinds, void* out, void* lse, int b, int hq, int hkv, int lq,
    int lkv, int d, int nq, int num_slots, int block_q, int block_kv,
    int sparse, int window, int causal, int num_global, int num_random,
    int q_offset, int kv_offset, int seq_kv, float scale, float softcap,
    int dtype, void* stream) {
  if (block_q < 1 || block_q > 256 || block_kv < 1 || hkv < 1 ||
      hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  Spec sp{sparse, window, causal, num_global, num_random,
          q_offset, kv_offset, seq_kv, scale, softcap};
  auto st = static_cast<cudaStream_t>(stream);
  const int* km = static_cast<const int*>(kv_map);
  const int* kd = static_cast<const int*>(kinds);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, km, kd, out, ls, b, hq, hkv, lq, lkv,
                             nq, num_slots, block_q, block_kv, sp, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, km, kd, out, ls, b, hq, hkv,
                                     lq, lkv, nq, num_slots, block_q,
                                     block_kv, sp, st);
  return (int)cudaErrorInvalidValue;
}
