// SWAT block-sparse banded attention backward for Hopper (sm_90a): the
// gradient of the row-wise fused band (paper Eq. 1) in two kernels, dQ and
// dK/dV, both visiting only the blocks of the host-built block pattern.
//
// Replaces: src/repro/kernels/swat_backward.py::_dq_kernel (the
// `swat_attention_dq` pallas_call) and ::_dkv_kernel (`swat_attention_dkv`),
// reached by swat_attention_bwd from ops._pallas_attention's custom VJP. In
// the port they carry training's attention gradient (kernels/ops.py
// _SwatAttentionFn.backward).
//
// What bounds them on an H100: per visible (query, key) pair dQ does 6*D
// flops (the score, dO.V^T and ds.K) and dK/dV 8*D (the score, dO.V^T,
// ds^T.Q and P^T.dO), against Q, K, V, dO, the LSE and delta read once and
// the gradients written once. At the training shapes (B=4, 32 q heads,
// 8 kv heads, L=2048, window 256, D=64) the two bounds are of the same
// order (~0.03 ms each). This first version does the products with plain
// fp32 FMAs from shared-memory tiles (no tensor cores, no TMA), so its real
// ceiling is the fp32 FMA rate and shared-memory bandwidth: it is compute
// bound. Both kernels keep scores, probabilities and the gradient
// accumulators in registers, read every visited tile from device memory
// once per CTA with coalesced loads, and write each output row exactly once.
// Moving the products onto mma.sync/wgmma is later work.
//
// dQ: one CTA per (q block, q head, batch), thread r owns query row r: its
// scaled q row and fp32 dQ accumulator in registers, its dO row in its own
// shared-memory row. The CTA walks its row of kv_block_map / slot_kinds (the
// forward's schedule) in KT-row K/V tiles.
//
// dK/dV: one CTA per (kv block, KV head, batch), thread c owns kv row c: its
// K and V rows in its own shared-memory rows, the fp32 dK and dV
// accumulators in registers. The CTA loops over the `group` q heads of its
// kv head and, for each, over its row of the inverse pattern
// (BlockPattern.inverse()), in QT-row Q/dO tiles. Summing the GQA group
// inside the CTA replaces the TPU design's per-q-head (B, Hq, Lkv, D)
// outputs summed outside (swat_backward.py:235-237): fewer bytes and no
// cross-CTA reduction. Kv block 0 holds the global columns and every q
// block visits it, so its CTAs do ~nq times the row visits of the others:
// a load imbalance left for later work.
//
// Head dim 256 (gemma2-2b): both kernels keep their structure, but a
// thread's D-wide register rows (q and dQ; dK and dV) spill to local memory,
// and dK/dV keeps the thread's own K and V rows in local memory too, since
// at block_kv 128 they would need 266 KB of shared memory. Right, and slow.
//
// Deterministic by construction: no atomics and no split reductions; every
// accumulator is summed by one thread in a fixed order, so two launches on
// the same inputs give bitwise-equal outputs.
//
// Masking is explicit, not by zero padding: only visible pairs contribute,
// visibility is element_mask (swat_attention.py:39) in global coordinates
// (band causal or bidirectional, global columns, whole-block RANDOM slots,
// kv bounds, causality), query rows at or past Lq and kv rows at or past
// Lkv or the kv bound are skipped. p = exp(s - lse) with the forward's LSE;
// ds = p * (dp - delta) times the softcap chain 1 - tanh^2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int KT = 32;  // kv rows per shared-memory tile (dQ)
constexpr int QT = 32;  // q rows per shared-memory tile (dK/dV)
constexpr int RANDOM_KIND = 3;
constexpr int PAD_KIND = 0;
constexpr size_t MAX_SMEM = 232448;  // per block on an H100

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

// element_mask: is key k_idx visible to query q_idx (global coordinates) in
// a slot of kind `kind`?
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

// dot of two D-float rows in shared memory / registers, 4 lanes at a time
template <int D>
__device__ __forceinline__ float dot_rs(const float* reg, const float* sm) {
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < D; e += 4) {
    const float4 b = *reinterpret_cast<const float4*>(sm + e);
    acc = fmaf(reg[e], b.x, acc);
    acc = fmaf(reg[e + 1], b.y, acc);
    acc = fmaf(reg[e + 2], b.z, acc);
    acc = fmaf(reg[e + 3], b.w, acc);
  }
  return acc;
}

template <int D>
__device__ __forceinline__ float dot_ss(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < D; e += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + e);
    const float4 y = *reinterpret_cast<const float4*>(b + e);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

// acc[e] += w * row[e] for a shared-memory row
template <int D>
__device__ __forceinline__ void axpy(float* acc, float w, const float* sm) {
#pragma unroll
  for (int e = 0; e < D; e += 4) {
    const float4 b = *reinterpret_cast<const float4*>(sm + e);
    acc[e] = fmaf(w, b.x, acc[e]);
    acc[e + 1] = fmaf(w, b.y, acc[e + 1]);
    acc[e + 2] = fmaf(w, b.z, acc[e + 2]);
    acc[e + 3] = fmaf(w, b.w, acc[e + 3]);
  }
}

// Capped score and its chain factor d(capped)/d(raw) (1 when no cap).
__device__ __forceinline__ float capped(const Spec& sp, float s, float* chain) {
  if (sp.softcap != 0.f) {
    const float t = tanhf(s / sp.softcap);
    *chain = 1.f - t * t;
    return sp.softcap * t;
  }
  *chain = 1.f;
  return s;
}

// ------------------------------------------------------------------ dQ ---

template <typename T, int D>
__global__ void attention_dq_kernel(
    const T* __restrict__ q,      // (B, Hq, Lq, D)
    const T* __restrict__ k,      // (B, Hkv, Lkv, D)
    const T* __restrict__ v,      // (B, Hkv, Lkv, D)
    const T* __restrict__ dout,   // (B, Hq, Lq, D)
    const float* __restrict__ lse,    // (B, Hq, Lq)
    const float* __restrict__ delta,  // (B, Hq, Lq)
    const int* __restrict__ kv_map,   // (nq, num_slots)
    const int* __restrict__ kinds,    // (nq, num_slots)
    T* __restrict__ dq,               // (B, Hq, Lq, D)
    int hq, int hkv, int lq, int lkv, int num_slots, int block_q,
    int block_kv, Spec sp) {
  constexpr int DP = D + 4;  // padded own-row stride: conflict-free float4
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // (KT, D)
  float* vs = ks + KT * D;                      // (KT, D)
  float* dos = vs + KT * D;                     // (blockDim.x, DP)
  const int i = blockIdx.x;
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
  float* dor = dos + r * DP;
#pragma unroll
  for (int e = 0; e < D; ++e) {
    qr[e] = live ? to_f(q[qrow * D + e]) * sp.scale : 0.f;
    dor[e] = live ? to_f(dout[qrow * D + e]) : 0.f;
    acc[e] = 0.f;
  }
  const float lse_r = live ? lse[qrow] : 0.f;
  const float delta_r = live ? delta[qrow] : 0.f;
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
          const int lr = j * block_kv + t0 + c;
          if (lr >= lkv || !visible(sp, q_idx, sp.kv_offset + lr, kind))
            continue;
          const float* kr = ks + c * D;
          float chain;
          const float sc = capped(sp, dot_rs<D>(qr, kr), &chain);
          const float p = expf(sc - lse_r);
          const float dp = dot_ss<D>(dor, vs + c * D);
          const float ds = p * (dp - delta_r) * chain;
          axpy<D>(acc, ds, kr);
        }
      }
      __syncthreads();
    }
  }
  if (live) {
#pragma unroll
    for (int e = 0; e < D; ++e) dq[qrow * D + e] = from_f<T>(acc[e] * sp.scale);
  }
}

// ---------------------------------------------------------------- dK/dV ---

// Whether a dK/dV thread keeps its own K and V rows in shared memory (padded
// rows, conflict-free float4 reads) or, at D=256, in its own local memory.
template <int D>
__host__ __device__ constexpr bool own_rows_in_smem() { return D <= 128; }

template <typename T, int D>
__global__ void attention_dkv_kernel(
    const T* __restrict__ q,      // (B, Hq, Lq, D)
    const T* __restrict__ k,      // (B, Hkv, Lkv, D)
    const T* __restrict__ v,      // (B, Hkv, Lkv, D)
    const T* __restrict__ dout,   // (B, Hq, Lq, D)
    const float* __restrict__ lse,    // (B, Hq, Lq)
    const float* __restrict__ delta,  // (B, Hq, Lq)
    const int* __restrict__ q_map,    // (nkv, num_inv_slots)
    const int* __restrict__ ikinds,   // (nkv, num_inv_slots)
    T* __restrict__ dk,               // (B, Hkv, Lkv, D)
    T* __restrict__ dv,               // (B, Hkv, Lkv, D)
    int hq, int hkv, int lq, int lkv, int num_slots, int block_q,
    int block_kv, Spec sp) {
  constexpr int DP = D + 4;
  constexpr bool kOwnSmem = own_rows_in_smem<D>();
  extern __shared__ float4 smem4[];
  float* kown = reinterpret_cast<float*>(smem4);  // (blockDim.x, DP)
  float* vown = kown + (kOwnSmem ? blockDim.x * DP : 0);  // (blockDim.x, DP)
  float* qs = vown + (kOwnSmem ? blockDim.x * DP : 0);    // (QT, D), q*scale
  float* dos = qs + QT * D;                       // (QT, D)
  float* ls = dos + QT * D;                       // (QT)
  float* dls = ls + QT;                           // (QT)
  const int j = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int c = threadIdx.x;
  const int nthreads = blockDim.x;
  const int group = hq / hkv;
  const int col = j * block_kv + c;
  const bool live = c < block_kv && col < lkv;
  const int k_idx = sp.kv_offset + col;
  const size_t krow = ((size_t)b * hkv + hk) * lkv + col;

  // above D=128 the own rows (2 x 128 x 260 floats) outgrow shared memory
  // and stay with the thread, in local memory
  alignas(16) float kloc[kOwnSmem ? 4 : D];
  alignas(16) float vloc[kOwnSmem ? 4 : D];
  float* kr = kOwnSmem ? kown + c * DP : kloc;
  float* vr = kOwnSmem ? vown + c * DP : vloc;
  float dk_acc[D];
  float dv_acc[D];
#pragma unroll
  for (int e = 0; e < D; ++e) {
    kr[e] = live ? to_f(k[krow * D + e]) : 0.f;
    vr[e] = live ? to_f(v[krow * D + e]) : 0.f;
    dk_acc[e] = 0.f;
    dv_acc[e] = 0.f;
  }

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const size_t hbase = ((size_t)b * hq + h) * lq;  // row 0 of (b, h)
    for (int s = 0; s < num_slots; ++s) {
      const int kind = ikinds[j * num_slots + s];
      if (kind == PAD_KIND) continue;  // uniform across the CTA
      const int i = q_map[j * num_slots + s];
      for (int r0 = 0; r0 < block_q; r0 += QT) {
        const int first = i * block_q + r0;
        const int nrow = min(min(QT, block_q - r0), lq - first);
        if (nrow <= 0) break;  // uniform: the rest of the block is past Lq
        for (int idx = threadIdx.x; idx < QT * D; idx += nthreads) {
          const int rr = idx / D, e = idx % D;
          const bool in = rr < nrow;
          const size_t off = (hbase + first + rr) * D + e;
          qs[idx] = in ? to_f(q[off]) * sp.scale : 0.f;
          dos[idx] = in ? to_f(dout[off]) : 0.f;
        }
        for (int rr = threadIdx.x; rr < QT; rr += nthreads) {
          const bool in = rr < nrow;
          ls[rr] = in ? lse[hbase + first + rr] : 0.f;
          dls[rr] = in ? delta[hbase + first + rr] : 0.f;
        }
        __syncthreads();
        if (live) {
          for (int rr = 0; rr < nrow; ++rr) {
            if (!visible(sp, sp.q_offset + first + rr, k_idx, kind)) continue;
            const float* qrow = qs + rr * D;
            const float* dorow = dos + rr * D;
            float chain;
            const float sc = capped(sp, dot_ss<D>(qrow, kr), &chain);
            const float p = expf(sc - ls[rr]);
            axpy<D>(dv_acc, p, dorow);
            const float dp = dot_ss<D>(dorow, vr);
            const float ds = p * (dp - dls[rr]) * chain;
            axpy<D>(dk_acc, ds, qrow);
          }
        }
        __syncthreads();
      }
    }
  }
  if (live) {
#pragma unroll
    for (int e = 0; e < D; ++e) {
      dk[krow * D + e] = from_f<T>(dk_acc[e]);
      dv[krow * D + e] = from_f<T>(dv_acc[e]);
    }
  }
}

// -------------------------------------------------------------- launch ---

template <typename K>
int set_smem(K kern, size_t smem) {
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int *map, *kinds;
  void *out0, *out1;
  int b, hq, hkv, lq, lkv, nblocks, num_slots, block_q, block_kv;
};

template <typename T, int D>
int launch_dq(const Args& a, Spec sp, cudaStream_t stream) {
  const int threads = ((a.block_q + 31) / 32) * 32;
  const size_t smem = (2 * KT * D + (size_t)threads * (D + 4)) * sizeof(float);
  auto kern = attention_dq_kernel<T, D>;
  if (int err = set_smem(kern, smem)) return err;
  dim3 grid(a.nblocks, a.hq, a.b);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.map, a.kinds, static_cast<T*>(a.out0), a.hq, a.hkv, a.lq,
      a.lkv, a.num_slots, a.block_q, a.block_kv, sp);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Args& a, Spec sp, cudaStream_t stream) {
  const int threads = ((a.block_kv + 31) / 32) * 32;
  const size_t own = own_rows_in_smem<D>() ? 2 * (size_t)threads * (D + 4) : 0;
  const size_t smem = (own + 2 * QT * D + 2 * QT) * sizeof(float);
  auto kern = attention_dkv_kernel<T, D>;
  if (int err = set_smem(kern, smem)) return err;
  dim3 grid(a.nblocks, a.hkv, a.b);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.map, a.kinds, static_cast<T*>(a.out0),
      static_cast<T*>(a.out1), a.hq, a.hkv, a.lq, a.lkv, a.num_slots,
      a.block_q, a.block_kv, sp);
  return (int)cudaGetLastError();
}

template <typename T, bool DKV>
int dispatch_d(int d, const Args& a, Spec sp, cudaStream_t stream) {
#define SWAT_BWD_CASE(DD)                                        \
  case DD:                                                       \
    return DKV ? launch_dkv<T, DD>(a, sp, stream)                \
               : launch_dq<T, DD>(a, sp, stream);
  switch (d) {
    SWAT_BWD_CASE(16)
    SWAT_BWD_CASE(32)
    SWAT_BWD_CASE(64)
    SWAT_BWD_CASE(128)
    SWAT_BWD_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SWAT_BWD_CASE
}

template <bool DKV>
int run(const Args& a, int d, Spec sp, int dtype, void* stream) {
  if (a.block_q < 1 || a.block_q > 256 || a.block_kv < 1 ||
      a.block_kv > 256 || a.hkv < 1 || a.hq % a.hkv != 0)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float, DKV>(d, a, sp, st);
  if (dtype == 1) return dispatch_d<__nv_bfloat16, DKV>(d, a, sp, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the gradients share
// it); lse and delta are fp32 (B, Hq, Lq). kv_map / kinds: the forward
// pattern, int32 (nq, num_slots). Returns cudaGetLastError().
extern "C" int swat_attention_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_map, const void* kinds,
    void* dq, int b, int hq, int hkv, int lq, int lkv, int d, int nq,
    int num_slots, int block_q, int block_kv, int sparse, int window,
    int causal, int num_global, int num_random, int q_offset, int kv_offset,
    int seq_kv, float scale, float softcap, int dtype, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<const int*>(kv_map),
         static_cast<const int*>(kinds), dq, nullptr, b, hq, hkv, lq, lkv,
         nq, num_slots, block_q, block_kv};
  Spec sp{sparse, window, causal, num_global, num_random,
          q_offset, kv_offset, seq_kv, scale, softcap};
  return run<false>(a, d, sp, dtype, stream);
}

// q_map / ikinds: the inverse pattern, int32 (nkv, num_inv_slots).
extern "C" int swat_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* q_map, const void* ikinds,
    void* dk, void* dv, int b, int hq, int hkv, int lq, int lkv, int d,
    int nkv, int num_slots, int block_q, int block_kv, int sparse, int window,
    int causal, int num_global, int num_random, int q_offset, int kv_offset,
    int seq_kv, float scale, float softcap, int dtype, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<const int*>(q_map),
         static_cast<const int*>(ikinds), dk, dv, b, hq, hkv, lq, lkv, nkv,
         num_slots, block_q, block_kv};
  Spec sp{sparse, window, causal, num_global, num_random,
          q_offset, kv_offset, seq_kv, scale, softcap};
  return run<true>(a, d, sp, dtype, stream);
}
