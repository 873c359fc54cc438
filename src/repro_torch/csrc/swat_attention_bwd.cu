// SWAT block-sparse banded attention backward for Hopper (sm_90a): the
// gradient of the row-wise fused band (paper Eq. 1) in two passes, dQ and
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
// 8 kv heads, L=2048, window 256, D=64) the byte and the bf16 tensor-core
// bounds are of the same order (~0.03 ms each).
//
// Both gradients have two routes, chosen by the wrapper from (dtype, head
// dim) (kernels/swat_backward.py `dq_route`, `dkv_route`); each is its own
// entry point:
//
//   dtype  head dim      dQ                       dK/dV
//   bf16   64, 128, 256  swat_attention_dq_tc     swat_attention_dkv_tc, then
//                        (tensor cores)           swat_attention_dkv_combine
//                                                 where the plan cut a row
//   bf16   16, 32        swat_attention_dq        swat_attention_dkv (SIMT)
//   fp32   any           swat_attention_dq        swat_attention_dkv (SIMT:
//                                                 the tensor cores would
//                                                 compute in TF32)
//
// Tensor-core dQ (attention_dq_tc_kernel): the query tile is stationary, as
// in the forward. One CTA (one warpgroup) holds 64 query rows of one q head
// (Q and dO in 128B-swizzled shared memory, each row's LSE and delta in
// registers) and walks the forward pattern's slots, bringing K and V tiles
// through a two-stage cp.async ring; tiles with no visible pair are
// neither loaded nor multiplied. S = Q K^T and dP = dO V^T run on wgmma from
// shared memory; S is scaled in fp32 after the product (the plain version
// scales q in fp32), then the softcap chain, the per-row key bit set of
// band.cuh, P = exp(S - lse) and dS = P (dP - delta) chain stay in
// registers as the A operand of dQ += dS K, whose B operand (K as stored)
// is read MN-major through the transpose bit. dS goes in as two bf16 parts
// (the rounded value and the rest), as dK/dV's does. Each dQ row belongs to
// one CTA: no cross-CTA sum, no combine. At D=256 the K/V tiles are 32
// rows, so the score and dP tiles (16 registers each) fit beside the
// 128-register accumulator.
//
// Tensor-core dK/dV (attention_dkv_tc_kernel): the kv tile is stationary,
// the paper's input-stationary reuse. One CTA (one warpgroup below D=256;
// two at D=256, as below) holds 64 kv
// rows of K and V in shared memory as bf16 and walks the GQA group's q
// heads and its chunk of the inverse row's q blocks, bringing Q, dO, LSE
// and delta tiles through a two-stage cp.async ring. Four products run on
// wgmma with the kv rows as M: S^T = K Q^T and dP^T = V dO^T from shared
// memory; then P^T = exp(S^T - lse) and dS^T = P^T (dP^T - delta) (times
// the softcap chain) stay in registers as the A operands of dV += P^T dO
// and dK += dS^T Q, whose B operands (dO and Q as stored) are read
// MN-major through the transpose bit. P and dS go in as two bf16 parts
// (the rounded value and the rest): one bf16 rounding moved dK and dV by
// a few bf16 ulps, outside the backward's tolerance. The mask is a bit set
// per row built from the band's query interval; steps with no visible
// pair are neither loaded nor multiplied, and a warp whose rows see none
// of a tile skips its arithmetic.
// Balance without atomics: kv block 0 holds the global columns, so every q
// block visits it. The host cuts every inverse row longer than the
// longest count of non-GLOBAL slots into chunks (kernels/swat_backward.py
// `dkv_plan`); each chunk is a CTA, the chunks of a cut row write fp32
// partials, and dkv_combine_kernel sums them in chunk order. Registers
// bound the design: the dK and dV accumulators are D registers a thread,
// which one warpgroup holds up to D=128.
// At D=256 (gemma2-2b) they would take 256 registers a thread, and wgmma's
// M of 64 rows a warpgroup rules out a smaller kv tile. So the CTA holds two
// warpgroups over the same 64 kv rows, one accumulator each (128
// registers): warpgroup 0 computes S^T = K Q^T and P^T and owns dV +=
// P^T dO; warpgroup 1 computes dP^T = V dO^T beside it, then dS^T, and owns
// dK += dS^T Q. P^T and its softcap chain factor cross from warpgroup 0 to
// 1 in fp32 through shared memory (a named barrier: warpgroup 0
// arrives, warpgroup 1 waits), so dS^T is the same fp32 expression as in
// the one-warpgroup layout and P and dS still enter their products as
// bf16 hi + lo. Each warpgroup runs two of the four products (three
// wgmma passes with the hi + lo split), the split that needs no product
// twice; splitting D across the warpgroups instead would run S^T and dP^T
// in both, 1.5x the products. One CTA an SM: 64-row Q/dO tiles take all
// 227 KB of its shared memory (K and V 64 KB, two stages 130 KB, the
// hand-off 32 KB).
//
// SIMT kernels (attention_dq_kernel, attention_dkv_kernel), for fp32 and
// the head dims the tensor-core kernels do not take: one thread per query
// row (dQ) or kv row (dK/dV) with fp32 FMA loops against fp32 tiles in
// shared memory; dK/dV sums the GQA group inside the CTA. Their ceiling is
// the 67 TFLOP/s fp32 rate; at head dim 256 (fp32 only, on these routes)
// their register rows spill, and dK/dV keeps a thread's own K and V rows
// in local memory.
//
// Deterministic by construction: no atomics; every sum runs in a fixed
// order, so two launches on the same inputs give bitwise-equal outputs.
//
// Masking is explicit, not by zero padding: only visible pairs contribute,
// visibility is element_mask (swat_attention.py:39) in global coordinates
// (band.cuh), query rows at or past Lq and kv rows at or past Lkv or the
// kv bound are skipped. p = exp(s - lse) with the forward's LSE;
// ds = p * (dp - delta) times the softcap chain 1 - tanh^2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "band.cuh"
#include "wgmma.cuh"

namespace {

constexpr int KT = 32;  // kv rows per shared-memory tile (dQ)
constexpr int QT = 32;  // q rows per shared-memory tile (dK/dV)
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


// ------------------------------------------ dK/dV on the tensor cores ---

// kv rows per CTA: 64, the M of one warpgroup's wgmma. Below D=256 one
// warpgroup holds both D-wide accumulators, two CTAs an SM (a 128-row CTA
// of two warpgroups was slower: its per-step barrier keeps them in
// lockstep). At D=256 the two accumulators would take 256 registers a
// thread, so two warpgroups share the 64 kv rows, one accumulator each.
constexpr int TCB_ROWS = 64;
constexpr int TCB_THREADS = 128;  // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// warpgroups of a dK/dV CTA
template <int D>
__host__ __device__ constexpr int dkv_wgs() { return D <= 128 ? 1 : 2; }

// q rows per Q/dO tile: 64, but 32 at D=128, where one warpgroup's two
// 64-register accumulators beside a 64-row tile's score and dP tiles (64
// registers more) would spill. At D=256 each warpgroup holds one
// 128-register accumulator and one 32-register tile (no spill; faster
// than 32-row tiles on the H100: half the steps, each product twice as
// wide)
template <int D>
__host__ __device__ constexpr int tc_qt() { return D == 128 ? 32 : 64; }

// bytes of one stage (Q, dO, lse, delta), rounded up so that every stage's
// tiles start on a 1024-byte boundary, as the 128B swizzle needs
template <int D>
__host__ __device__ constexpr uint32_t dkv_tc_stage_bytes() {
  return (2 * tc_qt<D>() * D * 2 + 2 * tc_qt<D>() * 4 + 1023) / 1024 * 1024;
}

constexpr int DKV_STAGES = 2;  // stages of the Q/dO ring

// bytes of the two-warpgroup hand-off: P^T and its softcap chain factor,
// fp32, one value per accumulator register of a warpgroup
template <int D>
constexpr size_t dkv_xch_bytes() {
  return dkv_wgs<D>() == 2 ? 2 * (size_t)TCB_THREADS * (tc_qt<D>() / 2) * 4
                           : 0;
}

template <int D>
constexpr size_t dkv_tc_smem_bytes() {
  // K and V tiles, the stages, the hand-off, room to align
  return 2 * (size_t)TCB_ROWS * D * 2 +
         DKV_STAGES * (size_t)dkv_tc_stage_bytes<D>() + dkv_xch_bytes<D>() +
         1024;
}

template <int D>
__global__ void __launch_bounds__(TCB_THREADS * dkv_wgs<D>(),
                                  dkv_wgs<D>() == 1 ? 2 : 1)
    attention_dkv_tc_kernel(
    const __nv_bfloat16* __restrict__ q,     // (B, Hq, Lq, D)
    const __nv_bfloat16* __restrict__ k,     // (B, Hkv, Lkv, D)
    const __nv_bfloat16* __restrict__ v,     // (B, Hkv, Lkv, D)
    const __nv_bfloat16* __restrict__ dout,  // (B, Hq, Lq, D)
    const float* __restrict__ lse,           // (B, Hq, Lq)
    const float* __restrict__ delta,         // (B, Hq, Lq)
    const int* __restrict__ chunks,  // (n_chunks, 4): kv block, s0, s1, part
    const int* __restrict__ q_map,   // (nkv, num_inv_slots)
    const int* __restrict__ ikinds,  // (nkv, num_inv_slots)
    __nv_bfloat16* __restrict__ dk,  // (B, Hkv, Lkv, D)
    __nv_bfloat16* __restrict__ dv,  // (B, Hkv, Lkv, D)
    float* __restrict__ part_k,      // (n_parts, B, Hkv, block_kv, D)
    float* __restrict__ part_v,      // (n_parts, B, Hkv, block_kv, D)
    int hq, int hkv, int lq, int lkv, int num_slots, int block_q,
    int block_kv, int nsub, Spec sp) {
  constexpr int WGS = dkv_wgs<D>();
  constexpr int NT = TCB_THREADS * WGS;
  constexpr int QT = tc_qt<D>();
  constexpr uint32_t KB = TCB_ROWS * D * 2;  // bytes of the K (or V) tile
  constexpr uint32_t QB = QT * D * 2;        // bytes of a Q (or dO) tile
  constexpr uint32_t SB = dkv_tc_stage_bytes<D>();
  constexpr int R = D / 2;    // registers of a dK or dV accumulator
  constexpr int RS = QT / 2;  // score and dP registers
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sk = (wg::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sv = sk + KB;
  const uint32_t st0 = sv + KB;  // stage s at st0 + s * SB: Q, dO, lse, delta
  uint8_t* gen0 = smem_raw + (st0 - wg::smem_u32(smem_raw));

  const int c = blockIdx.x / nsub;
  const int j = chunks[4 * c];
  const int s0 = chunks[4 * c + 1];
  const int s1 = chunks[4 * c + 2];
  const int part = chunks[4 * c + 3];
  const int kr0 = j * block_kv + (blockIdx.x % nsub) * TCB_ROWS;
  const int nkr = min(min(TCB_ROWS, (j + 1) * block_kv - kr0), lkv - kr0);
  if (nkr <= 0) return;  // uniform across the CTA
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wgi = tid / TCB_THREADS;  // this thread's warpgroup
  const int wt = tid % TCB_THREADS;   // ... and its thread there
  const int warp = wt / 32;
  const int lane = tid % 32;
  const int group = hq / hkv;
  const int nslot = s1 - s0;
  const int ntq = (block_q + QT - 1) / QT;
  const int total = group * nslot * ntq;
  const int* qm = q_map + j * num_slots;
  const int* km = ikinds + j * num_slots;
  const int ck0 = sp.kv_offset + kr0;  // the CTA's live kv rows
  const int ck1 = ck0 + nkr - 1;
  const __nv_bfloat16* kh = k + ((size_t)b * hkv + hk) * lkv * D;
  const __nv_bfloat16* vh = v + ((size_t)b * hkv + hk) * lkv * D;

  // step f = (q head g, inverse slot s0 + s, q tile t), t fastest
  auto rows = [&](int f, int* g, int* kind, int* first) {
    const int t = f % ntq, rest = f / ntq;
    const int s = s0 + rest % nslot;
    *g = rest / nslot;
    *kind = km[s];
    *first = qm[s] * block_q + t * QT;
    return min(min(QT, (qm[s] + 1) * block_q - *first), lq - *first);
  };
  auto next = [&](int f) {
    for (; f < total; ++f) {
      int g, kind, first;
      const int nq = rows(f, &g, &kind, &first);
      if (kind == PAD_KIND || nq <= 0) continue;
      const int q0 = sp.q_offset + first;
      if (any_visible(sp, q0, q0 + nq - 1, ck0, ck1, kind)) return f;
    }
    return total;
  };
  auto issue = [&](int f, int stage) {
    int g, kind, first;
    const int nq = rows(f, &g, &kind, &first);
    const size_t hrow = ((size_t)b * hq + hk * group + g) * lq;
    const uint32_t st = st0 + stage * SB;
    wg::load_tile<D>(st, q + (hrow + first) * D, q, QT, nq, tid, NT);
    wg::load_tile<D>(st + QB, dout + (hrow + first) * D, dout, QT, nq, tid,
                     NT);
    if (tid < QT) {
      const bool in = tid < nq;
      const size_t r = in ? hrow + first + tid : 0;
      wg::cp_async4(st + 2 * QB + tid * 4, lse + r, in ? 4 : 0);
      wg::cp_async4(st + 2 * QB + QT * 4 + tid * 4, delta + r, in ? 4 : 0);
    }
  };

  wg::load_tile<D>(sk, kh + (size_t)kr0 * D, kh, TCB_ROWS, nkr, tid, NT);
  wg::load_tile<D>(sv, vh + (size_t)kr0 * D, vh, TCB_ROWS, nkr, tid, NT);
  // one commit group per step (empty past the last), so that waiting for
  // all but the newest DKV_STAGES - 2 groups lands the step about to run
  int cur = next(0);
  int ahead = cur;  // the last step issued
#pragma unroll
  for (int st = 0; st < DKV_STAGES - 1; ++st) {
    if (st > 0 && ahead < total) ahead = next(ahead + 1);
    if (ahead < total) issue(ahead, st);
    wg::cp_async_commit();
  }

  // one warpgroup: acc[0] is dV, acc[1] dK; two: each warpgroup's acc[0],
  // dV in warpgroup 0 and dK in warpgroup 1
  float acc[WGS == 1 ? 2 : 1][R];
#pragma unroll
  for (int a = 0; a < (WGS == 1 ? 2 : 1); ++a)
#pragma unroll
    for (int e = 0; e < R; ++e) acc[a][e] = 0.f;
  const int r_lo = warp * 16 + lane / 4;  // kv row of half 0; half 1 is +8
  // the thread's first query column of a tile
  const int off = (lane & 3) * 2;
  // the queries each of this thread's two kv rows sees (bit j: the
  // thread's column j), of the step's nq queries from q0
  auto seen = [&](int q0, int nq, int kind, bool full, uint32_t (&vis)[2]) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rr = r_lo + 8 * hh;
      const int2 r = query_range(sp, ck0 + rr, q0 + off, nq - off, kind);
      vis[hh] = rr >= nkr ? 0u : full ? ~0u : cols_in(r.x, r.y);
    }
  };
  // register e of a score tile: its query column (from the thread's
  // first), and whether its pair is visible
  auto col = [](int e) { return (e >> 2) * 8 + (e & 1); };
  auto bit = [](const uint32_t (&vis)[2], int e) {
    return ((vis[(e >> 1) & 1] >> (2 * (e >> 2) + (e & 1))) & 1u) != 0u;
  };
  // P^T of score s in query column cc (0 where not visible) and the
  // softcap chain factor d(capped)/d(raw)
  auto prob = [&](float s, bool in, int cc, const float* ls, float* chain) {
    float x = s * sp.scale;
    *chain = 1.f;
    if (sp.softcap != 0.f) {
      const float t = tanhf(x / sp.softcap);
      *chain = 1.f - t * t;
      x = sp.softcap * t;
    }
    return in ? wg::ex2(fmaf(x, LOG2E, -ls[cc + off] * LOG2E)) : 0.f;
  };
  // the hand-off of the two-warpgroup layout: register e of warpgroup
  // thread t at xp[e * TCB_THREADS + t] (P^T) and xc[...] (the chain); the
  // same register of the other warpgroup's tile is the same (row, column)
  float* xp = reinterpret_cast<float*>(gen0 + DKV_STAGES * SB) + wt;
  float* xc = xp + RS * TCB_THREADS;
  int stage = 0;
  while (cur < total) {
    wg::cp_async_wait<DKV_STAGES - 2>();  // this step's tiles (and K, V)
    wg::fence_async_smem();               // have landed
    __syncthreads();  // ... and every warp is done with the stage that
                      // the next load refills (and with the hand-off)
    if (ahead < total) ahead = next(ahead + 1);
    if (ahead < total) issue(ahead, (stage + DKV_STAGES - 1) % DKV_STAGES);
    wg::cp_async_commit();
    int g, kind, first;
    const int nq = rows(cur, &g, &kind, &first);
    const int q0 = sp.q_offset + first;
    // (next() skipped the steps with no visible pair)
    const bool full = nkr == TCB_ROWS && nq == QT &&
                      all_visible(sp, q0, q0 + QT - 1, ck0, ck1, kind);
    const uint32_t sq = st0 + stage * SB;
    const uint32_t sdo = sq + QB;
    const float* ls = reinterpret_cast<const float*>(
        gen0 + stage * SB + 2 * QB);
    const float* dls = ls + QT;
    if constexpr (WGS == 1) {
      float s_t[RS], dp_t[RS];
#pragma unroll
      for (int e = 0; e < RS; ++e) s_t[e] = dp_t[e] = 0.f;
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // S^T = K Q^T
        wg::mma_ss<QT>(s_t, wg::desc_k(sk, TCB_ROWS, 0, kk),
                       wg::desc_k(sq, QT, 0, kk), 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // dP^T = V dO^T
        wg::mma_ss<QT>(dp_t, wg::desc_k(sv, TCB_ROWS, 0, kk),
                       wg::desc_k(sdo, QT, 0, kk), 1);
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_regs(s_t);
      wg::fence_regs(dp_t);
      uint32_t vis[2];
      seen(q0, nq, kind, full, vis);
      // a warp whose 16 kv rows see no query of the tile (the global
      // block's rows past the global columns) skips the arithmetic
      if (!__any_sync(0xffffffffu, (vis[0] | vis[1]) != 0u)) {
#pragma unroll
        for (int e = 0; e < RS; ++e) s_t[e] = dp_t[e] = 0.f;
      } else {
#pragma unroll
        for (int e = 0; e < RS; ++e) {
          const bool in = bit(vis, e);
          float chain;
          const float p = prob(s_t[e], in, col(e), ls, &chain);
          s_t[e] = p;  // P^T, then dS^T
          dp_t[e] = in ? p * (dp_t[e] - dls[col(e) + off]) * chain : 0.f;
        }
      }
      // bf16 A operands, each split into hi and lo parts: one bf16 rounding
      // of P and dS would move dK and dV by a few bf16 ulps
      uint32_t ph[QT / 16][4], pl[QT / 16][4], dh[QT / 16][4],
          dl[QT / 16][4];
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        wg::a_frag_split(s_t, kk, ph[kk], pl[kk]);
        wg::a_frag_split(dp_t, kk, dh[kk], dl[kk]);
      }
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {  // dV += P^T dO
        wg::mma_rs<D>(acc[0], ph[kk], wg::desc_mn(sdo, QT, kk), 1);
        wg::mma_rs<D>(acc[0], pl[kk], wg::desc_mn(sdo, QT, kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {  // dK += dS^T Q
        wg::mma_rs<D>(acc[1], dh[kk], wg::desc_mn(sq, QT, kk), 1);
        wg::mma_rs<D>(acc[1], dl[kk], wg::desc_mn(sq, QT, kk), 1);
      }
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_regs(acc[0]);
      wg::fence_regs(acc[1]);
    } else {
      // warpgroup 0: S^T = K Q^T, then P^T, handed to warpgroup 1, then
      // dV += P^T dO; warpgroup 1: dP^T = V dO^T (beside warpgroup 0's S^T),
      // then dS^T = P^T (dP^T - delta) chain, then dK += dS^T Q
      float x[RS];
#pragma unroll
      for (int e = 0; e < RS; ++e) x[e] = 0.f;
      const uint32_t sa = wgi == 0 ? sk : sv;
      const uint32_t sb = wgi == 0 ? sq : sdo;
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wg::mma_ss<QT>(x, wg::desc_k(sa, TCB_ROWS, 0, kk),
                       wg::desc_k(sb, QT, 0, kk), 1);
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_regs(x);
      if (wgi == 0) {
        uint32_t vis[2];
        seen(q0, nq, kind, full, vis);
        const bool any = __any_sync(0xffffffffu, (vis[0] | vis[1]) != 0u);
#pragma unroll
        for (int e = 0; e < RS; ++e) {
          float chain = 1.f;
          x[e] = any ? prob(x[e], bit(vis, e), col(e), ls, &chain) : 0.f;
          xp[e * TCB_THREADS] = x[e];
          xc[e * TCB_THREADS] = chain;
        }
        wg::bar_arrive(1, NT);
      } else {
        wg::bar_sync(1, NT);
#pragma unroll
        for (int e = 0; e < RS; ++e)  // 0 where P^T is (not visible)
          x[e] = xp[e * TCB_THREADS] * (x[e] - dls[col(e) + off]) *
                 xc[e * TCB_THREADS];
      }
      // P^T or dS^T as bf16 hi and lo parts, as in the one-warpgroup layout
      uint32_t xh[QT / 16][4], xl[QT / 16][4];
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk)
        wg::a_frag_split(x, kk, xh[kk], xl[kk]);
      const uint32_t sm = wgi == 0 ? sdo : sq;
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {  // dV += P^T dO, dK += dS^T Q
        wg::mma_rs<D>(acc[0], xh[kk], wg::desc_mn(sm, QT, kk), 1);
        wg::mma_rs<D>(acc[0], xl[kk], wg::desc_mn(sm, QT, kk), 1);
      }
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_regs(acc[0]);
    }
    cur = next(cur + 1);
    stage = (stage + 1) % DKV_STAGES;
  }
  wg::cp_async_wait<0>();
  // dV, then dK (times the score scale): both from one warpgroup, or each
  // from its own
#pragma unroll
  for (int a = 0; a < (WGS == 1 ? 2 : 1); ++a) {
    const bool is_k = WGS == 1 ? a == 1 : wgi == 1;
    const float osc = is_k ? sp.scale : 1.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rr = r_lo + 8 * hh;
      if (rr >= nkr) continue;
      const int row = kr0 + rr;  // local kv row
      if (part < 0) {  // the chunk is its kv block's only one: write dK/dV
        __nv_bfloat16* o = (is_k ? dk : dv) +
                           (((size_t)b * hkv + hk) * lkv + row) * D + off;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const int e = 4 * n + 2 * hh;
          *reinterpret_cast<__nv_bfloat162*>(o + n * 8) =
              __floats2bfloat162_rn(acc[a][e] * osc, acc[a][e + 1] * osc);
        }
      } else {  // one of several: its fp32 partial, summed by dkv_combine
        float* o = (is_k ? part_k : part_v) +
                   ((((size_t)part * gridDim.z + b) * hkv + hk) * block_kv +
                    (row - j * block_kv)) * D + off;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const int e = 4 * n + 2 * hh;
          *reinterpret_cast<float2*>(o + n * 8) =
              make_float2(acc[a][e] * osc, acc[a][e + 1] * osc);
        }
      }
    }
  }
}

// dK/dV of the kv blocks whose inverse row was cut into chunks: the sum of
// their fp32 partials in chunk order, cast to bf16. One thread per 4
// consecutive values of a (split kv block, kv head, batch) slab.
__global__ void dkv_combine_kernel(const float* __restrict__ part_k,
                                   const float* __restrict__ part_v,
                                   const int* __restrict__ combine,  // (n, 3)
                                   __nv_bfloat16* __restrict__ dk,
                                   __nv_bfloat16* __restrict__ dv, int hkv,
                                   int lkv, int d, int block_kv) {
  const int j = combine[3 * blockIdx.y];
  const int p0 = combine[3 * blockIdx.y + 1];
  const int np = combine[3 * blockIdx.y + 2];
  const int nb = gridDim.z / hkv;
  const int hk = blockIdx.z % hkv;
  const int b = blockIdx.z / hkv;
  const int idx = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (idx >= min(block_kv, lkv - j * block_kv) * d) return;
  const size_t pstride = (size_t)nb * hkv * block_kv * d;  // one partial
  const size_t pbase =
      (((size_t)p0 * nb + b) * hkv + hk) * block_kv * d + idx;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int p = 0; p < np; ++p) {
    const float4 a = *reinterpret_cast<const float4*>(part_k + pbase +
                                                      p * pstride);
    const float4 c = *reinterpret_cast<const float4*>(part_v + pbase +
                                                      p * pstride);
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
  }
  const size_t o =
      (((size_t)b * hkv + hk) * lkv + (size_t)j * block_kv) * d + idx;
  __nv_bfloat162* k2 = reinterpret_cast<__nv_bfloat162*>(dk + o);
  __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(dv + o);
  k2[0] = __floats2bfloat162_rn(sk.x, sk.y);
  k2[1] = __floats2bfloat162_rn(sk.z, sk.w);
  v2[0] = __floats2bfloat162_rn(sv.x, sv.y);
  v2[1] = __floats2bfloat162_rn(sv.z, sv.w);
}

template <int D>
int launch_dkv_tc(const Args& a, const int* chunks, float* part_k,
                  float* part_v, Spec sp, cudaStream_t stream) {
  static_assert(dkv_tc_smem_bytes<D>() <= MAX_SMEM, "dK/dV shared memory");
  const size_t smem = dkv_tc_smem_bytes<D>();
  auto kern = attention_dkv_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nsub = (a.block_kv + TCB_ROWS - 1) / TCB_ROWS;
  dim3 grid(a.nblocks * nsub, a.hkv, a.b);  // nblocks: the chunk count
  kern<<<grid, TCB_THREADS * dkv_wgs<D>(), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta, chunks,
      a.map, a.kinds, static_cast<__nv_bfloat16*>(a.out0),
      static_cast<__nv_bfloat16*>(a.out1), part_k, part_v, a.hq, a.hkv, a.lq,
      a.lkv, a.num_slots, a.block_q, a.block_kv, nsub, sp);
  return (int)cudaGetLastError();
}


// -------------------------------------------- dQ on the tensor cores ---

// query rows per CTA: one warpgroup of 64
constexpr int DQ_ROWS = 64;
constexpr int DQ_STAGES = 2;  // stages of the K/V ring

// kv rows per K/V tile: at D=256 a 64-key tile's score and dP tiles (64
// registers) beside the dQ accumulator (128) would spill
template <int D>
__host__ __device__ constexpr int dq_kt() { return D <= 128 ? 64 : 32; }

template <int D>
constexpr size_t dq_tc_smem_bytes() {
  // Q and dO tiles, the stages of (K tile, V tile), room to align
  return 2 * (size_t)DQ_ROWS * D * 2 +
         2 * (size_t)DQ_STAGES * dq_kt<D>() * D * 2 + 1024;
}

template <int D>
__global__ void __launch_bounds__(TCB_THREADS, D <= 128 ? 2 : 1)
    attention_dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q,     // (B, Hq, Lq, D)
    const __nv_bfloat16* __restrict__ k,     // (B, Hkv, Lkv, D)
    const __nv_bfloat16* __restrict__ v,     // (B, Hkv, Lkv, D)
    const __nv_bfloat16* __restrict__ dout,  // (B, Hq, Lq, D)
    const float* __restrict__ lse,           // (B, Hq, Lq)
    const float* __restrict__ delta,         // (B, Hq, Lq)
    const int* __restrict__ kv_map,          // (nq, num_slots)
    const int* __restrict__ kinds,           // (nq, num_slots)
    __nv_bfloat16* __restrict__ dq,          // (B, Hq, Lq, D)
    int hq, int hkv, int lq, int lkv, int num_slots, int block_q,
    int block_kv, int nsub, Spec sp) {
  constexpr int KT = dq_kt<D>();
  constexpr uint32_t QB = DQ_ROWS * D * 2;  // bytes of the Q (or dO) tile
  constexpr uint32_t KVB = KT * D * 2;      // bytes of one K or V tile
  constexpr int R = D / 2;                  // dQ accumulator registers
  constexpr int RS = KT / 2;                // score and dP registers
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (wg::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdo = sq + QB;
  const uint32_t st0 = sdo + QB;  // stage s at st0 + s * 2 * KVB: K, V

  const int i = blockIdx.x / nsub;
  const int row0 = i * block_q + (blockIdx.x % nsub) * DQ_ROWS;
  const int nrow =
      min(min(DQ_ROWS, (i + 1) * block_q - row0), lq - row0);  // live rows
  if (nrow <= 0) return;  // uniform across the CTA
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int hk = h / (hq / hkv);
  const size_t hrow = ((size_t)b * hq + h) * lq;  // row 0 of (b, h)
  const __nv_bfloat16* kh = k + ((size_t)b * hkv + hk) * lkv * D;
  const __nv_bfloat16* vh = v + ((size_t)b * hkv + hk) * lkv * D;
  const int* map_i = kv_map + i * num_slots;
  const int* kind_i = kinds + i * num_slots;
  const int ntile = (block_kv + KT - 1) / KT;
  const int total = num_slots * ntile;
  const int cq0 = sp.q_offset + row0;  // the CTA's live query rows
  const int cq1 = cq0 + nrow - 1;

  // tile f = (slot f / ntile, KT-row tile f % ntile of its kv block)
  auto cols = [&](int f, int* kind, int* c0) {
    const int s = f / ntile, tt = f % ntile;
    *kind = kind_i[s];
    *c0 = map_i[s] * block_kv + tt * KT;
    return min(min(KT, block_kv - tt * KT), lkv - *c0);
  };
  // the first tile at or after f that holds a visible pair for the CTA
  auto next = [&](int f) {
    for (; f < total; ++f) {
      int kind, c0;
      const int ncol = cols(f, &kind, &c0);
      if (kind == PAD_KIND || ncol <= 0) continue;
      const int k0 = sp.kv_offset + c0;
      if (any_visible(sp, cq0, cq1, k0, k0 + ncol - 1, kind)) return f;
    }
    return total;
  };
  auto issue = [&](int f, int stage) {
    int kind, c0;
    const int ncol = cols(f, &kind, &c0);
    const uint32_t sk = st0 + stage * 2 * KVB;
    wg::load_tile<D>(sk, kh + (size_t)c0 * D, kh, KT, ncol, tid,
                     TCB_THREADS);
    wg::load_tile<D>(sk + KVB, vh + (size_t)c0 * D, vh, KT, ncol, tid,
                     TCB_THREADS);
  };

  // one commit group per tile (empty past the last), so that waiting for
  // all but the newest DQ_STAGES - 2 groups lands the tile about to be used
  wg::load_tile<D>(sq, q + (hrow + row0) * D, q, DQ_ROWS, nrow, tid,
                   TCB_THREADS);
  wg::load_tile<D>(sdo, dout + (hrow + row0) * D, dout, DQ_ROWS, nrow, tid,
                   TCB_THREADS);
  wg::cp_async_commit();
  int cur = next(0);
  int ahead = cur;  // the last tile issued
#pragma unroll
  for (int st = 0; st < DQ_STAGES - 1; ++st) {
    if (st > 0 && ahead < total) ahead = next(ahead + 1);
    if (ahead < total) issue(ahead, st);
    wg::cp_async_commit();
  }

  // each thread's two query rows: their LSE and delta, log2-scaled
  const int r_lo = warp * 16 + lane / 4;  // row of half 0; half 1 is +8
  float ls2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rr = r_lo + 8 * hh;
    const bool in = rr < nrow;
    ls2[hh] = in ? lse[hrow + row0 + rr] * LOG2E : 0.f;
    dl[hh] = in ? delta[hrow + row0 + rr] : 0.f;
  }
  float acc[R];
#pragma unroll
  for (int e = 0; e < R; ++e) acc[e] = 0.f;
  const int off = (lane & 3) * 2;  // the thread's first column of a tile
  int stage = 0;
  while (cur < total) {
    wg::cp_async_wait<DQ_STAGES - 2>();  // this tile (and Q, dO) landed
    wg::fence_async_smem();
    __syncthreads();  // ... and every warp is done with the stage that
                      // the next load refills
    if (ahead < total) ahead = next(ahead + 1);
    if (ahead < total) issue(ahead, (stage + DQ_STAGES - 1) % DQ_STAGES);
    wg::cp_async_commit();
    int kind, c0;
    const int ncol = cols(cur, &kind, &c0);
    const int k0 = sp.kv_offset + c0;
    // (next() skipped the tiles with no visible pair)
    const bool full = nrow == DQ_ROWS && ncol == KT &&
                      all_visible(sp, cq0, cq0 + DQ_ROWS - 1, k0,
                                  k0 + KT - 1, kind);
    const uint32_t sk = st0 + stage * 2 * KVB;
    const uint32_t sv = sk + KVB;
    float s[RS], dp[RS];
#pragma unroll
    for (int e = 0; e < RS; ++e) s[e] = dp[e] = 0.f;
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // S = Q K^T
      wg::mma_ss<KT>(s, wg::desc_k(sq, DQ_ROWS, 0, kk),
                     wg::desc_k(sk, KT, 0, kk), 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // dP = dO V^T
      wg::mma_ss<KT>(dp, wg::desc_k(sdo, DQ_ROWS, 0, kk),
                     wg::desc_k(sv, KT, 0, kk), 1);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(s);
    wg::fence_regs(dp);
    // the keys each of this thread's two query rows sees (bit j: the
    // thread's column j)
    uint32_t vis[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rr = r_lo + 8 * hh;
      vis[hh] = rr >= nrow ? 0u
                : full     ? ~0u
                           : key_range(sp, cq0 + rr, k0 + off, ncol - off,
                                       kind).bits();
    }
    // a warp whose 16 rows see no key of the tile skips the arithmetic
    if (!__any_sync(0xffffffffu, (vis[0] | vis[1]) != 0u)) {
#pragma unroll
      for (int e = 0; e < RS; ++e) s[e] = 0.f;
    } else {
#pragma unroll
      for (int e = 0; e < RS; ++e) {
        const int hh = (e >> 1) & 1;
        const bool in = (vis[hh] >> (2 * (e >> 2) + (e & 1))) & 1u;
        float x = s[e] * sp.scale, chain = 1.f;  // scaled in fp32
        if (sp.softcap != 0.f) {
          const float t = tanhf(x / sp.softcap);
          chain = 1.f - t * t;
          x = sp.softcap * t;
        }
        const float p = in ? wg::ex2(fmaf(x, LOG2E, -ls2[hh])) : 0.f;
        s[e] = in ? p * (dp[e] - dl[hh]) * chain : 0.f;  // dS
      }
    }
    // dS as two bf16 parts (the rounded value and the rest): one bf16
    // rounding of dS would move dQ by a few bf16 ulps
    uint32_t dh[KT / 16][4], dlo[KT / 16][4];
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      wg::a_frag_split(s, kk, dh[kk], dlo[kk]);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {  // dQ += dS K
      wg::mma_rs<D>(acc, dh[kk], wg::desc_mn(sk, KT, kk), 1);
      wg::mma_rs<D>(acc, dlo[kk], wg::desc_mn(sk, KT, kk), 1);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(acc);
    cur = next(cur + 1);
    stage = (stage + 1) % DQ_STAGES;
  }
  wg::cp_async_wait<0>();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rr = r_lo + 8 * hh;
    if (rr >= nrow) continue;
    __nv_bfloat16* drow = dq + (hrow + row0 + rr) * D + off;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(drow + c * 8) =
          __floats2bfloat162_rn(acc[4 * c + 2 * hh] * sp.scale,
                                acc[4 * c + 2 * hh + 1] * sp.scale);
  }
}

template <int D>
int launch_dq_tc(const Args& a, Spec sp, cudaStream_t stream) {
  const size_t smem = dq_tc_smem_bytes<D>();
  auto kern = attention_dq_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nsub = (a.block_q + DQ_ROWS - 1) / DQ_ROWS;
  dim3 grid(a.nblocks * nsub, a.hq, a.b);
  kern<<<grid, TCB_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta, a.map,
      a.kinds, static_cast<__nv_bfloat16*>(a.out0), a.hq, a.hkv, a.lq, a.lkv,
      a.num_slots, a.block_q, a.block_kv, nsub, sp);
  return (int)cudaGetLastError();
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

// The tensor-core dQ route: bf16 only (dtype 1), head dim 64, 128 or 256;
// arguments as swat_attention_dq's.
extern "C" int swat_attention_dq_tc(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_map, const void* kinds,
    void* dq, int b, int hq, int hkv, int lq, int lkv, int d, int nq,
    int num_slots, int block_q, int block_kv, int sparse, int window,
    int causal, int num_global, int num_random, int q_offset, int kv_offset,
    int seq_kv, float scale, float softcap, int dtype, void* stream) {
  if (dtype != 1 || block_q < 1 || block_kv < 1 || hkv < 1 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<const int*>(kv_map),
         static_cast<const int*>(kinds), dq, nullptr, b, hq, hkv, lq, lkv,
         nq, num_slots, block_q, block_kv};
  Spec sp{sparse, window, causal, num_global, num_random,
          q_offset, kv_offset, seq_kv, scale, softcap};
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_dq_tc<64>(a, sp, st);
    case 128: return launch_dq_tc<128>(a, sp, st);
    case 256: return launch_dq_tc<256>(a, sp, st);
    default: return (int)cudaErrorInvalidValue;
  }
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

// The tensor-core dK/dV route: bf16 only (dtype 1), head dim 64, 128 or
// 256.
// chunks: int32 (n_chunks, 4) rows (kv block, first inverse slot, end slot,
// partial index or -1), from the host's chunk plan. A chunk with a partial
// index writes its fp32 partial into part_k / part_v (n_parts, B, Hkv,
// block_kv, D), which swat_attention_dkv_combine then sums; the others
// write dK/dV directly. Other arguments as swat_attention_dkv's.
extern "C" int swat_attention_dkv_tc(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* chunks, const void* q_map,
    const void* ikinds, void* dk, void* dv, void* part_k, void* part_v,
    int b, int hq, int hkv, int lq, int lkv, int d, int n_chunks,
    int num_slots, int block_q, int block_kv, int sparse, int window,
    int causal, int num_global, int num_random, int q_offset, int kv_offset,
    int seq_kv, float scale, float softcap, int dtype, void* stream) {
  if (dtype != 1 || n_chunks < 1 || block_q < 1 || block_kv < 1 || hkv < 1 ||
      hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<const int*>(q_map),
         static_cast<const int*>(ikinds), dk, dv, b, hq, hkv, lq, lkv,
         n_chunks, num_slots, block_q, block_kv};
  Spec sp{sparse, window, causal, num_global, num_random,
          q_offset, kv_offset, seq_kv, scale, softcap};
  auto st = static_cast<cudaStream_t>(stream);
  const int* ch = static_cast<const int*>(chunks);
  float* pk = static_cast<float*>(part_k);
  float* pv = static_cast<float*>(part_v);
  if (d == 64) return launch_dkv_tc<64>(a, ch, pk, pv, sp, st);
  if (d == 128) return launch_dkv_tc<128>(a, ch, pk, pv, sp, st);
  if (d == 256) return launch_dkv_tc<256>(a, ch, pk, pv, sp, st);
  return (int)cudaErrorInvalidValue;
}

// combine: int32 (n_combine, 3) rows (kv block, first partial, partial
// count). dk, dv: bf16 (B, Hkv, Lkv, D).
extern "C" int swat_attention_dkv_combine(const void* part_k,
                                          const void* part_v,
                                          const void* combine, void* dk,
                                          void* dv, int b, int hkv, int lkv,
                                          int d, int n_combine, int block_kv,
                                          void* stream) {
  if (n_combine < 1 || b < 1 || hkv < 1 || d < 1 || d % 4 || block_kv < 1)
    return (int)cudaErrorInvalidValue;
  const int per_slab = (block_kv * d / 4 + 255) / 256;  // CTAs of 256
  dim3 grid(per_slab, n_combine, hkv * b);
  dkv_combine_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_k), static_cast<const float*>(part_v),
      static_cast<const int*>(combine), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), hkv, lkv, d, block_kv);
  return (int)cudaGetLastError();
}
