// SWAT block-sparse banded attention forward for Hopper (sm_90a): the
// paper's row-wise fused band (Eq. 1) — QK^T, exp and the V accumulation in
// one kernel, visiting only the kv blocks of the host-built block pattern.
//
// Replaces: src/repro/kernels/swat_attention.py::_attention_fwd_kernel (the
// `swat_attention_fwd` pallas_call), reached by ops._pallas_attention. In the
// port it carries prefill's attention on the card and the forward of every
// training step.
//
// What bounds it on an H100: 4*D flops per visible (query, key) pair, about
// window+1 pairs per causal row, against Q, K, V, O and the fp32 LSE moved
// once. At the serving and training shapes (window 256, head dim 64, L=512
// or 2048) the byte bound and the bf16 tensor-core bound are of the same
// order (a few to tens of microseconds); at head dim 256 (gemma2-2b,
// window 4096) the operations bound it.
//
// Two routes, chosen by the wrapper from (dtype, head dim)
// (kernels/swat_attention.py `route`); each is its own entry point:
//
//   dtype  head dim       entry point
//   bf16   64, 128, 256   swat_attention_fwd_tc   (tensor cores)
//   bf16   16, 32         swat_attention_fwd      (SIMT)
//   fp32   any            swat_attention_fwd      (SIMT)
//
// fp32 stays on the SIMT kernel: the tensor cores would compute it in TF32,
// which keeps about three decimal digits.
//
// Tensor-core kernel (attention_fwd_tc_kernel). One CTA per (128 query rows
// of a q block, q head, batch): two warpgroups of 64 query rows each.
// - QK^T and PV run on wgmma (bf16 in, fp32 accumulate). Q stays in shared
//   memory for the whole CTA, scaled and rounded to bf16 as the plain
//   version scales it; the scores stay in registers and, rounded to
//   bf16 (as the plain version rounds P before P.V), are the register A
//   operand of PV. V is read MN-major through wgmma's transpose bit.
// - K and V move as bf16 64-row tiles, loaded with 16-byte cp.async into a
//   two-stage ring, so the next tile loads while this one is multiplied.
//   Rows past Lkv or the block read as zeros (cp.async's zero fill) and are
//   masked.
// - Online softmax in registers: fp32 running max, sum and accumulator per
//   row. The mask (band.cuh), a bit set per row built from the row's key
//   intervals, is applied only on tiles that cross a band or causal edge, a
//   bound or a ragged row or column; tiles with no visible pair for the
//   CTA are neither loaded nor multiplied. So a GLOBAL slot outside the
//   band visits only the tile that holds the global columns.
// - Two CTAs an SM at D=64 (at most 128 registers a thread), so that one
//   CTA's softmax overlaps the other's products and loads.
// - Deterministic: every sum runs in a fixed order.
// Registers bound the design: the fp32 accumulator is D/2 registers a
// thread (128 at D=256) beside the 32 of the score tile.
//
// SIMT kernel (attention_fwd_kernel), unchanged from the first port: one
// thread per query row, QK^T and PV as fp32 FMA loops against fp32 K/V
// tiles in shared memory. Its ceiling is the 67 TFLOP/s fp32 rate; at D=256
// its register rows spill.
//
// Both: the CTA reads its own row of kv_block_map / slot_kinds (device
// arrays uploaded once per pattern); PAD slots are skipped; GQA maps q head
// h to kv head h / group; the per-element mask is element_mask in global
// token coordinates (q_offset / kv_offset / seq_kv_bound hooks). Outputs: O
// in q's dtype and the fp32 row LSE (B, Hq, Lq).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "band.cuh"
#include "wgmma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int KT = 32;  // kv rows per shared-memory tile (SIMT)

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


// ------------------------------------------------------- tensor cores ---

constexpr int TC_ROWS = 128;  // query rows per CTA: two warpgroups of 64
constexpr int TC_KT = 64;     // kv rows per K/V tile
constexpr int TC_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int TC_STAGES = 2;  // stages of the K/V ring

template <int D>
constexpr size_t tc_smem_bytes() {
  // Q tile, the stages of (K tile, V tile), and room to align to 1024
  return (size_t)TC_ROWS * D * 2 +
         2 * (size_t)TC_STAGES * TC_KT * D * 2 + 1024;
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, D <= 64 ? 2 : 1)
    attention_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q,  // (B, Hq, Lq, D)
    const __nv_bfloat16* __restrict__ k,  // (B, Hkv, Lkv, D)
    const __nv_bfloat16* __restrict__ v,  // (B, Hkv, Lkv, D)
    const int* __restrict__ kv_map,       // (nq, num_slots)
    const int* __restrict__ kinds,        // (nq, num_slots)
    __nv_bfloat16* __restrict__ out,      // (B, Hq, Lq, D)
    float* __restrict__ lse,              // (B, Hq, Lq)
    int hq, int hkv, int lq, int lkv, int num_slots, int block_q,
    int block_kv, int nsub, Spec sp) {
  constexpr uint32_t QB = TC_ROWS * D * 2;  // bytes of the Q tile
  constexpr uint32_t KVB = TC_KT * D * 2;   // bytes of one K or V tile
  constexpr int R = D / 2;                  // accumulator registers
  constexpr int RS = TC_KT / 2;             // score registers
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (wg::smem_u32(smem_raw) + 1023u) & ~1023u;

  const int i = blockIdx.x / nsub;
  const int row0 = i * block_q + (blockIdx.x % nsub) * TC_ROWS;
  const int nrow =
      min(min(TC_ROWS, (i + 1) * block_q - row0), lq - row0);  // live rows
  if (nrow <= 0) return;  // uniform across the CTA
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int hk = h / (hq / hkv);
  const __nv_bfloat16* qh = q + ((size_t)b * hq + h) * lq * D;
  const __nv_bfloat16* kh = k + ((size_t)b * hkv + hk) * lkv * D;
  const __nv_bfloat16* vh = v + ((size_t)b * hkv + hk) * lkv * D;
  const int* map_i = kv_map + i * num_slots;
  const int* kind_i = kinds + i * num_slots;
  const int ntile = (block_kv + TC_KT - 1) / TC_KT;
  const int total = num_slots * ntile;
  const int cq0 = sp.q_offset + row0;  // the CTA's live query rows
  const int cq1 = cq0 + nrow - 1;
  const int wn = min(64, nrow - 64 * wgi);  // this warpgroup's live rows
  const int wq0 = cq0 + 64 * wgi;

  // tile f = (slot f / ntile, 64-row tile f % ntile of its kv block)
  auto cols = [&](int f, int* kind, int* c0) {
    const int s = f / ntile, tt = f % ntile;
    *kind = kind_i[s];
    *c0 = map_i[s] * block_kv + tt * TC_KT;
    return min(min(TC_KT, block_kv - tt * TC_KT), lkv - *c0);
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
    const uint32_t sk = sq + QB + stage * 2 * KVB;
    wg::load_tile<D>(sk, kh + (size_t)c0 * D, kh, TC_KT, ncol, tid,
                     TC_THREADS);
    wg::load_tile<D>(sk + KVB, vh + (size_t)c0 * D, vh, TC_KT, ncol, tid,
                     TC_THREADS);
  };

  // one commit group per tile (empty past the last), so that waiting for
  // all but the newest TC_STAGES - 2 groups lands the tile about to be used
  wg::load_tile<D>(sq, qh + (size_t)row0 * D, qh, TC_ROWS, nrow, tid,
                   TC_THREADS);
  wg::cp_async_commit();
  int cur = next(0);
  int ahead = cur;  // the last tile issued
#pragma unroll
  for (int st = 0; st < TC_STAGES - 1; ++st) {
    if (st > 0 && ahead < total) ahead = next(ahead + 1);
    if (ahead < total) issue(ahead, st);
    wg::cp_async_commit();
  }
  // q * scale rounded to bf16, as the plain version computes it: each
  // thread rescales the chunks it copied, once they have landed
  wg::cp_async_wait<TC_STAGES - 1>();
  wg::scale_tile<D>(smem_raw + (sq - wg::smem_u32(smem_raw)), TC_ROWS, tid,
                    TC_THREADS, sp.scale);

  float o[R];
#pragma unroll
  for (int e = 0; e < R; ++e) o[e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int r_lo = warp * 16 + lane / 4;  // row of half 0; half 1 is +8
  int stage = 0;
  while (cur < total) {
    wg::cp_async_wait<TC_STAGES - 2>();  // this tile (and Q) have landed
    wg::fence_async_smem();
    __syncthreads();  // ... and every warpgroup is done with the stage
                      // that the next load refills
    if (ahead < total) ahead = next(ahead + 1);
    if (ahead < total) issue(ahead, (stage + TC_STAGES - 1) % TC_STAGES);
    wg::cp_async_commit();
    int kind, c0;
    const int ncol = cols(cur, &kind, &c0);
    const int k0 = sp.kv_offset + c0;
    if (wn > 0 && any_visible(sp, wq0, wq0 + wn - 1, k0, k0 + ncol - 1,
                              kind)) {  // uniform across the warpgroup
      const bool full = wn == 64 && ncol == TC_KT &&
                        all_visible(sp, wq0, wq0 + 63, k0, k0 + TC_KT - 1,
                                    kind);
      const uint32_t sk = sq + QB + stage * 2 * KVB;
      float sc[RS];
#pragma unroll
      for (int e = 0; e < RS; ++e) sc[e] = 0.f;
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wg::mma_ss<TC_KT>(sc, wg::desc_k(sq, TC_ROWS, 64 * wgi, kk),
                          wg::desc_k(sk, TC_KT, 0, kk), 1);
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_regs(sc);
      if (sp.softcap != 0.f) {
#pragma unroll
        for (int e = 0; e < RS; ++e)
          sc[e] = sp.softcap * tanhf(sc[e] / sp.softcap);
      }
      if (!full) {  // masked scores are -inf: p = 0
        uint32_t vis[2];  // bit j: the thread's column j of the row
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int rr = r_lo + 8 * hh;
          const int off = (lane & 3) * 2;  // the thread's first column
          vis[hh] = rr < wn ? key_range(sp, wq0 + rr, k0 + off, ncol - off,
                                        kind).bits()
                            : 0u;  // a dead row sees nothing
        }
#pragma unroll
        for (int e = 0; e < RS; ++e)
          if (!((vis[(e >> 1) & 1] >> (2 * (e >> 2) + (e & 1))) & 1u))
            sc[e] = -INFINITY;
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int e = 0; e < RS; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
      float alpha[2], ml[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        alpha[hh] = wg::ex2((m[hh] - mx[hh]) * LOG2E);
        m[hh] = mx[hh];
        ml[hh] = mx[hh] * LOG2E;
        l[hh] *= alpha[hh];
      }
#pragma unroll
      for (int e = 0; e < RS; ++e) {
        const int hh = (e >> 1) & 1;
        const float p = wg::ex2(fmaf(sc[e], LOG2E, -ml[hh]));
        sc[e] = p;
        l[hh] += p;
      }
      if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
        for (int e = 0; e < R; ++e) o[e] *= alpha[(e >> 1) & 1];
      }
      uint32_t pa[TC_KT / 16][4];  // P in bf16, the A operand of PV
#pragma unroll
      for (int kk = 0; kk < TC_KT / 16; ++kk) wg::a_frag(sc, kk, pa[kk]);
      const uint32_t sv = sk + KVB;
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_KT / 16; ++kk)
        wg::mma_rs<D>(o, pa[kk], wg::desc_mn(sv, TC_KT, kk), 1);
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_regs(o);
    }
    cur = next(cur + 1);
    stage = (stage + 1) % TC_STAGES;
  }
  wg::cp_async_wait<0>();
  if (wn <= 0) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int rr = r_lo + 8 * hh;
    if (rr >= wn) continue;
    const size_t row = ((size_t)b * hq + h) * lq + (row0 + 64 * wgi + rr);
    const float inv = 1.f / fmaxf(l[hh], 1e-30f);
    __nv_bfloat16* orow = out + row * D + (lane & 3) * 2;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(orow + c * 8) =
          __floats2bfloat162_rn(o[4 * c + 2 * hh] * inv,
                                o[4 * c + 2 * hh + 1] * inv);
    if ((lane & 3) == 0) lse[row] = m[hh] + logf(fmaxf(l[hh], 1e-30f));
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const int* kv_map,
              const int* kinds, void* out, float* lse, int b, int hq,
              int hkv, int lq, int lkv, int nq, int num_slots, int block_q,
              int block_kv, Spec sp, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<D>();
  auto kern = attention_fwd_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nsub = (block_q + TC_ROWS - 1) / TC_ROWS;
  dim3 grid(nq * nsub, hq, b);
  kern<<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), kv_map, kinds,
      static_cast<__nv_bfloat16*>(out), lse, hq, hkv, lq, lkv, num_slots,
      block_q, block_kv, nsub, sp);
  return (int)cudaGetLastError();
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

// The tensor-core route: bf16 only (dtype 1), head dim 64, 128 or 256;
// arguments as swat_attention_fwd's. Returns cudaGetLastError().
extern "C" int swat_attention_fwd_tc(
    const void* q, const void* k, const void* v, const void* kv_map,
    const void* kinds, void* out, void* lse, int b, int hq, int hkv, int lq,
    int lkv, int d, int nq, int num_slots, int block_q, int block_kv,
    int sparse, int window, int causal, int num_global, int num_random,
    int q_offset, int kv_offset, int seq_kv, float scale, float softcap,
    int dtype, void* stream) {
  if (dtype != 1 || block_q < 1 || block_kv < 1 || hkv < 1 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  Spec sp{sparse, window, causal, num_global, num_random,
          q_offset, kv_offset, seq_kv, scale, softcap};
  auto st = static_cast<cudaStream_t>(stream);
  const int* km = static_cast<const int*>(kv_map);
  const int* kd = static_cast<const int*>(kinds);
  float* ls = static_cast<float*>(lse);
  switch (d) {
    case 64:
      return launch_tc<64>(q, k, v, km, kd, out, ls, b, hq, hkv, lq, lkv, nq,
                           num_slots, block_q, block_kv, sp, st);
    case 128:
      return launch_tc<128>(q, k, v, km, kd, out, ls, b, hq, hkv, lq, lkv,
                            nq, num_slots, block_q, block_kv, sp, st);
    case 256:
      return launch_tc<256>(q, k, v, km, kd, out, ls, b, hq, hkv, lq, lkv,
                            nq, num_slots, block_q, block_kv, sp, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
