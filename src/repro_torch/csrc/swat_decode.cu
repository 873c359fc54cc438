// SWAT ring-decode kernels for Hopper (sm_90a), two modes of one TPU kernel.
//
// Fused (`swat_decode_fused`): the step's new K/V rows are written into their
// ring slots and the window is attended in the same launch. Replaces
// src/repro/kernels/swat_decode.py::_decode_kernel in fused mode (the
// `swat_decode_fused` pallas_call), reached by ops.decode_attention(new_kv=...)
// on every decode token of every layer.
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
// memory exactly once, keep scores, probabilities and the accumulator in
// registers (nothing intermediate goes back to device memory), and write
// only the output (plus, fused, the T new cache rows; plain, one fp32
// partial state per row and kv split).
//
// Layout: the GQA group of query heads and the T tokens are packed into
// `rows = group*T` query rows per (slot, kv head), as the TPU kernel packs
// its MXU tile (plain mode can also run unpacked, pack_gqa=False: a CTA
// serves one q head's T rows and reads kv head h / group).
//
// Fused design. Decode's few query rows (4 at llama's serve shape) are far
// below a 64-row wgmma tile, so it runs on the CUDA cores; what matters is
// keeping enough bytes in flight on enough SMs.
// - One launch, S CTAs per (slot, kv head) in a thread-block cluster of S
//   (S <= 8, the portable size; the wrapper picks S so that B*Hkv*S covers
//   the SMs about once: 4 x 32 = 128 CTAs at llama's serve shape). Cluster
//   rank c takes rows [c*chunk, min((c+1)*chunk, cap)) of the ring.
// - Each CTA streams its chunk through a three-stage ring of bf16 (or
//   fp32) shared tiles filled by 16-byte cp.async copies; tiles in which no
//   query row sees a slot are neither loaded nor visited (a cold ring's
//   CTAs past its first rows contribute an empty state).
// - Thread layout: a lane holds 8 values of a row (16 bytes of bf16), so
//   a key group of D/8 lanes shares a key; dot products are finished with
//   warp shuffles. A key group takes 4 keys at once: their scores for
//   every row are independent, and each row's online-softmax state is
//   updated once per 4 keys, without a branch. A thread keeps, for each
//   of up to 4 query rows of a pass, its 8 q values and its slice of the
//   state (max, sum, 8 accumulator values): no thread holds a full D-row,
//   so the register count does not grow with D (no spill at D=256). Rows
//   beyond 4 (group*T up to 128) run in further passes.
// - Merge: the key groups of a warp by shuffles, the 4 warps through shared
//   memory, then, after a cluster barrier, the S partial states in rank
//   order through distributed shared memory; each CTA of the cluster writes
//   its share of the outputs. No second kernel, no global workspace, and a
//   fixed merge order: the output is bitwise repeatable.
// - Insert without ordering across CTAs: for each new row j < num_new, the
//   CTA whose chunk holds its slot writes it into the caches, and every
//   load of that slot reads new_k/new_v[j] instead of the cache. So no CTA
//   reads a cache row this launch writes, and the loads need no fence.
//
// Plain: nothing is written to the cache, so the kv range is split across
// CTAs (grid: kv splits x (slot, head)); the wrapper picks the split count so
// that the grid covers the card's SMs about twice (whisper-tiny's cross
// attention at 8 clips: 48 (slot, head) pairs x 6 splits of 256 of the 1500
// encoder rows). 128 threads: thread (s, r) owns query row r (< rows_pad,
// rows rounded up to a power of two) and the kv columns c with c % split ==
// s of every tile, where split = 128 / rows_pad, with its own fp32
// online-softmax state; the CTA merges them through shared memory and
// writes its rows' (max, sum, accumulator) partial state in fp32; a second
// small kernel combines the splits in a fixed order, so the result is
// deterministic.
//
// Masks are rebuilt per column from pos, num_new, ring_cap, num_global and
// window exactly as _decode_kernel does (slot_visible); plain mode takes
// total = pos and q0 = pos - T (the queries are the newest tokens).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;  // plain mode
constexpr int MAX_ROWS = 128;  // query rows of one (slot, head)

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

// The token cache slot s holds with `total` tokens in the cache, and whether
// it holds one: pinned slot s < g holds token s; ring slot s holds the newest
// token congruent to s (mod ring) below `total` (swat_decode.py:168-188).
__device__ __forceinline__ int slot_token(int s, int g, int ring, int total,
                                          bool* held) {
  if (s < g) {
    *held = s < total;
    return s;
  }
  const int last = total - 1;
  const int t = last - pmod(last - s, ring);
  *held = t >= g;
  return t;
}

// Is a slot holding token t_s (held: it holds one; pinned: s < g) visible to
// query token qp?
__device__ __forceinline__ bool token_visible(int t_s, bool held, bool pinned,
                                              int qp, int causal,
                                              int window) {
  bool vis = held;
  if (causal) vis = vis && t_s <= qp;
  if (window) vis = vis && (t_s >= qp - window || pinned);
  return vis;
}

// Is cache slot s visible to query token qp, with `total` tokens in the
// cache? The mask of both modes.
__device__ __forceinline__ bool slot_visible(int s, int g, int ring,
                                             int total, int qp, int causal,
                                             int window) {
  bool held;
  const int t_s = slot_token(s, g, ring, total, &held);
  return token_visible(t_s, held, s < g, qp, causal, window);
}

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

// ------------------------------------------------------------ fused mode ---

constexpr int PIECE = 8;      // values of a row one lane holds
constexpr int RB = 4;         // query rows a pass keeps in registers
constexpr int STAGES = 3;     // stages of the K/V tile ring
// 4 warps: two CTAs fit an SM (~220 registers a thread), so that a
// cluster's CTAs find room together; with 8 warps a CTA fills an SM and
// clusters of 4 at the serve shape no longer all fit at once
constexpr int FUSED_THREADS = 128;
constexpr int WARPS = FUSED_THREADS / 32;
constexpr int MAX_SPLITS = 8;       // the portable cluster size

// kv rows per tile: 16 KB of K (and of V) a stage, at most 128 rows
template <typename T, int D>
__host__ __device__ constexpr int fused_kt() {
  const int kt = 16384 / (D * (int)sizeof(T));
  return kt < 128 ? kt : 128;
}

// keys a key group (the D/8 lanes that share a key) takes at once: 4, or
// fewer where a tile holds fewer than 4 for each key group of the CTA
template <typename T, int D>
__host__ __device__ constexpr int fused_uk() {
  const int per_group = fused_kt<T, D>() / (WARPS * (32 / (D / PIECE)));
  return per_group < 4 ? per_group : 4;
}

template <typename T, int D>
__host__ __device__ constexpr size_t fused_tile_bytes() {
  return (size_t)fused_kt<T, D>() * D * sizeof(T);
}

// the stages (later the warps' partial states), then the CTA's partial
// state (RB rows of D accumulator values, their max and sum), which the
// cluster reads
template <typename T, int D>
constexpr size_t fused_smem_bytes() {
  return STAGES * 2 * fused_tile_bytes<T, D>() + RB * (D + 2) * sizeof(float);
}

// 8 consecutive values at p (16-byte aligned) as fp32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  widen(*reinterpret_cast<const uint4*>(p), f, __nv_bfloat16());
}
__device__ __forceinline__ void load8(const float* p, float* f) {
  widen(reinterpret_cast<const uint4*>(p)[0], f, 0.f);
  widen(reinterpret_cast<const uint4*>(p)[1], f + 4, 0.f);
}

// (m, l, acc) <- the merge of (m, l, acc) and (mo, lo, acco): softmax
// states of disjoint key sets
__device__ __forceinline__ void merge_state(float& m, float& l, float* acc,
                                            float mo, float lo,
                                            const float* acco) {
  const float mm = fmaxf(m, mo);
  const float fa = expf(m - mm), fb = expf(mo - mm);
  l = fmaf(lo, fb, l * fa);
#pragma unroll
  for (int e = 0; e < PIECE; ++e) acc[e] = fmaf(acco[e], fb, acc[e] * fa);
  m = mm;
}

template <typename T, int D>
__global__ void __launch_bounds__(FUSED_THREADS) decode_fused_kernel(
    const T* __restrict__ q,  // (B, Hkv, rows, D), rows = group*T
    T* kc, T* vc,             // (B, Hkv, W, D), updated in place
    const T* __restrict__ nk, const T* __restrict__ nv,  // (B, Hkv, T, D)
    const int* __restrict__ pos, const int* __restrict__ num_new,
    T* __restrict__ out,  // (B, Hkv, rows, D)
    int hkv, int rows, int tspan, int w, int cap, int g, int window,
    int causal, int chunk, float scale, float softcap) {
  constexpr int KT = fused_kt<T, D>();
  constexpr int LPK = D / PIECE;  // lanes that share a key
  constexpr int KPW = 32 / LPK;   // key groups of a warp
  constexpr int UK = fused_uk<T, D>();  // keys a key group takes at once
  constexpr int KSTEP = WARPS * KPW * UK;  // keys the CTA takes at once
  constexpr int CPR = D * (int)sizeof(T) / 16;  // 16-byte chunks a row
  constexpr uint32_t TB = (uint32_t)fused_tile_bytes<T, D>();
  constexpr int DS = D + 2;  // a partial state: D values, max, sum
  static_assert(D % PIECE == 0 && LPK <= 32 && KT % KSTEP == 0 &&
                    FUSED_THREADS % CPR == 0,
                "fused decode layout");
  static_assert(WARPS * RB * DS * sizeof(float) <= STAGES * 2 * TB,
                "the warps' partial states reuse the stages");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // (RB, DS): the CTA's partial state; (WARPS, RB, DS): the warps'
  float* cpart = reinterpret_cast<float*>(smem_raw + STAGES * 2 * TB);
  float* wpart = reinterpret_cast<float*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nsplit = gridDim.x;  // the cluster spans the grid's x
  const int bh = blockIdx.y;  // b * hkv + h
  const int b = bh / hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int kg = lane / LPK;  // the warp's key group of this lane
  const int e0 = (lane % LPK) * PIECE;  // the lane's first value of a row
  const int p = pos[b];
  const int nn = num_new[b];
  const int total = p + nn;
  const int last = total - 1;
  const int nins = min(nn, tspan);  // new rows written this step
  const int ring = cap - g;
  const int lo = rank * chunk;
  const int hi = min(lo + chunk, cap);  // slots >= cap are never visible
  const int ntile = hi > lo ? (hi - lo + KT - 1) / KT : 0;
  const int qmax = p + tspan - 1;  // the newest query token
  const float inv_cap = softcap != 0.f ? 1.f / softcap : 0.f;
  T* kb = kc + (size_t)bh * w * D;
  T* vb = vc + (size_t)bh * w * D;
  const T* nkb = nk + (size_t)bh * tspan * D;
  const T* nvb = nv + (size_t)bh * tspan * D;

  // The token of slot base + c and whether it holds one, as slot_token
  // computes them, from d0 = pmod(last - base, ring) (one modulo a tile).
  auto tile_token = [&](int base, int d0, int c, bool* held) {
    const int s = base + c;
    if (s < g) {
      *held = s < total;
      return s;
    }
    int x = d0 - c;
    while (x < 0) x += ring;
    const int t = last - x;
    *held = t >= g;
    return t;
  };
  // does tile t hold a slot that some query row may see? (a superset of
  // the per-row mask; the same answer in every warp)
  auto seen = [&](int t) {
    const int base = lo + t * KT;
    const int n = min(KT, hi - base);
    const int d0 = pmod(last - base, ring);
    bool any = false;
    for (int c = lane; c < n; c += 32) {
      bool held;
      const int ts = tile_token(base, d0, c, &held);
      any = any || (token_visible(ts, held, base + c < g, qmax, causal, 0) &&
                    (!window || base + c < g || ts >= p - window));
    }
    return __any_sync(0xffffffffu, any);
  };
  auto next = [&](int t) {
    for (; t < ntile; ++t)
      if (seen(t)) return t;
    return ntile;
  };
  // K and V rows of tile t into stage `stage`; a slot this step writes
  // reads its new row j (slot g + (p+j-g) mod ring, or p+j below g)
  const uint32_t st0 = wg::smem_u32(smem_raw);
  auto issue = [&](int t, int stage) {
    const int base = lo + t * KT;
    const int n = min(KT, hi - base);
    const int j0 = pmod(base - p, ring);
    const uint32_t sk = st0 + stage * 2 * TB;
    const int c = tid % CPR;
    for (int r = tid / CPR; r < n; r += FUSED_THREADS / CPR) {
      const int s = base + r;
      int j = s - p;
      if (s >= g) {
        j = j0 + r;
        while (j >= ring) j -= ring;
        if (p + j < g) j = -1;
      }
      const bool fresh = j >= 0 && j < nins;
      const T* ks = fresh ? nkb + (size_t)j * D : kb + (size_t)s * D;
      const T* vs = fresh ? nvb + (size_t)j * D : vb + (size_t)s * D;
      const uint32_t off = r * D * (uint32_t)sizeof(T) + c * 16;
      wg::cp_async16(sk + off, reinterpret_cast<const uint8_t*>(ks) + c * 16,
                     16);
      wg::cp_async16(sk + TB + off,
                     reinterpret_cast<const uint8_t*>(vs) + c * 16, 16);
    }
  };

  for (int r0 = 0; r0 < rows; r0 += RB) {  // uniform across the cluster
    const int nr = min(RB, rows - r0);
    float qr[RB][PIECE], acc[RB][PIECE], m[RB], l[RB];
    int qp[RB];  // each row's query token
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) {
      if (rr < nr) load8(q + ((size_t)bh * rows + r0 + rr) * D + e0, qr[rr]);
#pragma unroll
      for (int e = 0; e < PIECE; ++e) {
        qr[rr][e] = rr < nr ? qr[rr][e] * scale : 0.f;
        acc[rr][e] = 0.f;
      }
      m[rr] = NEG_INF;
      l[rr] = 0.f;
      qp[rr] = p + (r0 + rr) % tspan;
    }

    // the chunk's visible tiles through the ring of STAGES tiles: one
    // commit group per tile (empty past the last), so that waiting for all
    // but the newest STAGES - 2 groups lands the tile about to be used
    int cur = next(0);
    int ahead = cur;  // the last tile issued
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st > 0 && ahead < ntile) ahead = next(ahead + 1);
      if (ahead < ntile) issue(ahead, st);
      wg::cp_async_commit();
    }
    if (r0 == 0) {  // after the first loads are issued, so that they overlap
      // the ring insert, by the CTA whose chunk holds the slot: token p+j
      // goes to slot g + (p+j-g) mod ring (pinned below g); T <= ring, so
      // the slots are distinct. No load of this launch reads these rows of
      // the caches, so the insert needs no ordering against them.
      for (int j = 0; j < nins; ++j) {
        const int pj = p + j;
        const int slot = pj < g ? pj : g + pmod(pj - g, ring);
        if (slot < lo || slot >= hi) continue;
        for (int c = tid; c < 2 * CPR; c += FUSED_THREADS) {
          const bool isv = c >= CPR;
          const uint4* src = reinterpret_cast<const uint4*>(
              (isv ? nvb : nkb) + (size_t)j * D);
          uint4* dst = reinterpret_cast<uint4*>((isv ? vb : kb) +
                                                (size_t)slot * D);
          dst[c % CPR] = src[c % CPR];
        }
      }
    }
    int stage = 0;
    while (cur < ntile) {
      wg::cp_async_wait<STAGES - 2>();  // this tile has landed
      __syncthreads();  // ... and every warp is done with the stage that
                        // the next issue refills
      if (ahead < ntile) ahead = next(ahead + 1);
      if (ahead < ntile) issue(ahead, (stage + STAGES - 1) % STAGES);
      wg::cp_async_commit();
      const int base = lo + cur * KT;
      const int n = min(KT, hi - base);
      const int d0 = pmod(last - base, ring);
      const T* ks = reinterpret_cast<const T*>(smem_raw + stage * 2 * TB);
      const T* vs =
          reinterpret_cast<const T*>(smem_raw + stage * 2 * TB + TB);
      // UK keys of each key group at once: their scores for every row are
      // independent, then one online-softmax update a row
      for (int c0 = warp * KPW * UK; c0 < n; c0 += KSTEP) {  // warp-uniform
        float kf[UK][PIECE], vf[UK][PIECE];
        int ts[UK];
        bool held[UK], pin[UK];
#pragma unroll
        for (int u = 0; u < UK; ++u) {
          const int c = c0 + u * KPW + kg;
          held[u] = false;
          ts[u] = 0;
          if (c < n) {
            load8(ks + c * D + e0, kf[u]);
            load8(vs + c * D + e0, vf[u]);
            ts[u] = tile_token(base, d0, c, &held[u]);
          } else {  // past the chunk: never loaded; p = 0 must not meet NaN
#pragma unroll
            for (int e = 0; e < PIECE; ++e) kf[u][e] = vf[u][e] = 0.f;
          }
          pin[u] = base + c < g;
        }
#pragma unroll
        for (int rr = 0; rr < RB; ++rr) {
          if (rr >= nr) continue;  // uniform
          float sc[UK];
#pragma unroll
          for (int u = 0; u < UK; ++u) {
            float x = 0.f;
#pragma unroll
            for (int e = 0; e < PIECE; ++e) x = fmaf(qr[rr][e], kf[u][e], x);
            sc[u] = x;
          }
#pragma unroll
          for (int o = LPK / 2; o > 0; o >>= 1) {
#pragma unroll
            for (int u = 0; u < UK; ++u)
              sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], o);
          }
          float mx = m[rr];
#pragma unroll
          for (int u = 0; u < UK; ++u) {
            float x = sc[u];
            if (softcap != 0.f) x = softcap * tanhf(x * inv_cap);
            sc[u] = token_visible(ts[u], held[u], pin[u], qp[rr], causal,
                                  window)
                        ? x
                        : -INFINITY;
            mx = fmaxf(mx, sc[u]);
          }
          const float alpha = expf(m[rr] - mx);
          float ps = 0.f;
#pragma unroll
          for (int u = 0; u < UK; ++u) {
            sc[u] = expf(sc[u] - mx);  // p; 0 where masked
            ps += sc[u];
          }
          l[rr] = fmaf(l[rr], alpha, ps);
#pragma unroll
          for (int e = 0; e < PIECE; ++e) {
            float a = acc[rr][e] * alpha;
#pragma unroll
            for (int u = 0; u < UK; ++u) a = fmaf(sc[u], vf[u][e], a);
            acc[rr][e] = a;
          }
          m[rr] = mx;
        }
      }
      cur = next(cur + 1);
      stage = (stage + 1) % STAGES;
    }
    wg::cp_async_wait<0>();
    __syncthreads();  // every warp is done with the stages, which the
                      // warps' partial states reuse

    // merge: the warp's key groups (shuffles), the warps (shared memory),
    // then the cluster's CTAs (distributed shared memory)
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1) {
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) {
        if (rr >= nr) continue;
        float acco[PIECE];
#pragma unroll
        for (int e = 0; e < PIECE; ++e)
          acco[e] = __shfl_xor_sync(0xffffffffu, acc[rr][e], o);
        const float mo = __shfl_xor_sync(0xffffffffu, m[rr], o);
        const float lo_ = __shfl_xor_sync(0xffffffffu, l[rr], o);
        merge_state(m[rr], l[rr], acc[rr], mo, lo_, acco);
      }
    }
    if (kg == 0) {
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) {
        if (rr >= nr) continue;
        float* dst = wpart + (warp * RB + rr) * DS;
#pragma unroll
        for (int e = 0; e < PIECE; ++e) dst[e0 + e] = acc[rr][e];
        if (e0 == 0) {
          dst[D] = m[rr];
          dst[D + 1] = l[rr];
        }
      }
    }
    __syncthreads();
    for (int idx = tid; idx < nr * D; idx += FUSED_THREADS) {
      const int rr = idx / D, e = idx % D;
      float mm = NEG_INF;
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi)
        mm = fmaxf(mm, wpart[(wi * RB + rr) * DS + D]);
      float ll = 0.f, aa = 0.f;
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) {
        const float* src = wpart + (wi * RB + rr) * DS;
        const float f = expf(src[D] - mm);
        ll = fmaf(src[D + 1], f, ll);
        aa = fmaf(src[e], f, aa);
      }
      cpart[rr * DS + e] = aa;
      if (e == 0) {
        cpart[rr * DS + D] = mm;
        cpart[rr * DS + D + 1] = ll;
      }
    }
    cluster.sync();  // every CTA's partial state is written and visible
    const int n_out = nr * D;
    const int per = (n_out + nsplit - 1) / nsplit;
    const int o1 = min(n_out, (rank + 1) * per);
    for (int idx = rank * per + tid; idx < o1; idx += FUSED_THREADS) {
      const int rr = idx / D, e = idx % D;
      float rm[MAX_SPLITS], rl[MAX_SPLITS], ra[MAX_SPLITS];
#pragma unroll
      for (int c = 0; c < MAX_SPLITS; ++c) {  // all remote loads at once
        if (c < nsplit) {
          const float* src = cluster.map_shared_rank(cpart, c) + rr * DS;
          rm[c] = src[D];
          rl[c] = src[D + 1];
          ra[c] = src[e];
        }
      }
      float mm = NEG_INF;
#pragma unroll
      for (int c = 0; c < MAX_SPLITS; ++c)
        if (c < nsplit) mm = fmaxf(mm, rm[c]);
      float ll = 0.f, aa = 0.f;
#pragma unroll
      for (int c = 0; c < MAX_SPLITS; ++c) {  // rank order
        if (c < nsplit) {
          const float f = expf(rm[c] - mm);
          ll = fmaf(rl[c], f, ll);
          aa = fmaf(ra[c], f, aa);
        }
      }
      out[((size_t)bh * rows + r0 + rr) * D + e] =
          from_f<T>(aa / fmaxf(ll, 1e-30f));
    }
    cluster.sync();  // no CTA reuses (or leaves) its shared memory while
                     // another still reads it
  }
}

struct FusedArgs {
  const void *q, *nk, *nv;
  void *kc, *vc, *out;
  const int *pos, *nn;
  int b, hkv, rows, tspan, w, cap, g, window, causal, chunk, nsplit;
  float scale, softcap;
};

template <typename T, int D>
int launch(const FusedArgs& a, cudaStream_t stream) {
  const size_t smem = fused_smem_bytes<T, D>();
  auto kern = decode_fused_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.nsplit, a.b * a.hkv, 1);
  cfg.blockDim = dim3(FUSED_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.nsplit;  // the splits of one (slot, kv head)
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(a.q), static_cast<T*>(a.kc),
      static_cast<T*>(a.vc), static_cast<const T*>(a.nk),
      static_cast<const T*>(a.nv), a.pos, a.nn, static_cast<T*>(a.out), a.hkv,
      a.rows, a.tspan, a.w, a.cap, a.g, a.window, a.causal, a.chunk, a.scale,
      a.softcap);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const FusedArgs& a, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ------------------------------------------------------------ plain mode ---

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

// kv rows per shared-memory tile in plain mode: one row per thread at D <= 64
// (whisper's single-row cross attention keeps all 128 threads busy), fewer
// where two fp32 (KT, D+1) tiles would outgrow shared memory
template <int D>
__host__ __device__ constexpr int plain_kt() { return D <= 64 ? 128 : (D <= 128 ? 64 : 32); }

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
// pos / num_new: int32 (B,) device arrays. The ring [0, cap) is cut into
// nsplit (1..8) chunks of `chunk` rows, none empty, one CTA each, the CTAs
// of a (slot, kv head) forming one thread-block cluster. Every pointer is
// 16-byte aligned. Returns cudaGetLastError().
extern "C" int swat_decode_fused(const void* q, void* k_cache, void* v_cache,
                                 const void* new_k, const void* new_v,
                                 const void* pos, const void* num_new,
                                 void* out, int b, int hkv, int rows,
                                 int tspan, int d, int w, int cap, int g,
                                 int window, int causal, int chunk,
                                 int nsplit, float scale, float softcap,
                                 int dtype, void* stream) {
  if (rows < 1 || rows > MAX_ROWS || tspan < 1 || tspan > cap - g ||
      cap > w || cap <= g || nsplit < 1 || nsplit > MAX_SPLITS || chunk < 1 ||
      (long)chunk * (nsplit - 1) >= cap || (long)chunk * nsplit < cap)
    return (int)cudaErrorInvalidValue;
  FusedArgs a{q, new_k, new_v, k_cache, v_cache, out,
              static_cast<const int*>(pos), static_cast<const int*>(num_new),
              b, hkv, rows, tspan, w, cap, g, window, causal, chunk, nsplit,
              scale, softcap};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(d, a, st);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(d, a, st);
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
