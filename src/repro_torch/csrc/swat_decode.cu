// SWAT ring-decode kernel for Hopper (sm_90a): one kernel, in the two modes
// of one TPU kernel.
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
// token of every decoder layer. Plain mode is the fused computation without
// the insert (a compile-time flag; kernels decode_fused_kernel and
// decode_plain_kernel): total = pos tokens in the cache and the
// queries its newest, q0 = pos - T.
//
// What bounds both on an H100: bytes. A CTA reads its K and V rows once and
// does 4*rows*D flops per row, far below the ~295 flops/byte the card needs
// to be compute bound. The design therefore streams each K/V row from device
// memory exactly once, keeps scores, probabilities and the accumulator in
// registers (nothing intermediate goes back to device memory), and writes
// only the output (plus, fused, the T new cache rows).
//
// Layout: the GQA group of query heads and the T tokens are packed into
// `rows = group*T` query rows per (slot, kv head), as the TPU kernel packs
// its MXU tile (plain mode can also run unpacked, pack_gqa=False: a cluster
// serves one q head's T rows and reads kv head h / group).
//
// Decode's few query rows (4 at llama's serve shape, 1 for whisper's cross
// attention) are far below a 64-row wgmma tile, so it runs on the CUDA
// cores; what matters is keeping enough bytes in flight on enough SMs.
// - One launch, S CTAs per (slot, head) in a thread-block cluster of S
//   (S <= 8, the portable size). The wrapper picks S: fused so that the
//   grid covers the SMs about once (4 x 32 = 128 CTAs at llama's serve
//   shape), plain from its own rule (kernels/swat_decode.py `plain_splits`:
//   a long cache has no insert to serialise). Cluster rank c takes rows
//   [c*chunk, min((c+1)*chunk, cap)) of the cache.
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
// - Fused insert without ordering across CTAs: for each new row j <
//   num_new, the CTA whose chunk holds its slot writes it into the caches,
//   and every load of that slot reads new_k/new_v[j] instead of the cache.
//   So no CTA reads a cache row this launch writes, and the loads need no
//   fence.
//
// Masks are rebuilt per column from pos, num_new, ring_cap, num_global and
// window exactly as _decode_kernel does (token_visible).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_ROWS = 128;  // query rows of one (slot, head)

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

// --------------------------------------------------------------- kernel ---

constexpr int PIECE = 8;      // values of a row one lane holds
constexpr int RB = 4;         // query rows a pass keeps in registers
constexpr int STAGES = 3;     // stages of the K/V tile ring
// 4 warps: two CTAs fit an SM (~220 registers a thread), so that a
// cluster's CTAs find room together; with 8 warps a CTA fills an SM and
// clusters of 4 at the serve shape no longer all fit at once
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SPLITS = 8;       // the portable cluster size

// kv rows per tile: 16 KB of K (and of V) a stage, at most 128 rows
template <typename T, int D>
__host__ __device__ constexpr int tile_rows() {
  const int kt = 16384 / (D * (int)sizeof(T));
  return kt < 128 ? kt : 128;
}

// keys a key group (the D/8 lanes that share a key) takes at once: 4, or
// fewer where a tile holds fewer than 4 for each key group of the CTA
template <typename T, int D>
__host__ __device__ constexpr int group_keys() {
  const int per_group = tile_rows<T, D>() / (WARPS * (32 / (D / PIECE)));
  return per_group < 4 ? per_group : 4;
}

template <typename T, int D>
__host__ __device__ constexpr size_t tile_bytes() {
  return (size_t)tile_rows<T, D>() * D * sizeof(T);
}

// the stages (later the warps' partial states), then the CTA's partial
// state (RB rows of D accumulator values, their max and sum), which the
// cluster reads
template <typename T, int D>
constexpr size_t smem_bytes() {
  return STAGES * 2 * tile_bytes<T, D>() + RB * (D + 2) * sizeof(float);
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

// The kernel of both modes (decode_fused_kernel, decode_plain_kernel
// below). PLAIN: plain mode (nothing inserted; nk, nv and num_new unused).
template <typename T, int D, bool PLAIN>
__device__ __forceinline__ void decode(
    const T* __restrict__ q,  // (B, grid_h, rows, D)
    T* kc, T* vc,             // (B, Hkv, W, D), fused: updated in place
    const T* __restrict__ nk, const T* __restrict__ nv,  // (B, Hkv, T, D)
    const int* __restrict__ pos, const int* __restrict__ num_new,
    T* __restrict__ out,  // (B, grid_h, rows, D)
    int hkv, int heads_per_kv, int rows, int tspan, int w, int cap, int g,
    int window, int causal, int chunk, float scale, float softcap) {
  constexpr int KT = tile_rows<T, D>();
  constexpr int LPK = D / PIECE;  // lanes that share a key
  constexpr int KPW = 32 / LPK;   // key groups of a warp
  constexpr int UK = group_keys<T, D>();  // keys a key group takes at once
  constexpr int KSTEP = WARPS * KPW * UK;  // keys the CTA takes at once
  constexpr int CPR = D * (int)sizeof(T) / 16;  // 16-byte chunks a row
  constexpr uint32_t TB = (uint32_t)tile_bytes<T, D>();
  constexpr int DS = D + 2;  // a partial state: D values, max, sum
  static_assert(D % PIECE == 0 && LPK <= 32 && KT % KSTEP == 0 &&
                    THREADS % CPR == 0,
                "decode layout");
  static_assert(WARPS * RB * DS * sizeof(float) <= STAGES * 2 * TB,
                "the warps' partial states reuse the stages");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // (RB, DS): the CTA's partial state; (WARPS, RB, DS): the warps'
  float* cpart = reinterpret_cast<float*>(smem_raw + STAGES * 2 * TB);
  float* wpart = reinterpret_cast<float*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nsplit = gridDim.x;  // the cluster spans the grid's x
  // q and out's (slot, head): grid_h = hkv * heads_per_kv heads a slot, the
  // kv heads (packed, heads_per_kv 1) or the q heads (plain, unpacked)
  const int bh = blockIdx.y;
  const int grid_h = hkv * heads_per_kv;
  const int b = bh / grid_h;
  const int kvh = b * hkv + (bh % grid_h) / heads_per_kv;  // caches' row
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int kg = lane / LPK;  // the warp's key group of this lane
  const int e0 = (lane % LPK) * PIECE;  // the lane's first value of a row
  // p: the oldest query's token. Fused: the step's T tokens follow pos[b]
  // (num_new[b] of them real); plain: the cache holds pos[b] tokens and the
  // queries are its newest T
  const int p = PLAIN ? pos[b] - tspan : pos[b];
  const int total = PLAIN ? pos[b] : p + num_new[b];
  const int last = total - 1;
  const int nins = PLAIN ? 0 : min(num_new[b], tspan);  // rows written
  const int ring = cap - g;
  const int lo = rank * chunk;
  const int hi = min(lo + chunk, cap);  // slots >= cap are never visible
  const int ntile = hi > lo ? (hi - lo + KT - 1) / KT : 0;
  const int qmax = p + tspan - 1;  // the newest query token
  const float inv_cap = softcap != 0.f ? 1.f / softcap : 0.f;
  T* kb = kc + (size_t)kvh * w * D;
  T* vb = vc + (size_t)kvh * w * D;
  const T* nkb = PLAIN ? nullptr : nk + (size_t)kvh * tspan * D;
  const T* nvb = PLAIN ? nullptr : nv + (size_t)kvh * tspan * D;

  // The token slot s = base + c holds with `total` tokens in the cache,
  // and whether it holds one (swat_decode.py:168-188): pinned slot s < g
  // holds token s; ring slot s the newest token congruent to s (mod ring)
  // below `total`. From d0 = pmod(last - base, ring): one modulo a tile.
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
  // K and V rows of tile t into stage `stage`; fused, a slot this step
  // writes reads its new row j (slot g + (p+j-g) mod ring, or p+j below g)
  const uint32_t st0 = wg::smem_u32(smem_raw);
  auto issue = [&](int t, int stage) {
    const int base = lo + t * KT;
    const int n = min(KT, hi - base);
    const int j0 = pmod(base - p, ring);
    const uint32_t sk = st0 + stage * 2 * TB;
    const int c = tid % CPR;
    for (int r = tid / CPR; r < n; r += THREADS / CPR) {
      const int s = base + r;
      const T* ks = kb + (size_t)s * D;
      const T* vs = vb + (size_t)s * D;
      if constexpr (!PLAIN) {
        int j = s - p;
        if (s >= g) {
          j = j0 + r;
          while (j >= ring) j -= ring;
          if (p + j < g) j = -1;
        }
        if (j >= 0 && j < nins) {
          ks = nkb + (size_t)j * D;
          vs = nvb + (size_t)j * D;
        }
      }
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
    if (!PLAIN && r0 == 0) {
      // after the first loads are issued, so that they overlap them: (fused)
      // the ring insert, by the CTA whose chunk holds the slot: token p+j
      // goes to slot g + (p+j-g) mod ring (pinned below g); T <= ring, so
      // the slots are distinct. No load of this launch reads these rows of
      // the caches, so the insert needs no ordering against them.
      for (int j = 0; j < nins; ++j) {
        const int pj = p + j;
        const int slot = pj < g ? pj : g + pmod(pj - g, ring);
        if (slot < lo || slot >= hi) continue;
        for (int c = tid; c < 2 * CPR; c += THREADS) {
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
    for (int idx = tid; idx < nr * D; idx += THREADS) {
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
    for (int idx = rank * per + tid; idx < o1; idx += THREADS) {
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

// One kernel name a mode, so that traces and ptxas reports tell them apart.
#define SWAT_DECODE_KERNEL(NAME, PLAIN)                                      \
  template <typename T, int D>                                               \
  __global__ void __launch_bounds__(THREADS) NAME(                           \
      const T* __restrict__ q, T* kc, T* vc, const T* __restrict__ nk,       \
      const T* __restrict__ nv, const int* __restrict__ pos,                 \
      const int* __restrict__ num_new, T* __restrict__ out, int hkv,         \
      int heads_per_kv, int rows, int tspan, int w, int cap, int g,          \
      int window, int causal, int chunk, float scale, float softcap) {       \
    decode<T, D, PLAIN>(q, kc, vc, nk, nv, pos, num_new, out, hkv,           \
                        heads_per_kv, rows, tspan, w, cap, g, window,        \
                        causal, chunk, scale, softcap);                      \
  }
SWAT_DECODE_KERNEL(decode_fused_kernel, false)
SWAT_DECODE_KERNEL(decode_plain_kernel, true)
#undef SWAT_DECODE_KERNEL

struct Args {
  const void *q, *nk, *nv;
  void *kc, *vc, *out;
  const int *pos, *nn;
  int b, hkv, heads_per_kv, rows, tspan, w, cap, g, window, causal, chunk,
      nsplit;
  float scale, softcap;
};

template <typename T, int D, bool PLAIN>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>();
  auto kern = PLAIN ? decode_plain_kernel<T, D> : decode_fused_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.nsplit, a.b * a.hkv * a.heads_per_kv, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.nsplit;  // the splits of one (slot, head)
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(a.q), static_cast<T*>(a.kc),
      static_cast<T*>(a.vc), static_cast<const T*>(a.nk),
      static_cast<const T*>(a.nv), a.pos, a.nn, static_cast<T*>(a.out), a.hkv,
      a.heads_per_kv, a.rows, a.tspan, a.w, a.cap, a.g, a.window, a.causal,
      a.chunk, a.scale, a.softcap);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool PLAIN>
int dispatch(int d, int dtype, const Args& a, cudaStream_t stream) {
#define SWAT_DECODE_CASE(DD)                                               \
  case DD:                                                                 \
    return dtype == 0 ? launch<float, DD, PLAIN>(a, stream)                \
                      : launch<__nv_bfloat16, DD, PLAIN>(a, stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
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

// Does [0, cap) cut into nsplit (1..8) chunks of `chunk` rows, none empty?
bool valid_split(int cap, int chunk, int nsplit) {
  return nsplit >= 1 && nsplit <= MAX_SPLITS && chunk >= 1 &&
         (long)chunk * (nsplit - 1) < cap && (long)chunk * nsplit >= cap;
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
      cap > w || cap <= g || !valid_split(cap, chunk, nsplit))
    return (int)cudaErrorInvalidValue;
  Args a{q, new_k, new_v, k_cache, v_cache, out,
         static_cast<const int*>(pos), static_cast<const int*>(num_new),
         b, hkv, 1, rows, tspan, w, cap, g, window, causal, chunk, nsplit,
         scale, softcap};
  return dispatch<false>(d, dtype, a, static_cast<cudaStream_t>(stream));
}

// Plain mode: nothing inserted, the caches are read only. q / out: (B,
// grid_h, rows, D) with grid_h = hkv * heads_per_kv: packed, grid_h = Hkv
// and rows = group*T (heads_per_kv = 1); unpacked, grid_h = Hq and rows =
// T (heads_per_kv = group). pos: int32 (B,) tokens in each cache, the
// queries its newest T. The cache [0, cap) is cut into nsplit (1..8)
// chunks of `chunk` rows, none empty, one CTA each, the CTAs of a (slot,
// head) forming one thread-block cluster. q and the caches are 16-byte
// aligned. One launch; returns cudaGetLastError().
extern "C" int swat_decode_plain(
    const void* q, const void* k_cache, const void* v_cache, const void* pos,
    void* out, int b, int hkv, int heads_per_kv, int rows, int tspan, int d,
    int w, int cap, int g, int window, int causal, int chunk, int nsplit,
    float scale, float softcap, int dtype, void* stream) {
  if (rows < 1 || rows > MAX_ROWS || tspan < 1 || heads_per_kv < 1 ||
      cap > w || cap <= g || !valid_split(cap, chunk, nsplit))
    return (int)cudaErrorInvalidValue;
  Args a{q, nullptr, nullptr, const_cast<void*>(k_cache),
         const_cast<void*>(v_cache), out, static_cast<const int*>(pos),
         nullptr, b, hkv, heads_per_kv, rows, tspan, w, cap, g, window,
         causal, chunk, nsplit, scale, softcap};
  return dispatch<true>(d, dtype, a, static_cast<cudaStream_t>(stream));
}
