// K2 and K3: paged attention over a stacked KV cache, for Hopper (sm_90a).
//
// K2 replaces dynamo_tpu/ops/paged_attention.py::
// paged_attention_decode_stacked (body _decode_kernel_stacked): one query
// token per sequence against layer `layer` of the stacked paged cache.
// K3 replaces paged_attention_prefill_stacked (body
// _prefill_kernel_stacked): causal flash attention for a chunk of T
// queries at positions start[b] + t, whose own K/V are already in the
// cache. Both honour an optional sliding window and an int8 cache with
// per-(slot, head) f32 scales [L, N, Hk, bs]: the K scale multiplies the
// f32 scores per key, the V scale folds into the probabilities, which are
// then rounded to bf16 before P @ V, as the Pallas kernels do. Online
// softmax in f32; the running sum is floored at 1e-9, so rows with no
// valid key (padded rows, ctx = 0) write exact zeros.
//
// What bounds them on an H100: decode reads every live K/V byte once and
// does 4 operations per cached element, so it is bound by memory. A
// 1024-token prefill chunk does ~T/2 times more work per byte and is
// bound by arithmetic.
//
// Design: the cache is never sliced: the kernels compute the layer's
// offset themselves (64-bit) and read the block table and context length
// of their sequence. A block stages 32 keys at a time, gathered by
// position through the block table with 16-byte loads (so page sizes 16
// and 128 are the same code), converts them to f32 in shared memory
// (int8 and bf16 values are exact in f32), and runs the online-softmax
// update for every query row of its KV head: the G = H/Hk query heads of
// a GQA group share each K/V load. K2: one block per (sequence, KV head).
// K3: one block per (sequence, 64/G-token query tile, KV head), with
// 4x4 register tiles for the scores and 4x(Dh/8) tiles for P @ V; it
// visits only the keys its tile may see (causal end, window start).
// Simple first: f32 FMAs, no tensor cores, no split over pages
// (flash-decoding) yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;   // threads per block
constexpr int C = 32;     // keys staged per step
constexpr int MAXG = 8;   // largest GQA group the decode kernel takes
constexpr int ROWS = 64;  // query rows (tokens x group) per prefill block
constexpr float NEG = -1e30f;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T>
__device__ __forceinline__ void to_float(const uint4& u, float* dst);

template <>
__device__ __forceinline__ void to_float<__nv_bfloat16>(const uint4& u,
                                                        float* dst) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[e] = __bfloat162float(h[e]);
}

template <>
__device__ __forceinline__ void to_float<int8_t>(const uint4& u, float* dst) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int e = 0; e < 16; ++e) dst[e] = (float)b[e];
}

struct Cache {
  const void* k;
  const void* v;
  const float* ks;  // null for a float cache
  const float* vs;
  const int* tables;  // [B, W]
  int layer, Hk, NP, bs, W;
  int64_t S;  // slots per layer
};

// Stage keys/values at positions [p0, p0 + C) of sequence b, head hk,
// into Ks/Vs [C][DH + 4] as f32 (zeros at and past `pend`), with their
// scales (1 for a float cache).
template <typename T, int DH>
__device__ __forceinline__ void stage_chunk(const Cache& c, int b, int hk,
                                            int p0, int pend, float* Ks,
                                            float* Vs, float* kss,
                                            float* vss) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = DH / VEC;
  const T* kc = reinterpret_cast<const T*>(c.k);
  const T* vc = reinterpret_cast<const T*>(c.v);
  for (int i = threadIdx.x; i < C * PER_ROW; i += NT) {
    int row = i / PER_ROW, col = (i % PER_ROW) * VEC;
    int p = p0 + row;
    float kf[VEC], vf[VEC];
    if (p < pend) {
      int64_t slot = (int64_t)c.tables[(int64_t)b * c.W + p / c.bs] * c.bs +
                     p % c.bs;
      int64_t off = (((int64_t)c.layer * c.S + slot) * c.Hk + hk) * DH + col;
      to_float<T>(*reinterpret_cast<const uint4*>(kc + off), kf);
      to_float<T>(*reinterpret_cast<const uint4*>(vc + off), vf);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) kf[e] = vf[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      *reinterpret_cast<float4*>(Ks + row * (DH + 4) + col + e) =
          make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]);
      *reinterpret_cast<float4*>(Vs + row * (DH + 4) + col + e) =
          make_float4(vf[e], vf[e + 1], vf[e + 2], vf[e + 3]);
    }
  }
  for (int row = threadIdx.x; row < C; row += NT) {
    int p = p0 + row;
    float a = 1.0f, bsc = 1.0f;
    if (c.ks != nullptr && p < pend) {
      int page = c.tables[(int64_t)b * c.W + p / c.bs];
      int64_t o = (((int64_t)c.layer * c.NP + page) * c.Hk + hk) * c.bs +
                  p % c.bs;
      a = c.ks[o];
      bsc = c.vs[o];
    }
    kss[row] = a;
    vss[row] = bsc;
  }
}

// One row's online-softmax update over a staged chunk: scores in srow
// (masked entries already NEG) become bf16-rounded p * v_scale in place.
__device__ __forceinline__ void softmax_row(float* srow, const bool* valid,
                                            const float* vss, float* m,
                                            float* l, float* alpha) {
  float m_prev = *m, m_new = m_prev;
#pragma unroll 8
  for (int c = 0; c < C; ++c) m_new = fmaxf(m_new, srow[c]);
  float sum = 0.0f;
#pragma unroll 8
  for (int c = 0; c < C; ++c) {
    float p = valid[c] ? expf(srow[c] - m_new) : 0.0f;
    sum += p;
    srow[c] = round_bf16(p * vss[c]);
  }
  float a = expf(m_prev - m_new);
  *alpha = a;
  *l = *l * a + sum;
  *m = m_new;
}

// ---------------------------------------------------------------- K2 --
template <typename T, int DH>
__global__ void __launch_bounds__(NT) decode_kernel(
    const __nv_bfloat16* __restrict__ q, Cache c,
    const int* __restrict__ ctx_lens, __nv_bfloat16* __restrict__ out, int H,
    int window, float scale) {
  constexpr int PAIRS = MAXG * DH / NT;
  __shared__ __align__(16) float qs[MAXG][DH];
  __shared__ __align__(16) float Ks[C * (DH + 4)];
  __shared__ __align__(16) float Vs[C * (DH + 4)];
  __shared__ float P[MAXG][C];
  __shared__ bool valid[C];
  __shared__ float kss[C], vss[C], m_s[MAXG], l_s[MAXG], a_s[MAXG];

  const int b = blockIdx.x, hk = blockIdx.y;
  const int G = H / c.Hk;
  const int ctx = ctx_lens[b];
  const int lo = window > 0 ? max(ctx - window, 0) : 0;
  const __nv_bfloat16* qb = q + ((int64_t)b * H + hk * G) * DH;
  for (int i = threadIdx.x; i < G * DH; i += NT)
    qs[i / DH][i % DH] = __bfloat162float(qb[i]);
  if (threadIdx.x < G) {
    m_s[threadIdx.x] = NEG;
    l_s[threadIdx.x] = 0.0f;
  }
  float acc[PAIRS];
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) acc[j] = 0.0f;

  for (int p0 = (lo / C) * C; p0 < ctx; p0 += C) {
    __syncthreads();  // previous chunk fully consumed
    stage_chunk<T, DH>(c, b, hk, p0, ctx, Ks, Vs, kss, vss);
    if (threadIdx.x < C) {
      int p = p0 + threadIdx.x;
      valid[threadIdx.x] = p < ctx && p >= lo;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G * C; i += NT) {
      int g = i / C, k = i % C;
      const float4* qv = reinterpret_cast<const float4*>(qs[g]);
      const float4* kv = reinterpret_cast<const float4*>(Ks + k * (DH + 4));
      float dot = 0.0f;
#pragma unroll
      for (int d = 0; d < DH / 4; ++d) {
        float4 a = qv[d], bb = kv[d];
        dot += a.x * bb.x + a.y * bb.y + a.z * bb.z + a.w * bb.w;
      }
      P[g][k] = valid[k] ? dot * scale * kss[k] : NEG;
    }
    __syncthreads();
    if (threadIdx.x < G) {
      int g = threadIdx.x;
      softmax_row(P[g], valid, vss, &m_s[g], &l_s[g], &a_s[g]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PAIRS; ++j) {
      int i = threadIdx.x + j * NT;
      if (i < G * DH) {
        int g = i / DH, d = i % DH;
        float a = 0.0f;
#pragma unroll 8
        for (int k = 0; k < C; ++k) a += P[g][k] * Vs[k * (DH + 4) + d];
        acc[j] = acc[j] * a_s[g] + a;
      }
    }
  }
  __syncthreads();
  __nv_bfloat16* ob = out + ((int64_t)b * H + hk * G) * DH;
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    int i = threadIdx.x + j * NT;
    if (i < G * DH)
      ob[i] = __float2bfloat16(acc[j] / fmaxf(l_s[i / DH], 1e-9f));
  }
}

// ---------------------------------------------------------------- K3 --
template <int DH>
constexpr int prefill_smem_bytes() {
  return (ROWS * (DH + 4) + 2 * C * (DH + 4) + ROWS * (C + 1) + 3 * ROWS +
          2 * C) * 4;
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) prefill_kernel(
    const __nv_bfloat16* __restrict__ q, Cache c,
    const int* __restrict__ starts, const int* __restrict__ ctx_lens,
    __nv_bfloat16* __restrict__ out, int T_len, int H, int window,
    float scale) {
  constexpr int DPT = DH / 8;  // output dims per thread in P @ V
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;                            // [ROWS][DH + 4]
  float* Ks = Qs + ROWS * (DH + 4);          // [C][DH + 4]
  float* Vs = Ks + C * (DH + 4);             // [C][DH + 4]
  float* S = Vs + C * (DH + 4);              // [ROWS][C + 1]
  float* m_s = S + ROWS * (C + 1);
  float* l_s = m_s + ROWS;
  float* a_s = l_s + ROWS;
  float* kss = a_s + ROWS;
  float* vss = kss + C;

  const int b = blockIdx.x, qt = blockIdx.y, hk = blockIdx.z;
  const int G = H / c.Hk;
  const int TQ = ROWS / G;  // query tokens per block
  const int ctx = ctx_lens[b];
  const int start = starts[b];
  const int t0 = qt * TQ;
  const int q_lo = start + t0;
  const int q_hi = min(start + min(t0 + TQ, T_len), ctx);  // exclusive
  const int lo = window > 0 ? max(q_lo - (window - 1), 0) : 0;

  // stage the query rows: row r = (token r / G, head r % G)
  for (int i = threadIdx.x; i < ROWS * (DH / 8); i += NT) {
    int r = i / (DH / 8), col = (i % (DH / 8)) * 8;
    int t = t0 + r / G;
    float f[8];
    if (t < T_len) {
      const __nv_bfloat16* src =
          q + (((int64_t)b * T_len + t) * H + hk * G + r % G) * DH + col;
      to_float<__nv_bfloat16>(*reinterpret_cast<const uint4*>(src), f);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.0f;
    }
    *reinterpret_cast<float4*>(Qs + r * (DH + 4) + col) =
        make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(Qs + r * (DH + 4) + col + 4) =
        make_float4(f[4], f[5], f[6], f[7]);
  }
  if (threadIdx.x < ROWS) {
    m_s[threadIdx.x] = NEG;
    l_s[threadIdx.x] = 0.0f;
  }
  const int rg = threadIdx.x / 8;  // rows rg*4 .. rg*4+3 (scores and P@V)
  const int cg = threadIdx.x % 8;  // keys cg*4 .. (scores), dims cg*DPT ..
  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.0f;

  for (int p0 = (lo / C) * C; p0 < q_hi; p0 += C) {
    __syncthreads();
    stage_chunk<T, DH>(c, b, hk, p0, ctx, Ks, Vs, kss, vss);
    __syncthreads();
    // scores: 4 rows x 4 keys per thread
    float dot[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dot[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (rg * 4 + i) * (DH + 4) + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(Ks + (cg * 4 + j) * (DH + 4) + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dot[i][j] += qa[i].x * kb[j].x + qa[i].y * kb[j].y +
                       qa[i].z * kb[j].z + qa[i].w * kb[j].w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int r = rg * 4 + i;
      int q_pos = q_lo + r / G;
      bool row_live = (t0 + r / G) < T_len && q_pos < ctx;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int k = cg * 4 + j, key = p0 + k;
        bool ok = row_live && key <= q_pos && key < ctx &&
                  (window <= 0 || key > q_pos - window);
        S[r * (C + 1) + k] = ok ? dot[i][j] * scale * kss[k] : NEG;
      }
    }
    __syncthreads();
    if (threadIdx.x < ROWS) {
      int r = threadIdx.x;
      int q_pos = q_lo + r / G;
      bool row_live = (t0 + r / G) < T_len && q_pos < ctx;
      bool ok[C];
#pragma unroll
      for (int k = 0; k < C; ++k) {
        int key = p0 + k;
        ok[k] = row_live && key <= q_pos && key < ctx &&
                (window <= 0 || key > q_pos - window);
      }
      softmax_row(S + r * (C + 1), ok, vss, &m_s[r], &l_s[r], &a_s[r]);
    }
    __syncthreads();
    // P @ V: 4 rows x DPT dims per thread
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float a = a_s[rg * 4 + i];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int k = 0; k < C; ++k) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = S[(rg * 4 + i) * (C + 1) + k];
#pragma unroll
      for (int j = 0; j < DPT; j += 4) {
        float4 v = *reinterpret_cast<const float4*>(Vs + k * (DH + 4) + cg * DPT + j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] += p[i] * v.x;
          acc[i][j + 1] += p[i] * v.y;
          acc[i][j + 2] += p[i] * v.z;
          acc[i][j + 3] += p[i] * v.w;
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r = rg * 4 + i;
    int t = t0 + r / G;
    if (t >= T_len) continue;
    float inv_l = 1.0f / fmaxf(l_s[r], 1e-9f);
    __nv_bfloat16* dst =
        out + (((int64_t)b * T_len + t) * H + hk * G + r % G) * DH + cg * DPT;
#pragma unroll
    for (int j = 0; j < DPT; ++j) dst[j] = __float2bfloat16(acc[i][j] * inv_l);
  }
}

template <typename T, int DH>
int run_prefill(const void* q, const Cache& c, const void* starts,
                const void* ctx, void* out, int B, int T_len, int H,
                int window, float scale, cudaStream_t st) {
  constexpr int bytes = prefill_smem_bytes<DH>();
  cudaFuncSetAttribute(prefill_kernel<T, DH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int TQ = ROWS / (H / c.Hk);
  dim3 grid(B, (T_len + TQ - 1) / TQ, c.Hk);
  prefill_kernel<T, DH><<<grid, NT, bytes, st>>>(
      (const __nv_bfloat16*)q, c, (const int*)starts, (const int*)ctx,
      (__nv_bfloat16*)out, T_len, H, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int run_decode(const void* q, const Cache& c, const void* ctx, void* out,
               int B, int H, int window, float scale, cudaStream_t st) {
  dim3 grid(B, c.Hk);
  decode_kernel<T, DH><<<grid, NT, 0, st>>>(
      (const __nv_bfloat16*)q, c, (const int*)ctx, (__nv_bfloat16*)out, H,
      window, scale);
  return (int)cudaGetLastError();
}

Cache make_cache(const void* k, const void* v, const void* ks, const void* vs,
                 const void* tables, int layer, int Hk, long long S, int NP,
                 int bs, int W) {
  Cache c;
  c.k = k;
  c.v = v;
  c.ks = (const float*)ks;
  c.vs = (const float*)vs;
  c.tables = (const int*)tables;
  c.layer = layer;
  c.Hk = Hk;
  c.S = S;
  c.NP = NP;
  c.bs = bs;
  c.W = W;
  return c;
}

bool group_ok(int H, int Hk, int maxg) {
  if (Hk <= 0 || H % Hk != 0) return false;
  int G = H / Hk;
  return G <= maxg && (G & (G - 1)) == 0;
}

}  // namespace

// q [B, H, Dh] bf16; caches [L, S, Hk, Dh] bf16 (quantized = 0) or int8
// (quantized = 1, scales [L, NP, Hk, bs] f32); tables [B, W] i32; ctx [B]
// i32; out [B, H, Dh] bf16. window <= 0 = none. Dh in {64, 128}, H/Hk a
// power of two <= 8. Returns cudaGetLastError() after the launch.
extern "C" int pa_decode_launch(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs,
                                const void* tables, const void* ctx,
                                void* out, int quantized, int layer, int B,
                                int H, int Hk, int Dh, long long S, int NP,
                                int bs, int W, int window, float scale,
                                void* stream) {
  if (!group_ok(H, Hk, MAXG) || B <= 0) return (int)cudaErrorInvalidValue;
  Cache c = make_cache(k, v, quantized ? ks : nullptr,
                       quantized ? vs : nullptr, tables, layer, Hk, S, NP,
                       bs, W);
  cudaStream_t st = (cudaStream_t)stream;
  if (Dh == 128)
    return quantized ? run_decode<int8_t, 128>(q, c, ctx, out, B, H, window, scale, st)
                     : run_decode<__nv_bfloat16, 128>(q, c, ctx, out, B, H, window, scale, st);
  if (Dh == 64)
    return quantized ? run_decode<int8_t, 64>(q, c, ctx, out, B, H, window, scale, st)
                     : run_decode<__nv_bfloat16, 64>(q, c, ctx, out, B, H, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

// q [B, T, H, Dh] bf16; starts/ctx [B] i32; out [B, T, H, Dh] bf16; the
// rest as pa_decode_launch.
extern "C" int pa_prefill_launch(const void* q, const void* k, const void* v,
                                 const void* ks, const void* vs,
                                 const void* tables, const void* starts,
                                 const void* ctx, void* out, int quantized,
                                 int layer, int B, int T_len, int H, int Hk,
                                 int Dh, long long S, int NP, int bs, int W,
                                 int window, float scale, void* stream) {
  if (!group_ok(H, Hk, MAXG) || B <= 0 || T_len <= 0)
    return (int)cudaErrorInvalidValue;
  Cache c = make_cache(k, v, quantized ? ks : nullptr,
                       quantized ? vs : nullptr, tables, layer, Hk, S, NP,
                       bs, W);
  cudaStream_t st = (cudaStream_t)stream;
  if (Dh == 128)
    return quantized
               ? run_prefill<int8_t, 128>(q, c, starts, ctx, out, B, T_len, H, window, scale, st)
               : run_prefill<__nv_bfloat16, 128>(q, c, starts, ctx, out, B, T_len, H, window, scale, st);
  if (Dh == 64)
    return quantized
               ? run_prefill<int8_t, 64>(q, c, starts, ctx, out, B, T_len, H, window, scale, st)
               : run_prefill<__nv_bfloat16, 64>(q, c, starts, ctx, out, B, T_len, H, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
