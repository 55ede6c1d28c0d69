// K2 and K3: paged attention over a stacked KV cache, for Hopper (sm_90a).
//
// K2 replaces dynamo_tpu/ops/paged_attention.py::
// paged_attention_decode_stacked (body _decode_kernel_stacked): one query
// token per sequence against layer `layer` of the stacked paged cache.
// K3 replaces dynamo_tpu/ops/paged_attention.py::
// paged_attention_prefill_stacked (body _prefill_kernel_stacked): causal
// flash attention for a chunk of T queries at positions start[b] + t,
// whose own K/V are already in the cache. Both honour an optional sliding
// window and an int8 cache with per-(slot, head) f32 scales
// [L, N, Hk, bs]: the K scale multiplies the f32 scores per key, the V
// scale folds into the probabilities, which are then rounded to bf16
// before P @ V, as the Pallas kernels do. Online softmax in f32; the
// running sum is floored at 1e-9, so rows with no valid key (padded rows,
// ctx = 0) write exact zeros.
//
// What bounds them on an H100: decode reads every live K/V byte once and
// does 4 operations per cached element, so it is bound by memory. A
// 1024-token prefill chunk does ~T/2 times more work per byte and is
// bound by arithmetic: at B=2, T=1024, start 1024 (ctx 2048), H=32,
// Hk=8, Dh=128 it does 52 GFLOP of Q K^T and P V, 0.052 ms at the
// card's 989 TFLOP/s bf16 tensor rate, against 0.013 ms to move its
// bytes at 3.35 TB/s.
//
// Both kernels never slice the cache: they compute the layer's offset
// themselves (64-bit) and read the block table and context length of
// their sequence, gathering keys by position through the block table
// with 16-byte copies, so page sizes 16 and 128 are the same code. The
// G = H/Hk query heads of a GQA group share each K/V load.
//
// K2 design: one block per (sequence, KV head) stages 32 keys at a time,
// converted to f32 in shared memory (int8 and bf16 values are exact in
// f32), and runs f32 FMAs; no split over pages (flash-decoding) yet.
//
// K3 design (arithmetic-bound, so the work goes to the tensor cores):
// one block of two warpgroups per (KV head, sequence, 128-row query
// tile), row r = (token r / G, head r % G); each warpgroup owns 64 rows.
// S = Q K^T and O += P V run as wgmma (bf16, f32 accumulation): Q and
// each K chunk are read by the tensor cores straight from shared memory,
// P from registers, V from shared memory as a transposed operand. Not
// mma.sync: there each warp loads its own operand fragments (ldmatrix)
// and, at the 32 rows a warp that keeps those loads below the MMA rate,
// has no registers left to hide their latency; wgmma reads its operands
// itself and needs half the registers per row, so two blocks fit on an
// SM and one block's softmax overlaps the other's MMAs. Keys come in
// chunks of 64: each chunk's K/V rows (and int8 scales) are gathered by
// cp.async into a double-buffered ring, so chunk j + 1 is in flight
// while chunk j computes; an int8 chunk is converted once into a bf16
// tile (exact, by byte permutes and an f32 add rather than the
// quarter-rate conversion unit), a bf16 chunk is read where it lands.
// The online softmax stays
// in registers: row max and sum over the 4 lanes that share a row, and
// the score fragments, times the V scale and rounded to bf16, are P's
// operand fragments without a trip through shared memory. The causal /
// context / window mask is evaluated only on chunks that cross an edge,
// and a tile visits only the chunks it may see. Tiles that carry the
// most keys are launched first. TMA is not used: Hopper's TMA cannot
// gather rows through a block table.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int NT = 128;   // threads per block
constexpr int C = 32;     // keys staged per step
constexpr int MAXG = 8;   // largest GQA group the decode kernel takes
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
namespace k3 {

using namespace sm90;

constexpr int KC = 64;           // keys per chunk
constexpr int NWG = 2;           // warpgroups per block, 64 query rows each
constexpr int PT = 128 * NWG;    // threads per block
constexpr int ROWS = 64 * NWG;   // query rows (tokens x group) per block

// 4-byte global -> shared copy; with live false the destination is
// zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 4 : 0));
}

__device__ __forceinline__ float ex2(float x) {  // 2^x
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

#define K3_R8(a) "+f"(a[0]), "+f"(a[1]), "+f"(a[2]), "+f"(a[3]), \
                 "+f"(a[4]), "+f"(a[5]), "+f"(a[6]), "+f"(a[7])

// d (+)= A B^T, 64 x 64 x 16: A (query rows) and B (keys) both K-major in
// shared memory; acc = 0 overwrites d
__device__ __forceinline__ void wg_qk(float (&d)[32], uint64_t da,
                                      uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : K3_R8((d + 0)), K3_R8((d + 8)), K3_R8((d + 16)), K3_R8((d + 24))
      : "l"(da), "l"(db), "r"(acc));
}

// d += A B, 64 x N x 16: A (probabilities) in registers, B (values, rows
// = keys) MN-major in shared memory
__device__ __forceinline__ void wg_pv(float (&d)[32], const uint32_t (&a)[4],
                                      uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : K3_R8((d + 0)), K3_R8((d + 8)), K3_R8((d + 16)), K3_R8((d + 24))
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wg_pv(float (&d)[64], const uint32_t (&a)[4],
                                      uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, 1, 1, "
      "1, 1;\n"
      : K3_R8((d + 0)), K3_R8((d + 8)), K3_R8((d + 16)), K3_R8((d + 24)),
        K3_R8((d + 32)), K3_R8((d + 40)), K3_R8((d + 48)), K3_R8((d + 56))
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

#undef K3_R8

// Shared memory of one block, in this order: Q [ROWS][DH] bf16 as core
// matrices; the ring of copies, two stages of K and V (a bf16 chunk as
// core matrices, an int8 chunk as [KC][DH + 16] rows), and their scales
// [2][K, V][KC] f32 (ones for a float cache); for an int8 cache the
// converted chunk, K and V [KC][DH] bf16 as core matrices.
template <typename T, int DH>
struct Layout {
  static constexpr bool CONVERT = sizeof(T) == 1;
  static constexpr int RST = DH + 16;  // bytes per staged int8 row
  static constexpr int Q_BYTES = ROWS * DH * 2;
  static constexpr int TILE_BYTES = KC * DH * 2;  // bf16 K or V chunk
  static constexpr int STAGE_BYTES = CONVERT ? KC * RST : TILE_BYTES;
  static constexpr int SCALE_OFF = Q_BYTES + 4 * STAGE_BYTES;
  static constexpr int TILE_OFF = SCALE_OFF + 4 * KC * 4;
  static constexpr int BYTES = TILE_OFF + (CONVERT ? 2 * TILE_BYTES : 0);
};

// Where a block reads its sequence's keys: so that a chunk costs one
// table load and a few integer operations per key row.
struct Gather {
  const int* table;  // the sequence's block table
  int64_t kv_base;   // element offset of (layer, slot 0, hk, 0)
  int64_t sc_base;   // offset of (layer, page 0, hk, 0) in the scales
  int kv_slot;       // elements from one slot to the next: Hk * DH
  int sc_page;       // scale elements from one page to the next: Hk * bs
  int bs, bs_shift;  // page size, and its log2 (-1: not a power of two)

  __device__ __forceinline__ int page_of(int p) const {
    return bs_shift >= 0 ? p >> bs_shift : p / bs;
  }
};

// Start the copies of keys [p0, p0 + KC) into one stage: rows at or past
// pend are zero-filled and read nothing. Each thread copies one 16-byte
// column of every STEP-th row; its table entries are loaded first.
template <typename T, int DH>
__device__ __forceinline__ void issue_chunk(const Cache& c, const Gather& g,
                                            int p0, int pend, T* Ks, T* Vs,
                                            float* kss, float* vss) {
  using LY = Layout<T, DH>;
  constexpr int VEC = 16 / sizeof(T);    // elements per copy
  constexpr int PER_ROW = DH / VEC;      // copies per key row
  constexpr int STEP = PT / PER_ROW;     // rows per pass of the block
  static_assert(PT % PER_ROW == 0 && KC % STEP == 0 && KC <= PT, "copy tiling");
  const T* kc = reinterpret_cast<const T*>(c.k);
  const T* vc = reinterpret_cast<const T*>(c.v);
  const int col = (threadIdx.x % PER_ROW) * VEC;
  const int row0 = threadIdx.x / PER_ROW;
  int page[KC / STEP];
#pragma unroll
  for (int k = 0; k < KC / STEP; ++k) {
    int p = p0 + row0 + k * STEP;
    page[k] = p < pend ? __ldg(g.table + g.page_of(p)) : 0;
  }
#pragma unroll
  for (int k = 0; k < KC / STEP; ++k) {
    int row = row0 + k * STEP, p = p0 + row;
    bool live = p < pend;
    int64_t slot = (int64_t)page[k] * g.bs + (p - g.page_of(p) * g.bs);
    int64_t off = live ? g.kv_base + slot * g.kv_slot + col : 0;
    int at = LY::CONVERT ? row * LY::RST + col : core_off<DH>(row, col);
    cp_async16(Ks + at, kc + off, live);
    cp_async16(Vs + at, vc + off, live);
  }
  if (c.ks != nullptr && threadIdx.x < KC) {
    int p = p0 + threadIdx.x;
    bool live = p < pend;
    int64_t o = 0;
    if (live) {
      int pi = g.page_of(p);
      o = g.sc_base + (int64_t)__ldg(g.table + pi) * g.sc_page + (p - pi * g.bs);
    }
    cp_async4(kss + threadIdx.x, c.ks + o, live);
    cp_async4(vss + threadIdx.x, c.vs + o, live);
  }
}

// A staged int8 chunk, K and V [KC][DH + 16], -> bf16 core matrices
// (exact). Consecutive threads take consecutive rows, so the 16-byte
// reads and writes of 8 threads fall on distinct banks.
template <int DH>
__device__ __forceinline__ void convert_chunk(const int8_t* k, const int8_t* v,
                                              __nv_bfloat16* tk,
                                              __nv_bfloat16* tv) {
  for (int i = threadIdx.x; i < 2 * KC * (DH / 16); i += PT) {
    const int half = i / (KC * (DH / 16));  // 0: K, 1: V
    const int j = i - half * KC * (DH / 16);
    const int row = j % KC, col = (j / KC) * 16;
    uint4 raw = *reinterpret_cast<const uint4*>((half ? v : k) + row * (DH + 16) + col);
    uint4 a, b;
    i8x4_to_bf16(raw.x, a.x, a.y);
    i8x4_to_bf16(raw.y, a.z, a.w);
    i8x4_to_bf16(raw.z, b.x, b.y);
    i8x4_to_bf16(raw.w, b.z, b.w);
    __nv_bfloat16* t = half ? tv : tk;
    *reinterpret_cast<uint4*>(t + core_off<DH>(row, col)) = a;
    *reinterpret_cast<uint4*>(t + core_off<DH>(row, col + 8)) = b;
  }
}

// One chunk's scores times scale * log2(e) * k_scale; with MASK, keys a
// row may not see become NEG. cmax: each row's max over this lane's keys.
// s[4 n + e]: key 8 n + 2 cq + (e & 1) of row i = e >> 1.
template <bool MASK>
__device__ __forceinline__ void scale_scores(
    float (&s)[32], const float* kss, float scale_log2, int cq, int p0,
    const int (&q_pos)[2], const bool (&row_live)[2], int ctx, int window,
    float (&cmax)[2]) {
  cmax[0] = cmax[1] = NEG;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kl = n * 8 + 2 * cq + h, key = p0 + kl;
      const float ksc = scale_log2 * kss[kl];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v = s[4 * n + 2 * i + h] * ksc;
        if (MASK && !(row_live[i] && key <= q_pos[i] && key < ctx &&
                      (window <= 0 || key > q_pos[i] - window)))
          v = NEG;
        s[4 * n + 2 * i + h] = v;
        cmax[i] = fmaxf(cmax[i], v);
      }
    }
  }
}

// Two blocks per SM (registers capped at 128): while one block's
// warpgroups run their softmax, the other's keep the tensor cores busy.
template <typename T, int DH>
__global__ void __launch_bounds__(PT, 2) prefill_kernel(
    const __nv_bfloat16* __restrict__ q, Cache c,
    const int* __restrict__ starts, const int* __restrict__ ctx_lens,
    __nv_bfloat16* __restrict__ out, int T_len, int H, int window,
    float scale) {
  using LY = Layout<T, DH>;
  extern __shared__ __align__(128) unsigned char sm[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(sm);
  auto stage_k = [&](int s) {
    return reinterpret_cast<T*>(sm + LY::Q_BYTES + 2 * s * LY::STAGE_BYTES);
  };
  auto stage_v = [&](int s) {
    return reinterpret_cast<T*>(sm + LY::Q_BYTES + (2 * s + 1) * LY::STAGE_BYTES);
  };
  float* scales = reinterpret_cast<float*>(sm + LY::SCALE_OFF);  // [2][K, V][KC]
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(sm + LY::TILE_OFF);

  const int hk = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // most keys first
  const int G = H / c.Hk;
  const int TQ = ROWS / G;  // query tokens per block
  const int ctx = ctx_lens[b];
  const int start = starts[b];
  const int t0 = qt * TQ;
  const int q_lo = start + t0;
  const int q_last = q_lo + TQ - 1;
  const int q_hi = min(start + min(t0 + TQ, T_len), ctx);  // exclusive
  const int lo = window > 0 ? max(q_lo - (window - 1), 0) : 0;
  const int p_begin = (lo / KC) * KC;
  const int n_chunks = q_hi > q_lo ? (q_hi - p_begin + KC - 1) / KC : 0;
  const bool tile_full = t0 + TQ <= T_len && q_last < ctx;
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = 2^(x log2 e)
  Gather gt;
  gt.table = c.tables + (int64_t)b * c.W;
  gt.kv_slot = c.Hk * DH;
  gt.kv_base = (int64_t)c.layer * c.S * gt.kv_slot + hk * DH;
  gt.sc_page = c.Hk * c.bs;
  gt.sc_base = (int64_t)c.layer * c.NP * gt.sc_page + hk * c.bs;
  gt.bs = c.bs;
  gt.bs_shift = (c.bs & (c.bs - 1)) == 0 ? __ffs(c.bs) - 1 : -1;

  // the query rows (zeros past T), then the first chunk
  for (int i = threadIdx.x; i < ROWS * (DH / 8); i += PT) {
    int r = i / (DH / 8), col = (i % (DH / 8)) * 8;
    int t = t0 + r / G;
    bool live = t < T_len;
    const __nv_bfloat16* src =
        live ? q + (((int64_t)b * T_len + t) * H + hk * G + r % G) * DH + col
             : q;
    cp_async16(Qs + core_off<DH>(r, col), src, live);
  }
  if (c.ks == nullptr)
    for (int i = threadIdx.x; i < 4 * KC; i += PT) scales[i] = 1.0f;
  if (n_chunks > 0)
    issue_chunk<T, DH>(c, gt, p_begin, q_hi, stage_k(0), stage_v(0), scales,
                       scales + KC);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, cq = lane % 4;
  // this thread's rows: 16 warp + g + 8 i (warpgroup warp / 4 owns 64)
  int q_pos[2];
  bool row_live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int r = warp * 16 + g + 8 * i;
    q_pos[i] = q_lo + r / G;
    row_live[i] = t0 + r / G < T_len && q_pos[i] < ctx;
  }
  // O: 8-wide output tiles n, o[4 n + e] at row i = e >> 1, column
  // 8 n + 2 cq + (e & 1)
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};  // l: this lane's part
  const __nv_bfloat16* q_wg = Qs + core_off<DH>(64 * (warp / 4), 0);

  // One barrier per chunk (two for int8): at chunk j the copies of
  // j + 1 are in flight; an int8 chunk is converted into bf16 first.
  for (int j = 0; j < n_chunks; ++j) {
    const int st = j & 1;
    const int p0 = p_begin + j * KC;
    cp_async_wait_all();  // chunk j (and Q) has landed
    fence_to_async();
    __syncthreads();      // ... for every thread; chunk j - 1 is done
    if (j + 1 < n_chunks)
      issue_chunk<T, DH>(c, gt, p0 + KC, q_hi, stage_k(st ^ 1),
                         stage_v(st ^ 1), scales + (st ^ 1) * 2 * KC,
                         scales + (st ^ 1) * 2 * KC + KC);
    cp_async_commit();
    const __nv_bfloat16* Kt;
    const __nv_bfloat16* Vt;
    if constexpr (LY::CONVERT) {
      convert_chunk<DH>(reinterpret_cast<const int8_t*>(stage_k(st)),
                        reinterpret_cast<const int8_t*>(stage_v(st)), tiles,
                        tiles + KC * DH);
      fence_to_async();
      __syncthreads();
      Kt = tiles;
      Vt = tiles + KC * DH;
    } else {
      Kt = reinterpret_cast<const __nv_bfloat16*>(stage_k(st));
      Vt = reinterpret_cast<const __nv_bfloat16*>(stage_v(st));
    }
    const float* kss = scales + st * 2 * KC;
    const float* vss = kss + KC;

    // S = Q K^T on the tensor cores, 16 dims a step
    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wg_qk(s, wg_desc(q_wg + kk * 128, 128, DH * 16),
            wg_desc(Kt + kk * 128, 128, DH * 16), kk);
    wg_commit_and_wait();

    // scale (log2 units), mask (only on chunks that cross an edge), row max
    float cmax[2];
    if (tile_full && p0 + KC - 1 <= q_lo && (window <= 0 || p0 > q_last - window))
      scale_scores<false>(s, kss, scale_log2, cq, p0, q_pos, row_live, ctx, window, cmax);
    else
      scale_scores<true>(s, kss, scale_log2, cq, p0, q_pos, row_live, ctx, window, cmax);
    // a row that has seen no valid key keeps m = NEG and takes its
    // exponents against 0, so its NEG scores give p = 0 exactly
    float alpha[2], base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      cmax[i] = fmaxf(cmax[i], __shfl_xor_sync(0xffffffffu, cmax[i], 1));
      cmax[i] = fmaxf(cmax[i], __shfl_xor_sync(0xffffffffu, cmax[i], 2));
      float m_new = fmaxf(m[i], cmax[i]);
      base[i] = m_new == NEG ? 0.0f : m_new;
      alpha[i] = ex2(m[i] - base[i]);
      m[i] = m_new;
    }

    // p = 2^(s - m); l sums p, P V takes bf16(p * v_scale), packed from
    // the score layout straight into A fragments
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(s[4 * n + e] - base[e >> 1]);
        rs[e >> 1] += p;
        s[4 * n + e] = p * vss[n * 8 + 2 * cq + (e & 1)];
      }
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
    if (alpha[0] != 1.0f || alpha[1] != 1.0f) {  // a row max moved
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        o[4 * n + 0] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }
    }

    // O += P V on the tensor cores, 16 keys a step
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg_pv(o, pa[kk], wg_desc(Vt + kk * 2 * (DH / 8) * 64, DH * 16, 128));
    wg_commit_and_wait();
  }
  cp_async_wait_all();  // no copy may land after the block exits

  // O / l; a row with no valid key has O = 0 and l = 0: exact zeros
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int r = warp * 16 + g + 8 * i;
    int t = t0 + r / G;
    if (t >= T_len) continue;
    float inv_l = 1.0f / fmaxf(l[i], 1e-9f);
    __nv_bfloat16* dst =
        out + (((int64_t)b * T_len + t) * H + hk * G + r % G) * DH + 2 * cq;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = __floats2bfloat162_rn(
          o[4 * n + 2 * i] * inv_l, o[4 * n + 2 * i + 1] * inv_l);
  }
}

}  // namespace k3

template <typename T, int DH>
int run_prefill(const void* q, const Cache& c, const void* starts,
                const void* ctx, void* out, int B, int T_len, int H,
                int window, float scale, cudaStream_t st) {
  constexpr int bytes = k3::Layout<T, DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      k3::prefill_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  int TQ = k3::ROWS / (H / c.Hk);
  dim3 grid(c.Hk, B, (T_len + TQ - 1) / TQ);
  k3::prefill_kernel<T, DH><<<grid, k3::PT, bytes, st>>>(
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
