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
// K2 design (split-KV flash-decoding on CUDA cores). At G = 4 an int8
// K or V byte takes 2 G = 8 operations, far below the ~20 operations a
// byte at which the card's 67 TFLOP/s f32 rate would bind, so the only
// aim is to move the bytes at full rate: at B=64, contexts 128..4096,
// int8, the 0.0855 ms of the byte bound against ~0.033 ms of f32 FMAs.
// Tensor cores would add fragment layouts and 12 wasted rows of 16 for
// nothing. What the design does about it:
// - The grid is (split, KV head, sequence): each sequence's keys are cut
//   into splits of keys_per_split (ops/paged_attention.py::decode_plan,
//   a function of B, Hk, W and bs only), so a batch of few or long
//   sequences still fills the 132 SMs; a block whose keys lie outside
//   [window start, ctx) returns at once.
// - A block loads its split's block-table entries into shared memory
//   once, then gathers 64-key chunks of raw K/V rows (int8 stays int8)
//   and their scales by cp.async into a 3-stage ring: two chunks are in
//   flight while one computes, with one barrier a chunk. Rows are padded
//   by 16 bytes, so 8 lanes reading 8 rows hit 8 distinct bank groups.
// - Each of the 4 warps owns 16 keys of a chunk and its own online
//   softmax in registers: Q K^T takes two lanes a key (each half of the
//   16-byte pieces, joined by one shuffle), q in shared memory as f32;
//   P V takes one lane per Dh/32 dims of every head. int8 converts by
//   byte permutes and an f32 subtract (i8x4_to_f32), never on the
//   quarter-rate conversion unit, which alone would cost ~0.066 ms.
// - The block merges its warps' (m, l, acc) and writes the split's
//   partial in f32; a second kernel, one block per (KV head, sequence),
//   merges the live splits in split order. No atomics: every call gives
//   the same bits.

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

constexpr int MAXG = 8;   // largest GQA group the kernels take
constexpr float NEG = -1e30f;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 4-byte global -> shared copy; with live false the destination is
// zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   sm90::smem_addr(dst)),
               "l"(src), "r"(live ? 4 : 0));
}

__device__ __forceinline__ float ex2(float x) {  // 2^x
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// ---------------------------------------------------------------- K2 --
namespace k2 {

using namespace sm90;

constexpr int NT = 128;     // threads per block (both kernels)
constexpr int KC = 64;      // keys per chunk (ops/paged_attention.py: DECODE_CHUNK)
constexpr int KW = KC / 4;  // keys of a chunk per warp
constexpr int STAGES = 3;   // chunks in the cp.async ring
constexpr int TBL = 256;    // block-table entries a split holds (_DECODE_TABLE)

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 int8 in one word -> 4 f32, exactly, by the byte-permute route of
// sm90::i8x4_to_bf16: each byte, biased to unsigned, becomes the low
// mantissa bits of 2^23, and the bias is subtracted in f32.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
  constexpr uint32_t MAGIC = 0x4b000000u;  // 2^23
  constexpr float BIAS = 8388736.0f;       // 2^23 + 128
  w ^= 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(w, MAGIC, 0x7540 | i)) - BIAS;
}

// 2 bf16 in one word -> 2 f32 (exact: a shift)
__device__ __forceinline__ void bf16x2_to_f32(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

// one 16-byte piece of a cache row -> its 16 / sizeof(T) values in f32
template <typename T>
__device__ __forceinline__ void piece_to_f32(const uint4& u, float* f) {
  if constexpr (sizeof(T) == 1) {
    i8x4_to_f32(u.x, f);
    i8x4_to_f32(u.y, f + 4);
    i8x4_to_f32(u.z, f + 8);
    i8x4_to_f32(u.w, f + 12);
  } else {
    bf16x2_to_f32(u.x, f);
    bf16x2_to_f32(u.y, f + 2);
    bf16x2_to_f32(u.z, f + 4);
    bf16x2_to_f32(u.w, f + 6);
  }
}

// dims [lane * N, lane * N + N) of a staged cache row, in f32
template <typename T, int N>
__device__ __forceinline__ void dims_to_f32(const unsigned char* row, int lane,
                                            float* f) {
  const unsigned char* at = row + lane * N * (int)sizeof(T);
  if constexpr (sizeof(T) == 1) {
    float t[4];
    i8x4_to_f32(N == 4 ? *reinterpret_cast<const uint32_t*>(at)
                       : (uint32_t)*reinterpret_cast<const uint16_t*>(at), t);
#pragma unroll
    for (int e = 0; e < N; ++e) f[e] = t[e];
  } else if constexpr (N == 4) {
    uint2 u = *reinterpret_cast<const uint2*>(at);
    bf16x2_to_f32(u.x, f);
    bf16x2_to_f32(u.y, f + 2);
  } else {
    bf16x2_to_f32(*reinterpret_cast<const uint32_t*>(at), f);
  }
}

// The keys [x, y) that sequence b attends to: inside its window, before
// its context length and inside its block table. Both kernels derive a
// split's liveness from it, so they agree on which partials exist.
__device__ __forceinline__ int2 live_keys(const int* ctx_lens, int b,
                                          int window, int max_keys) {
  const int ctx = ctx_lens[b];
  return make_int2(window > 0 ? max(ctx - window, 0) : 0, min(ctx, max_keys));
}

// Shared memory of a split block, in this order: the ring, STAGES x
// (K, V [KC][RST] raw rows, scales [K, V][KC] f32); q [G][DH] f32; the
// rounded probabilities [4 warps][KW][G] f32; the split's block-table
// entries. After the loop the ring holds the warps' (acc, m, l).
template <typename T, int DH, int G>
struct Smem {
  static constexpr int RST = DH * (int)sizeof(T) + 16;  // bytes a staged row
  static constexpr int KV_BYTES = KC * RST;
  static constexpr int STAGE = 2 * KV_BYTES + 2 * KC * 4;
  static constexpr int Q_OFF = STAGES * STAGE;
  static constexpr int P_OFF = Q_OFF + G * DH * 4;
  static constexpr int T_OFF = P_OFF + 4 * KW * G * 4;
  static constexpr int BYTES = T_OFF + TBL * 4;
  static_assert(4 * G * DH * 4 + 2 * 4 * G * 4 <= Q_OFF, "warp merge fits the ring");
  static_assert(STAGE % 16 == 0 && RST % 16 == 0, "16-byte copies");
};

// One block per (split, KV head, sequence): the split's live keys
// against the G query heads of the KV head. Writes the split's partial
// per head, m in log2 units: acc [DH] at ws[row * DH], (m, l) at
// ws[n_rows * DH + 2 row], row = (b * H + h) * n_splits + split.
template <typename T, int DH, int G>
__global__ void __launch_bounds__(NT) split_kernel(
    const __nv_bfloat16* __restrict__ q, Cache c,
    const int* __restrict__ ctx_lens, float* __restrict__ ws, int H,
    int window, float scale_log2, int kps) {
  using SM = Smem<T, DH, G>;
  constexpr int VEC = 16 / sizeof(T);    // values a 16-byte piece
  constexpr int PER_ROW = DH / VEC;      // pieces a row
  constexpr int STEP = NT / PER_ROW;     // rows a pass of the block copies
  constexpr int DPL = DH / 32;           // P V: dims a lane
  static_assert(PER_ROW % 2 == 0 && KC % STEP == 0, "copy tiling");
  extern __shared__ __align__(128) unsigned char sm[];
  float* qs = reinterpret_cast<float*>(sm + SM::Q_OFF);
  float* ps = reinterpret_cast<float*>(sm + SM::P_OFF);
  int* tbl = reinterpret_cast<int*>(sm + SM::T_OFF);

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int2 live = live_keys(ctx_lens, b, window, c.W * c.bs);
  const int s0 = split * kps;
  const int a = max(live.x, s0), e = min(live.y, s0 + kps);
  if (a >= e) return;  // nothing of this split is attended: no partial
  const int c0 = s0 + (a - s0) / KC * KC;  // first chunk
  const int n_chunks = (e - c0 + KC - 1) / KC;
  const int bs_shift = (c.bs & (c.bs - 1)) == 0 ? __ffs(c.bs) - 1 : -1;
  auto page_of = [&](int p) { return bs_shift >= 0 ? p >> bs_shift : p / c.bs; };
  const int page0 = page_of(c0);

  // the split's table entries, q as f32, unit scales for a float cache
  const int* table = c.tables + (int64_t)b * c.W;
  for (int i = threadIdx.x; i <= page_of(e - 1) - page0; i += NT)
    tbl[i] = table[page0 + i];
  const __nv_bfloat16* qb = q + ((int64_t)b * H + hk * G) * DH;
  for (int i = threadIdx.x; i < G * DH; i += NT) qs[i] = __bfloat162float(qb[i]);
  if (c.ks == nullptr)
    for (int i = threadIdx.x; i < STAGES * 2 * KC; i += NT)
      reinterpret_cast<float*>(sm + (i / (2 * KC)) * SM::STAGE +
                               2 * SM::KV_BYTES)[i % (2 * KC)] = 1.0f;
  __syncthreads();

  const int kv_slot = c.Hk * DH;  // elements from one slot to the next
  const int64_t kv_base = (int64_t)c.layer * c.S * kv_slot + hk * DH;
  const int sc_page = c.Hk * c.bs;
  const int64_t sc_base = (int64_t)c.layer * c.NP * sc_page + hk * c.bs;
  const T* kc = reinterpret_cast<const T*>(c.k);
  const T* vc = reinterpret_cast<const T*>(c.v);
  // start the copies of chunk j into stage st: rows outside [a, e) are
  // zero-filled and read nothing
  auto start_chunk = [&](int j, int st) {
    unsigned char* kd = sm + st * SM::STAGE;
    unsigned char* vd = kd + SM::KV_BYTES;
    const int p0 = c0 + j * KC;
    const int col = threadIdx.x % PER_ROW;
#pragma unroll
    for (int r = threadIdx.x / PER_ROW; r < KC; r += STEP) {
      const int p = p0 + r;
      const bool on = p >= a && p < e;
      int64_t off = 0;
      if (on) {
        const int pg = page_of(p);
        off = kv_base + ((int64_t)tbl[pg - page0] * c.bs + (p - pg * c.bs)) * kv_slot +
              col * VEC;
      }
      cp_async16(kd + r * SM::RST + col * 16, kc + off, on);
      cp_async16(vd + r * SM::RST + col * 16, vc + off, on);
    }
    if (c.ks != nullptr && threadIdx.x < KC) {
      const int p = p0 + threadIdx.x;
      const bool on = p >= a && p < e;
      int64_t o = 0;
      if (on) {
        const int pg = page_of(p);
        o = sc_base + (int64_t)tbl[pg - page0] * sc_page + (p - pg * c.bs);
      }
      float* sc = reinterpret_cast<float*>(vd + SM::KV_BYTES);
      cp_async4(sc + threadIdx.x, c.ks + o, on);
      cp_async4(sc + KC + threadIdx.x, c.vs + o, on);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) start_chunk(s, s);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kl = lane & (KW - 1);  // Q K^T: this lane's key of the warp's
  const int key = warp * KW + kl;
  const int half = lane / KW;      // ... and its half of the pieces
  float m[G], lsum[G], acc[G][DPL];  // lsum: this lane's part of l
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG;
    lsum[g] = 0.0f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[g][d] = 0.0f;
  }
  float* pw = ps + warp * KW * G;  // this warp's rounded probabilities

  for (int j = 0; j < n_chunks; ++j) {
    cp_async_wait<STAGES - 2>();  // chunk j has landed (this thread's copies)
    __syncthreads();              // ... everyone's; chunk j - 1 is consumed
    if (j + STAGES - 1 < n_chunks) start_chunk(j + STAGES - 1, (j + STAGES - 1) % STAGES);
    cp_async_commit();
    const unsigned char* kst = sm + (j % STAGES) * SM::STAGE;
    const unsigned char* vst = kst + SM::KV_BYTES;
    const float* kss = reinterpret_cast<const float*>(vst + SM::KV_BYTES);

    // scores: q . k over this lane's pieces 2 i + half, then the pair's sum
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < PER_ROW / 2; ++i) {
      const int pc = 2 * i + half;
      float kf[VEC];
      piece_to_f32<T>(*reinterpret_cast<const uint4*>(kst + key * SM::RST + pc * 16), kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int x = 0; x < VEC; x += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + g * DH + pc * VEC + x);
          s[g] = fmaf(qv.x, kf[x], s[g]);
          s[g] = fmaf(qv.y, kf[x + 1], s[g]);
          s[g] = fmaf(qv.z, kf[x + 2], s[g]);
          s[g] = fmaf(qv.w, kf[x + 3], s[g]);
        }
      }
    }
    // online softmax over the warp's 16 keys (log2 units); p * v_scale
    // rounded to bf16, as the Pallas kernel rounds before P V
    const int p = c0 + j * KC + key;
    const bool valid = p >= a && p < e;
    const float ksc = scale_log2 * kss[key];
    const float vsc = kss[KC + key];
    float alpha[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float v = s[g] + __shfl_xor_sync(0xffffffffu, s[g], KW);
      v = valid ? v * ksc : NEG;
      float mx = v;
#pragma unroll
      for (int o = KW / 2; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      alpha[g] = ex2(m[g] - m_new);
      const float pr = valid ? ex2(v - m_new) : 0.0f;
      lsum[g] = lsum[g] * alpha[g] + pr;
      m[g] = m_new;
      s[g] = round_bf16(pr * vsc);
    }
    if (half == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) pw[kl * G + g] = s[g];
    }
    __syncwarp();
    // O = O * alpha + P V over the warp's keys, DPL dims a lane
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[g][d] *= alpha[g];
#pragma unroll 4
    for (int k = 0; k < KW; ++k) {
      float vf[DPL];
      dims_to_f32<T, DPL>(vst + (warp * KW + k) * SM::RST, lane, vf);
      float pk[G];
      if constexpr (G % 4 == 0) {
#pragma unroll
        for (int g = 0; g < G; g += 4) {
          const float4 t = *reinterpret_cast<const float4*>(pw + k * G + g);
          pk[g] = t.x;
          pk[g + 1] = t.y;
          pk[g + 2] = t.z;
          pk[g + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int g = 0; g < G; ++g) pk[g] = pw[k * G + g];
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[g][d] = fmaf(pk[g], vf[d], acc[g][d]);
    }
    __syncwarp();  // pw is rewritten by the next chunk
  }
  cp_async_wait<0>();  // only empty groups remain; none may land later
  __syncthreads();     // every warp is done with the ring

  // the 4 warps' states into the ring, then merged in warp order
  float* wacc = reinterpret_cast<float*>(sm);  // [4][G][DH]
  float* wm = wacc + 4 * G * DH;               // [4][G]
  float* wl = wm + 4 * G;                      // [4][G]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float l = lsum[g];
#pragma unroll
    for (int o = KW / 2; o > 0; o /= 2) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = l;
    }
#pragma unroll
    for (int d = 0; d < DPL; ++d) wacc[(warp * G + g) * DH + lane * DPL + d] = acc[g][d];
  }
  __syncthreads();
  const int64_t n_rows = (int64_t)gridDim.z * H * n_splits;
  for (int i = threadIdx.x; i < G * DH; i += NT) {
    const int g = i / DH, d = i % DH;
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float o = 0.0f, l = 0.0f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {  // a warp that saw no valid key has f = 0
      const float f = ex2(wm[w * G + g] - mx);
      o += wacc[(w * G + g) * DH + d] * f;
      l += wl[w * G + g] * f;
    }
    const int64_t row = ((int64_t)b * H + hk * G + g) * n_splits + split;
    ws[row * DH + d] = o;
    if (d == 0) {
      ws[n_rows * DH + 2 * row] = mx;
      ws[n_rows * DH + 2 * row + 1] = l;
    }
  }
}

// One block per (KV head, sequence): merges the partials of the live
// splits in split order (m = max m_i, each scaled by 2^(m_i - m)), and
// writes out = acc / max(l, 1e-9) in bf16. A sequence with no live
// split (ctx = 0) writes exact zeros.
template <int DH>
__global__ void __launch_bounds__(NT) merge_kernel(
    const float* __restrict__ ws, const int* __restrict__ ctx_lens,
    __nv_bfloat16* __restrict__ out, int H, int G, int window, int max_keys,
    int kps, int n_splits) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const int2 live = live_keys(ctx_lens, b, window, max_keys);
  const int first = live.x < live.y ? live.x / kps : 0;
  const int last = live.x < live.y ? (live.y - 1) / kps : -1;
  const float* ml = ws + (int64_t)gridDim.y * H * n_splits * DH;
  for (int i = threadIdx.x; i < G * DH / 4; i += NT) {
    const int g = i / (DH / 4), d = (i % (DH / 4)) * 4;
    const int64_t r0 = ((int64_t)b * H + hk * G + g) * n_splits;
    float mx = NEG;
    for (int s = first; s <= last; ++s) mx = fmaxf(mx, ml[2 * (r0 + s)]);
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float l = 0.0f;
    for (int s = first; s <= last; ++s) {
      const float f = ex2(ml[2 * (r0 + s)] - mx);
      const float4 x = *reinterpret_cast<const float4*>(ws + (r0 + s) * DH + d);
      o.x += x.x * f;
      o.y += x.y * f;
      o.z += x.z * f;
      o.w += x.w * f;
      l += ml[2 * (r0 + s) + 1] * f;
    }
    const float den = fmaxf(l, 1e-9f);
    __nv_bfloat162 lo = __floats2bfloat162_rn(o.x / den, o.y / den);
    __nv_bfloat162 hi = __floats2bfloat162_rn(o.z / den, o.w / den);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + ((int64_t)b * H + hk * G + g) * DH + d) = u;
  }
}

}  // namespace k2

// ---------------------------------------------------------------- K3 --
namespace k3 {

using namespace sm90;

constexpr int KC = 64;           // keys per chunk
constexpr int NWG = 2;           // warpgroups per block, 64 query rows each
constexpr int PT = 128 * NWG;    // threads per block
constexpr int ROWS = 64 * NWG;   // query rows (tokens x group) per block

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
  static bool prepared = false;  // per instance: set at the first launch only
  if (!prepared) {
    cudaError_t err = cudaFuncSetAttribute(
        k3::prefill_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    prepared = true;
  }
  int TQ = k3::ROWS / (H / c.Hk);
  dim3 grid(c.Hk, B, (T_len + TQ - 1) / TQ);
  k3::prefill_kernel<T, DH><<<grid, k3::PT, bytes, st>>>(
      (const __nv_bfloat16*)q, c, (const int*)starts, (const int*)ctx,
      (__nv_bfloat16*)out, T_len, H, window, scale);
  return (int)cudaGetLastError();
}

// K2: the split kernel, then the merge kernel, on one stream; ws holds
// n_splits = ceil(W bs / kps) partials of (Dh + 2) floats a (b, head).
template <typename T, int DH, int G>
int run_decode(const void* q, const Cache& c, const void* ctx, void* out,
               void* ws, int B, int H, int window, float scale, int kps,
               cudaStream_t st) {
  using SM = k2::Smem<T, DH, G>;
  static bool prepared = false;  // per instance: set at the first launch only
  if (!prepared) {
    cudaError_t err = cudaFuncSetAttribute(
        k2::split_kernel<T, DH, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SM::BYTES);
    if (err != cudaSuccess) return (int)err;
    prepared = true;
  }
  const int max_keys = c.W * c.bs;
  const int n_splits = max((max_keys + kps - 1) / kps, 1);
  k2::split_kernel<T, DH, G><<<dim3(n_splits, c.Hk, B), k2::NT, SM::BYTES, st>>>(
      (const __nv_bfloat16*)q, c, (const int*)ctx, (float*)ws, H, window,
      scale * 1.4426950408889634f, kps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k2::merge_kernel<DH><<<dim3(c.Hk, B), k2::NT, 0, st>>>(
      (const float*)ws, (const int*)ctx, (__nv_bfloat16*)out, H, G, window,
      max_keys, kps, n_splits);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int run_decode_g(const void* q, const Cache& c, const void* ctx, void* out,
                 void* ws, int B, int H, int window, float scale, int kps,
                 cudaStream_t st) {
  switch (H / c.Hk) {
    case 1: return run_decode<T, DH, 1>(q, c, ctx, out, ws, B, H, window, scale, kps, st);
    case 2: return run_decode<T, DH, 2>(q, c, ctx, out, ws, B, H, window, scale, kps, st);
    case 4: return run_decode<T, DH, 4>(q, c, ctx, out, ws, B, H, window, scale, kps, st);
    case 8: return run_decode<T, DH, 8>(q, c, ctx, out, ws, B, H, window, scale, kps, st);
  }
  return (int)cudaErrorInvalidValue;
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
// i32; out [B, H, Dh] bf16; workspace: B H ceil(W bs / keys_per_split)
// (Dh + 2) f32. window <= 0 = none. Dh in {64, 128}, H/Hk a power of two
// <= 8, keys_per_split a multiple of the 64-key chunk whose keys span at
// most 256 table entries. Returns the first cudaGetLastError() that is
// not cudaSuccess, after the two launches.
extern "C" int pa_decode_launch(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs,
                                const void* tables, const void* ctx,
                                void* out, void* workspace, int quantized,
                                int layer, int B, int H, int Hk, int Dh,
                                long long S, int NP, int bs, int W,
                                int window, float scale, int keys_per_split,
                                void* stream) {
  if (!group_ok(H, Hk, MAXG) || B <= 0 || bs <= 0 || keys_per_split <= 0 ||
      keys_per_split % k2::KC != 0 || (keys_per_split - 1) / bs + 2 > k2::TBL)
    return (int)cudaErrorInvalidValue;
  Cache c = make_cache(k, v, quantized ? ks : nullptr,
                       quantized ? vs : nullptr, tables, layer, Hk, S, NP,
                       bs, W);
  cudaStream_t st = (cudaStream_t)stream;
  const int kps = keys_per_split;
  if (Dh == 128)
    return quantized
               ? run_decode_g<int8_t, 128>(q, c, ctx, out, workspace, B, H, window, scale, kps, st)
               : run_decode_g<__nv_bfloat16, 128>(q, c, ctx, out, workspace, B, H, window, scale, kps, st);
  if (Dh == 64)
    return quantized
               ? run_decode_g<int8_t, 64>(q, c, ctx, out, workspace, B, H, window, scale, kps, st)
               : run_decode_g<__nv_bfloat16, 64>(q, c, ctx, out, workspace, B, H, window, scale, kps, st);
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
