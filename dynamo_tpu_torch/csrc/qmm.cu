// K1: W8A16 matmul with three epilogues, for Hopper (sm_90a).
//
// Replaces the Pallas kernel dynamo_tpu/ops/qmatmul.py::_qmm_call
// (body _qmm_kernel), reached by qmm (plain and residual), qmm_gate_up and
// qmm_lm_head:
//   none:     y = bf16((x @ W) * s)
//   residual: y = bf16(r + bf16((x @ W) * s))
//   gate_up:  y = bf16(bf16(act(bf16(x@Wg*sg))) * bf16(x@Wu*su))
// x [M, K] bf16, W [K, N] int8, s [N] f32, f32 accumulation. Rounding
// points are those of the reference epilogue (qmatmul.py:361-369).
//
// What bounds it on an H100: at decode (M <= 64) the int8 weight read,
// 1 byte per weight, far below the card's 295 bf16 operations per byte;
// at prefill (M ~ 1024) the bf16 tensor-core rate.
//
// Design: a 128-thread block owns a 64x64 output tile and loops over K in
// 64-deep steps. The int8 tile is read with 16-byte loads, upcast to bf16
// (exact: |w| <= 127) into shared memory, and fed with the bf16 x tile to
// the tensor cores through WMMA 16x16x16 with f32 accumulators; the next
// step's global loads are issued before the current step's products, so
// the weight stream overlaps the math. The scale applies to the f32
// accumulator in the epilogue. When the output tiles alone cannot fill the
// card (decode: few tiles along N), K is split across blocks
// (grid.z): each split writes its f32 partial sums, and a second kernel
// adds them in split order (deterministic) and runs the epilogue. Ragged
// M, N and K edges are masked in the loads and the epilogue. Simple
// first: no TMA, no wgmma, one stage of register prefetch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 64, NT = 128;
constexpr int XS_LD = BK + 8;  // bf16 elements per shared row of the x tile
constexpr int WS_LD = BN + 8;  // bf16 elements per shared row of a W tile
constexpr int CS_LD = BN + 4;  // floats per shared row of the output tile

constexpr int EPI_NONE = 0, EPI_RESIDUAL = 1, EPI_GATE_UP = 2;
constexpr int ACT_SILU = 0, ACT_GELU = 1;

constexpr int OPERAND_BYTES = (BM * XS_LD + 2 * BK * WS_LD) * 2;
constexpr int STAGE_BYTES = 2 * BM * CS_LD * 4;
constexpr int SMEM_BYTES =
    OPERAND_BYTES > STAGE_BYTES ? OPERAND_BYTES : STAGE_BYTES;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float act_fn(float g, int act) {
  if (act == ACT_GELU) {
    float inner = 0.7978845608028654f * (g + 0.044715f * g * g * g);
    return 0.5f * g * (1.0f + tanhf(inner));
  }
  return g / (1.0f + expf(-g));
}

template <int EPI>
__device__ __forceinline__ __nv_bfloat16 epilogue(
    float a, float a2, int64_t m, int n, int N, const float* __restrict__ s,
    const float* __restrict__ s2, const __nv_bfloat16* __restrict__ r,
    int act) {
  if (EPI == EPI_GATE_UP) {
    float g = round_bf16(a * s[n]);
    float u = round_bf16(a2 * s2[n]);
    float h = round_bf16(act_fn(g, act));
    return __float2bfloat16(h * u);
  }
  __nv_bfloat16 y = __float2bfloat16(a * s[n]);
  if (EPI == EPI_RESIDUAL) {
    return __float2bfloat16(__bfloat162float(r[m * N + n]) +
                            __bfloat162float(y));
  }
  return y;
}

// x tile: BM x BK bf16 = 512 vectors of 8 values, 4 per thread.
__device__ __forceinline__ void load_x(
    uint4 (&xr)[4], const __nv_bfloat16* __restrict__ x, int M, int K,
    int m0, int k0, int kend, bool vec) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int i = threadIdx.x + j * NT;
    int row = i / (BK / 8), col = (i % (BK / 8)) * 8;
    int gm = m0 + row, gk = k0 + col;
    if (gm < M && vec && gk + 8 <= kend) {
      xr[j] = *reinterpret_cast<const uint4*>(x + (int64_t)gm * K + gk);
    } else {
      union { uint4 u; __nv_bfloat16 h[8]; } t;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        t.h[e] = (gm < M && gk + e < kend) ? x[(int64_t)gm * K + gk + e]
                                           : __float2bfloat16(0.0f);
      xr[j] = t.u;
    }
  }
}

// W tile: BK x BN int8 = 256 vectors of 16 values, 2 per thread.
__device__ __forceinline__ void load_w(
    uint4 (&wr)[2], const int8_t* __restrict__ w, int N, int n0, int k0,
    int kend, bool vec) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    int i = threadIdx.x + j * NT;
    int row = i / (BN / 16), col = (i % (BN / 16)) * 16;
    int gk = k0 + row, gn = n0 + col;
    if (gk < kend && vec && gn + 16 <= N) {
      wr[j] = *reinterpret_cast<const uint4*>(w + (int64_t)gk * N + gn);
    } else {
      union { uint4 u; int8_t b[16]; } t;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        t.b[e] = (gk < kend && gn + e < N) ? w[(int64_t)gk * N + gn + e] : 0;
      wr[j] = t.u;
    }
  }
}

__device__ __forceinline__ void store_x(const uint4 (&xr)[4],
                                        __nv_bfloat16* xs) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int i = threadIdx.x + j * NT;
    int row = i / (BK / 8), col = (i % (BK / 8)) * 8;
    *reinterpret_cast<uint4*>(xs + row * XS_LD + col) = xr[j];
  }
}

__device__ __forceinline__ void store_w(const uint4 (&wr)[2],
                                        __nv_bfloat16* ws) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    int i = threadIdx.x + j * NT;
    int row = i / (BN / 16), col = (i % (BN / 16)) * 16;
    union { uint4 u; int8_t b[16]; } t;
    t.u = wr[j];
    union { uint4 u[2]; __nv_bfloat16 h[16]; } o;
#pragma unroll
    for (int e = 0; e < 16; ++e) o.h[e] = __float2bfloat16((float)t.b[e]);
    uint4* dst = reinterpret_cast<uint4*>(ws + row * WS_LD + col);
    dst[0] = o.u[0];
    dst[1] = o.u[1];
  }
}

template <int EPI>
__global__ void __launch_bounds__(NT) qmm_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ s, const int8_t* __restrict__ w2,
    const float* __restrict__ s2, const __nv_bfloat16* __restrict__ r,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part, int M, int N,
    int K, int kps, int act, bool xvec, bool wvec) {
  constexpr bool TWO = EPI == EPI_GATE_UP;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = xs + BM * XS_LD;
  __nv_bfloat16* ws2 = ws + BK * WS_LD;
  float* cs = reinterpret_cast<float*>(smem);
  float* cs2 = cs + BM * CS_LD;

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * kps;
  const int kend = min(K, kbeg + kps);
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2], acc2[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc[i][j], 0.0f);
      if (TWO) wmma::fill_fragment(acc2[i][j], 0.0f);
    }

  uint4 xr[4], wr[2], wr2[2];
  if (kbeg < kend) {
    load_x(xr, x, M, K, m0, kbeg, kend, xvec);
    load_w(wr, w, N, n0, kbeg, kend, wvec);
    if (TWO) load_w(wr2, w2, N, n0, kbeg, kend, wvec);
  }
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    store_x(xr, xs);
    store_w(wr, ws);
    if (TWO) store_w(wr2, ws2);
    __syncthreads();
    if (k0 + BK < kend) {  // next step's loads fly during this step's math
      load_x(xr, x, M, K, m0, k0 + BK, kend, xvec);
      load_w(wr, w, N, n0, k0 + BK, kend, wvec);
      if (TWO) load_w(wr2, w2, N, n0, k0 + BK, kend, wvec);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs + (wm + i * 16) * XS_LD + kk, XS_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(bf, ws + kk * WS_LD + wn + j * 16, WS_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], bf, acc[i][j]);
        if (TWO) {
          wmma::load_matrix_sync(bf, ws2 + kk * WS_LD + wn + j * 16, WS_LD);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::mma_sync(acc2[i][j], a[i], bf, acc2[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // stage the f32 tile in shared memory (it overlays the operand tiles,
  // which the last __syncthreads above released)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* dst = cs + (wm + i * 16) * CS_LD + wn + j * 16;
      wmma::store_matrix_sync(dst, acc[i][j], CS_LD, wmma::mem_row_major);
      if (TWO) {
        wmma::store_matrix_sync(cs2 + (wm + i * 16) * CS_LD + wn + j * 16,
                                acc2[i][j], CS_LD, wmma::mem_row_major);
      }
    }
  __syncthreads();

  const bool direct = gridDim.z == 1;
  const int64_t plane = (int64_t)M * N;
  for (int i = threadIdx.x; i < BM * BN; i += NT) {
    int row = i / BN, col = i % BN;
    int64_t gm = m0 + row;
    int gn = n0 + col;
    if (gm >= M || gn >= N) continue;
    float a = cs[row * CS_LD + col];
    float a2 = TWO ? cs2[row * CS_LD + col] : 0.0f;
    if (direct) {
      out[gm * N + gn] = epilogue<EPI>(a, a2, gm, gn, N, s, s2, r, act);
    } else {
      int64_t o = blockIdx.z * plane + gm * N + gn;
      part[o] = a;
      if (TWO) part[gridDim.z * plane + o] = a2;
    }
  }
}

// Split-K reduction: partial sums added in split order, then the epilogue.
template <int EPI>
__global__ void qmm_reduce(const float* __restrict__ part, int splits,
                           const float* __restrict__ s,
                           const float* __restrict__ s2,
                           const __nv_bfloat16* __restrict__ r,
                           __nv_bfloat16* __restrict__ out, int M, int N,
                           int act) {
  const int64_t plane = (int64_t)M * N;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  float a = 0.0f, a2 = 0.0f;
  for (int z = 0; z < splits; ++z) {
    a += part[z * plane + i];
    if (EPI == EPI_GATE_UP) a2 += part[(splits + z) * plane + i];
  }
  out[i] = epilogue<EPI>(a, a2, i / N, (int)(i % N), N, s, s2, r, act);
}

template <int EPI>
void launch(const void* x, const void* w, const void* s, const void* w2,
            const void* s2, const void* r, void* out, void* part, int M,
            int N, int K, int act, int splits, int kps, cudaStream_t st) {
  bool xvec = K % 8 == 0 && ((uintptr_t)x % 16) == 0;
  bool wvec = N % 16 == 0 && ((uintptr_t)w % 16) == 0 &&
              ((uintptr_t)(w2 ? w2 : w) % 16) == 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  qmm_kernel<EPI><<<grid, NT, 0, st>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w, (const float*)s,
      (const int8_t*)w2, (const float*)s2, (const __nv_bfloat16*)r,
      (__nv_bfloat16*)out, (float*)part, M, N, K, kps, act, xvec, wvec);
  if (splits > 1) {
    int64_t total = (int64_t)M * N;
    int blocks = (int)((total + 255) / 256);
    qmm_reduce<EPI><<<blocks, 256, 0, st>>>(
        (const float*)part, splits, (const float*)s, (const float*)s2,
        (const __nv_bfloat16*)r, (__nv_bfloat16*)out, M, N, act);
  }
}

}  // namespace

// epi: 0 none, 1 residual, 2 gate_up. act: 0 silu, 1 tanh-gelu.
// part: f32 workspace of splits*M*N floats (twice that for gate_up) when
// splits > 1, else unused. kps: K range per split, a multiple of 64.
// Returns cudaGetLastError() after the launches.
extern "C" int qmm_launch(const void* x, const void* w, const void* s,
                          const void* w2, const void* s2, const void* r,
                          void* out, void* part, int M, int N, int K, int epi,
                          int act, int splits, int kps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || kps % BK != 0)
    return (int)cudaErrorInvalidValue;
  switch (epi) {
    case EPI_NONE:
      launch<EPI_NONE>(x, w, s, w2, s2, r, out, part, M, N, K, act, splits,
                       kps, st);
      break;
    case EPI_RESIDUAL:
      launch<EPI_RESIDUAL>(x, w, s, w2, s2, r, out, part, M, N, K, act,
                           splits, kps, st);
      break;
    case EPI_GATE_UP:
      launch<EPI_GATE_UP>(x, w, s, w2, s2, r, out, part, M, N, K, act,
                          splits, kps, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
