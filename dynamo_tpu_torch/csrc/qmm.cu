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
// at prefill (M ~ 1024) the bf16 tensor-core rate, which only wgmma
// reaches.
//
// Design: one kernel template in two configurations, chosen by M (the
// launch plan in ops/qmatmul.py): prefill, a 128-row tile with two
// consumer warpgroups of 64 rows; decode, a 64-row tile with one (rows
// past M are zeroed once in shared memory and never read). Each block
// has one more warpgroup, the producer, which only copies (setmaxnreg
// moves its registers to the consumers): a ring of STAGES 64-deep steps,
// filled with 16-byte cp.async as soon as a slot is released, x landing
// as wgmma core matrices (operand A, K-major) and the int8 W tile raw;
// the hardware arrives on the slot's mbarrier when a thread's copies
// land, so no copy waits behind another step's work. The consumers
// convert each landed W tile in turn into bf16 core matrices (operand B,
// MN-major) by byte permutes (exact for |w| <= 127), into one of two
// buffers, while the tensor cores still run the previous step, then run
// wgmma.m64nNk16 (N = 256 or 128 at prefill, 128 or 64 at decode;
// gate_up holds two accumulators of half the width) and release the
// step's slot once its products are done. Where the output tiles alone
// cannot fill the card, K is split across the blocks of a thread-block
// cluster: each writes its f32 partial tile into its own shared memory,
// and after a cluster barrier each block sums one slice of the tile over
// the cluster's ranks in rank order (deterministic), through distributed
// shared memory, and runs the epilogue on it; a second barrier keeps the
// partials alive until every block has read them. Without a split the
// epilogue runs straight from the accumulator registers: column pairs
// scaled by a float2 of s, the residual read and the result written as
// bf16x2. Ragged shapes are the same kernel: tails along M, N and K are
// zero-filled by cp.async, and rows that are not 16-byte aligned
// (K % 8 or N % 16 != 0) take synchronous element loads instead.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace sm90;

constexpr int BK = 64;  // K per step
constexpr int EPI_NONE = 0, EPI_RESIDUAL = 1, EPI_GATE_UP = 2;
constexpr int ACT_GELU = 1;  // act: 0 silu, 1 tanh-gelu
// kernel variants: prefill; decode with a 128- or a 64-column staged tile
constexpr int CFG_PREFILL = 0, CFG_DECODE = 1, CFG_DECODE_NARROW = 2;
constexpr int MAX_SPLITS = 16;

template <int CFG, int EPI>
struct Cfg {
  static constexpr bool TWO = EPI == EPI_GATE_UP;
  static constexpr int NWG = CFG == CFG_PREFILL ? 2 : 1;  // consumer warpgroups
  static constexpr int BM = 64 * NWG;
  // W columns staged per step; gate_up stages both weights side by side
  static constexpr int BNS = CFG == CFG_PREFILL ? 256 : CFG == CFG_DECODE ? 128 : 64;
  static constexpr int BN = TWO ? BNS / 2 : BNS;  // output columns per block
  static constexpr int STAGES = CFG == CFG_DECODE_NARROW ? 6 : 4;
  static constexpr int NBF = 2;  // bf16 W buffers
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int THREADS = CONSUMERS + 128;
  static constexpr int MIN_BLOCKS = CFG == CFG_PREFILL ? 1 : 2;
  // per-thread registers after setmaxnreg; they fill the register file
  // that __launch_bounds__(THREADS, MIN_BLOCKS) grants the block
  static constexpr int PRODUCER_REGS = 56;
  static constexpr int CONSUMER_REGS = CFG == CFG_PREFILL ? 224 : 200;
  static constexpr int RAW_LD = BNS + 16;  // bytes per staged int8 row
  static constexpr int X_BYTES = BM * BK * 2;
  static constexpr int RAW_BYTES = BK * RAW_LD;
  static constexpr int WBF_BYTES = BK * BNS * 2;
  static constexpr int RAW_OFF = STAGES * X_BYTES;
  static constexpr int WBF_OFF = RAW_OFF + STAGES * RAW_BYTES;
  static constexpr int BAR_OFF = WBF_OFF + NBF * WBF_BYTES;
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8;
  // split-K partial tiles (f32, rows padded so that the accumulator's
  // float2 writes of a half-warp fall on distinct banks) overlay the ring
  static constexpr int PART_LD = BN + 8;
  static constexpr int PART_TILE = BM * PART_LD;
  static_assert((TWO ? 2 : 1) * PART_TILE * 4 <= BAR_OFF, "partials fit");
  static_assert((PRODUCER_REGS + NWG * CONSUMER_REGS) * 128 * MIN_BLOCKS <= 65536,
                "register budget");
  static_assert(STAGES > NBF && NBF >= 2, "ring");
};

struct Args {
  const __nv_bfloat16* x;
  const int8_t* w;
  const float* s;
  const int8_t* w2;
  const float* s2;
  const __nv_bfloat16* r;
  __nv_bfloat16* out;
  int M, N, K, act, splits;
  int xvec;  // x rows 16-byte aligned: cp.async, else element loads
  int wvec;  // W rows 16-byte aligned
  int ovec;  // out/r rows 4-byte and scales 8-byte aligned: pair access
};

// --- mbarriers, named and cluster barriers, register reallocation ---

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(b)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(b))
               : "memory");
}

// arrive on b once this thread's cp.async copies so far have landed (the
// arrival counts against b's expected count)
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(b)) : "memory");
}

// Wait until the phase of the given parity has completed. A wait of more
// than 2^32 cycles (seconds) can only be a deadlock: trap, so that the
// launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t addr = smem_addr(b);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// --- wgmma: d += A B, 64 x N x 16, A K-major and B MN-major in shared
// memory (descriptors a and b) ---

#define R8(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]), \
                 "+f"(a[i + 4]), "+f"(a[i + 5]), "+f"(a[i + 6]), "+f"(a[i + 7])

template <int N>
struct Mma;

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31"
        "}, %32, %33, 1, 1, 1, 0, 1;\n"
        : R8(d, 0), R8(d, 8), R8(d, 16), R8(d, 24)
        : "l"(a), "l"(b));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, 1, 1, 1, 0, 1;\n"
        : R8(d, 0), R8(d, 8), R8(d, 16), R8(d, 24), R8(d, 32), R8(d, 40),
          R8(d, 48), R8(d, 56)
        : "l"(a), "l"(b));
  }
};

template <>
struct Mma<256> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
        "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
        "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
        "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
        "%127"
        "}, %128, %129, 1, 1, 1, 0, 1;\n"
        : R8(d, 0), R8(d, 8), R8(d, 16), R8(d, 24), R8(d, 32), R8(d, 40),
          R8(d, 48), R8(d, 56), R8(d, 64), R8(d, 72), R8(d, 80), R8(d, 88),
          R8(d, 96), R8(d, 104), R8(d, 112), R8(d, 120)
        : "l"(a), "l"(b));
  }
};

#undef R8

// --- epilogue ---

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

// One output before its final rounding to bf16: a (and b, up) are the f32
// sums, s (and s2) their scales, rv the residual.
template <int EPI>
__device__ __forceinline__ float epi_value(float a, float b, float s,
                                           float s2, float rv, int act) {
  if (EPI == EPI_GATE_UP) {
    float g = round_bf16(a * s);
    float u = round_bf16(b * s2);
    return round_bf16(act_fn(g, act)) * u;
  }
  if (EPI == EPI_RESIDUAL) return rv + round_bf16(a * s);
  return a * s;
}

// Columns col, col + 1 of one row (col even); b0, b1: the up sums.
template <int EPI>
__device__ __forceinline__ void emit_pair(const Args& p, int row, int col,
                                          float a0, float a1, float b0,
                                          float b1) {
  if (row >= p.M || col >= p.N) return;
  const int64_t o = (int64_t)row * p.N + col;
  if (p.ovec) {
    const float2 s = *reinterpret_cast<const float2*>(p.s + col);
    float2 s2 = make_float2(0.0f, 0.0f), rv = s2;
    if (EPI == EPI_GATE_UP) s2 = *reinterpret_cast<const float2*>(p.s2 + col);
    if (EPI == EPI_RESIDUAL)
      rv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.r + o));
    *reinterpret_cast<__nv_bfloat162*>(p.out + o) = __floats2bfloat162_rn(
        epi_value<EPI>(a0, b0, s.x, s2.x, rv.x, p.act),
        epi_value<EPI>(a1, b1, s.y, s2.y, rv.y, p.act));
    return;
  }
  const float av[2] = {a0, a1}, bv[2] = {b0, b1};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (col + e >= p.N) break;
    float s2 = EPI == EPI_GATE_UP ? p.s2[col + e] : 0.0f;
    float rv = EPI == EPI_RESIDUAL ? __bfloat162float(p.r[o + e]) : 0.0f;
    p.out[o + e] = __float2bfloat16(
        epi_value<EPI>(av[e], bv[e], p.s[col + e], s2, rv, p.act));
  }
}

// --- producer ---
// Copy mapping (and the conversion's, below): 8 consecutive threads take
// 8 consecutive rows of one 16-byte column, so their shared-memory
// accesses fall on distinct banks, while a warp still reads whole
// 32-byte sectors of each row. A thread's copies of one step are
// rows r0 + i * X_RS of x at one column, and rows k0 + i * W_RS of W at
// one column, so it keeps a base per operand and strides from it.
template <class C>
struct Loader {
  static constexpr int CPR = C::BNS / 16;       // copies per W row
  static constexpr int X_RS = 16;               // x rows between copies
  static constexpr int W_RS = 128 / CPR;        // W rows between copies
  static constexpr int X_COPIES = C::BM / X_RS;
  static constexpr int W_COPIES = BK / W_RS;
  int x_rows;                 // this thread's copies of x rows below M
  int kc;                     // its x column within a step
  int kr0;                    // its first W row within a step
  int x_dst, w_dst;           // element / byte offsets within a slot
  const __nv_bfloat16* x_src; // x[m0 + r0][kc]
  const int8_t* w_src;        // W row 0 at this thread's column
  int w_n;                    // that column

  __device__ __forceinline__ Loader(const Args& p, int t, int m0, int n0,
                                    int rows) {
    const int r0 = ((t >> 6) << 3) | (t & 7);
    kc = ((t >> 3) & 7) * 8;
    x_rows = r0 < rows ? (rows - r0 + X_RS - 1) / X_RS : 0;
    x_dst = core_off<BK>(r0, kc);
    x_src = p.x + (int64_t)(m0 + r0) * p.K + kc;
    kr0 = ((t >> 3) / CPR) * 8 + (t & 7);
    const int c = ((t >> 3) % CPR) * 16;
    w_dst = kr0 * C::RAW_LD + c;
    const bool second = C::TWO && c >= C::BN;  // gate_up: the up weight
    w_n = n0 + c - (second ? C::BN : 0);
    w_src = (second ? p.w2 : p.w) + w_n;
  }

  // Start the copies of the step at k0 into one ring slot: x as core
  // matrices, W raw as [BK][RAW_LD] bytes; K and N tails zero-filled.
  __device__ __forceinline__ void issue(const Args& p, int k0,
                                        __nv_bfloat16* xs, int8_t* raw) const {
    const bool x_live = k0 + kc < p.K;
    const __nv_bfloat16* xsrc = x_src + k0;
#pragma unroll
    for (int i = 0; i < X_COPIES; ++i) {
      if (i >= x_rows) break;
      __nv_bfloat16* dst = xs + x_dst + i * (X_RS * BK);
      const __nv_bfloat16* src = xsrc + (int64_t)i * X_RS * p.K;
      if (p.xvec) {
        cp_async16(dst, x_live ? src : p.x, x_live);
      } else {
        union { uint4 u; __nv_bfloat16 h[8]; } v;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v.h[e] = k0 + kc + e < p.K ? src[e] : __float2bfloat16(0.0f);
        *reinterpret_cast<uint4*>(dst) = v.u;
      }
    }
    const int8_t* wsrc = w_src + (int64_t)(k0 + kr0) * p.N;
#pragma unroll
    for (int i = 0; i < W_COPIES; ++i) {
      const int k = k0 + kr0 + i * W_RS;
      int8_t* dst = raw + w_dst + i * W_RS * C::RAW_LD;
      const int8_t* src = wsrc + (int64_t)i * W_RS * p.N;
      if (p.wvec) {
        const bool live = w_n < p.N && k < p.K;
        cp_async16(dst, live ? src : p.w, live);
      } else {
        union { uint4 u; int8_t b[16]; } v;
#pragma unroll
        for (int e = 0; e < 16; ++e) v.b[e] = k < p.K && w_n + e < p.N ? src[e] : 0;
        *reinterpret_cast<uint4*>(dst) = v.u;
      }
    }
  }
};

// A landed int8 W tile -> bf16 core matrices (exact), shared by the
// consumer threads (t: 0 .. CONSUMERS - 1).
template <class C>
__device__ __forceinline__ void convert_step(int t, const int8_t* raw,
                                             __nv_bfloat16* wbf) {
  constexpr int CPR = C::BNS / 16;
#pragma unroll
  for (int it = 0; it < BK * CPR / C::CONSUMERS; ++it) {
    const int L = it * C::CONSUMERS + t;
    const int kr = ((L >> 3) / CPR) * 8 + (L & 7), c = ((L >> 3) % CPR) * 16;
    uint4 a, b;
    i8x16_to_bf16(*reinterpret_cast<const uint4*>(raw + kr * C::RAW_LD + c), a, b);
    *reinterpret_cast<uint4*>(wbf + core_off<C::BNS>(kr, c)) = a;
    *reinterpret_cast<uint4*>(wbf + core_off<C::BNS>(kr, c + 8)) = b;
  }
}

// Block (m tile, rank) x n tile. Threads [0, CONSUMERS): consumers; the
// last warpgroup: the producer.
template <int CFG, int EPI>
__global__ void __launch_bounds__(Cfg<CFG, EPI>::THREADS, Cfg<CFG, EPI>::MIN_BLOCKS)
    qmm_kernel(const Args p) {
  using C = Cfg<CFG, EPI>;
  extern __shared__ __align__(1024) unsigned char sm[];
  auto xs = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(sm + s * C::X_BYTES);
  };
  auto raw = [&](int s) {
    return reinterpret_cast<int8_t*>(sm + C::RAW_OFF + s * C::RAW_BYTES);
  };
  auto wbf = [&](int b) {
    return reinterpret_cast<__nv_bfloat16*>(sm + C::WBF_OFF + b * C::WBF_BYTES);
  };
  uint64_t* loaded = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);  // [STAGES]
  uint64_t* freed = loaded + C::STAGES;                              // [STAGES]

  const int splits = p.splits;
  const int rank = blockIdx.x % splits;
  const int m0 = (blockIdx.x / splits) * C::BM, n0 = blockIdx.y * C::BN;
  const int nk = (p.K + BK - 1) / BK;
  const int kb = rank * nk / splits;  // this rank's steps [kb, ke)
  const int steps = (rank + 1) * nk / splits - kb;
  const int rows = min(C::BM, p.M - m0);

  // x rows past M stay zero in every slot and are never copied
  if (rows < C::BM) {
    for (int L = threadIdx.x; L < C::STAGES * C::BM * 8; L += C::THREADS) {
      const int s = L / (C::BM * 8), l = L % (C::BM * 8);
      const int r = ((l >> 6) << 3) | (l & 7), kc = ((l >> 3) & 7) * 8;
      if (r >= rows)
        *reinterpret_cast<uint4*>(xs(s) + core_off<BK>(r, kc)) = make_uint4(0, 0, 0, 0);
    }
    fence_to_async();
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&loaded[s], 128);           // producer threads
      mbar_init(&freed[s], 4 * C::NWG);     // consumer warps
    }
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == C::NWG) {
    // ---------------------------------------------------------- producer
    regs_dec<C::PRODUCER_REGS>();
    const int t = threadIdx.x - C::CONSUMERS;
    // aligned rows: the hardware arrives for each thread once its copies
    // land; element loads are stored by the thread itself, which arrives
    const bool async = p.xvec && p.wvec;
    const Loader<C> ld(p, t, m0, n0, rows);
    for (int j = 0; j < steps; ++j) {  // step j's copies, once its slot is free
      const int s = j % C::STAGES;
      if (j >= C::STAGES) mbar_wait(&freed[s], (j / C::STAGES - 1) & 1);
      ld.issue(p, (kb + j) * BK, xs(s), raw(s));
      if (async) {
        mbar_arrive_on_copies(&loaded[s]);
      } else {
        cp_async_wait_all();
        mbar_arrive(&loaded[s]);
      }
    }
    if (splits > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
  } else {
    // ---------------------------------------------------------- consumers
    regs_inc<C::CONSUMER_REGS>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    float acc[C::BN / 2], acc2[C::BN / 2];  // acc2: up (gate_up only)
#pragma unroll
    for (int e = 0; e < C::BN / 2; ++e) acc[e] = acc2[e] = 0.0f;
    wg_fence();
    const int a_off = core_off<BK>(64 * wg, 0);
    for (int i = 0; i < steps; ++i) {
      const int s = i % C::STAGES, b = i % C::NBF;
      mbar_wait(&loaded[s], (i / C::STAGES) & 1);
      // convert step i while step i - 1's products run; its bf16 buffer
      // was last read by step i - NBF, which every warpgroup has released
      if (i >= C::NBF)
        mbar_wait(&freed[(i - C::NBF) % C::STAGES], ((i - C::NBF) / C::STAGES) & 1);
      convert_step<C>(threadIdx.x, raw(s), wbf(b));
      fence_to_async();
      named_sync(1, C::CONSUMERS);  // the whole bf16 tile is written
      const __nv_bfloat16* xa = xs(s) + a_off;
      const __nv_bfloat16* wb = wbf(b);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = wg_desc(xa + kk * 128, 128, BK * 16);
        const __nv_bfloat16* bk = wb + kk * 2 * (C::BNS / 8) * 64;
        Mma<C::BN>::run(acc, da, wg_desc(bk, C::BNS * 16, 128));
        if constexpr (C::TWO)
          Mma<C::BN>::run(acc2, da, wg_desc(bk + (C::BN / 8) * 64, C::BNS * 16, 128));
      }
      wg_commit();
      wg_wait<1>();  // step i - 1's products are done: release its slot
      if (i > 0 && lane == 0) mbar_arrive(&freed[(i - 1) % C::STAGES]);
    }
    wg_wait<0>();

    // accumulator layout: acc[4 j + 2 h + e] is row 16 warp + g + 8 h of
    // this warpgroup, column 8 j + 2 q + e
    const int g = lane / 4, q = lane % 4;
    const int r_loc = 64 * wg + 16 * warp + g;
    if (splits == 1) {
#pragma unroll
      for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          emit_pair<EPI>(p, m0 + r_loc + 8 * h, n0 + 8 * j + 2 * q,
                         acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1],
                         acc2[4 * j + 2 * h], acc2[4 * j + 2 * h + 1]);
      return;
    }
    named_sync(1, C::CONSUMERS);  // every consumer's operands are consumed
    float* part = reinterpret_cast<float*>(sm);
#pragma unroll
    for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = (r_loc + 8 * h) * C::PART_LD + 8 * j + 2 * q;
        *reinterpret_cast<float2*>(part + o) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        if (C::TWO)
          *reinterpret_cast<float2*>(part + C::PART_TILE + o) =
              make_float2(acc2[4 * j + 2 * h], acc2[4 * j + 2 * h + 1]);
      }
    cluster_sync();  // every rank's partials are written
    cg::cluster_group cluster = cg::this_cluster();
    constexpr int QPR = C::BN / 4;  // 4-column groups per row
    const int q0 = rank * (C::BM * QPR) / splits;
    const int q1 = (rank + 1) * (C::BM * QPR) / splits;
    for (int qi = q0 + (int)threadIdx.x; qi < q1; qi += C::CONSUMERS) {
      const int row = qi / QPR, c = (qi % QPR) * 4;
      if (row >= rows) continue;
      // every rank's values are loaded before any is added, so the
      // distributed-memory latencies overlap; the sum runs in rank order
      const float* mine = part + row * C::PART_LD + c;
      float4 v[MAX_SPLITS], v2[MAX_SPLITS];
#pragma unroll
      for (int rr = 0; rr < MAX_SPLITS; ++rr) {
        if (rr >= splits) break;
        const float* src = cluster.map_shared_rank(mine, rr);
        v[rr] = *reinterpret_cast<const float4*>(src);
        if (C::TWO) v2[rr] = *reinterpret_cast<const float4*>(src + C::PART_TILE);
      }
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), u = a;
#pragma unroll
      for (int rr = 0; rr < MAX_SPLITS; ++rr) {
        if (rr >= splits) break;
        a.x += v[rr].x; a.y += v[rr].y; a.z += v[rr].z; a.w += v[rr].w;
        if (C::TWO) {
          u.x += v2[rr].x; u.y += v2[rr].y; u.z += v2[rr].z; u.w += v2[rr].w;
        }
      }
      emit_pair<EPI>(p, m0 + row, n0 + c, a.x, a.y, u.x, u.y);
      emit_pair<EPI>(p, m0 + row, n0 + c + 2, a.z, a.w, u.z, u.w);
    }
    cluster_sync();  // no rank's partials are read any more
  }
}

template <int CFG, int EPI>
int launch(const Args& a, cudaStream_t st) {
  using C = Cfg<CFG, EPI>;
  auto kern = qmm_kernel<CFG, EPI>;
  static bool prepared = false;  // per instance: attributes set once
  if (!prepared) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    prepared = true;
  }
  const int tiles_m = (a.M + C::BM - 1) / C::BM;
  const int tiles_n = (a.N + C::BN - 1) / C::BN;
  if (tiles_n > 65535) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_m * a.splits, tiles_n, 1);
  cfg.blockDim = dim3(C::THREADS, 1, 1);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of `splits` blocks of a variant the card holds at once.
template <int CFG, int EPI>
int max_clusters(int splits) {
  using C = Cfg<CFG, EPI>;
  auto kern = qmm_kernel<CFG, EPI>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, 1, 1);
  cfg.blockDim = dim3(C::THREADS, 1, 1);
  cfg.dynamicSmemBytes = C::SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return e != cudaSuccess ? -(int)e : n;
}

template <int CFG>
int launch_epi(const Args& a, int epi, cudaStream_t st) {
  switch (epi) {
    case EPI_NONE: return launch<CFG, EPI_NONE>(a, st);
    case EPI_RESIDUAL: return launch<CFG, EPI_RESIDUAL>(a, st);
    case EPI_GATE_UP:
      if constexpr (CFG != CFG_DECODE_NARROW) return launch<CFG, EPI_GATE_UP>(a, st);
      [[fallthrough]];
    default: return (int)cudaErrorInvalidValue;
  }
}

bool aligned(const void* p, uintptr_t n) {
  return p == nullptr || ((uintptr_t)p % n) == 0;
}

}  // namespace

// epi: 0 none, 1 residual (r [M, N]), 2 gate_up (w2, s2). act: 0 silu,
// 1 tanh-gelu. cfg: 0 prefill, 1 decode, 2 decode with a 64-column tile
// (not with gate_up). splits: blocks of a cluster that split K, 1..16 and
// at most ceil(K / 64). Returns the launch's CUDA error code.
extern "C" int qmm_launch(const void* x, const void* w, const void* s,
                          const void* w2, const void* s2, const void* r,
                          void* out, int M, int N, int K, int epi, int act,
                          int cfg, int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || splits > MAX_SPLITS ||
      splits > (K + BK - 1) / BK || (epi == EPI_GATE_UP && (!w2 || !s2)) ||
      (epi == EPI_RESIDUAL && !r))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = (const __nv_bfloat16*)x;
  a.w = (const int8_t*)w;
  a.s = (const float*)s;
  a.w2 = (const int8_t*)w2;
  a.s2 = (const float*)s2;
  a.r = (const __nv_bfloat16*)r;
  a.out = (__nv_bfloat16*)out;
  a.M = M;
  a.N = N;
  a.K = K;
  a.act = act;
  a.splits = splits;
  a.xvec = K % 8 == 0 && aligned(x, 16);
  a.wvec = N % 16 == 0 && aligned(w, 16) && aligned(w2, 16);
  a.ovec = N % 2 == 0 && aligned(out, 4) && aligned(r, 4) && aligned(s, 8) &&
           aligned(s2, 8);
  cudaStream_t st = (cudaStream_t)stream;
  switch (cfg) {
    case CFG_PREFILL: return launch_epi<CFG_PREFILL>(a, epi, st);
    case CFG_DECODE: return launch_epi<CFG_DECODE>(a, epi, st);
    case CFG_DECODE_NARROW: return launch_epi<CFG_DECODE_NARROW>(a, epi, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Clusters of `splits` blocks of a variant (its plain epilogue) that the
// card holds at once; a negative CUDA error code on failure.
extern "C" int qmm_max_clusters(int cfg, int splits) {
  if (splits < 1 || splits > MAX_SPLITS) return -(int)cudaErrorInvalidValue;
  switch (cfg) {
    case CFG_PREFILL: return max_clusters<CFG_PREFILL, EPI_NONE>(splits);
    case CFG_DECODE: return max_clusters<CFG_DECODE, EPI_NONE>(splits);
    case CFG_DECODE_NARROW: return max_clusters<CFG_DECODE_NARROW, EPI_NONE>(splits);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block of a variant, in bytes (0: no such
// variant).
extern "C" int qmm_smem_bytes(int cfg, int epi) {
  switch (cfg * 3 + epi) {
    case 0: return Cfg<CFG_PREFILL, EPI_NONE>::SMEM;
    case 1: return Cfg<CFG_PREFILL, EPI_RESIDUAL>::SMEM;
    case 2: return Cfg<CFG_PREFILL, EPI_GATE_UP>::SMEM;
    case 3: return Cfg<CFG_DECODE, EPI_NONE>::SMEM;
    case 4: return Cfg<CFG_DECODE, EPI_RESIDUAL>::SMEM;
    case 5: return Cfg<CFG_DECODE, EPI_GATE_UP>::SMEM;
    case 6: return Cfg<CFG_DECODE_NARROW, EPI_NONE>::SMEM;
    case 7: return Cfg<CFG_DECODE_NARROW, EPI_RESIDUAL>::SMEM;
    default: return 0;
  }
}
