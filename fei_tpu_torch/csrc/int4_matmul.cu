// Weight-only int4 matmul for Hopper (sm_90a).
//
// Replaces: fei_tpu/ops/pallas/int4_matmul.py, the Pallas TPU kernel
// `_kernel` (:75) reached through `_int4_mm_kernel` (:105, the
// pallas_call at :124) and the public `int4_mm` (:283).
//
// Contract: x [M, K] bf16 (rows `x_row_stride` elements apart, unit
// stride within a row); p [K/2, N] int8, byte (k, n) packing logical
// contraction rows k (low nibble) and k + K/2 (high nibble); s [K/gs, N]
// fp32, row g scaling logical rows [g*gs, (g+1)*gs). Output [M, N] bf16,
// contiguous:
//   w_lo[k, n] = bf16(fp32(lo[k, n]) * s[k / gs, n])
//   w_hi[k, n] = bf16(fp32(hi[k, n]) * s[(k + K/2) / gs, n])
//   out = bf16(x[:, :K/2] @ w_lo + x[:, K/2:] @ w_hi)   (fp32 accumulate)
// — the Pallas kernel's arithmetic: the scaled weight is rounded to bf16
// before the product, as `scaled(...).astype(jnp.bfloat16)` does.
//
// What bounds it on the H100: at decode (M <= 16) each packed byte is used
// by at most 16 rows, far below the card's ~295 FLOP/byte ridge, so the
// bound is the bytes of p and s at 3.35 TB/s (wq at 4096 x 4096: 8.9 MB,
// 2.7 us). At prefill (M = 2048) it is 2*M*K*N tensor-core operations at
// 989 TFLOP/s (wq: 69.5 us), which only wgmma reaches on Hopper.
//
// What the design does about it. Every product is a wgmma in "swap AB"
// form: out^T = W^T x^T, so that 64 weight columns fill wgmma's 64-row
// side (A: the dequantized bf16 weight, MN-major in shared memory) and the
// tokens its narrow side (B: x, K-major). Operands sit in wgmma's
// 128-byte swizzled layout (wgmma.cuh), which a 16-byte cp.async (x) or an
// 8-byte store (the weight) fills without bank conflicts.
// - Decode (M <= 16, `int4_mm_split`): the contraction is cut into fixed
//   segments of SEG = 256 packed rows, a function of K alone. A block
//   (one warpgroup) takes 64 weight columns of one segment: it copies the
//   segment's packed bytes, scales and x rows with cp.async all at once,
//   then dequantizes 64-row chunks into a double buffer while wgmma
//   m64n16k16 multiplies the previous chunk. w_down at M = 8 gives 64 x 28
//   blocks instead of 64. Each block writes its fp32 partial sums to
//   scratch; `int4_mm_reduce` adds the segments in order (no atomics).
// - Prefill (M > 16, `int4_mm_pipe`): a block takes 128 weight columns x
//   128 tokens with four warpgroups over a three-stage ring of 64 packed
//   rows a stage. Two loader warpgroups take alternate stages: each
//   brings its stage's x tile in with TMA (128-byte swizzle, straight
//   into wgmma's layout) and its packed bytes and scales with cp.async,
//   then dequantizes them into bf16 tiles in shared memory (an exact
//   magic-number int4 -> fp32, the fp32 scale, one rounding to bf16).
//   The two consumer warpgroups (64 columns each) multiply with wgmma
//   m64n128k16 while the loaders prepare the next stages; mbarriers
//   guard each stage (x landed, weight dequantized, stage consumed), and
//   setmaxnreg gives the consumers the loaders' spare registers. What
//   bounds it now is the x tile's traffic from L2 (32 KB of x for 8 KB of
//   packed weight a stage) and the dequantization.
//
// Row invariance: every output element is summed in one order, whatever M
// and whichever kernel: per segment a fresh fp32 accumulator takes the
// segment's 16-row steps from its first row upwards, the low plane's step
// before the high plane's; the segments are then added into a total that
// starts at 0, in segment order. So a row of an M = 2048 call is bitwise
// the same row of an M = 1 call (both kernels issue the same wgmma k16
// steps), which the serving path's identities (resume == uninterrupted,
// merged == solo) rely on.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libint4_matmul.so int4_matmul.cu
// The Python side (fei_tpu_torch/ops/kernels/int4_matmul.py) builds it at
// first use and calls fei_int4_matmul through ctypes.

#include <cuda.h>  // CUtensorMap (the encoder is found at run time: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using hopper::cp_async16;
using hopper::sw128_offset;

constexpr int SEG = 256;  // packed rows per segment of the contraction (a function of K only)
constexpr int CH = 64;    // packed rows per dequantized chunk / pipeline stage

struct Params {
  const __nv_bfloat16* x;
  const int8_t* p;
  const float* s;
  __nv_bfloat16* out;
  float* part;       // decode: [nseg, M, N] fp32 partial sums
  int M, N, K2, G2;  // K2 = K/2 packed rows; G2 = scale rows per half
  int group;         // contraction rows per scale row
  long long x_rs;    // x row stride in elements
  int n16;           // N % 16 == 0: 16-byte copies of the packed rows
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(hopper::smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// fp32 value of the signed nibble at bit `shift` of w, exactly: the
// nibble's offset-binary form under 2^23's exponent, minus 2^23 + 8
__device__ __forceinline__ float nibble(uint32_t w, int shift) {
  return __uint_as_float(((w >> shift) & 0xFu) ^ 0x4B000008u) - 8388616.f;
}

// copy rows [k0, k0 + rows) x BNW columns of the packed bytes into shared
// memory (row stride BNW + 16 bytes); columns past N are zeros
template <int BNW>
__device__ __forceinline__ void load_packed(const Params& p, int8_t* sP, int k0, int rows,
                                            int n0, int tid, int nthreads) {
  constexpr int PROW = BNW + 16;
  if (p.n16) {
    for (int i = tid; i < rows * (BNW / 16); i += nthreads) {
      const int r = i / (BNW / 16), c = (i % (BNW / 16)) * 16;
      const int n = n0 + c;
      cp_async16(sP + r * PROW + c, n < p.N ? p.p + (long long)(k0 + r) * p.N + n : p.p,
                 n < p.N ? 16 : 0);
    }
  } else {
    for (int i = tid; i < rows * (BNW / 8); i += nthreads) {
      const int r = i / (BNW / 8), c = (i % (BNW / 8)) * 8;
      const int n = n0 + c;
      cp_async8(sP + r * PROW + c, n < p.N ? p.p + (long long)(k0 + r) * p.N + n : p.p,
                n < p.N ? 8 : 0);
    }
  }
}

// copy scale rows [g0, g0 + rows) of both halves, BNW columns, into
// sS[half][row][BNW]; columns past N are zeros
template <int BNW>
__device__ __forceinline__ void load_scales(const Params& p, float* sS, int g0, int rows,
                                            int n0, int tid, int nthreads) {
  constexpr int SV = BNW / 4;
  for (int i = tid; i < 2 * rows * SV; i += nthreads) {
    const int half = i / (rows * SV);
    const int r = (i / SV) % rows;
    const int c = (i % SV) * 4;
    const int n = n0 + c;
    cp_async16(sS + (half * rows + r) * BNW + c,
               n < p.N ? p.s + (long long)(g0 + r + half * p.G2) * p.N + n : p.s,
               n < p.N ? 16 : 0);
  }
}

// copy x rows [m0, m0 + ROWS), contraction columns [k0, k0 + cols) of both
// halves, into SW128 panels of [ROWS][64] (the high half at `half_bytes`);
// rows past M are zeros
template <int ROWS>
__device__ __forceinline__ void load_x(const Params& p, unsigned char* sX, int half_bytes,
                                       int m0, int k0, int cols, int tid, int nthreads) {
  const int C = cols / 8;
  for (int i = tid; i < 2 * ROWS * C; i += nthreads) {
    const int half = i / (ROWS * C);
    const int r = (i / C) % ROWS;
    const int c = i % C;
    const int m = m0 + r;
    const __nv_bfloat16* src = m < p.M ? p.x + m * p.x_rs + half * p.K2 + k0 + c * 8 : p.x;
    cp_async16(sX + half * half_bytes + (c >> 3) * (ROWS * 128) + sw128_offset(r, c & 7), src,
               m < p.M ? 16 : 0);
  }
}

// dequantize CH packed rows (row stride BNW + 16) into the two bf16 planes
// (SW128 panels of [CH][64] weight columns; the high plane at CH * BNW * 2
// bytes), with the scale rows sLo / sHi [BNW], by 128 threads. A thread
// keeps its 4 columns (one 32-bit word, 8 nibbles, a row; BNW / 64 such
// columns) and their scales, and walks rows r8, r8 + 8, ...: all its words
// are read before the arithmetic, so the loads overlap. Eight consecutive
// threads take eight rows of one 16-byte chunk column, which the padding
// (reads) and the swizzle (stores) spread over distinct bank groups.
template <int BNW>
__device__ __forceinline__ void dequant(const int8_t* sP, const float* sLo, const float* sHi,
                                        unsigned char* sW, int tid) {
  constexpr int PROW = BNW + 16;
  const int r8 = tid & 7;
  const int hf = (tid >> 3) & 1;
#pragma unroll
  for (int cc = 0; cc < BNW / 64; ++cc) {
    const int c = (tid >> 4) + 8 * cc;  // 16-byte chunk column over all panels
    const int n = c * 8 + hf * 4;
    const float4 sl = *reinterpret_cast<const float4*>(sLo + n);
    const float4 sh = *reinterpret_cast<const float4*>(sHi + n);
    uint32_t w[CH / 8];
#pragma unroll
    for (int j = 0; j < CH / 8; ++j) {
      w[j] = *reinterpret_cast<const uint32_t*>(sP + (8 * j + r8) * PROW + n);
    }
#pragma unroll
    for (int j = 0; j < CH / 8; ++j) {
      uint2 plo, phi;
      // byte b: low nibble at bit 8b (plane lo), high nibble at 8b + 4 (plane hi)
      plo.x = pack_bf16(nibble(w[j], 0) * sl.x, nibble(w[j], 8) * sl.y);
      plo.y = pack_bf16(nibble(w[j], 16) * sl.z, nibble(w[j], 24) * sl.w);
      phi.x = pack_bf16(nibble(w[j], 4) * sh.x, nibble(w[j], 12) * sh.y);
      phi.y = pack_bf16(nibble(w[j], 20) * sh.z, nibble(w[j], 28) * sh.w);
      const int off = (c >> 3) * (CH * 128) + sw128_offset(8 * j + r8, c & 7) + hf * 8;
      *reinterpret_cast<uint2*>(sW + off) = plo;
      *reinterpret_cast<uint2*>(sW + CH * BNW * 2 + off) = phi;
    }
  }
}

// ------------------------------------------------- decode: a split of K

constexpr int D_BNW = 64;  // weight columns per block: wgmma's 64 rows
constexpr int D_BT = 16;   // token columns: m64n16k16
constexpr int D_THREADS = 128;

struct SplitLayout {
  static constexpr int X_HALF = D_BT * SEG * 2;  // one half of x's rows, bf16
  static constexpr int P_OFF = 2 * X_HALF;
  static constexpr int P_BYTES = SEG * (D_BNW + 16);
  static constexpr int S_OFF = P_OFF + P_BYTES;
  static constexpr int S_ROWS = 2;  // scale rows a segment can touch in each half
  static constexpr int W_OFF = S_OFF + 2 * S_ROWS * D_BNW * 4;
  static constexpr int W_BYTES = 2 * CH * D_BNW * 2;  // both planes of one chunk
  static constexpr int BYTES = W_OFF + 2 * W_BYTES + 1024;  // two chunk buffers; alignment
  static_assert(X_HALF % 1024 == 0 && P_OFF % 1024 == 0 && W_OFF % 1024 == 0, "SW128 panels");
};

__global__ void __launch_bounds__(D_THREADS) int4_mm_split(const Params p) {
  using L = SplitLayout;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * D_BNW;
  const int seg = blockIdx.y;
  const int k0 = seg * SEG;
  const int rows = min(SEG, p.K2 - k0);  // a multiple of 128
  const int g0 = k0 / p.group;
  const int g_rows = (k0 + rows - 1) / p.group - g0 + 1;
  int8_t* sP = reinterpret_cast<int8_t*>(smem + L::P_OFF);
  float* sS = reinterpret_cast<float*>(smem + L::S_OFF);

  // the whole segment in flight at once: x rows, packed bytes, scales
  load_x<D_BT>(p, smem, L::X_HALF, 0, k0, rows, tid, D_THREADS);
  load_packed<D_BNW>(p, sP, k0, rows, n0, tid, D_THREADS);
  load_scales<D_BNW>(p, sS, g0, g_rows, n0, tid, D_THREADS);
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();

  auto dequant_chunk = [&](int j) {
    const int g = (k0 + j * CH) / p.group - g0;
    dequant<D_BNW>(sP + j * CH * (D_BNW + 16), sS + g * D_BNW, sS + (g_rows + g) * D_BNW,
                   smem + L::W_OFF + (j & 1) * L::W_BYTES, tid);
  };

  const int n_ch = rows / CH;
  const uint64_t dx = hopper::make_desc(smem, 16, 1024);  // K-major x: a panel per chunk
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  dequant_chunk(0);
  hopper::fence_proxy_async();
  __syncthreads();
  for (int j = 0; j < n_ch; ++j) {
    const unsigned char* w = smem + L::W_OFF + (j & 1) * L::W_BYTES;
    const uint64_t dlo = hopper::make_desc(w, CH * 128, 1024);  // MN-major weight
    const uint64_t dhi = hopper::desc_add(dlo, CH * D_BNW * 2);
    hopper::fence_regs<8>(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CH / 16; ++kk) {  // 16-row steps: low plane, then high plane
      const int xo = j * (D_BT * 128) + kk * 32;  // panel j, 32 bytes per k step
      hopper::wgmma_ss_n16<1, 0>(acc, hopper::desc_add(dlo, kk * 2048),
                                 hopper::desc_add(dx, xo), (j > 0 || kk > 0) ? 1 : 0);
      hopper::wgmma_ss_n16<1, 0>(acc, hopper::desc_add(dhi, kk * 2048),
                                 hopper::desc_add(dx, L::X_HALF + xo), 1);
    }
    hopper::wgmma_commit();
    if (j + 1 < n_ch) {  // the next chunk's dequantization overlaps these products
      dequant_chunk(j + 1);
      hopper::fence_proxy_async();
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs<8>(acc);
    __syncthreads();
  }

  // this segment's partial sums, fp32 [seg][m][n]
  const int warp = tid / 32, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  float* part = p.part + (long long)seg * p.M * p.N;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int m = 8 * (e >> 2) + 2 * tig + (e & 1);
    const int n = n0 + warp * 16 + g + 8 * ((e >> 1) & 1);
    if (m < p.M && n < p.N) part[(long long)m * p.N + n] = acc[e];
  }
}

// out = bf16(((0 + part[0]) + part[1]) + ...): the segments in order, as
// the prefill kernel adds them
__global__ void int4_mm_reduce(const Params p, int nseg) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long mn = (long long)p.M * p.N;
  if (i >= mn) return;
  float t = 0.f;
  for (int s = 0; s < nseg; ++s) t += p.part[s * mn + i];
  p.out[i] = __float2bfloat16_rn(t);
}

// ---------------------------------------- prefill: a dequantizing pipeline

constexpr int P_BNW = 128;  // weight columns per block: two consumer warpgroups of 64
constexpr int P_BT = 128;   // tokens per block: m64n128k16
constexpr int P_STAGES = 3;
constexpr int P_CONSUMERS = 256;
constexpr int P_LOADERS = 2;  // loader warpgroups, taking alternate stages
constexpr int P_THREADS = P_CONSUMERS + P_LOADERS * 128;

struct PipeLayout {
  static constexpr int X_HALF = P_BT * CH * 2;  // one TMA box: 128 tokens x 64 k, bf16
  static constexpr int P_OFF = 2 * X_HALF;
  static constexpr int S_OFF = P_OFF + CH * (P_BNW + 16);
  static constexpr int W_OFF = S_OFF + 2 * P_BNW * 4;
  static constexpr int W_PLANE = CH * P_BNW * 2;
  static constexpr int STAGE = W_OFF + 2 * W_PLANE;
  static constexpr int BAR_OFF = P_STAGES * STAGE;
  static constexpr int BYTES = BAR_OFF + 4 * P_STAGES * 8 + 1024;  // + alignment
  static constexpr int OUT_ROW = P_BNW + 8;  // bf16 per staged output row
  static_assert(P_BT * OUT_ROW * 2 <= STAGE, "the output tile is staged in stage 0");
  static_assert(X_HALF % 1024 == 0 && W_OFF % 1024 == 0 && STAGE % 1024 == 0, "SW128 panels");
};

__global__ void __launch_bounds__(P_THREADS, 1)
    int4_mm_pipe(const Params p, const __grid_constant__ CUtensorMap xmap) {
  using L = PipeLayout;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  uint64_t* raw = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);  // packed bytes, scales
  uint64_t* xin = raw + P_STAGES;                                   // x (TMA)
  uint64_t* full = xin + P_STAGES;                                  // the bf16 weight
  uint64_t* empty = full + P_STAGES;                                // the stage is read
  const int n0 = blockIdx.x * P_BNW;
  const int m0 = blockIdx.y * P_BT;
  const int n_st = p.K2 / CH;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P_STAGES; ++s) {
      hopper::mbar_init(&raw[s], 128);                   // the stage's loader warpgroup (cp.async)
      hopper::mbar_init(&xin[s], 1);                     // its TMA issuer, plus the bytes
      hopper::mbar_init(&full[s], 128);                  // the stage's loader warpgroup
      hopper::mbar_init(&empty[s], P_CONSUMERS / 32);    // one arrival per consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= P_CONSUMERS) {
    // ---- loader warpgroups: x through TMA, packed bytes and scales
    // through cp.async; warpgroup ld loads and dequantizes the stages
    // i = ld (mod 2), each ahead of the products
    hopper::reg_dealloc<64>();
    const int ld = (threadIdx.x - P_CONSUMERS) / 128;
    const int tid = (threadIdx.x - P_CONSUMERS) % 128;
    auto issue = [&](int i) {
      const int s = i % P_STAGES;
      unsigned char* st = smem + s * L::STAGE;
      const int k0 = i * CH;
      if (tid == 0) {
        hopper::mbar_expect_tx(&xin[s], 2 * L::X_HALF);
        hopper::tma_load_2d(st, &xmap, k0, m0, &xin[s]);                    // low half
        hopper::tma_load_2d(st + L::X_HALF, &xmap, p.K2 + k0, m0, &xin[s]);  // high half
      }
      load_packed<P_BNW>(p, reinterpret_cast<int8_t*>(st + L::P_OFF), k0, CH, n0, tid, 128);
      load_scales<P_BNW>(p, reinterpret_cast<float*>(st + L::S_OFF), k0 / p.group, 1, n0,
                         tid, 128);
      hopper::cp_async_arrive(&raw[s]);
    };
    for (int i = ld; i < P_STAGES && i < n_st; i += P_LOADERS) issue(i);
    for (int i = ld; i < n_st; i += P_LOADERS) {
      const int s = i % P_STAGES;
      hopper::mbar_wait(&raw[s], (i / P_STAGES) & 1);
      unsigned char* st = smem + s * L::STAGE;
      const float* sS = reinterpret_cast<const float*>(st + L::S_OFF);
      dequant<P_BNW>(reinterpret_cast<const int8_t*>(st + L::P_OFF), sS, sS + P_BNW,
                     st + L::W_OFF, tid);
      hopper::fence_proxy_async();
      hopper::mbar_arrive(&full[s]);
      // stage i + 2 (this warpgroup's next) refills the slot that stage
      // i - 1 used, once it is consumed
      const int j = i + P_STAGES - 1;
      if (i >= 1 && j < n_st) {
        hopper::mbar_wait(&empty[(i - 1) % P_STAGES], ((i - 1) / P_STAGES) & 1);
        issue(j);
      }
    }
    hopper::cp_async_wait<0>();
  } else {
    // ---- consumer warpgroups: 64 weight columns x 128 tokens each
    hopper::reg_alloc<192>();
    const int wg = threadIdx.x / 128;
    float acc[64], tot[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = tot[e] = 0.f;
    for (int i = 0; i < n_st; ++i) {
      const int s = i % P_STAGES;
      hopper::mbar_wait(&xin[s], (i / P_STAGES) & 1);
      hopper::mbar_wait(&full[s], (i / P_STAGES) & 1);
      const unsigned char* st = smem + s * L::STAGE;
      // this warpgroup's 64 weight columns are the plane's panel wg
      const uint64_t dlo = hopper::make_desc(st + L::W_OFF + wg * CH * 128, CH * 128, 1024);
      const uint64_t dhi = hopper::desc_add(dlo, L::W_PLANE);
      const uint64_t dx = hopper::make_desc(st, 16, 1024);
      const bool fresh = (i * CH) % SEG == 0;  // a segment starts: a fresh accumulator
      hopper::fence_regs<64>(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk) {  // 16-row steps: low plane, then high plane
        hopper::wgmma_ss_n128<1, 0>(acc, hopper::desc_add(dlo, kk * 2048),
                                    hopper::desc_add(dx, kk * 32), (fresh && kk == 0) ? 0 : 1);
        hopper::wgmma_ss_n128<1, 0>(acc, hopper::desc_add(dhi, kk * 2048),
                                    hopper::desc_add(dx, L::X_HALF + kk * 32), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<64>(acc);
      __syncwarp();
      if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(&empty[s]);
      if (((i + 1) * CH) % SEG == 0 || i + 1 == n_st) {  // a segment ends: into the total
#pragma unroll
        for (int e = 0; e < 64; ++e) tot[e] += acc[e];
      }
    }

    // epilogue: the bf16 tile transposed through shared memory (stage 0 is
    // free once both consumer warpgroups are past the last stage), then
    // 16-byte rows of out; rows past M and columns past N not written
    hopper::named_sync(2, P_CONSUMERS);
    __nv_bfloat16* sO = reinterpret_cast<__nv_bfloat16*>(smem);
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      const int m = 8 * (e >> 2) + 2 * tig + (e & 1);
      const int n = wg * 64 + warp * 16 + g + 8 * ((e >> 1) & 1);
      sO[m * L::OUT_ROW + n] = __float2bfloat16_rn(tot[e]);
    }
    hopper::named_sync(2, P_CONSUMERS);
    for (int i = threadIdx.x; i < P_BT * (P_BNW / 8); i += P_CONSUMERS) {
      const int m = i / (P_BNW / 8), c = (i % (P_BNW / 8)) * 8;
      if (m0 + m < p.M && n0 + c < p.N) {
        *reinterpret_cast<uint4*>(p.out + (long long)(m0 + m) * p.N + n0 + c) =
            *reinterpret_cast<const uint4*>(sO + m * L::OUT_ROW + c);
      }
    }
  }
}

cudaError_t launch_split(const Params& p, cudaStream_t stream) {
  cudaError_t err = hopper::allow_smem<int4_mm_split>(SplitLayout::BYTES);
  if (err != cudaSuccess) return err;
  const int nseg = (p.K2 + SEG - 1) / SEG;
  int4_mm_split<<<dim3((p.N + D_BNW - 1) / D_BNW, nseg), D_THREADS, SplitLayout::BYTES, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long mn = (long long)p.M * p.N;
  int4_mm_reduce<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(p, nseg);
  return cudaGetLastError();
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time (no -lcuda)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
    }
  }
  return fn;
}

cudaError_t launch_pipe(const Params& p, cudaStream_t stream) {
  cudaError_t err = hopper::allow_smem<int4_mm_pipe>(PipeLayout::BYTES);
  if (err != cudaSuccess) return err;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // x as a 2-D bf16 tensor [M][K] (rows x_rs apart), read in boxes of 128
  // tokens x 64 k with the 128-byte swizzle; rows past M arrive as zeros
  CUtensorMap xmap;
  const cuuint64_t dims[2] = {(cuuint64_t)(2 * p.K2), (cuuint64_t)p.M};
  const cuuint64_t strides[1] = {(cuuint64_t)p.x_rs * 2};
  const cuuint32_t box[2] = {(cuuint32_t)CH, (cuuint32_t)P_BT};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<__nv_bfloat16*>(p.x), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  int4_mm_pipe<<<dim3((p.N + P_BNW - 1) / P_BNW, (p.M + P_BT - 1) / P_BT), P_THREADS,
                 PipeLayout::BYTES, stream>>>(p, xmap);
  return cudaGetLastError();
}

}  // namespace

// `part` is fp32 scratch of `part_elems` = nseg * M * N elements (nseg =
// ceil(K / 2 / SEG)) for M <= 16, and may be null (0 elements) for larger M;
// a call whose scratch is not that size is refused
extern "C" int fei_int4_matmul(const void* x, long long x_row_stride, const void* p,
                               const void* s, void* out, void* part, long long part_elems,
                               int M, int N, int K, int group, void* stream) {
  Params prm;
  prm.x = static_cast<const __nv_bfloat16*>(x);
  prm.p = static_cast<const int8_t*>(p);
  prm.s = static_cast<const float*>(s);
  prm.out = static_cast<__nv_bfloat16*>(out);
  prm.part = static_cast<float*>(part);
  prm.M = M;
  prm.N = N;
  prm.K2 = K / 2;
  prm.G2 = K / 2 / group;
  prm.group = group;
  prm.x_rs = x_row_stride;
  prm.n16 = N % 16 == 0;
  // the wrapper checks these too; a call that breaks them is refused here
  if (M <= 0 || N % 8 != 0 || K % 256 != 0 || group % 128 != 0 || (K / 2) % group != 0 ||
      (M <= 16 && (part == nullptr ||
                   part_elems != (long long)((prm.K2 + SEG - 1) / SEG) * M * N))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 16) return (int)launch_split(prm, st);
  return (int)launch_pipe(prm, st);
}

extern "C" const char* fei_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
