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
// What bounds it on the H100: at decode (M <= 8) each packed byte is used
// by at most 8 rows, far below the card's ~295 FLOP/byte ridge, so the
// bound is the bytes of p and s at 3.35 TB/s (wq at 4096 x 4096: 8.9 MB,
// 2.7 us). At prefill (M = 2048) it is 2*M*K*N tensor-core operations at
// 989 TFLOP/s (wq: 69.5 us).
//
// What the design does about it: the packed bytes, the scales and the x
// tiles stream into shared memory through a multi-stage cp.async
// pipeline, so each packed byte crosses from device memory once per
// block; a stage is dequantized once into bf16 tiles in shared memory
// (both nibble planes from one byte), and every product runs on the
// tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate; B fragments
// through ldmatrix.trans). Two tile shapes: 16 x 64 for M <= 16 (decode)
// and 128 x 128 for larger M (prefill). It is the simple version: decode
// gives only N/64 blocks (16 for N = 1024) against 132 SMs; a fixed
// split of K, smaller tiles, wgmma and TMA are later work.
//
// Row invariance: every output element sums its K in the same order —
// 16-row steps of k from 0 upwards, the low plane's step before the high
// plane's, one accumulator, no split of K — whatever M, the tile shape or
// the row's place in the tile. So a row of an M = 256 call is bitwise the
// same row of an M = 1 call, which the serving path's identities (resume
// == uninterrupted, merged == solo) rely on.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libint4_matmul.so int4_matmul.cu
// The Python side (fei_tpu_torch/ops/kernels/int4_matmul.py) builds it at
// first use and calls fei_int4_matmul through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  const __nv_bfloat16* x;
  const int8_t* p;
  const float* s;
  __nv_bfloat16* out;
  int M, N, K2, G2;  // K2 = K/2 packed rows; G2 = scale rows per half
  int group;         // contraction rows per scale row
  long long x_rs;    // x row stride in elements
  int n16;           // N % 16 == 0: 16-byte copies of the packed rows
};

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// cp.async with zero-fill: `bytes` of src land in dst, the rest of the
// copy is zeros (bytes = 0 reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c[16x8] += a[16x16] (row-major) * b[16x8] (col-major), bf16 in, fp32 acc
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8x8 bf16 matrices from row-major [k][n] shared memory, transposed
// into mma B fragments: r0/r1 the two k halves of n-tile 0, r2/r3 of n-tile 1
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// BM x BN output tile per block, warps of WM x WN, KS packed rows per
// pipeline stage, STAGES stages in flight
template <int BM_, int BN_, int WM, int WN, int KS_, int STAGES_>
struct Cfg {
  static constexpr int BM = BM_;
  static constexpr int BN = BN_;
  static constexpr int KS = KS_;
  static constexpr int STAGES = STAGES_;
  static constexpr int WARPS_N = BN / WN;
  static constexpr int THREADS = (BM / WM) * WARPS_N * 32;
  static constexpr int MT = WM / 16;   // 16-row m-tiles per warp
  static constexpr int NT = WN / 8;    // 8-column n-tiles per warp
  static constexpr int XROW = KS + 8;  // bf16 per x row in smem (padded)
  static constexpr int WROW = BN + 8;  // bf16 per dequantized weight row
  // bytes of one stage: x (two halves), packed bytes, scales (two halves)
  static constexpr int X_BYTES = 2 * BM * XROW * 2;
  static constexpr int P_BYTES = KS * BN;
  static constexpr int S_BYTES = 2 * BN * 4;
  static constexpr int STAGE_BYTES = X_BYTES + P_BYTES + S_BYTES;
  static constexpr int W_BYTES = 2 * KS * WROW * 2;  // both planes, bf16
  static constexpr int SMEM = STAGES * STAGE_BYTES + W_BYTES;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile: whole m16 tiles, n-tile pairs");
  static_assert(KS % 16 == 0 && BN % 16 == 0, "stage tile");
};

template <class T>
__device__ __forceinline__ void load_stage(const Params& p, unsigned char* stage,
                                           int m0, int n0, int k0) {
  constexpr int KS = T::KS;
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(stage);
  int8_t* sP = reinterpret_cast<int8_t*>(stage + T::X_BYTES);
  float* sS = reinterpret_cast<float*>(stage + T::X_BYTES + T::P_BYTES);
  // x: both halves, 8 bf16 (16 bytes) per copy; rows past M are zeros
  constexpr int XV = KS / 8;
  for (int i = threadIdx.x; i < 2 * T::BM * XV; i += T::THREADS) {
    const int half = i / (T::BM * XV);
    const int r = (i / XV) % T::BM;
    const int c = (i % XV) * 8;
    const int m = m0 + r;
    const __nv_bfloat16* src =
        m < p.M ? p.x + m * p.x_rs + half * p.K2 + k0 + c : p.x;
    cp_async16(sX + (half * T::BM + r) * T::XROW + c, src, m < p.M ? 16 : 0);
  }
  // packed bytes: KS rows of BN columns; columns past N are zeros
  if (p.n16) {
    constexpr int PV = T::BN / 16;
    for (int i = threadIdx.x; i < KS * PV; i += T::THREADS) {
      const int r = i / PV;
      const int c = (i % PV) * 16;
      const int n = n0 + c;
      const int8_t* src = n < p.N ? p.p + (long long)(k0 + r) * p.N + n : p.p;
      cp_async16(sP + r * T::BN + c, src, n < p.N ? 16 : 0);
    }
  } else {
    constexpr int PV = T::BN / 8;
    for (int i = threadIdx.x; i < KS * PV; i += T::THREADS) {
      const int r = i / PV;
      const int c = (i % PV) * 8;
      const int n = n0 + c;
      const int8_t* src = n < p.N ? p.p + (long long)(k0 + r) * p.N + n : p.p;
      cp_async8(sP + r * T::BN + c, src, n < p.N ? 8 : 0);
    }
  }
  // scales: the stage's scale row in each half (a stage never straddles a
  // group: group % KS == 0), 4 floats per copy
  const int g = k0 / p.group;
  constexpr int SV = T::BN / 4;
  for (int i = threadIdx.x; i < 2 * SV; i += T::THREADS) {
    const int half = i / SV;
    const int c = (i % SV) * 4;
    const int n = n0 + c;
    const float* src = n < p.N ? p.s + (long long)(g + half * p.G2) * p.N + n : p.s;
    cp_async16(sS + half * T::BN + c, src, n < p.N ? 16 : 0);
  }
}

// dequantize a stage's packed bytes into the two bf16 planes [KS][WROW]:
// each thread takes 4 columns of one row (one 32-bit word, 8 nibbles)
template <class T>
__device__ __forceinline__ void dequant_stage(const unsigned char* stage,
                                              __nv_bfloat16* sW) {
  constexpr int KS = T::KS;
  const uint32_t* sP = reinterpret_cast<const uint32_t*>(stage + T::X_BYTES);
  const float* sS = reinterpret_cast<const float*>(stage + T::X_BYTES + T::P_BYTES);
  __nv_bfloat16* sLo = sW;
  __nv_bfloat16* sHi = sW + KS * T::WROW;
  constexpr int QPR = T::BN / 4;  // words per packed row
  for (int i = threadIdx.x; i < KS * QPR; i += T::THREADS) {
    const int r = i / QPR;
    const int c = (i % QPR) * 4;
    const uint32_t w = sP[i];
    const float4 slo = *reinterpret_cast<const float4*>(sS + c);
    const float4 shi = *reinterpret_cast<const float4*>(sS + T::BN + c);
    const float sl[4] = {slo.x, slo.y, slo.z, slo.w};
    const float sh[4] = {shi.x, shi.y, shi.z, shi.w};
    float lo[4], hi[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      // byte b: low nibble = bits [8b, 8b+4), high nibble = bits [8b+4, 8b+8),
      // each sign-extended by an arithmetic shift
      const int vlo = static_cast<int>(w << (28 - 8 * b)) >> 28;
      const int vhi = static_cast<int>(w << (24 - 8 * b)) >> 28;
      lo[b] = static_cast<float>(vlo) * sl[b];
      hi[b] = static_cast<float>(vhi) * sh[b];
    }
    uint2 plo, phi;
    plo.x = pack_bf16(lo[0], lo[1]);
    plo.y = pack_bf16(lo[2], lo[3]);
    phi.x = pack_bf16(hi[0], hi[1]);
    phi.y = pack_bf16(hi[2], hi[3]);
    *reinterpret_cast<uint2*>(sLo + r * T::WROW + c) = plo;
    *reinterpret_cast<uint2*>(sHi + r * T::WROW + c) = phi;
  }
}

template <class T>
__global__ void __launch_bounds__(T::THREADS)
    int4_mm_kernel(const Params p) {
  constexpr int KS = T::KS;
  constexpr int STAGES = T::STAGES;
  constexpr int MT = T::MT;
  constexpr int NT = T::NT;

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sW = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * T::STAGE_BYTES);

  const int n0 = blockIdx.x * T::BN;
  const int m0 = blockIdx.y * T::BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row group
  const int tig = lane & 3;  // thread in group
  const int wm = (warp / T::WARPS_N) * (MT * 16);  // warp's first row in the tile
  const int wn = (warp % T::WARPS_N) * (NT * 8);   // warp's first column

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int nk = p.K2 / KS;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load_stage<T>(p, smem + st * T::STAGE_BYTES, m0, n0, st * KS);
    cp_async_commit();
  }

  // ldmatrix row this lane addresses: matrices 0/1 are the k halves of an
  // n-tile, 2/3 those of the next n-tile
  const int lm_k = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lm_n = (lane >> 4) * 8;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; the previous products are done
    const unsigned char* stage = smem + (kt % STAGES) * T::STAGE_BYTES;
    dequant_stage<T>(stage, sW);
    __syncthreads();  // the planes are ready; slot (kt - 1) is free
    {
      const int nxt = kt + STAGES - 1;
      if (nxt < nk) load_stage<T>(p, smem + (nxt % STAGES) * T::STAGE_BYTES, m0, n0, nxt * KS);
      cp_async_commit();
    }
    const __nv_bfloat16* sX = reinterpret_cast<const __nv_bfloat16*>(stage);
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // low plane, then high plane
        const __nv_bfloat16* xh = sX + half * T::BM * T::XROW;
        const __nv_bfloat16* wh = sW + half * KS * T::WROW;
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const __nv_bfloat16* x0 = xh + (wm + i * 16 + g) * T::XROW + kk + tig * 2;
          const __nv_bfloat16* x8 = x0 + 8 * T::XROW;
          a[i][0] = *reinterpret_cast<const uint32_t*>(x0);
          a[i][1] = *reinterpret_cast<const uint32_t*>(x8);
          a[i][2] = *reinterpret_cast<const uint32_t*>(x0 + 8);
          a[i][3] = *reinterpret_cast<const uint32_t*>(x8 + 8);
        }
        uint32_t b[NT][2];
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, wh + (kk + lm_k) * T::WROW + wn + j * 8 + lm_n);
          b[j][0] = r[0];
          b[j][1] = r[1];
          b[j + 1][0] = r[2];
          b[j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_16816(acc[i][j], a[i], b[j]);
      }
    }
  }

  // epilogue: bf16 pairs, rows past M and columns past N not written
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + wm + i * 16 + g + 8 * r;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + wn + j * 8 + tig * 2;
        if (n < p.N) {
          *reinterpret_cast<uint32_t*>(p.out + (long long)m * p.N + n) =
              pack_bf16(acc[i][j][2 * r], acc[i][j][2 * r + 1]);
        }
      }
    }
  }
}

template <class T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      int4_mm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + T::BN - 1) / T::BN, (p.M + T::BM - 1) / T::BM);
  int4_mm_kernel<T><<<grid, T::THREADS, T::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// decode: one 16-row m-tile, 64 columns, four warps of 16 columns
using Small = Cfg<16, 64, 16, 16, 128, 4>;
// prefill: 128 x 128, eight warps of 64 x 32
using Large = Cfg<128, 128, 64, 32, 64, 3>;

}  // namespace

extern "C" int fei_int4_matmul(const void* x, long long x_row_stride, const void* p,
                               const void* s, void* out, int M, int N, int K,
                               int group, void* stream) {
  Params prm;
  prm.x = static_cast<const __nv_bfloat16*>(x);
  prm.p = static_cast<const int8_t*>(p);
  prm.s = static_cast<const float*>(s);
  prm.out = static_cast<__nv_bfloat16*>(out);
  prm.M = M;
  prm.N = N;
  prm.K2 = K / 2;
  prm.G2 = K / 2 / group;
  prm.group = group;
  prm.x_rs = x_row_stride;
  prm.n16 = N % 16 == 0;
  // the wrapper checks these too; a call that breaks them is refused here
  if (M <= 0 || N % 8 != 0 || K % 256 != 0 || group % 128 != 0 || (K / 2) % group != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 16) return (int)launch<Small>(prm, st);
  return (int)launch<Large>(prm, st);
}

extern "C" const char* fei_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
