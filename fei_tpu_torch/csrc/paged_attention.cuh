// Paged attention for Hopper (sm_90a): the body shared by the paged decode
// kernel (paged_attention.cu, K2) and the ragged kernel
// (ragged_paged_attention.cu, K3). Each .cu file includes this header and
// exports one C entry point.
//
// Replaces: fei_tpu/ops/pallas/paged_attention.py `_decode_kernel` (:44,
// through `_paged_call`, `paged_attention` :218 and `paged_attention_block`
// :259) and fei_tpu/ops/pallas/ragged_paged_attention.py `_ragged_kernel`
// (:55, through `ragged_paged_attention` :278).
//
// Contract: q [Bv, R, H, D] bf16 (R query positions per row); pools
// [P, K, PS, D], head-major pages, bf16 or int8 (+ per-slot fp32 scales
// [P, K, 1, PS]); block_table [Bv, max_pages] int32; limits [Bv] int32:
// query position t of row b sees key positions < limits[b] + t (and, with a
// window W, > limits[b] - 1 + t - W). q_lens [Bv] (null = R for every row)
// says how many of the R positions are live; a row with mode 1 (a decode
// row) has at most one. Dead positions write zeros. fp32 online softmax;
// int8 pools fold the k scales into the score row and the v scales into p,
// as the Pallas kernel does. Output [Bv, R, H, D] bf16.
//
// What bounds it on the H100: at the decode shape (one query position per
// row, B = 8, H = 32, K = 8, D = 128, contexts of 100 to 8000 tokens) the
// kernel reads every live page once for the G = H/K query heads that share
// it and does 4*D FLOP per (query head, key): about 8 FLOP per byte of K/V
// read, far below the card's ~295 FLOP/byte ridge. It is bound by memory.
//
// What the design does about it: each block owns one (row, kv head, tile of
// 64 query rows) and walks only that tile's live pages, in block-table
// order, from the first in-window page to the page holding the last live
// key; pages past it and the null page are never read. Pages stream into
// shared memory through a two-stage cp.async pipeline (16-byte copies, the
// next page in flight while the current one is computed); products run on
// the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate), int8
// values widen to bf16 exactly inside the fragment loads. Known loss: at
// B = 8 and K = 8 a decode step has 64 blocks for 132 SMs; splitting the
// pages of a row over blocks (flash-decoding) is later work.
//
// The identity rule: a query row's arithmetic never depends on the tile
// height R, on the row's place in the tile, or on the other rows. Every
// output element comes from the same mma.sync sequence over the same pages
// in the same order, and pages a row does not see are exact no-ops for it
// (masked scores give p = 0 and a correction of 1). So a K3 decode row is
// bitwise K2 with one query position, and a K3 chunk group is bitwise the
// same rows of K2's block form.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fei_paged {

constexpr int PS = 64;           // page size: slots per page
constexpr int TILE_M = 64;       // query rows per block
constexpr int NUM_WARPS = 4;     // 16 query rows per warp
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr float NEG_INF = -1e30f;  // the Pallas kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;
  const unsigned char* k;  // bf16 or int8 elements, contiguous pool
  const unsigned char* v;
  const float* ks;  // int8 pools only
  const float* vs;
  __nv_bfloat16* o;
  const int* block_table;
  const int* limits;
  const int* q_lens;  // null: every row has R live positions
  const int* modes;   // null: no decode rows
  int Bv, R, H, K, G, max_pages;
  long long bt_stride;
  long long q_sb, q_st, q_sh;  // strides in elements; the d stride is 1
  long long o_sb, o_st, o_sh;
  int window;
  float scale_log2;  // softmax scale * log2(e): the softmax runs on exp2
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
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

// 16-byte global -> shared copy; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// element (slot, d) of a page tile in shared memory, as raw bf16 bits
template <bool INT8>
__device__ __forceinline__ uint16_t elem_bits(const unsigned char* tile,
                                              int srow_b, int slot, int d) {
  if (INT8) {
    const float x = (float)reinterpret_cast<const int8_t*>(tile + slot * srow_b)[d];
    __nv_bfloat16 h = __float2bfloat16_rn(x);  // exact: |x| <= 127
    return *reinterpret_cast<uint16_t*>(&h);
  } else {
    return reinterpret_cast<const uint16_t*>(tile + slot * srow_b)[d];
  }
}

// two elements (slot, d) and (slot, d + 1)
template <bool INT8>
__device__ __forceinline__ uint32_t pair_d(const unsigned char* tile,
                                           int srow_b, int slot, int d) {
  if (INT8) {
    return pack_raw(elem_bits<true>(tile, srow_b, slot, d),
                    elem_bits<true>(tile, srow_b, slot, d + 1));
  } else {
    return *reinterpret_cast<const uint32_t*>(tile + slot * srow_b + d * 2);
  }
}

template <int D, bool INT8, int BN>
__global__ void __launch_bounds__(NUM_THREADS) paged_attn_kernel(const Params p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static_assert(PS % BN == 0 && BN % 16 == 0, "sub-tile must divide the page");
  constexpr int EB = INT8 ? 1 : 2;          // bytes per pool element
  constexpr int SROW_B = D * EB + 16;       // bytes per slot row in smem
  constexpr int TILE_B = PS * SROW_B;       // one K (or V) page tile
  constexpr int QROW = D + 8;               // bf16 per smem query row
  constexpr int CPR = D * EB / 16;          // 16-byte chunks per slot row
  constexpr int NT_O = D / 8;               // 8-wide n-tiles of the output
  constexpr int NT_S = BN / 8;              // 8-wide n-tiles of the scores

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* sKV = smem_raw + TILE_M * QROW * 2;  // [stage][K, V]
  float* sS = reinterpret_cast<float*>(sKV + 4 * TILE_B);  // [stage][ks, vs]

  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int r0 = blockIdx.x * TILE_M;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row group
  const int tig = lane & 3;  // thread in group
  const int G = p.G;

  const int limit = p.limits[b];
  int qlen = p.q_lens ? p.q_lens[b] : p.R;
  if (p.modes && p.modes[b] == 1) qlen = min(qlen, 1);
  qlen = max(0, min(qlen, p.R));
  const int rows_total = p.R * G;
  const int r1 = min(r0 + TILE_M, qlen * G);  // live rows of this tile

  // this thread's two rows: ra and ra + 8 (tile-global row index)
  const int ra = r0 + warp * 16 + g;
  int t_r[2], lim_r[2];
  bool live_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = ra + 8 * r;
    live_r[r] = rr < r1;
    t_r[r] = rr / G;
    lim_r[r] = limit + t_r[r];  // keys < lim_r are causally visible
  }
  const bool warp_live = r0 + warp * 16 < r1;

  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};  // running max (log2 domain)
  float l_r[2] = {0.f, 0.f};          // this thread's share of the row sum

  int hi = 0, lo = 0;
  if (r1 > r0) {
    const int t_first = r0 / G;
    const int t_last = (r1 - 1) / G;
    hi = min(limit + t_last, p.max_pages * PS);  // the tile's keys: [lo, hi)
    lo = p.window > 0 ? max(limit + t_first - p.window, 0) : 0;
  }

  if (hi > lo) {  // block-uniform
    // the tile's query rows; dead rows are zeros
    for (int i = threadIdx.x; i < TILE_M * (D / 8); i += NUM_THREADS) {
      const int r = i / (D / 8);
      const int c = (i % (D / 8)) * 8;
      const int rr = r0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (rr < r1) {
        const int t = rr / G;
        const int h = kh * G + rr % G;
        val = *reinterpret_cast<const uint4*>(p.q + b * p.q_sb + t * p.q_st +
                                              h * p.q_sh + c);
      }
      *reinterpret_cast<uint4*>(sQ + r * QROW + c) = val;
    }

    const int* bt = p.block_table + b * p.bt_stride;
    const int pg_first = lo / PS;
    const int pg_last = (hi - 1) / PS;

    auto issue = [&](int pi, int st) {
      const long long page = bt[pi];
      const long long base = (page * p.K + kh) * (long long)(PS * D * EB);
      unsigned char* dK = sKV + st * 2 * TILE_B;
      unsigned char* dV = dK + TILE_B;
      for (int i = threadIdx.x; i < PS * CPR; i += NUM_THREADS) {
        const int slot = i / CPR;
        const int c = (i % CPR) * 16;
        const int bytes = pi * PS + slot < hi ? 16 : 0;  // zero-fill the tail
        const long long off = base + slot * (D * EB) + c;
        cp_async16(dK + slot * SROW_B + c, p.k + off, bytes);
        cp_async16(dV + slot * SROW_B + c, p.v + off, bytes);
      }
      if (INT8) {
        float* dS = sS + st * 2 * PS;
        const long long sbase = (page * p.K + kh) * PS;
        for (int i = threadIdx.x; i < 2 * (PS / 4); i += NUM_THREADS) {
          const int which = i / (PS / 4);
          const int c = (i % (PS / 4)) * 4;
          cp_async16(dS + which * PS + c, (which ? p.vs : p.ks) + sbase + c, 16);
        }
      }
    };

    issue(pg_first, 0);
    cp_async_commit();
    for (int pi = pg_first; pi <= pg_last; ++pi) {
      const int st = (pi - pg_first) & 1;
      if (pi < pg_last) {
        issue(pi + 1, st ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // this page (and the query tile) is in shared memory

      if (warp_live) {
        const unsigned char* sK = sKV + st * 2 * TILE_B;
        const unsigned char* sV = sK + TILE_B;
        const float* sks = sS + st * 2 * PS;
        const float* svs = sks + PS;
#pragma unroll 1
        for (int slot0 = 0; slot0 < PS; slot0 += BN) {
          const int key0 = pi * PS + slot0;
          // S = Q K^T for this warp's 16 rows against BN slots
          float s[NT_S][4];
#pragma unroll
          for (int n = 0; n < NT_S; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < D; kk += 16) {
            const __nv_bfloat16* q0 = sQ + (warp * 16 + g) * QROW + kk + tig * 2;
            const __nv_bfloat16* q8 = q0 + 8 * QROW;
            uint32_t a[4];
            a[0] = *reinterpret_cast<const uint32_t*>(q0);
            a[1] = *reinterpret_cast<const uint32_t*>(q8);
            a[2] = *reinterpret_cast<const uint32_t*>(q0 + 8);
            a[3] = *reinterpret_cast<const uint32_t*>(q8 + 8);
#pragma unroll
            for (int n = 0; n < NT_S; ++n) {
              const int slot = slot0 + n * 8 + g;
              uint32_t bf[2];
              bf[0] = pair_d<INT8>(sK, SROW_B, slot, kk + tig * 2);
              bf[1] = pair_d<INT8>(sK, SROW_B, slot, kk + tig * 2 + 8);
              mma_16816(s[n], a, bf);
            }
          }

          // mask, scale into the log2 domain (int8: times the k scale),
          // row max over the quad
          float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
          for (int n = 0; n < NT_S; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              const int slot = slot0 + n * 8 + tig * 2 + (e & 1);
              const int key = key0 + n * 8 + tig * 2 + (e & 1);
              const bool ok = live_r[r] && key < lim_r[r] &&
                              (p.window <= 0 || key > lim_r[r] - 1 - p.window);
              float x = s[n][e] * p.scale_log2;
              if (INT8) x *= sks[slot];
              x = ok ? x : NEG_INF;
              s[n][e] = x;
              mx[r] = fmaxf(mx[r], x);
            }
          }
          float corr[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m_r[r], mx[r]);
            corr[r] = exp2f(m_r[r] - m_new);
            m_r[r] = m_new;
            l_r[r] *= corr[r];
          }
#pragma unroll
          for (int n = 0; n < NT_O; ++n) {
            acc[n][0] *= corr[0];
            acc[n][1] *= corr[0];
            acc[n][2] *= corr[1];
            acc[n][3] *= corr[1];
          }
          // probabilities; a row whose max is still NEG_INF has seen no
          // visible key, and its masked entries count as 0
#pragma unroll
          for (int n = 0; n < NT_S; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              const float pv = m_r[r] == NEG_INF ? 0.f : exp2f(s[n][e] - m_r[r]);
              s[n][e] = pv;
              l_r[r] += pv;
              if (INT8) s[n][e] = pv * svs[slot0 + n * 8 + tig * 2 + (e & 1)];
            }
          }

          // O += P V: score accumulators of n-tiles 2c and 2c+1 are the A
          // fragment of the 16-slot step c (bf16, as the Pallas kernel
          // casts p)
#pragma unroll
          for (int c = 0; c < BN / 16; ++c) {
            uint32_t a[4];
            a[0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
            a[1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
            a[2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
            a[3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
            const int slot = slot0 + c * 16 + tig * 2;
#pragma unroll
            for (int n = 0; n < NT_O; ++n) {
              const int d = n * 8 + g;
              uint32_t bf[2];
              bf[0] = pack_raw(elem_bits<INT8>(sV, SROW_B, slot, d),
                               elem_bits<INT8>(sV, SROW_B, slot + 1, d));
              bf[1] = pack_raw(elem_bits<INT8>(sV, SROW_B, slot + 8, d),
                               elem_bits<INT8>(sV, SROW_B, slot + 9, d));
              mma_16816(acc[n], a, bf);
            }
          }
        }
      }
      __syncthreads();  // the stage is consumed before it is refilled
    }
  }

  // finalize: full row sums over the quad, normalize, store bf16; dead
  // rows (and tiles) store zeros
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = ra + 8 * r;
    if (rr < rows_total) {
      const int t = rr / G;
      const int h = kh * G + rr % G;
      const float inv = live_r[r] && l_r[r] > 0.f ? 1.f / l_r[r] : 0.f;
      __nv_bfloat16* orow = p.o + b * p.o_sb + t * p.o_st + h * p.o_sh + tig * 2;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
      }
    }
  }
}

template <int D, bool INT8, int BN>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int EB = INT8 ? 1 : 2;
  constexpr int SROW_B = D * EB + 16;
  const int smem = TILE_M * (D + 8) * 2 + 4 * PS * SROW_B + (INT8 ? 4 * PS * 4 : 0);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attn_kernel<D, INT8, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.R * p.G + TILE_M - 1) / TILE_M, p.K, p.Bv);
  paged_attn_kernel<D, INT8, BN><<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// head dims 64/80/128/256; D = 256 walks each page in two 32-slot halves to
// keep the score and output fragments in registers
inline cudaError_t dispatch(const Params& p, int D, int int8, cudaStream_t s) {
  if (int8) {
    switch (D) {
      case 64: return launch<64, true, 64>(p, s);
      case 80: return launch<80, true, 64>(p, s);
      case 128: return launch<128, true, 64>(p, s);
      case 256: return launch<256, true, 32>(p, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 64: return launch<64, false, 64>(p, s);
    case 80: return launch<80, false, 64>(p, s);
    case 128: return launch<128, false, 64>(p, s);
    case 256: return launch<256, false, 32>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

// pointers and geometry shared by both entry points
inline Params make_params(const void* q, const void* k, const void* v,
                          const void* ks, const void* vs, void* o,
                          const int* block_table, long long bt_stride,
                          const int* limits, const int* q_lens, const int* modes,
                          int Bv, int R, int H, int K, int max_pages,
                          long long q_sb, long long q_st, long long q_sh,
                          long long o_sb, long long o_st, long long o_sh,
                          int window, float scale) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const unsigned char*>(k);
  p.v = static_cast<const unsigned char*>(v);
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.block_table = block_table;
  p.bt_stride = bt_stride;
  p.limits = limits;
  p.q_lens = q_lens;
  p.modes = modes;
  p.Bv = Bv; p.R = R; p.H = H; p.K = K; p.G = H / K;
  p.max_pages = max_pages;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  p.window = window;
  p.scale_log2 = scale * LOG2E;
  return p;
}

}  // namespace fei_paged

extern "C" const char* fei_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
