// Flash-attention forward for Hopper (sm_90a): the inference primal and,
// with a logsumexp output, the forward of the training path.
//
// Replaces: fei_tpu/ops/pallas/flash_attention.py, the Pallas TPU kernel
// `_fwd_kernel` (:52) reached through `_fwd_impl` (:195) and the public
// `flash_attention` (:598), with save_lse=False (lse pointer null) and
// save_lse=True. The backward kernels are in flash_attention_bwd.cu.
//
// Contract: q [B,T,H,D], k/v [B,S,K,D] (the whole cache buffer), bf16;
// q_start[B], kv_length[B] int32. Key s is visible to the query at
// absolute position p = q_start + t iff s <= p, s < kv_length and, with a
// window, s > p - window. GQA: kv_head = h / (H / K). fp32 online softmax;
// a query row with no live key writes zeros. Output [B,T,H,D] bf16. With a
// non-null `lse` [B,H,T] fp32 the kernel also writes each row's logsumexp
// of its scaled, masked scores in natural-log units (m + log l), and +inf
// for a row with no live key, so that the backward's exp(s - L) is 0
// there. The output's arithmetic does not depend on the pointer.
//
// What bounds it on the H100: at the serving path's prefill shape
// (T = 2048 causal from position 0, H = 32, D = 128) the work is about
// 4*T*(T/2)*D*H = 34 GFLOP against about 42 MB of q, o and live k/v, i.e.
// some 800 FLOP per byte, far above the card's ~295 FLOP/byte ridge: the
// kernel is bound by tensor-core operations, and only wgmma reaches their
// full rate on Hopper.
//
// What the design does about it (D = 64 and D = 128, `flash_fwd_wgmma`):
// a block takes 128 query rows of one head and has three warpgroups. A
// producer warpgroup streams the q tile and then each live 128-key tile of k
// and v into a ring of shared-memory stages with cp.async, each stage
// guarded by a "full" and an "empty" mbarrier, so the next tiles' loads
// overlap the current tile's products. Two consumer warpgroups of 64 rows
// each compute S = Q K^T with wgmma (both operands from shared memory),
// mask and run the online softmax on the accumulator in registers, round
// p to bf16 in place as the A operand of O += P V (wgmma with A from
// registers, V read MN-major), and release the stage. The operands sit in wgmma's 128-byte swizzled layout
// (wgmma.cuh), which a 16-byte cp.async fills directly and wgmma reads
// without bank conflicts. Only tiles that cut the diagonal, kv_length or
// the window are masked. Each block walks only the k tiles from the first to the last live one (the
// Pallas `_kv_index_map` clamp): tiles above the causal diagonal, past
// kv_length or below the window are neither read nor computed. The grid
// starts the heaviest causal q tiles first, so the light tiles fill the
// tail. D = 80 and D = 256 keep the first design (`flash_fwd_mma`: 64-row
// blocks of four warps, mma.sync m16n8k16, single-buffered tiles), chosen
// by an explicit switch on D.
//
// Row invariance: key tiles start at absolute multiples of the tile width
// and are walked in ascending order; a tile with no live key for a row
// gives it a correction factor of exactly 1 and weights of exactly 0, so a
// row's result depends only on its own position and the keys, never on T,
// its place in the q tile or the other rows of the batch. Its bits are not
// always the paged kernels' (K2's mma.sync over 64-key pages; at D = 128 a
// few rows in 10^4 land one bf16 ulp apart), so the scheduler rebuilds a
// preempted prompt through the route that admitted it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_fwd.so flash_attention_fwd.cu
// The Python side (fei_tpu_torch/ops/kernels/flash_attention.py) builds it
// at first use and calls fei_flash_attention_fwd through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int BLOCK_M = 64;                  // query rows per block
constexpr int NUM_WARPS = 4;                 // 16 query rows per warp
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int PAD = 8;                       // bf16 of padding per smem row
constexpr float NEG_INF = -1e30f;            // the Pallas kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;  // [B,H,T] or null
  const int* q_start;
  const int* kv_length;
  int B, T, H, S, K;
  long long q_sb, q_st, q_sh;  // strides in elements; the d stride is 1
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_st, o_sh;
  int window;
  float scale_log2;  // softmax scale * log2(e): the softmax runs on exp2
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(const __nv_bfloat16* lo,
                                             const __nv_bfloat16* hi) {
  uint32_t a = *reinterpret_cast<const uint16_t*>(lo);
  uint32_t b = *reinterpret_cast<const uint16_t*>(hi);
  return a | (b << 16);
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

// Copy rows [row0, row0 + ROWS) of a [rows][D] global matrix into shared
// memory (row stride D + PAD), 16 bytes per thread per step; rows at or
// past row_limit are zero-filled and never read from global memory.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int row0,
                                          int row_limit) {
  constexpr int VEC = 8;
  constexpr int VPR = D / VEC;
  constexpr int SROW = D + PAD;
  for (int i = threadIdx.x; i < ROWS * VPR; i += NUM_THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < row_limit) {
      val = *reinterpret_cast<const uint4*>(base + gr * row_stride + c);
    }
    *reinterpret_cast<uint4*>(smem + r * SROW + c) = val;
  }
}

template <int D, int BLOCK_N>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_fwd_mma(const Params p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static_assert(BLOCK_N % 16 == 0, "key tile must be a multiple of 16");
  constexpr int SROW = D + PAD;
  constexpr int NT_O = D / 8;        // 8-wide n-tiles of the output
  constexpr int NT_S = BLOCK_N / 8;  // 8-wide n-tiles of the score tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BLOCK_M * SROW;
  __nv_bfloat16* sV = sK + BLOCK_N * SROW;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * BLOCK_M;
  const int kvh = h / (p.H / p.K);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row group
  const int tig = lane & 3;  // thread in group

  const int q_start = p.q_start[b];
  const int kv_len = min(p.kv_length[b], p.S);
  const int pos_first = q_start + t0;
  const int pos_last = q_start + min(t0 + BLOCK_M, p.T) - 1;
  // live keys of the whole tile: [lo, hi)
  const int hi = min(pos_last + 1, kv_len);
  const int lo = p.window > 0 ? max(pos_first - p.window + 1, 0) : 0;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + kvh * p.v_sh;
  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;

  // this thread's two query rows within the tile: row_a and row_a + 8
  const int row_a = warp * 16 + g;
  const int pos_r[2] = {pos_first + row_a, pos_first + row_a + 8};

  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  float m_r[2] = {NEG_INF, NEG_INF};  // running max (log2 domain)
  float l_r[2] = {0.f, 0.f};          // this thread's share of the row sum

  if (hi > lo) {  // block-uniform: a tile with no live key writes zeros
    load_tile<D, BLOCK_M>(sQ, qb, p.q_st, t0, p.T);
    const int kt_first = lo / BLOCK_N;
    const int kt_last = (hi - 1) / BLOCK_N;
    for (int kt = kt_first; kt <= kt_last; ++kt) {
      const int k0 = kt * BLOCK_N;
      __syncthreads();  // the previous tile is fully consumed
      load_tile<D, BLOCK_N>(sK, kb, p.k_ss, k0, kv_len);
      load_tile<D, BLOCK_N>(sV, vb, p.v_ss, k0, kv_len);
      __syncthreads();

      // S = Q K^T for this warp's 16 rows against BLOCK_N keys
      float s[NT_S][4];
#pragma unroll
      for (int n = 0; n < NT_S; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        const __nv_bfloat16* q0 = sQ + row_a * SROW + kk + tig * 2;
        const __nv_bfloat16* q8 = q0 + 8 * SROW;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(q0);
        a[1] = *reinterpret_cast<const uint32_t*>(q8);
        a[2] = *reinterpret_cast<const uint32_t*>(q0 + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(q8 + 8);
#pragma unroll
        for (int n = 0; n < NT_S; ++n) {
          const __nv_bfloat16* kr = sK + (n * 8 + g) * SROW + kk + tig * 2;
          uint32_t bf[2];
          bf[0] = *reinterpret_cast<const uint32_t*>(kr);
          bf[1] = *reinterpret_cast<const uint32_t*>(kr + 8);
          mma_16816(s[n], a, bf);
        }
      }

      // mask, scale into the log2 domain, row max over the quad
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int key = k0 + n * 8 + tig * 2 + (e & 1);
          const int pos = pos_r[r];
          const bool ok = key <= pos && key < kv_len &&
                          (p.window <= 0 || key > pos - p.window);
          const float x = ok ? s[n][e] * p.scale_log2 : NEG_INF;
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
      // probabilities; a row whose max is still NEG_INF has seen no live
      // key, and its masked entries must count as 0, not exp2(0)
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float pv = m_r[r] == NEG_INF ? 0.f : exp2f(s[n][e] - m_r[r]);
          s[n][e] = pv;
          l_r[r] += pv;
        }
      }

      // O += P V: the score accumulators of n-tiles 2c and 2c+1 are the A
      // fragment of the 16-key step c (bf16, as the Pallas kernel casts p)
#pragma unroll
      for (int c = 0; c < BLOCK_N / 16; ++c) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
        a[1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
        a[2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
        a[3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
        const __nv_bfloat16* vr = sV + (c * 16 + tig * 2) * SROW + g;
#pragma unroll
        for (int n = 0; n < NT_O; ++n) {
          const __nv_bfloat16* vp = vr + n * 8;
          uint32_t bf[2];
          bf[0] = pack_raw(vp, vp + SROW);
          bf[1] = pack_raw(vp + 8 * SROW, vp + 9 * SROW);
          mma_16816(acc[n], a, bf);
        }
      }
    }
  }

  // finalize: full row sums over the quad, normalize, store bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + row_a + 8 * r;
    if (t < p.T) {
      const float inv = l_r[r] > 0.f ? 1.f / l_r[r] : 0.f;
      __nv_bfloat16* orow = ob + t * p.o_st + tig * 2;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
      }
      if (p.lse != nullptr && tig == 0) {
        // the running max is in the log2 domain: back to natural-log units
        p.lse[((long long)b * p.H + h) * p.T + t] =
            l_r[r] > 0.f ? m_r[r] * LN2 + logf(l_r[r]) : __int_as_float(0x7f800000);
      }
    }
  }
}

template <int D, int BLOCK_N>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  constexpr int SROW = D + PAD;
  const int smem = (BLOCK_M + 2 * BLOCK_N) * SROW * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<D, BLOCK_N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + BLOCK_M - 1) / BLOCK_M, p.H, p.B);
  flash_fwd_mma<D, BLOCK_N><<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------ wgmma design (D 64, 128)

constexpr int WG_BLOCK_M = 128;                 // two consumer warpgroups of 64 rows
constexpr int WG_BLOCK_N = 128;                 // keys per k tile
constexpr int WG_CONSUMERS = 256;
constexpr int WG_PRODUCERS = 128;               // one producer warpgroup
constexpr int WG_THREADS = WG_CONSUMERS + WG_PRODUCERS;

template <int D, int STAGES>
struct WgLayout {
  // q, k and v tiles are D / 64 SW128 panels of [rows][64] (wgmma.cuh)
  static constexpr int Q_PANEL = WG_BLOCK_M * 128;
  static constexpr int KV_PANEL = WG_BLOCK_N * 128;
  static constexpr int Q_BYTES = WG_BLOCK_M * D * 2;
  static constexpr int KV_BYTES = WG_BLOCK_N * D * 2;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;  // k then v
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;  // + alignment
};

// O += P V for one 16-key step, an n64 product per 64-wide panel of V
template <int D>
__device__ __forceinline__ void pv_product(float* o, const uint32_t* a, uint64_t dv,
                                           int panel_bytes) {
  hopper::wgmma_rs_n64<1>(o, a, dv);
  if constexpr (D == 128) hopper::wgmma_rs_n64<1>(o + 32, a, hopper::desc_add(dv, panel_bytes));
}

template <int D, int STAGES>
__global__ void __launch_bounds__(WG_THREADS, 1) flash_fwd_wgmma(const Params p) {
  static_assert(D == 64 || D == 128, "the wgmma design takes D 64 and 128");
  using L = WgLayout<D, STAGES>;
  constexpr int BN = WG_BLOCK_N;
  constexpr int NT_O = D / 8;    // 8-column blocks of the output

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  unsigned char* sQ = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  // the heaviest (last) causal q tiles first; heads of one tile together
  const int n_mt = (p.T + WG_BLOCK_M - 1) / WG_BLOCK_M;
  const int h = blockIdx.x % p.H;
  const int rest = blockIdx.x / p.H;
  const int b = rest % p.B;
  const int t0 = (n_mt - 1 - rest / p.B) * WG_BLOCK_M;
  const int kvh = h / (p.H / p.K);

  const int q_start = p.q_start[b];
  const int kv_len = min(p.kv_length[b], p.S);
  const int pos_first = q_start + t0;
  const int pos_last = q_start + min(t0 + WG_BLOCK_M, p.T) - 1;
  // live keys of the whole tile: [lo, hi)
  const int hi = min(pos_last + 1, kv_len);
  const int lo = p.window > 0 ? max(pos_first - p.window + 1, 0) : 0;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + kvh * p.v_sh;
  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;

  if (hi <= lo) {  // block-uniform: no live key in the tile, zeros
    constexpr int VPR = D / 8;
    for (int i = threadIdx.x; i < WG_BLOCK_M * VPR; i += WG_THREADS) {
      const int t = t0 + i / VPR;
      if (t < p.T) {
        *reinterpret_cast<uint4*>(ob + t * p.o_st + (i % VPR) * 8) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (p.lse != nullptr && threadIdx.x < WG_BLOCK_M && t0 + (int)threadIdx.x < p.T) {
      p.lse[((long long)b * p.H + h) * p.T + t0 + threadIdx.x] = __int_as_float(0x7f800000);
    }
    return;
  }
  const int kt_first = lo / BN;
  const int n_kt = (hi - 1) / BN - kt_first + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], WG_PRODUCERS);     // every producer thread (cp.async)
      hopper::mbar_init(&empty[s], WG_CONSUMERS / 32);  // one arrival per consumer warp
    }
    hopper::mbar_init(qbar, WG_PRODUCERS);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= WG_CONSUMERS) {
    // ---- producer warpgroup: q once, then k/v tiles into the ring
    hopper::reg_dealloc<40>();
    const int tid = threadIdx.x - WG_CONSUMERS;
    hopper::group_load<D, WG_BLOCK_M>(sQ, qb, p.q_st, t0, p.T, tid);
    hopper::cp_async_arrive(qbar);
    for (int i = 0; i < n_kt; ++i) {
      const int s = i % STAGES;
      hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);  // the first pass finds it free
      unsigned char* st = smem + L::Q_BYTES + s * L::STAGE_BYTES;
      const int k0 = (kt_first + i) * BN;
      hopper::group_load<D, BN>(st, kb, p.k_ss, k0, kv_len, tid);
      hopper::group_load<D, BN>(st + L::KV_BYTES, vb, p.v_ss, k0, kv_len, tid);
      hopper::cp_async_arrive(&full[s]);
    }
    hopper::cp_async_wait<0>();
  } else {
    // ---- consumer warpgroups: 64 query rows each
    hopper::reg_alloc<232>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;   // fragment row group
    const int tig = lane & 3;  // thread in group
    const int row_a = wg * 64 + warp * 16 + g;  // this thread's rows: row_a, row_a + 8
    const int pos_r[2] = {pos_first + row_a, pos_first + row_a + 8};

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_r[2] = {NEG_INF, NEG_INF};  // running max (log2 domain)
    float l_r[2] = {0.f, 0.f};          // this thread's share of the row sum

    const uint64_t dq = hopper::make_desc(sQ + wg * 64 * 128, 16, 1024);
    hopper::mbar_wait(qbar, 0);
    for (int i = 0; i < n_kt; ++i) {
      const int s = i % STAGES;
      const int k0 = (kt_first + i) * BN;
      hopper::mbar_wait(&full[s], (i / STAGES) & 1);
      hopper::fence_proxy_async();
      const unsigned char* st = smem + L::Q_BYTES + s * L::STAGE_BYTES;
      const uint64_t dk = hopper::make_desc(st, 16, 1024);                         // K-major
      const uint64_t dv = hopper::make_desc(st + L::KV_BYTES, L::KV_PANEL, 1024);  // MN-major
      // a tile that every row of the block sees whole needs no mask
      const bool whole = k0 + BN - 1 <= pos_first && k0 + BN <= kv_len &&
                         (p.window <= 0 || k0 > pos_last - p.window);

      // S = Q K^T: 64 rows x 128 keys per warpgroup
      float sc[BN / 2];
      hopper::fence_regs<BN / 2>(sc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // the 16-wide k step kk: panel kk / 4, 32 bytes per step within it
        const int ko = (kk & 3) * 32;
        hopper::wgmma_ss_n128<0, 0>(sc, hopper::desc_add(dq, (kk >> 2) * L::Q_PANEL + ko),
                                    hopper::desc_add(dk, (kk >> 2) * L::KV_PANEL + ko), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<BN / 2>(sc);

      // mask (a whole tile: no entry is masked, the same arithmetic),
      // scale into the log2 domain, row max over the quad
      float mx[2] = {NEG_INF, NEG_INF};
      if (whole) {
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) {
          sc[j] *= p.scale_log2;
          mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) {
          const int r = (j >> 1) & 1;
          const int key = k0 + (j >> 2) * 8 + tig * 2 + (j & 1);
          const int pos = pos_r[r];
          const bool ok = key <= pos && key < kv_len &&
                          (p.window <= 0 || key > pos - p.window);
          sc[j] = ok ? sc[j] * p.scale_log2 : NEG_INF;
          mx[r] = fmaxf(mx[r], sc[j]);
        }
      }
      float corr[2], m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        corr[r] = hopper::fast_exp2(m_r[r] - m_new);
        m_r[r] = m_new;
        l_r[r] *= corr[r];
        // a row whose max is still NEG_INF has seen no live key: its
        // masked entries (NEG_INF) must give exp2(NEG_INF - 0) = 0, not 1
        m_use[r] = m_new == NEG_INF ? 0.f : m_new;
      }
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        o[4 * n + 0] *= corr[0];
        o[4 * n + 1] *= corr[0];
        o[4 * n + 2] *= corr[1];
        o[4 * n + 3] *= corr[1];
      }
      // probabilities
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) {
        sc[j] = hopper::fast_exp2(sc[j] - m_use[(j >> 1) & 1]);
        l_r[(j >> 1) & 1] += sc[j];
      }

      // O += P V: the score blocks 2c and 2c+1 are the A fragment of the
      // 16-key step c (bf16, as the Pallas kernel casts p)
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int c = 0; c < BN / 16; ++c) {
        pa[c][0] = pack_bf16(sc[8 * c + 0], sc[8 * c + 1]);
        pa[c][1] = pack_bf16(sc[8 * c + 2], sc[8 * c + 3]);
        pa[c][2] = pack_bf16(sc[8 * c + 4], sc[8 * c + 5]);
        pa[c][3] = pack_bf16(sc[8 * c + 6], sc[8 * c + 7]);
      }
      hopper::fence_regs<D / 2>(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < BN / 16; ++c) {
        pv_product<D>(o, pa[c], hopper::desc_add(dv, c * 2048), L::KV_PANEL);  // 16 keys
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<D / 2>(o);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);  // k and v of this stage are read
    }

    // finalize: full row sums over the quad, normalize, store bf16
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + row_a + 8 * r;
      if (t < p.T) {
        const float inv = l_r[r] > 0.f ? 1.f / l_r[r] : 0.f;
        __nv_bfloat16* orow = ob + t * p.o_st + tig * 2;
#pragma unroll
        for (int n = 0; n < NT_O; ++n) {
          *reinterpret_cast<uint32_t*>(orow + n * 8) =
              pack_bf16(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
        }
        if (p.lse != nullptr && tig == 0) {
          p.lse[((long long)b * p.H + h) * p.T + t] =
              l_r[r] > 0.f ? m_r[r] * LN2 + logf(l_r[r]) : __int_as_float(0x7f800000);
        }
      }
    }
  }
}

template <int D, int STAGES>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  constexpr int smem = WgLayout<D, STAGES>::BYTES;
  cudaError_t err = hopper::allow_smem<flash_fwd_wgmma<D, STAGES>>(smem);
  if (err != cudaSuccess) return err;
  const int blocks = (p.T + WG_BLOCK_M - 1) / WG_BLOCK_M * p.B * p.H;
  flash_fwd_wgmma<D, STAGES><<<blocks, WG_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fei_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const int* q_start, const int* kv_length,
    int B, int T, int H, int S, int K, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    int window, float scale, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.q_start = q_start;
  p.kv_length = kv_length;
  p.B = B; p.T = T; p.H = H; p.S = S; p.K = K;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  p.window = window;
  p.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    // the design each head dim runs (ops/kernels/flash_attention.py
    // DESIGNS says the same)
    case 64: return (int)launch_wgmma<64, 3>(p, s);
    case 80: return (int)launch_mma<80, 64>(p, s);
    case 128: return (int)launch_wgmma<128, 2>(p, s);
    case 256: return (int)launch_mma<256, 32>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fei_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
