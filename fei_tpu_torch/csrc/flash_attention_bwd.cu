// Flash-attention backward for Hopper (sm_90a): two kernels, dq and dk/dv.
//
// Replaces: fei_tpu/ops/pallas/flash_attention.py, the Pallas TPU kernels
// `_dq_kernel` (:275, the pallas_call at :475) and `_dkv_kernel` (:345, the
// pallas_call at :531), both reached through `_bwd_impl` (:424), the
// custom_vjp of `flash_attention`.
//
// Contract: q, dout, dq [B,T,H,D] and k, v, dk, dv [B,S,K,D], bf16 (dq, dk
// and dv contiguous; dout with q's strides); lse and dsum [B,H,T] fp32,
// lse the forward's logsumexp in natural-log units (+inf for a row with no
// live key) and dsum = rowsum(dout * out); q_start[B], kv_length[B] int32.
// Key s is visible to the query at p = q_start + t iff s <= p,
// s < kv_length and, with a window, s > p - window; kv_head = h / (H / K).
// With s_ij = scale * q_i.k_j masked to -1e30 where not visible:
//   p_ij  = exp(s_ij - lse_i)            (0 where masked, 0 where lse = +inf)
//   dp_ij = dout_i . v_j
//   ds_ij = p_ij * (dp_ij - dsum_i)
//   dq_i  = scale * sum_j bf16(ds_ij) k_j
//   dv_j  = sum_i bf16(p_ij) dout_i      (summed over the G heads of a kv head)
//   dk_j  = scale * sum_i bf16(ds_ij) q_i
// — the Pallas kernels' arithmetic, the bf16 roundings of p and ds before
// the products included. Keys at s >= kv_length and keys no query sees get
// dk = dv = 0; rows with lse = +inf get dq = 0.
//
// What bounds them on the H100: at the training shape (T = S = 2048 causal
// from position 0, H = 32, K = 8, D = 128) dq is three products over the
// live half of the score matrix, 6*T*(T/2)*D*H = 51.5 GFLOP, and dk/dv four,
// 68.7 GFLOP, against some 60 MB of operands each: hundreds of FLOP per
// byte, above the card's ~295 FLOP/byte ridge. Both are bound by
// tensor-core operations.
//
// What the design does about it: every product runs on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulate); scores, probabilities and
// ds never leave registers (the accumulators are re-packed in place as the
// A operand of the next product); each block walks only its live tiles.
//  - dq: one block per (64-row q tile, head, batch), four warps of 16 query
//    rows, a loop over the live k tiles (the forward's shape). S = Q K^T and
//    dP = dO V^T share the operand layout; ds.K reads K as a [key][d]
//    B operand through ldmatrix.trans.
//  - dk/dv: one block per (k tile, kv head, batch), looping over the G query
//    heads of the group and over the live q tiles, with dk and dv of the
//    whole group in fp32 registers — the Pallas grid's sequential q axis and
//    the group sum outside it become loops inside the block. It computes
//    S^T = K Q^T and dP^T = V dO^T, so p^T and ds^T are A operands in
//    registers and dO and Q enter as [query][d] B operands (ldmatrix.trans).
//    At D = 256 two warps share 16 keys and split the head dim, so the
//    accumulators fit the register file (they recompute S^T and dP^T).
// Every output element has exactly one writer and a fixed summation order:
// no atomics, so two runs give bitwise the same gradients. It is the simple
// version: single-buffered tiles, 16-byte vector loads, the causal
// imbalance between k tiles left to the block scheduler; wgmma, TMA and a
// pipeline are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_bwd.so flash_attention_bwd.cu
// The Python side (fei_tpu_torch/ops/kernels/flash_attention.py) builds it
// at first use and calls fei_flash_attention_bwd_dq / _dkv through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int PAD = 8;  // bf16 of padding per smem row
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;   // [B,H,T]
  const float* dsum;  // [B,H,T]
  __nv_bfloat16* dq;  // [B,T,H,D], q's strides
  __nv_bfloat16* dk;  // [B,S,K,D] contiguous
  __nv_bfloat16* dv;
  const int* q_start;
  const int* kv_length;
  int B, T, H, S, K;
  long long q_sb, q_st, q_sh;  // strides in elements; the d stride is 1
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int window;
  float scale;
  float scale_log2;  // scale * log2(e): the exponentials run on exp2
};

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
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

// A fragment (16 rows x 16 k) of a row-major [row][k] smem tile: this
// thread's rows are `row` and `row + 8`
template <int SROW>
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* tile,
                                       int row, int kk, int tig) {
  const __nv_bfloat16* r0 = tile + row * SROW + kk + tig * 2;
  const __nv_bfloat16* r8 = r0 + 8 * SROW;
  a[0] = *reinterpret_cast<const uint32_t*>(r0);
  a[1] = *reinterpret_cast<const uint32_t*>(r8);
  a[2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
}

// B fragment (16 k x 8 n) of a [n][k] smem tile (the "col-major" operand of
// X Y^T): n-tile `n`, this thread's column is n * 8 + g
template <int SROW>
__device__ __forceinline__ void load_b(uint32_t* b, const __nv_bfloat16* tile,
                                       int n, int kk, int g, int tig) {
  const __nv_bfloat16* r = tile + (n * 8 + g) * SROW + kk + tig * 2;
  b[0] = *reinterpret_cast<const uint32_t*>(r);
  b[1] = *reinterpret_cast<const uint32_t*>(r + 8);
}

// the accumulators of n-tiles 2c and 2c+1 as the A fragment of 16-wide
// k-step c, rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float (*s)[4], int c) {
  a[0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
  a[1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
  a[2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
  a[3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
}

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// ------------------------------------------------------------------ dq

template <int D, int BLOCK_N>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_bwd_dq_kernel(const Params p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static_assert(BLOCK_N % 16 == 0, "key tile must be a multiple of 16");
  constexpr int BLOCK_M = NUM_WARPS * 16;
  constexpr int SROW = D + PAD;
  constexpr int NT_O = D / 8;        // 8-wide n-tiles of dq
  constexpr int NT_S = BLOCK_N / 8;  // 8-wide n-tiles of the score tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + BLOCK_M * SROW;
  __nv_bfloat16* sK = sdO + BLOCK_M * SROW;
  __nv_bfloat16* sV = sK + BLOCK_N * SROW;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * BLOCK_M;
  const int kvh = h / (p.H / p.K);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row group
  const int tig = lane & 3;  // thread in group
  // ldmatrix row this lane addresses (see ldmatrix_x4_trans)
  const int lm_k = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lm_n = (lane >> 4) * 8;

  const int q_start = p.q_start[b];
  const int kv_len = min(p.kv_length[b], p.S);
  const int pos_first = q_start + t0;
  const int pos_last = q_start + min(t0 + BLOCK_M, p.T) - 1;
  // live keys of the whole tile: [lo, hi)
  const int hi = min(pos_last + 1, kv_len);
  const int lo = p.window > 0 ? max(pos_first - p.window + 1, 0) : 0;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* dob = p.dout + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + kvh * p.v_sh;
  __nv_bfloat16* dqb = p.dq + b * p.q_sb + h * p.q_sh;

  // this thread's two query rows within the tile: row_a and row_a + 8
  const int row_a = warp * 16 + g;
  const int pos_r[2] = {pos_first + row_a, pos_first + row_a + 8};
  float lse_r[2], dsum_r[2];  // lse in the log2 domain
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + row_a + 8 * r;
    const long long idx = ((long long)b * p.H + h) * p.T + t;
    lse_r[r] = t < p.T ? p.lse[idx] * LOG2E : pos_inf();
    dsum_r[r] = t < p.T ? p.dsum[idx] : 0.f;
  }

  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  if (hi > lo) {  // block-uniform: a tile with no live key writes zeros
    load_tile<D, BLOCK_M>(sQ, qb, p.q_st, t0, p.T);
    load_tile<D, BLOCK_M>(sdO, dob, p.q_st, t0, p.T);
    const int kt_first = lo / BLOCK_N;
    const int kt_last = (hi - 1) / BLOCK_N;
    for (int kt = kt_first; kt <= kt_last; ++kt) {
      const int k0 = kt * BLOCK_N;
      __syncthreads();  // the previous tile is fully consumed
      load_tile<D, BLOCK_N>(sK, kb, p.k_ss, k0, kv_len);
      load_tile<D, BLOCK_N>(sV, vb, p.v_ss, k0, kv_len);
      __syncthreads();

      // S = Q K^T and dP = dO V^T for this warp's 16 rows
      float s[NT_S][4], dp[NT_S][4];
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t aq[4], ado[4];
        load_a<SROW>(aq, sQ, row_a, kk, tig);
        load_a<SROW>(ado, sdO, row_a, kk, tig);
#pragma unroll
        for (int n = 0; n < NT_S; ++n) {
          uint32_t bk[2], bv[2];
          load_b<SROW>(bk, sK, n, kk, g, tig);
          load_b<SROW>(bv, sV, n, kk, g, tig);
          mma_16816(s[n], aq, bk);
          mma_16816(dp[n], ado, bv);
        }
      }

      // ds = p * (dp - dsum), p = exp(s*scale - lse): 0 where masked, and
      // 0 for a row whose lse is +inf (exp2 of -inf)
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int key = k0 + n * 8 + tig * 2 + (e & 1);
          const int pos = pos_r[r];
          const bool ok = key <= pos && key < kv_len &&
                          (p.window <= 0 || key > pos - p.window);
          const float pv = ok ? exp2f(s[n][e] * p.scale_log2 - lse_r[r]) : 0.f;
          s[n][e] = pv * (dp[n][e] - dsum_r[r]);
        }
      }

      // dq += bf16(ds) K: the ds accumulators of n-tiles 2c and 2c+1 are the
      // A fragment of the 16-key step c; K enters as a [key][d] B operand
#pragma unroll
      for (int c = 0; c < BLOCK_N / 16; ++c) {
        uint32_t a[4];
        acc_to_a(a, s, c);
#pragma unroll
        for (int j = 0; j < NT_O; j += 2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, sK + (c * 16 + lm_k) * SROW + j * 8 + lm_n);
          mma_16816(acc[j], a, bf);
          mma_16816(acc[j + 1], a, bf + 2);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + row_a + 8 * r;
    if (t < p.T) {
      __nv_bfloat16* row = dqb + t * p.q_st + tig * 2;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        *reinterpret_cast<uint32_t*>(row + n * 8) =
            pack_bf16(acc[n][2 * r] * p.scale, acc[n][2 * r + 1] * p.scale);
      }
    }
  }
}

// --------------------------------------------------------------- dk, dv

// BLOCK_N keys per block, BLOCK_M queries per step; DSPLIT warps share a
// group of 16 keys and split the head dim between them
template <int D, int BLOCK_N, int BLOCK_M, int DSPLIT>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_bwd_dkv_kernel(const Params p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static_assert(BLOCK_M % 16 == 0, "query tile must be a multiple of 16");
  static_assert(BLOCK_N == (NUM_WARPS / DSPLIT) * 16, "16 keys per warp group");
  static_assert((D / DSPLIT) % 16 == 0, "n-tile pairs per warp");
  constexpr int SROW = D + PAD;
  constexpr int DW = D / DSPLIT;     // head-dim columns this warp owns
  constexpr int NT_O = DW / 8;       // 8-wide n-tiles of dk and dv
  constexpr int NT_S = BLOCK_M / 8;  // 8-wide n-tiles of the S^T tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + BLOCK_N * SROW;
  __nv_bfloat16* sQ = sV + BLOCK_N * SROW;
  __nv_bfloat16* sdO = sQ + BLOCK_M * SROW;
  float* sL = reinterpret_cast<float*>(sdO + BLOCK_M * SROW);  // lse, log2 domain
  float* sD = sL + BLOCK_M;                                    // dsum

  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int k0 = blockIdx.x * BLOCK_N;
  const int G = p.H / p.K;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int lm_k = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lm_n = (lane >> 4) * 8;
  const int d0 = (warp % DSPLIT) * DW;

  const int q_start = p.q_start[b];
  const int kv_len = min(p.kv_length[b], p.S);

  // this thread's two key rows within the tile: row_a and row_a + 8
  const int row_a = (warp / DSPLIT) * 16 + g;
  const int key_r[2] = {k0 + row_a, k0 + row_a + 8};

  float dk[NT_O][4], dv[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  // live queries of the whole key tile: [t_lo, t_hi]. The first query that
  // reaches the tile's first key causally; with a window, the last query
  // whose window still holds the tile's last valid key.
  const int k_last = min(k0 + BLOCK_N, kv_len) - 1;
  const int t_lo = max(k0 - q_start, 0);
  int t_hi = p.T - 1;
  if (p.window > 0) t_hi = min(t_hi, k_last + p.window - 1 - q_start);

  if (k0 < kv_len && t_lo <= t_hi) {  // block-uniform
    const __nv_bfloat16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
    const __nv_bfloat16* vb = p.v + b * p.v_sb + kvh * p.v_sh;
    load_tile<D, BLOCK_N>(sK, kb, p.k_ss, k0, kv_len);
    load_tile<D, BLOCK_N>(sV, vb, p.v_ss, k0, kv_len);
    const int qt_first = t_lo / BLOCK_M;
    const int qt_last = t_hi / BLOCK_M;
    for (int gi = 0; gi < G; ++gi) {
      const int h = kvh * G + gi;
      const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
      const __nv_bfloat16* dob = p.dout + b * p.q_sb + h * p.q_sh;
      const long long stat0 = ((long long)b * p.H + h) * p.T;
      for (int qt = qt_first; qt <= qt_last; ++qt) {
        const int q0 = qt * BLOCK_M;
        __syncthreads();  // the previous tile is fully consumed
        load_tile<D, BLOCK_M>(sQ, qb, p.q_st, q0, p.T);
        load_tile<D, BLOCK_M>(sdO, dob, p.q_st, q0, p.T);
        for (int i = threadIdx.x; i < BLOCK_M; i += NUM_THREADS) {
          const int t = q0 + i;
          sL[i] = t < p.T ? p.lse[stat0 + t] * LOG2E : pos_inf();
          sD[i] = t < p.T ? p.dsum[stat0 + t] : 0.f;
        }
        __syncthreads();

        // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys
        float st[NT_S][4], dpt[NT_S][4];
#pragma unroll
        for (int n = 0; n < NT_S; ++n) {
          st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
          dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < D; kk += 16) {
          uint32_t ak[4], av[4];
          load_a<SROW>(ak, sK, row_a, kk, tig);
          load_a<SROW>(av, sV, row_a, kk, tig);
#pragma unroll
          for (int n = 0; n < NT_S; ++n) {
            uint32_t bq[2], bdo[2];
            load_b<SROW>(bq, sQ, n, kk, g, tig);
            load_b<SROW>(bdo, sdO, n, kk, g, tig);
            mma_16816(st[n], ak, bq);
            mma_16816(dpt[n], av, bdo);
          }
        }

        // p^T and ds^T: row = key, column = query
#pragma unroll
        for (int n = 0; n < NT_S; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n * 8 + tig * 2 + (e & 1);
            const int key = key_r[e >> 1];
            const int pos = q_start + q0 + col;
            const bool ok = q0 + col < p.T && key <= pos && key < kv_len &&
                            (p.window <= 0 || key > pos - p.window);
            const float pv = ok ? exp2f(st[n][e] * p.scale_log2 - sL[col]) : 0.f;
            st[n][e] = pv;
            dpt[n][e] = pv * (dpt[n][e] - sD[col]);
          }
        }

        // dv += bf16(p^T) dO and dk += bf16(ds^T) Q: the accumulators of
        // n-tiles 2c and 2c+1 are the A fragment of the 16-query step c;
        // dO and Q enter as [query][d] B operands
#pragma unroll
        for (int c = 0; c < BLOCK_M / 16; ++c) {
          uint32_t ap[4], ads[4];
          acc_to_a(ap, st, c);
          acc_to_a(ads, dpt, c);
#pragma unroll
          for (int j = 0; j < NT_O; j += 2) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, sdO + (c * 16 + lm_k) * SROW + d0 + j * 8 + lm_n);
            mma_16816(dv[j], ap, bf);
            mma_16816(dv[j + 1], ap, bf + 2);
            ldmatrix_x4_trans(bf, sQ + (c * 16 + lm_k) * SROW + d0 + j * 8 + lm_n);
            mma_16816(dk[j], ads, bf);
            mma_16816(dk[j + 1], ads, bf + 2);
          }
        }
      }
    }
  }

  // dk, dv are contiguous [B,S,K,D]; every row below S is written (zeros for
  // a key past kv_length or one no query sees)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = key_r[r];
    if (s < p.S) {
      const long long off =
          (((long long)b * p.S + s) * p.K + kvh) * D + d0 + tig * 2;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        *reinterpret_cast<uint32_t*>(p.dk + off + n * 8) =
            pack_bf16(dk[n][2 * r] * p.scale, dk[n][2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(p.dv + off + n * 8) =
            pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
      }
    }
  }
}

template <int D, int BLOCK_N>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  constexpr int BLOCK_M = NUM_WARPS * 16;
  constexpr int SROW = D + PAD;
  const int smem = 2 * (BLOCK_M + BLOCK_N) * SROW * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, BLOCK_N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + BLOCK_M - 1) / BLOCK_M, p.H, p.B);
  flash_bwd_dq_kernel<D, BLOCK_N><<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int BLOCK_N, int BLOCK_M, int DSPLIT>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr int SROW = D + PAD;
  const int smem = 2 * (BLOCK_M + BLOCK_N) * SROW * (int)sizeof(__nv_bfloat16) +
                   2 * BLOCK_M * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, BLOCK_N, BLOCK_M, DSPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BLOCK_N - 1) / BLOCK_N, p.K, p.B);
  flash_bwd_dkv_kernel<D, BLOCK_N, BLOCK_M, DSPLIT>
      <<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* dsum, void* dq, void* dk, void* dv,
                   const int* q_start, const int* kv_length,
                   int B, int T, int H, int S, int K,
                   long long q_sb, long long q_st, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh,
                   int window, float scale) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.dsum = static_cast<const float*>(dsum);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.q_start = q_start;
  p.kv_length = kv_length;
  p.B = B; p.T = T; p.H = H; p.S = S; p.K = K;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.window = window;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  return p;
}

}  // namespace

// dq [B,T,H,D] (q's strides) from q, k, v, dout, lse and dsum
extern "C" int fei_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, void* dq,
    const int* q_start, const int* kv_length,
    int B, int T, int H, int S, int K, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int window, float scale, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, dsum, dq, nullptr, nullptr,
                               q_start, kv_length, B, T, H, S, K,
                               q_sb, q_st, q_sh, k_sb, k_ss, k_sh,
                               v_sb, v_ss, v_sh, window, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_dq<64, 64>(p, s);
    case 80: return (int)launch_dq<80, 64>(p, s);
    case 128: return (int)launch_dq<128, 64>(p, s);
    case 256: return (int)launch_dq<256, 32>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dk, dv [B,S,K,D] (contiguous) from the same inputs
extern "C" int fei_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, void* dk, void* dv,
    const int* q_start, const int* kv_length,
    int B, int T, int H, int S, int K, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int window, float scale, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, dsum, nullptr, dk, dv,
                               q_start, kv_length, B, T, H, S, K,
                               q_sb, q_st, q_sh, k_sb, k_ss, k_sh,
                               v_sb, v_ss, v_sh, window, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_dkv<64, 64, 64, 1>(p, s);
    case 80: return (int)launch_dkv<80, 64, 64, 1>(p, s);
    case 128: return (int)launch_dkv<128, 64, 32, 1>(p, s);
    case 256: return (int)launch_dkv<256, 32, 32, 2>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fei_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
