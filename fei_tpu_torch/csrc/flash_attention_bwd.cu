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
// What the design does about it (D = 64 and D = 128, the wgmma kernels):
// every product runs on wgmma from operands in the 128-byte swizzled
// layout of wgmma.cuh, which a 16-byte cp.async fills directly; a producer
// warpgroup streams the tiles into a ring of shared-memory stages guarded
// by "full" and "empty" mbarriers, so the next tiles' loads overlap the
// current products; scores, probabilities and ds never leave registers
// (the accumulators are rounded to bf16 in place as the register A operand
// of the next product); each block walks only its live tiles, and only
// tiles that cut the diagonal, kv_length, T or the window are masked.
//  - dq (`flash_bwd_dq_wgmma`): a block takes 128 query rows of one head,
//    two consumer warpgroups of 64 rows. The producer loads the q and dO
//    tiles once, then each live 128-key k/v tile. S = Q K^T and
//    dP = dO V^T are wgmma with both operands in shared memory (K-major
//    over d); dq += bf16(dS) K takes dS from registers and reads the same
//    K tile MN-major. The two consumer warpgroups issue S and dP in turns
//    (two named barriers, FA3's ping-pong), so one's exponentials run
//    beside the other's products. The grid starts the heaviest causal q
//    tiles first.
//  - dk/dv (`flash_bwd_dkv_wgmma`): a cluster of C CTAs takes a 128-key
//    tile of one kv head; in each CTA consumer warpgroup w holds keys
//    64w .. 64w + 63 with dk and dv in fp32 registers. The tile's work is
//    a list of (query head of the group, 64-row q tile) steps in a fixed
//    order, and CTA r takes the steps i with i % C == r; for each step its
//    producer streams Q, dO, lse and dsum once for both warpgroups (128
//    keys per q tile loaded: the loads are what bounds a 64-key tile).
//    S^T = K Q^T and dP^T = V dO^T are wgmma from shared memory, p^T and
//    ds^T are rounded in registers as the A operand of dv += P^T dO and
//    dk += dS^T Q, which read the dO and Q tiles MN-major (two descriptors
//    on the tiles the first two products read K-major); a warpgroup skips
//    a step in which it sees no key. The CTAs' sums then meet in a tree
//    fixed by C: at stride 1, 2, 4 CTA r + stride stores its dk, then its
//    dv, into CTA r's k and v tiles through distributed shared memory
//    (each after CTA r has signalled that the area is free) and CTA r adds
//    them to its own; CTA 0 writes the tile. C is 2, or 4 or 8 where all
//    the clusters of one batch row still fit on the card at once (a short
//    sequence or few kv heads would leave most SMs idle). Causal balance:
//    a cluster takes 128-key tile j and then tile n - 1 - j, so with T = S
//    from position 0 every CTA walks the same number of steps (at the
//    training shape, C = 2: 34 q tiles of the pair times 4 heads, halved:
//    68), where one tile a block would leave the blocks next to position 0
//    with twice the mean.
// D = 80 and D = 256 keep the first design, chosen by an explicit switch on
// D (`flash_bwd_dq_kernel`, `flash_bwd_dkv_kernel`: four warps, mma.sync
// m16n8k16, single-buffered tiles; at D = 256 two warps share 16 keys and
// split the head dim so the accumulators fit the register file). Every
// output element has exactly one writer and a summation order fixed by the
// shape, q_start, kv_length, the window and (dk/dv's cluster size) the
// card alone: no atomics, so two runs give bitwise the same gradients, and
// a batch row's gradients do not depend on the other rows.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_bwd.so flash_attention_bwd.cu
// The Python side (fei_tpu_torch/ops/kernels/flash_attention.py) builds it
// at first use and calls fei_flash_attention_bwd_dq / _dkv through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

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
  int* steps;        // dk/dv wgmma, optional: the steps each CTA walked
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

  extern __shared__ __align__(128) unsigned char smem_raw[];
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

  extern __shared__ __align__(128) unsigned char smem_raw[];
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

// ------------------------------------------------ wgmma design (D 64, 128)

constexpr int WG_CONSUMERS = 256;  // two consumer warpgroups
constexpr int WG_PRODUCERS = 128;  // one producer warpgroup
constexpr int WG_THREADS = WG_CONSUMERS + WG_PRODUCERS;
constexpr int DQ_BLOCK_M = 128;    // query rows of a dq block, 64 per consumer
constexpr int DQ_BLOCK_N = 128;    // keys of a dq k/v tile
constexpr int PING = 2;            // dq's named barriers: PING (first warpgroup's turn), PING + 1
constexpr int DKV_KEYS = 128;      // keys of a dk/dv tile, 64 per consumer
constexpr int DKV_STEP = 64;       // query rows of a dk/dv step

// d[64 x D] += A[64 x 16] (registers) * B[16 x D], B a [row][d] tile read
// MN-major: one n64 product per 64-wide panel of d
template <int D>
__device__ __forceinline__ void rs_product(float* d, const uint32_t* a, uint64_t db,
                                           int panel_bytes) {
  hopper::wgmma_rs_n64<1>(d, a, db);
  if constexpr (D == 128) hopper::wgmma_rs_n64<1>(d + 32, a, hopper::desc_add(db, panel_bytes));
}

// the accumulator blocks 2c and 2c+1 of an m64nN tile as the A fragment of
// the 16-wide k step c, rounded to bf16
template <int N>
__device__ __forceinline__ void acc_to_frags(uint32_t (*a)[4], const float* x) {
#pragma unroll
  for (int c = 0; c < N / 16; ++c) {
    a[c][0] = pack_bf16(x[8 * c + 0], x[8 * c + 1]);
    a[c][1] = pack_bf16(x[8 * c + 2], x[8 * c + 3]);
    a[c][2] = pack_bf16(x[8 * c + 4], x[8 * c + 5]);
    a[c][3] = pack_bf16(x[8 * c + 6], x[8 * c + 7]);
  }
}

template <int D, int STAGES>
struct DqLayout {
  static constexpr int Q_PANEL = DQ_BLOCK_M * 128;  // one 64-wide d panel of q or dO
  static constexpr int KV_PANEL = DQ_BLOCK_N * 128;
  static constexpr int Q_BYTES = DQ_BLOCK_M * D * 2;
  static constexpr int KV_BYTES = DQ_BLOCK_N * D * 2;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;  // k then v
  static constexpr int STAGE_OFF = 2 * Q_BYTES;     // q, dO, then the stages
  static constexpr int BAR_OFF = STAGE_OFF + STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;  // + alignment
};

template <int D, int STAGES>
__global__ void __launch_bounds__(WG_THREADS, 1) flash_bwd_dq_wgmma(const Params p) {
  static_assert(D == 64 || D == 128, "the wgmma design takes D 64 and 128");
  using L = DqLayout<D, STAGES>;
  constexpr int BN = DQ_BLOCK_N;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sdO = smem + L::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  // the heaviest (last) causal q tiles first; heads of one tile together
  const int n_mt = (p.T + DQ_BLOCK_M - 1) / DQ_BLOCK_M;
  const int h = blockIdx.x % p.H;
  const int rest = blockIdx.x / p.H;
  const int b = rest % p.B;
  const int t0 = (n_mt - 1 - rest / p.B) * DQ_BLOCK_M;
  const int kvh = h / (p.H / p.K);

  const int q_start = p.q_start[b];
  const int kv_len = min(p.kv_length[b], p.S);
  const int pos_first = q_start + t0;
  const int pos_last = q_start + min(t0 + DQ_BLOCK_M, p.T) - 1;
  // live keys of the whole tile: [lo, hi)
  const int hi = min(pos_last + 1, kv_len);
  const int lo = p.window > 0 ? max(pos_first - p.window + 1, 0) : 0;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* dob = p.dout + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + kvh * p.v_sh;
  __nv_bfloat16* dqb = p.dq + b * p.q_sb + h * p.q_sh;

  if (hi <= lo) {  // block-uniform: no live key in the tile, zeros
    constexpr int VPR = D / 8;
    for (int i = threadIdx.x; i < DQ_BLOCK_M * VPR; i += WG_THREADS) {
      const int t = t0 + i / VPR;
      if (t < p.T) {
        *reinterpret_cast<uint4*>(dqb + t * p.q_st + (i % VPR) * 8) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }
  const int kt_first = lo / BN;
  const int n_kt = (hi - 1) / BN - kt_first + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], WG_PRODUCERS);        // every producer thread (cp.async)
      hopper::mbar_init(&empty[s], WG_CONSUMERS / 32);  // one arrival per consumer warp
    }
    hopper::mbar_init(qbar, WG_PRODUCERS);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= WG_CONSUMERS) {
    // ---- producer warpgroup: q and dO once, then k/v tiles into the ring
    hopper::reg_dealloc<40>();
    const int tid = threadIdx.x - WG_CONSUMERS;
    hopper::group_load<D, DQ_BLOCK_M>(sQ, qb, p.q_st, t0, p.T, tid);
    hopper::group_load<D, DQ_BLOCK_M>(sdO, dob, p.q_st, t0, p.T, tid);
    hopper::cp_async_arrive(qbar);
    for (int i = 0; i < n_kt; ++i) {
      const int s = i % STAGES;
      hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);  // the first pass finds it free
      unsigned char* st = smem + L::STAGE_OFF + s * L::STAGE_BYTES;
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
    float lse_r[2], dsum_r[2];  // lse in the log2 domain; +inf past T
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + row_a + 8 * r;
      const long long idx = ((long long)b * p.H + h) * p.T + t;
      lse_r[r] = t < p.T ? p.lse[idx] * LOG2E : pos_inf();
      dsum_r[r] = t < p.T ? p.dsum[idx] : 0.f;
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    const uint64_t dq_desc = hopper::make_desc(sQ + wg * 64 * 128, 16, 1024);
    const uint64_t do_desc = hopper::make_desc(sdO + wg * 64 * 128, 16, 1024);
    hopper::mbar_wait(qbar, 0);
    if (wg == 1) hopper::named_arrive(PING, WG_CONSUMERS);  // the first turn is the first's
    for (int i = 0; i < n_kt; ++i) {
      const int s = i % STAGES;
      const int k0 = (kt_first + i) * BN;
      hopper::mbar_wait(&full[s], (i / STAGES) & 1);
      hopper::fence_proxy_async();
      const unsigned char* st = smem + L::STAGE_OFF + s * L::STAGE_BYTES;
      const uint64_t k_desc = hopper::make_desc(st, 16, 1024);                   // K-major
      const uint64_t v_desc = hopper::make_desc(st + L::KV_BYTES, 16, 1024);     // K-major
      const uint64_t kmn_desc = hopper::make_desc(st, L::KV_PANEL, 1024);        // MN-major
      // a tile that every row of the block sees whole needs no mask
      const bool whole = k0 + BN - 1 <= pos_first && k0 + BN <= kv_len &&
                         (p.window <= 0 || k0 > pos_last - p.window);

      // S = Q K^T and dP = dO V^T: 64 rows x BN keys per warpgroup, two
      // groups, issued in turns with the other warpgroup (ping-pong: one
      // warpgroup's exponentials run beside the other's products)
      float sc[BN / 2], dp[BN / 2];
      hopper::fence_regs<BN / 2>(sc);
      hopper::fence_regs<BN / 2>(dp);
      hopper::named_sync(PING + wg, WG_CONSUMERS);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // the 16-wide k step kk: panel kk / 4, 32 bytes per step within it
        const int ko = (kk & 3) * 32;
        hopper::wgmma_ss_n128<0, 0>(sc, hopper::desc_add(dq_desc, (kk >> 2) * L::Q_PANEL + ko),
                                    hopper::desc_add(k_desc, (kk >> 2) * L::KV_PANEL + ko), kk > 0);
      }
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int ko = (kk & 3) * 32;
        hopper::wgmma_ss_n128<0, 0>(dp, hopper::desc_add(do_desc, (kk >> 2) * L::Q_PANEL + ko),
                                    hopper::desc_add(v_desc, (kk >> 2) * L::KV_PANEL + ko), kk > 0);
      }
      hopper::wgmma_commit();
      if (wg == 0 || i + 1 < n_kt) hopper::named_arrive(PING + 1 - wg, WG_CONSUMERS);

      // p = exp(s*scale - lse) while dP is in flight: 0 where masked, and 0
      // for a row whose lse is +inf (exp2 of -inf)
      hopper::wgmma_wait<1>();
      hopper::fence_regs<BN / 2>(sc);
      if (whole) {
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) {
          sc[j] = hopper::fast_exp2(fmaf(sc[j], p.scale_log2, -lse_r[(j >> 1) & 1]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) {
          const int r = (j >> 1) & 1;
          const int key = k0 + (j >> 2) * 8 + tig * 2 + (j & 1);
          const int pos = pos_r[r];
          const bool ok = key <= pos && key < kv_len &&
                          (p.window <= 0 || key > pos - p.window);
          sc[j] = ok ? hopper::fast_exp2(fmaf(sc[j], p.scale_log2, -lse_r[r])) : 0.f;
        }
      }
      // ds = p * (dp - dsum), rounded to bf16 as the A operand of ds.K
      hopper::wgmma_wait<0>();
      hopper::fence_regs<BN / 2>(dp);
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) sc[j] = sc[j] * (dp[j] - dsum_r[(j >> 1) & 1]);
      uint32_t da[BN / 16][4];
      acc_to_frags<BN>(da, sc);

      // dq += bf16(dS) K: K read MN-major from the tile S read K-major
      hopper::fence_regs<D / 2>(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < BN / 16; ++c) {
        rs_product<D>(acc, da[c], hopper::desc_add(kmn_desc, c * 2048), L::KV_PANEL);  // 16 keys
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<D / 2>(acc);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);  // k and v of this stage are read
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + row_a + 8 * r;
      if (t < p.T) {
        __nv_bfloat16* row = dqb + t * p.q_st + tig * 2;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          *reinterpret_cast<uint32_t*>(row + n * 8) =
              pack_bf16(acc[4 * n + 2 * r] * p.scale, acc[4 * n + 2 * r + 1] * p.scale);
        }
      }
    }
  }
}

template <int D, int STAGES>
struct DkvLayout {
  static constexpr int Q_PANEL = DKV_STEP * 128;   // one 64-wide d panel of a q or dO tile
  static constexpr int KV_PANEL = DKV_KEYS * 128;  // one 64-wide d panel of the k or v tile
  static constexpr int Q_BYTES = DKV_STEP * D * 2;
  static constexpr int KV_BYTES = DKV_KEYS * D * 2;
  static constexpr int STAGE_OFF = 2 * KV_BYTES;   // k, v, then the stages (q, dO)
  static constexpr int STAGE_BYTES = 2 * Q_BYTES;
  static constexpr int STAT_OFF = STAGE_OFF + STAGES * STAGE_BYTES;  // lse, dsum per stage
  static constexpr int BAR_OFF = STAT_OFF + STAGES * 2 * DKV_STEP * 4;
  static constexpr int BYTES = BAR_OFF + (2 * STAGES + 4) * 8 + 1024;  // + alignment
  // the second CTA's dk, then dv, reach the first through the first's k and
  // v tiles once they are read: D / 2 floats for each consumer thread
  static_assert(WG_CONSUMERS * (D / 2) * 4 == 2 * KV_BYTES, "the exchange fills k and v");
};

// the (head, q tile) steps of one 128-key tile: live iff some query sees
// one of its keys; step i is head i / n_q of the group and q tile
// qt_first + i % n_q
struct KeyTile {
  int k0, qt_first, n_q;
  bool live;
};

__device__ __forceinline__ KeyTile key_tile(const Params& p, int tile, int q_start,
                                            int kv_len) {
  KeyTile kt;
  kt.k0 = tile * DKV_KEYS;
  // the first query that reaches the tile's first key causally; with a
  // window, the last query whose window still holds its last valid key
  const int k_last = min(kt.k0 + DKV_KEYS, kv_len) - 1;
  const int t_lo = max(kt.k0 - q_start, 0);
  int t_hi = p.T - 1;
  if (p.window > 0) t_hi = min(t_hi, k_last + p.window - 1 - q_start);
  kt.live = kt.k0 < kv_len && t_lo <= t_hi;
  kt.qt_first = t_lo / DKV_STEP;
  kt.n_q = kt.live ? t_hi / DKV_STEP - kt.qt_first + 1 : 0;
  return kt;
}

// the cluster's exchange of partial dk or dv: a sending CTA stores a
// thread's D / 2 sums as float4s at slots slot + 128 m of the receiving
// CTA's exchange area, which adds them to its own in the same order
template <int D>
__device__ __forceinline__ void send_part(const float (&x)[D / 2], uint32_t peer, int slot) {
#pragma unroll
  for (int m = 0; m < D / 8; ++m) {
    hopper::st_cluster_v4(peer + ((slot + 128 * m) << 4),
                          make_float4(x[4 * m], x[4 * m + 1], x[4 * m + 2], x[4 * m + 3]));
  }
}

template <int D>
__device__ __forceinline__ void add_part(float (&x)[D / 2], const float4* xch, int slot) {
#pragma unroll
  for (int m = 0; m < D / 8; ++m) {
    const float4 v = xch[slot + 128 * m];
    x[4 * m] += v.x;
    x[4 * m + 1] += v.y;
    x[4 * m + 2] += v.z;
    x[4 * m + 3] += v.w;
  }
}

// a receiving CTA's turn in the exchange: every consumer thread is done
// with the exchange area (k and v, or the previous partial sums), the
// sender `peer_xready` may store, and they have landed
__device__ __forceinline__ void take_turn(uint32_t peer_xready, uint64_t* xfull, int& rx) {
  hopper::named_sync(1, WG_CONSUMERS);
  if (threadIdx.x == 0) hopper::mbar_arrive_cluster(peer_xready);
  hopper::mbar_wait_cluster(xfull, rx & 1);
  ++rx;
}

template <int D, int STAGES, int C>
__global__ void __launch_bounds__(WG_THREADS, 1) flash_bwd_dkv_wgmma(const Params p) {
  static_assert(D == 64 || D == 128, "the wgmma design takes D 64 and 128");
  using L = DkvLayout<D, STAGES>;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  unsigned char* sK = smem;
  unsigned char* sV = smem + L::KV_BYTES;
  float* sStat = reinterpret_cast<float*>(smem + L::STAT_OFF);  // [stage][lse 64, dsum 64]
  float4* xch = reinterpret_cast<float4*>(smem);  // over k and v, once they are read
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_full = empty + STAGES;
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* xfull = kv_empty + 1;   // receiver: the sender's partial sums have landed
  uint64_t* xready = xfull + 1;     // sender: the receiver can take the next partial sums

  // a cluster of C CTAs = (pair j, kv head, batch row): key tiles j and
  // n - 1 - j; CTA r takes the steps i with i % C == r of each
  const int rank = (int)hopper::cluster_rank();
  const int n_kt = (p.S + DKV_KEYS - 1) / DKV_KEYS;
  const int unit = blockIdx.x / C;
  const int kvh = unit % p.K;
  const int rest = unit / p.K;
  const int b = rest % p.B;
  const int j = rest / p.B;
  const int n_tiles = n_kt - 1 - j == j ? 1 : 2;
  const int G = p.H / p.K;

  const int q_start = p.q_start[b];
  const int kv_len = min(p.kv_length[b], p.S);
  const __nv_bfloat16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + kvh * p.v_sh;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], WG_PRODUCERS);
      hopper::mbar_init(&empty[s], WG_CONSUMERS / 32);  // one arrival per consumer warp
    }
    hopper::mbar_init(kv_full, WG_PRODUCERS);
    hopper::mbar_init(kv_empty, WG_CONSUMERS / 32);
    hopper::mbar_init(xfull, WG_CONSUMERS);  // every consumer thread of the sender
    hopper::mbar_init(xready, 1);            // one thread of the receiver
    hopper::mbar_init_fence();
  }
  hopper::cluster_sync();  // the barriers of both CTAs are set before either reaches the other

  if (threadIdx.x >= WG_CONSUMERS) {
    // ---- producer warpgroup: per live key tile its k and v, then this
    // CTA's steps' q, dO, lse and dsum into the ring
    hopper::reg_dealloc<40>();
    const int tid = threadIdx.x - WG_CONSUMERS;
    int c = 0, n_live = 0;
    for (int tt = 0; tt < n_tiles; ++tt) {
      const KeyTile kt = key_tile(p, tt == 0 ? j : n_kt - 1 - j, q_start, kv_len);
      if (!kt.live) continue;
      if (n_live > 0) hopper::mbar_wait(kv_empty, (n_live - 1) & 1);
      hopper::group_load<D, DKV_KEYS>(sK, kb, p.k_ss, kt.k0, kv_len, tid);
      hopper::group_load<D, DKV_KEYS>(sV, vb, p.v_ss, kt.k0, kv_len, tid);
      hopper::cp_async_arrive(kv_full);
      for (int i = rank; i < G * kt.n_q; i += C, ++c) {
        const int s = c % STAGES;
        hopper::mbar_wait(&empty[s], ((c / STAGES) & 1) ^ 1);  // the first pass finds it free
        const int hq = kvh * G + i / kt.n_q;
        const int q0 = (kt.qt_first + i % kt.n_q) * DKV_STEP;
        unsigned char* st = smem + L::STAGE_OFF + s * L::STAGE_BYTES;
        hopper::group_load<D, DKV_STEP>(st, p.q + b * p.q_sb + hq * p.q_sh, p.q_st, q0, p.T, tid);
        hopper::group_load<D, DKV_STEP>(st + L::Q_BYTES, p.dout + b * p.q_sb + hq * p.q_sh, p.q_st, q0,
                                p.T, tid);
        // threads 0-63 copy the rows' lse, 64-127 their dsum (0 past T)
        const int r = tid & (DKV_STEP - 1);
        const float* src = (tid < DKV_STEP ? p.lse : p.dsum) +
                           ((long long)b * p.H + hq) * p.T + q0 + r;
        hopper::cp_async4(sStat + s * 2 * DKV_STEP + tid, q0 + r < p.T ? src : p.lse,
                          q0 + r < p.T ? 4 : 0);
        hopper::cp_async_arrive(&full[s]);
      }
      ++n_live;
    }
    hopper::cp_async_wait<0>();
    hopper::cluster_sync();  // no CTA leaves while another may reach its memory
  } else {
    // ---- consumer warpgroups: 64 keys each, every step of this CTA
    hopper::reg_alloc<232>();
    const int wg = threadIdx.x / 128;
    const int wtid = threadIdx.x & 127;
    const int warp = wtid / 32;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    const int row_a = wg * 64 + warp * 16 + g;  // this thread's keys in the tile: row_a, row_a + 8
    const uint64_t k_desc = hopper::make_desc(sK + wg * 64 * 128, 16, 1024);  // K-major A
    const uint64_t v_desc = hopper::make_desc(sV + wg * 64 * 128, 16, 1024);
    int c = 0, n_live = 0;
    for (int tt = 0; tt < n_tiles; ++tt) {
      const KeyTile kt = key_tile(p, tt == 0 ? j : n_kt - 1 - j, q_start, kv_len);
      if (!kt.live) {
        // a key tile that no query sees (or past kv_length): zeros
        if (rank == 0) {
          constexpr int VPR = D / 8;
          for (int i = threadIdx.x; i < DKV_KEYS * VPR; i += WG_CONSUMERS) {
            const int s = kt.k0 + i / VPR;
            if (s < p.S) {
              const long long off = (((long long)b * p.S + s) * p.K + kvh) * D + (i % VPR) * 8;
              *reinterpret_cast<uint4*>(p.dk + off) = make_uint4(0u, 0u, 0u, 0u);
              *reinterpret_cast<uint4*>(p.dv + off) = make_uint4(0u, 0u, 0u, 0u);
            }
          }
        }
        continue;
      }
      const int kw0 = kt.k0 + wg * 64;  // this warpgroup's first key
      const int key_r[2] = {kt.k0 + row_a, kt.k0 + row_a + 8};
      float dk[D / 2], dv[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
      hopper::mbar_wait(kv_full, n_live & 1);
      hopper::fence_proxy_async();
      const int n_steps = G * kt.n_q;
      for (int i = rank; i < n_steps; i += C, ++c) {
        const int s = c % STAGES;
        const int q0 = (kt.qt_first + i % kt.n_q) * DKV_STEP;
        const int pos0 = q_start + q0;  // the step's first query position
        hopper::mbar_wait(&full[s], (c / STAGES) & 1);
        // a step none of whose (key, query) pairs is visible adds nothing
        const bool none = kw0 >= kv_len || kw0 > pos0 + DKV_STEP - 1 ||
                          (p.window > 0 && kw0 + 63 <= pos0 - p.window);
        if (!none) {
          hopper::fence_proxy_async();
          const unsigned char* st = smem + L::STAGE_OFF + s * L::STAGE_BYTES;
          const float* sL = sStat + s * 2 * DKV_STEP;
          const float* sD = sL + DKV_STEP;
          const uint64_t q_desc = hopper::make_desc(st, 16, 1024);                   // K-major
          const uint64_t do_desc = hopper::make_desc(st + L::Q_BYTES, 16, 1024);     // K-major
          const uint64_t qmn_desc = hopper::make_desc(st, L::Q_PANEL, 1024);         // MN-major
          const uint64_t domn_desc = hopper::make_desc(st + L::Q_BYTES, L::Q_PANEL, 1024);
          // a step whose every (key, query) pair is visible needs no mask
          const bool whole = kw0 + 63 <= pos0 && kw0 + 64 <= kv_len &&
                             q0 + DKV_STEP <= p.T &&
                             (p.window <= 0 || kw0 > pos0 + DKV_STEP - 1 - p.window);

          // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
          float st_[32], dpt[32];
          hopper::fence_regs<32>(st_);
          hopper::fence_regs<32>(dpt);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const int ko = (kk & 3) * 32;
            hopper::wgmma_ss_n64<0, 0>(st_, hopper::desc_add(k_desc, (kk >> 2) * L::KV_PANEL + ko),
                                       hopper::desc_add(q_desc, (kk >> 2) * L::Q_PANEL + ko),
                                       kk > 0);
          }
          hopper::wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const int ko = (kk & 3) * 32;
            hopper::wgmma_ss_n64<0, 0>(dpt, hopper::desc_add(v_desc, (kk >> 2) * L::KV_PANEL + ko),
                                       hopper::desc_add(do_desc, (kk >> 2) * L::Q_PANEL + ko),
                                       kk > 0);
          }
          hopper::wgmma_commit();

          // p^T = exp(s*scale - lse): row = key, column = query; this
          // thread's columns are 8 jb + 2 tig + {0, 1}
          hopper::wgmma_wait<1>();
          hopper::fence_regs<32>(st_);
#pragma unroll
          for (int jb = 0; jb < 8; ++jb) {
            const float2 l = reinterpret_cast<const float2*>(sL)[jb * 4 + tig];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int jj = 4 * jb + e;
              const int col = jb * 8 + tig * 2 + (e & 1);
              bool ok = true;
              if (!whole) {
                const int key = key_r[e >> 1];
                const int pos = pos0 + col;
                ok = q0 + col < p.T && key <= pos && key < kv_len &&
                     (p.window <= 0 || key > pos - p.window);
              }
              const float lse2 = ((e & 1) ? l.y : l.x) * LOG2E;
              st_[jj] = ok ? hopper::fast_exp2(fmaf(st_[jj], p.scale_log2, -lse2)) : 0.f;
            }
          }
          // ds^T = p^T * (dp^T - dsum)
          hopper::wgmma_wait<0>();
          hopper::fence_regs<32>(dpt);
#pragma unroll
          for (int jb = 0; jb < 8; ++jb) {
            const float2 d2 = reinterpret_cast<const float2*>(sD)[jb * 4 + tig];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dpt[4 * jb + e] = st_[4 * jb + e] * (dpt[4 * jb + e] - ((e & 1) ? d2.y : d2.x));
            }
          }
          uint32_t pa[4][4], da[4][4];
          acc_to_frags<64>(pa, st_);
          acc_to_frags<64>(da, dpt);

          // dv += bf16(P^T) dO and dk += bf16(dS^T) Q: dO and Q read MN-major
          hopper::fence_regs<D / 2>(dv);
          hopper::fence_regs<D / 2>(dk);
          hopper::wgmma_fence();
#pragma unroll
          for (int cq = 0; cq < 4; ++cq) {  // 16 queries each
            rs_product<D>(dv, pa[cq], hopper::desc_add(domn_desc, cq * 2048), L::Q_PANEL);
            rs_product<D>(dk, da[cq], hopper::desc_add(qmn_desc, cq * 2048), L::Q_PANEL);
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs<D / 2>(dv);
          hopper::fence_regs<D / 2>(dk);
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[s]);  // q, dO and the stats are read
      }
      // the sums meet in a tree fixed by C: at stride 1, 2, 4, ... CTA
      // r + stride (r a multiple of 2 stride) sends its dk, then its dv, into
      // CTA r's k and v tiles and arrives on r's xfull; CTA r arrives on the
      // sender's xready when it can take them. CTA 0 ends with
      // ((s0 + s1) + (s2 + s3)) + ... in that order. Computed here, after
      // the steps, so that nothing of it holds a register through them
      int low = 1, levels = 0;  // the lowest set bit of rank (C for rank 0): it sends there
      while (low < C && (rank & low) == 0) {
        low *= 2;
        ++levels;
      }
      int rx = 2 * levels * n_live, tx = 2 * n_live;  // the exchange rounds of earlier tiles
      ++n_live;
      const int slot = wg * (D / 8) * 128 + wtid;  // this thread's float4s: slot + 128 m
      for (int stride = 1; stride < low; stride *= 2) {
        const uint32_t peer_xready = hopper::map_shared(xready, rank + stride);
        take_turn(peer_xready, xfull, rx);
        add_part<D>(dk, xch, slot);
        take_turn(peer_xready, xfull, rx);
        add_part<D>(dv, xch, slot);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(kv_empty);  // the producer may load the next k, v
      if (rank != 0) {
        const uint32_t peer_xch = hopper::map_shared(xch, rank - low);
        const uint32_t peer_xfull = hopper::map_shared(xfull, rank - low);
        hopper::mbar_wait_cluster(xready, tx++ & 1);
        send_part<D>(dk, peer_xch, slot);
        hopper::mbar_arrive_cluster(peer_xfull);
        hopper::mbar_wait_cluster(xready, tx++ & 1);
        send_part<D>(dv, peer_xch, slot);
        hopper::mbar_arrive_cluster(peer_xfull);
      } else {
        // dk, dv are contiguous [B,S,K,D]; every key row below S is written
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int s = key_r[r];
          if (s < p.S) {
            const long long off = (((long long)b * p.S + s) * p.K + kvh) * D + tig * 2;
#pragma unroll
            for (int n = 0; n < D / 8; ++n) {
              *reinterpret_cast<uint32_t*>(p.dk + off + n * 8) =
                  pack_bf16(dk[4 * n + 2 * r] * p.scale, dk[4 * n + 2 * r + 1] * p.scale);
              *reinterpret_cast<uint32_t*>(p.dv + off + n * 8) =
                  pack_bf16(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
            }
          }
        }
      }
    }
    if (p.steps != nullptr && threadIdx.x == 0) p.steps[blockIdx.x] = c;
    hopper::cluster_sync();  // no CTA leaves while another may reach its memory
  }
}

template <int D, int STAGES>
cudaError_t launch_dq_wgmma(const Params& p, cudaStream_t stream) {
  constexpr int smem = DqLayout<D, STAGES>::BYTES;
  cudaError_t err = hopper::allow_smem<flash_bwd_dq_wgmma<D, STAGES>>(smem);
  if (err != cudaSuccess) return err;
  const int blocks = (p.T + DQ_BLOCK_M - 1) / DQ_BLOCK_M * p.B * p.H;
  flash_bwd_dq_wgmma<D, STAGES><<<blocks, WG_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// the clusters of C CTAs that the card holds at once (0 if it holds none),
// asked once per device
template <int D, int STAGES, int C>
int dkv_clusters_at_once() {
  static int known[64] = {};  // the count + 1
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (known[dev] == 0) {
    constexpr int smem = DkvLayout<D, STAGES>::BYTES;
    int n = 0;
    if (hopper::allow_smem<flash_bwd_dkv_wgmma<D, STAGES, C>>(smem) == cudaSuccess) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = C;
      attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
      cfg.gridDim = dim3(C);
      cfg.blockDim = dim3(WG_THREADS);
      cfg.dynamicSmemBytes = smem;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      if (cudaOccupancyMaxActiveClusters(&n, flash_bwd_dkv_wgmma<D, STAGES, C>, &cfg) !=
          cudaSuccess) {
        n = 0;
      }
    }
    cudaGetLastError();  // a size the card cannot take is not an error of the launch
    known[dev] = n + 1;
  }
  return known[dev] - 1;
}

template <int D, int STAGES, int C>
cudaError_t launch_dkv_cluster(const Params& p, int units, cudaStream_t stream) {
  constexpr int smem = DkvLayout<D, STAGES>::BYTES;
  cudaError_t err = hopper::allow_smem<flash_bwd_dkv_wgmma<D, STAGES, C>>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(C * units * p.B);
  cfg.blockDim = dim3(WG_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_bwd_dkv_wgmma<D, STAGES, C>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// dk/dv on wgmma: clusters of 2 CTAs, or of 8 or 4 where all the clusters
// of one batch row still run at once (a short sequence or few kv heads
// leave most SMs idle with 2). The size depends on S, K and the card, not
// on B, so a batch row's sums do not depend on the other rows.
template <int D, int STAGES>
cudaError_t launch_dkv_wgmma(const Params& p, cudaStream_t stream) {
  const int n_kt = (p.S + DKV_KEYS - 1) / DKV_KEYS;
  const int units = (n_kt + 1) / 2 * p.K;  // the clusters of one batch row
  if (units <= dkv_clusters_at_once<D, STAGES, 8>())
    return launch_dkv_cluster<D, STAGES, 8>(p, units, stream);
  if (units <= dkv_clusters_at_once<D, STAGES, 4>())
    return launch_dkv_cluster<D, STAGES, 4>(p, units, stream);
  return launch_dkv_cluster<D, STAGES, 2>(p, units, stream);
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
  p.steps = nullptr;
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
    // the design each head dim runs (ops/kernels/flash_attention.py
    // DESIGNS says the same)
    case 64: return (int)launch_dq_wgmma<64, 3>(p, s);
    case 80: return (int)launch_dq<80, 64>(p, s);
    case 128: return (int)launch_dq_wgmma<128, 2>(p, s);
    case 256: return (int)launch_dq<256, 32>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dk, dv [B,S,K,D] (contiguous) from the same inputs. `steps`, null or
// one int per CTA of the wgmma kernel, receives the (query head, q tile)
// steps each CTA walked, in CTA order; the mma.sync kernels refuse it.
extern "C" int fei_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, void* dk, void* dv, int* steps,
    const int* q_start, const int* kv_length,
    int B, int T, int H, int S, int K, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int window, float scale, void* stream) {
  Params p = make_params(q, k, v, dout, lse, dsum, nullptr, dk, dv,
                         q_start, kv_length, B, T, H, S, K,
                         q_sb, q_st, q_sh, k_sb, k_ss, k_sh,
                         v_sb, v_ss, v_sh, window, scale);
  p.steps = steps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_dkv_wgmma<64, 4>(p, s);
    case 80: return steps ? (int)cudaErrorInvalidValue : (int)launch_dkv<80, 64, 64, 1>(p, s);
    case 128: return (int)launch_dkv_wgmma<128, 3>(p, s);
    case 256: return steps ? (int)cudaErrorInvalidValue : (int)launch_dkv<256, 32, 32, 2>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fei_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
