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
// read, far below the card's ~295 FLOP/byte ridge. It is bound by memory:
// the time is the live pages' bytes over 3.35 TB/s if enough of them are
// in flight on every SM at once.
//
// What the design does about it:
// - Split each row's keys over blocks (flash-decoding). The keys are cut
//   into fixed segments of `seg_pages` pages: page pi of a table row lies
//   in segment pi / seg_pages. One block owns (tile of query rows,
//   segment, kv head, row) and walks only the pages of its segment that a
//   live row of its tile can see; a block whose segment holds none exits at
//   once, so dead pages and the null page are never read. At the decode
//   shape about 250 blocks stream pages instead of 64, and the longest walk
//   is seg_pages pages instead of 125.
// - Pages stream through a ring of 16-byte cp.async copies into padded
//   rows, so ldmatrix reads them without bank conflicts: three pages deep
//   for a decode tile (two blocks an SM), two for taller tiles (three
//   blocks an SM) and at D = 256.
// - Every warp works at decode. A tile is 16 * MT query rows (MT = 1, 2 or
//   4 m16 tiles, chosen per launch from R * G: 1 at decode, 2 for K3's
//   8-position groups, 4 for blocks), and its four warps share the
//   products: S = Q K^T in (m-tile, 16-slot group) units, P V in (m-tile,
//   16-column pair) units. At decode the four warps of the one m-tile take
//   a quarter of the slots and a quarter of the columns each; the row
//   maxima and sums cross them through shared memory (a named barrier per
//   m-tile) and the bf16 softmax weights come back as mma A fragments
//   through ldmatrix. With one warp per m-tile (MT = 4) all of that stays
//   in registers. V fragments come through ldmatrix.trans; Q fragments
//   are loaded once into registers (D <= 128). Steps whose keys every row
//   of a thread sees skip the mask. mma.sync m16n8k16, bf16 in, fp32
//   accumulate.
// - int8 pools widen each landed page to bf16 once, in shared memory
//   (16 values per 16-byte load, exact: |x| <= 127), then run the bf16
//   fragments; the scales fold in as before.
// - Each block writes fp32 partials (m, l, unnormalised acc) of its rows
//   for its segment; `paged_attn_combine` then adds a row's segments in
//   index order: m = max m_s, l = sum l_s * 2^(m_s - m), acc = sum acc_s *
//   2^(m_s - m) (each sum starting from its first segment's term), out =
//   bf16(acc / l). A row whose keys lie in one segment is written by that
//   segment's block as bf16(acc / l), the same bits (2^0 = 1). Rows with no
//   visible key, and dead positions, write zeros. No atomics: two runs are
//   bitwise equal.
//
// The identity rule: a query row's arithmetic depends only on its own keys.
// The segment grid is a function of absolute key positions alone (never of
// R, the tile height, the batch or the other rows). Inside a segment every
// score, max, weight, row sum and P V product of a row is the same
// sequence of operations whatever MT is, in registers or through shared
// memory (explicitly rounded adds and multiplies, so the compiler
// contracts none of them differently in the instantiations), and pages or
// slots a row does not see are exact no-ops for it (masked scores give
// p = 0 and a correction of 1). So a K3 decode row is bitwise K2 with one
// query position, a K3 chunk group is bitwise the same rows of K2's block
// form, and a decode row at position p is bitwise the block form's row at
// p: a preempted sequence rebuilt through chunks reproduces what it first
// computed as decode rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fei_paged {

constexpr int PS = 64;  // page size: slots per page
constexpr int NW = 4;   // warps of a block
constexpr int NT = NW * 32;
constexpr int COMBINE_WARPS = 8;  // rows per block of the combine
constexpr float NEG_INF = -1e30f;  // the Pallas kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;
  const unsigned char* k;  // bf16 or int8 elements, contiguous pool
  const unsigned char* v;
  const float* ks;  // int8 pools only
  const float* vs;
  __nv_bfloat16* o;
  float* part_ml;   // [Bv, R, H, nseg, 2] (m, l) of each row's segments
  float* part_acc;  // [Bv, R, H, nseg, D] unnormalised acc
  const int* block_table;
  const int* limits;
  const int* q_lens;  // null: every row has R live positions
  const int* modes;   // null: no decode rows
  int Bv, R, H, K, G, max_pages;
  int seg_pages, nseg;
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

// c[16x8] += a[16x16] (row-major) * b[16x8] (col-major), bf16 in, fp32 acc
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 (16 bytes)
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// 16-byte global -> shared copy; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four int8 values -> four bf16 (two packed pairs), exactly: each byte
// x + 128 becomes the low bits of the fp32 2^23 + x + 128, from which
// 2^23 + 128 is subtracted; |x| <= 127 keeps 7 significant bits, so the
// fp32's upper half is the bf16
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// live query positions of row b
__device__ __forceinline__ int live_len(const Params& p, int b) {
  int qlen = p.q_lens ? p.q_lens[b] : p.R;
  if (p.modes && p.modes[b] == 1) qlen = min(qlen, 1);
  return max(0, min(qlen, p.R));
}

// the keys [lo, hi) that query position t of a row with this limit sees
__device__ __forceinline__ void row_keys(const Params& p, int limit, int t,
                                         int& lo, int& hi) {
  hi = min(limit + t, p.max_pages * PS);
  lo = p.window > 0 ? max(limit + t - p.window, 0) : 0;
}

// named barrier over `threads` threads (a multiple of 32)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// shapes of one instantiation: MT m16 tiles of query rows
template <int D, bool INT8, int MT>
struct Cfg {
  static constexpr int BN = D > 128 ? 32 : 64;  // slots per softmax step: D alone decides
  static constexpr int ROWS = 16 * MT;          // query rows of a tile
  static constexpr int WPM = NW / MT;           // warps per m-tile
  static constexpr int GPM = BN / 16;           // 16-slot groups per step
  static constexpr int SPW = (GPM + WPM - 1) / WPM;  // S units per warp
  static constexpr int NP = D / 16;             // 16-column pairs of the output
  static constexpr int NPW = (NP + WPM - 1) / WPM;   // pairs per warp
  // ring stages: a decode tile streams three pages deep; taller tiles
  // compute longer per page and take two, so that more blocks fit an SM
  static constexpr int NST = D > 128 || MT > 1 ? 2 : 3;
  static constexpr int MIN_BLOCKS = D > 128 ? 1 : 2;  // blocks an SM must hold
  static constexpr bool QREG = D <= 128;  // the warp's Q fragments stay in registers
  // one warp per m-tile: its row maxima, sums and weights never leave its
  // registers (the same values and order as through shared memory)
  static constexpr bool SOLO = WPM == 1;
  static constexpr int KROW = D + 8;            // bf16 per smem K/V/Q row (padded)
  static constexpr int PROW = BN + 8;           // bf16 per smem P row (padded)
  static constexpr int TILE_E = PS * KROW;      // bf16 elements of one K (or V) tile
  static constexpr int STAGE_B = INT8 ? 2 * PS * D + 2 * PS * 4 : 2 * TILE_E * 2;
  // shared memory: Q (unless in registers), the exchange of row maxima,
  // sums and weights (unless SOLO), the ring, the widened int8 page
  static constexpr int Q_OFF = 0;
  static constexpr int P_OFF = Q_OFF + (QREG ? 0 : ROWS * KROW * 2);
  static constexpr int MAX_OFF = P_OFF + (SOLO ? 0 : ROWS * PROW * 2);
  static constexpr int SUM_OFF = MAX_OFF + (SOLO ? 0 : ROWS * GPM * 4);
  static constexpr int RING_OFF = SUM_OFF + (SOLO ? 0 : ROWS * GPM * 4);
  static constexpr int WIDE_OFF = RING_OFF + NST * STAGE_B;  // int8: the widened page
  static constexpr int SMEM = WIDE_OFF + (INT8 ? 2 * TILE_E * 2 : 0);
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static_assert(PS % BN == 0, "a softmax step must divide the page");
  static_assert(P_OFF % 16 == 0 && RING_OFF % 16 == 0 && STAGE_B % 16 == 0,
                "16-byte aligned shared-memory regions");
};

template <int D, bool INT8, int MT>
__global__ void __launch_bounds__(NT, Cfg<D, INT8, MT>::MIN_BLOCKS)
    paged_attn_seg(const Params p) {
  using C = Cfg<D, INT8, MT>;
  constexpr int BN = C::BN, GPM = C::GPM, WPM = C::WPM, KROW = C::KROW;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + C::Q_OFF);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + C::P_OFF);
  float* sMax = reinterpret_cast<float*>(smem + C::MAX_OFF);  // [ROWS][GPM]
  float* sSum = reinterpret_cast<float*>(smem + C::SUM_OFF);  // [ROWS][GPM]
  unsigned char* ring = smem + C::RING_OFF;
  __nv_bfloat16* sWide = reinterpret_cast<__nv_bfloat16*>(smem + C::WIDE_OFF);

  const int seg = blockIdx.x % p.nseg;
  const int r0 = (blockIdx.x / p.nseg) * C::ROWS;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.G;
  const int limit = p.limits[b];
  const int r1 = min(r0 + C::ROWS, live_len(p, b) * G);  // live rows of this tile
  if (r1 <= r0) return;  // a dead tile: the combine writes its zeros

  // the tile's keys [lo, hi), then the pages of this segment among them
  int lo, hi, other;
  row_keys(p, limit, r0 / G, lo, other);
  row_keys(p, limit, (r1 - 1) / G, other, hi);
  if (hi <= lo) return;
  const int pg_first = max(lo / PS, seg * p.seg_pages);
  const int pg_last = min((hi - 1) / PS, seg * p.seg_pages + p.seg_pages - 1);
  if (pg_first > pg_last) return;  // no live row sees a key of this segment

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row group
  const int tig = lane & 3;  // thread in group
  const int mt = warp / WPM;    // the m-tile this warp serves
  const int part = warp % WPM;  // its share of that m-tile's work
  const bool mt_live = r0 + mt * 16 < r1;
  // the warps of one m-tile exchange row maxima, sums and weights (unless
  // SOLO); other m-tiles' rows are none of their business
  auto mt_sync = [&]() { named_sync(1 + mt, WPM * 32); };

  // this thread's two rows: tile rows mt*16 + g and + 8
  int lim_r[2];
  bool live_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = r0 + mt * 16 + g + 8 * r;
    live_r[r] = rr < r1;
    lim_r[r] = limit + rr / G;  // keys < lim_r are causally visible
  }

  // the tile's query rows, dead rows zeros: straight into this warp's A
  // fragments (D <= 128), else into shared memory
  uint32_t qf[C::QREG ? D / 16 : 1][4];
  if (C::QREG && mt_live) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = r0 + mt * 16 + g + 8 * r;
      const __nv_bfloat16* qrow =
          p.q + b * p.q_sb + (rr / G) * p.q_st + (kh * G + rr % G) * p.q_sh + tig * 2;
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        qf[kk / 16][r] = live_r[r] ? *reinterpret_cast<const uint32_t*>(qrow + kk) : 0u;
        qf[kk / 16][2 + r] = live_r[r] ? *reinterpret_cast<const uint32_t*>(qrow + kk + 8) : 0u;
      }
    }
  }
  for (int i = threadIdx.x; !C::QREG && i < C::ROWS * (D / 8); i += NT) {
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
    *reinterpret_cast<uint4*>(sQ + r * KROW + c) = val;
  }

  const int* bt = p.block_table + b * p.bt_stride;
  auto issue = [&](int pi, int st) {
    const long long page = bt[pi];
    unsigned char* dst = ring + st * C::STAGE_B;
    if (INT8) {
      constexpr int CPR = D / 16;  // 16-byte chunks per int8 slot row
      const long long base = (page * p.K + kh) * (long long)(PS * D);
      for (int i = threadIdx.x; i < PS * CPR; i += NT) {
        const int slot = i / CPR;
        const int c = (i % CPR) * 16;
        const int bytes = pi * PS + slot < hi ? 16 : 0;  // zero-fill the tail
        cp_async16(dst + slot * D + c, p.k + base + slot * D + c, bytes);
        cp_async16(dst + PS * D + slot * D + c, p.v + base + slot * D + c, bytes);
      }
      float* dS = reinterpret_cast<float*>(dst + 2 * PS * D);
      const long long sbase = (page * p.K + kh) * PS;
      if (threadIdx.x < 2 * (PS / 4)) {
        const int which = threadIdx.x / (PS / 4);
        const int c = (threadIdx.x % (PS / 4)) * 4;
        cp_async16(dS + which * PS + c, (which ? p.vs : p.ks) + sbase + c,
                   pi * PS + c < hi ? 16 : 0);
      }
    } else {
      constexpr int CPR = D * 2 / 16;  // 16-byte chunks per bf16 slot row
      const long long base = (page * p.K + kh) * (long long)(PS * D * 2);
      __nv_bfloat16* dK = reinterpret_cast<__nv_bfloat16*>(dst);
      __nv_bfloat16* dV = dK + C::TILE_E;
      for (int i = threadIdx.x; i < PS * CPR; i += NT) {
        const int slot = i / CPR;
        const int c = (i % CPR) * 8;  // in elements
        const int bytes = pi * PS + slot < hi ? 16 : 0;
        const long long off = base + (slot * D + c) * 2;
        cp_async16(dK + slot * KROW + c, p.k + off, bytes);
        cp_async16(dV + slot * KROW + c, p.v + off, bytes);
      }
    }
  };

  // running state of this thread's two rows (the same in every warp of
  // the m-tile) and its share of their outputs: pairs [pr0, pr0 + NPW)
  float m_run[2] = {NEG_INF, NEG_INF};  // log2 domain
  float l_run[2] = {0.f, 0.f};          // the full row sum
  float acc[C::NPW][2][4];
#pragma unroll
  for (int j = 0; j < C::NPW; ++j)
#pragma unroll
    for (int n = 0; n < 2; ++n) acc[j][n][0] = acc[j][n][1] = acc[j][n][2] = acc[j][n][3] = 0.f;
  const int pr0 = part * C::NPW;

  const int npg = pg_last - pg_first + 1;
#pragma unroll
  for (int s = 0; s < C::NST - 1; ++s) {
    if (s < npg) issue(pg_first + s, s);
    cp_async_commit();
  }

#pragma unroll 1
  for (int i = 0; i < npg; ++i) {
    const int pi = pg_first + i;
    cp_async_wait<C::NST - 2>();
    __syncthreads();  // page i landed; every thread is done with page i - 1
    if (i + C::NST - 1 < npg) issue(pi + C::NST - 1, (i + C::NST - 1) % C::NST);
    cp_async_commit();
    const unsigned char* stage = ring + (i % C::NST) * C::STAGE_B;
    const __nv_bfloat16* sK;
    const float* sks = nullptr;
    const float* svs = nullptr;
    if (INT8) {
      // widen the landed int8 page to bf16 once
      constexpr int CPR = D / 16;
      for (int j = threadIdx.x; j < 2 * PS * CPR; j += NT) {
        const int which = j / (PS * CPR);
        const int slot = (j / CPR) % PS;
        const int c = (j % CPR) * 16;
        const uint4 w = *reinterpret_cast<const uint4*>(stage + which * PS * D + slot * D + c);
        uint4 a, bb;
        widen4(w.x, a.x, a.y);
        widen4(w.y, a.z, a.w);
        widen4(w.z, bb.x, bb.y);
        widen4(w.w, bb.z, bb.w);
        __nv_bfloat16* d = sWide + which * C::TILE_E + slot * KROW + c;
        *reinterpret_cast<uint4*>(d) = a;
        *reinterpret_cast<uint4*>(d + 8) = bb;
      }
      sks = reinterpret_cast<const float*>(stage + 2 * PS * D);
      svs = sks + PS;
      sK = sWide;
      __syncthreads();
    } else {
      sK = reinterpret_cast<const __nv_bfloat16*>(stage);
    }
    const __nv_bfloat16* sV = sK + C::TILE_E;

#pragma unroll 1
    for (int slot0 = 0; slot0 < PS; slot0 += BN) {
      const int key0 = pi * PS + slot0;
      // both of this thread's rows are live and see every key of the step
      // (row g + 8's limit is the larger)
      const bool vis_all = live_r[1] && key0 + BN <= lim_r[0] &&
                           (p.window <= 0 || key0 >= lim_r[1] - p.window);
      // (a) S = Q K^T in (m-tile, 16-slot group) units: scale into the log2
      // domain (int8: times the k scale), mask, each unit's row maxima
      float s[C::SPW][2][4];
      float gmax[C::SPW][2], gsum[C::SPW][2];  // SOLO: per group, per row
      uint32_t pa[C::SPW][4];                  // SOLO: P's A fragments
      if (mt_live) {
#pragma unroll
        for (int j = 0; j < C::SPW; ++j)
#pragma unroll
          for (int n = 0; n < 2; ++n) s[j][n][0] = s[j][n][1] = s[j][n][2] = s[j][n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D; kk += 16) {
          uint32_t a[4];
          if (C::QREG) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] = qf[kk / 16][e];
          } else {
            ldsm_x4(a, sQ + (mt * 16 + (lane & 15)) * KROW + kk + (lane >> 4) * 8);
          }
#pragma unroll
          for (int j = 0; j < C::SPW; ++j) {
            const int grp = part + j * WPM;
            if (grp < GPM) {
              uint32_t bk[4];
              ldsm_x4(bk, sK + (slot0 + grp * 16 + (lane & 7) + (lane >> 4) * 8) * KROW +
                              kk + ((lane >> 3) & 1) * 8);
              mma_16816(s[j][0], a, bk);
              mma_16816(s[j][1], a, bk + 2);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < C::SPW; ++j) {
          const int grp = part + j * WPM;
          if (grp < GPM) {
            float mx[2] = {NEG_INF, NEG_INF};
            if (vis_all) {  // no mask: the same values, fewer instructions
#pragma unroll
              for (int n = 0; n < 2; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int slot = slot0 + grp * 16 + n * 8 + tig * 2 + (e & 1);
                  float x = __fmul_rn(s[j][n][e], p.scale_log2);
                  if (INT8) x = __fmul_rn(x, sks[slot]);
                  s[j][n][e] = x;
                  mx[e >> 1] = fmaxf(mx[e >> 1], x);
                }
              }
            } else {
#pragma unroll
              for (int n = 0; n < 2; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int r = e >> 1;
                  const int slot = slot0 + grp * 16 + n * 8 + tig * 2 + (e & 1);
                  const int key = pi * PS + slot;
                  const bool ok = live_r[r] && key < lim_r[r] &&
                                  (p.window <= 0 || key > lim_r[r] - 1 - p.window);
                  float x = __fmul_rn(s[j][n][e], p.scale_log2);
                  if (INT8) x = __fmul_rn(x, sks[slot]);
                  x = ok ? x : NEG_INF;
                  s[j][n][e] = x;
                  mx[r] = fmaxf(mx[r], x);
                }
              }
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
              mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
              if (C::SOLO) gmax[j][r] = mx[r];
              else if (tig == 0) sMax[(mt * 16 + g + 8 * r) * GPM + grp] = mx[r];
            }
          }
        }
        if (!C::SOLO) mt_sync();
      }

      // (b) the rows' new maxima; each unit's weights (bf16, int8: times
      // the v scale) to shared memory and its row sums in a fixed order
      float m_new[2];
      if (mt_live) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = NEG_INF;
#pragma unroll
          for (int q = 0; q < GPM; ++q)
            mx = fmaxf(mx, C::SOLO ? gmax[C::SOLO ? q : 0][r] : sMax[(mt * 16 + g + 8 * r) * GPM + q]);
          m_new[r] = fmaxf(m_run[r], mx);
        }
#pragma unroll
        for (int j = 0; j < C::SPW; ++j) {
          const int grp = part + j * WPM;
          if (grp < GPM) {
            // a row whose max is still NEG_INF has seen no visible key,
            // and its masked entries count as 0
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                s[j][n][e] = m_new[r] == NEG_INF ? 0.f : exp2f(__fsub_rn(s[j][n][e], m_new[r]));
              }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float t = __fadd_rn(__fadd_rn(__fadd_rn(s[j][0][2 * r], s[j][0][2 * r + 1]),
                                            s[j][1][2 * r]),
                                  s[j][1][2 * r + 1]);
              t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, 1));
              t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, 2));
              if (C::SOLO) gsum[j][r] = t;
              else if (tig == 0) sSum[(mt * 16 + g + 8 * r) * GPM + grp] = t;
            }
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              const int col = grp * 16 + n * 8 + tig * 2;
              float w[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                w[e] = s[j][n][e];
                if (INT8) w[e] = w[e] > 0.f ? __fmul_rn(w[e], svs[slot0 + col + (e & 1)]) : 0.f;
              }
              if (C::SOLO) {
                pa[j][2 * n] = pack_bf16(w[0], w[1]);
                pa[j][2 * n + 1] = pack_bf16(w[2], w[3]);
              } else {
                *reinterpret_cast<uint32_t*>(sP + (mt * 16 + g) * C::PROW + col) =
                    pack_bf16(w[0], w[1]);
                *reinterpret_cast<uint32_t*>(sP + (mt * 16 + g + 8) * C::PROW + col) =
                    pack_bf16(w[2], w[3]);
              }
            }
          }
        }
        if (!C::SOLO) mt_sync();
      }

      // (c) rescale and O += P V in (m-tile, column pair) units
      if (mt_live) {
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float* rs = sSum + (mt * 16 + g + 8 * r) * GPM;
          float t = C::SOLO ? gsum[0][r] : rs[0];
#pragma unroll
          for (int q = 1; q < GPM; ++q) t = __fadd_rn(t, C::SOLO ? gsum[C::SOLO ? q : 0][r] : rs[q]);
          corr[r] = exp2f(__fsub_rn(m_run[r], m_new[r]));
          l_run[r] = __fadd_rn(__fmul_rn(l_run[r], corr[r]), t);
          m_run[r] = m_new[r];
        }
#pragma unroll
        for (int j = 0; j < C::NPW; ++j)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            acc[j][n][0] = __fmul_rn(acc[j][n][0], corr[0]);
            acc[j][n][1] = __fmul_rn(acc[j][n][1], corr[0]);
            acc[j][n][2] = __fmul_rn(acc[j][n][2], corr[1]);
            acc[j][n][3] = __fmul_rn(acc[j][n][3], corr[1]);
          }
#pragma unroll
        for (int c = 0; c < BN / 16; ++c) {
          uint32_t a[4];
          if (C::SOLO) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] = pa[C::SOLO ? c : 0][e];
          } else {
            ldsm_x4(a, sP + (mt * 16 + (lane & 15)) * C::PROW + c * 16 + (lane >> 4) * 8);
          }
#pragma unroll
          for (int j = 0; j < C::NPW; ++j) {
            if (pr0 + j < C::NP) {
              uint32_t bv[4];
              ldsm_x4_trans(bv, sV + (slot0 + c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * KROW +
                                    (pr0 + j) * 16 + (lane >> 4) * 8);
              mma_16816(acc[j][0], a, bv);
              mma_16816(acc[j][1], a, bv + 2);
            }
          }
        }
      }
    }
  }

  // this segment's partials of the rows that see it; a row whose keys lie
  // in this segment alone gets its output here
  if (!mt_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = r0 + mt * 16 + g + 8 * r;
    if (rr >= r1) continue;
    const int t = rr / G;
    const int h = kh * G + rr % G;
    int klo, khi;
    row_keys(p, limit, t, klo, khi);
    if (khi <= klo) continue;
    const int s_lo = klo / PS / p.seg_pages;
    const int s_hi = (khi - 1) / PS / p.seg_pages;
    if (seg < s_lo || seg > s_hi) continue;
    if (s_lo == s_hi) {
      __nv_bfloat16* orow = p.o + b * p.o_sb + t * p.o_st + h * p.o_sh;
#pragma unroll
      for (int j = 0; j < C::NPW; ++j) {
        if (pr0 + j < C::NP) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            *reinterpret_cast<uint32_t*>(orow + (pr0 + j) * 16 + n * 8 + tig * 2) =
                pack_bf16(__fdiv_rn(acc[j][n][2 * r], l_run[r]),
                          __fdiv_rn(acc[j][n][2 * r + 1], l_run[r]));
          }
        }
      }
    } else {
      const long long idx = ((long long)(b * p.R + t) * p.H + h) * p.nseg + seg;
      if (part == 0 && tig == 0) {
        p.part_ml[2 * idx] = m_run[r];
        p.part_ml[2 * idx + 1] = l_run[r];
      }
      float* arow = p.part_acc + idx * D;
#pragma unroll
      for (int j = 0; j < C::NPW; ++j) {
        if (pr0 + j < C::NP) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            *reinterpret_cast<float2*>(arow + (pr0 + j) * 16 + n * 8 + tig * 2) =
                make_float2(acc[j][n][2 * r], acc[j][n][2 * r + 1]);
          }
        }
      }
    }
  }
}

// one warp per query row (b, t, h): add the row's segments in index order;
// rows with no visible key and dead positions get zeros; a one-segment row
// was written by its segment's block
template <int D>
__global__ void __launch_bounds__(COMBINE_WARPS * 32) paged_attn_combine(const Params p) {
  const long long row = (long long)blockIdx.x * COMBINE_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)p.Bv * p.R * p.H) return;
  const int h = row % p.H;
  const int t = (row / p.H) % p.R;
  const int b = row / ((long long)p.H * p.R);
  __nv_bfloat16* orow = p.o + b * p.o_sb + t * p.o_st + h * p.o_sh;
  int klo = 0, khi = 0;
  if (t < live_len(p, b)) row_keys(p, p.limits[b], t, klo, khi);
  if (khi <= klo) {
    for (int c = lane * 2; c < D; c += 64) *reinterpret_cast<uint32_t*>(orow + c) = 0u;
    return;
  }
  const int s_lo = klo / PS / p.seg_pages;
  const int s_hi = (khi - 1) / PS / p.seg_pages;
  if (s_lo == s_hi) return;
  const long long idx0 = row * p.nseg;
  float m = NEG_INF;
  for (int s = s_lo; s <= s_hi; ++s) m = fmaxf(m, p.part_ml[2 * (idx0 + s)]);
  for (int c = lane * 2; c < D; c += 64) {
    float l = 0.f, a0 = 0.f, a1 = 0.f;
    for (int s = s_lo; s <= s_hi; ++s) {
      const float w = exp2f(__fsub_rn(p.part_ml[2 * (idx0 + s)], m));
      const float ls = __fmul_rn(p.part_ml[2 * (idx0 + s) + 1], w);
      const float2 v = *reinterpret_cast<const float2*>(p.part_acc + (idx0 + s) * D + c);
      if (s == s_lo) {
        l = ls;
        a0 = __fmul_rn(v.x, w);
        a1 = __fmul_rn(v.y, w);
      } else {
        l = __fadd_rn(l, ls);
        a0 = __fadd_rn(a0, __fmul_rn(v.x, w));
        a1 = __fadd_rn(a1, __fmul_rn(v.y, w));
      }
    }
    *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(__fdiv_rn(a0, l), __fdiv_rn(a1, l));
  }
}

template <int D, bool INT8, int MT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<D, INT8, MT>;
  const int ntiles = (p.R * p.G + C::ROWS - 1) / C::ROWS;
  if (p.nseg > 0) {
    cudaError_t err = cudaFuncSetAttribute(paged_attn_seg<D, INT8, MT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           C::SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid(ntiles * p.nseg, p.K, p.Bv);
    paged_attn_seg<D, INT8, MT><<<grid, NT, C::SMEM, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long rows = (long long)p.Bv * p.R * p.H;
  paged_attn_combine<D><<<(unsigned)((rows + COMBINE_WARPS - 1) / COMBINE_WARPS),
                          COMBINE_WARPS * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

// the tile height: the fewest m16 tiles that hold a row's R * G query rows
// (64 rows: one warp per m-tile, no exchange between warps inside a page)
template <int D, bool INT8>
cudaError_t launch_tiled(const Params& p, cudaStream_t s) {
  const int rows = p.R * p.G;
  if (rows <= 16) return launch<D, INT8, 1>(p, s);
  if (rows <= 32) return launch<D, INT8, 2>(p, s);
  return launch<D, INT8, 4>(p, s);
}

// head dims 64/80/128/256; D = 256 takes 32-slot softmax steps to keep its
// score and output fragments in registers
inline cudaError_t dispatch(const Params& p, int D, int int8, cudaStream_t s) {
  if (int8) {
    switch (D) {
      case 64: return launch_tiled<64, true>(p, s);
      case 80: return launch_tiled<80, true>(p, s);
      case 128: return launch_tiled<128, true>(p, s);
      case 256: return launch_tiled<256, true>(p, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 64: return launch_tiled<64, false>(p, s);
    case 80: return launch_tiled<80, false>(p, s);
    case 128: return launch_tiled<128, false>(p, s);
    case 256: return launch_tiled<256, false>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

// the partials' fp32 elements a call needs: (m, l) and D accumulators for
// every (row, position, head, segment)
inline long long scratch_elems(int Bv, int R, int H, int D, int nseg) {
  return (long long)Bv * R * H * nseg * (D + 2);
}

// pointers and geometry shared by both entry points; a call whose scratch
// is not its plan's size, or whose segment length is not positive, is
// refused (returns false)
inline bool make_params(Params& p, const void* q, const void* k, const void* v,
                        const void* ks, const void* vs, void* o, void* part,
                        long long part_elems, const int* block_table,
                        long long bt_stride, const int* limits, const int* q_lens,
                        const int* modes, int Bv, int R, int H, int K, int D,
                        int max_pages, long long q_sb, long long q_st, long long q_sh,
                        long long o_sb, long long o_st, long long o_sh, int window,
                        float scale, int seg_pages) {
  if (seg_pages <= 0 || K <= 0 || H % K) return false;
  const int nseg = (max_pages + seg_pages - 1) / seg_pages;
  const long long need = scratch_elems(Bv, R, H, D, nseg);
  if (part_elems != need || (need > 0 && part == nullptr)) return false;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const unsigned char*>(k);
  p.v = static_cast<const unsigned char*>(v);
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.part_ml = static_cast<float*>(part);
  p.part_acc = p.part_ml ? p.part_ml + 2LL * Bv * R * H * nseg : nullptr;
  p.block_table = block_table;
  p.bt_stride = bt_stride;
  p.limits = limits;
  p.q_lens = q_lens;
  p.modes = modes;
  p.Bv = Bv; p.R = R; p.H = H; p.K = K; p.G = H / K;
  p.max_pages = max_pages;
  p.seg_pages = seg_pages;
  p.nseg = nseg;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  p.window = window;
  p.scale_log2 = scale * LOG2E;
  return true;
}

}  // namespace fei_paged

extern "C" const char* fei_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
