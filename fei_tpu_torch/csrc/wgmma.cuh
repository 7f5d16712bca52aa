// Hopper (sm_90a) building blocks shared by the wgmma kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu, int4_matmul.cu):
// shared-memory addresses, mbarriers, cp.async into an mbarrier, the wgmma
// matrix descriptor and the wgmma instructions the kernels issue.
//
// Shared-memory layout of every wgmma operand here: the 128-byte swizzle
// (CUTLASS's canonical SW128 GMMA layouts, cute/atom/mma_traits_sm90_gmma.hpp).
// An operand is kept as panels of 64 bf16 along its contiguous axis: a
// panel row is 128 bytes, eight rows make a 1024-byte atom, and the 16-byte
// chunk c of row r sits at chunk c ^ (r % 8) of its row (`sw128_offset`),
// so the eight rows of one logical chunk column lie in eight different
// bank groups. Panels start at 1024-byte boundaries. For an operand stored
// K-major (the k index contiguous: q, k, x), a panel row is one row's 64
// consecutive k values; for one stored MN-major (v, the dequantized
// weight), it is one k row's 64 consecutive m or n values. One tile can be
// read both ways: a [row][d] tile is K-major over d and MN-major over its
// rows, two descriptors on the same bytes (the flash backward reads k, q
// and dO so). Descriptors:
//   K-major:  SBO = 1024 (next 8 rows); a 16-wide k step moves the start
//             address by 32 bytes within the panel row
//   MN-major: SBO = 1024 (next 8 k rows), LBO = the stride between
//             64-wide m/n panels; a 16-row k step moves it by 2048 bytes
//
// Accumulator layout of m64nNk16 (fp32): warp w of the warpgroup owns rows
// 16w .. 16w+15; within the warp, d[4j + e] is mma.sync m16n8's C fragment
// of the 8-column block j: row (lane / 4) + 8 * (e / 2), column
// 8j + 2 * (lane % 4) + (e % 2). The register A operand is mma.sync's
// m16n8k16 A fragment of the warp's 16 rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// byte offset of 16-byte chunk c (0..7) of row r within a 1024-byte
// aligned SW128 panel
__device__ __forceinline__ int sw128_offset(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// the first 1024-byte boundary at or after the dynamic shared memory's
// start (launches ask for 1024 bytes more than the layout needs)
__device__ __forceinline__ unsigned char* align1024(unsigned char* smem) {
  return smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
}

// ---- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// wait until the barrier's phase with the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// arrive on `bar` and add `bytes` to the transfer count its phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// ---- clusters: one CTA reaches another's shared memory (sm_90)

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the address of `ptr` (in this CTA's shared memory) in the shared memory
// of the cluster's CTA `rank`
__device__ __forceinline__ uint32_t map_shared(const void* ptr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_addr(ptr)), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_cluster_v4(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}

// arrive on a barrier of another CTA of the cluster (an address from
// map_shared), releasing this thread's earlier writes at cluster scope
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(addr)
               : "memory");
}

// mbar_wait that acquires at cluster scope: writes that another CTA
// released before its arrival are visible after it
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// every thread of every CTA of the cluster (each warp whole)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

// ---- TMA

// copy the box at (c0, c1) (c0 the inner coordinate) of the 2-D tensor that
// `map` (a __grid_constant__ kernel parameter) describes into shared memory
// at `dst`; the bytes complete on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// ---- cp.async

// 16 bytes, with zero-fill: `bytes` of src land in dst, the rest of the
// 16 are zeros (bytes = 0 reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes, with zero-fill (bytes 0 or 4): for rows of fp32 statistics
// whose start is not 16-byte aligned
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// arrive on `bar` once this thread's earlier cp.asyncs have landed; the
// barrier's count includes this arrival (.noinc)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// a producer warpgroup (128 threads, `tid` 0..127) copies rows [row0,
// row0 + ROWS) of a [rows][D] bf16 matrix into D / 64 SW128 panels of
// ROWS * 128 bytes with cp.async; rows at or past `limit` are zero-filled
// and never read. Eight threads take one row's 128 bytes of a panel, so a
// warp reads whole 128-byte segments and its stores fall in distinct bank
// groups.
template <int D, int ROWS>
__device__ __forceinline__ void group_load(unsigned char* tile, const __nv_bfloat16* base,
                                           long long row_stride, int row0, int limit,
                                           int tid) {
  constexpr int C = D / 8;
  for (int i = tid; i < ROWS * C; i += 128) {
    const int r = i / C;
    const int c = i % C;
    const int gr = row0 + r;
    const bool ok = gr < limit;
    cp_async16(tile + (c >> 3) * (ROWS * 128) + sw128_offset(r, c & 7),
               ok ? base + gr * row_stride + c * 8 : base, ok ? 16 : 0);
  }
}

// order this thread's generic-proxy shared-memory writes (st.shared,
// cp.async) before later async-proxy reads (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier over `threads` threads (a multiple of 32)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// arrive on a named barrier without waiting for it
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma

// descriptor of a SW128 operand at `ptr`; lbo and sbo in bytes
__device__ __forceinline__ uint64_t make_desc(const void* ptr, int lbo, int sbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((smem_addr(ptr) >> 4) & 0x3FFF);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;  // layout type 1: 128-byte swizzle; base offset 0
  return d;
}

// a descriptor moved by `bytes` (a multiple of 16) within shared memory
__device__ __forceinline__ uint64_t desc_add(uint64_t d, int bytes) {
  return d + static_cast<uint64_t>(bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special function unit (flush-to-zero; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// hand registers from one warpgroup to another (every warp of the
// warpgroup executes it; the counts are compile-time)
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// keep the compiler from moving accumulator reads and writes across the
// asynchronous wgmma that own the registers
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// TA / TB: 0 = the operand is K-major in shared memory, 1 = MN-major

// d[64 x 16] (+)= A[64 x 16] * B[16 x 16], A and B from shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n16(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B from shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      " %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, "
      "%33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B from shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      " %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33,"
      " %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, "
      "%65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d[64 x 64] += A[64 x 16] (registers: each warp holds its 16 rows as
// mma.sync's A fragment) * B[16 x 64] (shared memory)
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      " %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, "
      "%33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// ---- host

// let `Kernel` use `bytes` of dynamic shared memory, once per kernel and
// device, so that a launch costs no attribute call
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

}  // namespace hopper
