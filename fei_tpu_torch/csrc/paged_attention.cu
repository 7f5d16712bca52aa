// Paged decode attention (K2) for Hopper (sm_90a).
//
// Replaces: fei_tpu/ops/pallas/paged_attention.py, the Pallas TPU kernel
// `_decode_kernel` (:44) reached through `_paged_call` (:144) by
// `paged_attention` (:218, one query position per row) and
// `paged_attention_block` (:259, T positions per row).
//
// The kernel body, what bounds it and what its design does about it are in
// paged_attention.cuh, which this file shares with the ragged kernel (K3).
// Every row here has qt live query positions. `part` is fp32 scratch for
// the segments' partials, of exactly `part_elems` = B * qt * H * nseg *
// (D + 2) elements (nseg = ceil(max_pages / seg_pages)); a call with
// scratch of another size is refused.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpaged_attention.so paged_attention.cu
// The Python side (fei_tpu_torch/ops/kernels/paged_attention.py) builds it
// at first use and calls fei_paged_attention through ctypes.

#include "paged_attention.cuh"

extern "C" int fei_paged_attention(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, void* o, void* part, long long part_elems,
    const int* block_table, long long bt_stride, const int* limits,
    int B, int qt, int H, int K, int D, int max_pages,
    long long q_sb, long long q_st, long long q_sh,
    long long o_sb, long long o_st, long long o_sh,
    int window, float scale, int int8, int seg_pages, void* stream) {
  fei_paged::Params p;
  if (!fei_paged::make_params(p, q, k, v, ks, vs, o, part, part_elems, block_table,
                              bt_stride, limits, nullptr, nullptr, B, qt, H, K, D,
                              max_pages, q_sb, q_st, q_sh, o_sb, o_st, o_sh, window,
                              scale, seg_pages))
    return (int)cudaErrorInvalidValue;
  return (int)fei_paged::dispatch(p, D, int8, static_cast<cudaStream_t>(stream));
}
