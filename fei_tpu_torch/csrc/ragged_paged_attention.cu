// Ragged paged attention (K3) for Hopper (sm_90a): decode rows and prefill
// chunk groups in one launch.
//
// Replaces: fei_tpu/ops/pallas/ragged_paged_attention.py, the Pallas TPU
// kernel `_ragged_kernel` (:55) reached through `_ragged_call` (:199) by
// `ragged_paged_attention` (:278).
//
// The kernel body is K2's (paged_attention.cuh), with per-row metadata: row
// b has q_lens[b] live query positions, and a row with modes[b] == 1 (a
// decode row) at most one. Since a query row's arithmetic depends only on
// its own limit and pages, a decode row here is bitwise K2 at qt = 1 and a
// chunk group is bitwise the same rows of K2's block form. The scratch
// rule is K2's (paged_attention.cu), with Bv rows of R positions.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libragged_paged_attention.so
//        ragged_paged_attention.cu
// The Python side (fei_tpu_torch/ops/kernels/ragged_paged_attention.py)
// builds it at first use and calls fei_ragged_paged_attention via ctypes.

#include "paged_attention.cuh"

extern "C" int fei_ragged_paged_attention(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, void* o, void* part, long long part_elems,
    const int* block_table, long long bt_stride,
    const int* limits, const int* q_lens, const int* modes,
    int Bv, int R, int H, int K, int D, int max_pages,
    long long q_sb, long long q_st, long long q_sh,
    long long o_sb, long long o_st, long long o_sh,
    int window, float scale, int int8, int seg_pages, void* stream) {
  fei_paged::Params p;
  if (!fei_paged::make_params(p, q, k, v, ks, vs, o, part, part_elems, block_table,
                              bt_stride, limits, q_lens, modes, Bv, R, H, K, D,
                              max_pages, q_sb, q_st, q_sh, o_sb, o_st, o_sh, window,
                              scale, seg_pages))
    return (int)cudaErrorInvalidValue;
  return (int)fei_paged::dispatch(p, D, int8, static_cast<cudaStream_t>(stream));
}
