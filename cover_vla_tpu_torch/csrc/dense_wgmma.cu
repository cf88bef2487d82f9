// K2  cvla_mha_dense, behind a plain C interface.
//
// Replaces cover_vla_tpu/ops/pallas_attention.py pallas_mha_dense
// (_dense_mha_kernel): mask-free multi-head attention of the SigLIP towers
// (head dim 72 for so400m, 64 for the SigLIP2 towers). Rows are the queries
// of one (batch, head); the key loop is bounded by the key count, so no
// padding of S is needed and any S >= 1 is taken.
//
// Bound on the H100: at the ViT-L/16-384 shape (16 x 576 tokens x 16 heads
// x 64) one launch moves ~38 MB and does ~22 GFLOP, about 11 us at
// 3.35 TB/s against 22 us at 989 TFLOP/s: bound by operations, and beside
// the tensor cores by the special-function unit, which needs as long for
// the 85 M exponentials (16 a clock an SM) as the tensor cores for the two
// products. What a launch waits for in practice is the K/V traffic from
// L2 to shared memory: every row tile of a (batch, head) pair reads all of
// its K and V again. The design (flash_wgmma.cuh) therefore issues both
// products as asynchronous warpgroup instructions (wgmma) that leave the
// warps' issue slots to the softmax, spends one special-function
// instruction per score (2^x on scores pre-scaled by log2 e), issues the
// next tile's scores ahead of this tile's P V so that the softmax runs
// under a product, takes blocks of 192 or 256 rows where that saves passes
// over K and V (3 instead of 5 at ViT-L, 1 instead of 2 at so400m), keeps
// K/V four tiles deep in flight, and never writes the [S, S] score tensor
// to device memory.
//
// Dispatch: every head dim (a multiple of 8 up to 256) takes the wgmma
// kernel, padded in shared memory to 16, 32, 64, 80, 128 or 256.

#include "flash_wgmma.cuh"

// q [B, Sq, H, D]; k/v [B, Skv, H, D]; out [B, Sq, H, D]; bf16, contiguous.
extern "C" int cvla_mha_dense(const void* q, const void* k, const void* v,
                              void* out, int B, int Sq, int Skv, int H,
                              int D, float scale, void* stream) {
  if (Skv <= 0 || H <= 0) return int(cudaErrorInvalidValue);
  WgParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.mask = nullptr;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.out_f32 = nullptr;
  p.hkv = H;
  p.groups = 1;
  p.rows = Sq;
  p.d = D;
  p.n_keys = Skv;
  p.scale_log2 = scale * kLog2e;
  return wg_dispatch<false>(p, B * H, static_cast<cudaStream_t>(stream));
}
