// K3  cvla_prefix_gqa, behind a plain C interface.
//
// Replaces cover_vla_tpu/ops/pallas_attention.py pallas_prefix_gqa
// (_attention_kernel): masked prefix-LM GQA of the PaliGemma prefill, with
// fp32 probabilities. The rows of a (batch, kv-head) pair are its Sq * G
// query rows, position-major, so one K/V tile serves all G heads and the
// mask row of a query row is that of its position (no per-head copy of the
// mask, no padding of S). Masked and absent keys, the fp32 probabilities'
// hi/lo split and the mask's way into shared memory are described in
// flash_wgmma.cuh. The result is written as fp32 or as bf16.
//
// Bound on the H100: at B = 16 prompts, Sq = Skv = 328, 8 query heads over
// 1 KV head, D = 256 (q 21.5 MB, K/V 5.4 MB, mask 1.7 MB, bf16 output
// 21.5 MB; 9.4 GFLOP over the 268 x 268 attended pairs) one launch needs
// about 15 us of memory traffic and 9.5 us of bf16 tensor-core time:
// memory bound, with operations close behind, and the second P V product
// (the price of fp32 probabilities on bf16 tensor cores) adds half again
// to the tensor-core time. The design issues the products as asynchronous
// warpgroup instructions (wgmma) whose 64 x 256 fp32 accumulator is 128
// registers a thread with no spill at 255, shares each K/V tile and its
// 1 KB of mask bytes between the 128 rows (16 positions x 8 heads) of a
// block, and keeps the next tile's copy in flight under this tile's
// products.
//
// Dispatch: every head dim (a multiple of 8 up to 256) takes the wgmma
// kernel, padded in shared memory to 16, 32, 64, 80, 128 or 256.

#include "flash_wgmma.cuh"

// q bf16 [B, Sq, Hkv*G, D]; k/v bf16 [B, Skv, Hkv, D]; mask uint8
// [B, Sq, Skv] (nonzero = attend); out [B, Sq, Hkv*G, D], fp32 when
// out_f32 != 0, else bf16. All contiguous.
extern "C" int cvla_prefix_gqa(const void* q, const void* k, const void* v,
                               const void* mask, void* out, int B, int Sq,
                               int Skv, int Hkv, int G, int D, float scale,
                               int out_f32, void* stream) {
  if (Sq <= 0 || Skv <= 0 || Hkv <= 0 || G <= 0)
    return int(cudaErrorInvalidValue);
  WgParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.mask = static_cast<const uint8_t*>(mask);
  p.out = out_f32 ? nullptr : static_cast<__nv_bfloat16*>(out);
  p.out_f32 = out_f32 ? static_cast<float*>(out) : nullptr;
  p.hkv = Hkv;
  p.groups = G;
  p.rows = Sq * G;
  p.d = D;
  p.n_keys = Skv;
  p.scale_log2 = scale * kLog2e;
  return wg_dispatch<true>(p, B * Hkv, static_cast<cudaStream_t>(stream));
}
