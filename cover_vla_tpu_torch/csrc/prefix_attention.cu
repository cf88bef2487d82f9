// K3: the fp32-probability, per-(position, key)-masked instance of the
// flash-attention body in flash_rows.cuh (see the notes there), behind a
// plain C interface.

#include "flash_rows.cuh"

// K3. q bf16 [B, Sq, Hkv*G, D]; k/v bf16 [B, Skv, Hkv, D]; mask uint8
// [B, Sq, Skv] (nonzero = attend); out [B, Sq, Hkv*G, D], fp32 when
// out_f32 != 0, else bf16. All contiguous.
extern "C" int cvla_prefix_gqa(const void* q, const void* k, const void* v,
                               const void* mask, void* out, int B, int Sq,
                               int Skv, int Hkv, int G, int D, float scale,
                               int out_f32, void* stream) {
  if (Sq <= 0 || Skv <= 0 || Hkv <= 0 || G <= 0)
    return int(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.k_suf = nullptr;
  p.v_suf = nullptr;
  p.key_valid = nullptr;
  p.suffix_mask = nullptr;
  p.mask = static_cast<const uint8_t*>(mask);
  p.out = out_f32 ? nullptr : static_cast<__nv_bfloat16*>(out);
  p.out_f32 = out_f32 ? static_cast<float*>(out) : nullptr;
  p.hkv = Hkv;
  p.groups = G;
  p.rows = Sq * G;
  p.d = D;
  p.n_keys = Skv;
  p.n_cand = 0;
  p.s_len = 0;
  p.scale = scale;
  return dispatch<true>(p, B * Hkv, static_cast<cudaStream_t>(stream));
}
