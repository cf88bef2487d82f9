// K1: the flash-attention body in flash_rows.cuh (see the notes there),
// behind a plain C interface.

#include "flash_rows.cuh"

// K1. q [B, N, S, Hkv*G, D]; k_suf/v_suf [B, N, S, Hkv, D];
// k_pre/v_pre [B, P, Hkv, D]; prefix_pad uint8 [B, P]; suffix_mask uint8
// [B, S, S]; out [B, N, S, Hkv*G, D]. All bf16 unless noted, contiguous.
extern "C" int cvla_shared_prefix_gqa(
    const void* q, const void* k_suf, const void* v_suf, const void* k_pre,
    const void* v_pre, const void* prefix_pad, const void* suffix_mask,
    void* out, int B, int N, int S, int Hkv, int G, int P, int D,
    float scale, void* stream) {
  if (S <= 0 || S > 32 || N <= 0 || G <= 0 || Hkv <= 0 || P < 0)
    return int(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k_pre);
  p.v = static_cast<const __nv_bfloat16*>(v_pre);
  p.k_suf = static_cast<const __nv_bfloat16*>(k_suf);
  p.v_suf = static_cast<const __nv_bfloat16*>(v_suf);
  p.key_valid = static_cast<const uint8_t*>(prefix_pad);
  p.suffix_mask = static_cast<const uint8_t*>(suffix_mask);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.hkv = Hkv;
  p.groups = G;
  p.rows = N * S * G;
  p.d = D;
  p.n_keys = P;
  p.n_cand = N;
  p.s_len = S;
  p.scale = scale;
  return dispatch(p, B * Hkv, static_cast<cudaStream_t>(stream));
}
