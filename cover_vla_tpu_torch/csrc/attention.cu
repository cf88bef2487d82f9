// K1: the warpgroup decode-attention body in decode_wgmma.cuh (see the notes
// there), behind a plain C interface. The tensor maps of the TMA loads are
// encoded here, on the host, for every call.

#include <cuda.h>

#include "decode_wgmma.cuh"

namespace {

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// the CUDA driver's cuTensorMapEncodeTiled, looked up once through the runtime
// (no link against libcuda)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// a bf16 tensor of `rank` dims (innermost first, strides in bytes of dims
// 1..rank-1), read in boxes of `box` with the 128-byte swizzle; elements
// outside the tensor read as zero
bool encode(CUtensorMap* map, const void* ptr, cuuint32_t rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// K1. q [B, N, S, Hkv*G, D]; k_suf/v_suf [B, N, S, Hkv, D];
// k_pre/v_pre [B, P, Hkv, D]; prefix_pad uint8 [B, P]; suffix_mask uint8
// [B, S, S]; out [B, N, S, Hkv*G, D]. All bf16 unless noted, contiguous,
// 16-byte aligned. `split`: the parts the P keys are cut into, the blocks
// of a cluster (cuda_attention.decode_plan); each part gets
// ceil(ceil(P / 64) / split) key tiles and none may be empty.
extern "C" int cvla_shared_prefix_gqa(
    const void* q, const void* k_suf, const void* v_suf, const void* k_pre,
    const void* v_pre, const void* prefix_pad, const void* suffix_mask,
    void* out, int B, int N, int S, int Hkv, int G, int P, int D, int split,
    float scale, void* stream) {
  if (B <= 0 || S <= 0 || S > 32 || N <= 0 || G <= 0 || Hkv <= 0 || P <= 0 ||
      D <= 0 || D % 8 != 0 || D > 256 || split < 1 || split > kMaxSplit)
    return int(cudaErrorInvalidValue);
  const int n_tiles = (P + kTileKeys - 1) / kTileKeys;
  const int tiles_per_part = (n_tiles + split - 1) / split;
  if ((n_tiles + tiles_per_part - 1) / tiles_per_part != split)
    return int(cudaErrorInvalidValue);  // an empty part
  if (!aligned16(q) || !aligned16(k_suf) || !aligned16(v_suf) ||
      !aligned16(k_pre) || !aligned16(v_pre) || !aligned16(out))
    return int(cudaErrorInvalidValue);

  DecodeParams p;
  const cuuint64_t row = cuuint64_t(D) * 2;  // bytes of one head's vector
  {
    const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(Hkv), cuuint64_t(P),
                                cuuint64_t(B)};
    const cuuint64_t strides[3] = {row, row * Hkv, row * Hkv * P};
    const cuuint32_t box[4] = {64, 1, kTileKeys, 1};
    if (!encode(&p.kp, k_pre, 4, dims, strides, box) ||
        !encode(&p.vp, v_pre, 4, dims, strides, box))
      return int(cudaErrorInvalidValue);
  }
  {
    const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(Hkv),
                                cuuint64_t(B) * N * S};
    const cuuint64_t strides[2] = {row, row * Hkv};
    const cuuint32_t box[3] = {64, 1, kSufKeys};
    if (!encode(&p.ks, k_suf, 3, dims, strides, box) ||
        !encode(&p.vs, v_suf, 3, dims, strides, box))
      return int(cudaErrorInvalidValue);
  }
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.prefix_pad = static_cast<const uint8_t*>(prefix_pad);
  p.suffix_mask = static_cast<const uint8_t*>(suffix_mask);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.hkv = Hkv;
  p.groups = G;
  p.rows = N * S * G;
  p.d = D;
  p.n_keys = P;
  p.n_cand = N;
  p.s_len = S;
  p.row_ctas = (p.rows + kCtaRows - 1) / kCtaRows;
  p.split = split;
  p.tiles_per_part = tiles_per_part;
  p.scale_log2 = scale * 1.4426950408889634f;
  const int batch_heads = B * Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return decode_launch<64>(p, batch_heads, s);
  if (D <= 128) return decode_launch<128>(p, batch_heads, s);
  if (D <= 192) return decode_launch<192>(p, batch_heads, s);
  return decode_launch<256>(p, batch_heads, s);
}
