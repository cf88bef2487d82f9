// Hand-written Hopper (sm_90a) decode attention kernel of the port, bound
// to Python through a plain C interface (ctypes). This header holds the
// flash-attention body of K1, which attention.cu instantiates. (K2 and K3
// have their own warpgroup body, flash_wgmma.cuh.)
//
// A thread block owns up to 64 query rows of one (batch, kv-head) pair:
// 4 warps of 16 rows each. Key and value tiles of 32 keys are copied into
// shared memory with cp.async, two stages deep, so the copy of the next
// tile overlaps the products of this one. Scores come from bf16
// tensor-core products (mma.sync m16n8k16, fp32 accumulation; V's operands
// read transposed with ldmatrix.trans) and run through one fp32 online
// softmax. Probabilities are rounded to bf16 before the PV product and the
// running row sum adds the rounded values. The output is divided by the
// row sum at the end. These are the rounding points of the TPU kernel this
// file replaces.
//
// K1  cvla_shared_prefix_gqa
//     Replaces cover_vla_tpu/ops/pallas_attention.py pallas_shared_prefix_gqa
//     (_shared_prefix_kernel): candidate-suffix decode attention of the pi0
//     action expert. The rows of a (batch, kv-head) pair are its N*S*G
//     query rows, candidate-major. They attend the shared prefix keys (the
//     prefill's KV cache, padded keys masked) and then each candidate's own
//     S suffix keys under the S x S suffix mask, in one softmax. The prefix
//     is read once per row tile, never replicated over candidates.
//     Bound on the H100: at 16 episodes x 16 candidates (q 5.2 MB, prefix
//     K/V 5.4 MB, suffix K/V 1.3 MB, output 5.2 MB, ~3.5 GFLOP) one launch
//     needs about 5 us of memory traffic and 3.5 us of bf16 tensor-core
//     time: memory bound. The design keeps scores and probabilities in
//     registers (no [rows, P] score tensor in device memory) and reads the
//     prefix tiles through shared memory, so device traffic stays near the
//     inputs once plus L2 re-reads across row tiles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kBigNeg = -2.3819763e38f;  // masking constant of the reference
constexpr int kRows = 64;                  // query rows per block
constexpr int kKeys = 32;                  // keys per shared-memory tile
constexpr int kThreads = 128;              // 4 warps x 16 rows
constexpr int kMaxSuffixMask = 1024;       // bytes: S x S suffix mask, S <= 32

struct Params {
  const __nv_bfloat16* q;      // [B, rows / groups, hkv * groups, d]
  const __nv_bfloat16* k;      // [B, n_keys, hkv, d]
  const __nv_bfloat16* v;      // [B, n_keys, hkv, d]
  const __nv_bfloat16* k_suf;  // [B, n_cand, s_len, hkv, d] or null
  const __nv_bfloat16* v_suf;  // [B, n_cand, s_len, hkv, d] or null
  const uint8_t* key_valid;    // [B, n_keys] or null (all keys valid)
  const uint8_t* suffix_mask;  // [B, s_len, s_len] or null
  __nv_bfloat16* out;          // same layout as q
  int hkv;     // key/value heads
  int groups;  // query heads per key/value head
  int rows;    // query rows per (batch, kv head)
  int d;       // head dim
  int n_keys;  // main (prefix) keys per batch row
  int n_cand;  // candidates (suffix mode)
  int s_len;   // suffix tokens per candidate (suffix mode)
  float scale;
};

__device__ __forceinline__ void mma_16816(float (&c)[4], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that does not pass through registers;
// with valid == false nothing is read and the destination is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices, transposed: the B operands of two m16n8k16
// products read from a row-major [key][d] tile
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

constexpr int kStages = 2;                 // key/value tiles in flight

template <int DP>
constexpr size_t smem_bytes() {
  return (size_t(kRows) + 2 * kStages * kKeys) * (DP + 8) *
             sizeof(__nv_bfloat16) +
         kStages * kKeys * sizeof(int) + kMaxSuffixMask;
}

// DP: head dim padded to a multiple of 16 (the mma depth).
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_rows_kernel(const Params p) {
  constexpr int QS = DP + 8;     // row stride of every tile (conflict-free)
  constexpr int CPR = DP / 8;    // 16-byte chunks per padded row
  constexpr int NT = kKeys / 8;  // score n-tiles per key tile
  constexpr int DT = DP / 8;     // output n-tiles
  constexpr int TILE = kKeys * QS;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // [kRows][QS]
  __nv_bfloat16* sK = sQ + kRows * QS;               // [kStages][kKeys][QS]
  __nv_bfloat16* sV = sK + kStages * TILE;           // [kStages][kKeys][QS]
  int* sInfo = reinterpret_cast<int*>(sV + kStages * TILE);  // [kStages][kKeys]
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sInfo + kStages * kKeys);

  const int b = blockIdx.x / p.hkv;
  const int kvh = blockIdx.x % p.hkv;
  const int r0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hq = p.hkv * p.groups;
  const int rows_per_b = p.rows / p.groups;

  auto q_offset = [&](int r) -> size_t {
    return ((size_t(b) * rows_per_b + r / p.groups) * hq + kvh * p.groups +
            r % p.groups) * size_t(p.d);
  };

  // query tile, zero-padded past the last row and past d
  for (int i = tid; i < kRows * CPR; i += kThreads) {
    const int rr = i / CPR, c = (i % CPR) * 8;
    const int r = r0 + rr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < p.rows && c < p.d)
      val = *reinterpret_cast<const uint4*>(p.q + q_offset(r) + c);
    *reinterpret_cast<uint4*>(sQ + rr * QS + c) = val;
  }
  const bool suffix_mode = p.k_suf != nullptr;
  if (suffix_mode) {
    const int ss = p.s_len * p.s_len;
    for (int i = tid; i < ss; i += kThreads)
      sMask[i] = p.suffix_mask[size_t(b) * ss + i];
  }

  // the two rows this thread holds in the mma fragments
  int row_n[2], row_s[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + warp * 16 + g + 8 * h;
    row_n[h] = suffix_mode ? r / (p.s_len * p.groups) : 0;
    row_s[h] = suffix_mode ? (r / p.groups) % p.s_len : 0;
  }
  int n_first = 0, n_suf = 0;
  if (suffix_mode) {
    const int per_cand = p.s_len * p.groups;
    const int last = min(r0 + kRows, p.rows) - 1;
    n_first = r0 / per_cand;
    n_suf = (last / per_cand - n_first + 1) * p.s_len;
  }

  float m_i[2] = {kBigNeg, kBigNeg};
  float l_i[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  // key tiles: the prefix (or all keys) first, then the suffix keys of
  // the candidates this row tile spans; tile i+1 is copied while tile i
  // is computed
  const int n_main = (p.n_keys + kKeys - 1) / kKeys;
  const int n_tiles = n_main + (n_suf + kKeys - 1) / kKeys;

  auto load_tile = [&](int tile, int stage) {
    const bool suffix = tile >= n_main;
    const int j0 = (suffix ? tile - n_main : tile) * kKeys;
    const int n_tile_keys = suffix ? n_suf : p.n_keys;
    const __nv_bfloat16* kbase = suffix ? p.k_suf : p.k;
    const __nv_bfloat16* vbase = suffix ? p.v_suf : p.v;
    __nv_bfloat16* dk = sK + stage * TILE;
    __nv_bfloat16* dv = sV + stage * TILE;
    for (int i = tid; i < kKeys * CPR; i += kThreads) {
      const int jj = i / CPR, c = (i % CPR) * 8;
      const int j = j0 + jj;
      const bool valid = j < n_tile_keys && c < p.d;
      size_t off = 0;
      if (valid) {
        if (suffix) {
          const int n = n_first + j / p.s_len, tt = j % p.s_len;
          off = ((size_t(b) * p.n_cand + n) * p.s_len + tt) * p.hkv + kvh;
        } else {
          off = (size_t(b) * p.n_keys + j) * p.hkv + kvh;
        }
        off = off * p.d + c;
      }
      cp_async16(dk + jj * QS + c, kbase + off, valid);
      cp_async16(dv + jj * QS + c, vbase + off, valid);
    }
    // per-key validity: main keys -> 0/1; suffix keys -> (cand << 8) | pos
    for (int jj = tid; jj < kKeys; jj += kThreads) {
      const int j = j0 + jj;
      int info;
      if (suffix) {
        info = j < n_tile_keys
                   ? (((n_first + j / p.s_len) << 8) | (j % p.s_len))
                   : -1;
      } else {
        info = j < p.n_keys &&
               (p.key_valid == nullptr ||
                p.key_valid[size_t(b) * p.n_keys + j] != 0);
      }
      sInfo[stage * kKeys + jj] = info;
    }
  };

  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) {
      load_tile(tile + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool suffix = tile >= n_main;
    const __nv_bfloat16* tk = sK + stage * TILE;
    const __nv_bfloat16* tv = sV + stage * TILE;
    const int* info_row = sInfo + stage * kKeys;

    // scores S = Q K^T for this warp's 16 rows x 32 keys
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const __nv_bfloat16* qa = sQ + (warp * 16 + g) * QS + kk * 16 + t * 2;
      const uint32_t a0 = ld_u32(qa), a1 = ld_u32(qa + 8 * QS);
      const uint32_t a2 = ld_u32(qa + 8), a3 = ld_u32(qa + 8 * QS + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kb = tk + (nt * 8 + g) * QS + kk * 16 + t * 2;
        mma_16816(sc[nt], a0, a1, a2, a3, ld_u32(kb), ld_u32(kb + 8));
      }
    }

    // scale + mask, then one online-softmax update per row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kBigNeg;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int info = info_row[nt * 8 + t * 2 + e];
          bool valid;
          if (suffix) {
            valid = info >= 0 && (info >> 8) == row_n[h] &&
                    sMask[row_s[h] * p.s_len + (info & 0xff)] != 0;
          } else {
            valid = info != 0;
          }
          const float s = valid ? sc[nt][2 * h + e] * p.scale : kBigNeg;
          sc[nt][2 * h + e] = s;
          mx = fmaxf(mx, s);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[h], mx);
      const float alpha = expf(m_i[h] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float prob = round_bf16(expf(sc[nt][2 * h + e] - m_new));
          sc[nt][2 * h + e] = prob;
          rs += prob;
        }
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_i[h] = l_i[h] * alpha + rs;
      m_i[h] = m_new;
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        acc[dn][2 * h] *= alpha;
        acc[dn][2 * h + 1] *= alpha;
      }
    }

    // O += P V: the score fragments are the A operand (bf16-exact
    // values); V's B operands come transposed out of the row-major tile
#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16(sc[2 * kc][0], sc[2 * kc][1]);
      a[1] = pack_bf16(sc[2 * kc][2], sc[2 * kc][3]);
      a[2] = pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]);
      a[3] = pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3]);
#pragma unroll
      for (int dn = 0; dn < DT; dn += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(
            bv, tv + (kc * 16 + (lane & 15)) * QS + (dn + (lane >> 4)) * 8);
        mma_16816(acc[dn], a[0], a[1], a[2], a[3], bv[0], bv[1]);
        mma_16816(acc[dn + 1], a[0], a[1], a[2], a[3], bv[2], bv[3]);
      }
    }
    __syncthreads();
  }

  // epilogue: divide by the row sum, store d columns as bf16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + warp * 16 + g + 8 * h;
    if (r < p.rows) {
      const float l = fmaxf(l_i[h], 1e-37f);
      const size_t off = q_offset(r);
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        const int c = dn * 8 + t * 2;
        if (c >= p.d) continue;
        const float o0 = acc[dn][2 * h] / l, o1 = acc[dn][2 * h + 1] / l;
        *reinterpret_cast<__nv_bfloat162*>(p.out + off + c) =
            __floats2bfloat162_rn(o0, o1);
      }
    }
  }
}

template <int DP>
int launch(const Params& p, int batch_heads, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_rows_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(batch_heads, (p.rows + kRows - 1) / kRows);
  flash_rows_kernel<DP><<<grid, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

inline int dispatch(const Params& p, int batch_heads, cudaStream_t stream) {
  if (p.d <= 0 || p.d % 8 != 0 || p.rows <= 0 || batch_heads <= 0)
    return int(cudaErrorInvalidValue);
  if (p.d <= 16) return launch<16>(p, batch_heads, stream);
  if (p.d <= 32) return launch<32>(p, batch_heads, stream);
  if (p.d <= 64) return launch<64>(p, batch_heads, stream);
  if (p.d <= 80) return launch<80>(p, batch_heads, stream);
  if (p.d <= 128) return launch<128>(p, batch_heads, stream);
  if (p.d <= 256) return launch<256>(p, batch_heads, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace
