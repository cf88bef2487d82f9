// cvla_act_quant and cvla_rescale: the glue of the int8 (w8a8) route
// around torch._int_mm, behind a plain C interface.
//
// Replaces no Pallas kernel: cover_vla_tpu/ops/quant.py is plain jnp, which
// XLA fuses around the int8 dot. Run eagerly, the same arithmetic took ten
// launches for an activation quant and four for a rescale, each pass over
// fp32 temporaries in device memory (about 47 bytes moved an activation
// element where 3 are needed, about 30 an output element where 6 are).
//
//   act_quant  [M, K] bf16 or fp32 -> int8 [M, K] and the fp32 per-row
//              scale: scale = max(amax(|x|) / 127, 1e-12) by IEEE division,
//              q = clamp(rint(x / scale), -127, 127) (round half to even).
//   rescale    int32 [M, N] accumulator, fp32 xs [M] and ws [N] -> out
//              [M, N] bf16 or fp32: out = to_out((float(acc) * xs) * ws),
//              two fp32 multiplies rounded one at a time; with a bias
//              (the ViT's dense layers) out = to_out(float(out) + bias),
//              which is the eager `int8_matmul(...) + bias`.
//
// Both are bound by device memory: they read and write each element once
// and do a few operations on it (at 3.35 TB/s an [83,968 x 16,384] bf16
// quant moves 4.1 GB, 1.2 ms; its rescale 8.3 GB, 2.5 ms). The design
// moves the least bytes the results need: one read of each input, one
// write of each output, 16-byte loads, nothing in between in device
// memory. The quant keeps its whole row in registers between the row's
// maximum and its rounding (one block a row, the threads and the loads
// each thread keeps in flight adapted to K); the rescale keeps four
// 16-byte loads a thread in flight. Per element the quant would spend as
// much issue time as its bytes take with an IEEE division (a MUFU
// reciprocal and a range check each) and an F2I conversion, so it takes
// the row's maximum by redux on the magnitudes' bits, divides a bf16 row
// by one reciprocal a row and one FMA residual step (see `quotient`), and
// rounds and converts with one addition. The results are bit-equal to
// ops/quant.py's plain twins: the scale by IEEE division, the quotient
// the IEEE one (fp32 rows divide by __fdiv_rn itself), the rescale by
// __fmul_rn / __fadd_rn, which the compiler never contracts into an FMA,
// and round-to-nearest-even casts.
//
// The symbols are named for the benchmark's trace categories, which file a
// kernel by substrings of its name: the quant's holds "reduce" (a
// reduction over the row) and the rescale's "elementwise", so both count
// as the glue they are and neither as an int8 GEMM (no "int8", "imma",
// "gemm", "cutlass").

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kQuantRowThreads = 128;  // threads a row aims for
constexpr int kQuantThreads = 256;     // and takes at most
constexpr int kRescaleThreads = 256;
constexpr int kRescaleItems = 4;     // 16-byte loads a thread keeps in flight

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }

// |v| as the bits of an fp32: for non-negative floats the integer order is
// the float order, and a NaN's bits exceed infinity's, so an unsigned
// maximum of these keeps a NaN, as torch's amax does
__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// the row's maximum over the block: one redux a warp, one over the warps
__device__ __forceinline__ float block_amax(unsigned bits) {
  __shared__ unsigned warp_amax[kQuantThreads / 32];
  const int lane = threadIdx.x & 31;
  bits = __reduce_max_sync(0xffffffffu, bits);
  if (lane == 0) warp_amax[threadIdx.x >> 5] = bits;
  __syncthreads();
  bits = lane < int(blockDim.x >> 5) ? warp_amax[lane] : 0u;
  return __uint_as_float(__reduce_max_sync(0xffffffffu, bits));
}

// x / s rounded to nearest, as __fdiv_rn(x, s). For a bf16 x it is one
// multiplication by y = 1/s (rounded to nearest once a row) and one
// residual step by FMA, q0 + (x - s q0) y: equal to the IEEE quotient for
// every pair a bf16 row can hold (|x| <= amax, s = max(amax / 127, 1e-12)),
// which tests/test_torch_quant.py checks exhaustively on the card. An fp32
// x takes the IEEE division itself.
template <typename T>
__device__ __forceinline__ float quotient(float x, float s, float y) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const float q0 = __fmul_rn(x, y);
    return __fmaf_rn(__fmaf_rn(-q0, s, x), y, q0);
  } else {
    return __fdiv_rn(x, s);
  }
}

// clamp(rint(v), -127, 127) in the low byte (two's complement): adding
// 1.5 * 2^23 rounds to an integer, half to even, and leaves it in the low
// bits of the sum (exact for |v| < 2^22; v is finite here)
__device__ __forceinline__ unsigned round_to_int8_bits(float v) {
  v = fminf(fmaxf(v, -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(v, 12582912.0f));
}

// One block a row of K elements, read as K / VEC packs of VEC elements
// (16 bytes, or one element where the row is not 16-byte aligned); thread
// t keeps packs t, t + blockDim.x, ... (at most PER) in registers.
template <typename T, int VEC, int PER>
__global__ void __launch_bounds__(kQuantThreads)
act_quant_reduce_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                        float* __restrict__ scale, int K) {
  using In = Pack<T, VEC>;
  using Out = Pack<int8_t, VEC>;
  const int packs = K / VEC;
  const size_t row = blockIdx.x;
  const In* xr = reinterpret_cast<const In*>(x + row * K);
  In v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    if (j < packs) {
      v[i] = xr[j];
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[i].v[e] = T(0.0f);
    }
  }
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) bits = max(bits, abs_bits(to_f32(v[i].v[e])));
  const float amax = block_amax(bits);

  float s = __fdiv_rn(amax, 127.0f);
  s = s < 1e-12f ? 1e-12f : s;   // fmaxf, but a NaN stays NaN
  if (threadIdx.x == 0) scale[row] = s;
  // a NaN or an infinity in the row makes s NaN or infinite, and every
  // eager quotient NaN or 0, which the eager cast makes 0
  const bool finite = isfinite(s);
  const float y = __frcp_rn(s);

  Out* qr = reinterpret_cast<Out*>(q + row * K);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    if (j < packs) {
      Out o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const unsigned b = round_to_int8_bits(quotient<T>(to_f32(v[i].v[e]), s, y));
        o.v[e] = finite ? static_cast<int8_t>(b & 0xffu) : int8_t(0);
      }
      qr[j] = o;
    }
  }
}

template <bool BIAS>
__device__ __forceinline__ __nv_bfloat16 finish(float v, __nv_bfloat16 b) {
  const __nv_bfloat16 o = __float2bfloat16_rn(v);
  if (!BIAS) return o;
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(o),
                                       __bfloat162float(b)));
}

template <bool BIAS>
__device__ __forceinline__ float finish(float v, float b) {
  return BIAS ? __fadd_rn(v, b) : v;
}

// Pack p of the flat [rows, N] output, VEC elements of one row: N / VEC
// packs a row. Thread t of block b takes packs b * 4 * blockDim.x + t,
// + blockDim.x, ..., and loads all four before it computes.
template <typename OutT, int VEC, bool BIAS>
__global__ void __launch_bounds__(kRescaleThreads)
rescale_elementwise_kernel(const int32_t* __restrict__ acc,
                           const float* __restrict__ xs,
                           const float* __restrict__ ws,
                           const OutT* __restrict__ bias,
                           OutT* __restrict__ out, unsigned row_packs,
                           unsigned total) {
  using Acc = Pack<int32_t, VEC>;
  using W = Pack<float, VEC>;
  using O = Pack<OutT, VEC>;
  const Acc* a = reinterpret_cast<const Acc*>(acc);
  const W* w = reinterpret_cast<const W*>(ws);
  const O* bp = reinterpret_cast<const O*>(bias);
  O* op = reinterpret_cast<O*>(out);
  const unsigned first = blockIdx.x * (kRescaleItems * blockDim.x) + threadIdx.x;
  Acc av[kRescaleItems];
  float sx[kRescaleItems];
  W wv[kRescaleItems];
  O bv[kRescaleItems];
#pragma unroll
  for (int i = 0; i < kRescaleItems; ++i) {
    const unsigned p = first + i * blockDim.x;
    if (p < total) {
      const unsigned row = p / row_packs;
      const unsigned col = p - row * row_packs;
      av[i] = a[p];
      sx[i] = xs[row];
      wv[i] = w[col];
      if (BIAS) bv[i] = bp[col];
    }
  }
#pragma unroll
  for (int i = 0; i < kRescaleItems; ++i) {
    const unsigned p = first + i * blockDim.x;
    if (p < total) {
      O o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float v = __fmul_rn(__fmul_rn(__int2float_rn(av[i].v[e]), sx[i]),
                                  wv[i].v[e]);
        o.v[e] = finish<BIAS>(v, BIAS ? bv[i].v[e] : OutT(0.0f));
      }
      op[p] = o;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, int VEC, int PER>
cudaError_t quant_launch(const void* x, void* q, void* scale, int rows, int K,
                         int threads, cudaStream_t stream) {
  act_quant_reduce_kernel<T, VEC, PER><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scale), K);
  return cudaGetLastError();
}

// PER: the fewest packs a thread (1, 2, 4, 8 or 16) that keep a row within
// kQuantRowThreads threads (on the card, 128-thread rows beat 256-thread
// ones at K = 2048 and tie elsewhere), or else within kQuantThreads
template <typename T, int VEC>
cudaError_t quant_dispatch(const void* x, void* q, void* scale, int rows,
                           int K, cudaStream_t stream) {
  const int packs = K / VEC;
  int per = 1;
  while (per < 16 && (packs + per - 1) / per > kQuantRowThreads) per *= 2;
  const int threads = ((packs + per - 1) / per + 31) / 32 * 32;
  if (threads > kQuantThreads) return cudaErrorInvalidValue;
  switch (per) {
    case 1: return quant_launch<T, VEC, 1>(x, q, scale, rows, K, threads, stream);
    case 2: return quant_launch<T, VEC, 2>(x, q, scale, rows, K, threads, stream);
    case 4: return quant_launch<T, VEC, 4>(x, q, scale, rows, K, threads, stream);
    case 8: return quant_launch<T, VEC, 8>(x, q, scale, rows, K, threads, stream);
    default: return quant_launch<T, VEC, 16>(x, q, scale, rows, K, threads, stream);
  }
}

template <typename T>
cudaError_t quant_typed(const void* x, void* q, void* scale, int rows, int K,
                        cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (K % kVec == 0 && aligned16(x) && aligned16(q))
    return quant_dispatch<T, kVec>(x, q, scale, rows, K, stream);
  return quant_dispatch<T, 1>(x, q, scale, rows, K, stream);
}

template <typename OutT, int VEC, bool BIAS>
cudaError_t rescale_launch(const void* acc, const void* xs, const void* ws,
                           const void* bias, void* out, int rows, int N,
                           cudaStream_t stream) {
  const unsigned row_packs = unsigned(N / VEC);
  const unsigned total = unsigned(rows) * row_packs;
  const unsigned per_block = kRescaleThreads * kRescaleItems;
  rescale_elementwise_kernel<OutT, VEC, BIAS>
      <<<(total + per_block - 1) / per_block, kRescaleThreads, 0, stream>>>(
          static_cast<const int32_t*>(acc), static_cast<const float*>(xs),
          static_cast<const float*>(ws), static_cast<const OutT*>(bias),
          static_cast<OutT*>(out), row_packs, total);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t rescale_typed(const void* acc, const void* xs, const void* ws,
                          const void* bias, void* out, int rows, int N,
                          cudaStream_t stream) {
  // 4 int32 (16 bytes) a pack, where every row and the scales allow it
  const bool vec = N % 4 == 0 && aligned16(acc) && aligned16(ws)
                   && aligned16(out) && (bias == nullptr || aligned16(bias));
  if (vec)
    return bias ? rescale_launch<OutT, 4, true>(acc, xs, ws, bias, out, rows, N, stream)
                : rescale_launch<OutT, 4, false>(acc, xs, ws, bias, out, rows, N, stream);
  return bias ? rescale_launch<OutT, 1, true>(acc, xs, ws, bias, out, rows, N, stream)
              : rescale_launch<OutT, 1, false>(acc, xs, ws, bias, out, rows, N, stream);
}

}  // namespace

// x [rows, K] bf16 (in_f32 = 0) or fp32 (1); q int8 [rows, K]; scale fp32
// [rows]; all contiguous. K up to 16 x 256 packs: 32,768 bf16 or 16,384
// fp32 elements on 16-byte rows, 4,096 otherwise.
extern "C" int cvla_act_quant(const void* x, void* q, void* scale, int rows,
                              int K, int in_f32, void* stream) {
  if (rows <= 0 || K <= 0) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(in_f32 ? quant_typed<float>(x, q, scale, rows, K, st)
                    : quant_typed<__nv_bfloat16>(x, q, scale, rows, K, st));
}

// acc int32 [rows, N]; xs fp32 [rows]; ws fp32 [N]; bias [N] in the output's
// dtype, or null; out [rows, N] bf16 (out_f32 = 0) or fp32 (1); all
// contiguous; rows * N < 2^31.
extern "C" int cvla_rescale(const void* acc, const void* xs, const void* ws,
                            const void* bias, void* out, int rows, int N,
                            int out_f32, void* stream) {
  if (rows <= 0 || N <= 0 || int64_t(rows) * N >= (int64_t(1) << 31))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(out_f32 ? rescale_typed<float>(acc, xs, ws, bias, out, rows, N, st)
                     : rescale_typed<__nv_bfloat16>(acc, xs, ws, bias, out, rows, N, st));
}
