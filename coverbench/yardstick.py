"""The benchmark's yardstick: peaks, model FLOPs, the hand kernels' work on
the cell's shapes, the union of device intervals and the categories of
device events. Frozen copies, so that a change to the program cannot move
the ruler it is measured with:

- `PEAK_*`, `merged_len`, `analytic_flops`: `cover_vla_tpu_torch/bench.py`
  (`PEAK_FLOPS`, `PEAK_INT8_OPS`, `PEAK_FP32_FLOPS`, `PEAK_HBM_BYTES`,
  `_merged_len`, `_gemma_matmul_params`, `_vit_matmul_params`,
  `_analytic_flops`) at commit 5a2a5d9;
- `k1_work`, `k2_work`, `k3_work`: `cover_vla_tpu_torch/ops/kernel_work.py`
  at 5a2a5d9, rewritten to take shapes and valid-token counts that the
  harness made instead of the program's tensors;
- `category` and its tables: `scripts/torch_roofline.py` at 5a2a5d9 (the
  sub-window traces the host's operators too, so an int8 GEMM is
  categorised by the `aten::_int_mm` that launched it).

Configurations are plain dicts as `coverbench/configs/<name>.json` holds
them (the `policy` and `verifier` groups).
"""

from __future__ import annotations

# dense peaks of NVIDIA's data sheets, by `torch.cuda.get_device_name()`
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12, "NVIDIA H100 PCIe": 756e12}
PEAK_INT8_OPS = {"NVIDIA H100 80GB HBM3": 1979e12, "NVIDIA H100 PCIe": 1513e12}
PEAK_FP32_FLOPS = {"NVIDIA H100 80GB HBM3": 67e12, "NVIDIA H100 PCIe": 51e12}
PEAK_HBM_BYTES = {"NVIDIA H100 80GB HBM3": 3.35e12, "NVIDIA H100 PCIe": 2.0e12}

# chrome-trace categories of work on the device
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

BF16 = 2   # bytes of an element of the kernels' operands and results


def merged_len(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


# ---------------------------------------------------------------------------
# Model FLOPs of one chunk boundary
# ---------------------------------------------------------------------------


def _gemma_matmul_params(g: dict) -> float:
    qd = g["num_heads"] * g["head_dim"]
    kvd = g["num_kv_heads"] * g["head_dim"]
    return g["depth"] * (g["width"] * qd + 2 * g["width"] * kvd
                         + qd * g["width"] + 3 * g["width"] * g["mlp_dim"])


def _vit_matmul_params(v: dict) -> float:
    return v["depth"] * (4 * v["width"] ** 2 + 2 * v["width"] * v["mlp_dim"])


def _num_patches(v: dict) -> int:
    return (v["image_size"] // v["patch_size"]) ** 2


def analytic_flops(policy: dict, verifier: dict, k: int, n: int,
                   episodes: int) -> float:
    """Model FLOPs (2 a multiply-add) of one verified step over `episodes`
    episodes with K prompts and N candidates each: the policy's vision
    tower, K prompt prefills through PaliGemma, the Euler-loop expert decode
    over N candidates attending the cached prefix, the attention products,
    and the verifier's towers."""
    pg, ex, pv = policy["paligemma"], policy["expert"], policy["vision"]
    p_len = _num_patches(pv) + policy["tokenizer_max_length"]
    s_len = 1 + policy["chunk_size"]
    qd_pg = pg["num_heads"] * pg["head_dim"]
    qd_ex = ex["num_heads"] * ex["head_dim"]

    vision = 2 * _vit_matmul_params(pv) * _num_patches(pv)
    prefill = 2 * _gemma_matmul_params(pg) * k * p_len
    prefill += 2 * 2 * pg["depth"] * k * p_len * p_len * qd_pg
    dec_tokens = policy["num_denoise_steps"] * k * n * s_len
    decode = 2 * _gemma_matmul_params(ex) * dec_tokens
    decode += 2 * 2 * ex["depth"] * dec_tokens * (p_len + s_len) * qd_ex

    vv, vt = verifier["vision"], verifier["text"]
    v_patches = _num_patches(vv)
    ver = 2 * _vit_matmul_params(vv) * v_patches
    ver += 2 * 2 * vv["depth"] * v_patches ** 2 * vv["width"]
    ver += 2 * _vit_matmul_params(vt) * vt["context_length"]
    return episodes * (vision + prefill + decode + ver)


# ---------------------------------------------------------------------------
# The hand kernels' work on shapes: (bytes, FLOPs) of ONE launch. Each input
# is read once and the bf16 result written once; the FLOPs are those of the
# (query, key) pairs the masks let attend.
# ---------------------------------------------------------------------------


def k1_work(rows_valid_prefix, n: int, s: int, hq: int, hkv: int, d: int,
            p_len: int):
    """K1 `shared_prefix_gqa` over B = len(rows_valid_prefix) prefix rows,
    each with N candidates of S suffix tokens: q [B, N, S, Hq, D], k/v
    suffix [B, N, S, Hkv, D], k/v prefix [B, P, Hkv, D], the prefix pad
    mask bool [B, P] and the suffix mask bool [B, S, S]; every candidate's
    rows attend the row's valid prefix keys and its own suffix."""
    b = len(rows_valid_prefix)
    q = b * n * s * hq * d * BF16
    nbytes = (2 * q + 2 * b * n * s * hkv * d * BF16
              + 2 * b * p_len * hkv * d * BF16 + b * p_len + b * s * s)
    keys = sum(rows_valid_prefix) + b * s
    return float(nbytes), float(4 * n * s * hq * d * keys)


def k2_work(b: int, s: int, h: int, d: int):
    """K2 `mha_dense`: q/k/v [B, S, H, D] bf16, every query over every key."""
    qkv = b * s * h * d * BF16
    return float(4 * qkv), float(4 * b * h * s * s * d)


def k3_work(rows_valid, p_len: int, hq: int, hkv: int, d: int):
    """K3 `prefix_gqa`: q [B, P, Hq, D], k/v [B, P, Hkv, D], mask bool
    [B, P, P]; each row's valid tokens attend each other (the prefix is
    bidirectional over its valid tokens)."""
    b = len(rows_valid)
    q = b * p_len * hq * d * BF16
    nbytes = 2 * q + 2 * b * p_len * hkv * d * BF16 + b * p_len * p_len
    pairs = sum(v * v for v in rows_valid)
    return float(nbytes), float(4 * hq * d * pairs)


# ---------------------------------------------------------------------------
# Categories of device events
# ---------------------------------------------------------------------------

# the wgmma bodies' symbols as a trace names them:
#   void (anonymous namespace)::decode_wgmma_kernel<256>(...DecodeParams)
#   void (anonymous namespace)::flash_wgmma_kernel<64, 3, false>(...WgParams)
# (the template's last argument is K3's EXACT flag)
K1_SYMBOL = "decode_wgmma_kernel<"
K23_SYMBOL = "flash_wgmma_kernel<"

GEMM_OPS = {"aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
            "aten::mv", "aten::addmv", "aten::dot", "aten::_int_mm"}
GEMM_NAMES = ("nvjet", "gemm", "gemv", "cutlass", "xmma", "splitkreduce",
              "cublas")
INT8_NAMES = ("imma", "i8i8", "s8s8", "int8")
SOFTMAX_NORM_OPS = {"aten::_softmax", "aten::softmax", "aten::_log_softmax",
                    "aten::native_layer_norm", "aten::layer_norm",
                    "aten::rms_norm", "aten::_fused_rms_norm",
                    "aten::group_norm", "aten::native_group_norm"}
SOFTMAX_NORM_NAMES = ("softmax", "layer_norm", "layernorm", "rms_norm",
                      "rmsnorm")
INDEX_OPS = {"aten::index", "aten::index_select", "aten::gather",
             "aten::scatter", "aten::scatter_", "aten::scatter_add_",
             "aten::index_put_", "aten::_index_put_impl_", "aten::embedding",
             "aten::take_along_dim", "aten::masked_select", "aten::nonzero",
             "aten::index_add_", "aten::masked_scatter_"}
INDEX_NAMES = ("index", "gather", "scatter", "embedding", "nonzero")
REDUCTION_OPS = {"aten::sum", "aten::mean", "aten::amax", "aten::amin",
                 "aten::max", "aten::min", "aten::argmax", "aten::argmin",
                 "aten::prod", "aten::any", "aten::all", "aten::norm",
                 "aten::linalg_vector_norm", "aten::cumsum", "aten::var",
                 "aten::std", "aten::logsumexp"}
REDUCTION_NAMES = ("reduce_kernel", "reduce", "cumsum", "scan")
COPY_OPS = {"aten::copy_", "aten::cat", "aten::fill_", "aten::zero_",
            "aten::clone", "aten::contiguous", "aten::_to_copy"}
COPY_NAMES = ("copy_kernel", "catarray", "fillfunctor", "memcpy", "memset")
HALF_TYPES = ("c10::BFloat16", "c10::Half")

GEMM_CATEGORIES = ("gemm_bf16", "gemm_fp32", "gemm_int8")
GLUE_CATEGORIES = ("elementwise", "copy_memset", "reduction",
                   "softmax_norm", "index")


def category(ev: dict, op) -> str:
    """The category of a device event; `op` is the CPU operator joined to
    it through `External id` (None for K1-K3, copies without one, ...)."""
    name = ev.get("name", "")
    low = name.lower()
    if ev.get("cat") in ("gpu_memcpy", "gpu_memset"):
        return "copy_memset"
    if K1_SYMBOL in name:
        return "K1"
    if K23_SYMBOL in name:
        args = name[name.index(K23_SYMBOL) + len(K23_SYMBOL):].split(">")[0]
        return "K3" if args.replace(" ", "").endswith(",true") else "K2"
    op_name = op["name"] if op else ""
    if op_name == "aten::_int_mm" or any(s in low for s in INT8_NAMES):
        return "gemm_int8"
    if op_name in GEMM_OPS or any(s in low for s in GEMM_NAMES):
        types = (op or {}).get("args", {}).get("Input type") or []
        if op is not None and types:
            half = any(t in HALF_TYPES for t in types)
        else:
            half = not any(s in low for s in ("f32", "sgemm", "<float"))
        return "gemm_bf16" if half else "gemm_fp32"
    # the launching operator decides where the trace names one, else the
    # kernel's symbol
    for ops_, cat in ((SOFTMAX_NORM_OPS, "softmax_norm"), (INDEX_OPS, "index"),
                      (REDUCTION_OPS, "reduction"), (COPY_OPS, "copy_memset")):
        if op_name in ops_:
            return cat
    for names, cat in ((SOFTMAX_NORM_NAMES, "softmax_norm"),
                       (COPY_NAMES, "copy_memset"),
                       (REDUCTION_NAMES, "reduction"),
                       (("elementwise",), "elementwise"),
                       (INDEX_NAMES, "index")):
        if any(s in low for s in names):
            return cat
    return "other"
