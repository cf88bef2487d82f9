"""The benchmark's yardstick: peaks, model FLOPs, the hand kernels' work on
the cell's shapes, the union of device intervals and the categories of
device events. Frozen copies, so that a change to the program cannot move
the ruler it is measured with:

- `PEAK_*`, `merged_len`, `analytic_flops`: `cover_vla_tpu_torch/bench.py`
  (`PEAK_FLOPS`, `PEAK_INT8_OPS`, `PEAK_FP32_FLOPS`, `PEAK_HBM_BYTES`,
  `_merged_len`, `_vit_matmul_params`, `_analytic_flops`) at commit
  5a2a5d9; the backbone's part of the FLOPs is its module's
  `policy_flops` (`coverbench/backbones/`);
- `k2_work`: `cover_vla_tpu_torch/ops/kernel_work.py` at 5a2a5d9,
  rewritten to take shapes instead of the program's tensors (the
  backbone's kernels' work is its module's `kernel_work`);
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


def _vit_matmul_params(v: dict) -> float:
    return v["depth"] * (4 * v["width"] ** 2 + 2 * v["width"] * v["mlp_dim"])


def num_patches(v: dict) -> int:
    return (v["image_size"] // v["patch_size"]) ** 2


def analytic_flops(config: dict, k: int, n: int, episodes: int) -> float:
    """Model FLOPs (2 a multiply-add) of one verified step over `episodes`
    episodes with K prompts and N candidates each: the policy's vision
    tower, its backbone's K prompt prefills and Euler-loop decode over N
    candidates (the backbone's `policy_flops`), and the verifier's
    towers."""
    from coverbench import backbones
    policy, verifier = config["policy"], config["verifier"]
    pv = policy["vision"]
    vision = 2 * _vit_matmul_params(pv) * num_patches(pv)
    policy_part = backbones.load(config).policy_flops(policy, k, n)

    vv, vt = verifier["vision"], verifier["text"]
    v_patches = num_patches(vv)
    ver = 2 * _vit_matmul_params(vv) * v_patches
    ver += 2 * 2 * vv["depth"] * v_patches ** 2 * vv["width"]
    ver += 2 * _vit_matmul_params(vt) * vt["context_length"]
    return episodes * (vision + policy_part + ver)


# ---------------------------------------------------------------------------
# The hand kernels' work on shapes: (bytes, FLOPs) of ONE launch. Each input
# is read once and the bf16 result written once; the FLOPs are those of the
# (query, key) pairs the masks let attend.
# ---------------------------------------------------------------------------


def k2_work(b: int, s: int, h: int, d: int):
    """K2 `mha_dense`: q/k/v [B, S, H, D] bf16, every query over every key."""
    qkv = b * s * h * d * BF16
    return float(4 * qkv), float(4 * b * h * s * s * d)


# ---------------------------------------------------------------------------
# Categories of device events
# ---------------------------------------------------------------------------

# the wgmma flash body's symbol as a trace names it (K2 with its EXACT
# flag off; a backbone's `KERNELS` name its own uses of it):
#   void (anonymous namespace)::flash_wgmma_kernel<64, 3, false>(...WgParams)
K23_SYMBOL = "flash_wgmma_kernel<"


def flash_exact(name: str):
    """The EXACT flag (the template's last argument) of a flash body's
    symbol; None for any other symbol."""
    if K23_SYMBOL not in name:
        return None
    args = name[name.index(K23_SYMBOL) + len(K23_SYMBOL):].split(">")[0]
    return args.replace(" ", "").endswith(",true")

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


def category(ev: dict, op, kernels: dict) -> str:
    """The category of a device event; `op` is the CPU operator joined to
    it through `External id` (None for K1-K3, copies without one, ...);
    `kernels`: the backbone's {kernel: predicate on the symbol}, consulted
    before the generic rules."""
    name = ev.get("name", "")
    low = name.lower()
    if ev.get("cat") in ("gpu_memcpy", "gpu_memset"):
        return "copy_memset"
    for kernel, match in kernels.items():
        if match(name):
            return kernel
    if flash_exact(name) is False:
        return "K2"
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
