"""Package boundary of the PyTorch port: it imports neither jax nor the
JAX package (nor safetensors, ml_dtypes, PIL, tensorflow, pyarrow, cv2,
matplotlib, gymnasium, simpler_env, libero or transformers, which a CUDA
installation need not have; yaml only where a YAML file is read, PIL only
where an encoded image is read, pyarrow and cv2 only where a LeRobot
dataset's tables and videos are, tensorflow only where an RT-1 SavedModel
is run, matplotlib only where a plot is drawn, the simulators only where
their environments are built), and its entry points do not fall back to
the CPU silently."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import cover_vla_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(cover_vla_tpu_torch.__file__)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="cover_vla_tpu_torch."))


def _sources():
    """chip_smoke.py, every file of the package and the port's scripts
    (`scripts/torch_*`)."""
    out = [os.path.join(ROOT, "chip_smoke.py")]
    scripts = os.path.join(ROOT, "scripts")
    out += sorted(os.path.join(scripts, f) for f in os.listdir(scripts)
                  if f.startswith("torch_"))
    for dirpath, _, files in os.walk(PKG_DIR):
        out += [os.path.join(dirpath, f) for f in files
                if f.endswith((".py", ".cu", ".cuh"))]
    return out


def test_every_module_imports_without_jax():
    mods = _modules()
    for name in ("engine.verified_step", "engine.cover_engine",
                 "engine.batched_engine", "eval.evaluator", "eval.fake_env",
                 "eval.adapters", "eval.fractal_adapters", "eval.benchmark",
                 "eval.rephrase", "data.tokenizer", "ops.cuda_attention",
                 "ops.quant", "models.pi0fast", "models.factory",
                 "data.fast_tokenizer", "serving", "serving.msgpack_numpy",
                 "serving.policy_service", "serving.policy_wrapper",
                 "eval.remote_evaluator", "convert.blob",
                 "convert.checkpoints", "convert.from_jax",
                 "convert.loaders", "convert.pi0_from_torch",
                 "convert.pi0fast_from_torch", "convert.verifier_from_torch",
                 "convert.verifier_to_torch", "utils", "utils.cli",
                 "utils.geometry", "utils.metrics_sink", "utils.monitor",
                 "utils.tree", "run", "training", "training.optim",
                 "training.quantized_optim", "training.train_pi0",
                 "training.validation", "data.pipeline", "data.augment",
                 "training.train_verifier", "training.train_pi0fast",
                 "eval.verifier_retrieval", "data.bridge_verifier_dataset",
                 "data.rlds", "parallel", "parallel.mesh",
                 "parallel.distributed", "data.normalize", "data.oxe",
                 "data.lerobot", "bench", "eval.sim_metrics",
                 "eval.analyze", "eval.lang_transform", "eval.simpler_utils",
                 "eval.aloha", "eval.simpler_integration", "eval.libero",
                 "eval.fake_expert", "robot", "robot.devices",
                 "serving.alt_policies", "serving.legacy_policies"):
        assert f"cover_vla_tpu_torch.{name}" in mods
    code = ("import sys\n"
            "for m in ('jax', 'cover_vla_tpu', 'safetensors', 'ml_dtypes',\n"
            "          'yaml', 'PIL', 'tensorflow', 'pyarrow', 'cv2',\n"
            "          'matplotlib', 'gymnasium', 'simpler_env', 'libero',\n"
            "          'transformers'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'cover_vla_tpu.'))\n"
            "               for k, v in sys.modules.items() if v is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_serving_imports_without_its_transport():
    """websockets and msgpack are imported inside the transport only: the
    serving package and the verb dispatch work without them."""
    code = ("import sys\n"
            "for m in ('jax', 'cover_vla_tpu', 'websockets', 'msgpack'):\n"
            "    sys.modules[m] = None\n"
            "from cover_vla_tpu_torch.serving import WebsocketPolicyServer\n"
            "import cover_vla_tpu_torch.eval.remote_evaluator\n"
            "import cover_vla_tpu_torch.models.factory\n"
            "class P:\n"
            "    def infer(self, obs): return {'a': obs['x'] + 1}\n"
            "    def reset(self): pass\n"
            "    def switch_model(self, path): pass\n"
            "s = WebsocketPolicyServer(P())\n"
            "assert s.dispatch({'type': 'infer', 'obs': {'x': 1}}) == {'a': 2}\n"
            "assert s.dispatch({'type': 'reset'}) == {'status': 'ok'}\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_source_names_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|cover_vla_tpu|safetensors"
                         r"|ml_dtypes)(\.|\s|$)", re.MULTILINE)
    top_level_yaml = re.compile(r"^(import|from)\s+yaml(\.|\s|$)",
                                re.MULTILINE)
    for path in _sources():
        with open(path) as f:
            text = f.read()
        assert not pattern.search(text), path
        assert not top_level_yaml.search(text), path
        assert "cover_vla_tpu." not in text.replace("cover_vla_tpu_torch.", ""), (
            f"{path} names a module of the JAX package")


def test_entry_points_refuse_silent_cpu(monkeypatch):
    from cover_vla_tpu_torch.configs import (
        CoVerConfig, tiny_pi0_config, tiny_verifier_config)
    from cover_vla_tpu_torch.data.stats import DatasetStatistics
    from cover_vla_tpu_torch.engine.verified_step import (
        make_verified_step_batched)
    from cover_vla_tpu_torch.models import pi0, verifier

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pi0.init_pi0(0, tiny_pi0_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        verifier.init_verifier(0, tiny_verifier_config())
    from cover_vla_tpu_torch.models import factory, pi0fast
    with pytest.raises(RuntimeError, match="CUDA"):
        pi0fast.init_pi0fast(0, pi0fast.tiny_pi0fast_config())
    for family in ("pi0", "pi0fast"):
        with pytest.raises(RuntimeError, match="CUDA"):
            factory.make_policy(family, tiny=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_verified_step_batched(tiny_pi0_config(), tiny_verifier_config(),
                                   CoVerConfig(n_samples=2, n_rephrases=2),
                                   DatasetStatistics.from_json())
    # an explicit CPU device is honoured
    pp = pi0.init_pi0(0, tiny_pi0_config(), device="cpu")
    assert pp["expert"]["final_norm"].device.type == "cpu"

    # the episode entry points: engines and the suite evaluator
    from cover_vla_tpu_torch.data.tokenizer import HashTokenizer
    from cover_vla_tpu_torch.engine import BatchedCoVerEngine, CoVerEngine
    from cover_vla_tpu_torch.engine.verified_step import (
        make_propose_step_batched, make_select_step_batched)
    from cover_vla_tpu_torch.eval.evaluator import (
        EvalConfig, evaluate_suite_batched)
    pcfg, vcfg = tiny_pi0_config(), tiny_verifier_config()
    ccfg = CoVerConfig(n_samples=2, n_rephrases=2)
    vp = verifier.init_verifier(0, vcfg, device="cpu")
    toks = dict(policy_tokenizer=HashTokenizer(pcfg.paligemma.vocab_size),
                verifier_tokenizer=HashTokenizer(vcfg.text.vocab_size,
                                                 add_bos=False))
    cfg = EvalConfig(task_suite="simpler_carrot_on_plate",
                     num_trials_per_task=1, max_steps=4)
    for build in (
            lambda **kw: CoVerEngine(pp, vp, pcfg, vcfg, ccfg, **toks, **kw),
            lambda **kw: BatchedCoVerEngine(pp, vp, pcfg, vcfg, ccfg,
                                            num_episodes=2, **toks, **kw),
            lambda **kw: evaluate_suite_batched(pp, vp, pcfg, vcfg, ccfg, cfg,
                                                n_parallel=1, **toks, **kw),
            lambda **kw: make_propose_step_batched(
                pcfg, vcfg, ccfg, DatasetStatistics.from_json(), **kw),
            lambda **kw: make_select_step_batched(ccfg, **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    assert CoVerEngine(pp, vp, pcfg, vcfg, ccfg, device="cpu", **toks
                       ).device.type == "cpu"
    assert BatchedCoVerEngine(pp, vp, pcfg, vcfg, ccfg, num_episodes=2,
                              device="cpu", **toks)._generator.device.type == "cpu"
    out = evaluate_suite_batched(pp, vp, pcfg, vcfg, ccfg, cfg, n_parallel=1,
                                 device="cpu", **toks)
    assert out["summary"]["total_episodes"] == 1


def test_package_level_names_build_no_kernel():
    """The names the JAX package's `__init__` files export import from the
    port's packages, in a fresh process, and importing them compiles and
    loads no kernel library."""
    code = (
        "import ctypes, sys\n"
        "for m in ('jax', 'cover_vla_tpu', 'ml_dtypes'):\n"
        "    sys.modules[m] = None\n"
        "loaded = []\n"
        "_cdll = ctypes.CDLL.__init__\n"
        "def spy(self, name, *a, **kw):\n"
        "    loaded.append(name)\n"
        "    _cdll(self, name, *a, **kw)\n"
        "ctypes.CDLL.__init__ = spy\n"
        "import cover_vla_tpu_torch\n"
        "assert cover_vla_tpu_torch.__version__ == '0.1.0'\n"
        "from cover_vla_tpu_torch.ops import (\n"
        "    rms_norm, layer_norm, apply_rope, make_att_2d_masks,\n"
        "    prefix_att_masks, suffix_att_masks, gqa_attention,\n"
        "    mha_attention, BIG_NEG, resize_bilinear_torch, resize_lanczos4,\n"
        "    resize_bicubic_pil, resize_with_pad, to_siglip_range, patchify,\n"
        "    sinusoidal_time_embedding, sample_beta, sample_flow_time,\n"
        "    sample_noise)\n"
        "from cover_vla_tpu_torch.ops.attention import (\n"
        "    set_fast_math, score_precision)\n"
        "from cover_vla_tpu_torch.data import (\n"
        "    DatasetStatistics, FieldStats, BRIDGE_STATS_PATH,\n"
        "    normalize_bound, denormalize_bound, normalize_gaussian,\n"
        "    denormalize_gaussian)\n"
        "import cover_vla_tpu_torch.models as models\n"
        "import cover_vla_tpu_torch.convert as convert\n"
        "import cover_vla_tpu_torch.training as training\n"
        "models.gemma, models.siglip, models.pi0, convert.checkpoints\n"
        "training.optim, training.train_pi0, training.train_pi0fast\n"
        "from cover_vla_tpu_torch import _build\n"
        "assert _build.load.cache_info().currsize == 0\n"
        "assert not any('kernels-' in str(p) for p in loaded), loaded\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
