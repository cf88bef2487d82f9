"""PyTorch port vs the JAX package: torch-checkpoint conversion on the CPU.

The same numpy state dicts (made from seeds) go through the JAX converters
and the port's; the port's trees must equal `from_jax(<JAX tree>)` bit for
bit, leaf for leaf, dtype for dtype. Also: the port's bf16 cast rounds as
numpy/ml_dtypes does, the HF / torch forward parities of
tests/test_convert_parity.py hold on the port's forward, merged-ensemble
exports agree and load across the packages, and the port's own
.safetensors parser reads what the `safetensors` package writes."""

import dataclasses

import numpy as np
import jax
import ml_dtypes
import pytest
import torch

from cover_vla_tpu import configs as jconfigs
from cover_vla_tpu.convert import pi0_from_torch as jpi0conv
from cover_vla_tpu.convert import pi0fast_from_torch as jfastconv
from cover_vla_tpu.convert import verifier_from_torch as jvconv
from cover_vla_tpu.convert import verifier_to_torch as jvexport
from cover_vla_tpu.models import pi0fast as jpi0fast
from cover_vla_tpu.models import verifier as jverifier

from cover_vla_tpu_torch import configs
from cover_vla_tpu_torch.convert import pi0_from_torch as pi0conv
from cover_vla_tpu_torch.convert import pi0fast_from_torch as fastconv
from cover_vla_tpu_torch.convert import verifier_from_torch as vconv
from cover_vla_tpu_torch.convert import verifier_to_torch as vexport
from cover_vla_tpu_torch.convert.from_jax import (
    pi0_from_jax, pi0fast_from_jax, place_like, verifier_from_jax)
from cover_vla_tpu_torch.models import gemma, pi0fast, siglip, verifier
from cover_vla_tpu_torch.models.params import ParamTree

from tests.test_convert_parity import make_tiny_pi0_state_dict

TOL = dict(rtol=2e-3, atol=2e-4)     # tests/test_convert_parity.py's bound


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_trees_equal(got, want, where=""):
    """Same keys; every leaf the same dtype, shape and bits."""
    assert sorted(got) == sorted(want), where
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, (dict, ParamTree)):
            assert_trees_equal(g, w, f"{where}/{k}")
        else:
            assert g.dtype == w.dtype, (f"{where}/{k}", g.dtype, w.dtype)
            assert torch.equal(g, w), f"{where}/{k}"


# --------------------------------------------------------------------------
# state dicts (numpy, from seeds)
# --------------------------------------------------------------------------


def _rand(rng, *shape, scale=0.05):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _ln_sd(rng, sd, prefix, w, bias=True):
    sd[prefix + ".weight"] = 1.0 + _rand(rng, w, scale=0.1)
    if bias:
        sd[prefix + ".bias"] = _rand(rng, w)


def _lin_sd(rng, sd, prefix, o, i, bias=True):
    sd[prefix + ".weight"] = _rand(rng, o, i)
    if bias:
        sd[prefix + ".bias"] = _rand(rng, o, scale=0.02)


def _relayout(sd, old, new):
    return {(new + k[len(old):] if k.startswith(old) else k): v
            for k, v in sd.items()}


def _pi0_sd(layout):
    """The lerobot-layout tiny state dict, or the same tensors under the
    key names of later transformers versions, or of a bare
    PaliGemmaWithExpertModel."""
    sd = make_tiny_pi0_state_dict(configs.tiny_pi0_config())
    pali = "model.paligemma_with_expert.paligemma."
    if layout == "transformers_new":
        sd = _relayout(sd, pali + "language_model.model",
                       pali + "model.language_model")
        sd = _relayout(sd, pali + "vision_tower", pali + "model.vision_tower")
        sd = _relayout(sd, pali + "multi_modal_projector.linear",
                       pali + "model.multi_modal_projector")
    elif layout == "bare":
        sd = _relayout(sd, "model.paligemma_with_expert.", "")
    return sd


def _fast_cfgs():
    """pi0-FAST configs over the tiny pi0 towers, in both packages."""
    jp, tp = jconfigs.tiny_pi0_config(), configs.tiny_pi0_config()
    return (dataclasses.replace(jpi0fast.tiny_pi0fast_config(),
                                paligemma=jp.paligemma, vision=jp.vision),
            dataclasses.replace(pi0fast.tiny_pi0fast_config(),
                                paligemma=tp.paligemma, vision=tp.vision))


def _pi0fast_sd(root):
    sd = make_tiny_pi0_state_dict(configs.tiny_pi0_config())
    pali = "model.paligemma_with_expert.paligemma."
    return {root + k[len(pali):]: v for k, v in sd.items()
            if k.startswith(pali)}


def _backbone_sd(cfg, seed=11):
    """open_clip SigLIP2 layout: timm ViT trunk + custom text tower."""
    rng = np.random.default_rng(seed)
    sd = {}
    v, t = cfg.vision, cfg.text
    vt = "visual.trunk"
    sd[vt + ".patch_embed.proj.weight"] = _rand(rng, v.width, 3,
                                                v.patch_size, v.patch_size)
    sd[vt + ".patch_embed.proj.bias"] = _rand(rng, v.width)
    sd[vt + ".pos_embed"] = _rand(rng, 1, v.num_patches, v.width)
    for i in range(v.depth):
        p = f"{vt}.blocks.{i}."
        _ln_sd(rng, sd, p + "norm1", v.width)
        _lin_sd(rng, sd, p + "attn.qkv", 3 * v.width, v.width)
        _lin_sd(rng, sd, p + "attn.proj", v.width, v.width)
        _ln_sd(rng, sd, p + "norm2", v.width)
        _lin_sd(rng, sd, p + "mlp.fc1", v.mlp_dim, v.width)
        _lin_sd(rng, sd, p + "mlp.fc2", v.width, v.mlp_dim)
    _ln_sd(rng, sd, vt + ".norm", v.width)
    sd["text.token_embedding.weight"] = _rand(rng, t.vocab_size, t.width)
    sd["text.positional_embedding"] = _rand(rng, t.context_length, t.width)
    for i in range(t.depth):
        p = f"text.transformer.resblocks.{i}."
        _ln_sd(rng, sd, p + "ln_1", t.width)
        sd[p + "attn.in_proj_weight"] = _rand(rng, 3 * t.width, t.width)
        sd[p + "attn.in_proj_bias"] = _rand(rng, 3 * t.width)
        _lin_sd(rng, sd, p + "attn.out_proj", t.width, t.width)
        _ln_sd(rng, sd, p + "ln_2", t.width)
        _lin_sd(rng, sd, p + "mlp.c_fc", t.mlp_dim, t.width)
        _lin_sd(rng, sd, p + "mlp.c_proj", t.width, t.mlp_dim)
    _ln_sd(rng, sd, "text.ln_final", t.width)
    _lin_sd(rng, sd, "text.text_projection", t.embed_dim, t.width)
    return sd


@pytest.fixture(scope="module")
def jax_members():
    vp = jverifier.init_verifier(jax.random.PRNGKey(3),
                                 jconfigs.tiny_verifier_config(),
                                 num_members=2)
    return _np_tree(vp["members"])


# --------------------------------------------------------------------------
# bit-equal conversion
# --------------------------------------------------------------------------


def test_bf16_cast_rounds_as_numpy():
    """torch's fp32 -> bf16 cast gives ml_dtypes' bits: random values,
    exact halfway cases (ties to even, both parities), subnormals,
    extremes and infinities."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    ties = (rng.integers(0, 2**16, 4096, dtype=np.uint64).astype(np.uint32)
            << 16) | 0x8000
    special = np.array([0, 0x80000000, 1, 0x00008000, 0x00018000,
                        0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000, 0x7F800000,
                        0xFF800000, 0x3F808000, 0x3F818000], np.uint32)
    x = np.concatenate([bits, ties, special]).view(np.float32)
    x = x[~np.isnan(x)]
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(got.view(np.uint16), want)


@pytest.mark.parametrize("layout", ["lerobot", "transformers_new", "bare"])
def test_convert_pi0_bit_equal(layout):
    sd = _pi0_sd(layout)
    cfg = configs.tiny_pi0_config()
    want = pi0_from_jax(_np_tree(jpi0conv.convert_pi0(
        sd, jconfigs.tiny_pi0_config())), cfg, device="cpu")
    got = pi0conv.convert_pi0(sd, cfg, device="cpu")
    assert_trees_equal(got, want)
    assert got["paligemma"]["layers"]["q"].dtype == torch.bfloat16
    assert got["paligemma"]["layers"]["input_ln"].dtype == torch.float32
    # torch tensors in, the same tree out
    got_t = pi0conv.convert_pi0({k: torch.from_numpy(v) for k, v in sd.items()},
                                cfg, device="cpu")
    assert_trees_equal(got_t, want)


@pytest.mark.parametrize("root", ["model.pi0_paligemma.", "pi0_paligemma."])
def test_convert_pi0fast_bit_equal(root):
    jcfg, cfg = _fast_cfgs()
    sd = _pi0fast_sd(root)
    want = pi0fast_from_jax(_np_tree(jfastconv.convert_pi0fast(sd, jcfg)),
                            cfg, device="cpu")
    assert_trees_equal(fastconv.convert_pi0fast(sd, cfg, device="cpu"), want)


def test_convert_siglip2_backbone_bit_equal():
    cfg = configs.tiny_verifier_config()
    sd = _backbone_sd(cfg)
    want = _np_tree(jvconv.convert_siglip2_backbone(
        sd, jconfigs.tiny_verifier_config()))
    got = vconv.convert_siglip2_backbone(sd, cfg, device="cpu")
    ref = verifier.init_verifier(0, cfg, device="meta")["backbone"]
    assert_trees_equal(got, ParamTree(place_like(want, ref, "cpu")))
    assert got["vision"]["blocks"]["ln1"]["scale"].dtype == torch.float32
    assert got["text"]["text_projection"]["kernel"].dtype == torch.float32


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_merged_checkpoint_bit_equal(tmp_path, jax_members, writer):
    """A merged .pt written by either package converts, with a backbone
    state dict, to the same tree in both."""
    jcfg, cfg = jconfigs.tiny_verifier_config(), configs.tiny_verifier_config()
    path = str(tmp_path / "merged.pt")
    if writer == "jax":
        jvexport.save_merged_ensemble(path, jax_members, jcfg)
    else:
        members = verifier_from_jax(
            {"members": jax_members, "backbone": _np_tree(
                jverifier.init_verifier(jax.random.PRNGKey(0), jcfg,
                                        num_members=2)["backbone"])},
            cfg, device="cpu")["members"]
        vexport.save_merged_ensemble(path, members, cfg)
    bsd = _backbone_sd(cfg)
    want = verifier_from_jax(_np_tree(jvconv.convert_merged_checkpoint(
        path, jcfg, backbone_sd=bsd)), cfg, device="cpu")
    got = vconv.convert_merged_checkpoint(path, cfg, backbone_sd=bsd,
                                          device="cpu")
    assert_trees_equal(got, want)
    assert got["members"]["logit_scale"].shape == (2,)
    # heads only: members alone, equal to the JAX members
    heads = vconv.convert_merged_checkpoint(path, cfg, device="cpu")
    assert list(heads) == ["members"]
    assert_trees_equal(heads["members"], want["members"])


@pytest.mark.parametrize("which", ["pi0", "pi0fast", "backbone", "merged"])
def test_converters_refuse_a_tree_unlike_the_config(tmp_path, jax_members,
                                                    which):
    """Every converter places its result through the one checked path: a
    source whose shapes differ from the config's tree raises, on the host
    as on the card, instead of returning an unchecked tree."""
    r = dataclasses.replace
    if which == "pi0":
        cfg = configs.tiny_pi0_config()
        cfg = r(cfg, paligemma=r(cfg.paligemma,
                                 mlp_dim=2 * cfg.paligemma.mlp_dim))
        call = lambda: pi0conv.convert_pi0(_pi0_sd("lerobot"), cfg,
                                           device="cpu")
    elif which == "pi0fast":
        _, cfg = _fast_cfgs()
        cfg = r(cfg, vision=r(cfg.vision, mlp_dim=2 * cfg.vision.mlp_dim))
        call = lambda: fastconv.convert_pi0fast(
            _pi0fast_sd("pi0_paligemma."), cfg, device="cpu")
    elif which == "backbone":
        cfg = configs.tiny_verifier_config()
        sd = _backbone_sd(cfg)
        cfg = r(cfg, text=r(cfg.text, embed_dim=2 * cfg.text.embed_dim))
        call = lambda: vconv.convert_siglip2_backbone(sd, cfg, device="cpu")
    else:
        path = str(tmp_path / "merged.pt")
        jvexport.save_merged_ensemble(path, jax_members,
                                      jconfigs.tiny_verifier_config())
        cfg = configs.tiny_verifier_config()
        cfg = r(cfg, action_dim=cfg.action_dim + 1)
        call = lambda: vconv.convert_merged_checkpoint(path, cfg,
                                                       device="cpu")
    with pytest.raises(ValueError, match="expected"):
        call()


def test_merged_exports_equal(jax_members):
    """verifier_to_torch of the same members in both packages: the same
    state dicts, key for key, value for value, all fp32."""
    jcfg, cfg = jconfigs.tiny_verifier_config(), configs.tiny_verifier_config()
    members = verifier_from_jax(
        {"members": jax_members, "backbone": _np_tree(
            jverifier.init_verifier(jax.random.PRNGKey(0), jcfg,
                                    num_members=2)["backbone"])},
        cfg, device="cpu")["members"]
    jcomp = jvexport.export_ensemble_components(jax_members, jcfg)
    tcomp = vexport.export_ensemble_components(members, cfg)
    assert len(jcomp) == len(tcomp) == 2

    def compare(t, j, where=""):
        if isinstance(j, dict):
            assert sorted(t) == sorted(j), where
            for k in j:
                compare(t[k], j[k], f"{where}/{k}")
        elif isinstance(j, float):
            assert t == j, where
        else:
            assert t.dtype == torch.float32 and t.is_contiguous(), where
            assert torch.equal(t, torch.from_numpy(np.array(j))), \
                where

    for t, j in zip(tcomp, jcomp):
        compare(t, j)


# --------------------------------------------------------------------------
# forward parity against HF / torch modules (tests/test_convert_parity.py)
# --------------------------------------------------------------------------


def _sd_numpy(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def test_gemma_parity_vs_hf():
    """The port's Gemma stack on converted HF GemmaModel weights (fp32,
    causal mask) == HF's hidden states."""
    from transformers import GemmaConfig as HFGemmaConfig
    from transformers.models.gemma.modeling_gemma import GemmaModel

    cfg = configs.GemmaConfig(width=64, depth=2, mlp_dim=128, num_heads=4,
                              num_kv_heads=1, head_dim=16, vocab_size=128)
    hf_cfg = HFGemmaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=1,
        head_dim=16, hidden_activation="gelu_pytorch_tanh",
        rms_norm_eps=1e-6, rope_theta=10000.0, attention_bias=False,
        attn_implementation="eager")
    torch.manual_seed(0)
    hf = GemmaModel(hf_cfg).eval()
    params = pi0conv.convert_gemma(_sd_numpy(hf), cfg, "", embed=True,
                                   dtype=torch.float32, device="cpu")
    b, t = 2, 7
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (b, t)))
    with torch.no_grad():
        want = hf(input_ids=tokens).last_hidden_state
        # HF scales token embeddings by sqrt(width) internally; pi0 applies
        # that scaling in embed_prefix
        emb = gemma.embed_tokens(params, tokens) * (64 ** 0.5)
        positions = torch.arange(t)[None].expand(b, t)
        mask = torch.tril(torch.ones(t, t, dtype=torch.bool))[None].expand(
            b, t, t)
        hidden, _ = gemma.prefill(params, cfg, emb, positions, mask,
                                  return_hidden=True)
    np.testing.assert_allclose(hidden.numpy(), want.numpy(), **TOL)


def test_siglip_vision_parity_vs_hf():
    """The port's ViT on converted HF SiglipVisionModel weights (fp32) ==
    HF's last hidden state, final post-LN included."""
    from transformers import SiglipVisionConfig
    from transformers.models.siglip.modeling_siglip import SiglipVisionModel

    cfg = configs.VitConfig(width=48, depth=2, mlp_dim=96, num_heads=4,
                            patch_size=8, image_size=32)
    hf_cfg = SiglipVisionConfig(
        hidden_size=48, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, image_size=32, patch_size=8,
        hidden_act="gelu_pytorch_tanh", attn_implementation="eager")
    torch.manual_seed(1)
    hf = SiglipVisionModel(hf_cfg).eval()
    params = pi0conv.convert_siglip_vision(
        _sd_numpy(hf), cfg, "vision_model", dtype=torch.float32, device="cpu")
    img = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = hf(pixel_values=torch.from_numpy(
            img.transpose(0, 3, 1, 2))).last_hidden_state
        got = siglip.vit_forward(params, cfg, torch.from_numpy(img)).tokens
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def _add_member_axis(tree):
    return {k: _add_member_axis(v) if isinstance(v, (dict, ParamTree))
            else v[None] for k, v in tree.items()}


def test_attention_pooling_parity_vs_torch():
    """The port's pooling on a converted CrossAttentionBlock stack
    (MultiheadAttention with kdim != embed_dim) == the torch module."""
    kv_dim, out_dim, heads, layers = 24, 16, 4, 2
    torch.manual_seed(3)

    class TorchBlock(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.attention = torch.nn.MultiheadAttention(
                out_dim, heads, batch_first=True, kdim=kv_dim, vdim=kv_dim)
            self.mlp = torch.nn.Sequential()
            self.mlp.fc1 = torch.nn.Linear(out_dim, out_dim)
            self.mlp.act = torch.nn.GELU()
            self.mlp.fc2 = torch.nn.Linear(out_dim, out_dim)
            self.q_layer_norm = torch.nn.LayerNorm(out_dim)
            self.layer_norm = torch.nn.LayerNorm(out_dim)

        def forward(self, q, kv):
            q = self.q_layer_norm(q)
            attn, _ = self.attention(q, kv, kv)
            q = self.layer_norm(q + attn)
            return q + self.mlp.fc2(self.mlp.act(self.mlp.fc1(q)))

    class TorchPool(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.query = torch.nn.Parameter(torch.randn(1, 1, out_dim))
            self.blocks = torch.nn.ModuleList(
                [TorchBlock() for _ in range(layers)])
            self.layer_norm = torch.nn.LayerNorm(out_dim)

        def forward(self, x):
            q = self.query.expand(x.shape[0], -1, -1)
            for blk in self.blocks:
                q = blk(q, x)
            return self.layer_norm(q).reshape(x.shape[0], -1)

    pool = TorchPool().eval()
    vcfg = dataclasses.replace(configs.tiny_verifier_config(),
                               pooling_layers=layers, pooling_heads=heads)
    params = vconv._convert_attention_pooling(_sd_numpy(pool), vcfg, kv_dim,
                                              device="cpu")
    x = np.random.default_rng(3).standard_normal((2, 5, kv_dim)).astype(
        np.float32)
    with torch.no_grad():
        want = pool(torch.from_numpy(x))
        got = verifier.attention_pooling(_add_member_axis(params),
                                         torch.from_numpy(x)[None], heads)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_traj_encoder_parity_vs_torch():
    """The port's post-LN encoder on converted nn.TransformerEncoder
    weights == the module (relu, ff=2d) at the unpadded positions."""
    d, heads, layers = 16, 4, 2
    torch.manual_seed(4)
    enc = torch.nn.TransformerEncoder(torch.nn.TransformerEncoderLayer(
        d_model=d, nhead=heads, dim_feedforward=2 * d, dropout=0.0,
        batch_first=False), num_layers=layers).eval()
    vcfg = dataclasses.replace(configs.tiny_verifier_config(),
                               traj_layers=layers, traj_heads=heads)
    params = vconv._convert_traj_encoder(_sd_numpy(enc), vcfg, d,
                                         device="cpu")
    x = np.random.default_rng(4).standard_normal((3, 6, d)).astype(np.float32)
    pad = np.zeros((3, 6), bool)
    pad[:, :2] = True
    with torch.no_grad():
        want = enc(torch.from_numpy(x).permute(1, 0, 2),
                   src_key_padding_mask=torch.from_numpy(pad)
                   ).permute(1, 0, 2).numpy()
        got = verifier.traj_encoder(_add_member_axis(params),
                                    torch.from_numpy(x)[None],
                                    torch.from_numpy(pad), heads)[0].numpy()
    np.testing.assert_allclose(got[~pad], want[~pad], **TOL)


# --------------------------------------------------------------------------
# the port's .safetensors parser
# --------------------------------------------------------------------------


def test_safetensors_parser_reads_the_package_files(tmp_path):
    st = pytest.importorskip("safetensors")
    from safetensors.numpy import save_file as save_np
    from safetensors.torch import load_file, save_file as save_torch
    del st
    rng = np.random.default_rng(6)
    tensors = {"a.f32": torch.from_numpy(_rand(rng, 3, 5)),
               "b.bf16": torch.from_numpy(_rand(rng, 4, 2)).to(torch.bfloat16),
               "c.i64": torch.arange(-3, 9).reshape(3, 4),
               "d.scalar": torch.tensor(2.5),
               "e.empty": torch.zeros(0, 3)}
    p_torch = str(tmp_path / "t.safetensors")
    save_torch(tensors, p_torch, metadata={"format": "pt", "note": "x"})
    arrays = {"w": _rand(rng, 6, 2), "ids": np.arange(7, dtype=np.int64),
              "half": _rand(rng, 2, 3).astype(np.float16)}
    p_np = str(tmp_path / "n.safetensors")
    save_np(arrays, p_np, metadata={"format": "np"})
    for path in (p_torch, p_np):
        want = load_file(path)
        got = pi0conv.load_state_dict(path)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and \
                got[k].shape == want[k].shape, k
            assert torch.equal(got[k], want[k]), k
    # offsets that run past the file are refused
    with open(p_np, "rb") as f:
        data = f.read()
    with open(str(tmp_path / "cut.safetensors"), "wb") as f:
        f.write(data[:-8])
    with pytest.raises(ValueError, match="data offsets"):
        pi0conv.read_safetensors(str(tmp_path / "cut.safetensors"))
