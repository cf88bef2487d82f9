"""The plain reference against the port's CPU path at tiny widths. This
test may import both; the reference module imports nothing of the port."""

import time

import numpy as np
import pytest
import torch

from coverbench import fake_env, harness, reference
from coverbench.tests.tiny import tiny_cell


def frames(n=3, seed=0):
    out = []
    for i in range(n):
        env = fake_env.FakeWidowXEnv(fake_env.ID_TASKS[i % 4])
        out.append(env.reset(seed + i)["image"])
    rng = np.random.default_rng(seed)
    out.append(rng.integers(0, 256, (256, 256, 3), dtype=np.uint8))
    return out


@pytest.mark.parametrize("size", [224, 56])
def test_lanczos4_equals_port(size):
    from cover_vla_tpu_torch.ops.image import resize_lanczos4_uint8
    for img in frames():
        np.testing.assert_array_equal(reference.lanczos4_uint8(img, size),
                                      resize_lanczos4_uint8(img, size, size))


@pytest.mark.parametrize("size", [384, 64])
def test_verifier_image_near_port(size):
    from cover_vla_tpu_torch.engine.verified_step import _verifier_image
    for img in frames():
        ref = reference.verifier_image(img, size, "cpu")
        prog = _verifier_image(torch.from_numpy(img)[None], size)[0]
        # the same 8-bit levels but where a pass rounds a tie differently
        assert (ref - prog).abs().max().item() <= 2.0 / 255 * 2 + 1e-6


def test_tokenizers_equal_port():
    from cover_vla_tpu_torch.data.tokenizer import HashTokenizer
    texts = list(fake_env.TASK_INSTRUCTIONS.values()) + [
        "Place the vegetable in the yellow rack.", ""]
    for vocab, bos, length in ((257152, True, 72), (256000, False, 64),
                               (1024, True, 8)):
        tok = HashTokenizer(vocab, add_bos=bos)
        t_prog, m_prog = tok.encode_batch(texts, length)
        for i, text in enumerate(texts):
            t, m = reference.tokenize(text, length, vocab, bos)
            np.testing.assert_array_equal(t, t_prog[i])
            np.testing.assert_array_equal(m, m_prog[i])


def test_euler_to_rotvec_equals_port():
    from cover_vla_tpu_torch.utils.geometry import euler_to_rotvec
    rpy = torch.randn(200, 3, generator=torch.Generator().manual_seed(0))
    rpy[0] = 0
    torch.testing.assert_close(reference.euler_to_rotvec(rpy),
                               euler_to_rotvec(rpy), atol=1e-6, rtol=0)


@pytest.mark.parametrize("route", ["bf16", "w8a8"])
def test_reference_agrees_with_port_on_cpu(route):
    """A whole tiny run on the CPU: the port's step (its kernels' plain
    twins) against the reference, on the reference's own grid."""
    torch.set_num_threads(2)
    limits = {"action_rms": 0.008, "score_gap": 0.003, "action_gap": 0.03,
              "pick_mismatch": 0, "decode_mismatch": 0, "vote_mismatch": 0,
              "engine_mismatch": 0}
    out = harness.run(tiny_cell(route, ticks=16, limits=limits), 2 ** 31 + 9,
                      1.0, False, "cpu", time.perf_counter())
    assert out.correct, out.compared
    assert len(out.answers) == 6
    assert {a["where"][2] for a in out.answers} & {0}      # an episode start
