"""PyTorch port vs the JAX package: the simulator-side host modules —
SIMPLER image and action helpers (`eval/simpler_utils.py`), the Aloha
transforms (`eval/aloha.py`), the SimplerEnv registry with its fake-env
fallback (`eval/simpler_integration.py`) and the LIBERO suite loop
(`eval/libero.py`). Neither simulator is installed here, so both
packages build the fake environment; every result must be byte-equal."""

import numpy as np
import pytest

from cover_vla_tpu.eval import aloha as jaloha
from cover_vla_tpu.eval import libero as jlibero
from cover_vla_tpu.eval import simpler_integration as jsimpler
from cover_vla_tpu.eval import simpler_utils as jutils

from cover_vla_tpu_torch.eval import aloha, libero, simpler_integration
from cover_vla_tpu_torch.eval import simpler_utils
from cover_vla_tpu_torch.eval.benchmark import TASK_INSTRUCTIONS
from cover_vla_tpu_torch.eval.fake_env import FakeWidowXEnv


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("hw,size", [((256, 256), 224), ((480, 640), 256),
                                     ((100, 90), 128)])
def test_simpler_images_byte_equal(hw, size):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (*hw, 3)).astype(np.uint8)
    for center_crop in (False, True):
        _same(simpler_utils.get_simpler_img(img, size, center_crop),
              jutils.get_simpler_img(img, size, center_crop))
    _same(simpler_utils.center_crop_resize(img, size, 0.8),
          jutils.center_crop_resize(img, size, 0.8))
    _same(simpler_utils.resize_reward_image(img, size),
          jutils.resize_reward_image(img, size))
    f = img.astype(np.float32) / 255
    _same(simpler_utils.get_simpler_img(f, size),
          jutils.get_simpler_img(f, size))
    out = simpler_utils.get_simpler_img(img, size, center_crop=True)
    assert out.shape == (size, size, 3) and out.dtype == np.uint8


def test_simpler_actions_equal():
    rng = np.random.default_rng(2)
    assert simpler_utils.get_simpler_dummy_action().tolist() == \
        jutils.get_simpler_dummy_action().tolist() == [0, 0, 0, 0, 0, 0, 1.0]
    for a in [np.array([0.1, 0.2, 0.3, 0.0, 0.0, 0.5, 1.0]),
              *rng.uniform(-1, 1, (6, 7))]:
        _same(simpler_utils.convert_maniskill(a), jutils.convert_maniskill(a))
    conv = simpler_utils.convert_maniskill(
        np.array([0.1, 0.2, 0.3, 0.0, 0.0, 0.5, 1.0]))
    np.testing.assert_allclose(conv[3:6], [0, 0, 0.5], atol=1e-8)
    acts = rng.uniform(0, 1, (3, 4, 7))
    for binarize in (True, False):
        _same(simpler_utils.normalize_gripper_action(acts, binarize),
              jutils.normalize_gripper_action(acts, binarize))
    _same(simpler_utils.invert_gripper_action(acts),
          jutils.invert_gripper_action(acts))


def test_aloha_transforms_byte_equal():
    x = np.linspace(0.05, 0.95, 13).astype(np.float32)
    for fn in ("aloha_gripper_to_angular", "aloha_gripper_from_angular",
               "aloha_gripper_from_angular_inv"):
        _same(getattr(aloha, fn)(x), getattr(jaloha, fn)(x))
    rng = np.random.default_rng(0)
    state = rng.uniform(0.1, 0.9, (2, 14)).astype(np.float32)
    _same(aloha.decode_state(state), jaloha.decode_state(state))
    acts = rng.uniform(0.1, 0.9, (2, 4, 14)).astype(np.float32)
    for fn in ("encode_actions", "encode_actions_inv"):
        _same(getattr(aloha, fn)(acts), getattr(jaloha, fn)(acts))
    dec = aloha.decode_state(state)
    for j in (1, 2, 8, 9):
        np.testing.assert_array_equal(dec[:, j], -state[:, j])
    # encode then encode_inv restores the original
    np.testing.assert_allclose(
        aloha.encode_actions_inv(aloha.encode_actions(acts)), acts,
        rtol=1e-5, atol=1e-6)


def test_environment_map_equal():
    assert simpler_integration.ENVIRONMENT_MAP == jsimpler.ENVIRONMENT_MAP
    assert simpler_integration.ENVIRONMENTS == jsimpler.ENVIRONMENTS
    assert simpler_integration.SIMPLER_ENV_IDS == jsimpler.SIMPLER_ENV_IDS
    names = simpler_integration.ENVIRONMENTS
    assert len(names) == 34
    assert sum(n.startswith("google_robot") for n in names) == 21
    assert sum(n.startswith("widowx") for n in names) == 13
    assert all(n in TASK_INSTRUCTIONS for n in names)
    assert simpler_integration.simpler_available() is \
        jsimpler.simpler_available() is False


@pytest.mark.parametrize("task", ["widowx_carrot_on_plate",
                                  "google_robot_open_top_drawer",
                                  "widowx_redbull_on_plate"])
def test_simpler_fallback_is_the_fake_env(task):
    """Without SimplerEnv (and ManiSkill2_real2sim) both packages build the
    same fake environment, which then steps identically."""
    env = simpler_integration.make_simpler_env(task, max_steps=5)
    ref = jsimpler.make_simpler_env(task, max_steps=5)
    assert isinstance(env, FakeWidowXEnv)
    assert type(env).__name__ == type(ref).__name__
    obs, _ = env.reset(seed=3)
    robs, _ = ref.reset(seed=3)
    _same(obs["image"], robs["image"])
    assert env.get_language_instruction() == ref.get_language_instruction()
    rng = np.random.default_rng(4)
    for _ in range(5):
        a = np.concatenate([rng.uniform(-0.04, 0.04, 3), np.zeros(3),
                            [rng.choice([-1.0, 1.0])]])
        step, rstep = env.step(a), ref.step(a)
        _same(step[0]["image"], rstep[0]["image"])
        assert step[1:4] == rstep[1:4]


def test_simpler_env_wrapper_converts_like_the_jax_one():
    """SimplerEnvWrapper over a stand-in gym env: the camera selector,
    the instruction fallback and the step tuple."""
    class Gym:
        def reset(self, seed=None):
            return {"image": {"3rd_view_camera": {"rgb": np.full(
                (4, 4, 3), seed, np.uint8)}}}, {"s": seed}

        def step(self, action):
            return ({"image": {"overhead_camera": np.ones((2, 2, 3))}}, 0.5,
                    1, 0, {"episode_stats": {"success": True}})

    for mod in (simpler_integration, jsimpler):
        w = mod.SimplerEnvWrapper(Gym(), "widowx_stack_cube")
        obs, info = w.reset(seed=7)
        assert info == {"s": 7} and obs["image"].tolist() == \
            np.full((4, 4, 3), 7, np.uint8).tolist()
        obs, r, done, trunc, _ = w.step(np.zeros(7))
        assert (r, done, trunc) == (0.5, True, False)
        assert obs["image"].shape == (2, 2, 3)
        assert w.episode_stats == {"success": True}
        assert w.get_language_instruction() == \
            TASK_INSTRUCTIONS["widowx_stack_cube"]


class ScriptedPolicy:
    def __init__(self):
        self.resets, self.frames = [], []

    def reset(self, task):
        self.resets.append(task)

    def select_action(self, image, state, task):
        assert image is not None and image.ndim == 3
        self.frames.append(int(np.asarray(image, np.int64).sum()))
        return np.asarray([0.02, 0.0, -0.01, 0, 0, 0, -1.0])


def test_libero_suite_loop_equal():
    """LIBERO's loop over the fake env (settle steps, per-suite caps, a
    policy reset per episode): the same results and the same frames seen
    by the policy in both packages."""
    for suite in libero.LIBERO_SUITES:
        assert libero.list_tasks(suite) == jlibero.list_tasks(suite)
    assert libero.LIBERO_SUITES == jlibero.LIBERO_SUITES
    assert libero.LIBERO_MAX_STEPS == jlibero.LIBERO_MAX_STEPS
    _same(libero.LIBERO_DUMMY_ACTION, jlibero.LIBERO_DUMMY_ACTION)
    assert libero.libero_available() is jlibero.libero_available() is False

    pol, ref_pol = ScriptedPolicy(), ScriptedPolicy()
    out = libero.LiberoEvaluator(pol, "libero_object", n_eval_episodes=2,
                                 max_steps=12).evaluate(n_tasks=2)
    ref = jlibero.LiberoEvaluator(ref_pol, "libero_object", n_eval_episodes=2,
                                  max_steps=12).evaluate(n_tasks=2)
    assert out == ref
    assert pol.resets == ref_pol.resets and len(pol.resets) == 4
    assert pol.frames == ref_pol.frames and len(pol.frames) > 0
    with pytest.raises(ValueError):
        libero.LiberoEvaluator(pol, "not_a_suite")


def test_libero_env_wrapper_converts_like_the_jax_one():
    class Env:
        def seed(self, s):
            self.s = s

        def reset(self):
            return {"agentview_image": np.arange(2 * 3 * 3).reshape(2, 3, 3),
                    "robot0_eef_pos": np.array([0.1, 0.2, 0.3]),
                    "robot0_eef_quat": np.array([0.0, 0.0, 0.0, 1.0]),
                    "robot0_gripper_qpos": np.array([0.03, -0.03])}

        def step(self, action):
            return self.reset(), 1.0, True, {"i": 1}

    for mod in (libero, jlibero):
        w = mod.LiberoEnvWrapper(Env(), "pick the bowl")
        obs, _ = w.reset(seed=None)
        assert obs["image"].tolist() == \
            np.arange(18).reshape(2, 3, 3)[::-1].tolist()
        assert obs["agent"]["eef_pos"].tolist() == \
            [0.1, 0.2, 0.3, 1.0, 0.0, 0.0, 0.0, 0.03]
        assert w.step(np.zeros(7))[1:] == (1.0, True, False, {"i": 1})
        assert w.get_language_instruction() == "pick the bowl"
