"""The comparison fails a broken timed path: a run on the CPU at tiny
widths (the harness's look for a chip skipped), with the program broken
underneath in each way this cell can break, and with each control in the
program's place. (A cell runs on one card: there is no exchange between
chips to leave out.)"""

import time

import pytest
import torch

from coverbench import harness
from coverbench.tests.tiny import tiny_cell

# the tiny widths' own limits: sound runs read 5x or more below them, the
# controls 3x or more above
LIMITS = {"bf16": {"action_rms": 0.008, "score_gap": 0.003,
                   "action_gap": 0.03},
          "w8a8": {"action_rms": 0.02, "score_gap": 0.02,
                   "action_gap": 0.06}}


def run(route="bf16", faults=None, control=None, seed=11):
    torch.set_num_threads(2)
    limits = dict(LIMITS[route], pick_mismatch=0, decode_mismatch=0,
                  vote_mismatch=0, engine_mismatch=0)
    return harness.run(tiny_cell(route, ticks=16, limits=limits), seed, 1.0,
                       False, "cpu", time.perf_counter(), faults=faults,
                       control=control)


def state_unchanged(cohorts):
    """The engine's step leaves its state (the history ring) as it was."""
    for c in cohorts:
        c.engine._push_history = lambda verif: None


def half_batch(cohorts):
    """The step computes the first half of the episodes; the rest get the
    mean of those."""
    for c in cohorts:
        inner = c.step.step

        def step(pp, vp, *args, noise=None, inner=inner):
            h = args[0].shape[0] // 2
            res = inner(pp, vp, *(a[:h] for a in args), noise=noise[:h])
            out = []
            for t in res:
                rest = (t.float().mean(0, keepdim=True).to(t.dtype)
                        if t.is_floating_point() else t[:1])
                out.append(torch.cat([t, rest.expand(h, *t.shape[1:])]))
            return type(res)(*out)
        c.step.step = step


def altered_answer(cohorts):
    """Every candidate's first action dimension is moved where the policy
    produces it."""
    from cover_vla_tpu_torch.models import pi0
    inner = pi0.sample_actions

    def sample(*a, **k):
        out = inner(*a, **k)
        return out + torch.tensor([0.2] + [0.0] * (out.shape[-1] - 1))
    pi0.sample_actions = sample
    cohorts[0].restore = lambda: setattr(pi0, "sample_actions", inner)


def broken_verifier(monkeypatch):
    """The verifier scores each episode's candidates against another
    episode's image and instruction embedding."""
    from cover_vla_tpu_torch.models import verifier
    inner = verifier.ensemble_embed

    def embed(*a, **k):
        fused_it, fused_ac = inner(*a, **k)
        return fused_it.roll(1, 0), fused_ac
    monkeypatch.setattr(verifier, "ensemble_embed", embed)


def flipped_vote(monkeypatch):
    """The gripper vote executes the minority's gripper."""
    from cover_vla_tpu_torch.engine import verified_step
    inner = verified_step.vote_gripper

    def vote(*a, **k):
        out = inner(*a, **k)
        out[:, 0, 6] = -out[:, 0, 6]
        return out
    monkeypatch.setattr(verified_step, "vote_gripper", vote)


def test_sound_run_is_correct():
    assert run().correct


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   altered_answer])
def test_fault_is_not_correct(fault):
    from cover_vla_tpu_torch.models import pi0
    inner = pi0.sample_actions
    try:
        out = run(faults=fault)
    finally:
        pi0.sample_actions = inner
    assert not out.correct, out.compared


@pytest.mark.parametrize("fault, number", [(broken_verifier, "score_gap"),
                                           (flipped_vote, "vote_mismatch")])
def test_verifier_or_vote_fault_fails_its_number(fault, number, monkeypatch):
    """Only `score_gap` sees the verifier, only `vote_mismatch` the vote:
    each fails its own number."""
    fault(monkeypatch)
    out = run()
    reading, limit = out.compared[number]
    assert not out.correct and reading > limit, out.compared


def test_control_of_bf16_is_not_correct():
    """The program on its int8 route, judged with the bf16 limits."""
    assert not run(control="program_w8a8").correct


def test_control_of_w8a8_is_not_correct():
    """The reference on the int4 grid in the program's place, judged with
    the w8a8 limits."""
    assert run("w8a8").correct
    assert not run("w8a8", control="reference_int4").correct
