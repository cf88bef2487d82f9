"""The comparison that decides `correct`.

After the window has closed, a sample of the (boundary, episode) answers
that the window resolved, drawn from the seed, is worked out again by the
plain reference (`coverbench/reference.py`) on the same raw frames,
proprio, prompt texts and noise, and compared with what the program's
timed path produced:

- `score_gap`: the widest gap between the program's and the reference's
  verifier score over the episode's K x N candidates (the policy's
  candidates reach the scores through their trajectories), leaving out
  the candidates whose raw gripper, in any row of the chunk, lies within
  the cell's `flip_margin` of 0.5 in the reference: the verifier reads the
  gripper as 0 or 1 at 0.5, so rounding can flip it there;
- `action_rms`: the root mean square, over every sampled answer, of the
  gap in the policy's normalised action units between the executed
  candidate's chunk as the program produced it (its verifier-format chunk
  mapped back, and its raw gripper) and the same candidate of the
  reference: the steady number, the one the control of the limits fails;
- `action_gap`: the widest of those gaps;
- `pick_mismatch`: answers whose winner, stage-2 flag, winning score or
  deference differ from the reference's selection over the program's own
  scores (the selection stage checked on its own inputs, exactly);
- `decode_mismatch`: answers whose execution-format chunk departs from
  the reference's decoding of the program's verifier-format chunk
  (axis-angle from Euler, +-1 grippers) by more than DECODE_TOL, float32
  rounding of values of order one on two devices;
- `vote_mismatch`: answers whose voted gripper differs from the vote over
  the reference's candidates of the winning group, wherever the members
  whose raw gripper lies within `flip_margin` of 0.5 cannot decide it:
  the majority of the others leads by more than their number;
- `engine_mismatch`: answers whose prompt tokens and masks, verifier
  tokens or history ring differ from what the reference works out from
  the prompt texts and the program's earlier executed chunks.

The reference follows the episode from the program's earlier outputs
(the executed chunks fill the history ring, a stage-2 pick switches the
instruction): it checks each boundary from the program's state, and
`engine_mismatch` checks that state by itself.
"""

from __future__ import annotations

import numpy as np
import torch

from coverbench import backbones, reference

# numbers of one answer; `action_rms` is the run's, over every answer
NUMBERS = ("score_gap", "action_gap", "pick_mismatch", "decode_mismatch",
           "vote_mismatch", "engine_mismatch")
DECODE_TOL = 1e-5


def prompts_of(task: str, original: str, rephrases: dict, k: int):
    reph = list(rephrases.get(original, []))
    return ([task] + reph)[:k] + [task] * max(0, k - 1 - len(reph))


def episode_state(boundaries, e: int, original: str, rephrases: dict,
                  k: int, max_history: int):
    """The task, prompts and history ring of episode slot `e` at the
    boundary after `boundaries` (its earlier boundaries, in order, each
    with the program's host result)."""
    task, rows = original, []
    for b in boundaries:
        r = b.host
        prompts = prompts_of(task, original, rephrases, k)
        if r["used_stage2"][e]:
            task = prompts[int(r["winner_group"][e])]
        rows.extend(r["verifier_chunk"][e])
    hist = np.zeros((max_history, 7), np.float32)
    n = min(len(rows), max_history)
    if n:
        hist[max_history - n:] = np.stack(rows[len(rows) - n:])
    return task, prompts_of(task, original, rephrases, k), hist, n


def sample(window, seed: int, n_boundaries: int, per_boundary: int, e: int):
    """(boundary, [episode slots]) pairs drawn from the seed: an
    episode's first boundary (empty history), one with a full history
    where the window has one, the rest at random; in each, one slot from
    each of `per_boundary` equal slices of the batch."""
    rng = np.random.default_rng([seed, 7])
    first = [b for b in window if b.in_episode == 0]
    full = [b for b in window if b.in_episode >= 2]
    picked = []
    for pool in (first, full):
        if pool and len(picked) < n_boundaries:
            picked.append(pool[int(rng.integers(len(pool)))])
    rest = [b for b in window if b not in picked]
    while len(picked) < n_boundaries and rest:
        picked.append(rest.pop(int(rng.integers(len(rest)))))
    edges = np.linspace(0, e, per_boundary + 1).astype(int)
    return [(b, sorted({int(rng.integers(lo, max(lo + 1, hi)))
                        for lo, hi in zip(edges[:-1], edges[1:])}))
            for b in picked]


def noise_of(b, shape, noise_std, device):
    gen = torch.Generator(device=device)
    gen.set_state(b.noise_state)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * noise_std


def judge(program: dict, ref: dict, e: int, n: int, cfg, stats, limits,
          engine_ok: bool) -> dict:
    """The numbers of one answer. program: the boundary's host result
    (fields of the step's result, episode axis first); ref: the
    reference's episode dict; n: candidates a prompt."""
    p01 = np.asarray(stats["action"]["p01"], np.float64)
    p99 = np.asarray(stats["action"]["p99"], np.float64)
    out = {}
    s_prog = np.asarray(program["scores"][e], np.float64)
    s_diff = np.abs(s_prog - ref["scores"].double().numpy())
    margin = (ref["actions"][:, :, 6] - 0.5).abs().amin(dim=1).double().numpy()
    steady = margin > limits["flip_margin"]
    out["score_gap"] = float(s_diff[steady].max(initial=0.0))

    w = int(program["winner_idx"][e])
    verif = np.asarray(program["verifier_chunk"][e], np.float64)
    a_prog = np.concatenate(
        [2 * (verif[:, :6] - p01[:6]) / (p99[:6] - p01[:6]) - 1,
         np.asarray(program["raw_gripper"][e], np.float64)[:, None]], axis=1)
    a_ref = ref["actions"][w].double().numpy()
    a_diff = np.abs(a_prog - a_ref)
    out["action_gap"] = float(a_diff.max())

    w_ref, stage2_ref, score_ref = reference.select(
        program["scores"][e], n, cfg["cover"]["rescore_threshold"])
    out["pick_mismatch"] = int(
        w_ref != w or stage2_ref != bool(program["used_stage2"][e])
        or score_ref != float(program["max_score"][e])
        or int(program["winner_group"][e]) != w // n
        or bool(program["deferred"][e]))

    exec_prog = np.asarray(program["exec_chunk"][e], np.float64)
    verif_t = torch.from_numpy(np.asarray(program["verifier_chunk"][e],
                                          np.float32))
    rotvec = reference.euler_to_rotvec(verif_t[:, 3:6]).double().numpy()
    raw_g = np.asarray(program["raw_gripper"][e], np.float64)
    grip = np.where(raw_g > 0.5, 1.0, -1.0)
    out["decode_mismatch"] = int(max(
        np.abs(exec_prog[:, :3] - verif[:, :3]).max(),
        np.abs(exec_prog[:, 3:6] - rotvec).max(),
        np.abs(exec_prog[1:, 6] - grip[1:]).max(initial=0.0)) > DECODE_TOL)

    members = (w // n) * n + np.arange(n)
    g_ref = ref["actions"][members, 0, 6].double().numpy()
    certain = np.abs(g_ref - 0.5) > limits["flip_margin"]
    lead = abs(2 * int((g_ref[certain] > 0.5).sum()) - int(certain.sum()))
    out["vote_compared"] = int(cfg["cover"]["gripper_vote"]
                               and lead > int((~certain).sum()))
    out["vote_mismatch"] = 0
    if out["vote_compared"]:
        voted = reference.vote(np.where(g_ref > 0.5, 1.0, -1.0), grip[0])
        out["vote_mismatch"] = int(voted != exec_prog[0, 6])
    out["engine_mismatch"] = int(not engine_ok)
    out["detail"] = {"score_diffs": s_diff.tolist(),
                     "grip_margin": margin.tolist(),
                     "action_diffs": a_diff.ravel().tolist()}
    return out


def engine_matches(b, e, task, prompts, hist, hist_len, cfg) -> bool:
    pol, ver = cfg["policy"], cfg["verifier"]["text"]
    vocab = backbones.load(cfg).prompt_vocab(pol)
    for i, p in enumerate(prompts):
        t, m = reference.tokenize(p, pol["tokenizer_max_length"], vocab,
                                  True)
        if not (np.array_equal(b.lang_tokens[e, i], t)
                and np.array_equal(b.lang_masks[e, i], m)):
            return False
    vt, _ = reference.tokenize(task, ver["context_length"],
                               ver["vocab_size"], False)
    return (np.array_equal(b.vtoks[e], vt)
            and np.array_equal(b.history[e], hist)
            and int(b.history_len[e]) == hist_len)


def as_program(ref: dict, n: int, cfg) -> dict:
    """A one-episode host result made from a reference run, as the
    program's step would report it: the control of a w8a8 configuration
    puts the int4 reference in the program's place."""
    s = ref["scores"].numpy()
    w, stage2, score = reference.select(s, n, cfg["cover"]["rescore_threshold"])
    exec_ = ref["exec"][w].double().numpy().copy()
    if cfg["cover"]["gripper_vote"]:
        members = (w // n) * n + np.arange(n)
        exec_[0, 6] = reference.vote(ref["exec"][members, 0, 6].numpy(),
                                     exec_[0, 6])
    one = {"scores": s, "winner_idx": w, "winner_group": w // n,
           "used_stage2": stage2, "max_score": score, "deferred": False,
           "verifier_chunk": ref["verif"][w].numpy(),
           "raw_gripper": ref["actions"][w, :, 6].numpy(),
           "exec_chunk": exec_}
    return {k: np.asarray(v)[None] for k, v in one.items()}


def run(picked, earlier, cfg, k: int, stats, rephrases, weights,
        quant_levels, limits, device, control_levels=None) -> list:
    """Judge every picked answer. picked: [(boundary, [slots])]; earlier:
    boundary -> the earlier boundaries of its cohort's episode generation,
    in order. With `control_levels`, the program's answer is replaced by
    the reference's on that grid (the control of a w8a8 configuration).
    Returns one dict of numbers an answer."""
    pol = cfg["policy"]
    out = []
    for b, slots in picked:
        shape = (b.lang_tokens.shape[0], k, b.n_samples, pol["chunk_size"],
                 pol["max_action_dim"])
        noise = noise_of(b, shape, cfg["cover"]["noise_std"], device)
        for e in slots:
            task, prompts, hist, hist_len = episode_state(
                earlier(b), e, b.originals[e], rephrases, k,
                cfg["cover"]["max_history"])
            ok = engine_matches(b, e, task, prompts, hist, hist_len, cfg)
            args = (weights, cfg, stats, b.raw[e], b.proprio[e], prompts,
                    task, hist, hist_len, noise[e])
            ref = reference.episode(*args, quant_levels, device)
            program, slot = b.host, e
            if control_levels is not None:
                program = as_program(
                    reference.episode(*args, control_levels, device),
                    b.n_samples, cfg)
                slot = 0
            numbers = judge(program, ref, slot, b.n_samples, cfg, stats,
                            limits, ok)
            numbers["where"] = [b.cohort, b.generation, b.in_episode, e]
            out.append(numbers)
    return out


def verdict(answers: list, limits: dict):
    """-> (correct, failed answers, {number: (reading, limit)}): the run's
    `action_rms` and each answer's numbers at their worst, for the numbers
    the cell's limits name (a number with no limit is not compared)."""
    gaps = np.concatenate([a["detail"]["action_diffs"] for a in answers]
                          or [np.zeros(1)])
    compared = {"action_rms": (float(np.sqrt(np.mean(np.square(gaps)))),
                               limits["action_rms"])}
    numbers = [n for n in NUMBERS if n in limits]   # the cell compares
    for n in numbers:
        compared[n] = (max((a[n] for a in answers), default=0.0), limits[n])
    failed = sum(any(a[n] > limits[n] for n in numbers) for a in answers)
    correct = bool(answers) and failed == 0 and \
        compared["action_rms"][0] <= limits["action_rms"]
    return correct, failed, compared
