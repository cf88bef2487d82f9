"""The episode-batched CoVer verified control step.

Everything between raw pixels and the selected execution-format action
chunk runs on the device, for E episodes at once (every per-episode
argument has a leading E axis):

  1. image preprocessing for the policy (LANCZOS4 -> uint8 -> [-1,1]) and
     the verifier (TF-antialias to 256, PIL-bicubic 384, mean/std 0.5);
  2. proprio bound-normalisation + zero-pad to max_state_dim;
  3. pi0 sampling: one vision-tower pass per episode, K prompt prefills,
     N candidates per prompt decoding against a shared KV cache;
  4. decoding to both action formats: execution
     [xyz | axis-angle | gripper +-1] and verifier [xyz | euler | gripper 0/1];
  5. trajectory assembly (<= max_history past actions + chunk future,
     top-padded with -5);
  6. SigLIP2 ensemble scoring of all K*N candidates under the current
     instruction;
  7. branch-free two-stage selection (stage 1 accepts candidate 0 if its
     score >= threshold, else the best candidate of the group-mean-best
     language group) and the phase-aware deference gate;
  8. gripper majority vote within the winning language group.

Each stage is a span of `utils.monitor` (recorded only when recording is
on). Stages 1-5 are also exposed alone (`make_propose_step_batched`) with
the selection half over an externally supplied score vector
(`make_select_step_batched`): the injected-score selection mode.
`make_verified_step_sharded` splits the episodes over the processes of a
mesh.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cover_vla_tpu_torch.configs import CoVerConfig, Pi0Config, VerifierConfig
from cover_vla_tpu_torch.data.stats import DatasetStatistics
from cover_vla_tpu_torch.device import resolve_device
from cover_vla_tpu_torch.models import pi0, verifier
from cover_vla_tpu_torch.models.params import ParamTree
from cover_vla_tpu_torch.ops.image import (
    resize_bicubic_pil, resize_bilinear_tf_antialias,
    resize_lanczos4_uint8_device)
from cover_vla_tpu_torch.ops.sampling import sample_noise
from cover_vla_tpu_torch.parallel.mesh import batch_sharding, gather_rows
from cover_vla_tpu_torch.utils.geometry import euler_to_rotvec
from cover_vla_tpu_torch.utils.monitor import span, to_device


class VerifiedStepResult(NamedTuple):
    exec_chunk: torch.Tensor      # [E, chunk, 7] execution-format winner actions
    verifier_chunk: torch.Tensor  # [E, chunk, 7] verifier-format winner actions
    winner_idx: torch.Tensor      # int32[E] global candidate index in [0, K*N)
    winner_group: torch.Tensor    # int32[E] language/prompt index in [0, K)
    max_score: torch.Tensor       # fp32[E] winning cosine similarity
    used_stage2: torch.Tensor     # bool[E] stage-2 rescore was taken
    deferred: torch.Tensor        # bool[E] low-affinity approach-phase pick
    #                               deferred to candidate 0
    scores: torch.Tensor          # [E, K*N] all candidate scores
    raw_gripper: torch.Tensor     # [E, chunk] winner's raw [0,1] gripper output


def _policy_image(raw_u8: torch.Tensor, size: int) -> torch.Tensor:
    """uint8[E, H, W, 3] -> policy input: cv2-LANCZOS4 resize (bit-exact
    8-bit path) -> /255 -> (x - .5) / .5."""
    x = resize_lanczos4_uint8_device(raw_u8, size, size).float()
    return (x / 255.0 - 0.5) / 0.5


def _verifier_image(raw_u8: torch.Tensor, size: int) -> torch.Tensor:
    """uint8[E, H, W, 3] -> verifier input: tf.image.resize BILINEAR
    antialias to 256 with a truncating uint8 cast (skipped at 256x256),
    then PIL-bicubic to `size` and mean/std 0.5 normalisation."""
    x = raw_u8.float()
    if x.shape[1] != 256 or x.shape[2] != 256:
        x = resize_bilinear_tf_antialias(x, 256, 256)
        x = torch.floor(x).clamp(0, 255)
    x = resize_bicubic_pil(x, size, size)
    return ((x / 255.0) - 0.5) / 0.5


def decode_candidates(actions: torch.Tensor, a_p01: torch.Tensor,
                      a_p99: torch.Tensor):
    """Normalised policy outputs [..., 7] -> (exec [xyz | axis-angle |
    gripper +-1], verif [xyz | euler | gripper 0/1], raw gripper [0, 1])."""
    body = (actions[..., :6] + 1) / 2 * (a_p99[:6] - a_p01[:6]) + a_p01[:6]
    grip = actions[..., 6:]
    exec_grip = 2.0 * (grip > 0.5).float() - 1.0
    verif_grip = (grip >= 0.5).float()
    rotvec = euler_to_rotvec(body[..., 3:6])
    exec_chunks = torch.cat([body[..., :3], rotvec, exec_grip], dim=-1)
    verif_chunks = torch.cat([body, verif_grip], dim=-1)
    return exec_chunks, verif_chunks, grip


def assemble_trajectories(verif_chunks: torch.Tensor, history: torch.Tensor,
                          history_len: torch.Tensor, max_history: int,
                          padding_value: float) -> torch.Tensor:
    """[E, C, chunk, 7] candidate futures + [E, max_history, 7] shared past
    (valid entries in the last history_len[e] rows) -> [E, C,
    max_history + chunk, 7] verifier trajectories, -5 top padding."""
    e, c = verif_chunks.shape[:2]
    hist = history[:, None].expand(e, c, *history.shape[1:])
    traj = torch.cat([hist, verif_chunks], dim=2)
    row = torch.arange(traj.shape[2], device=traj.device)
    valid = row[None, :] >= (max_history - history_len.long())[:, None]
    return torch.where(valid[:, None, :, None], traj,
                       torch.full_like(traj, padding_value))


def select_from_scores(scores: torch.Tensor, n_samples: int,
                       rescore_threshold: float):
    """Two-stage branch-free selection over [E, K*N] scores: stage 1
    accepts candidate 0 iff its score >= threshold; stage 2 picks the best
    candidate inside the group-mean-best language group.
    Returns (winner [E], max_score [E], used_stage2 [E])."""
    e = scores.shape[0]
    score0 = scores[:, 0]
    grouped = scores.reshape(e, -1, n_samples)
    best_group = grouped.mean(dim=2).argmax(dim=1)
    best_in_group = grouped[torch.arange(e, device=scores.device),
                            best_group].argmax(dim=1)
    stage2_idx = best_group * n_samples + best_in_group
    used_stage2 = score0 < rescore_threshold
    winner = torch.where(used_stage2, stage2_idx, torch.zeros_like(stage2_idx))
    stage2_score = scores.gather(1, stage2_idx[:, None])[:, 0]
    max_score = torch.where(used_stage2, stage2_score, score0)
    return winner, max_score, used_stage2


def vote_gripper(exec_chunks: torch.Tensor, exec_chunk: torch.Tensor,
                 winner_group: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Majority gripper vote over the winning language group's candidates,
    applied to the executed chunk's first step. exec_chunks: [E, K*N,
    chunk, 7]; exec_chunk: [E, chunk, 7]; winner_group: [E]."""
    members = winner_group[:, None] * n_samples + torch.arange(
        n_samples, device=exec_chunks.device)[None]
    group_grippers = exec_chunks[:, :, 0, 6].gather(1, members)
    close_votes = (group_grippers >= 0).sum(dim=1)
    open_votes = n_samples - close_votes
    one = torch.ones_like(exec_chunk[:, 0, 6])
    tie = torch.where(exec_chunk[:, 0, 6] >= 0, one, -one)
    voted = torch.where(close_votes > open_votes, one,
                        torch.where(open_votes > close_votes, -one, tie))
    out = exec_chunk.clone()
    out[:, 0, 6] = torch.sign(voted)
    return out


class ProposeResult(NamedTuple):
    exec_chunks: torch.Tensor      # [E, K*N, chunk, 7] execution-format candidates
    verifier_chunks: torch.Tensor  # [E, K*N, chunk, 7] verifier-format candidates
    trajectories: torch.Tensor     # [E, K*N, history_length, 7] verifier trajs
    raw_grippers: torch.Tensor     # [E, K*N, chunk, 1] raw [0,1] gripper outputs


def _make_propose(pcfg: Pi0Config, vcfg: VerifierConfig, ccfg: CoVerConfig,
                  stats: DatasetStatistics, dev: torch.device):
    """Stages 1-5 on `dev`, shared by the fused step and the propose step:
    propose(policy_params, raw_image, proprio, lang_tokens, lang_masks,
    history, history_len, noise, generator) -> (ProposeResult, raw_image,
    proprio), the last two on `dev` for the fused step's verifier half.
    Its spans: `step.inputs` (the copies to `dev`, stages 1-2),
    `pi0.prefix` and `pi0.denoise` (stage 3, `pi0.sample_actions`) and
    `step.candidates` (stages 4-5)."""
    if ccfg.max_history + pcfg.chunk_size != vcfg.history_length:
        raise ValueError(
            f"verifier history_length ({vcfg.history_length}) must equal "
            f"max_history ({ccfg.max_history}) + chunk_size ({pcfg.chunk_size})")
    f32 = torch.float32
    a_p01 = to_device(stats.action.p01, dev, f32)
    a_p99 = to_device(stats.action.p99, dev, f32)
    p_p01 = to_device(stats.proprio.p01, dev, f32)
    p_p99 = to_device(stats.proprio.p99, dev, f32)
    K, N = ccfg.n_rephrases, ccfg.n_samples

    def propose(policy_params: ParamTree, raw_image, proprio, lang_tokens,
                lang_masks, history, history_len, noise, generator):
        with span("step.inputs"):
            raw_image = to_device(raw_image, dev)
            proprio = to_device(proprio, dev, f32)
            lang_tokens = to_device(lang_tokens, dev, torch.long)
            lang_masks = to_device(lang_masks, dev, torch.bool)
            history = to_device(history, dev, f32)
            history_len = to_device(history_len, dev, torch.long)
            E = raw_image.shape[0]
            if lang_tokens.shape[:2] != (E, K):
                raise ValueError(f"lang_tokens {tuple(lang_tokens.shape)} "
                                 f"is not [E={E}, K={K}, T]")

            # 1-2. observation preprocessing -----------------------------
            img = _policy_image(raw_image, pcfg.vision.image_size)
            state_norm = 2 * (proprio - p_p01) / (p_p99 - p_p01 + 1e-8) - 1
            state = torch.zeros((E, pcfg.max_state_dim), dtype=f32,
                                device=dev)
            state[:, :7] = state_norm.clamp(-1, 1)

            shape = (E, K, N, pcfg.chunk_size, pcfg.max_action_dim)
            noise = (sample_noise(shape, ccfg.noise_std,
                                  generator=generator, device=dev)
                     if noise is None else to_device(noise, dev, f32))
            if tuple(noise.shape) != shape:
                raise ValueError(f"noise {tuple(noise.shape)} is not {shape}")

        # 3. pi0: one vision tower pass per episode, E*K prefills, N
        # candidates each (the spans `pi0.prefix` and `pi0.denoise`) -------
        actions = pi0.sample_actions(
            policy_params, pcfg, img[:, None],
            torch.ones((E, pcfg.num_images), dtype=torch.bool, device=dev),
            lang_tokens.reshape(E * K, -1), lang_masks.reshape(E * K, -1),
            state.repeat_interleave(K, dim=0), num_candidates=N,
            noise=noise.reshape(E * K, N, *shape[3:]))

        with span("step.candidates"):
            actions = actions.reshape(E, K * N, pcfg.chunk_size,
                                      pcfg.max_action_dim)[..., :7]

            # 4. both action formats --------------------------------------
            exec_chunks, verif_chunks, grip = decode_candidates(
                actions, a_p01, a_p99)

            # 5. trajectories: [E, K*N, max_history + chunk, 7] ------------
            traj = assemble_trajectories(verif_chunks, history, history_len,
                                         ccfg.max_history,
                                         vcfg.action_padding_value)
        return (ProposeResult(exec_chunks, verif_chunks, traj, grip),
                raw_image, proprio)

    return propose


def make_verified_step_batched(pcfg: Pi0Config, vcfg: VerifierConfig,
                               ccfg: CoVerConfig, stats: DatasetStatistics,
                               device=None):
    """Episode-batched verified step on `device` (CUDA unless given):

        step(policy_params, verifier_params, raw_image, proprio,
             lang_tokens, lang_masks, verifier_tokens, history,
             history_len, noise=None, generator=None, random_winner=None)
             -> VerifiedStepResult

    raw_image uint8[E, H, W, 3]; proprio fp32[E, 7] (raw euler format);
    lang_tokens/lang_masks [E, K, T] (row 0 = current task);
    verifier_tokens int[E, Tv]; history fp32[E, max_history, 7] (valid
    entries in the last history_len rows); history_len int[E].
    noise fp32[E, K, N, chunk, max_action_dim] is the flow's starting
    point; when absent it is drawn from `generator` (times noise_std).
    random_winner int[E]: selection="random"'s picks, drawn from
    `generator` (after the noise) when absent.
    Arrays may be numpy or tensors; they are moved to `device`.
    Its stages are the spans `step.inputs`, `pi0.prefix`, `pi0.denoise`,
    `step.candidates`, `step.verifier_towers`, `step.verifier_heads` and
    `step.select` (`utils.monitor`).
    """
    if ccfg.selection not in ("verifier", "random", "first"):
        raise ValueError(f"unknown selection mode {ccfg.selection!r} "
                         "(the 'injected' mode uses make_propose_step "
                         "+ make_select_step)")
    dev = resolve_device(device)
    f32 = torch.float32
    propose = _make_propose(pcfg, vcfg, ccfg, stats, dev)
    K, N = ccfg.n_rephrases, ccfg.n_samples

    @torch.no_grad()
    def step(policy_params: ParamTree, verifier_params: ParamTree,
             raw_image, proprio, lang_tokens, lang_masks, verifier_tokens,
             history, history_len, noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             random_winner: Optional[torch.Tensor] = None
             ) -> VerifiedStepResult:
        # 1-5. preprocess, sample, decode, assemble trajectories ----------
        (exec_chunks, verif_chunks, traj, grip), raw_image, proprio = \
            propose(policy_params, raw_image, proprio, lang_tokens,
                    lang_masks, history, history_len, noise, generator)
        E = raw_image.shape[0]

        # 6. verifier scoring -----------------------------------------------
        deferred = torch.zeros(E, dtype=torch.bool, device=dev)
        zero = torch.zeros(E, dtype=torch.long, device=dev)
        verify = ccfg.selection == "verifier"
        if verify:
            with span("step.verifier_towers"):
                vimg = _verifier_image(raw_image, vcfg.vision.image_size)
                feats = verifier.extract_features(
                    verifier_params, vcfg, vimg,
                    to_device(verifier_tokens, dev, torch.long))
            with span("step.verifier_heads"):
                fused_it, fused_ac = verifier.ensemble_embed(
                    verifier_params, vcfg, feats,
                    traj.reshape(E * K * N, *traj.shape[2:]))
                scores = torch.einsum("ed,ecd->ec", fused_it,
                                      fused_ac.reshape(E, K * N, -1))

        # 7. selection --------------------------------------------------------
        with span("step.select"):
            if verify:
                winner, max_score, used_stage2 = select_from_scores(
                    scores, N, ccfg.rescore_threshold)

                # 7b. phase-aware deference: approach-phase picks in a
                # scene of low affinity to the calibration prototype fall
                # back to candidate 0; carry-phase picks stay verified
                if ccfg.defer_threshold != float("-inf"):
                    calib = verifier_params.get("calibration")
                    if calib is None:
                        raise ValueError(
                            "CoVerConfig.defer_threshold is set but the "
                            "verifier parameters have no 'calibration' "
                            "entry")
                    affinity = fused_it @ calib["prototype"].float()
                    approach = proprio[:, 6] > 0.5  # gripper still open
                    deferred = approach & (affinity < ccfg.defer_threshold)
                    winner = torch.where(deferred, zero, winner)
                    max_score = torch.where(deferred, scores[:, 0],
                                            max_score)
                    used_stage2 = used_stage2 & ~deferred
            else:
                scores = torch.zeros((E, K * N), dtype=f32, device=dev)
                max_score = torch.zeros(E, dtype=f32, device=dev)
                used_stage2 = torch.zeros(E, dtype=torch.bool, device=dev)
                if ccfg.selection == "first":
                    winner = zero
                elif random_winner is not None:
                    winner = to_device(random_winner, dev, torch.long)
                else:
                    winner = torch.randint(0, K * N, (E,),
                                           generator=generator, device=dev)

            rows = torch.arange(E, device=dev)
            exec_chunk = exec_chunks[rows, winner]
            verifier_chunk = verif_chunks[rows, winner]

            # 8. gripper majority vote within the winning language group; a
            # deferred step executes the unvoted candidate 0
            winner_group = winner // N
            if ccfg.gripper_vote:
                voted = vote_gripper(exec_chunks, exec_chunk, winner_group, N)
                exec_chunk = torch.where(deferred[:, None, None], exec_chunk,
                                         voted)

            return VerifiedStepResult(
                exec_chunk=exec_chunk, verifier_chunk=verifier_chunk,
                winner_idx=winner.to(torch.int32),
                winner_group=winner_group.to(torch.int32),
                max_score=max_score, used_stage2=used_stage2,
                deferred=deferred, scores=scores,
                raw_gripper=grip[rows, winner, :, 0])

    return step


def make_verified_step_sharded(pcfg: Pi0Config, vcfg: VerifierConfig,
                               ccfg: CoVerConfig, stats: DatasetStatistics,
                               mesh, device=None):
    """Episode-parallel verified step over the processes of `mesh`
    (`parallel.make_mesh`), each on its own device (CUDA unless given);
    the parameters are replicated (the policy fits one card; scaling is
    along the episode axis):

        step(policy_params, verifier_params, raw_image, proprio,
             lang_tokens, lang_masks, verifier_tokens, history,
             history_len, noise=None, generator=None) -> VerifiedStepResult

    Every rank passes the full-E arguments of `make_verified_step_batched`
    and gets the full-E result. The noise (and selection="random"'s
    winners) are drawn for all E episodes from `generator` and then
    sliced, so the result does not depend on the number of ranks. Rank r
    runs the batched step on its contiguous E / W episodes; no
    collectives run inside it, and the result's fields are all-gathered
    after. E must be a multiple of the mesh size (else ValueError)."""
    dev = resolve_device(device)
    batched = make_verified_step_batched(pcfg, vcfg, ccfg, stats, device=dev)
    rows = batch_sharding(mesh)
    K, N = ccfg.n_rephrases, ccfg.n_samples

    def step(policy_params: ParamTree, verifier_params: ParamTree,
             raw_image, proprio, lang_tokens, lang_masks, verifier_tokens,
             history, history_len, noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None
             ) -> VerifiedStepResult:
        E = raw_image.shape[0]
        if noise is None:
            noise = sample_noise(
                (E, K, N, pcfg.chunk_size, pcfg.max_action_dim),
                ccfg.noise_std, generator=generator, device=dev)
        winner = (torch.randint(0, K * N, (E,), generator=generator,
                                device=dev)
                  if ccfg.selection == "random" else None)
        res = batched(policy_params, verifier_params,
                      *(rows(x) for x in (raw_image, proprio, lang_tokens,
                                          lang_masks, verifier_tokens,
                                          history, history_len)),
                      noise=rows(noise),
                      random_winner=None if winner is None else rows(winner))
        return VerifiedStepResult(*(gather_rows(t, mesh) for t in res))

    return step


def make_propose_step_batched(pcfg: Pi0Config, vcfg: VerifierConfig,
                              ccfg: CoVerConfig, stats: DatasetStatistics,
                              device=None):
    """Episode-batched candidate proposal, the first half of the
    injected-score selection mode:

        propose(policy_params, raw_image, proprio, lang_tokens, lang_masks,
                history, history_len, noise=None, generator=None)
            -> ProposeResult

    with the verified step's argument shapes. It runs stages 1-5 and
    returns ALL candidates, so that an external scorer (a privileged
    oracle, a remote model, a replayed score vector) can rank them;
    selection then runs through `make_select_step_batched`, the code the
    verifier arm uses."""
    dev = resolve_device(device)
    propose = _make_propose(pcfg, vcfg, ccfg, stats, dev)

    @torch.no_grad()
    def step(policy_params: ParamTree, raw_image, proprio, lang_tokens,
             lang_masks, history, history_len,
             noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> ProposeResult:
        return propose(policy_params, raw_image, proprio, lang_tokens,
                       lang_masks, history, history_len, noise, generator)[0]

    return step


def make_select_step_batched(ccfg: CoVerConfig, device=None):
    """Episode-batched injected-score selection: the two-stage gate, the
    group-mean language selection and the gripper vote of the verifier
    arm, applied to externally supplied scores.

        select(scores [E, K*N], exec_chunks, verif_chunks, raw_grippers)
            -> VerifiedStepResult   (deferred is all False)
    """
    dev = resolve_device(device)
    N = ccfg.n_samples

    @torch.no_grad()
    def select(scores, exec_chunks, verif_chunks,
               raw_grippers) -> VerifiedStepResult:
        with span("step.select"):
            scores = to_device(scores, dev, torch.float32)
            exec_chunks = to_device(exec_chunks, dev, torch.float32)
            verif_chunks = to_device(verif_chunks, dev, torch.float32)
            raw_grippers = to_device(raw_grippers, dev, torch.float32)
            winner, max_score, used_stage2 = select_from_scores(
                scores, N, ccfg.rescore_threshold)
            rows = torch.arange(scores.shape[0], device=dev)
            exec_chunk = exec_chunks[rows, winner]
            winner_group = winner // N
            if ccfg.gripper_vote:
                exec_chunk = vote_gripper(exec_chunks, exec_chunk,
                                          winner_group, N)
            return VerifiedStepResult(
                exec_chunk=exec_chunk,
                verifier_chunk=verif_chunks[rows, winner],
                winner_idx=winner.to(torch.int32),
                winner_group=winner_group.to(torch.int32),
                max_score=max_score, used_stage2=used_stage2,
                deferred=torch.zeros_like(used_stage2), scores=scores,
                raw_gripper=raw_grippers[rows, winner, :, 0])

    return select


def make_verified_step(pcfg: Pi0Config, vcfg: VerifierConfig,
                       ccfg: CoVerConfig, stats: DatasetStatistics,
                       device=None):
    """The verified step for ONE episode: the batched step at E = 1, with
    unbatched arguments (raw_image [H, W, 3], proprio [7], lang_tokens /
    lang_masks [K, T], verifier_tokens [Tv], history [max_history, 7],
    history_len scalar, noise [K, N, chunk, A]) and unbatched results."""
    batched = make_verified_step_batched(pcfg, vcfg, ccfg, stats, device)

    def step(policy_params, verifier_params, raw_image, proprio,
             lang_tokens, lang_masks, verifier_tokens, history, history_len,
             noise=None, generator=None) -> VerifiedStepResult:
        def one(x):
            return None if x is None else torch.as_tensor(x)[None]
        res = batched(policy_params, verifier_params, one(raw_image),
                      one(proprio), one(lang_tokens), one(lang_masks),
                      one(verifier_tokens), one(history), one(history_len),
                      noise=one(noise), generator=generator)
        return VerifiedStepResult(*(t[0] for t in res))

    return step
