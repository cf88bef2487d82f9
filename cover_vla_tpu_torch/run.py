"""Unified CLI entry point of the PyTorch port.

Roles (all of the JAX package's):
  train            — pi0 finetuning on a trajectory dataset (npz dir or
                     rlds shards)
  train_pi0fast    — pi0-FAST finetuning (CE over FAST action tokens)
  train_verifier   — verifier contrastive training
  serve_policy     — websocket policy server (pi0 or CoVer engine)
  eval             — closed-loop CoVer evaluation on a benchmark suite
  bench            — the full-width throughput benchmark
                     (`cover_vla_tpu_torch/bench.py`, one JSON line)

The config classes are the JAX package's, field for field and default for
default, so every YAML of `config/` parses the same in both packages.

Multi-process: `main` makes the process group from the environment
(`parallel.distributed.init_multihost`: torchrun's variables or the JAX
package's) before the role runs. Each rank runs on its own device
(`cuda:LOCAL_RANK` unless `--device` names one; `--device cpu` runs the
ranks over gloo). With more than one process the training roles shard:
π0 and π0-FAST over a ('dp', 'fsdp') mesh from `--train.dp` /
`--train.fsdp` (all on fsdp by default), the verifier as DDP (dp = world
size); every rank reads the same global batches, a batch that does not
divide over the ranks is refused (ValueError), metrics are averaged over
the ranks, and rank 0 alone writes the metric sinks and files.

    torchrun --standalone --nproc_per_node 8 -m cover_vla_tpu_torch.run \
        --role train --train.dataset_dir <dir> --train.batch_size 32

Usage: python -m cover_vla_tpu_torch.run --role train \
       --train.dataset_dir <dir of .npz trajectories> --train.batch_size 32

Everything runs on the first CUDA device unless `--device` (or
`main(argv, device=)`) names another; every role and `build_server` take
`device=` too (the tests pass "cpu").
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class TrainCfg:
    batch_size: int = 32
    num_steps: int = 1000
    lr: float = 5e-5
    warmup_steps: int = 100
    grad_accum: int = 1
    optimizer: str = "adamw"    # adamw | adamw_8bit (quantised moments)
    train_expert_only: bool = True   # freeze VLM+vision; grads/moments only
                                     # for the expert + projections
    dp: int = 0                 # 0 = auto (all devices on fsdp)
    fsdp: int = 0
    checkpoint_dir: str = "checkpoints"
    save_every: int = 500
    keep_last: int = 3
    resume: bool = False
    dataset_dir: str = ""       # dir of .npz trajectories / rlds shards
    data_format: str = "npz"    # npz | rlds (TFDS/OXE TFRecord shards)
    shuffle_buffer: int = 1000  # interleave shuffle buffer
    augment: bool = False       # random_resized_crop + color jitter
    paraphrase_json: str = ""   # rephrase store for ParaphraseAugment
    paraphrase_prob: float = 0.5
    val_every: int = 0          # 0 = no validation
    val_batches: int = 4        # held-out batches rolled per validation
    val_fraction: float = 0.1   # held-out fraction (verifier training)
    num_members: int = 3        # verifier ensemble size
    metrics_jsonl: str = ""     # default: <checkpoint_dir>/metrics.jsonl
    wandb_project: str = ""
    tiny: bool = False          # tiny model (CI)
    seed: int = 42


@dataclass(frozen=True)
class ServeCfg:
    host: str = "0.0.0.0"
    port: int = 8000
    mode: str = "pi0"           # pi0 | cover
    checkpoint: str = ""
    verifier_checkpoint: str = ""   # cover mode
    n_samples: int = 5              # cover mode: candidates per prompt
    n_rephrases: int = 8
    tiny: bool = False
    # serving a real checkpoint without real tokenizer artifacts emits
    # garbage — refuse unless explicitly allowed
    allow_hash_tokenizer: bool = False
    tokenizer: str = ""             # policy tokenizer path override
    # serving-time int8 (w8a8) quantization — same modes as EvalCfg
    quantize: str = "none"


@dataclass(frozen=True)
class EvalCfg:
    task_suite: str = "simpler_widowx"
    num_trials_per_task: int = 10
    max_steps: int = 150
    n_samples: int = 5
    n_rephrases: int = 8
    # candidate selection: verifier (CoVer loop) | random | first — the
    # ablation arms of the reference's headline table
    selection: str = "verifier"
    # >1 routes through the lockstep-batched engine (the reference's
    # n_parallel_eval)
    n_parallel: int = 1
    # two-cohort pipelined dispatch (2*n_parallel episodes in flight)
    pipelined: bool = False
    out_dir: str = "eval_out"
    policy_checkpoint: str = ""
    verifier_checkpoint: str = ""
    # dataset-statistics JSON for BOTH the engine normalization and the env
    # adapter ("" = vendored bridge stats). google_robot suites REQUIRE an
    # explicit (fractal) path — Bridge bounds would silently mis-normalize
    dataset_statistics: str = ""
    tokenizer: str = ""             # policy tokenizer path override
    verifier_tokenizer: str = ""
    allow_hash_tokenizer: bool = False
    # serving-time int8 (w8a8) quantization (ops/quant.py): none | int8
    # (policy Gemma stacks + vision tower) | int8_full (also the verifier's
    # SigLIP2 backbone)
    quantize: str = "none"
    tiny: bool = False
    seed: int = 7


@dataclass(frozen=True)
class RunCfg:
    role: str = "eval"
    train: TrainCfg = TrainCfg()
    serve: ServeCfg = ServeCfg()
    eval: EvalCfg = EvalCfg()


_QUANTIZE_MODES = ("none", "int8", "int8_full")


def _load_trajectories(dataset_dir: str):
    """Each .npz holds one trajectory: images/states/actions (+task str)."""
    trajs = []
    for fn in sorted(os.listdir(dataset_dir)):
        if fn.endswith(".npz"):
            z = np.load(os.path.join(dataset_dir, fn), allow_pickle=True)
            trajs.append({
                "images": z["images"], "states": z["states"],
                "actions": z["actions"],
                "task": str(z["task"]) if "task" in z else "",
            })
    if not trajs:
        raise FileNotFoundError(f"no .npz trajectories in {dataset_dir}")
    return trajs


def _train_mesh(t: TrainCfg, dp: int = 0, fsdp: int = 0):
    """The training mesh of a multi-process run (None for one process):
    `dp` x `fsdp` (0 = the JAX package's defaults). The global batch must
    divide over the ranks: the JAX package would run unsharded there and
    train each rank's copy apart."""
    from cover_vla_tpu_torch.parallel.distributed import world_size
    from cover_vla_tpu_torch.parallel.mesh import make_mesh
    n = world_size()
    if n == 1:
        return None
    if t.batch_size % n:
        raise ValueError(f"--train.batch_size {t.batch_size} does not divide "
                         f"over {n} processes")
    return make_mesh(dp=dp or None, fsdp=fsdp or None)


def _sinks(t: TrainCfg):
    """The metric sinks: rank 0's; the other ranks log nowhere."""
    from cover_vla_tpu_torch.parallel.distributed import rank
    from cover_vla_tpu_torch.utils.metrics_sink import make_sinks
    if rank():
        return make_sinks()
    return make_sinks(
        jsonl_path=t.metrics_jsonl or os.path.join(t.checkpoint_dir,
                                                   "metrics.jsonl"),
        wandb_project=t.wandb_project or None)


def _frame_dataset(t: TrainCfg, chunk_size: int, paraphrase=None):
    """The training frames of `--train.dataset_dir`: npz trajectories, or
    RLDS TFRecord shards streamed one episode at a time."""
    from cover_vla_tpu_torch.data.pipeline import (
        FrameDataset, StreamingFrameDataset)
    if t.data_format == "rlds":
        from cover_vla_tpu_torch.data.rlds import RldsShardDataset
        return StreamingFrameDataset(RldsShardDataset(t.dataset_dir),
                                     chunk_size=chunk_size,
                                     paraphrase=paraphrase)
    return FrameDataset(_load_trajectories(t.dataset_dir),
                        chunk_size=chunk_size, paraphrase=paraphrase)


def _bilinear_image_fn(size: int):
    """uint8 [B, H, W, 3] on the device -> [-1, 1] fp32 at size x size
    (the PyTorch bilinear resize, only when the frames differ in size)."""
    from cover_vla_tpu_torch.ops.image import resize_bilinear_torch

    def image_fn(imgs):
        x = imgs.float() / 255.0 * 2.0 - 1.0
        if tuple(imgs.shape[1:3]) != (size, size):
            x = resize_bilinear_torch(x, size, size)
        return x

    return image_fn


def role_train(cfg: RunCfg, device=None):
    """pi0 finetuning: expert-only (the partitioned state) or the whole
    tree, AdamW or 8-bit AdamW under warmup-cosine, optional validation,
    train-state checkpoints under <checkpoint_dir>/step_<N>/ and a resume
    from the latest one. Metrics go to <checkpoint_dir>/metrics.jsonl
    every 10 steps, as the JAX role logs them at one process."""
    import torch
    from cover_vla_tpu_torch.configs import Pi0Config, tiny_pi0_config
    from cover_vla_tpu_torch.convert import checkpoints
    from cover_vla_tpu_torch.data.pipeline import (
        ParaphraseAugment, batcher, interleave, make_pi0_batch, prefetch)
    from cover_vla_tpu_torch.data.tokenizer import make_policy_tokenizer
    from cover_vla_tpu_torch.parallel.distributed import (
        aggregate_metrics, local_device)
    from cover_vla_tpu_torch.parallel.mesh import gather_params
    from cover_vla_tpu_torch.training import train_pi0
    from cover_vla_tpu_torch.training.optim import warmup_cosine
    from cover_vla_tpu_torch.training.validation import validate_pi0
    from cover_vla_tpu_torch.utils.monitor import Timer, setup_logger

    t = cfg.train
    dev = local_device(device)
    log = setup_logger("train")
    mcfg = tiny_pi0_config() if t.tiny else Pi0Config()
    tok = make_policy_tokenizer(mcfg.paligemma.vocab_size)

    paraphrase = None
    if t.paraphrase_json:
        from cover_vla_tpu_torch.eval.rephrase import load_rephrases
        paraphrase = ParaphraseAugment(load_rephrases(t.paraphrase_json),
                                       prob=t.paraphrase_prob)
    ds = _frame_dataset(t, mcfg.chunk_size, paraphrase)

    s = mcfg.vision.image_size
    if t.augment:
        # random_resized_crop + color jitter on the device, raw uint8 in
        from cover_vla_tpu_torch.data.augment import augment_frame

        def image_fn(gen, imgs):
            return augment_frame(gen, imgs, (s, s))
    else:
        resize = _bilinear_image_fn(s)

        def image_fn(gen, imgs):
            return resize(imgs)

    def device_batch(frame_batch, gen):
        batch = make_pi0_batch(frame_batch, tok, mcfg)
        out = {k: torch.from_numpy(np.asarray(v)).to(dev)
               for k, v in batch.items() if k != "images"}
        imgs = torch.from_numpy(np.asarray(frame_batch["image"])).to(dev)
        out["images"] = image_fn(gen, imgs)[:, None]
        return out

    def generator(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    mesh = _train_mesh(t, t.dp, t.fsdp)
    sinks = _sinks(t)
    tx = train_pi0.make_optimizer(
        warmup_cosine(t.lr, t.warmup_steps, t.num_steps),
        optimizer=t.optimizer, accumulate_steps=t.grad_accum)
    if t.train_expert_only:
        # no gradient buffers or moments for the frozen weights
        state, mask = train_pi0.init_partitioned_train_state(
            t.seed, mcfg, tx, mesh=mesh, device=dev)
        step_fn = train_pi0.make_partitioned_train_step(mcfg, tx, mask,
                                                        mesh=mesh)
    else:
        state = train_pi0.init_train_state(t.seed, mcfg, tx, mesh=mesh,
                                           device=dev)
        step_fn = train_pi0.make_train_step(mcfg, tx, mesh=mesh)
    start = 0
    if t.resume:
        state, start = checkpoints.restore_train_state(t.checkpoint_dir,
                                                       state)
        log.info("resumed from step %d", start)

    timer = Timer()
    frames = prefetch(batcher(interleave([ds], seed=t.seed,
                                         shuffle_buffer=t.shuffle_buffer),
                              t.batch_size))
    val_set = []
    if t.val_every:
        # a held-out stream of batches; each validation rolls all of them
        for vb in range(max(1, t.val_batches)):
            val_set.append(device_batch(next(frames),
                                        generator(t.seed - 1 - vb)))
    for i, frame_batch in enumerate(frames):
        if start + i >= t.num_steps:
            break
        # one generator a step, the same on every rank: the global batch's
        # augmentation draws, then the step's noise and flow times
        gen = generator(t.seed + start + i)
        state, metrics = step_fn(state, gen, device_batch(frame_batch, gen))
        if (start + i) % 10 == 0:
            m = aggregate_metrics({k: float(v) for k, v in metrics.items()})
            sinks.log(m, step=start + i)
            log.info("step %d loss %.4f (%.2fs)", start + i, m["loss"],
                     timer.elapsed())
        if t.val_every and (start + i + 1) % t.val_every == 0:
            params = gather_params(state.params)
            vms = [validate_pi0(params, mcfg, vb, seed=vi)
                   for vi, vb in enumerate(val_set)]
            del params
            val = aggregate_metrics({k: float(np.mean([m[k] for m in vms]))
                                     for k in vms[0]})
            sinks.log({f"val/{k}": v for k, v in val.items()},
                      step=start + i + 1)
            log.info("step %d val %s", start + i + 1, val)
        if (start + i + 1) % t.save_every == 0:
            checkpoints.save_train_state(t.checkpoint_dir, start + i + 1,
                                         state, keep_last=t.keep_last)
    checkpoints.save_train_state(t.checkpoint_dir, t.num_steps, state,
                                 keep_last=t.keep_last)
    sinks.close()
    log.info("done")


def role_train_pi0fast(cfg: RunCfg, device=None):
    """pi0-FAST finetuning: teacher-forced CE over FAST action tokens,
    the whole tree trained under warmup-cosine AdamW or 8-bit AdamW, over
    the npz or RLDS frames of `role_train`; train-state checkpoints under
    <checkpoint_dir>/step_<N>/ and a resume from the latest one."""
    import torch
    from cover_vla_tpu_torch.convert import checkpoints
    from cover_vla_tpu_torch.data.fast_tokenizer import FastActionTokenizer
    from cover_vla_tpu_torch.data.pipeline import batcher, interleave, prefetch
    from cover_vla_tpu_torch.data.tokenizer import make_policy_tokenizer
    from cover_vla_tpu_torch.models.pi0fast import (
        Pi0FastConfig, tiny_pi0fast_config)
    from cover_vla_tpu_torch.parallel.distributed import (
        aggregate_metrics, local_device)
    from cover_vla_tpu_torch.training import train_pi0fast
    from cover_vla_tpu_torch.training.optim import warmup_cosine
    from cover_vla_tpu_torch.training.train_pi0 import make_optimizer
    from cover_vla_tpu_torch.utils.monitor import Timer, setup_logger

    t = cfg.train
    dev = local_device(device)
    log = setup_logger("train_pi0fast")
    mcfg = tiny_pi0fast_config() if t.tiny else Pi0FastConfig()
    tok = make_policy_tokenizer(mcfg.paligemma.vocab_size)
    ds = _frame_dataset(t, mcfg.chunk_size)
    image_fn = _bilinear_image_fn(mcfg.vision.image_size)
    fast = FastActionTokenizer(time_horizon=mcfg.chunk_size, action_dim=7)
    mesh = _train_mesh(t, t.dp, t.fsdp)
    sinks = _sinks(t)
    tx = make_optimizer(warmup_cosine(t.lr, t.warmup_steps, t.num_steps),
                        optimizer=t.optimizer, accumulate_steps=t.grad_accum)
    state = train_pi0fast.init_train_state(t.seed, mcfg, tx, mesh=mesh,
                                           device=dev)
    step_fn = train_pi0fast.make_train_step(mcfg, tx, mesh=mesh)
    start = 0
    if t.resume:
        state, start = checkpoints.restore_train_state(t.checkpoint_dir,
                                                       state)
        log.info("resumed from step %d", start)
    timer = Timer()
    frames = prefetch(batcher(interleave([ds], seed=t.seed,
                                         shuffle_buffer=t.shuffle_buffer),
                              t.batch_size))
    for i, frame_batch in enumerate(frames):
        if start + i >= t.num_steps:
            break
        batch = train_pi0fast.make_fast_batch(frame_batch, tok, mcfg,
                                              fast_tokenizer=fast)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()
                 if k != "images"}
        imgs = torch.from_numpy(np.asarray(frame_batch["image"])).to(dev)
        batch["images"] = image_fn(imgs)[:, None]
        state, metrics = step_fn(state, batch)
        if (start + i) % 10 == 0:
            m = aggregate_metrics({k: float(v) for k, v in metrics.items()})
            sinks.log(m, step=start + i)
            log.info("step %d loss %.4f (%.2fs)", start + i, m["loss"],
                     timer.elapsed())
        if (start + i + 1) % t.save_every == 0:
            checkpoints.save_train_state(t.checkpoint_dir, start + i + 1,
                                         state, keep_last=t.keep_last)
    checkpoints.save_train_state(t.checkpoint_dir, t.num_steps, state,
                                 keep_last=t.keep_last)
    sinks.close()
    log.info("done")


def role_train_verifier(cfg: RunCfg, device=None):
    """Verifier ensemble training from a normalized Bridge-verifier JSON
    (train.dataset_dir is the JSON file or its directory, which then
    holds dataset.json): all --train.num_members members in one step,
    retrieval top-1 validated on a held-out split, the best parameters
    under <checkpoint_dir>/best/ plus the last keep_last train states, a
    resume from the latest one, and the merged ensemble exported in the
    reference .pt schema (merged_ensemble.pt)."""
    import torch
    from cover_vla_tpu_torch.configs import (
        VerifierConfig, tiny_verifier_config)
    from cover_vla_tpu_torch.convert import checkpoints
    from cover_vla_tpu_torch.convert.verifier_to_torch import (
        save_merged_ensemble)
    from cover_vla_tpu_torch.data.bridge_verifier_dataset import (
        BridgeVerifierDataset)
    from cover_vla_tpu_torch.data.tokenizer import make_verifier_tokenizer
    from cover_vla_tpu_torch.parallel.distributed import (
        aggregate_metrics, local_device, rank, world_size)
    from cover_vla_tpu_torch.training import train_verifier
    from cover_vla_tpu_torch.training.optim import linear_warmup, make_adamw
    from cover_vla_tpu_torch.utils.monitor import setup_logger

    t = cfg.train
    dev = local_device(device)
    log = setup_logger("train_verifier")
    vcfg = tiny_verifier_config() if t.tiny else VerifierConfig()
    json_path = t.dataset_dir if t.dataset_dir.endswith(".json") else \
        os.path.join(t.dataset_dir, "dataset.json")
    ds = BridgeVerifierDataset(json_path, history_length=vcfg.history_length,
                               image_size=vcfg.vision.image_size)
    tok = make_verifier_tokenizer(vcfg.text.vocab_size)
    ctx = vcfg.text.context_length

    def on_device(batch):
        batch.pop("instructions")
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    val_batch = None
    if t.val_every:
        ds, val_ds = ds.split(t.val_fraction, seed=t.seed)
        val_batch = on_device(next(val_ds.batches(
            min(t.batch_size, len(val_ds)), tok, ctx, seed=0)))
    if len(ds) < t.batch_size:
        raise ValueError(f"{len(ds)} training samples make no batch of "
                         f"{t.batch_size}")

    tx = make_adamw(linear_warmup(t.lr, t.warmup_steps))
    backbone, state = train_verifier.init_train_state(
        t.seed, vcfg, tx, num_members=t.num_members, device=dev)
    # the reference's DDP: every rank a replica of the members
    step_fn = train_verifier.make_ensemble_train_step(
        vcfg, tx, mesh=_train_mesh(t, dp=world_size(), fsdp=1))
    sinks = _sinks(t)

    def saved():
        return train_verifier.VerifierCheckpoint(state.members,
                                                 state.opt_state, backbone)

    start = 0
    if t.resume:
        # in place: the members, their moments and the backbone
        _, start = checkpoints.restore_train_state(t.checkpoint_dir, saved())
        log.info("resumed from step %d", start)

    def save(step_i):
        checkpoints.save_train_state(t.checkpoint_dir, step_i, saved(),
                                     keep_last=t.keep_last)

    best_top1 = -1.0
    i = start
    while i < t.num_steps:
        for batch in ds.batches(t.batch_size, tok, ctx, seed=t.seed + i):
            state, metrics = step_fn(state, backbone, on_device(batch))
            if i % 10 == 0:
                m = aggregate_metrics({k: float(v) for k, v in metrics.items()
                                       if v.ndim == 0})
                sinks.log(m, step=i)
                log.info("step %d loss %.4f top1 %.3f", i, m["loss"],
                         m["top1_i2a"])
            i += 1
            if t.val_every and val_batch is not None \
                    and i % t.val_every == 0:
                val = aggregate_metrics({k: float(v) for k, v in
                                         train_verifier.ensemble_eval_metrics(
                                             state.members, vcfg, backbone,
                                             val_batch).items()})
                sinks.log({f"val/{k}": v for k, v in val.items()}, step=i)
                log.info("step %d val top1 %.3f", i, val["top1_i2a"])
                save(i)
                if val["top1_i2a"] > best_top1:
                    best_top1 = val["top1_i2a"]
                    if not rank():
                        checkpoints.save_params(
                            os.path.join(t.checkpoint_dir, "best"),
                            {"members": state.members, "backbone": backbone})
            if i >= t.num_steps:
                break
    save(t.num_steps)
    if not rank():
        # the merged ensemble in the reference schema; it reads back
        # through convert.verifier_from_torch.convert_merged_checkpoint
        save_merged_ensemble(
            os.path.join(t.checkpoint_dir, "merged_ensemble.pt"),
            state.members, vcfg)
        log.info("exported merged ensemble (%d members)", t.num_members)
    sinks.close()
    log.info("done")


def build_server(cfg: RunCfg, device=None):
    """The websocket server of `--role serve_policy`, not yet serving."""
    from cover_vla_tpu_torch.configs import Pi0Config, tiny_pi0_config
    from cover_vla_tpu_torch.convert.loaders import (
        load_policy_params, load_verifier_params)
    from cover_vla_tpu_torch.data.tokenizer import make_policy_tokenizer
    from cover_vla_tpu_torch.device import resolve_device
    from cover_vla_tpu_torch.models import pi0
    from cover_vla_tpu_torch.serving import (
        Pi0PolicyWrapper, WebsocketPolicyServer)

    s = cfg.serve
    if s.quantize not in _QUANTIZE_MODES:
        raise SystemExit(f"--serve.quantize {s.quantize!r}: "
                         "expected none | int8 | int8_full")
    dev = resolve_device(device)
    mcfg = tiny_pi0_config() if s.tiny else Pi0Config()
    tok = make_policy_tokenizer(
        mcfg.paligemma.vocab_size,
        **({"hf_path": s.tokenizer} if s.tokenizer else {}),
        strict=bool(s.checkpoint) and not s.allow_hash_tokenizer)
    params = load_policy_params(s.checkpoint, mcfg, device=dev) \
        if s.checkpoint else pi0.init_pi0(0, mcfg, device=dev)
    if s.mode == "cover":
        # the fused sample->score->select engine behind the same RPC verbs
        from cover_vla_tpu_torch.configs import (
            CoVerConfig, VerifierConfig, tiny_verifier_config)
        from cover_vla_tpu_torch.engine import CoVerEngine
        from cover_vla_tpu_torch.eval.rephrase import load_rephrases
        from cover_vla_tpu_torch.models import verifier
        from cover_vla_tpu_torch.serving import CoVerPolicyWrapper
        vcfg = tiny_verifier_config() if s.tiny else VerifierConfig()
        vp = load_verifier_params(s.verifier_checkpoint, vcfg, device=dev) \
            if s.verifier_checkpoint \
            else verifier.init_verifier(1, vcfg, 3, device=dev)
        engine = CoVerEngine(params, vp, mcfg, vcfg,
                             CoVerConfig(n_samples=s.n_samples,
                                         n_rephrases=s.n_rephrases),
                             policy_tokenizer=tok,
                             rephrases=load_rephrases(), device=dev)
        policy = CoVerPolicyWrapper(engine, quantize=s.quantize)
    else:
        policy = Pi0PolicyWrapper(params, mcfg, tokenizer=tok,
                                  quantize=s.quantize, device=dev)
    return WebsocketPolicyServer(policy, s.host, s.port,
                                 metadata={"model": s.mode})


def role_serve(cfg: RunCfg, device=None):
    server = build_server(cfg, device=device)
    s = cfg.serve
    print(f"serving {s.mode} on ws://{s.host}:{s.port}")
    server.serve_forever()


def role_eval(cfg: RunCfg, device=None):
    """Closed-loop evaluation of a benchmark suite; prints the summary."""
    from cover_vla_tpu_torch.configs import (
        CoVerConfig, Pi0Config, VerifierConfig, tiny_pi0_config,
        tiny_verifier_config)
    from cover_vla_tpu_torch.convert.loaders import (
        load_policy_params, load_verifier_params)
    from cover_vla_tpu_torch.data.stats import DatasetStatistics
    from cover_vla_tpu_torch.data.tokenizer import (
        make_policy_tokenizer, make_verifier_tokenizer)
    from cover_vla_tpu_torch.device import resolve_device
    from cover_vla_tpu_torch.engine import CoVerEngine
    from cover_vla_tpu_torch.eval.evaluator import (
        CoVerEvaluator, EvalConfig, evaluate_suite_batched)
    from cover_vla_tpu_torch.eval.rephrase import load_rephrases
    from cover_vla_tpu_torch.models import pi0, verifier

    e = cfg.eval
    dev = resolve_device(device)
    pcfg = tiny_pi0_config() if e.tiny else Pi0Config()
    vcfg = tiny_verifier_config() if e.tiny else VerifierConfig()
    ccfg = CoVerConfig(n_samples=e.n_samples, n_rephrases=e.n_rephrases,
                       selection=e.selection,
                       gripper_vote=(e.selection == "verifier"))
    # real checkpoints demand real tokenizers unless explicitly overridden
    strict = bool(e.policy_checkpoint) and not e.allow_hash_tokenizer
    ptok = make_policy_tokenizer(
        pcfg.paligemma.vocab_size,
        **({"hf_path": e.tokenizer} if e.tokenizer else {}), strict=strict)
    vtok = make_verifier_tokenizer(
        vcfg.text.vocab_size, hf_path=e.verifier_tokenizer or None,
        strict=bool(e.verifier_checkpoint) and not e.allow_hash_tokenizer)
    is_google = e.task_suite.startswith("simpler_google")
    if is_google and not e.dataset_statistics:
        raise SystemExit(
            "google_robot suites require --eval.dataset_statistics "
            "(fractal statistics); the vendored Bridge bounds would "
            "silently mis-normalize fractal-trained checkpoints")
    stats = DatasetStatistics.from_json(e.dataset_statistics) \
        if e.dataset_statistics else DatasetStatistics.from_json()
    pp = load_policy_params(e.policy_checkpoint, pcfg, device=dev) \
        if e.policy_checkpoint else pi0.init_pi0(0, pcfg, device=dev)
    vp = load_verifier_params(e.verifier_checkpoint, vcfg, device=dev) \
        if e.verifier_checkpoint \
        else verifier.init_verifier(1, vcfg, 3, device=dev)
    if e.quantize not in _QUANTIZE_MODES:
        raise SystemExit(f"--eval.quantize {e.quantize!r}: "
                         "expected none | int8 | int8_full")
    if e.quantize != "none":
        from cover_vla_tpu_torch.ops import quant
        pp = quant.quantize_pi0_policy(pp)
        if e.quantize == "int8_full":
            vp = quant.quantize_verifier(vp)
    ecfg = EvalConfig(
        task_suite=e.task_suite, num_trials_per_task=e.num_trials_per_task,
        max_steps=e.max_steps, out_dir=e.out_dir, seed=e.seed)
    if e.n_parallel > 1:
        out = evaluate_suite_batched(
            pp, vp, pcfg, vcfg, ccfg, ecfg, n_parallel=e.n_parallel,
            stats=stats, rephrases=load_rephrases(), pipelined=e.pipelined,
            seed=e.seed, policy_tokenizer=ptok, verifier_tokenizer=vtok,
            device=dev)
        print(json.dumps({**out["summary"],
                          "actions_per_sec": round(out["actions_per_sec"], 2),
                          "wall_s": round(out["wall_s"], 2)}, indent=2))
        return
    engine = CoVerEngine(pp, vp, pcfg, vcfg, ccfg, stats=stats,
                         policy_tokenizer=ptok, verifier_tokenizer=vtok,
                         rephrases=load_rephrases(), seed=e.seed, device=dev)
    ev = CoVerEvaluator(engine, ecfg,
                        stats=None if is_google else stats,
                        fractal_stats=stats if is_google else None)
    out = ev.evaluate()
    print(json.dumps(out["summary"], indent=2))


def role_bench(cfg: RunCfg, device=None):
    """The throughput benchmark (`cover_vla_tpu_torch.bench`) at its
    defaults; it takes no argument from the command line, which holds the
    role's own."""
    from cover_vla_tpu_torch import bench
    bench.main([], device=device)


def main(argv=None, device=None):
    """Parse `argv` and run its role on `device` (this rank's CUDA device
    unless given), in the process group of a multi-process launch when the
    environment configures one. `--device <name>` in `argv` names the
    device too; it is no field of the configs, which stay the JAX
    package's."""
    import sys
    from cover_vla_tpu_torch.parallel.distributed import (
        init_multihost, shutdown)
    from cover_vla_tpu_torch.utils.cli import parse
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise SystemExit("--device needs a value (cuda, cuda:1, cpu)")
        device = argv[i + 1]
        del argv[i:i + 2]
    cfg = parse(RunCfg, argv)
    role = {"train": role_train, "train_pi0fast": role_train_pi0fast,
            "train_verifier": role_train_verifier, "serve_policy": role_serve,
            "eval": role_eval, "bench": role_bench}.get(cfg.role)
    if role is None:
        raise SystemExit(
            f"unknown role {cfg.role!r} "
            f"(train|train_pi0fast|train_verifier|serve_policy|eval|bench)")
    started = init_multihost(device=device)
    try:
        role(cfg, device=device)
    finally:
        if started:
            shutdown()


if __name__ == "__main__":
    main()
