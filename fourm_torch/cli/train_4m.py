"""4M pre-training on one card or several: the port of fourm_tpu/cli/train_4m.py.

Carried over: `--config` (a run config of cfgs/default/4m/models/**, read by
the port's YAML reader; CLI flags win) and the `auto` run name, the model
registry and overrides, token budgets (with `--min_input_tokens` /
`--min_target_tokens` ranges) and loss type, the token-budget step math
(reference run_training_4m.py:431-470), LR x bs/256 (:498), the three
schedules, AdamW with the 4M decay rules, the global-norm clip, `--skip_grad`
(a step whose gradient norm exceeds it, or is not finite, is skipped, on the
card), `--layer_decay` (per-layer LR scales, in the reference's order: see
utils/optim.py), the frozen-trunk phase of `--frozen_model_epochs` epochs
(:522-529: only the embeddings train), `--remat` (activation checkpointing
per block), gradient accumulation, the NaN tripwire with a batch dump
(:729-732), per-step print lines, `config.json` and a JSONL log with
tokens-seen accounting, checkpoints every `--save_ckpt_freq` epochs of
`--epoch_size` samples and at the end (`checkpoints/step_N`: the fp32
masters, the AdamW moments and step count, the step, the generators'
states; and a params export `weights/step_N`, which cli/generate.py:load_fm
reads), auto-resume from the newest checkpoint (on by default; a resumed run
restarts its data stream, as the JAX CLI does; a JAX run's orbax
`checkpoints/step_N` resumes too: its fp32 masters, AdamW moments and count
and step, while the generators restart from `--seed`, since the JAX run's
RNG state has no counterpart here), `--finetune` (a warm start from a
released .safetensors, or a step, checkpoint or run directory of the port
or of the JAX package, without its `.pos_emb` tensors, reference
:475-487), and the eval every `--eval_freq`
epochs (:156-192, :798-832) on the data config's val datasets, or held-out
synthetic batches, at the fixed `--fixed_eval_*` budgets.

Data: `--data_config` (cfgs/default/4m/data/** layout: tar shards with
use_wds, or aligned folders; a mixture of datasets with weights), decoded,
transformed, Dirichlet-masked and batched by fourm_torch/data, inline or in
`--num_workers` spawn processes, prefetched by a thread; or
`--synthetic_data`. Unlike the JAX CLI, which starts afresh when a resume
fails (fourm_tpu/cli/train_4m.py:326-333), a checkpoint that cannot be read
raises. A MetricLogger keeps the printed steps' loss and gradient norm, and
the step and eval stats go to log.txt and to WandbLogger: `--log_wandb`
prints that wandb is absent (the port imports no wandb) and carries on, as
the JAX CLI does where wandb is not installed.

Several cards: run it under torchrun, one process a card. `--fsdp` and
`--tensor` size those axes of the (data, fsdp, tensor) mesh and `data` takes
the rest of the world (parallel/mesh.py); the global batch is batch_size x
world x grad_accum_steps and lr = blr x global batch / 256, as the JAX CLI
(a tensor group shares batch_size x tensor samples). Each rank of the
(data, fsdp) group takes its rows of the global batch: of each synthetic
batch, or from its own shards of a data config (data/pretrain_utils.py).
The eval's losses are the global batch's. Only rank 0 prints, logs and
writes; checkpoints hold whole tensors (gathered), and resume at any mesh.

Usage:
  python -m fourm_torch.cli.train_4m --config cfgs/default/4m/models/main/4m-b_mod21_500b.yaml \
      --data_config my_shards.yaml --text_tokenizer_path tokenizer.json   # on the card
  python -m fourm_torch.cli.train_4m --synthetic_data --max_steps 100     # no data
  python -m fourm_torch.cli.train_4m --device cpu --synthetic_data ...    # plain twins
  python -m torch.distributed.run --nproc_per_node 4 -m fourm_torch.cli.train_4m \
      --config cfgs/default/4m/models/main/4m-xl_mod21_500b.yaml --fsdp 4 --remat ...
  python -m fourm_torch.cli.train_4m --synthetic_data --finetune 4m-21_b.safetensors \
      --save_ckpt_freq 1 --epoch_size 3200 --output_dir out/ft           # resumes if run again
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

from typing import Optional

import numpy as np
import torch


def get_parser():
    p = argparse.ArgumentParser("4M pre-training (fourm_torch)", add_help=True)
    # model
    p.add_argument("--model", default="fm_base_12e_12d_swiglu_qknorm_nobias")
    p.add_argument("--in_domains", default="tok_rgb@224-caption")
    p.add_argument("--out_domains", default="tok_rgb@224-caption")
    p.add_argument("--dim", type=int, default=None)
    p.add_argument("--encoder_depth", type=int, default=None)
    p.add_argument("--decoder_depth", type=int, default=None)
    p.add_argument("--num_heads", type=int, default=None)
    p.add_argument("--num_register_tokens", type=int, default=0)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--remat", action="store_true", help="activation checkpointing per block")
    # token budgets (reference :76-79)
    p.add_argument("--num_input_tokens", type=int, default=128)
    p.add_argument("--num_target_tokens", type=int, default=128)
    p.add_argument("--min_input_tokens", type=int, default=None)
    p.add_argument("--min_target_tokens", type=int, default=None)
    p.add_argument("--loss_type", default="mod", choices=["mod", "token"])
    # schedule (token-based step math, reference :431-470)
    p.add_argument("--total_tokens", type=float, default=1.0,
                   help="total training tokens, in billions")
    p.add_argument("--warmup_tokens", type=float, default=0.1, help="warmup tokens, in billions")
    p.add_argument("--cooldown_tokens", type=float, default=0.0)
    p.add_argument("--batch_size", type=int, default=8, help="per-card batch size")
    p.add_argument("--grad_accum_steps", type=int, default=1)
    p.add_argument("--blr", type=float, default=1e-4, help="base LR, scaled by global bs/256")
    p.add_argument("--min_lr", type=float, default=0.0)
    p.add_argument("--scheduler", default="cosine", choices=["cosine", "inverse_sqrt", "constant"])
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--clip_grad", type=float, default=1.0)
    p.add_argument("--skip_grad", type=float, default=None,
                   help="skip a step whose gradient norm exceeds this (or is not finite)")
    p.add_argument("--opt_betas", type=float, nargs=2, default=(0.9, 0.95))
    p.add_argument("--frozen_model_epochs", type=int, default=0,
                   help="initial epochs where only the embeddings train (reference :522-529)")
    p.add_argument("--layer_decay", type=float, default=None,
                   help="per-layer LR decay factor (reference optim_factory.py:62-150)")
    p.add_argument("--finetune", default=None,
                   help="warm-start weights (a released .safetensors, or a step, checkpoint "
                        "or run dir of the port or of the JAX package), loaded minus "
                        "pos-embs (reference :475-487)")
    # data
    p.add_argument("--data_config", default=None, help="YAML with train (and val) datasets")
    p.add_argument("--synthetic_data", action="store_true")
    p.add_argument("--text_tokenizer_path", default=None)
    p.add_argument("--num_workers", type=int, default=0,
                   help="data-loading worker processes (0 = inline)")
    # mesh (under torchrun; data = world / (fsdp * tensor))
    p.add_argument("--fsdp", type=int, default=1, help="fsdp axis size (sharded masters)")
    p.add_argument("--tensor", type=int, default=1, help="tensor-parallel axis size")
    # misc
    p.add_argument("--output_dir", default="out/train_4m")
    p.add_argument("--run_name", default="auto")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--print_freq", type=int, default=50)
    p.add_argument("--eval_freq", type=int, default=1, help="eval every N epochs")
    p.add_argument("--fixed_eval", action="store_true", default=True,
                   help="eval with pinned token budgets (reference :166-174)")
    p.add_argument("--fixed_eval_input_tokens", type=int, default=128)
    p.add_argument("--fixed_eval_target_tokens", type=int, default=128)
    p.add_argument("--eval_size", type=int, default=256, help="samples per eval")
    p.add_argument("--log_wandb", action="store_true")
    p.add_argument("--wandb_project", default=None)
    p.add_argument("--epoch_size", type=int, default=10_000,
                   help="samples per 'epoch' (the checkpoint cadence)")
    p.add_argument("--save_ckpt_freq", type=int, default=1, help="checkpoint every N epochs")
    p.add_argument("--auto_resume", action="store_true", default=True,
                   help="resume from the newest checkpoint of output_dir (always on, as JAX)")
    p.add_argument("--max_steps", type=int, default=None, help="hard step cap")
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain twins)")
    return p


def make_synthetic_loader(domains, batch_size, num_input_tokens, num_target_tokens, seed=0):
    from ..utils.synthetic import synthetic_mod_batch

    i = seed
    while True:
        yield synthetic_mod_batch(domains, batch_size, num_input_tokens, num_target_tokens,
                                  seed=i)
        i += 1


def rows_of(batch, index: int, count: int, accum: int = 1):
    """Rank `index` of `count`'s rows of a global batch of numpy arrays
    (fourm_tpu/cli/train_4m.py:246-249 shards the global batch the same
    way); with accum > 1 its rows of each of the accum micro-batches."""
    if count == 1:
        return batch

    def take(v):
        micro = v.reshape((accum, -1) + v.shape[1:])
        b = micro.shape[1] // count
        part = micro[:, index * b:(index + 1) * b]
        return part.reshape((-1,) + v.shape[1:])

    return {m: {k: take(v) for k, v in d.items()} for m, d in batch.items()}


def evaluate(model, val_loader, num_input_tokens: int, num_target_tokens: int, loss_type: str,
             max_samples: int, global_bs: int, device, plan=None) -> dict:
    """Held-out loss at (pinned) token budgets (fourm_tpu/cli/train_4m.py:
    156-192; reference run_training_4m.py:798-832): the model's inference
    path (train=False: no stochastic depth, the inference kernels), batches
    until max_samples, the mean loss and per-modality losses. Over a mesh
    (`plan`) each rank takes its rows of each global batch and the losses
    are the global batch's (counts and sums all-reduced)."""
    from ..utils.synthetic import to_torch

    losses, mod_losses, seen = [], {}, 0
    index, count = (0, 1) if plan is None else (plan.batch_index, plan.batch_count)
    reduce = plan.reduce_batch if count > 1 else None
    with torch.no_grad():
        for batch in val_loader:
            loss, (mod_loss, _cnt) = model(to_torch(rows_of(batch, index, count), device),
                                           num_input_tokens, num_target_tokens,
                                           loss_type=loss_type, train=False,
                                           count_reduce=reduce)
            mods = list(mod_loss)
            vals = torch.stack([loss.float()] + [mod_loss[m].float() for m in mods])
            vals = (vals if reduce is None else reduce(vals)).tolist()
            losses.append(vals[0])
            for m, v in zip(mods, vals[1:]):
                mod_losses.setdefault(m, []).append(v)
            seen += global_bs
            if seen >= max_samples:
                break
    out = {"loss": float(np.mean(losses))}
    out.update({f"loss_{m}": float(np.mean(v)) for m, v in mod_losses.items()})
    return out


def build_loaders(args, all_domains, global_bs: int, eval_in: int, eval_tgt: int,
                  shard=(0, 1)):
    """(train batch iterator, val loader factory or None): the data config's
    datasets through fourm_torch/data (inline or in --num_workers
    processes, prefetched by a thread), or synthetic batches with held-out
    seeds for the eval. shard (index, count): a rank of the batch-sharded
    group, whose loader reads its own shards and gives its global_bs /
    count rows a step (the val batches stay global: evaluate takes the
    rank's rows)."""
    from ..parallel.launch import is_main_process

    say = print if is_main_process() else (lambda *a, **k: None)
    if args.synthetic_data or args.data_config is None:
        say("[data] synthetic batches")
        from ..utils.synthetic import synthetic_mod_batch

        def val_loader_fn():
            n_batches = max(args.eval_size // global_bs, 1)
            return iter([synthetic_mod_batch(all_domains, global_bs, eval_in, eval_tgt,
                                             seed=10_000_000 + i) for i in range(n_batches)])

        return None, val_loader_fn
    import itertools

    from ..data.datasets import batched_loader, prefetch_iterator
    from ..data.pretrain_utils import build_parallel_train_loader, get_val_dataset
    from ..utils.config import load_yaml
    from ..utils.text_tokenizer import load_tokenizer

    data_cfg = load_yaml(args.data_config)
    text_tokenizer = load_tokenizer(args.text_tokenizer_path) if args.text_tokenizer_path else None
    say(f"[data] {args.data_config}: {len(data_cfg['train']['datasets'])} train dataset(s), "
        f"{args.num_workers} worker process(es) a rank", flush=True)
    loader = prefetch_iterator(build_parallel_train_loader(
        data_cfg["train"]["datasets"], all_domains, global_bs // shard[1], 224,
        args.num_input_tokens, args.num_target_tokens, args.min_input_tokens,
        args.min_target_tokens, text_tokenizer_path=args.text_tokenizer_path, seed=args.seed,
        num_workers=args.num_workers, shard=shard), prefetch=4)
    val_cfgs = (data_cfg.get("val") or {}).get("datasets", {})
    if not val_cfgs:
        return loader, None

    def val_loader_fn():
        return itertools.chain.from_iterable(
            batched_loader(iter(get_val_dataset(
                dcfg, text_tokenizer, 224, args.num_input_tokens, args.num_target_tokens,
                args.min_input_tokens, args.min_target_tokens, fixed_eval=args.fixed_eval,
                fixed_eval_input_tokens=args.fixed_eval_input_tokens,
                fixed_eval_target_tokens=args.fixed_eval_target_tokens, seed=args.seed)),
                global_bs)
            for dcfg in val_cfgs.values())

    return loader, val_loader_fn


def load_finetune_weights(path: str, model) -> None:
    """--finetune: copy released or trained weights into the model without
    their `.pos_emb` tensors (reference run_training_4m.py:475-487, which
    loads with strict=False and prints what did not match): a .safetensors;
    a step directory; a directory of step_N (the newest, as the JAX CLI
    reads an orbax one, fourm_tpu/cli/train_4m.py:121-150); or a run
    directory (its weights/). Step directories are the port's (a params
    export or a train checkpoint) or the JAX package's orbax ones (a params
    export or a TrainState). A file that fills no parameter raises."""
    from ..utils.checkpoint import (latest_checkpoint_steps, load_fourm_state_dict,
                                    load_fourm_weights, load_safetensors)
    from ..utils.orbax import is_orbax_step

    if path.endswith(".safetensors"):
        state = load_safetensors(path, return_metadata=False)
    else:
        parent, name = os.path.split(os.path.normpath(path))
        if is_orbax_step(path) or os.path.isfile(os.path.join(path, "state.pt")):
            ckpt_dir, step = parent, int(name.rsplit("_", 1)[1])
        else:
            ckpt_dir = path if latest_checkpoint_steps(path) else os.path.join(path, "weights")
            steps = latest_checkpoint_steps(ckpt_dir)
            if not steps:
                raise FileNotFoundError(f"{path}: not a .safetensors, a step directory, a "
                                        "directory of step_N or a run directory with weights/")
            step = steps[-1]
        state = load_fourm_weights(ckpt_dir, step, model.config)
    missing, unexpected = load_fourm_state_dict(model, state, drop_pos_emb=True, strict=False)
    loaded = len(state) - sum(".pos_emb" in k for k in state) - len(unexpected)
    if loaded == 0:
        raise ValueError(f"--finetune {path}: no tensor of it is a parameter of the model "
                         f"(its keys: {sorted(state)[:5]})")
    print(f"[ckpt] warm-started from {path} (pos-embs re-initialized); {len(missing)} "
          f"parameters kept their init {missing[:5]}, {len(unexpected)} checkpoint tensors "
          f"unused {unexpected[:5]}")


def train_checkpoint(state, generator, step: int) -> Optional[dict]:
    """What a resumed run needs to continue the uninterrupted one: the fp32
    masters, the AdamW state (moments, step count: the schedule's
    position), the step (and so the synthetic batch position), and the
    state of every generator (the step's, torch's CPU and CUDA ones). Over
    a mesh every rank calls it: the whole tensors are gathered onto rank 0,
    which gets the dict (the others None)."""
    if state.plan is None:
        model_state, opt_state = state.model.state_dict(), state.optimizer.state_dict()
    else:
        model_state, opt_state = state.plan.full_state(state.optimizer)
        if model_state is None:
            return None
    return {"step": step, "model": model_state,
            "optimizer": opt_state, "generator": generator.get_state(),
            "torch_rng": torch.get_rng_state(),
            "cuda_rng": torch.cuda.get_rng_state_all() if torch.cuda.is_available() else []}


def restore_checkpoint(state, generator, ckpt: dict) -> int:
    """Load train_checkpoint's dict (on the CPU) into the train state and
    generator, in place, at this run's mesh whatever the writer's; -> its
    step. A dict without generator states (from_jax_train_state's) leaves
    the generators as they are."""
    if state.plan is None:
        state.model.load_state_dict(ckpt["model"], strict=True)
        state.optimizer.load_state_dict(ckpt["optimizer"])
    else:
        missing = set(state.model.state_dict()) ^ set(ckpt["model"])
        if missing:
            raise KeyError(f"checkpoint and model differ in {sorted(missing)[:5]}")
        state.plan.load_full(ckpt["model"], state.optimizer, ckpt["optimizer"])
    if "generator" in ckpt:  # not in a JAX run's: its generators keep --seed's state
        generator.set_state(ckpt["generator"])
        torch.set_rng_state(ckpt["torch_rng"])
        if ckpt["cuda_rng"]:
            torch.cuda.set_rng_state_all(ckpt["cuda_rng"])
    state.step = int(ckpt["step"])
    return state.step


def main(args=None):
    from ..models import FourM, create_fourm_config, init_weights
    from ..parallel import build_train_step, frozen_trunk_mask, init_train_state, make_mesh
    from ..parallel.launch import (barrier, initialize_multihost, is_main_process,
                                   process_count, shutdown)
    from ..utils.checkpoint import auto_resume, from_jax_train_state, save_checkpoint
    from ..utils.config import expand_run_name, parse_args_with_config
    from ..utils.logger import JSONLLogger, MetricLogger, WandbLogger, tokens_seen
    from ..utils.orbax import is_orbax_step
    from ..utils.optim import create_optimizer, make_schedule
    from ..utils.synthetic import to_torch

    args = parse_args_with_config(get_parser(), args)
    initialize_multihost(device=args.device)
    world = process_count()
    mesh = None
    if world > 1 or args.fsdp != 1 or args.tensor != 1:
        mesh = make_mesh(data=-1, fsdp=args.fsdp, tensor=args.tensor)
    main_rank = is_main_process()
    say = print if main_rank else (lambda *a, **k: None)
    run_name = expand_run_name(args.run_name, args.config)
    output_dir = (os.path.join(args.output_dir, run_name) if run_name != "auto"
                  else args.output_dir)
    if main_rank:
        os.makedirs(output_dir, exist_ok=True)
    in_domains = sorted(args.in_domains.split("-"))
    out_domains = sorted(args.out_domains.split("-"))
    all_domains = sorted(set(in_domains) | set(out_domains))
    global_bs = args.batch_size * world * args.grad_accum_steps

    # token-budget step math (reference run_training_4m.py:431-470)
    tokens_per_step = global_bs * (args.num_input_tokens + args.num_target_tokens)
    total_steps = int(args.total_tokens * 1e9 / tokens_per_step)
    warmup_steps = int(args.warmup_tokens * 1e9 / tokens_per_step)
    cooldown_steps = int(args.cooldown_tokens * 1e9 / tokens_per_step)
    if args.max_steps:
        total_steps = min(total_steps, args.max_steps)
    steps_per_epoch = max(args.epoch_size // global_bs, 1)
    lr = args.blr * global_bs / 256.0  # reference :498
    shape = "one process" if mesh is None else dict(zip(mesh.mesh_dim_names, mesh.shape))
    say(f"device={args.device} mesh={shape} global_bs={global_bs} total_steps={total_steps} "
        f"warmup={warmup_steps} lr={lr:.2e}")

    overrides = {k: getattr(args, k) for k in ("dim", "encoder_depth", "decoder_depth",
                                               "num_heads") if getattr(args, k) is not None}
    config = create_fourm_config(args.model, tuple(in_domains), tuple(out_domains),
                                 dtype=args.dtype, num_register_tokens=args.num_register_tokens,
                                 remat=args.remat, **overrides)
    if main_rank:
        with open(os.path.join(output_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(config), f, indent=1)
    model = init_weights(FourM(config), args.seed)  # alike on every rank: one seed
    if args.finetune:
        load_finetune_weights(args.finetune, model)
    sched = make_schedule(args.scheduler, lr, total_steps, warmup_steps, min_lr=args.min_lr,
                          cooldown_steps=cooldown_steps)
    tx = create_optimizer(model, sched, weight_decay=args.weight_decay,
                          betas=tuple(args.opt_betas), clip_grad=args.clip_grad,
                          skip_grad=args.skip_grad, layer_decay=args.layer_decay)
    state = init_train_state(model, tx, device=args.device, mesh=mesh)
    device = model.mask_token.device
    shard = (0, 1) if state.plan is None else (state.plan.batch_index, state.plan.batch_count)
    step_kw = dict(loss_type=args.loss_type, grad_accum_steps=args.grad_accum_steps, mesh=mesh)
    step_fn = build_train_step(model, tx, args.num_input_tokens, args.num_target_tokens,
                               **step_kw)
    # the frozen-trunk warm-start phase (reference :522-529, fm.py:762): a
    # second step whose gradients and updates are masked to the embeddings
    frozen_steps = args.frozen_model_epochs * steps_per_epoch
    frozen_step_fn = None
    if frozen_steps > 0:
        frozen_step_fn = build_train_step(model, tx, args.num_input_tokens,
                                          args.num_target_tokens, **step_kw,
                                          trainable_mask=frozen_trunk_mask(model))
        say(f"[train] frozen-trunk phase for the first {frozen_steps} steps")
    jsonl = JSONLLogger(output_dir) if main_rank else None
    metric_logger = MetricLogger()
    wandb_logger = WandbLogger(project=args.wandb_project if args.log_wandb and main_rank
                               else None, name=run_name, config=vars(args))
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)  # shared by the ranks
    ckpt_dir = os.path.join(output_dir, "checkpoints")
    start_step = 0
    if args.auto_resume:
        barrier()  # rank 0 made the output directory
        ckpt, step = auto_resume(ckpt_dir, map_location="cpu")
        if ckpt is not None:
            jax_run = is_orbax_step(os.path.join(ckpt_dir, f"step_{step}"))
            if jax_run:  # the JAX package's TrainState (orbax)
                ckpt = from_jax_train_state(ckpt, config)
            start_step = restore_checkpoint(state, generator, ckpt)
            say(f"[ckpt] resumed from step {start_step}" + (
                " of a JAX run (fp32 masters, AdamW moments and count); its RNG state is not "
                "carried over: the generators restart from --seed at this step" if jax_run
                else ""))
            del ckpt
    eval_in = args.fixed_eval_input_tokens if args.fixed_eval else args.num_input_tokens
    eval_tgt = args.fixed_eval_target_tokens if args.fixed_eval else args.num_target_tokens
    loader, val_loader_fn = build_loaders(args, all_domains, global_bs, eval_in, eval_tgt,
                                          shard)
    synthetic = loader is None
    if synthetic:
        loader = make_synthetic_loader(all_domains, global_bs, args.num_input_tokens,
                                       args.num_target_tokens, args.seed + start_step)

    t0 = time.time()
    for step in range(start_step, total_steps):
        batch_np = next(loader)
        if synthetic:  # the global batch: this rank's rows
            batch_np = rows_of(batch_np, *shard, accum=args.grad_accum_steps)
        batch = to_torch(batch_np, device)
        if args.grad_accum_steps > 1:
            batch = {m: {k: v.reshape((args.grad_accum_steps, -1) + v.shape[1:])
                         for k, v in d.items()} for m, d in batch.items()}
        fn = frozen_step_fn if (frozen_step_fn is not None and step < frozen_steps) else step_fn
        state, metrics = fn(state, batch, generator)

        if step % args.print_freq == 0 or step == total_steps - 1:
            loss = float(metrics["loss"])  # a host read: waits for the step
            if not math.isfinite(loss):  # the global loss: every rank stops
                # NaN tripwire: dump the batch and abort (reference :729-732)
                dump = os.path.join(output_dir, f"nan_batch_step{step}_rank{shard[0]}.npz")
                np.savez(dump, **{f"{m}_{k}": v for m, d in batch_np.items()
                                  for k, v in d.items()})
                print(f"FATAL: non-finite loss {loss} at step {step}; batch dumped to {dump}")
                sys.exit(1)
            sps = global_bs * args.print_freq / max(time.time() - t0, 1e-6)
            t0 = time.time()
            gnorm = float(metrics["grad_norm"])
            metric_logger.update(loss=loss, grad_norm=gnorm)
            tokens_b = tokens_seen(step + 1, global_bs, args.num_input_tokens,
                                   args.num_target_tokens)
            say(f"step {step}/{total_steps} loss {loss:.4f} gnorm {gnorm:.2f} "
                f"samples/s {sps:.1f} tokens {tokens_b:.3f}B", flush=True)
            if main_rank:
                stats = {"step": step, "loss": loss, "grad_norm": gnorm,
                         "samples_per_sec": sps, "tokens_B": tokens_b}
                jsonl.write(stats)
                wandb_logger.log(stats, step=step)

        if (step + 1) % (steps_per_epoch * args.save_ckpt_freq) == 0 or step == total_steps - 1:
            ckpt = train_checkpoint(state, generator, step + 1)  # every rank: a gather
            if main_rank:
                save_checkpoint(ckpt_dir, ckpt, step + 1)
                # params-only export for generation (read by cli/generate.py:load_fm)
                save_checkpoint(os.path.join(output_dir, "weights"), ckpt["model"], step + 1)
                print(f"[ckpt] saved step {step + 1}", flush=True)
            del ckpt
            barrier()  # the others wait for rank 0's files

        if val_loader_fn is not None and (
                (step + 1) % (steps_per_epoch * args.eval_freq) == 0 or step == total_steps - 1):
            t_eval = time.time()
            stats = evaluate(model, val_loader_fn(), eval_in, eval_tgt, args.loss_type,
                             args.eval_size, global_bs, device, state.plan)
            stats["seconds"] = time.time() - t_eval
            say(f"[eval] step {step + 1}: {stats}", flush=True)
            if main_rank:
                jsonl.write({"step": step + 1, **{f"eval_{k}": v for k, v in stats.items()}})
                wandb_logger.log({f"eval_{k}": v for k, v in stats.items()}, step=step + 1)
            t0 += time.time() - t_eval
    wandb_logger.finish()
    if hasattr(loader, "close"):
        loader.close()  # stops the prefetch thread and the data workers
    say("training done")
    if world > 1:
        shutdown()
    return state


if __name__ == "__main__":
    main()
