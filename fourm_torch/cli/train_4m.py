"""4M pre-training on one card: the port of fourm_tpu/cli/train_4m.py for the
options this slice serves.

Carried over: the model registry and overrides, token budgets and loss type,
the token-budget step math (reference run_training_4m.py:431-470), LR x
bs/256 (:498), the three schedules, AdamW with the 4M decay rules and the
global-norm clip, gradient accumulation, the NaN tripwire with a batch dump
(:729-732), per-step print lines, `config.json` and a JSONL log with
tokens-seen accounting. Synthetic batches only. Not ported yet (ROADMAP):
checkpoints and auto-resume, eval, --finetune, the frozen-trunk phase,
layer decay, skip-grad, remat, the data pipeline, FSDP / tensor parallel.

Usage:
  python -m fourm_torch.cli.train_4m --synthetic_data --max_steps 100   # on the card
  python -m fourm_torch.cli.train_4m --device cpu --synthetic_data ...  # plain twins
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch


def get_parser():
    p = argparse.ArgumentParser("4M pre-training (fourm_torch, one card)", add_help=True)
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
    # token budgets (reference :76-79)
    p.add_argument("--num_input_tokens", type=int, default=128)
    p.add_argument("--num_target_tokens", type=int, default=128)
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
    p.add_argument("--opt_betas", type=float, nargs=2, default=(0.9, 0.95))
    # data
    p.add_argument("--synthetic_data", action="store_true",
                   help="synthetic batches (the only data this port reads yet)")
    # misc
    p.add_argument("--output_dir", default="out/train_4m")
    p.add_argument("--run_name", default="auto")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--print_freq", type=int, default=50)
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


def main(args=None):
    from ..models import FourM, create_fourm_config, init_weights
    from ..parallel import build_train_step, init_train_state
    from ..utils.logger import JSONLLogger, tokens_seen
    from ..utils.optim import create_optimizer, make_schedule
    from ..utils.synthetic import to_torch

    args = get_parser().parse_args(args)
    output_dir = (os.path.join(args.output_dir, args.run_name) if args.run_name != "auto"
                  else args.output_dir)
    os.makedirs(output_dir, exist_ok=True)
    in_domains = sorted(args.in_domains.split("-"))
    out_domains = sorted(args.out_domains.split("-"))
    all_domains = sorted(set(in_domains) | set(out_domains))
    global_bs = args.batch_size * args.grad_accum_steps

    # token-budget step math (reference run_training_4m.py:431-470)
    tokens_per_step = global_bs * (args.num_input_tokens + args.num_target_tokens)
    total_steps = int(args.total_tokens * 1e9 / tokens_per_step)
    warmup_steps = int(args.warmup_tokens * 1e9 / tokens_per_step)
    cooldown_steps = int(args.cooldown_tokens * 1e9 / tokens_per_step)
    if args.max_steps:
        total_steps = min(total_steps, args.max_steps)
    lr = args.blr * global_bs / 256.0  # reference :498
    print(f"device={args.device} global_bs={global_bs} total_steps={total_steps} "
          f"warmup={warmup_steps} lr={lr:.2e}")

    overrides = {k: getattr(args, k) for k in ("dim", "encoder_depth", "decoder_depth",
                                               "num_heads") if getattr(args, k) is not None}
    config = create_fourm_config(args.model, tuple(in_domains), tuple(out_domains),
                                 dtype=args.dtype, num_register_tokens=args.num_register_tokens,
                                 **overrides)
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(config), f, indent=1)
    print("[data] synthetic batches")
    loader = make_synthetic_loader(all_domains, global_bs, args.num_input_tokens,
                                   args.num_target_tokens, args.seed)

    model = init_weights(FourM(config), args.seed)
    sched = make_schedule(args.scheduler, lr, total_steps, warmup_steps, min_lr=args.min_lr,
                          cooldown_steps=cooldown_steps)
    tx = create_optimizer(model, sched, weight_decay=args.weight_decay,
                          betas=tuple(args.opt_betas), clip_grad=args.clip_grad)
    state = init_train_state(model, tx, device=args.device)
    device = model.mask_token.device
    step_fn = build_train_step(model, tx, args.num_input_tokens, args.num_target_tokens,
                               loss_type=args.loss_type, grad_accum_steps=args.grad_accum_steps)
    jsonl = JSONLLogger(output_dir)
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)

    t0 = time.time()
    for step in range(total_steps):
        batch_np = next(loader)
        batch = to_torch(batch_np, device)
        if args.grad_accum_steps > 1:
            batch = {m: {k: v.reshape((args.grad_accum_steps, -1) + v.shape[1:])
                         for k, v in d.items()} for m, d in batch.items()}
        state, metrics = step_fn(state, batch, generator)

        if step % args.print_freq == 0 or step == total_steps - 1:
            loss = float(metrics["loss"])  # a host read: waits for the step
            if not math.isfinite(loss):
                # NaN tripwire: dump the batch and abort (reference :729-732)
                dump = os.path.join(output_dir, f"nan_batch_step{step}.npz")
                np.savez(dump, **{f"{m}_{k}": v for m, d in batch_np.items()
                                  for k, v in d.items()})
                print(f"FATAL: non-finite loss {loss} at step {step}; batch dumped to {dump}")
                sys.exit(1)
            sps = global_bs * args.print_freq / max(time.time() - t0, 1e-6)
            t0 = time.time()
            gnorm = float(metrics["grad_norm"])
            tokens_b = tokens_seen(step + 1, global_bs, args.num_input_tokens,
                                   args.num_target_tokens)
            print(f"step {step}/{total_steps} loss {loss:.4f} gnorm {gnorm:.2f} "
                  f"samples/s {sps:.1f} tokens {tokens_b:.3f}B", flush=True)
            jsonl.write({"step": step, "loss": loss, "grad_norm": gnorm,
                         "samples_per_sec": sps, "tokens_B": tokens_b})
    print("training done")
    return state


if __name__ == "__main__":
    main()
