"""Training and serving over four H100s of one host: the port's mesh paths
(fourm_torch/parallel) at the widths of the 4M-21 configurations.

Run under torchrun, one process a card, on four cards of one host:

  python3 -m torch.distributed.run --nproc_per_node 4 scripts/chip_multicard.py \\
      [--json_out FILE]

A single process (`--nproc_per_node 1`, or no torchrun) starts a world-1
group itself: the parts then run at world 1 (M2 its parity run alone), a
rehearsal of the code on one card. Rank 0 prints `nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader` for every card, then one JSON
line a part (all of them to --json_out as well). Each part gates; a failed
gate raises and the script exits non-zero after printing the part's line.
Weights are random, from seed 0 on every rank; batches synthetic
(utils/synthetic.py: the 4M-21 modality set), the global batch made on every
rank and each rank taking its rows.

  M1  data parallel at 4M-21 B
      (cfgs/default/4m/models/main/4m-b_mod21_500b.yaml:
      fm_base_12e_12d_swiglu_nobias, 64 a card, 256 + 256 tokens, lr = 1e-4 x
      256 / 256, the clip at 1.0): DP=4 over a global batch of 256 whose
      ranks hold different per-modality target counts (uneven: each rank's
      rows lack the targets of another modality), against rank 0 alone
      stepping the same global batch (one_card_step: its 4 micro-batches of
      64, each modality's loss over the global count). Gates over 3 steps:
      losses and gradient norms within 1e-3 relative, and the masters
      (close_masters). Reports samples/s at 4 cards and at 1 card (the port's
      step accumulating the 4 micro-batches), their ratio, peak memory a
      card, launches a rank a step.
  M2  FSDP at 4M-21 XL (4m-xl_mod21_500b.yaml: fm_xlarge_24e_24d_swiglu_nobias
      at full width and depth, 32 a card, 256 + 256), born sharded (built
      under meta_params, each rank drawing its chunks): a few steps at
      fsdp 4 with activation checkpointing per block, then without it if
      it fits (its peak a card predicted first from one step each at depth
      4 + 4 and 8 + 8, linear in depth; run only below 88% of the card).
      Reports peak memory a card, each rank's bytes of parameters (those
      held between steps), masters and moments, samples/s, launches a rank
      a step; gates every rank's loss equal and finite. Parity at full
      width, depth 2 + 2: fsdp 4 against rank 0 alone on the same uneven
      global batch of 128 (one_card_step, 4 micro-batches of 32), gated as
      M1.
  M3  tensor parallel at 4M-21 XL (fm_xlarge_24e_24d_swiglu_qknorm_nobias,
      32 heads, 8 a rank; bf16 weights): forward_generation_img of a
      tok_depth@224 target from rgb@224, caption and tok_clip@224 inputs at
      B = 8, tensor 4 against tensor 1 on rank 0 and an fp32 run of the same
      weights on rank 0: chip_smoke.py's gate (logits within twice the
      plain bf16 error of fp32 plus 1e-3, argmax agreement >= 0.99 where the
      fp32 top-2 margin exceeds twice that). Reports ms a forward at 4 and
      at 1, launches a rank, each rank's parameter bytes.
  M4  data-parallel tokenizer training: T3 of phase 13
      (cfgs/default/tokenization/vqvae/semseg_coco/ViTB-ViTB_4k_224.yaml, 64
      a card, synthetic class maps), 4 steps through cli.train_vqvae's
      Trainer over the world's group. Gate: every rank's codebook (embed,
      cluster_size) bit for bit equal after every step. Reports samples/s
      and launches a rank a step.

  M5  the two meshes that combine fsdp with another axis, at XL width,
      depth 2 + 2, born sharded, each a parity run gated as M2's on an
      uneven global batch of 32 a batch rank: M5a data 2 x fsdp 2, M5b
      fsdp 2 x tensor 2 (the combined rule: the fsdp dim skips the tensor
      one; the ranks of a tensor group share their rows).

`--device cpu --tiny` rehearses every part on the CPU under gloo at narrow
widths (launch counts stay 0 there).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

B_MODEL, XL_MODEL, XL_QK = ("fm_base_12e_12d_swiglu_nobias", "fm_xlarge_24e_24d_swiglu_nobias",
                            "fm_xlarge_24e_24d_swiglu_qknorm_nobias")
T3_CONFIG = "cfgs/default/tokenization/vqvae/semseg_coco/ViTB-ViTB_4k_224.yaml"  # in ROOT
TOKENS = 256
STEPS = 3  # parity steps


class Ctx:
    def __init__(self, args):
        from fourm_torch.parallel.launch import process_count, process_index

        self.args = args
        self.rank, self.world = process_index(), process_count()
        self.device = torch.device(args.device if args.device == "cpu" else
                                   f"cuda:{torch.cuda.current_device()}")
        self.cuda = self.device.type == "cuda"
        self.card = ""

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def say(self, *a):
        if self.rank == 0:
            print(*a, flush=True)

    def gather(self, obj):
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def peak_reset(self):
        if self.cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak(self):
        return self.gather(torch.cuda.max_memory_allocated() if self.cuda else 0)


FAILED = []  # the gates a part missed: printed with its line, then the script fails


def check(cond: bool, what: str) -> None:
    if not cond:
        print(f"chip_multicard: FAILED: {what}", flush=True)
        FAILED.append(what)


def tiny(ctx) -> dict:
    """Narrow overrides of a model for the CPU rehearsal (--tiny)."""
    if not ctx.args.tiny:
        return {}
    heads = max(2, ctx.world)
    return dict(dim=32 * heads, encoder_depth=2, decoder_depth=2, num_heads=heads)


def build(ctx, name: str, dtype="bfloat16", params_dtype=None, meta=False, **over):
    """The model with seed-0 weights on the rank's card; `meta`: its
    parameters on the meta device, for init_train_state(..., seed=0) to
    draw the rank's chunks (born sharded)."""
    from fourm_torch.models import FourM, create_fourm_config, init_weights
    from fourm_torch.parallel import meta_params
    from fourm_torch.utils.synthetic import MOD21_DECODER_MODALITIES, MOD21_MODALITIES

    cfg = create_fourm_config(name, MOD21_MODALITIES, MOD21_DECODER_MODALITIES, dtype=dtype,
                              **{**tiny(ctx), **over})
    if meta:
        with meta_params():
            return FourM(cfg)
    with torch.device(ctx.device):
        model = FourM(cfg)
    model = model.to(device=ctx.device, dtype=params_dtype)  # the tables made on the host too
    return init_weights(model, 0)


def global_batch(ctx, n: int, seed: int = 0):
    from fourm_torch.utils.synthetic import MOD21_MODALITIES, synthetic_mod_batch

    return synthetic_mod_batch(MOD21_MODALITIES, n, TOKENS, TOKENS, seed=seed)


def uneven(batch, world: int):
    """The global batch with different per-modality target counts on each
    rank: rank r's rows lose the targets of the modality with the r-th most
    of them, so that a step which averaged the ranks' losses (each over its
    own counts) would not give the global batch's."""
    if world == 1:
        return batch
    counts = {m: int((~d["target_mask"]).sum()) for m, d in batch.items()}
    ranked = sorted((m for m in counts if counts[m]), key=lambda m: -counts[m])
    per = len(batch[ranked[0]]["target_mask"]) // world
    for r in range(world):
        batch[ranked[r % len(ranked)]]["target_mask"][r * per:(r + 1) * per] = True
    return batch


def local_rows(ctx, batch, plan):
    """This rank's rows of a global numpy batch, on its device."""
    from fourm_torch.cli.train_4m import rows_of
    from fourm_torch.utils.synthetic import to_torch

    return to_torch(rows_of(batch, plan.batch_index, plan.batch_count), ctx.device)


def masters_cpu(model):
    """Copies of the parameters, fp32, on the CPU."""
    return {n: p.detach().to("cpu", torch.float32, copy=True) for n, p in model.named_parameters()}


def close_masters(got, ref, init, lr: float, steps: int, label: str) -> dict:
    """The masters after the steps (`init` before them): every one within 2
    lr x steps, Adam's bound (its first steps move an entry by about lr
    whatever its gradient's size, so a gradient within rounding of zero may
    move it either way); and of the entries the reference moved by more
    than 1% of lr x steps, at most 10% differ by more than that. The ranks'
    fp32 gradients are summed in another order than one card's: on four
    H100s 1.92% of M1's 409,666,148 moved entries differed by more
    (PERF.md). A step that lost a rank's gradient moves far more of them
    (23% at world 2 on the CPU); a doubled or averaged share moves few, and
    close_moments and the grad-norm gate catch it."""
    near = 0.01 * lr * steps
    worst, far, moved, moved_far = 0.0, 0, 0, 0
    for n, t in ref.items():
        diff = (got[n] - t).abs()
        worst = max(worst, float(diff.max()))
        far += int(diff.gt(near).sum())
        m = (t - init[n]).abs().gt(near)
        moved += int(m.sum())
        moved_far += int((diff.gt(near) & m).sum())
    total = sum(t.numel() for t in ref.values())
    share = moved_far / max(moved, 1)
    check(worst <= 2 * lr * steps + 1e-7 and share <= 0.1,
          f"{label}: masters max diff {worst}; {moved_far} of the {moved} moved entries "
          f"beyond {near}")
    return {"masters_max_abs_diff": worst, "masters_beyond_1pct_lr_steps": far,
            "masters": total, "masters_moved": moved,
            "moved_masters_beyond_1pct_lr_steps": moved_far, "moved_share_beyond": share}


def close_moments(got: dict, tx, label: str) -> dict:
    """Both AdamW moments of the mesh (whole, `got`: full_state's) against
    one card's (`tx`'s), as relative L2 differences; the first moment, a sum
    of the steps' gradients, within 5e-2. Unlike the masters it is not
    normalised: a gradient that lost, doubled or averaged a rank's share
    moves it by a third or more."""
    out = {}
    for k in ("mu", "nu"):
        ref = getattr(tx, k)
        num = sum(float((got[k][n] - t.cpu()).double().square().sum()) for n, t in ref.items())
        den = sum(float(t.double().square().sum()) for t in ref.values())
        out[f"{k}_rel_l2_diff"] = (num / max(den, 1e-300)) ** 0.5
    check(out["mu_rel_l2_diff"] <= 5e-2,
          f"{label}: first moment {out['mu_rel_l2_diff']} from one card's (relative L2)")
    return out


def one_card_step(model, tx, micro) -> dict:
    """The reference step of the global batch on one card, written out:
    each micro-batch (a rank's rows) divides each modality's summed loss by
    the modality's count over all the micro-batches (counted by a first,
    gradient-free pass), the gradients of the micro-batches add up to the
    global batch's, then the norm, the clip and one optimizer step.
    -> {"loss", "grad_norm"}."""
    seen = []
    with torch.no_grad():
        for mb in micro:
            model(mb, TOKENS, TOKENS, count_reduce=lambda c: seen.append(c) or c)
    total = torch.stack(seen).sum(0)
    for p in model.parameters():
        p.grad = None
    loss = 0.0
    for mb in micro:
        part, _ = model(mb, TOKENS, TOKENS, count_reduce=lambda c: total)
        part.backward()
        loss = loss + part.detach()
    norm = torch.stack([torch.linalg.vector_norm(p.grad, dtype=torch.float64)
                        for p in model.parameters() if p.grad is not None]).norm().float()
    tx.step(norm)
    return {"loss": float(loss), "grad_norm": float(norm)}


def close_metrics(got, ref, label: str) -> dict:
    """Losses and gradient norms (one each a step) within 1e-3 relative."""
    out = {}
    for k in ("loss", "grad_norm"):
        g, r = [m[k] for m in got], [m[k] for m in ref]
        rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(g, r))
        check(all(np.isfinite(g)) and rel <= 1e-3, f"{label}: {k} {g} vs one card {r}")
        out[f"{k}_max_rel_diff"] = rel
    return out


def timed_steps(ctx, step, state, batch, n: int, gen=None):
    """n steps after ctx.sync + barrier -> (state, seconds a step, [{"loss",
    "grad_norm"}] a step)."""
    ctx.sync()
    dist.barrier()
    t0 = time.perf_counter()
    metrics = []
    for _ in range(n):
        state, m = step(state, batch, gen)
        metrics.append((m["loss"], m["grad_norm"]))
    ctx.sync()
    dist.barrier()
    return state, (time.perf_counter() - t0) / n, [
        {"loss": float(a), "grad_norm": float(b)} for a, b in metrics]


def counts():
    from fourm_torch import kernels

    return {k: v for k, v in kernels.launch_counts().items() if v}


def reset_counts():
    from fourm_torch import kernels

    kernels.reset_launch_counts()


# ------------------------------------------------------------------ parts

def train_parity(ctx, name: str, per_card: int, over: dict, lr: float, label: str,
                 mesh_kw: dict, timing_steps: int = 0):
    """STEPS mesh steps (make_mesh(**mesh_kw); born sharded at fsdp > 1)
    from seed-0 weights on an uneven global batch of per_card rows a batch
    rank, and the same global batch on rank 0 alone (one_card_step over the
    batch ranks' rows in turn). timing_steps: samples/s of both, one card's
    by the port's step accumulating the micro-batches. -> the report."""
    from fourm_torch.parallel import build_train_step, init_train_state, make_mesh
    from fourm_torch.utils.optim import constant_schedule, create_optimizer
    from fourm_torch.utils.synthetic import to_torch

    mesh = make_mesh(**mesh_kw)
    sharded = int(mesh["fsdp"].size()) > 1
    count = ctx.world // int(mesh["tensor"].size())  # the batch ranks
    n = per_card * count
    batch = uneven(global_batch(ctx, n), count)
    ctx.peak_reset()
    model = build(ctx, name, meta=sharded, **over)
    tx = create_optimizer(model, constant_schedule(lr), weight_decay=0.05, betas=(0.9, 0.95),
                          clip_grad=1.0)
    state = init_train_state(model, tx, device=str(ctx.device), mesh=mesh,
                             seed=0 if sharded else None)
    plan = state.plan
    step = build_train_step(model, tx, TOKENS, TOKENS, mesh=mesh)
    local = local_rows(ctx, batch, plan)
    reset_counts()
    state, _, mets = timed_steps(ctx, step, state, local, STEPS)
    launches = counts()
    losses = [m["loss"] for m in mets]
    out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "global_batch": n,
           "losses": losses, "grad_norms": [m["grad_norm"] for m in mets],
           "launches_per_rank_per_step":
           {k: v / STEPS for k, v in launches.items()},
           "rank_losses_equal": len(set(map(tuple, ctx.gather(losses)))) == 1,
           "plan_bytes_per_rank": ctx.gather(plan.param_bytes())}
    check(out["rank_losses_equal"], f"{label}: ranks' losses differ")
    mine, moments = plan.full_state(tx)  # whole masters, mu and nu on rank 0 (all gather)
    if timing_steps:
        state, sec, _ = timed_steps(ctx, step, state, local, timing_steps)
        out["samples_per_s"] = n / sec
        out["ms_per_step"] = sec * 1e3
    out["peak_memory_bytes_per_card"] = ctx.peak()
    del state, step, tx, model, plan, local
    if ctx.rank == 0:  # the reference on one card, alone
        ctx.peak_reset()
        model = build(ctx, name, **over)
        tx = create_optimizer(model, constant_schedule(lr), weight_decay=0.05,
                              betas=(0.9, 0.95), clip_grad=1.0)
        state = init_train_state(model, tx, device=str(ctx.device))
        init = masters_cpu(model)
        ref = to_torch(batch, ctx.device)
        micro = [{m: {k: v[i * per_card:(i + 1) * per_card] for k, v in d.items()}
                  for m, d in ref.items()} for i in range(count)]
        ref_mets = [one_card_step(model, tx, micro) for _ in range(STEPS)]
        out["one_card_losses"] = [m["loss"] for m in ref_mets]
        out["one_card_grad_norms"] = [m["grad_norm"] for m in ref_mets]
        out.update(close_metrics(mets, ref_mets, label))
        out.update(close_masters(mine, masters_cpu(model), init, lr, STEPS, label))
        out.update(close_moments(moments, tx, label))
        del mine, init, micro, state, tx, model, moments
        if timing_steps:
            ctx.peak_reset()
            model = build(ctx, name, **over)
            tx = create_optimizer(model, constant_schedule(lr), weight_decay=0.05,
                                  betas=(0.9, 0.95), clip_grad=1.0)
            state = init_train_state(model, tx, device=str(ctx.device))
            step = build_train_step(model, tx, TOKENS, TOKENS, grad_accum_steps=count)
            if count > 1:
                ref = {m: {k: v.reshape((count, -1) + v.shape[1:]) for k, v in d.items()}
                       for m, d in ref.items()}
            state, _ = step(state, ref)  # warm-up
            ctx.sync()
            t0 = time.perf_counter()
            for _ in range(timing_steps):
                state, m = step(state, ref)
            ctx.sync()
            out["one_card_samples_per_s"] = n / ((time.perf_counter() - t0) / timing_steps)
            out["one_card_peak_memory_bytes"] = (torch.cuda.max_memory_allocated()
                                                 if ctx.cuda else 0)
            del state, step, tx, model
        del ref
    if ctx.cuda:
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def part_m1(ctx):
    per_card = 64 if not ctx.args.tiny else 2
    lr = 1e-4 * per_card * ctx.world / 256
    out = train_parity(ctx, B_MODEL, per_card, {}, lr, "M1", dict(data=ctx.world),
                       timing_steps=ctx.args.timing_steps)
    if "samples_per_s" in out and "one_card_samples_per_s" in out:
        out["scaling"] = out["samples_per_s"] / out["one_card_samples_per_s"]
    return dict(out, model=B_MODEL, per_card=per_card, tokens=[TOKENS, TOKENS], lr=lr)


def m2_run(ctx, remat: bool, depth: dict, timing_steps: int, lr: float, batch) -> dict:
    """Steps of M2's XL at fsdp = world, born sharded: one, then
    timing_steps timed. -> its report."""
    from fourm_torch.parallel import build_train_step, init_train_state, make_mesh
    from fourm_torch.utils.optim import constant_schedule, create_optimizer

    n = len(next(iter(batch.values()))["tensor"])
    mesh = make_mesh(fsdp=ctx.world)
    ctx.peak_reset()
    t0 = time.perf_counter()
    model = build(ctx, XL_MODEL, meta=True, remat=remat, **depth)
    tx = create_optimizer(model, constant_schedule(lr), weight_decay=0.05, betas=(0.9, 0.95),
                          clip_grad=1.0)
    state = init_train_state(model, tx, device=str(ctx.device), mesh=mesh, seed=0)
    ctx.sync()
    init_s = time.perf_counter() - t0
    init_peak = ctx.peak()
    params = sum(l.param.numel() for l in state.plan.leaves)
    step = build_train_step(model, tx, TOKENS, TOKENS, mesh=mesh)
    local = local_rows(ctx, batch, state.plan)
    reset_counts()
    state, first_s, mets = timed_steps(ctx, step, state, local, 1)
    launches = counts()
    more = []
    if timing_steps:
        state, sec, more = timed_steps(ctx, step, state, local, timing_steps)
    losses = [m["loss"] for m in mets + more]
    gathered = ctx.gather(losses)
    check(all(g == losses for g in gathered) and all(np.isfinite(losses)),
          f"M2: ranks' losses differ or are not finite: {gathered}")
    out = {"model": XL_MODEL, "parameters": params, "global_batch": n, "remat": remat,
           "depth": depth or "full", "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "init_s": init_s, "init_peak_memory_bytes_per_card": init_peak,
           "first_step_s": first_s, "losses": losses, "rank_losses_equal": True,
           "launches_per_rank_per_step": launches,
           "plan_bytes_per_rank": ctx.gather(state.plan.param_bytes()),
           "peak_whole_units_per_rank": ctx.gather(state.plan.peak_whole),
           "peak_memory_bytes_per_card": ctx.peak()}
    if timing_steps:
        out.update(ms_per_step=sec * 1e3, samples_per_s=n / sec)
    del state, step, tx, model, local
    if ctx.cuda:
        torch.cuda.empty_cache()
    return out


def part_m2(ctx):
    per_card = 32 if not ctx.args.tiny else 2
    n = per_card * ctx.world
    lr = 1e-4 * n / 256
    depth = {} if ctx.args.tiny else dict(encoder_depth=2, decoder_depth=2)
    if ctx.world == 1:  # the whole XL state does not fit one card: the parity run alone
        return {"parity_2_2": train_parity(ctx, XL_MODEL, per_card, depth, lr, "M2 parity",
                                           dict(fsdp=1))}
    batch = global_batch(ctx, n, seed=1)
    full = {"per_card": per_card,
            "remat": m2_run(ctx, True, {}, ctx.args.timing_steps, lr, batch)}
    ctx.say(json.dumps({"part": "M2 full depth, remat", **full["remat"]}))
    fits, predicted = True, None
    if ctx.cuda and not ctx.args.tiny:  # without remat: predicted from depths 4 and 8 first
        p4, p8 = (max(m2_run(ctx, False, dict(encoder_depth=d, decoder_depth=d), 0, lr,
                             batch)["peak_memory_bytes_per_card"]) for d in (4, 8))
        predicted = p4 + (p8 - p4) * (24 - 4) / 4
        fits = predicted <= 0.88 * torch.cuda.get_device_properties(ctx.device).total_memory
        full["no_remat_probe"] = {"peak_depth_4": p4, "peak_depth_8": p8,
                                  "predicted_peak_depth_24": predicted, "fits": fits}
        ctx.say(json.dumps({"part": "M2 no remat, predicted", **full["no_remat_probe"]}))
    if fits:
        full["no_remat"] = m2_run(ctx, False, {}, ctx.args.timing_steps, lr, batch)
        ctx.say(json.dumps({"part": "M2 full depth, no remat", **full["no_remat"]}))
    parity = train_parity(ctx, XL_MODEL, per_card, depth, lr, "M2 parity",
                          dict(fsdp=ctx.world))
    return {"full_depth": full, "parity_2_2": parity}


def part_m5(ctx):
    """M5a data x fsdp 2, M5b fsdp 2 x tensor 2 (at world 2: fsdp 2, and
    tensor 2 alone), parity runs at XL width, depth 2 + 2."""
    if ctx.world % 2:
        return {"skipped": f"world {ctx.world}: the meshes need an even one"}
    per_card = 32 if not ctx.args.tiny else 2
    depth = {} if ctx.args.tiny else dict(encoder_depth=2, decoder_depth=2)
    out = {}
    for label, mesh_kw in (("M5a", dict(data=ctx.world // 2, fsdp=2)),
                           ("M5b", dict(data=1, fsdp=ctx.world // 2, tensor=2))):
        lr = 1e-4 * per_card * (ctx.world // mesh_kw.get("tensor", 1)) / 256
        out[label] = dict(train_parity(ctx, XL_MODEL, per_card, depth, lr, label, mesh_kw),
                          lr=lr, per_card=per_card)
        ctx.say(json.dumps({"part": label, **out[label]}))
    return out


def gate_logits(gpu, ref, ref_bf16, label: str) -> dict:
    """chip_smoke.py's gate: gpu within 2 x (plain bf16's error) + 1e-3 of
    the fp32 logits; argmax agreement >= 0.99 where fp32's top-2 margin
    exceeds twice that."""
    err = (gpu - ref).abs().max().item()
    err_plain = (ref_bf16 - ref).abs().max().item()
    tol = 2.0 * err_plain + 1e-3
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * tol
    n_dec = int(decided.sum())
    agree = ((gpu.argmax(-1) == ref.argmax(-1))[decided].float().mean().item()
             if n_dec else 1.0)
    check(bool(torch.isfinite(gpu).all()), f"{label}: non-finite logits")
    check(err <= tol, f"{label}: logits error {err} > {tol}")
    check(agree >= 0.99, f"{label}: argmax agreement {agree} on decided positions")
    return {"logits_max_abs_err_vs_fp32": err, "tol": tol, "plain_bf16_err": err_plain,
            "argmax_agreement_decided": agree, "decided_positions": n_dec,
            "positions": decided.numel(),
            "argmax_agreement_all_vs_tensor1": (gpu.argmax(-1) == ref_bf16.argmax(-1))
            .float().mean().item()}


def part_m3(ctx):
    from fourm_torch.ops.tensor_parallel import TensorGroup
    from fourm_torch.parallel import make_mesh
    from fourm_torch.parallel.shard import shard_tensor_parallel
    from fourm_torch.utils.synthetic import to_torch

    B = 8 if not ctx.args.tiny else 2
    mesh = make_mesh(data=1, tensor=ctx.world)
    batch = global_batch(ctx, B, seed=2)
    target = "tok_depth@224"
    md = {m: batch[m] for m in ("rgb@224", "caption", "tok_clip@224", target)}
    md = to_torch(md, ctx.device)
    md["tok_clip@224"]["input_mask"][:] = False
    sa = torch.from_numpy(np.random.RandomState(4).rand(B, 196) > 0.3).to(ctx.device)
    model = build(ctx, XL_QK, params_dtype=torch.bfloat16).eval()
    full_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    state0 = {k: v.detach().cpu() for k, v in model.state_dict().items()} \
        if ctx.rank == 0 else None
    tp = TensorGroup(mesh.get_group("tensor"), mesh.get_local_rank("tensor"), ctx.world)
    shard_tensor_parallel(model, tp)
    rank_bytes = sum(p.numel() * p.element_size() for p in model.parameters())

    def fwd():
        with torch.inference_mode():
            return model.forward_generation_img(md, target, sa)

    reset_counts()
    logits = fwd()
    ctx.sync()
    launches = counts()
    times = []
    for _ in range(1 + ctx.args.timing_steps):
        ctx.sync()
        dist.barrier()
        t0 = time.perf_counter()
        fwd()
        ctx.sync()
        dist.barrier()
        times.append(time.perf_counter() - t0)
    out = {"model": XL_QK, "batch": B, "target": target, "tensor": ctx.world,
           "heads_per_rank": model.config.num_heads // ctx.world,
           "ms_per_forward": float(np.median(times[1:])) * 1e3,
           "launches_per_rank": ctx.gather(launches),
           "parameter_bytes_per_rank": ctx.gather(rank_bytes), "parameter_bytes_whole":
           full_bytes}
    del model
    if ctx.cuda:
        torch.cuda.empty_cache()
    if ctx.rank == 0:
        one = build(ctx, XL_QK, params_dtype=torch.bfloat16).eval()
        one.load_state_dict(state0)
        with torch.inference_mode():
            ref_bf16 = one.forward_generation_img(md, target, sa)
            reset_counts()
            one.forward_generation_img(md, target, sa)
            out["tensor1_launches"] = counts()
            t1 = []
            for _ in range(1 + ctx.args.timing_steps):
                ctx.sync()
                t0 = time.perf_counter()
                one.forward_generation_img(md, target, sa)
                ctx.sync()
                t1.append(time.perf_counter() - t0)
        out["tensor1_ms_per_forward"] = float(np.median(t1[1:])) * 1e3
        del one
        f32 = build(ctx, XL_QK, dtype="float32")
        f32.load_state_dict({k: v.float() for k, v in state0.items()})
        with torch.inference_mode():
            ref = f32.forward_generation_img(md, target, sa).float()
        del f32
        out.update(gate_logits(logits.float(), ref, ref_bf16.float(), "M3"))
        check(out["launches_per_rank"][0] == out["tensor1_launches"],
              f"M3: tensor-4 launches {out['launches_per_rank'][0]} != tensor-1 "
              f"{out['tensor1_launches']}")
    if ctx.cuda:
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def part_m4(ctx):
    from fourm_torch.cli import train_vqvae as tcli
    from fourm_torch.utils.config import parse_args_with_config

    per_card = 64 if not ctx.args.tiny else 2
    extra = ["--enc_type", "vit_t_enc", "--dec_type", "vit_t_dec", "--input_size", "64"] \
        if ctx.args.tiny else []
    args = parse_args_with_config(tcli.get_parser(), [
        "--config", os.path.join(ROOT, T3_CONFIG), "--batch_size", str(per_card),
        "--total_steps", "4",
        "--synthetic_data", "--output_dir", os.path.join("out", "chip_multicard_m4"),
        "--device", str(ctx.device), *extra] + (["--dtype", "float32"] if not ctx.cuda else []))
    ctx.peak_reset()
    trainer = tcli.Trainer(args, ctx.device, dist.group.WORLD)
    src = tcli.SyntheticBatches(args, (ctx.rank, ctx.world))
    equal, times, launches = [], [], None
    for it in range(4):
        batch = torch.from_numpy(src.batch(it)).to(ctx.device)
        reset_counts()
        ctx.sync()
        dist.barrier()
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        ctx.sync()
        times.append(time.perf_counter() - t0)
        if it == 0:
            launches = counts()
        cb = trainer.model.quantize._codebook
        mine = (cb.embed.detach().cpu(), cb.cluster_size.detach().cpu())
        every = ctx.gather(mine)
        same = all(torch.equal(e, every[0][0]) and torch.equal(c, every[0][1])
                   for e, c in every)
        equal.append(same)
        check(same, f"M4: ranks' codebooks differ after step {it}")
        check(np.isfinite(float(metrics["loss"])), f"M4: loss {float(metrics['loss'])}")
    sec = float(np.median(times[1:]))
    out = {"config": T3_CONFIG, "per_card": per_card, "global_batch": per_card * ctx.world,
           "codebooks_equal_after_each_step": equal, "ms_per_step": sec * 1e3,
           "samples_per_s": per_card * ctx.world / sec, "launches_per_rank_step0":
           ctx.gather(launches), "peak_memory_bytes_per_card": ctx.peak()}
    del trainer
    dist.barrier()
    return out


PARTS = {"M1": part_m1, "M2": part_m2, "M3": part_m3, "M4": part_m4, "M5": part_m5}


def main() -> int:
    p = argparse.ArgumentParser(description="the port's mesh paths over the cards of one host")
    p.add_argument("--parts", default="M1,M2,M3,M4,M5")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--tiny", action="store_true", help="narrow widths (CPU rehearsal)")
    p.add_argument("--timing_steps", type=int, default=5)
    p.add_argument("--json_out", default=None, help="write every part's JSON here too")
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_multicard: no CUDA device; run it on the cards (or --device cpu)",
              file=sys.stderr)
        return 2
    from fourm_torch.parallel.launch import initialize_multihost, shutdown

    initialize_multihost(device=args.device)
    if not dist.is_initialized():  # one process (a rehearsal on one card): a world-1 group
        import socket
        from datetime import timedelta

        if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
            init = "env://"  # torchrun's store (its agent holds it)
        else:
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                init = f"tcp://localhost:{sock.getsockname()[1]}"
        dist.init_process_group("gloo" if args.device == "cpu" else "nccl", init_method=init,
                                world_size=1, rank=0, timeout=timedelta(seconds=300))
    ctx = Ctx(args)
    t_start = time.perf_counter()
    if ctx.cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from fourm_torch.kernels import _build

        if ctx.rank == 0:
            ctx.card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                       "--format=csv,noheader"], capture_output=True,
                                      text=True, check=True, timeout=60).stdout.strip()
            print(ctx.card, flush=True)
            print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, world {ctx.world}",
                  flush=True)
            print(f"build: {_build.build_all():.2f} s", flush=True)
        dist.barrier()
        _build.build_all()  # built by rank 0: found
    results = {}
    for name in args.parts.split(","):
        t0 = time.perf_counter()
        res = PARTS[name](ctx)
        res = {"part": name, "seconds": time.perf_counter() - t0, **res,
               "cards": ctx.card.splitlines()}
        results[name] = res
        ctx.say(json.dumps(res))
        if FAILED:
            raise RuntimeError(f"chip_multicard: {name} missed {len(FAILED)} gate(s): {FAILED}")
    if ctx.rank == 0:
        if args.json_out:
            os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
            with open(args.json_out, "w") as f:
                json.dump(results, f, indent=1)
        print(f"chip_multicard: {', '.join(results)} passed in "
              f"{time.perf_counter() - t_start:.1f} s; {ctx.card.splitlines()[:1]}", flush=True)
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
