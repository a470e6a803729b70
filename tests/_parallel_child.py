"""The ranks of tests/test_torch_parallel*.py: jobs run in every process of a
world-2 gloo group (started with torch.multiprocessing.spawn on a file://
store under the test's tmp_path, one torch thread a process). Imports
torch and fourm_torch only, so that a spawned process loads no JAX.

`spawn(tmp_path, jobs)` writes the jobs, runs them on both ranks in turn,
and returns rank 0's results: {job name: result}. A job is a dict with
"kind" ("train", "forward", "vq", "born" or "eval") and "name"; see run_*
below.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

WORLD = 2


def spawn(tmp_path, jobs, world: int = WORLD) -> dict:
    import torch.multiprocessing as mp

    path = os.path.join(str(tmp_path), "jobs.pt")
    torch.save(jobs, path)
    mp.spawn(_child, args=(world, str(tmp_path)), nprocs=world, join=True)
    return torch.load(os.path.join(str(tmp_path), "results.pt"), weights_only=False)


def _child(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=rank, world_size=world)
    jobs = torch.load(os.path.join(tmp, "jobs.pt"), weights_only=False)
    results = {}
    for job in jobs:
        if job.get("resume_from"):  # rank 0's full state of an earlier job, on every rank
            obj = [results[job["resume_from"]].get("saved")]
            dist.broadcast_object_list(obj, src=0)
            job = dict(job, resume=obj[0])
        results[job["name"]] = {"train": run_train, "forward": run_forward, "vq": run_vq,
                                "born": run_born, "eval": run_eval}[job["kind"]](job)
        dist.barrier()
    if rank == 0:
        torch.save(results, os.path.join(tmp, "results.pt"))
    dist.barrier()
    dist.destroy_process_group()


def build_model(job):
    from fourm_torch.models import FourM, create_fourm_config

    cfg = create_fourm_config(job["flavor"], job["mods"], job["dec"], **job["config"])
    model = FourM(cfg)
    model.load_state_dict(job["state"], strict=True)
    return model


def _torch(batch):
    from fourm_torch.utils.synthetic import to_torch

    return to_torch(batch, "cpu")


def local_batch(batch, plan, accum: int):
    """The rank's rows of a global numpy batch, (accum, rows) when accum > 1."""
    from fourm_torch.cli.train_4m import rows_of

    b = _torch(rows_of(batch, plan.batch_index, plan.batch_count, accum))
    if accum > 1:
        b = {m: {k: v.reshape((accum, -1) + v.shape[1:]) for k, v in d.items()}
             for m, d in b.items()}
    return b


def run_train(job):
    """job: mesh (make_mesh kwargs), flavor / mods / dec / config / state (the
    model), opt (create_optimizer kwargs; "frozen_trunk": the trainable mask),
    sched, accum, batches (global numpy batches, one a step), gen_seed
    (drop-path generator), resume (a full state to load first), save_after
    (steps after which to keep the full state), probe (hold_a_share after
    init and after each step). -> rank 0's metrics a step, the final full
    state, the saved state, this job's per-rank counts and local-count
    losses of the first batch (counts), every rank's bytes, the probes."""
    from fourm_torch.parallel import (build_train_step, frozen_trunk_mask, init_train_state,
                                      make_mesh)
    from fourm_torch.utils import optim

    mesh = make_mesh(**job["mesh"])
    model = build_model(job)
    opt = dict(job.get("opt", {}))
    mask = frozen_trunk_mask(model) if opt.pop("frozen_trunk", False) else None
    tx = optim.create_optimizer(model, optim.cosine_schedule(*job["sched"]), **opt)
    state = init_train_state(model, tx, device="cpu", mesh=mesh)
    plan = state.plan
    out = {"bytes": _gather_obj(plan.param_bytes())}
    if job.get("resume") is not None:
        m_sd, o_sd = job["resume"]
        plan.load_full(m_sd, tx, o_sd)
    if job.get("counts"):
        b = local_batch(job["batches"][0], plan, 1)
        with torch.no_grad():
            loss, (_, counts) = model(b, job["ni"], job["nt"])
        out["counts"] = _gather_obj({"loss": float(loss),
                                     "counts": {m: int(c) for m, c in counts.items()}})
    step = build_train_step(model, tx, job["ni"], job["nt"], mesh=mesh,
                            grad_accum_steps=job.get("accum", 1), trainable_mask=mask)
    gen = None if job.get("gen_seed") is None else torch.Generator().manual_seed(job["gen_seed"])
    metrics = []
    probes = [hold_a_share(plan)] if job.get("probe") else []
    for i, batch in enumerate(job["batches"]):
        plan.reset_peak()
        state, m = step(state, local_batch(batch, plan, job.get("accum", 1)), gen)
        metrics.append({k: float(v) for k, v in m.items()})
        if job.get("probe"):
            probes.append(hold_a_share(plan))
        if job.get("save_after") == i + 1:
            out["saved"] = plan.full_state(tx)
    out["probes"] = _gather_obj(probes)
    out["metrics"] = metrics
    out["full"] = plan.full_state(tx)
    out["count"] = tx.count
    return out


def hold_a_share(plan) -> dict:
    """What the rank holds now: the sharded leaves whose parameter's
    storage is above their chunk's bytes or that have a gradient, and the
    most units whole at once since the plan's last reset_peak."""
    over = [l.name for l in plan.leaves if l.fdim is not None
            and l.param.untyped_storage().nbytes() > l.n * 4]
    grads = [l.name for l in plan.leaves if l.fdim is not None and l.param.grad is not None]
    return {"sharded": sum(l.fdim is not None for l in plan.leaves), "over_chunk": over,
            "with_grad": grads, "peak_whole_units": plan.peak_whole,
            "whole_now": [u.name for u in plan.units if u.whole], "units": len(plan.units)}


def run_born(job):
    """A model built under meta_params, born sharded through init_train_state
    (seed job["seed"]), against init_weights of the whole model chunked by
    the same plan. -> every rank's (leaves equal bit for bit, leaves, its
    probe)."""
    from fourm_torch.models import FourM, create_fourm_config, init_weights
    from fourm_torch.parallel import init_train_state, make_mesh, meta_params
    from fourm_torch.utils import optim

    cfg = create_fourm_config(job["flavor"], job["mods"], job["dec"], **job["config"])
    with meta_params():
        model = FourM(cfg)
    tx = optim.create_optimizer(model, optim.cosine_schedule(*job["sched"]))
    plan = init_train_state(model, tx, device="cpu", mesh=make_mesh(**job["mesh"]),
                            seed=job["seed"]).plan
    whole = dict(init_weights(FourM(cfg), job["seed"]).named_parameters())
    equal = [torch.equal(plan.master(l), plan._chunk(whole[l.name], l) if l.fdim is not None
                         else whole[l.name]) for l in plan.leaves]
    buffers = all(torch.equal(b, dict(FourM(cfg).named_buffers())[n])
                  for n, b in model.named_buffers())
    return {"equal": _gather_obj((sum(equal), len(equal), buffers)),
            "probe": _gather_obj(hold_a_share(plan))}


def run_eval(job):
    """The eval forward (train=False, no gradient) of a sharded model on the
    rank's rows of job["batch"], the loss over the global batch
    (cli/train_4m.py:evaluate's count_reduce); then DecoderBlock.step and
    cross_kv, which must raise. -> the global loss and per-modality losses,
    every rank's probe and what each call raised."""
    from fourm_torch.parallel import init_train_state, make_mesh
    from fourm_torch.parallel.shard import ShardedUnitError
    from fourm_torch.utils import optim

    model = build_model(job)
    tx = optim.create_optimizer(model, optim.cosine_schedule(*job["sched"]))
    plan = init_train_state(model, tx, device="cpu", mesh=make_mesh(**job["mesh"])).plan
    b = local_batch(job["batch"], plan, 1)
    plan.reset_peak()
    with torch.no_grad():
        loss, (mod_loss, _) = model(b, job["ni"], job["nt"], train=False,
                                    count_reduce=plan.reduce_batch)
    mods = list(mod_loss)
    vals = plan.reduce_batch(torch.stack([loss] + [mod_loss[m] for m in mods]))
    raised = {}
    blk = model.decoder[0]
    x = torch.zeros(2, 1, model.config.dim)
    for name, call in (("step", lambda: blk.step(x, None, None, None, None, None, None)),
                       ("cross_kv", lambda: blk.cross_kv(x)),
                       ("forward_generation_img",
                        lambda: model.forward_generation_img(b, "tok_rgb@224", None))):
        try:
            call()
            raised[name] = None
        except ShardedUnitError as e:
            raised[name] = str(e)
    return {"loss": float(vals[0]), "mod_loss": dict(zip(mods, vals[1:].tolist())),
            "probe": _gather_obj(hold_a_share(plan)), "raised": _gather_obj(raised)}


def run_forward(job):
    """forward_generation_img of a tensor-split model: job mesh, the model,
    mod_dict (numpy), target, sa_keys_valid. -> logits (rank 0's), every
    rank's parameter bytes."""
    from fourm_torch.parallel import make_mesh
    from fourm_torch.parallel.shard import ParallelPlan

    mesh = make_mesh(**job["mesh"])
    model = build_model(job)
    plan = ParallelPlan(model, mesh)
    with torch.no_grad():
        logits = model.forward_generation_img(_torch(job["mod_dict"]), job["target"],
                                              torch.from_numpy(job["sa_keys_valid"]))
    return {"logits": logits.numpy(), "bytes": _gather_obj(plan.param_bytes()),
            "split_heads": [m.num_heads for m in model.modules() if hasattr(m, "tp")
                            and m.tp is not None and hasattr(m, "num_heads")]}


def run_vq(job):
    """A VectorQuantize training forward over the world's group, each rank
    on its rows of x: job quantizer kwargs, codebook, x (global), draws
    (global). -> indices and losses of every rank, the codebook."""
    from fourm_torch.vq import quantizer as tq

    pm = tq.VectorQuantize(**job["kwargs"])
    pm.group = dist.group.WORLD
    pm._codebook.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in
                                  job["codebook"].items()})
    r, n = dist.get_rank(), dist.get_world_size()
    x = torch.from_numpy(job["x"])
    b = x.shape[0] // n
    draws = {k: torch.from_numpy(v) for k, v in job["draws"].items()}
    _, ind, loss = pm(x[r * b:(r + 1) * b], train=True, draws=draws)
    return {"ind": _gather_obj(ind.numpy()), "loss": _gather_obj(float(loss)),
            "codebook": {k: v.clone() for k, v in pm._codebook.state_dict().items()},
            "codebooks_equal": _gather_obj(pm._codebook.embed.clone())}


def _gather_obj(obj):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out
