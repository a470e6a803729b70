"""Phase 15 of chip_smoke.py: the train step over a mesh on one H100.

A world-1 NCCL process group is started inside the script (on a free
localhost port) and phase 9's step (bench.py:224-279: 4M-B mod-7,
fm_base_12e_12d_swiglu_nobias at full width, B = 32, 128 + 128 tokens, lr
1e-3) runs 3 times on one batch in three ways from the same seeded weights:
without a mesh, through build_train_step(mesh=make_mesh()) (data parallel
at world 1), and sharded at world 1 (init_train_state(..., shard=True):
every parameter held in the plan's chunk buffer, gathered unit by unit in
the forward and again in the backward, its gradient reduce-scattered into
the chunks, the collectives of size 1; parallel/shard.py). Gates: the
launch counts of each mesh run exact (36 + 36 `attention_train` and 1
`fused_adamw` a step); its losses within 1e-3 relative of the run without a
mesh and every master within 2 lr x steps of it, with at most 0.1% of the
entries beyond 1e-6 (the bf16 step's own tolerance, tests/test_torch_train.py);
the sharded run's masters bit for bit equal to the run without a mesh (at
world 1 the runs launch the same kernels on the same values, and the unit
hooks leave the backward's order as it is); after each of its steps no
sharded parameter holds storage or a gradient (the masters are the only
copy between steps). After the steps each run evaluates the batch as
cli/train_4m.py:evaluate does (train=False, no gradient: the inference
kernels, through the unit gathers in the sharded run, where
chip_smoke.KernelTap holds each launch to its plain twin): the same launch
counts as the run without a mesh, the loss within 1e-5 relative of its
(bit for bit expected, printed). The group is torn down at the end.

`python3 chip_smoke.py --part parallel` runs the build and this phase.
"""

from __future__ import annotations

import json
import socket
import time

STEPS = 3
LR = 1e-3
EVAL_KERNELS = ("ln_matmul", "ln_mlp", "attn_block", "mha_short", "flash_mha", "attention")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(torch, check, train_model, batch, tokens: int, mesh, shard):
    """STEPS steps from seed-0 weights, then the eval forward -> (losses,
    masters on the CPU, launch counts of the steps, the plan's bytes or
    None, the sharded parameters that held storage or a gradient after a
    step, (eval loss, its launch counts))."""
    from fourm_torch import kernels
    from fourm_torch.parallel import build_train_step, init_train_state
    from fourm_torch.utils.optim import constant_schedule, create_optimizer

    model = train_model(torch, "cuda")
    tx = create_optimizer(model, constant_schedule(LR), weight_decay=0.05, betas=(0.9, 0.95))
    state = init_train_state(model, tx, mesh=mesh, shard=shard) if mesh is not None \
        else init_train_state(model, tx)
    step = build_train_step(model, tx, tokens, tokens, mesh=mesh)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    losses, held = [], set()
    for _ in range(STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        if state.plan is not None:
            held |= {l.name for l in state.plan.leaves if l.fdim is not None and (
                l.param.untyped_storage().nbytes() or l.param.grad is not None)}
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if state.plan is None:
        masters = {n: p.detach().to("cpu", torch.float32, copy=True)
                   for n, p in model.named_parameters()}
        info = None
    else:
        masters, _ = state.plan.full_state(tx)  # whole, from the chunks
        info = state.plan.param_bytes()
    kernels.reset_launch_counts()
    with torch.no_grad():  # cli/train_4m.py:evaluate at world 1
        if shard:
            import chip_smoke

            with chip_smoke.KernelTap(torch, "phase 15 sharded eval", EVAL_KERNELS) as tap:
                loss, _ = model(batch, tokens, tokens, train=False)
            print(f"phase 15 sharded eval: launches held to their twins (calls, largest "
                  f"error, tolerance): {json.dumps(tap.calls)}", flush=True)
        else:
            loss, _ = model(batch, tokens, tokens, train=False)
    torch.cuda.synchronize()
    evaluated = (float(loss), {k: v for k, v in kernels.launch_counts().items() if v})
    if state.plan is not None:
        check(not any(u.whole for u in state.plan.units), "phase 15: a unit left whole "
              "after the eval")
    del state, step, tx, model
    torch.cuda.empty_cache()
    return losses, masters, launches, info, sorted(held), evaluated


def parallel_phase(torch, card: str, check, train_model, train_batch, per_step: dict,
                   batch_size: int = 32, tokens: int = 128) -> dict:
    """Phase 15 (see the module docstring). -> {path: launch counts}."""
    import torch.distributed as dist

    from fourm_torch.parallel import make_mesh

    t0 = time.perf_counter()
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                                world_size=1, rank=0)
    try:
        batch = train_batch(torch, batch_size, 0, "cuda")
        ref_losses, ref_masters, _, _, _, ref_eval = _run(torch, check, train_model, batch,
                                                          tokens, None, None)
        mesh = make_mesh()
        out = {}
        for label, shard in (("mesh_data", None), ("mesh_fsdp", True)):
            losses, masters, launches, info, held, evaluated = _run(
                torch, check, train_model, batch, tokens, mesh, shard)
            expected = {k: STEPS * per_step.get(k, 0) for k in launches}
            check(launches == expected, f"phase 15 {label}: launches {launches} != {expected}")
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
            worst = max(float((masters[n] - t).abs().max()) for n, t in ref_masters.items())
            far = sum(int((masters[n] - t).abs().gt(1e-6).sum()) for n, t in ref_masters.items())
            total = sum(t.numel() for t in ref_masters.values())
            bitwise = all(torch.equal(masters[n], t) for n, t in ref_masters.items())
            shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
            fmt = ", ".join
            print(f"phase 15 {label}: world-1 NCCL mesh {shape}, shard={bool(shard)}: losses "
                  f"{fmt(f'{x:.6f}' for x in losses)} vs no mesh "
                  f"{fmt(f'{x:.6f}' for x in ref_losses)} (max rel {rel:.3g}); "
                  f"masters max abs diff {worst:.3g}, {far} of {total} beyond 1e-6, bit for "
                  f"bit {bitwise}; plan bytes {json.dumps(info)}; sharded parameters holding "
                  f"storage or a gradient after a step: {len(held)}; {card}", flush=True)
            check(rel <= 1e-3, f"phase 15 {label}: losses off by {rel}")
            check(worst <= 2 * LR * STEPS + 1e-6 and far <= 1e-3 * total,
                  f"phase 15 {label}: masters off ({worst}, {far} of {total})")
            print(f"phase 15 {label} eval: loss {evaluated[0]!r} vs no mesh {ref_eval[0]!r} "
                  f"(equal {evaluated[0] == ref_eval[0]}), launches {json.dumps(evaluated[1])}",
                  flush=True)
            check(evaluated[1] == ref_eval[1] and evaluated[1],
                  f"phase 15 {label} eval: launches {evaluated[1]} != no mesh {ref_eval[1]}")
            check(abs(evaluated[0] - ref_eval[0]) <= 1e-5 * abs(ref_eval[0]),
                  f"phase 15 {label} eval: loss {evaluated[0]} vs {ref_eval[0]}")
            if shard:
                check(bitwise, f"phase 15 {label}: masters not bit for bit the run without "
                               "a mesh's")
                check(not held and info["parameters"] == 0,
                      f"phase 15 {label}: between steps {held[:5]} held storage or a "
                      f"gradient ({info['parameters']} parameter bytes)")
            print(f"launches {json.dumps({k: v for k, v in launches.items() if v})}", flush=True)
            out[label] = launches
        del mesh
    finally:
        if started:
            dist.destroy_process_group()
    print(f"phase 15: {time.perf_counter() - t0:.1f} s; {card}", flush=True)
    return out
