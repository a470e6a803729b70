"""The rest of the training slice against the JAX package on the CPU, in
fp32, at the tiny 4M-7 config of tests/test_torch_train.py cut to 1 + 1
layers (dim 64, 2 heads; weights carried over by from_jax_params): layer decay,
the frozen-trunk phase, skip-grad, remat, the eval, and the CLI on tar
shards.

  * Layer decay: the port's per-layer scales equal JAX's layerwise_lr_scales
    leaf for leaf (through the weight bridge), and three steps equal the
    reference's order built here from the JAX package's own pieces
    (clip_by_global_norm, optax.adamw, then scale_by_tree of the scales);
    the JAX package's create_optimizer(layer_decay=), which scales the
    gradient before AdamW, differs from the port by more than the
    tolerance on the same gradients (ROADMAP, "Not faults of the port").
  * The frozen-trunk phase: three steps of build_train_step with
    frozen_trunk_mask against JAX's build_train_step(trainable_mask=):
    losses, grad norms, every parameter and moment, the count; the trunk's
    values stay bit for bit. create_optimizer(frozen_mask=) against JAX's
    (optax.masked(set_to_zero) after the chain) over three steps on the same
    gradients: the frozen leaves' moments step, their values stay.
  * skip-grad: three steps on three batches with the threshold between their
    norms against JAX's skip_large_grads: which steps skip, parameters,
    moments and the count.
  * Remat with drop_path_rate > 0 and one explicit generator: the loss and
    every gradient equal the run without remat, and each block's forward
    runs twice.
  * evaluate: the port's against JAX's on the same val batches.
Tolerances as tests/test_torch_train.py: losses and norms within rtol 1e-4
/ atol 2e-5, parameters within 2e-6 (at most 0.1% of entries beyond, none
beyond 2 lr x steps), each moment leaf within 1e-3 x its largest value plus
the gradients' floor of 2e-6 carried into it ((1 - b1) 2e-6 in mu, (1 - b2)
(2e-6)^2 in nu).
"""

import _torch_threads  # noqa: F401  (torch's threads in xdist workers)
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fourm_tpu.cli import train_4m as jax_cli
from fourm_tpu.models import FourM as JaxFourM
from fourm_tpu.models import create_fourm_config as jax_config
from fourm_tpu.parallel import TrainState as JaxTrainState
from fourm_tpu.parallel import build_train_step as jax_build_train_step
from fourm_tpu.parallel import frozen_trunk_mask as jax_frozen_trunk_mask
from fourm_tpu.utils import optim as jax_optim
from fourm_torch.cli import train_4m as port_cli
from fourm_torch.models import FourM, create_fourm_config
from fourm_torch.parallel import build_train_step, frozen_trunk_mask, init_train_state
from fourm_torch.utils import optim, synthetic
from fourm_torch.utils.checkpoint import from_jax_adam_state, from_jax_params

MODS, DEC = synthetic.MOD7_MODALITIES, synthetic.MOD7_DECODER_MODALITIES
FLAVOR = "fm_base_12e_12d_swiglu_qknorm_nobias"
TINY = dict(dim=64, encoder_depth=1, decoder_depth=1, num_heads=2)
NI = NT = 32
LR = 1e-3
SCHED = (LR, 50, 1)  # cosine: base lr, total steps, warmup


def _batch(seed=6, B=2):
    return synthetic.synthetic_mod_batch(MODS, B, NI, NT, seed=seed)


@pytest.fixture(scope="module")
def pair():
    jm = JaxFourM(jax_config(FLAVOR, MODS, DEC, **TINY))
    variables = jax.jit(jm.init, static_argnums=(2, 3))(
        jax.random.key(0), jax.tree.map(jnp.asarray, _batch()), NI, NT)
    return dict(jm=jm, variables=variables, tcfg=create_fourm_config(FLAVOR, MODS, DEC, **TINY))


def _port(pair, **cfg):
    tm = FourM(pair["tcfg"].__class__(**{**pair["tcfg"].__dict__, **cfg}))
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, pair["variables"])["params"],
                                       pair["tcfg"]), strict=True)
    return tm


def _jax_steps(pair, tx, seeds, trainable_mask=None):
    step = jax_build_train_step(pair["jm"], tx, NI, NT, donate=False,
                                trainable_mask=trainable_mask)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=pair["variables"],
                          opt_state=tx.init(pair["variables"]))
    out = []
    for seed in seeds:
        state, metrics = step(state, jax.tree.map(jnp.asarray, _batch(seed)), jax.random.key(2))
        out.append((state, jax.tree.map(np.asarray, metrics)))
    return out


def _port_steps(tm, tx, seeds, trainable_mask=None, check=None):
    state = init_train_state(tm, tx, device="cpu")
    step = build_train_step(tm, tx, NI, NT, trainable_mask=trainable_mask)
    out = []
    for seed in seeds:
        state, metrics = step(state, synthetic.to_torch(_batch(seed), "cpu"))
        out.append({k: float(v) for k, v in metrics.items()})
    return out


def _grad_trees(pair, seeds):
    """Gradients of the model's JAX tree drawn from numpy seeds (0.1 x N(0, 1))."""
    out = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        out.append(jax.tree.map(lambda a: 0.1 * rng.standard_normal(a.shape, np.float32),
                                jax.tree.map(np.asarray, pair["variables"])))
    return out


def _optimizer_steps(pair, jtx, tx, grads):
    """The JAX optax chain and the port's FusedAdamW (over tx.model, from the
    pair's weights) stepped on the same gradients; -> JAX's (params, state)."""
    @jax.jit
    def update(g, state, params):
        upd, state = jtx.update(g, state, params)
        return optax.apply_updates(params, upd), state

    params, state = pair["variables"], jtx.init(pair["variables"])
    tx.init()
    for g in grads:
        params, state = update(g, state, params)
        tg = from_jax_params(g["params"], pair["tcfg"])
        for n, p in tx.model.named_parameters():
            p.grad = tg[n].clone()
        tx.step(torch.nn.utils.get_total_norm([p.grad for p in tx.model.parameters()]))
    return params, state


def _far(tm, jparams, tcfg):
    """(entries beyond 2e-6, all entries, the largest difference)."""
    ref = from_jax_params(jax.tree.map(np.asarray, jparams)["params"], tcfg)
    n_far = n_all = 0
    worst = 0.0
    for name, p in tm.named_parameters():
        d = np.abs(p.detach().numpy() - ref[name].numpy())
        n_far += int((d > 2e-6).sum())
        n_all += d.size
        worst = max(worst, float(d.max()))
    return n_far, n_all, worst


def _params_close(tm, jparams, tcfg, steps):
    n_far, n_all, worst = _far(tm, jparams, tcfg)
    assert worst <= 2 * LR * steps + 2e-6, worst
    assert n_far <= 1e-3 * n_all, f"{n_far} of {n_all} entries beyond 2e-6"


def _metrics_close(got, ref):
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-4, atol=2e-5, err_msg=k)


def _moments_close(tx, jstate, tcfg):
    adam = from_jax_adam_state(jstate.opt_state, tcfg)
    assert tx.count == adam["count"]
    # a gradient's floor of 2e-6 (tests/test_torch_train.py) is (1 - b1) 2e-6
    # in mu and (1 - b2) (2e-6)^2 in nu
    for key, floor in (("mu", 2e-7), ("nu", 2e-13)):
        for n, t in getattr(tx, key).items():
            ref = adam[key][n].numpy()
            np.testing.assert_allclose(t.numpy(), ref, rtol=0,
                                       atol=1e-3 * float(np.abs(ref).max()) + floor,
                                       err_msg=f"{key} {n}")


def test_layer_scales_match_jax(pair):
    """fourm_layer_id on the port's names gives JAX's ids (computed on the
    params tree, where JAX's names are encoder_0/..., not params/...)."""
    tm = _port(pair)
    ours = optim.layerwise_lr_scales(tm, 0.75)
    ref = jax_optim.layerwise_lr_scales(pair["variables"]["params"], 0.75, 1, 1)
    ref = from_jax_params(jax.tree.map(lambda x: np.full((), x, np.float32), ref), pair["tcfg"])
    for name, scale in ours.items():
        assert np.float32(scale) == ref[name].reshape(-1)[0], name
    assert len(set(ours.values())) == 1 + 1 + 3  # ids 0 .. max_id = 1 + 1 + 2


def test_layer_decay_matches_reference_order(pair):
    """Three steps with layer_decay 0.75 and the clip against optax's
    clip -> adamw -> scale_by_tree(scales); JAX's own create_optimizer, which
    scales the gradient first, lands elsewhere."""
    variables = pair["variables"]
    scales = {"params": jax_optim.layerwise_lr_scales(variables["params"], 0.75, 1, 1)}
    sched = jax_optim.cosine_schedule(*SCHED)
    ref_tx = optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adamw(sched, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.05,
                    mask=jax_optim.weight_decay_mask(variables)),
        jax_optim.scale_by_tree(scales))
    ref = _jax_steps(pair, ref_tx, [6, 6, 6])
    tm = _port(pair)
    tx = optim.create_optimizer(tm, optim.cosine_schedule(*SCHED), clip_grad=1.0,
                                layer_decay=0.75)
    got = _port_steps(tm, tx, [6, 6, 6])
    for g, (_, m) in zip(got, ref):
        _metrics_close(g, m)
    _params_close(tm, ref[-1][0].params, pair["tcfg"], 3)
    _moments_close(tx, ref[-1][0], pair["tcfg"])

    # two steps on the same gradients (the first at lr 0, the warmup's)
    own_tx = jax_optim.create_optimizer(variables, sched, clip_grad=1.0, layer_decay=0.75,
                                        encoder_depth=1, decoder_depth=1)
    one = _port(pair)
    one_tx = optim.create_optimizer(one, optim.cosine_schedule(*SCHED), clip_grad=1.0,
                                    layer_decay=0.75)
    own, _ = _optimizer_steps(pair, own_tx, one_tx, _grad_trees(pair, [1, 2]))
    n_far, n_all, worst = _far(one, own, pair["tcfg"])
    assert n_far > 0.1 * n_all and worst > 10 * 2e-6, (n_far, n_all, worst)


def test_frozen_phase_matches_jax(pair):
    variables = pair["variables"]
    sched = jax_optim.cosine_schedule(*SCHED)
    jtx = jax_optim.create_optimizer(variables, sched, clip_grad=1.0)
    ref = _jax_steps(pair, jtx, [6, 7, 8], trainable_mask=jax_frozen_trunk_mask(variables))
    tm = _port(pair)
    start = {n: p.detach().clone() for n, p in tm.named_parameters()}
    mask = frozen_trunk_mask(tm)
    tx = optim.create_optimizer(tm, optim.cosine_schedule(*SCHED), clip_grad=1.0)
    got = _port_steps(tm, tx, [6, 7, 8], trainable_mask=mask)
    for g, (_, m) in zip(got, ref):
        _metrics_close(g, m)
    _params_close(tm, ref[-1][0].params, pair["tcfg"], 3)
    _moments_close(tx, ref[-1][0], pair["tcfg"])
    frozen = [n for n, t in mask.items() if not t]
    assert frozen and any(mask.values())
    assert all(n.startswith(("encoder.", "decoder.", "encoder_norm", "decoder_norm"))
               for n in frozen)
    moved = {n for n, p in tm.named_parameters() if not torch.equal(p.detach(), start[n])}
    assert not moved & set(frozen)
    # every leaf of the decoder's inputs and outputs trains (the encoder's
    # token embeddings get no gradient here: the 32 encoder tokens are rgb's)
    heads = {n for n in mask if n.startswith(("decoder_embeddings", "decoder_proj_context",
                                              "mask_token"))}
    assert heads and heads <= moved, heads - moved
    for n in frozen:  # the moments of a leaf frozen from the start stay zero
        assert not tx.mu[n].any() and not tx.nu[n].any(), n


def test_frozen_mask_matches_jax(pair):
    """create_optimizer(frozen_mask=) against JAX's over three steps on the
    same gradients, with the clip: a frozen leaf's moments step on its real
    gradient and its value stays bit for bit; the rest, the moments and the
    count as JAX's."""
    variables = pair["variables"]
    frozen_tree = jax.tree.map(lambda t: not t, jax_frozen_trunk_mask(variables))
    jtx = jax_optim.create_optimizer(variables, jax_optim.cosine_schedule(*SCHED),
                                     clip_grad=1.0, frozen_mask=frozen_tree)
    tm = _port(pair)
    frozen = {n: not t for n, t in frozen_trunk_mask(tm).items()}
    start = {n: p.detach().clone() for n, p in tm.named_parameters()}
    tx = optim.create_optimizer(tm, optim.cosine_schedule(*SCHED), clip_grad=1.0,
                                frozen_mask=frozen)
    params, state = _optimizer_steps(pair, jtx, tx, _grad_trees(pair, [1, 2, 3]))
    _params_close(tm, params, pair["tcfg"], 3)
    _moments_close(tx, SimpleNamespace(opt_state=state), pair["tcfg"])
    assert any(frozen.values()) and not all(frozen.values())
    for n, p in tm.named_parameters():
        assert torch.equal(p.detach(), start[n]) == frozen[n], n
        assert tx.mu[n].any() and tx.nu[n].any(), n


def test_skip_grad_matches_jax(pair):
    """The threshold between two batches' gradient norms at the start, the
    larger first: step 0 skips (parameters, moments and count stay), step 1
    does not, in both packages alike."""
    def norm_at_start(seed):
        tm = _port(pair)
        loss, _ = tm(synthetic.to_torch(_batch(seed), "cpu"), NI, NT)
        loss.backward()
        return float(torch.nn.utils.get_total_norm([p.grad for p in tm.parameters()]))

    (n_hi, hi), (n_lo, lo) = sorted(((norm_at_start(s), s) for s in (6, 7)), reverse=True)
    threshold = 0.5 * (n_hi + n_lo)
    seeds = [hi, lo, hi]
    variables = pair["variables"]
    sched = jax_optim.cosine_schedule(*SCHED)
    jtx = jax_optim.create_optimizer(variables, sched, clip_grad=1.0, skip_grad=threshold)
    ref = _jax_steps(pair, jtx, seeds)
    tm = _port(pair)
    tx = optim.create_optimizer(tm, optim.cosine_schedule(*SCHED), clip_grad=1.0,
                                skip_grad=threshold)
    got = _port_steps(tm, tx, seeds)
    skipped = [m["grad_norm"] > threshold for m in got]
    assert skipped[:2] == [True, False], (n_hi, n_lo, [m["grad_norm"] for m in got])
    for g, (_, m) in zip(got, ref):
        _metrics_close(g, m)
    assert tx.count == 3 - sum(skipped) == from_jax_adam_state(ref[-1][0].opt_state,
                                                               pair["tcfg"])["count"]
    _params_close(tm, ref[-1][0].params, pair["tcfg"], 3)
    _moments_close(tx, ref[-1][0], pair["tcfg"])


def test_remat_equals_no_remat_with_drop_path(pair, monkeypatch):
    """drop_path_rate 0.2 / 0.1 and one explicit generator: remat's loss and
    every gradient equal the plain run's (the keep masks are drawn before
    each checkpointed block and reused by its recomputation), and every
    attention core runs its forward twice."""
    from fourm_torch.ops import transformer as tt

    attend = tt.dot_product_attention
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return attend(*args, **kw)

    monkeypatch.setattr(tt, "dot_product_attention", counted)
    batch = synthetic.to_torch(_batch(), "cpu")
    out = {}
    for remat in (False, True):
        tm = _port(pair, remat=remat, drop_path_rate_encoder=0.2, drop_path_rate_decoder=0.1)
        calls.clear()
        loss, _ = tm(batch, NI, NT, generator=torch.Generator().manual_seed(3))
        loss.backward()
        out[remat] = (loss.detach(), {n: p.grad.clone() for n, p in tm.named_parameters()})
        assert len(calls) == (2 if remat else 1) * (1 + 2 * 1), (remat, len(calls))
    assert torch.equal(out[False][0], out[True][0])
    for n, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][n], g, rtol=0, atol=1e-7, msg=n)
    # masks drawn again inside a recomputation would differ: two draws differ
    gen = torch.Generator().manual_seed(3)
    x = torch.ones(64, 1, 1)
    assert not torch.equal(tt.draw_keep(x, 0.5, gen), tt.draw_keep(x, 0.5, gen))


def test_evaluate_matches_jax(pair):
    """The port's evaluate (inference path, train=False) against the JAX
    CLI's on the same held-out batches, at 16 + 16 tokens."""
    batches = [synthetic.synthetic_mod_batch(MODS, 2, 16, 16, seed=10 + i) for i in range(3)]
    ref = jax_cli.evaluate(pair["jm"], pair["variables"], iter(batches), 16, 16, "mod",
                           max_samples=4, global_bs=2)
    tm = _port(pair)
    got = port_cli.evaluate(tm, iter(batches), 16, 16, "mod", max_samples=4, global_bs=2,
                            device="cpu")
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=2e-5, err_msg=k)


def test_cli_data_config_cpu(tmp_path):
    """cli/train_4m.main with --data_config on tiny 4M-21 shards (and a val
    shard) on the CPU: 2 steps of the frozen phase then 2 more with layer
    decay, remat and a skip_grad no step reaches, the eval, a checkpoint;
    then a second run to step 5 resumes from step 4 with a skip_grad below
    every norm: its step is skipped, so the optimizer's count stays 4."""
    from fourm_tpu.utils.text_tokenizer import generate_sentinel_tokens
    from fourm_tpu.utils.text_tokenizer import train_unified_wordpiece_tokenizer
    from fourm_torch.utils import synthetic_shards as ss
    from fourm_torch.utils.config import dump_yaml, load_yaml

    words = "a the of on and photo cat dog grass".split()
    (tmp_path / "corpus.txt").write_text((" ".join(words) + "\n") * 20)
    tok = train_unified_wordpiece_tokenizer(str(tmp_path / "corpus.txt"), vocab_size=200,
                                            sentinel_tokens=generate_sentinel_tokens(num=100),
                                            show_progress=False)
    tok.save(str(tmp_path / "tokenizer.json"))
    run_cfg = "cfgs/default/4m/models/main/4m-b_mod21_500b.yaml"
    cfg = load_yaml(run_cfg)
    din, dout = cfg["in_domains"].split("-"), cfg["out_domains"].split("-")
    doms = sorted(set(din) | set(dout))
    kw = dict(image_size=(226, 240), t5_len=8)
    pattern = ss.write_shards(str(tmp_path / "train"), doms, 2, 2, 0, words, **kw)
    val = ss.write_shards(str(tmp_path / "val"), doms, 1, 2, 1, words, **kw)
    alphas = "cfgs/default/4m/alphas_mixture/main/mix_mod21_all2allmix_rgb2all_capT5bias.yaml"
    (tmp_path / "data.yaml").write_text(dump_yaml(ss.data_config(
        pattern, din, dout, alphas, val_pattern=val, shuffle_buffer=2)))

    def run(max_steps, skip_grad="1e6"):
        port_cli.main([
            "--config", run_cfg, "--data_config", str(tmp_path / "data.yaml"),
            "--text_tokenizer_path", str(tmp_path / "tokenizer.json"), "--device", "cpu",
            "--dtype", "float32", "--dim", "64", "--encoder_depth", "1", "--decoder_depth", "1",
            "--num_heads", "2", "--num_input_tokens", "64", "--num_target_tokens", "64",
            "--fixed_eval_input_tokens", "32", "--fixed_eval_target_tokens", "32",
            "--batch_size", "2", "--epoch_size", "4", "--frozen_model_epochs", "1",
            "--layer_decay", "0.75", "--skip_grad", skip_grad, "--remat", "--eval_size", "2",
            "--print_freq", "1", "--max_steps", str(max_steps), "--blr", "0.1",
            "--warmup_tokens", "0", "--output_dir", str(tmp_path / "out"), "--run_name", "r"])

    run(4)
    log = tmp_path / "out" / "r" / "log.txt"
    lines = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in lines if "loss" in r] == [0, 1, 2, 3]
    assert [r["step"] for r in lines if "eval_loss" in r] == [2, 4]
    assert all(np.isfinite(r.get("loss", r.get("eval_loss"))) for r in lines)
    from fourm_torch.utils.checkpoint import load_checkpoint

    assert load_checkpoint(str(tmp_path / "out" / "r" / "checkpoints"), 4)[
        "optimizer"]["count"] == 4
    run(5, skip_grad="1e-9")
    lines = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in lines if "loss" in r] == [0, 1, 2, 3, 4]
    ckpt = load_checkpoint(str(tmp_path / "out" / "r" / "checkpoints"), 5)
    assert ckpt["optimizer"]["count"] == 4 and ckpt["step"] == 5


def test_metric_logger_prints_the_jax_lines(monkeypatch, capsys):
    """SmoothedValue / MetricLogger (reference logger.py:34-182): on the same
    values, and a clock stepping alike, the port prints the JAX package's
    lines, log_every's included."""
    import time

    from fourm_tpu.utils import logger as jl
    from fourm_torch.utils import logger as tl

    values = np.random.RandomState(3).rand(30, 2) * 10
    printed = {}
    for name, mod in (("port", tl), ("jax", jl)):
        clock = iter(np.arange(0.0, 1000.0, 0.37))
        monkeypatch.setattr(time, "time", lambda: float(next(clock)))
        sv = mod.SmoothedValue(window_size=7, fmt="{median:.3f} {avg:.3f} {global_avg:.3f} "
                                                  "{max:.3f} {value:.3f}")
        ml = mod.MetricLogger(delimiter=" | ")
        lines = []
        for i, (loss, gnorm) in enumerate(ml.log_every(values, 4, header="train",
                                                        total_len=len(values))):
            sv.update(loss, n=i % 3 + 1)
            ml.update(loss=loss, grad_norm=gnorm)
            lines.append(f"{sv} / {ml} / {ml.loss.median:.6f}")
        printed[name] = (lines, capsys.readouterr().out)
    assert printed["port"] == printed["jax"]
    with pytest.raises(AttributeError):
        tl.MetricLogger().missing


def test_train_4m_log_wandb_prints_and_carries_on(tmp_path, capsys):
    """--log_wandb: the wandb writer says wandb is absent, as the JAX CLI's
    says where it is not installed, and the run trains on."""
    from fourm_torch.utils.logger import WandbLogger

    WandbLogger().log({"loss": 1.0}, step=0)  # no project: nothing
    assert capsys.readouterr().out == ""
    port_cli.main(["--device", "cpu", "--synthetic_data", "--model", "fm_tiny_6e_6d_gelu",
                   "--in_domains", "tok_clip@224-caption", "--out_domains",
                   "tok_clip@224-caption", "--dim", "64", "--num_heads", "2",
                   "--encoder_depth", "1", "--decoder_depth", "1", "--dtype", "float32",
                   "--batch_size", "2", "--num_input_tokens", "16", "--num_target_tokens", "16",
                   "--print_freq", "1", "--max_steps", "2", "--epoch_size", "2", "--eval_size", "2",
                   "--log_wandb", "--wandb_project", "fourm", "--output_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[logger] wandb disabled: No module named 'wandb'" in out
    assert "step 1/2" in out and "training done" in out
