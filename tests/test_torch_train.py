"""The port's training slice (fourm_torch) against the JAX package's
(fourm_tpu) on the CPU, in fp32, with the same weights carried over by the
weight bridge: the training forward and its loss, every gradient, the
weight-decay mask, the schedules, three train steps with clipping and
gradient accumulation, a run resumed from a JAX optimizer state, the
routing of the train path, and the CLI.

Tiny configs on the 4M-7 modality set (raw rgb@224, five image-token
modalities, caption, det): dim 64, 2 heads, 2+2 layers, in the `gelu`
flavour (biases) and the `swiglu_qknorm_nobias` flavour (the CLI's default:
QK-norm as plain ops before the attention core). The JAX side runs its XLA
path, the port its kernels' plain twins (the attention backward by its
explicit formulas). Tolerances: losses within 2e-5 (fp32, the same
arithmetic summed in other orders); each gradient leaf within 2e-6 + 1e-3 x
its largest value; parameters after each step within 2e-6, where AdamW's
first steps (lr * sign(g) for a gradient near 0) may move an entry by up to
2 lr if the two summation orders give its gradient opposite signs: at most
0.1% of the entries may differ beyond 2e-6, and none beyond 2 lr x steps."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourm_tpu.models import FourM as JaxFourM
from fourm_tpu.models import create_fourm_config as jax_config
from fourm_tpu.parallel import TrainState as JaxTrainState
from fourm_tpu.parallel import build_train_step as jax_build_train_step
from fourm_tpu.utils import optim as jax_optim
from fourm_tpu.utils import synthetic as jax_synthetic
from fourm_torch.models import FourM, create_fourm_config
from fourm_torch.ops import transformer as tt
from fourm_torch.parallel import build_train_step, init_train_state
from fourm_torch.utils import optim, synthetic
from fourm_torch.utils.checkpoint import from_jax_adam_state, from_jax_params

MODS, DEC = synthetic.MOD7_MODALITIES, synthetic.MOD7_DECODER_MODALITIES
TINY = dict(dim=64, encoder_depth=2, decoder_depth=2, num_heads=2)
FLAVORS = ["fm_base_12e_12d_gelu", "fm_base_12e_12d_swiglu_qknorm_nobias"]
NI = NT = 32
SEED = 6  # every decoder modality gets 3+ target tokens
LR = 1e-3


def _batch(B, seed=SEED):
    return synthetic.synthetic_mod_batch(MODS, B, NI, NT, seed=seed)


def _torch(np_batch):
    return synthetic.to_torch(np_batch, "cpu")


_PAIRS = {}


@pytest.fixture(scope="module", params=FLAVORS)
def pair(request):
    return _pair(request.param)


def _pair(flavor):
    """The JAX model of a flavour with its initial variables, its loss (both
    types) and gradients on the batch; the port's config. Cached."""
    if flavor not in _PAIRS:
        _PAIRS[flavor] = _make_pair(flavor)
    return _PAIRS[flavor]


def _make_pair(flavor):
    jcfg = jax_config(flavor, MODS, DEC, **TINY)
    tcfg = create_fourm_config(flavor, MODS, DEC, **TINY)
    jm = JaxFourM(jcfg)
    jbatch = jax.tree.map(jnp.asarray, _batch(2))
    variables = jax.jit(jm.init, static_argnums=(2, 3))(jax.random.key(0), jbatch, NI, NT)
    params = jax.tree.map(np.asarray, variables)["params"]

    def loss(v, lt):
        return jm.apply(v, jbatch, NI, NT, loss_type=lt, deterministic=False,
                        rngs={"dropout": jax.random.key(1)})

    (jloss, aux), grads = jax.jit(jax.value_and_grad(lambda v: loss(v, "mod"), has_aux=True))(
        variables)
    token_loss = jax.jit(lambda v: loss(v, "token")[0])(variables)
    return dict(name=flavor, jcfg=jcfg, tcfg=tcfg, jm=jm, variables=variables,
                params=params, loss={"mod": (jloss, aux), "token": token_loss},
                grads=jax.tree.map(np.asarray, grads)["params"])


def _port(pair):
    tm = FourM(pair["tcfg"])
    tm.load_state_dict(from_jax_params(pair["params"], pair["tcfg"]), strict=True)
    return tm


def test_synthetic_copy_matches_jax():
    for seed in (0, SEED):
        ours, ref = _batch(3, seed), jax_synthetic.synthetic_mod_batch(MODS, 3, NI, NT, seed=seed)
        assert ours.keys() == ref.keys()
        for m in ref:
            for k in ref[m]:
                np.testing.assert_array_equal(ours[m][k], ref[m][k])
    assert synthetic.MOD21_MODALITIES == jax_synthetic.MOD21_MODALITIES
    assert synthetic.MOD21_DECODER_MODALITIES == jax_synthetic.MOD21_DECODER_MODALITIES
    assert (MODS, DEC) == (jax_synthetic.MOD7_MODALITIES, jax_synthetic.MOD7_DECODER_MODALITIES)


@pytest.mark.parametrize("loss_type", ["mod", "token"])
def test_forward_loss_matches_jax(pair, loss_type):
    tm = _port(pair)
    loss, (mod_loss, mod_count) = tm(_torch(_batch(2)), NI, NT, loss_type=loss_type)
    if loss_type == "token":
        np.testing.assert_allclose(loss.item(), float(pair["loss"]["token"]), atol=2e-5)
        return
    ref, (ref_loss, ref_count) = pair["loss"]["mod"]
    np.testing.assert_allclose(loss.item(), float(ref), atol=2e-5)
    assert mod_loss.keys() == ref_loss.keys() == set(DEC)
    for m in DEC:
        assert int(mod_count[m]) == int(ref_count[m]) >= 3, m
        np.testing.assert_allclose(mod_loss[m].item(), float(ref_loss[m]), atol=2e-5, err_msg=m)


def test_gradients_match_jax(pair):
    """Every leaf, under every name it has (the shared mod_emb included):
    a .detach() on the train path would zero one of them."""
    tm = _port(pair)
    loss, _ = tm(_torch(_batch(2)), NI, NT)
    loss.backward()
    ref = from_jax_params(pair["grads"], pair["tcfg"])
    named = dict(tm.named_parameters(remove_duplicate=False))
    assert named.keys() == ref.keys()
    for name, p in named.items():
        r = ref[name].numpy()
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0,
                                   atol=2e-6 + 1e-3 * np.abs(r).max(), err_msg=name)


def test_weight_decay_mask_matches_jax(pair):
    """The port decides by name; JAX's mask (ndim <= 1 and name patterns)
    mapped through the weight bridge gives the same answer for every name."""
    jmask = jax_optim.weight_decay_mask(pair["params"])
    ref = from_jax_params(jax.tree.map(np.asarray, jmask), pair["tcfg"])
    ours = optim.weight_decay_mask(_port(pair))
    for name in ours:
        assert ours[name] == bool(ref[name].reshape(-1)[0]), name
    assert any(ours.values()) and not all(ours.values())


@pytest.mark.parametrize("name,kw", [
    ("cosine", dict(base_lr=3e-4, total_steps=100, warmup_steps=10, min_lr=1e-6,
                    cooldown_steps=5)),
    ("inverse_sqrt", dict(base_lr=3e-4, total_steps=100, warmup_steps=10, min_lr=1e-6,
                          cooldown_steps=20)),
    ("constant", dict(base_lr=3e-4, total_steps=100, warmup_steps=10))])
def test_schedules_match_jax(name, kw):
    ours, ref = optim.make_schedule(name, **kw), jax_optim.make_schedule(name, **kw)
    for step in (0, 1, 5, 9, 10, 11, 50, 79, 80, 81, 94, 95, 99, 100, 150):
        np.testing.assert_allclose(ours(step), float(ref(jnp.int32(step))), rtol=2e-6,
                                   err_msg=f"{name} step {step}")


_JAX_RUNS = {}


def _jax_run(pair, clip, accum, steps=3):
    """States and metrics of `steps` JAX train steps (the optax chain of
    create_optimizer) from the pair's initial parameters, cached."""
    key = (pair["name"], clip, accum)
    if key not in _JAX_RUNS:
        batch = jax.tree.map(jnp.asarray, _batch(2 * accum))
        if accum > 1:
            batch = jax.tree.map(lambda x: x.reshape((accum, -1) + x.shape[1:]), batch)
        tx = jax_optim.create_optimizer(pair["variables"], jax_optim.cosine_schedule(LR, 50, 1),
                                        clip_grad=clip)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=pair["variables"],
                              opt_state=tx.init(pair["variables"]))
        step = jax_build_train_step(pair["jm"], tx, NI, NT, grad_accum_steps=accum, donate=False)
        out = []
        for _ in range(steps):
            state, metrics = step(state, batch, jax.random.key(2))
            out.append((state, jax.tree.map(np.asarray, metrics)))
        _JAX_RUNS[key] = (batch, out)
    return _JAX_RUNS[key]


def _port_batch(jbatch):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), jbatch)


def _params_close(tm, jparams, tcfg, steps):
    ref = from_jax_params(jax.tree.map(np.asarray, jparams)["params"], tcfg)
    n_far = n_all = 0
    for name, p in tm.named_parameters():
        d = np.abs(p.detach().numpy() - ref[name].numpy())
        assert d.max() <= 2 * LR * steps + 2e-6, (name, d.max())
        n_far += int((d > 2e-6).sum())
        n_all += d.size
    assert n_far <= 1e-3 * n_all, f"{n_far} of {n_all} entries beyond 2e-6"
    return n_far


# each flavour with accumulation and without, the clip on and off: the four
# combinations over the two flavours
STEP_CASES = {FLAVORS[0]: [(None, 1), (1.0, 2)], FLAVORS[1]: [(1.0, 1), (None, 2)]}


@pytest.mark.parametrize("flavor,clip,accum", [(f, c, a) for f, cases in STEP_CASES.items()
                                               for c, a in cases])
def test_train_steps_match_jax(flavor, clip, accum):
    """Three build_train_step steps against JAX's build_train_step with the
    optax chain: loss, grad_norm and per-modality losses each step, every
    parameter after each step."""
    pair = _pair(flavor)
    batch, ref = _jax_run(pair, clip, accum)
    tm = _port(pair)
    tx = optim.create_optimizer(tm, optim.cosine_schedule(LR, 50, 1), clip_grad=clip)
    state = init_train_state(tm, tx, device="cpu")
    step = build_train_step(tm, tx, NI, NT, grad_accum_steps=accum)
    tb = _port_batch(batch)
    for i, (jstate, jmet) in enumerate(ref):
        state, metrics = step(state, tb)
        assert metrics.keys() == jmet.keys()
        for k, v in jmet.items():
            np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4, atol=2e-5,
                                       err_msg=f"step {i} {k}")
        _params_close(tm, jstate.params, pair["tcfg"], i + 1)
    assert state.step == tx.count == 3


def test_resume_from_jax_adam_state(pair):
    """Two JAX steps, then the third on the port from the JAX parameters
    and optimizer state (from_jax_adam_state): equal to JAX's third step."""
    clip, accum = STEP_CASES[pair["name"]][0]  # this flavour's run without accumulation
    batch, ref = _jax_run(pair, clip, accum)
    jstate2, _ = ref[1]
    tm = FourM(pair["tcfg"])
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jstate2.params)["params"],
                                       pair["tcfg"]))
    tx = optim.create_optimizer(tm, optim.cosine_schedule(LR, 50, 1), clip_grad=clip)
    state = init_train_state(tm, tx, device="cpu")
    adam = from_jax_adam_state(jstate2.opt_state, pair["tcfg"])
    assert adam["count"] == 2
    tx.load_state_dict(adam)
    state.step = 2
    state, metrics = build_train_step(tm, tx, NI, NT)(state, _port_batch(batch))
    np.testing.assert_allclose(float(metrics["loss"]), float(ref[2][1]["loss"]), atol=2e-5)
    _params_close(tm, ref[2][0].params, pair["tcfg"], 1)


def _tiny_port(flavor=FLAVORS[1]):
    torch.manual_seed(0)
    from fourm_torch.models import init_weights

    return init_weights(FourM(create_fourm_config(flavor, MODS, DEC, **TINY)), 0)


def test_train_path_routing(monkeypatch):
    """A train forward and backward run attention_train for every attention
    core (2 encoder + 2x2 decoder) and its backward for each, and no
    inference kernel; a generation forward runs none of attention_train."""
    from fourm_torch.kernels import attention_train as atm

    calls = []
    for name in ("attention_train", "attention", "attn_block", "mha_short", "flash_mha",
                 "ln_matmul", "ln_mlp"):
        fn = getattr(tt, name)
        monkeypatch.setattr(tt, name, lambda *a, _fn=fn, _n=name, **k: calls.append(_n)
                            or _fn(*a, **k))
    bwd = atm.attention_train_bwd_plain
    monkeypatch.setattr(atm, "attention_train_bwd_plain",
                        lambda *a, **k: calls.append("backward") or bwd(*a, **k))
    tm = _tiny_port()
    loss, _ = tm(_torch(_batch(2)), NI, NT)
    assert calls == ["attention_train"] * 6
    loss.backward()
    assert calls == ["attention_train"] * 6 + ["backward"] * 6
    calls.clear()
    md = _torch(_batch(2))
    with torch.no_grad():
        tm.forward_generation_img(md, "tok_depth@224", torch.ones(2, 196, dtype=torch.bool))
    assert calls and "attention_train" not in calls and "backward" not in calls


def test_drop_path():
    x = torch.randn(6, 5, 4)
    assert tt.drop_path(x, 0.3, False) is x and tt.drop_path(x, 0.0, True) is x
    out = tt.drop_path(x, 0.3, True, torch.Generator().manual_seed(5))
    keep = torch.rand((6, 1, 1), generator=torch.Generator().manual_seed(5)) < 0.7
    torch.testing.assert_close(out, torch.where(keep, x / 0.7, 0.0), rtol=0, atol=0)
    cfg = create_fourm_config(FLAVORS[0], MODS, DEC, **TINY, drop_path_rate_encoder=0.2,
                              drop_path_rate_decoder=0.1)
    jm = JaxFourM(jax_config(FLAVORS[0], MODS, DEC, **TINY, drop_path_rate_encoder=0.2,
                             drop_path_rate_decoder=0.1))
    for shared in (False, True):
        c = cfg.__class__(**{**cfg.__dict__, "shared_drop_path": shared})
        tm = FourM(c)
        jb = JaxFourM(jm.config.__class__(**{**jm.config.__dict__, "shared_drop_path": shared}))
        bound = jb.bind(_pair(FLAVORS[0])["variables"])  # the rates change no parameter
        rates = [b.drop_path.drop_prob for b in (*tm.encoder, *tm.decoder)]
        ref = [b.drop_path_rate for b in (*bound.encoder, *bound.decoder)]
        np.testing.assert_allclose(rates, ref, rtol=0, atol=0)


def test_what_is_not_ported_raises():
    tm = _tiny_port()
    sched = optim.constant_schedule(1e-3)
    for kw in (dict(skip_grad=5.0), dict(frozen_mask={}), dict(layer_decay=0.75)):
        with pytest.raises(NotImplementedError):
            optim.create_optimizer(tm, sched, **kw)
    tx = optim.create_optimizer(tm, sched)
    with pytest.raises(NotImplementedError):
        init_train_state(tm, tx, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError):
        build_train_step(tm, tx, NI, NT, mesh=object())
    remat = FourM(create_fourm_config(FLAVORS[0], MODS, DEC, **TINY, remat=True))
    with pytest.raises(NotImplementedError, match="remat"):
        remat(_torch(_batch(2)), NI, NT)


def test_train_entry_needs_the_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    tm = _tiny_port()
    tx = optim.create_optimizer(tm, optim.constant_schedule(1e-3))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(tm, tx)
    from fourm_torch.cli.train_4m import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model", FLAVORS[0], "--dim", "64", "--encoder_depth", "1",
              "--decoder_depth", "1", "--num_heads", "2", "--max_steps", "1"])


def test_cli_cpu_synthetic(tmp_path):
    from fourm_torch.cli.train_4m import main

    main(["--model", FLAVORS[1], "--dim", "64", "--encoder_depth", "2", "--decoder_depth", "2",
          "--num_heads", "2", "--in_domains", "tok_rgb@224-caption", "--out_domains",
          "tok_rgb@224-caption", "--synthetic_data", "--batch_size", "2",
          "--num_input_tokens", "32", "--num_target_tokens", "32", "--total_tokens", "0.0001",
          "--warmup_tokens", "0.00001", "--max_steps", "3", "--print_freq", "1",
          "--output_dir", str(tmp_path), "--run_name", "t", "--device", "cpu"])
    lines = [json.loads(line) for line in (tmp_path / "t" / "log.txt").read_text().splitlines()]
    assert [r["step"] for r in lines] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in lines)
    cfg = json.loads((tmp_path / "t" / "config.json").read_text())
    assert cfg["dim"] == 64 and cfg["encoder_modalities"] == ["caption", "tok_rgb@224"]
