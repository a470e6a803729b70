"""Training over a (data, fsdp, tensor) mesh in the port (fourm_torch/parallel:
mesh.py, shard.py, train.py) against the JAX package's mesh (fourm_tpu/
parallel) on the CPU, in fp32, at the tiny 4M-7 config of
tests/test_torch_train.py (dim 64, 2 heads, 2 + 2 layers; weights carried
over by from_jax_params).

  * The rules, with no process group: the port's fsdp dim of every leaf of
    the tiny model and of odd shapes equals JAX's fsdp_sharding_for on a
    2- and a 4-device mesh (through the weight bridge's names and
    transposes); its tensor dims equal JAX's TENSOR_RULES on the blocks,
    XL's SwiGLU hidden of 5461 included (replicated at tensor 4), and differ
    where stated (the embeddings stay whole; an attention whose heads the
    tensor size does not divide stays whole); make_mesh's errors are JAX's.
  * A world-2 gloo group (tests/_parallel_child.py; one spawn for the file):
    three steps of build_train_step at data=2 (on batches whose ranks hold
    different per-modality counts), fsdp=2 (with gradient accumulation 2)
    and tensor=2 (both flavours: biases added once, the QK-norm weights'
    gradients summed over the heads' ranks) against JAX's build_train_step
    on the matching 2-device mesh; the frozen-trunk mask with the clip and
    skip_grad against JAX's; two steps with layer scales (fsdp 2) and with
    drop-path 0.5 (data 2) against the port on one process (JAX draws other
    masks, and its create_optimizer scales layers in another order:
    ROADMAP); the uneven batch's average of the ranks' own losses misses the
    global loss by far more than the tolerance (a step that averaged them
    would fail here); an fsdp checkpoint written at world 2 resumed at world
    2 (bit for bit) and at world 1; the tensor-parallel
    forward_generation_img against JAX's unsharded forward, each rank's
    parameter bytes below the whole.
Tolerances: losses and grad norms within rtol 1e-5 / atol 1e-6 (gloo and
XLA sum in other orders; the grad norm is summed in fp64 per leaf);
parameters as tests/test_torch_train.py (within 2e-6, at most 0.1% of
entries beyond, none beyond 2 lr x steps: the QK-norm's key bias, whose
gradient the softmax cancels, has a gradient of rounding noise that Adam's
first steps turn into up to lr either way); logits within 1e-4.
"""

import _torch_threads  # noqa: F401  (torch's threads in xdist workers)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _parallel_child import spawn
from fourm_tpu.models import FourM as JaxFourM
from fourm_tpu.models import create_fourm_config as jax_config
from fourm_tpu.parallel import TrainState as JaxTrainState
from fourm_tpu.parallel import build_train_step as jax_build_train_step
from fourm_tpu.parallel import frozen_trunk_mask as jax_frozen_trunk_mask
from fourm_tpu.parallel import mesh as jmesh
from fourm_tpu.utils import optim as jax_optim
from fourm_torch.models import FourM, create_fourm_config
from fourm_torch.parallel import build_train_step, init_train_state, make_mesh
from fourm_torch.parallel import mesh as tmesh
from fourm_torch.utils import optim, synthetic
from fourm_torch.utils.checkpoint import from_jax_params

MODS, DEC = synthetic.MOD7_MODALITIES, synthetic.MOD7_DECODER_MODALITIES
TINY = dict(dim=64, encoder_depth=2, decoder_depth=2, num_heads=2)
GELU, QKNORM = "fm_base_12e_12d_gelu", "fm_base_12e_12d_swiglu_qknorm_nobias"
NI = NT = 32
LR = 1e-3
SCHED = (LR, 50, 1)
B = 4  # the global batch: 2 rows a rank


def _batch(seed, n=B):
    return synthetic.synthetic_mod_batch(MODS, n, NI, NT, seed=seed)


def _uneven_batch(seed):
    """A global batch whose two halves (the ranks' rows at data 2) hold
    different per-modality target counts: no caption targets in the first
    half, no depth targets in the second."""
    b = _batch(seed)
    b["caption"]["target_mask"][:B // 2] = True
    b["tok_depth@224"]["target_mask"][B // 2:] = True
    return b


_PAIRS = {}


def _pair(flavor):
    if flavor not in _PAIRS:
        jm = JaxFourM(jax_config(flavor, MODS, DEC, **TINY))
        variables = jax.jit(jm.init, static_argnums=(2, 3))(
            jax.random.key(0), jax.tree.map(jnp.asarray, _batch(6, 2)), NI, NT)
        tcfg = create_fourm_config(flavor, MODS, DEC, **TINY)
        state = from_jax_params(jax.tree.map(np.asarray, variables)["params"], tcfg)
        _PAIRS[flavor] = dict(jm=jm, variables=variables, tcfg=tcfg, state=state)
    return _PAIRS[flavor]


# ------------------------------------------------------------------ rules

def _port_dims_of(jax_tree, axis_of, tcfg):
    """{port name: the dim along which the leaf of JAX axis `axis_of(path,
    leaf)` varies after the weight bridge}, None where JAX gives no axis."""
    def mark(path, leaf):
        a = axis_of(path, leaf)
        if a is None:
            return np.zeros(leaf.shape, np.float32)
        shape = [1] * leaf.ndim
        shape[a] = leaf.shape[a]
        return np.broadcast_to(np.arange(leaf.shape[a], dtype=np.float32).reshape(shape),
                               leaf.shape).copy()

    marked = jax.tree_util.tree_map_with_path(mark, jax_tree)
    out = {}
    for name, t in from_jax_params(marked, tcfg).items():
        dims = [d for d in range(t.ndim) if t.shape[d] > 1 and
                bool((t.diff(dim=d) != 0).any())]
        assert len(dims) <= 1, (name, dims)
        out[name] = dims[0] if dims else None
    return out


def _spec_axis(spec, name):
    axes = [i for i, s in enumerate(spec) if s == name or (isinstance(s, tuple) and name in s)]
    return axes[0] if axes else None


def _linear_names(model):
    return {f"{n}.weight" for n, m in model.named_modules() if isinstance(m, torch.nn.Linear)}


@pytest.mark.parametrize("fsdp", [2, 4])
def test_fsdp_rule_matches_jax(fsdp):
    pair = _pair(QKNORM)
    params = jax.tree.map(np.asarray, pair["variables"])["params"]
    mesh = jmesh.make_mesh(data=1, fsdp=fsdp, devices=jax.devices()[:fsdp])

    def axis_of(path, leaf):
        return _spec_axis(jmesh.fsdp_sharding_for(
            mesh, jax.ShapeDtypeStruct(leaf.shape, leaf.dtype)).spec, "fsdp")

    ref = _port_dims_of(params, axis_of, pair["tcfg"])
    model = FourM(pair["tcfg"])
    linear = _linear_names(model)
    named = dict(model.named_parameters(remove_duplicate=False))
    assert set(named) <= set(ref)
    for name, p in named.items():
        got = tmesh.fsdp_dim(p.shape, fsdp, transposed=name in linear and p.ndim == 2)
        assert got == ref[name], (name, tuple(p.shape), got, ref[name])
    # odd shapes, untransposed: ties, indivisible and small dims
    for shape in [(7,), (8,), (3, 8), (8, 8), (6, 4), (2, 2), (1, 1, 16), (5, 7), (16, 16, 3),
                  (4, 12, 12), ()]:
        want = _spec_axis(jmesh.fsdp_sharding_for(
            mesh, jax.ShapeDtypeStruct(shape, jnp.float32)).spec, "fsdp")
        assert tmesh.fsdp_dim(shape, fsdp) == want, (shape, want)


def test_tensor_rules_match_jax():
    """tensor=2 on the tiny model: every block weight the JAX rules split
    the port splits on the mapped dim; the token embeddings (JAX: width
    split) stay whole. XL's shapes at tensor 4: qkv, q, kv, proj split;
    SwiGLU's fc1 / fc3 / fc2 of hidden 5461 whole in both; an attention of
    6 heads at tensor 4 whole in the port, split in JAX (its 3C columns
    divide)."""
    pair = _pair(GELU)
    params = jax.tree.map(np.asarray, pair["variables"])["params"]
    mesh = jmesh.make_mesh(data=1, fsdp=1, tensor=2, devices=jax.devices()[:2])

    def axis_of(path, leaf):
        return _spec_axis(jmesh.tensor_sharding_for(mesh, "params/" + jmesh._path_str(path),
                                                    leaf).spec, "tensor")

    ref = _port_dims_of(params, axis_of, pair["tcfg"])
    model = FourM(pair["tcfg"])
    hidden = 256  # dim 64 x mlp_ratio 4
    for name, p in model.named_parameters(remove_duplicate=False):
        got = tmesh.tensor_dim(name, 2, 2, hidden)
        if name.startswith(("encoder_embeddings.", "decoder_embeddings.")):
            assert got is None, name  # the port keeps the embeddings whole (JAX splits
            continue                  # token_emb's width and the patch proj's input)
        assert got == ref[name], (name, got, ref[name])
    # XL widths at tensor 4 (shapes only; JAX paths in its layout)
    mesh4 = jmesh.make_mesh(data=1, fsdp=1, tensor=4, devices=jax.devices()[:4])
    C, H, HID = 2048, 32, 5461
    cases = [("encoder_0/attn/qkv/kernel", (C, 3 * C), "encoder.0.attn.qkv.weight", H, 0),
             ("decoder_0/cross_attn/kv/kernel", (C, 2 * C), "decoder.0.cross_attn.kv.weight",
              H, 0),
             ("decoder_0/cross_attn/q/kernel", (C, C), "decoder.0.cross_attn.q.weight", H, 0),
             ("encoder_0/attn/proj/kernel", (C, C), "encoder.0.attn.proj.weight", H, 1),
             ("encoder_0/mlp/fc1/kernel", (C, HID), "encoder.0.mlp.fc1.weight", H, None),
             ("encoder_0/mlp/fc3/kernel", (C, HID), "encoder.0.mlp.fc3.weight", H, None),
             ("encoder_0/mlp/fc2/kernel", (HID, C), "encoder.0.mlp.fc2.weight", H, None)]
    for jpath, jshape, name, heads, want in cases:
        spec = jmesh.tensor_sharding_for(mesh4, "params/" + jpath,
                                         jax.ShapeDtypeStruct(jshape, jnp.float32)).spec
        jax_axis = _spec_axis(spec, "tensor")
        assert (None if jax_axis is None else 1 - jax_axis) == want, jpath
        assert tmesh.tensor_dim(name, 4, heads, HID) == want, name
    # 6 heads of 64 at tensor 4: JAX splits the 1152 qkv columns, the port
    # cannot give each rank whole heads and keeps the attention whole
    spec = jmesh.tensor_sharding_for(mesh4, "params/encoder_0/attn/qkv/kernel",
                                     jax.ShapeDtypeStruct((384, 1152), jnp.float32)).spec
    assert _spec_axis(spec, "tensor") == 1
    assert tmesh.tensor_dim("encoder.0.attn.qkv.weight", 4, 6, 1536) is None


def test_make_mesh_errors_are_jax_s():
    for kw in (dict(fsdp=3), dict(data=2, fsdp=2), dict(tensor=16), dict(data=3, tensor=2)):
        with pytest.raises(ValueError) as jerr:
            jmesh.make_mesh(**kw)  # over the 8 CPU devices of tests/conftest.py
        with pytest.raises(ValueError) as terr:
            tmesh.mesh_shape(8, **kw)
        assert str(terr.value) == str(jerr.value), kw
    assert tmesh.mesh_shape(8, fsdp=2, tensor=2) == (2, 2, 2)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()  # no group in this process
    with pytest.raises(ValueError, match="mesh 1x1x2 != 1 devices"):
        make_mesh(data=1, tensor=2)


# ----------------------------------------------------------- world 2

def _jax_mesh_run(pair, mesh_kw, tx, batches, accum=1, trainable_mask=None):
    mesh = jmesh.make_mesh(**mesh_kw, devices=jax.devices()[:2])
    v = pair["variables"]
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=v, opt_state=tx.init(v))
    shardings = jmesh.model_shardings(mesh, state)
    state = jax.device_put(state, shardings)
    step = jax_build_train_step(pair["jm"], tx, NI, NT, grad_accum_steps=accum, mesh=mesh,
                                state_shardings=shardings, donate=False,
                                trainable_mask=trainable_mask)
    out = []
    for b in batches:
        jb = jax.tree.map(jnp.asarray, b)
        if accum > 1:
            jb = jax.tree.map(lambda x: x.reshape((accum, -1) + x.shape[1:]), jb)
        state, m = step(state, jb, jax.random.key(2))
        out.append({k: float(x) for k, x in m.items()})
    return out, jax.tree.map(np.asarray, state.params)["params"], state


def _job(name, flavor, mesh, batches, **kw):
    pair = _pair(flavor)
    return dict(kind="train", name=name, flavor=flavor, mods=MODS, dec=DEC, config=TINY,
                state=pair["state"], mesh=mesh, sched=SCHED, batches=batches, ni=NI, nt=NT,
                **kw)


def _global_norms(pair, batches, mask):
    """JAX's global norm of the masked gradient at the start, a batch each."""
    jm, v = pair["jm"], pair["variables"]

    @jax.jit
    def norm(b):
        g = jax.grad(lambda p: jm.apply(p, b, NI, NT, deterministic=False,
                                        rngs={"dropout": jax.random.key(2)})[0])(v)
        return optax.global_norm(jax.tree.map(lambda a, m: a * m, g, mask))

    return [float(norm(jax.tree.map(jnp.asarray, b))) for b in batches]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every world-2 job of this file, run in one spawn; and the inputs the
    checks need."""
    seeds = [6, 7, 8]
    batches = [_batch(s) for s in seeds]
    acc_batches = [_batch(s, 2 * B) for s in seeds]
    uneven = [_uneven_batch(s) for s in seeds]
    qk = _pair(QKNORM)
    frozen_mask = jax_frozen_trunk_mask(qk["variables"])
    norms = sorted(zip(_global_norms(qk, [_batch(6), _batch(7)], frozen_mask), (6, 7)),
                   reverse=True)
    threshold = 0.5 * (norms[0][0] + norms[1][0])
    skip_seeds = [norms[0][1], norms[1][1], norms[0][1]]
    jobs = [
        _job("data", GELU, dict(data=2), uneven, opt=dict(clip_grad=1.0), counts=True),
        _job("fsdp", QKNORM, dict(data=1, fsdp=2), acc_batches, accum=2, probe=True),
        _job("tensor_gelu", GELU, dict(data=1, tensor=2), batches, opt=dict(clip_grad=1.0)),
        _job("tensor_qknorm", QKNORM, dict(data=1, tensor=2), batches),
        _job("frozen_skip", QKNORM, dict(data=2), [_batch(s) for s in skip_seeds],
             opt=dict(clip_grad=1.0, skip_grad=threshold, frozen_trunk=True)),
        _job("layer_decay", QKNORM, dict(data=1, fsdp=2), batches[:2],
             opt=dict(clip_grad=1.0, layer_decay=0.75), save_after=1),
        _job("drop_path", QKNORM, dict(data=2), batches[:2], gen_seed=5),
        _job("resume", QKNORM, dict(data=1, fsdp=2), batches[1:2], resume_from="layer_decay",
             opt=dict(clip_grad=1.0, layer_decay=0.75)),
    ]
    jobs[6]["config"] = dict(TINY, drop_path_rate_encoder=0.5, drop_path_rate_decoder=0.5)
    jobs += [
        _job("bits_fsdp", GELU, dict(data=1, fsdp=2), uneven, probe=True),
        _job("bits_data", GELU, dict(data=2), uneven),
        _job("share_remat", QKNORM, dict(data=1, fsdp=2), batches[:2], probe=True),
        dict(kind="born", name="born", flavor=QKNORM, mods=MODS, dec=DEC, config=TINY,
             mesh=dict(data=1, fsdp=2), sched=SCHED, seed=3),
        dict(_job("eval", QKNORM, dict(data=1, fsdp=2), []), kind="eval",
             batch=_uneven_batch(9)),
    ]
    jobs[-3]["config"] = dict(TINY, remat=True)
    md, target, sa = _forward_inputs()
    jobs.append(dict(kind="forward", name="tp_forward", flavor=QKNORM, mods=MODS, dec=DEC,
                     config=TINY, state=_pair(QKNORM)["state"], mesh=dict(data=1, tensor=2),
                     mod_dict=md, target=target, sa_keys_valid=sa))
    res = spawn(tmp_path_factory.mktemp("world2"), jobs)
    return dict(res=res, batches=batches, acc_batches=acc_batches, uneven=uneven,
                skip_seeds=skip_seeds,
                threshold=threshold, frozen_mask=frozen_mask, jobs={j["name"]: j for j in jobs})


def _forward_inputs():
    batch = _batch(9, 2)
    sa = np.random.RandomState(4).rand(2, 196) > 0.3
    return batch, "tok_depth@224", sa


def _params_close(full_state, jparams, tcfg, steps):
    ref = from_jax_params(jparams, tcfg)
    n_far = n_all = 0
    for name, p in full_state.items():
        if name not in ref:
            continue
        d = np.abs(p.numpy() - ref[name].numpy())
        assert d.max() <= 2 * LR * steps + 2e-6, (name, d.max())
        n_far += int((d > 2e-6).sum())
        n_all += d.size
    assert n_far <= 1e-3 * n_all, f"{n_far} of {n_all} entries beyond 2e-6"


def _metrics_close(got, ref, keys=("loss", "grad_norm")):
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        for k in keys:
            np.testing.assert_allclose(g[k], r[k], rtol=1e-5, atol=1e-6, err_msg=f"step {i} {k}")


@pytest.mark.parametrize("name,flavor,mesh,clip,accum", [
    ("data", GELU, dict(data=2), 1.0, 1),
    ("fsdp", QKNORM, dict(data=1, fsdp=2), None, 2),
    ("tensor_gelu", GELU, dict(data=1, tensor=2), 1.0, 1),
    ("tensor_qknorm", QKNORM, dict(data=1, tensor=2), None, 1)])
def test_mesh_steps_match_jax(world2, name, flavor, mesh, clip, accum):
    pair = _pair(flavor)
    tx = jax_optim.create_optimizer(pair["variables"], jax_optim.cosine_schedule(*SCHED),
                                    clip_grad=clip)
    batches = world2["jobs"][name]["batches"]
    ref, jparams, _ = _jax_mesh_run(pair, mesh, tx, batches, accum)
    got = world2["res"][name]
    _metrics_close(got["metrics"], ref)
    if accum == 1:  # per-modality losses (JAX reports them without accumulation)
        _metrics_close(got["metrics"], ref, [k for k in ref[0] if k.startswith("loss_")])
    _params_close(got["full"][0], jparams, pair["tcfg"], 3)
    assert got["count"] == 3


def test_frozen_mask_clip_and_skip_match_jax(world2):
    pair = _pair(QKNORM)
    tx = jax_optim.create_optimizer(pair["variables"], jax_optim.cosine_schedule(*SCHED),
                                    clip_grad=1.0, skip_grad=world2["threshold"])
    batches = [_batch(s) for s in world2["skip_seeds"]]
    ref, jparams, _ = _jax_mesh_run(pair, dict(data=2), tx, batches,
                                    trainable_mask=world2["frozen_mask"])
    got = world2["res"]["frozen_skip"]
    _metrics_close(got["metrics"], ref)
    skipped = [m["grad_norm"] > world2["threshold"] for m in got["metrics"]]
    assert skipped[:2] == [True, False]
    assert got["count"] == 3 - sum(skipped)
    _params_close(got["full"][0], jparams, pair["tcfg"], 3)
    start = world2["jobs"]["frozen_skip"]["state"]
    for name, t in got["full"][0].items():  # the trunk stays bit for bit
        if name.startswith(("encoder.", "decoder.", "encoder_norm", "decoder_norm")):
            assert torch.equal(t, start[name]), name


def _single(job, steps_from=None):
    """The job on one process (no mesh): metrics and the final state."""
    pair = _pair(job["flavor"])
    model = FourM(create_fourm_config(job["flavor"], MODS, DEC, **job["config"]))
    model.load_state_dict(pair["state"])
    opt = dict(job.get("opt", {}))
    tx = optim.create_optimizer(model, optim.cosine_schedule(*SCHED), **opt)
    state = init_train_state(model, tx, device="cpu")
    if steps_from is not None:
        m_sd, o_sd = steps_from
        model.load_state_dict(m_sd)
        tx.load_state_dict(o_sd)
    step = build_train_step(model, tx, NI, NT)
    gen = None if job.get("gen_seed") is None else torch.Generator().manual_seed(job["gen_seed"])
    out = []
    for b in job["batches"]:
        state, m = step(state, synthetic.to_torch(b, "cpu"), gen)
        out.append({k: float(v) for k, v in m.items()})
    return out, {n: p.detach() for n, p in model.named_parameters()}


@pytest.mark.parametrize("name", ["layer_decay", "drop_path"])
def test_world2_equals_one_process(world2, name):
    """Layer scales (at fsdp 2) and drop-path 0.5 (at data 2, the global
    batch's masks from one generator): world 2 against the same run on one
    process, which tests/test_torch_train*.py hold to JAX."""
    job = world2["jobs"][name]
    ref, params = _single(job)
    got = world2["res"][name]
    # the step's grad norm on one process is torch's fp32 sum (1e-4 off on
    # the CPU for the embeddings' million-row gradients, see shard.py)
    _metrics_close(got["metrics"], ref, ("loss",))
    for m, r in zip(got["metrics"], ref):
        np.testing.assert_allclose(m["grad_norm"], r["grad_norm"], rtol=1e-3)
    far = sum(int((got["full"][0][n] - p).abs().gt(2e-6).sum()) for n, p in params.items())
    assert far <= 1e-3 * sum(p.numel() for p in params.values())
    if name == "drop_path":  # the masks drop something: not the run without drop-path
        plain, _ = _single(dict(job, config=TINY, gen_seed=None))
        assert max(abs(p["loss"] - r["loss"]) for p, r in zip(plain, ref)) > 1e-3


def test_uneven_modality_counts(world2):
    """The data job's first batch gives the two ranks different counts of
    some modality; the ranks' own mean losses, averaged, miss the global
    loss (JAX's, and the port's over the mesh) by far more than the
    tolerance."""
    per_rank = world2["res"]["data"]["counts"]
    counts = [r["counts"] for r in per_rank]
    assert any(counts[0][m] != counts[1][m] for m in counts[0]), counts
    averaged = np.mean([r["loss"] for r in per_rank])
    got = world2["res"]["data"]["metrics"][0]["loss"]
    pair = _pair(GELU)
    tx = jax_optim.create_optimizer(pair["variables"], jax_optim.cosine_schedule(*SCHED),
                                    clip_grad=1.0)
    ref, _, _ = _jax_mesh_run(pair, dict(data=2), tx, world2["uneven"][:1])
    np.testing.assert_allclose(got, ref[0]["loss"], rtol=1e-5, atol=1e-6)
    assert abs(averaged - ref[0]["loss"]) > 100 * (1e-6 + 1e-5 * abs(ref[0]["loss"]))


def test_fsdp_checkpoint_resumes_at_world_2_and_1(world2):
    """One fsdp=2 step (layer scales and the clip on), whole tensors
    gathered on rank 0; the second step resumed from them at world 2 equals
    the uninterrupted run's bit for bit, and on one process within the
    tolerance."""
    res = world2["res"]
    second = res["layer_decay"]["metrics"][1]
    assert res["resume"]["metrics"][0] == second
    for name, t in res["layer_decay"]["full"][0].items():
        assert torch.equal(t, res["resume"]["full"][0][name]), name
    m_sd, o_sd = res["layer_decay"]["saved"]
    assert o_sd["count"] == 1 and set(m_sd) == set(FourM(_pair(QKNORM)["tcfg"]).state_dict())
    one, params = _single(dict(world2["jobs"]["resume"]), steps_from=(m_sd, o_sd))
    np.testing.assert_allclose(one[0]["loss"], second["loss"], rtol=1e-5, atol=1e-6)
    far = sum(int((res["layer_decay"]["full"][0][n] - p).abs().gt(2e-6).sum())
              for n, p in params.items())
    assert far <= 1e-3 * sum(p.numel() for p in params.values())


def test_tensor_parallel_forward_matches_jax(world2):
    pair = _pair(QKNORM)
    md, target, sa = _forward_inputs()
    ref = pair["jm"].apply(pair["variables"], jax.tree.map(jnp.asarray, md), target,
                           jnp.asarray(sa), None, method="forward_generation_img")
    got = world2["res"]["tp_forward"]
    assert got["logits"].shape == ref.shape
    np.testing.assert_allclose(got["logits"], np.asarray(ref), atol=1e-4, rtol=1e-4)
    whole = sum(t.numel() * 4 for t in pair["state"].values()) - sum(
        t.numel() * 4 for n, t in pair["state"].items() if n.startswith("decoder_embeddings")
        and n.endswith("mod_emb") and n.replace("decoder_", "encoder_") in pair["state"])
    for b in got["bytes"]:
        assert b["parameters"] < whole, (b, whole)
    # each split attention holds one of the two heads
    assert got["split_heads"] and set(got["split_heads"]) == {1}


# ------------------------------------------- fsdp: parameters held in chunks

UNITS = 1 + 2 + 2 + len(MODS) + len(DEC)  # root, blocks, embedding modules


@pytest.mark.parametrize("name", ["fsdp", "bits_fsdp", "share_remat"])
def test_fsdp_holds_a_share(world2, name):
    """After init and after every step (accumulation 2; remat off; remat
    on), every rank's sharded parameters hold no storage above their
    chunk's bytes and no gradient; during each step at most two units and
    the root were whole at once."""
    probes = world2["res"][name]["probes"]
    steps = len(world2["jobs"][name]["batches"])
    assert len(probes) == 2 and all(len(p) == steps + 1 for p in probes)
    for rank, per_rank in enumerate(probes):
        for i, p in enumerate(per_rank):
            assert p["sharded"] > 0 and p["units"] == UNITS, (rank, i, p)
            assert p["over_chunk"] == [] and p["with_grad"] == [], (rank, i, p)
            assert p["whole_now"] == [], (rank, i, p)
            if i:
                assert 2 <= p["peak_whole_units"] <= 3, (rank, i, p)


def test_fsdp_equals_data_parallel_bit_for_bit(world2):
    """fsdp 2 and data 2 on the same uneven batches, no clip, no skip: the
    two ranks' gradients meet in a reduce-scatter or an all-reduce, a + b
    either way, so the losses and every master after 3 steps are equal bit
    for bit (a wrong chunk <-> gather mapping is not rounding)."""
    fsdp, data = world2["res"]["bits_fsdp"], world2["res"]["bits_data"]
    assert [m["loss"] for m in fsdp["metrics"]] == [m["loss"] for m in data["metrics"]]
    for k in fsdp["metrics"][0]:
        if k.startswith("loss_"):
            assert [m[k] for m in fsdp["metrics"]] == [m[k] for m in data["metrics"]], k
    start = world2["jobs"]["bits_fsdp"]["state"]
    moved = 0
    for name, t in data["full"][0].items():
        assert torch.equal(fsdp["full"][0][name], t), name
        moved += int(name in start and not torch.equal(t, start[name]))
    assert moved > 0.9 * len(start)
    for k in ("mu", "nu"):
        for name, t in data["full"][1][k].items():
            assert torch.equal(fsdp["full"][1][k][name], t), (k, name)


def test_fsdp_born_sharded_init(world2):
    """A model built under meta_params and born sharded by init_train_state
    (seed 3): each rank's masters equal init_weights(seed 3) of the whole
    model, chunked, bit for bit; the buffers are the whole model's; no
    sharded parameter holds storage."""
    res = world2["res"]["born"]
    for n_equal, n, buffers in res["equal"]:
        assert n_equal == n > 0 and buffers
    for p in res["probe"]:
        assert p["over_chunk"] == [] and p["whole_now"] == [] and p["sharded"] > 0


def test_fsdp_eval_forward(world2):
    """The eval forward (train=False, no gradient) at fsdp 2, each rank on
    its rows, the global loss over the all-reduced counts: within 1e-6 of
    one process on the whole batch; no unit left whole; DecoderBlock.step,
    cross_kv and FourM.forward_generation_img raise ShardedUnitError."""
    res = world2["res"]["eval"]
    pair = _pair(QKNORM)
    model = FourM(pair["tcfg"])
    model.load_state_dict(pair["state"])
    with torch.no_grad():
        loss, (mod_loss, _) = model(synthetic.to_torch(world2["jobs"]["eval"]["batch"], "cpu"),
                                    NI, NT, train=False)
    np.testing.assert_allclose(res["loss"], float(loss), rtol=0, atol=1e-6)
    for m, v in mod_loss.items():
        np.testing.assert_allclose(res["mod_loss"][m], float(v), rtol=0, atol=1e-6, err_msg=m)
    for p in res["probe"]:
        assert p["whole_now"] == [] and p["over_chunk"] == [] and p["peak_whole_units"] <= 3
    for raised in res["raised"]:
        assert "DecoderBlock.step (decoder.0)" in raised["step"]
        assert "DecoderBlock.cross_kv (decoder.0)" in raised["cross_kv"]
        assert "FourM.forward_generation_img (the root)" in raised["forward_generation_img"]
