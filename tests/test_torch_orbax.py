"""The JAX package's orbax run directories read and written by the port
(fourm_torch/native/zstd_decode.cpp, utils/orbax.py, the weight bridge of
utils/checkpoint.py and every entry point that takes a run directory),
against the JAX package on the CPU.

  * `decode_zstd` equals `zstandard` on hypothesis-drawn buffers (runs,
    noise, small alphabets, floats; up to 300 KB, so several blocks) at
    levels 1, 3, 19 and 22, with and without the content size and the
    checksum, one to three frames with skippable frames between them; a
    corrupted checksum and a dictionary frame raise;
  * `read_orbax_tree` on directories that fourm_tpu's save_checkpoint
    wrote (a FourM's params; a JAX TrainState with create_optimizer's AdamW
    chain; a VQ's params and codebook; bf16, f16, int32, int64, bool and
    scalar leaves, values inline and indirect; a TrainState sharded over
    the 8-device CPU mesh at fsdp 4, so that arrays arrive in several
    chunks): every leaf equal, bit for bit, to `jax.tree.map(np.asarray,
    state)`; a prefix reads only its subtree; the fixtures of
    tests/orbax_fixtures equal their expected arrays;
  * `write_orbax_tree` restored bit for bit by the JAX package's
    `load_checkpoint`, a TrainState of `to_jax_train_state` into the JAX
    TrainState of create_optimizer's chain; `to_jax_params` and
    `from_jax_params` inverse both ways; `from_jax_adam_state` on a state
    read back;
  * end to end on JAX-written run directories (FourM at dim 64, 1 + 1
    blocks; vit_t tokenizers at 32 px): `load_fm` within 1e-4 of the JAX
    model's logits and its tokens at temperature 0; `train_4m --finetune`
    and auto-resume with the JAX masters, moments and count bit for bit;
    `get_image_tokenizer`, `save_vq_tokens --ckpt_dir` and
    `train_vqcontrolnet --vq_ckpt` with the JAX package's tokens and
    frozen weights exactly; `--teacher_ckpt` (OpenAI CLIP and DINOv2
    layouts, 2 blocks at width 32, as .safetensors, .pth and .npz) with
    the JAX teacher's features within 1e-5.
"""

import _torch_threads  # noqa: F401  (torch's threads in xdist workers)
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _jax_leaves import init_variables
from fourm_tpu.cli import save_vq_tokens as jsave
from fourm_tpu.generate import GenerationSampler as JaxGenerationSampler
from fourm_tpu.models import FourM as JaxFourM
from fourm_tpu.models import create_fourm_config as jax_config
from fourm_tpu.parallel.mesh import make_mesh, params_shardings
from fourm_tpu.parallel.train import TrainState
from fourm_tpu.utils import checkpoint as jck
from fourm_tpu.utils.optim import create_optimizer
from fourm_tpu.utils.synthetic import synthetic_mod_batch
from fourm_tpu.vq import VQ as JaxVQ
from fourm_tpu.vq import VQVAE as JaxVQVAE
from fourm_tpu.vq import VQControlNet as JaxVQControlNet
from fourm_tpu.vq import get_image_tokenizer as jax_get_image_tokenizer
from fourm_tpu.vq import teachers as jteachers
from fourm_tpu.vq import vit_models as jvit
from fourm_torch.cli import save_vq_tokens as tsave
from fourm_torch.cli import train_vqcontrolnet as tcn
from fourm_torch.cli.generate import load_fm
from fourm_torch.cli.train_4m import load_finetune_weights, restore_checkpoint
from fourm_torch.cli.train_4m import main as train_main
from fourm_torch.generate import GenerationSampler
from fourm_torch.models import FourM, create_fourm_config
from fourm_torch.native import decode_zstd
from fourm_torch.parallel import init_train_state
from fourm_torch.utils import checkpoint as tck
from fourm_torch.utils.optim import create_optimizer as t_create_optimizer
from fourm_torch.utils.optim import make_schedule
from fourm_torch.utils.orbax import read_orbax_tree, write_orbax_tree
from fourm_torch.vq import teachers as tteachers
from fourm_torch.vq import vit_models as tvit
from fourm_torch.vq.loader import get_image_tokenizer

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "orbax_fixtures")
NAME = "fm_base_12e_12d_swiglu_qknorm_nobias"
MODS = ("rgb@224", "tok_clip@224", "caption")
DEC_MODS = ("tok_clip@224", "caption")
TINY = dict(dim=64, encoder_depth=1, decoder_depth=1, num_heads=4)
TRAIN = ["--device", "cpu", "--synthetic_data", "--model", NAME,
         "--in_domains", "-".join(MODS), "--out_domains", "-".join(DEC_MODS),
         "--dim", "64", "--num_heads", "4", "--encoder_depth", "1", "--decoder_depth", "1",
         "--dtype", "float32", "--batch_size", "2", "--num_input_tokens", "32",
         "--num_target_tokens", "32", "--print_freq", "1", "--scheduler", "constant",
         "--warmup_tokens", "0", "--epoch_size", "4", "--blr", "0.1", "--eval_size", "2"]
VQ_KW = dict(image_size=32, patch_size=4, enc_type="vit_t_enc", latent_dim=8, codebook_size=64)


def _flat(tree, prefix=()):
    """{key path: leaf} of a tree of dicts, sequences, NamedTuples and
    dataclasses (int keys for sequence entries, as read_orbax_tree keys
    them); None leaves kept."""
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = tree._asdict().items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    elif dataclasses.is_dataclass(tree):
        items = ((f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        if hasattr(v, "_fields") and not v._fields:  # optax's EmptyState: orbax's None
            v = None
        out.update(_flat(v, prefix + (k,)))
    return out


def _bits(a) -> tuple:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # read_orbax_tree widens bf16 exactly
        a = a.astype(np.float32)
    return a.dtype.str, a.shape, a.tobytes()


def _assert_tree_equal(got, ref):
    g, r = _flat(got), _flat(ref)
    assert set(g) == set(r), set(g) ^ set(r)
    for k, v in r.items():
        if v is None:
            assert g[k] is None, k
        else:
            assert _bits(g[k]) == _bits(v), k


# ------------------------------------------------------------------ zstd

def _buffer(parts) -> bytes:
    """A buffer of drawn parts: (kind, length, seed)."""
    out = []
    for kind, n, seed in parts:
        r = np.random.default_rng(seed)
        if kind == 0:
            out.append(r.integers(0, 256, n, dtype=np.uint8).tobytes())
        elif kind == 1:
            out.append(r.integers(0, 5, n, dtype=np.uint8).tobytes())
        elif kind == 2:
            out.append(bytes([seed % 256]) * n)
        elif kind == 3:
            out.append(r.standard_normal(n // 4).astype(np.float32).tobytes())
        else:
            word = r.integers(0, 256, 1 + seed % 40, dtype=np.uint8).tobytes()
            out.append((word * (n // len(word) + 1))[:n])
    return b"".join(out)


PARTS = st.lists(st.tuples(st.integers(0, 4), st.integers(0, 100_000), st.integers(0, 2 ** 16)),
                 min_size=1, max_size=4)


@pytest.mark.parametrize("level", [1, 3, 19, 22])
@settings(max_examples=6, deadline=None, derandomize=True)
@given(frames=st.lists(st.tuples(PARTS, st.booleans(), st.booleans(), st.booleans()),
                       min_size=1, max_size=3))
def test_decode_zstd_equals_zstandard(level, frames):
    zstandard = pytest.importorskip("zstandard")
    data, want = [], []
    for parts, size, check, skip in frames:
        buf = _buffer(parts)
        data.append(zstandard.ZstdCompressor(level=level, write_content_size=size,
                                             write_checksum=check).compress(buf))
        if skip:  # a skippable frame after it
            data.append((0x184D2A50 + len(buf) % 16).to_bytes(4, "little")
                        + (7).to_bytes(4, "little") + b"skipped")
        want.append(buf)
    stream = b"".join(data)
    got = decode_zstd(stream)
    assert got.dtype == np.uint8 and got.tobytes() == b"".join(want)
    assert zstandard.ZstdDecompressor().decompressobj().decompress(data[0]) == want[0]
    if all(size for _, size, _, _ in frames):  # into a caller's buffer
        out = np.empty(len(b"".join(want)), np.uint8)
        assert decode_zstd(stream, out=out) is not None and out.tobytes() == b"".join(want)


def test_decode_zstd_refusals():
    zstandard = pytest.importorskip("zstandard")
    data = _buffer([(4, 50_000, 3), (3, 20_000, 4)])
    bad = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data))
    bad[-1] ^= 1
    with pytest.raises(ValueError, match="checksum"):
        decode_zstd(bytes(bad))
    samples = [_buffer([(4, 2000, i)]) for i in range(200)]
    dictionary = zstandard.train_dictionary(2048, samples)
    with pytest.raises(ValueError, match="dictionar"):
        decode_zstd(zstandard.ZstdCompressor(dict_data=dictionary).compress(samples[0]))
    good = zstandard.ZstdCompressor(level=3).compress(data)
    with pytest.raises(ValueError):
        decode_zstd(good[:len(good) // 2])
    with pytest.raises(ValueError, match="not a zstd frame"):
        decode_zstd(b"\x00" * 16)
    with pytest.raises(ValueError, match="expected"):
        decode_zstd(good, out=np.empty(len(data) - 1, np.uint8))


# ------------------------------------------------------------ the JAX run

def _jax_model():
    jcfg = jax_config(NAME, MODS, DEC_MODS, **TINY)
    jm = JaxFourM(jcfg)
    batch = jax.tree.map(jnp.asarray, synthetic_mod_batch(MODS, 2, 32, 32))
    return jcfg, jm, init_variables(jm, 3, batch, 32, 32)


def _jax_train_state(variables, step: int, seed: int):
    """A JAX TrainState of train_4m's optimizer with drawn moments."""
    tx = create_optimizer(variables, lambda s: 1e-4, clip_grad=1.0)
    rng = np.random.default_rng(seed)

    def draw(x):
        if np.issubdtype(x.dtype, np.floating):
            return np.abs(rng.standard_normal(x.shape)).astype(np.float32) * 1e-3
        return np.full(x.shape, step, x.dtype)

    opt = jax.tree.map(lambda x: draw(np.asarray(x)), tx.init(variables))
    return TrainState(step=np.int32(step), params=variables, opt_state=opt)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A train_4m run directory of the JAX package: config.json, the params
    export weights/step_2 and the TrainState checkpoints/step_2."""
    jcfg, jm, variables = _jax_model()
    run = tmp_path_factory.mktemp("jax_run")
    with open(run / "config.json", "w") as f:
        json.dump(dataclasses.asdict(jcfg), f)
    state = _jax_train_state(variables, 2, 11)
    jck.save_checkpoint(str(run / "weights"), variables, 2)
    jck.save_checkpoint(str(run / "checkpoints"), state, 2)
    return run, jcfg, jm, variables, state


@pytest.fixture(scope="module")
def vq_run(tmp_path_factory):
    """A tokenizer run directory of the JAX package (what its
    get_image_tokenizer restores): config.json and checkpoints/step_1 with a
    VQ-VAE's params and codebook."""
    cfg = dict(VQ_KW, domain="rgb", dec_type="vit_t_dec")
    jm = JaxVQVAE(**{k: v for k, v in cfg.items() if k != "domain"})
    variables = init_variables(jm, 21, jnp.zeros((1, 32, 32, 3)))
    run = tmp_path_factory.mktemp("vq_run")
    with open(run / "config.json", "w") as f:
        json.dump(cfg, f)
    jck.save_checkpoint(str(run / "checkpoints"), variables, 1)
    return run, variables


# ------------------------------------------------------------ the reader

def test_read_fourm_params_and_train_state(jax_run):
    run, _, _, variables, state = jax_run
    _assert_tree_equal(read_orbax_tree(str(run / "weights" / "step_2")), variables)
    got = read_orbax_tree(str(run / "checkpoints" / "step_2"))
    _assert_tree_equal(got, jax.tree.map(np.asarray, state))
    # a prefix reads its subtree only
    sub = read_orbax_tree(str(run / "checkpoints" / "step_2"), prefix=("params",))
    assert set(sub) == {"params"}
    _assert_tree_equal(sub["params"], variables)
    with pytest.raises(KeyError, match="no leaf"):
        read_orbax_tree(str(run / "checkpoints" / "step_2"), prefix=("ema",))


def test_read_vq_and_dtypes(vq_run, tmp_path):
    run, variables = vq_run
    _assert_tree_equal(read_orbax_tree(str(run / "checkpoints" / "step_1")), variables)
    r = np.random.default_rng(5)
    tree = {"bf16": jnp.asarray(r.standard_normal((40, 30)), jnp.bfloat16),
            "f16": jnp.asarray(r.standard_normal(7), jnp.float16),
            "i32": jnp.asarray(r.integers(-9, 9, (3, 4)), jnp.int32),
            "i64": np.arange(5, dtype=np.int64), "b": jnp.asarray([True, False, True]),
            "s": jnp.float32(2.5), "n": 3, "x": 0.25, "none": None,
            "big": jnp.asarray(r.standard_normal((300, 20)), jnp.float32),  # indirect
            "seq": [jnp.zeros(2), {"a": jnp.ones(3)}]}
    jck.save_checkpoint(str(tmp_path), tree, 1)
    got = read_orbax_tree(str(tmp_path / "step_1"))
    assert got["bf16"].dtype == np.float32 and got["seq"][1]["a"].shape == (3,)
    _assert_tree_equal(got, jax.tree.map(np.asarray, tree))


def test_read_sharded_train_state(jax_run, tmp_path):
    """A TrainState sharded over the 8-device CPU mesh (fsdp 4): orbax
    writes an array per shard as a chunk; the reader assembles them."""
    _, _, _, variables, state = jax_run
    mesh = make_mesh(data=-1, fsdp=4)
    sharded = jax.device_put(state, params_shardings(mesh, state))
    assert any(len(x.sharding.device_set) > 1 and not x.sharding.is_fully_replicated
               for x in jax.tree.leaves(sharded))
    jck.save_checkpoint(str(tmp_path), sharded, 5)
    zarrays = [json.loads(v) for k, v in _zarray_metas(tmp_path / "step_5")]
    assert any(m["chunks"] != m["shape"] for m in zarrays)
    _assert_tree_equal(read_orbax_tree(str(tmp_path / "step_5")), jax.tree.map(np.asarray, state))


def _zarray_metas(step_dir):
    from fourm_torch.utils.orbax import _Ocdbt

    store = _Ocdbt(str(step_dir))
    items = store.items()
    out = [(k, store.value(v, "").tobytes()) for k, v in items.items() if k.endswith(b".zarray")]
    store.close()
    return out


def test_fixtures_equal_expected():
    """tests/orbax_fixtures (scripts/make_orbax_fixtures.py: orbax's zstd,
    a sharded TrainState) against their expected arrays, read by the port's
    safetensors reader."""
    exp = tck.load_safetensors(os.path.join(FIXTURES, "expected.safetensors"),
                               return_metadata=False)
    got = {}
    for step in ("fourm_run/checkpoints/step_1", "vq_run/checkpoints/step_1"):
        for k, v in _flat(read_orbax_tree(os.path.join(FIXTURES, step))).items():
            if v is not None:
                got["/".join([step, *map(str, k)])] = v
    assert set(got) == set(exp)
    for k, v in exp.items():  # bf16 where it holds the float32 value exactly
        assert _bits(got[k]) == _bits(v.float().numpy() if v.dtype == torch.bfloat16
                                      else v.numpy()), k
    weights = _flat(read_orbax_tree(os.path.join(FIXTURES, "fourm_run/weights/step_1")))
    for k, v in weights.items():
        assert _bits(v) == _bits(got["/".join(["fourm_run/checkpoints/step_1/params",
                                               *map(str, k)])]), k


def test_fixture_wide_leaf():
    """The fixture's wide float32 leaf (whole mantissas, one zstd frame of
    605 KB, as orbax writes a weight) read equal, bit for bit, to its
    draw, and its frame decoded as zstandard decodes it."""
    import importlib.util

    from fourm_torch.utils.orbax import _Ocdbt

    spec = importlib.util.spec_from_file_location(
        "make_orbax_fixtures", os.path.join(HERE, "..", "scripts", "make_orbax_fixtures.py"))
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    step = os.path.join(FIXTURES, "wide_leaf", "step_1")
    tree = read_orbax_tree(step)
    assert set(tree) == {"w"} and _bits(tree["w"]) == _bits(maker.wide_leaf())
    store = _Ocdbt(step)
    frame = store.value(store.items()[b"w/0.0"], "").tobytes()
    store.close()
    assert len(frame) > 500_000 and frame[:4] == b"\x28\xb5\x2f\xfd"
    zstandard = pytest.importorskip("zstandard")
    assert decode_zstd(frame).tobytes() == \
        zstandard.ZstdDecompressor().decompressobj().decompress(frame)


def test_reader_refusals(vq_run, tmp_path):
    import shutil

    run, _ = vq_run
    step = tmp_path / "step_1"
    shutil.copytree(run / "checkpoints" / "step_1", step)
    meta = json.loads((step / "_METADATA").read_text())
    (step / "_METADATA").write_text(json.dumps(dict(meta, use_zarr3=True)))
    with pytest.raises(ValueError, match="zarr3"):
        read_orbax_tree(str(step))
    (step / "_METADATA").write_text(json.dumps(meta))
    manifest = (step / "manifest.ocdbt").read_bytes()
    (step / "manifest.ocdbt").write_bytes(manifest[:-1] + bytes([manifest[-1] ^ 1]))
    with pytest.raises(ValueError, match="CRC-32C"):
        read_orbax_tree(str(step))
    (step / "manifest.ocdbt").write_bytes(manifest)
    shutil.rmtree(step / "ocdbt.process_0")
    with pytest.raises((FileNotFoundError, ValueError)):
        read_orbax_tree(str(step))
    with pytest.raises(ValueError, match="int8"):
        write_orbax_tree(str(tmp_path / "w" / "step_1"), {"a": np.zeros(3, np.int8)})


# ------------------------------------------------------------ the writer

def test_write_restored_by_jax(jax_run, tmp_path):
    _, jcfg, _, variables, state = jax_run
    r = np.random.default_rng(8)
    tree = {"params": {"w": r.standard_normal((64, 48)).astype(np.float32),
                       "bf": torch.randn(40, 30, generator=torch.Generator().manual_seed(1)
                                         ).to(torch.bfloat16),
                       "i": np.arange(5, dtype=np.int32), "m": np.array([True, False])},
            "step": np.int32(7), "opt": [None, {"count": np.int32(3)}], "h": np.float16(2.5)}
    write_orbax_tree(str(tmp_path / "a" / "step_3"), tree)
    assert not [n for n in os.listdir(tmp_path / "a") if n.endswith(".tmp")]
    dev = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    abstract = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(np.shape(x), jnp.bfloat16 if isinstance(x, torch.Tensor)
                                       else np.asarray(x).dtype, sharding=dev), tree)
    got = jck.load_checkpoint(str(tmp_path / "a"), 3, abstract)
    assert _bits(got["params"]["bf"]) == _bits(tree["params"]["bf"].float().numpy())
    assert np.asarray(got["params"]["bf"]).dtype.name == "bfloat16"
    for k in ("w", "i", "m"):
        assert _bits(got["params"][k]) == _bits(tree["params"][k]), k
    assert int(got["step"]) == 7 and int(got["opt"][1]["count"]) == 3 and got["opt"][0] is None
    # the port's TrainState in the JAX layout, into the JAX TrainState of the CLI's chain
    tcfg = create_fourm_config(NAME, MODS, DEC_MODS, **TINY)
    model_state = tck.from_jax_params(variables["params"], tcfg)
    opt = tck.from_jax_adam_state(state.opt_state, tcfg)
    write_orbax_tree(str(tmp_path / "b" / "step_2"),
                     tck.to_jax_train_state(model_state, opt, 2, tcfg))
    # a concrete target: its structure and placement
    got = jck.load_checkpoint(str(tmp_path / "b"), 2, jax.tree.map(jnp.asarray, state))
    _assert_tree_equal(jax.tree.map(np.asarray, got), jax.tree.map(np.asarray, state))
    # without shardings of its own the restore reads the _sharding file
    got = jck.load_checkpoint(str(tmp_path / "b"), 2, jax.eval_shape(lambda: state))
    _assert_tree_equal(jax.tree.map(np.asarray, got), jax.tree.map(np.asarray, state))


def test_to_jax_params_inverts_from_jax_params(jax_run):
    _, _, _, variables, _ = jax_run
    tcfg = create_fourm_config(NAME, MODS, DEC_MODS, **TINY)
    params = variables["params"]
    _assert_tree_equal(tck.to_jax_params(tck.from_jax_params(params, tcfg), tcfg), params)
    torch.manual_seed(0)
    model = FourM(tcfg)
    sd = model.state_dict()
    back = tck.from_jax_params(tck.to_jax_params(sd, tcfg), tcfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_from_jax_adam_state_on_read_back(jax_run):
    """The optimizer state as read_orbax_tree gives it (mappings, int keys
    for the chain's tuples) gives what the optax state itself gives."""
    run, jcfg, _, _, state = jax_run
    tcfg = create_fourm_config(NAME, MODS, DEC_MODS, **TINY)
    read = read_orbax_tree(str(run / "checkpoints" / "step_2"))["opt_state"]
    a, b = tck.from_jax_adam_state(read, tcfg), tck.from_jax_adam_state(state.opt_state, tcfg)
    assert a["count"] == b["count"] == 2 and set(a["mu"]) == set(b["mu"])
    for k in a["mu"]:
        assert torch.equal(a["mu"][k], b["mu"][k]) and torch.equal(a["nu"][k], b["nu"][k]), k
    with pytest.raises(ValueError, match="found 0"):
        tck.from_jax_adam_state({"a": {"count": np.int32(1)}}, tcfg)


# ------------------------------------------------------------ entry points

def _gen_md(B, seed):
    rng = np.random.RandomState(seed)
    md = {"rgb@224": {"tensor": rng.rand(B, 224, 224, 3).astype(np.float32),
                      "input_mask": np.zeros((B, 196), bool),
                      "target_mask": np.ones((B, 196), bool),
                      "decoder_attention_mask": np.zeros((B, 196), np.int32)},
          "tok_clip@224": {"tensor": rng.randint(0, 8192, (B, 196)).astype(np.int32),
                           "input_mask": rng.rand(B, 196) > 0.5,
                           "target_mask": np.zeros((B, 196), bool),
                           "decoder_attention_mask": np.zeros((B, 196), np.int32)},
          "caption": {"tensor": rng.randint(0, 30000, (B, 20)).astype(np.int32),
                      "input_mask": np.ones((B, 20), bool),
                      "target_mask": np.ones((B, 20), bool),
                      "decoder_attention_mask": np.zeros((B, 20), np.int32)}}
    return md, rng.rand(B, 196) > 0.3


def test_load_fm_jax_run(jax_run):
    from fourm_torch.generate import init_empty_target_modality, init_full_input_modality

    run, _, jm, variables, _ = jax_run
    tm = load_fm(str(run), device="cpu")
    md, sa = _gen_md(2, 3)
    ref = jm.apply(variables, jax.tree.map(jnp.asarray, md), "tok_clip@224", jnp.asarray(sa),
                   None, method="forward_generation_img")
    with torch.no_grad():
        port = tm.forward_generation_img(
            {m: {k: torch.from_numpy(np.array(v)) for k, v in d.items()} for m, d in md.items()},
            "tok_clip@224", torch.from_numpy(sa), None)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    # tokens at temperature 0: tok_clip@224 by 3 MaskGIT steps from the RGB
    sched = [{"target_domain": "tok_clip@224", "scheme": "maskgit", "num_tokens": n,
              "temperature": 0.0, "cfg_scale": 1.0, "cfg_cond_domains": [],
              "top_k": 0.0, "top_p": 0.0} for n in (98, 49, 49)]
    md = {"rgb@224": {"tensor": np.random.RandomState(1).rand(1, 224, 224, 3)
                      .astype(np.float32)}}
    init_full_input_modality(md, "rgb@224")
    init_empty_target_modality(md, "tok_clip@224", 1, 196)
    copy = lambda: {m: {k: np.array(v) for k, v in d.items()} for m, d in md.items()}
    jout = JaxGenerationSampler(jm, variables).generate(copy(), sched, seed=0)
    tout = GenerationSampler(tm).generate(copy(), sched, seed=0)
    np.testing.assert_array_equal(tout["tok_clip@224"]["tensor"].numpy(),
                                  np.asarray(jout["tok_clip@224"]["tensor"]))


def _state_of(jstate, tcfg):
    return tck.from_jax_params(jstate.params["params"], tcfg), \
        tck.from_jax_adam_state(jstate.opt_state, tcfg)


def test_train_4m_finetune_and_resume_from_jax_run(jax_run, tmp_path, capsys):
    run, _, _, variables, state = jax_run
    tcfg = create_fourm_config(NAME, MODS, DEC_MODS, **TINY)
    want, want_opt = _state_of(state, tcfg)
    # --finetune: the run dir, its weights/, one step dir, the TrainState's dir
    for path in (run, run / "weights", run / "weights" / "step_2", run / "checkpoints"):
        torch.manual_seed(1)
        model = FourM(tcfg)
        load_finetune_weights(str(path), model)
        for k, v in model.state_dict().items():
            assert torch.equal(v, want[k]), (path, k)
    # auto-resume: the masters, the moments and the count, bit for bit
    model = FourM(tcfg)
    tx = t_create_optimizer(model, make_schedule("constant", 1e-4, 10, 0))
    tstate = init_train_state(model, tx, device="cpu")
    ckpt, step = tck.auto_resume(str(run / "checkpoints"))
    gen = torch.Generator().manual_seed(5)
    before = gen.get_state()
    assert restore_checkpoint(tstate, gen, tck.from_jax_train_state(ckpt, tcfg)) == step == 2
    assert torch.equal(gen.get_state(), before)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    got = tstate.optimizer.state_dict()
    assert got["count"] == want_opt["count"] == 2
    for k in got["mu"]:
        assert torch.equal(got["mu"][k], want_opt["mu"][k]), k
        assert torch.equal(got["nu"][k], want_opt["nu"][k]), k
    # the CLI: --finetune from the JAX run, then resuming it in place for one step
    train_main(TRAIN + ["--output_dir", str(tmp_path / "ft"), "--max_steps", "1",
                        "--finetune", str(run)])
    assert "warm-started" in capsys.readouterr().out
    out = tmp_path / "resumed"
    import shutil

    shutil.copytree(run, out)
    train_main(TRAIN + ["--output_dir", str(out), "--max_steps", "3"])
    text = capsys.readouterr().out
    assert "resumed from step 2 of a JAX run" in text and "restart from --seed" in text
    assert tck.latest_checkpoint_steps(str(out / "checkpoints")) == [2, 3]
    assert tck.load_checkpoint(str(out / "checkpoints"), 3)["optimizer"]["count"] == 3


def test_train_4m_finetune_port_run(tmp_path):
    """--finetune on the port's own run: the run dir, weights/, a params
    export, checkpoints/ and a train checkpoint's step dir all give the
    trained masters; a step that fills no parameter raises."""
    run = tmp_path / "run"
    train_main(TRAIN + ["--output_dir", str(run), "--max_steps", "1"])
    want = tck.load_checkpoint(str(run / "checkpoints"), 1)["model"]
    tcfg = create_fourm_config(NAME, MODS, DEC_MODS, **TINY)
    for path in (run, run / "weights", run / "weights" / "step_1", run / "checkpoints",
                 run / "checkpoints" / "step_1"):
        torch.manual_seed(7)
        model = FourM(tcfg)
        load_finetune_weights(str(path), model)
        for k, v in model.state_dict().items():
            assert torch.equal(v, want[k]), (path, k)
    tck.save_checkpoint(str(tmp_path / "other"), {"step": 1, "encoder.w": torch.zeros(2)}, 1)
    with pytest.raises(ValueError, match="no tensor of it is a parameter"):
        load_finetune_weights(str(tmp_path / "other"), FourM(tcfg))


def test_get_image_tokenizer_jax_run(vq_run):
    run, variables = vq_run
    x = np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32)
    jm, jvars = jax_get_image_tokenizer(str(run), verbose=False)
    want = np.asarray(jm.apply(jvars, jnp.asarray(x), method="tokenize"))
    # encoder_only: the port leaves the decoder out (the JAX restore refuses the subset)
    for encoder_only in (False, True):
        pm, _ = get_image_tokenizer(str(run), encoder_only=encoder_only, verbose=False,
                                    device="cpu")
        with torch.no_grad():
            np.testing.assert_array_equal(pm.tokenize(torch.from_numpy(x)).numpy(), want)
    for k, v in tck.from_jax_vq_variables(variables).items():
        if not k.endswith("pos_emb"):
            assert torch.equal(pm.state_dict().get(k, v), v), k


def test_save_vq_tokens_ckpt_dir(tmp_path, monkeypatch):
    """Both CLIs on one orbax directory of an encoder-only VQ of the JAX
    CLI's build (VQ defaults; vit_b shrunk in both packages to 1 block at
    width 32, so that the test stays small) and one crop-settings dir."""
    from PIL import Image

    tiny = dict(dim_tokens=32, depth=1, num_heads=2)
    monkeypatch.setitem(jvit.VIT_SIZES, "vit_b", tiny)
    monkeypatch.setitem(tvit.VIT_SIZES, "vit_b", tiny)
    rng = np.random.default_rng(3)
    root = tmp_path / "data"
    (root / "rgb" / "c").mkdir(parents=True)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 52, 3)).astype(np.uint8)).save(
            root / "rgb" / "c" / f"{i}.png")
    variables = init_variables(JaxVQ(image_size=32), 31, jnp.zeros((1, 32, 32, 3)))
    jck.save_checkpoint(str(tmp_path / "ckpt"), variables, 4)
    common = ["--data_root", str(root), "--input_size", "32", "--n_crops", "2",
              "--ckpt_dir", str(tmp_path / "ckpt"), "--crop_settings_dir", str(tmp_path / "cs")]
    assert tsave.main(common + ["--out_dir", str(tmp_path / "p"), "--device", "cpu",
                                "--dtype", "float32"]) == 3
    jsave.main(common + ["--out_dir", str(tmp_path / "j")])
    for i in range(3):
        got = np.load(tmp_path / "p" / "c" / f"{i}.npy")
        assert got.shape == (2, 4)
        np.testing.assert_array_equal(got, np.load(tmp_path / "j" / "c" / f"{i}.npy"))
    with pytest.raises(SystemExit):
        tsave.main(common + ["--out_dir", str(tmp_path / "x"), "--ckpt", "a.safetensors",
                            "--device", "cpu"])


def test_train_vqcontrolnet_vq_ckpt(tmp_path):
    """--vq_ckpt on the JAX CLI's orbax directory: the encoder, quant_proj
    and codebook that JAX's load_checkpoint restores, bit for bit; the rest
    of the model keeps its seeded init."""
    kw = dict(image_size=32, patch_size=4, enc_type="vit_t_enc", codebook_size=64,
              latent_dim=8, model_channels=32, channel_mult=(1, 2), attention_levels=(1,),
              num_heads=2, context_len=4, context_dim=16, vae_base_channels=32,
              vae_ch_mult=(1, 2))
    jm = JaxVQControlNet(**kw)
    variables = init_variables(jm, 41, jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 16, 16, 4)),
                               jnp.zeros((1,), jnp.int32), method="init_all")
    jck.save_checkpoint(str(tmp_path / "vq"), variables, 9)
    loaded = jck.load_checkpoint(str(tmp_path / "vq"), 9, variables)
    args = tcn.get_parser().parse_args([
        "--device", "cpu", "--dtype", "float32", "--input_size", "32", "--patch_size", "4",
        "--enc_type", "vit_t_enc", "--codebook_size", "64", "--latent_dim", "8",
        "--model_channels", "32", "--channel_mult", "1", "2", "--attention_levels", "1",
        "--num_heads", "2", "--context_len", "4", "--context_dim", "16",
        "--vae_base_channels", "32", "--vae_ch_mult", "1", "2", "--vq_ckpt",
        str(tmp_path / "vq")])
    fresh = tcn.build_model(args, "cpu")
    want = tck.from_jax_vq_variables(
        {"params": {k: jax.tree.map(np.asarray, loaded["params"][k])
                    for k in ("encoder", "quant_proj")},
         "codebook": jax.tree.map(np.asarray, loaded["codebook"])})
    own = fresh.state_dict()
    n = 0
    for k, v in want.items():
        if k.endswith("pos_emb"):
            continue
        assert torch.equal(own[k].float(), v), k
        n += 1
    assert n > 10
    assert not any(p.requires_grad for k, p in fresh.named_parameters()
                   if k.startswith(("encoder.", "quant_proj.")))


@pytest.mark.parametrize("task,fmt", [("CLIP-B16", "safetensors"), ("CLIP-B16", "pth"),
                                      ("DINOv2-B14-global", "npz")])
def test_teacher_ckpt(task, fmt, tmp_path, monkeypatch):
    """A teacher checkpoint in its release layout (OpenAI CLIP `visual.*`,
    DINOv2 torchhub), width 32 and 2 blocks (the presets shrunk in both
    packages), read by both packages: features within 1e-5."""
    clip = "CLIP" in task
    preset = dict(patch_size=16 if clip else 14, width=32, depth=2, num_heads=2,
                  **(dict(act_name="quick_gelu", pre_norm=True, patch_bias=False, output_dim=16)
                     if clip else dict(act_name="gelu", layer_scale=True)))
    monkeypatch.setitem(jteachers.TEACHER_PRESETS, task, preset)
    monkeypatch.setitem(tteachers.TEACHER_PRESETS, task, preset)
    size = 32 if clip else 28
    n = (size // preset["patch_size"]) ** 2 + 1
    r = np.random.default_rng(7)
    w = lambda *s: (r.standard_normal(s) * 0.2).astype(np.float32)
    ones = lambda d: (1 + 0.1 * r.standard_normal(d)).astype(np.float32)
    state = {}
    p, W = preset["patch_size"], 32
    if clip:
        state.update({"visual.conv1.weight": w(W, 3, p, p), "visual.class_embedding": w(W),
                      "visual.positional_embedding": w(n, W), "visual.ln_pre.weight": ones(W),
                      "visual.ln_pre.bias": w(W), "visual.ln_post.weight": ones(W),
                      "visual.ln_post.bias": w(W), "visual.proj": w(W, 16)})
        for i in range(2):
            b = f"visual.transformer.resblocks.{i}"
            state.update({f"{b}.ln_1.weight": ones(W), f"{b}.ln_1.bias": w(W),
                          f"{b}.attn.in_proj_weight": w(3 * W, W),
                          f"{b}.attn.in_proj_bias": w(3 * W),
                          f"{b}.attn.out_proj.weight": w(W, W), f"{b}.attn.out_proj.bias": w(W),
                          f"{b}.ln_2.weight": ones(W), f"{b}.ln_2.bias": w(W),
                          f"{b}.mlp.c_fc.weight": w(4 * W, W), f"{b}.mlp.c_fc.bias": w(4 * W),
                          f"{b}.mlp.c_proj.weight": w(W, 4 * W), f"{b}.mlp.c_proj.bias": w(W)})
    else:
        state.update({"patch_embed.proj.weight": w(W, 3, p, p), "patch_embed.proj.bias": w(W),
                      "cls_token": w(1, 1, W), "pos_embed": w(1, n, W),
                      "norm.weight": ones(W), "norm.bias": w(W)})
        for i in range(2):
            b = f"blocks.{i}"
            state.update({f"{b}.norm1.weight": ones(W), f"{b}.norm1.bias": w(W),
                          f"{b}.attn.qkv.weight": w(3 * W, W), f"{b}.attn.qkv.bias": w(3 * W),
                          f"{b}.attn.proj.weight": w(W, W), f"{b}.attn.proj.bias": w(W),
                          f"{b}.ls1.gamma": ones(W), f"{b}.ls2.gamma": ones(W),
                          f"{b}.norm2.weight": ones(W), f"{b}.norm2.bias": w(W),
                          f"{b}.mlp.fc1.weight": w(4 * W, W), f"{b}.mlp.fc1.bias": w(4 * W),
                          f"{b}.mlp.fc2.weight": w(W, 4 * W), f"{b}.mlp.fc2.bias": w(W)})
    path = str(tmp_path / f"teacher.{fmt}")
    if fmt == "safetensors":
        from safetensors.numpy import save_file

        save_file(state, path)
    elif fmt == "pth":
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in state.items()}}, path)
    else:
        np.savez(path, **state)
    x = np.random.RandomState(4).rand(2, size, size, 3).astype(np.float32)
    ref = np.asarray(jteachers.get_feature_extractor(task, path, size)(jnp.asarray(x)))
    teacher = tsave.build_teacher(task, path, size, 0, "cpu")
    with torch.no_grad():
        got = teacher(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    del state[next(iter(state))]
    np.savez(str(tmp_path / "short.npz"), **state)
    with pytest.raises(KeyError):
        tsave.build_teacher(task, str(tmp_path / "short.npz"), size, 0, "cpu")
