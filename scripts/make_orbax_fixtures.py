"""Write the orbax fixtures of the port's checkpoint reader with the JAX package.

    python scripts/make_orbax_fixtures.py [--out tests/orbax_fixtures]

Two run directories, each written by fourm_tpu.utils.checkpoint.save_checkpoint
(orbax's StandardCheckpointer: OCDBT, zarr v2, zstd), as the JAX trainers
leave them:
  * `fourm_run/`: a train_4m run of a FourM (fm_base_12e_12d_swiglu_qknorm_nobias
    at dim 8, 2 heads, 1 + 1 blocks, rgb@224 -> tok_semseg@224): `config.json`,
    the params export `weights/step_1` and the TrainState `checkpoints/step_1`
    (step, params, the AdamW chain of fourm_tpu.utils.optim.create_optimizer
    with clip 1.0), saved from arrays sharded over an 8-device CPU mesh
    (params_shardings at fsdp 4), so that most arrays arrive in several
    chunks;
  * `vq_run/`: a tokenizer run of an encoder-only VQ (vit_t at 32 px, patch 4,
    64 codes of 8, cosine codebook): `config.json` and `checkpoints/step_1`
    with the `params` and `codebook` collections, what the JAX
    get_image_tokenizer restores.
Their leaves are drawn from a seed and rounded to bfloat16's precision
(stored as float32), so that zstd halves them and the folder stays small.
`expected.safetensors` holds every array leaf of these two runs under
`<run>/<step dir>/<key path joined by "/">`, the port's reader's expected
values, the float ones that bfloat16 holds exactly as bfloat16 (the
readers widen them back to float32), the rest as float32; the params export's are the TrainState's
`params` (they are the same arrays) and are not stored twice.
  * `wide_leaf/step_1`: one float32 array `w` of WIDE_SHAPE drawn with
    whole mantissas (wide_leaf(), as trained weights have them), in one
    chunk: a zstd frame of 605 KB, of the kind orbax writes for a weight
    (zstd level 1 hardly shrinks it; a full-width model's chunks are
    megabytes). Its expected value is not stored: the
    readers draw it again from numpy's legacy RandomState, whose stream
    numpy keeps fixed.
The folder stays under 2 MB. Needs JAX, flax, optax, orbax and torch (for
the bfloat16 safetensors); the port never imports JAX, flax, optax or orbax.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402

FOURM = dict(model="fm_base_12e_12d_swiglu_qknorm_nobias", encoder=("rgb@224",),
             decoder=("tok_semseg@224",), dim=8, num_heads=2, encoder_depth=1, decoder_depth=1)
VQ_CFG = dict(domain="rgb", image_size=32, patch_size=4, enc_type="vit_t_enc", latent_dim=8,
              codebook_size=64)
WIDE_SHAPE = (640, 256)


def wide_leaf() -> np.ndarray:
    """The `w` of wide_leaf/step_1: N(0, 0.02) in float32, whole mantissas."""
    return np.random.RandomState(2020).standard_normal(WIDE_SHAPE).astype(np.float32) \
        * np.float32(0.02)


def _draw(tree, rng):
    """Every leaf drawn (float: N(0, 0.02) rounded to bfloat16's 8-bit
    mantissa; int: small counts), as numpy."""
    import jax

    def leaf(x):
        if np.issubdtype(x.dtype, np.floating):
            v = (rng.standard_normal(x.shape) * 0.02).astype(np.float32)
            return (v.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
        return np.full(x.shape, 1, x.dtype)

    return jax.tree.map(leaf, tree)


def _flat(prefix: str, tree, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(f"{prefix}/{k}", v, out)
    elif hasattr(tree, "_fields") or isinstance(tree, (tuple, list)):
        items = tree._asdict().items() if hasattr(tree, "_asdict") else enumerate(tree)
        for k, v in items:
            _flat(f"{prefix}/{k}", v, out)
    elif hasattr(tree, "__dataclass_fields__"):
        for f in dataclasses.fields(tree):
            _flat(f"{prefix}/{f.name}", getattr(tree, f.name), out)
    elif tree is not None:
        out[prefix] = np.asarray(tree)


def main(argv=None) -> None:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    import torch
    from safetensors.torch import save_file

    from fourm_tpu.models import FourM, create_fourm_config
    from fourm_tpu.parallel.mesh import make_mesh, params_shardings
    from fourm_tpu.parallel.train import TrainState
    from fourm_tpu.utils.checkpoint import save_checkpoint
    from fourm_tpu.utils.optim import create_optimizer
    from fourm_tpu.utils.synthetic import synthetic_mod_batch
    from fourm_tpu.vq import VQ

    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(os.path.dirname(__file__), "..", "tests",
                                                 "orbax_fixtures"))
    args = p.parse_args(argv)
    out = os.path.abspath(args.out)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    rng = np.random.default_rng(2020)
    expected = {}

    # ---- the train_4m run
    f = FOURM
    config = create_fourm_config(f["model"], f["encoder"], f["decoder"], dim=f["dim"],
                                 num_heads=f["num_heads"], encoder_depth=f["encoder_depth"],
                                 decoder_depth=f["decoder_depth"])
    model = FourM(config)
    mods = f["encoder"] + f["decoder"]
    batch = jax.tree.map(jnp.asarray, synthetic_mod_batch(mods, 1, 32, 32))
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), batch, 32, 32))
    variables = _draw(shapes, rng)
    tx = create_optimizer(variables, lambda step: 1e-4, clip_grad=1.0)
    opt = tx.init(variables)
    opt = jax.tree.map(lambda x: _draw(x, rng) if hasattr(x, "shape") else x, opt)
    state = TrainState(step=np.int32(1), params=variables, opt_state=opt)
    mesh = make_mesh(data=-1, fsdp=4)
    state = jax.device_put(state, params_shardings(mesh, state))
    run = os.path.join(out, "fourm_run")
    os.makedirs(run)
    with open(os.path.join(run, "config.json"), "w") as fh:
        json.dump(dataclasses.asdict(config), fh, indent=1)
    save_checkpoint(os.path.join(run, "weights"), state.params, 1)
    save_checkpoint(os.path.join(run, "checkpoints"), state, 1)
    _flat("fourm_run/checkpoints/step_1", jax.tree.map(np.asarray, state), expected)

    # ---- the tokenizer run
    vq = VQ(**{k: v for k, v in VQ_CFG.items() if k != "domain"})
    vshapes = jax.eval_shape(lambda: vq.init({"params": jax.random.key(0),
                                              "rng": jax.random.key(1)},
                                             jnp.zeros((1, 32, 32, 3))))
    vvars = {"params": _draw(vshapes["params"], rng), "codebook": _draw(vshapes["codebook"], rng)}
    embed = vvars["codebook"]["quantize"]["embed"]
    vvars["codebook"]["quantize"]["embed"] = (
        embed / np.linalg.norm(embed, axis=-1, keepdims=True)).astype(np.float32)
    vrun = os.path.join(out, "vq_run")
    os.makedirs(vrun)
    with open(os.path.join(vrun, "config.json"), "w") as fh:
        json.dump(VQ_CFG, fh, indent=1)
    save_checkpoint(os.path.join(vrun, "checkpoints"), vvars, 1)
    _flat("vq_run/checkpoints/step_1", vvars, expected)

    # ---- one wide float32 leaf in one chunk
    save_checkpoint(os.path.join(out, "wide_leaf"), {"w": jnp.asarray(wide_leaf())}, 1)

    tensors = {}
    for k, v in expected.items():
        t = torch.from_numpy(np.array(v, order="C"))  # 0-d arrays stay 0-d
        if t.is_floating_point() and torch.equal(t.to(torch.bfloat16).float(), t):
            t = t.to(torch.bfloat16)  # it holds the value exactly
        tensors[k] = t
    save_file(tensors, os.path.join(out, "expected.safetensors"))
    size = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(out) for n in ns)
    print(f"wrote {out}: {len(expected)} arrays, {size} bytes")


if __name__ == "__main__":
    main()
