"""Checkpoints of the PyTorch port: release-format safetensors in and out,
the port's own train-state checkpoints, and the weight bridge from the JAX
package's parameter trees.

Release files (fourm_tpu/utils/checkpoint.py:259-475; reference
utils/checkpoint.py:176-192), read and written by the port itself (the
machine with the card has neither `safetensors` nor PyYAML):
  * `load_safetensors` / `save_safetensors`: the format itself (an 8-byte
    little-endian header length, a JSON header of `dtype`, `shape` and
    `data_offsets` with an optional `__metadata__` of strings, then the
    raw little-endian bytes). Loading maps the file and makes each tensor
    a view of the mapping (torch.frombuffer): no second host copy;
  * `parse_metadata_value`: a metadata string as the JAX loader's
    `yaml.safe_load(v.replace("None", "null"))` reads the forms these
    files carry: a Python-literal dict or list (the reference writes
    `str(config)`), JSON, the block YAML of `export_vq_safetensors`, one
    scalar. Anything else raises;
  * `fourm_config_from_metadata` / `load_fourm_safetensors`: a released 4M
    model (a local file) as the port's FourM, its reference-named tensors
    copied into the module's own parameters, then cast. A key the port
    cannot place, or a parameter the file lacks, raises with its name; a
    sin-cos `pos_emb` table in the file is held to the port's computed one
    and dropped;
  * `import_vq_state_dict` / `load_vq_safetensors` / `export_vq_safetensors`:
    the VQ tokenizers (vq/loader.py:get_image_tokenizer reads with them).
Train state (fourm_tpu/utils/checkpoint.py:31-82, orbax there, here
`torch.save`): `save_checkpoint` writes `step_N` directories (under a
temporary name, then renamed) and keeps the newest `keep`;
`latest_checkpoint_steps`, `load_checkpoint`, `auto_resume`, which read
the port's own step directories and, by utils/orbax.py, those the JAX
package's orbax wrote (`is_orbax_step` tells them apart).

Weight bridge: each `from_jax_*` function takes a fourm_tpu variables tree
as nested dicts of numpy arrays (what `jax.tree.map(np.asarray,
variables)` gives) and returns the reference-named torch state dict that
the port's module takes with `load_state_dict(..., strict=True)`:
  * `from_jax_params(params, config)`: `variables["params"]` of a FourM, the
    port's own copy of fourm_tpu/utils/checkpoint.py:export_fourm_torch_state;
  * `from_jax_vq_variables(variables)`: a VQ's, VQVAE's or DiVAE's
    `params` and `codebook` collection (the encoder, the quantizer, and the
    ViT, MLP, UNet and UViT decoders), named as
    checkpoint.py:_vq_torch_name / export_vq_torch_state (356-408) name
    them;
  * `from_jax_teacher_params(params)`: a ViTTeacher's `params`;
  * `from_jax_adam_state(opt_state, config)`: optax AdamW's `count`, `mu`
    and `nu` of a FourM, as the port's FusedAdamW state (`load_state_dict`);
  * `from_jax_train_state(tree, config)`: a JAX TrainState (`step`,
    `params`, `opt_state`, fourm_tpu/parallel/train.py:28) as the port's
    checkpoint dict (`step`, `model`, `optimizer`).
And back: `to_jax_params(state, config)` (the port's copy of
fourm_tpu/utils/checkpoint.py:138 import_fourm_state_dict) and
`to_jax_train_state(model_state, opt_state, step, config)`, the JAX
train_4m's TrainState layout (optax's chain of the default clip and AdamW),
which utils/orbax.py:write_orbax_tree writes as the JAX package would.
A returned tensor shares its memory with the tree's array where that array
owns writeable contiguous data (read_orbax_tree's: no second copy of a
checkpoint); other arrays are copied. Dense kernels (in, out) become
nn.Linear weights (out, in), convolution
kernels (kh, kw, in, out) the reference's (out, in, kh, kw), transposed
convolution kernels (kh, kw, out, in; flax's transpose_kernel=True) the
(in, out, kh, kw) of nn.ConvTranspose2d (the same permutation), flax
LayerNorm / GroupNorm scales `weight`, embedding tables keep their layout,
modality and mask tokens take the reference (1, 1, D) shape. Sin-cos
tables are computed, not loaded.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import mmap
import os
import re
import shutil
from types import SimpleNamespace
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def _walk(out: Dict[str, np.ndarray], prefix: str, tree: Mapping) -> None:
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            _walk(out, f"{prefix}.{name}", sub)
            continue
        arr = np.asarray(sub)
        if name == "kernel":
            out[f"{prefix}.weight"] = np.ascontiguousarray(arr.T)
        elif name == "embedding":
            out[f"{prefix}.weight"] = arr
        else:
            out[f"{prefix}.{name}"] = arr


def from_jax_params(params: Mapping, config) -> Dict[str, torch.Tensor]:
    """Reference-named torch state dict from a JAX FourM parameter tree."""
    out: Dict[str, np.ndarray] = {}
    for key, val in params.items():
        if re.fullmatch(r"(encoder|decoder)_\d+", key):
            top, idx = key.rsplit("_", 1)
            _walk(out, f"{top}.{idx}", val)
        elif key in ("encoder_norm", "decoder_norm", "decoder_proj_context"):
            _walk(out, key, val)
        elif key == "mask_token":
            out["mask_token"] = np.asarray(val).reshape(1, 1, -1)
        elif key == "register_tokens":
            out["register_tokens"] = np.asarray(val)[None]
        elif key.startswith("mod_emb_"):
            mod = key[len("mod_emb_"):]
            arr = np.asarray(val).reshape(1, 1, -1)
            if mod in config.encoder_modalities:
                out[f"encoder_embeddings.{mod}.mod_emb"] = arr
            if config.share_modality_embeddings and mod in config.decoder_modalities:
                out[f"decoder_embeddings.{mod}.mod_emb"] = arr
        elif key.startswith("dec_mod_emb_"):
            mod = key[len("dec_mod_emb_"):]
            out[f"decoder_embeddings.{mod}.mod_emb"] = np.asarray(val).reshape(1, 1, -1)
        elif key.startswith(("encoder_embeddings_", "decoder_embeddings_")):
            top = ("encoder_embeddings" if key.startswith("encoder_embeddings_")
                   else "decoder_embeddings")
            mod = key[len(top) + 1:]
            for name, sub in val.items():
                if name == "pos_emb":
                    out[f"{top}.{mod}.pos_emb"] = np.asarray(sub)[None]
                elif isinstance(sub, Mapping):
                    _walk(out, f"{top}.{mod}.{name}", sub)
                else:
                    out[f"{top}.{mod}.{name}"] = np.asarray(sub)
        else:
            raise KeyError(f"unhandled JAX param {key}")
    return _tensors(out)


def _numpy(t, transpose: bool = False) -> np.ndarray:
    """A tensor (or array) as numpy on the host, bf16 widened to fp32;
    `transpose` reverses its axes first (where it lies, on the card)."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if transpose:
            t = t.permute(*reversed(range(t.ndim))).contiguous()
        t = t.to("cpu")
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.ascontiguousarray(np.asarray(t).T) if transpose else np.asarray(t)


def _jax_leaf(parts, t):
    """(path, value) of a block or embedding tensor in the JAX tree: an
    nn.Linear / convolution weight is a flax kernel, transposed back
    (_walk's .T), a token embedding's weight its `embedding`, a norm's 1-D
    weight stays `weight`."""
    *sub, leaf = parts
    if leaf == "weight":
        if sub and sub[-1] == "token_emb":
            return tuple(sub) + ("embedding",), _numpy(t)
        if len(t.shape) >= 2:
            return tuple(sub) + ("kernel",), _numpy(t, transpose=True)
    return tuple(parts), _numpy(t)


def to_jax_params(state: Mapping[str, Any], config) -> Dict:
    """The JAX FourM's `params` tree (nested dicts of numpy arrays) of a
    reference-named state dict: the inverse of from_jax_params, by the rules
    of fourm_tpu/utils/checkpoint.py:138 import_fourm_state_dict. A
    `pos_emb` (the reference's (1, N, D)) becomes the JAX (N, D) table, as
    there; the port's state dicts hold none where the table is sin-cos."""
    params: Dict = {}

    def put(path, value):
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value

    for key, t in state.items():
        parts = key.split(".")
        top = parts[0]
        if top in ("encoder", "decoder") and len(parts) > 2 and parts[1].isdigit():
            path, v = _jax_leaf(parts[2:], t)
            put((f"{top}_{parts[1]}",) + path, v)
        elif top in ("encoder_norm", "decoder_norm", "decoder_proj_context"):
            path, v = _jax_leaf(parts[1:], t)
            put((top,) + path, v)
        elif key == "mask_token":
            put(("mask_token",), _numpy(t).reshape(-1))
        elif key == "register_tokens":
            put(("register_tokens",), _numpy(t).reshape(t.shape[-2], t.shape[-1]))
        elif top in ("encoder_embeddings", "decoder_embeddings") and len(parts) > 2:
            mod, rest = parts[1], parts[2:]
            if rest == ["mod_emb"]:
                shared = top == "encoder_embeddings" or config.share_modality_embeddings
                put((f"mod_emb_{mod}" if shared else f"dec_mod_emb_{mod}",),
                    _numpy(t).reshape(-1))
            elif rest == ["pos_emb"]:
                put((f"{top}_{mod}", "pos_emb"), _numpy(t).reshape(t.shape[-2], t.shape[-1]))
            else:
                path, v = _jax_leaf(rest, t)
                put((f"{top}_{mod}",) + path, v)
        else:
            raise KeyError(f"unhandled FourM tensor {key}")
    return params


def from_jax_block_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The state dict of one block of ops/transformer.py (Block,
    DecoderBlock, CrossAttentionBlock) from its JAX parameter tree, mapped
    as from_jax_params maps each layer of a FourM."""
    out: Dict[str, np.ndarray] = {}
    for key, val in params.items():
        _walk(out, key, val)
    return _tensors(out)


def from_jax_vit_params(params: Mapping, img_size: int = 224) -> Dict[str, torch.Tensor]:
    """The port's FourMViT state dict from a JAX FourMViT parameter tree
    (models/fm_vit.py): the encoder as from_jax_params maps a FourM's, and
    the Dense head."""
    from types import SimpleNamespace

    enc = SimpleNamespace(encoder_modalities=(f"rgb@{img_size}",), decoder_modalities=(),
                          share_modality_embeddings=False)
    out = from_jax_params({k: v for k, v in params.items() if k != "head"}, enc)
    if "head" in params:
        tmp: Dict[str, np.ndarray] = {}
        _walk(tmp, "head", params["head"])
        out.update(_tensors(tmp))
    return out


def _own(v: np.ndarray) -> np.ndarray:
    """v itself where it owns its writeable contiguous data (an array the
    bridge or utils/orbax.py made), else a copy (a view of the caller's
    tree, or JAX's read-only arrays)."""
    v = np.asarray(v)
    ok = v.base is None and v.flags.writeable and v.flags.c_contiguous
    return v if ok else np.array(v, copy=True)


def _tensors(out: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(_own(v)) for k, v in out.items()}


# flax module names -> the reference's (fourm_tpu/utils/checkpoint.py:_VQ_SEG_MAP)
_VQ_SEG_MAP = [
    (re.compile(r"^blocks_(\d+)$"), lambda m: f"blocks.{m.group(1)}"),
    (re.compile(r"^mid_block_(\d+)$"), lambda m: f"mid_block.{m.group(1)}"),
    (re.compile(r"^down_(\d+)_resnet_(\d+)$"),
     lambda m: f"down_blocks.{m.group(1)}.resnets.{m.group(2)}"),
    (re.compile(r"^down_(\d+)_downsample$"), lambda m: f"down_blocks.{m.group(1)}.downsamplers.0"),
    (re.compile(r"^up_(\d+)_resnet_(\d+)$"),
     lambda m: f"up_blocks.{m.group(1)}.resnets.{m.group(2)}"),
    (re.compile(r"^up_(\d+)_upsample$"), lambda m: f"up_blocks.{m.group(1)}.upsamplers.0"),
    (re.compile(r"^out_conv_(\d+)$"), lambda m: f"out_conv.{m.group(1)}"),
    (re.compile(r"^mlp_fc(\d)$"), lambda m: f"mlp.fc{m.group(1)}"),
    (re.compile(r"^xattn_(q|kv|proj)$"), lambda m: f"cross_attn.{m.group(1)}"),
    (re.compile(r"^emb_proj_(\d)$"), lambda m: f"emb_proj.{m.group(1)}"),
    (re.compile(r"^block_(\d)$"), lambda m: f"block.{m.group(1)}"),
    (re.compile(r"^layernorms_(\d+)$"), lambda m: f"layernorms.{m.group(1)}"),
    (re.compile(r"^layers_(\d+)$"), lambda m: f"layers.{m.group(1)}"),
]
_VQ_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight"}


def _vq_segment(seg: str) -> str:
    for pat, repl in _VQ_SEG_MAP:
        m = pat.match(seg)
        if m:
            return repl(m)
    return seg


def _vq_tree(out: Dict[str, np.ndarray], path: list, tree: Mapping) -> None:
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            _vq_tree(out, path + [_vq_segment(name)], sub)
            continue
        arr = np.asarray(sub, dtype=np.float32)
        if name == "kernel":  # Dense (in, out) -> (out, in); conv -> (out|in, in|out, kh, kw)
            arr = arr.T if arr.ndim == 2 else np.transpose(arr, (3, 2, 0, 1))
        out[".".join(path + [_VQ_LEAF.get(name, name)])] = np.ascontiguousarray(arr)


CODEBOOK_STATE = ("embed", "embed_avg", "cluster_size", "initted")


def from_jax_vq_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of the port's VQ, VQVAE, DiVAE or VQControlNet (or of a
    decoder module such as Token2VAE) from the JAX module's variables, under
    the names of fourm_tpu/utils/checkpoint.py:_vq_torch_name: the params,
    and of each codebook collection `embed` and its EMA state (`embed_avg`,
    `cluster_size`, `initted`, where present) as
    `<quantizer>._codebook.<name>`."""
    out: Dict[str, np.ndarray] = {}
    _vq_tree(out, [], variables["params"])
    for path, cb in _codebooks(variables.get("codebook", {}), []):
        for name in CODEBOOK_STATE:
            if name in cb:
                out[f"{'.'.join(path) or 'quantize'}._codebook.{name}"] = np.asarray(
                    cb[name], np.float32)
    return _tensors(out)


def _codebooks(tree: Mapping, path: list):
    if "embed" in tree and not isinstance(tree["embed"], Mapping):
        yield path, tree
        return
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _codebooks(v, path + [k])


def from_jax_teacher_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of the port's ViTTeacher from a JAX ViTTeacher's params."""
    out: Dict[str, np.ndarray] = {}
    _vq_tree(out, [], params)
    return _tensors(out)


def _adam_states(state):
    """The optax ScaleByAdamState(s) in an optimizer state: any node with
    count, mu and nu (attributes, or the keys of a mapping as
    utils/orbax.py:read_orbax_tree gives them), found through tuples,
    lists, NamedTuples and mappings."""
    if isinstance(state, Mapping):
        if all(f in state for f in ("count", "mu", "nu")):
            yield SimpleNamespace(count=state["count"], mu=state["mu"], nu=state["nu"])
        else:
            for sub in state.values():
                yield from _adam_states(sub)
    elif all(hasattr(state, f) for f in ("count", "mu", "nu")):
        yield state
    elif isinstance(state, (tuple, list)):
        for sub in state:
            yield from _adam_states(sub)


def from_jax_adam_state(opt_state, config) -> dict:
    """The port's optimizer state from a JAX optimizer state: the AdamW
    moments under the parameter names of `from_jax_params` and the step
    count, {"count": int, "mu": {name: tensor}, "nu": {name: tensor}}, for
    `FusedAdamW.load_state_dict`. Takes the optax chain of
    fourm_tpu.utils.optim.create_optimizer (one ScaleByAdamState; moment
    trees of variables `{"params": ...}` or of params)."""
    found = list(_adam_states(opt_state))
    if len(found) != 1:
        raise ValueError(f"expected one AdamW state in the optimizer state, found {len(found)}")
    adam = found[0]

    def moments(tree):
        tree = tree["params"] if "params" in tree else tree
        return from_jax_params(_numpy_tree(tree), config)

    return {"count": int(np.asarray(adam.count)), "mu": moments(adam.mu),
            "nu": moments(adam.nu)}


def jax_params_of(tree: Mapping) -> Mapping:
    """The FourM `params` of a tree read from a JAX run: a TrainState
    (`step`, `params`: the variables, `opt_state`), a variables export
    (train_4m's weights/step_N: {"params": ...}), or the params themselves."""
    if "opt_state" in tree:
        tree = tree["params"]
    while set(tree) == {"params"}:  # the variables, or a TrainState read by its params
        tree = tree["params"]
    return tree


def from_jax_train_state(tree: Mapping, config) -> Dict[str, Any]:
    """The port's checkpoint dict ({"step", "model", "optimizer"}, what
    cli/train_4m.py:restore_checkpoint loads) of a JAX TrainState
    (fourm_tpu/parallel/train.py:28) read by read_orbax_tree: the fp32
    masters, the AdamW moments and count, the step."""
    return {"step": int(np.asarray(tree["step"])),
            "model": from_jax_params(jax_params_of(tree), config),
            "optimizer": from_jax_adam_state(tree["opt_state"], config)}


def to_jax_train_state(model_state: Mapping[str, Any], opt_state: Mapping[str, Any], step: int,
                       config) -> Dict:
    """The JAX train_4m's TrainState of the port's fp32 masters and
    FusedAdamW state ({"count", "mu", "nu"}), as nested dicts (int keys: a
    tuple's entries): `params` the variables, `opt_state` the state of the
    chain fourm_tpu/utils/optim.py:create_optimizer builds with the CLI's
    defaults (clip_by_global_norm: no state; adamw: ScaleByAdamState, the
    masked weight decay's empty state, the schedule's count)."""
    count = np.int32(opt_state["count"])
    adam = {"count": count, "mu": {"params": to_jax_params(opt_state["mu"], config)},
            "nu": {"params": to_jax_params(opt_state["nu"], config)}}
    return {"step": np.int32(step), "params": {"params": to_jax_params(model_state, config)},
            "opt_state": {0: None, 1: {0: adam, 1: {"inner_state": None}, 2: {"count": count}}}}


def _numpy_tree(tree):
    if isinstance(tree, Mapping):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)


# ------------------------------------------------------------ safetensors

_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
              "U8": torch.uint8, "BOOL": torch.bool}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def _local_file(path: str) -> str:
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{path}: no such file. The port reads checkpoints from local files only; a "
            "Hugging Face Hub id (e.g. EPFL-VILAB/4M-21_B) must be downloaded first")
    return path


def _tensor_at(buf, start: int, info: dict, name: str) -> torch.Tensor:
    dtype = _ST_DTYPES.get(info["dtype"])
    if dtype is None:
        raise ValueError(f"{name}: safetensors dtype {info['dtype']} is not supported "
                         f"(supported: {', '.join(_ST_DTYPES)})")
    shape = [int(n) for n in info["shape"]]
    begin, end = info["data_offsets"]
    numel = int(np.prod(shape))
    itemsize = torch.empty((), dtype=dtype).element_size()
    if end - begin != numel * itemsize:
        raise ValueError(f"{name}: data_offsets span {end - begin} bytes, shape {shape} of "
                         f"{info['dtype']} needs {numel * itemsize}")
    if numel == 0:
        return torch.empty(shape, dtype=dtype)
    offset = start + begin
    if offset % itemsize:  # an unaligned tensor: a copy of its bytes
        return torch.frombuffer(bytearray(buf[offset:offset + end - begin]),
                                dtype=dtype).reshape(shape)
    return torch.frombuffer(buf, dtype=dtype, count=numel, offset=offset).reshape(shape)


def load_safetensors(path: str, return_metadata: bool = True):
    """{name: tensor} of a safetensors file, each tensor a CPU view of the
    file's private mapping (writing to one never reaches the file), and,
    with return_metadata, the parsed `__metadata__` (parse_metadata_value
    on each value) -> (tensors, metadata)."""
    with open(_local_file(path), "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    start = 8 + n
    tensors = {name: _tensor_at(buf, start, info, name)
               for name, info in header.items() if name != "__metadata__"}
    if not return_metadata:
        return tensors
    metadata = header.get("__metadata__") or {}
    return tensors, {k: parse_metadata_value(v) for k, v in metadata.items()}


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str,
                     metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write {name: tensor} as a safetensors file (tensors in name order, the
    header padded with blanks to 8 bytes); metadata values must be
    strings."""
    items = []
    for name in sorted(tensors):
        t = tensors[name]
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name here")
        items.append((name, t.detach().to("cpu").contiguous()))
    header: Dict[str, Any] = {}
    if metadata:
        if not all(isinstance(v, str) for v in metadata.values()):
            raise TypeError("safetensors metadata values must be strings")
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name, t in items:
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for _, t in items:
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)


def _lists(v):
    if isinstance(v, (list, tuple)):
        return [_lists(x) for x in v]
    if isinstance(v, dict):
        return {k: _lists(x) for k, x in v.items()}
    return v


def parse_metadata_value(v: Any) -> Any:
    """One `__metadata__` value as the JAX loader reads it
    (fourm_tpu/utils/checkpoint.py:270-283): a string under 10 000
    characters is parsed; others are kept as they are. A dict or list is
    JSON or a Python literal (tuples as lists); anything else is read by
    the port's YAML subset (utils/config.py) after the JAX loader's
    replace of "None" by "null", so a form outside all three raises."""
    from .config import safe_load

    if not isinstance(v, str) or len(v) >= 10_000:
        return v
    text = v.strip()
    if text[:1] in "{[":
        try:
            return json.loads(text)
        except ValueError:
            pass
        try:
            return _lists(ast.literal_eval(text))
        except (ValueError, SyntaxError):
            pass
    return safe_load(v.replace("None", "null"), "safetensors metadata")


# --------------------------------------------------------- FourM releases

_ACT_MAP = {"GELU": "gelu", "SiLU": "silu", "ReLU": "relu"}


def fourm_config_from_metadata(cfg: Dict[str, Any]):
    """The port's FourMConfig from the reference FM config dict (reference
    fm.py:783-831: domains_in / domains_out and the architecture keys), as
    fourm_tpu/utils/checkpoint.py:290-314 builds it: float32 compute (the
    metadata names no dtype), untied logits."""
    from ..models.fourm import FourMConfig

    return FourMConfig(
        encoder_modalities=tuple(cfg["domains_in"]),
        decoder_modalities=tuple(cfg["domains_out"]),
        dim=cfg.get("dim", 768),
        encoder_depth=cfg.get("encoder_depth", 12),
        decoder_depth=cfg.get("decoder_depth", 12),
        num_heads=cfg.get("num_heads", 12),
        mlp_ratio=cfg.get("mlp_ratio", 4.0),
        qkv_bias=cfg.get("qkv_bias", True),
        proj_bias=cfg.get("proj_bias", True),
        mlp_bias=cfg.get("mlp_bias", True),
        norm_bias=cfg.get("norm_bias", True),
        act=_ACT_MAP.get(cfg.get("act_layer", "GELU"), "gelu"),
        gated_mlp=cfg.get("gated_mlp", False),
        qk_norm=cfg.get("qk_norm", False),
        decoder_sep_mask=cfg.get("decoder_sep_mask", True),
        decoder_causal_mask=cfg.get("decoder_causal_mask", False),
        num_register_tokens=cfg.get("num_register_tokens", 0),
        share_modality_embeddings=cfg.get("share_modality_embeddings", True),
        decoder_share_embedding=False,  # the releases untie the logits (fm.py:813-815)
    )


def _sincos_table(model: torch.nn.Module, key: str):
    """(table, one_d) of the embedding that `key` (`...embeddings.{mod}.
    pos_emb`) names: its computed (N, D) sin-cos table and whether it is a
    sequence's; None if that module computes none."""
    try:
        module = model.get_submodule(key.rsplit(".", 1)[0])
    except AttributeError:
        return None
    for name, one_d in (("sincos_table", True), ("pos_table", False)):
        table = getattr(module, name, None)
        if isinstance(table, torch.Tensor):  # a sequence decoder's pos_table is a method
            return table, one_d
    return None


def _check_sincos(key: str, value: torch.Tensor, table: torch.Tensor, one_d: bool) -> None:
    """A file's sin-cos table, (1, N, D) or, for an image grid, the
    reference's (1, D, h, w) (its rearrange 'b (h w) d -> b d h w'),
    against the computed one."""
    N, D = table.shape
    v = value.detach().float().cpu()
    if (not one_d and v.ndim == 4 and v.shape[0] == 1 and v.shape[1] == D
            and v.shape[2] * v.shape[3] == N):
        got = v[0].permute(1, 2, 0).reshape(N, D)
    elif v.ndim in (2, 3) and v.shape[-1] == D and (v.ndim == 2 or v.shape[0] == 1):
        got = v.reshape(-1, D)
    else:
        raise ValueError(f"{key}: a sin-cos table of shape {tuple(v.shape)}; the port's is "
                         f"({N}, {D}), stored as (1, {N}, {D})"
                         + ("" if one_d else f" or (1, {D}, h, w)"))
    if got.shape[0] != N:
        raise ValueError(f"{key}: a sin-cos table of {got.shape[0]} positions, the port uses {N}")
    err = float((got - table.detach().float().cpu()).abs().max())
    if err > 1e-6:
        raise ValueError(f"{key}: the file's sin-cos table differs from the port's computed "
                         f"table by up to {err:.3g} (tolerance 1e-6)")


def load_fourm_state_dict(model: torch.nn.Module, state: Mapping[str, torch.Tensor],
                          drop_pos_emb: bool = False, strict: bool = True):
    """Copy a reference-named FourM state dict into `model`'s own
    parameters (load_state_dict copies in place, so a padded fc2 storage
    stays). A `pos_emb` the model computes as a sin-cos table is held to
    that table (_check_sincos) and dropped. strict: a key the model has no
    place for, or a parameter the state lacks, raises KeyError naming it.
    drop_pos_emb (the --finetune warm start, reference run_training_4m.py:
    475-487) leaves out every `.pos_emb` key first; with strict=False
    (that warm start, as the reference's load_state_dict(strict=False))
    the keys left out either way are returned: (missing, unexpected)."""
    own = model.state_dict()
    sd = {}
    for k, t in state.items():
        if drop_pos_emb and ".pos_emb" in k:
            continue
        if k.endswith(".pos_emb") and k not in own:
            found = _sincos_table(model, k)
            if found is not None:
                _check_sincos(k, t, *found)
                continue
        sd[k] = t
    missing = [k for k in own if k not in sd and not (drop_pos_emb and ".pos_emb" in k)]
    unexpected = [k for k in sd if k not in own]
    if strict and (missing or unexpected):
        raise KeyError(f"checkpoint keys the model has no place for: {unexpected}; model "
                       f"parameters the checkpoint lacks: {missing}")
    model.load_state_dict({k: v for k, v in sd.items() if k in own}, strict=False)
    return missing, unexpected


def load_fourm_safetensors(path: str, config_override: Optional[Dict] = None,
                           device: Optional[str] = None):
    """A released 4M safetensors checkpoint (a local file; fourm_tpu/utils/
    checkpoint.py:317-334 without its Hub download) -> (FourMConfig, FourM).
    The model is built on `device` (the card unless "cpu" is asked), the
    file's tensors copied into its fp32 parameters, then the whole module
    cast to the compute dtype, as inference holds it. config_override
    updates the metadata's config; its "dtype" (e.g. "bfloat16", which the
    kernels compute in) sets the compute dtype, float32 without it."""
    from ..api import resolve_device
    from ..models.fourm import FourM

    tensors, metadata = load_safetensors(path)
    cfg_dict = dict(metadata.get("config") or {})
    cfg_dict.update(config_override or {})
    config = dataclasses.replace(fourm_config_from_metadata(cfg_dict),
                                 dtype=(config_override or {}).get("dtype", "float32"))
    dev = resolve_device(device)
    with torch.device(dev):
        model = FourM(config)
    load_fourm_state_dict(model, tensors)
    return config, model.to(device=dev, dtype=config.compute_dtype).eval()


# ------------------------------------------------------- VQ tokenizers

# sin-cos tables the port computes
_VQ_UNUSED = ("pos_emb",)


def import_vq_state_dict(model: torch.nn.Module, state: Mapping[str, torch.Tensor]):
    """Copy a reference-named tokenizer state dict (the names of
    from_jax_vq_variables; the codebook as `quantize._codebook.embed`) into
    a VQ / VQVAE / DiVAE of the port, in place (each parameter keeps its
    dtype). `pos_emb` tables may be present or absent. So may a codebook's
    EMA state: a file without it (the release files) gets the JAX
    package's init from its `embed` (quantizer.py:150-159: embed_avg =
    embed, cluster_size = 0, initted = 1). Any other key the model has no
    place for, or parameter the state lacks, raises KeyError naming it (the
    JAX importer prints the missing ones and keeps their init,
    fourm_tpu/utils/checkpoint.py:458-461)."""
    own = model.state_dict()
    sd = {k: v for k, v in state.items() if not k.endswith(_VQ_UNUSED)}
    for key in [k for k in own if k.endswith("_codebook.embed") and k in sd]:
        base = key[:-len("embed")]
        if base + "embed_avg" not in sd:
            sd[base + "embed_avg"] = sd[key]
            sd[base + "cluster_size"] = torch.zeros(sd[key].shape[0])
            sd[base + "initted"] = torch.tensor(1.0)
    missing = [k for k in own if k not in sd]
    unexpected = [k for k in sd if k not in own]
    if missing or unexpected:
        raise KeyError(f"tokenizer keys the model has no place for: {unexpected}; model "
                       f"parameters the checkpoint lacks: {missing}")
    model.load_state_dict(sd, strict=True)
    return model


def export_vq_safetensors(model: torch.nn.Module, config: Mapping[str, Any], path: str,
                          overrides: Optional[Mapping[str, torch.Tensor]] = None) -> None:
    """A tokenizer of the port in the release format: its reference-named
    state dict in fp32 (with `overrides`, {name: tensor} such as a model
    EMA, in place of those entries), the config as YAML metadata
    (fourm_tpu/utils/checkpoint.py:464-472; utils/config.py:dump_yaml
    writes what yaml.safe_dump writes). vq/loader.py:get_image_tokenizer
    reads it."""
    from .config import dump_yaml

    tensors = {k: v.detach().float() for k, v in {**model.state_dict(),
                                                   **(overrides or {})}.items()}
    save_safetensors(tensors, path, metadata={"config": dump_yaml(dict(config))})


def load_vq_safetensors(path: str, model: torch.nn.Module):
    """A released tokenizer safetensors checkpoint into `model` (a VQ, VQVAE
    or DiVAE of the port built from the same config) -> (config metadata,
    model)."""
    tensors, metadata = load_safetensors(path)
    return metadata.get("config", {}), import_vq_state_dict(model, tensors)


# ------------------------------------------------------------ train state

def save_checkpoint(ckpt_dir: str, state: Mapping[str, Any], step: int, keep: int = 3) -> None:
    """`state` (a dict of tensors, numbers, strings, lists and dicts) as
    `{ckpt_dir}/step_{step}/state.pt`, written under a temporary name and
    renamed, so a run cut while writing leaves no half-written step_N;
    an existing step_N is replaced. Then only the newest `keep` stay."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step}")
    tmp = os.path.join(ckpt_dir, f".step_{step}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(dict(state), os.path.join(tmp, "state.pt"))
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    _prune_checkpoints(ckpt_dir, keep)


def _prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    steps = latest_checkpoint_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def latest_checkpoint_steps(ckpt_dir: str):
    """The steps of the `step_N` directories under ckpt_dir, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in
                  (re.fullmatch(r"step_(\d+)", n) for n in os.listdir(ckpt_dir)) if m)


def load_checkpoint(ckpt_dir: str, step: int, map_location=None) -> Dict[str, Any]:
    """The state saved at `step`: the port's (tensors onto map_location, as
    torch.load), or, where the JAX package's orbax wrote `step_N`,
    read_orbax_tree's nested dicts of numpy arrays."""
    from .orbax import is_orbax_step, read_orbax_tree

    path = os.path.join(ckpt_dir, f"step_{step}")
    if is_orbax_step(path):
        return read_orbax_tree(path)
    return torch.load(os.path.join(path, "state.pt"), map_location=map_location,
                      weights_only=True)


def load_fourm_weights(ckpt_dir: str, step: int, config) -> Dict[str, torch.Tensor]:
    """The reference-named FourM state dict saved at `step`: the port's
    params export or the `model` of its train checkpoint, or, in the JAX
    package's orbax directory, the `params` of a variables export or of a
    TrainState (only those are read)."""
    from .orbax import is_orbax_step, read_orbax_tree

    path = os.path.join(ckpt_dir, f"step_{step}")
    if is_orbax_step(path):
        return from_jax_params(jax_params_of(read_orbax_tree(path, prefix=("params",))), config)
    state = load_checkpoint(ckpt_dir, step, map_location="cpu")
    return state["model"] if "optimizer" in state else state  # train_checkpoint's dict


def auto_resume(ckpt_dir: str, map_location=None) -> Tuple[Optional[Dict[str, Any]], int]:
    """The newest checkpoint under ckpt_dir -> (state, step), or (None, 0)
    when there is none. A checkpoint that cannot be read raises."""
    steps = latest_checkpoint_steps(ckpt_dir)
    if not steps:
        return None, 0
    return load_checkpoint(ckpt_dir, steps[-1], map_location), steps[-1]
