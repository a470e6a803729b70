"""Batch chained generation CLI, PyTorch port (fourm_tpu/cli/generate.py;
reference run_generation.py:69-866): run a conditioning -> targets schedule
over a dataset (a folder of images, text prompts, or empty samples) with
optional 448px super-resolution, sharded over processes; save the tokens
(.npz) and, with tokenizers, the decoded images (.png) and text (.txt).

Checkpoints are local files: a released 4M `.safetensors` (the config in
its metadata) or a train_4m run directory of the port (`config.json` and
`weights/step_N`); tokenizers `.safetensors` or `.pth`; the text tokenizer
a `tokenizer.json`. Everything is read by the port itself, and images are
written by the port's own PNG writer (data/image_io.py): the machine
with the card has no safetensors, PyYAML, tokenizers or PIL. The folder
dataset reads PNG and JPEG files with the port's decoders.

Usage:
  python -m fourm_torch.cli.generate --fm_ckpt 4m-21_b.safetensors \\
      --text_tokenizer_path text_tokenizer_4m_wordpiece_30k.json \\
      --tokenizer tok_rgb=rgb_16k.safetensors --dataset prompts --prompts_tsv p.tsv \\
      --config cfgs/default/generation/settings_base/T2CR_roar49-25_cfg3_t6-0.5.yaml
  (on the card in bf16 by default; --device cpu runs the plain twins in fp32)
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data import image_io


def get_parser():
    p = argparse.ArgumentParser("4M batch generation (fourm_torch)")
    p.add_argument("--fm_ckpt", required=True,
                   help="a released .safetensors, or a train_4m run dir of the port")
    p.add_argument("--fm_sr_ckpt", default=None)
    p.add_argument("--text_tokenizer_path", default=None)
    p.add_argument("--cond_domains", default="rgb@224", help="hyphen-separated")
    p.add_argument("--target_domains", default="tok_rgb@224-caption")
    p.add_argument("--dataset", default="empty", choices=["folder", "prompts", "empty"])
    p.add_argument("--data_path", default=None)
    p.add_argument("--prompts_tsv", default=None, help="TSV of text prompts (Parti-style)")
    p.add_argument("--num_samples", type=int, default=4)
    p.add_argument("--num_variations", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--top_k", type=float, default=0.0)
    p.add_argument("--top_p", type=float, default=0.0)
    # per-target schedule overrides, hyphen-separated with single-value
    # broadcast (reference run_generation.py string_to_list / settings configs)
    p.add_argument("--tokens_per_target", default=None)
    p.add_argument("--autoregression_schemes", default=None,
                   help="e.g. roar-roar-autoregressive")
    p.add_argument("--decoding_steps", default=None)
    p.add_argument("--token_decoding_schedules", default=None)
    p.add_argument("--temps", default=None)
    p.add_argument("--temp_schedules", default=None)
    p.add_argument("--cfg_scales", default=None)
    p.add_argument("--cfg_schedules", default=None)
    p.add_argument("--cfg_grow_conditioning", type=bool, default=True)
    p.add_argument("--perform_sr", action="store_true")
    p.add_argument("--tokenizer", action="append", default=[], metavar="MOD=PATH",
                   help="tokenizer checkpoint per modality key (e.g. "
                        "tok_rgb=ckpts/rgb_16k.safetensors); repeatable. When given, "
                        "generated tokens are decoded and saved as images / text "
                        "(reference run_generation.py:662+)")
    p.add_argument("--detokenizer_steps", type=int, default=50,
                   help="diffusion steps for DiVAE detokenization")
    p.add_argument("--save_tokens", action="store_true", default=True)
    p.add_argument("--output_dir", default="out/generation")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--shard_id", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain twins)")
    p.add_argument("--dtype", default=None,
                   help="compute dtype of the models: bfloat16 (default on cuda, the "
                        "kernels') or float32 (default on cpu)")
    return p


def _hyphen_list(value, n, cast):
    """'a-b-c' -> [a, b, c]; a single value broadcasts to n (reference
    run_generation.py:309 string_to_list)."""
    parts = str(value).split("-")
    vals = [cast(v) for v in parts]
    if len(vals) == 1:
        vals = vals * n
    if len(vals) != n:
        raise SystemExit(f"expected 1 or {n} hyphen-separated values, got {value!r}")
    return vals


def schedule_overrides(args, sampler, cond_domains, targets):
    """Per-target schedule defaults: the demo defaults with any given
    settings-config field overriding (the reference settings_base /
    settings_sr configs set these keys)."""
    fields = {
        "tokens_per_target": (args.tokens_per_target, int),
        "autoregression_scheme": (args.autoregression_schemes, str),
        "decoding_steps": (args.decoding_steps, int),
        "token_decoding_schedule": (args.token_decoding_schedules, str),
        "temp": (args.temps, float),
        "temp_schedule": (args.temp_schedules, str),
        "cfg_scale": (args.cfg_scales, float),
        "cfg_schedule": (args.cfg_schedules, str),
    }
    if all(v is None for v, _ in fields.values()):
        return None
    base = sampler.resolve_defaults(cond_domains)
    n = len(targets)
    cols = {k: (_hyphen_list(v, n, cast) if v is not None else None)
            for k, (v, cast) in fields.items()}
    out = {}
    for i, t in enumerate(targets):
        d = dict(base[t])
        for k, vals in cols.items():
            if vals is not None:
                d[k] = vals[i]
        out[t] = d
    return out


def load_fm(path: str, dtype: str = "float32", device: str = "cuda"):
    """A FourM of the port on `device`, computing in `dtype`: a released
    .safetensors (config in the metadata), or a train_4m run directory
    (config.json and its newest weights/step_N params export) of the port
    or of the JAX package (an orbax directory, read by utils/orbax.py; JAX
    cli/generate.py:101-142)."""
    import dataclasses

    import torch

    from ..api import resolve_device
    from ..models import FourM, FourMConfig
    from ..utils.checkpoint import (latest_checkpoint_steps, load_fourm_safetensors,
                                    load_fourm_state_dict, load_fourm_weights)

    if path.endswith(".safetensors"):
        return load_fourm_safetensors(path, config_override={"dtype": dtype}, device=device)[1]
    if os.path.isdir(path):
        cfg_path = os.path.join(path, "config.json")
        if not os.path.exists(cfg_path):
            raise SystemExit(f"{path}: no config.json (written by train_4m)")
        with open(cfg_path) as f:
            cfg_dict = json.load(f)
        for k in ("encoder_modalities", "decoder_modalities"):
            cfg_dict[k] = tuple(cfg_dict[k])
        config = dataclasses.replace(FourMConfig(**cfg_dict), dtype=dtype)
        ckpt_dir = os.path.join(path, "weights")
        steps = latest_checkpoint_steps(ckpt_dir)
        if not steps:
            raise SystemExit(f"no params export under {ckpt_dir} (written by train_4m "
                             "beside checkpoints/)")
        dev = resolve_device(device)
        with torch.device(dev):
            model = FourM(config)
        load_fourm_state_dict(model, load_fourm_weights(ckpt_dir, steps[-1], config))
        return model.to(device=dev, dtype=config.compute_dtype).eval()
    raise SystemExit(f"unsupported checkpoint format: {path} "
                     "(expected .safetensors or a train_4m run dir)")


def iter_samples(args, text_tokenizer):
    """Yield (sample_id, sample_dict) conditioning inputs (reference
    get_dataset, run_generation.py:408-470)."""
    if args.dataset == "folder":
        from ..data.modality_info import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD

        mean = np.asarray(IMAGENET_DEFAULT_MEAN, dtype=np.float32)
        std = np.asarray(IMAGENET_DEFAULT_STD, dtype=np.float32)
        files = sorted(os.listdir(args.data_path))[: args.num_samples]
        for f in files:
            img = image_io.resize(image_io.read_rgb(os.path.join(args.data_path, f)), (224, 224))
            arr = (img.astype(np.float32) / 255.0 - mean) / std
            yield f, {"rgb@224": arr[None]}
    elif args.dataset == "prompts":
        with open(args.prompts_tsv) as fh:
            lines = [l.split("\t")[0] for l in fh.read().splitlines() if l][: args.num_samples]
        for i, prompt in enumerate(lines):
            yield f"prompt_{i:05d}", {"caption": prompt}
    else:  # empty / unconditional
        for i in range(args.num_samples):
            yield f"empty_{i:05d}", {}


def write_png(path: str, arr: np.ndarray) -> None:
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG (rows unfiltered, zlib
    level 6; data/image_io.py:write_png): the pixels PIL's
    Image.fromarray(arr).save(path) writes."""
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {arr.dtype} {arr.shape}")
    with open(path, "wb") as f:
        f.write(image_io.write_png(arr))


def _save_decoded(base: str, val) -> None:
    """A decoded output as the JAX CLI saves it: text as .txt, an image (the
    first of a batch; grey stacked to RGB; floats clipped to [0, 1] and
    scaled to uint8) as .png; other outputs (metadata dicts) are not saved."""
    if isinstance(val, str) or (isinstance(val, list) and val and isinstance(val[0], str)):
        with open(base + ".txt", "w") as fh:
            fh.write("\n".join(val) if isinstance(val, list) else val)
    elif isinstance(val, np.ndarray) and val.ndim >= 2:
        arr = val[0] if val.ndim == 4 else val
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, -1)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        write_png(base + ".png", arr)


def main(args=None):
    from ..api import FourMSampler
    from ..utils.config import parse_args_with_config
    from ..utils.decoding import TokenizerBundle, to_numpy
    from ..utils.text_tokenizer import load_tokenizer
    from ..vq.loader import get_image_tokenizer

    args = parse_args_with_config(get_parser(), args)
    dtype = args.dtype or ("float32" if args.device == "cpu" else "bfloat16")
    os.makedirs(args.output_dir, exist_ok=True)
    cond_domains = [d for d in args.cond_domains.split("-") if d] if args.cond_domains else []
    target_domains = args.target_domains.split("-")

    model = load_fm(args.fm_ckpt, dtype, args.device)
    fm_sr = load_fm(args.fm_sr_ckpt, dtype, args.device) if args.fm_sr_ckpt else None
    text_tokenizer = load_tokenizer(args.text_tokenizer_path) if args.text_tokenizer_path else None
    tokenizers = {}
    for spec in args.tokenizer:
        mod, tok_path = spec.split("=", 1)
        tok_model, _ = get_image_tokenizer(tok_path, config_override={"dtype": dtype},
                                           device=args.device)
        tokenizers[mod] = TokenizerBundle(tok_model)

    sampler = FourMSampler(model, text_tokenizer, top_k=args.top_k, top_p=args.top_p,
                           device=args.device, tokenizers=tokenizers, fm_sr=fm_sr)
    count = 0
    for idx, (sample_id, sample) in enumerate(iter_samples(args, text_tokenizer)):
        if idx % args.num_shards != args.shard_id:
            continue
        for var in range(args.num_variations):
            seed = args.seed + idx * 1000 + var
            mod_dict = sampler.prepare_sample(sample, cond_domains, target_domains,
                                              args.batch_size)
            schedule = sampler.build_schedule(
                cond_domains, target_domains,
                defaults=schedule_overrides(args, sampler, cond_domains, target_domains),
                cfg_grow_conditioning=args.cfg_grow_conditioning)
            out = sampler.generate(mod_dict, schedule, seed=seed)
            if args.perform_sr and sampler.sampler_sr is not None:
                out = sampler.super_resolve(out, seed=seed)
            if args.save_tokens:
                path = os.path.join(args.output_dir, f"{sample_id}_v{var}.npz")
                np.savez(path, **{m: to_numpy(out[m]["tensor"]) for m in target_domains
                                  if m in out})
                print(f"[{count}] saved {path}")
            # decoded images / text (reference run_generation.py:662-760)
            if tokenizers or text_tokenizer is not None:
                decoded = sampler.decode(out, decoding_steps=args.detokenizer_steps, seed=seed)
                for mod, val in decoded.items():
                    _save_decoded(os.path.join(args.output_dir,
                                               f"{sample_id}_v{var}_{mod.replace('@', '_')}"),
                                  val)
            count += 1
    print(f"generated {count} outputs")


if __name__ == "__main__":
    main()
