"""Dataset pre-tokenization on one card: the port of
fourm_tpu/cli/save_vq_tokens.py (reference save_vq_tokens.py:199-402), the
bridge from a trained tokenizer to the `tok_*` arrays that pre-training
reads.

For every image of root/{domain}: its crop settings are made (1 centre + n-1
random resized crops with flips, (n, 5) [top, left, h, w, flip]) or reused
from `--crop_settings_dir`, so that the tokens of every modality stay
aligned; all crops are tokenized in one `VQ.tokenize` call (on the card: the
encoder's `attn_block` / `ln_mlp` kernels and the codebook search), and
saved as int16 (n_crops, Hq*Wq) arrays, {out_dir}/{class}/{id}.npy.
`--num_shards` / `--shard_id` split the samples between processes,
`--skip_existing` skips samples already written, and with
`--corrupt_samples_log` a sample that cannot be read is logged there; when
the log exists, only the samples it lists are (re)tokenized (reference
:98-115). Non-RGB domains are read through the DiVAE transforms
(data/transforms.py); `--task` (CLIP-B16, DINOv2-B14, DINOv2-B14-global)
tokenizes a teacher's feature maps (vq/teachers.py) of the RGB crops.

What differs from the JAX CLI, and why:
  * the tokenizer comes from `--ckpt`: a .safetensors / .pth tokenizer
    file (vq/loader.py:get_image_tokenizer, encoder only), or a
    cli/train_vqvae output directory (its `tokenizer.safetensors`); the
    JAX CLI reads an orbax `--ckpt_dir`, which the port does not read
    (ROADMAP);
  * only reading a sample (load, preprocess, crop) counts as corrupt: an
    error of the tokenizer or a kernel raises, where the JAX CLI logs it
    as the sample's;
  * crop draws come from a random.Random / np.random.RandomState pair
    seeded by `--seed` (the JAX CLI's crop boxes draw from the global
    `random`);
  * a teacher's weights are random from `--seed` (init_teacher_weights):
    reading CLIP / DINOv2 checkpoints (`--teacher_ckpt`) is not ported.

Usage:
  python -m fourm_torch.cli.save_vq_tokens --data_root data/ --domain rgb \\
      --ckpt out/divae/tokenizer.safetensors --out_dir data/tok_rgb   # on the card
"""

from __future__ import annotations

import argparse
import os
import random
import time
from typing import Optional

import numpy as np
import torch


def get_parser():
    p = argparse.ArgumentParser("VQ pre-tokenization (fourm_torch, one card)")
    p.add_argument("--data_root", required=True)
    p.add_argument("--domain", default="rgb")
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--n_crops", type=int, default=3, help="1 center + n-1 random crops")
    p.add_argument("--ckpt", required=True,
                   help="tokenizer: a .safetensors / .pth file, or a train_vqvae output dir")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--crop_settings_dir", default=None)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--shard_id", type=int, default=0)
    p.add_argument("--skip_existing", action="store_true", default=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--corrupt_samples_log", default=None,
                   help="path to a corrupt-samples log: failures are appended; if the file "
                        "exists, ONLY the listed sample ids are (re-)tokenized")
    p.add_argument("--task", default=None,
                   help="teacher feature task: CLIP-B16, DINOv2-B14, DINOv2-B14-global; "
                        "default: tokenize raw pixels of --domain")
    p.add_argument("--teacher_ckpt", default=None, help="not ported: raises")
    p.add_argument("--dtype", default="bfloat16", help="the tokenizer's compute dtype")
    p.add_argument("--device", default=None,
                   help="the card unless 'cpu' is asked (the plain PyTorch twins)")
    return p


def make_crop_settings(rng: random.Random, np_rng: np.random.RandomState, orig_size,
                       n_crops: int) -> np.ndarray:
    """1 center crop + n-1 random resized crops (scale 0.8-1, square), each
    flipped with probability 1/2, as (n, 5) int64 [top, left, h, w, flip]
    (save_vq_tokens.py:49-61; reference SaveVQDataset :138-159). The boxes
    draw from `rng`, the flips from `np_rng`."""
    from ..data.augmenters import random_resized_crop_params

    H, W = orig_size
    s = min(H, W)
    settings = [[(H - s) // 2, (W - s) // 2, s, s, 0]]
    for _ in range(n_crops - 1):
        top, left, h, w = random_resized_crop_params(H, W, (0.8, 1.0), (1.0, 1.0), rng)
        settings.append([top, left, h, w, int(np_rng.rand() < 0.5)])
    return np.asarray(settings, dtype=np.int64)


def tokenize_folder(model, data_root: str, domain: str, out_dir: str, input_size: int = 224,
                    n_crops: int = 3, crop_settings_dir: Optional[str] = None,
                    batch_size: int = 16, num_shards: int = 1, shard_id: int = 0,
                    skip_existing: bool = True, seed: int = 0, teacher=None,
                    corrupt_samples_log: Optional[str] = None) -> int:
    """Tokenize every sample of root/{domain} with `model` (a VQ of the
    port, on its device); returns the number of samples written
    (save_vq_tokens.py:64-157)."""
    from ..data.datasets import MultiModalDatasetFolder
    from ..data.transforms import default_modality_transforms, divae_modality_transforms

    rng, np_rng = random.Random(seed), np.random.RandomState(seed)
    transforms = divae_modality_transforms(rng, np_rng)
    if domain not in transforms:
        transforms.update(default_modality_transforms(rng, np_rng))
    key = domain.split("@")[0]
    if key not in transforms:  # teacher tasks read plain RGB images
        transforms[key] = transforms["rgb"]
    ds = MultiModalDatasetFolder(data_root, [domain], transforms)
    crop_settings_dir = crop_settings_dir or os.path.join(data_root, "crop_settings")
    os.makedirs(out_dir, exist_ok=True)

    only_ids = None
    if corrupt_samples_log and os.path.exists(corrupt_samples_log):
        with open(corrupt_samples_log) as f:
            only_ids = {line.strip() for line in f if line.strip()}
        print(f"[retokenize] {len(only_ids)} corrupt samples from {corrupt_samples_log}")

    n_done = 0
    t = transforms[key]
    dev = model.device
    for idx in range(shard_id, len(ds), num_shards):
        sample_id = ds.sample_ids[idx]
        out_path = os.path.join(out_dir, f"{sample_id}.npy")
        if only_ids is not None:
            if sample_id not in only_ids:
                continue
        elif skip_existing and os.path.exists(out_path):
            continue
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        try:
            img = t.preprocess(t.load(ds.paths[domain][idx]))
            H, W = img.shape[:2]
            cs_path = os.path.join(crop_settings_dir, f"{sample_id}.npy")
            if os.path.exists(cs_path):
                settings = np.load(cs_path)
            else:
                settings = make_crop_settings(rng, np_rng, (H, W), n_crops)
                os.makedirs(os.path.dirname(cs_path), exist_ok=True)
                np.save(cs_path, settings)
            crops = [t.postprocess(t.image_augment(img, (top, left, h, w), bool(flip), (H, W),
                                                   (input_size, input_size), rand_aug_idx=None))
                     for top, left, h, w, flip in settings]
        except Exception as e:  # an unreadable sample (reference :98-115)
            print(f"[data] failed to tokenize {sample_id}: {e}")
            if corrupt_samples_log:
                with open(corrupt_samples_log, "a") as f:
                    f.write(sample_id + "\n")
            continue
        x = torch.from_numpy(np.stack(crops)).to(dev)
        with torch.no_grad():
            if teacher is not None:  # the tokenizer reads the teacher's feature maps
                x = teacher(x)
            tokens = model.tokenize(x).cpu().numpy().astype(np.int16)
        np.save(out_path, tokens.reshape(tokens.shape[0], -1))
        n_done += 1
    return n_done


def tokenizer_path(ckpt: str) -> str:
    """The tokenizer file of --ckpt: the file itself, or a train_vqvae
    output directory's tokenizer.safetensors."""
    if os.path.isdir(ckpt):
        path = os.path.join(ckpt, "tokenizer.safetensors")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{ckpt}: no tokenizer.safetensors (a train_vqvae output "
                                    "directory holds one after its first checkpoint)")
        return path
    return ckpt


def build_teacher(task: str, ckpt: Optional[str], image_size: int, seed: int, device):
    from ..vq.teachers import TEACHER_PRESETS, ViTTeacher, init_teacher_weights

    if ckpt:
        raise NotImplementedError("--teacher_ckpt: reading CLIP / DINOv2 checkpoints is not "
                                  "ported; without it the teacher has random weights")
    print(f"[teacher] WARNING: no --teacher_ckpt for {task}; RANDOM weights "
          "(pipeline-validation mode, not real features)")
    teacher = init_teacher_weights(ViTTeacher(image_size=image_size, dtype="bfloat16"
                                              if torch.device(device).type == "cuda"
                                              else "float32", device=str(device),
                                              **TEACHER_PRESETS[task]), seed)
    is_global = task.endswith("-global")
    return lambda x: teacher(x, return_global=is_global)


def main(args=None):
    from ..api import resolve_device
    from ..utils.config import parse_args_with_config
    from ..vq.loader import get_image_tokenizer

    args = parse_args_with_config(get_parser(), args)
    device = resolve_device(args.device)
    teacher = None
    if args.task:
        teacher = build_teacher(args.task, args.teacher_ckpt, args.input_size, args.seed, device)
    model, _ = get_image_tokenizer(tokenizer_path(args.ckpt), encoder_only=True,
                                   config_override={"dtype": args.dtype}, device=str(device))
    t0 = time.time()
    n = tokenize_folder(model, args.data_root, args.domain, args.out_dir,
                        input_size=args.input_size, n_crops=args.n_crops,
                        crop_settings_dir=args.crop_settings_dir, batch_size=args.batch_size,
                        num_shards=args.num_shards, shard_id=args.shard_id,
                        skip_existing=args.skip_existing, seed=args.seed, teacher=teacher,
                        corrupt_samples_log=args.corrupt_samples_log)
    print(f"tokenized {n} samples in {time.time() - t0:.1f}s")
    return n


if __name__ == "__main__":
    main()
