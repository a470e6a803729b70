"""End-to-end 4M demo on the PyTorch port, with synthetic weights (no
downloads needed): examples/end_to_end_demo.py step for step, on the card
unless `--device cpu` is given.

Covers the whole stack in one script:
  1. train a tiny WordPiece text tokenizer (the port's own trainer),
  2. build a tiny RGB VQ-VAE tokenizer (ViT-S, 16k codes, seeded weights),
  3. pre-tokenize a synthetic image folder (PNG files) with persisted crop
     settings (cli/save_vq_tokens.tokenize_folder),
  4. train fm_tiny_6e_6d_gelu on the folder (Dirichlet-masked multimodal
     batches, parallel/train.py),
  5. run chained generation (caption -> tok_rgb@224 image tokens),
  6. decode the generated tokens to an image with the VQ-VAE.

With released 4M checkpoints, replace steps 2 / 4 by `load_fourm_safetensors` /
`load_vq_safetensors`; the rest is identical.

Run: python examples/end_to_end_demo_torch.py [--device cpu] [--dtype float32]
[--train_steps 10]. In bf16 on the card every block runs the hand-written
kernels.
"""

import argparse
import contextlib
import os
import random
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(device=None, dtype="bfloat16", train_steps=10, n_images=8, decoding_steps=None,
         workdir=None, seed=0, stage=None):
    """Returns {"text_vocab", "loss", "tokens" (1, 196) int64 numpy, "image"
    (1, 224, 224, 3) float32 numpy} of the run. decoding_steps: the image
    target's ROAR steps (the schedule's default, 25, if None). stage(name,
    module): a context manager entered around the tokenize ("tokenize", the
    VQ-VAE), the train steps ("train", the 4M), the generation ("generate",
    the 4M) and the decode ("decode", the VQ-VAE), e.g. to count each
    one's kernel launches; none by default."""
    stage = stage or (lambda name, module: contextlib.nullcontext())
    from fourm_torch.api import resolve_device

    dev = resolve_device(device)
    workdir = workdir or tempfile.mkdtemp(prefix="fourm_torch_demo_")
    os.makedirs(workdir, exist_ok=True)
    print(f"workdir: {workdir} device: {dev} dtype: {dtype}")
    rng = np.random.RandomState(seed)

    # ---------------------------------------------------------- 1. text tokenizer
    from fourm_torch.utils.text_tokenizer import (generate_coord_tokens,
                                                  generate_sentinel_tokens,
                                                  train_unified_wordpiece_tokenizer)

    corpus = os.path.join(workdir, "corpus.txt")
    with open(corpus, "w") as f:
        f.write("a photo of a cat sitting in the sun near a dog\n" * 300)
    text_tok = train_unified_wordpiece_tokenizer(
        corpus, vocab_size=500, sentinel_tokens=generate_sentinel_tokens(20),
        coord_tokens=generate_coord_tokens(10), show_progress=False)
    print("1. text tokenizer trained:", text_tok.get_vocab_size(), "tokens")

    # ------------------------------------------------------------- 2. VQ tokenizer
    from fourm_torch.vq import VQVAE, init_vq_weights

    vq = VQVAE(image_size=224, patch_size=16, enc_type="vit_s_enc", dec_type="vit_s_dec",
               codebook_size=16384, latent_dim=16, threshold_ema_dead_code=0.0, dtype=dtype,
               device=str(dev))
    init_vq_weights(vq, seed)
    vq.eval()
    print("2. VQVAE initialized (16k codebook)")

    # ------------------------------------------------- 3. pre-tokenize a folder
    from fourm_torch.cli.save_vq_tokens import tokenize_folder
    from fourm_torch.data.image_io import write_png

    data_root = os.path.join(workdir, "data")
    os.makedirs(f"{data_root}/rgb/c", exist_ok=True)
    os.makedirs(f"{data_root}/caption/c", exist_ok=True)
    for i in range(n_images):
        with open(f"{data_root}/rgb/c/{i:04d}.png", "wb") as f:
            f.write(write_png(rng.randint(0, 255, (256, 256, 3), dtype=np.uint8)))
        with open(f"{data_root}/caption/c/{i:04d}.txt", "w") as f:
            f.write("a photo of a cat in the sun")
    with torch.no_grad(), stage("tokenize", vq):
        n = tokenize_folder(vq, data_root, "rgb", f"{data_root}/tok_rgb", input_size=224,
                            n_crops=2, seed=seed)
    print(f"3. pre-tokenized {n} images -> {data_root}/tok_rgb")

    # --------------------------------------------------------------- 4. train 4M
    from fourm_torch.data.augmenters import PreTokenizedImageAugmenter
    from fourm_torch.data.datasets import (batched_loader, build_fm_pretraining_dataset,
                                           repeat_dataset)
    from fourm_torch.data.masking import UnifiedMasking
    from fourm_torch.data.modality_info import MODALITY_INFO
    from fourm_torch.data.transforms import default_modality_transforms
    from fourm_torch.models import FourM, create_fourm_config, init_weights
    from fourm_torch.parallel import build_train_step, init_train_state
    from fourm_torch.utils.optim import cosine_schedule, create_optimizer
    from fourm_torch.utils.synthetic import to_torch

    mods = ["tok_rgb@224", "caption"]
    masking = UnifiedMasking(
        modality_info={m: MODALITY_INFO[m] for m in mods}, text_tokenizer=text_tok,
        input_tokens_range=(64, 64), target_tokens_range=(64, 64),
        input_alphas={m: 0.5 for m in mods}, target_alphas={m: 0.5 for m in mods}, seed=seed)
    py_rng, np_rng = random.Random(seed), np.random.RandomState(seed)
    ds = build_fm_pretraining_dataset(
        data_root, mods + ["crop_settings"], default_modality_transforms(py_rng, np_rng),
        PreTokenizedImageAugmenter(target_size=224, main_domain="rgb", rng=py_rng,
                                   np_rng=np_rng), masking)
    loader = batched_loader(repeat_dataset(ds, np_rng), batch_size=4)

    cfg = create_fourm_config("fm_tiny_6e_6d_gelu", tuple(mods), tuple(mods), dtype=dtype)
    model = init_weights(FourM(cfg), seed)
    tx = create_optimizer(model, cosine_schedule(3e-4, 30, 3), clip_grad=1.0)
    state = init_train_state(model, tx, device=str(dev))
    step = build_train_step(model, tx, 64, 64)
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    metrics = {"loss": torch.tensor(float("nan"))}
    with stage("train", model):
        for _ in range(train_steps):
            state, metrics = step(state, to_torch(next(loader), dev), generator)
    loss = float(metrics["loss"])
    print(f"4. trained {train_steps} steps, loss {loss:.3f}")

    # ------------------------------------------------------------ 5. generation
    from fourm_torch.api import FourMSampler

    model.eval()
    sampler = FourMSampler(model, text_tokenizer=text_tok, device=str(dev))
    out = sampler.prepare_sample({"caption": "a photo of a cat"}, ["caption"], ["tok_rgb@224"],
                                 batch_size=1)
    defaults = sampler.resolve_defaults(["caption"])
    if decoding_steps is not None:
        defaults["tok_rgb@224"] = dict(defaults["tok_rgb@224"], decoding_steps=decoding_steps)
    schedule = sampler.build_schedule(["caption"], ["tok_rgb@224"], defaults=defaults)
    with torch.no_grad(), stage("generate", model):
        gen = sampler.generate(out, schedule, seed=seed)
    tokens = np.asarray(torch.as_tensor(gen["tok_rgb@224"]["tensor"]).cpu())
    print(f"5. generated {tokens.shape[1]} image tokens, range [{tokens.min()}, {tokens.max()}]")

    # -------------------------------------------------------------- 6. decode
    grid = torch.as_tensor(tokens.reshape(1, 14, 14), device=dev).long()
    with torch.no_grad(), stage("decode", vq):
        img = vq.decode_tokens(grid).float().cpu().numpy()
    print(f"6. decoded image {img.shape}; demo complete")
    return {"text_vocab": text_tok.get_vocab_size(), "loss": loss, "tokens": tokens,
            "image": img}


if __name__ == "__main__":
    p = argparse.ArgumentParser("4M end-to-end demo (PyTorch port)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--train_steps", type=int, default=10)
    p.add_argument("--decoding_steps", type=int, default=None)
    p.add_argument("--workdir", default=None)
    a = p.parse_args()
    main(device=a.device, dtype=a.dtype, train_steps=a.train_steps,
         decoding_steps=a.decoding_steps, workdir=a.workdir)
