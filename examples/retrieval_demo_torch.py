#!/usr/bin/env python
"""Any-to-any retrieval demo on the PyTorch port: examples/retrieval_demo.py
step for step (the reference notebooks/retrieval_4M-21.ipynb), on the card
unless `--device cpu` is given.

4M-21 retrieval predicts the DINOv2 GLOBAL embedding tokens
(`tok_dinov2_global`) from a conditioning modality, decodes them to an
embedding vector with the global tokenizer, and ranks a gallery by cosine
similarity. Everything below runs offline on tiny seeded random models; swap
in released checkpoints (load_fourm_safetensors / get_image_tokenizer) for
real retrieval quality. The 4M here has heads of 32, which the attention
kernels take as they take heads of 64.

Run: python examples/retrieval_demo_torch.py [--device cpu] [--dtype float32]
"""

import argparse
import contextlib
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(device=None, dtype="bfloat16", gallery_size=4, seed=0, stage=None):
    """Returns {"sims": cosine similarities of the query to each gallery
    image, "ranking": gallery indices, best first}. stage(name, module): a
    context manager entered around each embedding ("generate", the 4M) and
    its decode ("decode", the tokenizer), e.g. to count kernel launches;
    none by default."""
    stage = stage or (lambda name, module: contextlib.nullcontext())
    from fourm_torch.api import FourMSampler, resolve_device
    from fourm_torch.models import FourM, create_fourm_config, init_weights
    from fourm_torch.vq import VQVAE, init_vq_weights

    dev = resolve_device(device)
    # 1) a 4M model that maps RGB -> global-embedding tokens
    mods = ("rgb@224", "tok_dinov2_global")
    cfg = create_fourm_config("fm_tiny_6e_6d_gelu", encoder_modalities=mods,
                              decoder_modalities=("tok_dinov2_global",), dim=128,
                              encoder_depth=2, decoder_depth=2, num_heads=4, dtype=dtype)
    model = init_weights(FourM(cfg), seed).to(dev).eval()
    sampler = FourMSampler(model, device=str(dev))

    # 2) the global-embedding tokenizer (BottleneckMLP, as in the release)
    #    decodes the 16 predicted tokens to an embedding
    tok_model = VQVAE(image_size=4, patch_size=1, enc_type="BottleneckMLP/B_1-Wi_64",
                      dec_type="BottleneckMLP/B_1-Wi_64", codebook_size=8192, latent_dim=8,
                      n_channels=32, patch_proj=False, dtype=dtype, device=str(dev))
    init_vq_weights(tok_model, seed + 1)
    tok_model.eval()

    def embed_image(rgb: np.ndarray, seed: int) -> np.ndarray:
        md = sampler.prepare_sample({"rgb@224": rgb[None]}, ["rgb@224"],
                                    ["tok_dinov2_global"], batch_size=1)
        sched = sampler.build_schedule(["rgb@224"], ["tok_dinov2_global"])
        with torch.no_grad():
            with stage("generate", model):
                out = sampler.generate(md, sched, seed=seed)
            toks = torch.as_tensor(out["tok_dinov2_global"]["tensor"], device=dev)
            with stage("decode", tok_model):
                emb = tok_model.decode_tokens(toks.reshape(1, 4, 4).long())
        return emb.float().reshape(-1).cpu().numpy()

    # 3) gallery + query, ranked by cosine similarity
    rng = np.random.RandomState(seed)
    gallery = [rng.rand(224, 224, 3).astype(np.float32) for _ in range(gallery_size)]
    query = gallery[2 % gallery_size] + 0.01 * rng.rand(224, 224, 3).astype(np.float32)

    g_embs = np.stack([embed_image(g, seed=7) for g in gallery])  # same seed =
    q_emb = embed_image(query, seed=7)  # deterministic embedding per image

    def cos(a, b):
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))

    sims = [cos(q_emb, g) for g in g_embs]
    ranking = np.argsort(sims)[::-1]
    print("cosine similarities:", [round(s, 4) for s in sims])
    print("retrieval ranking (gallery indices, best first):", ranking.tolist())
    print("NOTE: random-init models - load released 4M-21 + tokenizer weights "
          "for meaningful retrieval.")
    return {"sims": sims, "ranking": ranking.tolist()}


if __name__ == "__main__":
    p = argparse.ArgumentParser("4M retrieval demo (PyTorch port)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--gallery_size", type=int, default=4)
    a = p.parse_args()
    main(device=a.device, dtype=a.dtype, gallery_size=a.gallery_size)
