"""VQ tokenizer training on one card or several: the port of fourm_tpu/cli/train_vqvae.py
(reference run_training_vqvae.py / run_training_divae.py), VQ-VAE (a
feed-forward decoder) and DiVAE (a diffusion decoder) in one path.

Carried over: the same flags (plus `--device`), `--config` (a
cfgs/default/tokenization/** recipe, read by the port's YAML reader; CLI
flags win), the six reconstruction losses (:102-126), the codebook loss
weight, DiVAE noise and timesteps with sample / epsilon / v_prediction
targets (:284-305), LPIPS when `--percept_loss_weight > 0` (weights from
`--percept_loss_ckpt`, else random with a warning), multi-resolution
synthetic batches, LR x bs/256, the cosine schedule, AdamW with the decay
mask of the JAX tree (every vector spared) after a global-norm clip, the
model EMA (:338), the eval every `--eval_freq` steps of a VQ-VAE (PSNR /
MSE / MAE / codebook usage, MS-SSIM, LPIPS, FID and IS through InceptionV3
or VGG features, :347-386), and checkpoints every `--save_ckpt_freq`
steps and at the end (:395).

The step runs the model's training forward: attention through
`attention_train` (forward and backward kernels) in the ViT and UViT
blocks, the codebook search through `nearest_code_cosine` /
`nearest_code`, the EMA update of the codebook, and one `fused_adamw`
launch over the fp32 master parameters. The model EMA is kept beside the
masters, fp32, updated after each step. A frozen encoder (`--freeze_enc`)
is left out of the optimizer (no moments; neither read nor written), so it
stays bit for bit (the JAX chain's AdamW decays it, ROADMAP).
cli/train_vqcontrolnet.py runs the same Trainer (its diffusion in a VAE's
latent space through the `diffusion_target` hook) and `train_loop`.

What differs from the JAX CLI, and why:
  * `--kmeans_init` initialises the codebook by k-means on the first
    batch, as the reference's quantizer does on its first training forward
    (quantize_lucid.py:222-233); the JAX CLI zeroes the codebook and never
    calls its k-means (ROADMAP);
  * multi-resolution picks the size of step `it` by `hash(it)` (the
    reference's); the JAX CLI hashes str(step), which Python salts per
    process;
  * checkpoints are `checkpoints/step_N/state.pt` (utils/checkpoint.py),
    read back by auto-resume (the JAX CLI does not resume): the fp32
    masters, the codebook state, the AdamW moments and count, the model
    EMA, the step and the generator's state; a resumed run skips the
    synthetic batches it has seen, so it continues bit for bit (a folder
    stream restarts). Each checkpoint also exports the tokenizer as
    `tokenizer.safetensors` (release format, `get_image_tokenizer` reads
    it) and, with `--model_ema`, the EMA weights as
    `tokenizer_ema.safetensors`;
  * random draws (noise, timesteps, condition masks, dead codes, k-means)
    come from one torch.Generator on the card, seeded by `--seed`; data
    from numpy / random generators seeded by it;
  * several cards (under torchrun): data parallel, `--batch_size` a card
    and lr = blr x batch_size x world / 256 (fourm_tpu/cli/train_vqvae.py:
    240 scales lr by the device count but builds its mesh, :229, without
    placing anything on it). Each rank takes its rows of the global
    synthetic batch (a folder stream is read by each rank with its own
    seed), gradients are averaged over the ranks, the codebook's EMA sums,
    dead codes and k-means see the global batch (vq/quantizer.py), and the
    noise and timesteps are drawn for the global batch, so every rank keeps
    the same model and codebook. Rank 0 alone prints, logs, evaluates its
    rows and writes checkpoints. `--fsdp` above 1 raises: the tokenizers
    are small and their optimizer state is not sharded.
Images (PNG, JPEG) are read without Pillow (data/image_io.py).

Usage:
  python -m fourm_torch.cli.train_vqvae \\
      --config cfgs/default/tokenization/divae/rgb/ViTB-UNetP4_16k_224_predx0.yaml \\
      --data_path /data/images --output_dir out/divae          # on the card
  python -m fourm_torch.cli.train_vqvae --synthetic_data --total_steps 100
  python -m fourm_torch.cli.train_vqvae --device cpu ...       # plain twins
  python -m torch.distributed.run --nproc_per_node 4 -m fourm_torch.cli.train_vqvae ...
"""

from __future__ import annotations

import argparse
import math
import os
import random
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F


def get_parser():
    p = argparse.ArgumentParser("VQ tokenizer training (fourm_torch)")
    p.add_argument("--model_type", default="vqvae", choices=["vqvae", "divae"])
    p.add_argument("--domain", default="rgb", help="modality to tokenize")
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--input_size_min", type=int, default=None,
                   help="multi-resolution training: min size (reference :108-112)")
    p.add_argument("--input_size_max", type=int, default=None)
    p.add_argument("--resolution_step", type=int, default=32)
    p.add_argument("--n_channels", type=int, default=3)
    p.add_argument("--n_labels", type=int, default=None, help="semseg class count")
    p.add_argument("--enc_type", default="vit_b_enc")
    p.add_argument("--dec_type", default=None, help="default: vit_b_dec / uvit_b_p4_f16")
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--patch_proj", action="store_true", default=True)
    p.add_argument("--post_mlp", action="store_true")
    p.add_argument("--codebook_size", type=int, default=16384)
    p.add_argument("--num_codebooks", type=int, default=1)
    p.add_argument("--latent_dim", type=int, default=32)
    p.add_argument("--norm_codes", action="store_true", default=True)
    p.add_argument("--ema_decay", type=float, default=0.99)
    p.add_argument("--threshold_ema_dead_code", type=float, default=0.25)
    p.add_argument("--code_replacement_policy", default="batch_random",
                   choices=["batch_random", "linde_buzo_gray"])
    p.add_argument("--commitment_weight", type=float, default=1.0)
    p.add_argument("--codebook_weight", type=float, default=1.0)
    p.add_argument("--kmeans_init", action="store_true")
    p.add_argument("--freeze_enc", action="store_true",
                   help="freeze the encoder (reference frozenenc recipes)")
    p.add_argument("--quantizer_ema_decay", type=float, default=None)
    # losses
    p.add_argument("--loss_fn", default="mse",
                   choices=["mse", "l1", "smooth_l1", "cross_entropy", "cosine", "binary"])
    p.add_argument("--percept_loss_weight", type=float, default=0.0,
                   help="LPIPS perceptual loss weight (reference :413-431)")
    p.add_argument("--percept_loss_ckpt", default=None,
                   help="LPIPS weights (.safetensors / .npz / .pth of the reference torch "
                        "state dict); random init and a warning when absent")
    p.add_argument("--fid_extractor", default="inception", choices=["inception", "vgg", "none"],
                   help="FID feature extractor for eval: InceptionV3 or VGG pool5")
    p.add_argument("--fid_ckpt", default=None,
                   help="InceptionV3 weights (pt_inception .pth / .safetensors / .npz); "
                        "random init and a warning when absent")
    # divae
    p.add_argument("--num_train_timesteps", type=int, default=1000)
    p.add_argument("--beta_schedule", default="squaredcos_cap_v2")
    p.add_argument("--prediction_type", default="v_prediction",
                   choices=["sample", "epsilon", "v_prediction"])
    p.add_argument("--cls_free_guidance_dropout", type=float, default=0.0)
    p.add_argument("--masked_cfg", action="store_true")
    p.add_argument("--zero_terminal_snr", action="store_true", default=True)
    # optimization
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--total_steps", type=int, default=1000)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--blr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--clip_grad", type=float, default=1.0)
    p.add_argument("--model_ema", action="store_true")
    p.add_argument("--model_ema_decay", type=float, default=0.9999)
    p.add_argument("--dtype", default="bfloat16")
    # data
    p.add_argument("--data_path", default=None)
    p.add_argument("--synthetic_data", action="store_true")
    p.add_argument("--mask_value", type=float, default=None)
    # misc
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--output_dir", default="out/train_vq")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval_freq", type=int, default=500)
    p.add_argument("--save_ckpt_freq", type=int, default=1000)
    p.add_argument("--print_freq", type=int, default=50)
    p.add_argument("--device", default=None,
                   help="the card unless 'cpu' is asked (the plain PyTorch twins)")
    return p


def compute_reconst_loss(pred: torch.Tensor, target: torch.Tensor, loss_fn: str) -> torch.Tensor:
    """The reconstruction losses (train_vqvae.py:102-126; reference
    run_training_vqvae.py:961-1003), channel-last."""
    if loss_fn == "mse":
        return (pred - target).square().mean()
    if loss_fn == "l1":
        return (pred - target).abs().mean()
    if loss_fn == "smooth_l1":
        d = (pred - target).abs()
        return torch.where(d < 1.0, 0.5 * d * d, d - 0.5).mean()
    if loss_fn == "cross_entropy":  # semseg: pred (B, H, W, L), target (B, H, W) ints
        logp = F.log_softmax(pred, dim=-1)
        return -logp.gather(-1, target.long()[..., None]).mean()
    if loss_fn == "cosine":
        pn = pred / (pred.norm(dim=-1, keepdim=True) + 1e-8)
        tn = target / (target.norm(dim=-1, keepdim=True) + 1e-8)
        return (1.0 - (pn * tn).sum(-1)).mean()
    if loss_fn == "binary":
        return -(target * F.logsigmoid(pred) + (1 - target) * F.logsigmoid(-pred)).mean()
    raise ValueError(loss_fn)


def eval_metrics(pred: np.ndarray, target: np.ndarray, tokens: np.ndarray,
                 codebook_size: int) -> Dict[str, float]:
    """PSNR / MSE / MAE and codebook usage (train_vqvae.py:129-137)."""
    mse = float(np.mean((pred - target) ** 2))
    mae = float(np.mean(np.abs(pred - target)))
    rng = float(target.max() - target.min() + 1e-8)
    psnr = 10 * math.log10(rng ** 2 / max(mse, 1e-12))
    usage = len(np.unique(tokens)) / codebook_size
    return {"mse": mse, "mae": mae, "psnr": psnr, "codebook_usage": usage}


def model_config(args) -> Dict:
    """The tokenizer's constructor config (the export's metadata)."""
    cfg = dict(domain=args.domain, image_size=args.input_size, n_channels=args.n_channels,
               n_labels=args.n_labels, enc_type=args.enc_type, patch_proj=args.patch_proj,
               post_mlp=args.post_mlp, patch_size=args.patch_size,
               codebook_size=args.codebook_size, num_codebooks=args.num_codebooks,
               latent_dim=args.latent_dim, norm_codes=args.norm_codes,
               ema_decay=args.ema_decay, threshold_ema_dead_code=args.threshold_ema_dead_code,
               code_replacement_policy=args.code_replacement_policy,
               commitment_weight=args.commitment_weight, kmeans_init=args.kmeans_init,
               freeze_enc=args.freeze_enc, dtype=args.dtype)
    if args.model_type == "divae":
        cfg.update(dec_type=args.dec_type or "uvit_b_p4_f16",
                   num_train_timesteps=args.num_train_timesteps,
                   beta_schedule=args.beta_schedule, prediction_type=args.prediction_type,
                   cls_free_guidance_dropout=args.cls_free_guidance_dropout,
                   masked_cfg=args.masked_cfg, zero_terminal_snr=args.zero_terminal_snr)
    else:
        cfg.update(dec_type=args.dec_type or "vit_b_dec")
    return cfg


def build_model(args, device):
    """The tokenizer with fp32 master parameters, seeded random weights
    (vqvae.init_vq_weights; the EMA sums start at the codebook, JAX's init;
    with --kmeans_init the codebook is zero and pending), on `device`,
    trainable but for a frozen encoder."""
    from ..vq import VQVAE, DiVAE, init_vq_weights

    cfg = {k: v for k, v in model_config(args).items() if k != "domain"}
    cls = DiVAE if args.model_type == "divae" else VQVAE
    model = init_vq_weights(cls(**cfg, fp32_params=True, device=device), args.seed)
    cb = model.quantize._codebook
    with torch.no_grad():
        if args.kmeans_init:
            cb.embed.zero_()
        cb.embed_avg.copy_(cb.embed)
    model.requires_grad_(True)
    frozen = frozen_names(model, args.freeze_enc)
    for name, p in model.named_parameters():
        if name in frozen:
            p.requires_grad_(False)
    return model


def frozen_names(model, freeze_enc: bool) -> set:
    """The parameters a frozen encoder's stop-gradient keeps from any
    gradient: the encoder's and the class embedding's."""
    if not freeze_enc:
        return set()
    return {n for n, _ in model.named_parameters() if n.startswith(("encoder.", "cls_emb."))}


class SyntheticBatches:
    """The JAX CLI's synthetic batches (train_vqvae.py:195-206) from one
    np.random.RandomState(seed): images uniform in [-1, 1], or class maps;
    step `it` at size res_choices[hash(it) % len] (the reference's
    multi-resolution choice)."""

    def __init__(self, args, shard=(0, 1)):
        self.rng = np.random.RandomState(args.seed)
        self.args = args
        self.shard = shard  # (rank, world): this rank's rows of the global batch
        if args.input_size_min and args.input_size_max:
            self.choices = list(range(args.input_size_min, args.input_size_max + 1,
                                      args.resolution_step))
        else:
            self.choices = [args.input_size]

    def batch(self, it: int) -> np.ndarray:
        a = self.args
        size = self.choices[hash(it) % len(self.choices)]
        r, n = self.shard
        if a.n_labels is not None:
            x = self.rng.randint(0, a.n_labels, (a.batch_size * n, size, size)).astype(np.int32)
        else:
            x = self.rng.rand(a.batch_size * n, size, size, a.n_channels).astype(np.float32)
            x = x * 2 - 1
        return x[r * a.batch_size:(r + 1) * a.batch_size]


def folder_batches(args, rank: int = 0):
    """Batches of `--domain` from root/{domain}/... through the DiVAE
    transforms, a random crop to input_size and a flip
    (train_vqvae.py:208-224), every draw from generators seeded by --seed
    (+ 1000 x rank on rank `rank`)."""
    from ..data.augmenters import RandomCropImageAugmenter
    from ..data.datasets import MultiModalDatasetFolder, repeat_dataset
    from ..data.transforms import UnifiedDataTransform, divae_modality_transforms

    seed = args.seed + 1000 * rank
    rng, np_rng = random.Random(seed), np.random.RandomState(seed)
    transforms = divae_modality_transforms(rng, np_rng)
    aug = RandomCropImageAugmenter(target_size=args.input_size, main_domain=args.domain,
                                   rng=rng, np_rng=np_rng)
    ds = MultiModalDatasetFolder(args.data_path, [args.domain], transforms,
                                 transform=UnifiedDataTransform(transforms, aug))
    samples = repeat_dataset(ds, np_rng)
    while True:
        yield np.stack([next(samples)[args.domain] for _ in range(args.batch_size)])


class Trainer:
    """One tokenizer run's state and step: the model (fp32 masters and the
    codebook buffers), FusedAdamW over its trainable parameters, the model
    EMA, the step count and the generator of the step's draws. group: the
    data-parallel process group (None: one process); the model and codebook
    stay equal on its ranks. `model`: a tokenizer built by the caller (its
    frozen parameters without requires_grad), else build_model's."""

    def __init__(self, args, device, group=None, model=None):
        from ..vq.quantizer import VectorQuantize

        self.args, self.device, self.group = args, device, group
        self.world = 1 if group is None else torch.distributed.get_world_size(group)
        self.model = build_model(args, device) if model is None else model
        for m in self.model.modules():
            if isinstance(m, VectorQuantize):
                m.group = group
        self.diffusion = args.model_type != "vqvae"
        self.scheduler = self.model.noise_scheduler() if self.diffusion else None
        self.opt = make_optimizer(self.model, args, self.world,
                                  {n for n, p in self.model.named_parameters()
                                   if not p.requires_grad})
        self.ema = ({n: p.detach().clone() for n, p in self.model.named_parameters()}
                    if args.model_ema else None)
        self.gen = torch.Generator(device=device).manual_seed(args.seed + 2)
        self.step = 0
        self.lpips = None
        if args.percept_loss_weight > 0 and args.n_labels is None:
            self.lpips = build_lpips(args, device)

    def config(self) -> Dict:
        """The tokenizer's constructor config (the export's metadata)."""
        return model_config(self.args)

    def diffusion_target(self, x: torch.Tensor, draws: Dict) -> torch.Tensor:
        """The clean sample a diffusion decoder learns to denoise: the image
        itself (DiVAE)."""
        return x

    def state(self) -> Dict:
        m = self.model
        return {"params": {n: p.detach() for n, p in m.named_parameters()},
                "codebook": m.quantize._codebook.state_dict(),
                "opt_state": self.opt.state_dict(), "ema_params": self.ema,
                "step": self.step, "generator": self.gen.get_state()}

    def load(self, state: Dict) -> None:
        m = self.model
        with torch.no_grad():
            for n, p in m.named_parameters():
                p.copy_(state["params"][n])
            m.quantize._codebook.load_state_dict(state["codebook"])
            if self.ema is not None:
                for n, t in self.ema.items():
                    t.copy_(state["ema_params"][n])
        self.opt.load_state_dict(state["opt_state"])
        self.gen.set_state(state["generator"].cpu())
        self.step = int(state["step"])

    def train_step(self, batch: torch.Tensor, draws: Optional[Dict] = None
                   ) -> Dict[str, torch.Tensor]:
        """One step (train_vqvae.py:273-325) -> {"loss", "rec", "code_loss",
        "grad_norm"}, tensors on the card. `draws`: the step's random draws
        where given ("noise", "timesteps", those of `diffusion_target`, and
        the model's: VectorQuantize / DiVAE.forward), else from the trainer's
        generator."""
        args, m, gen = self.args, self.model, self.gen
        draws = draws or {}
        for p in self.opt.params():
            p.grad = None
        if self.diffusion:
            from ..vq.quantizer import rank_rows

            x = batch.float()
            z = self.diffusion_target(x, draws)
            noise = draws.get("noise")
            if noise is None:
                noise = rank_rows(z.shape, self.group, gen, z.device, torch.randn)
            t = draws.get("timesteps")
            if t is None:
                t = rank_rows((z.shape[0],), self.group, gen, z.device,
                              lambda shape, **kw: torch.randint(0, args.num_train_timesteps,
                                                                shape, **kw))
            noised = self.scheduler.add_noise(z, noise, t)
            pred, code_loss = m(x, noised, t, train=True, draws=draws, generator=gen)
            target = {"v_prediction": lambda: self.scheduler.get_velocity(z, noise, t),
                      "epsilon": lambda: noise, "sample": lambda: z}[args.prediction_type]()
            rec = compute_reconst_loss(pred.float(), target, args.loss_fn)
        else:
            pred, code_loss = m(batch, train=True, draws=draws, generator=gen)
            rec = compute_reconst_loss(pred.float(), batch, args.loss_fn)
        total = rec + args.codebook_weight * code_loss
        if self.lpips is not None and (not self.diffusion or args.prediction_type == "sample"):
            total = total + args.percept_loss_weight * self.lpips(pred.float(),
                                                                  batch.float()).mean()
        total.backward()
        grads = [p.grad for p in self.opt.params() if p.grad is not None]
        metrics = torch.stack([total.detach(), rec.detach(), code_loss.detach().float()])
        if self.group is not None:  # the global batch's mean: the ranks' means averaged
            average_over(grads + [metrics], self.group, self.world)
        grad_norm = torch.nn.utils.get_total_norm(grads, norm_type=2.0)
        self.opt.step(grad_norm)
        if self.ema is not None:
            update_ema(self.ema, self.model, args.model_ema_decay)
        self.step += 1
        return {"loss": metrics[0], "rec": metrics[1], "code_loss": metrics[2],
                "grad_norm": grad_norm}


def make_optimizer(model, args, world: int, frozen: set):
    """FusedAdamW of the JAX create_optimizer (train_vqvae.py:240-243): lr =
    blr x batch_size x world / 256 on the cosine schedule, a global-norm
    clip, AdamW with the JAX tree's decay mask (every vector spared), over
    the parameters outside `frozen` only (those get no moments and are
    neither read nor written)."""
    from ..utils.optim import cosine_schedule, create_optimizer, weight_decay_mask

    lr = args.blr * args.batch_size * world / 256.0
    opt = create_optimizer(model, cosine_schedule(lr, args.total_steps, args.warmup_steps),
                           weight_decay=args.weight_decay, clip_grad=args.clip_grad,
                           decay_mask=weight_decay_mask(model, vectors=False))
    return opt.use_leaves([(n, p) for n, p in model.named_parameters()
                           if n not in frozen]).init()


def average_over(tensors, group, world: int) -> None:
    """Each tensor averaged over the group's ranks, in place, in one
    all-reduce."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    torch.distributed.all_reduce(flat, group=group)
    flat /= world
    torch._foreach_copy_(tensors, [c.view_as(t) for c, t in
                                   zip(flat.split([t.numel() for t in tensors]), tensors)])


def update_ema(ema: Dict[str, torch.Tensor], model, decay: float) -> None:
    """ema = decay * ema + (1 - decay) * params, in fp32 (train_vqvae.py:338),
    in place."""
    names = list(ema)
    params = dict(model.named_parameters())
    with torch.no_grad():
        torch._foreach_mul_([ema[n] for n in names], decay)
        torch._foreach_add_([ema[n] for n in names],
                            torch._foreach_mul([params[n].detach() for n in names], 1 - decay))


def build_lpips(args, device):
    from ..vq.percept_losses import LPIPS, load_lpips

    if args.percept_loss_ckpt:
        print(f"[lpips] loaded weights from {args.percept_loss_ckpt}")
        return load_lpips(args.percept_loss_ckpt, device=str(device))
    print("[lpips] WARNING: no --percept_loss_ckpt; using RANDOM VGG weights "
          "(architecture-only mode, not a trained metric)")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        model = LPIPS()
    return model.to(device).requires_grad_(False).eval()


def run_eval(trainer: Trainer, batch: torch.Tensor, fid_state: Dict) -> Dict[str, float]:
    """The eval of a VQ-VAE on the step's batch (train_vqvae.py:347-386):
    tokenize and autoencode through the inference kernels, then PSNR / MSE
    / MAE / usage (of a class map's argmax: the JAX CLI subtracts the
    (B, H, W, L) logits from the (B, H, W) labels, which numpy refuses;
    ROADMAP), and for RGB MS-SSIM, LPIPS and FID / IS."""
    from ..vq.percept_losses import frechet_distance, inception_score, ms_ssim

    args, m = trainer.args, trainer.model
    with torch.no_grad():
        tokens = m.tokenize(batch)
        rec = m.autoencode(batch)
    if args.n_labels is not None:  # a class map: its argmax (the JAX CLI raises here)
        rec = rec.argmax(-1)
    pred_np, tgt_np = rec.float().cpu().numpy(), batch.float().cpu().numpy()
    out = eval_metrics(pred_np, tgt_np, tokens.cpu().numpy(), args.codebook_size)
    if args.n_labels is None and pred_np.shape[-1] == 3:
        out["ms_ssim"] = ms_ssim(pred_np, tgt_np)
        lp = trainer.lpips
        if lp is not None:
            with torch.no_grad():
                out["lpips"] = float(lp(rec.float(), batch.float()).mean())
        if args.fid_extractor == "inception" and pred_np.shape[0] > 1:
            from ..vq.inception import inception_features_and_probs, load_inception

            if "model" not in fid_state:
                if args.fid_ckpt:
                    print(f"[fid] InceptionV3 weights from {args.fid_ckpt}")
                else:
                    print("[fid] WARNING: no --fid_ckpt; InceptionV3 runs with RANDOM "
                          "weights (pipeline exercise only, not a comparable FID)")
                with torch.random.fork_rng(devices=[]):
                    torch.manual_seed(0)
                    fid_state["model"] = load_inception(args.fid_ckpt,
                                                        device=str(trainer.device))
            lo, hi = float(tgt_np.min()), float(tgt_np.max())
            scale = (hi - lo) or 1.0
            fp_, pp_ = inception_features_and_probs(fid_state["model"], (pred_np - lo) / scale)
            ft_, _ = inception_features_and_probs(fid_state["model"], (tgt_np - lo) / scale)
            out["fid"] = frechet_distance(ft_, fp_)
            out["inception_score"] = inception_score(pp_, splits=1)[0]
        elif args.fid_extractor == "vgg" and lp is not None and pred_np.shape[0] > 1:
            with torch.no_grad():
                fp_ = lp.features(rec.float())[-1].mean(dim=(2, 3)).cpu().numpy()
                ft_ = lp.features(batch.float())[-1].mean(dim=(2, 3)).cpu().numpy()
            out["vgg_fid"] = frechet_distance(ft_.astype(np.float64), fp_.astype(np.float64))
    return out


def export_tokenizer(trainer: Trainer, path: str, weights=None) -> None:
    """The tokenizer in the release format (`get_image_tokenizer` reads it):
    the model's state dict, with `weights` ({name: tensor}, the EMA) in
    place of its parameters when given, and its config as metadata."""
    from ..utils.checkpoint import export_vq_safetensors

    export_vq_safetensors(trainer.model, trainer.config(), path, overrides=weights)


def save(trainer: Trainer, output_dir: str) -> None:
    from ..utils.checkpoint import save_checkpoint

    save_checkpoint(os.path.join(output_dir, "checkpoints"), trainer.state(), trainer.step)
    export_tokenizer(trainer, os.path.join(output_dir, "tokenizer.safetensors"))
    if trainer.ema is not None:
        export_tokenizer(trainer, os.path.join(output_dir, "tokenizer_ema.safetensors"),
                         trainer.ema)


def train_loop(trainer: Trainer, eval_fn=None, rank: int = 0, world: int = 1) -> None:
    """A run from its last checkpoint under --output_dir (auto-resume) to
    --total_steps: synthetic batches (this rank's rows) or a folder's, the
    k-means init on the first batch where the codebook waits for it, one
    train_step a batch, the metrics printed and logged every --print_freq
    steps (a non-finite one raises), eval_fn(trainer, batch) -> {name:
    value} every --eval_freq steps on rank 0, a checkpoint every
    --save_ckpt_freq steps and at the end (rank 0 writes it)."""
    from ..parallel.launch import barrier
    from ..utils.checkpoint import auto_resume
    from ..utils.logger import JSONLLogger

    args, device = trainer.args, trainer.device
    main_rank = rank == 0
    say = print if main_rank else (lambda *a, **k: None)
    if main_rank:
        os.makedirs(args.output_dir, exist_ok=True)
    barrier()
    state, start = auto_resume(os.path.join(args.output_dir, "checkpoints"), map_location=device)
    synthetic = args.synthetic_data or args.data_path is None
    source = SyntheticBatches(args, (rank, world)) if synthetic else folder_batches(args, rank)

    def next_batch(it: int) -> torch.Tensor:
        arr = source.batch(it) if synthetic else next(source)
        return torch.from_numpy(arr).to(device)

    if state is not None:
        trainer.load(state)
        if synthetic:  # the batches the run has seen: it continues bit for bit
            for it in range(start):
                source.batch(it)
        say(f"resumed from step {start}")
    jsonl = JSONLLogger(args.output_dir) if main_rank else None
    t0 = time.time()
    for it in range(trainer.step, args.total_steps):
        batch = next_batch(it)
        if it == 0 and float(trainer.model.quantize._codebook.initted) == 0.0:
            trainer.model.init_codebook_kmeans(batch, generator=trainer.gen)
            say("[kmeans] codebook initialised from the first (global) batch")
        metrics = trainer.train_step(batch)
        if it % args.print_freq == 0 or it == args.total_steps - 1:
            vals = {k: float(v) for k, v in metrics.items()}
            if not all(math.isfinite(v) for v in vals.values()):
                raise FloatingPointError(f"step {it}: non-finite metrics {vals}")
            sps = args.batch_size * world * args.print_freq / max(time.time() - t0, 1e-6)
            t0 = time.time()
            say(f"step {it}/{args.total_steps} loss {vals['loss']:.4f} rec {vals['rec']:.4f} "
                f"code {vals['code_loss']:.4f} samples/s {sps:.1f}", flush=True)
            if main_rank:
                jsonl.write({"step": it, "loss": vals["loss"], "rec": vals["rec"],
                             "code_loss": vals["code_loss"]})
        if eval_fn is not None and (it + 1) % args.eval_freq == 0 and main_rank:
            m = eval_fn(trainer, batch)
            print(f"[eval] {m}", flush=True)
            jsonl.write({"step": it, **{f"eval_{k}": v for k, v in m.items()}})
        if (it + 1) % args.save_ckpt_freq == 0 or it == args.total_steps - 1:
            if main_rank:  # every rank holds the same state
                save(trainer, args.output_dir)
            barrier()
    say("tokenizer training done")


def main(args=None):
    from ..api import resolve_device
    from ..utils.config import parse_args_with_config

    from ..parallel.launch import initialize_multihost, process_count, process_index, shutdown

    args = parse_args_with_config(get_parser(), args)
    if args.fsdp != 1:
        raise NotImplementedError(f"--fsdp {args.fsdp}: the tokenizer trainer does not shard "
                                  "its optimizer state; it runs data parallel over every "
                                  "rank of torchrun (the model is small): leave --fsdp at 1")
    initialize_multihost(device=args.device)
    device = resolve_device(args.device)
    rank, world = process_index(), process_count()
    trainer = Trainer(args, device, torch.distributed.group.WORLD if world > 1 else None)
    fid_state: Dict = {}
    eval_fn = None if trainer.diffusion else (
        lambda trainer, batch: run_eval(trainer, batch, fid_state))
    train_loop(trainer, eval_fn, rank, world)
    if world > 1:
        shutdown()
    return trainer


if __name__ == "__main__":
    main()
