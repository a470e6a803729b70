"""VQControlNet training on one card: the port of
fourm_tpu/cli/train_vqcontrolnet.py (reference
run_training_vqcontrolnet.py): an SD-1.5-scale UNet and KL VAE, frozen, and
a ControlNet branch that learns to steer the UNet from the tokens of a
frozen VQ encoder, with VAE-latent diffusion targets.

Carried over: the same flags (plus `--device`), `--config` (a
cfgs/default/tokenization/vqcontrolnet/** recipe; CLI flags win), the step
of :167-193 (a VAE latent sampled, noise, t in [0, num_train_timesteps),
add_noise, the training forward with the codebook's EMA and the CFG
condition dropout, the MSE against the prediction_type's target; the code
loss is logged, not trained), only `decoder.controlnet.*` training
(vqcontrolnet_trainable_mask: the UNet, the VAE, the encoder, quant_proj and
the prompt encoding frozen), `--init_controlnet_from_unet`, lr = blr x
batch_size / 256 on the cosine schedule, AdamW with the JAX tree's decay
mask after a clip of the trainable set's gradient norm, the eval every
`--eval_freq` steps (:212-221: decode the batch's tokens with
`--eval_timesteps` DDIM steps, MSE and codebook usage), synthetic batches
or a folder through the DiVAE transforms and a random crop, and a
checkpoint every `--save_ckpt_freq` steps and at the end.

The step runs the port's kernels where the JAX step runs Pallas: the ViT
encoder's inference path (`ln_matmul`, `mha_short`, `ln_mlp` at 784 tokens
for a 448 image; the encoder is frozen and runs without a graph), one
`nearest_code_cosine` search, and one `fused_adamw` launch over the
trainable set's fp32 masters (the frozen parameters are neither read nor
written and have no moments). The UNet, the branch and the VAE are
convolutions, GroupNorm and plain attention (vq/controlnet.py).

What differs from the JAX CLI, and why:
  * the trainer and the loop are cli/train_vqvae.py's: its Trainer (the
    step of a DiVAE with `diffusion_target` the VAE's latent sample; the
    state, `make_optimizer`) and `train_loop` (synthetic or folder
    batches, the print and finite check, the eval, checkpoints by
    torch.save as `checkpoints/step_N/state.pt` with `tokenizer.safetensors`
    for get_image_tokenizer, auto-resume); the JAX CLI writes orbax
    checkpoints and does not resume;
  * `--vq_ckpt` reads a tokenizer `.safetensors` / `.pth` or a train_vqvae
    output directory (encoder, quant_proj and codebook); the JAX CLI reads
    an orbax directory, which the port does not (ROADMAP);
  * random draws (the VAE sample, noise, timesteps, dead codes, condition
    dropout) come from one torch.Generator on the card seeded by
    `--seed` + 2, and the eval's from one seeded 9, as the JAX eval's key;
  * one process: lr scales with the batch of the card.

Usage:
  python -m fourm_torch.cli.train_vqcontrolnet \\
      --config cfgs/default/tokenization/vqcontrolnet/rgb/ViTB-SD1.5_1k_224-448.yaml \\
      --data_path /data/images --vq_ckpt out/vq/tokenizer.safetensors      # on the card
  python -m fourm_torch.cli.train_vqcontrolnet --synthetic_data --total_steps 100
  python -m fourm_torch.cli.train_vqcontrolnet --device cpu ...   # plain twins
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch

from . import train_vqvae as tv


def get_parser():
    p = argparse.ArgumentParser("VQControlNet training (fourm_torch)")
    p.add_argument("--domain", default="rgb")
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--n_channels", type=int, default=3)
    p.add_argument("--enc_type", default="vit_b_enc")
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--codebook_size", type=int, default=16384)
    p.add_argument("--latent_dim", type=int, default=32)
    p.add_argument("--freeze_enc", action="store_true", default=True,
                   help="freeze the pretrained VQ encoder (reference default)")
    # ControlNet / SD scale
    p.add_argument("--model_channels", type=int, default=320)
    p.add_argument("--num_res_blocks", type=int, default=2)
    p.add_argument("--channel_mult", type=int, nargs="+", default=[1, 2, 4, 4])
    p.add_argument("--attention_levels", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--context_len", type=int, default=77)
    p.add_argument("--context_dim", type=int, default=768)
    p.add_argument("--vae_base_channels", type=int, default=128)
    p.add_argument("--vae_ch_mult", type=int, nargs="+", default=[1, 2, 4, 4])
    p.add_argument("--init_controlnet_from_unet", action="store_true", default=True,
                   help="copy base-UNet encoder weights into the ControlNet branch "
                        "(diffusers ControlNetModel.from_unet)")
    # diffusion
    p.add_argument("--num_train_timesteps", type=int, default=1000)
    p.add_argument("--prediction_type", default="epsilon",
                   choices=["sample", "epsilon", "v_prediction"])
    p.add_argument("--cls_free_guidance_dropout", type=float, default=0.05)
    p.add_argument("--masked_cfg", action="store_true")
    # optimization
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--total_steps", type=int, default=1000)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--blr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--clip_grad", type=float, default=1.0)
    p.add_argument("--dtype", default="bfloat16")
    # data / misc
    p.add_argument("--data_path", default=None)
    p.add_argument("--synthetic_data", action="store_true")
    p.add_argument("--vq_ckpt", default=None,
                   help="pretrained VQ encoder, loaded frozen: a tokenizer .safetensors / "
                        ".pth, or a train_vqvae output directory")
    p.add_argument("--output_dir", default="out/train_vqcontrolnet")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval_freq", type=int, default=500)
    p.add_argument("--eval_timesteps", type=int, default=8)
    p.add_argument("--save_ckpt_freq", type=int, default=1000)
    p.add_argument("--print_freq", type=int, default=50)
    p.add_argument("--device", default=None,
                   help="the card unless 'cpu' is asked (the plain PyTorch twins)")
    # what train_vqvae's Trainer and train_loop read, fixed here: the MSE of
    # the diffusion target alone (the code loss is logged, not trained:
    # train_vqcontrolnet.py:184), no LPIPS, no model EMA, one resolution,
    # images
    p.set_defaults(model_type="vqcontrolnet", loss_fn="mse", codebook_weight=0.0,
                   percept_loss_weight=0.0, model_ema=False, n_labels=None,
                   input_size_min=None, input_size_max=None)
    return p


def model_config(args) -> Dict:
    """The VQControlNet's constructor config (the export's metadata)."""
    return dict(domain=args.domain, image_size=args.input_size, n_channels=args.n_channels,
                enc_type=args.enc_type, patch_size=args.patch_size,
                codebook_size=args.codebook_size, latent_dim=args.latent_dim,
                freeze_enc=args.freeze_enc, model_channels=args.model_channels,
                num_res_blocks=args.num_res_blocks, channel_mult=list(args.channel_mult),
                attention_levels=list(args.attention_levels), num_heads=args.num_heads,
                context_len=args.context_len, context_dim=args.context_dim,
                vae_base_channels=args.vae_base_channels, vae_ch_mult=list(args.vae_ch_mult),
                num_train_timesteps=args.num_train_timesteps,
                prediction_type=args.prediction_type,
                cls_free_guidance_dropout=args.cls_free_guidance_dropout,
                masked_cfg=args.masked_cfg, dtype=args.dtype)


def load_vq_encoder(model, path: str) -> None:
    """The encoder, quant_proj and codebook of a tokenizer file (or a
    train_vqvae output directory's) into `model`, in place."""
    from ..vq.loader import get_image_tokenizer
    from .save_vq_tokens import tokenizer_path

    vq, _ = get_image_tokenizer(tokenizer_path(path), encoder_only=True, verbose=False,
                                config_override={"dtype": "float32"}, device="cpu")
    state = {k: v for k, v in vq.state_dict().items() if not k.endswith("pos_emb")}
    own = model.state_dict()
    unknown = [k for k in state if k not in own]
    if unknown:
        raise KeyError(f"{path}: tokenizer keys the VQControlNet has no place for: {unknown}")
    with torch.no_grad():
        for k, v in state.items():
            own[k].copy_(v)
    print(f"[ckpt] loaded frozen VQ encoder from {path}")


def build_model(args, device):
    """The VQControlNet with fp32 master parameters and seeded random
    weights (vqvae.init_vq_weights; the codebook's EMA sums start at the
    codebook), the branch copied from the UNet with
    --init_controlnet_from_unet, the encoder from --vq_ckpt; only the
    branch trainable."""
    from ..vq import (VQControlNet, controlnet_params_from_unet, init_vq_weights,
                      vqcontrolnet_trainable_mask)

    cfg = {k: v for k, v in model_config(args).items() if k != "domain"}
    model = init_vq_weights(VQControlNet(**cfg, fp32_params=True, device=str(device)),
                            args.seed)
    cb = model.quantize._codebook
    with torch.no_grad():
        cb.embed_avg.copy_(cb.embed)
    if args.init_controlnet_from_unet:
        controlnet_params_from_unet(model)
    if args.vq_ckpt:
        load_vq_encoder(model, args.vq_ckpt)
    trainable = vqcontrolnet_trainable_mask(model)
    for name, p in model.named_parameters():
        p.requires_grad_(name in trainable)
    return model


class Trainer(tv.Trainer):
    """train_vqvae's Trainer over a VQControlNet: the optimizer steps the
    branch alone (the model's trainable set), the diffusion runs in the
    VAE's latent space (train_vqcontrolnet.py:167-193)."""

    def __init__(self, args, device):
        super().__init__(args, device, model=build_model(args, device))

    def config(self) -> Dict:
        return model_config(self.args)

    def diffusion_target(self, x: torch.Tensor, draws: Dict) -> torch.Tensor:
        """A sample of the frozen VAE's latent of x (draws["vae_noise"], else
        from the trainer's generator), fp32."""
        return self.model.vae_encode(x, draws.get("vae_noise"), self.gen).float()


def run_eval(trainer: Trainer, batch: torch.Tensor) -> Dict[str, float]:
    """train_vqcontrolnet.py:212-221: the batch tokenized and decoded with
    --eval_timesteps DDIM steps (noise from a generator seeded 9) -> MSE
    against the batch, codebook usage."""
    from ..vq import controlnet_decode_quant

    args, m = trainer.args, trainer.model
    with torch.no_grad():
        quant, _, tokens = m.encode(batch)
        gen = torch.Generator(device=trainer.device).manual_seed(9)
        img = controlnet_decode_quant(m, quant, gen, timesteps=args.eval_timesteps)
    mse = float((img.float() - batch.float()).square().mean())
    usage = len(torch.unique(tokens)) / args.codebook_size
    return {"mse": mse, "codebook_usage": usage}


def main(args=None):
    from ..api import resolve_device
    from ..utils.config import parse_args_with_config

    args = parse_args_with_config(get_parser(), args)
    trainer = Trainer(args, resolve_device(args.device))
    tv.train_loop(trainer, run_eval)
    return trainer


if __name__ == "__main__":
    main()
