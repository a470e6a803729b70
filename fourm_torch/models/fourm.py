"""FourM: the 4M multimodal encoder-decoder, PyTorch port.

Counterpart of fourm_tpu/models/fourm.py (reference fourm/models/fm.py): the
same configuration, registry, modality-dict format, generation forwards and
training forward, as an nn.Module whose parameter names are the reference
torch names (`encoder.{i}.attn.qkv.weight`, `encoder_embeddings.{mod}.mod_emb`,
...). Generation: the image-target forward and the KV-cached autoregressive
methods. Training: `forward` (JAX's `__call__` with deterministic=False),
the masked-modeling loss over exact per-modality buckets.

mod_dict format (per modality): {
  'tensor': int tokens (B, L) / image-token grid (B, N) / raw NHWC image,
  'input_mask': (B, L) bool, True = NOT an encoder input,
  'target_mask': (B, L) bool, True = NOT a decoder target,
  'decoder_attention_mask': (B, L) int compressed decoder attention mask,
}
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.modality_info import MODALITY_INFO, ModalitySpec
from ..ops.token_select import adapt_decoder_attention_mask, gather_tokens, select_tokens
from ..ops.transformer import Block, DecoderBlock, LayerNorm, _dense, _key_bias
from .embeddings import (
    ImageEncoderEmbedding,
    ImageTokenDecoderEmbedding,
    ImageTokenEncoderEmbedding,
    SequenceDecoderEmbedding,
    SequenceEmbEncoderEmbedding,
    SequenceEncoderEmbedding,
)

SEQ_TYPES = ("seq", "seq_emb", "seq_token")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclass(frozen=True)
class FourMConfig:
    """Static configuration of a FourM model (reference fm.py:81-174)."""

    encoder_modalities: Tuple[str, ...]
    decoder_modalities: Tuple[str, ...]
    dim: int = 768
    encoder_depth: int = 12
    decoder_depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    proj_bias: bool = True
    mlp_bias: bool = True
    norm_bias: bool = True
    act: str = "gelu"
    gated_mlp: bool = False
    qk_norm: bool = False
    decoder_causal_mask: bool = False
    decoder_sep_mask: bool = True
    num_register_tokens: int = 0
    share_modality_embeddings: bool = True
    decoder_share_embedding: bool = True
    drop_path_rate_encoder: float = 0.0
    drop_path_rate_decoder: float = 0.0
    shared_drop_path: bool = False
    remat: bool = False
    dtype: str = "float32"  # compute dtype

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def spec(self, mod: str) -> ModalitySpec:
        return MODALITY_INFO[mod]


def _grid_for(spec: ModalitySpec) -> Tuple[int, int]:
    g = spec.grid_size
    if g is not None:
        return g
    n = int(round(spec.resolved_max_tokens() ** 0.5))  # global-token modalities
    return (n, n)


def _build_encoder_embedding(spec: ModalitySpec, dim: int, dtype) -> Optional[nn.Module]:
    kind = spec.encoder_embedding
    if kind is None:
        return None
    if kind == "image":
        gh, gw = _grid_for(spec)
        return ImageEncoderEmbedding(spec.num_channels, spec.patch_size, gh, gw, dim,
                                     spec.sincos_pos_emb, dtype)
    if kind == "image_token":
        gh, gw = _grid_for(spec)
        return ImageTokenEncoderEmbedding(spec.vocab_size, gh, gw, dim,
                                          spec.sincos_pos_emb, dtype)
    if kind == "sequence":
        return SequenceEncoderEmbedding(spec.vocab_size, spec.max_length, dim,
                                        spec.sincos_pos_emb, dtype=dtype)
    if kind == "sequence_emb":
        return SequenceEmbEncoderEmbedding(spec.max_length, dim, spec.orig_emb_dim, dtype=dtype)
    raise ValueError(f"unknown encoder embedding kind {kind}")


def _build_decoder_embedding(spec: ModalitySpec, dim: int, dtype,
                             share_embedding: bool) -> Optional[nn.Module]:
    kind = spec.decoder_embedding
    if kind is None:
        return None
    if kind == "image_token":
        gh, gw = _grid_for(spec)
        return ImageTokenDecoderEmbedding(spec.vocab_size, gh, gw, dim, spec.sincos_pos_emb,
                                          share_embedding, dtype)
    if kind == "sequence":
        return SequenceDecoderEmbedding(spec.vocab_size, spec.max_length, dim,
                                        spec.sincos_pos_emb, share_embedding=share_embedding,
                                        dtype=dtype)
    raise ValueError(f"unknown decoder embedding kind {kind}")


def _drop_path_rates(cfg: FourMConfig):
    """Per-block stochastic-depth rates, linear in depth (fourm.py:208-214)."""
    if cfg.shared_drop_path:
        total = cfg.encoder_depth + cfg.decoder_depth
        dprs = [cfg.drop_path_rate_encoder * i / max(total - 1, 1) for i in range(total)]
        return dprs[:cfg.encoder_depth], dprs[cfg.encoder_depth:]
    enc = [cfg.drop_path_rate_encoder * i / max(cfg.encoder_depth - 1, 1)
           for i in range(cfg.encoder_depth)]
    dec = [cfg.drop_path_rate_decoder * i / max(cfg.decoder_depth - 1, 1)
           for i in range(cfg.decoder_depth)]
    return enc, dec


class FourM(nn.Module):
    """4M encoder-decoder over modality dicts."""

    def __init__(self, config: FourMConfig):
        super().__init__()
        cfg = self.config = config
        dtype = cfg.compute_dtype
        self.encoder_embeddings = nn.ModuleDict()
        for mod in cfg.encoder_modalities:
            m = _build_encoder_embedding(cfg.spec(mod), cfg.dim, dtype)
            if m is not None:
                self.encoder_embeddings[mod] = m
        self.decoder_embeddings = nn.ModuleDict()
        for mod in cfg.decoder_modalities:
            m = _build_decoder_embedding(cfg.spec(mod), cfg.dim, dtype,
                                         cfg.decoder_share_embedding)
            if m is not None:
                self.decoder_embeddings[mod] = m
        if cfg.share_modality_embeddings:  # reference fm.py:176-180
            for mod, dec in self.decoder_embeddings.items():
                if mod in self.encoder_embeddings:
                    dec.mod_emb = self.encoder_embeddings[mod].mod_emb

        block_kw = dict(
            dim=cfg.dim, num_heads=cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
            qkv_bias=cfg.qkv_bias, proj_bias=cfg.proj_bias, mlp_bias=cfg.mlp_bias,
            act=cfg.act, gated_mlp=cfg.gated_mlp, qk_norm=cfg.qk_norm,
            norm_bias=cfg.norm_bias, dtype=dtype,
        )
        dpr_enc, dpr_dec = _drop_path_rates(cfg)
        self.encoder = nn.ModuleList([Block(**block_kw, drop_path_rate=r) for r in dpr_enc])
        self.encoder_norm = LayerNorm(cfg.dim, use_bias=cfg.norm_bias, dtype=dtype)
        self.decoder_proj_context = nn.Linear(cfg.dim, cfg.dim)
        self.decoder = nn.ModuleList([DecoderBlock(**block_kw, drop_path_rate=r)
                                      for r in dpr_dec])
        self.decoder_norm = LayerNorm(cfg.dim, use_bias=cfg.norm_bias, dtype=dtype)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, cfg.dim))
        if cfg.num_register_tokens > 0:
            self.register_tokens = nn.Parameter(
                torch.zeros(1, cfg.num_register_tokens, cfg.dim))

    @property
    def device(self) -> torch.device:
        return self.mask_token.device

    # ------------------------------------------------------------------ encoder

    def _cat_encoder(self, mod_dict: Dict[str, Dict[str, torch.Tensor]]):
        """Embed and concatenate all encoder modalities (reference fm.py:245-278)."""
        xs, embs, masks, modids = [], [], [], []
        dtype = self.config.compute_dtype
        for mod in self.config.encoder_modalities:
            if mod not in mod_dict or mod not in self.encoder_embeddings:
                continue
            d = mod_dict[mod]
            emb_mod = self.encoder_embeddings[mod]
            x, pos = emb_mod(d["tensor"], d["input_mask"])
            xs.append(x)
            embs.append(pos + emb_mod.mod_emb.to(dtype))
            masks.append(d["input_mask"])
            modids.append(torch.full(d["input_mask"].shape, self.config.spec(mod).id,
                                     dtype=torch.int64, device=x.device))
        return (torch.cat(xs, 1), torch.cat(embs, 1), torch.cat(masks, 1),
                torch.cat(modids, 1))

    def forward_mask_encoder(self, mod_dict, num_encoder_tokens: Optional[int]):
        """Select the encoder token subset (reference fm.py:338-390);
        None keeps the whole concatenated stream."""
        x, emb, mask, modid = self._cat_encoder(mod_dict)
        B = x.shape[0]
        if num_encoder_tokens is not None:
            idx = select_tokens(mask, num_encoder_tokens)
            x, emb = gather_tokens(x, idx), gather_tokens(emb, idx)
            mask, modid = torch.gather(mask, 1, idx), torch.gather(modid, 1, idx)
        if self.config.num_register_tokens > 0:
            R = self.config.num_register_tokens
            reg = self.register_tokens.to(x.dtype).expand(B, R, -1)
            x = torch.cat([reg, x], 1)
            emb = torch.cat([torch.zeros_like(reg), emb], 1)
            mask = torch.cat([torch.zeros((B, R), dtype=torch.bool, device=x.device), mask], 1)
            modid = torch.cat([torch.full((B, R), -1, dtype=modid.dtype,
                                          device=x.device), modid], 1)
        x = x.masked_fill(mask[..., None], 0.0)
        emb = emb.masked_fill(mask[..., None], 0.0)
        modid = modid.masked_fill(mask, -1)
        return x, emb, mask, modid

    def forward_encoder(self, x, encoder_mask, train: bool = False,
                        generator: Optional[torch.Generator] = None):
        """Encoder blocks; encoder_mask (B, N) or (B, 1, N) bool (fm.py:477-495).
        `train` runs the blocks' differentiable training path."""
        if encoder_mask is not None and encoder_mask.ndim == 2:
            encoder_mask = encoder_mask[:, None, :]
        for blk in self.encoder:
            x = blk(x, encoder_mask, train=train, generator=generator)
        return self.encoder_norm(x)

    def encode(self, mod_dict, num_encoder_tokens: Optional[int] = None, train: bool = False,
               generator: Optional[torch.Generator] = None):
        """Embed + select + encode. Returns (enc_out, enc_emb, enc_mask, enc_modid)."""
        x, emb, mask, modid = self.forward_mask_encoder(mod_dict, num_encoder_tokens)
        return self.forward_encoder(x + emb, mask, train, generator), emb, mask, modid

    def decoder_context(self, enc_out, enc_emb):
        """Project the encoder output and re-add its embeddings (fm.py:674)."""
        return _dense(enc_out, self.decoder_proj_context, self.config.compute_dtype) + enc_emb

    # ------------------------------------------------------------------ decoder

    def _cat_decoder(self, mod_dict):
        """Embed and concatenate the decoder modalities, sequence ones shifted
        for next-token prediction (fourm_tpu fourm.py:320-358, reference
        fm.py:279-334): input[:-1] predicts ids[1:], the merged mask drops
        the last unmasked position; image modalities take the mask token as
        input."""
        xs, embs, masks, ids, attn, modids = [], [], [], [], [], []
        dtype = self.config.compute_dtype
        mask_token = self.mask_token.to(dtype)
        for mod in self.config.decoder_modalities:
            if mod not in mod_dict or mod not in self.decoder_embeddings:
                continue
            d = mod_dict[mod]
            spec = self.config.spec(mod)
            dec_emb = self.decoder_embeddings[mod]
            x, pos, tok_ids = dec_emb.embed(d["tensor"], d["target_mask"])
            emb = pos + dec_emb.mod_emb.to(dtype)
            if spec.type in SEQ_TYPES:
                xs.append(x[:, :-1])
                embs.append(emb[:, :-1])
                ids.append(tok_ids[:, 1:])
                masks.append(d["target_mask"][:, 1:] | d["target_mask"][:, :-1])
                attn.append(d["decoder_attention_mask"][:, :-1])
                n = x.shape[1] - 1
            else:
                xs.append(mask_token.expand(x.shape))
                embs.append(emb)
                ids.append(tok_ids)
                masks.append(d["target_mask"])
                attn.append(d["decoder_attention_mask"])
                n = x.shape[1]
            modids.append(torch.full((x.shape[0], n), spec.id, dtype=torch.int64,
                                     device=x.device))
        return (torch.cat(xs, 1), torch.cat(embs, 1), torch.cat(masks, 1), torch.cat(ids, 1),
                torch.cat(attn, 1), torch.cat(modids, 1))

    def forward_mask_decoder(self, mod_dict, num_decoder_tokens: Optional[int]):
        """Select the decoder token subset and build its full self-attention
        mask (fm.py:392-438). Returns (x, emb, mask, target ids, sa_mask
        (B, M, M), modid)."""
        x, emb, mask, ids, attn, modid = self._cat_decoder(mod_dict)
        if num_decoder_tokens is not None:
            idx = select_tokens(mask, num_decoder_tokens)
            x, emb = gather_tokens(x, idx), gather_tokens(emb, idx)
            mask, ids = torch.gather(mask, 1, idx), torch.gather(ids.long(), 1, idx)
            attn, modid = torch.gather(attn, 1, idx), torch.gather(modid, 1, idx)
        x = x.masked_fill(mask[..., None], 0.0)
        emb = emb.masked_fill(mask[..., None], 0.0)
        ids = ids.masked_fill(mask, 0)
        sa_mask = adapt_decoder_attention_mask(attn, modid, causal=self.config.decoder_causal_mask,
                                               sep_mask=self.config.decoder_sep_mask)
        modid = modid.masked_fill(mask, -1)
        return x, emb, mask, ids, sa_mask, modid

    def forward_decoder(self, y, context, encoder_mask, decoder_attention_mask,
                        train: bool = False, generator: Optional[torch.Generator] = None):
        """Decoder blocks (fm.py:497-519)."""
        if encoder_mask is not None and encoder_mask.ndim == 2:
            encoder_mask = encoder_mask[:, None, :]
        for blk in self.decoder:
            y = blk(y, context, decoder_attention_mask, encoder_mask, train=train,
                    generator=generator)
        return self.decoder_norm(y)

    def mod_logits(self, mod: str, y: torch.Tensor) -> torch.Tensor:
        """Logits for one modality over all given decoder outputs."""
        return self.decoder_embeddings[mod].logits(y)

    def forward_generation_img(self, mod_dict, target_mod: str, sa_keys_valid: torch.Tensor,
                               num_encoder_tokens: Optional[int] = None) -> torch.Tensor:
        """Generation forward for an image-token target over its full token grid
        (reference generate.py:628-765, in the fixed-shape form of the JAX
        package): every grid position is a decoder query; self-attention keys
        are restricted to `sa_keys_valid` (True = attendable).
        num_encoder_tokens compacts the encoder stream to its first K selected
        (valid-first) tokens; every valid token is kept, so logits do not change.
        Returns logits (B, N_grid, V) in the compute dtype."""
        enc_out, enc_emb, enc_mask, _ = self.encode(mod_dict, num_encoder_tokens)
        context = self.decoder_context(enc_out, enc_emb)
        d = mod_dict[target_mod]
        dtype = self.config.compute_dtype
        dec_emb = self.decoder_embeddings[target_mod]
        x, pos, _ids = dec_emb.embed(d["tensor"], d["target_mask"])
        emb = pos + dec_emb.mod_emb.to(dtype)
        y = self.mask_token.to(dtype).expand_as(x) + emb
        sa_mask = ~sa_keys_valid[:, None, :]  # (B, 1, N) keys
        y = self.forward_decoder(y, context, enc_mask, sa_mask)
        return self.mod_logits(target_mod, y)

    # ------------------------------------------------ autoregressive decoding

    def ar_prefill(self, mod_dict, target_mod: str, max_len: int,
                   num_encoder_tokens: Optional[int] = None):
        """Encoder pass, per-layer cross-attention K/V and the target's
        position embeddings for KV-cached AR decoding (fourm_tpu
        models/fourm.py:428-442). Returns (cross_kvs, enc_mask, y_emb
        (B, max_len, D)); num_encoder_tokens as in forward_generation_img."""
        enc_out, enc_emb, enc_mask, _ = self.encode(mod_dict, num_encoder_tokens)
        context = self.decoder_context(enc_out, enc_emb)
        cross_kvs = self.decoder_cross_kvs(context)
        dec_emb = self.decoder_embeddings[target_mod]
        y_emb = (dec_emb.pos_table(max_len).float() + dec_emb.mod_emb[0].float())
        y_emb = y_emb.to(self.config.compute_dtype)
        return cross_kvs, enc_mask, y_emb[None].expand(enc_out.shape[0], -1, -1)

    def decoder_cross_kvs(self, context):
        """Per-layer cross-attention K/V, computed once per AR target."""
        return [blk.cross_kv(context) for blk in self.decoder]

    def embed_target_token(self, mod: str, ids: torch.Tensor) -> torch.Tensor:
        """Token embedding lookup for AR decoding (sequence modalities)."""
        return self.decoder_embeddings[mod].token_embed(ids)

    def decode_one_token(self, y_t, caches, cross_kvs, enc_mask, step_idx):
        """One KV-cached decoder step (fourm_tpu models/fourm.py:456-464).
        y_t (B, 1, D); caches per-layer (k, v) of shape (B, H, L, Dh), updated
        in place; cross_kvs per-layer (k, v), bf16 or int8 (values, scale)
        tuples, passed to each block as they are; step_idx a one-element
        int32 tensor. Returns (normed output, caches)."""
        xa_bias = _key_bias(enc_mask)  # once per token, shared by every layer
        for blk, (ck, cv), (xk, xv) in zip(self.decoder, caches, cross_kvs):
            y_t, _, _ = blk.step(y_t, ck, cv, xk, xv, xa_bias, step_idx)
        return self.decoder_norm(y_t), caches

    # ------------------------------------------------------------------ loss

    def _decoder_stream_length(self, mod: str, mod_dict) -> int:
        """Length this modality contributes to the decoder stream, from the
        data's shapes (sequence tensors lose one position to the AR shift)."""
        t = mod_dict[mod]["tensor"]
        n = int(np.prod(t.shape[1:])) if t.ndim > 2 else t.shape[1]
        return n - 1 if self.config.spec(mod).type in SEQ_TYPES else n

    def forward_loss(self, y, target_ids, decoder_modid, mods, mod_dict,
                     num_decoder_tokens: Optional[int], loss_type: str = "mod"):
        """Per-modality cross-entropy over exact fixed-capacity buckets
        (fourm_tpu fourm.py:485-525, reference fm.py:547-637): each target
        modality gathers the first C positions carrying its id (C = min(its
        stream length, the budget, M), which bounds how many it can hold),
        logits in fp32. "mod" averages the modalities' mean losses; "token"
        weights each by its count times its vocabulary (logits.numel(), as
        the reference)."""
        M = y.shape[1]
        mod_loss, mod_count = {}, {}
        total_sum, total_cnt = 0.0, 0.0
        for mod in mods:
            spec = self.config.spec(mod)
            cap = min(self._decoder_stream_length(mod, mod_dict), num_decoder_tokens or M, M)
            bucket = select_tokens(decoder_modid != spec.id, cap)
            y_m = gather_tokens(y, bucket)
            valid = torch.gather(decoder_modid, 1, bucket) == spec.id
            # a position of another modality may hold an id past this vocabulary:
            # its loss is masked out, so any in-range id does
            tgt = torch.gather(target_ids, 1, bucket).masked_fill(~valid, 0)
            logits = self.mod_logits(mod, y_m).float()
            ce = -torch.gather(F.log_softmax(logits, dim=-1), -1, tgt[..., None].long())[..., 0]
            cnt = valid.sum()
            mod_loss[mod] = torch.where(valid, ce, 0.0).sum() / cnt.clamp_min(1)
            mod_count[mod] = cnt
            vocab = logits.shape[-1]
            total_sum = total_sum + mod_loss[mod] * cnt * vocab
            total_cnt = total_cnt + cnt * vocab
        if loss_type in ("mod", "modality"):
            loss = sum(mod_loss.values()) / max(len(mod_loss), 1)
        elif loss_type == "token":
            loss = total_sum / torch.clamp_min(torch.as_tensor(total_cnt), 1)
        else:
            raise ValueError(f"invalid loss type {loss_type}")
        return loss, mod_loss, mod_count

    # ------------------------------------------------------------------ train

    def forward(self, mod_dict: Dict[str, Dict[str, torch.Tensor]], num_encoder_tokens: int,
                num_decoder_tokens: int, loss_type: str = "mod",
                generator: Optional[torch.Generator] = None):
        """The training forward (fourm_tpu fourm.py:529-557 with
        deterministic=False; reference fm.py:640-692): encoder and decoder
        on their training paths, then the loss. `generator` draws the
        stochastic-depth masks. Returns (loss, (mod_loss, mod_count))."""
        if self.config.remat:
            raise NotImplementedError("remat (activation checkpointing) is not ported yet")
        enc_out, enc_emb, enc_mask, _ = self.encode(mod_dict, num_encoder_tokens, True, generator)
        dec_x, dec_emb, _dec_mask, target_ids, sa_mask, dec_modid = self.forward_mask_decoder(
            mod_dict, num_decoder_tokens)
        context = self.decoder_context(enc_out, enc_emb)
        y = self.forward_decoder(dec_x + dec_emb, context, enc_mask, sa_mask, True, generator)
        mods = [m for m in self.config.decoder_modalities
                if m in mod_dict and m in self.decoder_embeddings]
        loss, mod_loss, mod_count = self.forward_loss(y, target_ids, dec_modid, mods, mod_dict,
                                                      num_decoder_tokens, loss_type)
        return loss, (mod_loss, mod_count)

    def init_kv_caches(self, batch_size: int, max_len: int):
        """Zeroed per-layer self-attention KV caches, (B, H, L, Dh), one
        buffer each (the decode step writes them in place)."""
        cfg = self.config
        shape = (batch_size, cfg.num_heads, max_len, cfg.dim // cfg.num_heads)

        def zeros():
            return torch.zeros(shape, dtype=cfg.compute_dtype, device=self.device)

        return [(zeros(), zeros()) for _ in range(cfg.decoder_depth)]


def init_weights(model: FourM, seed: int, std: float = 0.02) -> FourM:
    """Random weights from a seeded torch.Generator on the model's device,
    following the JAX package's initialisers: linear weights lecun-normal
    (std 1/sqrt(fan_in)), embeddings, modality and mask tokens normal(std),
    LayerNorm weights one, all biases zero."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            owner = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
            if isinstance(owner, LayerNorm):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias":
                p.zero_()
            elif isinstance(owner, nn.Linear):
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device)
                        * p.shape[1] ** -0.5)
            else:
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * std)
    return model


# ---------------------------------------------------------------------- registry

MODEL_SIZES = {
    "tiny": dict(dim=384, encoder_depth=6, decoder_depth=6, num_heads=6),
    "small": dict(dim=512, encoder_depth=8, decoder_depth=8, num_heads=8),
    "base": dict(dim=768, encoder_depth=12, decoder_depth=12, num_heads=12),
    "large": dict(dim=1024, encoder_depth=24, decoder_depth=24, num_heads=16),
    "xlarge": dict(dim=2048, encoder_depth=24, decoder_depth=24, num_heads=32),
}

_FLAVORS = {
    "gelu": dict(act="gelu"),
    "swiglu_nobias": dict(
        act="silu", gated_mlp=True, qkv_bias=False, proj_bias=False,
        mlp_bias=False, norm_bias=False,
    ),
    "swiglu_qknorm_nobias": dict(
        act="silu", gated_mlp=True, qkv_bias=False, proj_bias=False,
        mlp_bias=False, norm_bias=False, qk_norm=True,
    ),
}

# 13 registered constructors (reference fm.py:33-50 / :839-1130)
MODEL_REGISTRY: Dict[str, Dict[str, Any]] = {}
for _size in MODEL_SIZES:
    for _flavor, _fkw in _FLAVORS.items():
        if _flavor == "swiglu_qknorm_nobias" and _size in ("tiny", "small"):
            continue
        _d = MODEL_SIZES[_size]["encoder_depth"]
        MODEL_REGISTRY[f"fm_{_size}_{_d}e_{_d}d_{_flavor}"] = {**MODEL_SIZES[_size], **_fkw}


def create_fourm_config(model_name: str, encoder_modalities: Tuple[str, ...],
                        decoder_modalities: Tuple[str, ...], **overrides) -> FourMConfig:
    """A FourMConfig from a registered size variant plus overrides."""
    if model_name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {model_name}; known: {sorted(MODEL_REGISTRY)}")
    kw = dict(MODEL_REGISTRY[model_name])
    kw.update(overrides)
    return FourMConfig(encoder_modalities=tuple(encoder_modalities),
                       decoder_modalities=tuple(decoder_modalities), **kw)
