"""FourMSampler: the one-class generation API of the PyTorch port.

Counterpart of fourm_tpu/api.py (reference fourm/demo_4M_sampler.py:29-447):
holds a FourM model on its device and the tokenizers' decoders, builds
chained generation schedules from per-modality defaults, generates
image-token targets (ROAR / MaskGIT) and sequence targets (KV-cached
autoregressive decoding), so the whole RGB-to-all chain, and decodes the
generated tokens into images, text and structured outputs
(utils/decoding.py:decode_dict). With an SR model (`fm_sr`), the 224
tokens of a chain condition a 224 -> 448 super-resolution chain
(`super_resolve`, `__call__(perform_sr=True)`).

Usage:
    sampler = FourMSampler(model, text_tokenizer,
                           tokenizers={"tok_depth": TokenizerBundle(divae)})  # on "cuda"
    out = sampler(sample={"rgb@224": img_nhwc}, cond_domains=["rgb@224"],
                  target_domains=["tok_clip@224", "tok_depth@224", "caption"], seed=0)
    # or step by step:
    mod_dict = sampler.prepare_sample({"rgb@224": img_nhwc}, ["rgb@224"], targets,
                                      batch_size=8)
    gen = sampler.generate(mod_dict, sampler.build_schedule(["rgb@224"], targets), seed=0)
    images = sampler.decode(gen, decoding_steps=25, seed=0)
    # 224 -> 448: the @224 tokens condition a second model's @448 targets
    sampler = FourMSampler(model, text_tokenizer, fm_sr=sr_model)
    gen448 = sampler.super_resolve(gen, seed=0)
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .data.modality_info import MODALITY_INFO
from .generate import (
    GenerationSampler,
    build_chained_generation_schedules,
    custom_text,
    expand_to_batch,
    init_empty_target_modality,
    init_full_input_modality,
)
from .utils.decoding import TokenizerBundle, decode_dict

# Default chained generation order (reference demo_4M_sampler.py:29-39)
DEFAULT_ORDER = [
    "tok_clip@224", "tok_dinov2@224", "tok_imagebind@224", "tok_depth@224",
    "tok_normal@224", "tok_semseg@224", "tok_canny_edge@224", "tok_sam_edge@224",
    "tok_rgb@224", "caption", "det", "human_poses", "sam_instance",
    "color_palette", "metadata",
]
DEFAULT_ORDER_SR = [
    "tok_clip@448", "tok_depth@448", "tok_normal@448", "tok_semseg@448", "tok_rgb@448",
]


def _expand_defaults(d: Dict[str, Dict]) -> Dict[str, Dict]:
    return {k: v for ks, v in d.items() for k in ks.split("/")}


def _roar(tokens, steps, temp, temp_schedule, cfg):
    return {"tokens_per_target": tokens, "autoregression_scheme": "roar",
            "decoding_steps": steps, "token_decoding_schedule": "linear", "temp": temp,
            "temp_schedule": temp_schedule, "cfg_scale": cfg, "cfg_schedule": "constant"}


def _ar(tokens, temp):
    return {"tokens_per_target": tokens, "autoregression_scheme": "autoregressive",
            "decoding_steps": None, "token_decoding_schedule": None, "temp": temp,
            "temp_schedule": "constant", "cfg_scale": 1.0, "cfg_schedule": "constant"}


# (reference demo_4M_sampler.py:42-136; the same values as fourm_tpu/api.py)
DEFAULTS_RGB2X = _expand_defaults({
    "tok_clip@224/tok_depth@224/tok_normal@224/tok_semseg@224/tok_canny_edge@224/"
    "tok_sam_edge@224": _roar(196, 1, 0.01, "constant", 2.0),
    "tok_dinov2@224/tok_imagebind@224": _roar(256, 1, 0.01, "constant", 2.0),
    "tok_dinov2_global/tok_imagebind_global": _roar(16, 1, 0.01, "constant", 2.0),
    "caption/det": _ar(256, 0.3),
    "human_poses": _ar(275, 0.1),
    "sam_instance": _ar(256, 0.01),
    "color_palette": _ar(23, 0.1),
    "metadata": _ar(40, 0.1),
})

DEFAULTS_X2RGB = _expand_defaults({
    "tok_clip@224": _roar(196, 50, 5.0, "onex:0.5:0.5", 3.0),
    "tok_dinov2@224/tok_imagebind@224": _roar(256, 8, 0.01, "constant", 2.0),
    "tok_dinov2_global/tok_imagebind_global": _roar(16, 1, 0.01, "constant", 2.0),
    "tok_depth@224/tok_normal@224/tok_semseg@224/tok_canny_edge@224/tok_sam_edge@224":
        _roar(196, 8, 3.0, "onex:0.5:0.5", 2.0),
    "tok_rgb@224": _roar(196, 25, 3.0, "onex:0.5:0.5", 2.0),
    "caption/det": _ar(256, 0.3),
    "human_poses": _ar(275, 0.1),
    "sam_instance": _ar(256, 0.01),
    "color_palette": _ar(23, 0.1),
    "metadata": _ar(40, 0.1),
})

DEFAULTS_SR = _expand_defaults({
    "tok_clip@448/tok_depth@448/tok_normal@448/tok_semseg@448/tok_rgb@448": {
        "tokens_per_target": 784, "autoregression_scheme": "maskgit", "decoding_steps": 8,
        "token_decoding_schedule": "cosine", "temp": 1.0, "temp_schedule": "constant",
        "cfg_scale": 2.0, "cfg_schedule": "constant",
    },
})

_SCHEDULE_KEYS = ("tokens_per_target", "autoregression_scheme", "decoding_steps",
                  "token_decoding_schedule", "temp", "temp_schedule", "cfg_scale",
                  "cfg_schedule")


def resolve_device(device: Optional[str]) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks for
    the CPU. Without a GPU, anything but an explicit CPU request raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fourm_torch runs on a CUDA device and none is available; "
                           "pass device='cpu' to run the plain PyTorch path")
    return dev


class FourMSampler:
    """High-level chained generation (reference Demo4MSampler,
    demo_4M_sampler.py:202-447) for a FourM model of the port."""

    def __init__(self, fm, text_tokenizer=None, top_k: float = 0.0, top_p: float = 0.0,
                 device: str = "cuda", kv_quant: Optional[str] = None,
                 tokenizers: Optional[Dict[str, TokenizerBundle]] = None, fm_sr=None,
                 mods: Optional[List[str]] = None, mods_sr: Optional[List[str]] = None):
        """fm: a FourM of the port, moved to `device`; text_tokenizer encodes
        text prompts given as conditioning, and its sentinel ids drive the
        span merge of sequence targets (it needs `get_vocab()` and
        `token_to_id()`; `encode()` only for text prompts; `decode()` for
        decoding sequence targets); kv_quant None or "int8", the AR
        targets' cross K/V mode (GenerationSampler); tokenizers: {transform
        key ("tok_depth", "sam_instance", ...): TokenizerBundle}, the
        decoders `decode` uses, each on its own device; fm_sr: a FourM of
        the port for 224 -> 448 super-resolution, moved to `device`, with a
        GenerationSampler of its own (the same top_k, top_p, kv_quant);
        mods / mods_sr: kept, as in the JAX package."""
        self.device = resolve_device(device)
        self.model = fm.to(self.device).eval()
        self.sampler = GenerationSampler(self.model, text_tokenizer, top_k=top_k, top_p=top_p,
                                         kv_quant=kv_quant)
        if fm_sr is not None:
            self.model_sr = fm_sr.to(self.device).eval()
            self.sampler_sr = GenerationSampler(self.model_sr, text_tokenizer, top_k=top_k,
                                                top_p=top_p, kv_quant=kv_quant)
        else:
            self.sampler_sr = None
        self.text_tokenizer = text_tokenizer
        self.tokenizers = tokenizers or {}
        self.mods, self.mods_sr = mods, mods_sr

    def _ordered_targets(self, target_domains, order):
        """Default order first; targets outside it are appended."""
        ordered = [m for m in order if m in target_domains]
        return ordered + [m for m in target_domains if m not in ordered]

    def resolve_defaults(self, cond_domains: List[str]) -> Dict[str, Dict]:
        """Per-modality schedule defaults for this conditioning side."""
        rgb = any(d.startswith("rgb") or d.startswith("tok_rgb") for d in cond_domains)
        return {**(DEFAULTS_RGB2X if rgb else DEFAULTS_X2RGB), **DEFAULTS_SR}

    def build_schedule(self, cond_domains: List[str], target_domains: List[str],
                       defaults: Optional[Dict] = None, cfg_grow_conditioning: bool = True):
        """A chained schedule from per-modality defaults (reference
        __setup_sample_and_schedule, demo_4M_sampler.py:304-404)."""
        if defaults is None:
            defaults = self.resolve_defaults(cond_domains)
        targets = self._ordered_targets(target_domains, DEFAULT_ORDER + DEFAULT_ORDER_SR)
        cols = {k: [defaults[t][k] for t in targets] for k in _SCHEDULE_KEYS}
        return build_chained_generation_schedules(
            cond_domains=list(cond_domains), target_domains=targets,
            tokens_per_target=cols["tokens_per_target"],
            autoregression_schemes=cols["autoregression_scheme"],
            decoding_steps=cols["decoding_steps"],
            token_decoding_schedules=cols["token_decoding_schedule"],
            temps=cols["temp"], temp_schedules=cols["temp_schedule"],
            cfg_scales=cols["cfg_scale"], cfg_schedules=cols["cfg_schedule"],
            cfg_grow_conditioning=cfg_grow_conditioning, modality_info=MODALITY_INFO,
        )

    def prepare_sample(self, sample: Dict[str, Any], cond_domains: List[str],
                       target_domains: List[str], batch_size: int = 1) -> Dict:
        """Wrap raw conditioning values (NHWC images, token arrays, text) into
        full mod dicts plus empty targets, as numpy arrays."""
        mod_dict: Dict[str, Dict] = {}
        for mod in cond_domains:
            value = sample[mod]
            if isinstance(value, dict):
                mod_dict[mod] = dict(value)
            elif MODALITY_INFO[mod].type in ("seq", "seq_token") and isinstance(value, str):
                custom_text(mod_dict, value, "[EOS]", mod, self.text_tokenizer)
                init_full_input_modality(mod_dict, mod)
                continue
            else:
                arr = np.array(value)  # a copy: the init helpers mutate in place
                if arr.ndim in (1, 3):  # unbatched tokens / image
                    arr = arr[None]
                mod_dict[mod] = {"tensor": arr}
            init_full_input_modality(mod_dict, mod)
        for mod in self._ordered_targets(target_domains, DEFAULT_ORDER + DEFAULT_ORDER_SR):
            init_empty_target_modality(mod_dict, mod, batch_size,
                                       MODALITY_INFO[mod].resolved_max_tokens())
        return expand_to_batch(mod_dict, batch_size)

    def generate(self, mod_dict, schedule, seed: Optional[int] = None):
        return self.sampler.generate(mod_dict, schedule, seed=seed,
                                     text_tokenizer=self.text_tokenizer)

    def decode(self, mod_dict, image_size: int = 224, decoding_steps: int = 25,
               seed: Optional[int] = None, keys: Optional[Sequence[str]] = None):
        """The generated mod dict (or its `keys`) decoded by decode_dict:
        images as numpy arrays, text, metadata dicts. Diffusion decoders run
        `decoding_steps` steps (half that for the edge tokenizers), drawing
        from one generator seeded from `seed`, key after key."""
        sub = {k: v for k, v in mod_dict.items() if keys is None or k in keys}
        return decode_dict(sub, self.tokenizers, self.text_tokenizer, image_size=image_size,
                           decoding_steps=decoding_steps, seed=seed)

    def __call__(self, sample: Dict[str, Any], cond_domains: List[str],
                 target_domains: List[str], seed: Optional[int] = None,
                 batch_size: int = 1, decoding_steps: int = 25, perform_sr: bool = False):
        """Condition -> chained generation -> decoded outputs (reference
        Demo4MSampler.forward, demo_4M_sampler.py:405-447): the decoded
        targets, by modality. With perform_sr and an SR model, the chain's
        @224 tokens are super-resolved first and every key of that result is
        decoded; without an SR model perform_sr skips the super-resolution
        and decodes every key of the chain's output."""
        mod_dict = self.prepare_sample(sample, cond_domains, target_domains, batch_size)
        out = self.generate(mod_dict, self.build_schedule(cond_domains, target_domains),
                            seed=seed)
        if perform_sr and self.sampler_sr is not None:
            out = self.super_resolve(out, seed=seed)
        return self.decode(out, decoding_steps=decoding_steps, seed=seed,
                           keys=[m for m in out if m in target_domains or perform_sr])

    def super_resolve(self, mod_dict, seed: Optional[int] = None):
        """224 -> 448 super-resolution (fourm_tpu api.py:166-188, reference
        demo_4M_sampler.py:426-439): every @224 entry of mod_dict conditions
        the SR model (an entry it does not embed is skipped by its encoder),
        whose targets are the DEFAULT_ORDER_SR keys with an @224 counterpart
        in mod_dict, generated by DEFAULTS_SR (8 MaskGIT steps of 784 tokens,
        cosine, CFG 2.0, growing conditioning). The conditions are copied
        where they lie: a chain's output on the card stays on the card.
        Returns the SR model's mod dict (the conditions and the @448
        targets), as tensors on its device."""
        if self.sampler_sr is None:
            raise AttributeError("super_resolve needs an SR model: FourMSampler(..., fm_sr=...)")
        sr_conds = [m for m in mod_dict if m.endswith("@224")]
        sr_targets = [m for m in DEFAULT_ORDER_SR if m.replace("@448", "@224") in mod_dict]
        sr_dict = {m: _full_input_copy(mod_dict[m], m) for m in sr_conds}
        B = next(iter(sr_dict.values()))["tensor"].shape[0]
        for mod in sr_targets:
            init_empty_target_modality(sr_dict, mod, B, MODALITY_INFO[mod].resolved_max_tokens())
        schedule = self.build_schedule(sr_conds, sr_targets, defaults=DEFAULTS_SR,
                                       cfg_grow_conditioning=True)
        return self.sampler_sr.generate(sr_dict, schedule, seed=seed,
                                        text_tokenizer=self.text_tokenizer)


def _full_input_copy(d: Dict[str, Any], mod: str) -> Dict[str, Any]:
    """A copy of an image conditioning entry (every @224 modality is one)
    marked as whole input, as init_full_input_modality marks it (fourm_tpu
    api.py:172-178 copies, then marks): its tensors copied where they lie (on
    the card for a chain's output), every position an input, none a
    target."""
    out = {k: v.clone() if isinstance(v, torch.Tensor) else np.array(v) for k, v in d.items()}
    t = out["tensor"]
    if mod.startswith("rgb"):  # NHWC pixels: one position per patch
        ps = MODALITY_INFO[mod].patch_size
        shape = (t.shape[0], (t.shape[1] // ps) * (t.shape[2] // ps))
    else:
        shape = tuple(t.shape[:2])
    dev = t.device if isinstance(t, torch.Tensor) else None
    out["input_mask"] = torch.zeros(shape, dtype=torch.bool, device=dev)
    out["target_mask"] = torch.ones(shape, dtype=torch.bool, device=dev)
    out.setdefault("decoder_attention_mask", torch.zeros(shape, dtype=torch.int32, device=dev))
    return out
