"""GenerationSampler: chained generation over image-token targets, PyTorch port.

Counterpart of fourm_tpu/generate/sampler.py (reference
fourm/models/generate.py:323-1273), in its fixed-shape form:
  * MaskGIT / ROAR decode over the target's FULL token grid with
    key-restricted self-attention (FourM.forward_generation_img), so every
    step of a target runs at one shape;
  * classifier-free guidance runs cond and uncond in one batch-doubled
    forward;
  * the encoder stream is compacted to a host-computed bucket of valid
    tokens (`_encoder_budget`), with counts updated analytically per step.
The steps of one target run as one Python loop (the counterpart of the JAX
package's fused lax.scan). Randomness comes from one torch.Generator on the
model's device, seeded from `seed`; its draws are not those of jax.random, so
equality with the JAX package is tested where no draw matters (one step per
target, temperature 0). Sequence targets (autoregressive decoding) belong
to the next slice of the port and raise NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.modality_info import MODALITY_INFO
from ..ops.sampling import top_k_top_p_filtering_dynamic
from .init_helpers import S1_ID

IMG = "img"
SEQ = ("seq", "seq_token")


def _sample_traced_temp(gen: torch.Generator, logits: torch.Tensor, temperature: float):
    """Sample (..., V) logits at `temperature`; below 1e-9 it is argmax with
    probability 1 (reference sample_tokens, generate.py:361-370)."""
    logits = logits.float()
    if temperature < 1e-9:
        samples = logits.argmax(dim=-1)
        return samples, torch.ones(samples.shape, device=logits.device)
    probs = torch.softmax(logits / max(temperature, 1e-9), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    samples = torch.multinomial(flat, 1, generator=gen).reshape(probs.shape[:-1])
    return samples, probs.gather(-1, samples[..., None])[..., 0]


def _ranks_desc(scores: torch.Tensor) -> torch.Tensor:
    """ranks[i] = how many entries (index tie-break) precede i in descending
    score order."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    return torch.argsort(order, dim=-1)


def _empty_cond_tree(mod_dict, cond_mods: Sequence[str]):
    """Empty-modality transforms (generate.py:30-80) applied to the
    conditioning modalities: the CFG unconditional branch."""
    out = {m: dict(d) for m, d in mod_dict.items()}
    for mod in cond_mods:
        spec = MODALITY_INFO[mod]
        d = out[mod]
        if spec.type == IMG:
            d["input_mask"] = torch.ones_like(d["input_mask"])
        elif spec.type in SEQ:
            t = torch.zeros_like(d["tensor"])
            t[:, 0] = S1_ID
            t[:, 1] = S1_ID
            t[:, -1] = S1_ID + 1
            d["tensor"] = t
            im = torch.ones_like(d["input_mask"])
            im[:, 0] = False
            d["input_mask"] = im
        elif spec.type == "seq_emb":
            d["tensor"] = torch.zeros_like(d["tensor"])
            im = torch.ones_like(d["input_mask"])
            im[:, 0] = False
            d["input_mask"] = im
        else:
            raise ValueError(f"cannot empty modality type {spec.type}")
    return out


def _tree_concat(dicts):
    """Concatenate mod dicts along the batch axis."""
    return {mod: {k: torch.cat([d[mod][k] for d in dicts], 0) for k in dicts[0][mod]}
            for mod in dicts[0]}


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class GenerationSampler:
    """Chained generation with a FourM model (its parameters held by the model).

    Usage:
      sampler = GenerationSampler(model)
      out = sampler.generate(mod_dict, schedule, seed=0)
    """

    def __init__(self, model, top_k: float = 0.0, top_p: float = 0.0):
        self.model = model
        self.top_k = top_k
        self.top_p = top_p

    def _init_valid_counts(self, mod_dict) -> Dict[str, int]:
        """Per-modality max (over batch) count of valid encoder tokens, taken
        once at the start of `generate`; later steps update it analytically."""
        counts: Dict[str, int] = {}
        for mod in self.model.config.encoder_modalities:
            if mod in mod_dict:
                m = _np(mod_dict[mod]["input_mask"])
                counts[mod] = int((~m).sum(axis=1).max())
        return counts

    def _encoder_budget(self, counts: Dict[str, int], mod_dict) -> Optional[int]:
        """Encoder-token budget: the valid count rounded up to 256, or None
        when that would not be shorter than the whole stream."""
        total = sum(mod_dict[mod]["input_mask"].shape[1]
                    for mod in self.model.config.encoder_modalities if mod in mod_dict)
        if not counts or total == 0:
            return None
        need = max(sum(counts.values()), 1)
        bucket = min(-(-need // 256) * 256, total)
        return None if bucket >= total else bucket

    @staticmethod
    def _group_schedule(schedule: List[dict]) -> List[List[dict]]:
        """Group consecutive img steps of the same (target, scheme, CFG
        conditions); each group runs as one loop."""
        groups: List[List[dict]] = []
        for step_info in schedule:
            spec = MODALITY_INFO[step_info["target_domain"]]
            is_list = isinstance(step_info.get("cfg_scale", 1.0), (list, tuple))
            key = (step_info["target_domain"], step_info.get("scheme"),
                   tuple(step_info.get("cfg_cond_domains", ())))
            if (spec.type == IMG and not is_list and groups and groups[-1] and
                    groups[-1][0].get("_group_key") == key):
                groups[-1].append(step_info)
            elif spec.type == IMG and not is_list:
                groups.append([{**step_info, "_group_key": key}])
            else:
                groups.append([step_info])
        return groups

    def _img_step(self, md_step, target_mod: str, scheme: str, cond_mods, use_cfg: bool,
                  num_select: int, temperature: float, cfg_scale: float, top_k: float,
                  top_p: float, enc_budget: Optional[int], gen: torch.Generator):
        """One MaskGIT / ROAR step (the body of the JAX package's
        _img_target_fn scan). Returns the target's new (tensor, input_mask,
        target_mask)."""
        d_t = md_step[target_mod]
        tensor, input_mask, target_mask = d_t["tensor"], d_t["input_mask"], d_t["target_mask"]
        B = tensor.shape[0]
        still = ~target_mask
        if scheme == "roar":  # a random subset of the still-masked positions
            noise = torch.rand(still.shape, generator=gen, device=still.device)
            noise = noise.masked_fill(~still, float("-inf"))
            sa_valid = (_ranks_desc(noise) < num_select) & still
        else:  # maskgit: every still-masked position is a decoder token
            sa_valid = still
        if use_cfg:
            md = _tree_concat([md_step, _empty_cond_tree(md_step, cond_mods)])
            sa = torch.cat([sa_valid, sa_valid], 0)
        else:
            md, sa = md_step, sa_valid
        logits = self.model.forward_generation_img(md, target_mod, sa, enc_budget).float()
        if use_cfg:
            lc, lu = logits[:B], logits[B:]
            logits = lu + cfg_scale * (lc - lu)
        if top_k or top_p:
            logits = top_k_top_p_filtering_dynamic(logits, top_k, top_p)
        samples, probs = _sample_traced_temp(gen, logits, temperature)
        samples = samples.to(tensor.dtype)
        if scheme == "roar":
            accept = sa_valid
        else:
            conf = probs.masked_fill(~still, float("-inf"))
            accept = (_ranks_desc(conf) < num_select) & still
        return (torch.where(accept, samples, tensor), input_mask & ~accept,
                target_mask | accept)

    def _generate_img_target(self, mod_dict, group: List[dict], gen: torch.Generator,
                             top_k: float, top_p: float, counts: Dict[str, int]):
        """All steps of one image target."""
        first = group[0]
        target_mod = first["target_domain"]
        scheme = first["scheme"].lower()
        conds = tuple(first.get("cfg_cond_domains", ()))
        scales = [s.get("cfg_scale", 1.0) for s in group]
        # list-valued (multi-condition) guidance is not served here: like the
        # JAX package's single-step path, such a step runs without CFG
        use_cfg = (not any(isinstance(c, (list, tuple)) for c in scales)
                   and any(c != 1.0 for c in scales) and len(conds) > 0)
        num_selects = [int(s["num_tokens"]) for s in group]
        # the budget covers the LAST step, when all of this target's
        # accepted tokens are already encoder inputs
        end_counts = dict(counts)
        if target_mod in end_counts:
            cap = int(np.prod(mod_dict[target_mod]["input_mask"].shape[1:]))
            end_counts[target_mod] = min(end_counts[target_mod] + sum(num_selects), cap)
        enc_budget = self._encoder_budget(end_counts, mod_dict)

        d = dict(mod_dict[target_mod])
        for step, num_select in zip(group, num_selects):
            md_step = {**mod_dict, target_mod: d}
            tensor, input_mask, target_mask = self._img_step(
                md_step, target_mod, scheme, conds if use_cfg else (), use_cfg, num_select,
                float(step["temperature"]), float(step["cfg_scale"]) if use_cfg else 1.0,
                top_k, top_p, enc_budget, gen)
            d = {**d, "tensor": tensor, "input_mask": input_mask, "target_mask": target_mask}
        mod_dict[target_mod] = d
        if target_mod in counts:
            counts[target_mod] = end_counts[target_mod]
        return mod_dict

    def generate(self, mod_dict, schedule: List[dict], seed: Optional[int] = None,
                 top_k: Optional[float] = None, top_p: Optional[float] = None):
        """Run a chained generation schedule (reference generate.py:1028-1095).
        Returns the mod dict with every target filled in, as tensors on the
        model's device."""
        top_k = self.top_k if top_k is None else top_k
        top_p = self.top_p if top_p is None else top_p
        dev = self.model.device
        gen = torch.Generator(device=dev).manual_seed(0 if seed is None else int(seed))
        counts = self._init_valid_counts(mod_dict)
        mod_dict = {m: {k: torch.as_tensor(v).to(dev) for k, v in d.items()}
                    for m, d in mod_dict.items()}
        with torch.inference_mode():
            for group in self._group_schedule(schedule):
                target = group[0]["target_domain"]
                if MODALITY_INFO[target].type != IMG:
                    raise NotImplementedError(
                        f"sequence target {target!r}: autoregressive decoding is the next "
                        "slice of the port (ROADMAP.md, 'AR targets')")
                mod_dict = self._generate_img_target(mod_dict, group, gen, top_k, top_p,
                                                     counts)
        return mod_dict
