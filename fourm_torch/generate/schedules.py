"""Generation schedule builders (host-side numpy).

The port's own copy of fourm_tpu/generate/schedules.py.

Token/temperature schedules from reference fourm/utils/generation.py:49-110 and the
chained-generation schedule expander from reference fourm/models/generate.py:197-320.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np


def cosine_token_schedule(num_steps: int, total_tokens: int) -> np.ndarray:
    """Tokens decoded per MaskGIT step, cosine-spaced (utils/generation.py:49-58)."""
    iters = np.arange(num_steps)
    schedule = np.array([0.5 * (1 + math.cos(math.pi * i / num_steps)) for i in iters])
    tokens = [round(total_tokens * d) for d in (schedule[:-1] - schedule[1:])]
    tokens.append(total_tokens - sum(tokens))
    return np.array(tokens)


def linear_token_schedule(num_steps: int, total_tokens: int) -> np.ndarray:
    """Evenly-spaced token schedule, descending, zero-trimmed (utils/generation.py:61-66)."""
    schedule = np.linspace(0, total_tokens, num_steps + 1, dtype=int)
    tokens = np.sort(np.diff(schedule))[::-1]
    return np.trim_zeros(tokens, "b")


def continue_token_schedule(schedule: np.ndarray, num_current_tokens: int) -> np.ndarray:
    """Resume a token schedule after num_current_tokens are already decoded
    (utils/generation.py:69-75); used for super-resolution chaining."""
    cumsum = np.cumsum(schedule)
    keep = cumsum > num_current_tokens
    new = schedule[keep].copy()
    new[0] = cumsum[keep][0] - num_current_tokens
    return new


def linear_temp_schedule(temp: float, token_schedule: np.ndarray) -> np.ndarray:
    """Temperature decaying with decoded-token count (utils/generation.py:107-110)."""
    total = token_schedule.sum()
    decay = (temp * (total - token_schedule.cumsum()) / total)[:-1]
    return np.concatenate([np.array([temp * 1.0]), decay]).clip(min=1e-9)


def onex_temp_schedule(max_t: float, min_t: float, token_schedule: np.ndarray,
                       power: float = 0.5, min_linspace: float = 1,
                       max_linspace: float = 100) -> np.ndarray:
    """1/x^power temperature schedule (utils/generation.py:93-104)."""
    x = np.linspace(min_linspace, max_linspace, num=int(sum(token_schedule)))
    y = 1 / (x**power)
    y = y - min(y)
    y = y / max(y)
    cumsum = np.cumsum(token_schedule) / np.sum(token_schedule)
    unscaled = [(1 - cs) * us for us, cs in zip(y, cumsum)]
    return np.array([min_t + (max_t - min_t) * s for s in unscaled]).clip(min=1e-9)


def build_chained_generation_schedules(
    cond_domains: List[str],
    target_domains: List[str],
    tokens_per_target: List[int],
    autoregression_schemes: List[str],
    decoding_steps: List[int],
    token_decoding_schedules: List[str],
    temps: List[float],
    temp_schedules: List[str],
    cfg_scales: List[float],
    cfg_schedules: List[str],
    cfg_grow_conditioning: bool = False,
    modality_info: Optional[dict] = None,
) -> List[dict]:
    """Expand per-target settings into a flat list of per-step dicts
    {target_domain, scheme, num_tokens, temperature, cfg_scale, cfg_cond_domains}
    (reference generate.py:197-320)."""
    chained = []
    cond_domains = list(cond_domains)

    for idx, target_domain in enumerate(target_domains):
        scheme = autoregression_schemes[idx]
        ntoks = tokens_per_target[idx]
        temp = temps[idx]

        if scheme == "autoregressive":
            chained.append({
                "target_domain": target_domain,
                "scheme": scheme,
                "num_tokens": None,
                "temperature": temp,
                "cfg_scale": cfg_scales[idx],
                "cfg_cond_domains": cond_domains.copy(),
            })
            if cfg_grow_conditioning:
                cond_domains.append(target_domain)
            continue

        if modality_info is not None:
            mtype = modality_info[target_domain].type
            if mtype in ("seq", "seq_token"):
                raise ValueError(f"illegal scheme {scheme} for seq domain {target_domain}")

        num_steps = decoding_steps[idx]
        if scheme == "maskgit":
            name = token_decoding_schedules[idx]
            if name == "cosine":
                token_schedule = cosine_token_schedule(num_steps, ntoks)
            elif name == "linear":
                token_schedule = linear_token_schedule(num_steps, ntoks)
            else:
                raise ValueError(f"illegal MaskGIT token schedule {name}")
        elif scheme == "roar":
            token_schedule = linear_token_schedule(num_steps, ntoks)
        else:
            raise ValueError(f"illegal decoding scheme {scheme}")

        temp_name = temp_schedules[idx]
        if temp_name == "linear":
            temp_schedule = linear_temp_schedule(temp, token_schedule)
        elif temp_name == "constant":
            temp_schedule = temp * np.ones(len(token_schedule))
        elif "onex" in temp_name:
            min_t, power = [float(f) for f in temp_name.split(":")[1:]]
            temp_schedule = onex_temp_schedule(temp, min_t, token_schedule, power)
        else:
            raise ValueError(f"illegal temperature schedule {temp_name}")

        cfg_name = cfg_schedules[idx]
        cfg_scale = cfg_scales[idx]
        if cfg_name == "constant":
            if isinstance(cfg_scale, (list, tuple)):
                cfg_schedule = np.array(cfg_scale) * np.ones((len(token_schedule), 1))
            else:
                cfg_schedule = cfg_scale * np.ones(len(token_schedule))
        else:
            raise ValueError(f"illegal guidance schedule {cfg_name}")

        for tok, t, cfg in zip(token_schedule, temp_schedule, cfg_schedule):
            chained.append({
                "target_domain": target_domain,
                "scheme": scheme,
                "num_tokens": int(tok),
                "temperature": float(t),
                "cfg_scale": cfg.tolist() if isinstance(cfg, np.ndarray) else float(cfg),
                "cfg_cond_domains": cond_domains.copy(),
            })

        if cfg_grow_conditioning:
            cond_domains.append(target_domain)

    return chained
