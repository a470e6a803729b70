"""Pre-training data glue: parse alphas configs, build per-dataset loaders.

The port's own copy of fourm_tpu/data/pretrain_utils.py (reference fourm/
data/pretrain_utils.py:29-292). Alphas files are read by the port's YAML
subset reader (utils/config.py:load_yaml), not PyYAML. Each dataset gets
one pair of generators, `random.Random(seed)` and
`np.random.RandomState(seed)`, which its transforms, augmenter and (for a
folder) its repetition order draw from where the JAX package draws from
the global `random` and `np.random`; so a dataset's stream is reproducible
from its seed, in `spawn` workers too. Validation datasets may also be tar
shards (`use_wds`): one pass over the shards in order, without shuffling.
"""

from __future__ import annotations

import functools
import random
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils.config import load_yaml
from .augmenters import (CenterCropImageAugmenter, PreTokenizedImageAugmenter,
                         RandomCropImageAugmenter)
from .datasets import (MixtureDataset, ShardedTarDataset, batched_loader,
                       build_fm_pretraining_dataset, repeat_dataset)
from .masking import UnifiedMasking
from .modality_info import MODALITY_INFO
from .transforms import CaptionTransform, UnifiedDataTransform, default_modality_transforms


def setup_sampling_mod_info(dataset_config: Dict[str, Any], modality_info=None):
    """Parse per-modality Dirichlet alphas (scalar or mixture) and keep schemes
    from a dataset config (reference pretrain_utils.py:29-82).

    Returns (mods, input_alphas, target_alphas, keep_schemes, sampling_weights):
      mods: sorted list of modality names this dataset uses,
      alphas: {mod: [alpha_per_mixture]}."""
    modality_info = modality_info or MODALITY_INFO
    in_domains = sorted(dataset_config["in_domains"].split("-"))
    out_domains = sorted(dataset_config["out_domains"].split("-"))
    all_domains = sorted(set(in_domains) | set(out_domains))

    input_alphas = {mod: [0.0] for mod in all_domains}
    target_alphas = {mod: [0.0] for mod in all_domains}
    keep_schemes: Dict[str, Any] = {}
    sampling_weights = None

    if dataset_config.get("alphas_config") is None:
        if "input_alphas" in dataset_config:
            vals = str(dataset_config["input_alphas"]).split("-")
            vals = [float(vals[0])] * len(in_domains) if len(vals) == 1 else [float(v) for v in vals]
            for mod, a in zip(in_domains, vals):
                input_alphas[mod] = [a]
        if "target_alphas" in dataset_config:
            vals = str(dataset_config["target_alphas"]).split("-")
            vals = [float(vals[0])] * len(out_domains) if len(vals) == 1 else [float(v) for v in vals]
            for mod, a in zip(out_domains, vals):
                target_alphas[mod] = [a]
    else:
        alphas_config = load_yaml(dataset_config["alphas_config"])
        if "sampling_weights" in alphas_config:
            sampling_weights = alphas_config["sampling_weights"]
            alphas_config = alphas_config["alphas_mixture"]
        for mod in all_domains:
            input_alphas[mod] = alphas_config[mod]["input_alphas"]
            target_alphas[mod] = alphas_config[mod]["target_alphas"]
            if modality_info[mod].type in ("seq", "seq_emb", "seq_token"):
                keep_schemes[mod] = alphas_config[mod]["keep"]

    return all_domains, input_alphas, target_alphas, keep_schemes, sampling_weights


def make_unified_masking(
    all_domains: List[str],
    text_tokenizer,
    num_input_tokens: int,
    num_target_tokens: int,
    input_alphas=None,
    target_alphas=None,
    keep_schemes=None,
    sampling_weights=None,
    min_input_tokens: Optional[int] = None,
    min_target_tokens: Optional[int] = None,
    seed: Optional[int] = None,
) -> UnifiedMasking:
    mod_info = {m: MODALITY_INFO[m] for m in all_domains}
    return UnifiedMasking(
        modality_info=mod_info,
        text_tokenizer=text_tokenizer,
        input_tokens_range=(
            (min_input_tokens, num_input_tokens) if min_input_tokens is not None
            else num_input_tokens
        ),
        target_tokens_range=(
            (min_target_tokens, num_target_tokens) if min_target_tokens is not None
            else num_target_tokens
        ),
        input_alphas=input_alphas,
        target_alphas=target_alphas,
        keep_schemes=keep_schemes,
        sampling_weights=sampling_weights,
        seed=seed,
    )


def _transforms(dataset_config, rngs):
    transforms = default_modality_transforms(**rngs)
    transforms["caption"] = CaptionTransform(
        aligned_captions=dataset_config.get("aligned_captions", True), **rngs)
    return transforms


def get_train_dataset(
    dataset_config: Dict[str, Any],
    text_tokenizer,
    input_size: int,
    num_input_tokens: int,
    num_target_tokens: int,
    min_input_tokens: Optional[int] = None,
    min_target_tokens: Optional[int] = None,
    seed: Optional[int] = None,
    shard_split: Optional[Tuple[int, int]] = None,
):
    """Build one dataset's infinite sample iterator (reference get_train_dataloader,
    pretrain_utils.py:84-195): folder or sharded-tar, pre-tokenized or random-crop
    augmentation, unified transform + Dirichlet masking. shard_split (i, n):
    a sharded-tar dataset reads only shards i, i + n, ... (a reader of n
    across ranks and workers)."""
    all_domains, in_a, tgt_a, keep, weights = setup_sampling_mod_info(dataset_config)
    rngs = dict(rng=random.Random(seed), np_rng=np.random.RandomState(seed))
    transforms = _transforms(dataset_config, rngs)

    is_pretokenized = any(MODALITY_INFO[m].pretokenized for m in all_domains)
    load_domains = list(all_domains)
    if is_pretokenized:
        augmenter = PreTokenizedImageAugmenter(
            target_size=input_size,
            no_aug=not dataset_config.get("tok_train_aug", True),
            main_domain=dataset_config.get("main_augment_domain", "rgb"), **rngs,
        )
        # pre-tokenized datasets carry persisted crop settings alongside tokens
        # (reference unified_datasets.py:83-85 appends them automatically)
        load_domains.append("crop_settings")
    else:
        augmenter = RandomCropImageAugmenter(target_size=input_size, **rngs)

    masking = make_unified_masking(
        all_domains, text_tokenizer, num_input_tokens, num_target_tokens,
        input_alphas=in_a, target_alphas=tgt_a, keep_schemes=keep,
        sampling_weights=weights, min_input_tokens=min_input_tokens,
        min_target_tokens=min_target_tokens, seed=seed,
    )

    dtype = dataset_config.get("type", "multimodal")
    path = dataset_config["data_path"]
    if dtype == "multimodal" and dataset_config.get("use_wds", False):
        unified = UnifiedDataTransform(transforms, augmenter)

        def transform(sample):
            return masking(unified(sample))

        return ShardedTarDataset(
            path, load_domains, transforms, transform=transform,
            shuffle_buffer=dataset_config.get("wds_shuffle_buffer_tar", 1000),
            seed=seed, modality_name_map=dataset_config.get("modality_name_map"),
            n_repeats=dataset_config.get("wds_n_repeats", 1),
            shuffle_buffer_repeat=dataset_config.get("wds_shuffle_buffer_repeat", 1000),
            shard_split=shard_split,
        )
    if dtype == "multimodal":
        ds = build_fm_pretraining_dataset(
            path, load_domains, transforms, augmenter, masking,
            modality_paths=dataset_config.get("modality_paths"),
        )
        return repeat_dataset(ds, rngs["np_rng"])
    if dtype == "huggingface":
        from .datasets import build_huggingface_text_dataset

        return build_huggingface_text_dataset(path, masking)
    raise ValueError(f"unsupported dataset type {dtype}")


def get_val_dataset(
    dataset_config: Dict[str, Any],
    text_tokenizer,
    input_size: int,
    num_input_tokens: int,
    num_target_tokens: int,
    min_input_tokens: Optional[int] = None,
    min_target_tokens: Optional[int] = None,
    fixed_eval: bool = True,
    fixed_eval_input_tokens: int = 128,
    fixed_eval_target_tokens: int = 128,
    seed: Optional[int] = 0,
):
    """Build a FINITE validation dataset (reference get_val_dataloader,
    pretrain_utils.py:195-292): deterministic center-crop (or no-aug
    pre-tokenized) augmentation; with fixed_eval the token budgets are pinned,
    so that val loss is comparable across runs (reference
    run_training_4m.py:166-174). A folder, or (the port's addition) tar shards
    with `use_wds`, read once in order."""
    all_domains, in_a, tgt_a, keep, weights = setup_sampling_mod_info(dataset_config)
    rngs = dict(rng=random.Random(seed), np_rng=np.random.RandomState(seed))
    transforms = _transforms(dataset_config, rngs)

    is_pretokenized = any(MODALITY_INFO[m].pretokenized for m in all_domains)
    load_domains = list(all_domains)
    if is_pretokenized:
        augmenter = PreTokenizedImageAugmenter(
            target_size=input_size, no_aug=True,
            main_domain=dataset_config.get("main_augment_domain", "rgb"), **rngs,
        )
        load_domains.append("crop_settings")
    else:
        augmenter = CenterCropImageAugmenter(
            target_size=input_size,
            main_domain=dataset_config.get("main_augment_domain", "rgb"), **rngs,
        )

    if fixed_eval:
        ni, nt = fixed_eval_input_tokens, fixed_eval_target_tokens
        mi, mt = None, None
    else:
        ni, nt = num_input_tokens, num_target_tokens
        mi, mt = min_input_tokens, min_target_tokens
    masking = make_unified_masking(
        all_domains, text_tokenizer, ni, nt,
        input_alphas=in_a, target_alphas=tgt_a, keep_schemes=keep,
        sampling_weights=weights, min_input_tokens=mi, min_target_tokens=mt,
        seed=seed,
    )

    dtype = dataset_config.get("type", "multimodal")
    if dtype != "multimodal":
        raise ValueError(f"unsupported val dataset type {dtype}")
    if dataset_config.get("use_wds", False):
        unified = UnifiedDataTransform(transforms, augmenter)

        def transform(sample):
            return masking(unified(sample))

        return ShardedTarDataset(
            dataset_config["data_path"], load_domains, transforms, transform=transform,
            shuffle_buffer=0, resample=False, seed=seed,
            modality_name_map=dataset_config.get("modality_name_map"))
    return build_fm_pretraining_dataset(
        dataset_config["data_path"], load_domains, transforms, augmenter, masking,
        modality_paths=dataset_config.get("modality_paths"),
    )


def build_mixture_loader(
    datasets: List, weights: List[float], all_domains: List[str], batch_size: int,
    epoch_size: Optional[int] = None, seed: Optional[int] = None,
):
    """Mixture of datasets -> batched numpy mod dicts (reference
    build_mixture_dataloader, unified_datasets.py:549-557)."""
    modality_info = {m: MODALITY_INFO[m] for m in all_domains}
    mixture = MixtureDataset(datasets, weights, modality_info, seed=seed)
    return batched_loader(iter(mixture), batch_size, epoch_size)


# --------------------------------------------------- multiprocess train loader

def _mixture_worker_factory(spec: Dict[str, Any], worker_id: int, num_workers: int):
    """Picklable worker entry for MultiprocessLoader: rebuilds tokenizer +
    datasets inside the worker with a per-worker seed, seed + 1000 *
    worker_id (pretrain_utils.py:249; the reference's independent per-worker
    shard resampling, unified_datasets.py:371-373). On rank i of n (spec
    "shard", n > 1) the reader is worker i * num_workers + worker_id of n *
    num_workers: its seed follows that index, and it reads its own shards."""
    from ..utils.text_tokenizer import load_tokenizer

    text_tokenizer = (load_tokenizer(spec["text_tokenizer_path"])
                      if spec.get("text_tokenizer_path") else None)
    rank, ranks = spec.get("shard") or (0, 1)
    reader = rank * num_workers + worker_id
    seed = (spec.get("seed") or 0) + 1000 * reader
    split = (reader, ranks * num_workers) if ranks > 1 else None
    datasets, weights = [], []
    for name, dcfg in spec["train_datasets"].items():
        datasets.append(get_train_dataset(
            dcfg, text_tokenizer, spec["input_size"], spec["num_input_tokens"],
            spec["num_target_tokens"], spec.get("min_input_tokens"),
            spec.get("min_target_tokens"), seed=seed, shard_split=split,
        ))
        weights.append(dcfg.get("weight", 1.0))
    return build_mixture_loader(datasets, weights, spec["all_domains"],
                                spec["batch_size"], seed=seed)


def build_parallel_train_loader(
    train_datasets: Dict[str, Dict[str, Any]],
    all_domains: List[str],
    batch_size: int,
    input_size: int,
    num_input_tokens: int,
    num_target_tokens: int,
    min_input_tokens: Optional[int] = None,
    min_target_tokens: Optional[int] = None,
    text_tokenizer_path: Optional[str] = None,
    seed: Optional[int] = None,
    num_workers: int = 0,
    shard: Tuple[int, int] = (0, 1),
):
    """Mixture train loader across `num_workers` spawn processes (a torch
    DataLoader; 0 = inline, numpy batches): the host-side Dirichlet / span
    masking is the loader's cost. With workers, batches arrive as CPU
    tensors, pinned on a machine with a card. shard (index, count): this
    rank of the batch-sharded group; its readers take disjoint sets of the
    tar shards (_mixture_worker_factory)."""
    from .loader import MultiprocessLoader

    spec = dict(
        train_datasets=train_datasets, all_domains=list(all_domains),
        batch_size=batch_size, input_size=input_size,
        num_input_tokens=num_input_tokens, num_target_tokens=num_target_tokens,
        min_input_tokens=min_input_tokens, min_target_tokens=min_target_tokens,
        text_tokenizer_path=text_tokenizer_path, seed=seed, shard=tuple(shard),
    )
    if num_workers == 0:
        return _mixture_worker_factory(spec, 0, 1)
    return iter(MultiprocessLoader(
        functools.partial(_mixture_worker_factory, spec), num_workers=num_workers))
