"""Transfer-learning data utilities, PyTorch port (fourm_tpu/data/transfer.py;
reference fourm/data/transfer_utils.py:16, unified_datasets.py:93-131 and
dataset_utils.py:18-88): fine-tuning on a labelled image folder with a
fixed split of input and target modalities.

A transfer dataset is `build_fm_transfer_dataset` (the port's
MultiModalDatasetFolder over root/{modality}/{class}/{file}, JPEG and PNG
decoded by data/image_io.py) whose `transform` is the unified crop / flip
followed by `masking.TransferMasking`; `SubsampleDatasetWrapper` and
`RepeatedDatasetWrapper` take a subset of it or repeat it.
`folder_transfer_dataset` assembles one from a folder with the pre-training
transforms, and `build_transfer_loader` batches it in spawn worker
processes (data/loader.py).
"""

from __future__ import annotations

import random
from functools import partial
from typing import Dict, Optional, Sequence

import numpy as np

from ..utils.profiling import worker_seed
from .augmenters import PreTokenizedImageAugmenter, RandomCropImageAugmenter
from .batching import batch_mod_dicts
from .datasets import MultiModalDatasetFolder
from .loader import MultiprocessLoader
from .masking import TransferMasking
from .modality_info import MODALITY_INFO
from .transforms import (UnifiedDataTransform, default_modality_transforms,
                         get_transform_resolution)


class SubsampleDatasetWrapper:
    """A fixed subset of a map-style dataset: the first `dataset_size` of a
    np.random.RandomState(seed) permutation (reference dataset_utils.py:50)."""

    def __init__(self, dataset, dataset_size: Optional[int] = None, seed: int = 0,
                 return_orig_idx: bool = False):
        self.dataset = dataset
        self.return_orig_idx = return_orig_idx
        n = len(dataset)
        size = min(dataset_size or n, n)
        self.indices = np.random.RandomState(seed).permutation(n)[:size]

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        idx = int(self.indices[i])
        sample = self.dataset[idx]
        return (sample, idx) if self.return_orig_idx else sample


class RepeatedDatasetWrapper:
    """A map-style dataset repeated `num_repeats` times (reference
    dataset_utils.py:18)."""

    def __init__(self, dataset, num_repeats: int):
        self.dataset = dataset
        self.num_repeats = num_repeats

    def __len__(self):
        return len(self.dataset) * self.num_repeats

    def __getitem__(self, i):
        return self.dataset[i % len(self.dataset)]


def convert_samples_to_mod_dict(samples, input_mod: str, target_mod: str) -> Dict:
    """Plain (input, target) pairs as a transfer mod dict (reference
    transfer_utils.py:16)."""
    return {input_mod: samples[0], target_mod: samples[1]}


def build_fm_transfer_dataset(
    data_path: str,
    transform,
    modality_transforms: Dict,
    modalities: Sequence[str],
    modality_paths: Optional[Dict[str, str]] = None,
    max_samples: Optional[int] = None,
) -> MultiModalDatasetFolder:
    """A transfer dataset over data_path/{modality}/{class}/{file}: each
    sample loaded by its modality transform, then `transform` (the unified
    augmentation and TransferMasking) applied (reference
    unified_datasets.py:93-131, without its `modality_info`, which it never
    reads: the split lives in the masking)."""
    return MultiModalDatasetFolder(
        data_path, list(modalities), modality_transforms, transform=transform,
        modality_paths=modality_paths, max_samples=max_samples,
    )


def folder_transfer_dataset(data_path: str, input_modalities: Sequence[str],
                            target_modalities: Sequence[str], text_tokenizer=None,
                            seed: int = 0, num_repeats: int = 1):
    """A transfer dataset over data_path/{modality}/{class}/{file} with the
    pre-training transforms (transforms.default_modality_transforms) and
    TransferMasking, all drawing from generators seeded by `seed`. The crop
    size is the main (first rgb, else first) modality's resolution, as its
    name gives it (rgb@224 -> 224). With a pre-tokenized modality (tok_*) the
    crop is one of the persisted data_path/crop_settings/{class}/{file}.npy
    rows, as in pre-training (PreTokenizedImageAugmenter), else a random
    resized crop. `text_tokenizer` (a tokenizer or the path of its json;
    sequence modalities need it). Repeated num_repeats times
    (RepeatedDatasetWrapper)."""
    if isinstance(text_tokenizer, str):
        from ..utils.text_tokenizer import load_tokenizer

        text_tokenizer = load_tokenizer(text_tokenizer)
    rngs = dict(rng=random.Random(seed), np_rng=np.random.RandomState(seed))
    transforms = default_modality_transforms(**rngs)
    mods = list(input_modalities) + list(target_modalities)
    main = next((m for m in mods if m.startswith("rgb")), mods[0])
    image_size = get_transform_resolution(main, MODALITY_INFO[main].input_size)
    if any(m.startswith("tok_") for m in mods):
        augmenter = PreTokenizedImageAugmenter(image_size, main_domain=main, **rngs)
        mods.append("crop_settings")
    else:
        augmenter = RandomCropImageAugmenter(image_size, main_domain=main, **rngs)
    unified = UnifiedDataTransform(transforms, augmenter)
    info = {m: MODALITY_INFO[m] for m in list(input_modalities) + list(target_modalities)}
    masking = TransferMasking(info, text_tokenizer, input_modalities, target_modalities, seed=seed)
    dataset = build_fm_transfer_dataset(data_path, lambda s: masking(unified(s)), transforms,
                                        mods)
    return RepeatedDatasetWrapper(dataset, num_repeats)


def transfer_batches(worker_id: int, num_workers: int, *, batch_size: int, seed: int = 0,
                     **dataset_kw):
    """Worker `worker_id`'s batches of one pass over a folder_transfer_dataset
    (built in the worker, its generators seeded by profiling.worker_seed):
    batches worker_id, worker_id + num_workers, ... of a
    np.random.RandomState(seed) permutation of the samples; an incomplete
    last batch is dropped."""
    ds = folder_transfer_dataset(seed=worker_seed(seed, worker_id), **dataset_kw)
    order = np.random.RandomState(seed).permutation(len(ds))
    for b in range(worker_id, len(ds) // batch_size, num_workers):
        yield batch_mod_dicts([ds[int(i)] for i in order[b * batch_size:(b + 1) * batch_size]])


def build_transfer_loader(data_path: str, input_modalities: Sequence[str],
                          target_modalities: Sequence[str], batch_size: int,
                          num_workers: int = 4, seed: int = 0, **dataset_kw) -> MultiprocessLoader:
    """One pass of batched transfer samples from `num_workers` spawn workers
    taken in turn (in this process with 0), numeric arrays as CPU tensors
    (pinned where there is a card). dataset_kw: folder_transfer_dataset's
    (text_tokenizer as a path, so that workers can load it)."""
    return MultiprocessLoader(partial(
        transfer_batches, batch_size=batch_size, seed=seed, data_path=data_path,
        input_modalities=list(input_modalities), target_modalities=list(target_modalities),
        **dataset_kw), num_workers)
