"""Datasets for batch generation, PyTorch port (fourm_tpu/data/
generation_datasets.py; reference fourm/utils/generation_datasets/): Parti
prompts, image+caption folders, and an empty (unconditional) dataset.
ImageCaptionDataset reads PNG and JPEG images with the port's own decoders
(data/image_io.py), as Image.open(path).convert("RGB") gives them: a
(H, W, 3) uint8 array."""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

from . import image_io


class PartiPromptsDataset:
    """TSV of text prompts (PartiPrompts format: Prompt\tCategory...); reference
    generation_datasets/parti_prompts_dataset.py."""

    def __init__(self, tsv_path: str, text_transform: Optional[Callable] = None,
                 skip_header: bool = True):
        with open(tsv_path) as f:
            lines = [l for l in f.read().splitlines() if l.strip()]
        if skip_header and lines and lines[0].lower().startswith("prompt"):
            lines = lines[1:]
        self.prompts = [l.split("\t")[0] for l in lines]
        self.categories = [l.split("\t")[1] if "\t" in l else "" for l in lines]
        self.text_transform = text_transform

    def __len__(self):
        return len(self.prompts)

    def __getitem__(self, i) -> Tuple[str, str]:
        p = self.prompts[i]
        return (self.text_transform(p) if self.text_transform else p), self.categories[i]


class ImageCaptionDataset:
    """Paired image/caption folders (reference image_caption_dataset.py)."""

    IMG_EXTS = (".jpg", ".jpeg", ".png")

    def __init__(self, root: str, image_folder: str = "images",
                 caption_folder: str = "captions", image_transform: Optional[Callable] = None):
        img_dir = os.path.join(root, image_folder)
        cap_dir = os.path.join(root, caption_folder)
        self.items: List[Tuple[str, str]] = []
        for fname in sorted(os.listdir(img_dir)):
            stem, ext = os.path.splitext(fname)
            if ext.lower() not in self.IMG_EXTS:
                continue
            cap_path = os.path.join(cap_dir, stem + ".txt")
            if os.path.exists(cap_path):
                self.items.append((os.path.join(img_dir, fname), cap_path))
        self.image_transform = image_transform

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        img_path, cap_path = self.items[i]
        img = image_io.read_rgb(img_path)
        if self.image_transform:
            img = self.image_transform(img)
        with open(cap_path) as f:
            caption = f.read().strip()
        return img, caption


class EmptyDataset:
    """N empty samples for unconditional generation (reference empty_dataset.py)."""

    def __init__(self, dataset_size: int):
        self.dataset_size = dataset_size

    def __len__(self):
        return self.dataset_size

    def __getitem__(self, i):
        return {}
