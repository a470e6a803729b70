"""Synthetic pre-training data in the layouts the 4M data pipeline reads,
from a seed: webdataset-style tar shards (one tar per modality group and
shard, merged by the `[a,b]` shard syntax) or an aligned folder tree. For
tests and smoke runs of `fourm_torch.cli.train_4m --data_config` without
the real (CC12M / COYO) shards.

Each sample carries `n_crops` crop settings (top, left, h, w, flip) inside
an RGB image larger than the crop, and per crop: the pre-computed tokens
(`tok_*`, one row per crop), a caption, a SAM instance set; then one T5
caption embedding (float16, width `t5_dim`), detections, metadata, human
poses and a colour palette in the JSON layouts of data/transforms.py. PNGs
are written by data/image_io.py:write_png with every row filter in turn,
no Pillow needed. Words come from `words` (those of the caller's
tokenizer).
"""

from __future__ import annotations

import io
import json
import os
import tarfile
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.image_io import write_png
from ..data.modality_info import MODALITY_INFO

# modality groups of the tar layout: group -> the transform keys it holds
GROUPS = ("rgb", "tok", "text", "t5")
DET_CLASSES = ("person", "car", "dog", "cat", "bicycle")
METADATA_KEYS = ("original_width", "original_height", "caption_n_words", "n_humans",
                 "colorfulness", "brightness", "watermark_score", "aesthetic_score")


def _group(key: str) -> str:
    if key in ("rgb", "crop_settings"):
        return "rgb"
    if key.startswith("tok_"):
        return "tok"
    if key == "t5_caption":
        return "t5"
    return "text"


def _caption(rng, words) -> str:
    return " ".join(rng.choice(words, rng.integers(3, 12)))


def _contour(rng, size: int) -> List:
    """A convex-ish polygon as a cv2 contour (N, 1, 2) of ints."""
    cx, cy = rng.integers(20, size - 20, 2)
    r = rng.integers(8, 60)
    n = int(rng.integers(3, 9))
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    pts = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], 1).round().astype(int)
    return [[[int(x), int(y)]] for x, y in np.clip(pts, 0, size - 1)]


def make_sample(domains: Sequence[str], rng: np.random.Generator, words: Sequence[str],
                n_crops: int = 2, image_size=(240, 320), t5_dim: int = 4096,
                t5_len: int = 24) -> Dict[str, object]:
    """One sample: {transform key: value} for the domains' transform keys
    (and crop_settings), values as the files hold them (an image array, an
    ndarray, JSON-able objects, an npz dict)."""
    keys = {d.split("@")[0] for d in domains}
    h = int(rng.integers(image_size[0], image_size[1] + 1))
    w = int(rng.integers(image_size[0], image_size[1] + 1))
    out: Dict[str, object] = {}
    crops = []
    for _ in range(n_crops):
        ch, cw = (int(v) for v in rng.integers(min(h, w) // 2, min(h, w) + 1, 2))
        crops.append([int(rng.integers(0, h - ch + 1)), int(rng.integers(0, w - cw + 1)), ch, cw,
                      int(rng.integers(0, 2))])
    out["crop_settings"] = np.asarray(crops, np.int64)
    if "rgb" in keys:
        base = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3))
        img = np.repeat(np.repeat(base, 8, 0), 8, 1)[:h, :w]
        out["rgb"] = np.clip(img + rng.integers(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)
    for d in domains:
        spec = MODALITY_INFO[d]
        key = d.split("@")[0]
        if key.startswith("tok_"):
            out[key] = rng.integers(0, spec.vocab_size, (n_crops, spec.resolved_max_tokens())
                                    ).astype(np.int32)
    if "caption" in keys:
        out["caption"] = [_caption(rng, words) for _ in range(n_crops)]
    if "t5_caption" in keys:
        n = int(rng.integers(4, t5_len + 1))
        out["t5_caption"] = {"emb": rng.standard_normal((1, t5_len, t5_dim)).astype(np.float16),
                             "mask_valid": (np.arange(t5_len) < n)[None]}
    if "det" in keys:
        inst = []
        for _ in range(int(rng.integers(0, 6))):
            x0, y0 = rng.uniform(0, 0.8, 2)
            x1, y1 = x0 + rng.uniform(0.05, 0.2), y0 + rng.uniform(0.05, 0.2)
            inst.append({"boxes": [float(x0), float(y0), float(x1), float(y1)],
                         "class_name": str(rng.choice(DET_CLASSES)),
                         "score": float(rng.uniform(0.3, 1.0))})
        out["det"] = {"instances": inst}
    if "metadata" in keys:
        md = {}
        for k in METADATA_KEYS:
            md[k] = (int(rng.integers(100, 1000)) if k.startswith(("original", "caption", "n_"))
                     else float(rng.uniform(0, 200)))
        out["metadata"] = md
    if "human_poses" in keys:
        n = int(rng.integers(0, 3))
        if n == 0:
            out["human_poses"] = {}
        else:
            boxes = []
            for _ in range(n):
                x0, y0 = rng.uniform(0, w * 0.7), rng.uniform(0, h * 0.7)
                boxes.append([float(x0), float(y0), float(x0 + rng.uniform(10, w * 0.3)),
                              float(y0 + rng.uniform(10, h * 0.3))])
            out["human_poses"] = {
                "bbox_xyxy": boxes,
                "pred_smpl_params": {
                    "global_orient": rng.uniform(-1, 1, (n, 3, 3)).tolist(),
                    "betas": rng.uniform(-3, 3, (n, 10)).tolist()},
                "pose_tokenized": rng.integers(0, 1024, (n, 8)).tolist(),
                "pred_cam": rng.uniform(-1, 19, (n, 3)).tolist()}
    if "color_palette" in keys:
        out["color_palette"] = [{str(k): rng.integers(0, 256, (k, 3)).tolist()
                                 for k in range(1, 8)}]
    if "sam_instance" in keys:
        per_crop = []
        for _ in range(n_crops):
            n = int(rng.integers(1, 5))
            per_crop.append({"points": [[_contour(rng, 224)] for _ in range(n)],
                             "token_ids": rng.integers(0, 1024, (n, 16)).tolist(),
                             "bbox": rng.integers(0, 224, (n, 4)).tolist()})
        out["sam_instance"] = per_crop
    return out


def _encode(key: str, value, fmt: str, filters) -> (str, bytes):
    """(extension, bytes) of one value in the tar (fmt "tar") or folder
    (fmt "folder") layout."""
    if key == "rgb":
        return "png", write_png(value, filters=filters, level=1)
    if isinstance(value, np.ndarray):
        buf = io.BytesIO()
        np.save(buf, value, allow_pickle=False)
        return "npy", buf.getvalue()
    if key == "t5_caption":
        buf = io.BytesIO()
        np.savez(buf, **value)
        return "npz", buf.getvalue()
    if key == "sam_instance" and fmt == "folder":  # the folder loader np.load()s it
        buf = io.BytesIO()
        arr = np.empty(len(value), dtype=object)
        for i, v in enumerate(value):
            arr[i] = {"points": [np.asarray(c, np.int32) for c in v["points"]],
                      "token_ids": v["token_ids"], "bbox": v["bbox"]}
        np.save(buf, arr, allow_pickle=True)
        return "npy", buf.getvalue()
    return "json", json.dumps(value).encode()


def _add(tf: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def write_shards(root: str, domains: Sequence[str], n_shards: int, samples_per_shard: int,
                 seed: int, words: Sequence[str], **sample_kw) -> str:
    """Tar shards root/{group}/shard-NNNN.tar, sample keys in order, and the
    shard pattern that reads them (root/[groups]/shard-{0000..NNNN}.tar)."""
    rng = np.random.default_rng(seed)
    keys = {d.split("@")[0] for d in domains} | {"crop_settings"}
    groups = [g for g in GROUPS if any(_group(k) == g for k in keys)]
    for g in groups:
        os.makedirs(os.path.join(root, g), exist_ok=True)
    n = 0
    for s in range(n_shards):
        tars = {g: tarfile.open(os.path.join(root, g, f"shard-{s:04d}.tar"), "w")
                for g in groups}
        try:
            for _ in range(samples_per_shard):
                sample = make_sample(domains, rng, words, **sample_kw)
                for key, value in sample.items():
                    ext, data = _encode(key, value, "tar", filters=(n % 5, 1, 2, 3, 4, 0))
                    _add(tars[_group(key)], f"{n:09d}.{key}.{ext}", data)
                n += 1
        finally:
            for tf in tars.values():
                tf.close()
    return os.path.join(root, f"[{','.join(groups)}]", f"shard-{{0000..{n_shards - 1:04d}}}.tar")


def write_folder(root: str, domains: Sequence[str], n_samples: int, seed: int,
                 words: Sequence[str], **sample_kw) -> str:
    """The same kind of samples as an aligned folder tree root/{key}/{class}/
    {id}.ext (MultiModalDatasetFolder); returns root."""
    rng = np.random.default_rng(seed)
    for i in range(n_samples):
        sample = make_sample(domains, rng, words, **sample_kw)
        for key, value in sample.items():
            ext, data = _encode(key, value, "folder", filters=(i % 5, 4, 3))
            folder = os.path.join(root, key, "c0")
            os.makedirs(folder, exist_ok=True)
            with open(os.path.join(folder, f"{i:06d}.{ext}"), "wb") as f:
                f.write(data)
    return root


def data_config(pattern: str, domains_in: Sequence[str], domains_out: Sequence[str],
                alphas_config: str, use_wds: bool = True, val_pattern: Optional[str] = None,
                shuffle_buffer: int = 100) -> Dict:
    """A data config (the layout of cfgs/default/4m/data/**) over these
    shards: one train dataset, and a val dataset when val_pattern is given."""
    ds = {"type": "multimodal", "in_domains": "-".join(domains_in),
          "out_domains": "-".join(domains_out), "input_alphas": None, "target_alphas": None,
          "alphas_config": alphas_config, "data_path": pattern, "use_wds": use_wds,
          "wds_shuffle_buffer_tar": shuffle_buffer, "main_augment_domain": "rgb@224",
          "aligned_captions": True, "tok_train_aug": True, "weight": 1.0}
    cfg = {"train": {"datasets": {"synthetic": ds}}}
    if val_pattern is not None:
        cfg["val"] = {"datasets": {"synthetic": {**ds, "data_path": val_pattern}}}
    return cfg
