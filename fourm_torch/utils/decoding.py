"""Token decoding and visualization of generated mod dicts (decode_dict),
PyTorch port.

Counterpart of fourm_tpu/utils/decoding.py (reference
fourm/utils/plotting_utils.py:47-673): maps a generated mod dict back to
images, text and structured outputs through the tokenizers' decoders.
Tokenizers are given as {transform key: TokenizerBundle}; a bundle holds a
VQVAE or DiVAE of the port on its device, and diffusion decoding runs its
eager loop there. Outputs are numpy arrays on the host, as the JAX
package's.

Everything runs without PIL, cv2 or matplotlib (the machine with the card
has none of them): the depth and semseg colormaps are the port's own
tables (utils/colormaps.py), the SAM masks' bicubic resize is torch's, and
boxes and human poses are drawn by utils/drawing.py (cv2's lines, circles
and rectangles and Pillow's rectangle outline pixel for pixel; box labels
in a built-in pixel font, not Pillow's default font).

Randomness: one torch.Generator per device, seeded from `seed`, drawn by
the diffusion decoders in mod_dict order (the JAX package splits one key
per such target in the same order; the draws differ).
"""

from __future__ import annotations

import dataclasses
from itertools import groupby
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.modality_info import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
from ..data.transforms import (ID_METADATA_MAP, IMAGE_DIM_BIN_SIZE, IMAGE_DIM_MODALITIES,
                               METADATA_ID_MAP, MIN_MAX_BINS, get_transform_key,
                               get_transform_resolution)
from . import drawing
from .colormaps import colormap
from .text_tokenizer import get_sentinel_to_id_mapping, merge_span_masking


def to_numpy(x) -> np.ndarray:
    """A tensor (any device, any dtype: floats as fp32) or array as numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class TokenizerBundle:
    """A VQ tokenizer of the port (VQVAE or DiVAE), on its device, used for
    decoding."""

    model: Any

    @property
    def is_diffusion(self) -> bool:
        from ..vq.vqvae import DiVAE

        return isinstance(self.model, DiVAE)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def decode_tokens(self, tokens, timesteps: Optional[int] = None,
                      image_size: Optional[int] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Tokens (array or tensor) -> the decoder's output on the model's
        device (a diffusion decoder's sampled images, fp32). A VQControlNet
        raises: the JAX bundle has no ControlNet route
        (fourm_tpu/utils/decoding.py:36-48 falls through to a decode_tokens
        that VQ lacks); decode its tokens with vq.controlnet_decode_tokens."""
        from ..vq.vqvae import VQControlNet

        if isinstance(self.model, VQControlNet):
            raise NotImplementedError(
                "TokenizerBundle.decode_tokens: a VQControlNet has no route in decode_dict "
                "(nor in the JAX package's); call fourm_torch.vq.controlnet_decode_tokens")
        tokens = torch.as_tensor(to_numpy(tokens)).long().to(self.device)
        with torch.inference_mode():
            if self.is_diffusion:
                from ..vq.vqvae import divae_decode_tokens

                return divae_decode_tokens(self.model, tokens, generator, timesteps=timesteps,
                                           image_size=image_size)
            return self.model.decode_tokens(tokens)


def denormalize(img: np.ndarray, mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD):
    """Invert channel-last normalization (reference utils/misc denormalize)."""
    return np.asarray(img) * np.asarray(std) + np.asarray(mean)


def np_squeeze(array: np.ndarray, axis: int = 0):
    return array.squeeze(axis) if array.shape[axis] == 1 else array


def pca_visualize(features: np.ndarray, n_components: int = 3) -> np.ndarray:
    """Project a (H, W, C) feature map to RGB via PCA (reference :65-78)."""
    H, W, C = features.shape
    flat = np.asarray(features, dtype=np.float64).reshape(-1, C)
    flat = flat - flat.mean(0)
    _u, _s, vt = np.linalg.svd(flat, full_matrices=False)
    proj = flat @ vt[:n_components].T
    proj = (proj - proj.min(0)) / (proj.max(0) - proj.min(0) + 1e-8)
    return proj.reshape(H, W, n_components)


def _grid(tokens, image_size: int, patch_size: int) -> np.ndarray:
    n = image_size // patch_size
    t = to_numpy(tokens)
    if t.ndim == 1:
        t = t[None]
    return t.reshape(t.shape[0], n, n)


def _strip(s: str) -> str:
    return s.replace("[EOS]", "").replace("[PAD]", "").strip()


# ------------------------------------------------------------- text decoders

def decode_text(mod_dict, key: str, text_tokenizer) -> Tuple:
    """Decode input/target/merged text of a sequence modality (reference
    :473-510)."""
    sentinel_ids = set(get_sentinel_to_id_mapping(text_tokenizer).values())
    tensor = to_numpy(mod_dict[key]["tensor"])
    input_mask = to_numpy(mod_dict[key]["input_mask"])
    target_mask = to_numpy(mod_dict[key]["target_mask"])
    inputs, targets, merged = [], [], []
    for i in range(tensor.shape[0]):
        in_seq = tensor[i][~input_mask[i]].tolist()
        tgt_seq = tensor[i][~target_mask[i]].tolist()
        merged_seq = merge_span_masking(in_seq, tgt_seq, sentinel_ids)
        inputs.append(text_tokenizer.decode(in_seq, skip_special_tokens=False))
        targets.append(text_tokenizer.decode(tgt_seq, skip_special_tokens=False))
        merged.append(text_tokenizer.decode(merged_seq, skip_special_tokens=False))
    if len(inputs) == 1:
        return inputs[0], targets[0], merged[0]
    return inputs, targets, merged


def _merged_list(mod_dict, key: str, text_tokenizer) -> List[str]:
    merged = decode_text(mod_dict, key, text_tokenizer)[2]
    return merged if isinstance(merged, list) else [merged]


def decode_metadata(mod_dict, text_tokenizer, key: str = "metadata"):
    """Parse generated 'v1=.. v0=..' metadata strings back to a dict
    (reference :419-471)."""
    all_decoded = [d.replace(" [EOS]", "").replace(" [PAD]", "")
                   for d in _merged_list(mod_dict, key, text_tokenizer)]
    out = []
    for d in all_decoded:
        parts, cur = [], []
        for p in d.split():
            if "v1" in p and cur:
                parts.append(cur)
                cur = []
            cur.append(p)
        if cur:
            parts.append(cur)
        md = {}
        for part in parts:
            if len(part) != 2:
                continue
            mid, mval = part
            if not (mid.startswith("v1=") and mval.startswith("v0=")) or mid not in ID_METADATA_MAP:
                continue
            mtype = ID_METADATA_MAP[mid]
            value = int(mval.split("=")[1])
            if mtype in IMAGE_DIM_MODALITIES:
                value *= IMAGE_DIM_BIN_SIZE
            elif mtype in MIN_MAX_BINS:
                vmin, vmax, bins = MIN_MAX_BINS[mtype]
                value = (vmax - vmin) * (value / bins) + vmin
            md[mtype] = value
        out.append({k: md[k] for k in METADATA_ID_MAP if k in md})
    return out[0] if len(out) == 1 else out


def convert_string_to_bboxes(bboxes_str: str, bins: int = 1000) -> List[Tuple]:
    """Parse 'v0=.. v1=.. v2=.. v3=.. class' strings (reference :863-888)."""
    bboxes: List = []
    for tok in bboxes_str.split():
        if tok.startswith("v0="):
            bboxes.append([min(int(tok[3:]), bins - 1) / (bins - 1)])
        elif tok.startswith("v1=") and bboxes and len(bboxes[-1]) == 1:
            bboxes[-1].append(min(int(tok[3:]), bins - 1) / (bins - 1))
        elif tok.startswith("v2=") and bboxes and len(bboxes[-1]) == 2:
            bboxes[-1].append(min(int(tok[3:]), bins - 1) / (bins - 1))
        elif tok.startswith("v3=") and bboxes and len(bboxes[-1]) == 3:
            bboxes[-1].append(min(int(tok[3:]), bins - 1) / (bins - 1))
        elif bboxes and len(bboxes[-1]) == 4:
            bboxes[-1].append(tok)
        elif bboxes and len(bboxes[-1]) >= 5 and not tok.startswith("v"):
            bboxes[-1][4] = f"{bboxes[-1][4]} {tok}"
    return [tuple(b) for b in bboxes if len(b) >= 5]


def visualize_bboxes(img: np.ndarray, bboxes_str: str, color=(255, 99, 71), thickness: int = 2):
    """Draw parsed bboxes on an RGB [0,1] image (reference :1042-1086):
    Pillow's rectangle outline exactly; the class label in the built-in
    pixel font of utils/drawing.py (the JAX package writes it in Pillow's
    default font)."""
    H, W = img.shape[:2]
    out = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    for bbox in convert_string_to_bboxes(bboxes_str):
        x0, y0, x1, y1, cls = bbox[:5]
        drawing.pil_rectangle(out, (x0 * W, y0 * H, x1 * W, y1 * H), color, thickness)
        drawing.draw_text(out, (x0 * W + 2, y0 * H + 2), str(cls), color)
    return out.astype(np.float32) / 255.0


def visualize_palette(palette_str: str, size: int = 224) -> np.ndarray:
    """Render 'v1=<n> v0=.. ...' palette strings as color strips."""
    values = [int(t[3:]) for t in palette_str.split() if t.startswith("v0=")]
    n = len(values) // 3
    if n == 0:
        return np.ones((size, size, 3), dtype=np.float32)
    img = np.zeros((size, size, 3), dtype=np.float32)
    w = size // n
    for i in range(n):
        rgb = np.asarray(values[3 * i: 3 * i + 3], dtype=np.float32) / 255.0
        img[:, i * w: (i + 1) * w if i < n - 1 else size] = rgb
    return img


# --------------------------------------------------------------- img decoders

def decode_dict(mod_dict: Dict, tokenizers: Dict[str, TokenizerBundle], text_tokenizer,
                image_size: int = 224, patch_size: int = 16, decoding_steps: int = 25,
                to_rgb: bool = True, seed: Optional[int] = None) -> Dict[str, Any]:
    """Decode a generated mod dict into images / text / structured outputs
    (reference plotting_utils.py:673-838)."""
    generators: Dict[str, torch.Generator] = {}

    def generator(device: torch.device) -> torch.Generator:
        key = str(device)
        if key not in generators:
            generators[key] = torch.Generator(device=device).manual_seed(
                seed if seed is not None else 0)
        return generators[key]

    dec: Dict[str, Any] = {}
    for key in mod_dict:
        k = get_transform_key(key)
        res = get_transform_resolution(key, image_size, to_tuple=False)
        d = mod_dict[key]

        if k == "rgb":
            dec[key] = np_squeeze(np.clip(denormalize(to_numpy(d["tensor"])), 0, 1))
        elif k in ("tok_rgb", "tok_normal", "tok_canny_edge", "tok_sam_edge", "tok_depth"):
            if k not in tokenizers:
                continue
            tok = tokenizers[k]
            t = (max(decoding_steps // 2, 1) if k in ("tok_canny_edge", "tok_sam_edge")
                 else decoding_steps)
            rec = to_numpy(tok.decode_tokens(_grid(d["tensor"], res, patch_size), timesteps=t,
                                             image_size=res, generator=generator(tok.device)))
            if k != "tok_depth":
                dec[key] = np_squeeze(np.clip(rec * 0.5 + 0.5, 0, 1))  # [-1,1] -> [0,1]
            elif not to_rgb:
                dec[key] = np_squeeze(rec[..., 0])
            else:
                imgs = [colormap((img - img.min()) / (img.max() - img.min() + 1e-8))
                        for img in rec[..., 0]]
                dec[key] = np_squeeze(np.stack(imgs))
        elif k == "tok_semseg":
            if k not in tokenizers:
                continue
            logits = tokenizers[k].decode_tokens(_grid(d["tensor"], res, patch_size))
            if not to_rgb:
                dec[key] = np_squeeze(to_numpy(logits))
            else:  # the class map, not the (B, H, W, classes) logits, comes to the host
                semseg = to_numpy(logits.argmax(-1))
                imgs = [colormap(s / max(s.max(), 1), "viridis") for s in semseg]
                dec[key] = np_squeeze(np.stack(imgs))
        elif k in ("tok_clip", "tok_dinov2", "tok_imagebind"):
            if k not in tokenizers:
                continue
            ps = 14 if k in ("tok_dinov2", "tok_imagebind") else patch_size
            feats = to_numpy(tokenizers[k].decode_tokens(_grid(d["tensor"], res, ps)))
            dec[key] = np_squeeze(np.stack([pca_visualize(f) for f in feats]))
        elif k in ("tok_dinov2_global", "tok_imagebind_global"):
            if k not in tokenizers:
                continue
            toks = to_numpy(d["tensor"])
            toks = toks.reshape(toks.shape[0], 4, 4)
            dec[key] = np_squeeze(to_numpy(tokenizers[k].decode_tokens(toks)))
        elif k in ("caption", "det") or (k == "sam_instance" and k not in tokenizers):
            merged = decode_text(mod_dict, key, text_tokenizer)[2]
            dec[key] = [_strip(s) for s in merged] if isinstance(merged, list) else _strip(merged)
        elif k == "sam_instance":
            dec[key] = decode_sam_instances(mod_dict, tokenizers, text_tokenizer, key=key,
                                            image_size=res)
        elif k == "human_poses":
            texts = [_strip(s) for s in _merged_list(mod_dict, key, text_tokenizer)]
            if k in tokenizers:
                background = dec.get("rgb@224")
                imgs = [visualize_human_poses(t, tokenizers[k], background, image_size=res)
                        for t in texts]
                dec[key] = np_squeeze(np.stack(imgs))
            else:
                dec[key] = texts if len(texts) > 1 else texts[0]
        elif k == "metadata":
            dec[key] = decode_metadata(mod_dict, text_tokenizer, key)
        elif k == "color_palette":
            merged = _merged_list(mod_dict, key, text_tokenizer)
            imgs = [visualize_palette(m.replace(" [EOS]", "")) for m in merged]
            dec[key] = np_squeeze(np.stack(imgs))
    return dec


# ------------------------------------------------------------- SAM instances

def _group_by_identifier(items, identifier):
    """[a,b,c,a,d,d] with identifier a -> [[b,c],[d,d]] (reference
    plotting_utils.py:534-539)."""
    return [list(g) for key, g in groupby(items, lambda x: x == identifier) if not key]


def _map_location(inp: str, tokens: bool = False):
    """'v0=123' -> 123; with tokens=True, 'v1=x' -> x+512 (reference :541-558)."""
    if "=" not in inp:
        return None
    axis, position = inp.split("=")
    try:
        position = int(position)
    except ValueError:
        return None
    if tokens:
        return position if axis == "v0" else position + 512
    return position


def _bbox_iou(box1, box2) -> float:
    x1, y1 = max(box1[0], box2[0]), max(box1[1], box2[1])
    x2, y2 = min(box1[2], box2[2]), min(box1[3], box2[3])
    inter = max(0, x2 - x1) * max(0, y2 - y1)
    a1 = (box1[2] - box1[0]) * (box1[3] - box1[1])
    a2 = (box2[2] - box2[0]) * (box2[3] - box2[1])
    return inter / max(a1 + a2 - inter, 1e-9)


def resize_bicubic(mask: np.ndarray, width: int, height: int) -> np.ndarray:
    """A (H, W) float64 map resized to (height, width) by torch's bicubic
    interpolation (a = -0.75, half-pixel centres, replicated border, no
    antialiasing): cv2.resize(..., INTER_CUBIC)'s kernel and sampling."""
    t = torch.from_numpy(np.ascontiguousarray(mask, dtype=np.float64))[None, None]
    return F.interpolate(t, size=(height, width), mode="bicubic", align_corners=False)[0, 0].numpy()


def decode_sam_instances(mod_dict, tokenizers: Dict[str, TokenizerBundle], text_tokenizer,
                         key: str = "sam_instance", image_size: int = 224,
                         token_len: int = 16) -> np.ndarray:
    """Decode SAM-instance token strings to a colored per-instance mask image
    (reference plotting_utils.py:512-672): parse point/polygon groups, decode
    each 16-token polygon through the SAM-instance tokenizer (sigmoid mask),
    dedupe near-identical instances (Dice > 0.8 and bbox IoU > 0.9), paint by
    descending area with a deterministic palette."""
    all_decoded = [d.replace(" [EOS]", "").replace("[EOS]", "")
                   for d in _merged_list(mod_dict, key, text_tokenizer)]
    rng = np.random.default_rng(seed=0)
    sam_palette = [rng.integers(0, 255, size=3) for _ in range(1000)]

    outputs = []
    for dec_str in all_decoded:
        tokens_per_sample, bboxes_per_sample, areas = [], [], []
        for part in _group_by_identifier(dec_str.split(), identifier="point"):
            if len(part[2:]) <= 1:  # 'none' cases
                continue
            for positions in _group_by_identifier(part, identifier="polygon"):
                if len(positions) != token_len + 4:
                    continue
                bbox, toks = positions[:4], positions[4:]
                min_w, min_h, max_w, max_h = map(_map_location, bbox)
                if None in (min_w, max_w, min_h, max_h) or min_w >= max_w or min_h >= max_h:
                    continue
                toks = [_map_location(t, tokens=True) for t in toks]
                if None in toks:
                    continue
                tokens_per_sample.append(np.array(toks))
                bboxes_per_sample.append(np.array([min_h, min_w, max_h, max_w]))
                areas.append((max_w - min_w) * (max_h - min_h))

        final = np.zeros((image_size, image_size, 3), dtype=np.uint8)
        if not areas:
            outputs.append(final)
            continue
        order = np.argsort(-np.asarray(areas))
        tokens_arr = np.stack(tokens_per_sample)[order].reshape(-1, 4, 4)
        bboxes_arr = np.stack(bboxes_per_sample)[order]
        masks = to_numpy(tokenizers[key].decode_tokens(tokens_arr)).astype(np.float64)
        masks = 1.0 / (1.0 + np.exp(-masks))  # sigmoid
        masks = masks.reshape(masks.shape[0], masks.shape[1], masks.shape[2])

        rep_masks, rep_boxes = [], []
        for mask, bbox in zip(masks, bboxes_arr):
            if (mask.max() - mask.min()) < 0.9:
                continue
            for rms, rbs in zip(rep_masks, rep_boxes):
                rm, rb = rms[0], rbs[0]
                dice = 2 * ((rm * mask).sum() + 0.01) / (rm.sum() + mask.sum() + 0.01)
                if dice > 0.8 and _bbox_iou(rb, bbox) > 0.9:
                    rms.append(mask)
                    rbs.append(bbox)
                    break
            else:
                rep_masks.append([mask])
                rep_boxes.append([bbox])

        for i, (rms, rbs) in enumerate(zip(rep_masks, rep_boxes)):
            mask = np.mean(rms, axis=0)
            min_h, min_w, max_h, max_w = np.mean(rbs, axis=0).astype(np.int32).tolist()
            mask = resize_bicubic(mask, max(max_w - min_w, 1), max(max_h - min_h, 1))
            max_w, max_h = min(max_w, image_size), min(max_h, image_size)
            m = mask[: max_h - min_h, : max_w - min_w] > 0.5
            final[min_h:max_h, min_w:max_w, :][m] = sam_palette[i]
        outputs.append(final)
    return outputs[0] if len(outputs) == 1 else np.stack(outputs)


# ------------------------------------------------------------- human poses

# SMPL kinematic tree (public model topology: parent index per joint)
SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                16, 17, 18, 19, 20, 21)
# Approximate SMPL neutral rest-pose joint locations (meters), the JAX
# package's stand-in for the licensed SMPL mesh data the reference vendors
# via HMR2 (plotting_utils.py:913-932): enough to drive a skeleton render.
SMPL_REST_JOINTS = np.array([
    [0.00, 0.00, 0.00], [0.06, -0.09, 0.00], [-0.06, -0.09, 0.00],
    [0.00, 0.10, 0.00], [0.10, -0.49, 0.00], [-0.10, -0.49, 0.00],
    [0.00, 0.23, 0.00], [0.09, -0.90, 0.00], [-0.09, -0.90, 0.00],
    [0.00, 0.29, 0.00], [0.11, -0.97, 0.12], [-0.11, -0.97, 0.12],
    [0.00, 0.47, 0.00], [0.04, 0.42, 0.00], [-0.04, 0.42, 0.00],
    [0.00, 0.58, 0.00], [0.17, 0.44, 0.00], [-0.17, 0.44, 0.00],
    [0.43, 0.42, 0.00], [-0.43, 0.42, 0.00], [0.68, 0.42, 0.00],
    [-0.68, 0.42, 0.00], [0.76, 0.42, 0.00], [-0.76, 0.42, 0.00],
])


def parse_human_pose_instances(pose_str: str) -> list:
    """Parse the 39-token-per-instance pose string into structured params
    (reference visualize_human_poses parsing, plotting_utils.py:934-1000):
    bbox_xyxy (224px space), pred_cam (3,), betas (10,), global_orient (3,3),
    pose_token_ids (8,) for the pose tokenizer."""
    words = pose_str.split()
    instances = []
    for inst in range(len(words) // 39):
        w = words[inst * 39: (inst + 1) * 39]
        try:
            out = {}
            out["bbox_xyxy"] = np.array([int(w[i][3:]) / 999 * 224 for i in (1, 2, 3, 4)])
            ci = w.index("camera")
            out["pred_cam"] = np.array(
                [(int(w[ci + j][3:]) - 49.95) / 49.95 for j in (1, 2, 3)])
            si = w.index("shape")
            out["betas"] = np.array(
                [(int(w[si + j][3:]) - 499.5) / 166.5 for j in range(1, 11)])
            gi = w.index("global")
            out["global_orient"] = np.array(
                [(int(w[gi + j][3:]) - 499.5) / 499.5 for j in range(1, 10)]
            ).reshape(3, 3)
            pi = w.index("pose")
            out["pose_token_ids"] = np.array([
                int(w[pi + 1 + j][3:]) + (512 if w[pi + 1 + j].startswith("v1") else 0)
                for j in range(8)
            ])
            instances.append(out)
        except (ValueError, IndexError):
            continue
    return instances


def _smpl_forward_kinematics(global_orient: np.ndarray,
                             body_rotmats: np.ndarray) -> np.ndarray:
    """Joint positions from per-joint rotations over the approximate rest
    skeleton (pose2rot=False semantics). body_rotmats: (23, 3, 3)."""
    def orthonormalize(R):
        u, _, vt = np.linalg.svd(R)
        return u @ vt

    rots = [orthonormalize(global_orient)]
    pos = [SMPL_REST_JOINTS[0]]
    for i in range(1, len(SMPL_PARENTS)):
        p = SMPL_PARENTS[i]
        local = orthonormalize(body_rotmats[i - 1]) if i - 1 < len(body_rotmats) else np.eye(3)
        rots.append(rots[p] @ local)
        pos.append(pos[p] + rots[p] @ (SMPL_REST_JOINTS[i] - SMPL_REST_JOINTS[p]))
    return np.stack(pos)


def _cam_crop_to_full(pred_cam, box_center, box_size, img_size, focal_length):
    """HMR2 weak-perspective crop-cam -> full-image translation (reference
    hmr2 renderer cam_crop_to_full)."""
    s, tx, ty = pred_cam
    w, h = img_size
    bs = box_size * s + 1e-9
    tz = 2 * focal_length / bs
    tx_full = 2 * (box_center[0] - w / 2) / bs + tx
    ty_full = 2 * (box_center[1] - h / 2) / bs + ty
    return np.array([tx_full, ty_full, tz])


def visualize_human_poses(pose_str: str, pose_tokenizer: TokenizerBundle,
                          background: Optional[np.ndarray] = None,
                          image_size: int = 224) -> np.ndarray:
    """Render decoded human poses as 2D skeletons over the (optional) RGB
    background, as the JAX package does (a dependency-free stand-in for the
    reference's SMPL-mesh render, plotting_utils.py:934-1040): the 8 pose
    tokens decoded to 23 body rotation matrices by the pose tokenizer,
    forward kinematics over an approximate rest skeleton, projection with
    the predicted crop camera, bones drawn as cv2 draws them
    (utils/drawing.py)."""
    img = (np.ascontiguousarray((background * 255).astype(np.uint8))
           if background is not None and np.ndim(background) == 3
           else np.zeros((image_size, image_size, 3), np.uint8))
    focal = 5000.0 / 256.0 * image_size

    for inst in parse_human_pose_instances(pose_str):
        try:
            toks = inst["pose_token_ids"].reshape(1, 8, 1)
            dec = to_numpy(pose_tokenizer.decode_tokens(toks)).reshape(-1)
            if dec.size < 23 * 9:
                continue
            body_rotmats = dec[: 23 * 9].reshape(23, 3, 3)
            joints = _smpl_forward_kinematics(inst["global_orient"], body_rotmats)
            joints = joints * np.array([1.0, -1.0, 1.0])  # y-up -> image y-down
            bbox = inst["bbox_xyxy"] / 224.0 * image_size
            center = np.array([(bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2])
            size = max((bbox[2] - bbox[0]), (bbox[3] - bbox[1]))
            t = _cam_crop_to_full(inst["pred_cam"], center, size, (image_size, image_size),
                                  focal)
            pts = joints + t
            xy = np.stack([
                focal * pts[:, 0] / np.maximum(pts[:, 2], 1e-6) + image_size / 2,
                focal * pts[:, 1] / np.maximum(pts[:, 2], 1e-6) + image_size / 2,
            ], axis=1).astype(np.int32)
            drawing.cv_rectangle(img, (int(bbox[0]), int(bbox[1])),
                                 (int(bbox[2]), int(bbox[3])), (166, 189, 219), 1)
            for i in range(1, len(SMPL_PARENTS)):
                p = SMPL_PARENTS[i]
                drawing.cv_line(img, tuple(xy[p]), tuple(xy[i]), (66, 135, 245), 2)
            for x, y in xy:
                drawing.cv_circle(img, (int(x), int(y)), 2, (255, 255, 255), -1)
        except Exception as e:  # the reference's per-instance tolerance
            print(f"Error decoding human pose instance: {e}")
            continue
    return img.astype(np.float32) / 255.0
