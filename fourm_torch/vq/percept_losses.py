"""Perceptual losses and tokenizer-evaluation metrics, PyTorch port.

Counterpart of fourm_tpu/vq/percept_losses.py (reference
fourm/vq/percept_losses/lpips.py:66-140, timm_perceptual_loss.py:25-110,
and the torchmetrics metrics of run_training_vqvae.py:1427-1640):
  * `LPIPS` over `VGG16Features`, its modules named as the reference's
    LPIPS state dict (`net.slice{k}.{i}.weight`, `lin{j}.model.1.weight`),
    so a reference-format file loads with `load_state_dict`; `load_lpips`
    reads one from a path the user gives (.safetensors by the port's own
    reader, .npz, .pth). Nothing is downloaded: without a path the caller
    runs it with random weights, as the JAX package does;
  * `feature_perceptual_loss` over any feature lists;
  * the numpy metrics `ms_ssim`, `frechet_distance`, `inception_score` and
    `binary_iou`, the JAX package's own numpy (and scipy) code.
Inputs are channel-last (B, H, W, C) in [-1, 1]; the VGG runs NCHW in
fp32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

# torchvision vgg16.features conv indices grouped by LPIPS slice
VGG16_SLICES: Tuple[Tuple[int, ...], ...] = (
    (0, 2),            # relu1_2
    (5, 7),            # relu2_2
    (10, 12, 14),      # relu3_3
    (17, 19, 21),      # relu4_3
    (24, 26, 28),      # relu5_3
)
VGG16_CHANNELS = (64, 128, 256, 512, 512)

# LPIPS input scaling constants (reference lpips.py ScalingLayer)
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """VGG16's five LPIPS slices (`slice1` .. `slice5`, each an
    nn.Sequential holding its convolutions under their torchvision
    `features` indices), NCHW in, the five ReLU outputs out."""

    def __init__(self):
        super().__init__()
        cin = 3
        for k, (conv_ids, ch) in enumerate(zip(VGG16_SLICES, VGG16_CHANNELS)):
            seq = nn.Sequential()
            if k > 0:
                seq.add_module(str(conv_ids[0] - 1), nn.MaxPool2d(2, 2))
            for ci in conv_ids:
                seq.add_module(str(ci), nn.Conv2d(cin, ch, 3, padding=1))
                seq.add_module(str(ci + 1), nn.ReLU())
                cin = ch
            self.add_module(f"slice{k + 1}", seq)

    def forward(self, x: torch.Tensor):
        outs = []
        for k in range(len(VGG16_SLICES)):
            x = getattr(self, f"slice{k + 1}")(x)
            outs.append(x)
        return outs


def _normalize_channels(x: torch.Tensor, dim: int, eps: float = 1e-10) -> torch.Tensor:
    """Unit-normalise the channel axis (reference normalize_tensor)."""
    return x / (x.square().sum(dim=dim, keepdim=True).sqrt() + eps)


class _NetLin(nn.Module):
    """A bias-free 1x1 convolution to one channel, under the reference's
    `model.1` name (model.0 is its dropout)."""

    def __init__(self, chn_in: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(chn_in, 1, 1, bias=False))

    def forward(self, x):
        return self.model(x)


class LPIPS(nn.Module):
    """Learned perceptual metric (reference lpips.py:66-110): forward(input,
    target), NHWC in [-1, 1] -> (B,) distances."""

    def __init__(self):
        super().__init__()
        self.net = VGG16Features()
        for j, ch in enumerate(VGG16_CHANNELS):
            self.add_module(f"lin{j}", _NetLin(ch))
        self.register_buffer("shift", torch.tensor(_LPIPS_SHIFT).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_LPIPS_SCALE).reshape(1, 3, 1, 1),
                             persistent=False)

    def features(self, x: torch.Tensor):
        """The five VGG feature maps (NCHW) of NHWC images in [-1, 1]."""
        return self.net((x.float().permute(0, 3, 1, 2) - self.shift) / self.scale)

    def forward(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        f0, f1 = self.features(input), self.features(target)
        val = 0.0
        for j, (a, b) in enumerate(zip(f0, f1)):
            diff = (_normalize_channels(a, 1) - _normalize_channels(b, 1)).square()
            val = val + getattr(self, f"lin{j}")(diff).mean(dim=(1, 2, 3))
        return val


def read_state_file(path: str) -> dict:
    """A torch-layout state dict from a local .safetensors (the port's own
    reader), .npz or .pth file, as fp32 tensors."""
    if path.endswith(".safetensors"):
        from ..utils.checkpoint import load_safetensors

        state = load_safetensors(path, return_metadata=False)
    elif path.endswith(".npz"):
        state = {k: torch.from_numpy(np.asarray(v)) for k, v in np.load(path).items()}
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float() if v.is_floating_point() else v for k, v in state.items()}


def load_lpips(path: str, device=None) -> LPIPS:
    """LPIPS with the reference-format weights of a local file (the LPIPS
    vgg.pth state dict: net.slice{k}.{i}.*, lin{j}.model.1.weight), on
    `device` (the card unless "cpu" is asked), frozen, in eval mode."""
    from ..api import resolve_device

    model = LPIPS()
    model.load_state_dict(read_state_file(path), strict=True)
    return model.to(resolve_device(device)).requires_grad_(False).eval()


def feature_perceptual_loss(feats_pred: Sequence[torch.Tensor],
                            feats_target: Sequence[torch.Tensor],
                            feature_loss: str = "cosine") -> torch.Tensor:
    """Distance over feature lists (reference TimmPerceptualLoss,
    timm_perceptual_loss.py:63-110). Features (B, N, C) or NHWC."""
    loss = 0.0
    for fp, ft in zip(feats_pred, feats_target):
        if fp.ndim == 4:
            fp = fp.reshape(fp.shape[0], -1, fp.shape[-1])
            ft = ft.reshape(ft.shape[0], -1, ft.shape[-1])
        if feature_loss in ("l1", "mae"):
            loss = loss + (_normalize_channels(fp, -1) - _normalize_channels(ft, -1)).abs() \
                .sum(-1).mean(-1)
        elif feature_loss in ("cosine", "cos"):
            cos = (_normalize_channels(fp, -1) * _normalize_channels(ft, -1)).sum(-1)
            loss = loss + (1.0 - cos.mean(-1))
        else:
            raise ValueError(f"unknown feature loss {feature_loss}")
    return loss.mean()


# ----------------------------------------------------------------- metrics


def ms_ssim(img1: np.ndarray, img2: np.ndarray, data_range: float = 2.0,
            weights: Sequence[float] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)) -> float:
    """Multi-scale SSIM (Wang et al. 2003), numpy, NHWC (percept_losses.py:
    151-197)."""
    def gaussian_kernel(size=11, sigma=1.5):
        g = np.exp(-0.5 * ((np.arange(size) - size // 2) / sigma) ** 2)
        g /= g.sum()
        return np.outer(g, g)

    def filt(x, k):
        from scipy.signal import convolve2d

        return np.stack([
            np.stack([convolve2d(x[b, :, :, c], k, mode="valid")
                      for c in range(x.shape[-1])], axis=-1)
            for b in range(x.shape[0])
        ])

    def ssim_pair(a, b):
        k = gaussian_kernel()
        C1 = (0.01 * data_range) ** 2
        C2 = (0.03 * data_range) ** 2
        mu1, mu2 = filt(a, k), filt(b, k)
        s11 = filt(a * a, k) - mu1 * mu1
        s22 = filt(b * b, k) - mu2 * mu2
        s12 = filt(a * b, k) - mu1 * mu2
        cs = (2 * s12 + C2) / (s11 + s22 + C2)
        ssim = ((2 * mu1 * mu2 + C1) / (mu1**2 + mu2**2 + C1)) * cs
        return float(ssim.mean()), float(cs.mean())

    a = np.asarray(img1, np.float64)
    b = np.asarray(img2, np.float64)
    levels = len(weights)
    vals = []
    for i in range(levels):
        s, cs = ssim_pair(a, b)
        vals.append(s if i == levels - 1 else cs)
        if i != levels - 1:
            a = a[:, : a.shape[1] // 2 * 2, : a.shape[2] // 2 * 2]
            b = b[:, : b.shape[1] // 2 * 2, : b.shape[2] // 2 * 2]
            a = (a[:, ::2, ::2] + a[:, 1::2, ::2] + a[:, ::2, 1::2] + a[:, 1::2, 1::2]) / 4
            b = (b[:, ::2, ::2] + b[:, 1::2, ::2] + b[:, ::2, 1::2] + b[:, 1::2, 1::2]) / 4
    vals = np.clip(np.asarray(vals), 1e-8, None)
    return float(np.prod(vals ** np.asarray(weights)))


def frechet_distance(feats_real: np.ndarray, feats_fake: np.ndarray,
                     eps: float = 1e-6) -> float:
    """FID over any feature space (percept_losses.py:200-228): the Frechet
    distance of the two Gaussians, eps * I added to both covariances when
    sqrtm of their product is not finite (pytorch-fid)."""
    import warnings

    from scipy import linalg

    mu1, mu2 = feats_real.mean(0), feats_fake.mean(0)
    s1 = np.cov(feats_real, rowvar=False)
    s2 = np.cov(feats_fake, rowvar=False)
    diff = mu1 - mu2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        covmean, _ = linalg.sqrtm(s1 @ s2, disp=False)
        if not np.isfinite(covmean).all():
            offset = np.eye(s1.shape[0]) * eps
            covmean, _ = linalg.sqrtm((s1 + offset) @ (s2 + offset), disp=False)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2 * np.trace(covmean))


def inception_score(probs: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """IS from class probabilities (reference torchmetrics InceptionScore)."""
    scores = []
    n = probs.shape[0]
    for i in range(splits):
        part = probs[i * n // splits: (i + 1) * n // splits]
        if len(part) == 0:
            continue
        py = part.mean(0, keepdims=True)
        kl = part * (np.log(part + 1e-10) - np.log(py + 1e-10))
        scores.append(np.exp(kl.sum(1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def binary_iou(pred: np.ndarray, target: np.ndarray, threshold: float = 0.5) -> float:
    """Binary IoU (reference torchmetrics BinaryJaccardIndex for mask eval)."""
    p = np.asarray(pred) > threshold
    t = np.asarray(target) > threshold
    inter = np.logical_and(p, t).sum()
    union = np.logical_or(p, t).sum()
    return float(inter / union) if union else 1.0
