"""InceptionV3 feature extractor for FID / Inception Score, PyTorch port.

Counterpart of fourm_tpu/vq/inception.py: the pt_inception-2015-12-05 "FID
variant" InceptionV3 that torchmetrics' FrechetInceptionDistance /
InceptionScore run (reference run_training_vqvae.py:47-53, 1427-1640):
average-pool branches with count_include_pad=False, max pooling in
Mixed_7c's pool branch, a 1008-class fc; `fid_variant=False` is the stock
torchvision layout. Modules are named as the torchvision / pytorch-fid
state dict (`Mixed_5b.branch1x1.conv.weight`, `...bn.running_var`,
`fc.weight`), so a reference-format file loads with `load_state_dict`;
BatchNorm runs in eval mode (eps 1e-3). `load_inception` reads a local
.pth / .safetensors / .npz; without a path the network keeps random
weights (nothing is downloaded), as the JAX package does.

Inputs are channel-last; `preprocess` resizes to 299 bilinearly as
jax.image.resize does (antialiased when downsizing) and maps [0, 1] to
[-1, 1].
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .vit_models import resize_weights


class BasicConv2d(nn.Module):
    """Convolution (no bias), eval-mode BatchNorm (eps 1e-3), ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg3(x: torch.Tensor, count_include_pad: bool) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=count_include_pad)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, fid_variant: bool = True):
        super().__init__()
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg3(x, not self.fid_variant))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, fid_variant: bool = True):
        super().__init__()
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg3(x, not self.fid_variant))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """pool_mode "avg" (Mixed_7b) or "max" (Mixed_7c, in the FID variant)."""

    def __init__(self, cin: int, pool_mode: str = "avg", fid_variant: bool = True):
        super().__init__()
        self.pool_mode, self.fid_variant = pool_mode, fid_variant
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool_mode == "max" and self.fid_variant:
            bp = F.max_pool2d(x, 3, 1, 1)
        else:
            bp = _avg3(x, not self.fid_variant)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


class InceptionV3(nn.Module):
    """InceptionV3 trunk: forward(x NHWC, 299 x 299 in [-1, 1]; `preprocess`)
    -> (features (B, 2048), logits (B, num_classes))."""

    def __init__(self, num_classes: int = 1008, fid_variant: bool = True):
        super().__init__()
        fv = fid_variant
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, fv)
        self.Mixed_5c = InceptionA(256, 64, fv)
        self.Mixed_5d = InceptionA(288, 64, fv)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fv)
        self.Mixed_6c = InceptionC(768, 160, fv)
        self.Mixed_6d = InceptionC(768, 160, fv)
        self.Mixed_6e = InceptionC(768, 192, fv)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg", fv)
        self.Mixed_7c = InceptionE(2048, "max", fv)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.float().permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        feats = x.mean(dim=(2, 3))
        return feats, self.fc(feats)


def preprocess(images: torch.Tensor, size: int = 299) -> torch.Tensor:
    """Images NHWC in [0, 1] (any resolution) -> size x size in [-1, 1]: the
    bilinear resize of jax.image.resize (two separable weight matrices,
    fp64 on the host, applied in fp32)."""
    B, H, W, C = images.shape
    x = images.float()
    if (H, W) != (size, size):
        wh = torch.from_numpy(resize_weights(H, size, "bilinear")).float().to(x.device)
        ww = torch.from_numpy(resize_weights(W, size, "bilinear")).float().to(x.device)
        x = torch.einsum("bhwc,hi,wj->bijc", x, wh, ww)
    return x * 2.0 - 1.0


def load_inception(path: Optional[str] = None, fid_variant: bool = True,
                   device=None) -> InceptionV3:
    """InceptionV3 (with the weights of a local reference-format file when
    a path is given; num_batches_tracked entries are ignored) on `device`
    (the card unless "cpu" is asked), frozen, in eval mode."""
    from ..api import resolve_device
    from .percept_losses import read_state_file

    model = InceptionV3(fid_variant=fid_variant)
    if path is not None:
        state = {k: v for k, v in read_state_file(path).items()
                 if not k.endswith("num_batches_tracked")}
        missing, unexpected = model.load_state_dict(state, strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if missing or unexpected:
            raise KeyError(f"{path}: InceptionV3 keys missing {missing[:5]}, unexpected "
                           f"{unexpected[:5]}")
    return model.to(resolve_device(device)).requires_grad_(False).eval()


def inception_features_and_probs(model: InceptionV3, images_01_nhwc, batch_size: int = 32):
    """FID / IS inputs of images in [0, 1] (NHWC, numpy or tensor), in
    chunks: (features (N, 2048), softmax probabilities (N, classes)) as
    numpy."""
    dev = next(model.parameters()).device
    feats, probs = [], []
    with torch.no_grad():
        for i in range(0, len(images_01_nhwc), batch_size):
            chunk = images_01_nhwc[i:i + batch_size]
            x = torch.as_tensor(chunk if isinstance(chunk, torch.Tensor)
                                else np.asarray(chunk)).to(dev)
            f, logits = model(preprocess(x))
            feats.append(f.cpu().numpy())
            probs.append(F.softmax(logits, dim=-1).cpu().numpy())
    return np.concatenate(feats), np.concatenate(probs)
