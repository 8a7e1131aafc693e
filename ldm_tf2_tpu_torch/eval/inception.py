"""InceptionV3 pool3 features for the published FID (the port's counterpart
of ``ldm_tf2_tpu.eval.inception``).

``InceptionV3`` is an ``nn.Module`` up to the 2048-d pool3 layer whose
``state_dict`` names are torchvision's ``inception_v3`` (which pytorch-fid's
``pt_inception-2015-12-05`` weights also use), so such a ``state_dict``
loads by name (``load_torchvision_state_dict``; the classifier ``fc.*``,
the ``AuxLogits`` tower and BatchNorm's ``num_batches_tracked`` are not
read).  The graph is pytorch-fid's ``FIDInceptionV3``, as in the JAX
package:

* the images, in [-1, 1], go straight to ``Conv2d_1a_3x3``: no
  ``transform_input`` affine;
* BatchNorm in eval mode, eps 1e-3, computed in float32 as
  ``(x - mean) * rsqrt(var + eps) * scale + bias``;
* the 3x3 stride-1 average pools of the A and C blocks and of ``Mixed_7b``
  exclude the padding (``count_include_pad=False``), and ``Mixed_7c``
  max-pools;
* the resize to 299x299 is ``jax.image.resize(..., "linear")``: half-pixel
  bilinear, antialiased when it shrinks the image, which is
  ``F.interpolate(mode="bilinear", align_corners=False, antialias=True)``
  (``tests/test_torch_eval.py`` holds both at 256 -> 299 and 512 -> 299).

Everything runs in float32 with TF32 off.  Weights are not shipped:
``inception_feature_extractor`` raises without a local ``.pth`` path.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3


class _BatchNorm(nn.Module):
    """torchvision's BatchNorm2d names, eval mode only."""

    def __init__(self, features: int):
        super().__init__()
        for name in ("weight", "bias", "running_mean", "running_var"):
            self.register_buffer(name, torch.empty(features))

    def forward(self, x):  # NCHW float32
        shape = (1, -1, 1, 1)
        inv = torch.rsqrt(self.running_var + BN_EPS)
        return ((x - self.running_mean.view(shape)) * inv.view(shape)
                * self.weight.view(shape) + self.bias.view(shape))


class BasicConv2d(nn.Module):
    """conv (no bias) -> BatchNorm (eps 1e-3) -> ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = _BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_exclude_pad(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_exclude_pad(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
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
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_exclude_pad(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


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
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool
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
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        pooled = (F.max_pool2d(x, 3, stride=1, padding=1) if self.pool == "max"
                  else _avg_pool_exclude_pad(x))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pooled)], dim=1)


class InceptionV3(nn.Module):
    """images [N, H, W, 3] in [-1, 1] (H, W >= 75) -> pool3 features
    [N, 2048]; the caller resizes to 299 (``resize_to_299``)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, pool="max")

    def forward(self, images):
        x = images.float().permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        return x.mean(dim=(2, 3))


def load_torchvision_state_dict(model: InceptionV3, state_dict: dict) -> InceptionV3:
    """Copy a torchvision / pytorch-fid ``state_dict`` (tensors or numpy
    arrays) into ``model`` by name; keys the pool3 graph does not use are
    not read, a key it uses that is missing raises ``KeyError``."""
    own = model.state_dict()
    with torch.no_grad():
        for key, value in own.items():
            if key not in state_dict:
                raise KeyError(f"inception state_dict has no {key}")
            value.copy_(torch.as_tensor(np.asarray(state_dict[key])).float())
    return model


def resize_to_299(images: torch.Tensor) -> torch.Tensor:
    """NHWC -> NHWC 299x299: ``jax.image.resize(..., "linear")``.  Its
    triangle kernel is plain half-pixel bilinear when it enlarges (the
    antialiased kernel rounds differently: 3e-6 off instead of 1e-7) and
    widens with the scale when it shrinks (plain bilinear is then 1.05
    off at 512 -> 299, the antialiased kernel 3e-6)."""
    shrinks = max(images.shape[1:3]) > 299
    x = F.interpolate(images.float().permute(0, 3, 1, 2), size=(299, 299),
                      mode="bilinear", align_corners=False, antialias=shrinks)
    return x.permute(0, 2, 3, 1)


def make_synthetic_inception_state_dict(seed: int = 0) -> dict:
    """Random torchvision-shaped state_dict (for structure tests — the
    graph and converter are exercised without the real 95 MB weights)."""
    rng = np.random.RandomState(seed)
    sd: dict = {}

    def add(prefix, cin, cout, kh, kw):
        sd[f"{prefix}.conv.weight"] = rng.randn(
            cout, cin, kh, kw
        ).astype(np.float32) * (kh * kw * cin) ** -0.5
        sd[f"{prefix}.bn.weight"] = np.abs(rng.randn(cout)).astype(np.float32)
        sd[f"{prefix}.bn.bias"] = rng.randn(cout).astype(np.float32) * 0.1
        sd[f"{prefix}.bn.running_mean"] = rng.randn(cout).astype(
            np.float32
        ) * 0.1
        sd[f"{prefix}.bn.running_var"] = np.abs(rng.randn(cout)).astype(
            np.float32
        ) + 0.5
        return cout

    add("Conv2d_1a_3x3", 3, 32, 3, 3)
    add("Conv2d_2a_3x3", 32, 32, 3, 3)
    add("Conv2d_2b_3x3", 32, 64, 3, 3)
    add("Conv2d_3b_1x1", 64, 80, 1, 1)
    add("Conv2d_4a_3x3", 80, 192, 3, 3)

    def inception_a(name, cin, pool):
        add(f"{name}.branch1x1", cin, 64, 1, 1)
        add(f"{name}.branch5x5_1", cin, 48, 1, 1)
        add(f"{name}.branch5x5_2", 48, 64, 5, 5)
        add(f"{name}.branch3x3dbl_1", cin, 64, 1, 1)
        add(f"{name}.branch3x3dbl_2", 64, 96, 3, 3)
        add(f"{name}.branch3x3dbl_3", 96, 96, 3, 3)
        add(f"{name}.branch_pool", cin, pool, 1, 1)
        return 64 + 64 + 96 + pool

    def inception_b(name, cin):
        add(f"{name}.branch3x3", cin, 384, 3, 3)
        add(f"{name}.branch3x3dbl_1", cin, 64, 1, 1)
        add(f"{name}.branch3x3dbl_2", 64, 96, 3, 3)
        add(f"{name}.branch3x3dbl_3", 96, 96, 3, 3)
        return 384 + 96 + cin

    def inception_c(name, cin, c7):
        add(f"{name}.branch1x1", cin, 192, 1, 1)
        add(f"{name}.branch7x7_1", cin, c7, 1, 1)
        add(f"{name}.branch7x7_2", c7, c7, 1, 7)
        add(f"{name}.branch7x7_3", c7, 192, 7, 1)
        add(f"{name}.branch7x7dbl_1", cin, c7, 1, 1)
        add(f"{name}.branch7x7dbl_2", c7, c7, 7, 1)
        add(f"{name}.branch7x7dbl_3", c7, c7, 1, 7)
        add(f"{name}.branch7x7dbl_4", c7, c7, 7, 1)
        add(f"{name}.branch7x7dbl_5", c7, 192, 1, 7)
        add(f"{name}.branch_pool", cin, 192, 1, 1)
        return 768

    def inception_d(name, cin):
        add(f"{name}.branch3x3_1", cin, 192, 1, 1)
        add(f"{name}.branch3x3_2", 192, 320, 3, 3)
        add(f"{name}.branch7x7x3_1", cin, 192, 1, 1)
        add(f"{name}.branch7x7x3_2", 192, 192, 1, 7)
        add(f"{name}.branch7x7x3_3", 192, 192, 7, 1)
        add(f"{name}.branch7x7x3_4", 192, 192, 3, 3)
        return 320 + 192 + cin

    def inception_e(name, cin):
        add(f"{name}.branch1x1", cin, 320, 1, 1)
        add(f"{name}.branch3x3_1", cin, 384, 1, 1)
        add(f"{name}.branch3x3_2a", 384, 384, 1, 3)
        add(f"{name}.branch3x3_2b", 384, 384, 3, 1)
        add(f"{name}.branch3x3dbl_1", cin, 448, 1, 1)
        add(f"{name}.branch3x3dbl_2", 448, 384, 3, 3)
        add(f"{name}.branch3x3dbl_3a", 384, 384, 1, 3)
        add(f"{name}.branch3x3dbl_3b", 384, 384, 3, 1)
        add(f"{name}.branch_pool", cin, 192, 1, 1)
        return 320 + 768 + 768 + 192

    c = inception_a("Mixed_5b", 192, 32)     # 256
    c = inception_a("Mixed_5c", c, 64)       # 288
    c = inception_a("Mixed_5d", c, 64)       # 288
    c = inception_b("Mixed_6a", c)           # 768
    c = inception_c("Mixed_6b", c, 128)
    c = inception_c("Mixed_6c", c, 160)
    c = inception_c("Mixed_6d", c, 160)
    c = inception_c("Mixed_6e", c, 192)
    c = inception_d("Mixed_7a", c)           # 1280
    c = inception_e("Mixed_7b", c)           # 2048
    c = inception_e("Mixed_7c", c)           # 2048
    # head keys a real checkpoint carries; converter must ignore them
    sd["fc.weight"] = rng.randn(1008, 2048).astype(np.float32)
    sd["fc.bias"] = rng.randn(1008).astype(np.float32)
    return sd


def inception_feature_extractor(
    weights_path: str | None = None, batch_size: int = 16, device="cuda",
) -> Callable[[np.ndarray], np.ndarray]:
    """features(images [N,H,W,3] in [-1,1]) -> [N, 2048] pool3 features.

    Weights-gated like eval/fid.py::clip_score: a random InceptionV3
    measures nothing comparable, so there is no offline fallback.
    """
    if weights_path is None:
        raise RuntimeError(
            "Inception-FID needs pretrained pool3 weights. Download the "
            "torchvision inception_v3 checkpoint "
            "(inception_v3_google-0cc3c7bd.pth) or pytorch-fid's "
            "pt_inception-2015-12-05 weights and pass "
            "inception_weights_path=<file>."
        )
    sd = torch.load(weights_path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return extractor_from_state_dict(sd, batch_size, device)


def extractor_from_state_dict(sd: dict, batch_size: int = 16, device="cuda"):
    """The pool3 extractor on ``device`` (float32, TF32 off) from a
    torchvision-layout ``state_dict``."""
    from ldm_tf2_tpu_torch import factory

    device = factory.resolve_device(device)
    factory.set_float32_precision()
    with torch.device(device):
        model = InceptionV3().eval().requires_grad_(False)
    load_torchvision_state_dict(model, sd)

    @torch.no_grad()
    def features(images: np.ndarray) -> np.ndarray:
        images = np.asarray(images, np.float32)
        out = []
        for i in range(0, len(images), batch_size):
            x = torch.as_tensor(images[i:i + batch_size], device=device)
            out.append(model(resize_to_299(x)).cpu().numpy())
        return np.concatenate(out, axis=0)

    return features
