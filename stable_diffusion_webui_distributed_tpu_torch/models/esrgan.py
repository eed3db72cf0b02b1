"""ESRGAN-family (RRDBNet) image upscalers in PyTorch.

Port of the JAX package's ``models/esrgan.py``, the image-space upscalers of
the hires fix (webui's upscaler dropdown, which the reference's ETA model
accounts for at ``scripts/spartan/worker.py:205-228``). The network is the
standard RRDBNet x4: ``conv_first``, ``nb`` RRDB blocks (three residual
dense blocks of five growth convolutions each), the trunk convolution, two
nearest x2 upsample convolutions, the HR convolution and the last one, with
LeakyReLU(0.2) activations. It computes in f32, as the JAX package does;
the engine runs it with TF32 off.

Both public checkpoint layouts load:
- new arch (BasicSR / RealESRGAN): ``conv_first.*, body.N.rdb1.conv1.*,
  conv_body.*, conv_up1/2.*, conv_hr.*, conv_last.*``;
- old arch (the original ESRGAN): ``model.0.*, model.1.sub.N.RDB1.conv1.0.*,
  model.1.sub.{nb}.*, model.3/6/8/10.*``, translated on load.

Weights keep torch's OIHW layout and one module per block (the JAX package
stacks the blocks for one ``lax.scan``). A ``.safetensors`` file is read by
the port's own reader, a ``.pth`` file by ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stable_diffusion_webui_distributed_tpu_torch.models.safetensors_io import (
    load_safetensors,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.image import (
    resize_device,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.dtypes import (
    resolve_device,
)

_OLD_HEAD = {"0": "conv_first", "3": "conv_up1", "6": "conv_up2",
             "8": "conv_hr", "10": "conv_last"}


def _normalize_keys(sd: Dict) -> Dict:
    """Old-arch ESRGAN keys -> new-arch names; new-arch passes through."""
    out = {}
    for key, v in sd.items():
        m = re.match(
            r"model\.1\.sub\.(\d+)\.RDB(\d)\.conv(\d)\.0\.(weight|bias)",
            key)
        if m:
            out[f"body.{m.group(1)}.rdb{m.group(2)}.conv{m.group(3)}."
                f"{m.group(4)}"] = v
            continue
        m = re.match(r"model\.1\.sub\.(\d+)\.(weight|bias)", key)
        if m:  # the trailing convolution inside the trunk is conv_body
            out[f"conv_body.{m.group(2)}"] = v
            continue
        m = re.match(r"model\.(\d+)\.(weight|bias)", key)
        if m and m.group(1) in _OLD_HEAD:
            out[f"{_OLD_HEAD[m.group(1)]}.{m.group(2)}"] = v
            continue
        if key.startswith("model."):
            continue  # old-arch activation and upsample placeholders
        out[key.replace(".RDB", ".rdb")] = v
    return out


def convert_esrgan(sd: Dict) -> Dict[str, torch.Tensor]:
    """A checkpoint's state dict (numpy arrays or tensors, either layout)
    -> :class:`RRDBNet`'s state dict, f32 on the CPU. Raises
    ``ValueError`` for an input of other than 3 channels (the
    pixel-unshuffle x2 variants)."""
    sd = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
          .float() for k, v in _normalize_keys(sd).items()}
    in_ch = sd["conv_first.weight"].shape[1]
    if in_ch != 3:
        raise ValueError(
            f"unsupported RRDBNet input of {in_ch} channels (pixel-unshuffle"
            " x2 variants not supported; use an x4 model)")
    return sd


class RDB(nn.Module):
    """Residual dense block: four growth convolutions, each seeing every
    earlier output, and a fifth back to ``nf`` channels, added at 0.2."""

    def __init__(self, nf: int, gc: int):
        super().__init__()
        for k in range(1, 6):
            self.add_module(f"conv{k}", nn.Conv2d(
                nf + (k - 1) * gc, gc if k < 5 else nf, 3, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cur = x
        for k in range(1, 5):
            y = getattr(self, f"conv{k}")(cur)
            cur = torch.cat([cur, F.leaky_relu(y, 0.2)], dim=1)
        return x + 0.2 * self.conv5(cur)


class RRDB(nn.Module):
    def __init__(self, nf: int, gc: int):
        super().__init__()
        self.rdb1 = RDB(nf, gc)
        self.rdb2 = RDB(nf, gc)
        self.rdb3 = RDB(nf, gc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + 0.2 * self.rdb3(self.rdb2(self.rdb1(x)))


class RRDBNet(nn.Module):
    """``forward(img (B,H,W,3) NHWC in [0, 1])`` -> ``(B,4H,4W,3)`` f32."""

    def __init__(self, nf: int = 64, gc: int = 32, nb: int = 23,
                 in_ch: int = 3, out_ch: int = 3):
        super().__init__()
        self.conv_first = nn.Conv2d(in_ch, nf, 3, padding=1)
        self.body = nn.ModuleList(RRDB(nf, gc) for _ in range(nb))
        self.conv_body = nn.Conv2d(nf, nf, 3, padding=1)
        self.conv_up1 = nn.Conv2d(nf, nf, 3, padding=1)
        self.conv_up2 = nn.Conv2d(nf, nf, 3, padding=1)
        self.conv_hr = nn.Conv2d(nf, nf, 3, padding=1)
        self.conv_last = nn.Conv2d(nf, out_ch, 3, padding=1)

    @staticmethod
    def shape_of(sd: Dict[str, torch.Tensor]) -> Dict[str, int]:
        """The constructor's arguments that ``sd`` was made with."""
        nb = 1 + max(int(re.match(r"body\.(\d+)\.", k).group(1))
                     for k in sd if k.startswith("body."))
        return {"nf": sd["conv_first.weight"].shape[0],
                "gc": sd["body.0.rdb1.conv1.weight"].shape[0], "nb": nb,
                "in_ch": sd["conv_first.weight"].shape[1],
                "out_ch": sd["conv_last.weight"].shape[0]}

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        def lrelu(x):
            return F.leaky_relu(x, 0.2)

        fea = self.conv_first(img.float().permute(0, 3, 1, 2))
        trunk = fea
        for block in self.body:
            trunk = block(trunk)
        fea = fea + self.conv_body(trunk)
        fea = lrelu(self.conv_up1(F.interpolate(fea, scale_factor=2,
                                                mode="nearest")))
        fea = lrelu(self.conv_up2(F.interpolate(fea, scale_factor=2,
                                                mode="nearest")))
        out = self.conv_last(lrelu(self.conv_hr(fea)))
        return out.permute(0, 2, 3, 1)


def esrgan_module(sd: Dict[str, torch.Tensor],
                  device: Optional[Union[str, torch.device]] = None
                  ) -> RRDBNet:
    """:class:`RRDBNet` with :func:`convert_esrgan`'s state dict ``sd``, in
    f32 on ``device`` (``cuda`` unless named; with none named and no GPU
    this raises)."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = RRDBNet(**RRDBNet.shape_of(sd))
    model = model.to_empty(device=device)
    model.load_state_dict(sd, strict=True)
    return model.requires_grad_(False).eval()


def load_esrgan(path: str,
                device: Optional[Union[str, torch.device]] = None
                ) -> RRDBNet:
    """Load and convert a ``.pth`` / ``.safetensors`` RRDBNet checkpoint to
    a module on ``device`` (``cuda`` unless named)."""
    device = resolve_device(device)
    if path.lower().endswith(".safetensors"):
        sd = load_safetensors(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict):
            for nest in ("params_ema", "params", "state_dict"):
                if nest in sd and isinstance(sd[nest], dict):
                    sd = sd[nest]
                    break
        sd = {k: v for k, v in sd.items() if torch.is_tensor(v)}
    return esrgan_module(convert_esrgan(sd), device)


def make_upscaler(model: RRDBNet) -> Callable:
    """-> ``upscale(imgs (B,H,W,3) in [0, 1], target_w, target_h)``: the
    model applied (again while the image is short of the target), clipped
    to [0, 1], then a lanczos3 resize to the exact target, clipped again:
    webui's upscale-then-shrink for fractional factors. Runs on the
    model's device."""
    device = next(model.parameters()).device

    def upscale(imgs: torch.Tensor, target_w: int,
                target_h: int) -> torch.Tensor:
        with torch.inference_mode():
            x = imgs.to(device=device, dtype=torch.float32)
            while x.shape[1] < target_h or x.shape[2] < target_w:
                x = torch.clamp(model(x), 0.0, 1.0)
            if (x.shape[1], x.shape[2]) != (target_h, target_w):
                x = torch.clamp(resize_device(x, target_h, target_w,
                                              "lanczos3"), 0.0, 1.0)
            return x

    return upscale
