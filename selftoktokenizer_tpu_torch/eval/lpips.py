"""The LPIPS perceptual distance on VGG16 features, as an ``nn.Module``
(counterpart of the reference ``eval/lpips.py``; richzhang's 'vgg' LPIPS).

Inputs in [0, 1] are mapped to [-1, 1] and normalised per channel by the
scaling layer; VGG16's features at relu1_2, relu2_2, relu3_3, relu4_3 and
relu5_3 are unit-normalised over channels; the squared differences pass
through the five 1x1 ``lin`` heads, are averaged over space and summed over
the layers.

Module names are the lpips package's: ``scaling_layer.shift`` / ``.scale``
(buffers holding the package's constants), ``net.slice{1..5}.<torchvision
features index>.weight`` / ``.bias`` (slice1 holds features[0..3], slice2
[4..8], slice3 [9..15], slice4 [16..22], slice5 [23..29]) and
``lin{i}.model.1.weight`` [1, C, 1, 1], so the state dict of the package's
``LPIPS(net='vgg')`` loads strictly (``load_lpips_state_dict``, which drops
only ``lins.*``: the package's second name for the ``lin{i}`` heads). The
forward runs in fp32 with TF32 off inside the call.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from selftoktokenizer_tpu_torch.ops.precision import fp32_exact

# VGG16's convolutions: (torchvision features index, out channels); "M" = 2x2 max pool
VGG16 = [(0, 64), (2, 64), "M", (5, 128), (7, 128), "M",
         (10, 256), (12, 256), (14, 256), "M",
         (17, 512), (19, 512), (21, 512), "M",
         (24, 512), (26, 512), (28, 512)]
TAPS = (2, 7, 14, 21, 28)                 # the relu after these convolutions
TAP_CHANNELS = (64, 128, 256, 512, 512)
SLICES = ((1, 0, 3), (2, 4, 8), (3, 9, 15), (4, 16, 22), (5, 23, 29))
# the lpips package's ScalingLayer constants
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
IGNORED_PREFIX = "lins."


def slice_of(idx):
    return next(s for s, lo, hi in SLICES if lo <= idx <= hi)


class ScalingLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(SHIFT)[None, :, None, None])
        self.register_buffer("scale", torch.tensor(SCALE)[None, :, None, None])

    def forward(self, x):
        return (x - self.shift) / self.scale


class NetLinLayer(nn.Module):
    """A 1x1 conv to one channel, no bias; ``model.0`` is the package's
    dropout, which holds no weight and is off at evaluation."""

    def __init__(self, c):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(c, 1, 1, bias=False))

    def forward(self, x):
        return self.model(x)


class LPIPS(nn.Module):
    """forward(a, b): NHWC in [0, 1] -> distance [B] (lower is closer)."""

    def __init__(self):
        super().__init__()
        self.scaling_layer = ScalingLayer()
        self.net = nn.Module()
        for s, _, _ in SLICES:
            setattr(self.net, f"slice{s}", nn.Sequential())
        cin = 3
        for item in VGG16:
            if item == "M":
                continue
            idx, cout = item
            getattr(self.net, f"slice{slice_of(idx)}").add_module(
                str(idx), nn.Conv2d(cin, cout, 3, padding=1))
            cin = cout
        for i, c in enumerate(TAP_CHANNELS):
            setattr(self, f"lin{i}", NetLinLayer(c))

    def features(self, x):
        """The five tapped relu maps of NCHW x (already scaled)."""
        feats = []
        for item in VGG16:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            idx, _ = item
            x = F.relu(getattr(getattr(self.net, f"slice{slice_of(idx)}"), str(idx))(x))
            if idx in TAPS:
                feats.append(x)
        return feats

    def forward(self, a, b):
        with fp32_exact():
            def prep(x):
                return self.scaling_layer(2.0 * x.float().permute(0, 3, 1, 2) - 1.0)

            total = 0.0
            for i, (fa, fb) in enumerate(zip(self.features(prep(a)), self.features(prep(b)))):
                d = (_unit_norm(fa) - _unit_norm(fb)) ** 2
                total = total + torch.mean(getattr(self, f"lin{i}")(d), dim=(1, 2, 3))
            return total


def _unit_norm(f, eps=1e-10):
    return f / (torch.sqrt(torch.sum(f ** 2, dim=1, keepdim=True)) + eps)


def load_lpips_state_dict(model, sd):
    """Load the lpips package's LPIPS(net='vgg') state dict strictly, but
    for its ``lins.*`` aliases of the ``lin{i}`` heads."""
    model.load_state_dict({k: v for k, v in sd.items() if not k.startswith(IGNORED_PREFIX)},
                          strict=True)
    return model


@torch.no_grad()
def init_lpips_(model, generator):
    """Seeded random weights (plumbing checks only): conv weights 0.05 n,
    biases 0, lin heads |0.1 n|, as the reference's ``lpips_init`` draws
    them; the scaling constants stay."""
    dev = generator.device
    for m in model.net.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.copy_(0.05 * torch.randn(m.weight.shape, generator=generator, device=dev))
            m.bias.zero_()
    for i in range(len(TAP_CHANNELS)):
        w = getattr(model, f"lin{i}").model[1].weight
        w.copy_(torch.abs(0.1 * torch.randn(w.shape, generator=generator, device=dev)))
    return model
