"""Inception-V3 pool3 features (2048 a row), the network of FID, as an
``nn.Module`` (counterpart of the reference ``eval/inception.py``).

Module names are torchvision's / pytorch-fid's (``Conv2d_1a_3x3.conv.weight``,
``Mixed_5b.branch5x5_1.bn.running_mean``, ...), so a pytorch-fid state dict
loads with a strict ``load_state_dict`` through ``load_inception_state_dict``,
which leaves out only what the pool3 features never read: ``fc.*``,
``AuxLogits.*`` and BatchNorm's ``num_batches_tracked``. BatchNorm is the
eval form (running statistics, eps 1e-3) and keeps no
``num_batches_tracked``.

``fid_variant=True`` (the default) keeps pytorch-fid's pooling: average
pools with ``count_include_pad=False`` in the A, C and E blocks and a 3x3
stride-1 max pool in Mixed_7c's pool branch; ``False`` gives torchvision's
pools.

Input NHWC in [0, 1], any size; resized to 299 x 299 bilinearly with
antialiasing (as ``jax.image.resize`` does, which the reference calls; so
this departs from pytorch-fid, which does not antialias a downscale), then
scaled to [-1, 1]. Output [B, 2048]. The forward runs in fp32 with TF32 off
inside the call (``ops/precision.py::fp32_exact``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from selftoktokenizer_tpu_torch.ops.precision import fp32_exact

BN_EPS = 1e-3
SIZE = 299
# entries of a torchvision / pytorch-fid state dict that pool3 never reads
IGNORED_PREFIXES = ("fc.", "AuxLogits.")
IGNORED_SUFFIX = "num_batches_tracked"


class EvalBatchNorm2d(nn.Module):
    """BatchNorm2d in eval mode: y = (x - running_mean) / sqrt(running_var
    + eps) * weight + bias, with BatchNorm2d's parameter names."""

    def __init__(self, c, eps=BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, False, 0.0, self.eps)


class BasicConv2d(nn.Module):
    """conv (no bias) -> eval BatchNorm -> relu."""

    def __init__(self, cin, cout, kernel_size, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=padding,
                              bias=False)
        self.bn = EvalBatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x, fid):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=not fid)


class InceptionA(nn.Module):
    def __init__(self, cin, pool):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool, 1)

    def forward(self, x, fid=True):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool(x, fid))
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x, fid=True):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin, c7):
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

    def forward(self, x, fid=True):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool(x, fid))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x, fid=True):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """max_pool: the FID variant's Mixed_7c (a 3x3 stride-1 max pool in the
    pool branch)."""

    def __init__(self, cin, max_pool=False):
        super().__init__()
        self.max_pool = max_pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x, fid=True):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        pool = F.max_pool2d(x, 3, 1, 1) if (self.max_pool and fid) else _avg_pool(x, fid)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pool)], 1)


class InceptionV3Pool3(nn.Module):
    """x: NHWC [B, H, W, 3] in [0, 1] -> pool3 features [B, 2048] fp32."""

    def __init__(self, fid_variant=True):
        super().__init__()
        self.fid_variant = fid_variant
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
        self.Mixed_7c = InceptionE(2048, max_pool=True)

    MIXED = ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
             "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c")

    def forward(self, x, resize=True):
        with fp32_exact():
            x = x.float().permute(0, 3, 1, 2)
            if resize and tuple(x.shape[2:]) != (SIZE, SIZE):
                x = F.interpolate(x, size=(SIZE, SIZE), mode="bilinear",
                                  align_corners=False, antialias=True)
            x = 2.0 * x - 1.0
            x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
            x = F.max_pool2d(x, 3, 2)
            x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
            x = F.max_pool2d(x, 3, 2)
            for name in self.MIXED:
                x = getattr(self, name)(x, fid=self.fid_variant)
            return torch.mean(x, dim=(2, 3))


def load_inception_state_dict(model, sd):
    """Load a torchvision / pytorch-fid Inception3 state dict into
    ``model``, strictly but for the entries pool3 never reads
    (``IGNORED_PREFIXES``, ``IGNORED_SUFFIX``); a missing or unknown key
    raises."""
    model.load_state_dict({k: v for k, v in sd.items() if not k.startswith(IGNORED_PREFIXES)
                           and not k.endswith(IGNORED_SUFFIX)}, strict=True)
    return model


@torch.no_grad()
def init_inception_(model, generator):
    """Seeded random weights of the shapes of the real net (for plumbing
    checks: real rFID needs the pytorch-fid weights): conv weights 0.1 n,
    BatchNorm scale 1 + 0.1 n, shift 0, running statistics 0 and 1, as the
    reference's ``inception_init`` draws them."""
    for m in model.modules():
        if isinstance(m, BasicConv2d):
            w = m.conv.weight
            w.copy_(0.1 * torch.randn(w.shape, generator=generator, device=generator.device))
            c = m.bn.weight.shape[0]
            m.bn.weight.copy_(1.0 + 0.1 * torch.randn(c, generator=generator,
                                                      device=generator.device))
            m.bn.bias.zero_()
            m.bn.running_mean.zero_()
            m.bn.running_var.fill_(1.0)
    return model
