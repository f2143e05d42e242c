"""Reconstruction and retrieval metrics (counterpart of the reference
``utils/metrics.py``): PSNR and SSIM on image tensors, the moment
accumulator and Frechet distance of FID-style metrics, Recall@K and mAP.

SSIM filters with an 11x11 Gaussian window; its convolution runs in exact
fp32 with TF32 off inside the call (cuDNN's default is TF32, which would
put the window sums near 1e-3 off), and the caller's flags come back
afterwards. The accumulators and the retrieval metrics are numpy.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from selftoktokenizer_tpu_torch.ops.precision import fp32_exact


def psnr(a, b, data_range=1.0, dim=(1, 2, 3)):
    """Per-image PSNR in dB. a, b: [B,H,W,C] in [0, data_range]."""
    mse = torch.mean((a.float() - b.float()) ** 2, dim=dim)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size=11, sigma=1.5, device=None):
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def ssim(a, b, data_range=1.0, size=11, sigma=1.5):
    """Per-image mean SSIM (Wang et al. constants), one Gaussian window a
    channel, valid positions only. a, b: [B,H,W,C] in [0, data_range]."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    a = a.float().permute(0, 3, 1, 2)
    b = b.float().permute(0, 3, 1, 2)
    ch = a.shape[1]
    kern = _gaussian_kernel(size, sigma, a.device)[None, None].expand(ch, 1, size, size)

    with fp32_exact():
        def filt(x):
            return F.conv2d(x, kern, groups=ch)

        mu_a, mu_b = filt(a), filt(b)
        mu_a2, mu_b2, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
        s_a = filt(a * a) - mu_a2
        s_b = filt(b * b) - mu_b2
        s_ab = filt(a * b) - mu_ab
    m = ((2 * mu_ab + c1) * (2 * s_ab + c2)) / ((mu_a2 + mu_b2 + c1) * (s_a + s_b + c2))
    return torch.mean(m, dim=(1, 2, 3))


class StreamingMoments:
    """Mean / covariance sums of features for FID-style metrics, in
    float64; merge the accumulators of several ranks or shards by adding
    their fields (``parallel.distributed.allgather_f64`` carries them)."""

    def __init__(self, dim):
        self.n = 0
        self.s1 = np.zeros((dim,), np.float64)
        self.s2 = np.zeros((dim, dim), np.float64)

    def update(self, feats):
        if torch.is_tensor(feats):
            feats = feats.detach().cpu().double().numpy()
        f = np.asarray(feats, np.float64)
        self.n += f.shape[0]
        self.s1 += f.sum(axis=0)
        self.s2 += f.T @ f

    def merge(self, other):
        self.n += other.n
        self.s1 += other.s1
        self.s2 += other.s2
        return self

    def mean_cov(self):
        mu = self.s1 / self.n
        cov = (self.s2 - self.n * mu[:, None] * mu[None, :]) / (self.n - 1)
        return mu, cov


def frechet_distance(mu1, cov1, mu2, cov2, eps=1e-6):
    """Frechet distance between two Gaussians; the square root of
    cov1 cov2 through symmetric eigendecompositions."""
    diff = mu1 - mu2
    s1 = _sqrtm_psd(cov1, eps)
    tr_sqrt = np.trace(_sqrtm_psd(s1 @ cov2 @ s1, eps))
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2 * tr_sqrt)


def _sqrtm_psd(m, eps=1e-6):
    w, v = np.linalg.eigh((m + m.T) / 2)
    w = np.clip(w, eps, None)
    return (v * np.sqrt(w)) @ v.T


def recall_at_k(sim, ks=(1, 5, 10)):
    """Recall@K over a similarity matrix [N_query, N_gallery] whose
    matched pairs lie on the diagonal."""
    sim = np.asarray(sim)
    n = sim.shape[0]
    ranks = np.argsort(-sim, axis=1)
    pos = np.argmax(ranks == np.arange(n)[:, None], axis=1)
    return {f"R@{k}": float(np.mean(pos < k)) for k in ks}


def mean_average_precision(sim, labels_q, labels_g):
    """Retrieval mAP of queries against a labelled gallery; a query with no
    relevant item is left out."""
    sim = np.asarray(sim)
    labels_q = np.asarray(labels_q)
    labels_g = np.asarray(labels_g)
    aps = []
    order = np.argsort(-sim, axis=1)
    for i in range(sim.shape[0]):
        rel = labels_g[order[i]] == labels_q[i]
        if not rel.any():
            continue
        cum = np.cumsum(rel)
        prec = cum / (np.arange(len(rel)) + 1)
        aps.append(float((prec * rel).sum() / rel.sum()))
    return float(np.mean(aps)) if aps else 0.0
