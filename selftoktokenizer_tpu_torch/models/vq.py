"""Cosine-similarity vector quantizer, inference path (counterpart of the
reference ``models/vq.py:34-143``).

project_in (latent_dim -> code_dim) -> l2norm -> cosine scores against the
codebook -> argmax -> code gather. Runs fp32; the score + argmax decides
every token id and goes through the kernel of ``ops/vq_kernels.py``.
Parameter names follow the reference checkpoint (``project_in.weight``,
``_codebook.embed`` with its leading num_codebooks=1 axis).
"""

from __future__ import annotations

import torch
from torch import nn

from selftoktokenizer_tpu_torch.ops import routing
from selftoktokenizer_tpu_torch.ops import vq_kernels as vk
from selftoktokenizer_tpu_torch.ops.linear import linear


def l2norm(t, eps=1e-12):
    """F.normalize(p=2, dim=-1) semantics: x / max(||x||, eps)."""
    n = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    return t / torch.clamp(n, min=eps)


class _Codebook(nn.Module):
    def __init__(self, codebook_size, code_dim):
        super().__init__()
        self.embed = nn.Parameter(torch.empty(1, codebook_size, code_dim),
                                  requires_grad=False)


class VectorQuantize(nn.Module):
    """Owns the quantizer's weights; the functions below do the work."""

    def __init__(self, latent_dim, code_dim, codebook_size, output_dim=None):
        super().__init__()
        self.project_in = (nn.Linear(latent_dim, code_dim)
                           if code_dim != latent_dim else None)
        self.project_out = (nn.Linear(code_dim, output_dim)
                            if output_dim is not None and output_dim != code_dim
                            else None)
        self._codebook = _Codebook(codebook_size, code_dim)

    @property
    def embed(self):
        return self._codebook.embed[0]


def project_in(p: VectorQuantize, x):
    m = p.project_in
    return linear(x, m.weight, m.bias) if m is not None else x


def project_out(p: VectorQuantize, x):
    m = p.project_out
    return linear(x, m.weight, m.bias) if m is not None else x


def vq_distances(p: VectorQuantize, z, fast=False):
    """Cosine scores of l2-normalised inputs against the codebook, exact
    fp32. z: [..., code_dim] -> [..., codebook_size]. ``fast`` is the serving
    tier's flag and changes nothing here."""
    del fast
    return torch.matmul(z.float(), p.embed.float().t())


def vq_encode(p: VectorQuantize, x, fast=False):
    """x: [B, K, latent_dim] -> (ids [B,K] int32, z [B,K,code_dim]).

    The score + argmax runs as the fused kernel (never materialising the
    [N, codebook] scores); identical ids, first occurrence on ties."""
    z = l2norm(project_in(p, x).float())
    embed = p.embed.float()
    flat = z.reshape(-1, z.shape[-1])
    if routing.current() == "plain":
        ids = vk.vq_argmax_plain(flat, embed)
    else:
        ids = vk.vq_argmax(flat.contiguous(), embed.contiguous(), fast=fast)
    return ids.reshape(z.shape[:-1]), z


def vq_margins(p: VectorQuantize, x, fast=False):
    """(ids, top-2 cosine-score gap) per token: the argmax-tie safety
    budget. A change of backend or precision can only flip a token id whose
    margin is below the numerical noise."""
    z = l2norm(project_in(p, x).float())
    dist = vq_distances(p, z, fast=fast)
    ids = torch.argmax(dist, dim=-1).to(torch.int32)
    top2 = torch.topk(dist, 2, dim=-1).values
    return ids, top2[..., 0] - top2[..., 1]


def get_codes_from_indices(p: VectorQuantize, indices):
    return p.embed[indices.long()]


def get_output_from_indices(p: VectorQuantize, indices):
    """Codebook gather + optional out-projection."""
    return project_out(p, get_codes_from_indices(p, indices))


def vq_apply(p: VectorQuantize, x, fast=False):
    """Eval-mode quantizer forward: (quantize, ids, loss, log_dict). quantize
    is the raw code vector projected out, no straight-through, zero loss."""
    ids, z = vq_encode(p, x, fast=fast)
    quant = get_codes_from_indices(p, ids)
    cos = torch.sum(quant * z, dim=-1)
    quant = project_out(p, quant.to(x.dtype))
    return quant, ids, torch.zeros((), dtype=x.dtype, device=x.device), \
        {"cosine_sim": torch.mean(cos)}
