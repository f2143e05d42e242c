"""Cosine-similarity EMA vector quantizer (counterpart of the reference
``models/vq.py``).

Inference (``vq_apply`` / ``vq_encode``): project_in (latent_dim ->
code_dim) -> l2norm -> cosine scores against the codebook -> argmax -> code
gather. Runs fp32; the score + argmax decides every token id and goes
through the kernel of ``ops/vq_kernels.py``. Parameter names follow the
reference checkpoint (``project_in.weight``, ``_codebook.embed`` with its
leading num_codebooks=1 axis).

Training (``vq_train_apply`` + ``VQState``): the EMA statistics are an
explicit state of tensors, passed in and returned. The ids come from the
full [B*K, C] score matrix, which the entropy losses need anyway, so the
argmax kernel is not on this path. Every random draw of the reference
(k-means' first indices, dead-code candidates, Gumbel noise, the warm-up's
ids) can be passed in explicitly, so a test can feed both sides one draw;
otherwise it comes from the ``torch.Generator`` given as ``rng``.

Accumulation over microbatches (and data parallelism, which places the
microbatches on ranks) splits the training step in two halves:
``vq_train_apply(return_extras=True)`` runs the statistics once over the
global batch and returns the codebook it quantized against and
d(diversity)/d(ap_k); ``vq_microbatch_surrogate`` then gives each
microbatch its exact share of the global loss's gradient.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from selftoktokenizer_tpu_torch.ops import routing
from selftoktokenizer_tpu_torch.ops import vq_kernels as vk
from selftoktokenizer_tpu_torch.ops.linear import linear
from selftoktokenizer_tpu_torch.ops.precision import fp32_exact


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


# ---------------------------------------------------------------------------
# Training: explicit EMA codebook state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VQState:
    """The EMA statistics the reference keeps as mutated buffers."""
    embed: torch.Tensor              # [C, D], the authoritative codebook
    cluster_size: torch.Tensor       # [C]
    embed_avg: torch.Tensor          # [C, D]
    timestep_p_over_c: torch.Tensor  # [K, C] per-position code-usage EMA
    count: torch.Tensor              # [C] lifetime usage counter
    steps: torch.Tensor              # int64 scalar
    initted: torch.Tensor            # bool scalar: k-means init done
    tpc_initted: torch.Tensor        # bool scalar: timestep_p_over_c seeded

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to(self, device):
        return VQState(**{f.name: getattr(self, f.name).to(device)
                          for f in dataclasses.fields(self)})

    def asdict(self):
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


def vq_state_init(p: VectorQuantize, K: int) -> VQState:
    embed = p.embed.detach().float()
    C = embed.shape[0]
    dev = embed.device
    return VQState(
        embed=embed.clone(),
        cluster_size=torch.zeros(C, device=dev),
        embed_avg=embed.clone(),
        timestep_p_over_c=torch.full((K, C), 1.0 / C, device=dev),
        count=torch.zeros(C, device=dev),
        steps=torch.zeros((), dtype=torch.int64, device=dev),
        initted=torch.zeros((), dtype=torch.bool, device=dev),
        tpc_initted=torch.zeros((), dtype=torch.bool, device=dev))


def vq_state_from_state_dict(sd, K: int) -> VQState:
    """The EMA buffers of a reference ``VectorQuantize`` sub-state-dict
    (names relative to the quantizer module); a missing buffer takes the
    reference loader's default."""
    def get(name):
        if name not in sd:
            return None
        a = torch.as_tensor(sd[name]).float()
        return a[0] if a.ndim > 1 and a.shape[0] == 1 else a

    def scalar(name, default):
        return torch.as_tensor(sd[name]).reshape(-1)[0].item() if name in sd else default

    embed = torch.as_tensor(sd["_codebook.embed"]).float()
    embed = embed[0] if embed.ndim == 3 else embed
    C = embed.shape[0]
    cluster = get("_codebook.cluster_size")
    embed_avg = get("_codebook.embed_avg")
    tpc = get("_codebook.timestep_p_over_c")
    count = get("count")
    return VQState(
        embed=embed.clone(),
        cluster_size=torch.zeros(C) if cluster is None else cluster.reshape(C),
        embed_avg=embed.clone() if embed_avg is None else embed_avg.reshape(embed.shape),
        timestep_p_over_c=torch.full((K, C), 1.0 / C) if tpc is None else tpc.reshape(K, C),
        count=torch.zeros(C) if count is None else count.reshape(C),
        steps=torch.tensor(int(scalar("steps", 0)), dtype=torch.int64),
        initted=torch.tensor(bool(scalar("_codebook.initted", 1))),
        tpc_initted=torch.tensor(bool(scalar("_codebook.tpc_initted", 1))))


def vq_state_to_state_dict(state: VQState):
    """The VQState as the reference ``VectorQuantize`` buffers (names
    relative to the quantizer module, the leading num_codebooks=1 axis)."""
    f32 = torch.float32
    return {
        "_codebook.embed": state.embed[None],
        "_codebook.initted": state.initted.reshape(1).to(f32),
        "_codebook.cluster_size": state.cluster_size[None],
        "_codebook.embed_avg": state.embed_avg[None],
        "_codebook.timestep_p_over_c": state.timestep_p_over_c[None],
        "_codebook.tpc_initted": state.tpc_initted.reshape(1).to(f32),
        "steps": state.steps.reshape(1).to(f32),
        "count": state.count[None],
    }


def _laplace_smoothing(x, n_categories, eps=1e-5):
    denom = torch.sum(x, dim=-1, keepdim=True)
    return (x + eps) / (denom + n_categories * eps)


def _ema_entropy_from_ap(ap, onehot_ema, ratio_d, groups=64):
    """calc_ema_entropy on the batch-mean softmax ``ap`` [K, C]: the entropy
    of the blended per-position usage, and of its means over groups of
    positions (torch ``tensor_split(groups)`` chunks; K groups when K < 64)."""
    ema_p = onehot_ema * (1 - ratio_d) + ap * ratio_d
    ent1 = torch.mean(-torch.sum(ema_p * torch.log(ema_p), dim=-1))
    K = ema_p.shape[0]
    g = torch.stack([c.mean(dim=0) for c in torch.tensor_split(ema_p, min(groups, K), dim=0)])
    ent2 = torch.mean(-torch.sum(g * torch.log(g), dim=-1))
    return ent1, ent2


def _diversity_from_apk(ap_k, new_tpc, cfg):
    """Diversity loss as a function of the batch-mean softmax ``ap_k`` [K, C]
    (new_tpc and the gate weight carry no gradient). Returns (diversity,
    perplexity, diversity_entropy)."""
    C = ap_k.shape[-1]
    if cfg.get("smart_react", True):
        cb_ent, grp_ent = _ema_entropy_from_ap(
            ap_k, new_tpc, ratio_d=1.0 - cfg.get("ema_entropy_ratio", 0.7))
        entropy = 0.5 * (cb_ent + grp_ent)
        group_perp = torch.mean(torch.exp(
            -torch.sum(new_tpc * torch.log(new_tpc + 1e-10), dim=-1)))
        frac = group_perp / C
        reg = cfg.get("reg", [0.25, 0.5])
        wgt = torch.where(frac < reg[0], torch.full_like(frac, 0.5),
                          torch.clamp(0.5 - 0.5 / (reg[1] - reg[0]) * (frac - reg[0]), min=0.0))
        diversity = -cfg.get("w_diversity", 1.0) * wgt * entropy
        return diversity, group_perp, cb_ent
    ap = torch.mean(ap_k, dim=0)
    entropy_to_max = -torch.sum(ap * torch.log(ap))
    diversity = -cfg.get("w_diversity", 1.0) * entropy_to_max
    return diversity, torch.exp(entropy_to_max), entropy_to_max


def _segment_sum(values, ids, n):
    """sum of values[i] into row ids[i] of n rows (values [N] or [N, D])."""
    out = torch.zeros((n,) + tuple(values.shape[1:]), dtype=values.dtype, device=values.device)
    return out.index_add_(0, ids, values)


def kmeans_cosine(samples, num_clusters, idx, num_iters=10):
    """Cosine k-means codebook init. samples: [N, D] l2-normalised; idx:
    [num_clusters] the first means' sample indices (the reference draws a
    permutation's head when N >= num_clusters, else uniform integers)."""
    means = samples[idx]
    for _ in range(num_iters):
        buckets = torch.argmax(samples @ means.t(), dim=-1)
        bins = _segment_sum(torch.ones(samples.shape[0], device=samples.device), buckets,
                            num_clusters)
        sums = _segment_sum(samples, buckets, num_clusters)
        new = l2norm(sums / torch.clamp(bins, min=1.0)[:, None])
        means = torch.where((bins == 0)[:, None], means, new)
    return means


def kmeans_init_indices(n, num_clusters, rng):
    """The first means' indices, drawn as the reference draws them."""
    if n >= num_clusters:
        return torch.randperm(n, generator=rng, device=rng.device)[:num_clusters]
    return torch.randint(0, n, (num_clusters,), generator=rng, device=rng.device)


def inverse_cdf(weights, uniforms):
    """Indices drawn with probabilities ``weights`` from ``uniforms`` in
    [0, 1), as the reference's ``jax.random.choice(p=...)`` turns its
    uniforms into indices: the first index whose cumulative weight reaches
    total * (1 - u)."""
    cum = torch.cumsum(weights, dim=0)
    return torch.searchsorted(cum, cum[-1] * (1 - uniforms))


def vq_train_apply(p: VectorQuantize, state: VQState, x, cfg, rng=None,
                   gumbel_noise=None, kmeans_idx=None, react_uniforms=None,
                   warm_ids=None, return_extras=False):
    """Training forward and EMA codebook update.

    cfg: the quantizer_config mapping (decay, w_commit, w_diversity, reg,
    ema_entropy_ratio, dead_code_threshold, reset_cluster_size, smart_react,
    continuous, continuous_steps, stochastic_sample_codes,
    sample_codebook_temp, kmeans_iters). rng: a torch.Generator for the
    draws not passed in; without rng and without the draw, k-means init and
    dead-code reactivation do not happen (the reference's ``rng=None``).
    kmeans_idx [C]: the k-means start; react_uniforms [C] in [0, 1): the
    dead-code candidates, through ``inverse_cdf``; gumbel_noise [1, B*K, C];
    warm_ids [B, K]: the continuous warm-up's ids.

    Returns (quantize_st, ids, loss, new_state, log_dict). Gradients reach
    project_in / project_out and x through the straight-through output and
    the commitment and entropy losses; the codebook moves by EMA in
    new_state (the caller writes ``new_state.embed`` back).

    ``continuous``: for the first ``continuous_steps`` calls the quantizer
    is bypassed (projected features out, uniform random ids, no loss, only
    ``count`` and ``steps`` advance); k-means fires on the first quantized
    step.

    return_extras: also return a sixth element {"embed_used": the codebook
    the forward quantized against (the k-means codebook on the init step),
    "g_ap": d(diversity)/d(ap_k) [K, C] at this batch's ap_k}, the frozen
    quantities of ``vq_microbatch_surrogate``. Refused (ValueError) while
    the continuous warm-up bypasses the quantizer."""
    B, K, _ = x.shape
    C = p.embed.shape[0]
    z = l2norm(project_in(p, x).float())
    flat = z.reshape(1, B * K, -1)
    if not cfg.get("continuous", False) or int(state.steps) >= int(cfg.get("continuous_steps", 2000)):
        return _vq_quantize_body(p, state, z, flat, x, cfg, rng, gumbel_noise, kmeans_idx,
                                 react_uniforms, return_extras)
    if return_extras:
        raise ValueError("return_extras: the continuous warm-up is active and quantizes "
                         "nothing (accumulation needs continuous=False or a finished warm-up)")
    if warm_ids is None:
        if rng is None:
            raise ValueError("continuous warmup requires an rng or warm_ids")
        warm_ids = torch.randint(0, C, (B, K), generator=rng, device=rng.device)
    ids = warm_ids.to(device=z.device, dtype=torch.int32)
    new_count = state.count + _segment_sum(torch.ones(B * K, device=z.device),
                                           ids.reshape(-1).long(), C)
    avg = new_count / torch.clamp(torch.sum(new_count), min=1.0)
    perplexity = torch.exp(-torch.sum(avg * torch.log(avg + 1e-10)))
    zero = torch.zeros((), device=z.device)
    log_dict = {
        "commit_loss": zero, "perplexity": perplexity, "diversity_entropy": zero,
        "deterministic_entropy": zero, "delta_embed": zero,
        "n_reactive": torch.zeros((), dtype=torch.int64, device=z.device),
        "cosine_sim": torch.mean(torch.sum(z * z, dim=-1)).detach(),
    }
    return (project_out(p, z), ids, zero, state.replace(count=new_count, steps=state.steps + 1),
            log_dict)


def _vq_quantize_body(p, state: VQState, z, flat, x, cfg, rng, gumbel_noise, kmeans_idx,
                      react_uniforms, return_extras=False):
    """The quantized (non-warm-up) training forward; see ``vq_train_apply``."""
    decay = cfg.get("decay", 0.99)
    B, K, _ = x.shape
    C = p.embed.shape[0]
    dev = z.device
    flat0 = flat[0].detach()

    # first-batch k-means seeding of the codebook and its cluster statistics
    if not bool(state.initted) and (kmeans_idx is not None or rng is not None):
        if kmeans_idx is None:
            kmeans_idx = kmeans_init_indices(flat0.shape[0], C, rng)
        embed = kmeans_cosine(flat0, C, kmeans_idx.to(dev).long(),
                              num_iters=cfg.get("kmeans_iters", 10))
        buckets = torch.argmax(flat0 @ embed.t(), dim=-1)
        prev_cluster = _segment_sum(torch.ones(flat0.shape[0], device=dev), buckets, C)
        prev_embed_avg = embed * prev_cluster[:, None]
    else:
        embed = state.embed
        prev_cluster, prev_embed_avg = state.cluster_size, state.embed_avg
    embed = embed.detach()
    dist = torch.matmul(flat, embed.t())                          # [1, B*K, C]
    temp = float(cfg.get("sample_codebook_temp", 1.0))
    if cfg.get("stochastic_sample_codes", False) and temp > 0:
        # Gumbel sampling perturbs the selection only; dist feeds the entropies
        if gumbel_noise is None:
            if rng is None:
                raise ValueError("stochastic_sample_codes requires an rng or gumbel_noise")
            u = torch.rand(dist.shape, generator=rng, device=rng.device).clamp_(min=1e-20)
            gumbel_noise = -torch.log(-torch.log(u))
        ids = torch.argmax(dist.detach() / temp + gumbel_noise.to(dev), dim=-1)
    else:
        ids = torch.argmax(dist.detach(), dim=-1)
    idv = ids[0]                                                  # [B*K]
    quantize = embed[idv].reshape(B, K, -1)

    # EMA statistics: scatter-adds of the assignments (no gradient)
    kpos = torch.arange(K, device=dev).repeat(B)                  # row b*K+k -> k
    per_pos = _segment_sum(torch.ones(B * K, device=dev), kpos * C + idv, K * C).reshape(K, C)
    tpc_decay = decay if bool(state.tpc_initted) else 0.3         # the first update: 0.3
    new_tpc = state.timestep_p_over_c * tpc_decay + per_pos / B * (1 - tpc_decay)
    bins = per_pos.sum(dim=0)
    embed_sum = _segment_sum(flat0, idv, C)
    new_cluster = prev_cluster * decay + bins * (1 - decay)
    new_embed_avg = prev_embed_avg * decay + embed_sum * (1 - decay)
    cs = _laplace_smoothing(new_cluster, C) * torch.sum(new_cluster)
    embed_normalized = l2norm(new_embed_avg / cs[:, None])
    delta_embed = torch.sum((embed - embed_normalized) ** 2)

    # dead-code reactivation: a code whose EMA count is under the threshold
    # takes a batch vector, drawn toward token positions of low perplexity
    threshold = cfg.get("threshold_ema_dead_code", cfg.get("dead_code_threshold", 0.0)) or 0.0
    reset_cluster_size = cfg.get("reset_cluster_size")
    if reset_cluster_size in (None, "None"):
        reset_cluster_size = threshold
    if threshold and (react_uniforms is not None or rng is not None):
        ratio = (B * K) / C                     # relative -> absolute threshold
        abs_threshold = ratio * threshold
        abs_reset = ratio * reset_cluster_size
        dead = new_cluster < abs_threshold
        perp = torch.exp(-torch.sum(new_tpc * torch.log(new_tpc + 1e-10), dim=-1))   # [K]
        w = 1.0 / perp
        w = torch.softmax(w / torch.max(w) * 10.0, dim=0)
        flat_w = w[None, :].expand(B, K).reshape(-1) / B
        if react_uniforms is None:
            react_uniforms = torch.rand((C,), generator=rng, device=rng.device)
        cand = l2norm(flat0[inverse_cdf(flat_w, react_uniforms.to(dev))])
        new_embed = torch.where(dead[:, None], cand, embed_normalized)
        new_embed_avg = torch.where(dead[:, None], cand * abs_reset, new_embed_avg)
        new_cluster = torch.where(dead, torch.full_like(new_cluster, abs_reset), new_cluster)
        n_reactive = torch.sum(dead)
    else:
        new_embed = embed_normalized
        n_reactive = torch.zeros((), dtype=torch.int64, device=dev)

    # losses: commitment, and both entropies from one softmax of the scores
    commit = torch.sum((quantize - z) ** 2) / z.numel()
    scaled = (dist * 10.0).reshape(B, K, C)
    lse = torch.logsumexp(scaled, dim=-1)                         # [B, K]
    pr = torch.exp(scaled - lse[..., None])
    ap_k = torch.mean(pr, dim=0)                                  # [K, C]
    entropy_to_min = torch.mean(lse - torch.sum(pr * scaled, dim=-1))
    diversity, perplexity, diversity_entropy = _diversity_from_apk(ap_k, new_tpc, cfg)
    loss = cfg.get("w_commit", 1.0) * commit + diversity

    quant_st = z + (quantize - z).detach()                        # straight-through
    quant_out = project_out(p, quant_st)
    one = torch.ones((), dtype=torch.bool, device=dev)
    new_state = VQState(
        embed=new_embed, cluster_size=new_cluster, embed_avg=new_embed_avg,
        timestep_p_over_c=new_tpc, count=state.count + bins, steps=state.steps + 1,
        initted=one, tpc_initted=one.clone())
    log_dict = {
        "commit_loss": commit.detach(),
        "perplexity": perplexity.detach(),
        "diversity_entropy": diversity_entropy.detach(),
        "deterministic_entropy": entropy_to_min.detach(),
        "delta_embed": delta_embed,
        "n_reactive": n_reactive,
        "cosine_sim": torch.mean(torch.sum(quantize * z.detach(), dim=-1)),
    }
    ids = ids.reshape(B, K).to(torch.int32)
    if return_extras:
        with torch.enable_grad():
            a = ap_k.detach().requires_grad_()
            g_ap, = torch.autograd.grad(_diversity_from_apk(a, new_tpc, cfg)[0], a)
        return quant_out, ids, loss, new_state, log_dict, {"embed_used": embed, "g_ap": g_ap}
    return quant_out, ids, loss, new_state, log_dict


class _ExactScores(torch.autograd.Function):
    """z @ embed^T with TF32 off in the forward and in the backward (the
    reference's HIGHEST precision); embed gets no gradient."""

    @staticmethod
    def forward(ctx, z, embed):
        ctx.save_for_backward(embed)
        with fp32_exact():
            return torch.matmul(z, embed.t())

    @staticmethod
    def backward(ctx, g):
        embed, = ctx.saved_tensors
        with fp32_exact():
            return torch.matmul(g, embed), None


def vq_microbatch_surrogate(p: VectorQuantize, x, inj, cfg):
    """One microbatch's training forward against the frozen quantities of
    the global step (the second half of the accumulated step).

    inj: {"ids": [B_m, K] this microbatch's rows of the global ids,
    "embed_used": [C, D] the codebook the global pass quantized against,
    "g_ap": [K, C] d(diversity)/d(ap_k) at the global ap_k}.

    The commitment loss is an element mean, so equal microbatches average
    to the global one; the diversity term is linear in each microbatch's
    batch-mean softmax near the global point, so sum(g_ap * ap_k_mb) gives
    the global gradient when the microbatches' gradients are averaged. The
    scores are exact fp32 (TF32 off inside). Returns (quant_out, loss,
    log_dict)."""
    z = l2norm(project_in(p, x).float())
    embed = inj["embed_used"].detach().float()
    quantize = embed[inj["ids"].long()]                           # [B, K, D]
    commit = torch.sum((quantize - z) ** 2) / z.numel()
    scaled = _ExactScores.apply(z, embed) * 10.0                  # [B, K, C]
    lse = torch.logsumexp(scaled, dim=-1)
    pr = torch.exp(scaled - lse[..., None])
    surr = torch.sum(inj["g_ap"].detach() * torch.mean(pr, dim=0))
    loss = cfg.get("w_commit", 1.0) * commit + surr
    quant_out = project_out(p, z + (quantize - z).detach())       # straight-through
    log_dict = {"commit_loss": commit.detach(),
                "cosine_sim": torch.mean(torch.sum(quantize * z.detach(), dim=-1))}
    return quant_out, loss, log_dict
