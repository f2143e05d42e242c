"""The tokenizer's training step, plain fp32 with TF32 off: the encoder, the
cosine VQ with its k-means seeding, EMA statistics, dead-code reactivation
and entropy losses, the flow-matching loss of the MMDiT under the CFG
condition drop, autograd, and AdamW over two groups (the decoder's
``model.*`` leaves and the rest), the EMA codebook written back after each
update.

It takes every draw of a step (t, noise, drop_ids, the k-means start, the
reactivation uniforms) as an input, as the program's step does, and the
configuration's ``quantizer`` and ``train`` groups.
"""

from __future__ import annotations

import torch

from benchmark.reference import encoder as ref_enc
from benchmark.reference import mmdit as ref_mmdit
from benchmark.reference.nn import layer_norm, linear, patchify, center_crop, timestep_mlp

CODEBOOK = "encoder.quantizer._codebook.embed"


def l2norm(t):
    return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)


def _segment_sum(values, ids, n):
    out = torch.zeros((n,) + tuple(values.shape[1:]), dtype=values.dtype, device=values.device)
    return out.index_add_(0, ids, values)


def vq_state(sd, K):
    """The quantizer's fresh EMA state."""
    embed = sd[CODEBOOK][0].detach().float()
    C = embed.shape[0]
    dev = embed.device
    return {"embed": embed.clone(), "cluster_size": torch.zeros(C, device=dev),
            "embed_avg": embed.clone(), "tpc": torch.full((K, C), 1.0 / C, device=dev),
            "count": torch.zeros(C, device=dev), "initted": False, "tpc_initted": False}


def _entropies(ap, onehot_ema, ratio_d, groups=64):
    ema_p = onehot_ema * (1 - ratio_d) + ap * ratio_d
    ent1 = torch.mean(-torch.sum(ema_p * torch.log(ema_p), dim=-1))
    K = ema_p.shape[0]
    g = torch.stack([c.mean(dim=0) for c in torch.tensor_split(ema_p, min(groups, K), dim=0)])
    return ent1, torch.mean(-torch.sum(g * torch.log(g), dim=-1))


def _diversity(ap_k, new_tpc, q):
    C = ap_k.shape[-1]
    ent1, ent2 = _entropies(ap_k, new_tpc, 1.0 - q["ema_entropy_ratio"])
    perp = torch.mean(torch.exp(-torch.sum(new_tpc * torch.log(new_tpc + 1e-10), dim=-1)))
    frac = perp / C
    lo, hi = q["reg"]
    wgt = torch.where(frac < lo, torch.full_like(frac, 0.5),
                      torch.clamp(0.5 - 0.5 / (hi - lo) * (frac - lo), min=0.0))
    return -q["w_diversity"] * wgt * 0.5 * (ent1 + ent2)


def quantize(p, state, outs, q, kmeans_idx, react_uniforms, kmeans_iters=10):
    """The training quantizer: (straight-through codes [B, K, D], loss,
    new state). p: the parameters (``encoder.quantizer.*``)."""
    B, K, _ = outs.shape
    C = state["embed"].shape[0]
    dev = outs.device
    decay = q["decay"]
    z = l2norm(linear(outs, p, "encoder.quantizer.project_in"))
    flat = z.reshape(B * K, -1)
    flat0 = flat.detach()
    N = flat0.shape[0]
    ones = torch.ones(N, device=dev)
    if not state["initted"]:
        means = flat0[kmeans_idx.long()]
        for _ in range(kmeans_iters):
            buckets = torch.argmax(flat0 @ means.t(), dim=-1)
            bins = _segment_sum(ones, buckets, C)
            new = l2norm(_segment_sum(flat0, buckets, C) / torch.clamp(bins, min=1.0)[:, None])
            means = torch.where((bins == 0)[:, None], means, new)
        embed = means
        prev_cluster = _segment_sum(ones, torch.argmax(flat0 @ embed.t(), dim=-1), C)
        prev_avg = embed * prev_cluster[:, None]
    else:
        embed, prev_cluster, prev_avg = state["embed"], state["cluster_size"], state["embed_avg"]
    embed = embed.detach()
    dist = flat @ embed.t()
    ids = torch.argmax(dist.detach(), dim=-1)
    codes = embed[ids].reshape(B, K, -1)

    kpos = torch.arange(K, device=dev).repeat(B)
    per_pos = _segment_sum(ones, kpos * C + ids, K * C).reshape(K, C)
    tpc_decay = decay if state["tpc_initted"] else 0.3
    new_tpc = state["tpc"] * tpc_decay + per_pos / B * (1 - tpc_decay)
    bins = per_pos.sum(dim=0)
    new_cluster = prev_cluster * decay + bins * (1 - decay)
    new_avg = prev_avg * decay + _segment_sum(flat0, ids, C) * (1 - decay)
    total = torch.sum(new_cluster)
    cs = (new_cluster + 1e-5) / (total + C * 1e-5) * total
    new_embed = l2norm(new_avg / cs[:, None])

    threshold = q["dead_code_threshold"]
    ratio = N / C
    dead = new_cluster < ratio * threshold
    perp = torch.exp(-torch.sum(new_tpc * torch.log(new_tpc + 1e-10), dim=-1))
    w = 1.0 / perp
    w = torch.softmax(w / torch.max(w) * 10.0, dim=0)
    cum = torch.cumsum(w[None, :].expand(B, K).reshape(-1) / B, dim=0)
    cand = l2norm(flat0[torch.searchsorted(cum, cum[-1] * (1 - react_uniforms))])
    reset = ratio * q["reset_cluster_size"]
    new_embed = torch.where(dead[:, None], cand, new_embed)
    new_avg = torch.where(dead[:, None], cand * reset, new_avg)
    new_cluster = torch.where(dead, torch.full_like(new_cluster, reset), new_cluster)

    commit = torch.sum((codes - z) ** 2) / z.numel()
    scaled = (dist * 10.0).reshape(B, K, C)
    lse = torch.logsumexp(scaled, dim=-1)
    ap_k = torch.mean(torch.exp(scaled - lse[..., None]), dim=0)
    loss = q["w_commit"] * commit + _diversity(ap_k, new_tpc, q)
    new_state = {"embed": new_embed, "cluster_size": new_cluster, "embed_avg": new_avg,
                 "tpc": new_tpc, "count": state["count"] + bins, "initted": True,
                 "tpc_initted": True}
    return z + (codes - z).detach(), loss, new_state


def _decoder_velocity(p, cfg, x, t, ehs, mask, drop):
    """The MMDiT's velocity in training: the full context, the dropped rows'
    context zeroed and masked, each context block's table from its own
    leaves."""
    d = cfg["decoder"]
    P = ref_mmdit.P
    pp = d["patch_size"]
    gh, gw = x.shape[1] // pp, x.shape[2] // pp
    xt = patchify(x, p, P + "x_embedder.proj", pp)
    xt = xt + center_crop(p[P + "pos_embed"], d["pos_embed_max_size"], gh, gw)
    c = timestep_mlp(p, P + "t_embedder", t * 1000.0)
    Lc = ehs.shape[1]
    ctx = linear(ehs, p, P + "context_embedder") + p[P + "context_pos_embed"][:, :Lc]
    drop = drop & (t * 1000.0 != 1000.0)
    ctx = torch.where(drop[:, None, None], torch.zeros_like(ctx), ctx)
    mask = mask & ~drop[:, None]
    key_mask = torch.cat([mask, torch.ones(mask.shape[0], xt.shape[1], dtype=torch.bool,
                                           device=mask.device)], dim=1)
    out = ref_mmdit.trunk(p, d, ctx, xt, c, ref_mmdit.context_mods(p, d, Lc), key_mask)
    return ref_mmdit.unpatchify(out, pp, x.shape[-1], gh, gw)


def loss(p, state, cfg, x, draws):
    """(loss, new VQ state) of one step on latents x [B, h, w, C]."""
    K = cfg["K"]
    t = draws["t"]
    k_batch = ref_mmdit.diti_indices(cfg["diti"], K, torch.clamp(t, 0, 1.0) * 1000.0)
    outs = ref_enc.pre_vq(p, cfg["encoder"], x)
    codes, quan_loss, new_state = quantize(p, state, outs, cfg["quantizer"], draws["kmeans_idx"],
                                           draws["react_uniforms"])
    outs_q = layer_norm(codes, p["encoder.final_layer_norm3.weight"],
                        p["encoder.final_layer_norm3.bias"])
    mask = torch.arange(K, device=x.device)[None, :] <= k_batch[:, None]
    ehs = outs_q * mask[..., None].to(outs_q.dtype)
    tt = t.reshape(-1, 1, 1, 1)
    x_t = tt * draws["noise"] + (1 - tt) * x
    v = _decoder_velocity(p, cfg, x_t, t, ehs, mask, draws["drop_ids"])
    mse = torch.mean(((draws["noise"] - x) - v) ** 2, dim=(1, 2, 3))
    return torch.mean(mse) + quan_loss, new_state


class AdamW:
    """torch's AdamW update written out: two groups by learning rate, no
    weight decay unless given, bias-corrected moments."""

    def __init__(self, params, lr_of, b1, b2, eps=1e-8, weight_decay=0.0):
        self.params, self.lr_of = params, lr_of
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.m = {n: torch.zeros_like(t) for n, t in params.items()}
        self.v = {n: torch.zeros_like(t) for n, t in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for n, p in self.params.items():
            g, lr = grads[n], self.lr_of(n)
            p.mul_(1 - lr * self.wd)
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[n].sqrt() / bc2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[n], denom, value=-lr / bc1)


def run_steps(sd, cfg, batches, draws, n_steps):
    """``n_steps`` training steps from the fp32 state dict ``sd`` (copied,
    leaf by leaf): the losses, each trainable leaf's first gradient (every
    leaf but the codebook, which moves by its EMA) and the parameters
    after the steps, the codebook included."""
    tc = cfg["train"]
    params = {}
    for n in list(sd):
        params[n] = sd.pop(n).detach().clone().requires_grad_(n != CODEBOOK)
    train = {n: t for n, t in params.items() if n != CODEBOOK}
    opt = AdamW(train, lambda n: tc["dit_lr"] if n.startswith("model.") else tc["token_lr"],
                tc["b1"], tc["b2"], weight_decay=tc["weight_decay"])
    state = vq_state(params, cfg["K"])
    losses, first = [], None
    for s in range(n_steps):
        value, state = loss(params, state, cfg, batches[s], draws[s])
        grads = torch.autograd.grad(value, list(train.values()), allow_unused=True)
        grads = {n: torch.zeros_like(train[n]) if g is None else g for n, g in zip(train, grads)}
        losses.append(float(value.detach()))
        if first is None:
            first = grads
        opt.step(grads)
        with torch.no_grad():
            params[CODEBOOK][0].copy_(state["embed"])
        del value, grads
    return losses, first, params
