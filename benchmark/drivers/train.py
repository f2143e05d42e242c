"""The tokenizer's training step: ``train/trainer.py::train_step`` over
``make_train_state`` (the encoder, the VQ's k-means, EMA and reactivation,
the MMDiT's flow-matching loss with its attention forward and backward
kernels, AdamW), one step a call on fresh rows.

Set-up builds one train state from the seeded weights and drives it through
the first ``checked_steps`` steps with the window's own call and feed,
recording each step's loss, the first gradient as the optimizer holds it
(its first moment over 1 - b1) and each leaf's change over those steps;
the window then goes on with the same state. The check runs the reference
through the same steps from the same weights, rows and draws.

Driver options: ``tf32`` (False: fp32 with TF32 off, the configuration's;
True: the control), ``checked_steps``.
"""

from __future__ import annotations

import gc
import statistics

import torch

from benchmark.harness import traffic as traffic_mod
from benchmark.harness import weights, yardstick
from benchmark.reference import mmdit as ref_mmdit
from benchmark.reference import train as ref_train
from benchmark.reference.nn import exact_fp32


def _set_tf32(on):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


class Driver:
    def __init__(self, cell, seed, device, overrides=None):
        from selftoktokenizer_tpu_torch.models.tokenizer import (
            tokenizer_config_from_params, tokenizer_from_state_dict)
        from selftoktokenizer_tpu_torch.train import trainer

        self.cell, self.seed, self.device = cell, seed, device
        self.cfg = cell.config
        self.opts = dict(cell.options["driver_options"], **(overrides or {}))
        self.images_per_call = cell.traffic["batch"]
        _set_tf32(self.opts["tf32"])
        self.tcfg = tokenizer_config_from_params(self.cfg["tokenizer_params"])
        sd = {k: v.clone() for k, v in weights.tokenizer_weights(
            self.cfg, seed, device, decoder=torch.float32).items()}
        tok, _ = tokenizer_from_state_dict(sd, self.tcfg)
        del sd
        t = self.cfg["train"]
        self.tc = trainer.TrainConfig(dit_lr=t["dit_lr"], token_lr=t["token_lr"], b1=t["b1"],
                                      b2=t["b2"], weight_decay=t["weight_decay"], grad_norm=0.0,
                                      ema_decay=0.0, warmup_steps=0)
        self.state = trainer.make_train_state(tok.to(device), self.tcfg, self.tc)
        self._train_step = trainer.train_step
        self.steps = 0
        self.attention = {}          # call -> [(kind, B, H, Lq, Lk, D, item, active keys)]
        self.record = {}

    # --------------------------------------------------------------- feed

    def draws(self, step):
        """The step's rows and draws from (seed, step): t, drop_ids and the
        quantizer's draws on the host, noise and rows on the device."""
        cfg, B = self.cfg, self.images_per_call
        C, N = cfg["codebook_size"], B * cfg["K"]
        g = torch.Generator()
        g.manual_seed((int(self.seed) * 1_000_003 + int(step)) * 4 + 1)
        t = torch.rand((B,), generator=g)
        drop = torch.rand((B,), generator=g) < cfg["tokenizer_params"]["decoder_config"]["class_dropout_prob"]
        host = {"t": t, "drop_ids": drop,
                "kmeans_idx": torch.randint(0, N, (C,), generator=g),
                "react_uniforms": torch.rand((C,), generator=g)}
        x = traffic_mod.latents(self.cell.traffic, cfg, self.seed, step, self.device)
        g2 = torch.Generator(device=self.device)
        g2.manual_seed((int(self.seed) * 1_000_003 + int(step)) * 4 + 2)
        noise = torch.randn(x.shape, generator=g2, device=self.device)
        d = {k: v.to(self.device, non_blocking=True) for k, v in host.items()}
        d["noise"] = noise
        return x, d, host

    def _account(self, call, host):
        """The attention calls of a step: per block one forward and one
        backward over [B, H, L, L], each row's active keys its active
        context tokens (none for a dropped row) and every latent token."""
        cfg, d = self.cfg, self.cfg["decoder"]
        B, K = self.images_per_call, cfg["K"]
        n_x = (cfg["image_size"] // 8 // d["patch_size"]) ** 2
        k = ref_mmdit.diti_indices(cfg["diti"], K, torch.clamp(host["t"], 0, 1.0) * 1000.0)
        dropped = host["drop_ids"] & (host["t"] * 1000.0 != 1000.0)
        nk = int(torch.where(dropped, 0, k.long() + 1).sum()) + B * n_x
        L, H = K + n_x, d["num_heads"]
        case = (B, H, L, L, d["hidden_size"] // H, 4, nk)
        self.attention[call] = [("fwd",) + case, ("bwd",) + case] * d["depth"]

    def _step(self):
        x, d, host = self.draws(self.steps)
        _, logs = self._train_step(self.state, self.tcfg, self.tc, x, **d)
        self._account(self.steps, host)
        self.steps += 1
        return logs

    # ------------------------------------------------------------- window

    def warm(self):
        """The first ``checked_steps`` steps, with what the check compares
        recorded after them."""
        n = self.opts["checked_steps"]
        model = self.state.model
        names = [name for name, p in model.named_parameters() if p.requires_grad]
        losses = []
        for s in range(n):
            losses.append(float(self._step()["loss"]))
            if s == 0:
                b1 = self.tc.b1
                params = dict(model.named_parameters())
                opt = self.state.opt.state
                grad = {name: float(torch.linalg.vector_norm(opt[params[name]]["exp_avg"]))
                        / (1 - b1) if "exp_avg" in opt.get(params[name], {}) else 0.0
                        for name in names}
        self.record = {"losses": losses, "grad": grad,
                       "change": _change_norms(dict(model.named_parameters()), self.cfg,
                                               self.seed, self.device)}
        if self.device != "cpu":
            torch.cuda.synchronize()

    def call(self, i):
        self._step()

    def work(self):
        """A step's model FLOPs (three times the forward, fp32-exact) and the
        attention calls of every call made, by call."""
        if self.opts["tf32"]:
            return None
        return {"flops": {"fp32": yardstick.train_flops(self.cfg, self.images_per_call)},
                "attention_by_call": self.attention}

    def release(self):
        self.state.release()
        self.state = None
        gc.collect()
        _set_tf32(False)
        if self.device != "cpu":
            torch.cuda.empty_cache()

    # -------------------------------------------------------------- check

    def check(self):
        """The reference's first ``checked_steps`` steps in fp32 with TF32
        off, from the same weights, rows and draws. Compared, each against
        the program's record:

        * ``loss_rel_gap``: the gap of the first step's loss, over the
          reference's (the later steps' gaps, in the information, swing with
          the VQ's argmax near its ties);
        * ``grad_norm_gap``: the worst leaf's gap between the norms of the
          first gradients, over the larger of the reference leaf's norm and
          the median leaf's;
        * ``change_norm_gap``: the same of each leaf's change over the
          steps, the codebook with them; leaves whose first reference
          gradient is under a thousandth of the median leaf's are left out.
        """
        n = self.opts["checked_steps"]
        cfg = self.cfg
        feed = [self.draws(s) for s in range(n)]
        with exact_fp32():
            losses, first, params = ref_train.run_steps(
                weights.tokenizer_weights(cfg, self.seed, self.device, decoder=torch.float32),
                cfg, [f[0] for f in feed], [f[1] for f in feed], n)
        grad = {name: float(torch.linalg.vector_norm(g)) for name, g in first.items()}
        del first
        change = _change_norms(params, cfg, self.seed, self.device)
        del params
        rec = self.record
        loss_gaps = [abs(a - b) / abs(b) for a, b in zip(rec["losses"], losses)]
        med_g = statistics.median(grad.values())
        grad_gap = max(abs(rec["grad"][k] - grad[k]) / max(grad[k], med_g) for k in grad)
        kept = [k for k in change if k == ref_train.CODEBOOK or grad[k] >= 1e-3 * med_g]
        med_c = statistics.median(change[k] for k in kept)
        gaps = {k: abs(rec["change"][k] - change[k]) / max(change[k], med_c) for k in kept}
        worst = max(gaps, key=gaps.get)
        return ({"loss_rel_gap": loss_gaps[0], "grad_norm_gap": grad_gap,
                 "change_norm_gap": gaps[worst]},
                {"loss_rel_gaps": loss_gaps, "change_norm_gap_median": statistics.median(gaps.values()),
                 "change_norm_gap_worst_leaf": worst,
                 "losses_program": rec["losses"], "losses_reference": losses,
                 "leaves_compared": len(kept), "leaves_left_out": len(change) - len(kept)})


@torch.no_grad()
def _change_norms(params, cfg, seed, device):
    """Each leaf's norm of its change from the seeded weights."""
    start = weights.tokenizer_weights(cfg, seed, device, decoder=torch.float32)
    out = {name: float(torch.linalg.vector_norm(params[name].detach().float() - start[name]))
           for name in start}
    del start
    return out
