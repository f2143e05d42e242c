"""The tokenizer's training driver (counterpart of the reference
``tools/train_tokenizer.py``).

    python -m selftoktokenizer_tpu_torch.tools.train_tokenizer --yml-path cfg.yml \\
        (--latents-file lat.npy | --data-dir imgs/ | --synthetic) [--vae-path sd3.pt] \\
        [--steps 1000] [--batch-size 32] [--accum N] [--device cuda]
    torchrun --standalone --nproc_per_node N -m selftoktokenizer_tpu_torch.tools.train_tokenizer ...
        [--mesh-fsdp F]

A step: a batch of latents (a latents file, random latents, or images that
the SD3 VAE encodes on the device in bf16) -> ``train.trainer.train_step``
(the flow loss, the VQ EMA and AdamW), ``train_step_accum`` for ``--accum
N`` (the global batch in N microbatches), or ``dp_train_step`` when
``torchrun`` starts more than one rank (``--batch-size`` is the global
batch; each rank takes its rows, its shards for a tar corpus). With
``--mesh-fsdp F`` the ranks form the mesh (world / F, F, 1) and the train
state is sharded over it with FSDP2 (``parallel.mesh.shard_tokenizer``):
weights, gradients, AdamW moments and the EMA copy are each held in F
shards, evals and reconstructions run on every rank, and a checkpoint is
gathered whole (a run resumes on any mesh). Each step's
draws come from a generator seeded by (config seed, step), so a resumed run
draws what the uninterrupted one drew. The loss stays on the device until a
log line prints it.

Checkpoints (``save_train_state``: weights, AdamW moments, VQ state, EMA
copy, step) go to ``<ckpt-dir>/step_N`` every ``--ckpt-interval`` steps
and, with ``--save-per-epochs``, at epoch ends; ``--resume-from-steps N``
continues from one. ``--eval-interval`` decodes the held-out rows of the
latents file (the last ``--eval-batch``) with a ``--eval-steps`` sampler,
for the live and the EMA weights, and ``--eval-image-space`` decodes those
latents through the trained VAE that the file's ``.meta.json`` names and
scores them against the corpus images (with the VAE's own ceiling at step
0). ``--metrics-out`` appends one JSON line per log interval and per eval;
the last line of standard output is ``{"final_loss", "steps"}``.

The reference's ``--pretrained`` is left out: it parses it and never reads
it. ``--mesh-fsdp`` must divide the number of ranks (``make_mesh`` raises
``ValueError`` otherwise, in one process for any F above 1);
``--donate-state`` changes nothing (a PyTorch step updates the state in
place).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG
from selftoktokenizer_tpu_torch.tools import common
from selftoktokenizer_tpu_torch.tools import train_data as td

# the labels of the config seed's uses (common.generator)
STEP_STREAM = 2
EVAL_NOISE = 424242
RECON_NOISE = 9000


def build_parser():
    p = argparse.ArgumentParser("train_tokenizer")
    p.add_argument("--yml-path", default=FLAGSHIP_CONFIG)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--vae-path", default=None)
    p.add_argument("--data_size", type=int, default=256)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--dit-lr", type=float, default=1e-5)
    p.add_argument("--token-lr", type=float, default=5e-5)
    p.add_argument("--grad-norm", type=float, default=0.0)
    p.add_argument("--ema-decay", type=float, default=0.0)
    p.add_argument("--warmup", type=int, default=0)
    p.add_argument("--lr-schedule", default="constant",
                   choices=["constant", "cosine", "linear"],
                   help="post-warmup LR decay to --end-lr-ratio * lr at --steps "
                        "(TrainConfig.schedule)")
    p.add_argument("--end-lr-ratio", type=float, default=0.1)
    p.add_argument("--log-interval", type=int, default=10)
    p.add_argument("--ckpt-interval", type=int, default=1000)
    p.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "selftok_ckpt"))
    p.add_argument("--resume-from-steps", type=int, default=0,
                   help="resume from <ckpt-dir>/step_N (reference resume_from_steps)")
    p.add_argument("--resume-exclude-opt", action="store_true",
                   help="drop the saved optimizer moments on resume (resume_exclude_opt)")
    p.add_argument("--save-per-epochs", type=int, default=0,
                   help="also checkpoint every N data epochs (save_per_epochs)")
    p.add_argument("--recon-interval", type=int, default=0,
                   help="save a decoded sample of the batch's first row every N steps")
    p.add_argument("--synthetic", action="store_true",
                   help="random latents instead of images (speed and development runs)")
    p.add_argument("--latents-file", default=None,
                   help="float32 .npy latents [N,h,w,16] (gen_corpus --latents-out, "
                        "encode_corpus); no VAE encode per step")
    p.add_argument("--metrics-out", default=None,
                   help="append one JSON line per log interval (and per eval)")
    p.add_argument("--eval-interval", type=int, default=0,
                   help="every N steps (and once at the start), diffusion-decode the last "
                        "--eval-batch rows of --latents-file (held out of training) and "
                        "record the latent MSE and SNR. Requires --latents-file")
    p.add_argument("--eval-steps", type=int, default=25,
                   help="Euler steps of the --eval-interval decode")
    p.add_argument("--eval-batch", type=int, default=16)
    p.add_argument("--eval-image-space", action="store_true",
                   help="also VAE-decode the held-out recons and report image PSNR / SSIM "
                        "against the corpus images; needs a --latents-file from "
                        "encode_corpus (its .meta.json names the trained VAE and the "
                        "latent normalisation); saves GT / recon PNG pairs at step 0 and "
                        "at the last eval")
    p.add_argument("--data-seed", type=int, default=None,
                   help="shuffling: per-epoch rows of a latents file, or for .tar corpora "
                        "the global shard shuffle and the sample shuffle buffer, "
                        "deterministic given (seed, epoch); None keeps the order")
    p.add_argument("--shuffle-buffer", type=int, default=1000,
                   help="sample shuffle-buffer size (with --data-seed)")
    p.add_argument("--resume-skip-exact", action="store_true",
                   help="the resume skip drains DECODED full batches (pays the decode of "
                        "the skipped prefix; exact when members fail to decode). The "
                        "default skips raw members without decoding them: exact only when "
                        "every member decodes")
    p.add_argument("--accum", type=int, default=1,
                   help="--batch-size is the GLOBAL batch, split into N sequential "
                        "microbatches with one VQ statistics / EMA apply per step "
                        "(train_step_accum)")
    p.add_argument("--mesh-fsdp", type=int, default=1,
                   help="FSDP width: the ranks form the mesh (world / N, N, 1) and the train "
                        "state is sharded N ways")
    p.add_argument("--donate-state", action="store_true",
                   help="accepted for the reference's command lines; PyTorch already "
                        "updates the train state in place")
    p.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    return p


def build_tokenizer(tcfg, seed, device):
    """The ImageTokenizer on ``device`` with the reference's init (zero
    adaLN and biases), drawn from generator(device, seed)."""
    from selftoktokenizer_tpu_torch.models.tokenizer import ImageTokenizer, init_weights_

    with torch.device(device):
        tok = ImageTokenizer(tcfg)
    init_weights_(tok, common.generator(device, seed))
    return tok


def load_vae(vae_path, seed, device):
    """(bf16 SD3 VAE on device, VAEConfig): a reference .pt / .safetensors
    (optional ``first_stage_model.`` prefix), else the seeded VAE."""
    from selftoktokenizer_tpu_torch.models.vae import vae_from_state_dict
    from selftoktokenizer_tpu_torch.utils.io import load_state_dict_file

    if vae_path:
        sd = load_state_dict_file(vae_path)
        p = "first_stage_model."
        if any(k.startswith(p) for k in sd):
            sd = {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
        vae = vae_from_state_dict(sd)
        cfg = vae.cfg
    else:
        vae, cfg = common.seeded_vae(seed)
    return common.bf16_vae(vae, device), cfg


@contextlib.contextmanager
def swapped_weights(module, tensors):
    """Run the block with the module's parameters of those names holding
    ``tensors`` ({name: tensor}, an EMA copy): the values are exchanged in
    place and back, one leaf at a time (a sharded parameter's storage is
    FSDP2's, so its values move and not its storage)."""
    named = dict(module.named_parameters())

    @torch.no_grad()
    def swap():
        for k, e in tensors.items():
            p = named[k].detach()
            tmp = p.clone()
            p.copy_(e)
            e.copy_(tmp)
    swap()
    try:
        yield
    finally:
        swap()


class StepClock:
    """CUDA events around each step (none on the CPU): the device's busy
    share of the loop and the warm step rate, read once at the end."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.events = []
        self.t0 = time.perf_counter()

    @contextlib.contextmanager
    def step(self):
        if not self.cuda:
            yield
            return
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        yield
        ev[1].record()
        self.events.append(ev)

    def summary(self):
        """{wall_s, device_busy_share, warm_steps_per_s} (None where not
        measured). The warm rate spans the end of the first step to the end
        of the last (evals and checkpoints between steps included)."""
        if self.cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        out = {"wall_s": wall, "device_busy_share": None, "warm_steps_per_s": None}
        if self.events:
            busy = sum(a.elapsed_time(b) for a, b in self.events) / 1e3
            span = self.events[0][0].elapsed_time(self.events[-1][1]) / 1e3
            out["device_busy_share"] = busy / span if span > 0 else None
            if len(self.events) > 1:
                warm = self.events[0][1].elapsed_time(self.events[-1][1]) / 1e3
                out["warm_steps_per_s"] = (len(self.events) - 1) / warm
        return out


def scalar_logs(logs):
    """The scalar entries of a step's logs as floats (a host sync)."""
    return {k: float(v) for k, v in logs.items()
            if isinstance(v, (int, float)) or getattr(v, "ndim", 1) == 0}


def image_eval(meta_path, rows, device):
    """(score(pred_latents) -> (psnr, ssim, images), gt images): the
    held-out corpus images of latent rows ``rows`` and the trained VAE of
    an ``encode_corpus`` sidecar; pred latents are un-normalised with the
    sidecar's shift and scale and decoded in bf16."""
    from selftoktokenizer_tpu_torch.models.vae import vae_decode
    from selftoktokenizer_tpu_torch.pipeline.preprocess import load_image
    from selftoktokenizer_tpu_torch.train.vae import load_vae_params
    from selftoktokenizer_tpu_torch.utils.io import walk_all_files
    from selftoktokenizer_tpu_torch.utils.metrics import psnr, ssim

    with open(meta_path) as f:
        meta = json.load(f)
    vae, vcfg = load_vae_params(meta["vae_ckpt"])
    vae = common.bf16_vae(vae, device)
    paths = walk_all_files(meta["images_dir"], common.IMAGE_EXT)[rows]
    gt = torch.from_numpy(np.concatenate([load_image(q, meta["size"]) for q in paths])).to(device)
    sh, sc = meta["shift"], meta["scale"]

    @torch.no_grad()
    def score(pred):
        raw = pred / sc + sh
        img = torch.clamp(vae_decode(vae, vcfg, raw.to(torch.bfloat16)).float(), -1, 1)
        a, b = (gt + 1) / 2, (img + 1) / 2
        return torch.mean(psnr(a, b)), torch.mean(ssim(a, b)), img
    return score, gt


def save_pair(gt, img, path):
    """GT row over recon row, the first 8 of each, as one PNG."""
    from selftoktokenizer_tpu_torch.pipeline.preprocess import save_image

    pair = torch.cat([torch.clamp(gt[:8], -1, 1), img[:8]], dim=1)
    grid = torch.cat(list(pair), dim=1)
    save_image((grid + 1) / 2, path)


def decode_sampler(tcfg, steps):
    """(schedule, per-step token counts) of a ``steps``-step uniform Euler
    decode."""
    from selftoktokenizer_tpu_torch.models import flow as flow_mod

    sched = flow_mod.make_schedule(steps, 1.0, "uniform")
    return sched, flow_mod.precompute_step_k(tcfg.make_diti(), sched)


@torch.no_grad()
def diffusion_decode(tok, tcfg, ehs, noise, sched, step_k, context_see_xt):
    """The Euler decode of latents from the encoder's context ``ehs``."""
    from selftoktokenizer_tpu_torch.models import flow as flow_mod
    from selftoktokenizer_tpu_torch.models.mmdit import mmdit_apply

    def mfn(xx, tt, e, m):
        return mmdit_apply(tok.model, tcfg.decoder, xx, tt, e, mask=m,
                           context_see_xt=context_see_xt)
    return flow_mod.p_sample_loop(mfn, sched, noise, ehs, step_k=step_k, K=tcfg.k)


def make_stream(args, seed, device, passes, world):
    """(stream(skip) -> batches, rows_are_local, held-out eval latents or
    None, the latents array or None)."""
    from selftoktokenizer_tpu_torch.utils.io import walk_all_files

    B = args.batch_size
    if args.latents_file:
        lat = np.load(args.latents_file, mmap_mode="r")
        if lat.ndim != 4 or lat.shape[-1] != 16:
            raise ValueError(f"{args.latents_file}: latents [N,h,w,16] expected, got {lat.shape}")
        n_eval = args.eval_batch if args.eval_interval else 0
        n_train = lat.shape[0] - n_eval
        if n_train < B:
            raise ValueError(f"{n_train} training latents < batch {B}")
        eval_lat = np.array(lat[n_train:], np.float32) if n_eval else None
        common.log(f"latents: {lat.shape} from {args.latents_file} "
                   f"({n_train} train / {n_eval} held-out eval)")
        return (lambda skip: td.latents_stream(lat, n_train, B, args.data_seed, passes, skip),
                False, eval_lat, lat)
    if args.synthetic or not args.data_dir:
        return (lambda skip: td.synthetic_stream(B, args.data_size // 8, skip=skip),
                False, None, None)

    vae, vcfg = load_vae(args.vae_path, seed, device)

    def encode(imgs):
        return common.encode_to_latents(vae, vcfg, imgs, device)
    loader = common.choose_loader()
    shards = walk_all_files(args.data_dir, (".tar",))
    if shards:
        common.log(f"tar shards: {len(shards)} (global), loader {loader}")
        local = B // world
        return (lambda skip: td.tar_stream(
            shards, args.data_size, local, loader, encode, passes, data_seed=args.data_seed,
            shuffle_buffer=args.shuffle_buffer, exact=args.resume_skip_exact, skip=skip),
            world > 1, None, None)
    paths = walk_all_files(args.data_dir, common.IMAGE_EXT)
    if not paths:
        raise SystemExit(f"no images or .tar shards in {args.data_dir}")
    return (lambda skip: td.folder_stream(paths, args.data_size, B, loader, encode, passes,
                                          skip=skip, what=args.data_dir),
            False, None, None)


def train(args):
    """The training loop. Returns {'final_loss', 'steps', 'timing': ...}."""
    from selftoktokenizer_tpu_torch.core.config import load_config
    from selftoktokenizer_tpu_torch.models.encoder import encoder_apply
    from selftoktokenizer_tpu_torch.models.tokenizer import tokenizer_config_from_params
    from selftoktokenizer_tpu_torch.parallel import distributed as pdist
    from selftoktokenizer_tpu_torch.parallel.mesh import make_mesh
    from selftoktokenizer_tpu_torch.train import trainer
    from selftoktokenizer_tpu_torch.utils.logging import AverageMeter

    device = common.resolve_device(args.device)
    pdist.init(backend="gloo" if device.type == "cpu" else None)
    rank, world = pdist.rank_and_world()
    mesh = None
    if args.mesh_fsdp != 1 or world > 1:
        mesh = make_mesh(data=world // args.mesh_fsdp, fsdp=args.mesh_fsdp)
        common.log(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} over {world} ranks")
    if device.type == "cuda" and world > 1:
        device = torch.device("cuda", torch.cuda.current_device())

    cfg = load_config(args.yml_path)
    tcfg = tokenizer_config_from_params(dict(cfg.tokenizer.params))
    seed = cfg.common.get("random_seed", 123)
    tc = trainer.TrainConfig(dit_lr=args.dit_lr, token_lr=args.token_lr,
                             warmup_steps=args.warmup, grad_norm=args.grad_norm,
                             ema_decay=args.ema_decay, schedule=args.lr_schedule,
                             end_lr_ratio=args.end_lr_ratio, max_steps=args.steps)
    # FSDP shards the state; a data-only mesh keeps it whole on every rank
    state = trainer.make_train_state(build_tokenizer(tcfg, seed, device), tcfg, tc,
                                     mesh=mesh if args.mesh_fsdp > 1 else None)
    sharded = state.sharding is not None
    start = 0
    if args.resume_from_steps:
        ck = os.path.join(args.ckpt_dir, f"step_{args.resume_from_steps}")
        state = trainer.restore_train_state(ck, state, exclude_opt=args.resume_exclude_opt)
        start = state.step
        if start != args.resume_from_steps:
            raise AssertionError(f"checkpoint {ck} is at step {start}")
        common.log(f"resumed from {ck} (step {start}, exclude_opt={args.resume_exclude_opt})")

    passes = td.Passes()
    stream, rows_local, eval_lat, lat = make_stream(args, seed, device, passes, world)
    if start >= args.steps:
        raise AssertionError(f"--resume-from-steps {start} >= --steps {args.steps}: nothing to do")
    if args.eval_interval and eval_lat is None:
        raise AssertionError("--eval-interval requires --latents-file")
    if args.batch_size % (args.accum * world):
        raise AssertionError(f"--batch-size {args.batch_size} is not a multiple of "
                             f"--accum {args.accum} x {world} ranks")

    def step_fn(st, batch, rng):
        if world > 1:
            local = batch if rows_local else pdist.local_rows(batch)
            return trainer.dp_train_step(st, tcfg, tc, local, n_micro=args.accum, rng=rng)
        if args.accum > 1:
            return trainer.train_step_accum(st, tcfg, tc, batch, args.accum, rng=rng)
        return trainer.train_step(st, tcfg, tc, batch, rng=rng)

    emit = common.metrics_writer(args.metrics_out if rank == 0 else None)
    ckpt_dir = args.ckpt_dir

    eval_x = score = gt = None
    if args.eval_interval:
        sched, step_k = decode_sampler(tcfg, args.eval_steps)
        eval_x = torch.from_numpy(eval_lat).to(device)
        if args.eval_image_space:
            n_rows = lat.shape[0] - args.eval_batch
            score, gt = image_eval(args.latents_file + ".meta.json",
                                   slice(n_rows, n_rows + args.eval_batch), device)
    elif args.eval_image_space:
        raise AssertionError("--eval-image-space requires --latents-file and --eval-interval")

    @torch.no_grad()
    def eval_once(x0):
        noise = torch.randn(x0.shape, generator=common.generator(device, seed, EVAL_NOISE),
                            device=device)

        def decode(tok):
            ehs, _ = encoder_apply(tok.encoder, tcfg.encoder, x0)
            return diffusion_decode(tok, tcfg, ehs, noise, sched, step_k, tcfg.context_see_xt)
        pred = state.model.run(decode)
        mse = torch.mean((pred - x0) ** 2)
        return mse, 10.0 * torch.log10(torch.var(x0, unbiased=False) / mse), pred

    def run_eval(at_step):
        tracks = [("", None)]
        if state.ema_params is not None:
            # the EMA copy includes the codebook: encode and decode both run
            # on the lagged weights
            tracks.append(("_ema", state.ema_params))
        rec = {"step": at_step}
        for tag, params in tracks:
            with swapped_weights(state.model, params) if params else contextlib.nullcontext():
                mse, snr, pred = eval_once(eval_x)
            rec[f"eval_latent_mse{tag}"] = float(mse)
            rec[f"eval_latent_snr_db{tag}"] = float(snr)
            msg = (f"eval{tag} @ {at_step}: latent mse={float(mse):.4f} snr={float(snr):.2f} dB "
                   f"({args.eval_steps}-step decode, B={len(eval_x)})")
            if score is not None:
                ps, ss, img = score(pred)
                rec[f"eval_image_psnr_db{tag}"] = float(ps)
                rec[f"eval_image_ssim{tag}"] = float(ss)
                msg += f" | image PSNR={float(ps):.2f} dB SSIM={float(ss):.4f}"
                if tag == "" and at_step in (0, args.steps) and rank == 0:
                    os.makedirs(ckpt_dir, exist_ok=True)
                    out = os.path.join(ckpt_dir, f"imgrecon_{at_step}.png")
                    save_pair(gt, img, out)
                    common.log(f"GT/recon pair -> {out}")
                if tag == "" and at_step == 0:
                    # the VAE's ceiling: the ground-truth latents decoded, the
                    # best any tokenizer can do through this VAE
                    cps, css, _ = score(eval_x)
                    rec["vae_ceiling_psnr_db"] = float(cps)
                    rec["vae_ceiling_ssim"] = float(css)
                    msg += f" | VAE ceiling {float(cps):.2f} dB / {float(css):.4f}"
            common.log(msg)
        emit(rec)

    recon_vae = None
    if args.recon_interval:
        recon_vae = load_vae(args.vae_path, seed, device)

    def save_recon(batch, i):
        """A decoded sample of the batch's first row, written by rank 0 (a
        sharded model decodes on every rank)."""
        from selftoktokenizer_tpu_torch.models.vae import SD3LatentFormat, vae_decode
        from selftoktokenizer_tpu_torch.pipeline.preprocess import save_image

        x0 = batch[:1]
        sch, sk = decode_sampler(tcfg, 8)
        noise = torch.randn(x0.shape, generator=common.generator(device, seed, RECON_NOISE + i),
                            device=device)

        def decode(tok):
            ehs, _ = encoder_apply(tok.encoder, tcfg.encoder, x0)
            return diffusion_decode(tok, tcfg, ehs, noise, sch, sk, True)
        with torch.no_grad():
            lat8 = state.model.run(decode)
            if rank != 0:
                return
            vae, vcfg = recon_vae
            img = vae_decode(vae, vcfg, SD3LatentFormat.process_out(lat8).to(torch.bfloat16))
            img = (torch.clamp(img.float(), -1, 1) + 1) / 2
        os.makedirs(ckpt_dir, exist_ok=True)
        save_image(img, os.path.join(ckpt_dir, f"recon_{i + 1}.png"))

    meter = AverageMeter("loss")
    pending = []
    logs = None
    clock = StepClock(device)
    # realign the deterministic data stream with the uninterrupted run
    batch_iter = td.with_epoch_flags(stream(start), passes)
    if args.eval_interval and start == 0:
        run_eval(0)    # the untrained baseline the curves start from
    for i in range(start, args.steps):
        nxt, epoch_done = next(batch_iter)
        batch = nxt.to(device) if torch.is_tensor(nxt) else torch.from_numpy(nxt).to(device)
        with clock.step():
            state, logs = step_fn(state, batch, common.generator(device, seed, STEP_STREAM, i))
        # the loss stays on the device: a float() per step would wait for
        # the step and serialise the launches
        pending.append(logs["loss"])
        if (i + 1) % args.log_interval == 0:
            for lv in pending:
                meter.update(float(lv))
            pending.clear()
            sps = (i + 1 - start) / (time.perf_counter() - clock.t0)
            sc = scalar_logs(logs)
            common.log(f"step {i + 1}: loss={meter.avg:.4f} dm_mse={sc['dm_mse']:.4f} "
                       f"perplexity={sc.get('vq_perplexity', float('nan')):.1f} "
                       f"{sps:.2f} steps/s")
            emit({"step": i + 1, "loss_avg": meter.avg, "steps_per_s": sps,
                  "epoch": passes.n, **sc})
            meter.reset()
        if args.eval_interval and (i + 1) % args.eval_interval == 0:
            run_eval(i + 1)
        hit_interval = args.ckpt_interval and (i + 1) % args.ckpt_interval == 0
        hit_epoch = args.save_per_epochs and epoch_done is not None \
            and epoch_done % args.save_per_epochs == 0
        if (hit_interval or hit_epoch) and (rank == 0 or sharded):
            # a sharded state is gathered on every rank, written by rank 0
            if rank == 0:
                os.makedirs(ckpt_dir, exist_ok=True)
            trainer.save_train_state(os.path.join(ckpt_dir, f"step_{i + 1}"), state,
                                     write=rank == 0)
        if args.recon_interval and (i + 1) % args.recon_interval == 0 and (rank == 0 or sharded):
            save_recon(batch, i)
    return {"final_loss": meter.avg or float(logs["loss"]), "steps": args.steps,
            "timing": clock.summary(), "state": state}


def main(argv=None):
    """Run the driver; returns the dict of ``train`` (the train state under
    'state')."""
    res = train(build_parser().parse_args(argv))
    print(json.dumps({"final_loss": res["final_loss"], "steps": res["steps"]}), flush=True)
    return res


if __name__ == "__main__":
    main()
