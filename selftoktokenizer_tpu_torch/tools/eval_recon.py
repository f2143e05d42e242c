"""Reconstruction quality of a folder of images: encode, decode (the
50-step bf16 decode, or ``--renderer``), then PSNR and SSIM, and rFID and
LPIPS when their weights are given (counterpart of the reference
``tools/eval_recon.py``).

    python -m selftoktokenizer_tpu_torch.tools.eval_recon --data-dir imgs/ \\
        [--pretrained tok.pth --vae-path sd3.pt] [--limit 1000] [--renderer] \\
        [--fid-weights pt_inception.pth|random] [--lpips-weights lpips_vgg.pth|random] \\
        [--device cuda]

``--fid-weights``: a pytorch-fid Inception-V3 state dict (``eval/inception.py``)
or ``random`` (seeded, a plumbing check only); likewise ``--lpips-weights``
(the lpips package's LPIPS(net='vgg') state dict, ``eval/lpips.py``).
``--batch-size`` is global: under ``torchrun --nproc_per_node N`` each rank
takes its slice of the sorted images and batch-size / N rows a step; the
metric sums are all-reduced and the FID moments merged across the ranks
before the result is read. Only full batches run (the remainder is left
out, as in the reference). ``images_per_s`` restarts its clock after the
first batch, which carries the warm-up.

The loop is ``evaluate(pipe, batches, ...)`` over (images, names) batches,
so a caller can drive it with a pipeline of its own.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.distributed as dist

from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG, load_config
from selftoktokenizer_tpu_torch.data.native import to_device
from selftoktokenizer_tpu_torch.parallel import distributed as pdist
from selftoktokenizer_tpu_torch.tools import common
from selftoktokenizer_tpu_torch.utils.io import walk_all_files
from selftoktokenizer_tpu_torch.utils.logging import AverageMeter, Timer
from selftoktokenizer_tpu_torch.utils.metrics import (
    StreamingMoments, frechet_distance, psnr, ssim)

FID_SEED, LPIPS_SEED = 7, 8      # the seeds of the 'random' nets


def build_parser():
    p = argparse.ArgumentParser("eval_recon")
    p.add_argument("--yml-path", default=FLAGSHIP_CONFIG)
    p.add_argument("--pretrained", default=None)
    p.add_argument("--vae-path", default=None)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--data_size", type=int, default=256)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=8,
                   help="global batch size (split over the ranks)")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--renderer", action="store_true")
    p.add_argument("--encode-precision", default="highest",
                   choices=("highest", "high", "default"))
    p.add_argument("--fid-weights", default=None,
                   help="Inception-V3 state dict (.pth, pytorch-fid names) -> rFID; "
                        "'random' for a seeded net")
    p.add_argument("--lpips-weights", default=None,
                   help="LPIPS-VGG state dict (.pth, lpips names) -> LPIPS; "
                        "'random' for a seeded net")
    p.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    return p


def build_eval_nets(fid_weights, lpips_weights, device):
    """(Inception net or None, LPIPS net or None) on ``device`` in fp32
    eval mode, from a ``.pth`` or ``'random'`` each."""
    from selftoktokenizer_tpu_torch.eval import inception as inc
    from selftoktokenizer_tpu_torch.eval import lpips as lp
    from selftoktokenizer_tpu_torch.pipeline.pipeline import load_torch_checkpoint

    def make(spec, module, load, init, seed):
        if spec is None:
            return None
        if spec == "random":
            gen = torch.Generator(device="cpu")
            gen.manual_seed(seed)
            init(module, gen)
        else:
            load(module, load_torch_checkpoint(spec))
        return module.to(device).eval().requires_grad_(False)

    return (make(fid_weights, inc.InceptionV3Pool3(), inc.load_inception_state_dict,
                 inc.init_inception_, FID_SEED),
            make(lpips_weights, lp.LPIPS(), lp.load_lpips_state_dict, lp.init_lpips_,
                 LPIPS_SEED))


@torch.no_grad()
def evaluate(pipe, batches, renderer=False, fid_net=None, lpips_net=None, on_batch=None,
             log=None):
    """Encode and decode every (images NHWC [-1, 1], names) batch and score
    the reconstructions against the inputs. Returns {'n', 'psnr', 'ssim',
    'images_per_s', and 'rfid' / 'lpips' with their nets}; under a process
    group the sums and FID moments of every rank. on_batch(ref01, recon,
    names) sees each batch's inputs and reconstructions in [0, 1]."""
    m_psnr, m_ssim, m_lpips = AverageMeter("psnr"), AverageMeter("ssim"), AverageMeter("lpips")
    fid_real = fid_fake = None
    if fid_net is not None:
        fid_real, fid_fake = StreamingMoments(2048), StreamingMoments(2048)
    timer, warm = Timer(), 0
    for imgs, names in batches:
        x = to_device(imgs, pipe.device)
        b = x.shape[0]
        ids = pipe.encoding(x)
        recon = pipe.decoding_with_renderer(ids) if renderer else pipe.decoding(ids)
        ref01 = (x.float() + 1.0) / 2.0
        m_psnr.update(float(psnr(recon, ref01).sum()) / b, b)
        m_ssim.update(float(ssim(recon, ref01).sum()) / b, b)
        if fid_net is not None:
            fid_real.update(fid_net(ref01))
            fid_fake.update(fid_net(recon))
        if lpips_net is not None:
            m_lpips.update(float(lpips_net(recon, ref01).sum()) / b, b)
        if on_batch is not None:
            on_batch(ref01, recon, names)
        if not warm:
            # the first batch carries the warm-up: restart the clock
            if pipe.device.type == "cuda":
                torch.cuda.synchronize()
            warm, timer = b, Timer()
        if log is not None:
            log(f"[{m_psnr.count}] {m_psnr} {m_ssim}")
    if pipe.device.type == "cuda":
        torch.cuda.synchronize()
    elapsed = timer.elapsed()
    meters = (m_psnr, m_ssim, m_lpips)
    if dist.is_initialized():
        # every rank's sums and counts, and the FID moments, before any
        # check on n (a collective every rank must reach)
        sums = torch.tensor([v for m in meters for v in (m.sum, m.count)], dtype=torch.float64,
                            device=pdist.comm_device())
        dist.all_reduce(sums)
        for i, m in enumerate(meters):
            m.sum, m.count = float(sums[2 * i]), int(sums[2 * i + 1])
        for m in (fid_real, fid_fake) if fid_net is not None else ():
            m.n = int(pdist.allgather_f64(np.float64(m.n)).sum())
            m.s1 = pdist.allgather_f64(m.s1).sum(axis=0)
            m.s2 = pdist.allgather_f64(m.s2).sum(axis=0)
        warm *= pdist.rank_and_world()[1]
    steady = m_psnr.count - warm
    out = {"n": m_psnr.count, "psnr": m_psnr.avg, "ssim": m_ssim.avg,
           # None when only the warm-up batch ran
           "images_per_s": steady / elapsed if steady > 0 else None}
    if fid_net is not None and fid_real.n >= 2:
        mu_r, cov_r = fid_real.mean_cov()
        mu_f, cov_f = fid_fake.mean_cov()
        out["rfid"] = frechet_distance(mu_f, cov_f, mu_r, cov_r)
    if lpips_net is not None:
        out["lpips"] = m_lpips.avg
    return out


def main(argv=None):
    """Run the tool; returns the result dict (printed as a JSON line by
    rank 0)."""
    from selftoktokenizer_tpu_torch.pipeline import SelftokPipeline

    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    pdist.init(backend="gloo" if device.type == "cpu" else None)
    rank, world = pdist.rank_and_world()
    pipe = SelftokPipeline(load_config(args.yml_path), ckpt_path=args.pretrained,
                           vae_path=args.vae_path, datasize=args.data_size, steps=args.steps,
                           decode_dtype=torch.bfloat16, encode_precision=args.encode_precision,
                           device=device)
    paths = walk_all_files(args.data_dir, common.IMAGE_EXT)
    if args.limit:
        paths = paths[:args.limit]
    if args.batch_size % world:
        raise SystemExit(f"--batch-size {args.batch_size} must divide by the {world} ranks")
    bs = args.batch_size // world
    n_steps = (len(paths) // world) // bs
    if n_steps == 0:
        raise SystemExit(f"need at least --batch-size={args.batch_size} images under "
                         f"{args.data_dir}, found {len(paths)}")
    lo, _ = pdist.process_slice(len(paths))
    mine = paths[lo:lo + n_steps * bs]
    fid_net, lpips_net = build_eval_nets(args.fid_weights, args.lpips_weights, device)
    loader = common.choose_loader()
    out = evaluate(pipe, common.file_batches(mine, args.data_size, bs, loader),
                   renderer=args.renderer, fid_net=fid_net, lpips_net=lpips_net,
                   log=print if rank == 0 else None)
    out["loader"] = loader
    if rank == 0:
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
