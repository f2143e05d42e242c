"""The multi-rank dry run (counterpart of the reference's
``__graft_entry__.dryrun_multichip``): one full train step of a tiny
tokenizer (the flow loss, the VQ EMA update, the optimizer) over n ranks,
with the batch split over ``data`` x ``fsdp``, the state sharded by FSDP2
over ``fsdp``, and the decoder split over ``tensor`` when that axis is
wider than one.

    python -m selftoktokenizer_tpu_torch.parallel.dryrun --n 4 --device cpu
    torchrun --standalone --nproc_per_node 4 -m selftoktokenizer_tpu_torch.parallel.dryrun

Without a launcher it starts the n ranks itself: gloo processes on the CPU,
or one NCCL process a card. The mesh follows the reference's rule: 8 ranks
-> (2, 2, 2), 4 -> (2, 2, 1), 2 -> (2, 1, 1).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

# the reference's dry-run tokenizer; its encoder "Enc-Dryrun/2" has the
# widths of the zoo's Enc-Qformer-Uni-Tiny/2 (patch 2, hidden 32, 4 heads,
# depth 2, queries 64 wide in 8 heads, unidirectional)
TINY_PARAMS = {
    "image_size": 64, "k": 8, "stages": "200,400,600,800,1000",
    "k_per_stage": "3,2,1,1,1", "in_channels": 16,
    "encoder_hidden_size": 16, "diffusion_type": "flow",
    "noise_schedule_config": {
        "schedule": "log_norm", "parameterization": "velocity",
        "force_recon": False, "m": 0.0, "s": 1.0},
    "enc": "Enc-Qformer-Uni-Tiny/2", "enable_enc_variable_size": True,
    "encoder_config": {
        "time_adaln": True, "qformer_mode": "dual", "pre_norm": False,
        "post_norm": True, "qk_norm": False, "attn_mask": False},
    "quantizer_config": {
        "codebook_size": 64, "code_dim": 16, "w_diversity": 1.0,
        "ema_entropy_ratio": 0.8, "w_commit": 1.0, "decay": 0.99,
        "dead_code_threshold": 0.2, "reset_cluster_size": 0.2,
        "smart_react": True, "continuous": False, "reg": [0.1, 0.3],
        "K": 8},
    "model": "MMDiT_XL", "context_see_xt": True,
    "decoder_config": {
        "sd3_cond_pooling": "None", "class_dropout_prob": 0.1,
        "train_filter": "all", "freeze_filter": "", "init_method": "None",
        "time_adaln": "pos_emb", "depth": 2, "pos_embed_max_size": 16,
        "num_patches": 256},
}


def tiny_train_mesh_shape(n):
    """(data, fsdp, tensor) of n ranks, every axis the count allows active."""
    tensor = 2 if n % 8 == 0 else 1
    fsdp = 2 if n % 4 == 0 else 1
    return n // (fsdp * tensor), fsdp, tensor


def dryrun_rank(device):
    """This rank's part of the dry run, in an initialized group: the mesh,
    the sharded tiny state, one step over a global batch of 2 x world rows.
    Returns (mesh shape, the step's logs)."""
    import torch.distributed as dist

    from selftoktokenizer_tpu_torch.models.tokenizer import (
        ImageTokenizer, init_weights_, tokenizer_config_from_params)
    from selftoktokenizer_tpu_torch.parallel.mesh import make_mesh
    from selftoktokenizer_tpu_torch.train.trainer import (
        TrainConfig, dp_train_step, make_train_state)

    n = dist.get_world_size()
    shape = tiny_train_mesh_shape(n)
    mesh = make_mesh(*shape)
    tcfg = tokenizer_config_from_params(TINY_PARAMS)
    tc = TrainConfig(dit_lr=1e-5, token_lr=5e-5, grad_norm=1.0)
    with torch.device(device):
        tok = ImageTokenizer(tcfg)
    init_weights_(tok, torch.Generator(device=device).manual_seed(0))
    state = make_train_state(tok, tcfg, tc, mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(1)
    batch = torch.randn((2 * n, 8, 8, 16), generator=gen, device=device)
    state, logs = dp_train_step(state, tcfg, tc, state.sharding.local_rows(batch),
                                rng=torch.Generator(device=device).manual_seed(2))
    loss = float(logs["loss"])
    if state.step != 1 or loss != loss:
        raise RuntimeError(f"dry run: step {state.step}, loss {loss}")
    return shape, logs


def _spawned(rank, n, device, store):
    from selftoktokenizer_tpu_torch.parallel import distributed as pdist

    os.environ["LOCAL_RANK"] = str(rank)
    pdist.init(backend="gloo" if device == "cpu" else "nccl", init_method=f"file://{store}",
               rank=rank, world_size=n)
    try:
        dev = "cpu" if device == "cpu" else f"cuda:{rank}"
        shape, logs = dryrun_rank(dev)
        if rank == 0:
            print(f"dryrun_multichip({n}): mesh {shape}, loss {float(logs['loss']):.6f}, "
                  f"grad norm {float(logs['grad_norm']):.6g}", flush=True)
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multichip(n, device="cuda"):
    """One sharded train step over n ranks. Inside an initialized group of n
    ranks (under ``torchrun``) this rank's part runs; otherwise n ranks are
    started here (``spawn``; device 'cpu': gloo, else one NCCL rank a card)
    and joined."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"dryrun_multichip({n}) in a group of {dist.get_world_size()}")
        return dryrun_rank(device if device == "cpu" else
                           torch.device("cuda", torch.cuda.current_device()))
    if device != "cpu" and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun_multichip({n}): {torch.cuda.device_count()} CUDA devices")
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_spawned, args=(n, device, os.path.join(d, "store")), nprocs=n,
                           start_method="spawn")
    return None


def main(argv=None):
    ap = argparse.ArgumentParser("dryrun")
    ap.add_argument("--n", type=int, default=None,
                    help="ranks (default: the launcher's world size, else 8)")
    ap.add_argument("--device", default="cuda", help="'cpu' to run gloo ranks on the CPU")
    args = ap.parse_args(argv)
    from selftoktokenizer_tpu_torch.parallel import distributed as pdist

    launched = pdist.init(backend="gloo" if args.device == "cpu" else None)
    n = args.n or (pdist.rank_and_world()[1] if launched else 8)
    out = dryrun_multichip(n, args.device)
    if launched:
        shape, logs = out
        if pdist.rank_and_world()[0] == 0:
            print(f"dryrun_multichip({n}): mesh {shape}, loss {float(logs['loss']):.6f}",
                  flush=True)
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
