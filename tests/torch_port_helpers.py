"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded numpy weights handed to both sides, conversions between the
two frameworks' arrays, and a pair of pipelines (JAX, port) with one set of
weights."""

import numpy as np
import torch

TINY = "tests/data/tiny-eval.yml"

# the suite runs several workers side by side and these tests are small: two
# threads a worker keep PyTorch's CPU pool from oversubscribing the cores
torch.set_num_threads(2)


def to_np(a):
    """jax / torch array -> numpy float32 (bf16 upcast)."""
    if torch.is_tensor(a):
        return a.detach().float().cpu().numpy() if a.is_floating_point() \
            else a.detach().cpu().numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "f" or a.dtype.name == "bfloat16" else a


def jax_tree(tree):
    """Numpy parameter tree -> the same tree with jax array leaves."""
    import jax.numpy as jnp

    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(jax_tree(v) for v in tree)
    return jnp.asarray(tree)


def seeded_tree(init_fn, seed, tables=()):
    """A parameter tree with the structure and shapes of ``init_fn(key)`` (a
    JAX ``*_init`` closed over its config; only traced with ``jax.eval_shape``,
    never run) and every weight a seeded numpy normal, NON-ZERO everywhere.

    The inits zero every adaLN projection, every bias and the MMDiT pos_embed;
    zero adaLN gates switch every attention off and would hide a wrong
    attention from every end-to-end comparison. So: biases, adaLN weights and
    the other small leaves get std 0.02; norm scales 1 + 0.1 n; the codebook
    is l2-normalised; matrices and conv kernels get std 1/sqrt(fan_in).
    ``tables`` maps a path such as ("encoder", "pos_embed") to the array of a
    sincos table, which is a buffer and no weight.
    """
    import jax

    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    tables = dict(tables)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path) for v in node)
        if path in tables:
            table = np.asarray(tables[path], np.float32)
            assert table.shape == tuple(node.shape), (path, table.shape, node.shape)
            return table
        name, parent = path[-1], path[-2] if len(path) > 1 else ""
        n = rng.standard_normal(node.shape).astype(np.float32)
        if name == "embed":
            return n / np.linalg.norm(n, axis=-1, keepdims=True)
        if name in ("scale", "weight"):
            return 1.0 + 0.1 * n
        if name == "w" and parent != "adaLN":
            # [in, out], depth-stacked [depth, in, out], or conv [kh, kw, in, out]
            fan_in = node.shape[-2] if n.ndim < 4 else int(np.prod(node.shape[:-1]))
            return n / np.sqrt(fan_in)
        return 0.02 * n

    return walk(shapes, ())


def encoder_tables(cfg, prefix=()):
    """The encoder's sincos pos_embed, as its init builds it."""
    from selftoktokenizer_tpu.ops.posembed import sincos_2d

    grid = cfg.pos_embed_max_size or cfg.input_size // cfg.patch_size
    return {prefix + ("pos_embed",): sincos_2d(cfg.hidden_size, grid)[None]}


def mmdit_tables(cfg, prefix=()):
    """The MMDiT's sincos context_pos_embed, as its init builds it."""
    from selftoktokenizer_tpu.ops.posembed import sincos_1d

    base = 1000 + 8 * np.arange(cfg.K) if cfg.diti_positions else np.arange(cfg.K)
    return {prefix + ("context_pos_embed",):
            sincos_1d(cfg.context_dim, base.astype(np.float32))[None]}


def add_ln_qk_norm(tree, cfg, seed):
    """Add the per-head LayerNorm leaves of qk-norm 'ln' ({'scale', 'bias'}
    under 'ln_q' / 'ln_k', seeded) to every dismantled block of an MMDiT
    tree, in place: the JAX package's ``_qkv_split`` reads them, but its
    ``mmdit_init`` makes them only for 'rms'."""
    rng = np.random.default_rng(seed + 500)
    hd = cfg.hidden_size // cfg.num_heads

    def leaves(lead):
        return {"scale": 1.0 + 0.1 * rng.standard_normal(lead + (hd,)).astype(np.float32),
                "bias": 0.02 * rng.standard_normal(lead + (hd,)).astype(np.float32)}

    for group, lead in (("joint_blocks", (cfg.depth - 1,)), ("last_block", ())):
        for blk in tree[group].values():
            blk["ln_q"], blk["ln_k"] = leaves(lead), leaves(lead)
    return tree


def assert_images_close(got, want):
    """The VAE decodes in bf16 on both sides, and XLA and PyTorch round at
    different places: each side's bf16 image lies up to 0.035 from its own
    fp32 image with these weights, single pixels further. So: within 5e-2
    for all but one pixel value in a thousand, and none beyond 1e-1."""
    d = np.abs(to_np(got) - to_np(want))
    assert np.quantile(d, 0.999) <= 5e-2 and d.max() <= 1e-1, (np.quantile(d, 0.999), d.max())


def pipeline_pair(cfg_dict, steps, seed, decode_dtype=torch.float32, datasize=64,
                  tree_hook=None):
    """(jax pipeline, port pipeline) with one set of seeded weights and a
    narrow VAE (ch=32) on both sides. decode_dtype: torch.float32,
    torch.bfloat16 or 'int8'. The JAX pipeline casts and quantizes its
    decoder in its constructor, before the weights are swapped in here, so
    the unconditional buffers its config names are loaded again, and the
    cast to bf16 and ``quantize_params_tree`` are repeated on the swapped-in
    tree, after the context adaLN table is computed in fp32 (the order of
    both constructors). tree_hook(tree, tokenizer_config) may edit the
    seeded tree in place before either side takes it."""
    import functools
    from unittest import mock

    import jax
    import jax.numpy as jnp

    import selftoktokenizer_tpu.pipeline.pipeline as j_pipeline_mod
    from selftoktokenizer_tpu.core import convert as j_cv
    from selftoktokenizer_tpu.core.config import AttrDict as JAttrDict
    from selftoktokenizer_tpu.models import vae as j_vae
    from selftoktokenizer_tpu.models.mmdit import precompute_context_mods
    from selftoktokenizer_tpu.models.tokenizer import tokenizer_init
    from selftoktokenizer_tpu.ops.q8_matmul import quantize_params_tree
    from selftoktokenizer_tpu.pipeline import SelftokPipeline as JaxPipeline
    from selftoktokenizer_tpu_torch.core import convert
    from selftoktokenizer_tpu_torch.core.config import AttrDict
    from selftoktokenizer_tpu_torch.models.vae import VAEConfig
    from selftoktokenizer_tpu_torch.pipeline import SelftokPipeline

    def zeros_like_init(init_fn):
        # the JAX constructor draws random weights that are replaced below:
        # give it zero trees of the right shapes, which cost no compile
        def fn(key, cfg, *a, **kw):
            shapes = jax.eval_shape(lambda k: init_fn(k, cfg, *a, **kw), key)
            return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
        return fn

    # the JAX pipeline builds VAEConfig() itself: hand it the narrow one
    with mock.patch.object(j_pipeline_mod, "VAEConfig",
                           functools.partial(j_vae.VAEConfig, ch=32)), \
            mock.patch.object(j_pipeline_mod, "tokenizer_init", zeros_like_init(tokenizer_init)), \
            mock.patch.object(j_pipeline_mod, "vae_init", zeros_like_init(j_vae.vae_init)):
        jpipe = JaxPipeline(JAttrDict(cfg_dict), datasize=datasize, steps=steps,
                            decode_dtype={torch.float32: jnp.float32,
                                          torch.bfloat16: jnp.bfloat16}.get(decode_dtype, decode_dtype))
    assert jpipe.vae_cfg.ch == 32
    tc = jpipe.tcfg
    vae_tree = seeded_tree(lambda k: j_vae.vae_init(k, jpipe.vae_cfg), seed)
    tok_tree = seeded_tree(
        lambda k: tokenizer_init(k, tc), seed + 1,
        {**encoder_tables(tc.encoder, ("encoder",)), **mmdit_tables(tc.decoder, ("model",))})
    if tree_hook is not None:
        tree_hook(tok_tree, tc)
    jpipe.vae_params = jax_tree(vae_tree)
    jpipe.params = jax_tree(tok_tree)
    jpipe.params["model"].update(jax_tree(j_cv.load_uncond_buffers(tc.decoder)))
    jpipe._ctx_mods = precompute_context_mods(jpipe.params["model"], tc.decoder)
    if decode_dtype != torch.float32:
        jpipe.params["model"] = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.bfloat16), jpipe.params["model"])
    if decode_dtype == "int8":
        jpipe.params["model"] = quantize_params_tree(jpipe.params["model"])

    tpipe = SelftokPipeline(AttrDict(cfg_dict), datasize=datasize, steps=steps, device="cpu",
                            decode_dtype=decode_dtype)
    tpipe.set_weights(convert.tokenizer_from_jax_tree(tok_tree, tpipe.tcfg),
                      convert.vae_from_jax_tree(vae_tree, VAEConfig(ch=32)))
    return jpipe, tpipe


def jax_decode(jpipe, ids, noise, cfg_scale=None, images=True):
    """(latents, images) of the JAX pipeline for given start noise: its
    jitted decode with the final VAE step taken off, then its own
    decode_latents (images None with images=False)."""
    import jax
    import jax.numpy as jnp

    keep = jpipe._latents_to_images
    jpipe._latents_to_images = lambda vp, x: x
    try:
        fn = jax.jit(jpipe._decode_impl, static_argnames=("cfg_scale",))
        lat = fn(jpipe.params, jpipe._ctx_mods, jpipe.vae_params, jnp.asarray(ids),
                 jnp.asarray(noise), cfg_scale=cfg_scale)
        lat = jax.block_until_ready(lat)
    finally:
        jpipe._latents_to_images = keep
    return to_np(lat), to_np(jpipe.decode_latents(lat)) if images else None


def jax_render(jpipe, ids):
    """(latents, images) of the JAX pipeline's one-step renderer, as
    jax_decode does it for the diffusion decode."""
    import jax
    import jax.numpy as jnp

    keep = jpipe._latents_to_images
    jpipe._latents_to_images = lambda vp, x: x
    try:
        lat = jax.block_until_ready(jax.jit(jpipe._render_impl)(
            jpipe.params, jpipe._ctx_mods, jpipe.vae_params, jnp.asarray(ids)))
    finally:
        jpipe._latents_to_images = keep
    return to_np(lat), to_np(jpipe.decode_latents(lat))


def jax_step_draws(key, tcfg, shape):
    """The random draws of the JAX package's ``train_step`` (through
    ``tokenizer_loss``) and ``train_step_accum`` from ``key`` for a global
    batch of ``shape``, as port inputs: both split the key into (t, noise,
    drop, react); the quantizer splits react into (choice, k-means). tcfg:
    the port's TokenizerConfig."""
    import jax
    import jax.numpy as jnp

    r_t, r_noise, r_drop, r_react = jax.random.split(key, 4)
    B, C, n = shape[0], tcfg.encoder.codebook_size, shape[0] * tcfg.k
    d = {"t": jax.random.uniform(r_t, (B,)),
         "noise": jax.random.normal(r_noise, shape, jnp.float32)}
    drop_p = tcfg.decoder.class_dropout_prob
    if drop_p > 0:
        d["drop_ids"] = jax.random.uniform(r_drop, (B,)) < drop_p
    r_choice, r_km = jax.random.split(r_react)
    d["kmeans_idx"] = (jax.random.permutation(r_km, n)[:C] if n >= C
                       else jax.random.randint(r_km, (C,), 0, n))
    d["react_uniforms"] = jax.random.uniform(r_choice, (C,))
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def run_ranks(worker_src, tmp_path, world=2, timeout=120, args=()):
    """Run the Python source ``worker_src`` in ``world`` processes, one a
    rank, with argv [rank, world, init_method, *args]; init_method is a
    FileStore under tmp_path (no port to race for between test workers).
    Each rank's output goes to a file (a full pipe would stall a rank
    inside a collective). Waits at most ``timeout`` seconds in all, then
    kills every rank. Fails unless every rank exits 0; returns their
    outputs."""
    import os
    import subprocess
    import sys
    import time

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "rank_worker.py"
    script.write_text(worker_src)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    init_method = f"file://{tmp_path / 'filestore'}"
    logs = [tmp_path / f"rank{r}.log" for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, str(script), str(r), str(world), init_method,
                     *map(str, args)], cwd=root, env=env, stdout=f, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        timed_out = [p for p in procs if p.poll() is None]
        for p in timed_out:
            p.kill()
        for p in procs:
            p.wait()
    outs = [open(f).read() for f in logs]
    report = "\n".join(f"--- rank {r} (exit {p.returncode}):\n{o}"
                       for r, (p, o) in enumerate(zip(procs, outs)))
    assert not timed_out, f"ranks killed after {timeout} s\n{report}"
    assert all(p.returncode == 0 for p in procs), report
    return outs


def seeded_inception_sd(seed):
    """Every entry of a pytorch-fid Inception3 state dict, seeded: the
    pool3 weights (conv 1.4 n / sqrt(fan_in), BatchNorm statistics and
    affine near their identity) plus the entries the port ignores (fc,
    AuxLogits, num_batches_tracked)."""
    from selftoktokenizer_tpu_torch.eval.inception import InceptionV3Pool3

    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in InceptionV3Pool3().state_dict().items():
        shape = tuple(v.shape)
        n = rng.standard_normal(shape).astype(np.float32)
        if k.endswith("conv.weight"):
            a = 1.4 * n / np.sqrt(np.prod(shape[1:]))
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif k.endswith("bn.weight"):
            a = 1.0 + 0.1 * n
        else:
            a = 0.1 * n
        sd[k] = torch.from_numpy(a.astype(np.float32))
        if k.endswith("running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(100)
    sd["fc.weight"] = torch.zeros(1008, 2048)
    sd["fc.bias"] = torch.zeros(1008)
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    return sd


def seeded_lpips_sd(seed):
    """An lpips-package LPIPS(net='vgg') state dict, seeded, with the
    scaling layer's buffers and the package's ``lins.*`` aliases."""
    from selftoktokenizer_tpu_torch.eval.lpips import LPIPS

    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in LPIPS().state_dict().items():
        shape = tuple(v.shape)
        n = rng.standard_normal(shape).astype(np.float32)
        if k.startswith("scaling_layer."):
            a = v.numpy()
        elif k.startswith("lin"):
            a = np.abs(0.1 * n)
        elif k.endswith("weight"):
            a = 1.4 * n / np.sqrt(np.prod(shape[1:]))
        else:
            a = 0.02 * n
        sd[k] = torch.from_numpy(np.asarray(a, np.float32))
    for i in range(5):
        sd[f"lins.{i}.model.1.weight"] = sd[f"lin{i}.model.1.weight"]
    return sd
