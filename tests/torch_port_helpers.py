"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded numpy weights handed to both sides, and conversions between
the two frameworks' arrays."""

import numpy as np
import torch

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
