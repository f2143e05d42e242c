"""Sharded training of the port: the FSDP and tensor-parallel layout against
the JAX package's rule at the flagship widths, and the sharded step on four
gloo ranks against the JAX package's single-device step.

(a) No processes: the port's tokenizer built on the meta device from
``configs/flagship-256.yml``, the JAX tree's shapes from ``jax.eval_shape``
of the same config values. For axis sizes (2, 2, 2) every parameter's FSDP,
TP and TP+FSDP placement (as FSDP2 and ``parallel.tp`` apply it) equals
what ``fsdp_shardings``, ``mmdit_tp_shardings`` and ``tp_fsdp_shardings``
give the matching JAX leaf, found through ``core/convert.py``'s name map and
transposes. The exceptions are named: FSDP2 shards every leaf, so a leaf
JAX keeps whole is sharded (their share of the bytes is held under 1 %).
Every leaf of at least 2^20 elements is sharded, and a rank holds at most
the total / shards x 1.10 (as tests/test_sharding.py asserts for JAX).

(b) Four gloo ranks (one spawn, ``run_ranks``), meshes (1, 2, 2) and
(2, 2, 1): two ``dp_train_step``s of the tiny tokenizer from the JAX
package's seeded tree with JAX's own draws, each held against JAX's
single-device ``train_step_accum(n_micro = data x fsdp)`` on the global
batch (computed here in a thread while the ranks run) and against the
port's unsharded ``train_step``, with tests/test_torch_distributed.py's
tolerances (loss rtol 1e-4, parameters rtol 2e-4 / atol 2e-5, VQ state
1e-6 against the port; JAX's VQ state within 1e-5 of its scale, as
tests/test_torch_accum.py holds it). After each step the whole parameters
and VQ states are bit-equal on every rank. A checkpoint saved sharded
restores unsharded to the same tensors and sharded again to the same
state.

(c) On the same spawn, the decoder split over ``tensor`` = 4 (the tiny
decoder at depth 4: 4 heads) equals JAX's ``mmdit_apply`` on the whole weights at
tests/test_tp.py's 2e-5.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selftoktokenizer_tpu.core.config import load_config as j_load_config
from selftoktokenizer_tpu.models import mmdit as j_mmdit
from selftoktokenizer_tpu.models import tokenizer as j_tok
from selftoktokenizer_tpu.models import vq as j_vq
from selftoktokenizer_tpu.parallel.mesh import fsdp_shardings, make_mesh as j_make_mesh
from selftoktokenizer_tpu.parallel.tp import mmdit_tp_shardings, tp_fsdp_shardings
from selftoktokenizer_tpu.train import trainer as j_trainer
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG
from selftoktokenizer_tpu_torch.models import tokenizer as t_tok
from selftoktokenizer_tpu_torch.parallel import mesh as pmesh
from tests.torch_port_helpers import (
    TINY, encoder_tables, jax_step_draws, jax_tree, mmdit_tables, run_ranks, seeded_tree)

AXES = {"data": 2, "fsdp": 2, "tensor": 2}


# ---------------------------------------------------------------------------
# (a) the layout at the flagship widths
# ---------------------------------------------------------------------------

def _probe(tree, specs, axis):
    """Each JAX leaf as a zero-stride float64 marker: uid * 2^20, plus the
    index along the leaf's axis sharded on ``axis`` (when its spec has one),
    so that after conversion the port leaf tells which JAX leaf it came
    from and along which of its axes the JAX-sharded one went."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    spec_of = dict(jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.NamedSharding))[0])
    leaves, paths = [], []
    for uid, (path, leaf) in enumerate(flat):
        spec = tuple(spec_of[path].spec) + (None,) * (len(leaf.shape) - len(spec_of[path].spec))
        v = np.float64(uid * 2 ** 20)
        if axis in spec:
            d = spec.index(axis)
            idx = np.arange(leaf.shape[d], dtype=np.float64).reshape(
                [-1 if i == d else 1 for i in range(len(leaf.shape))])
            leaves.append(np.broadcast_to(v + idx, leaf.shape))
        else:
            leaves.append(np.broadcast_to(v, leaf.shape))
        paths.append((path, leaf.shape, spec))
    return jax.tree_util.tree_unflatten(treedef, leaves), paths


def _port_axes(tree, specs, axis, tcfg, monkeypatch):
    """{port name: (JAX leaf path, JAX shape, the port axis the JAX leaf's
    ``axis``-sharded axis became, or None, or 'depth' where JAX shards the
    stacking axis that the port keeps per block)}."""
    probe, paths = _probe(tree, specs, axis)
    monkeypatch.setattr(convert, "_t", lambda a: a)    # keep the views: no copy
    sd = convert.tokenizer_state_dict(probe, tcfg)
    out = {}
    for name, a in sd.items():
        a = np.asarray(a)
        first = a[(0,) * a.ndim]
        path, jshape, jspec = paths[int(first) >> 20]
        moved = None
        for d in range(a.ndim):
            last = tuple(a.shape[d] - 1 if i == d else 0 for i in range(a.ndim))
            if a[last] != first:
                moved = d
        if moved is None and axis in jspec:
            moved = "depth"          # the stacking axis, unstacked by the converter
        out[name] = (path, jshape, moved)
    return out


@pytest.fixture(scope="module")
def flagship():
    params = j_load_config(FLAGSHIP_CONFIG).to_dict()["tokenizer"]["params"]
    jtc = j_tok.tokenizer_config_from_params(params)
    ttc = t_tok.tokenizer_config_from_params(params)
    shapes = jax.eval_shape(lambda k: j_tok.tokenizer_init(k, jtc), jax.random.PRNGKey(0))
    with torch.device("meta"):
        tok = t_tok.ImageTokenizer(ttc)
    assert ttc.decoder.hidden_size == 1536 and ttc.decoder.depth == 24
    mesh = j_make_mesh(jax.devices()[:8], data=2, fsdp=2, tensor=2)
    fsdp_tree = fsdp_shardings(mesh, shapes)
    tp_tree = dict(fsdp_tree)
    tp_tree["model"] = mmdit_tp_shardings(mesh, shapes["model"])
    tp_fsdp_tree = dict(fsdp_tree)
    tp_fsdp_tree["model"] = tp_fsdp_shardings(mesh, shapes["model"])
    return ttc, shapes, tok, {"fsdp": fsdp_tree, "tp": tp_tree, "tp_fsdp": tp_fsdp_tree}


@pytest.mark.parametrize("layout", ["fsdp", "tp", "tp_fsdp"])
def test_flagship_layout_equals_the_jax_rule(flagship, layout, monkeypatch):
    ttc, shapes, tok, trees = flagship
    specs = trees[layout]
    tp = layout != "fsdp"
    fs, ts = AXES["fsdp"], AXES["tensor"]
    rule = pmesh.tokenizer_layout(tok, fs, ts, tp)
    lin = pmesh.linear_weights(tok)
    by_t = _port_axes(shapes, specs, "tensor", ttc, monkeypatch)
    by_f = _port_axes(shapes, specs, "fsdp", ttc, monkeypatch)
    named = dict(tok.named_parameters())
    assert set(named) == set(rule) == set(by_f)
    total = mine = forced = 0
    forced_names = []
    for name, p in named.items():
        shape, n = tuple(p.shape), p.numel()
        t_dim, f_rule = rule[name]
        f_dim = None
        if layout != "tp":
            local = tuple(s // ts if d == t_dim else s for d, s in enumerate(shape))
            f_dim = pmesh.fsdp2_dim(local, fs, f_rule, name in lin)
        jt, jf = by_t[name][2], by_f[name][2]
        assert t_dim == jt, (layout, name, shape, t_dim, by_t[name])
        if layout != "tp":
            if f_dim != jf:
                # FSDP2 shards every leaf: a leaf the rule keeps whole, as
                # JAX does, is sharded all the same
                assert f_rule is None and jf in (None, "depth"), (layout, name, shape, f_dim,
                                                                  by_f[name])
                forced += n
                forced_names.append(name)
            else:
                assert f_rule == jf or f_rule is None, (layout, name, f_rule, jf)
        factor = (ts if t_dim is not None else 1) * (fs if f_dim is not None else 1)
        if n >= 2 ** 20 and layout != "tp":
            assert factor > 1, (layout, name, shape)
        total += n
        mine += -(-n // factor)
    div = {"fsdp": 2, "tp": 1, "tp_fsdp": 4}[layout]
    if layout != "tp":
        assert mine <= total / div * 1.10, (layout, mine / total)
    assert forced <= 0.01 * total, (layout, forced / total, forced_names[:10])
    print(f"{layout}: a rank holds {mine / total:.4f} of {total} elements; FSDP2 shards "
          f"{len(forced_names)} leaves JAX keeps whole ({forced / total:.2e} of the bytes)")


def test_layout_rule_ties_follow_the_reference_axis_order():
    # a square linear weight: JAX's [in, out] takes its first axis (in),
    # the port's [out, in] its second
    assert pmesh.fsdp_dim((256, 256), 2, transposed=True) == 1
    assert pmesh.fsdp_dim((256, 256), 2) == 0
    assert pmesh.fsdp_dim((100, 50), 2) is None or pmesh.fsdp_dim((100, 50), 2) == 0
    assert pmesh.fsdp_dim((127, 1024), 2) == 1 and pmesh.fsdp_dim((1024, 127), 4) == 0
    assert pmesh.fsdp_dim((4097, 5), 2) is None                # largest axis does not divide
    assert pmesh.fsdp_dim((64, 64), 2) is None                 # below 2^14
    assert pmesh.fsdp2_dim((64, 63), 2, None) == 0
    assert pmesh.fsdp2_dim((63, 64), 2, None) == 1
    assert pmesh.fsdp2_dim((63,), 2, None) == 0                # padded by FSDP2
    assert pmesh.tp_fsdp_dims((4608, 1536), 2, 2, 0, True) == (0, 1)
    assert pmesh.tp_fsdp_dims((4608,), 2, 2, 0) == (0, None)


# ---------------------------------------------------------------------------
# (b) and (c): four gloo ranks
# ---------------------------------------------------------------------------

WORKER = r'''
import copy
import os
import sys
import time

import numpy as np
import torch

torch.set_num_threads(1)
from selftoktokenizer_tpu_torch.core.config import load_config
from selftoktokenizer_tpu_torch.models.mmdit import MMDiT, mmdit_apply
from selftoktokenizer_tpu_torch.models.tokenizer import ImageTokenizer, tokenizer_config_from_params
from selftoktokenizer_tpu_torch.parallel import distributed as pdist
from selftoktokenizer_tpu_torch.parallel.mesh import make_mesh
from selftoktokenizer_tpu_torch.parallel.tp import apply_tp
from selftoktokenizer_tpu_torch.train import trainer as tr

rank, world, init_method, inputs, ref_dir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                             sys.argv[4], sys.argv[5])
assert pdist.init(backend="gloo", init_method=init_method, rank=rank, world_size=world)
data = torch.load(inputs, weights_only=True)
tcfg = tokenizer_config_from_params(dict(load_config(data["config"]).tokenizer.params))
FIELDS = ("embed", "cluster_size", "embed_avg", "timestep_p_over_c", "count")
tc = tr.TrainConfig(**data["tc"])


def wait_for(path):
    deadline = time.monotonic() + 100
    while not os.path.exists(path):
        if os.path.exists(os.path.join(ref_dir, "failed")) or time.monotonic() > deadline:
            raise SystemExit(f"no JAX reference {path}")
        time.sleep(0.2)
    return torch.load(path, weights_only=True)


def close(got, want, what, rtol=2e-4, atol=2e-5):
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {n}")


def fresh(mesh=None):
    tok = ImageTokenizer(tcfg)
    tok.load_state_dict(data["state_dict"])
    return tr.make_train_state(tok, tcfg, tc, mesh=mesh)


# the ranks' steps first, held against JAX at the end, when its compiles are done
held = {}
for shape in ((1, 2, 2), (2, 2, 1)):
    tag = "x".join(map(str, shape))
    mesh = make_mesh(*shape)
    state, ref = fresh(mesh), fresh()
    for i, (batch, draws) in enumerate(zip(data["batches"], data["draws"])):
        state, l_s = tr.dp_train_step(state, tcfg, tc, state.sharding.local_rows(batch),
                                      **dict(draws))
        ref, l_r = tr.train_step(ref, tcfg, tc, batch, **dict(draws))
        tree = tr.train_state_tree(state)
        what = f"mesh {tag} step {i}"
        # against the port's unsharded step
        close(tree["params"], ref.model.state_dict(), f"{what} vs train_step")
        for f in FIELDS:
            np.testing.assert_allclose(tree["vq_state"][f].float().numpy(),
                                       getattr(ref.vq_state, f).float().numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{what} vs train_step: {f}")
        np.testing.assert_allclose(float(l_s["loss"]), float(l_r["loss"]), rtol=1e-4, err_msg=what)
        np.testing.assert_allclose(float(l_s["grad_norm"]), float(l_r["grad_norm"]), rtol=1e-4,
                                   err_msg=what)
        np.testing.assert_array_equal(l_s["ids"].numpy(), l_r["ids"].numpy(), err_msg=what)
        held[(shape, i)] = (tree["params"], float(l_s["loss"]), tree["vq_state"]["embed"])
        # every rank holds the same bits
        mine = torch.cat([v.reshape(-1) for v in tree["params"].values()]
                         + [tree["vq_state"][f].float().reshape(-1) for f in FIELDS])
        every = pdist.all_gather_rows(mine[None])
        assert all(torch.equal(every[0], every[r]) for r in range(world)), f"{what}: ranks differ"
        print(f"rank {rank} mesh {tag} step {i}: loss {float(l_s['loss']):.6f} vs train_step ok",
              flush=True)

    # a checkpoint saved sharded restores unsharded, and sharded again
    path = os.path.join(ref_dir, f"ckpt_{tag}")
    tr.save_train_state(path, state, write=rank == 0)
    torch.distributed.barrier()
    plain = tr.restore_train_state(path, fresh())
    for n, p in plain.model.named_parameters():
        assert torch.equal(p.detach(), tree["params"][n]), n
    want = tree["opt_state"]["state"]
    got = plain.opt.state_dict()["state"]
    assert set(got) == set(want)
    for i in want:
        for k in want[i]:
            assert torch.equal(got[i][k], want[i][k]), (i, k)
    assert plain.step == state.step == 2
    assert all(torch.equal(getattr(plain.vq_state, f), tree["vq_state"][f]) for f in FIELDS)
    again = tr.train_state_tree(tr.restore_train_state(path, fresh(mesh)))
    for n, v in tree["params"].items():
        assert torch.equal(again["params"][n], v), n
    for i in want:
        for k in want[i]:
            assert torch.equal(again["opt_state"]["state"][i][k], want[i][k]), (i, k)
    print(f"rank {rank} mesh {tag} checkpoint ok", flush=True)
    torch.distributed.barrier()

# (c) the decoder split over tensor = 4
mesh = make_mesh(1, 1, 4)
tp_cfg = tokenizer_config_from_params(data["tp_params"]).decoder
m = MMDiT(tp_cfg)
m.load_state_dict(data["tp_state_dict"])
apply_tp(m, mesh.get_group("tensor"))
with torch.no_grad():
    out = mmdit_apply(m, tp_cfg, *data["tp_inputs"], context_see_xt=True)
jx = wait_for(os.path.join(ref_dir, "jax_tp.pt"))
np.testing.assert_allclose(out.numpy(), jx.numpy(), rtol=2e-5, atol=2e-5)
print(f"rank {rank} tensor-parallel forward ok", flush=True)

# (b) against JAX's single-device accumulated step
for (shape, i), (params, loss, embed) in held.items():
    what = f"mesh {'x'.join(map(str, shape))} step {i}"
    jx = wait_for(os.path.join(ref_dir, f"jax_{shape[0] * shape[1]}.pt"))
    close(params, jx["params"][i], f"{what} vs JAX")
    np.testing.assert_allclose(loss, jx["loss"][i], rtol=1e-4, err_msg=f"{what} vs JAX")
    want = jx["embed"][i].numpy()
    assert np.abs(embed.numpy() - want).max() <= 1e-5 * np.abs(want).max(), what
    print(f"rank {rank} {what}: vs JAX ok", flush=True)
torch.distributed.destroy_process_group()
'''

JAX_TC = dict(dit_lr=1e-5, token_lr=1e-5, grad_norm=1.0)


def _jax_steps(tree, jtc, ttc, batches, keys, n_micro, path):
    """JAX's single-device train_step_accum(n_micro) over the batches, from
    the seeded tree: {'params': [state dict a step], 'loss', 'embed'};
    written to path + '.tmp' and renamed, so a rank never reads half a
    file."""
    import os

    jtcfg = j_trainer.TrainConfig(**JAX_TC)
    jp = jax_tree(tree)
    opt = j_trainer.make_optimizer(jp, jtcfg)
    state = j_trainer.TokenizerTrainState(
        params=jp, opt_state=opt.init(jp),
        vq_state=j_vq.vq_state_init(jp["encoder"]["quantizer"], jtc.k), ema_params=None,
        step=jnp.zeros((), jnp.int32))
    step = jax.jit(lambda s, b, r: j_trainer.train_step_accum(s, opt, jtc, jtcfg, b, r,
                                                              n_micro=n_micro))
    out = {"params": [], "loss": [], "embed": []}
    for b, k in zip(batches, keys):
        state, logs = step(state, jnp.asarray(b), k)
        out["params"].append(convert.tokenizer_state_dict(
            jax.tree_util.tree_map(np.asarray, state.params), ttc))
        out["loss"].append(float(logs["loss"]))
        out["embed"].append(torch.from_numpy(np.array(state.vq_state.embed)))
    torch.save(out, f"{path}.tmp")
    os.replace(f"{path}.tmp", path)


def _jax_tp_forward(tree, cfg, inputs, path):
    import os

    x, t, ehs, mask = (jnp.asarray(a.numpy()) for a in inputs)
    want = jax.jit(lambda p: j_mmdit.mmdit_apply(p, cfg, x, t, ehs, mask=mask,
                                                 context_see_xt=True))(jax_tree(tree))
    torch.save(torch.from_numpy(np.array(want)), f"{path}.tmp")
    os.replace(f"{path}.tmp", path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One four-rank run of the worker above; the JAX references computed
    meanwhile in threads of this process. Returns the ranks' outputs."""
    tmp = tmp_path_factory.mktemp("sharded")
    params = j_load_config(TINY).to_dict()["tokenizer"]["params"]
    jtc = j_tok.tokenizer_config_from_params(params)
    ttc = t_tok.tokenizer_config_from_params(params)
    tree = seeded_tree(lambda k: j_tok.tokenizer_init(k, jtc), 7,
                       {**encoder_tables(jtc.encoder, ("encoder",)),
                        **mmdit_tables(jtc.decoder, ("model",))})
    rng = np.random.default_rng(7)
    batches = [rng.standard_normal((8, 8, 8, 16)).astype(np.float32) for _ in range(2)]
    keys = [jax.random.fold_in(jax.random.PRNGKey(11), i) for i in range(2)]
    # (c): the tiny decoder at depth 4, hidden 256: 4 heads of 64
    tp_params = {**params, "decoder_config": {**params["decoder_config"], "depth": 4}}
    tp_jcfg = j_tok.tokenizer_config_from_params(tp_params).decoder
    assert tp_jcfg.num_heads == 4
    tp_tree = seeded_tree(lambda k: j_mmdit.mmdit_init(k, tp_jcfg), 8, mmdit_tables(tp_jcfg))
    tp_tcfg = t_tok.tokenizer_config_from_params(tp_params).decoder
    B = 2
    tp_inputs = [torch.from_numpy(rng.standard_normal((B, 8, 8, 16)).astype(np.float32)),
                 torch.tensor([0.3, 0.8]),
                 torch.from_numpy(rng.standard_normal((B, 8, 16)).astype(np.float32)),
                 torch.tensor([[True] * 8, [True] * 5 + [False] * 3])]
    torch.save({"config": TINY, "tc": JAX_TC,
                "state_dict": convert.tokenizer_from_jax_tree(tree, ttc).state_dict(),
                "batches": [torch.from_numpy(b) for b in batches],
                "draws": [jax_step_draws(k, ttc, b.shape) for k, b in zip(keys, batches)],
                "tp_params": tp_params,
                "tp_state_dict": convert.mmdit_from_jax_tree(tp_tree, tp_tcfg).state_dict(),
                "tp_inputs": tp_inputs}, tmp / "inputs.pt")
    failed = []

    def reference(fn, *args):
        try:
            fn(*args)
        except BaseException as e:       # the ranks stop waiting; raised below
            failed.append(e)
            (tmp / "failed").touch()

    # data x fsdp of the two meshes, each compiled in a thread of its own
    ths = [threading.Thread(target=reference, args=(
        _jax_steps, tree, jtc, ttc, batches, keys, n_micro, str(tmp / f"jax_{n_micro}.pt")))
        for n_micro in (2, 4)]
    ths.append(threading.Thread(target=reference, args=(
        _jax_tp_forward, tp_tree, tp_jcfg, tp_inputs, str(tmp / "jax_tp.pt"))))
    for th in ths:
        th.start()
    try:
        outs = run_ranks(WORKER, tmp, world=4, timeout=120, args=(tmp / "inputs.pt", tmp))
    finally:
        for th in ths:
            th.join()
    if failed:
        raise failed[0]
    return outs


@pytest.mark.parametrize("mesh", ["1x2x2", "2x2x1"])
def test_sharded_steps_equal_jax_and_the_unsharded_step(ranks, mesh):
    for r, out in enumerate(ranks):
        for i in range(2):
            assert f"rank {r} mesh {mesh} step {i}: loss" in out, out
            assert f"rank {r} mesh {mesh} step {i}: vs JAX ok" in out, out


@pytest.mark.parametrize("mesh", ["1x2x2", "2x2x1"])
def test_sharded_checkpoint_restores_unsharded(ranks, mesh):
    for r, out in enumerate(ranks):
        assert f"rank {r} mesh {mesh} checkpoint ok" in out, out


def test_tensor_parallel_forward_equals_jax(ranks):
    for r, out in enumerate(ranks):
        assert f"rank {r} tensor-parallel forward ok" in out, out


# ---------------------------------------------------------------------------
# the training driver: --mesh-fsdp 2 on four ranks
# ---------------------------------------------------------------------------

TOOL_WORKER = """
import json, sys
import torch
torch.set_num_threads(1)
from selftoktokenizer_tpu_torch.parallel import distributed as pdist
from selftoktokenizer_tpu_torch.tools import train_tokenizer
rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
pdist.init(backend="gloo", init_method=init, rank=rank, world_size=world)
argv = json.loads(sys.argv[4])
argv[argv.index("--ckpt-dir") + 1] += f"/rank{rank}"
res = train_tokenizer.main(argv + ["--device", "cpu"])
assert res["state"].sharding is not None
print("RESULT", json.dumps({"loss": res["final_loss"], "step": res["state"].step}))
"""


def _tool_argv(lat, tmp_path, extra):
    return ["--yml-path", TINY, "--data_size", "64", "--batch-size", "4", "--latents-file", lat,
            "--data-seed", "1", "--steps", "3", "--log-interval", "1", "--ckpt-interval", "3",
            "--ema-decay", "0.9", "--eval-interval", "3", "--eval-batch", "2", "--eval-steps", "2",
            "--ckpt-dir", str(tmp_path / "ck")] + extra


def test_train_tokenizer_mesh_fsdp_on_four_ranks(tmp_path):
    """``--mesh-fsdp 2`` under four gloo ranks (mesh (2, 2, 1)): the run, its
    EMA evals included, equals the one-process ``--accum 4`` run, only rank
    0 writes the (whole) checkpoint, and one process resumes from it."""
    import contextlib
    import io
    import json
    import os

    from selftoktokenizer_tpu_torch.tools import train_tokenizer

    lat = str(tmp_path / "lat.npy")
    np.save(lat, np.random.default_rng(4).standard_normal((14, 8, 8, 16)).astype(np.float32))
    outs = run_ranks(TOOL_WORKER, tmp_path, world=4, timeout=120,
                     args=(json.dumps(_tool_argv(lat, tmp_path, ["--mesh-fsdp", "2"])),))
    res = [json.loads(o.split("RESULT", 1)[1]) for o in outs]
    assert all(r == res[0] for r in res) and res[0]["step"] == 3
    assert "mesh: {'data': 2, 'fsdp': 2, 'tensor': 1} over 4 ranks" in outs[0]
    assert "eval_ema @ 3:" in outs[0]
    assert os.path.exists(tmp_path / "ck" / "rank0" / "step_3")
    assert not any(os.path.exists(tmp_path / "ck" / f"rank{r}") for r in (1, 2, 3))
    (tmp_path / "one").mkdir()
    with contextlib.redirect_stdout(io.StringIO()):
        one = train_tokenizer.main(_tool_argv(lat, tmp_path / "one",
                                              ["--accum", "4", "--device", "cpu"]))
        # the sharded step's loss tolerance: FSDP2 sums the ranks' gradients
        # in another order than the microbatch loop, and Adam turns that
        # rounding into moves of up to lr
        np.testing.assert_allclose(res[0]["loss"], one["final_loss"], rtol=1e-4)
        one["state"].release()
        resumed = train_tokenizer.main(
            _tool_argv(lat, tmp_path, ["--ckpt-dir", str(tmp_path / "ck" / "rank0"),
                                       "--resume-from-steps", "3", "--steps", "4",
                                       "--accum", "4", "--device", "cpu"]))
    assert resumed["state"].step == 4
