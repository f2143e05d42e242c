"""Data parallelism of the port on the CPU: two gloo ranks, each a
subprocess, joined through a FileStore under the test's tmp_path (no port
to race for between test workers), each test killed after 120 s.

``dp_train_step`` on two ranks: its k-means init step against the JAX
package's ``train_step_accum(n_micro=2)`` on the same weights, batch and
draws (loss and parameters at rtol 1e-5 / atol 1e-6, lr 1e-5 as in
tests/test_torch_accum.py; the VQ codebook within 1e-5 of its scale); then
against ``train_step_accum(n_micro=2)`` and ``train_step`` on the whole
batch, with one and with two microbatches a rank, from the same input state
at every step of a 3-step trajectory that includes the k-means init step,
with the accumulated step's tolerances (VQ state 1e-6, parameters rtol
2e-4 / atol 2e-5, loss rtol 1e-4); after each step the two ranks'
parameters and VQ states are bit-equal; a global batch that does not split
evenly over the ranks is refused on every rank. The weights are the JAX
package's seeded tree carried into the port (``tokenizer_from_jax_tree``),
the draws JAX's own. Also: ``allgather_f64`` is bit-exact,
``process_slice`` / ``local_rows`` / ``all_gather_rows`` give the global
rows in rank order, ``psum_metrics`` averages, the mesh keeps its axis
names, builds any shape whose product is the world size and refuses any
other, and ``init`` raises when cluster variables are set but no group can
form."""

import os
import threading

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selftoktokenizer_tpu.core.config import load_config as j_load_config
from selftoktokenizer_tpu.models import tokenizer as j_tok
from selftoktokenizer_tpu.models import vq as j_vq
from selftoktokenizer_tpu.train import trainer as j_trainer
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.models import tokenizer as t_tok
from tests.torch_port_helpers import (
    TINY, encoder_tables, jax_step_draws, jax_tree, mmdit_tables, run_ranks, seeded_tree)

STEP_WORKER = r'''
import copy
import os
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
from selftoktokenizer_tpu_torch.core.config import load_config
from selftoktokenizer_tpu_torch.models.tokenizer import ImageTokenizer, tokenizer_config_from_params
from selftoktokenizer_tpu_torch.parallel import distributed as pdist
from selftoktokenizer_tpu_torch.parallel.mesh import make_mesh
from selftoktokenizer_tpu_torch.train import trainer as tr

rank, world, init_method, inputs, jax_ref = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                             sys.argv[4], sys.argv[5])
assert pdist.init(backend="gloo", init_method=init_method, rank=rank, world_size=world)
group = make_mesh().get_group("data")
data = torch.load(inputs, weights_only=True)
tcfg = tokenizer_config_from_params(dict(load_config(data["config"]).tokenizer.params))
tok = ImageTokenizer(tcfg)
tok.load_state_dict(data["state_dict"])
tok0 = copy.deepcopy(tok)
FIELDS = ("embed", "cluster_size", "embed_avg", "timestep_p_over_c", "count")
CODEBOOK = "encoder.quantizer._codebook.embed"
tc = tr.TrainConfig(dit_lr=3e-4, token_lr=1e-3, grad_norm=1.0)
state = tr.make_train_state(tok, tcfg, tc)


def agree(a, b, la, lb, what):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(a.vq_state, f).numpy(), getattr(b.vq_state, f).numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=f"{what}: vq_state.{f}")
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=f"{what}: {n}")
    np.testing.assert_allclose(float(la["loss"]), float(lb["loss"]), rtol=1e-4, err_msg=what)
    # Adam's step is blind to a gradient's scale: the norm is not
    np.testing.assert_allclose(float(la["grad_norm"]), float(lb["grad_norm"]), rtol=1e-4,
                               err_msg=what)
    np.testing.assert_array_equal(la["ids"].numpy(), lb["ids"].numpy(), err_msg=what)


for i, (batch, draws) in enumerate(zip(data["batches"], data["draws"])):
    dp, dp2, acc = copy.deepcopy(state), copy.deepcopy(state), copy.deepcopy(state)
    dp, l_dp = tr.dp_train_step(dp, tcfg, tc, pdist.local_rows(batch, group), group=group,
                                **dict(draws))
    dp2, l_dp2 = tr.dp_train_step(dp2, tcfg, tc, pdist.local_rows(batch, group), n_micro=2,
                                  group=group, **dict(draws))
    acc, l_acc = tr.train_step_accum(acc, tcfg, tc, batch, world, **dict(draws))
    state, l_g = tr.train_step(state, tcfg, tc, batch, **dict(draws))
    assert dp.step == dp2.step == acc.step == state.step == i + 1
    agree(dp, acc, l_dp, l_acc, f"step {i}: dp vs accum")
    agree(dp, state, l_dp, l_g, f"step {i}: dp vs whole batch")
    agree(dp2, state, l_dp2, l_g, f"step {i}: dp, two microbatches a rank, vs whole batch")
    assert torch.equal(dp.model.encoder.quantizer.embed, dp.vq_state.embed)
    # every rank holds the same bits
    mine = torch.cat([p.detach().reshape(-1) for p in dp.model.parameters()]
                     + [getattr(dp.vq_state, f).reshape(-1) for f in FIELDS])
    both = pdist.all_gather_rows(mine[None], group)
    assert all(torch.equal(both[0], both[r]) for r in range(world)), f"step {i}: ranks differ"
    print(f"rank {rank} step {i}: loss {float(l_dp['loss']):.6f} ok", flush=True)

# a global batch that does not split evenly: the last rank holds one row more
uneven = torch.randn((2 * world + 1, 8, 8, 16), generator=torch.Generator().manual_seed(0))
local = pdist.local_rows(uneven, group)
assert local.shape[0] == (3 if rank == world - 1 else 2)
with pytest.raises(ValueError, match="split the global batch evenly"):
    tr.dp_train_step(state, tcfg, tc, local, group=group, rng=torch.Generator().manual_seed(1))
assert state.step == len(data["batches"])
print(f"rank {rank} uneven refused", flush=True)

# the k-means init step against the JAX package's accumulated step, which
# the test computes while the ranks run the trajectory above
deadline = time.monotonic() + 90
while not os.path.exists(jax_ref):
    if os.path.exists(jax_ref + ".failed") or time.monotonic() > deadline:
        raise SystemExit("no JAX reference step")
    time.sleep(0.2)
jx = torch.load(jax_ref, weights_only=True)
tc0 = tr.TrainConfig(**jx["tc"])
s0 = tr.make_train_state(tok0, tcfg, tc0)
s0, l0 = tr.dp_train_step(s0, tcfg, tc0, pdist.local_rows(data["batches"][0], group), group=group,
                          **dict(data["draws"][0]))
np.testing.assert_allclose(float(l0["loss"]), jx["loss"], rtol=1e-5, atol=1e-6)
want = jx["embed"].numpy()
assert np.abs(s0.vq_state.embed.numpy() - want).max() <= 1e-5 * np.abs(want).max()
for n, p in s0.model.named_parameters():
    if n != CODEBOOK:       # the VQ state's, held above
        np.testing.assert_allclose(p.detach().numpy(), jx["params"][n].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f"step 0 vs JAX: {n}")
print(f"rank {rank} JAX step ok", flush=True)
torch.distributed.destroy_process_group()
'''


def _jax_accum_step(tree, jtc, ttc, batch, key, path):
    """JAX's accumulated step (n_micro=2) on the first batch and draws, lr
    1e-5 as in tests/test_torch_accum.py (Adam's first update turns a
    gradient's rounding near 0 into up to lr either way); written to
    path + '.tmp' and renamed, so a rank never reads half a file."""
    jtcfg = j_trainer.TrainConfig(dit_lr=1e-5, token_lr=1e-5)
    jp = jax_tree(tree)
    opt = j_trainer.make_optimizer(jp, jtcfg)
    j_state = j_trainer.TokenizerTrainState(
        params=jp, opt_state=opt.init(jp),
        vq_state=j_vq.vq_state_init(jp["encoder"]["quantizer"], jtc.k), ema_params=None,
        step=jnp.zeros((), jnp.int32))
    j_new, j_logs = jax.jit(lambda s, b, r: j_trainer.train_step_accum(
        s, opt, jtc, jtcfg, b, r, n_micro=2))(j_state, jnp.asarray(batch), key)
    torch.save({"tc": dict(vars(jtcfg)), "loss": float(j_logs["loss"]),
                "embed": torch.from_numpy(np.array(j_new.vq_state.embed)),
                "params": convert.tokenizer_state_dict(
                    jax.tree_util.tree_map(np.asarray, j_new.params), ttc)}, f"{path}.tmp")
    os.replace(f"{path}.tmp", path)


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """One two-rank run: the 3-step trajectory, the uneven refusal, then the
    comparison with JAX's step, which this process computes in a thread
    meanwhile (the ranks need not wait for JAX's compile). Returns the
    ranks' outputs."""
    tmp_path = tmp_path_factory.mktemp("dp")
    params = j_load_config(TINY).to_dict()["tokenizer"]["params"]
    jtc = j_tok.tokenizer_config_from_params(params)
    ttc = t_tok.tokenizer_config_from_params(params)
    tree = seeded_tree(lambda k: j_tok.tokenizer_init(k, jtc), 5,
                       {**encoder_tables(jtc.encoder, ("encoder",)),
                        **mmdit_tables(jtc.decoder, ("model",))})
    rng = np.random.default_rng(5)
    batches = [torch.from_numpy(rng.standard_normal((8, 8, 8, 16)).astype(np.float32))
               for _ in range(3)]
    key = jax.random.PRNGKey(3)
    torch.save({"config": TINY,
                "state_dict": convert.tokenizer_from_jax_tree(tree, ttc).state_dict(),
                "batches": batches,
                "draws": [jax_step_draws(jax.random.fold_in(key, i), ttc, tuple(b.shape))
                          for i, b in enumerate(batches)]}, tmp_path / "inputs.pt")
    ref = str(tmp_path / "jax_step0.pt")
    failed = []

    def reference():
        try:
            _jax_accum_step(tree, jtc, ttc, batches[0].numpy(), jax.random.fold_in(key, 0), ref)
        except BaseException as e:       # the ranks stop waiting; raised below
            failed.append(e)
            open(f"{ref}.failed", "w").close()

    th = threading.Thread(target=reference)
    th.start()
    try:
        outs = run_ranks(STEP_WORKER, tmp_path, args=(tmp_path / "inputs.pt", ref))
    finally:
        th.join()
    if failed:
        raise failed[0]
    return outs


def test_dp_train_step_equals_accum_and_whole_batch_step(dp_run):
    for r, out in enumerate(dp_run):
        assert all(f"rank {r} step {i}:" in out for i in range(3)), out
        assert f"rank {r} JAX step ok" in out, out


def test_dp_train_step_refuses_a_global_batch_that_does_not_split(dp_run):
    for r, out in enumerate(dp_run):
        assert f"rank {r} uneven refused" in out, out


HELPERS_WORKER = r'''
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
from selftoktokenizer_tpu_torch.parallel import distributed as pdist
from selftoktokenizer_tpu_torch.parallel import mesh as pmesh

rank, world, init_method = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
assert pdist.init(backend="gloo", init_method=init_method, rank=rank, world_size=world)
assert pdist.init(backend="gloo")            # idempotent
assert pdist.rank_and_world() == (rank, world)

# bit-exact float64, values no float32 holds
mine = np.array([np.pi * (rank + 1), 1e-300, -5e-324 * (rank + 1), 1 / 3 + rank], np.float64)
got = pdist.allgather_f64(mine)
assert got.shape == (world, 4) and got.dtype == np.float64
for r in range(world):
    want = np.array([np.pi * (r + 1), 1e-300, -5e-324 * (r + 1), 1 / 3 + r], np.float64)
    assert got[r].tobytes() == want.tobytes(), (r, got[r], want)

# the global rows in rank order
glob = torch.arange(10 * world * 3, dtype=torch.float32).reshape(10 * world, 3)
lo, hi = pdist.process_slice(glob.shape[0])
assert (lo, hi) == (rank * 10, (rank + 1) * 10)
assert pdist.process_slice(10 * world + 1, rank, world)[1] == (10 * world + 1 if rank == world - 1
                                                               else (rank + 1) * 10)
local = pdist.local_rows(glob)
assert torch.equal(local, glob[lo:hi])
assert torch.equal(pdist.all_gather_rows(local), glob)
with pytest.raises(ValueError, match="different shapes"):    # an uneven split
    pdist.all_gather_rows(glob[:rank + 1])

# metrics averaged over the data axis; the mesh keeps the reference's names
mesh = pmesh.make_mesh()
assert mesh.mesh_dim_names == ("data", "fsdp", "tensor") and tuple(mesh.shape) == (world, 1, 1)
m = pmesh.psum_metrics({"loss": float(rank), "n": torch.tensor(2.0 * rank)}, mesh.get_group("data"))
assert abs(float(m["loss"]) - (world - 1) / 2) < 1e-6 and abs(float(m["n"]) - (world - 1)) < 1e-6
for kw in ({"fsdp": 4}, {"data": 2, "tensor": 2}):       # not the world's shape
    with pytest.raises(ValueError, match="world size"):
        pmesh.make_mesh(**kw)
for kw, want in (({"fsdp": 2}, (1, 2, 1)), ({"tensor": 2}, (1, 1, 2))):
    assert tuple(pmesh.make_mesh(**kw).shape) == want
t = torch.full((3,), float(rank)), torch.tensor([rank == 0])
pdist.broadcast_(list(t))
assert torch.equal(t[0], torch.zeros(3)) and bool(t[1])
print(f"rank {rank} helpers ok", flush=True)
torch.distributed.destroy_process_group()
'''


def test_collective_helpers_on_two_ranks(tmp_path):
    outs = run_ranks(HELPERS_WORKER, tmp_path)
    for r, out in enumerate(outs):
        assert f"rank {r} helpers ok" in out, out


INIT_WORKER = r'''
import datetime
import os
import sys

import pytest
import torch

from selftoktokenizer_tpu_torch.parallel import distributed as pdist

# no cluster variable: one process, no group, the helpers act as a world of one
assert not pdist.init(backend="gloo")
assert not torch.distributed.is_initialized() and pdist.rank_and_world() == (0, 1)
x = torch.arange(6.0).reshape(3, 2)
assert pdist.all_gather_rows(x) is x and torch.equal(pdist.local_rows(x), x)
assert pdist.allgather_f64([1.5]).shape == (1, 1)
with pytest.raises(RuntimeError, match="initialized process group"):
    from selftoktokenizer_tpu_torch.parallel.mesh import make_mesh
    make_mesh()

# cluster variables set, nobody listening: the group cannot form, and init
# raises instead of going on as one process
os.environ.update(RANK="1", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=sys.argv[4])
try:
    pdist.init(backend="gloo", timeout=datetime.timedelta(seconds=3))
except Exception as e:          # the store's own error type differs between versions
    print(f"init raised {type(e).__name__}", flush=True)
else:
    raise SystemExit("init returned although no group could form")
assert not torch.distributed.is_initialized()
# NCCL asked for (backend=None) on a machine without CUDA: refused, not gloo
if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        pdist.init()
print("init ok", flush=True)
'''


def test_init_raises_when_a_cluster_is_indicated_but_no_group_forms(tmp_path):
    import socket

    with socket.socket() as s:          # a free port, closed again: nobody listens there
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out, = run_ranks(INIT_WORKER, tmp_path, world=1, timeout=120, args=(port,))
    assert "init raised" in out and "init ok" in out, out
