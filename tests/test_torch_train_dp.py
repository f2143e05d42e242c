"""The tokenizer's training driver over two gloo ranks on the CPU (what
``torchrun --nproc_per_node 2`` starts): each rank takes its rows of the
global batch and steps through ``dp_train_step``; the run equals the
one-process ``--accum 2`` run of the same global batch, and only rank 0
writes the checkpoint and the metrics."""

import contextlib
import io
import json
import os

import numpy as np

from selftoktokenizer_tpu_torch.tools import train_tokenizer
from tests.torch_port_helpers import TINY, run_ranks

WORKER = """
import json, sys
from selftoktokenizer_tpu_torch.parallel import distributed as pdist
from selftoktokenizer_tpu_torch.tools import train_tokenizer
rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
pdist.init(backend="gloo", init_method=init, rank=rank, world_size=world)
argv = json.loads(sys.argv[4])
argv[argv.index("--ckpt-dir") + 1] += f"/rank{rank}"
argv[argv.index("--metrics-out") + 1] += f".rank{rank}"
res = train_tokenizer.main(argv + ["--device", "cpu"])
print("RESULT", json.dumps({"loss": res["final_loss"], "step": res["state"].step}))
"""


def _argv(lat, tmp_path, extra):
    return ["--yml-path", TINY, "--data_size", "64", "--batch-size", "4", "--latents-file", lat,
            "--data-seed", "1", "--steps", "3", "--log-interval", "1", "--ckpt-interval", "3",
            "--ckpt-dir", str(tmp_path / "ck"), "--metrics-out", str(tmp_path / "m.jsonl")] + extra


def test_two_ranks_equal_the_accumulated_one_process_run(tmp_path):
    lat = str(tmp_path / "lat.npy")
    np.save(lat, np.random.default_rng(4).standard_normal((12, 8, 8, 16)).astype(np.float32))
    outs = run_ranks(WORKER, tmp_path, args=(json.dumps(_argv(lat, tmp_path, [])),))
    res = [json.loads(o.split("RESULT", 1)[1]) for o in outs]
    (tmp_path / "one").mkdir()
    with contextlib.redirect_stdout(io.StringIO()):
        one = train_tokenizer.main(_argv(lat, tmp_path / "one", ["--accum", "2", "--device", "cpu"]))
    assert res[0] == res[1]
    np.testing.assert_allclose(res[0]["loss"], one["final_loss"], rtol=1e-6)
    assert res[0]["step"] == 3
    assert os.path.exists(tmp_path / "ck" / "rank0" / "step_3")
    assert not os.path.exists(tmp_path / "ck" / "rank1")
    assert os.path.exists(str(tmp_path / "m.jsonl") + ".rank0")
    assert not os.path.exists(str(tmp_path / "m.jsonl") + ".rank1")
