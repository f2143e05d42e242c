"""What the benchmark loads: never JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference nothing of the port."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from benchmark.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "selftoktokenizer_tpu"}


def _run(code):
    r = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, PYTHONPATH=spec.ROOT))
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    """A whole run of a tiny cell on the CPU, the port and every metric
    reader loaded, then the top-level names in sys.modules."""
    out = _run(
        "import sys, time\n"
        "from benchmark.run import run_cell, forbidden_modules\n"
        "from benchmark.harness import spec\n"
        "from benchmark.tests.helpers import tiny_cell\n"
        "cell = tiny_cell('decode', {'dtype': 'bfloat16', 'checked_batches': 1},"
        " {'inputs': 'ids', 'batch': 1, 'pool': 1, 'noise': True})\n"
        "run_cell(cell, 7, 0.0, trace=True, device='cpu', t0=time.perf_counter())\n"
        "import glob, os\n"
        "for f in glob.glob(os.path.join(spec.HERE, 'metrics', '*.py')):\n"
        "    spec.metric_reader(os.path.basename(f)[:-3])\n"
        "assert 'selftoktokenizer_tpu_torch' in {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert not FORBIDDEN & set(eval(out))


def test_the_reference_loads_nothing_of_the_port():
    """The reference and the weights it makes again, run at a tiny size."""
    out = _run(
        "import sys, torch\n"
        "from benchmark.harness import weights\n"
        "from benchmark.reference import encoder, mmdit, nn, vae\n"
        "from benchmark.tests.helpers import tiny_config\n"
        "cfg = tiny_config()\n"
        "sd = weights.tokenizer_weights(cfg, 1, 'cpu', decoder=torch.float32); vsd = weights.vae_weights(cfg, 1, 'cpu')\n"
        "ids = torch.zeros(1, cfg['K'], dtype=torch.long)\n"
        "lat = mmdit.sample(sd, cfg['decoder'], cfg['diti'], cfg['K'], 2, encoder.context(sd, ids),"
        " torch.zeros(1, 8, 8, 16))\n"
        "encoder.encode(sd, cfg['encoder'], vae.images_to_latents(vsd, torch.zeros(1, 64, 64, 3),"
        " torch.bfloat16))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))")
    names = set(eval(out))
    assert not (FORBIDDEN | {"selftoktokenizer_tpu_torch"}) & names


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_source_names_jax():
    for dirpath, _, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                assert not FORBIDDEN & set(_imports(path)), path
                if os.sep + "reference" + os.sep in path:
                    assert "selftoktokenizer_tpu_torch" not in set(_imports(path)), path
