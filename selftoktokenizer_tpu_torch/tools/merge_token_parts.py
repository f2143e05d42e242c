"""Merge the part files of a multi-rank ``tokenize_corpus`` run into one
``.npz`` (counterpart of the reference ``tools/merge_token_parts.py``).

    python -m selftoktokenizer_tpu_torch.tools.merge_token_parts \\
        --glob 'tokens.part*.npz' --out tokens.npz [--allow-duplicates]

``tokenize_corpus`` writes ``<out>.part<rank>.npz`` a rank (``tokens``,
``paths`` and, with ``--margin-stats``, ``margins``). The parts merge in
rank order; a source path in two parts (overlapping shard assignments)
stops the merge unless ``--allow-duplicates``. Numpy only. One JSON line.
"""

from __future__ import annotations

import argparse
import glob
import json
import re

import numpy as np


def part_rank(name):
    """The rank in ``<out>.part<rank>.npz``, -1 for another name."""
    m = re.search(r"\.part(\d+)\.npz$", name)
    return int(m.group(1)) if m else -1


def main(argv=None):
    """Run the tool; returns the dict of its JSON line."""
    ap = argparse.ArgumentParser("merge_token_parts")
    ap.add_argument("--glob", required=True,
                    help="pattern matching the part files, e.g. 't.part*.npz'")
    ap.add_argument("--out", required=True)
    ap.add_argument("--allow-duplicates", action="store_true")
    args = ap.parse_args(argv)

    parts = sorted(glob.glob(args.glob), key=part_rank)
    if not parts:
        raise SystemExit(f"no files match {args.glob}")
    toks, paths, margins = [], [], []
    for p in parts:
        z = np.load(p, allow_pickle=False)
        toks.append(z["tokens"])
        paths.append(z["paths"])
        if "margins" in z:
            margins.append(z["margins"])
    filled = [t for t in toks if t.size]
    tokens = np.concatenate(filled) if filled else np.zeros((0,), np.int32)
    named = [p for p in paths if p.size]
    all_paths = np.concatenate(named) if named else np.zeros((0,), dtype="U1")
    if len(all_paths) != len(set(all_paths.tolist())) and not args.allow_duplicates:
        raise SystemExit("duplicate source paths across parts (overlapping shard "
                         "assignments?): pass --allow-duplicates to merge anyway")
    extra = {}
    if margins:
        if len(margins) != len(filled):
            raise SystemExit("some parts have margins and some do not: "
                             "re-run tokenize_corpus consistently")
        extra["margins"] = np.concatenate(margins)
    np.savez_compressed(args.out, tokens=tokens, paths=all_paths, **extra)
    line = {"parts": len(parts), "n": int(tokens.shape[0]), "out": args.out}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
