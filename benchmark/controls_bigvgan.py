#!/usr/bin/env python3
"""The control and the faults that set the upper end of the BigVGAN
cell's ``pcm_gap``.

    python3 benchmark/controls_bigvgan.py --workload batch-b64-bigvgan \
        --seeds 1,2 [--kinds control,base_rate,...] [--batches N] [--out F]

Per seed, the reference serves the run's first ``--batches`` batches in
the program's place as ``controls_waveglow.served_mels`` does (fp32, TF32
off: decode, the postnet, each row's frames past its stop at the log
floor, the buffer cut as ``synthesize_wav`` cuts it), and the fp32
reference BigVGAN vocodes them with the run's weights (seed + 3).  Each
kind is the reference BigVGAN with one thing changed, judged against that:

* ``control``: its convolutions in bfloat16 (the configuration states
  fp32 weights with cuDNN's TF32);
* ``base_rate``: the snake at the base rate, with no up- or downsampler;
* ``swap``: each channel's alpha and beta swapped;
* ``zero_pad``: zero padding in place of replicate at both filters;
* ``mrf_branch``: each stage's last AMP block (kernel 11) left out of its
  mean;
* ``weights_seed``: the weights of seed + 4.

Each line prints ``pcm_gap`` beside the cell's limit and whether the run
would have been correct (the acoustic stages are the other batch cells',
judged by ``controls.py``).  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import env  # noqa: E402

env.prepare()

KINDS = ("control", "base_rate", "swap", "zero_pad", "mrf_branch",
         "weights_seed")


def _base_rate(x, alpha, beta, f, ratio):
    import torch
    return x + (torch.sin(torch.exp(alpha)[None, :, None] * x) ** 2
                / (torch.exp(beta)[None, :, None] + 1e-9))


def _zero_pad(x, left, right):
    import torch.nn.functional as F
    return F.pad(x, (left, right))


def _two_branches(sd, stage, x, f, h, q):
    from benchmark.reference import bigvgan as R
    n = len(h["resblock_kernel_sizes"])
    total = 0.0
    for j, dils in enumerate(h["resblock_dilation_sizes"][:n - 1]):
        total = total + R.amp_block(sd, f"resblocks.{stage * n + j}", x,
                                    dils, f, h, q)
    return total / (n - 1)


def altered(kind: str, sd, h: dict, seed: int, device):
    """(state dict, rounding, patches) of one kind."""
    from benchmark.harness import bigvgan as bv
    from benchmark.reference import bigvgan as R
    from benchmark.reference import model as M
    q, patches = M.rounding("float32"), []
    if kind == "control":
        q = M.rounding("bfloat16")
    elif kind == "base_rate":
        patches.append(mock.patch.object(R, "activation", _base_rate))
    elif kind == "swap":
        sd = dict(sd)
        for k in [k for k in sd if k.endswith(".alpha")]:
            b = k[:-len("alpha")] + "beta"
            sd[k], sd[b] = sd[b], sd[k]
    elif kind == "zero_pad":
        patches.append(mock.patch.object(R, "replicate_pad", _zero_pad))
    elif kind == "mrf_branch":
        patches.append(mock.patch.object(R, "mrf", _two_branches))
    elif kind == "weights_seed":
        sd = bv.weights(h, seed + 4, device)
    else:
        raise ValueError(f"no {kind!r}")
    return sd, q, patches


def run_seed(cell, seed: int, device, kinds, batches: int, log=print):
    """{kind: pcm_gap} for one seed's batches."""
    import torch
    from benchmark.controls_waveglow import served_mels
    from benchmark.harness import bigvgan as bv
    from benchmark.reference import bigvgan as R
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h = bv.widths(cell.config)
    hop = cell.config["audio"]["hop_length"]
    sd = bv.weights(h, seed + 3, device)
    gaps = {k: 0.0 for k in kinds}
    for mel, fe in served_mels(cell, seed, device, batches):
        b, s = mel.shape[:2]
        ref = R.infer(sd, h, mel.transpose(1, 2))
        for kind in kinds:
            sd_k, q, patches = altered(kind, sd, h, seed, device)
            with contextlib.ExitStack() as stack:
                for p in patches:
                    stack.enter_context(p)
                alt = R.infer(sd_k, h, mel.transpose(1, 2), q)
            for i in range(b):
                e = int(fe[i]) * hop
                gaps[kind] = max(gaps[kind], float(
                    (alt[i, :e] - ref[i, :e]).abs().max()))
        log(f"seed {seed}: batch of {b} rows, {s} frames: {gaps}")
    return gaps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="batch-b64-bigvgan")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kinds", default=",".join(KINDS))
    ap.add_argument("--batches", type=int, default=None,
                    help="batches a seed (default: the check's, "
                         "check_batches + 1)")
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    from benchmark.harness import registry
    cell = registry.load_cell(args.workload)
    device = torch.device(args.device)
    kinds = args.kinds.split(",")
    batches = args.batches or cell.traffic["check_batches"] + 1
    limit = cell.limits["pcm_gap"]
    lines = []
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        gaps = run_seed(cell, seed, device, kinds, batches,
                        lambda m: print(m, file=sys.stderr, flush=True))
        for kind, v in gaps.items():
            line = {"workload": args.workload, "kind": kind, "seed": seed,
                    "seconds": time.perf_counter() - t0,
                    "correct": v <= limit, "checks": {"pcm_gap": [v, limit]}}
            print(json.dumps(line), flush=True)
            lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
