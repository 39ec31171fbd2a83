#!/usr/bin/env python3
"""The control and the faults that set the upper end of the WaveGlow
cell's ``pcm_gap``.

    python3 benchmark/controls_waveglow.py --workload batch-b64-waveglow \
        --seeds 1,2 [--kinds control,noise_seed,coupling,w_forward,sigma] \
        [--batches N] [--out FILE]

Per seed, the reference serves the run's first ``--batches`` batches in
the program's place as ``controls.py`` does (fp32, TF32 off: decode, the
postnet, each row's frames past its stop at the log floor, the buffer cut
as ``synthesize_wav`` cuts it), and the fp32 reference WaveGlow vocodes
them from the seed-0 noise.  Each kind is the reference WaveGlow with one
thing changed, judged against that:

* ``control``: its convolutions in bfloat16 (the configuration states
  fp32 weights with cuDNN's TF32);
* ``noise_seed``: the noise drawn from seed 1;
* ``coupling``: one flow's coupling left out (its ``end`` zeroed, so b =
  0 and s = 0: the identity);
* ``w_forward``: W in place of W^-1 in every flow;
* ``sigma``: sigma 1.0 in place of 0.6.

Each line prints ``pcm_gap`` beside the cell's limit and whether the run
would have been correct (the acoustic stages are the other batch cells',
judged by ``controls.py``).  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import env  # noqa: E402

env.prepare()

KINDS = ("control", "noise_seed", "coupling", "w_forward", "sigma")


def served_mels(cell, seed: int, device, batches: int):
    """(masked cut mel (B, S, n_mels), frame_ends) of the reference's
    decode of the run's first ``batches`` batches."""
    import numpy as np
    import torch
    from benchmark import controls
    from benchmark.harness import serving
    from benchmark.harness.env import ROOT
    from benchmark.reference import checkpoint, model as M, text
    from tacotron2_torch.infer.fused import trim_to_bucket
    cfg = cell.config
    m, audio = cfg["model"], cfg["audio"]
    params = checkpoint.load(str(ROOT / cfg["serve"]["checkpoint"]), m,
                             device)
    lexicon = text.read_lexicon(
        str(ROOT / "third_party" / "cmudict" / "cmudict.gz"),
        serving.data_file("data/vocab.json")["words"])
    floor = float(np.float32(np.log(audio["mel_eps"])))
    f32 = M.rounding("float32")
    out = []
    for texts in controls.serving_batches(cell, seed)[:batches]:
        ids = [text.token_ids(s, lexicon, cfg["symbols"]) for s in texts]
        tok = np.zeros((len(ids), -(-max(map(len, ids)) // 16) * 16),
                       np.int64)
        for i, x in enumerate(ids):
            tok[i, :len(x)] = x
        lengths = torch.as_tensor([len(x) for x in ids], device=device)
        coarse, _, ends, nf = M.decode(params, m, torch.as_tensor(
            tok, device=device), lengths, m["max_decoder_steps"], "all", f32)
        cut = trim_to_bucket(int(nf), m["max_decoder_steps"])
        coarse = coarse[:, :cut]
        with torch.no_grad():
            post = coarse + M.postnet(params, m, coarse, False, f32)
        valid = (torch.arange(cut, device=device)[None, :, None]
                 < ends[:, None, None])
        out.append((torch.where(valid, post, torch.full_like(post, floor)),
                    ends.cpu().numpy()))
    return out


def altered(kind: str, sd, w: dict):
    """(state dict, noise seed, sigma, rounding) of one kind."""
    from benchmark.reference import model as M
    from benchmark.reference import waveglow as R
    sd, seed, sigma, q = dict(sd), 0, w["sigma"], M.rounding("float32")
    if kind == "control":
        q = M.rounding("bfloat16")
    elif kind == "noise_seed":
        seed = 1
    elif kind == "coupling":
        k = w["n_flows"] // 2
        for p in ("weight", "bias"):
            sd[f"WN.{k}.end.{p}"] = sd[f"WN.{k}.end.{p}"] * 0
    elif kind == "w_forward":
        for k in range(w["n_flows"]):
            name = f"convinv.{k}.conv.weight"
            sd[name] = R.w_inverse(sd[name])
    elif kind == "sigma":
        sigma = 1.0
    else:
        raise ValueError(f"no {kind!r}")
    return sd, seed, sigma, q


def run_seed(cell, seed: int, device, kinds, batches: int, log=print):
    """{kind: pcm_gap} for one seed's batches."""
    import torch
    from benchmark.harness import waveglow as wg
    from benchmark.reference import waveglow as R
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = wg.widths(cell.config)
    hop = cell.config["audio"]["hop_length"]
    sd = wg.weights(w, seed + 2, device)
    gaps = {k: 0.0 for k in kinds}
    for mel, fe in served_mels(cell, seed, device, batches):
        b, s = mel.shape[:2]
        groups = s * w["upsample_stride"] // w["n_group"]
        ref = R.infer(sd, w, mel.transpose(1, 2),
                      R.noise(b, groups, w, 0, device), w["sigma"])
        for kind in kinds:
            sd_k, seed_k, sigma_k, q = altered(kind, sd, w)
            alt = R.infer(sd_k, w, mel.transpose(1, 2),
                          R.noise(b, groups, w, seed_k, device), sigma_k, q)
            for i in range(b):
                e = int(fe[i]) * hop
                gaps[kind] = max(gaps[kind], float(
                    (alt[i, :e] - ref[i, :e]).abs().max()))
        log(f"seed {seed}: batch of {b} rows, {s} frames: {gaps}")
    return gaps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="batch-b64-waveglow")
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
