#!/usr/bin/env python3
"""The controls and faults that set the upper end of each limit.

    python3 benchmark/controls.py --workload NAME --seeds 1,2,3 \
        --kind control|half_batch|early_stop|late_stop [--out FILE]

A control is the reference put in the program's place at the precision
just below the configuration's: for training (bf16 products over fp32
masters) the products' inputs rounded to float8 e4m3; for serving the
acoustic model with TF32 on (the configuration states fp32 with TF32 off)
and HiFi-GAN's convolutions in bfloat16 (it states fp32 with cuDNN's
TF32), Griffin-Lim with TF32 on.  The faults are the reference in the
program's place with one thing broken: ``half_batch`` (training) each
batch cut to its first half; ``early_stop`` / ``late_stop`` (serving)
every row's stop one frame off.
Each run prints the numbers the cell compares, beside the cell's limits,
and whether the run would have been correct.  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import env  # noqa: E402

env.prepare()


def train_case(cell, seed: int, device, kind: str, log=print):
    from benchmark.drivers.train import compare
    from benchmark.harness.training_data import make_rows
    from benchmark.reference import train as RT
    rows = make_rows(cell.traffic, cell.config["model"], seed, device)
    ref = RT.follow(cell.config, cell.traffic, rows, seed, device, "float32",
                    log=log)
    if kind == "control":
        alt = RT.follow(cell.config, cell.traffic, rows, seed, device,
                        "float8_e4m3fn", log=log, remat=True)
    elif kind == "half_batch":
        alt = RT.follow(cell.config, cell.traffic, rows, seed, device,
                        "float32", log=log,
                        keep_rows=cell.traffic["batch"] // 2)
    else:
        raise ValueError(f"no {kind!r} for a training cell")
    return compare(alt["losses"], alt["grad_norms"], alt["change_norms"],
                   ref, {k: v for k, v in cell.limits.items()}
                   | {k: float("inf") for k in ("loss1_gap", "loss_gap",
                                                "grad_gap", "change_gap")
                      if k not in cell.limits}, log)


def serving_batches(cell, seed: int):
    """The texts of the batches a run of the cell decodes:
    ``check_batches`` + 1 batches of ``batch`` sentences in the seed's
    order."""
    import numpy as np
    from benchmark.harness import serving
    t = cell.traffic
    pool = serving.sentence_pool(t)
    order = np.random.default_rng(seed).permutation(len(pool))
    b = t["batch"]
    return [[pool[j] for j in order[k * b:(k + 1) * b]]
            for k in range(t["check_batches"] + 1)]


def serving_case(cell, seed: int, device, kind: str, log=print):
    """The reference serves the cell's batches in the program's place, as
    the fused path would; the fp32 reference judges it.  ``control``: at
    the control's precision.  ``early_stop`` / ``late_stop``: in fp32, but
    every row's stop moved one frame before its gate fires, or one frame
    after (rows the decode ran past), as a stop rule off by a frame."""
    import numpy as np
    import torch
    from benchmark.harness import serving
    from benchmark.harness.env import ROOT
    from benchmark.reference import checkpoint, model as M, text, vocoders
    shift = {"control": 0, "early_stop": -1, "late_stop": 1}
    if kind not in shift:
        raise ValueError(f"no {kind!r} for a serving cell")
    cfg = cell.config
    m, audio = cfg["model"], cfg["audio"]
    params = checkpoint.load(str(ROOT / cfg["serve"]["checkpoint"]), m,
                             device)
    lexicon = text.read_lexicon(
        str(ROOT / "third_party" / "cmudict" / "cmudict.gz"),
        serving.data_file("data/vocab.json")["words"])
    hifi = (serving.hifigan_weights(seed + 1, device)
            if cfg["serve"]["vocoder"] == "hifigan" else None)
    floor = float(np.float32(np.log(audio["mel_eps"])))
    hop, iters = audio["hop_length"], cfg["serve"].get("griffinlim_iters", 60)
    records = []
    control = kind == "control"
    torch.backends.cuda.matmul.allow_tf32 = control
    torch.backends.cudnn.allow_tf32 = control
    f32 = M.rounding("float32")
    voc_q = M.rounding("bfloat16") if control else f32
    for texts in serving_batches(cell, seed):
        ids = [text.token_ids(s, lexicon, cfg["symbols"]) for s in texts]
        t_enc = -(-max(map(len, ids)) // 16) * 16
        tok = np.zeros((len(ids), t_enc), np.int64)
        for i, x in enumerate(ids):
            tok[i, :len(x)] = x
        lengths = np.asarray([len(x) for x in ids])
        tok_t = torch.as_tensor(tok, device=device)
        len_t = torch.as_tensor(lengths, device=device)
        stop = "all" if len(texts) > 1 else "any"
        coarse, gates, ends, nf = M.decode(params, m, tok_t, len_t,
                                           m["max_decoder_steps"], stop, f32)
        ends = torch.clamp(ends + shift[kind], 2, nf)
        with torch.no_grad():
            post = coarse + M.postnet(params, m, coarse, False, f32)
        fe = ends.cpu().numpy()
        valid = (torch.arange(post.shape[1], device=device)[None, :, None]
                 < ends[:, None, None])
        mel = torch.where(valid, post, torch.full_like(post, floor))
        wav = (vocoders.hifigan(hifi, mel.transpose(1, 2), voc_q)
               if hifi is not None else
               vocoders.griffin_lim(mel.transpose(1, 2), audio, iters, 0, f32))
        pcm = [wav[b][:int(fe[b]) * hop].float().cpu().numpy()
               for b in range(len(texts))]
        call = {"tokens": tok, "lengths": lengths,
                "max_steps": m["max_decoder_steps"], "stop_mode": stop,
                "n_frames": int(nf), "frame_ends": fe,
                "out": types.SimpleNamespace(
                    mel_coarse=coarse, mel_postnet=post, gate_logits=gates)}
        records.append({"texts": texts, "n": len(texts), "call": call,
                        "pcm": pcm, "griffinlim_iters": iters})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gaps = serving.judge(records, cfg, seed + 1, device, log)
    return [(k, v, cell.limits.get(k, float("inf"))) for k, v in gaps.items()]


def run_case(cell, seed: int, device, kind: str, log=print):
    driver = cell.traffic["driver"]
    if driver == "train":
        return train_case(cell, seed, device, kind, log)
    return serving_case(cell, seed, device, kind, log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kind", default="control")
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    from benchmark.harness import registry
    cell = registry.load_cell(args.workload)
    device = torch.device(args.device)
    lines = []
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        checks = run_case(cell, seed, device, args.kind,
                          lambda m: print(m, file=sys.stderr, flush=True))
        line = {"workload": args.workload, "kind": args.kind, "seed": seed,
                "seconds": time.perf_counter() - t0,
                "correct": all(v <= lim for _, v, lim in checks),
                "checks": {n: [v, lim] for n, v, lim in checks}}
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
