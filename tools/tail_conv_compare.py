#!/usr/bin/env python3
"""The attention tail (#1) and the conv (#5) against another checkout's,
on one CUDA card: outputs bit for bit, and device time in turns.

    python3 tools/tail_conv_compare.py --compare LABEL=DIR [--out FILE]

``DIR`` holds another checkout's ``tacotron2_torch`` (``git archive
<commit> tacotron2_torch | tar -x -C DIR``); it is loaded beside this
tree's package under another name (``tools/bwd_chain_probe.py``'s
``load_package``).  For the tail at the smoke's five shapes and the conv at
the serving layers' shapes (K=5: 512->512 at B=4, T=400 and B=1, T=32,
80->512, 512->80) and the halo-8 and halo-16 builds (K=11, 17, 33), fp32
and bf16, both packages run on the same seeded inputs: whether their
outputs are equal bit for bit, and each one's device time from a CUDA
graph of 20 calls, timed in turns (other, this, this, other).  The other
kernels have probes of their own (``decode_probe.py``,
``train_fwd_probe.py``, ``bwd_chain_probe.py``).

Prints the card's name and power limit first; JSON to ``--out`` (default
``chiprun_out/tail_conv_compare.json``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

from bwd_chain_probe import load_package  # noqa: E402

MODULES = ("ops.attention_kernel", "ops.convbn_kernel", "models.layers",
           "ops._build")
TAIL_SHAPES = ((torch.bfloat16, 4, 112), (torch.bfloat16, 1, 32),
               (torch.float32, 16, 128), (torch.bfloat16, 64, 200),
               (torch.float32, 4, 600))
CONV_SHAPES = ((5, 512, 512, 4, 400), (5, 512, 512, 1, 32),
               (5, 80, 512, 4, 400), (5, 512, 80, 4, 400),
               (11, 512, 512, 2, 130), (17, 64, 40, 2, 129),
               (33, 64, 40, 2, 129))


def graph_ms(fn, n: int = 20, replays: int = 5) -> float:
    """Device ms a call: ``n`` calls captured in one CUDA graph, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / replays / n


def conv_layer(pkg, c_in, c_out, k, dtype, tensors, dev):
    """The package's conv + BatchNorm with the given seeded values."""
    layers = pkg["models.layers"]
    conv, bn = layers.Conv1d(c_in, c_out, k), layers.BatchNorm(c_out, 1e-5)
    w, stats = tensors
    with torch.no_grad():
        conv.weight.copy_(w * (c_in * k) ** -0.5)
        conv.bias.copy_(stats[0] * 0.1)
        bn.weight.copy_(stats[1] + 0.5)
        bn.bias.copy_(stats[2] * 0.4 - 0.2)
        bn.running_mean.copy_(stats[3] * 0.8 - 0.4)
        bn.running_var.copy_(stats[4] * 1.7 + 0.3)
    for prm in list(conv.parameters()) + list(bn.parameters()):
        prm.data = prm.data.to(dtype)
    return conv.to(dev), bn.to(dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", required=True, metavar="LABEL=DIR")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "tail_conv_compare.json")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("tail_conv_compare: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    label, path = opts.compare.split("=", 1)
    pkgs = {label: load_package(Path(path) / "tacotron2_torch",
                                f"t2_{label}", MODULES),
            "this": load_package(ROOT / "tacotron2_torch", "t2_this",
                                 MODULES)}
    for pkg in pkgs.values():
        pkg["ops._build"].build(["attention_tail", "conv_bn_act"])
    dev = torch.device("cuda")
    order = [label, "this", "this", label]
    gen = torch.Generator().manual_seed(0)
    rows = []

    def compare(kernel, tag, calls, unit_us):
        with torch.no_grad():
            outs = {k: calls[k]() for k in pkgs}
            pairs = (zip(outs["this"], outs[label]) if kernel ==
                     "attention_tail" else [(outs["this"], outs[label])])
            same = all(torch.equal(x, y) for x, y in pairs)
            times = [(k, graph_ms(calls[k])) for k in order]
        scale, unit = (1e3, "us") if unit_us else (1.0, "ms")
        print(f"[{kernel} {tag}] bit for bit {same}; device {unit} (graph) "
              + ", ".join(f"{k} {ms * scale:.4f}" for k, ms in times),
              flush=True)
        rows.append(dict(kernel=kernel, shape=tag, bit_for_bit=same,
                         device_ms=times))

    for dtype, b, t in TAIL_SHAPES:
        lens = torch.randint(t // 2, t + 1, (b,), generator=gen)
        lens[0] = t
        ins = (torch.randn(b, t, 128, generator=gen).to(dev, dtype),
               (torch.randn(128, generator=gen) * 0.3).to(dev),
               torch.tensor(0.1, device=dev), torch.tensor(1.2, device=dev),
               (torch.arange(t)[None] >= lens[:, None]).to(dev),
               torch.randn(b, t, 512, generator=gen).to(dev))
        calls = {k: (lambda f=p["ops.attention_kernel"].attention_tail:
                     f(*ins)) for k, p in pkgs.items()}
        compare("attention_tail", f"{str(dtype)[6:]} B={b} T_enc={t}",
                calls, True)
    for k, c_in, c_out, b, t in CONV_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(b, c_in, t, generator=gen).to(dev)
            tensors = (torch.rand(c_out, c_in, k, generator=gen) * 2 - 1,
                       [torch.rand(c_out, generator=gen) for _ in range(5)])
            calls = {}
            for name, p in pkgs.items():
                conv, bn = conv_layer(p, c_in, c_out, k, dtype, tensors, dev)
                calls[name] = (lambda f=p["ops.convbn_kernel"].conv_bn_act,
                               c=conv, n=bn: f(x, c, n, 1e-5, "tanh"))
            compare("conv_bn_act",
                    f"K={k} {c_in}->{c_out} B={b} T={t} {str(dtype)[6:]}",
                    calls, False)
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps(dict(card=card, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
