#!/usr/bin/env python3
"""One-command check of an NVIDIA NGC HiFi-GAN generator checkpoint against
the PyTorch port's converter, on a CUDA card.

The counterpart of ``tools/verify_ngc_checkpoint.py``, with its flags plus
``--device``.  The port's converter
(``tacotron2_torch/models/hifigan.py::params_from_nvidia_state_dict``) has
been held only against synthetic weight-normed files in the same layout;
this closes the rest once a real generator file is at hand:

    python tools/verify_ngc_checkpoint_torch.py \\
        hifigan_gen_checkpoint_10000_ft.pt [--out report.json]

It checks, in order:

1. **Key manifest**: the generator state dict's keys and every tensor's
   shape against ``docs/ngc_hifigan_manifest.json`` (``--write-manifest``
   writes the manifest the architecture's constants give).  Each conv may
   hold a plain ``weight`` or the weight-normed ``weight_g`` +
   ``weight_v``.  A ``module.`` prefix (a DataParallel save) is stripped.
2. **Conversion + forward**: the converter's generator on ``--device``
   (fp32, TF32 off) on a deterministic mel: shape, finiteness and the tanh
   bound.
3. **Cross-parity** (on by default; ``--no-torch-parity`` skips it): the
   same weights in an independently written v1 generator on the CPU,
   waveforms within 2e-4 (fp32).

Prints the JSON report of the JAX tool (``--out`` also writes it), with the
file's sha256, and exits non-zero on any failure.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import sys
from typing import Dict, List, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)   # runnable from any cwd

MANIFEST = os.path.join(ROOT, "docs", "ngc_hifigan_manifest.json")
PARITY_TOL = 2e-4

from tacotron2_torch.models.hifigan import (  # noqa: E402
    RESBLOCK_DILATIONS, RESBLOCK_KERNELS, UPSAMPLE_INITIAL_CHANNEL,
    UPSAMPLE_KERNELS, UPSAMPLE_RATES, _denorm, hifigan_apply,
    params_from_nvidia_state_dict)


def expected_manifest() -> Dict[str, Dict[str, List[int]]]:
    """Generator keys -> shapes from the architecture's constants (HiFi-GAN
    v1, NVIDIA's LJSpeech 22 kHz config).  Per conv ``<prefix>`` the state
    dict holds ``<prefix>.bias`` and either ``<prefix>.weight`` or the
    weight-normed ``<prefix>.weight_g`` (the norm over all but dim 0, kept
    dims) + ``<prefix>.weight_v``.  PyTorch's layouts: Conv1d (out, in, k),
    ConvTranspose1d (in, out, k), bias (out,)."""
    convs: List[Tuple[str, Tuple[int, ...], int]] = []
    ch = UPSAMPLE_INITIAL_CHANNEL
    convs.append(("conv_pre", (ch, 80, 7), ch))
    for i, k in enumerate(UPSAMPLE_KERNELS):
        convs.append((f"ups.{i}", (ch, ch // 2, k), ch // 2))
        ch //= 2
        for j, (rk, dils) in enumerate(zip(RESBLOCK_KERNELS,
                                           RESBLOCK_DILATIONS)):
            bi = i * len(RESBLOCK_KERNELS) + j
            for c in range(len(dils)):
                convs.append((f"resblocks.{bi}.convs1.{c}", (ch, ch, rk), ch))
                convs.append((f"resblocks.{bi}.convs2.{c}", (ch, ch, rk), ch))
    convs.append(("conv_post", (1, ch, 7), 1))
    return {prefix: {"weight": list(w), "weight_g": [w[0], 1, 1],
                     "weight_v": list(w), "bias": [bias]}
            for prefix, w, bias in convs}


def check_keys(sd: Dict[str, np.ndarray], manifest) -> List[str]:
    """The problems found, in words (none: the keys pass)."""
    problems: List[str] = []
    seen = set()
    for prefix, shapes in manifest.items():
        bias_key = f"{prefix}.bias"
        if bias_key not in sd:
            problems.append(f"missing {bias_key}")
        else:
            seen.add(bias_key)
            got = list(sd[bias_key].shape)
            if got != shapes["bias"]:
                problems.append(f"{bias_key}: shape {got} != "
                                f"expected {shapes['bias']}")
        plain = f"{prefix}.weight" in sd
        normed = (f"{prefix}.weight_g" in sd
                  and f"{prefix}.weight_v" in sd)
        if not plain and not normed:
            problems.append(f"missing {prefix}.weight (or weight_g/"
                            f"weight_v pair)")
            continue
        for suffix in (("weight",) if plain else ("weight_g", "weight_v")):
            key = f"{prefix}.{suffix}"
            seen.add(key)
            got = list(sd[key].shape)
            if got != shapes[suffix]:
                problems.append(f"{key}: shape {got} != expected "
                                f"{shapes[suffix]}")
    for key in sorted(set(sd) - seen):
        problems.append(f"unexpected key {key} (shape "
                        f"{list(sd[key].shape)})")
    return problems


def _torch_generator(torch):
    """An independent PyTorch HiFi-GAN v1 (for the cross-check only)."""
    nn = torch.nn
    lrelu = lambda x: torch.nn.functional.leaky_relu(x, 0.1)

    class ResBlock(nn.Module):
        def __init__(self, ch, k, dils):
            super().__init__()
            self.convs1 = nn.ModuleList([
                nn.Conv1d(ch, ch, k, dilation=d, padding=(k - 1) * d // 2)
                for d in dils])
            self.convs2 = nn.ModuleList([
                nn.Conv1d(ch, ch, k, padding=(k - 1) // 2) for _ in dils])

        def forward(self, x):
            for c1, c2 in zip(self.convs1, self.convs2):
                x = x + c2(lrelu(c1(lrelu(x))))
            return x

    class Generator(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv_pre = nn.Conv1d(80, UPSAMPLE_INITIAL_CHANNEL, 7,
                                      padding=3)
            self.ups = nn.ModuleList()
            self.resblocks = nn.ModuleList()
            ch = UPSAMPLE_INITIAL_CHANNEL
            for u, k in zip(UPSAMPLE_RATES, UPSAMPLE_KERNELS):
                self.ups.append(nn.ConvTranspose1d(
                    ch, ch // 2, k, stride=u, padding=(k - u) // 2))
                ch //= 2
                for rk, dils in zip(RESBLOCK_KERNELS, RESBLOCK_DILATIONS):
                    self.resblocks.append(ResBlock(ch, rk, dils))
            self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

        def forward(self, x):
            x = self.conv_pre(x)
            n = len(RESBLOCK_KERNELS)
            for i, up in enumerate(self.ups):
                x = up(lrelu(x))
                acc = None
                for j in range(n):
                    y = self.resblocks[i * n + j](x)
                    acc = y if acc is None else acc + y
                x = acc / n
            return torch.tanh(self.conv_post(lrelu(x))).squeeze(1)

    return Generator()


def _denormed_torch_sd(torch, sd: Dict[str, np.ndarray]):
    """The state dict with each weight-norm pair resolved to a plain
    weight: the layout the independent generator loads."""
    out = {}
    for prefix in {k.rsplit(".", 1)[0] for k in sd}:
        out[f"{prefix}.weight"] = torch.from_numpy(
            np.ascontiguousarray(_denorm(sd, prefix)))
        out[f"{prefix}.bias"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(sd[f"{prefix}.bias"], np.float32)))
    return out


@contextlib.contextmanager
def _no_tf32(torch):
    """fp32 convolutions in fp32 on the card (cuDNN defaults to TF32)."""
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = was


def verify(path: str, torch_parity: bool = True, device="cuda") -> Dict:
    """The report of ``tools/verify_ngc_checkpoint.py`` for the file at
    ``path``, its forward run on ``device``."""
    import torch

    from tacotron2_torch.utils.device import resolve_device
    device = resolve_device(device)
    report: Dict = {"checkpoint": path, "ok": False}
    with open(path, "rb") as f:
        report["sha256"] = hashlib.sha256(f.read()).hexdigest()

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd_raw = ckpt.get("generator", ckpt) if isinstance(ckpt, dict) else ckpt
    if hasattr(sd_raw, "state_dict"):
        sd_raw = sd_raw.state_dict()
    sd = {}
    for k, v in sd_raw.items():
        k = k[len("module."):] if k.startswith("module.") else k
        sd[k] = v.detach().cpu().numpy()
    report["n_keys"] = len(sd)
    report["layout"] = ("weight_normed"
                        if any(k.endswith(".weight_g") for k in sd)
                        else "plain")

    with open(MANIFEST) as f:
        problems = check_keys(sd, json.load(f))
    report["manifest_problems"] = problems
    if problems:
        return report

    gen = params_from_nvidia_state_dict(sd).to(device)
    report["n_params"] = sum(int(p.numel()) for p in gen.parameters())

    rng = np.random.default_rng(0)
    mel = (rng.standard_normal((1, 80, 40)).astype(np.float32) - 5.0)
    with _no_tf32(torch):
        wav = hifigan_apply(gen, torch.from_numpy(mel).to(device)).cpu()
    wav = wav.numpy()
    report["forward"] = {
        "out_shape": list(wav.shape),
        "expected_shape": [1, 40 * 256],
        "finite": bool(np.isfinite(wav).all()),
        "max_abs": float(np.abs(wav).max()),
    }
    fwd_ok = (wav.shape == (1, 40 * 256)
              and report["forward"]["finite"]
              and report["forward"]["max_abs"] <= 1.0)

    parity_ok = True
    if torch_parity:
        ref_gen = _torch_generator(torch)
        ref_gen.load_state_dict(_denormed_torch_sd(torch, sd))
        ref_gen.eval()
        with torch.no_grad():
            ref = ref_gen(torch.from_numpy(mel)).numpy()
        max_delta = float(np.abs(wav - ref).max())
        report["torch_parity"] = {"max_abs_delta": max_delta,
                                  "threshold": PARITY_TOL}
        parity_ok = max_delta < PARITY_TOL

    report["ok"] = bool(fwd_ok and parity_ok)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Verify an NVIDIA NGC HiFi-GAN generator checkpoint "
                    "against the PyTorch port's converter.")
    ap.add_argument("checkpoint", nargs="?",
                    help="path to hifigan_gen_checkpoint_*.pt")
    ap.add_argument("--no-torch-parity", action="store_true",
                    help="skip the independent generator's cross-check")
    ap.add_argument("--out", help="also write the JSON report here")
    ap.add_argument("--write-manifest", metavar="PATH",
                    help="write the expected key/shape manifest as JSON "
                         "and exit (docs/ngc_hifigan_manifest.json)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.write_manifest:
        with open(args.write_manifest, "w") as f:
            json.dump(expected_manifest(), f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"manifest written: {args.write_manifest}")
        return 0
    if not args.checkpoint:
        ap.error("checkpoint path required (or --write-manifest)")

    report = verify(args.checkpoint, torch_parity=not args.no_torch_parity,
                    device=args.device)
    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
