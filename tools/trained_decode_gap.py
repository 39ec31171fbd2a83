#!/usr/bin/env python3
"""How far two decodes of the trained checkpoint part, on one CUDA card.

    python3 tools/trained_decode_gap.py [--checkpoint DIR]

For each sentence of ``chip_smoke.py``'s ``TRAINED_FRAME_ENDS``, in fp32
(as ``load_model`` serves) and in bf16 (``cast_params_bf16``), one at a
time with ``max_steps=256`` and no forced stop, four decodes: the decode
kernel, the step loop with the attention tail kernel, the step loop with
the plain tail, and the plain step loop on the CPU.  It prints, pair by
pair, the stops, the largest and mean difference of the decoder's mels
over the shared frames, the first frame where they part by more than
5e-3, the largest alignment difference and how far the alignments'
argmax paths part.  The plain loop against itself on the CPU is the
scale of rounding: a kernel whose gap is of that size agrees with the
plain version as far as the dtype lets two orders of summation agree.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def gap(a, b, n_tok: int) -> str:
    k = min(int(a[3]), int(b[3]))
    mel = (a[0][0, :k].float().cpu() - b[0][0, :k].float().cpu()).abs()
    al = (a[2][0, :k].float().cpu() - b[2][0, :k].float().cpu()).abs()
    pa = a[2][0, :k].float().cpu().argmax(-1)
    pb = b[2][0, :k].float().cpu().argmax(-1)
    per_frame = mel.amax(-1)
    parted = torch.nonzero(per_frame > 5e-3).flatten()
    return (f"stops {int(a[3])} / {int(b[3])}; mels max {float(mel.max()):.3e}"
            f" mean {float(mel.mean()):.3e}, first frame past 5e-3: "
            f"{int(parted[0]) if len(parted) else None}; alignments max "
            f"{float(al.max()):.3e} (mean size "
            f"{float(b[2][0, :k].float().abs().mean()):.3e}); argmax paths "
            f"at most {int((pa - pb).abs().max())} apart, on "
            f"{int((pa != pb).sum())} frames; ends at token {int(pa[-1])} / "
            f"{int(pb[-1])} of {n_tok}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default=os.path.join(
        ROOT, "checkpoints", "r4_synth_bf16"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trained_decode_gap: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import subprocess

    from chip_smoke import TRAINED_FRAME_ENDS, TRAINED_MAX_STEPS
    from tacotron2_torch.infer.synthesize import load_model
    from tacotron2_torch.models.decoder import decoder_infer_steps
    from tacotron2_torch.models.encoder import encoder_apply
    from tacotron2_torch.models.tacotron2 import (
        _condition_memory, cast_params_bf16, make_pad_mask)
    from tacotron2_torch.ops.decoder_megakernel import (
        decoder_infer_mega, decoder_infer_mega_reference)
    from tacotron2_torch.text import pad_sequences, text_to_sequence

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cuda = torch.device("cuda")
    model32 = load_model(args.checkpoint, device="cpu")
    for cpu_model in (model32, cast_params_bf16(model32)):
        card_model = copy.deepcopy(cpu_model).to(cuda)
        dtype = str(cpu_model.decoder.attention_lstm.weight_ih.dtype)[6:]
        for text in TRAINED_FRAME_ENDS:
            tokens, lengths = pad_sequences([text_to_sequence(text)],
                                            pad_multiple=16)
            out = {}
            for dev, model in ((cuda, card_model), (torch.device("cpu"),
                                                    cpu_model)):
                with torch.no_grad():
                    tok = torch.from_numpy(tokens).long().to(dev)
                    memory = _condition_memory(
                        model, encoder_apply(model.encoder, tok), None)
                    mask = make_pad_mask(torch.from_numpy(lengths).to(dev),
                                         tok.shape[1])
                    dargs = (model.decoder, memory, TRAINED_MAX_STEPS, 0.5,
                             True, mask, "any", None)
                    if dev.type == "cuda":
                        out["kernel"] = decoder_infer_mega(*dargs)
                        out["loop"] = decoder_infer_steps(*dargs)
                        out["plain"] = decoder_infer_mega_reference(*dargs)
                    else:
                        out["cpu"] = decoder_infer_mega_reference(*dargs)
            n_tok = int(lengths[0])
            print(f"[{dtype} {text!r}]")
            for a, b, what in (
                    ("kernel", "loop", "kernel vs step loop (tail kernel)"),
                    ("loop", "plain", "step loop: tail kernel vs plain"),
                    ("plain", "cpu", "plain step loop: card vs CPU"),
                    ("kernel", "cpu", "kernel vs plain step loop on CPU")):
                print(f"  {what}: {gap(out[a], out[b], n_tok)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
