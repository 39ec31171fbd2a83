#!/usr/bin/env python3
"""Inference scaling measurements of the PyTorch port on one CUDA card.

The counterpart of ``tools/bench_infer_scaling.py``, with its three sweeps
and flags plus ``--device``:

  --sweep mega     the decode kernel (``ops/decoder_megakernel.py``) against
                   the step loop over batch sizes (default 1 8 16 32 64), to
                   forced stops of 300 and 1000 frames; the decoder is
                   switched by ``ModelConfig.decoder_megakernel`` (the JAX
                   tool sets ``TACOTRON2_MEGA_DECODER``).  Per point: wall
                   min and median, ms and RTF per stream, and the device's
                   busy time from ``torch.profiler`` (the sum of the kernels'
                   device time of one call).
  --sweep sharded  ``infer/sharded.py::ShardedSynthesizer`` over
                   ``--n_data`` replicas (default: one a card; replicas may
                   share a card, ``--n_data 2`` on one card puts both on
                   ``cuda:0``) against the unsharded ``synthesize_wav_fused``,
                   in aggregate mel frames a second.
  --sweep buckets  ``infer/fused.py::synthesize_wav_buckets`` at a 300-frame
                   forced stop: wall and real-time factor.

    python tools/bench_infer_scaling_torch.py --sweep mega --bf16
    python tools/bench_infer_scaling_torch.py --sweep sharded --n_data 2 \\
        --batches 8 --cap 1000
    python tools/bench_infer_scaling_torch.py --sweep buckets

Seeded weights (``init_weights(seed=0)``) at the full ``ModelConfig()``
width, as the JAX tool's ``tacotron2_init(PRNGKey(0))``: they never fire
the gate, so the forced stops and the caps end the decodes.  Each sweep is
a function of a built model, so that other weights can be handed in.
XLA's persistent cache (``enable_persistent_cache``) has no counterpart.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))   # runnable from any cwd

import torch  # noqa: E402

SR = 22050.0
HOP = 256.0
SHARDED_TEXT = "The quick brown fox jumps over the lazy dog number %d."


def log_line(msg: str) -> None:
    print(msg, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall(fn: Callable[[], object], iters: int, device: torch.device
         ) -> Tuple[float, float]:
    """(min, median) seconds of ``iters`` calls, each ended by a
    synchronise."""
    ws = []
    for _ in range(iters):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        ws.append(time.perf_counter() - t0)
    return min(ws), float(np.median(ws))


def device_busy_ms(fn: Callable[[], object], n: int,
                   device: torch.device) -> Optional[float]:
    """Mean device milliseconds of one call of ``fn`` over ``n`` calls:
    the sum of the device time of every kernel, copy and memset
    ``torch.profiler`` saw.  Read from the profiler's raw device events:
    parsing them into its event tree takes about a millisecond an event,
    seconds for one step-loop decode.  None off the card (no device time
    to read)."""
    if device.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        sync(device)
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e6 / n


def seeded_model(bf16: bool, device: torch.device):
    """The full-width model on seeded weights (bf16 serving cast on
    request), on ``device``."""
    from tacotron2_torch.config import ModelConfig
    from tacotron2_torch.models.tacotron2 import (Tacotron2, cast_params_bf16,
                                                  init_weights)
    model = init_weights(Tacotron2(ModelConfig()), seed=0)
    if bf16:
        model = cast_params_bf16(model)
    return model.to(device)


# --------------------------------------------------------------------------
# --sweep mega
# --------------------------------------------------------------------------
def mega_tokens(rng: np.random.Generator, b: int, t_enc: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """One call's random token ids (B, t_enc) and their full lengths."""
    return (rng.integers(1, 72, (b, t_enc)).astype(np.int32),
            np.full((b,), t_enc, np.int32))


def mega_run(model, tokens: np.ndarray, lengths: np.ndarray, stop: int,
             device: torch.device, max_steps: int = 1000):
    """One decode of the mega sweep: ``tacotron2_infer`` under stop mode
    "all" with the gate forced at ``stop`` (``stop == max_steps``: the
    whole cap), by whichever decoder the model's config selects.  Waits
    for the card on one scalar of the mels.  Returns (out, n_frames,
    frame_ends)."""
    from tacotron2_torch.models.tacotron2 import tacotron2_infer
    out, n, ends = tacotron2_infer(model, tokens, max_steps=max_steps,
                                   text_lengths=lengths, stop_mode="all",
                                   forced_stop_at=stop, device=device)
    float(out.mel_postnet[0, -1, -1])
    return out, n, ends


def sweep_mega(model, device: torch.device, batches: Sequence[int],
               t_enc: int = 128, iters: int = 5, max_steps: int = 1000,
               stops: Sequence[int] = (300, 1000),
               log: Callable[[str], None] = log_line) -> List[Dict]:
    """The decode kernel, then the step loop, at each batch size and stop.
    Returns one record a point; the model's ``decoder_megakernel`` is left
    as it was."""
    from tacotron2_torch.models.tacotron2 import replace_config
    rng = np.random.default_rng(0)
    was = model.cfg.decoder_megakernel
    records = []
    try:
        for flag in (True, False):
            replace_config(model, decoder_megakernel=flag)
            name = "megakernel" if flag else "step_loop"
            for b in batches:
                mega_run(model, *mega_tokens(rng, b, t_enc), max_steps,
                         device, max_steps)           # first call, untimed
                for frames in stops:
                    ends = []

                    def run():
                        ends[:] = mega_run(model, *mega_tokens(rng, b, t_enc),
                                           frames, device, max_steps)[2]

                    w, med = wall(run, iters, device)
                    dev = device_busy_ms(run, 1, device)
                    audio = frames * HOP / SR
                    per = w / b
                    rec = dict(decoder=name, b=b, stop=frames,
                               wall_ms=w * 1e3, median_ms=med * 1e3,
                               ms_per_stream=per * 1e3,
                               rtf_per_stream=per / audio,
                               device_busy_ms=dev,
                               frame_ends=[int(e) for e in ends])
                    records.append(rec)
                    devs = ("" if dev is None else
                            f", device busy {dev:8.2f} ms "
                            f"({dev / 1e3 / b / audio:.5f} RTF/stream)")
                    log(f"{name} B={b} stop={frames}: wall "
                        f"{w * 1e3:8.1f} ms (median {med * 1e3:8.1f}) -> "
                        f"{per * 1e3:7.2f} ms/stream, per-stream RTF "
                        f"{per / audio:.5f}{devs}")
    finally:
        replace_config(model, decoder_megakernel=was)
    return records


# --------------------------------------------------------------------------
# --sweep sharded
# --------------------------------------------------------------------------
def sweep_sharded(model, cfg, devices: Sequence, batches: Sequence[int],
                  cap: int = 1000, iters: int = 5,
                  n_data: Optional[int] = None,
                  log: Callable[[str], None] = log_line) -> List[Dict]:
    """The unsharded fused pipeline on ``devices[0]``, then
    ``ShardedSynthesizer`` over ``n_data`` replicas on the first ``n_data``
    of ``devices`` (default all), each at every batch size, decoded to the
    cap under stop mode "all".  Returns one record a point."""
    from tacotron2_torch.infer.fused import _fetch, synthesize_wav_fused
    from tacotron2_torch.infer.sharded import ShardedSynthesizer
    from tacotron2_torch.infer.vocode import GriffinLim
    from tacotron2_torch.parallel import make_mesh
    from tacotron2_torch.text import pad_sequences, text_to_sequence

    devices = [torch.device(d) for d in devices]
    lead = devices[0]
    texts = [SHARDED_TEXT % i for i in range(max(batches))]
    seqs = [text_to_sequence(t) or [0] for t in texts]
    tokens, lengths = pad_sequences(seqs, pad_multiple=16)
    records = []
    for b in batches:
        def run():
            wav, *_ = synthesize_wav_fused(
                model, GriffinLim(cfg.audio), cfg.audio, tokens[:b],
                lengths[:b], None, max_steps=cap, stop_mode="all",
                device=lead)
            _fetch(wav)

        run()
        w, med = wall(run, iters, lead)
        fps = b * cap / w
        records.append(dict(path="unsharded", b=b, cap=cap, wall_s=w,
                            median_s=med, frames_per_s=fps))
        log(f"unsharded fused B={b} cap={cap}: wall {w:7.3f} s (median "
            f"{med:7.3f}) -> {fps / 1e3:7.1f}k frames/s aggregate")

    n_data = n_data or len(devices)
    mesh = make_mesh(n_data=n_data, n_model=1, devices=devices[:n_data])
    with ShardedSynthesizer(model, mesh, cfg) as synth:
        for b in batches:
            run = lambda: synth(texts[:b], max_steps=cap)
            run()
            w, med = wall(run, iters, lead)
            fps = b * cap / w
            records.append(dict(path=f"sharded({n_data})", b=b, cap=cap,
                                wall_s=w, median_s=med, frames_per_s=fps))
            log(f"sharded({n_data}) B={b} cap={cap}: wall {w:7.3f} s "
                f"(median {med:7.3f}) -> {fps / 1e3:7.1f}k frames/s "
                f"aggregate (incl. host G2P + trim)")
    return records


# --------------------------------------------------------------------------
# --sweep buckets
# --------------------------------------------------------------------------
def buckets_tokens(n: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """The buckets sweep's one request: ``n`` random token ids."""
    rng = np.random.default_rng(0)
    return (rng.integers(1, 72, (1, n)).astype(np.int32),
            np.full((1,), n, np.int32))


def buckets_run(model, acfg, tokens: np.ndarray, lengths: np.ndarray,
                stop: Optional[int], device: torch.device,
                max_steps: int = 1000, gl_iters: int = 60):
    """One call of the length-proportional pipeline; returns (int16 PCM
    on the host, frame_ends)."""
    from tacotron2_torch.infer.fused import _fetch, synthesize_wav_buckets
    pcm, ends = synthesize_wav_buckets(model, acfg, tokens, lengths, None,
                                       max_steps=max_steps, gl_iters=gl_iters,
                                       forced_stop_at=stop, device=device)
    return _fetch(pcm)[0], ends


def sweep_buckets(model, cfg, device: torch.device, iters: int = 5,
                  stop: int = 300, max_steps: int = 1000,
                  log: Callable[[str], None] = log_line) -> Dict:
    """The bucketed pipeline on one 64-token request stopped at ``stop``.
    Returns its record."""
    tokens, lengths = buckets_tokens()
    run = lambda: buckets_run(model, cfg.audio, tokens, lengths, stop,
                              device, max_steps)
    n = int(run()[1][0])
    w, med = wall(run, iters, device)
    audio = n * HOP / SR
    log(f"bucketed earlystop{stop}: wall {w:.4f} s (median {med:.4f}) over "
        f"{audio:.2f} s audio -> RTF {w / audio:.5f} "
        f"(median {med / audio:.5f})")
    return dict(frames=n, wall_s=w, median_s=med, rtf=w / audio,
                median_rtf=med / audio)


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", choices=("mega", "sharded", "buckets"),
                    required=True)
    ap.add_argument("--batches", type=int, nargs="+",
                    default=[1, 8, 16, 32, 64])
    ap.add_argument("--t_enc", type=int, default=128)
    ap.add_argument("--cap", type=int, default=1000)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--n_data", type=int, default=None,
                    help="sharded sweep: replicas (default: one a card; "
                         "more than the cards share them)")
    ap.add_argument("--bf16", action="store_true",
                    help="mega sweep: cast weights to bf16 (serving mode)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from tacotron2_torch.config import Config
    from tacotron2_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    cfg = Config()
    if args.sweep == "mega":
        model = seeded_model(args.bf16, device)
        return sweep_mega(model, device, args.batches, args.t_enc,
                          args.iters)
    model = seeded_model(False, device)
    if args.sweep == "buckets":
        return [sweep_buckets(model, cfg, device, args.iters)]
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 1
    n_data = args.n_data or n_cards
    devices = [device if device.type == "cpu"
               else torch.device("cuda", i % n_cards) for i in range(n_data)]
    return sweep_sharded(model, cfg, devices, args.batches, args.cap,
                         args.iters, n_data)


if __name__ == "__main__":
    main()
