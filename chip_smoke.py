#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tacotron2_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when
it fails:

1. require CUDA; print the card's name and power limit (``nvidia-smi``);
2. turn TF32 off for matrix products and convolutions;
3. build the kernels from ``tacotron2_torch/csrc`` (nvcc into
   ``tacotron2_torch/_build/``; the Triton kernel compiles at its first
   launch);
4. the Triton ``attention_tail`` against its plain version at full width
   (A=128, D=512, T_enc in {37, 128, 200}, B in {1, 16, 64}, fp32 and bf16
   ``qsum``);
5. the CUDA ``decoder_infer_mega`` against the plain step loop at the full
   ``ModelConfig()`` width on seeded weights (fp32 and bf16 weights,
   B in {1, 8}, T_enc=128 with a ragged mask, both stop modes, first frame
   dropped and kept, ``max_steps=400``, ``forced_stop_at=300``), with one
   limit per output (``DEC_TOL``);
6. the main path: seeded token sequences through ``synthesize_mels``
   (bf16 weights), batched and one by one, with the decode kernel on and
   off; the launch counters are zeroed before and read after, the outputs
   are checked for shape and finiteness, against each other and against a
   CPU run of the plain path on a short input;
7. each kernel against its plain version at the main path's own shapes
   and inputs: the decode kernel on the batched request and on each
   request alone (frame_ends exactly, each output within its own limit),
   the attention kernel on the inputs of every step of the same decodes;
   then one ``{"kernels": [...]}`` line: per kernel its launches on the
   main path, its error there (and over the sweeps of phases 4-5), its
   time, the plain version's, and the bound (the larger of bytes over
   3.35 TB/s and operations over the peak rate of their type, H100 SXM
   data sheet).

The last line is ``{"ok": true, "device": {...}}``.  Imports nothing of
JAX or of ``tacotron2_tpu``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS = {torch.float32: 67e12,  # fp32 outside the tensor cores
            torch.bfloat16: 989e12}  # bf16 tensor cores, dense
TAIL_TOL = 1e-5         # fp32 sums over <= 200 positions, other order
# decode kernel vs plain step loop, one limit per output.  Typical sizes at
# full width on seeded weights: mels and gate logits ~0.1-1, alignments
# ~1/T_enc (~1e-2).  fp32: the same products summed in another order;
# bf16 adds the composed location matrix, rounded once in the kernel and
# per step in the plain conv.
DEC_OUTPUTS = ("mels", "gates", "aligns")
DEC_TOL = {torch.float32: {"mels": 1e-4, "gates": 1e-4, "aligns": 1e-5},
           torch.bfloat16: {"mels": 5e-3, "gates": 5e-3, "aligns": 1e-3}}
MAIN_TOL = 5e-2         # bf16 postnet mels, kernel vs step loop / CPU
MAX_STEPS = 400
FORCED_STOP = 300
SEED = 0


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, n: int, warm: int = 2) -> float:
    """Mean milliseconds per call from CUDA events over ``n`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n: int, kernel: str):
    """Mean device milliseconds per call spent in the kernels whose name
    holds ``kernel``, from torch.profiler; None where it saw no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if kernel in e.key)
    return us / n / 1e3 if us > 0 else None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def max_err(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def compare_decode(got, ref, dtype, where: str):
    """Hold a decode kernel's returns against the plain step loop's:
    n_frames and frame_ends exactly, the rows past the stop exactly, and
    each output's stopped rows within its own limit.  Returns
    {output: max abs error}."""
    n = int(ref[3])
    check(int(got[3]) == n, f"{where}: n_frames {int(got[3])} != {n}")
    check(torch.equal(got[4], ref[4]), f"{where}: frame_ends "
          f"{got[4].tolist()} != {ref[4].tolist()}")
    errs = {}
    for name, g, r in zip(DEC_OUTPUTS, got[:3], ref[:3]):
        check(torch.equal(g[:, n:], r[:, n:]),
              f"{where}: {name} past the stop differ")
        errs[name] = float((g[:, :n].float() - r[:, :n].float()).abs().max())
    tol = DEC_TOL[dtype]
    print(f"[{where}] n_frames {n}, frame_ends {ref[4].tolist()}; max err "
          + ", ".join(f"{k} {errs[k]:.3e} (tol {tol[k]:g}, mean |ref| "
                      f"{float(r[:, :n].float().abs().mean()):.3e})"
                      for k, r in zip(DEC_OUTPUTS, ref[:3])), flush=True)
    for k in DEC_OUTPUTS:
        check(errs[k] <= tol[k], f"{where}: {k} error {errs[k]} > {tol[k]}")
    return errs


def bound(n_bytes: float, n_ops: float, dtype: torch.dtype):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's kernels run "
              "only on a CUDA card", file=sys.stderr)
        return 2
    from tacotron2_torch.config import ModelConfig
    from tacotron2_torch.infer.synthesize import synthesize_mels
    from tacotron2_torch.models.decoder import decoder_infer_steps
    from tacotron2_torch.models.encoder import encoder_apply
    from tacotron2_torch.models.postnet import postnet_apply
    from tacotron2_torch.models.tacotron2 import (
        Tacotron2, _condition_memory, cast_params_bf16, init_weights,
        make_pad_mask)
    from tacotron2_torch.ops import _build
    from tacotron2_torch.ops.attention_kernel import (
        attention_tail, attention_tail_reference)
    from tacotron2_torch.ops.decoder_megakernel import (
        decoder_infer_mega, decoder_infer_mega_reference, weight_bytes)
    from tacotron2_torch.text.frontend import pad_sequences

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={torch.cuda.current_device()}"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    # 2. no TF32 anywhere: the plain versions are the fp32 reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 3. build
    t0 = time.time()
    for name, log in _build.build().items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"built {name}: {'; '.join(regs)}")
    gen = torch.Generator().manual_seed(SEED)
    q = torch.randn(2, 37, 128, generator=gen).to(dev)
    attention_tail(q, q[0, 0], q[0, 0, 0], q[0, 0, 1],
                   torch.zeros(2, 37, dtype=torch.bool, device=dev),
                   torch.randn(2, 37, 512, device=dev))
    torch.cuda.synchronize()
    print(f"[build] kernels built and loaded in {time.time() - t0:.1f} s",
          flush=True)

    # 4. attention_tail kernel vs plain
    def tail_inputs(b, t, dtype, seed):
        g = torch.Generator().manual_seed(seed)
        lens = torch.randint(t // 2, t + 1, (b,), generator=g)
        lens[0] = t
        return (torch.randn(b, t, 128, generator=g).to(dev, dtype),
                (torch.randn(128, generator=g) * 0.3).to(dev),
                torch.tensor(0.1, device=dev), torch.tensor(1.2, device=dev),
                make_pad_mask(lens, t).to(dev),
                torch.randn(b, t, 512, generator=g).to(dev))

    tail_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for t in (37, 128, 200):
            for b in (1, 16, 64):
                ins = tail_inputs(b, t, dtype, seed=b * 1000 + t)
                got = attention_tail(*ins)
                ref = attention_tail_reference(*ins)
                err = max_err(got, ref)
                tail_err = max(tail_err, err)
                ms = time_ms(lambda: attention_tail(*ins), 200)
                dev_ms = device_ms(lambda: attention_tail(*ins), 50,
                                   "attention_tail_kernel")
                plain = time_ms(lambda: attention_tail_reference(*ins), 50)
                print(f"[attention_tail] {str(dtype)[6:]:8s} B={b:2d} "
                      f"T_enc={t:3d}: max err {err:.3e}, kernel {ms:.4f} ms "
                      f"per call (device {fmt_ms(dev_ms)}), plain "
                      f"{plain:.4f} ms",
                      flush=True)
                check(err <= TAIL_TOL, f"attention_tail error {err} > "
                      f"{TAIL_TOL} at B={b} T={t} {dtype}")

    # 5. decoder_infer_mega kernel vs plain step loop, full width
    cfg = ModelConfig()
    base = init_weights(Tacotron2(cfg), seed=SEED)
    dec_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        m = base if dtype == torch.float32 else cast_params_bf16(base)
        dec = copy.deepcopy(m.decoder).to(dev)
        for b in (1, 8):
            g = torch.Generator().manual_seed(100 + b)
            memory = (torch.randn(b, 128, cfg.encoder_embedding_dim,
                                  generator=g) * 0.5).to(dev)
            lens = torch.tensor([128 - 37 * (i % 3) for i in range(b)])
            mask = make_pad_mask(lens, 128).to(dev)
            for stop_mode in ("any", "all"):
                for drop in (True, False):
                    args = (dec, memory, MAX_STEPS, cfg.gate_threshold, drop,
                            mask, stop_mode, FORCED_STOP)
                    with torch.no_grad():
                        got = decoder_infer_mega(*args)
                        ref = decoder_infer_mega_reference(*args)
                    torch.cuda.synchronize()
                    where = (f"decoder_infer_mega {str(dtype)[6:]} B={b} "
                             f"{stop_mode} drop_first={drop}")
                    errs = compare_decode(got, ref, dtype, where)
                    dec_err[dtype] = max(dec_err.get(dtype, 0.0),
                                         *errs.values())
                    with torch.no_grad():
                        ms = time_ms(lambda: decoder_infer_mega(*args), 1,
                                     warm=0)
                    steps = int(got[3]) + int(drop)
                    print(f"[{where}] {ms:.3f} ms, {ms * 1e3 / steps:.1f} "
                          f"us/step, grid {decoder_infer_mega.last_grid_blocks}"
                          f" blocks", flush=True)
        del dec

    # 6. the main path: requests through synthesize_mels, bf16 weights
    model = cast_params_bf16(base).to(dev)
    rng = np.random.default_rng(SEED)
    seqs = [rng.integers(0, cfg.n_symbols, n).tolist()
            for n in rng.integers(20, 121, 4)]
    print(f"[main] {len(seqs)} requests of {[len(s) for s in seqs]} tokens, "
          f"max_steps {MAX_STEPS}, bf16 weights", flush=True)

    def set_megakernel(on: bool) -> None:
        c = dataclasses.replace(model.cfg, decoder_megakernel=on)
        model.cfg = c
        model.decoder.cfg = c

    def serve(on: bool):
        """Batched, then one request at a time; per-run wall seconds."""
        set_megakernel(on)
        runs = []
        for batch in [seqs] + [[s] for s in seqs]:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            mels, aligns = synthesize_mels(model, batch, max_steps=MAX_STEPS)
            runs.append((mels, aligns, time.perf_counter() - t1))
        return runs

    # warm-up outside the counted run (first launch of each path)
    synthesize_mels(model, seqs[:1], max_steps=4)
    set_megakernel(False)
    synthesize_mels(model, seqs[:1], max_steps=4)

    launches = {}
    results = {}
    for on in (True, False):
        decoder_infer_mega.launches = 0
        attention_tail.launches = 0
        results[on] = serve(on)
        launches[on] = (decoder_infer_mega.launches, attention_tail.launches)
        path = "decode kernel" if on else "step loop + attention kernel"
        frames = sum(m.shape[0] for mels, _, _ in results[on] for m in mels)
        batched, single = results[on][0], results[on][1:]
        steps_b = batched[1].shape[1]
        steps_s = sum(a.shape[1] for _, a, _ in single)
        print(f"[main] {path}: launches decoder_infer_mega="
              f"{launches[on][0]} attention_tail={launches[on][1]}; "
              f"batched B={len(seqs)}: {batched[2] * 1e3 / steps_b:.3f} ms/"
              f"step, {sum(m.shape[0] for m in batched[0]) / batched[2]:.1f} "
              f"frames/s; one by one: "
              f"{sum(r[2] for r in single) * 1e3 / steps_s:.3f} ms/step; "
              f"all runs {frames / sum(r[2] for r in results[on]):.1f} "
              f"frames/s", flush=True)
        for mels, aligns, _ in results[on]:
            for mel in mels:
                check(mel.ndim == 2 and mel.shape[1] == cfg.n_mels
                      and mel.shape[0] >= 1, f"mel shape {mel.shape}")
                check(bool(np.isfinite(mel).all()), "non-finite mel")
            check(bool(np.isfinite(aligns).all()), "non-finite alignment")
    check(launches[True][0] == 1 + len(seqs) and launches[True][1] == 0,
          f"decode kernel run launched {launches[True]}")
    check(launches[False][0] == 0 and launches[False][1] > 0,
          f"step-loop run launched {launches[False]}")

    # the two decode paths, and batched vs one by one, agree
    main_err = 0.0
    for i in range(len(seqs)):
        outs = [results[on][0][0][i] for on in (True, False)] + [
            results[on][1 + i][0][0] for on in (True, False)]
        for o in outs[1:]:
            check(o.shape == outs[0].shape,
                  f"request {i}: frame counts differ {o.shape} "
                  f"{outs[0].shape}")
            main_err = max(main_err, float(np.abs(o - outs[0]).max()))
    print(f"[main] kernel vs step loop, batched vs one by one: max err "
          f"{main_err:.3e} (tol {MAIN_TOL})")
    check(main_err <= MAIN_TOL, f"main path outputs differ by {main_err}")

    # where one batched request's time goes (decode kernel on)
    from torch.profiler import ProfilerActivity, profile
    set_megakernel(True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        synthesize_mels(model, seqs, max_steps=MAX_STEPS)
        wall_ms = (time.perf_counter() - t1) * 1e3
    by_kernel = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                        for e in prof.key_averages()
                        if e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(ms for ms, _, _ in by_kernel)
    print(f"[main] profile of one batched request: wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms (idle share "
          f"{1 - busy_ms / wall_ms:.3f}); by device time: "
          + "; ".join(f"{k[:48]} x{n} {ms:.3f} ms"
                      for ms, n, k in by_kernel[:6]), flush=True)

    # against the plain path on the CPU, on a short input
    cpu_model = cast_params_bf16(base)
    short = [seqs[0][:24]]
    set_megakernel(True)
    ref_mels, _ = synthesize_mels(cpu_model, short, max_steps=24,
                                  device="cpu")
    got_mels, _ = synthesize_mels(model, short, max_steps=24)
    check(ref_mels[0].shape == got_mels[0].shape, "CPU reference frames")
    cpu_err = float(np.abs(ref_mels[0] - got_mels[0]).max())
    print(f"[main] card vs CPU plain path, 24 tokens x 24 steps: max err "
          f"{cpu_err:.3e} (tol {MAIN_TOL})")
    check(cpu_err <= MAIN_TOL, f"card and CPU differ by {cpu_err}")

    # 7. each kernel against its plain version at the main path's own
    # shapes and inputs: the batched request (B=4 at its padded T_enc) and
    # each request alone (B=1 at its own T_enc), as synthesize_mels calls
    # them; then times and bounds at the batched shapes
    dec = model.decoder
    cdt = dec.attention_lstm.weight_ih.dtype
    main_dec_err = main_tail_err = 0.0
    for batch in [seqs] + [[s] for s in seqs]:
        tokens, lengths = pad_sequences(batch, pad_multiple=16)
        with torch.no_grad():
            tok = torch.from_numpy(tokens).long().to(dev)
            memory = _condition_memory(
                model, encoder_apply(model.encoder, tok), None)
        mask = make_pad_mask(torch.from_numpy(lengths).to(dev), tok.shape[1])
        b, t_enc = memory.shape[:2]
        where = f"main B={b} T_enc={t_enc}"
        dargs = (dec, memory, MAX_STEPS, cfg.gate_threshold, True, mask,
                 "all" if b > 1 else "any", None)
        with torch.no_grad():
            got = decoder_infer_mega(*dargs)
            ref = decoder_infer_mega_reference(*dargs)
        errs = compare_decode(got, ref, cdt, f"{where} decode kernel")
        main_dec_err = max(main_dec_err, *errs.values())

        # the attention kernel on every step's own inputs: the plain step
        # loop carries the plain tail's output forward, the kernel gets the
        # same qsum, mask and memory
        step_ins, step_errs = [], []

        def checked_tail(*ins):
            plain = attention_tail_reference(*ins)
            step_errs.append(max_err(attention_tail(*ins), plain))
            step_ins.append(ins)
            return plain

        with torch.no_grad():
            decoder_infer_steps(*dargs, tail=checked_tail)
        tail_err_here = max(step_errs)
        print(f"[{where} attention_tail] on the inputs of {len(step_errs)} "
              f"steps: max err {tail_err_here:.3e} (tol {TAIL_TOL})",
              flush=True)
        check(tail_err_here <= TAIL_TOL, f"{where}: attention_tail error "
              f"{tail_err_here} > {TAIL_TOL}")
        main_tail_err = max(main_tail_err, tail_err_here)
        if b > 1:
            batched = (tok, memory, mask, dargs, step_ins[len(step_ins) // 2])
    tok, memory, mask, dargs, tail_args = batched
    b, t_enc, e = memory.shape
    n_steps = results[True][0][1].shape[1] + 1    # + the dropped frame
    with torch.no_grad():
        dec_ms = time_ms(lambda: decoder_infer_mega(*dargs), 5, warm=1)
        dec_dev_ms = device_ms(lambda: decoder_infer_mega(*dargs), 3,
                               "decoder_infer_kernel")
        dec_plain_ms = time_ms(lambda: decoder_infer_mega_reference(*dargs),
                               1, warm=0)
        enc_ms = time_ms(lambda: encoder_apply(model.encoder, tok), 3)
        coarse = torch.randn(b, cfg.n_mels, n_steps - 1, device=dev)
        post_ms = time_ms(lambda: postnet_apply(model.postnet, coarse), 3)
    print(f"[main] batched request by part (CUDA events): encoder "
          f"{enc_ms:.3f} ms, decode kernel {dec_ms:.3f} ms, postnet "
          f"{post_ms:.3f} ms")
    h, a, m_ = cfg.decoder_rnn_dim, cfg.attention_dim, cfg.n_mels
    p, k = cfg.prenet_dim, cfg.location_kernel_size
    wbytes = weight_bytes(dec)
    macs_step = b * (m_ * p + p * p + 4 * h * (p + e + h) + a * h
                     + 4 * h * (h + e + h) + (m_ + 1) * (h + e)
                     + t_enc * (2 * k * a + 2 * a + e))
    dec_bound = bound(
        wbytes + memory.numel() * cdt.itemsize + b * t_enc * (a * 4 + 1)
        + b * MAX_STEPS * (m_ + 1 + t_enc) * 4,
        2 * macs_step * n_steps, cdt)

    qsum = tail_args[0]     # a middle step's own, from the check above
    tail_ms = time_ms(lambda: attention_tail(*tail_args), 500)
    tail_dev_ms = device_ms(lambda: attention_tail(*tail_args), 100,
                            "attention_tail_kernel")
    tail_plain_ms = time_ms(lambda: attention_tail_reference(*tail_args), 100)
    tail_bound = bound(
        qsum.numel() * qsum.element_size() + memory.numel() * 4
        + b * t_enc * (1 + 4) + a * 4 + b * e * 4,
        b * t_enc * (3 * a + 5 + 2 * e), torch.float32)
    print(f"[kernels] at the batched main path's shapes: B={b} T_enc={t_enc} "
          f"{str(cdt)[6:]}, decode of {n_steps} steps "
          f"(weights {wbytes / 1e6:.1f} MB, re-read every step: "
          f"{n_steps * wbytes / HBM_BYTES_PER_S * 1e3:.3f} ms)")
    kernels = [
        dict(name="attention_tail", route="triton",
             source="tacotron2_torch/csrc/attention_tail.py",
             replaces="tacotron2_tpu/ops/attention_kernel.py:166",
             launches=launches[False][1], max_abs_err=main_tail_err,
             sweep_max_abs_err=tail_err,
             ms=tail_ms, plain_ms=tail_plain_ms, bound_ms=tail_bound[0],
             bound_by=tail_bound[1], library_ms=None,
             device_ms=tail_dev_ms,
             shape=f"B={b} T_enc={t_enc} A={a} D={e} qsum {str(cdt)[6:]}"),
        dict(name="decoder_infer_mega", route="cuda",
             source="tacotron2_torch/csrc/decoder_infer.cu",
             replaces="tacotron2_tpu/ops/decoder_megakernel.py:317",
             launches=launches[True][0],
             max_abs_err=main_dec_err,
             sweep_max_abs_err=max(dec_err.values()),
             ms=dec_ms, plain_ms=dec_plain_ms, bound_ms=dec_bound[0],
             bound_by=dec_bound[1], library_ms=None,
             device_ms=dec_dev_ms,
             step_stream_bound_ms=n_steps * wbytes / HBM_BYTES_PER_S * 1e3,
             shape=f"B={b} T_enc={t_enc} steps={n_steps} "
                   f"weights {str(cdt)[6:]}"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
