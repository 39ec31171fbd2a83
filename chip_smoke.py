#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tacotron2_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when
it fails:

1. require CUDA; print the card's name and power limit (``nvidia-smi``);
2. turn TF32 off for matrix products and convolutions;
3. build the kernels from ``tacotron2_torch/csrc`` (one nvcc a source,
   all started together, into ``tacotron2_torch/_build/``), with each
   kernel's registers and the attention tail's shared memory a block;
4. the CUDA ``attention_tail`` against its plain version at full width
   (A=128, D=512, T_enc in {37, 128, 200, 600}, B in {1, 16, 64}, fp32 and
   bf16 ``qsum``), each with its plan (cluster split, rows a block, rows
   a tile), its device time from a CUDA graph of 20 calls and its time a
   call;
5. the CUDA ``decoder_infer_mega`` against the plain step loop at the full
   ``ModelConfig()`` width on seeded weights (fp32 and bf16 weights,
   B in {1, 8}, T_enc=128 with a ragged mask, both stop modes, first frame
   dropped and kept, ``max_steps=400``, ``forced_stop_at=300``), with one
   limit per output (``DEC_TOL``); then, in each type, decodes that the
   gate itself stops (``gate_stop_offset``: a gate-bias offset picked from
   the plain loop's own logits, B=8, at least two rows stopping at
   different frames by frame 200, every logit four times this type's
   largest gate error of the sweep at B=8 from the threshold up to its
   stop: seeded weights' logits move by about 1e-4 a frame, too little for
   ten times the gate limit), kernel
   against plain loop under both stop modes, ``frame_ends`` exactly;
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
   data sheet), printed after phase 10 with all five kernels;
8. the CUDA ``decoder_fwd_train_mega`` (the teacher-forced decoder forward)
   against its plain version at full width on seeded weights: B in
   {2, 5, 16} (5: a padded M tile in the reverse chain's products),
   T_enc=128 with a ragged mask, T_dec=64, fp32 and bf16, dropout 0.1/0.1
   with seeded masks and once with dropout off; all nine outputs, each
   with its own limit (``FWD_TOL``);
9. the CUDA ``decoder_bwd_chain_mega`` (the split-BPTT reverse chain)
   against its plain version on the series phase 8 stored and seeded
   cotangents: all nine outputs, each with its own limit (``BWD_TOL``;
   at bf16 B=5 ``scal`` is printed beside the plain version run on the
   CPU instead, which misses that limit itself there), and two runs bit
   for bit; then the whole ``decoder_scan_bptt``
   gradient (parameters, prenet frames, memory, pm) at B=2, T_dec=32 in
   fp32: kernel pair against plain pair, and against ``torch.autograd``
   through the plain step loop;
10. the training main path: ``create_train_state`` at the full
    ``ModelConfig()`` width with ``precision="bfloat16"``, a batch collated
    from seeded token ids and log-mels (B=16, T_enc=128, T_dec=512, ragged
    lengths), ``init_projection_bias``, three ``train_step``s (the first
    with the postnet bypassed), one ``train_step_accum`` of two
    micro-batches of 8 and one ``eval_step``, with the launch counters
    zeroed before and read after; before it, on the same batch and masks,
    the first step's gradients by the kernel route against the plain
    route, and both kernels against their plain versions on that step's
    own inputs; after the counted run, ``attention_tail`` against its
    plain version on the inputs of every step of one more ``eval_step``;
11. the CUDA ``conv_bn_act`` (eval Conv1d + BatchNorm + activation, folded)
    against its plain version at full width: (C_in, C_out) in {(512, 512),
    (80, 512), (512, 80)}, K=5, T in {1, 37, 128, 1000}, B in {1, 4, 16},
    relu, tanh and none, fp32 and bf16 weights, seeded non-identity
    BatchNorm statistics; the limit (``CONV_TOL``) is a share of the plain
    output's mean size;
12. the text -> PCM main path on seeded weights at the full
    ``ModelConfig()`` width (bf16 serving cast, decode kernel and fused
    convs on; random weights never fire the gate, so ``max_steps=400`` and
    ``forced_stop_at`` end the decodes, and the audio is that of seeded
    weights, not speech): four fixed sentences (one with a number, one with
    an out-of-lexicon word) through ``synthesize_wav`` batched; one by one
    through ``synthesize_pcm_proportional``, once with ``forced_stop_at``
    inside the bucket picked from the text length (no escalation) and once
    without (one escalation to ``max_steps``); and one through
    ``synthesize`` from a ``state_dict`` the script saves under a
    temporary directory into a WAV there, with the launch counters zeroed
    before and read after.  The lexicon and both LTS tables are loaded,
    token ids equal the pinned ones (``tests/test_torch_text.py`` pins the
    same), ``frame_ends`` equal ``forced_stop_at`` or ``max_steps`` as the
    stop rule says, PCM is int16 of length bucket x hop, finite, not silent
    before the stop and at the floor after it, the WAV reads back; then
    wall time, frames, seconds of audio and real-time factor per sentence,
    and wall, device busy and idle share of each part of a request; then
    ``decoder_infer_mega`` against the plain step loop on this path's own
    decodes (the batched request; each sentence alone capped at the bucket
    with the forced stop, capped without, and at ``max_steps``; and, on the
    fp32 model ``load_model`` gives from the same file, the ``synthesize``
    request's two decodes);
13. ``conv_bn_act`` at the main paths' own shapes and inputs: each of the
    eight layers of the batched request and of one single request, kernel
    against plain version on that layer's real input, with its time, the
    plain version's, cuDNN's on the folded weights (``library_ms``, and
    its kernels' device time, both kernels' from a CUDA graph of 20 calls)
    and the bound; the same comparison, untimed, on every layer of phase
    6's requests, batched and one by one, and of the fp32 ``synthesize``
    request at both its lengths; then the kernel route against the unfused
    (cuDNN, TF32 off) route for the whole request (``frame_ends`` and
    mels).

14. trained weights: ``checkpoints/r4_synth_bf16`` read by
    ``load_model`` without JAX (the zstd decompressor it used and the
    load's time printed), cast to bf16; the four sentences of
    ``TRAINED_FRAME_ENDS`` decoded one at a time, ``max_steps=256``, by
    ``decoder_infer_mega`` and by the plain step loop, with no forced stop
    and no gate offset: the gate fires by itself in both, within
    ``STOP_SLACK`` frames of the JAX package's stop and of each other, the
    mels and alignments over the shared frames within ``DEC_TOL`` /
    ``DEC_ALIGN_SHARE``, and the alignment's argmax path ends within
    ``STOP_SLACK`` of the last token; wall time and real-time factor per
    sentence; one ``synthesize(text, checkpoint directory)`` to a WAV;
15. the training loop: a corpus of 24 + 8 utterances written here from
    a seed (``data/synth_corpus.py``), ``train()`` at the full
    ``ModelConfig()`` width in bf16 over fp32 masters, batch 8, for two
    epochs with validation and ``save_every_steps=2``; then one epoch,
    and a resume from ``tacotron2_epoch_1`` for the second, which must end
    equal to the unbroken run bit for bit (weights, BatchNorm statistics,
    moments, counters, the dropout generator); the launches of the
    teacher-forced forward and the reverse chain equal the steps, and
    validation launches the attention tail; ``best_model`` is a full
    checkpoint; a resume from ``checkpoints/r4_synth_bf16`` starts at epoch
    0 with fresh moments and finite losses; then the mean step time
    (``StepTimer``), one step's device busy share and a full checkpoint's
    save and restore times;
16. widths the kernels were not written for: a seeded model whose every
    decoder width is no multiple of 8 (the decoder kernels run it
    zero-padded to multiples of 8), with an attention width of 14 and a
    120-byte memory row for the attention tail and even conv kernel sizes
    (6 in the encoder, 4 in the postnet): ``tacotron2_infer`` on the card
    against the CPU's plain request, ``decoder_scan_bptt``'s gradients on
    the card against the CPU's plain pair, and ``attention_tail`` at A=14,
    D=30 (and with a ``memory`` one element past a 16-byte boundary)
    against its plain version; the decode, conv and training kernels must
    each launch; and an encoder of 11 taps (the conv kernel's halo-8 build)
    on the card against the CPU's plain encoder.  Then the configs each
    kernel refused before the repair of C6 (``c6_widths``): a bf16
    ``train_step`` at ``attention_dim`` 512 and one at 95 location taps
    (B=8: the first step's gradients by both routes, ``GRAD_TOL``; #3 and
    #4 against their plain versions on that step's inputs,
    ``MAIN_PAIR_TOL``, the reverse chain's location phase in chunks of A;
    one counted step, #3 and #4 once each); a model with 65-tap encoder
    and postnet convs, ``attention_dim`` 512 and 95 location taps served
    in fp32 (#2 with its location matrix in L2, #5 in three tap groups)
    against the CPU's plain request, its eight conv layers against the
    plain version, and its ``eval_step`` by the fused route against the
    cuDNN route (``C6_EVAL_TOL``); ``conv_bn_act`` at 65 and 129 taps,
    512->512, B=4, T=400, both types (``CONV_TOL``); ``attention_tail`` at
    D=16392 fp32 (the wide kernel, ``TAIL_TOL``); each with its launches
    and device time;
17. serving, on the checkpoint of phase 14: ``serve()``'s handler on a
    ``BatchingTTSService`` (bf16, ``max_batch=8``) in a thread, with a
    seeded HiFi-GAN generator saved in NGC's weight-normed layout and
    named by ``HIFIGAN_CHECKPOINT``; after one warm-up request a vocoder,
    with the launch counters zeroed: eight concurrent ``POST /synthesize``
    (the four sentences twice, half Griffin-Lim, half HiFi-GAN), each 200
    with a WAV of ``frame_end x 256`` samples within ``STOP_SLACK`` of the
    pinned stops, ``/healthz`` showing a coalesced batch, the peak device
    memory; the same eight one at a time (p50 and max latency at both
    concurrencies, seconds of audio per wall second); ``POST
    /synthesize_streaming`` with Griffin-Lim, the service's bf16 HiFi-GAN
    and an fp32 one (time to the first chunk; the attention tail's inputs
    recorded); ``synthesize_longform`` of the four sentences with
    HiFi-GAN; ``inference_torch.py`` and ``serve_torch.py`` as processes
    (one WAV; one answered request, then SIGTERM and exit 0); then the
    counters read (each of ``decoder_infer_mega``, ``conv_bn_act`` and
    ``attention_tail`` above zero), and each kernel held on this path's
    inputs: the batched decode against the plain step loop (bf16 as phase
    14 holds it, and the fp32 model to ``DEC_TOL``), the tail on every
    recorded step (``TAIL_TOL``), the eight conv layers of one request
    (``CONV_TOL``: trained layers, whose largest sums stand further above
    their outputs' mean than the seeded ones of ``CONV_MAIN_TOL``); the
    streamed HiFi-GAN PCM against the one-shot PCM of the same mel (fp32
    generator, one LSB; the bf16 generator ``STREAM_BF16_LSB``); the
    generator on the card against the CPU's, bf16 against fp32,
    ``vocoder_chunk_frames=64`` against whole, and its device ms per
    second of audio at B=1 and 8 in fp32 and bf16.  After the serial
    requests, ``tools/load_test.py`` as a process against the same server
    at concurrency 1, 4 and 8 (``LOAD_REQUESTS`` a level): every request
    200, its report lines, the run's batching stats from ``/healthz``
    (batches coalesced), the launches of #2 and #5 during it.

18. the data path on the trained multi-speaker checkpoint
    ``checkpoints/r5_ms_bf16``: the seed-5, 4-speaker, 2048-row corpus of
    ``docs/evidence_r5`` generated by ``make_synth_corpus`` (every row
    synthesized, rows 1792-2047 written as float32 WAV to a temporary
    directory, the last 48 split into ``metadata_val.csv``);
    ``preprocess_corpus(use_native=True)`` on the card (the C++ loader
    built from ``native/wavio.cc``): every row ``ok``, every token file
    equal to ``text_to_sequence``, every card mel within ``PRE_MEL_TOL`` of
    the plain version on the CPU over the same padded batch, and the
    utterances and audio-seconds per wall second with the padding the size
    estimate costs; ``tools/eval_quality_torch.py::evaluate`` on the card
    over the first 16 val items, held to the TPU's report
    ``docs/evidence_r5/quality_r5ms.json``: ``text_len``, ``mel_len`` and
    ``speaker_id`` equal, ``ar_end_frames`` within ``AR_END_SLACK``,
    ``mcd_tf_db`` within ``TF_MCD_SLACK``, the summaries inside
    ``tests/test_quality_report.py``'s tail limits (``R5_TAILS``), with the
    launch counters zeroed before and read after (``attention_tail`` once a
    teacher-forced step, ``conv_bn_act`` 16 an item, ``decoder_infer_mega``
    one an item); then the 16 decodes against the plain step loop
    (``DEC_TOL``, fp32 as ``load_model`` serves), one item's teacher-forced
    tail calls (``TAIL_TOL``) and eight conv layers (``CONV_TOL``) against
    their plain versions; and ``gt_vocoder_check_torch.py`` on one val
    item: both scale guesses ``LIKELY_LOG``, the cached and recomputed
    mels within ``PRE_MEL_TOL``, a finite Griffin-Lim WAV.

19. data parallelism on the one card: the compute mode (``Default``) and
    no MPS server (the decoder kernels' grid barriers need every block
    resident; two processes time-slice the card); (a) one process at the
    training main path's B=16, then two ranks of this script
    (``--dp-rank``) on ``cuda:0`` over gloo (``file://`` store), each on
    8 rows at full width: the first step's gradients summed over the
    ranks (rank 0 also holds both training kernels against their plain
    versions on that step's inputs, ``MAIN_PAIR_TOL``), the counted run
    (``DP_STEPS`` bf16 ``train_step``s: #3 and #4 once a step on each
    rank, the gradient all-reduce timed; an ``eval_step``: #1 on every
    teacher-forced step, each call within ``TAIL_TOL`` of the plain
    version, #5 eight times), then the same steps in fp32; after every
    step every rank's state bit for bit (sha256); against one process:
    the bf16 gradients (``GRAD_TOL`` by phase 10's rule), each step's
    losses (``GRAD_TOL`` relative) and, in fp32, the weights after the
    last step (gap over update, ``GRAD_TOL``); a failed or hung rank
    fails the phase; (b) ``train_torch.py`` under ``torchrun
    --nproc_per_node 2`` on phase 15's corpus: two epochs, then the
    second resumed from the first's checkpoint, bit for bit, one log
    written by rank 0 alone; (c) ``ShardedSynthesizer`` over
    ``["cuda:0", "cuda:0"]`` on ``r4_synth_bf16`` (fp32) for eight
    sentences and for three: frame ends equal to the unsharded
    ``synthesize_wav``'s, waveforms within ``DP_WAV_TOL`` /
    ``DP_WAV_MEAN`` at ``DP_GL_ITERS`` Griffin-Lim rounds (widened to at
    most ``DP_WAV_CAP``), #2 once and #5 eight times a shard, each shard's
    decode and conv layers against their plain versions (at most
    ``DP_DEC_CAP``), the walls of both in turns; for the eight, how far
    the batch's makeup moves a decode (the whole batch against each row
    alone, by the kernel and by the plain step loop), printed, not held.

20. tensor parallelism on the one card, against phase 19's one process:
    (a) two ranks of this script (``--tp-rank``) on ``cuda:0`` over gloo,
    a grid of data 1 x model 2, each on the whole B=16 batch with its
    shards of the decoder LSTMs and heads: the first step's gradients
    (gathered), ``DP_STEPS`` bf16 ``train_step``s (#1 on every step of
    each forward, #2-#4 never: off under tensor parallelism, as in the
    JAX package; the model-axis collectives counted and timed), an
    ``eval_step`` (#1 on every step within ``TAIL_TOL``, #5 eight times),
    then the same steps in fp32; after every step the ranks' replicated
    state bit for bit; the gathered gradients, losses and fp32 weights
    by phase 19's rules, and the gathered weights the shards joined; then
    one bf16 step with remat "full" (#1 twice a step), the ranks'
    replicated state bit for bit after it, its gathered gradients, losses
    and state against one process's remat step by the same rules, each
    rank's peak memory beside the remat-off steps'; (b)
    ``train_torch.py --tp 2`` under ``torchrun --nproc_per_node 4`` on
    phase 15's corpus: two epochs, then the second resumed, bit for bit,
    the checkpoint read by ``load_model``; (c)
    ``ShardedSynthesizer(tensor_parallel=True)`` on ``r4_synth_bf16``
    (fp32) over a 1x2 and a 2x2 grid of ``cuda:0``: frame ends equal to
    the unsharded synthesizer's, each data shard's decode against the
    unsharded step loop (``DP_DEC_CAP``), #1 on every decode step, #5
    eight times a data shard, #2 never, the walls of both in turns.

21. the neural letter-to-sound trainer, ``tools/train_lts_neural_torch.py``,
    at full width on the whole CMUdict training split (103,953 words): the
    first step (B=512, seeded weights, dropout 0, smoothing 0.1) on the
    card against the CPU in fp32 (``LTS_LOSS_TOL``, ``LTS_GRAD_TOL``); ms a
    step and the device's busy share over ``LTS_PROFILE_STEPS`` steps;
    ``LTS_EPOCHS`` epochs through the CLI's ``main`` at the defaults
    (finite loss, falling); the held-out greedy word accuracy beside the
    committed ``tacotron2_tpu/text/data/lts_neural.npz``'s under the same
    greedy on the same 1,500 words; the export read back by
    ``text/lts_neural.py``.

22. the measurement and serving tools of ``tools/`` at the JAX tools'
    batch sizes, full width, seeded weights (``tools_phase``): the decode
    sweep of ``bench_infer_scaling_torch`` (kernel and step loop, B=1, 8,
    64, forced stops of 300 and 1000 frames), its sharded (two replicas on
    this card, B=8) and bucketed sweeps, ``bench_train_scaling_torch`` at
    B=16 and 128 with split BPTT on and off (no ``FAILED`` line), and
    ``profile_train_step_torch`` at B=128, with the launch counters zeroed
    before and read after; then each kernel against its plain version on
    the tools' own calls: #2 on the B=64 decode to 1000 frames
    (``DEC_TOL``, frame_ends equal), #1 on every step of the same decode
    by the step loop (``TAIL_TOL``), #5 on its eight layers
    (``CONV_TOL``), #3 and #4 on the first B=128 split step (phase 10's
    rule; #4 beside the plain version's own CPU-card spread);
    ``verify_ngc_checkpoint_torch`` on a seeded weight-normed file and
    ``export_reference_corpus_torch`` on phase 18's processed corpus.

23. decoder-step rematerialisation (``ModelConfig.remat_decoder_step``,
    ``train_torch.py --remat``) at full width, bf16 over fp32 masters,
    T_enc=128, T_dec=512, B=16 and 128 (``remat_phase``, measured in a
    fresh process, ``chip_smoke.py --remat-phase``, so that no earlier
    phase's profiler slows its launches): one ``train_step`` from the same
    seeded state by the split BPTT, the step loop without remat, remat
    ``full`` and remat ``dots``, each with its wall, device busy ms (from
    a second step under the profiler), peak memory and launches (#1 once
    a step of the loop, twice under remat: forward and recompute); ``full`` and
    ``dots`` held to the loop, losses and gradients bit for bit (or
    within ``GRAD_TOL``, the gap printed); every recompute of #1 the
    forward's bits; the ops the ``dots`` policy keeps, by name.

Phases 11-14 and 17 run after phase 7, before the training phases,
phases 15 and 16 after phase 10, then phases 18-23 last.  The
``kernels`` line has five entries; the serving path's three carry
``serve_path_launches``, the data path's three ``quality_path_launches``,
the data-parallel training path's four ``dp_path_launches`` (one rank's),
the sharded serving path's two ``sharded_path_launches``, the
tensor-parallel training path's ``tp_path_launches`` (one rank's),
its serving path's ``tp_sharded_path_launches``, and every kernel
phase 16's ``c6_launches``, ``c6_max_abs_err`` and ``c6_device_ms`` (by
config; ``conv_bn_act`` also ``c6_library_ms``, cuDNN's), the decode and
conv kernels ``load_test_launches`` (phase 17), and every kernel phase
22's ``tools_path_launches`` and ``tools_path_max_abs_err``; phase 23
adds #1's ``remat_path_launches`` and ``remat_path_max_abs_err``, and
#3's and #4's ``remat_phase_launches`` (by B and variant).  The last
line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of
``tacotron2_tpu``, and reads no weights file from the repository but the
checkpoints of phases 14 and 18, in phase 21 the committed LTS artifact,
and in phase 22 ``docs/ngc_hifigan_manifest.json``.
"""

from __future__ import annotations

import copy
import csv
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS = {torch.float32: 67e12,  # fp32 outside the tensor cores
            torch.bfloat16: 989e12}  # bf16 tensor cores, dense
TAIL_TOL = 1e-5         # fp32 sums over <= 200 positions, other order
# decode kernel vs plain step loop, one limit per output.  Typical sizes at
# full width on seeded weights: mels and gate logits ~0.1-1, alignments
# ~1/T_enc.  fp32: the same products summed in another order; bf16 adds the
# composed location matrix, rounded once in the kernel and per step in the
# plain conv, and the plain loop's bf16 rounding of qsum, whose location
# part grows with the cumulative alignment (steps / T_enc).  An alignment's
# error scales with its size, so its limit is a share of the plain
# alignments' mean size: read on an H100 in bf16, 1.3e-2 at T_enc=128 over
# 300 steps, 1.5e-2 at T_enc=112 and 2.6e-2 at T_enc=32 over 400 steps
# (8.2e-4 of 3.1e-2); in fp32 1.7e-6.
DEC_OUTPUTS = ("mels", "gates", "aligns")
DEC_TOL = {torch.float32: {"mels": 1e-4, "gates": 1e-4},
           torch.bfloat16: {"mels": 5e-3, "gates": 5e-3}}
DEC_ALIGN_SHARE = {torch.float32: 1e-3, torch.bfloat16: 6e-2}
MAIN_TOL = 5e-2         # bf16 postnet mels, kernel vs step loop / CPU
# training kernels vs their plain versions, one limit per output.  An
# element may differ by BF16_ULPS roundings of the plain value where the
# output is stored in bf16 (both sides round at the same places, and a sum
# taken in another order flips a rounding now and then), and beyond that by
# the output's limit times the plain output's mean size (frames: about
# their per-channel mean, which is the projection bias and no product).
# The limits come from readings on an H100 (PERF.md has them) and stand
# about 4 times above the largest: fp32 read at most 2.6e-5 over the sweep
# of phases 8-9; bf16 has a table for that sweep (T_dec=64) and one for the
# training main path's own step (T_dec=512, where a flipped rounding has 8
# times as many steps to carry through and the cotangents are the loss's).
FWD_OUT = ("frames", "attn", "ha_s", "ca_s", "hd_s", "cd_s", "qsum_s",
           "aa_s", "ad_s")
BWD_OUT = ("g_att_s", "g_dec_s", "d_ctx_s", "d_pre_s", "d_qsum_s", "d_pq_s",
           "dv", "dpm", "scal")
BF16_ULPS = 2
PAIR_TOL = {
    torch.float32: {n: 1e-4 for n in FWD_OUT + BWD_OUT},
    torch.bfloat16: dict(
        frames=3e-2, attn=1.2e-2, ha_s=4e-3, ca_s=5e-3, hd_s=1e-2,
        cd_s=1.1e-2, qsum_s=1.6e-2, aa_s=6e-3, ad_s=1.8e-2, g_att_s=4.5e-2,
        g_dec_s=1e-2, d_ctx_s=4e-3, d_pre_s=4e-2, d_qsum_s=4.4e-2,
        d_pq_s=4e-2, dv=1e-2, dpm=4e-2, scal=1.7e-3)}
MAIN_PAIR_TOL = dict(
    frames=5.4e-2, attn=2.1e-2, ha_s=4e-3, ca_s=4e-3, hd_s=1e-2, cd_s=1.3e-2,
    qsum_s=5.2e-2, aa_s=4e-3, ad_s=2e-2, g_att_s=1e-1, g_dec_s=2.8e-2,
    d_ctx_s=1.5e-2, d_pre_s=1e-1, d_qsum_s=6e-4, d_pq_s=1.2e-3, dv=1e-4,
    dpm=1.6e-3, scal=1e-4)
BPTT_TOL = 1e-3         # fp32 gradients, kernel pair vs plain pair/autograd
GRAD_TOL = 5e-2         # bf16 train-step gradients, kernel vs plain route
# conv_bn_act kernel vs its plain version: the largest error as a share of
# the plain output's mean size.  Both sides round the folded weight and
# the input at the same places and sum 2560 (or 400) products in fp32 in
# another order (the tensor cores' own, in bf16).  Readings on an H100:
# 4.9e-5 (fp32) and 8.3e-5 (bf16) over the seeded sweep of phase 11, and
# 2.9e-5 over the eight layers on the main path's own inputs (bf16, seeded
# weights); the limits stand 4 to 6 times above.
CONV_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-4}
CONV_MAIN_TOL = 1.5e-4
# fused (kernel) route against unfused (cuDNN, TF32 off) route over a whole
# bf16 request: the fused route rounds the folded weight W*g once and keeps
# each layer's output fp32, the unfused one rounds W, lets cuDNN round the
# conv's output to bf16 and scales afterwards.  Limits as shares of the
# unfused postnet mels' mean size: the largest difference over the first
# ten frames (read 9.8e-3 on an H100) and the mean difference over the
# whole utterances (read 2.0e-3), each 5 times above its reading.
ROUTE_FIRST_TOL = 5e-2
ROUTE_MEAN_TOL = 1e-2
# the sentences of the text -> PCM main path and their token ids
# (tests/test_torch_text.py pins the same values against the JAX package)
SMOKE_TEXTS = {
    "The quick brown fox.": [
        21, 6, 69, 41, 65, 35, 41, 69, 18, 53, 13, 44, 69, 31, 1, 41, 54],
    "Speech synthesis on one card.": [
        54, 52, 38, 19, 69, 54, 35, 44, 57, 6, 54, 6, 54, 69, 1, 44, 69, 65,
        7, 44, 69, 41, 1, 53, 20],
    "It costs 42 dollars.": [
        35, 56, 69, 41, 1, 54, 56, 54, 69, 31, 10, 53, 56, 37, 69, 56, 62, 69,
        20, 1, 42, 25, 67],
    "A zorblaxian wug sings.": [
        6, 69, 67, 11, 53, 18, 42, 4, 41, 54, 37, 6, 44, 69, 65, 7, 32, 69,
        54, 35, 45, 67],
}
# phase 14: the trained checkpoint and the gate stops the JAX package
# gives on it for SMOKE_TEXTS (bf16 serving cast, one sentence at a time,
# max_steps 256; tests/test_torch_synth.py::SMOKE_FRAME_ENDS pins the same)
TRAINED_CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "checkpoints", "r4_synth_bf16")
TRAINED_FRAME_ENDS = {"The quick brown fox.": 131,
                      "Speech synthesis on one card.": 220,
                      "It costs 42 dollars.": 174,
                      "A zorblaxian wug sings.": 171}
TRAINED_MAX_STEPS = 256
STOP_SLACK = 3          # frames: stops against the pin and each other, and
#                         the alignment path's end against the last token
# bf16 decodes on trained weights: the kernel and the step loop round in
# other places, and sharp attention carries a rounding on, so they part
# by far more than DEC_TOL while they stop at the same frame and align
# alike.  The plain loop run on the card and on the CPU parts as far
# (tools/trained_decode_gap.py on an H100: mel max 1.48 vs the kernel's
# 2.13 over the first sentence; mean 2.8e-2 vs 4.4e-2).  bf16 is held to
# the limits tests/test_torch_synth.py::test_smoke_sentences_full_width
# sets two bf16 decodes of this checkpoint (the port's and the JAX
# package's), here on the decoder's mels: the largest difference over the
# first ten frames and the mean difference.  fp32 is held to DEC_TOL.
TRAINED_FIRST_TOL = 0.2
TRAINED_MEAN_TOL = 0.1
SPEAK_BUCKET = 256      # what 17-25 tokens pick: 7 frames a token + 40
SPEAK_FORCED_STOP = 200  # inside that bucket
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


def kernel_launches(fn, n: int):
    """{kernel name: (launches, device ms)} that torch.profiler saw over
    ``n`` calls of ``fn`` (after one call outside the window)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.self_device_time_total > 0}


def device_ms(fn, n: int, kernel: str):
    """Mean device milliseconds of one launch of the kernel whose name holds
    ``kernel`` (``fn`` launches it once a call), from torch.profiler over
    ``n`` calls.  The profiler leaves a few launches out of its trace now
    and then (97 of 100 seen on an H100), so the mean is over the launches
    it saw; fails if it saw none or more than ``n``."""
    hits = [v for k, v in kernel_launches(fn, n).items() if kernel in k]
    count = sum(c for c, _ in hits)
    check(0 < count <= n, f"torch.profiler saw {count} launches of {kernel} "
          f"in {n} calls")
    return sum(ms for _, ms in hits) / count


def graph_ms(fn, n: int, replays: int = 5) -> float:
    """Device milliseconds per call of ``fn`` alone: ``n`` calls captured
    in one CUDA graph, its replays timed with CUDA events.  The time holds
    the kernels' own and the graph's gaps between them, and no host time."""
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


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def max_err(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def compare_decode(got, ref, dtype, where: str):
    """Hold a decode kernel's returns against the plain step loop's:
    n_frames and frame_ends exactly, the rows past the stop exactly, and
    each output's stopped rows within its own limit (the alignments' is a
    share of their mean size).  Returns {output: max abs error}."""
    n = int(ref[3])
    check(int(got[3]) == n, f"{where}: n_frames {int(got[3])} != {n}")
    check(torch.equal(got[4], ref[4]), f"{where}: frame_ends "
          f"{got[4].tolist()} != {ref[4].tolist()}")
    errs = {}
    for name, g, r in zip(DEC_OUTPUTS, got[:3], ref[:3]):
        check(torch.equal(g[:, n:], r[:, n:]),
              f"{where}: {name} past the stop differ")
        errs[name] = float((g[:, :n].float() - r[:, :n].float()).abs().max())
    tol = dict(DEC_TOL[dtype], aligns=DEC_ALIGN_SHARE[dtype] * float(
        ref[2][:, :n].float().abs().mean()))
    print(f"[{where}] n_frames {n}, frame_ends {ref[4].tolist()}; max err "
          + ", ".join(f"{k} {errs[k]:.3e} (tol {tol[k]:g}, mean |ref| "
                      f"{float(r[:, :n].float().abs().mean()):.3e})"
                      for k, r in zip(DEC_OUTPUTS, ref[:3])), flush=True)
    for k in DEC_OUTPUTS:
        check(errs[k] <= tol[k], f"{where}: {k} error {errs[k]} > {tol[k]}")
    return errs


def gate_stop_offset(dec, candidates, max_steps: int, gate_threshold: float,
                     margin: float, latest: int, drop_first: bool = True):
    """A decoder whose gate stops rows by itself, from seeded weights whose
    gate never fires: the plain step loop decodes each (memory, mask) of
    ``candidates`` in turn (stop mode "all", ``drop_first``) and a
    gate-bias offset is picked from its own gate logits.  The gate feeds
    nothing back, so the offset changes nothing before a stop.  It must make
    at least two rows stop at different frames no later than ``latest``,
    and keep every row's logits at least ``margin`` from the threshold's
    logit at every frame up to its stop (all frames where it does not
    stop), so that the kernel's error cannot move a stop.  The offset is
    applied to a copy of ``dec`` and the pick is checked on that copy's own
    logits.  Returns (candidate index, offset, the copy, per row the frame
    of its gate stop or 0 for none), or None where no candidate qualifies.
    """
    import math
    from tacotron2_torch.ops.decoder_megakernel import (
        decoder_infer_mega_reference)
    level = math.log(gate_threshold / (1 - gate_threshold))

    def logits(d, memory, mask):
        with torch.no_grad():
            out = decoder_infer_mega_reference(
                d, memory, max_steps, gate_threshold, drop_first, mask,
                "all")
        return int(out[3]), out[1].float().cpu().numpy()[:, 1:]

    def stops_for(g, taus):
        """Per level in ``taus``: the frame of each row's first logit above
        it (frames 2..max_steps; 0: none) and the logits' least distance
        from it up to each row's stop."""
        above = g[None] > taus[:, None, None]
        fired = above.any(2)
        first = above.argmax(2)
        upto = np.where(fired, first, g.shape[1] - 1)
        seen = np.arange(g.shape[1])[None, None] <= upto[:, :, None]
        dist = np.where(seen, np.abs(g[None] - taus[:, None, None]),
                        np.inf).min((1, 2))
        return np.where(fired, first + 2, 0), dist

    def qualifies(frames, dist):
        early = frames[(frames > 0) & (frames <= latest)]
        return dist >= margin and len(set(early.tolist())) >= 2

    for i, (memory, mask) in enumerate(candidates):
        n, g = logits(dec, memory, mask)
        if n != max_steps:
            continue
        taus = np.linspace(g.min(), g.max(), 4001)
        frames, dist = stops_for(g, taus)
        ok = [k for k in range(len(taus)) if qualifies(frames[k], dist[k])]
        if not ok:
            continue
        k = max(ok, key=lambda k: dist[k])
        offset = level - float(taus[k])
        hot = copy.deepcopy(dec)
        # an fp32 bias, so that a bf16 model takes the offset unrounded
        hot.gate_layer.bias = torch.nn.Parameter(
            hot.gate_layer.bias.detach().float() + offset)
        _, g_hot = logits(hot, memory, mask)
        frames, dist = stops_for(g_hot, np.array([level]))
        if qualifies(frames[0], dist[0]):
            return i, offset, hot, frames[0].tolist()
    return None


def expected_ends(stops, stop_mode: str, max_steps: int):
    """n_frames and frame_ends of a decode whose rows stop by the gate at
    ``stops`` (0: never)."""
    fired = [s for s in stops if s > 0]
    if stop_mode == "any":
        n = min(fired) if fired else max_steps
    else:
        n = max(fired) if len(fired) == len(stops) else max_steps
    return n, [min(s, n) if s > 0 else n for s in stops]


def gate_fired_stops(dec, dtype, cfg, margin, dev, kernel, plain,
                     make_pad_mask):
    """Phase 5's decodes that the gate itself stops: B=8, T_enc=128, a
    gate-bias offset from ``gate_stop_offset`` (memory seeds 500-515,
    first frame kept, two rows or more stopping by frame MAX_STEPS // 2),
    the kernel against the plain step loop under both stop modes, with
    n_frames and frame_ends those the plain loop's logits predict."""
    b = 8
    lens = torch.tensor([128 - 37 * (i % 3) for i in range(b)])
    mask = make_pad_mask(lens, 128).to(dev)

    def candidates():
        for seed in range(500, 516):
            g = torch.Generator().manual_seed(seed)
            yield (torch.randn(b, 128, cfg.encoder_embedding_dim,
                               generator=g) * 0.5).to(dev), mask

    picked = gate_stop_offset(dec, candidates(), MAX_STEPS,
                              cfg.gate_threshold, margin, MAX_STEPS // 2,
                              drop_first=False)
    check(picked is not None, f"{str(dtype)[6:]}: no gate-bias offset "
          f"makes two rows stop by the gate {margin:.1e} from the "
          f"threshold")
    i, offset, hot, stops = picked
    memory = list(candidates())[i][0]
    print(f"[decoder_infer_mega {str(dtype)[6:]} B={b} gate stops] memory "
          f"seed {500 + i}, gate-bias offset {offset:+.6f}, margin "
          f"{margin:.1e} (4 x this dtype's gate error at B=8): rows stop "
          f"by the gate at frames {stops} (0: not by frame {MAX_STEPS})",
          flush=True)
    for stop_mode in ("any", "all"):
        args = (hot, memory, MAX_STEPS, cfg.gate_threshold, False, mask,
                stop_mode, None)
        with torch.no_grad():
            got = kernel(*args)
            ref = plain(*args)
        torch.cuda.synchronize()
        n, ends = expected_ends(stops, stop_mode, MAX_STEPS)
        where = (f"decoder_infer_mega {str(dtype)[6:]} B={b} gate stops "
                 f"{stop_mode}")
        check(int(ref[3]) == n and ref[4].tolist() == ends,
              f"{where}: the plain loop stopped at {int(ref[3])}, "
              f"{ref[4].tolist()}; the logits said {n}, {ends}")
        compare_decode(got, ref, dtype, where)


def bound(n_bytes: float, n_ops: float, dtype: torch.dtype):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pair_share(name: str, g, r):
    """``compare_outputs``' rule for one output: (the largest error past
    BF16_ULPS roundings of the plain value where it is stored in bf16, as a
    share of the plain output's mean size; the largest absolute error; the
    mean size)."""
    stored_bf16 = r.dtype == torch.bfloat16
    g, r = g.detach().float(), r.detach().float()
    err = (g - r).abs()
    err_over = ((err - BF16_ULPS * 2.0 ** -7 * r.abs()).clamp_(min=0)
                if stored_bf16 else err)
    if name == "frames":
        r = r - r.mean(dim=(0, 1), keepdim=True)
    scale = float(r.abs().mean())
    return float(err_over.max()) / scale, float(err.max()), scale


def compare_outputs(names, got, ref, tol, where: str, unheld=()):
    """Hold a training kernel's outputs against its plain version's.  Per
    element the error may reach BF16_ULPS bf16 roundings of the plain value
    (outputs stored in bf16 only; a rounding is at most 2^-7 of the value) plus ``tol[name]`` times the plain
    output's mean size.  Outputs named in ``unheld`` are printed with
    their share and not held to the limit.  Returns {name: max abs
    error}."""
    errs, parts = {}, []
    for name, g, r in zip(names, got, ref):
        check(g.shape == r.shape and g.dtype == r.dtype,
              f"{where}: {name} is {tuple(g.shape)} {g.dtype}, plain "
              f"{tuple(r.shape)} {r.dtype}")
        check(bool(torch.isfinite(g).all()), f"{where}: non-finite {name}")
        stored_bf16 = r.dtype == torch.bfloat16
        share, errs[name], scale = pair_share(name, g, r)
        parts.append(f"{name} {errs[name]:.2e}: "
                     + (f"past {BF16_ULPS} roundings " if stored_bf16 else "")
                     + f"{share:.2e} of mean {scale:.2e} ("
                     + ("not held, see below" if name in unheld
                        else f"limit {tol[name]:g}") + ")")
        check(name in unheld or share <= tol[name],
              f"{where}: {name} error {errs[name]}, {share} of its mean "
              f"size {scale}, limit {tol[name]}")
    print(f"[{where}] max err " + ", ".join(parts), flush=True)
    return errs


def grad_errors(got, ref, floor: float):
    """Per tensor, max |got - ref| over (max |ref| + floor x the largest
    gradient of all): the rule of the JAX package's kernel tests."""
    gscale = max(float(r.float().abs().max()) for r in ref.values())
    return {n: float((got[n].float() - r.float()).abs().max())
            / (float(r.float().abs().max()) + floor * gscale)
            for n, r in ref.items()}


def profile_step(fn):
    """Run ``fn`` once under torch.profiler.  Returns (fn's result, wall ms,
    {kernel name: device ms}, device busy ms)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    by_kernel = {e.key: e.self_device_time_total / 1e3
                 for e in prof.key_averages() if e.self_device_time_total > 0}
    return out, wall_ms, by_kernel, sum(by_kernel.values())


def kernel_ms(by_kernel, name: str):
    ms = sum(v for k, v in by_kernel.items() if name in k)
    return ms if ms > 0 else None


def train_kernel_phases(dev, base, cfg):
    """Phases 8 and 9.  Returns each kernel's largest absolute error over
    the sweep."""
    from tacotron2_torch.models.decoder import decode_step, init_carry
    from tacotron2_torch.models.tacotron2 import (cast_params_bf16,
                                                  make_pad_mask)
    from tacotron2_torch.ops.decoder_bptt import (core_params,
                                                  decoder_scan_bptt)
    from tacotron2_torch.ops.decoder_bwd_kernel import (
        decoder_bwd_chain_mega, decoder_bwd_chain_reference)
    from tacotron2_torch.ops.decoder_train_kernel import (
        decoder_fwd_train_mega, decoder_fwd_train_reference, kernel_operands)

    h, t_enc = cfg.decoder_rnn_dim, 128
    sweep_err = {"fwd": 0.0, "bwd": 0.0}

    def inputs(dec, b, t_dec, dropout, seed):
        g = torch.Generator().manual_seed(seed)
        r = lambda *shape: torch.randn(*shape, generator=g)
        pre = torch.relu(r(t_dec, b, cfg.prenet_dim) * 0.5).to(dev)
        memory = (r(b, t_enc, cfg.encoder_embedding_dim) * 0.5).to(dev)
        with torch.no_grad():
            pm = dec.attention.memory_layer(memory)
        lens = torch.tensor([t_enc - 37 * (i % 3) for i in range(b)])
        mask = make_pad_mask(lens, t_enc).to(dev)
        keep = lambda: ((torch.rand(t_dec, b, h, generator=g) < 0.9).to(dev)
                        if dropout else None)
        cots = ((r(t_dec, b, cfg.n_mels + 1) * 0.1).to(dev),
                (r(t_dec, b, t_enc) * 0.1).to(dev))
        return (pre, memory, pm, mask, keep(), keep()), cots

    for dtype in (torch.float32, torch.bfloat16):
        m = base if dtype == torch.float32 else cast_params_bf16(base)
        dec = copy.deepcopy(m.decoder).to(dev)
        ops = kernel_operands(core_params(dec))
        for b, dropout in ((2, True), (5, True), (16, True), (16, False)):
            c = cfg if dropout else dataclasses.replace(
                cfg, p_attention_dropout=0.0, p_decoder_dropout=0.0)
            ins, cots = inputs(dec, b, 64, dropout, seed=200 + b)
            tag = (f"{str(dtype)[6:]} B={b} T_dec=64 dropout "
                   f"{'0.1/0.1' if dropout else 'off'}")
            # 8. forward kernel vs plain
            got = decoder_fwd_train_mega(c, ops, *ins)
            torch.cuda.synchronize()
            ref = decoder_fwd_train_reference(c, ops, *ins)
            errs = compare_outputs(FWD_OUT, got, ref, PAIR_TOL[dtype],
                                   f"decoder_fwd_train_mega {tag}")
            sweep_err["fwd"] = max(sweep_err["fwd"], *errs.values())
            ms = time_ms(lambda: decoder_fwd_train_mega(c, ops, *ins), 2,
                         warm=0)
            print(f"[decoder_fwd_train_mega {tag}] {ms:.3f} ms, "
                  f"{ms * 1e3 / 64:.1f} us/step, grid "
                  f"{decoder_fwd_train_mega.last_grid_blocks} blocks",
                  flush=True)
            # 9. reverse-chain kernel vs plain, on the series the forward
            # kernel stored
            _, attns, _, ca_s, _, cd_s, qsum_s, aa_s, ad_s = got
            bargs = (c, ops, ins[1], ins[4], ins[5], aa_s, ad_s, ca_s, cd_s,
                     attns, qsum_s, *cots)
            gotb = decoder_bwd_chain_mega(*bargs)
            again = decoder_bwd_chain_mega(*bargs)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(gotb, again)),
                  f"decoder_bwd_chain_mega {tag}: two runs differ")
            refb = decoder_bwd_chain_reference(*bargs)
            # bf16, B=5: scal is the sum of d_e * (e_raw + v_b), which
            # cancels; at these inputs the plain version run on the CPU
            # misses PAIR_TOL's scal limit against itself run on the card
            # (PERF.md), so no implementation can be held to it there:
            # the share is printed beside the plain CPU run's
            unheld = ("scal",) if dtype == torch.bfloat16 and b == 5 else ()
            errs = compare_outputs(BWD_OUT, gotb, refb, PAIR_TOL[dtype],
                                   f"decoder_bwd_chain_mega {tag}", unheld)
            if unheld:
                cpu = decoder_bwd_chain_reference(*(
                    {n: v.cpu() for n, v in x.items()} if isinstance(x, dict)
                    else x.cpu() if torch.is_tensor(x) else x
                    for x in bargs))
                share = lambda x: float((x.float() - refb[8].float().cpu())
                                        .abs().max()) / float(
                    refb[8].float().abs().mean())
                print(f"[decoder_bwd_chain_mega {tag}] scal, as a share of "
                      f"its mean size: kernel {share(gotb[8].cpu()):.2e}, "
                      f"the plain version on the CPU {share(cpu[8]):.2e}, "
                      f"both against the plain version on the card (limit "
                      f"{PAIR_TOL[dtype]['scal']:g})", flush=True)
            sweep_err["bwd"] = max(sweep_err["bwd"], *errs.values())
            ms = time_ms(lambda: decoder_bwd_chain_mega(*bargs), 2, warm=0)
            plan = decoder_bwd_chain_mega.last_plan
            print(f"[decoder_bwd_chain_mega {tag}] two runs bit for bit; "
                  f"{ms:.3f} ms, {ms * 1e3 / 64:.1f} us/step, grid "
                  f"{decoder_bwd_chain_mega.last_grid_blocks} blocks of "
                  f"{plan.smem_bytes / 1024:.1f} KB shared memory, "
                  f"{plan.m_tiles} pass(es) over the batch, {plan.k_chunks} "
                  f"K-chunks", flush=True)
        del dec

    # 9. the whole decoder_scan_bptt gradient, fp32, B=2, T_dec=32
    dec = copy.deepcopy(base.decoder).to(dev)
    ins, _ = inputs(dec, 2, 32, True, seed=300)
    weights = (torch.randn(32, 2, t_enc,
                           generator=torch.Generator().manual_seed(301)) * 0.1
               ).to(dev)

    def grads_of(route):
        p = {n: x.detach().clone().requires_grad_(True)
             for n, x in core_params(dec).items()}
        pre, memory, pm = (x.detach().clone().requires_grad_(True)
                           for x in ins[:3])
        mask, mka, mkd = ins[3:]
        if route == "autograd":
            # the plain step loop (the real location conv, the attention
            # tail's own backward), differentiated by torch.autograd
            d2 = copy.deepcopy(dec)
            carry = init_carry(2, t_enc, cfg, dev)
            outs = []
            for t in range(32):
                carry, o = decode_step(d2, pre[t], carry, memory, pm, mask,
                                       train=True,
                                       step_masks=(mka[t], mkd[t]))
                outs.append(o)
            out = tuple(torch.stack(x) for x in zip(*outs))
            p = core_params(d2)
        else:
            c = dataclasses.replace(cfg, decoder_megakernel=route == "kernel")
            out = decoder_scan_bptt(c, p, pre, memory, pm, mask, mka, mkd)
        loss = ((out[0] ** 2).sum() + (out[1] ** 2).sum()
                + (out[2] * weights).sum())
        loss.backward()
        g = {n: x.grad for n, x in p.items()}
        g.update(prenet=pre.grad, memory=memory.grad, pm=pm.grad)
        return float(loss.detach()), g

    counts = (decoder_fwd_train_mega.launches, decoder_bwd_chain_mega.launches)
    lk, gk = grads_of("kernel")
    check((decoder_fwd_train_mega.launches - counts[0],
           decoder_bwd_chain_mega.launches - counts[1]) == (1, 1),
          "decoder_scan_bptt did not launch the kernel pair once each")
    for other in ("plain", "autograd"):
        lo, go = grads_of(other)
        errs = grad_errors(gk, go, 1e-3)
        worst = max(errs, key=errs.get)
        print(f"[decoder_scan_bptt fp32 B=2 T_dec=32] kernel pair vs "
              f"{other}: loss {lk:.6f} vs {lo:.6f}; {len(errs)} gradients, "
              f"worst {worst} {errs[worst]:.2e} (limit {BPTT_TOL})",
              flush=True)
        check(abs(lk - lo) <= BPTT_TOL * abs(lo), f"bptt loss vs {other}")
        check(errs[worst] <= BPTT_TOL,
              f"decoder_scan_bptt vs {other}: {worst} off by {errs[worst]}")
    return sweep_err


def seeded_train_batch(mc, b: int = 16):
    """The training main path's batch: B=16 (or ``b``) seeded ragged
    utterances, the longest text 128 tokens and the longest mel 512
    frames."""
    from tacotron2_torch.data.dataset import Example, collate
    rng = np.random.default_rng(SEED)
    text_lens = rng.integers(60, 129, b)
    mel_lens = rng.integers(300, 513, b)
    text_lens[3], mel_lens[5] = 128, 512
    return collate([
        Example(text=rng.integers(0, mc.n_symbols, n).astype(np.int32),
                mel=(rng.standard_normal((mc.n_mels, m)) * 1.5 - 5.0
                     ).astype(np.float32))
        for n, m in zip(text_lens, mel_lens)])


def first_step_masks(mc, b, t_dec, g, dev):
    """Dropout keep-masks for a postnet-bypassed step of a batch of ``b``,
    drawn from the generator ``g`` on the card."""
    keep = lambda shape, rate: torch.rand(
        shape, generator=g, device=dev) < 1.0 - rate
    h = mc.decoder_rnn_dim
    return {"prenet": [keep((b, t_dec, mc.prenet_dim), mc.p_prenet_dropout)
                       for _ in range(2)],
            "attention": keep((t_dec, b, h), mc.p_attention_dropout),
            "decoder": keep((t_dec, b, h), mc.p_decoder_dropout)}


def train_main_path(dev):
    """Phase 10.  Returns attention_tail's launches on this path and its
    largest error on eval_step's inputs, and the kernels-line entries of
    the two training kernels."""
    from tacotron2_torch.config import Config
    from tacotron2_torch.models.encoder import encoder_apply
    from tacotron2_torch.models.layers import BatchNorm
    from tacotron2_torch.models.postnet import postnet_apply
    from tacotron2_torch.models.tacotron2 import (cast_params_bf16,
                                                  init_projection_bias,
                                                  replace_config)
    from tacotron2_torch.ops import attention_kernel, decoder_bptt
    from tacotron2_torch.ops.attention_kernel import attention_tail
    from tacotron2_torch.ops.decoder_bwd_kernel import (
        decoder_bwd_chain_mega, decoder_bwd_chain_reference)
    from tacotron2_torch.ops.decoder_train_kernel import (
        decoder_fwd_train_mega, decoder_fwd_train_reference, operand_bytes)
    from tacotron2_torch.train import step as train
    from tacotron2_torch.train.optim import make_optimizer
    from tacotron2_torch.train.state import create_train_state

    cfg = Config()
    mc = cfg.model
    check(cfg.train.precision == "bfloat16", "default precision is not bf16")
    tx = make_optimizer(cfg.train)
    state = create_train_state(cfg, seed=SEED, tx=tx)
    model = state.model
    batch = seeded_train_batch(mc)
    b, t_enc = batch["text"].shape
    t_dec = batch["mel"].shape[2]
    check((b, t_enc, t_dec) == (16, 128, 512), f"batch {b} {t_enc} {t_dec}")
    init_projection_bias(model, batch["mel"])
    print(f"[train] full-width model, {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
          f"parameters, fp32 masters, bf16 compute; batch B={b} T_enc={t_enc} "
          f"T_dec={t_dec}, text lengths {sorted(batch['text_lengths'].tolist())}, "
          f"mel lengths {sorted(batch['mel_lengths'].tolist())}", flush=True)

    def set_route(on: bool) -> None:
        replace_config(model, decoder_megakernel=on)

    # before the counted run: the first step's gradients by both routes on
    # the same batch and the same dropout masks, and both kernels against
    # their plain versions on that step's own inputs
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    h = mc.decoder_rnn_dim
    masks = first_step_masks(mc, b, t_dec, g, dev)
    tbatch = train._to_device(batch, dev)
    buffers = {n: x.clone() for n, x in model.named_buffers()}
    calls = {}

    def record(name, fn):
        def wrapper(*args):
            calls[name] = (args, fn(*args))
            return calls[name][1]
        return wrapper

    grads = {}
    for on in (True, False):
        set_route(on)
        if on:
            decoder_bptt.decoder_fwd_train_mega = record(
                "fwd", decoder_fwd_train_mega)
            decoder_bptt.decoder_bwd_chain_mega = record(
                "bwd", decoder_bwd_chain_mega)
        try:
            total, _ = train._forward_loss(
                model, cfg, tbatch, None, 0, False,
                cfg.guided_attention.sigma_warmup_steps, masks)
            grads[on] = train._grads(model, total)
        finally:
            decoder_bptt.decoder_fwd_train_mega = decoder_fwd_train_mega
            decoder_bptt.decoder_bwd_chain_mega = decoder_bwd_chain_mega
        with torch.no_grad():         # the forward moved the BatchNorm state
            for n, x in model.named_buffers():
                x.copy_(buffers[n])
    set_route(True)
    errs = grad_errors(grads[True], grads[False], 1e-2)
    worst = max(errs, key=errs.get)
    print(f"[train] first step's gradients, kernel route vs plain route "
          f"(bf16, same batch and masks): {len(errs)} tensors, worst {worst} "
          f"{errs[worst]:.2e} (limit {GRAD_TOL})", flush=True)
    check(set(grads[True]) == set(grads[False]), "routes differ in which "
          "parameters get a gradient")
    check(errs[worst] <= GRAD_TOL, f"train gradients: {worst} off by "
          f"{errs[worst]}")
    fwd_args, fwd_out = calls["fwd"]
    bwd_args, bwd_out = calls["bwd"]
    where = f"main B={b} T_enc={t_enc} T_dec={t_dec} bf16"
    detach = lambda xs: tuple(x.detach() if torch.is_tensor(x) else x
                              for x in xs)
    fwd_args, bwd_args = detach(fwd_args), detach(bwd_args)
    t1 = time.perf_counter()
    fwd_ref = decoder_fwd_train_reference(*fwd_args)
    torch.cuda.synchronize()
    fwd_plain_ms = (time.perf_counter() - t1) * 1e3
    t1 = time.perf_counter()
    bwd_ref = decoder_bwd_chain_reference(*bwd_args)
    torch.cuda.synchronize()
    bwd_plain_ms = (time.perf_counter() - t1) * 1e3
    fwd_errs = compare_outputs(FWD_OUT, fwd_out, fwd_ref, MAIN_PAIR_TOL,
                               f"{where} decoder_fwd_train_mega")
    bwd_errs = compare_outputs(BWD_OUT, bwd_out, bwd_ref, MAIN_PAIR_TOL,
                               f"{where} decoder_bwd_chain_mega")
    del fwd_ref, bwd_ref
    fwd_ms = time_ms(lambda: decoder_fwd_train_mega(*fwd_args), 2, warm=1)
    bwd_ms = time_ms(lambda: decoder_bwd_chain_mega(*bwd_args), 2, warm=1)

    # bounds: each input read once, each output written once, over the
    # memory rate; against the products' operations at the bf16 rate
    nbytes = lambda xs: sum(x.numel() * x.element_size() for x in xs
                            if torch.is_tensor(x))
    ops = fwd_args[1]
    wbytes = operand_bytes(ops)
    e, a, m_ = mc.encoder_embedding_dim, mc.attention_dim, mc.n_mels
    p_, k = mc.prenet_dim, mc.location_kernel_size
    lstm_macs = 4 * h * (p_ + e + h) + 4 * h * (h + e + h)
    macs_step = b * (lstm_macs + a * h + (m_ + 1) * (h + e)
                     + t_enc * (2 * k * a + 2 * a + e))
    fwd_stream = nbytes(fwd_args[2:]) + nbytes(fwd_out)
    bwd_stream = nbytes(bwd_args[2:]) + nbytes(bwd_out)
    fwd_bound = bound(wbytes + fwd_stream, 2 * macs_step * t_dec,
                      torch.bfloat16)
    bwd_bound = bound(wbytes + bwd_stream, 2 * macs_step * t_dec,
                      torch.bfloat16)
    step_stream = lambda stream: (t_dec * wbytes + stream) / HBM_BYTES_PER_S \
        * 1e3

    # where one step's time goes: each part alone at the step's own shapes,
    # on a bf16 copy of the model, under the profiler (second of two runs):
    # wall on the host clock, busy = device time of all its kernels
    def timed(fn):
        fn()
        _, wall_ms, by_kernel, busy_ms = profile_step(fn)
        return wall_ms, busy_ms, by_kernel

    half_model = cast_params_bf16(model)

    def encoder_part():
        encoder_apply(half_model.encoder, tbatch["text"].long(),
                      True).sum().backward()

    def postnet_part():
        x = torch.randn(b, mc.n_mels, t_dec, device=dev, requires_grad=True)
        postnet_apply(half_model.postnet, x, True, g).sum().backward()

    def decoder_part():
        p = {n: x.detach().requires_grad_(True)
             for n, x in decoder_bptt.core_params(half_model.decoder).items()}
        pre, memory, pm = (x.detach().requires_grad_(True)
                           for x in fwd_args[2:5])
        out = decoder_bptt.decoder_scan_bptt(model.cfg, p, pre, memory, pm,
                                             *fwd_args[5:])
        (out[0].sum() + out[1].sum() + out[2].sum()).backward()

    opt_model = copy.deepcopy(model)
    opt_state = tx.init(opt_model)
    enc, post, dec = (timed(f) for f in (encoder_part, postnet_part,
                                         decoder_part))
    opt = timed(lambda: tx.update(opt_model, opt_state, grads[True]))
    pair_ms = sum(kernel_ms(dec[2], k_) or 0.0 for k_ in (
        "decoder_train_fwd_kernel", "decoder_train_bwd_kernel"))
    print("[train] one step by part, each alone (wall / device busy, ms): "
          f"encoder fwd+bwd {enc[0]:.1f} / {enc[1]:.1f}; decoder_scan_bptt "
          f"fwd+bwd {dec[0]:.1f} / {dec[1]:.1f}, of which the two kernels "
          f"{pair_ms:.1f} and the hoisted products and the rest "
          f"{dec[1] - pair_ms:.1f}; postnet fwd+bwd {post[0]:.1f} / "
          f"{post[1]:.1f}; optimizer {opt[0]:.1f} / {opt[1]:.1f}", flush=True)
    del calls, fwd_out, bwd_out, grads, half_model, opt_model, opt_state

    # the counted run
    decoder_fwd_train_mega.launches = 0
    decoder_bwd_chain_mega.launches = 0
    attention_tail.launches = 0
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    warm = cfg.guided_attention.sigma_warmup_steps
    half = {k_: v.reshape(2, 8, *v.shape[1:]) for k_, v in batch.items()}
    plan = [("train_step, postnet bypassed", lambda: train.train_step(
                state, batch, cfg=cfg, tx=tx, use_postnet=False,
                sigma_warmup_steps=warm)),
            ("train_step", lambda: train.train_step(
                state, batch, cfg=cfg, tx=tx, use_postnet=True,
                sigma_warmup_steps=warm)),
            ("train_step", lambda: train.train_step(
                state, batch, cfg=cfg, tx=tx, use_postnet=True,
                sigma_warmup_steps=warm)),
            ("train_step_accum, 2 x 8", lambda: train.train_step_accum(
                state, half, cfg=cfg, tx=tx, use_postnet=True,
                sigma_warmup_steps=warm, accum_steps=2))]
    counters = [(1, 1), (2, 2), (3, 3), (4, 5)]
    step_dev = {"fwd": [], "bwd": []}
    for (name, fn), want in zip(plan, counters):
        (_, losses, aligns), wall_ms, by_kernel, busy_ms = profile_step(fn)
        f_ms = kernel_ms(by_kernel, "decoder_train_fwd_kernel")
        b_ms = kernel_ms(by_kernel, "decoder_train_bwd_kernel")
        step_dev["fwd"].append(f_ms)
        step_dev["bwd"].append(b_ms)
        print(f"[train] {name}: wall {wall_ms:.1f} ms, device busy "
              f"{busy_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f}), "
              f"device_ms decoder_train_fwd_kernel {fmt_ms(f_ms)}, "
              f"decoder_train_bwd_kernel {fmt_ms(b_ms)}; loss "
              + ", ".join(f"{k_} {float(v):.4f}"
                          for k_, v in losses._asdict().items()), flush=True)
        check(all(np.isfinite(float(v)) for v in losses),
              f"{name}: non-finite loss term")
        check((state.step, state.loss_step) == want,
              f"{name}: counters {(state.step, state.loss_step)} != {want}")
        check(aligns.shape[1:] == (t_dec, t_enc)
              and bool(torch.isfinite(aligns).all()), f"{name}: alignments")
        check(attention_tail.launches == 0, f"{name}: the kernel route "
              f"launched attention_tail {attention_tail.launches} times")
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    print(f"[train] last step by device time: "
          + "; ".join(f"{k_[:48]} {v:.2f} ms" for k_, v in top), flush=True)
    (losses, aligns, entropy), wall_ms, by_kernel, busy_ms = profile_step(
        lambda: train.eval_step(state, batch, cfg=cfg,
                                sigma_warmup_steps=warm))
    print(f"[train] eval_step: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f}); total "
          f"{float(losses.total):.4f}, unmasked entropy {float(entropy):.4f}",
          flush=True)
    check(all(np.isfinite(float(v)) for v in losses)
          and np.isfinite(float(entropy)), "eval_step: non-finite")
    check((state.step, state.loss_step) == (4, 5), "eval_step moved counters")
    launches = (decoder_fwd_train_mega.launches,
                decoder_bwd_chain_mega.launches, attention_tail.launches)
    print(f"[train] launches decoder_fwd_train_mega={launches[0]} "
          f"decoder_bwd_chain_mega={launches[1]} attention_tail="
          f"{launches[2]} (all in eval_step, one per decoder step)",
          flush=True)
    check(launches == (5, 5, t_dec), f"training main path launched "
          f"{launches}, expected 5, 5 and {t_dec}")

    # attention_tail on the inputs of every step of one more eval_step: the
    # kernel's outputs carry the loop on, the plain version runs beside it
    launch_tail = attention_kernel._forward
    step_errs = []

    def checked_tail(*ins):
        out = launch_tail(*ins)
        step_errs.append(max_err(
            out, attention_kernel.attention_tail_reference(*ins)))
        return out

    attention_kernel._forward = checked_tail
    try:
        train.eval_step(state, batch, cfg=cfg, sigma_warmup_steps=warm)
    finally:
        attention_kernel._forward = launch_tail
    eval_tail_err = max(step_errs)
    print(f"[train eval_step attention_tail] on the inputs of "
          f"{len(step_errs)} steps: max err {eval_tail_err:.3e} (tol "
          f"{TAIL_TOL})", flush=True)
    check(len(step_errs) == t_dec, f"eval_step ran the tail "
          f"{len(step_errs)} times, expected {t_dec}")
    check(eval_tail_err <= TAIL_TOL, f"eval_step: attention_tail error "
          f"{eval_tail_err} > {TAIL_TOL}")
    for n, p in model.named_parameters():
        check(bool(torch.isfinite(p).all()), f"parameter {n} not finite")
        check(p.dtype == torch.float32, f"master {n} is {p.dtype}")
        check(not torch.equal(p, before[n]), f"parameter {n} did not change")
    for mod_name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            check(not torch.equal(mod.running_mean,
                                  buffers[f"{mod_name}.running_mean"])
                  and bool(torch.isfinite(mod.running_var).all()),
                  f"BatchNorm {mod_name}: running statistics did not move")
    print(f"[train] {len(before)} parameters changed and are finite; "
          "BatchNorm running statistics moved", flush=True)

    shape = f"B={b} T_enc={t_enc} T_dec={t_dec} weights bf16"
    mean = lambda xs: (None if any(x is None for x in xs)
                       else sum(xs) / len(xs))
    return (launches[2], eval_tail_err), [
        dict(name="decoder_fwd_train_mega", route="cuda",
             source="tacotron2_torch/csrc/decoder_train_fwd.cu",
             replaces="tacotron2_tpu/ops/decoder_train_kernel.py:281",
             launches=launches[0], max_abs_err=max(fwd_errs.values()),
             max_abs_err_by_output=fwd_errs, ms=fwd_ms,
             plain_ms=fwd_plain_ms, bound_ms=fwd_bound[0],
             bound_by=fwd_bound[1], library_ms=None,
             device_ms=mean(step_dev["fwd"][:3]),
             us_per_step=fwd_ms * 1e3 / t_dec,
             step_stream_bound_ms=step_stream(fwd_stream), shape=shape),
        dict(name="decoder_bwd_chain_mega", route="cuda",
             source="tacotron2_torch/csrc/decoder_train_bwd.cu",
             replaces="tacotron2_tpu/ops/decoder_bwd_kernel.py:220",
             launches=launches[1], max_abs_err=max(bwd_errs.values()),
             max_abs_err_by_output=bwd_errs, ms=bwd_ms,
             plain_ms=bwd_plain_ms, bound_ms=bwd_bound[0],
             bound_by=bwd_bound[1], library_ms=None,
             device_ms=mean(step_dev["bwd"][:3]),
             us_per_step=bwd_ms * 1e3 / t_dec,
             step_stream_bound_ms=step_stream(bwd_stream), shape=shape),
    ]


def conv_layer(c_in, c_out, k, dtype, seed, dev):
    """A conv + BatchNorm layer with seeded non-identity statistics."""
    from tacotron2_torch.models.layers import BatchNorm, Conv1d
    g = torch.Generator().manual_seed(seed)
    u = lambda *shape: torch.rand(*shape, generator=g)
    conv, bn = Conv1d(c_in, c_out, k), BatchNorm(c_out, 1e-5)
    bound_ = (c_in * k) ** -0.5
    with torch.no_grad():
        conv.weight.copy_((u(c_out, c_in, k) * 2 - 1) * bound_)
        conv.bias.copy_((u(c_out) * 2 - 1) * bound_)
        bn.weight.copy_(u(c_out) + 0.5)
        bn.bias.copy_(u(c_out) * 0.4 - 0.2)
        bn.running_mean.copy_(u(c_out) * 0.8 - 0.4)
        bn.running_var.copy_(u(c_out) * 1.7 + 0.3)
    for p in list(conv.parameters()) + list(bn.parameters()):
        p.data = p.data.to(dtype)
    return conv.to(dev), bn.to(dev)


def conv_share(got, ref) -> float:
    """Largest error as a share of the plain output's mean size."""
    return float((got - ref).abs().max()) / float(ref.abs().mean())


def tail_recorder(forward, recorded: list):
    """A stand-in for ``ops/attention_kernel.py::_forward`` that runs
    ``forward`` and appends a copy of each call's (inputs, outputs) to
    ``recorded``."""
    def recording_forward(*ins):
        out = forward(*ins)
        recorded.append((tuple(x.clone() for x in ins),
                         tuple(o.clone() for o in out)))
        return out
    return recording_forward


def model_conv_layers(model, tokens, mel_coarse):
    """The model's eight conv layers, ``conv_bn_act`` against its plain
    version on each layer's real input: the encoder's from the embedded
    ``tokens`` (B, T_enc), the postnet's from ``mel_coarse`` (B, T_dec,
    n_mels), each next layer fed the plain output.  Returns (each layer's
    largest error as a share of the plain output's mean size, its largest
    absolute error)."""
    from tacotron2_torch.ops.convbn_kernel import (conv_bn_act,
                                                   conv_bn_act_reference)
    eps = model.cfg.batchnorm_eps
    n_post = len(model.postnet.convs)
    layers = [("encoder", i, c, b, "relu") for i, (c, b) in
              enumerate(zip(model.encoder.convs, model.encoder.bns))] + [
        ("postnet", i, c, b, "tanh" if i < n_post - 1 else "none")
        for i, (c, b) in enumerate(zip(model.postnet.convs,
                                       model.postnet.bns))]
    shares, abs_errs = [], []
    with torch.no_grad():
        x = model.encoder.embedding(tokens).transpose(1, 2)
        for part, i, conv, bn, act in layers:
            if part == "postnet" and i == 0:
                x = mel_coarse.transpose(1, 2)
            got = conv_bn_act(x, conv, bn, eps, act)
            ref = conv_bn_act_reference(x, conv, bn, eps, act)
            shares.append(conv_share(got, ref))
            abs_errs.append(float((got - ref).abs().max()))
            x = ref
    torch.cuda.synchronize()
    return shares, abs_errs


def convbn_sweep(dev):
    """Phase 11.  Returns the largest absolute error over the sweep."""
    from tacotron2_torch.ops.convbn_kernel import (conv_bn_act,
                                                   conv_bn_act_reference)
    worst_abs = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for c_in, c_out in ((512, 512), (80, 512), (512, 80)):
            conv, bn = conv_layer(c_in, c_out, 5, dtype, c_in + c_out, dev)
            worst, n = 0.0, 0
            for t in (1, 37, 128, 1000):
                for b in (1, 4, 16):
                    x = torch.randn(
                        b, c_in, t,
                        generator=torch.Generator().manual_seed(b * t)).to(dev)
                    for act in ("relu", "tanh", "none"):
                        got = conv_bn_act(x, conv, bn, 1e-5, act)
                        torch.cuda.synchronize()
                        ref = conv_bn_act_reference(x, conv, bn, 1e-5, act)
                        check(got.shape == ref.shape == (b, c_out, t)
                              and got.dtype == torch.float32
                              and bool(torch.isfinite(got).all()),
                              f"conv_bn_act output at B={b} T={t}")
                        share = conv_share(got, ref)
                        check(share <= CONV_TOL[dtype],
                              f"conv_bn_act {dtype} {c_in}->{c_out} B={b} "
                              f"T={t} {act}: error {share} of the mean size, "
                              f"limit {CONV_TOL[dtype]}")
                        worst = max(worst, share)
                        worst_abs = max(worst_abs,
                                        float((got - ref).abs().max()))
                        n += 1
            x = torch.randn(4, c_in, 400, device=dev)
            call = lambda: conv_bn_act(x, conv, bn, 1e-5, "tanh")
            repeat = torch.equal(call(), call())
            check(repeat, f"conv_bn_act {dtype} {c_in}->{c_out}: two "
                  "launches on one input differ")
            ms, first, split, dms, n_seen = conv_call_times(call, conv, x)
            stale = conv_refold_check(conv, bn, x)
            print(f"[conv_bn_act] {str(dtype)[6:]:8s} {c_in:3d}->{c_out:3d} "
                  f"K=5: {n} cases (T 1/37/128/1000 x B 1/4/16 x relu/tanh/"
                  f"none), worst error {worst:.2e} of the mean size (limit "
                  f"{CONV_TOL[dtype]:g}); B=4 T=400: split {split}, "
                  f"{ms:.4f} ms per call with the fold made, first call "
                  f"with the fold {first:.4f} ms, kernel alone (a CUDA "
                  f"graph of 20 launches) {dms:.4f} ms; ten calls "
                  f"dispatch only their outputs' allocation and launch ten "
                  f"times, torch.profiler saw {n_seen} of those launches "
                  f"and no other kernel; "
                  f"two launches bit for bit; after a copy_ into the weight "
                  f"{stale:.2e} of the mean size", flush=True)
    return worst_abs


class DispatchedOps(TorchDispatchMode):
    """The ATen ops dispatched to PyTorch inside the ``with`` block."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def conv_call_times(call, conv, x):
    """A conv_bn_act call's time with the layer's fold made, the first
    call's (which makes the fold), the split it launches with, the kernel's
    own device time (a CUDA graph of 20 calls) and the launches
    torch.profiler saw of ten calls.  With the fold made a call must
    dispatch nothing to PyTorch but its output's allocation and launch the
    kernel once: the profiler leaves short launches out of its trace now
    and then (at times all ten), so it is held only to seeing no other
    kernel."""
    from tacotron2_torch.ops import convbn_kernel
    ms = time_ms(call, 30)

    def first_call():
        convbn_kernel._FOLDS.pop(conv, None)
        return call()

    first = time_ms(first_call, 10)
    before = convbn_kernel.conv_bn_act.launches
    with DispatchedOps() as dispatched:
        for _ in range(10):
            call()
    check(dispatched.ops == ["aten.empty.memory_format"] * 10
          and convbn_kernel.conv_bn_act.launches == before + 10,
          f"ten conv_bn_act calls with the fold made dispatched "
          f"{dispatched.ops} and launched "
          f"{convbn_kernel.conv_bn_act.launches - before} times")
    seen = kernel_launches(call, 10)
    check(all("conv_bn_act" in k for k in seen), f"ten conv_bn_act calls "
          f"with the fold made: torch.profiler saw other kernels: "
          f"{sorted(seen)}")
    return (ms, first, convbn_kernel.launch_split(x, conv),
            graph_ms(call, 20), sum(c for c, _ in seen.values()))


def conv_refold_check(conv, bn, x, eps=1e-5):
    """After a copy_ into the conv's weight the kernel agrees with the plain
    version on the new weights (the fold was made again), and after a
    copy_ of the old weights back it gives the old bits.  Returns the
    error as a share of the plain output's mean size."""
    from tacotron2_torch.ops.convbn_kernel import (conv_bn_act,
                                                   conv_bn_act_reference)
    with torch.no_grad():
        before = conv_bn_act(x, conv, bn, eps, "none")
        w0 = conv.weight.clone()
        conv.weight.copy_(-0.5 * w0)
        got = conv_bn_act(x, conv, bn, eps, "none")
        torch.cuda.synchronize()
        share = conv_share(got, conv_bn_act_reference(x, conv, bn, eps,
                                                      "none"))
        limit = CONV_TOL[conv.weight.dtype]
        check(share <= limit, f"conv_bn_act after a copy_ into the weight: "
              f"{share} of the mean size (limit {limit}): the fold was not "
              f"made again")
        conv.weight.copy_(w0)
        check(torch.equal(conv_bn_act(x, conv, bn, eps, "none"), before),
              "conv_bn_act after the weight was copied back differs")
    return share


def conv_split_sweep(model, seqs, eps):
    """conv_bn_act's device time at each split for two layers of the text ->
    PCM path: a 512 -> 512 encoder layer of one sentence (B=1, T_enc=32)
    and a 512 -> 512 postnet layer of the batched request (B=4, T=400), on
    seeded inputs; the wrapper's pick is marked."""
    from tacotron2_torch.ops import convbn_kernel as ck
    from tacotron2_torch.text import pad_sequences
    t_enc = pad_sequences(seqs[:1], pad_multiple=16)[0].shape[1]
    g = torch.Generator().manual_seed(SEED)
    for part, b, t in (("encoder", 1, t_enc), ("postnet", len(seqs),
                                                MAX_STEPS)):
        layers = getattr(model, part)
        conv, bn = layers.convs[1], layers.bns[1]
        x = torch.randn(b, conv.weight.shape[1], t, generator=g).to(
            conv.weight.device)
        fold = ck.folded_weights(conv, bn, eps)
        pick = ck.launch_split(x, conv)
        times = {s: graph_ms(lambda: ck._launch(x, fold, "tanh", s), 20)
                 for s in (1, 2, 4, 8)}
        print(f"[conv_bn_act split] {part}.1 B={b} T={t} 512->512 bf16, "
              f"kernel alone by split (CUDA graphs of 20 launches): "
              + ", ".join(f"S={s} {ms:.4f} ms" + (" (picked)" if s == pick
                                                   else "")
                          for s, ms in times.items()), flush=True)


def text_to_pcm_main_path(dev, base, mels_requests):
    """Phases 12 and 13 on ``base``, the seeded full-width model;
    ``mels_requests`` are the token sequences of phase 6.  Returns
    conv_bn_act's kernels-line entry and decoder_infer_mega's launches and
    largest error on the text -> PCM path."""
    import torch.nn.functional as F
    from scipy.io import wavfile
    from tacotron2_torch.config import Config
    from tacotron2_torch.dsp.griffinlim import griffin_lim, mel_to_linear
    from tacotron2_torch.infer.fused import (_mask_and_slice, estimate_frames,
                                             pick_bucket,
                                             synthesize_pcm_proportional,
                                             synthesize_wav)
    from tacotron2_torch.infer.synthesize import load_model, synthesize
    from tacotron2_torch.models.decoder import decoder_infer
    from tacotron2_torch.models.encoder import encoder_apply
    from tacotron2_torch.models.postnet import postnet_apply
    from tacotron2_torch.models.tacotron2 import (cast_params_bf16,
                                                  make_pad_mask,
                                                  replace_config,
                                                  tacotron2_infer)
    from tacotron2_torch.ops.convbn_kernel import (conv_bn_act,
                                                   conv_bn_act_reference,
                                                   fold_conv_bn)
    from tacotron2_torch.ops.decoder_megakernel import (
        decoder_infer_mega, decoder_infer_mega_reference)
    from tacotron2_torch.text import (find_lexicon_path, lts_model,
                                      lts_neural, pad_sequences,
                                      text_to_sequence)
    from tacotron2_torch.text.frontend import _default_g2p

    # depth cut to MAX_STEPS frames; every width is ModelConfig()'s
    cfg = Config(model=dataclasses.replace(base.cfg,
                                           max_decoder_steps=MAX_STEPS))
    acfg, hop = cfg.audio, cfg.audio.hop_length
    texts = list(SMOKE_TEXTS)
    model = cast_params_bf16(base).to(dev)
    check(all(p.dtype == torch.bfloat16 for p in model.parameters())
          and model.cfg.decoder_megakernel and model.cfg.fused_convbn,
          "serving model is not bf16 with both kernels on")

    # the text frontend, on the host (the first call loads the lexicon and
    # the two letter-to-sound tables)
    t1 = time.perf_counter()
    seqs = [text_to_sequence(t) for t in texts]
    first_ms = (time.perf_counter() - t1) * 1e3
    t1 = time.perf_counter()
    for _ in range(5):
        [text_to_sequence(t) for t in texts]
    text_ms = (time.perf_counter() - t1) * 1e3 / 5 / len(texts)
    g2p = _default_g2p()
    check(len(g2p._lexicon) > 100000 and find_lexicon_path().endswith(
        os.path.join("third_party", "cmudict", "cmudict.gz")),
        "the CMUdict lexicon did not load")
    check(g2p._lts_model is not None and g2p._lts_neural is not None
          and os.path.isfile(lts_model.DEFAULT_MODEL_PATH)
          and os.path.isfile(lts_neural.DEFAULT_MODEL_PATH),
          "a letter-to-sound table did not load: G2p would go on with rules")
    check(g2p.resolution("zorblaxian") == "lts_model",
          "the out-of-lexicon word did not reach the LTS tables")
    for t, seq in zip(texts, seqs):
        check(seq == SMOKE_TEXTS[t], f"token ids of {t!r}: {seq}")
    print(f"[speak] lexicon of {len(g2p._lexicon)} words and both LTS tables "
          f"loaded; {len(texts)} sentences, token ids as pinned "
          f"({[len(q) for q in seqs]} tokens); text frontend {text_ms:.2f} ms "
          f"a sentence on the host (first call with the loads "
          f"{first_ms:.0f} ms); seeded weights, bf16: the audio is not "
          f"speech", flush=True)

    # warm-up outside the counted run (FFT plans, first launches)
    synthesize_wav(model, ["warm up."], cfg, max_steps=8, gl_iters=1)
    conv_bn_act.launches = 0
    decoder_infer_mega.launches = 0
    model_calls = 0

    def counted(want_calls, where):
        """The launches since the last call of this function."""
        nonlocal model_calls
        calls = decoder_infer_mega.launches - model_calls
        model_calls += calls
        check(calls == want_calls
              and conv_bn_act.launches == 8 * model_calls,
              f"{where}: {calls} model calls (expected {want_calls}), "
              f"decoder_infer_mega {decoder_infer_mega.launches}, "
              f"conv_bn_act {conv_bn_act.launches}")
        return calls

    def check_pcm(pcm, n, where):
        """int16, not silent before the stop, at the floor after it (a
        frame's window reaches two hops past its centre)."""
        check(pcm.dtype == np.int16, f"{where}: PCM is {pcm.dtype}")
        x = pcm.astype(np.float64)
        peak = np.abs(x[:n * hop]).max()
        rms = np.sqrt((x[:n * hop] ** 2).mean())
        tail = np.abs(x[(n + 4) * hop:]).max() if (n + 4) * hop < len(x) else 0
        check(np.isfinite(rms) and rms > 0 and peak > 0,
              f"{where}: silent before the stop")
        check(tail <= max(1.0, 0.02 * peak), f"{where}: {tail:.0f} after the "
              f"stop, peak {peak:.0f}")
        return rms, peak, tail

    # (a) batched, texts in, trimmed waveforms out
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    wavs = synthesize_wav(model, texts, cfg, max_steps=MAX_STEPS)
    batched_s = time.perf_counter() - t1
    counted(1, "synthesize_wav")
    check(all(w.dtype == np.float32 and np.isfinite(w).all()
              and float(np.abs(w).max()) > 0 for w in wavs),
          "synthesize_wav: waveforms not finite or silent")
    ends_b = [len(w) // hop for w in wavs]
    check(all(len(w) == MAX_STEPS * hop for w in wavs),
          f"batched: no gate stop, so every item ends at max_steps; got "
          f"{ends_b}")
    audio_s = sum(ends_b) * hop / acfg.sampling_rate
    print(f"[speak] synthesize_wav, B={len(texts)}, max_steps {MAX_STEPS}: "
          f"frame_ends {ends_b} (= max_steps: seeded weights fire no gate); "
          f"wall {batched_s * 1e3:.1f} ms for {audio_s:.2f} s of audio, "
          f"real-time factor {batched_s / audio_s:.4f}; peak "
          f"{max(float(np.abs(w).max()) for w in wavs):.3f}", flush=True)

    # (b) one by one through the length-proportional path: with a forced
    # stop inside the picked bucket (one model call), then without (the
    # gate is still open at the bucket's cap: one escalation to max_steps)
    for text, seq in zip(texts, seqs):
        tokens, lengths = pad_sequences([seq], pad_multiple=16)
        check(pick_bucket(estimate_frames(len(seq)), MAX_STEPS)
              == SPEAK_BUCKET, f"{text!r}: bucket from {len(seq)} tokens")
        for forced, want_calls, want_bucket, want_end in (
                (SPEAK_FORCED_STOP, 1, SPEAK_BUCKET, SPEAK_FORCED_STOP),
                (None, 2, MAX_STEPS, MAX_STEPS)):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pcm, ends, bucket, mel = synthesize_pcm_proportional(
                model, acfg, tokens, lengths, max_steps=MAX_STEPS,
                forced_stop_at=forced, return_mel=True)
            wall = time.perf_counter() - t1
            calls = counted(want_calls, repr(text))
            n = int(ends[0])
            check(bucket == want_bucket and n == want_end,
                  f"{text!r}: forced_stop_at={forced} gave bucket {bucket}, "
                  f"frame_ends {n}; expected {want_bucket}, {want_end}")
            check(pcm.shape == (1, bucket * hop), f"PCM shape {pcm.shape}")
            check(mel.shape == (1, bucket, acfg.n_mels)
                  and bool(np.isfinite(mel).all()), "returned mel")
            rms, peak, tail = check_pcm(pcm[0], n, repr(text))
            secs = n * hop / acfg.sampling_rate
            print(f"[speak] {text!r}: {len(seq)} tokens, forced_stop_at="
                  f"{forced} -> {n} frames, bucket {bucket}, {calls} model "
                  f"call(s); wall {wall * 1e3:.1f} ms for {secs:.2f} s of "
                  f"audio, real-time factor {wall / secs:.4f}; PCM rms "
                  f"{rms:.0f} peak {peak:.0f}, after the stop {tail:.0f}",
                  flush=True)

    # (c) the whole entry point: text + weights file -> WAV on disk.  The
    # weights file is this model's own state_dict, saved here.
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "seeded_bf16.pt")
        torch.save(model.state_dict(), weights)
        t1 = time.perf_counter()
        path = synthesize(texts[2], weights, os.path.join(tmp, "out"),
                          cfg=cfg)
        wall = time.perf_counter() - t1
        served = load_model(weights, cfg, dev)      # launches no kernel
        check(os.path.isfile(path) and path.endswith("output_1.wav"),
              f"no WAV at {path}")
        sr, audio = wavfile.read(path)
    counted(2, "synthesize")
    check(sr == acfg.sampling_rate and audio.dtype == np.float32
          and audio.ndim == 1 and bool(np.isfinite(audio).all()),
          "the WAV read back")
    check(len(audio) == MAX_STEPS * hop and float(np.abs(audio).max()) > 0,
          f"the WAV's length {len(audio)} or level")
    print(f"[speak] synthesize({texts[2]!r}) wrote and read back "
          f"{len(audio)} samples ({len(audio) // hop} frames) at {sr} Hz, "
          f"peak {float(np.abs(audio).max()):.3f}; wall {wall * 1e3:.1f} ms "
          f"with the weights' load and the escalation; load_model upcasts "
          f"the file's bf16 weights to fp32, as the JAX package does, so "
          f"this request runs the fp32 (FMA) conv_bn_act and the fp32 "
          f"decode kernel", flush=True)
    launches = (conv_bn_act.launches, decoder_infer_mega.launches)
    print(f"[speak] launches conv_bn_act={launches[0]} decoder_infer_mega="
          f"{launches[1]} over {model_calls} model calls", flush=True)
    check(launches == (8 * model_calls, model_calls) and model_calls == 15,
          f"text -> PCM path launched {launches} over {model_calls} calls")
    check(all(p.dtype == torch.float32 for p in served.state_dict().values()
              if p.is_floating_point()), "load_model did not serve fp32")

    # where a request's time goes, part by part (second of two runs each,
    # under the profiler): the batched request, then the first alone
    def timed(fn):
        fn()
        out, wall_ms, _, busy_ms = profile_step(fn)
        return out, wall_ms, busy_ms

    def parts(batch_texts, steps):
        tokens, lengths = pad_sequences(
            [text_to_sequence(t) for t in batch_texts], pad_multiple=16)
        tok = torch.from_numpy(tokens).long().to(dev)
        rows = []
        memory, *row = timed(lambda: encoder_apply(model.encoder, tok))
        rows.append(("encoder", *row))
        mask = make_pad_mask(torch.from_numpy(lengths).to(dev),
                             tokens.shape[1])
        stop_mode = "all" if len(batch_texts) > 1 else "any"
        decoded, *row = timed(lambda: decoder_infer(
            model.decoder, memory, steps, cfg.model.gate_threshold,
            mask=mask, stop_mode=stop_mode))
        rows.append(("decode", *row))
        coarse, ends = decoded[0], decoded[4]
        residual, *row = timed(lambda: postnet_apply(
            model.postnet, coarse.transpose(1, 2)))
        rows.append(("postnet", *row))
        mel_post = coarse + residual.transpose(1, 2)
        mel_lin = torch.exp(_mask_and_slice(
            mel_post, ends, steps, acfg.mel_eps).transpose(1, 2))
        mkw = dict(sr=acfg.sampling_rate, n_fft=acfg.n_fft,
                   n_mels=acfg.n_mels, fmin=acfg.fmin, fmax=acfg.fmax)
        linear, *row = timed(lambda: mel_to_linear(mel_lin, **mkw))
        rows.append(("mel_to_linear", *row))
        _, *row = timed(lambda: griffin_lim(
            linear, n_fft=acfg.n_fft, hop_length=hop,
            win_length=acfg.win_length, length=steps * hop))
        rows.append(("griffin_lim", *row))
        total = sum(r[1] for r in rows)
        print(f"[speak] one request by part, B={len(batch_texts)} "
              f"T_enc={tokens.shape[1]} at {steps} frames (wall ms / device "
              f"busy ms / idle share): text frontend on the host "
              f"{text_ms * len(batch_texts):.2f}; "
              + "; ".join(f"{n} {w:.2f} / {b:.2f} / {1 - b / w:.3f}"
                          for n, w, b in rows)
              + f"; device parts together {total:.1f} ms", flush=True)

    parts(texts, MAX_STEPS)
    parts(texts[:1], SPEAK_BUCKET)

    # the decode kernel against the plain step loop on this path's own
    # decodes: the batched request, and each sentence alone as the
    # length-proportional path decodes it (bucket-capped with the forced
    # stop, bucket-capped without, escalated to max_steps)
    def decode_check(token_seqs, steps, forced, net=model):
        tokens, lengths = pad_sequences(token_seqs, pad_multiple=16)
        tok = torch.from_numpy(tokens).long().to(dev)
        memory = encoder_apply(net.encoder, tok)
        mask = make_pad_mask(torch.from_numpy(lengths).to(dev), tok.shape[1])
        b = len(token_seqs)
        args = (net.decoder, memory, steps, cfg.model.gate_threshold, True,
                mask, "all" if b > 1 else "any", forced)
        got = decoder_infer_mega(*args)
        ref = decoder_infer_mega_reference(*args)
        dtype = next(net.decoder.parameters()).dtype
        where = (f"main text->PCM {str(dtype)[6:]} B={b} T_enc={tok.shape[1]}"
                 f" max_steps={steps} forced_stop_at={forced} decode kernel")
        errs = compare_decode(got, ref, dtype, where)
        want = steps if forced is None else forced
        check(got[4].tolist() == [want] * b,
              f"{where}: frame_ends {got[4].tolist()}, expected {want}")
        return max(errs.values())

    # and the fp32 model that synthesize served in (c), at that request's
    # two decodes: bucket-capped, then escalated
    speak_dec_err = max(
        [decode_check(seqs, MAX_STEPS, None)]
        + [decode_check([seq], steps, forced) for seq in seqs
           for steps, forced in ((SPEAK_BUCKET, SPEAK_FORCED_STOP),
                                 (SPEAK_BUCKET, None), (MAX_STEPS, None))]
        + [decode_check([seqs[2]], steps, None, served)
           for steps in (SPEAK_BUCKET, MAX_STEPS)])

    # 13. conv_bn_act on the real input of each of the eight layers
    def cudnn_layer(x, w_oik, h, act):
        y = F.conv1d(x.to(w_oik.dtype), w_oik, padding=2).float() \
            + h[None, :, None]
        return torch.relu(y) if act == "relu" else (
            torch.tanh(y) if act == "tanh" else y)

    def layers_of(token_seqs, steps, timed, net=model):
        """Kernel against plain version on each layer's real input of one
        request; ``timed`` adds the times and the bound."""
        tokens, lengths = pad_sequences(token_seqs, pad_multiple=16)
        with torch.no_grad():
            out, _, _ = tacotron2_infer(
                net, tokens, max_steps=steps, text_lengths=lengths,
                stop_mode="all" if len(token_seqs) > 1 else "any")
            x = net.encoder.embedding(
                torch.from_numpy(tokens).long().to(dev)).transpose(1, 2)
        n_post = len(net.postnet.convs)
        stack = [("encoder", i, c, b_, "relu") for i, (c, b_) in enumerate(
            zip(net.encoder.convs, net.encoder.bns))] + [
            ("postnet", i, c, b_, "tanh" if i < n_post - 1 else "none")
            for i, (c, b_) in enumerate(zip(net.postnet.convs,
                                            net.postnet.bns))]
        rows = []
        for part, i, conv, bn, act in stack:
            if part == "postnet" and i == 0:
                x = out.mel_coarse.transpose(1, 2)
            eps = cfg.model.batchnorm_eps
            got = conv_bn_act(x, conv, bn, eps, act)
            torch.cuda.synchronize()
            ref = conv_bn_act_reference(x, conv, bn, eps, act)
            share = conv_share(got, ref)
            where = (f"main {str(conv.weight.dtype)[6:]} B={x.shape[0]} "
                     f"T={x.shape[2]} {part}.{i} {conv.weight.shape[1]}->"
                     f"{conv.weight.shape[0]} {act}")
            check(share <= CONV_MAIN_TOL, f"{where}: conv_bn_act error "
                  f"{share} of the mean size")
            if not timed:
                rows.append(dict(err_share=share,
                                 max_abs_err=float((got - ref).abs().max())))
                print(f"[{where}] kernel vs plain {share:.2e} of the mean "
                      f"size (limit {CONV_MAIN_TOL:g})", flush=True)
                x = got
                continue
            wmat, h = fold_conv_bn(conv, bn, eps)
            w_oik = wmat.permute(2, 1, 0).to(conv.weight.dtype).contiguous()
            xin = x
            call = lambda: conv_bn_act(xin, conv, bn, eps, act)
            check(torch.equal(call(), got), f"{where}: two launches on one "
                  "input differ")
            ms, first, split, dms, n_seen = conv_call_times(call, conv,
                                                            xin)
            refold = conv_refold_check(conv, bn, xin, eps)
            plain = time_ms(
                lambda: conv_bn_act_reference(xin, conv, bn, eps, act), 10)
            lib = time_ms(lambda: cudnn_layer(xin, w_oik, h, act), 30)
            lib_dev = graph_ms(lambda: cudnn_layer(xin, w_oik, h, act), 20)
            b_, c_in, t = x.shape
            c_out, _, k = conv.weight.shape
            # each input read once (x, the conv's and the BatchNorm's
            # tensors), the output written once; the products' operations
            # at the peak rate of the weight dtype
            wdt = conv.weight.dtype
            bnd = bound(x.numel() * x.element_size() + 4 * b_ * t * c_out
                        + (k * c_in + 3) * c_out * wdt.itemsize + 8 * c_out,
                        2 * b_ * t * c_in * c_out * k, wdt)
            rows.append(dict(layer=f"{part}.{i}", B=b_, T=t, C_in=c_in,
                             C_out=c_out, act=act, err_share=share,
                             max_abs_err=float((got - ref).abs().max()),
                             split=split, ms=ms, first_call_ms=first,
                             profiler_saw_of_10=n_seen,
                             device_ms=dms, plain_ms=plain,
                             library_ms=lib, library_device_ms=lib_dev,
                             bound_ms=bnd[0], bound_by=bnd[1]))
            print(f"[{where}] kernel vs plain {share:.2e} of the mean size "
                  f"(limit {CONV_MAIN_TOL:g}), two launches bit for bit, "
                  f"{refold:.2e} after a copy_ into the weight; ten calls "
                  f"one launch each (torch.profiler saw {n_seen} of them, "
                  f"no other kernel); "
                  f"split {split}; {ms:.4f} ms per call with the fold made "
                  f"(first call with the fold {first:.4f} ms), kernel alone "
                  f"{dms:.4f} ms, plain {plain:.4f} ms, cuDNN on the folded "
                  f"weights {lib:.4f} ms (its kernels alone {lib_dev:.4f} "
                  f"ms; both alone from CUDA graphs of 20 calls), bound "
                  f"{bnd[0]:.5f} ms ({bnd[1]})",
                  flush=True)
            x = got
        return rows

    rows_b = layers_of(seqs, MAX_STEPS, True)
    rows_1 = layers_of(seqs[:1], SPEAK_BUCKET, True)
    conv_split_sweep(model, seqs, cfg.model.batchnorm_eps)
    # and of the tokens -> mels requests of phase 6, batched and one by one
    rows_m = [row for batch in [mels_requests] + [[q] for q in mels_requests]
              for row in layers_of(batch, MAX_STEPS, False)]
    # and of the fp32 model that synthesize served in (c), at that
    # request's two postnet lengths
    rows_s = [row for steps in (SPEAK_BUCKET, MAX_STEPS)
              for row in layers_of([seqs[2]], steps, False, served)]

    # the fused (kernel) route against the unfused (cuDNN, TF32 off) route
    def set_fused(on: bool) -> None:
        replace_config(model, fused_convbn=on)

    tokens, lengths = pad_sequences(seqs, pad_multiple=16)
    routes = {}
    for on in (True, False):
        set_fused(on)
        before = conv_bn_act.launches
        out, _, ends = tacotron2_infer(model, tokens, max_steps=MAX_STEPS,
                                       text_lengths=lengths, stop_mode="all")
        check(conv_bn_act.launches - before == (8 if on else 0),
              f"fused_convbn={on} launched "
              f"{conv_bn_act.launches - before} conv kernels")
        routes[on] = (out.mel_postnet.float(), ends.cpu().numpy())
    set_fused(True)
    check(np.array_equal(routes[True][1], routes[False][1])
          and bool((routes[True][1] == MAX_STEPS).all()),
          f"fused and unfused routes stop at {routes[True][1].tolist()} and "
          f"{routes[False][1].tolist()}")
    d = (routes[True][0] - routes[False][0]).abs()
    size = float(routes[False][0].abs().mean())
    first, mean = float(d[:, :10].max()) / size, float(d.mean()) / size
    print(f"[main text->PCM] fused route vs unfused route, whole batched "
          f"request: frame_ends {routes[True][1].tolist()} on both; postnet "
          f"mels of mean size {size:.3f}: first 10 frames differ by at most "
          f"{first:.3e} of it (limit {ROUTE_FIRST_TOL}), whole utterances by "
          f"{mean:.3e} of it on average (limit {ROUTE_MEAN_TOL}; largest "
          f"single difference {float(d.max()):.3e}: a bf16 rollout feeds a "
          f"folded weight's other rounding back in)", flush=True)
    check(first <= ROUTE_FIRST_TOL and mean <= ROUTE_MEAN_TOL,
          "fused and unfused routes disagree")

    mid = rows_b[5]        # a 512 -> 512 postnet layer of the batched request
    rows_all = rows_b + rows_1 + rows_m + rows_s
    conv_entry = dict(
        name="conv_bn_act", route="cuda",
        source="tacotron2_torch/csrc/conv_bn_act.cu",
        replaces="tacotron2_tpu/ops/convbn_kernel.py:86",
        launches=launches[0],
        max_abs_err=max(r["max_abs_err"] for r in rows_all),
        max_err_share_of_mean=max(r["err_share"] for r in rows_all),
        split=mid["split"], ms=mid["ms"], first_call_ms=mid["first_call_ms"],
        plain_ms=mid["plain_ms"], bound_ms=mid["bound_ms"],
        bound_by=mid["bound_by"], library_ms=mid["library_ms"],
        device_ms=mid["device_ms"],
        library_device_ms=mid["library_device_ms"],
        shape=f"{mid['layer']} B={mid['B']} T={mid['T']} "
              f"{mid['C_in']}->{mid['C_out']} K=5 weights bf16",
        request_ms=sum(r["ms"] for r in rows_b),
        request_device_ms=sum(r["device_ms"] for r in rows_b),
        device_ms_from="CUDA events over a CUDA graph of 20 calls",
        layers_batched=rows_b, layers_single=rows_1)
    return conv_entry, dict(speak_path_launches=launches[1],
                            speak_path_max_abs_err=speak_dec_err)


def trained_weights_phase(dev, smi: str):
    """Phase 14.  ``checkpoints/r4_synth_bf16`` read by ``load_model`` (no
    JAX); each sentence of ``TRAINED_FRAME_ENDS`` decoded alone by the
    decode kernel and by the plain step loop (whose attention tail is the
    kernel), with no forced stop, in fp32 as loaded and in bf16 as the
    smoke serves; then one ``synthesize`` to a WAV.  Returns the
    kernels-line additions of the decode kernel and the attention tail's
    launches."""
    from tacotron2_torch.config import AudioConfig
    from tacotron2_torch.dsp.wav import load_audio
    from tacotron2_torch.infer.synthesize import (load_model, synthesize,
                                                  synthesize_mels)
    from tacotron2_torch.models.decoder import decoder_infer_steps
    from tacotron2_torch.models.encoder import encoder_apply
    from tacotron2_torch.models.tacotron2 import (
        _condition_memory, cast_params_bf16, make_pad_mask)
    from tacotron2_torch.ops.attention_kernel import attention_tail
    from tacotron2_torch.ops.decoder_megakernel import decoder_infer_mega
    from tacotron2_torch.text import pad_sequences, text_to_sequence
    import tacotron2_torch.utils.orbax_reader as reader

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    model32 = load_model(TRAINED_CKPT, device=dev)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t1) * 1e3
    model = cast_params_bf16(model32)
    cfg = model.cfg
    print(f"[trained] load_model({os.path.relpath(TRAINED_CKPT)}) without "
          f"JAX: {load_ms:.1f} ms, zstd by {reader.ZSTD_LIBRARY} (ctypes) "
          f"({smi})", flush=True)
    decoder_infer_mega.launches = 0
    attention_tail.launches = 0
    worst = 0.0
    for m in (model32, model):
        dec = m.decoder
        cdt = dec.attention_lstm.weight_ih.dtype
        for text, want in TRAINED_FRAME_ENDS.items():
            tokens, lengths = pad_sequences([text_to_sequence(text)],
                                            pad_multiple=16)
            n_tok = int(lengths[0])
            with torch.no_grad():
                tok = torch.from_numpy(tokens).long().to(dev)
                memory = _condition_memory(
                    m, encoder_apply(m.encoder, tok), None)
                mask = make_pad_mask(torch.from_numpy(lengths).to(dev),
                                     tok.shape[1])
                args = (dec, memory, TRAINED_MAX_STEPS, cfg.gate_threshold,
                        True, mask, "any", None)
                runs = {"kernel": decoder_infer_mega(*args),
                        "step loop": decoder_infer_steps(*args)}
            torch.cuda.synchronize()
            where = f"trained {str(cdt)[6:]} {text!r}"
            stops, paths = {}, {}
            for path, out in runs.items():
                n = int(out[3])
                stops[path] = n
                paths[path] = out[2][0, :n].float().argmax(-1)
                check(n < TRAINED_MAX_STEPS and int(out[4][0]) == n,
                      f"{where} {path}: the gate did not fire ({n} frames, "
                      f"frame_ends {out[4].tolist()})")
                check(abs(n - want) <= STOP_SLACK,
                      f"{where} {path}: stop at {n}, pinned {want}")
                check(int(paths[path][-1]) >= n_tok - 1 - STOP_SLACK,
                      f"{where} {path}: the alignment ends at token "
                      f"{int(paths[path][-1])} of {n_tok}")
            k = min(stops.values())
            check(max(stops.values()) - k <= STOP_SLACK,
                  f"{where}: stops {stops} differ")
            got, ref = runs["kernel"], runs["step loop"]
            diff = (got[0][0, :k] - ref[0][0, :k]).abs()
            gate_err = float((got[1][0, :k] - ref[1][0, :k]).abs().max())
            al_err = float((got[2][0, :k] - ref[2][0, :k]).abs().max())
            path_gap = int((paths["kernel"][:k]
                            - paths["step loop"][:k]).abs().max())
            line = (f"[{where}] gate stops: kernel {stops['kernel']}, step "
                    f"loop {stops['step loop']} (pinned {want}); alignment "
                    f"ends at token {int(paths['kernel'][-1])} / "
                    f"{int(paths['step loop'][-1])} of {n_tok}, paths "
                    f"{path_gap} apart; over {k} shared frames mels max "
                    f"{float(diff.max()):.3e} (first ten frames "
                    f"{float(diff[:10].max()):.3e}, mean "
                    f"{float(diff.mean()):.3e}), gates {gate_err:.3e}, "
                    f"alignments {al_err:.3e}")
            if cdt == torch.float32:
                al_tol = DEC_ALIGN_SHARE[cdt] * float(
                    ref[2][0, :k].abs().mean())
                tol = dict(mels=DEC_TOL[cdt]["mels"],
                           gates=DEC_TOL[cdt]["gates"], aligns=al_tol)
                print(line + f" (tol {tol})", flush=True)
                for name, err in (("mels", float(diff.max())),
                                  ("gates", gate_err), ("aligns", al_err)):
                    check(err <= tol[name],
                          f"{where}: {name} differ by {err}")
                worst = max(worst, float(diff.max()))
            else:
                print(line + f" (tol first ten {TRAINED_FIRST_TOL}, mean "
                      f"{TRAINED_MEAN_TOL}, paths {STOP_SLACK})", flush=True)
                check(float(diff[:10].max()) <= TRAINED_FIRST_TOL
                      and float(diff.mean()) <= TRAINED_MEAN_TOL
                      and path_gap <= STOP_SLACK,
                      f"{where}: the decodes part beyond the limits")
    launches = (decoder_infer_mega.launches, attention_tail.launches)
    check(launches[0] == 2 * len(TRAINED_FRAME_ENDS) and launches[1] > 0,
          f"phase 14 launched decoder_infer_mega, attention_tail {launches}")

    # text -> mels a sentence, on the host clock, each after a warm-up run
    hop, sr = AudioConfig().hop_length, AudioConfig().sampling_rate
    for text in TRAINED_FRAME_ENDS:
        synthesize_mels(model, [text], max_steps=TRAINED_MAX_STEPS)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mels, _ = synthesize_mels(model, [text], max_steps=TRAINED_MAX_STEPS)
        wall = time.perf_counter() - t1
        audio_s = mels[0].shape[0] * hop / sr
        print(f"[trained text->mels] {text!r}: {mels[0].shape[0]} frames in "
              f"{wall * 1e3:.2f} ms wall, real-time factor "
              f"{wall / audio_s:.4f} (bf16, decode kernel; {smi})",
              flush=True)

    # one WAV through the entry point, from the checkpoint directory
    text = next(iter(TRAINED_FRAME_ENDS))
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        path = synthesize(text, TRAINED_CKPT, tmp)
        wall = time.perf_counter() - t1
        wav, rate = load_audio(path)
    frames = len(wav) // hop
    check(rate == sr and len(wav) % hop == 0
          and abs(frames - TRAINED_FRAME_ENDS[text]) <= STOP_SLACK
          and bool(np.isfinite(wav).all()) and float(np.abs(wav).max()) > 0,
          f"synthesize wrote {len(wav)} samples at {rate} Hz")
    print(f"[trained synthesize] {text!r} -> {os.path.basename(path)}: "
          f"{frames} frames ({len(wav)} samples), {wall * 1e3:.1f} ms wall "
          f"with the checkpoint's load, real-time factor "
          f"{wall / (len(wav) / sr):.4f} (fp32 as load_model serves; {smi})",
          flush=True)
    del model, model32
    return {"trained_path_launches": launches[0],
            "trained_fp32_max_abs_err": worst}, launches[1]


def training_loop_phase(dev, smi: str):
    """Phase 15.  ``train()`` at the full ``ModelConfig()`` width (bf16 over
    fp32 masters, batch 8) on a corpus written here: two epochs with
    validation; one epoch, then a resume from its epoch checkpoint for the
    second; then a resume from ``checkpoints/r4_synth_bf16``.  Returns the
    launches of attention_tail, decoder_fwd_train_mega and
    decoder_bwd_chain_mega in the first run."""
    import shutil

    from tacotron2_torch.config import Config, TrainConfig
    from tacotron2_torch.data.dataset import BatchLoader, TextMelDataset
    from tacotron2_torch.data.synth_corpus import write_corpus
    from tacotron2_torch.ops.attention_kernel import attention_tail
    from tacotron2_torch.ops.decoder_bwd_kernel import decoder_bwd_chain_mega
    from tacotron2_torch.ops.decoder_train_kernel import decoder_fwd_train_mega
    from tacotron2_torch.train import loop
    from tacotron2_torch.train.checkpoint import (checkpoint_kind,
                                                  restore_checkpoint,
                                                  save_checkpoint)
    from tacotron2_torch.train.optim import make_optimizer
    from tacotron2_torch.train.state import create_train_state
    from tacotron2_torch.utils.profiling import StepTimer

    tmp = tempfile.mkdtemp()
    try:
        t1 = time.perf_counter()
        train_csv, val_csv = write_corpus(os.path.join(tmp, "corpus"), 32,
                                          seed=SEED, n_val=8, device=dev)
        print(f"[loop] corpus of 24 + 8 utterances written in "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
        cfg = Config(train=TrainConfig(batch_size=8, save_every_steps=2))
        check(cfg.train.precision == "bfloat16", "precision is not bf16")

        # every train_step the loop takes: its total loss and the timer
        timer = StepTimer(device=dev)
        losses, step_ms = [], []
        plain_step = loop.train_step

        def recorded_step(*a, **k):
            t2 = time.perf_counter()
            out = plain_step(*a, **k)
            losses.append(float(out[1].total))     # waits for the card
            step_ms.append((time.perf_counter() - t2) * 1e3)
            timer.tick()
            return out

        loop.train_step = recorded_step

        def run(name, **kw):
            nonlocal timer
            losses.clear()
            step_ms.clear()
            timer = StepTimer(device=dev)
            t2 = time.perf_counter()
            state = loop.train(train_csv, os.path.join(tmp, name), cfg=cfg,
                               val_metadata=val_csv, **kw)
            print(f"[loop] {name}: {kw}: {state.step} steps, loss_step "
                  f"{state.loss_step}, {time.perf_counter() - t2:.1f} s wall,"
                  f" losses {[round(x, 4) for x in losses]}", flush=True)
            check(all(np.isfinite(losses)), f"{name}: non-finite loss")
            return state

        try:
            decoder_fwd_train_mega.launches = 0
            decoder_bwd_chain_mega.launches = 0
            attention_tail.launches = 0
            whole = run("unbroken", epochs=2)
            counts = (attention_tail.launches, decoder_fwd_train_mega.launches,
                      decoder_bwd_chain_mega.launches)
            print(f"[loop] launches attention_tail={counts[0]} "
                  f"decoder_fwd_train_mega={counts[1]} "
                  f"decoder_bwd_chain_mega={counts[2]} over {whole.step} "
                  f"steps and two validations", flush=True)
            check(counts[1] == counts[2] == whole.step == 6 and counts[0] > 0,
                  f"phase 15 launches {counts} over {whole.step} steps")
            best = os.path.join(tmp, "unbroken", "best_model")
            check(checkpoint_kind(best) == "full",
                  f"best_model is {checkpoint_kind(best)}")
            # step to step, as the loop's own timer reads it: the cadence
            # saves (every second step and at each epoch's end) included
            mean_step_ms = timer.stats()["step_time_s"] * 1e3
            call_ms = sorted(step_ms)

            run("resumed", epochs=1)
            resumed = run("resumed", epochs=2, resume=os.path.join(
                tmp, "resumed", "tacotron2_epoch_1"))
            same = {
                "weights and statistics": all(
                    torch.equal(a, b) for a, b in zip(
                        whole.model.state_dict().values(),
                        resumed.model.state_dict().values())),
                "moments": all(
                    torch.equal(whole.opt_state[m][n], resumed.opt_state[m][n])
                    for m in ("mu", "nu") for n in whole.opt_state[m]),
                "counters": (whole.step, whole.loss_step,
                             whole.opt_state["count"]) == (
                    resumed.step, resumed.loss_step,
                    resumed.opt_state["count"]),
                "dropout generator": torch.equal(
                    whole.generator.get_state(),
                    resumed.generator.get_state())}
            print(f"[loop] two epochs unbroken vs one + resumed one, bit for "
                  f"bit: {same}", flush=True)
            check(all(same.values()), f"resumed run differs: {same}")

            from_jax = run("from_r4", epochs=1, resume=TRAINED_CKPT)
            check(from_jax.step == 3 and from_jax.opt_state["count"] == 3,
                  f"resume from the Orbax checkpoint took {from_jax.step} "
                  "steps: it did not start at epoch 0 with fresh moments")
        finally:
            loop.train_step = plain_step

        # one step under the profiler, and a checkpoint's save and restore
        state = whole
        batch = next(iter(BatchLoader(TextMelDataset(train_csv), 8,
                                      seed=SEED)))
        tx = make_optimizer(cfg.train)
        warm = cfg.guided_attention.sigma_warmup_steps

        def step():
            return plain_step(state, batch, cfg=cfg, tx=tx, use_postnet=True,
                              sigma_warmup_steps=warm)

        step()
        _, wall_ms, _, busy_ms = profile_step(step)
        path = os.path.join(tmp, "timed")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        save_checkpoint(path, state, 2, 1.0)
        save_ms = (time.perf_counter() - t1) * 1e3
        template = create_train_state(cfg, seed=SEED + 1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        restore_checkpoint(path, template)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t1) * 1e3
        mb = os.path.getsize(os.path.join(path, "train_state.pt")) / 1e6
        print(f"[loop] mean step (StepTimer over the unbroken run, saves "
              f"included, B=8): {mean_step_ms:.1f} ms; train_step calls "
              f"alone {[round(x, 1) for x in call_ms]} ms; one step "
              f"(T_dec={batch['mel'].shape[2]})"
              f" under the profiler: wall "
              f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms (busy share "
              f"{busy_ms / wall_ms:.3f}); full checkpoint of {mb:.1f} MB: "
              f"save {save_ms:.1f} ms, restore {restore_ms:.1f} ms ({smi})",
              flush=True)
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 16: every decoder width padded, A % 4 = 2, D = 30, even conv sizes
ODD_WIDTHS = dict(n_mels=9, prenet_dim=13, symbols_embedding_dim=30,
                  encoder_embedding_dim=30, decoder_rnn_dim=60,
                  attention_rnn_dim=60, attention_dim=14,
                  location_n_filters=4, location_kernel_size=7,
                  postnet_embedding_dim=32, encoder_kernel_size=6,
                  postnet_kernel_size=4)
ODD_TOL = 1e-4          # fp32, relative to max |plain| + 1e-3 of the largest
LONG_TAPS = 11          # an encoder longer than the halo-4 builds take


def odd_widths_phase(dev) -> None:
    """Phase 16.  A config whose widths no kernel was written for runs the
    kernels on the card and agrees with the plain versions on the CPU."""
    from tacotron2_torch.config import ModelConfig
    from tacotron2_torch.models.tacotron2 import (Tacotron2, init_weights,
                                                  make_pad_mask,
                                                  tacotron2_infer)
    from tacotron2_torch.ops.attention_kernel import (
        attention_tail, attention_tail_reference)
    from tacotron2_torch.ops.convbn_kernel import conv_bn_act
    from tacotron2_torch.ops.decoder_bptt import core_params, decoder_scan_bptt
    from tacotron2_torch.ops.decoder_bwd_kernel import decoder_bwd_chain_mega
    from tacotron2_torch.ops.decoder_megakernel import (decoder_infer_mega,
                                                        kernel_widths)
    from tacotron2_torch.ops.decoder_train_kernel import decoder_fwd_train_mega

    def rel(got, ref):
        scale = max(float(r.abs().max()) for r in ref.values())
        return max(float((got[n].detach().float().cpu() - r).abs().max())
                   / (float(r.abs().max()) + 1e-3 * scale)
                   for n, r in ref.items())

    mc = ModelConfig(**ODD_WIDTHS, p_attention_dropout=0.0,
                     p_decoder_dropout=0.0, p_prenet_dropout=0.0,
                     p_postnet_dropout=0.0)
    model = init_weights(Tacotron2(mc), seed=SEED)
    g = torch.Generator().manual_seed(SEED)
    tokens = torch.randint(0, 72, (2, 11), generator=g)
    lengths = torch.tensor([11, 8])
    kw = dict(max_steps=14, text_lengths=lengths, forced_stop_at=9)
    ref = tacotron2_infer(model, tokens, device="cpu", **kw)
    model = model.to(dev)
    decoder_infer_mega.launches = conv_bn_act.launches = 0
    got = tacotron2_infer(model, tokens, device=dev, **kw)
    torch.cuda.synchronize()
    n = int(ref[1])
    err = rel({k: v[:, :n] for k, v in got[0]._asdict().items()},
              {k: v[:, :n] for k, v in ref[0]._asdict().items()})
    print(f"[odd widths] {ODD_WIDTHS} -> the decoder kernels at "
          f"{kernel_widths(mc)}: tacotron2_infer on the card vs the CPU's "
          f"plain request {err:.2e} (limit {ODD_TOL:g}), launches "
          f"decoder_infer_mega={decoder_infer_mega.launches} "
          f"conv_bn_act={conv_bn_act.launches}", flush=True)
    check(decoder_infer_mega.launches == 1 and conv_bn_act.launches == 8,
          "phase 16: the decode and conv kernels did not launch")
    check(int(got[1]) == n and torch.equal(got[2].cpu(), ref[2]),
          "phase 16: frame counts differ")
    check(err < ODD_TOL, f"phase 16: request error {err:.2e}")

    # an encoder of 11 taps: the conv kernel's halo-8 build
    from tacotron2_torch.models.encoder import encoder_apply
    long_enc = init_weights(Tacotron2(dataclasses.replace(
        mc, encoder_kernel_size=LONG_TAPS)), seed=SEED).encoder
    ref_mem = encoder_apply(long_enc, tokens)
    conv_bn_act.launches = 0
    with torch.no_grad():
        got_mem = encoder_apply(long_enc.to(dev), tokens.to(dev))
    torch.cuda.synchronize()
    err = rel({"memory": got_mem}, {"memory": ref_mem.detach()})
    print(f"[odd widths] encoder of {LONG_TAPS} taps on the card vs the "
          f"CPU's plain encoder: {err:.2e} (limit {ODD_TOL:g}), launches "
          f"conv_bn_act={conv_bn_act.launches}", flush=True)
    check(conv_bn_act.launches == mc.encoder_n_convolutions
          and err < ODD_TOL, f"phase 16: {LONG_TAPS}-tap encoder")

    rng = np.random.default_rng(SEED)
    t_dec, b, t_enc = 10, 2, 12
    pre = torch.from_numpy(np.abs(rng.standard_normal(
        (t_dec, b, mc.prenet_dim))).astype(np.float32) * 0.3)
    memory = torch.from_numpy((rng.standard_normal(
        (b, t_enc, mc.encoder_embedding_dim)) * 0.5).astype(np.float32))
    mask = make_pad_mask(torch.tensor([t_enc, t_enc - 3]), t_enc)
    grads = {}
    decoder_fwd_train_mega.launches = decoder_bwd_chain_mega.launches = 0
    for where in ("cpu", dev):
        d = model.decoder.to(where)
        p = {k: x.detach().clone().requires_grad_(True)
             for k, x in core_params(d).items()}
        m = memory.to(where)
        with torch.no_grad():
            pm = d.attention.memory_layer(m)
        out = decoder_scan_bptt(mc, p, pre.to(where), m, pm, mask.to(where),
                                None, None)
        ((out[0] ** 2).sum() + (out[1] ** 2).sum()).backward()
        grads[str(where)] = {k: x.grad.cpu() for k, x in p.items()}
    torch.cuda.synchronize()
    err = rel(grads[str(dev)], grads["cpu"])
    print(f"[odd widths] decoder_scan_bptt gradients, kernel pair on the "
          f"card vs plain pair on the CPU: {err:.2e} (limit {ODD_TOL:g}), "
          f"launches decoder_fwd_train_mega="
          f"{decoder_fwd_train_mega.launches} decoder_bwd_chain_mega="
          f"{decoder_bwd_chain_mega.launches}", flush=True)
    check(decoder_fwd_train_mega.launches == 1
          and decoder_bwd_chain_mega.launches == 1,
          "phase 16: the training kernels did not launch")
    check(err < ODD_TOL, f"phase 16: gradient error {err:.2e}")

    for mem_dtype in (torch.float32, torch.bfloat16):
        for offset in (False, True):
            f = lambda *shape: torch.from_numpy(rng.standard_normal(
                shape).astype(np.float32)).to(dev)
            mem = f(4, 37, 30).to(mem_dtype)
            if offset:      # one element past a 16-byte boundary
                buf = torch.empty(mem.numel() + 1, dtype=mem_dtype,
                                  device=dev)
                mem = buf[1:].view(mem.shape).copy_(mem)
            ins = (f(4, 37, 14), f(14) * 0.3, f(),
                   torch.tensor(1.2, device=dev),
                   make_pad_mask(torch.tensor([37, 30, 9, 37]), 37).to(dev),
                   mem)
            attention_tail.launches = 0
            got = attention_tail(*ins)
            tail_ref = attention_tail_reference(*ins)
            torch.cuda.synchronize()
            err = max_err(got, tail_ref)
            print(f"[odd widths] attention_tail A=14 D=30 memory "
                  f"{str(mem_dtype)[6:]}{' offset' if offset else ''}: "
                  f"{err:.2e} (limit {TAIL_TOL:g}), launches "
                  f"{attention_tail.launches}", flush=True)
            check(attention_tail.launches == 1 and err <= TAIL_TOL,
                  "phase 16: attention_tail at A=14 D=30")


# phase 16 (C6): widths whose location rows, location matrix, conv taps or
# memory rows did not fit a block, each refused on the card before
C6_TRAIN = ({"attention_dim": 512}, {"location_kernel_size": 95})
C6_SERVE = dict(encoder_kernel_size=65, postnet_kernel_size=65,
                attention_dim=512, location_kernel_size=95)
C6_LONG_TAPS = 129      # a conv_bn_act past four tap groups
C6_TAIL_D = 16392       # an fp32 memory row past a 64 KB ring stage
C6_EVAL_TOL = 1e-4      # eval losses, fused route vs cuDNN route, relative


def c6_batch(mc, b=8, t_enc=64, t_dec=160):
    """A seeded ragged batch smaller than the main path's."""
    from tacotron2_torch.data.dataset import Example, collate
    rng = np.random.default_rng(SEED + 16)
    text_lens = rng.integers(t_enc // 2, t_enc + 1, b)
    mel_lens = rng.integers(t_dec // 2, t_dec + 1, b)
    text_lens[0], mel_lens[1] = t_enc, t_dec
    return collate([
        Example(text=rng.integers(0, mc.n_symbols, n).astype(np.int32),
                mel=(rng.standard_normal((mc.n_mels, m)) * 1.5 - 5.0
                     ).astype(np.float32))
        for n, m in zip(text_lens, mel_lens)])


def c6_train_step(dev, widths: dict) -> dict:
    """A bf16 training step at C6 widths: the first step's gradients by
    the kernel route against the plain route (``GRAD_TOL``), both training
    kernels against their plain versions on that step's inputs
    (``MAIN_PAIR_TOL``) with their device times, then a counted
    ``train_step``: #3 and #4 once each."""
    from tacotron2_torch.config import Config, ModelConfig
    from tacotron2_torch.models.tacotron2 import (init_projection_bias,
                                                  replace_config)
    from tacotron2_torch.ops import decoder_bptt
    from tacotron2_torch.ops.decoder_bwd_kernel import (
        chain_plan, decoder_bwd_chain_mega, decoder_bwd_chain_reference)
    from tacotron2_torch.ops.decoder_megakernel import kernel_widths
    from tacotron2_torch.ops.decoder_train_kernel import (
        decoder_fwd_train_mega, decoder_fwd_train_reference, fwd_smem)
    from tacotron2_torch.train import step as train
    from tacotron2_torch.train.optim import make_optimizer
    from tacotron2_torch.train.state import create_train_state

    cfg = Config(model=ModelConfig(**widths))
    mc = cfg.model
    tx = make_optimizer(cfg.train)
    state = create_train_state(cfg, seed=SEED, tx=tx, device=dev)
    model = state.model
    batch = c6_batch(mc)
    b, t_enc = batch["text"].shape
    t_dec = batch["mel"].shape[2]
    init_projection_bias(model, batch["mel"])
    kd = kernel_widths(mc)
    k = mc.location_kernel_size
    plan = chain_plan(kd, b, t_enc, k, torch.bfloat16)
    smem, resident = fwd_smem(t_enc, kd["A"], k, torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    masks = first_step_masks(mc, b, t_dec, g, dev)
    tbatch = train._to_device(batch, dev)
    buffers = {n: x.clone() for n, x in model.named_buffers()}
    calls, grads = {}, {}

    def record(name, fn):
        def wrapper(*args):
            calls[name] = (args, fn(*args))
            return calls[name][1]
        return wrapper

    for on in (True, False):
        replace_config(model, decoder_megakernel=on)
        if on:
            decoder_bptt.decoder_fwd_train_mega = record(
                "fwd", decoder_fwd_train_mega)
            decoder_bptt.decoder_bwd_chain_mega = record(
                "bwd", decoder_bwd_chain_mega)
        try:
            total, _ = train._forward_loss(
                model, cfg, tbatch, None, 0, False,
                cfg.guided_attention.sigma_warmup_steps, masks)
            grads[on] = train._grads(model, total)
        finally:
            decoder_bptt.decoder_fwd_train_mega = decoder_fwd_train_mega
            decoder_bptt.decoder_bwd_chain_mega = decoder_bwd_chain_mega
        with torch.no_grad():
            for n, x in model.named_buffers():
                x.copy_(buffers[n])
    replace_config(model, decoder_megakernel=True)
    errs = grad_errors(grads[True], grads[False], 1e-2)
    worst = max(errs, key=errs.get)
    name = " ".join(f"{k_}={v}" for k_, v in widths.items())
    where = f"odd widths C6 {name} B={b} T_enc={t_enc} T_dec={t_dec} bf16"
    print(f"[{where}] reverse chain's C3 in {plan.location_chunks} chunks "
          f"of {plan.location_cols} columns ({plan.smem_bytes} bytes a "
          f"block); forward's location matrix "
          f"{'resident' if resident else 'in L2'} ({smem} bytes); first "
          f"step's gradients, kernel route vs plain route: worst {worst} "
          f"{errs[worst]:.2e} (limit {GRAD_TOL})", flush=True)
    check(errs[worst] <= GRAD_TOL, f"phase 16 {name}: gradients {worst} "
          f"off by {errs[worst]}")
    detach = lambda xs: tuple(x.detach() if torch.is_tensor(x) else x
                              for x in xs)
    fwd_args, bwd_args = detach(calls["fwd"][0]), detach(calls["bwd"][0])
    fwd_errs = compare_outputs(FWD_OUT, calls["fwd"][1],
                               decoder_fwd_train_reference(*fwd_args),
                               MAIN_PAIR_TOL, f"{where} decoder_fwd_train_mega")
    bwd_errs = compare_outputs(BWD_OUT, calls["bwd"][1],
                               decoder_bwd_chain_reference(*bwd_args),
                               MAIN_PAIR_TOL, f"{where} decoder_bwd_chain_mega")
    fwd_dev = device_ms(lambda: decoder_fwd_train_mega(*fwd_args), 3,
                        "decoder_train_fwd_kernel")
    bwd_dev = device_ms(lambda: decoder_bwd_chain_mega(*bwd_args), 3,
                        "decoder_train_bwd_kernel")
    del calls, grads
    decoder_fwd_train_mega.launches = decoder_bwd_chain_mega.launches = 0
    _, losses, _ = train.train_step(
        state, batch, cfg=cfg, tx=tx, use_postnet=True,
        sigma_warmup_steps=cfg.guided_attention.sigma_warmup_steps)
    loss = float(losses.total)
    launches = (decoder_fwd_train_mega.launches,
                decoder_bwd_chain_mega.launches)
    print(f"[{where}] train_step loss {loss:.4f}, launches "
          f"decoder_fwd_train_mega={launches[0]} decoder_bwd_chain_mega="
          f"{launches[1]}; device decoder_fwd_train_mega {fwd_dev:.3f} ms, "
          f"decoder_bwd_chain_mega {bwd_dev:.3f} ms a launch", flush=True)
    check(launches == (1, 1) and np.isfinite(loss),
          f"phase 16 {name}: train_step launched {launches}, loss {loss}")
    label = f"{name} bf16 B={b} T_enc={t_enc} T_dec={t_dec}"
    return label, {
        "decoder_fwd_train_mega": (1, max(fwd_errs.values()), fwd_dev),
        "decoder_bwd_chain_mega": (1, max(bwd_errs.values()), bwd_dev)}


def c6_widths(dev) -> dict:
    """Phase 16, C6: the configs each kernel refused before.  Returns, per
    kernel, ``c6_launches``, ``c6_max_abs_err`` and ``c6_device_ms`` (by
    config) for the kernels line, and for the long convs
    ``c6_library_ms`` (cuDNN's call and device ms by config)."""
    import torch.nn.functional as F

    from tacotron2_torch.config import Config, ModelConfig
    from tacotron2_torch.models.encoder import encoder_apply
    from tacotron2_torch.models.tacotron2 import (Tacotron2, init_weights,
                                                  make_pad_mask,
                                                  replace_config,
                                                  tacotron2_infer)
    from tacotron2_torch.ops.attention_kernel import (
        attention_tail, attention_tail_reference, tail_plan)
    from tacotron2_torch.ops.convbn_kernel import (conv_bn_act,
                                                   conv_bn_act_reference,
                                                   fold_conv_bn, tap_groups)
    from tacotron2_torch.ops.decoder_megakernel import (decode_smem,
                                                        decoder_infer_mega)
    from tacotron2_torch.train import step as train
    from tacotron2_torch.train.optim import make_optimizer
    from tacotron2_torch.train.state import create_train_state

    out = {}

    def add(kernel, config, launches, err, ms):
        e = out.setdefault(kernel, {"c6_launches": 0, "c6_max_abs_err": 0.0,
                                    "c6_device_ms": {}})
        e["c6_launches"] += launches
        e["c6_max_abs_err"] = max(e["c6_max_abs_err"], err)
        if ms is not None:
            e["c6_device_ms"][config] = ms

    # (a) the training pair at attention_dim 512 and at 95 location taps
    for widths in C6_TRAIN:
        label, entries = c6_train_step(dev, widths)
        for kernel, (n, err, ms) in entries.items():
            add(kernel, label, n, err, ms)
        torch.cuda.empty_cache()

    # (b) serving and eval at 65-tap encoder and postnet convs, with the
    # decode at A=512 and 95 location taps (fp32: its location matrix in
    # L2), against the CPU's plain request
    mc = ModelConfig(**C6_SERVE, p_attention_dropout=0.0,
                     p_decoder_dropout=0.0, p_prenet_dropout=0.0,
                     p_postnet_dropout=0.0)
    model = init_weights(Tacotron2(mc), seed=SEED)
    g = torch.Generator().manual_seed(SEED + 16)
    tokens = torch.randint(0, mc.n_symbols, (2, 40), generator=g)
    lengths = torch.tensor([40, 29])
    kw = dict(max_steps=48, text_lengths=lengths, forced_stop_at=40)
    ref = tacotron2_infer(model, tokens, device="cpu", **kw)
    model = model.to(dev)
    decoder_infer_mega.launches = conv_bn_act.launches = 0
    with torch.no_grad():
        got = tacotron2_infer(model, tokens, device=dev, **kw)
    torch.cuda.synchronize()
    launches = (decoder_infer_mega.launches, conv_bn_act.launches)
    n = int(ref[1])
    rel = max(float((getattr(got[0], f)[:, :n].float().cpu()
                     - getattr(ref[0], f)[:, :n]).abs().max())
              / (float(getattr(ref[0], f)[:, :n].abs().max()) + 1e-3)
              for f in ("mel_coarse", "mel_postnet", "alignments"))
    _, resident = decode_smem(2, 40, mc.attention_dim,
                              mc.location_kernel_size, torch.float32)
    print(f"[odd widths C6] serving {C6_SERVE} fp32 (conv taps in "
          f"{tap_groups(65)[0]} groups of {tap_groups(65)[1]}; decode's "
          f"location matrix {'resident' if resident else 'in L2'}): "
          f"tacotron2_infer on the card vs the CPU's plain request {rel:.2e} "
          f"(limit {ODD_TOL:g}), launches decoder_infer_mega={launches[0]} "
          f"conv_bn_act={launches[1]}", flush=True)
    check(launches == (1, 8) and int(got[1]) == n
          and torch.equal(got[2].cpu(), ref[2]) and rel < ODD_TOL,
          f"phase 16 C6 serving: launches {launches}, error {rel}")
    with torch.no_grad():
        memory = encoder_apply(model.encoder, tokens.to(dev))
        dargs = (model.decoder, memory, kw["max_steps"], mc.gate_threshold,
                 True, make_pad_mask(lengths, 40).to(dev), "any",
                 kw["forced_stop_at"])
        dec_ms = device_ms(lambda: decoder_infer_mega(*dargs), 2,
                           "decoder_infer_kernel")
    print(f"[odd widths C6] decoder_infer_mega B=2 T_enc=40 A=512 K=95 "
          f"fp32: device {dec_ms:.3f} ms a decode of {kw['max_steps']} "
          f"steps", flush=True)
    add("decoder_infer_mega", "A=512 K=95 fp32 B=2 T_enc=40", 1, rel,
        dec_ms)
    with torch.no_grad():
        shares, abs_errs = model_conv_layers(
            model, tokens.to(dev), ref[0].mel_coarse[:, :n].to(dev))
    print(f"[odd widths C6] the eight 65-tap conv layers on this request's "
          f"inputs vs plain: shares {max(shares):.2e} (limit "
          f"{CONV_MAIN_TOL:g}), max abs {max(abs_errs):.2e}", flush=True)
    check(max(shares) <= CONV_MAIN_TOL, f"phase 16 C6 conv layers {shares}")

    cfg = Config(model=mc)
    state = create_train_state(cfg, seed=SEED, tx=make_optimizer(cfg.train),
                               device=dev)
    batch = c6_batch(mc, b=4, t_enc=40, t_dec=64)
    evals = {}
    for fused in (True, False):
        replace_config(state.model, fused_convbn=fused)
        conv_bn_act.launches = 0
        losses, _, _ = train.eval_step(
            state, batch, cfg=cfg,
            sigma_warmup_steps=cfg.guided_attention.sigma_warmup_steps)
        evals[fused] = (float(losses.total), conv_bn_act.launches)
    gap = abs(evals[True][0] - evals[False][0]) / abs(evals[False][0])
    print(f"[odd widths C6] eval_step with 65-tap convs: fused route loss "
          f"{evals[True][0]:.6f} ({evals[True][1]} conv_bn_act launches) vs "
          f"cuDNN route {evals[False][0]:.6f}: {gap:.2e} (limit "
          f"{C6_EVAL_TOL:g})", flush=True)
    check(evals[True][1] == 8 and evals[False][1] == 0 and gap <= C6_EVAL_TOL,
          f"phase 16 C6 eval_step: {evals}")
    add("conv_bn_act", "K=65 eval", 8 + 8, max(abs_errs), None)
    del state, model

    # (c) conv_bn_act at 65 and 129 taps, the postnet's shape, both types
    x = torch.randn(4, 512, 400, generator=g).to(dev)
    for k in (65, C6_LONG_TAPS):
        for dtype in (torch.float32, torch.bfloat16):
            conv, bn = conv_layer(512, 512, k, dtype, SEED + k, dev)
            conv_bn_act.launches = 0
            with torch.no_grad():
                got = conv_bn_act(x, conv, bn, 1e-5, "tanh")
                want = conv_bn_act_reference(x, conv, bn, 1e-5, "tanh")
                torch.cuda.synchronize()
                count = conv_bn_act.launches
                ms = graph_ms(lambda: conv_bn_act(x, conv, bn, 1e-5,
                                                  "tanh"), 20)
                # the library call beside it: cuDNN's conv on the folded
                # weights (TF32 off), the fp32 bias and the activation
                wmat, h = fold_conv_bn(conv, bn, 1e-5)
                w_oik = wmat.permute(2, 1, 0).to(dtype).contiguous()
                lib = lambda: torch.tanh(F.conv1d(
                    x.to(dtype), w_oik, padding=(k - 1) // 2).float()
                    + h[None, :, None])
                lib_dev = graph_ms(lib, 20)
                lib_call = time_ms(lib, 10)
                call_ms = time_ms(lambda: conv_bn_act(x, conv, bn, 1e-5,
                                                      "tanh"), 10)
            share = conv_share(got, want)
            err = float((got - want).abs().max())
            print(f"[odd widths C6] conv_bn_act K={k} ({tap_groups(k)[0]} "
                  f"tap groups) 512->512 B=4 T=400 {str(dtype)[6:]}: "
                  f"{share:.2e} of the mean (limit {CONV_TOL[dtype]:g}), "
                  f"device {ms:.4f} ms (graph), {call_ms:.4f} ms a call, "
                  f"launches {count}; cuDNN F.conv1d on the folded weights "
                  f"{lib_dev:.4f} ms device (graph), {lib_call:.4f} ms a "
                  f"call", flush=True)
            check(count == 1 and share <= CONV_TOL[dtype],
                  f"phase 16 C6 conv_bn_act K={k} {dtype}: {share}")
            config = f"K={k} {str(dtype)[6:]} 512->512 B=4 T=400"
            add("conv_bn_act", config, 1, err, ms)
            out["conv_bn_act"].setdefault("c6_library_ms", {})[config] = dict(
                call_ms=lib_call, device_ms=lib_dev)

    # (d) attention_tail with a 65568-byte fp32 memory row
    f = lambda *shape: torch.randn(*shape, generator=g).to(dev)
    ins = (f(4, 112, 128), f(128) * 0.3, f(()), torch.tensor(1.2, device=dev),
           make_pad_mask(torch.tensor([112, 90, 57, 112]), 112).to(dev),
           f(4, 112, C6_TAIL_D))
    plan = tail_plan(4, 112, 128, C6_TAIL_D, torch.float32)
    attention_tail.launches = 0
    with torch.no_grad():
        got = attention_tail(*ins)
        want = attention_tail_reference(*ins)
        torch.cuda.synchronize()
        count = attention_tail.launches
        ms = graph_ms(lambda: attention_tail(*ins), 20)
    err = max_err(got, want)
    print(f"[odd widths C6] attention_tail B=4 T_enc=112 A=128 "
          f"D={C6_TAIL_D} fp32 (wide plan {plan.wide}, tiles of "
          f"{plan.tile_rows} rows): {err:.2e} (limit {TAIL_TOL:g}), device "
          f"{ms:.4f} ms (graph), launches {count}", flush=True)
    check(plan.wide and count == 1 and err <= TAIL_TOL,
          f"phase 16 C6 attention_tail: {err}")
    add("attention_tail", f"B=4 T_enc=112 D={C6_TAIL_D} fp32", 1, err, ms)
    return out


# phase 17: the serving path on the trained checkpoint
SERVE_MAX_BATCH = 8
SERVE_TIMEOUT_S = 300   # each HTTP call, thread join and subprocess
LONGFORM_SILENCE = int(22050 * 0.12)    # synthesize_longform's 120 ms
# HiFi-GAN (seeded generator, cuDNN): the card's fp32 generator against
# the CPU's with TF32 off (fp32 sums in another order; the JAX package's
# limit against an independent PyTorch generator), bf16 against fp32 on a
# tanh-bounded signal (the JAX package's limit for its bf16 cast), and the
# chunked generator against the whole one (the same windows)
HIFIGAN_TOL = 2e-4
HIFIGAN_BF16_TOL = 0.05
HIFIGAN_CHUNK_TOL = 2e-5
STREAM_LSB = 1          # streamed vs one-shot HiFi-GAN PCM, fp32 generator
# the same with the bf16 generator the service serves: its windows round
# apart from the one-shot call (16 LSB read on the H100), held at 4x that
STREAM_BF16_LSB = 64
LOAD_LEVELS = (1, 4, 8)  # tools/load_test.py's concurrency sweep
LOAD_REQUESTS = 8       # requests a level


def http_post(url: str, payload: dict, stream: bool = False):
    """One POST: (status, body, seconds to the first body bytes, seconds to
    the whole body)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t1 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT_S) as resp:
            first = resp.read1(1 << 16) if stream else b""
            t_first = time.perf_counter() - t1
            body = first + resp.read()
            return resp.status, body, t_first, time.perf_counter() - t1
    except urllib.error.HTTPError as e:
        return e.code, e.read(), None, time.perf_counter() - t1


def http_get_json(url: str, timeout: float = SERVE_TIMEOUT_S) -> dict:
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def wav_frames(body: bytes, where: str, want: int) -> int:
    """Frames of a served 16-bit WAV, held to the pinned gate stop."""
    import io
    import wave
    with wave.open(io.BytesIO(body)) as w:
        rate, n = w.getframerate(), w.getnframes()
        pcm = np.frombuffer(w.readframes(n), "<i2")
    check(rate == 22050 and n % 256 == 0 and pcm.size == n,
          f"{where}: WAV of {n} samples at {rate} Hz")
    check(abs(n // 256 - want) <= STOP_SLACK and np.abs(pcm).max() > 0,
          f"{where}: {n // 256} frames, pinned {want}")
    return n // 256


def latency_line(name: str, secs, audio_s: float, wall: float) -> str:
    ms = sorted(s * 1e3 for s in secs)
    return (f"[serve] {name}: {len(ms)} requests, p50 "
            f"{float(np.median(ms)):.1f} ms, max {ms[-1]:.1f} ms; "
            f"{audio_s:.2f} s of audio in {wall:.3f} s wall: "
            f"{audio_s / wall:.2f} s of audio per wall second")


def load_test_run(url: str, root: str, smi: str, kernels) -> dict:
    """``tools/load_test.py`` as a process against the server at ``url``
    at ``LOAD_LEVELS``, ``LOAD_REQUESTS`` a level (Griffin-Lim): every
    request 200, its report lines printed, ``/healthz``'s batching stats
    over the run (some batches must coalesce).  Returns the launches of
    ``kernels`` (the decode and conv kernels' wrappers) during the run."""
    health0 = http_get_json(url + "/healthz")
    before = [k.launches for k in kernels]
    t1 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, os.path.join("tools", "load_test.py"), "--url", url,
         "--concurrency", ",".join(map(str, LOAD_LEVELS)), "--requests",
         str(LOAD_REQUESTS), "--warmup", "0", "--timeout",
         str(SERVE_TIMEOUT_S)], cwd=root, capture_output=True, text=True,
        timeout=len(LOAD_LEVELS) * SERVE_TIMEOUT_S)
    wall = time.perf_counter() - t1
    launches = {k.__name__: k.launches - n for k, n in zip(kernels, before)}
    check(run.returncode == 0, f"tools/load_test.py exit {run.returncode}: "
          f"{run.stdout[-2000:]} {run.stderr[-2000:]}")
    levels = [json.loads(ln) for ln in run.stdout.splitlines()
              if ln.startswith("{")]
    check([lv.get("concurrency") for lv in levels] == list(LOAD_LEVELS)
          and all(lv.get("requests") == LOAD_REQUESTS for lv in levels)
          and " errors, first:" not in run.stderr,
          f"tools/load_test.py: not every request 200: {run.stdout} "
          f"{run.stderr[-2000:]}")
    for lv in levels:
        print(f"[serve load_test] concurrency {lv['concurrency']}: "
              f"{lv['requests']} requests, all 200; {lv['req_per_s']} "
              f"requests/s, {lv['audio_sec_per_wall_sec']} s of audio per "
              f"wall s; latency p50 {lv['latency_p50_s']} s, p90 "
              f"{lv['latency_p90_s']} s, max {lv['latency_max_s']} s "
              f"({smi})", flush=True)
    health = http_get_json(url + "/healthz")
    run_stats = {k: health[k] - health0[k]
                 for k in ("requests", "batches", "batched_requests")}
    print(f"[serve load_test] tools/load_test.py --concurrency "
          f"{','.join(map(str, LOAD_LEVELS))} --requests {LOAD_REQUESTS}: "
          f"{wall:.1f} s wall; over the run {run_stats}, healthz {health}; "
          f"launches {launches}", flush=True)
    check(run_stats["requests"] == len(LOAD_LEVELS) * LOAD_REQUESTS
          and run_stats["batched_requests"] > 0
          and run_stats["requests"] > run_stats["batches"]
          and health["batch_retries"] == 0,
          f"phase 17 load test: the batches did not coalesce: {run_stats}")
    check(all(n > 0 for n in launches.values()),
          f"phase 17 load test: launches {launches}")
    return launches


def serving_phase(dev, smi: str) -> dict:
    """Phase 17.  ``serve()``'s handler on a ``BatchingTTSService`` of
    ``checkpoints/r4_synth_bf16`` (bf16, ``max_batch=8``) and a seeded
    HiFi-GAN generator in NGC's file layout: batched, serial and streamed
    requests, long-form synthesis, both CLIs as subprocesses; then each
    kernel against its plain version on the inputs this path gave it, and
    the generator on the card.  Returns the kernels-line additions by
    kernel name: each kernel's launches on the path
    (``serve_path_launches``), the decode and conv kernels' during the
    load test (``load_test_launches``)."""
    import signal
    import socket
    import threading
    from http.server import ThreadingHTTPServer

    from tacotron2_torch.infer import server as srv
    from tacotron2_torch.infer.longform import synthesize_longform
    from tacotron2_torch.infer.streaming import stream_mels
    from tacotron2_torch.infer.synthesize import load_model
    from tacotron2_torch.infer.vocode import load_vocoder, vocode_array
    from tacotron2_torch.models import hifigan as hg
    from tacotron2_torch.models.encoder import encoder_apply
    from tacotron2_torch.models.tacotron2 import (
        _condition_memory, make_pad_mask, tacotron2_infer)
    from tacotron2_torch.ops import attention_kernel as ak
    from tacotron2_torch.ops.convbn_kernel import conv_bn_act
    from tacotron2_torch.ops.decoder_megakernel import (
        decoder_infer_mega, decoder_infer_mega_reference)
    from tacotron2_torch.text import pad_sequences, text_to_sequence

    root = os.path.dirname(os.path.abspath(__file__))
    texts = list(TRAINED_FRAME_ENDS)
    hop, sr = 256, 22050
    tmp = tempfile.TemporaryDirectory()
    gen = hg.hifigan_init(seed=SEED)
    ngc = os.path.join(tmp.name, "hifigan_gen.pt")
    torch.save({"generator": hg.nvidia_state_dict(gen)}, ngc)
    old_env = os.environ.get("HIFIGAN_CHECKPOINT")
    os.environ["HIFIGAN_CHECKPOINT"] = ngc
    t1 = time.perf_counter()
    service = srv.BatchingTTSService(TRAINED_CKPT, bf16=True,
                                     max_batch=SERVE_MAX_BATCH, device=dev)
    setup_s = time.perf_counter() - t1
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    proc = log = None
    recorded = []
    plain_forward = ak._forward
    try:
        print(f"[serve] BatchingTTSService({os.path.relpath(TRAINED_CKPT)}, "
              f"bf16, max_batch={SERVE_MAX_BATCH}) built and warmed in "
              f"{setup_s:.2f} s, serving on {url}; HiFi-GAN from a seeded "
              f"weight-normed file in NGC's layout ({smi})", flush=True)
        # one request a vocoder before the counted, timed run: the
        # generator is read from its file on first use, on the card
        for voc in ("griffinlim", "hifigan"):
            status, body, _, _ = http_post(url + "/synthesize",
                                           {"text": texts[0],
                                            "vocoder": voc})
            check(status == 200, f"phase 17 warm-up {voc}: HTTP {status}")
        decoder_infer_mega.launches = conv_bn_act.launches = 0
        ak.attention_tail.launches = 0

        # eight concurrent requests: the four sentences twice, half of
        # them Griffin-Lim, half HiFi-GAN
        reqs = [(t, v) for v in ("griffinlim", "hifigan") for t in texts]
        results = [None] * len(reqs)

        def call(i):
            text, voc = reqs[i]
            results[i] = http_post(url + "/synthesize",
                                   {"text": text, "vocoder": voc})

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base_mb = torch.cuda.memory_allocated(dev) / 2 ** 20
        t1 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=SERVE_TIMEOUT_S)
            check(not t.is_alive(), "phase 17: a request thread hung")
        wall8 = time.perf_counter() - t1
        peak_mb = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        frames8 = []
        for (text, voc), res in zip(reqs, results):
            check(res is not None and res[0] == 200,
                  f"phase 17 batched {voc} {text!r}: "
                  f"{None if res is None else res[:2]}")
            frames8.append(wav_frames(res[1], f"batched {voc} {text!r}",
                                      TRAINED_FRAME_ENDS[text]))
        health = http_get_json(url + "/healthz")
        check(health["max_batch_observed"] > 1,
              f"phase 17: the requests did not coalesce: {health}")
        check(health["batch_retries"] == 0,
              f"phase 17: a batched decode failed and was served per "
              f"item: {health}")
        print(f"[serve] 8 concurrent requests: all 200, frames {frames8} "
              f"(pinned {[TRAINED_FRAME_ENDS[t] for t, _ in reqs]}), "
              f"healthz {health}; peak device memory of the batch "
              f"{peak_mb - base_mb:.1f} MiB above the {base_mb:.1f} MiB "
              f"held before it ({peak_mb:.1f} MiB absolute, "
              f"torch.cuda.max_memory_allocated) ({smi})", flush=True)
        print(latency_line("concurrency 8", [r[3] for r in results],
                           sum(frames8) * hop / sr, wall8) + f" ({smi})",
              flush=True)

        # the same requests one at a time
        lat1, frames1 = [], []
        t1 = time.perf_counter()
        for text, voc in reqs:
            status, body, _, secs = http_post(url + "/synthesize",
                                              {"text": text, "vocoder": voc})
            check(status == 200, f"phase 17 serial {voc}: HTTP {status}")
            frames1.append(wav_frames(body, f"serial {voc} {text!r}",
                                      TRAINED_FRAME_ENDS[text]))
            lat1.append(secs)
        wall1 = time.perf_counter() - t1
        print(latency_line("concurrency 1", lat1, sum(frames1) * hop / sr,
                           wall1) + f" ({smi})", flush=True)

        # tools/load_test.py, as a process of its own, against this server
        load = load_test_run(url, root, smi,
                             (decoder_infer_mega, conv_bn_act))

        # streaming, once per vocoder, recording the attention tail's
        # inputs and outputs; then HiFi-GAN once more on an fp32 generator
        ak._forward = tail_recorder(plain_forward, recorded)
        streams = {}
        for name, voc in (("griffinlim", "griffinlim"),
                          ("hifigan bf16", "hifigan"),
                          ("hifigan fp32", "hifigan")):
            if name == "hifigan fp32":
                service._hifigan_vocoder = load_vocoder("hifigan",
                                                        device=dev)
            status, body, first_s, total_s = http_post(
                url + "/synthesize_streaming",
                {"text": texts[0], "vocoder": voc, "chunk_frames": 64},
                stream=True)
            check(status == 200 and len(body) % 2 == 0,
                  f"phase 17 stream {name}: HTTP {status}")
            streams[name] = np.frombuffer(body, "<i2").astype(np.int32)
            print(f"[serve stream {name}] {texts[0]!r}: first chunk after "
                  f"{first_s * 1e3:.1f} ms, {len(body) // 2} samples in "
                  f"{total_s * 1e3:.1f} ms ({smi})", flush=True)
        ak._forward = plain_forward

        # long-form: the four sentences as one paragraph, HiFi-GAN
        paragraph = " ".join(texts)
        card_gen = hg.load_hifigan_params(device=dev)
        with service._lock:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            wav, mels = synthesize_longform(service.model, paragraph,
                                            vocoder=card_gen, device=dev)
            long_s = time.perf_counter() - t1
        ends = [m.shape[0] for m in mels]
        check(len(mels) == len(texts) and all(
            abs(n - TRAINED_FRAME_ENDS[t]) <= STOP_SLACK
            for n, t in zip(ends, texts)), f"phase 17 long-form: {ends}")
        check(wav.shape == (sum(ends) * hop + 3 * LONGFORM_SILENCE,)
              and bool(np.isfinite(wav).all()) and np.abs(wav).max() > 0,
              f"phase 17 long-form: {wav.shape} samples")
        print(f"[serve longform] {len(texts)} sentences, frames {ends}, "
              f"{wav.size / sr:.2f} s of audio in {long_s * 1e3:.1f} ms "
              f"(HiFi-GAN fp32, bf16 Tacotron 2; {smi})", flush=True)

        # the CLIs, each as a process of its own
        out_dir = os.path.join(tmp.name, "cli")
        t1 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "inference_torch.py", texts[0], "--checkpoint",
             TRAINED_CKPT, "--vocoder", "griffinlim", "--output_dir",
             out_dir], cwd=root, capture_output=True, text=True,
            timeout=SERVE_TIMEOUT_S)
        cli_s = time.perf_counter() - t1
        check(run.returncode == 0, f"inference_torch.py exit "
              f"{run.returncode}: {run.stdout[-2000:]} {run.stderr[-2000:]}")
        from tacotron2_torch.dsp.wav import load_audio
        cli_wav, rate = load_audio(os.path.join(out_dir, "output_1.wav"))
        cli_frames = len(cli_wav) // hop
        check(rate == sr and abs(cli_frames - TRAINED_FRAME_ENDS[texts[0]])
              <= STOP_SLACK, f"inference_torch.py wrote {len(cli_wav)} "
              f"samples at {rate} Hz")
        print(f"[serve cli] inference_torch.py {texts[0]!r} --vocoder "
              f"griffinlim: exit 0, {cli_frames} frames in one WAV, "
              f"{cli_s:.1f} s wall with the process's start", flush=True)

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        log_path = os.path.join(tmp.name, "serve_torch.log")
        log = open(log_path, "w")
        t1 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "serve_torch.py", "--checkpoint", TRAINED_CKPT,
             "--port", str(port), "--bf16", "--max_batch", "2"], cwd=root,
            stdout=log, stderr=subprocess.STDOUT, text=True)
        cli_url = f"http://127.0.0.1:{port}"

        def server_log() -> str:
            with open(log_path) as f:
                return f.read()[-2000:]

        while True:
            if proc.poll() is not None:
                fail(f"serve_torch.py exited {proc.returncode}: "
                     f"{server_log()}")
            if time.perf_counter() - t1 > SERVE_TIMEOUT_S:
                fail(f"serve_torch.py did not come up: {server_log()}")
            try:
                http_get_json(cli_url + "/healthz", timeout=5)
                break
            except OSError:
                time.sleep(0.5)
        up_s = time.perf_counter() - t1
        status, body, _, secs = http_post(cli_url + "/synthesize",
                                          {"text": texts[0]})
        check(status == 200, f"serve_torch.py answered HTTP {status}")
        served = wav_frames(body, "serve_torch.py",
                            TRAINED_FRAME_ENDS[texts[0]])
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            fail(f"serve_torch.py did not stop on SIGTERM: {server_log()}")
        check(proc.returncode == 0, f"serve_torch.py exit {proc.returncode} "
              f"after SIGTERM: {server_log()}")
        proc = None
        said = [ln for ln in server_log().splitlines()
                if ln.startswith(("[serve]", "TTS server"))]
        print(f"[serve cli] serve_torch.py up in {up_s:.1f} s, one request "
              f"({served} frames) in {secs * 1e3:.1f} ms, SIGTERM -> exit 0; "
              f"it said: {' | '.join(said)}", flush=True)

        launches = {"decoder_infer_mega": decoder_infer_mega.launches,
                    "conv_bn_act": conv_bn_act.launches,
                    "attention_tail": ak.attention_tail.launches}
        print(f"[serve] launches on the serving path: {launches}",
              flush=True)
        check(all(n > 0 for n in launches.values()),
              f"phase 17: a kernel of the path did not launch: {launches}")
        launches = {k: dict(serve_path_launches=n) for k, n in
                    launches.items()}
        for k, n in load.items():
            launches[k]["load_test_launches"] = n

        # each kernel against its plain version on this path's inputs.
        # The batched decode: the service's (bf16, held as phase 14 holds
        # bf16) and the same batch on the fp32 model (DEC_TOL)
        tokens, lengths = pad_sequences(
            [text_to_sequence(t) for t, _ in reqs], pad_multiple=16)
        model32 = load_model(TRAINED_CKPT, device=dev)
        for m in (model32, service.model):
            cdt = m.decoder.attention_lstm.weight_ih.dtype
            with torch.no_grad():
                tok = torch.from_numpy(tokens).long().to(dev)
                memory = _condition_memory(m, encoder_apply(m.encoder, tok),
                                           None)
                mask = make_pad_mask(torch.from_numpy(lengths).to(dev),
                                     tok.shape[1])
                args = (m.decoder, memory, m.cfg.max_decoder_steps,
                        m.cfg.gate_threshold, True, mask, "all", None)
                got = decoder_infer_mega(*args)
                ref = decoder_infer_mega_reference(*args)
            torch.cuda.synchronize()
            g_end, r_end = got[4].tolist(), ref[4].tolist()
            where = f"serve batched decode {str(cdt)[6:]} B={len(reqs)}"
            check(all(abs(a - b) <= STOP_SLACK for a, b in zip(g_end, r_end))
                  and all(abs(a - TRAINED_FRAME_ENDS[t]) <= STOP_SLACK
                          for a, (t, _) in zip(g_end, reqs)),
                  f"{where}: frame_ends {g_end} vs plain {r_end}")
            errs = {"mels": 0.0, "gates": 0.0, "aligns": 0.0}
            first = mean = 0.0
            for row in range(len(reqs)):
                k = min(g_end[row], r_end[row])
                for name, g, r in zip(DEC_OUTPUTS, got[:3], ref[:3]):
                    errs[name] = max(errs[name], float(
                        (g[row, :k].float() - r[row, :k].float())
                        .abs().max()))
                d = (got[0][row, :k] - ref[0][row, :k]).abs()
                first = max(first, float(d[:10].max()))
                mean = max(mean, float(d.mean()))
            if cdt == torch.float32:
                tol = dict(DEC_TOL[cdt], aligns=DEC_ALIGN_SHARE[cdt] * float(
                    ref[2][:, :max(r_end)].abs().mean()))
                print(f"[{where}] frame_ends kernel {g_end}, plain {r_end}; "
                      f"over the shared frames " + ", ".join(
                          f"{k} {errs[k]:.3e} (tol {tol[k]:.3g})"
                          for k in DEC_OUTPUTS), flush=True)
                for k in DEC_OUTPUTS:
                    check(errs[k] <= tol[k], f"{where}: {k} {errs[k]}")
            else:
                print(f"[{where}] frame_ends kernel {g_end}, plain {r_end}; "
                      f"mels first ten frames {first:.3e} (tol "
                      f"{TRAINED_FIRST_TOL}), mean {mean:.3e} (tol "
                      f"{TRAINED_MEAN_TOL})", flush=True)
                check(first <= TRAINED_FIRST_TOL and mean <= TRAINED_MEAN_TOL,
                      f"{where}: the decodes part beyond the limits")
        del model32

        # the attention tail on the inputs of every step of the streams
        tail_err = max(max_err(out, ak.attention_tail_reference(*ins))
                       for ins, out in recorded)
        print(f"[serve stream attention_tail] {len(recorded)} steps of "
              f"{len(streams)} streams: kernel vs plain max err "
              f"{tail_err:.3e} (tol {TAIL_TOL})", flush=True)
        check(tail_err <= TAIL_TOL, f"phase 17: attention_tail {tail_err}")

        # conv_bn_act on each layer's real input of one request
        m = service.model
        tok1, len1 = pad_sequences([text_to_sequence(texts[0])],
                                   pad_multiple=16)
        with torch.no_grad():
            out, _, _ = tacotron2_infer(m, tok1, text_lengths=len1,
                                        device=dev)
        shares, abs_errs = model_conv_layers(
            m, torch.from_numpy(tok1).long().to(dev), out.mel_coarse)
        print(f"[serve conv_bn_act] the eight layers of one request "
              f"({texts[0]!r}, bf16, T={out.mel_coarse.shape[1]}): "
              f"kernel vs plain "
              f"{', '.join(f'{s_:.2e}' for s_ in shares)} of the mean size "
              f"(limit {CONV_TOL[torch.bfloat16]:g}), largest "
              f"{max(abs_errs):.2e} absolute", flush=True)
        check(max(shares) <= CONV_TOL[torch.bfloat16],
              f"phase 17 conv_bn_act {shares}")

        # the streams against one-shot vocodes of the same mel
        with torch.no_grad():
            full_mel = np.concatenate(list(stream_mels(
                m, texts[0], chunk_frames=64, apply_postnet=True,
                device=dev)))
        voc32 = service._hifigan_vocoder
        one_shot = np.frombuffer(srv._pcm16(
            vocode_array(voc32, full_mel[None], dev)[0]),
            "<i2").astype(np.int32)
        voc16 = load_vocoder("hifigan", bf16=True, device=dev)
        one_shot16 = np.frombuffer(srv._pcm16(
            vocode_array(voc16, full_mel[None], dev)[0]),
            "<i2").astype(np.int32)
        n_samples = full_mel.shape[0] * hop
        check(all(v.shape == (n_samples,) for v in streams.values()),
              f"phase 17 streams: {[v.shape for v in streams.values()]} vs "
              f"{n_samples} samples")
        lsb = int(np.abs(streams["hifigan fp32"] - one_shot).max())
        lsb16 = int(np.abs(streams["hifigan bf16"] - one_shot16).max())
        print(f"[serve stream] streamed vs one-shot HiFi-GAN PCM of the "
              f"same {full_mel.shape[0]}-frame mel: fp32 generator "
              f"{lsb} LSB (limit {STREAM_LSB}); the bf16 generator the "
              f"service serves {lsb16} LSB (limit {STREAM_BF16_LSB}: bf16 "
              f"convolutions of other lengths round apart); Griffin-Lim "
              f"stream "
              f"{streams['griffinlim'].size} samples, the one-shot length",
              flush=True)
        check(lsb <= STREAM_LSB, f"phase 17: streamed HiFi-GAN {lsb} LSB")
        check(lsb16 <= STREAM_BF16_LSB,
              f"phase 17: streamed bf16 HiFi-GAN {lsb16} LSB")

        # the generator on the card
        mel_ct = torch.from_numpy(np.ascontiguousarray(full_mel.T[None]))
        short = mel_ct[:, :, :32]
        with torch.no_grad():
            cpu_wav = hg.hifigan_apply(gen, short)
            card_wav = hg.hifigan_apply(card_gen, short.to(dev)).cpu()
            gen16 = hg.cast_hifigan_bf16(card_gen)
            half_wav = hg.hifigan_apply(gen16, short.to(dev)).cpu()
            whole = hg.hifigan_apply(card_gen, mel_ct.to(dev))
            chunked = hg.hifigan_apply_chunked(card_gen, mel_ct.to(dev),
                                               chunk=64)
        errs = (float((card_wav - cpu_wav).abs().max()),
                float((half_wav - card_wav).abs().max()),
                float((chunked - whole).abs().max()))
        print(f"[serve hifigan] card fp32 vs CPU on 32 frames "
              f"{errs[0]:.2e} (limit {HIFIGAN_TOL:g}); bf16 vs fp32 "
              f"{errs[1]:.2e} (limit {HIFIGAN_BF16_TOL:g}); "
              f"vocoder_chunk_frames=64 vs whole on {mel_ct.shape[2]} "
              f"frames {errs[2]:.2e} (limit {HIFIGAN_CHUNK_TOL:g})",
              flush=True)
        check(errs[0] <= HIFIGAN_TOL and errs[1] <= HIFIGAN_BF16_TOL
              and errs[2] <= HIFIGAN_CHUNK_TOL, f"phase 17 HiFi-GAN {errs}")
        rates = []
        for b in (1, 8):
            mel_b = mel_ct.to(dev).expand(b, -1, -1).contiguous()
            audio_s = b * mel_b.shape[2] * hop / sr
            for name, g in (("fp32", card_gen), ("bf16", gen16)):
                ms = time_ms(lambda: hg.hifigan_apply(g, mel_b), 5)
                rates.append(f"B={b} {name} {ms / audio_s:.3f}")
        print(f"[serve hifigan] device ms per second of audio (CUDA "
              f"events, {mel_ct.shape[2]} frames a row): "
              f"{'; '.join(rates)} ({smi})", flush=True)
        return launches
    finally:
        ak._forward = plain_forward
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=SERVE_TIMEOUT_S)
        if log is not None:
            log.close()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=SERVE_TIMEOUT_S)
        service.close(join_timeout=SERVE_TIMEOUT_S)
        if old_env is None:
            os.environ.pop("HIFIGAN_CHECKPOINT", None)
        else:
            os.environ["HIFIGAN_CHECKPOINT"] = old_env
        tmp.cleanup()


# phase 18: the data path on the trained multi-speaker checkpoint
R5_ROOT = os.path.dirname(os.path.abspath(__file__))
R5_CKPT = os.path.join(R5_ROOT, "checkpoints", "r5_ms_bf16")
R5_REPORT = os.path.join(R5_ROOT, "docs", "evidence_r5", "quality_r5ms.json")
R5_CORPUS = dict(n=2048, seed=5, n_speakers=4)   # tools/make_synth_corpus.py
R5_ROWS = range(1792, 2048)     # written and preprocessed; the last 48: val
R5_VAL = 48
R5_ITEMS = 16
# card mels against the plain version on the CPU (the same padded batch),
# max abs on natural-log mels: both frame, FFT and project in fp32 in
# another order, and the largest gap sits near the log floor (-11.5),
# where a power of 1e-5 moves the log by 1e-4 for a 1e-9 difference.
# Read on an H100 1.4e-4 (and 5.6e-5 between the cached mel and one
# recomputed alone on the card); the limit stands 4 times above.
PRE_MEL_TOL = 5.5e-4
AR_END_SLACK = 3        # frames, autoregressive stop against the TPU report
TF_MCD_SLACK = 0.5      # dB, teacher-forced MCD against the TPU report
# tests/test_quality_report.py's tail limits on the TPU report: (p90, max),
# strict for the MCDs, inclusive for the gate error
R5_TAILS = {"mcd_teacher_forced_db": (5.0, 8.0),
            "mcd_autoregressive_dtw_db": (6.0, 9.0),
            "gate_timing_error_frames": (10.0, 25.0)}


def data_path_phase(dev, smi: str, keep: str) -> dict:
    """Phase 18.  The seed-5 corpus of ``checkpoints/r5_ms_bf16`` generated,
    preprocessed on the card and evaluated there against the TPU's report;
    then the three kernels of the path against their plain versions on its
    inputs, and the ground-truth DSP round trip.  The processed corpus is
    copied to ``keep`` (phase 22 exports it).  Returns the kernels-line
    additions by kernel name."""
    import gt_vocoder_check_torch as gt_check
    from tacotron2_torch.config import AudioConfig, Config, ModelConfig
    from tacotron2_torch.data import preprocess as pre
    from tacotron2_torch.data.dataset import TextMelDataset
    from tacotron2_torch.data.metadata import (_write_csv, basename_of,
                                               read_metadata)
    from tacotron2_torch.data.native_loader import (decode_batch_padded,
                                                    library_path)
    from tacotron2_torch.data.synth_corpus import make_synth_corpus
    from tacotron2_torch.dsp import get_mel_spectrogram
    from tacotron2_torch.dsp.wav import load_audio
    from tacotron2_torch.dsp.mel import batched_log_mel_with_lengths
    from tacotron2_torch.infer.synthesize import load_model
    from tacotron2_torch.models.encoder import encoder_apply
    from tacotron2_torch.models.tacotron2 import (_condition_memory,
                                                  tacotron2_forward)
    from tacotron2_torch.ops import attention_kernel as ak
    from tacotron2_torch.ops.convbn_kernel import conv_bn_act
    from tacotron2_torch.ops.decoder_megakernel import (
        decoder_infer_mega, decoder_infer_mega_reference)
    from tacotron2_torch.text import text_to_sequence
    sys.path.insert(0, os.path.join(R5_ROOT, "tools"))
    try:
        from eval_quality_torch import evaluate
    finally:
        sys.path.pop(0)

    audio = AudioConfig()
    hop, sr = audio.hop_length, audio.sampling_rate
    with open(R5_REPORT) as f:
        tpu = json.load(f)
    phase0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    plain_forward = ak._forward
    try:
        # (a) the corpus: every row synthesized, the last 256 written
        raw, proc = (os.path.join(tmp.name, d) for d in ("raw", "processed"))
        t1 = time.perf_counter()
        meta = make_synth_corpus(raw, rows=R5_ROWS, **R5_CORPUS)
        gen_s = time.perf_counter() - t1
        rows = read_metadata(meta)
        fields = ["filepath", "text", "speaker_id"]
        check(len(rows) == len(R5_ROWS), f"phase 18: {len(rows)} rows")
        wav_bytes = sum(os.path.getsize(r["filepath"]) for r in rows)
        print(f"[data corpus] make_synth_corpus(n=2048, seed=5, "
              f"n_speakers=4): rows {R5_ROWS.start}-{R5_ROWS.stop - 1} "
              f"written ({wav_bytes / 1e6:.1f} MB of float32 WAV) in "
              f"{gen_s:.2f} s", flush=True)

        # (b) preprocessing on the card, the native loader forced
        print(f"[data preprocess] native loader {library_path().name} "
              f"(built from native/wavio.cc)", flush=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stats = pre.preprocess_corpus(meta, proc, use_native=True,
                                      device=dev)
        wall = time.perf_counter() - t1
        check(stats == {"ok": len(rows), "skipped": 0},
              f"phase 18 preprocess: {stats}")
        _write_csv(os.path.join(proc, "metadata_train.csv"),
                   rows[:-R5_VAL], fields)
        val_meta = os.path.join(proc, "metadata_val.csv")
        _write_csv(val_meta, rows[-R5_VAL:], fields)
        # the plan the pass made (size-estimate buckets, batches of 64) and
        # the one the true lengths would give
        lengths, buckets, true_buckets = [], {}, {}
        for r in rows:
            n = len(load_audio(r["filepath"])[0])
            lengths.append(n)
            est = pre._bucket_len(pre._estimated_wav_samples(r["filepath"]))
            buckets.setdefault(est, []).append(r)
            true_buckets.setdefault(pre._bucket_len(n), []).append(r)

        def planned(plan):
            return sum(-(-len(v) // 64) * 64 * (b + audio.n_fft)
                       for b, v in plan.items())
        audio_s = sum(lengths) / sr
        print(f"[data preprocess] {len(rows)} utterances, {audio_s:.1f} s "
              f"of audio in {wall:.3f} s wall: {len(rows) / wall:.1f} "
              f"utterances/s, {audio_s / wall:.1f} audio-s per wall s; "
              f"{sum(-(-len(v) // 64) for v in buckets.values())} device "
              f"batches over buckets {sorted(buckets)}; device samples "
              f"{planned(buckets)} for {sum(lengths)} true "
              f"({planned(buckets) / sum(lengths):.2f}x; buckets from the "
              f"true lengths: {planned(true_buckets)}, "
              f"{planned(true_buckets) / sum(lengths):.2f}x) ({smi})",
              flush=True)
        # every token file exact, every card mel against the CPU's plain
        # version on the same padded batch
        for r in rows:
            got = np.load(os.path.join(proc, "text",
                                       basename_of(r["filepath"]) + ".npy"))
            check(got.dtype == np.int32 and got.tolist()
                  == text_to_sequence(r["text"]),
                  f"phase 18: token file of {r['filepath']}")
        mel_err, n_frames = 0.0, 0
        for b, bucket_rows in buckets.items():
            for start in range(0, len(bucket_rows), 64):
                chunk = bucket_rows[start:start + 64]
                batch, lens, _ = decode_batch_padded(
                    [c["filepath"] for c in chunk], audio.n_fft // 2,
                    b + audio.n_fft)
                ref, _ = batched_log_mel_with_lengths(
                    torch.from_numpy(batch), torch.from_numpy(lens),
                    sr=sr, n_fft=audio.n_fft, hop_length=hop,
                    win_length=audio.win_length, n_mels=audio.n_mels,
                    fmin=audio.fmin, fmax=audio.fmax, mel_eps=audio.mel_eps)
                for j, c in enumerate(chunk):
                    got = np.load(os.path.join(
                        proc, "mels", basename_of(c["filepath"]) + ".npy"))
                    t = 1 + int(lens[j]) // hop
                    check(got.shape == (audio.n_mels, t)
                          and got.dtype == np.float32,
                          f"phase 18: mel {got.shape} {got.dtype}")
                    mel_err = max(mel_err, float(np.abs(
                        got - ref[j, :, :t].numpy()).max()))
                    n_frames += t
        print(f"[data preprocess] {len(rows)} token files equal "
              f"text_to_sequence; card mels vs the plain version on the "
              f"CPU over {n_frames} frames: max abs err {mel_err:.3e} "
              f"(tol {PRE_MEL_TOL:g})", flush=True)
        check(mel_err <= PRE_MEL_TOL, f"phase 18: mel error {mel_err}")

        # (c) the evaluation on the card, held to the TPU's report
        for fn in (ak.attention_tail, conv_bn_act, decoder_infer_mega):
            fn.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        report = evaluate(R5_CKPT, val_meta, n=R5_ITEMS, n_speakers=4,
                          device=dev)
        eval_s = time.perf_counter() - t1
        launches = {"attention_tail": ak.attention_tail.launches,
                    "conv_bn_act": conv_bn_act.launches,
                    "decoder_infer_mega": decoder_infer_mega.launches}
        items = report["per_item"]
        check(len(items) == R5_ITEMS, f"phase 18: {len(items)} items")
        gaps = []
        for got, ref in zip(items, tpu["per_item"]):
            for k in ("text_len", "mel_len", "speaker_id"):
                check(got[k] == ref[k], f"phase 18 item {got['index']}: "
                      f"{k} {got[k]} != {ref[k]}")
            gaps.append((got["ar_end_frames"] - ref["ar_end_frames"],
                         got["mcd_tf_db"] - ref["mcd_tf_db"],
                         got["mcd_ar_dtw_db"] - ref["mcd_ar_dtw_db"],
                         got["diagonality"] - ref["diagonality"]))
        print(f"[data eval] evaluate({os.path.relpath(R5_CKPT, R5_ROOT)}, "
              f"val, n={R5_ITEMS}, n_speakers=4) on the card in "
              f"{eval_s:.2f} s; per item against the TPU's report "
              f"(index: ar_end, mcd_tf dB, mcd_ar dB, diagonality): "
              + "; ".join(f"{i}: {g[0]:+d}, {g[1]:+.3f}, {g[2]:+.3f}, "
                          f"{g[3]:+.4f}" for i, g in enumerate(gaps))
              + f" ({smi})", flush=True)
        print("[data eval] summaries: " + "; ".join(
            f"{k} " + ", ".join(f"{s} {report[k][s]:.4f} (TPU "
                                f"{tpu[k][s]:.4f})"
                                for s in ("mean", "p90", "max"))
            for k in ("mcd_teacher_forced_db", "mcd_autoregressive_dtw_db",
                      "gate_timing_error_frames", "alignment_diagonality")),
            flush=True)
        check(max(abs(g[0]) for g in gaps) <= AR_END_SLACK,
              f"phase 18: autoregressive stops {[g[0] for g in gaps]}")
        check(max(abs(g[1]) for g in gaps) <= TF_MCD_SLACK,
              f"phase 18: teacher-forced MCD gaps {[g[1] for g in gaps]}")
        for k, (p90, top) in R5_TAILS.items():
            s = report[k]
            inclusive = k == "gate_timing_error_frames"
            ok = ((s["p90"] <= p90 and s["max"] <= top) if inclusive
                  else (s["p90"] < p90 and s["max"] < top))
            check(ok, f"phase 18: {k} tails {s}")
        mel_lens = [it["mel_len"] for it in items]
        print(f"[data eval] launches {launches} (attention_tail one a "
              f"teacher-forced step: {sum(mel_lens)} steps; conv_bn_act 8 "
              f"layers x 2 forwards x {R5_ITEMS}; one decode an item)",
              flush=True)
        check(launches == {"attention_tail": sum(mel_lens),
                           "conv_bn_act": 16 * R5_ITEMS,
                           "decoder_infer_mega": R5_ITEMS},
              f"phase 18: launches {launches}")

        # (d) each kernel against its plain version on this path's inputs
        cfg = Config(model=ModelConfig(n_speakers=4))
        model = load_model(R5_CKPT, cfg, device=dev)
        ds = TextMelDataset(val_meta)
        dec_errs = {k: 0.0 for k in DEC_OUTPUTS}
        stops = []
        for i in range(R5_ITEMS):
            item = ds[i]
            with torch.no_grad():
                tok = torch.from_numpy(item.text[None]).long().to(dev)
                spk = torch.tensor([item.speaker_id], device=dev)
                memory = _condition_memory(
                    model, encoder_apply(model.encoder, tok), spk)
                args = (model.decoder, memory, 1000,
                        model.cfg.gate_threshold, True, None, "any", None)
                got = decoder_infer_mega(*args)
                ref = decoder_infer_mega_reference(*args)
            g_n, r_n = int(got[4][0]), int(ref[4][0])
            check(abs(g_n - r_n) <= STOP_SLACK
                  and g_n == items[i]["ar_end_frames"],
                  f"phase 18 item {i}: stops kernel {g_n}, plain {r_n}, "
                  f"evaluate {items[i]['ar_end_frames']}")
            stops.append((g_n, r_n))
            k = min(g_n, r_n)
            tol = dict(DEC_TOL[torch.float32],
                       aligns=DEC_ALIGN_SHARE[torch.float32]
                       * float(ref[2][0, :k].abs().mean()))
            for name, g, r in zip(DEC_OUTPUTS, got[:3], ref[:3]):
                err = float((g[0, :k] - r[0, :k]).abs().max())
                check(err <= tol[name], f"phase 18 item {i}: decode {name} "
                      f"error {err} > {tol[name]}")
                dec_errs[name] = max(dec_errs[name], err)
        print(f"[data decoder_infer_mega] the {R5_ITEMS} decodes (fp32, "
              f"max_steps 1000) against the plain step loop: stops "
              f"(kernel, plain) {stops}; max err over the shared frames "
              + ", ".join(f"{k} {v:.3e}" for k, v in dec_errs.items())
              + f" (tol mels/gates {DEC_TOL[torch.float32]['mels']:g}, "
              f"aligns {DEC_ALIGN_SHARE[torch.float32]:g} of their mean)",
              flush=True)

        # one item's teacher-forced pass, recording every tail call, and
        # its eight conv layers on their real inputs
        recorded = []
        item = ds[0]
        ak._forward = tail_recorder(plain_forward, recorded)
        with torch.no_grad():
            out = tacotron2_forward(model, item.text[None], item.mel[None],
                                    [len(item.text)], train=False,
                                    speaker_ids=[item.speaker_id],
                                    device=dev)
        ak._forward = plain_forward
        check(len(recorded) == item.mel.shape[1],
              f"phase 18: {len(recorded)} tail calls for "
              f"{item.mel.shape[1]} frames")
        tail_err = max(max_err(o, ak.attention_tail_reference(*ins))
                       for ins, o in recorded)
        shares, conv_errs = model_conv_layers(
            model, torch.from_numpy(item.text[None]).long().to(dev),
            out.mel_coarse)
        print(f"[data attention_tail] item 0's {len(recorded)} "
              f"teacher-forced steps: kernel vs plain max err "
              f"{tail_err:.3e} (tol {TAIL_TOL})", flush=True)
        print(f"[data conv_bn_act] item 0's eight layers (fp32, T_enc="
              f"{len(item.text)}, T_dec={item.mel.shape[1]}): kernel vs "
              f"plain {', '.join(f'{s_:.2e}' for s_ in shares)} of the "
              f"mean size (limit {CONV_TOL[torch.float32]:g}), largest "
              f"{max(conv_errs):.2e} absolute", flush=True)
        check(tail_err <= TAIL_TOL, f"phase 18: attention_tail {tail_err}")
        check(max(shares) <= CONV_TOL[torch.float32],
              f"phase 18: conv_bn_act {shares}")
        del model

        # (e) the ground-truth DSP round trip on one val item
        gt = gt_check.main(gt_check.parse_args([
            "--metadata", val_meta, "--processed_root", proc, "--index",
            "0", "--output_dir", os.path.join(tmp.name, "gt"),
            "--device", str(dev)]))
        row = rows[-R5_VAL]
        cached = np.load(os.path.join(proc, "mels",
                                      basename_of(row["filepath"]) + ".npy"))
        again = get_mel_spectrogram(row["filepath"], audio, device=dev)
        gt_err = float(np.abs(cached - again).max())
        gl, rate = load_audio(os.path.join(
            tmp.name, "gt", gt["basename"] + "_gt_griffinlim.wav"))
        print(f"[data gt_vocoder_check] {gt['basename']}: scale guesses "
              f"processed {gt['processed_mel_scale_guess']}, recomputed "
              f"{gt['recomputed_mel_scale_guess']}; cached vs recomputed "
              f"mel max abs err {gt_err:.3e} (tol {PRE_MEL_TOL:g}); "
              f"Griffin-Lim {len(gl)} samples at {rate} Hz", flush=True)
        check(gt["recomputed_mel_scale_guess"] == "LIKELY_LOG"
              and gt["processed_mel_scale_guess"] == "LIKELY_LOG",
              f"phase 18: scale guesses {gt}")
        check(cached.shape == again.shape and gt_err <= PRE_MEL_TOL,
              f"phase 18: cached vs recomputed mel {gt_err}")
        check(rate == sr and bool(np.isfinite(gl).all())
              and float(np.abs(gl).max()) > 0,
              "phase 18: Griffin-Lim wrote no audio")
        shutil.copytree(proc, keep)
        print(f"[data] phase 18 wall {time.perf_counter() - phase0:.1f} s",
              flush=True)
        return {"attention_tail": dict(quality_path_launches=launches[
                    "attention_tail"], quality_path_max_abs_err=tail_err),
                "decoder_infer_mega": dict(
                    quality_path_launches=launches["decoder_infer_mega"],
                    quality_path_max_abs_err=dec_errs["mels"]),
                "conv_bn_act": dict(
                    quality_path_launches=launches["conv_bn_act"],
                    quality_path_max_abs_err=max(conv_errs))}
    finally:
        ak._forward = plain_forward
        tmp.cleanup()


# phase 19: data parallelism, two ranks sharing the one card
DP_WORLD = 2
DP_STEPS = 3
DP_WAIT_S = 300         # each launch of ranks, bounded: a hung rank fails
DP_EXTRA_TEXTS = ("Hello world.", "Two replicas share one card.",
                  "Good morning to you.", "The rain stays in the plain.")
DP_GL_ITERS = 2         # tests/test_parallel.py's sharded-serving limits,
DP_WAV_TOL, DP_WAV_MEAN = 5e-3, 5e-4   # at 2 Griffin-Lim iterations
# how far the trained checks may widen those limits to twice what batching
# alone gives (the sharded waveforms read 3.3e-3 at B=8 and 8.0e-3 at B=3,
# the shard decodes 2.6e-4 in the mels, on an H100 at 700 W)
DP_WAV_CAP, DP_DEC_CAP = 2e-2, 5e-4
# parameters whose true gradient is zero (a conv bias straight before a
# train-mode BatchNorm, the attention's v bias): Adam moves them by noise,
# at most twice the largest learning rate a step apart
STRUCTURAL_ZERO = tuple(f"{part}.convs.{i}.bias" for part, n in
                        (("encoder", 3), ("postnet", 5)) for i in range(n)) \
    + ("decoder.attention.v.bias",)


def state_digest(state) -> str:
    """sha256 over every bit of a train state: weights, BatchNorm
    statistics, Adam moments and count, counters, generator; under tensor
    parallelism its replicated part (the shards differ by rank)."""
    import hashlib

    from tacotron2_torch.parallel.mesh import sharded_names
    skip = sharded_names(state.model)
    h = hashlib.sha256()
    opt = state.opt_state
    for t in [*(t for n, t in state.model.state_dict().items()
                if n not in skip),
              *(opt[m][n] for m in ("mu", "nu") for n in sorted(opt[m])
                if n not in skip)]:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    h.update(repr((state.step, state.loss_step, opt["count"])).encode())
    h.update(state.generator.get_state().numpy().tobytes())
    return h.hexdigest()


def dp_state(precision: str, batch, dev, tensor_parallel: bool = False):
    """A full-width train state in ``precision`` (seed ``SEED``, under a
    group rank 0's on every rank; with ``tensor_parallel`` this rank's
    shards of it) with the projection bias from the mels of ``batch``
    (this rank's rows).  Returns (state, cfg, tx)."""
    from tacotron2_torch.config import Config, TrainConfig
    from tacotron2_torch.models.tacotron2 import init_projection_bias
    from tacotron2_torch.parallel import shard_train_state
    from tacotron2_torch.train.optim import make_optimizer
    from tacotron2_torch.train.state import create_train_state
    cfg = Config(train=TrainConfig(precision=precision))
    tx = make_optimizer(cfg.train)
    state = shard_train_state(create_train_state(cfg, seed=SEED, tx=tx,
                                                 device=dev),
                              tensor_parallel=tensor_parallel)
    init_projection_bias(state.model, batch["mel"])
    return state, cfg, tx


def dp_first_grads(state, cfg, batch, masks, dev):
    """The first step's gradients (summed over the ranks under a group) on
    ``masks``, the postnet bypassed; the BatchNorm statistics are left as
    they were."""
    from tacotron2_torch.parallel import all_reduce_gradients
    from tacotron2_torch.parallel.mesh import sharded_names
    from tacotron2_torch.train import step as train
    buffers = {n: x.clone() for n, x in state.model.named_buffers()}
    total, _ = train._forward_loss(
        state.model, cfg, train._to_device(batch, dev), None, 0, False,
        cfg.guided_attention.sigma_warmup_steps, masks)
    grads = all_reduce_gradients(train._grads(state.model, total),
                                 sharded_names(state.model))
    with torch.no_grad():
        for n, x in state.model.named_buffers():
            x.copy_(buffers[n])
    return grads


def dp_steps(state, cfg, tx, batch, digest: bool):
    """``DP_STEPS`` ``train_step``s, the postnet bypassed in the first.
    Returns each step's losses, wall ms and (``digest``) the state's
    digest after it."""
    from tacotron2_torch.train import step as train
    losses, walls, digests = [], [], []
    for use_postnet in (False,) + (True,) * (DP_STEPS - 1):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, l, _ = train.train_step(
            state, batch, cfg=cfg, tx=tx, use_postnet=use_postnet,
            sigma_warmup_steps=cfg.guided_attention.sigma_warmup_steps)
        losses.append({k: float(v) for k, v in l._asdict().items()})
        walls.append((time.perf_counter() - t1) * 1e3)
        if digest:
            digests.append(state_digest(state))
    return losses, walls, digests


def cpu_copy(tensors):
    return {n: x.detach().cpu().clone() for n, x in tensors.items()}


def dp_rank(rank: int, world: int, init_file: str, work: str) -> int:
    """One rank of phase 19, started by the phase as ``chip_smoke.py
    --dp-rank RANK WORLD INIT_FILE WORK_DIR``.  On this rank's rows of the
    training main path's batch: the first step's summed gradients, then
    the counted run (``DP_STEPS`` bf16 ``train_step``s, an ``eval_step``),
    then the same steps in fp32.  Writes ``WORK_DIR/rank<RANK>.json`` and,
    rank 0, the gradients and the weights after each run's last step."""
    import torch.distributed as dist

    from tacotron2_torch.ops import _build, attention_kernel, decoder_bptt
    from tacotron2_torch.ops.attention_kernel import attention_tail
    from tacotron2_torch.ops.convbn_kernel import conv_bn_act
    from tacotron2_torch.ops.decoder_bwd_kernel import (
        decoder_bwd_chain_mega, decoder_bwd_chain_reference)
    from tacotron2_torch.ops.decoder_train_kernel import (
        decoder_fwd_train_mega, decoder_fwd_train_reference)
    from tacotron2_torch.parallel import (initialize_distributed, rank_device,
                                          shard_batch)
    from tacotron2_torch.train import step as train

    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    # the parent built every kernel; a rank only loads them
    prebuilt = all(_build.library_path(n).exists()
                   for n in _build.CUDA_SOURCES)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(init_method=f"file://{init_file}",
                           world_size=world, rank=rank)
    dev = rank_device("cuda")
    torch.cuda.set_device(dev)
    out = {"rank": rank, "backend": dist.get_backend(), "device": str(dev),
           "prebuilt": prebuilt}
    from tacotron2_torch.config import ModelConfig
    batch = seeded_train_batch(ModelConfig())
    local = shard_batch(batch, rank, world)
    b, t_enc = local["text"].shape
    t_dec = local["mel"].shape[2]
    state, cfg, tx = dp_state("bfloat16", local, dev)

    # the first step's summed gradients on this rank's rows of the main
    # path's masks; the two training kernels' calls recorded on rank 0
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    masks = first_step_masks(cfg.model, b * world, t_dec, g, dev)
    rows = slice(rank * b, (rank + 1) * b)
    masks = {"prenet": [m[rows] for m in masks["prenet"]],
             "attention": masks["attention"][:, rows],
             "decoder": masks["decoder"][:, rows]}
    calls = {}

    def record(name, fn):
        def wrapper(*args):
            calls[name] = (args, fn(*args))
            return calls[name][1]
        return wrapper

    if rank == 0:
        decoder_bptt.decoder_fwd_train_mega = record(
            "fwd", decoder_fwd_train_mega)
        decoder_bptt.decoder_bwd_chain_mega = record(
            "bwd", decoder_bwd_chain_mega)
    try:
        grads = dp_first_grads(state, cfg, local, masks, dev)
    finally:
        decoder_bptt.decoder_fwd_train_mega = decoder_fwd_train_mega
        decoder_bptt.decoder_bwd_chain_mega = decoder_bwd_chain_mega
    if rank == 0:
        torch.save(cpu_copy(grads), os.path.join(work, "grads.pt"))
        where = f"dp rank 0 B={b} T_enc={t_enc} T_dec={t_dec} bf16"
        detach = lambda xs: tuple(x.detach() if torch.is_tensor(x) else x
                                  for x in xs)
        for name, kernel, names, plain in (
                ("fwd", "decoder_fwd_train_mega", FWD_OUT,
                 decoder_fwd_train_reference),
                ("bwd", "decoder_bwd_chain_mega", BWD_OUT,
                 decoder_bwd_chain_reference)):
            args, got = calls[name]
            errs = compare_outputs(names, got, plain(*detach(args)),
                                   MAIN_PAIR_TOL, f"{where} {kernel}")
            out[f"{name}_max_abs_err"] = max(errs.values())
    del grads, calls

    # the counted run: DP_STEPS bf16 train_steps, the all-reduce timed
    reduce = train.all_reduce_gradients
    reduce_ms = []

    def timed_reduce(grads, *args):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reduce(grads, *args)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t1) * 1e3)
        return grads

    train.all_reduce_gradients = timed_reduce
    dist.barrier()          # rank 0's comparisons above are not timed
    decoder_fwd_train_mega.launches = 0
    decoder_bwd_chain_mega.launches = 0
    attention_tail.launches = 0
    try:
        losses, walls, digests = dp_steps(state, cfg, tx, local, True)
    finally:
        train.all_reduce_gradients = reduce
    out["train_launches"] = (decoder_fwd_train_mega.launches,
                             decoder_bwd_chain_mega.launches,
                             attention_tail.launches)
    out.update(losses=losses, step_ms=walls, allreduce_ms=reduce_ms,
               counters=(state.step, state.loss_step))

    # one eval_step: the tail on every teacher-forced step, each call held
    # to the plain version on its own inputs
    launch_tail = attention_kernel._forward
    tail_errs = []

    def checked_tail(*ins):
        o = launch_tail(*ins)
        tail_errs.append(max_err(
            o, attention_kernel.attention_tail_reference(*ins)))
        return o

    attention_tail.launches = 0
    conv_bn_act.launches = 0
    attention_kernel._forward = checked_tail
    try:
        l, _, entropy = train.eval_step(state, local, cfg=cfg,
                                        sigma_warmup_steps=cfg.
                                        guided_attention.sigma_warmup_steps)
    finally:
        attention_kernel._forward = launch_tail
    out.update(eval_tail_launches=attention_tail.launches, t_dec=t_dec,
               eval_conv_launches=conv_bn_act.launches,
               eval_tail_calls=len(tail_errs), eval_tail_err=max(tail_errs),
               eval={k: float(v) for k, v in l._asdict().items()},
               eval_entropy=float(entropy))
    if rank == 0:
        torch.save(cpu_copy(state.model.state_dict()),
                   os.path.join(work, "weights_bfloat16.pt"))
    del state

    # the same steps in fp32, where the weights can be held to one process
    state, cfg, tx = dp_state("float32", local, dev)
    out["losses_fp32"], _, digests_fp32 = dp_steps(state, cfg, tx, local,
                                                   True)
    if rank == 0:
        torch.save(cpu_copy(state.model.state_dict()),
                   os.path.join(work, "weights_float32.pt"))
    every = [None] * world
    dist.all_gather_object(every, {"bfloat16": digests,
                                   "float32": digests_fp32})
    out["digests"] = every
    out["libraries"] = sorted(str(_build.library_path(n))
                              for n in _build._loaded)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def run_ranks(cmds, cwd: str, logs: str, what: str):
    """Start every command of ``cmds`` (each in its own process group) and
    wait, at most ``DP_WAIT_S``; on a failure or the time limit every
    process group is killed and the phase fails with the logs' ends.
    Returns the logs."""
    import signal
    paths = [os.path.join(logs, f"{what.replace(' ', '_')}_{i}.log")
             for i in range(len(cmds))]
    procs = []
    for cmd, path in zip(cmds, paths):
        with open(path, "w") as log:
            procs.append(subprocess.Popen(
                cmd, cwd=cwd, stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True))
    deadline = time.perf_counter() + DP_WAIT_S
    while (any(p.poll() is None for p in procs)
           and not any(p.returncode for p in procs)
           and time.perf_counter() < deadline):
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
        p.wait()
    texts = []
    for path in paths:
        with open(path) as f:
            texts.append(f.read())
    for p, text in zip(procs, texts):
        check(p.returncode == 0, f"{what}: exit {p.returncode} "
              f"(killed after {DP_WAIT_S} s if -9):\n{text[-3000:]}")
    return texts


def dp_reference(dev):
    """Phase 19's one process doing what the ranks do together, at B=16:
    the first step's gradients, then ``DP_STEPS`` steps in bf16 and in
    fp32.  Returns the gradients and per type the losses, wall ms and the
    weights before and after."""
    from tacotron2_torch.config import ModelConfig
    batch = seeded_train_batch(ModelConfig())
    out = {}
    for precision in ("bfloat16", "float32"):
        state, cfg, tx = dp_state(precision, batch, dev)
        if precision == "bfloat16":
            g = torch.Generator(device=dev).manual_seed(SEED + 7)
            out["grads"] = cpu_copy(dp_first_grads(
                state, cfg, batch, first_step_masks(
                    cfg.model, batch["mel"].shape[0], batch["mel"].shape[2],
                    g, dev), dev))
        before = cpu_copy(state.model.state_dict())
        losses, walls, _ = dp_steps(state, cfg, tx, batch, False)
        out[precision] = (losses, walls, before,
                          cpu_copy(state.model.state_dict()))
        del state
    lr = cfg.train.learning_rate * max(1.0, cfg.train.attention_lr_multiplier)
    return out, lr


def weight_gap(before, after_1, after_dp):
    """The gap between the ranks' weights and one process's, summed over
    every element of every tensor but the zero-gradient biases, as a
    share of one process's update summed likewise; each tensor's own
    share; the zero-gradient biases' largest gap."""
    gap_sum = moved_sum = zero_gap = 0.0
    shares = {}
    for n, ref in after_1.items():
        gap = (after_dp[n] - ref).abs()
        if n in STRUCTURAL_ZERO:
            zero_gap = max(zero_gap, float(gap.max()))
            continue
        moved = float((ref - before[n]).abs().sum())
        gap_sum += float(gap.sum())
        moved_sum += moved
        shares[n] = float(gap.sum()) / max(moved, 1e-30)
    return gap_sum / moved_sum, shares, zero_gap


def dp_training(dev, root: str, tmp: str, reference) -> dict:
    """Phase 19 (a): two ranks on the card against one process
    (``reference``: :func:`dp_reference`'s results and seconds)."""
    ref, lr, ref_s = reference
    init = os.path.join(tmp, "store")
    t1 = time.perf_counter()
    logs = run_ranks(
        [[sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
          str(DP_WORLD), init, tmp] for r in range(DP_WORLD)],
        root, tmp, "dp train")
    ranks_s = time.perf_counter() - t1
    outs = []
    for r in range(DP_WORLD):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    for o, log in zip(outs, logs):
        said = [ln for ln in log.splitlines()
                if ln.startswith(("[distributed]", "[dp rank"))]
        print(f"[dp rank {o['rank']}] backend {o['backend']} on {o['device']};"
              f" kernels loaded from the parent's build: "
              f"{[os.path.basename(p) for p in o['libraries']]}; "
              + " | ".join(said), flush=True)
        check(o["backend"] == "gloo" and o["device"] == "cuda:0",
              f"rank {o['rank']}: backend {o['backend']} on {o['device']}")
        check(o["prebuilt"] and len(o["libraries"]) == 4,
              f"rank {o['rank']}: kernels built before it started "
              f"{o['prebuilt']}, loaded {o['libraries']}")

    # every rank's state bit for bit after every step
    for precision in ("bfloat16", "float32"):
        for i in range(DP_STEPS):
            got = {d[precision][i] for d in outs[0]["digests"]}
            print(f"[dp {precision}] after step {i + 1}: the {DP_WORLD} "
                  "ranks' weights, BatchNorm statistics, moments, counters "
                  f"and generator {'bit for bit equal' if len(got) == 1 else 'DIFFER'}"
                  f" (sha256 {min(got)[:16]})", flush=True)
            check(len(got) == 1, f"phase 19: ranks differ after {precision} "
                  f"step {i + 1}")
    for o in outs:
        fwd, bwd, tail = o["train_launches"]
        print(f"[dp rank {o['rank']}] launches over {DP_STEPS} bf16 "
              f"train_steps: decoder_fwd_train_mega={fwd} "
              f"decoder_bwd_chain_mega={bwd} attention_tail={tail}; eval_step"
              f" attention_tail={o['eval_tail_launches']} ("
              f"{o['eval_tail_calls']} teacher-forced steps, each within "
              f"{o['eval_tail_err']:.2e} of the plain version, tol "
              f"{TAIL_TOL}), conv_bn_act={o['eval_conv_launches']}",
              flush=True)
        check((fwd, bwd, tail) == (DP_STEPS, DP_STEPS, 0),
              f"rank {o['rank']}: train launches {o['train_launches']}")
        check(o["eval_tail_launches"] == o["eval_tail_calls"] == o["t_dec"]
              and o["eval_tail_err"] <= TAIL_TOL,
              f"rank {o['rank']}: eval tail {o['eval_tail_launches']} "
              f"launches, {o['eval_tail_calls']} calls, err "
              f"{o['eval_tail_err']}")
        check(o["eval_conv_launches"] == 8,
              f"rank {o['rank']}: eval conv launches {o['eval_conv_launches']}")
        check(o["counters"] == [DP_STEPS, DP_STEPS], f"counters {o['counters']}")
    check(outs[0]["eval"] == outs[1]["eval"],
          f"phase 19: the ranks' global eval losses differ: {outs[0]['eval']}"
          f" vs {outs[1]['eval']}")

    # two ranks against one process: gradients, losses, weights
    grads_dp = torch.load(os.path.join(tmp, "grads.pt"))
    check(set(grads_dp) == set(ref["grads"]), "the ranks' gradients cover "
          "other parameters than one process's")
    errs = grad_errors(grads_dp, ref["grads"], 1e-2)
    worst = max(errs, key=errs.get)
    print(f"[dp] first step's gradients summed over the ranks vs one process "
          f"at B=16 (bf16, the same masks): {len(errs)} tensors, worst "
          f"{worst} {errs[worst]:.2e} (limit {GRAD_TOL})", flush=True)
    check(errs[worst] <= GRAD_TOL, f"phase 19 gradients: {worst} "
          f"{errs[worst]}")
    for precision, key in (("bfloat16", "losses"), ("float32", "losses_fp32")):
        losses_1, walls_1, before, after_1 = ref[precision]
        gap = max(abs(a[k] - b_[k]) / max(abs(b_[k]), 1e-6)
                  for a, b_ in zip(outs[0][key], losses_1) for k in b_)
        share, shares, zero_gap = weight_gap(
            before, after_1,
            torch.load(os.path.join(tmp, f"weights_{precision}.pt")))
        top = sorted(shares, key=shares.get)[-3:]
        print(f"[dp {precision}] losses of the {DP_STEPS} steps, rank 0 "
              f"{[round(x['total'], 5) for x in outs[0][key]]} vs one process "
              f"{[round(x['total'], 5) for x in losses_1]}: largest relative "
              f"gap over every term {gap:.2e} (limit {GRAD_TOL}); weights "
              f"and BatchNorm statistics after step {DP_STEPS}: the gap "
              f"summed over every element {share:.2e} of one process's "
              f"update summed likewise ("
              + (f"limit {GRAD_TOL}" if precision == "float32" else
                 "not held: Adam steps each element by about lr whatever "
                 "its gradient's size, so elements whose gradients sit at "
                 "bf16 noise step by noise")
              + "), largest by tensor " + ", ".join(
                  f"{n} {shares[n]:.2e}" for n in top)
              + f"; the zero-gradient biases {zero_gap:.2e} (limit "
              f"{2 * lr * DP_STEPS:g})", flush=True)
        check(gap <= GRAD_TOL, f"phase 19 {precision} losses part by {gap}")
        check(zero_gap <= 2 * lr * DP_STEPS, f"phase 19 {precision} biases: "
              f"{zero_gap}")
        if precision == "float32":
            check(max(shares.values()) <= GRAD_TOL,
                  f"phase 19 fp32 weights part by {max(shares.values())}")
    walls_1 = ref["bfloat16"][1]
    print(f"[dp] bf16 train_step wall, ms: 1 process at B=16 "
          f"{[round(x, 1) for x in walls_1]}; {DP_WORLD} ranks of 8 on the "
          f"one card (gloo) " + "; ".join(
              f"rank {x['rank']} {[round(y, 1) for y in x['step_ms']]}"
              for x in outs)
          + f"; the gradient all-reduce (gloo, through the host, "
          f"{sum(t.numel() for t in ref['grads'].values()) * 4 / 1e6:.1f} MB"
          ") " + "; ".join(f"rank {x['rank']} "
                           f"{[round(y, 1) for y in x['allreduce_ms']]}"
                           for x in outs)
          + f"; one process's part {ref_s:.1f} s, the ranks' {ranks_s:.1f} s"
          " with their start", flush=True)
    o = outs[0]
    return {"fwd": o.get("fwd_max_abs_err"), "bwd": o.get("bwd_max_abs_err"),
            "launches": o["train_launches"],
            "eval_tail_launches": o["eval_tail_launches"],
            "eval_conv_launches": o["eval_conv_launches"]}


def dp_cli(dev, root: str, tmp: str) -> None:
    """Phase 19 (b): ``train_torch.py`` under torchrun, two ranks on the
    card: two epochs unbroken, then the second again resumed from the
    first epoch's checkpoint, bit for bit."""
    from tacotron2_torch.data.synth_corpus import write_corpus
    from tacotron2_torch.utils.weight_files import load_file

    train_csv, val_csv = write_corpus(os.path.join(tmp, "corpus"), 32,
                                      seed=SEED, n_val=8, device=dev)
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", str(DP_WORLD), "train_torch.py"]
    flags = ["--batch_size", "4", "--epochs", "2", "--val_metadata", val_csv]
    runs = {}
    for name, extra in (
            ("unbroken", []),
            ("resumed", ["--resume", os.path.join(tmp, "unbroken",
                                                  "tacotron2_epoch_1")])):
        t1 = time.perf_counter()
        log = run_ranks([torchrun + [train_csv, os.path.join(tmp, name)]
                         + flags + extra], root, tmp, f"dp cli {name}")[0]
        runs[name] = time.perf_counter() - t1
        with open(os.path.join(tmp, name, "training_log.txt")) as f:
            written = f.read()
        dp_line = "Data parallel: 2 devices, 2 processes, global micro-batch 8"
        # the ranks print into torchrun's one output, lines may interleave
        said = sorted(re.findall(r"\[distributed\] initialized: rank "
                                 r"(\d+)/\d+, backend (\w+)", log))
        print(f"[dp cli] torchrun --standalone --nproc_per_node {DP_WORLD} "
              f"train_torch.py {name}: exit 0 in {runs[name]:.1f} s; ranks "
              f"and backends {said}; its log: "
              f"{written.count(dp_line)} x {dp_line!r}, "
              f"{written.count('complete. Avg Loss')} epoch lines, "
              f"{written.count('Validation |')} validations", flush=True)
        check(said == [(str(r), "gloo") for r in range(DP_WORLD)],
              f"{name}: {said}")
        check(written.count(dp_line) == 1, f"{name}: log {written[-2000:]}")
        want_epochs = 2 if name == "unbroken" else 1
        check(written.count("complete. Avg Loss") == want_epochs
              and written.count("Validation |") == want_epochs,
              f"{name}: rank 0 alone did not write the log: "
              f"{written[-2000:]}")
        left = [f for _, _, fs in os.walk(os.path.join(tmp, name))
                for f in fs if ".tmp" in f]
        check(not left, f"{name}: temporary files left {left}")
    a = load_file(os.path.join(tmp, "unbroken", "tacotron2_epoch_2",
                               "train_state.pt"))
    b = load_file(os.path.join(tmp, "resumed", "tacotron2_epoch_2",
                               "train_state.pt"))
    same = {
        "weights and statistics": all(torch.equal(a["model"][k], b["model"][k])
                                      for k in a["model"]),
        "moments": all(torch.equal(a["opt_state"][m][k], b["opt_state"][m][k])
                       for m in ("mu", "nu") for k in a["opt_state"][m]),
        "counters": (a["step"], a["loss_step"], a["opt_state"]["count"])
        == (b["step"], b["loss_step"], b["opt_state"]["count"]),
        "generator": torch.equal(a["generator"], b["generator"])}
    print(f"[dp cli] two epochs unbroken ({a['step']} steps) vs the second "
          f"resumed from the first's checkpoint, both on {DP_WORLD} ranks, "
          f"bit for bit: {same}", flush=True)
    check(all(same.values()) and a["step"] == 6, f"resumed run differs: "
          f"{same}, {a['step']} steps")


def trained_decode(model, fn, tok, lens, dev):
    """``fn`` (the decode kernel or the plain step loop) on padded token
    rows, stop mode "all", ``TRAINED_MAX_STEPS`` frames at most."""
    from tacotron2_torch.models.encoder import encoder_apply
    from tacotron2_torch.models.tacotron2 import (_condition_memory,
                                                  make_pad_mask)
    tok = torch.from_numpy(tok).long().to(dev)
    lens = torch.from_numpy(lens).to(dev)
    with torch.no_grad():
        memory = _condition_memory(model, encoder_apply(model.encoder, tok),
                                   None)
        return fn(model.decoder, memory, TRAINED_MAX_STEPS,
                  model.cfg.gate_threshold, True,
                  make_pad_mask(lens, tok.shape[1]), "all", None)


def shard_decodes(model, tokens, lengths, per: int, dev):
    """Each shard's decode (rows ``[i * per, (i + 1) * per)`` of the padded
    batch) by the kernel and by the plain step loop, and each row by the
    plain step loop alone.  Returns [(kernel, plain, [plain alone, ...]),
    ...] a shard."""
    from tacotron2_torch.ops.decoder_megakernel import (
        decoder_infer_mega, decoder_infer_mega_reference)

    out = []
    for i in range(DP_WORLD):
        rows = slice(i * per, (i + 1) * per)
        out.append((trained_decode(model, decoder_infer_mega, tokens[rows],
                                   lengths[rows], dev),
                    trained_decode(model, decoder_infer_mega_reference,
                                   tokens[rows], lengths[rows], dev),
                    [trained_decode(model, decoder_infer_mega_reference,
                                    tokens[r:r + 1], lengths[r:r + 1], dev)
                     for r in range(i * per, (i + 1) * per)]))
    return out


def batch_makeup(model, texts, tokens, lengths, plain_alone, dev) -> None:
    """Prints how far the batch's makeup moves the trained fp32 decode:
    the whole batch against each row alone, padded as in the batch and
    padded on its own, by the decode kernel and, as a second witness, by
    the plain step loop (``plain_alone``: its rows alone, padded as in
    the batch, from :func:`shard_decodes`).  For each row the frame ends
    (batched / alone) and the largest mel difference over the frames both
    keep."""
    from tacotron2_torch.ops.decoder_megakernel import (
        decoder_infer_mega, decoder_infer_mega_reference)
    from tacotron2_torch.text import pad_sequences, text_to_sequence

    for name, fn in (("kernel", decoder_infer_mega),
                     ("plain step loop", decoder_infer_mega_reference)):
        whole = trained_decode(model, fn, tokens, lengths, dev)
        for pad in ("as in the batch", "on its own"):
            rows = []
            for r, text in enumerate(texts):
                if pad == "on its own":
                    tok, lens = pad_sequences([text_to_sequence(text)],
                                              pad_multiple=16)
                    alone = trained_decode(model, fn, tok, lens, dev)
                elif fn is decoder_infer_mega:
                    alone = trained_decode(model, fn, tokens[r:r + 1],
                                           lengths[r:r + 1], dev)
                else:
                    alone = plain_alone[r]
                end_b, end_a = int(whole[4][r]), int(alone[4][0])
                k = min(end_b, end_a)
                gap = float((whole[0][r, :k] - alone[0][0, :k]).abs().max())
                rows.append(f"{end_b}/{end_a} {gap:.1e}")
            print(f"[dp batch makeup B={len(texts)}] {name}, fp32, each row "
                  f"alone padded {pad} (T_enc {tokens.shape[1]} in the "
                  f"batch): frame ends batched/alone and mels max gap "
                  f"{rows} (printed, not held)", flush=True)


def row_gaps(a, b, row_a: int, row_b: int):
    """{output: largest difference over the frames both decodes share}
    for one row of two decodes, or None where they stop apart."""
    end_a, end_b = int(a[4][row_a]), int(b[4][row_b])
    if end_a != end_b:
        return None
    return {name: float((x[row_a, :end_a] - y[row_b, :end_a]).abs().max())
            for name, x, y in zip(DEC_OUTPUTS, a[:3], b[:3])}


def dp_serving(dev) -> dict:
    """Phase 19 (c): ``ShardedSynthesizer`` over two replicas on the card.
    Returns each serving kernel's launches on the sharded calls.

    Trained fp32 decodes carry rounding through the autoregressive loop:
    the same sentence decoded in another batch parts by more than
    ``DEC_TOL`` and ``DP_WAV_TOL`` (tests/test_parallel.py's limit, set on
    a small seeded model; trained waveforms peak near 6.5, and Griffin-Lim
    turns a 1e-5 move of the mels into 1e-3 of the waveform).  So each
    limit is also at least twice what the unsharded path gives when the
    same sentences run one at a time: sharding may part the results no
    further than batching does."""
    from tacotron2_torch.config import Config
    from tacotron2_torch.dsp import griffinlim
    from tacotron2_torch.infer import ShardedSynthesizer
    from tacotron2_torch.infer.fused import (synthesize_wav,
                                             synthesize_wav_fused)
    from tacotron2_torch.infer.sharded import _pad_rows
    from tacotron2_torch.infer.vocode import GriffinLim
    from tacotron2_torch.infer.synthesize import load_model
    from tacotron2_torch.ops.convbn_kernel import conv_bn_act
    from tacotron2_torch.ops.decoder_megakernel import decoder_infer_mega
    from tacotron2_torch.parallel import make_mesh
    from tacotron2_torch.text import pad_sequences, text_to_sequence

    model = load_model(TRAINED_CKPT, device=dev)
    acfg = Config().audio
    hop = acfg.hop_length
    mesh = make_mesh(devices=["cuda:0"] * DP_WORLD)
    eight = list(SMOKE_TEXTS) + list(DP_EXTRA_TEXTS)
    launches = {"decoder_infer_mega": 0, "conv_bn_act": 0}
    with ShardedSynthesizer(model, mesh, gl_iters=DP_GL_ITERS) as synth:
        for texts in (eight, eight[:3]):
            n = len(texts)
            batched = synthesize_wav(model, texts,
                                     max_steps=TRAINED_MAX_STEPS,
                                     gl_iters=DP_GL_ITERS, device=dev)
            decoder_infer_mega.launches = 0
            conv_bn_act.launches = 0
            wavs = synth(texts, max_steps=TRAINED_MAX_STEPS)
            got = (decoder_infer_mega.launches, conv_bn_act.launches)
            launches["decoder_infer_mega"] += got[0]
            launches["conv_bn_act"] += got[1]
            # the unsharded path one sentence at a time, each padded as in
            # the batch (the encoder's BiLSTM runs over the padding) and on
            # its row of the batch's initial phase
            tokens, lengths = pad_sequences(
                [text_to_sequence(t) for t in texts], pad_multiple=16)
            phase = griffinlim._initial_phase(
                (n, acfg.n_fft // 2 + 1, TRAINED_MAX_STEPS), 0, dev)
            alone = []
            for r in range(n):
                w, _, _, e = synthesize_wav_fused(
                    model, GriffinLim(acfg, DP_GL_ITERS, phase[r:r + 1]),
                    acfg, tokens[r:r + 1], lengths[r:r + 1],
                    max_steps=TRAINED_MAX_STEPS, device=dev)
                alone.append(w[0, :int(e[0]) * hop].cpu().numpy())
            row_gap = [float(np.abs(a - b_).max()) if a.shape == b_.shape
                       else None for a, b_ in zip(alone, batched)]
            spread = max((g for g in row_gap if g is not None), default=0.0)
            wav_tol = min(max(DP_WAV_TOL, 2 * spread), DP_WAV_CAP)
            gaps = [None if g is None else float(f"{g:.2e}") for g in row_gap]
            print(f"[dp batch makeup B={n}] synthesize_wav, each sentence "
                  f"alone (padded as in the batch, its row's Griffin-Lim "
                  f"phase) against batched: frame ends alone "
                  f"{[len(a) // hop for a in alone]}, waveform max gap by "
                  f"row {gaps} (None: the ends part)", flush=True)
            ends = [len(w) // hop for w in wavs]
            ends_1 = [len(w) // hop for w in batched]
            err = max(float(np.abs(w - r).max()) for w, r in
                      zip(wavs, batched))
            mean = max(float(np.abs(w - r).mean()) for w, r in
                       zip(wavs, batched))
            # walls in turns: unsharded, sharded, sharded, unsharded
            walls = {"unsharded": [], "sharded": []}
            for name in ("unsharded", "sharded", "sharded", "unsharded"):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                if name == "sharded":
                    synth(texts, max_steps=TRAINED_MAX_STEPS)
                else:
                    synthesize_wav(model, texts, max_steps=TRAINED_MAX_STEPS,
                                   gl_iters=DP_GL_ITERS, device=dev)
                walls[name].append((time.perf_counter() - t1) * 1e3)
            print(f"[dp sharded B={n}] {DP_WORLD} replicas on cuda:0 (fp32 "
                  f"r4_synth_bf16, {DP_GL_ITERS} Griffin-Lim rounds): frame "
                  f"ends {ends} vs unsharded {ends_1}; wav max err "
                  f"{err:.2e} (tol {wav_tol:.3g}: {DP_WAV_TOL:g} or twice "
                  f"the unsharded path one sentence at a time against "
                  f"batched, {spread:.2e}, at most {DP_WAV_CAP:g}), mean "
                  f"{mean:.2e} (tol "
                  f"{DP_WAV_MEAN:g}), peak {max(np.abs(w).max() for w in wavs):.2f}; "
                  f"launches decoder_infer_mega={got[0]} conv_bn_act="
                  f"{got[1]}; wall ms sharded "
                  f"{[round(x, 1) for x in walls['sharded']]}, unsharded "
                  f"{[round(x, 1) for x in walls['unsharded']]} (one card: "
                  f"no speed-up expected)", flush=True)
            check(ends == ends_1, f"sharded frame ends {ends} vs {ends_1}")
            check(err <= wav_tol and mean <= DP_WAV_MEAN,
                  f"sharded wavs: {err}, {mean}")
            check(got == (DP_WORLD, 8 * DP_WORLD),
                  f"sharded launches {got}, expected one decode and eight "
                  "conv layers a shard")

            # each shard's decode against the plain step loop, and its
            # eight conv layers
            per = -(-n // DP_WORLD)
            tokens = _pad_rows(tokens, per * DP_WORLD)
            lengths = _pad_rows(lengths, per * DP_WORLD)
            shards = shard_decodes(model, tokens, lengths, per, dev)
            spreads = [row_gaps(p, a, r, 0) for _, p, alone_ in shards
                       for r, a in enumerate(alone_)]
            dec_spread = {k: max((s[k] for s in spreads if s), default=0.0)
                          for k in DEC_OUTPUTS}
            errs = {k: 0.0 for k in DEC_OUTPUTS}
            for i, (k_out, p_out, _) in enumerate(shards):
                g_end, r_end = k_out[4].tolist(), p_out[4].tolist()
                check(all(abs(a - b_) <= STOP_SLACK
                          for a, b_ in zip(g_end, r_end)),
                      f"shard {i}: frame ends {g_end} vs plain {r_end}")
                tol = {k: min(max(DEC_TOL[torch.float32][k],
                                  2 * dec_spread[k]), DP_DEC_CAP)
                       for k in ("mels", "gates")}
                tol["aligns"] = DEC_ALIGN_SHARE[torch.float32] * float(
                    p_out[2][:, :max(r_end)].abs().mean())
                for row, (a, b_) in enumerate(zip(g_end, r_end)):
                    for name, g_, r_ in zip(DEC_OUTPUTS, k_out[:3], p_out[:3]):
                        e = float((g_[row, :min(a, b_)]
                                   - r_[row, :min(a, b_)]).abs().max())
                        errs[name] = max(errs[name], e)
                        check(e <= tol[name], f"shard {i} row {row}: decode "
                              f"{name} error {e} > {tol[name]}")
                shares, _ = model_conv_layers(
                    model, torch.from_numpy(tokens[i * per:(i + 1) * per])
                    .long().to(dev), k_out[0])
                check(max(shares) <= CONV_TOL[torch.float32],
                      f"shard {i} conv_bn_act {shares}")
            print(f"[dp sharded B={n}] each shard (B={per}) against the plain "
                  f"versions: decode " + ", ".join(
                      f"{k} {v:.2e}" for k, v in errs.items())
                  + f" (tol mels/gates {DEC_TOL[torch.float32]['mels']:g} or"
                  f" twice the plain step loop's own gap between the shard "
                  f"and each row alone, mels {dec_spread['mels']:.2e}, "
                  f"gates {dec_spread['gates']:.2e}, at most "
                  f"{DP_DEC_CAP:g}; aligns "
                  f"{DEC_ALIGN_SHARE[torch.float32]:g} of their mean), eight "
                  f"conv layers each within {CONV_TOL[torch.float32]:g} of "
                  f"the mean size", flush=True)
            if n == len(eight):
                batch_makeup(model, texts, tokens, lengths,
                             [a for _, _, al in shards for a in al], dev)
    return launches


def data_parallel_phase(dev, smi: str, reference) -> dict:
    """Phase 19 (``reference``: one process's run, :func:`dp_reference`).
    Returns each kernel's launches on the data-parallel training path
    (``dp_path_launches``, each rank's) and on the sharded serving path
    (``sharded_path_launches``)."""
    import shutil
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode,name,power.limit",
         "--format=csv,noheader", f"--id={torch.cuda.current_device()}"],
        capture_output=True, text=True, check=True).stdout.strip()
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,process_name",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    mps = [ln for ln in apps.splitlines() if "mps" in ln.lower()]
    print(f"[dp] compute mode, card, power limit: {mode}; MPS server: "
          f"{mps or 'none'} (the decoder kernels' grid barriers need every "
          "block resident: two contexts time-slice the card, MPS would "
          "share its SMs)", flush=True)
    check(mode.split(",")[0].strip() == "Default", f"compute mode {mode}")
    check(not mps, f"an MPS server is active: {mps}")
    root = os.path.dirname(os.path.abspath(__file__))
    phase0 = time.perf_counter()
    tmp = tempfile.mkdtemp()
    try:
        for sub in ("train", "cli"):
            os.makedirs(os.path.join(tmp, sub))
        train_out = dp_training(dev, root, os.path.join(tmp, "train"),
                                reference)
        torch.cuda.empty_cache()
        dp_cli(dev, root, os.path.join(tmp, "cli"))
        sharded = dp_serving(dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[dp] phase 19 wall {time.perf_counter() - phase0:.1f} s ({smi})",
          flush=True)
    fwd, bwd, _ = train_out["launches"]
    return {"decoder_fwd_train_mega": {"dp_path_launches": fwd,
                                       "dp_path_max_abs_err": train_out["fwd"]},
            "decoder_bwd_chain_mega": {"dp_path_launches": bwd,
                                       "dp_path_max_abs_err": train_out["bwd"]},
            "attention_tail": {"dp_path_launches":
                               train_out["eval_tail_launches"]},
            "decoder_infer_mega": {"sharded_path_launches":
                                   sharded["decoder_infer_mega"]},
            "conv_bn_act": {"dp_path_launches":
                            train_out["eval_conv_launches"],
                            "sharded_path_launches": sharded["conv_bn_act"]}}

# phase 20: tensor parallelism, ranks and shards sharing the one card
TP = 2
TP_CLI_PROCS = 4


def whole_grads(model, grads):
    """This rank's gradients with each shard's put back together over the
    model group (a collective)."""
    from tacotron2_torch.parallel.collectives import gather_model_axis
    from tacotron2_torch.parallel.mesh import param_shardings, sharded_names
    names = sharded_names(model)
    specs = param_shardings(model, True)
    return {n: gather_model_axis(g, specs[n].index("model")) if n in names
            else g for n, g in grads.items()}


def tp_rank(rank: int, world: int, init_file: str, work: str) -> int:
    """One rank of phase 20 (a), started by the phase as ``chip_smoke.py
    --tp-rank RANK WORLD INIT_FILE WORK_DIR``: a grid of data 1 x model
    WORLD, every rank on the training main path's whole batch.  The first
    step's gradients (gathered whole), the counted run (``DP_STEPS`` bf16
    ``train_step``s with the model-axis collectives timed, an
    ``eval_step``), then the same steps in fp32.  Writes
    ``WORK_DIR/rank<RANK>.json``, this rank's shards after the fp32 steps
    and, rank 0, the gathered gradients and weights."""
    import torch.distributed as dist

    from tacotron2_torch.config import ModelConfig
    from tacotron2_torch.ops import _build, attention_kernel
    from tacotron2_torch.ops.attention_kernel import attention_tail
    from tacotron2_torch.ops.convbn_kernel import conv_bn_act
    from tacotron2_torch.ops.decoder_bwd_kernel import decoder_bwd_chain_mega
    from tacotron2_torch.ops.decoder_megakernel import decoder_infer_mega
    from tacotron2_torch.ops.decoder_train_kernel import decoder_fwd_train_mega
    from tacotron2_torch.parallel import (collectives, gather_train_state,
                                          init_tensor_parallel,
                                          initialize_distributed, rank_device)
    from tacotron2_torch.models.tacotron2 import replace_config
    from tacotron2_torch.parallel.mesh import sharded_names
    from tacotron2_torch.train import step as train

    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    prebuilt = all(_build.library_path(n).exists()
                   for n in _build.CUDA_SOURCES)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(init_method=f"file://{init_file}",
                           world_size=world, rank=rank)
    init_tensor_parallel(world)
    dev = rank_device("cuda")
    torch.cuda.set_device(dev)
    out = {"rank": rank, "backend": dist.get_backend(), "device": str(dev),
           "prebuilt": prebuilt}
    batch = seeded_train_batch(ModelConfig())
    b, t_enc = batch["text"].shape
    t_dec = batch["mel"].shape[2]
    state, cfg, tx = dp_state("bfloat16", batch, dev, tensor_parallel=True)
    names = sharded_names(state.model)
    out["shard_shapes"] = {n: list(state.model.get_parameter(n).shape)
                           for n in sorted(names)}

    # the first step's gradients on phase 19's masks, gathered whole
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    grads = whole_grads(state.model, dp_first_grads(
        state, cfg, batch, first_step_masks(cfg.model, b, t_dec, g, dev),
        dev))
    if rank == 0:
        torch.save(cpu_copy(grads), os.path.join(work, "grads.pt"))
    del grads

    # the counted run, the model-axis collectives timed and counted
    timed = {"n": 0, "ms": 0.0}

    def timing(fn):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            y = fn(*args, **kw)
            torch.cuda.synchronize()
            timed["ms"] += (time.perf_counter() - t1) * 1e3
            timed["n"] += 1
            return y
        return wrapper

    plain = (collectives._model_sum, collectives.gather_model_axis)
    collectives._model_sum = timing(plain[0])
    collectives.gather_model_axis = timing(plain[1])
    dist.barrier()
    for kernel in (decoder_fwd_train_mega, decoder_bwd_chain_mega,
                   decoder_infer_mega, attention_tail):
        kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        losses, walls, digests = dp_steps(state, cfg, tx, batch, True)
    finally:
        collectives._model_sum, collectives.gather_model_axis = plain
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["train_launches"] = (decoder_fwd_train_mega.launches,
                             decoder_bwd_chain_mega.launches,
                             decoder_infer_mega.launches,
                             attention_tail.launches)
    out.update(losses=losses, step_ms=walls, collectives=timed,
               counters=(state.step, state.loss_step))

    # one eval_step: the tail on every teacher-forced step, each call held
    # to the plain version on its own inputs; the conv kernel eight times
    launch_tail = attention_kernel._forward
    tail_errs = []

    def checked_tail(*ins):
        o = launch_tail(*ins)
        tail_errs.append(max_err(
            o, attention_kernel.attention_tail_reference(*ins)))
        return o

    attention_tail.launches = 0
    conv_bn_act.launches = 0
    attention_kernel._forward = checked_tail
    try:
        l, _, entropy = train.eval_step(
            state, batch, cfg=cfg,
            sigma_warmup_steps=cfg.guided_attention.sigma_warmup_steps)
    finally:
        attention_kernel._forward = launch_tail
    out.update(eval_tail_launches=attention_tail.launches, t_dec=t_dec,
               eval_conv_launches=conv_bn_act.launches,
               eval_tail_calls=len(tail_errs), eval_tail_err=max(tail_errs),
               eval={k: float(v) for k, v in l._asdict().items()},
               eval_entropy=float(entropy))
    del state

    # one bf16 step with every decoder step rematerialised (remat "full":
    # the model-axis collectives of a step run again in its backward), the
    # postnet bypassed as in the first step above: its gradients and the
    # state after it gathered whole, the replicated state's digest, the
    # peak memory against the steps above
    state, cfg, tx = dp_state("bfloat16", batch, dev, tensor_parallel=True)
    replace_config(state.model, remat_decoder_step=True,
                   decoder_remat_policy="full")
    seen = {}

    class Recorded:
        @staticmethod
        def update(model, opt_state, grads, names):
            seen.update(grads)
            tx.update(model, opt_state, grads, names)

    attention_tail.launches = 0
    dist.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    _, l, _ = train.train_step(
        state, batch, cfg=cfg, tx=Recorded, use_postnet=False,
        sigma_warmup_steps=cfg.guided_attention.sigma_warmup_steps)
    torch.cuda.synchronize()
    remat = {"step_ms": (time.perf_counter() - t1) * 1e3,
             "peak_bytes": torch.cuda.max_memory_allocated(),
             "tail_launches": attention_tail.launches,
             "losses": {k: float(v) for k, v in l._asdict().items()}}
    grads = whole_grads(state.model, seen)
    whole = gather_train_state(state)
    if rank == 0:
        torch.save({"grads": cpu_copy(grads),
                    "weights": cpu_copy(whole.model.state_dict())},
                   os.path.join(work, "remat.pt"))
    every = [None] * world
    dist.all_gather_object(every, state_digest(state))
    remat["digests"] = every
    out["remat"] = remat
    del state, whole, grads, seen

    # the same steps in fp32; the weights gathered, and this rank's shards
    state, cfg, tx = dp_state("float32", batch, dev, tensor_parallel=True)
    out["losses_fp32"], _, digests_fp32 = dp_steps(state, cfg, tx, batch,
                                                   True)
    whole = gather_train_state(state)
    torch.save({n: state.model.get_parameter(n).detach().cpu()
                for n in names}, os.path.join(work, f"shards{rank}.pt"))
    if rank == 0:
        torch.save(cpu_copy(whole.model.state_dict()),
                   os.path.join(work, "weights_float32.pt"))
    every = [None] * world
    dist.all_gather_object(every, {"bfloat16": digests,
                                   "float32": digests_fp32})
    out["digests"] = every
    out["libraries"] = sorted(str(_build.library_path(n))
                              for n in _build._loaded)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def tp_training(dev, root: str, tmp: str, reference) -> dict:
    """Phase 20 (a): ``TP`` ranks of one data index on the card against
    one process (phase 19's, ``reference``)."""
    from tacotron2_torch.parallel import tp_spec_for_name
    ref, lr, _ = reference
    init = os.path.join(tmp, "store")
    t1 = time.perf_counter()
    logs = run_ranks(
        [[sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
          str(TP), init, tmp] for r in range(TP)], root, tmp, "tp train")
    ranks_s = time.perf_counter() - t1
    outs = []
    for r in range(TP):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    for o, log in zip(outs, logs):
        said = [ln for ln in log.splitlines() if ln.startswith("[distributed]")]
        print(f"[tp rank {o['rank']}] backend {o['backend']} on {o['device']};"
              f" kernels loaded from the parent's build: "
              f"{[os.path.basename(p) for p in o['libraries']]}; shards "
              f"{o['shard_shapes']}; " + " | ".join(said), flush=True)
        check(o["backend"] == "gloo" and o["device"] == "cuda:0",
              f"tp rank {o['rank']}: backend {o['backend']} on {o['device']}")
        check(o["prebuilt"], f"tp rank {o['rank']}: kernels not prebuilt")
        check(len(o["shard_shapes"]) == 10, f"tp rank {o['rank']}: shards "
              f"{o['shard_shapes']}")

    for precision in ("bfloat16", "float32"):
        for i in range(DP_STEPS):
            got = {d[precision][i] for d in outs[0]["digests"]}
            print(f"[tp {precision}] after step {i + 1}: the {TP} ranks' "
                  "replicated weights, BatchNorm statistics, moments, "
                  "counters and generator "
                  f"{'bit for bit equal' if len(got) == 1 else 'DIFFER'}"
                  f" (sha256 {min(got)[:16]})", flush=True)
            check(len(got) == 1, f"phase 20: ranks differ after {precision} "
                  f"step {i + 1}")
    for o in outs:
        fwd, bwd, infer, tail = o["train_launches"]
        c = o["collectives"]
        print(f"[tp rank {o['rank']}] launches over {DP_STEPS} bf16 "
              f"train_steps: decoder_fwd_train_mega={fwd} "
              f"decoder_bwd_chain_mega={bwd} decoder_infer_mega={infer} "
              f"attention_tail={tail} ({o['t_dec']} a forward); eval_step "
              f"attention_tail={o['eval_tail_launches']} "
              f"({o['eval_tail_calls']} teacher-forced steps, each within "
              f"{o['eval_tail_err']:.2e} of the plain version, tol "
              f"{TAIL_TOL}), conv_bn_act={o['eval_conv_launches']}; "
              f"model-axis collectives (gloo) {c['n'] / DP_STEPS:.0f} and "
              f"{c['ms'] / DP_STEPS:.1f} ms a step; step wall ms "
              f"{[round(x, 1) for x in o['step_ms']]}", flush=True)
        check((fwd, bwd, infer, tail) == (0, 0, 0, DP_STEPS * o["t_dec"]),
              f"tp rank {o['rank']}: train launches {o['train_launches']}")
        check(o["eval_tail_launches"] == o["eval_tail_calls"] == o["t_dec"]
              and o["eval_tail_err"] <= TAIL_TOL,
              f"tp rank {o['rank']}: eval tail {o['eval_tail_launches']} "
              f"launches, {o['eval_tail_calls']} calls, err "
              f"{o['eval_tail_err']}")
        check(o["eval_conv_launches"] == 8,
              f"tp rank {o['rank']}: eval conv launches "
              f"{o['eval_conv_launches']}")
        check(o["counters"] == [DP_STEPS, DP_STEPS],
              f"counters {o['counters']}")
    check(outs[0]["eval"] == outs[1]["eval"],
          f"phase 20: the ranks' eval losses differ: {outs[0]['eval']} vs "
          f"{outs[1]['eval']}")

    # the gathered state against one process; the shards against the gather
    grads_tp = torch.load(os.path.join(tmp, "grads.pt"))
    check(set(grads_tp) == set(ref["grads"]), "the ranks' gathered gradients "
          "cover other parameters than one process's")
    errs = grad_errors(grads_tp, ref["grads"], 1e-2)
    worst = max(errs, key=errs.get)
    print(f"[tp] first step's gradients gathered from the {TP} ranks vs one "
          f"process at B=16 (bf16, the same masks): {len(errs)} tensors, "
          f"worst {worst} {errs[worst]:.2e} (limit {GRAD_TOL})", flush=True)
    check(errs[worst] <= GRAD_TOL, f"phase 20 gradients: {worst} "
          f"{errs[worst]}")
    weights = torch.load(os.path.join(tmp, "weights_float32.pt"))
    shards = [torch.load(os.path.join(tmp, f"shards{r}.pt"))
              for r in range(TP)]
    joined = all(torch.equal(
        torch.cat([sh[n] for sh in shards],
                  dim=tp_spec_for_name(n).index("model")), weights[n])
        for n in shards[0])
    print(f"[tp] the fp32 weights gathered by rank 0 are the {TP} ranks' "
          f"shards concatenated ({len(shards[0])} tensors): {joined}",
          flush=True)
    check(joined, "phase 20: gathered weights are not the shards joined")
    for precision, key in (("bfloat16", "losses"), ("float32", "losses_fp32")):
        losses_1, walls_1, before, after_1 = ref[precision]
        gap = max(abs(a[k] - b_[k]) / max(abs(b_[k]), 1e-6)
                  for a, b_ in zip(outs[0][key], losses_1) for k in b_)
        line = (f"[tp {precision}] losses of the {DP_STEPS} steps, rank 0 "
                f"{[round(x['total'], 5) for x in outs[0][key]]} vs one "
                f"process {[round(x['total'], 5) for x in losses_1]}: largest"
                f" relative gap over every term {gap:.2e} (limit {GRAD_TOL})")
        if precision == "float32":
            share, shares, zero_gap = weight_gap(before, after_1, weights)
            top = sorted(shares, key=shares.get)[-3:]
            line += (f"; gathered weights and BatchNorm statistics after step "
                     f"{DP_STEPS}: the gap summed over every element "
                     f"{share:.2e} of one process's update summed likewise, "
                     "largest by tensor " + ", ".join(
                         f"{n} {shares[n]:.2e}" for n in top)
                     + f" (limit {GRAD_TOL}); the zero-gradient biases "
                     f"{zero_gap:.2e} (limit {2 * lr * DP_STEPS:g})")
            check(max(shares.values()) <= GRAD_TOL,
                  f"phase 20 fp32 weights part by {max(shares.values())}")
            check(zero_gap <= 2 * lr * DP_STEPS, f"phase 20 biases: "
                  f"{zero_gap}")
        print(line, flush=True)
        check(gap <= GRAD_TOL, f"phase 20 {precision} losses part by {gap}")
    tp_remat_check(dev, tmp, outs)
    print(f"[tp] bf16 train_step wall, ms: 1 process at B=16 (decoder "
          f"kernels) {[round(x, 1) for x in ref['bfloat16'][1]]}; {TP} "
          "ranks of model=2 (step loop, gloo) " + "; ".join(
              f"rank {x['rank']} {[round(y, 1) for y in x['step_ms']]}"
              for x in outs) + f"; the ranks' {ranks_s:.1f} s with their "
          "start", flush=True)
    o = outs[0]
    fwd, bwd, infer, tail = o["train_launches"]
    return {"tail": tail + o["eval_tail_launches"],
            "conv": o["eval_conv_launches"], "fwd": fwd, "bwd": bwd,
            "infer": infer}


def tp_remat_check(dev, tmp: str, outs) -> None:
    """Phase 20 (a), the remat step: the ranks' replicated state bit for
    bit after it; their gathered gradients, losses and state against one
    process's remat step from the same seeded state and generator (phase
    19's rules); each rank's peak memory against its remat-off steps."""
    from tacotron2_torch.config import ModelConfig
    from tacotron2_torch.models.tacotron2 import replace_config
    from tacotron2_torch.train import step as train
    for o in outs:
        r = o["remat"]
        got = set(r["digests"])
        print(f"[tp remat] rank {o['rank']}: one bf16 train_step with remat "
              f"\"full\" {r['step_ms']:.1f} ms (remat off "
              f"{[round(x, 1) for x in o['step_ms']]}), attention_tail="
              f"{r['tail_launches']} ({o['t_dec']} a forward and as many in "
              f"the recompute), peak memory {r['peak_bytes'] / 1e9:.3f} GB "
              f"against {o['peak_bytes'] / 1e9:.3f} GB over the remat-off "
              f"steps; the {TP} ranks' replicated state after it "
              f"{'bit for bit equal' if len(got) == 1 else 'DIFFERS'} "
              f"(sha256 {min(got)[:16]})", flush=True)
        check(len(got) == 1, "phase 20: ranks differ after the remat step")
        check(r["tail_launches"] == 2 * o["t_dec"],
              f"phase 20 remat: attention_tail {r['tail_launches']}")
    batch = seeded_train_batch(ModelConfig())
    state, cfg, tx = dp_state("bfloat16", batch, dev)
    replace_config(state.model, remat_decoder_step=True,
                   decoder_remat_policy="full")
    before = cpu_copy(state.model.state_dict())
    seen = {}

    class Recorded:
        @staticmethod
        def update(model, opt_state, grads, names):
            seen.update(grads)
            tx.update(model, opt_state, grads, names)

    _, l, _ = train.train_step(
        state, batch, cfg=cfg, tx=Recorded, use_postnet=False,
        sigma_warmup_steps=cfg.guided_attention.sigma_warmup_steps)
    one = {k: float(v) for k, v in l._asdict().items()}
    grads_1, after_1 = cpu_copy(seen), cpu_copy(state.model.state_dict())
    del state, seen
    ranks = torch.load(os.path.join(tmp, "remat.pt"))
    errs = grad_errors(ranks["grads"], grads_1, 1e-2)
    worst = max(errs, key=errs.get)
    gap = max(abs(outs[0]["remat"]["losses"][k] - v) / max(abs(v), 1e-6)
              for k, v in one.items())
    share, shares, zero_gap = weight_gap(before, after_1, ranks["weights"])
    lr = cfg.train.learning_rate * max(1.0,
                                       cfg.train.attention_lr_multiplier)
    print(f"[tp remat] the {TP} ranks' gathered state against one process's "
          f"remat step (bf16, B=16): {len(errs)} gradients, worst {worst} "
          f"{errs[worst]:.2e}; losses, largest relative gap {gap:.2e}; "
          f"weights and BatchNorm statistics, the gap summed {share:.2e} of "
          f"one process's update, largest by tensor "
          f"{max(shares.values()):.2e}, the zero-gradient biases "
          f"{zero_gap:.2e} (limits {GRAD_TOL}, {2 * lr:g})", flush=True)
    check(set(errs) == set(ranks["grads"]) and errs[worst] <= GRAD_TOL
          and gap <= GRAD_TOL and max(shares.values()) <= GRAD_TOL
          and zero_gap <= 2 * lr,
          f"phase 20 remat: gradients {worst} {errs[worst]}, losses {gap}, "
          f"weights {max(shares.values())}, biases {zero_gap}")


def tp_cli(dev, root: str, tmp: str) -> None:
    """Phase 20 (b): ``train_torch.py --tp 2`` under torchrun, four ranks
    on the card (data 2 x model 2): two epochs unbroken, then the second
    again resumed from the first epoch's checkpoint, bit for bit; the
    checkpoint, written in the unsharded layout, loads in this process."""
    from tacotron2_torch.data.synth_corpus import write_corpus
    from tacotron2_torch.infer.synthesize import load_model
    from tacotron2_torch.utils.weight_files import load_file

    train_csv, val_csv = write_corpus(os.path.join(tmp, "corpus"), 32,
                                      seed=SEED, n_val=8, device=dev)
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", str(TP_CLI_PROCS), "train_torch.py"]
    flags = ["--batch_size", "2", "--epochs", "2", "--val_metadata", val_csv,
             "--tp", str(TP)]
    tp_line = (f"SPMD mesh: data={TP_CLI_PROCS // TP} x model={TP} (tensor "
               f"parallel), {TP_CLI_PROCS} processes, global micro-batch 8")
    for name, extra in (
            ("unbroken", []),
            ("resumed", ["--resume", os.path.join(tmp, "unbroken",
                                                  "tacotron2_epoch_1")])):
        t1 = time.perf_counter()
        log = run_ranks([torchrun + [train_csv, os.path.join(tmp, name)]
                         + flags + extra], root, tmp, f"tp cli {name}")[0]
        wall = time.perf_counter() - t1
        with open(os.path.join(tmp, name, "training_log.txt")) as f:
            written = f.read()
        said = sorted(re.findall(r"\[distributed\] initialized: rank "
                                 r"(\d+)/\d+, backend (\w+)", log))
        print(f"[tp cli] torchrun --standalone --nproc_per_node "
              f"{TP_CLI_PROCS} train_torch.py --tp {TP} {name}: exit 0 in "
              f"{wall:.1f} s; ranks and backends {said}; its log: "
              f"{written.count(tp_line)} x {tp_line!r}, "
              f"{written.count('complete. Avg Loss')} epoch lines, "
              f"{written.count('Validation |')} validations", flush=True)
        check(said == [(str(r), "gloo") for r in range(TP_CLI_PROCS)],
              f"tp cli {name}: {said}")
        check(written.count(tp_line) == 1, f"tp cli {name}: log "
              f"{written[-2000:]}")
        want = 2 if name == "unbroken" else 1
        check(written.count("complete. Avg Loss") == want
              and written.count("Validation |") == want,
              f"tp cli {name}: {written[-2000:]}")
    a = load_file(os.path.join(tmp, "unbroken", "tacotron2_epoch_2",
                               "train_state.pt"))
    b = load_file(os.path.join(tmp, "resumed", "tacotron2_epoch_2",
                               "train_state.pt"))
    same = {
        "weights and statistics": all(torch.equal(a["model"][k], b["model"][k])
                                      for k in a["model"]),
        "moments": all(torch.equal(a["opt_state"][m][k], b["opt_state"][m][k])
                       for m in ("mu", "nu") for k in a["opt_state"][m]),
        "counters": (a["step"], a["loss_step"], a["opt_state"]["count"])
        == (b["step"], b["loss_step"], b["opt_state"]["count"]),
        "generator": torch.equal(a["generator"], b["generator"])}
    model = load_model(os.path.join(tmp, "unbroken", "tacotron2_epoch_2"),
                       device=dev)
    loaded = all(torch.equal(t.cpu(), a["model"][k])
                 for k, t in model.state_dict().items())
    print(f"[tp cli] two epochs unbroken ({a['step']} steps) vs the second "
          f"resumed from the first's checkpoint, both on {TP_CLI_PROCS} "
          f"ranks of data {TP_CLI_PROCS // TP} x model {TP}, bit for bit: "
          f"{same}; the checkpoint (unsharded layout, "
          f"{tuple(a['model']['decoder.attention_lstm.weight_ih'].shape)} "
          f"attention-LSTM weights) loaded by load_model in one process, "
          f"equal: {loaded}", flush=True)
    check(all(same.values()) and a["step"] == 6, f"tp cli resumed run "
          f"differs: {same}, {a['step']} steps")
    check(loaded, "tp cli: load_model's weights differ from the checkpoint")


def tp_serving(dev) -> dict:
    """Phase 20 (c): ``ShardedSynthesizer(tensor_parallel=True)`` on
    ``r4_synth_bf16`` (fp32) and the four smoke sentences, over a 1x2 and a
    2x2 grid of ``cuda:0``: frame ends equal to the unsharded
    synthesizer's, each data shard's decode against the unsharded model's
    step loop on the same rows (phase 19's sharded limits), the tail on
    every decode step, the conv kernel on eight layers a data shard, the
    decode kernel never.  Returns the launches of both layouts."""
    from tacotron2_torch.config import Config
    from tacotron2_torch.infer import ShardedSynthesizer
    from tacotron2_torch.infer.fused import synthesize_wav
    from tacotron2_torch.infer.synthesize import load_model
    from tacotron2_torch.models.decoder import decoder_infer, decoder_infer_steps
    from tacotron2_torch.ops.attention_kernel import attention_tail
    from tacotron2_torch.ops.convbn_kernel import conv_bn_act
    from tacotron2_torch.ops.decoder_megakernel import decoder_infer_mega
    from tacotron2_torch.parallel import make_mesh
    from tacotron2_torch.text import pad_sequences, text_to_sequence

    model = load_model(TRAINED_CKPT, device=dev)
    hop = Config().audio.hop_length
    texts = list(SMOKE_TEXTS)
    n = len(texts)
    tokens, lengths = pad_sequences([text_to_sequence(t) for t in texts],
                                    pad_multiple=16)
    unsharded = synthesize_wav(model, texts, max_steps=TRAINED_MAX_STEPS,
                               gl_iters=DP_GL_ITERS, device=dev)
    ends_1 = [len(w) // hop for w in unsharded]
    launches = {"attention_tail": 0, "conv_bn_act": 0,
                "decoder_infer_mega": 0}
    for n_data in (1, 2):
        mesh = make_mesh(n_data, TP, ["cuda:0"] * (n_data * TP))
        with ShardedSynthesizer(model, mesh, gl_iters=DP_GL_ITERS,
                                tensor_parallel=True) as synth:
            for kernel in (attention_tail, conv_bn_act, decoder_infer_mega):
                kernel.launches = 0
            wavs = synth(texts, max_steps=TRAINED_MAX_STEPS)
            got = {k.__name__: k.launches for k in
                   (attention_tail, conv_bn_act, decoder_infer_mega)}
            for k, v in got.items():
                launches[k] += v
            ends = [len(w) // hop for w in wavs]
            per = n // n_data
            want_tail = sum(max(ends[d * per:(d + 1) * per]) + 1
                            for d in range(n_data))
            err = max(float(np.abs(w - r).max()) for w, r in
                      zip(wavs, unsharded))
            walls = {"unsharded": [], "sharded": []}
            for name in ("unsharded", "sharded", "sharded", "unsharded"):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                if name == "sharded":
                    synth(texts, max_steps=TRAINED_MAX_STEPS)
                else:
                    synthesize_wav(model, texts, max_steps=TRAINED_MAX_STEPS,
                                   gl_iters=DP_GL_ITERS, device=dev)
                walls[name].append((time.perf_counter() - t1) * 1e3)
            # each data shard's decode (its replica: shards, step loop)
            # against the unsharded model's step loop on the same rows
            errs = {k: 0.0 for k in DEC_OUTPUTS}
            stops = []
            for d, replica in enumerate(synth.replicas):
                rows = slice(d * per, (d + 1) * per)
                k_out = trained_decode(replica, decoder_infer, tokens[rows],
                                       lengths[rows], dev)
                p_out = trained_decode(model, decoder_infer_steps,
                                       tokens[rows], lengths[rows], dev)
                stops.append((k_out[4].tolist(), p_out[4].tolist()))
                check(k_out[4].tolist() == p_out[4].tolist(),
                      f"tp shard {d}: frame ends {stops[-1]}")
                end = int(p_out[4].max())
                tol = {"mels": DP_DEC_CAP, "gates": DP_DEC_CAP,
                       "aligns": DEC_ALIGN_SHARE[torch.float32] * float(
                           p_out[2][:, :end].abs().mean())}
                for name, g_, r_ in zip(DEC_OUTPUTS, k_out[:3], p_out[:3]):
                    e = float((g_[:, :end] - r_[:, :end]).abs().max())
                    errs[name] = max(errs[name], e)
                    check(e <= tol[name], f"tp shard {d}: decode {name} "
                          f"error {e} > {tol[name]}")
        print(f"[tp sharded {n_data}x{TP}] ShardedSynthesizer("
              f"tensor_parallel=True) over {n_data * TP} x cuda:0 (fp32 "
              f"r4_synth_bf16, {DP_GL_ITERS} Griffin-Lim rounds): frame ends "
              f"{ends} vs unsharded {ends_1}; wav max err {err:.2e} (not "
              f"held: the unsharded path decodes by the kernel); each data "
              f"shard's decode vs the unsharded step loop on its rows: ends "
              f"{stops}, " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f" (tol mels/gates {DP_DEC_CAP:g}, aligns "
              f"{DEC_ALIGN_SHARE[torch.float32]:g} of their mean); launches "
              f"{got} (attention_tail expected {want_tail}: every decode "
              f"step); wall ms sharded {[round(x, 1) for x in walls['sharded']]}"
              f", unsharded {[round(x, 1) for x in walls['unsharded']]} (one "
              f"card)", flush=True)
        check(ends == ends_1, f"tp sharded frame ends {ends} vs {ends_1}")
        check(got == {"attention_tail": want_tail, "conv_bn_act": 8 * n_data,
                      "decoder_infer_mega": 0}, f"tp sharded launches {got}")
    return launches


def tensor_parallel_phase(dev, smi: str, reference) -> dict:
    """Phase 20.  Returns each kernel's launches on the tensor-parallel
    training path (``tp_path_launches``, each rank's: the train steps'
    forwards and an ``eval_step``) and serving path
    (``tp_sharded_path_launches``)."""
    import shutil
    root = os.path.dirname(os.path.abspath(__file__))
    phase0 = time.perf_counter()
    tmp = tempfile.mkdtemp()
    try:
        for sub in ("train", "cli"):
            os.makedirs(os.path.join(tmp, sub))
        train_out = tp_training(dev, root, os.path.join(tmp, "train"),
                                reference)
        torch.cuda.empty_cache()
        tp_cli(dev, root, os.path.join(tmp, "cli"))
        sharded = tp_serving(dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[tp] phase 20 wall {time.perf_counter() - phase0:.1f} s ({smi})",
          flush=True)
    return {"attention_tail": {"tp_path_launches": train_out["tail"],
                               "tp_sharded_path_launches":
                                   sharded["attention_tail"]},
            "conv_bn_act": {"tp_path_launches": train_out["conv"],
                            "tp_sharded_path_launches":
                                sharded["conv_bn_act"]},
            "decoder_infer_mega": {"tp_path_launches": train_out["infer"],
                                   "tp_sharded_path_launches":
                                       sharded["decoder_infer_mega"]},
            "decoder_fwd_train_mega": {"tp_path_launches": train_out["fwd"]},
            "decoder_bwd_chain_mega": {"tp_path_launches": train_out["bwd"]}}


# phase 21: the neural letter-to-sound trainer on the card
LTS_EPOCHS = 2
LTS_BATCH = 512
LTS_LOSS_TOL = 1e-5     # first step's loss, card vs CPU fp32, relative
LTS_GRAD_TOL = 1e-4     # its gradients, by grad_errors' rule (floor 1e-3)
LTS_PROFILE_STEPS = 10
LTS_WORDS = ("tacotron", "hello", "quokka", "zyxel")


def lts_phase(dev, smi: str) -> None:
    """Phase 21.  ``tools/train_lts_neural_torch.py`` at full width on the
    whole training split: the first step from seeded weights at dropout 0
    on the card against the CPU in plain fp32 (TF32 off: the loss and
    every gradient leaf), ``LTS_EPOCHS`` epochs at the default dropout and
    smoothing through the CLI's ``main`` (finite, falling loss), ms a step
    and the device's busy share over ``LTS_PROFILE_STEPS`` steps, the
    held-out greedy word accuracy beside the committed
    ``tacotron2_tpu/text/data/lts_neural.npz``'s under the same greedy,
    and the exported file loaded back through ``text/lts_neural.py``."""
    import importlib.util
    import shutil
    from tacotron2_torch.text.lts_neural import NeuralLts
    root = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "train_lts_neural_torch",
        os.path.join(root, "tools", "train_lts_neural_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    phase0 = time.perf_counter()
    letters, targets, symbols, rows, hold = tool.build_data()
    n, v = len(letters), len(symbols)
    print(f"[lts] {n} training words, {len(hold)} held out, {v} phone "
          f"symbols", flush=True)
    check((n, len(hold), v) == (103953, 11578, 72), "phase 21: the data")

    # 1. the first step: card vs CPU, fp32, dropout 0
    idx = np.random.default_rng(SEED).permutation(n)[:LTS_BATCH]
    grads, losses = {}, {}
    for where in (dev, "cpu"):
        p = tool.init_params(SEED, v, where)
        for x in p.values():
            x.requires_grad_(True)
        loss = tool.loss_fn(p, torch.from_numpy(letters[idx]).long().to(where),
                            torch.from_numpy(targets[idx]).long().to(where),
                            None, 0.1)
        g = torch.autograd.grad(loss, list(p.values()))
        losses[str(where)] = float(loss.detach())
        grads[str(where)] = {k: x.cpu() for k, x in zip(p, g)}
    errs = grad_errors(grads[str(dev)], grads["cpu"], 1e-3)
    worst = max(errs, key=errs.get)
    gap = abs(losses[str(dev)] / losses["cpu"] - 1)
    print(f"[lts] first step B={LTS_BATCH}, seeded weights, dropout 0, "
          f"smoothing 0.1: loss card {losses[str(dev)]:.6f} vs CPU "
          f"{losses['cpu']:.6f} ({gap:.1e}, limit {LTS_LOSS_TOL:g}); "
          f"{len(errs)} gradient leaves, worst {worst} {errs[worst]:.2e} "
          f"(limit {LTS_GRAD_TOL:g})", flush=True)
    check(gap <= LTS_LOSS_TOL and errs[worst] <= LTS_GRAD_TOL,
          f"phase 21: first step, loss {gap}, {worst} {errs[worst]}")

    # 2. the device's busy share of a step, at the defaults
    p = tool.init_params(SEED, v, dev)
    opt = tool.Adam(p, tool.warmup_cosine(2e-3, 1000))
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    lb = torch.from_numpy(letters[idx]).long().to(dev)
    tb = torch.from_numpy(targets[idx]).long().to(dev)

    def steps():
        for _ in range(LTS_PROFILE_STEPS):
            masks = tool.dropout_masks(gen, 0.25, tb.shape[1], LTS_BATCH, dev)
            tool.train_step(p, opt, lb, tb, masks, 0.1)

    steps()
    _, wall, by_kernel, busy = profile_step(steps)
    print(f"[lts] {LTS_PROFILE_STEPS} train steps at B={LTS_BATCH}: wall "
          f"{wall / LTS_PROFILE_STEPS:.2f} ms, device busy "
          f"{busy / LTS_PROFILE_STEPS:.2f} ms a step ({busy / wall:.1%}), "
          f"{len(by_kernel)} kernels by name", flush=True)
    del p, opt

    # 3. two epochs through the CLI, on the whole training split
    tmp = tempfile.mkdtemp(prefix="t2_lts_")
    try:
        out = os.path.join(tmp, "lts_neural.npz")
        run = tool.main(["--epochs", str(LTS_EPOCHS), "--eval-every",
                         str(LTS_EPOCHS), "--out", out, "--device", "cuda"])
        loss = run["losses"]
        print(f"[lts] train_lts_neural_torch.py --epochs {LTS_EPOCHS}: "
              f"{run['steps']} steps in {run['seconds']:.1f} s, "
              f"{run['seconds'] * 1e3 / run['steps']:.2f} ms a step, epoch "
              f"losses {[round(x, 4) for x in loss]}, held-out greedy word "
              f"accuracy {run['heldout_acc'][0]:.4f} (stress-blind "
              f"{run['heldout_acc'][1]:.4f}) ({smi})", flush=True)
        check(all(np.isfinite(loss)) and loss[-1] < loss[0],
              f"phase 21: epoch losses {loss}")
        # the committed artifact under the same greedy, the same words
        z = np.load(os.path.join(root, "tacotron2_tpu", "text", "data",
                                 "lts_neural.npz"))
        committed = tool.params_from_numpy(
            {k: z[k] for k in z.files if k != "phone_symbols"}, dev)
        hl, truths = tool.heldout_batch(hold, 1500)
        acc = tool.word_accuracy(
            tool.greedy(committed, torch.from_numpy(hl).long().to(dev))
            .cpu().numpy(), truths, [str(s) for s in z["phone_symbols"]])
        print(f"[lts] the committed lts_neural.npz, same greedy, same "
              f"{len(truths)} held-out words: {acc[0]:.4f} (stress-blind "
              f"{acc[1]:.4f})", flush=True)
        # 4. the export, read back by the text frontend's module
        model = NeuralLts(out)
        said = {w: " ".join(model.pronounce(w) or ["-"]) for w in LTS_WORDS}
        print(f"[lts] exported {os.path.getsize(out) / 1e6:.1f} MB, read by "
              f"text/lts_neural.py: {said}", flush=True)
        check(model.phone_symbols == symbols and all(
            model.pronounce(w) for w in LTS_WORDS),
              "phase 21: the export did not load")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[lts] phase 21 wall {time.perf_counter() - phase0:.1f} s ({smi})",
          flush=True)


# phase 22: the measurement and serving tools of tools/, at the batch sizes
# the JAX package's tools run (decode to B=64, train at B=128)
TOOLS_MEGA_BATCHES = (1, 8, 64)
TOOLS_ITERS = 2         # timed calls a point (the tools' default is 5)
# timed steps a point of the training sweep: one (cut from two for phase
# 23's time; phase 23 measures the same routes at the same B alone)
TOOLS_TRAIN_ITERS = 1
TOOLS_TRAIN_BATCHES = "16,128"
TOOLS_SHARDED_B = 8     # two replicas on cuda:0
TOOLS_HELD_B = 64       # the decode held against the step loop
TOOLS_HELD_STOP = 1000
TOOLS_TRAIN_HELD_B = 128
TOOLS_VAL_COUNT = 48    # phase 18's split, exported again


def first_call(fn, keep):
    """A stand-in for the wrapper ``fn`` that records the first call whose
    arguments ``keep`` accepts: its arguments (tensors detached) and its
    outputs."""
    seen = {}

    def recording(*args):
        out = fn(*args)
        if "args" not in seen and keep(args):
            seen["args"] = tuple(x.detach() if torch.is_tensor(x) else x
                                 for x in args)
            seen["out"] = out
        return out
    # a wrapper that stands in its module's name counts its launches here
    recording.launches = fn.launches
    return recording, seen


def tools_phase(dev, smi: str, processed: str) -> dict:
    """Phase 22.  The tools of ``tools/`` at full ``ModelConfig()`` width,
    with the launch counters zeroed before and read after: (a)
    ``bench_infer_scaling_torch`` ``--sweep mega --bf16`` at B in
    ``TOOLS_MEGA_BATCHES`` to stops of 300 and 1000 frames; (b) ``--sweep
    sharded`` over two replicas on this card at B=8 and ``--sweep
    buckets``; (c) ``bench_train_scaling_torch`` at B=16 and 128, split
    BPTT on and off (a ``FAILED`` line fails the phase), the first B=128
    split step's calls of #3 and #4 recorded; (d)
    ``profile_train_step_torch`` at B=128 with the split.  Then each kernel
    against its plain version on one call's real inputs: #2 on the mega
    sweep's call at B=64 to 1000 frames (``DEC_TOL``, frame_ends equal),
    #1 on every step of the same call by the step loop (``TAIL_TOL``), #5
    on that request's eight layers (``CONV_TOL``), #3 and #4 on the
    recorded B=128 step by phase 10's rule (#3 to ``MAIN_PAIR_TOL``; #4 to
    the larger of it and twice the plain version's own spread, run on the
    CPU against the card, on these inputs).  Then (e)
    ``verify_ngc_checkpoint_torch`` on a seeded weight-normed generator
    file in NGC's layout and (f) ``export_reference_corpus_torch`` on phase
    18's processed corpus (``processed``), one item read back.  Returns
    the kernels-line additions by kernel name."""
    from tacotron2_torch.config import Config
    from tacotron2_torch.models import hifigan as hg
    from tacotron2_torch.models.tacotron2 import replace_config
    from tacotron2_torch.ops import attention_kernel as ak
    from tacotron2_torch.ops import decoder_bptt
    from tacotron2_torch.ops import decoder_megakernel as dm
    from tacotron2_torch.ops.convbn_kernel import conv_bn_act
    from tacotron2_torch.ops.decoder_bwd_kernel import (
        decoder_bwd_chain_mega, decoder_bwd_chain_reference)
    from tacotron2_torch.ops.decoder_train_kernel import (
        decoder_fwd_train_mega, decoder_fwd_train_reference)
    sys.path.insert(0, os.path.join(R5_ROOT, "tools"))
    try:
        import bench_infer_scaling_torch as infer_tool
        import bench_train_scaling_torch as train_tool
        import export_reference_corpus_torch as export_tool
        import profile_train_step_torch as profile_tool
        import verify_ngc_checkpoint_torch as ngc_tool
    finally:
        sys.path.pop(0)

    phase0 = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = Config()
    lines = []

    def log(msg: str) -> None:
        lines.append(msg)
        print(f"[tools] {msg.strip()}", flush=True)

    kernels = (ak.attention_tail, dm.decoder_infer_mega,
               decoder_fwd_train_mega, decoder_bwd_chain_mega, conv_bn_act)
    for k in kernels:
        k.launches = 0

    # (a) the mega sweep, bf16
    model16 = infer_tool.seeded_model(True, dev)
    t1 = time.perf_counter()
    mega = infer_tool.sweep_mega(model16, dev, TOOLS_MEGA_BATCHES,
                                 iters=TOOLS_ITERS, log=log)
    print(f"[tools] (a) --sweep mega --bf16 --batches "
          f"{' '.join(map(str, TOOLS_MEGA_BATCHES))} --iters {TOOLS_ITERS}: "
          f"{time.perf_counter() - t1:.1f} s ({smi})", flush=True)
    check(len(mega) == 4 * len(TOOLS_MEGA_BATCHES) and all(
        r["frame_ends"] == [r["stop"]] * r["b"] for r in mega),
          f"phase 22 mega sweep: {[r['frame_ends'][:2] for r in mega]}")
    # (b) the sharded and bucketed sweeps, fp32
    model32 = infer_tool.seeded_model(False, dev)
    t1 = time.perf_counter()
    infer_tool.sweep_sharded(model32, cfg, [dev, dev], [TOOLS_SHARDED_B],
                             iters=TOOLS_ITERS, n_data=2, log=log)
    bucket = infer_tool.sweep_buckets(model32, cfg, dev, TOOLS_ITERS,
                                      log=log)
    check(bucket["frames"] == 300, f"phase 22 buckets: {bucket}")
    print(f"[tools] (b) --sweep sharded --n_data 2 --batches "
          f"{TOOLS_SHARDED_B} and --sweep buckets: "
          f"{time.perf_counter() - t1:.1f} s ({smi})", flush=True)
    del model32
    # (c) the training sweep, the first B=128 split step's kernels recorded
    fwd, fwd_seen = first_call(decoder_fwd_train_mega, lambda a: (
        a[3].shape[0] == TOOLS_TRAIN_HELD_B))
    bwd, bwd_seen = first_call(decoder_bwd_chain_mega, lambda a: (
        a[2].shape[0] == TOOLS_TRAIN_HELD_B))
    decoder_bptt.decoder_fwd_train_mega = fwd
    decoder_bptt.decoder_bwd_chain_mega = bwd
    t1 = time.perf_counter()
    try:
        train = train_tool.main([TOOLS_TRAIN_BATCHES, "--iters",
                                 str(TOOLS_TRAIN_ITERS), "--device",
                                 str(dev)], log=log)
    finally:
        decoder_bptt.decoder_fwd_train_mega = decoder_fwd_train_mega
        decoder_bptt.decoder_bwd_chain_mega = decoder_bwd_chain_mega
    print(f"[tools] (c) bench_train_scaling_torch {TOOLS_TRAIN_BATCHES} "
          f"--iters {TOOLS_TRAIN_ITERS}: {time.perf_counter() - t1:.1f} s "
          f"({smi})", flush=True)
    failed = [ln for ln in lines if "FAILED" in ln]
    check(not failed, f"phase 22 training sweep: {failed}")
    check(len(train) == 2 * len(TOOLS_TRAIN_BATCHES.split(",")) and all(
        np.isfinite(r["last_loss"])
                                  for r in train),
          f"phase 22 training sweep: {train}")
    # (d) the profile of one B=128 step
    t1 = time.perf_counter()
    prof = profile_tool.profile_train_step(TOOLS_TRAIN_HELD_B, dev,
                                           split=True)
    profile_tool.print_report(prof, 10, log=log)
    print(f"[tools] (d) profile_train_step_torch --batch "
          f"{TOOLS_TRAIN_HELD_B} --split 1: {time.perf_counter() - t1:.1f} "
          f"s ({smi})", flush=True)
    check(prof["launches"]["decoder_fwd_train_mega"] == 1
          and prof["launches"]["decoder_bwd_chain_mega"] == 1
          and prof["busy_ms"] > 0, f"phase 22 profile: {prof['launches']}")
    launches = {k.__name__: k.launches for k in kernels}
    print(f"[tools] launches over (a)-(d): {launches}", flush=True)
    check(all(n > 0 for n in launches.values()),
          f"phase 22: a kernel of the tools did not launch: {launches}")

    # each kernel against its plain version on one call's real inputs:
    # the mega sweep's call at B=64 to 1000 frames, by the decode kernel
    # (#2, then #5 on its layers) and by the step loop (#1 on every step)
    tokens, lengths = infer_tool.mega_tokens(np.random.default_rng(SEED),
                                             TOOLS_HELD_B, 128)
    where = f"tools mega B={TOOLS_HELD_B} stop={TOOLS_HELD_STOP} bf16"
    rec, dec_seen = first_call(dm.decoder_infer_mega, lambda a: True)
    dm.decoder_infer_mega = rec
    try:
        replace_config(model16, decoder_megakernel=True)
        out, _, _ = infer_tool.mega_run(model16, tokens, lengths,
                                        TOOLS_HELD_STOP, dev)
    finally:
        dm.decoder_infer_mega = kernels[1]
    with torch.no_grad():
        ref = dm.decoder_infer_mega_reference(*dec_seen["args"])
    dec_errs = compare_decode(dec_seen["out"], ref, torch.bfloat16,
                              f"{where} decode kernel")
    del ref
    shares, conv_errs = model_conv_layers(
        model16, torch.from_numpy(tokens).long().to(dev), out.mel_coarse)
    print(f"[{where} conv_bn_act] the eight layers of the request: kernel "
          f"vs plain {', '.join(f'{x:.2e}' for x in shares)} of the mean "
          f"size (limit {CONV_TOL[torch.bfloat16]:g}), largest "
          f"{max(conv_errs):.2e} absolute", flush=True)
    check(max(shares) <= CONV_TOL[torch.bfloat16],
          f"phase 22 conv_bn_act {shares}")
    launch_tail = ak._forward
    tail_errs = []

    def checked_tail(*ins):
        got = launch_tail(*ins)
        tail_errs.append(max_err(got, ak.attention_tail_reference(*ins)))
        return got

    ak._forward = checked_tail
    try:
        replace_config(model16, decoder_megakernel=False)
        infer_tool.mega_run(model16, tokens, lengths, TOOLS_HELD_STOP, dev)
    finally:
        ak._forward = launch_tail
        replace_config(model16, decoder_megakernel=True)
    tail_err = max(tail_errs)
    print(f"[{where} attention_tail] the step loop's {len(tail_errs)} "
          f"steps: kernel vs plain max err {tail_err:.3e} (tol {TAIL_TOL})",
          flush=True)
    check(len(tail_errs) == TOOLS_HELD_STOP + 1 and tail_err <= TAIL_TOL,
          f"phase 22 attention_tail: {len(tail_errs)} steps, {tail_err}")
    del model16, out

    # the training pair on the first B=128 split step of (c)
    check("args" in fwd_seen and "args" in bwd_seen,
          "phase 22: no B=128 call of the training pair was recorded")
    where = f"tools train B={TOOLS_TRAIN_HELD_B} T_enc=128 T_dec=512 bf16"
    fwd_errs = compare_outputs(
        FWD_OUT, fwd_seen["out"], decoder_fwd_train_reference(
            *fwd_seen["args"]), MAIN_PAIR_TOL,
        f"{where} decoder_fwd_train_mega")
    del fwd_seen["out"]
    # On the tools' batches (full-length random tokens, B=16 as B=128) the
    # plain version run on the CPU misses MAIN_PAIR_TOL's d_qsum_s and
    # d_pq_s limits (read on phase 10's batch) against itself run on the
    # card, by as much as the kernel (PERF.md): each output is held
    # to the larger of its limit and twice that spread on these inputs.
    bwd_ref = decoder_bwd_chain_reference(*bwd_seen["args"])
    t1 = time.perf_counter()
    bwd_cpu = decoder_bwd_chain_reference(*(
        cpu_copy(x) if isinstance(x, dict) else
        x.cpu() if torch.is_tensor(x) else x for x in bwd_seen["args"]))
    spread = {n: pair_share(n, c.to(dev), r)[0]
              for n, c, r in zip(BWD_OUT, bwd_cpu, bwd_ref)}
    bwd_tol = {n: max(MAIN_PAIR_TOL[n], 2 * spread[n]) for n in BWD_OUT}
    print(f"[{where} decoder_bwd_chain_mega] the plain version on the CPU "
          f"({time.perf_counter() - t1:.1f} s) against itself on the card, "
          f"as a share of the mean size: " + ", ".join(
              f"{n} {spread[n]:.2e} (MAIN_PAIR_TOL {MAIN_PAIR_TOL[n]:g})"
              for n in BWD_OUT), flush=True)
    bwd_errs = compare_outputs(BWD_OUT, bwd_seen["out"], bwd_ref, bwd_tol,
                               f"{where} decoder_bwd_chain_mega")
    del fwd_seen, bwd_seen, bwd_ref, bwd_cpu
    torch.cuda.empty_cache()

    # (e) the NGC check on a seeded generator file, (f) the export
    tmp = tempfile.TemporaryDirectory()
    try:
        path = os.path.join(tmp.name, "hifigan_gen_seeded.pt")
        torch.save({"generator": hg.nvidia_state_dict(hg.hifigan_init(
            seed=SEED))}, path)
        report = ngc_tool.verify(path, device=dev)
        print(f"[tools] (e) verify_ngc_checkpoint_torch on a seeded "
              f"weight-normed file: ok {report['ok']}, layout "
              f"{report['layout']}, {report['n_keys']} keys, "
              f"{report['n_params']} parameters, manifest problems "
              f"{report['manifest_problems']}, forward "
              f"{report['forward']}, parity {report['torch_parity']}, "
              f"sha256 {report['sha256'][:16]}...", flush=True)
        check(report["ok"] and report["layout"] == "weight_normed"
              and not report["manifest_problems"],
              f"phase 22 NGC check: {report}")
        out_dir = os.path.join(tmp.name, "reference_corpus")
        n = export_tool.export(processed, out_dir, TOOLS_VAL_COUNT,
                               device=dev)
        with open(os.path.join(out_dir, "metadata_val.csv")) as f:
            val_rows = list(csv.DictReader(f))
        with open(os.path.join(out_dir, "metadata_train.csv")) as f:
            n_train = sum(1 for _ in csv.DictReader(f))
        base = os.path.basename(val_rows[0]["filepath"]).rsplit(".", 1)[0]
        mel = torch.load(os.path.join(out_dir, "mels", f"{base}.pt"))
        seq = torch.load(os.path.join(out_dir, "text", f"{base}.pt"))
        want_mel = np.load(os.path.join(processed, "mels", f"{base}.npy"))
        want_seq = np.load(os.path.join(processed, "text", f"{base}.npy"))
        print(f"[tools] (f) export_reference_corpus_torch: {n} items, "
              f"train/val {n_train}/{len(val_rows)}; {base}: mel "
              f"{tuple(mel.shape)} {mel.dtype}, text {tuple(seq.shape)} "
              f"{seq.dtype}, equal to the processed caches", flush=True)
        check(n == n_train + len(val_rows) and len(val_rows) == TOOLS_VAL_COUNT
              and mel.dtype == torch.float32 and seq.dtype == torch.int64
              and np.array_equal(mel.numpy(), want_mel)
              and np.array_equal(seq.numpy(), want_seq),
              f"phase 22 export: {base}")
    finally:
        tmp.cleanup()
    print(f"[tools] phase 22 wall {time.perf_counter() - phase0:.1f} s "
          f"({smi})", flush=True)
    errs = dict(attention_tail=tail_err,
                decoder_infer_mega=max(dec_errs.values()),
                decoder_fwd_train_mega=max(fwd_errs.values()),
                decoder_bwd_chain_mega=max(bwd_errs.values()),
                conv_bn_act=max(conv_errs))
    return {name: dict(tools_path_launches=n,
                       tools_path_max_abs_err=errs[name])
            for name, n in launches.items()}


# phase 23: decoder-step rematerialisation on the step-loop training path
REMAT_BATCHES = (16, 128)
REMAT_ROUTE = dict(decoder_split_bptt=True, remat_decoder_step=False,
                   decoder_remat_policy="full")
REMAT_VARIANTS = {
    "split": {},                                   # the default route
    "loop": dict(decoder_split_bptt=False),        # autograd, no remat
    "full": dict(remat_decoder_step=True, decoder_remat_policy="full"),
    "dots": dict(remat_decoder_step=True, decoder_remat_policy="dots"),
}


def state_snapshot(state):
    """Every tensor and counter a ``train_step`` changes, cloned."""
    opt = state.opt_state
    return ({n: t.clone() for n, t in state.model.state_dict().items()},
            {m: {n: t.clone() for n, t in opt[m].items()}
             for m in ("mu", "nu")},
            (opt["count"], state.step, state.loss_step),
            state.generator.get_state())


@torch.no_grad()
def state_restore(state, snap) -> None:
    weights, moments, (count, step, loss_step), gen = snap
    for n, t in state.model.state_dict().items():
        t.copy_(weights[n])
    for m, ts in moments.items():
        for n, t in ts.items():
            state.opt_state[m][n].copy_(t)
    state.opt_state["count"], state.step, state.loss_step = (count, step,
                                                             loss_step)
    state.generator.set_state(gen)


def remat_measure(work: str, device: str = "cuda") -> int:
    """Phase 23's measurements, run by the phase as ``chip_smoke.py
    --remat-phase WORK_DIR`` in a fresh process: ``torch.profiler`` leaves
    the CUDA tracer on in the process that used it (earlier phases do),
    and every launch after it pays for that.  One bf16 ``train_step`` at
    full ``ModelConfig()`` width, T_enc=128, T_dec=512, at B in
    ``REMAT_BATCHES`` (the main path's seeded ragged batch, widened), in
    each of ``REMAT_VARIANTS``, every one from the same seeded state
    (restored before each step: the same weights and dropout masks), with
    cuDNN held to its deterministic algorithms so that only the route
    differs.  First one unmeasured step by the loop at the largest B (the
    allocator's pool grown to the phase's largest), then each variant's
    step alone: its wall, peak ``max_memory_allocated`` after
    ``reset_peak_memory_stats`` and what was held before it, the launch
    counters zeroed before and read after; ``full`` and ``dots`` held to
    ``loop``: the losses and every gradient handed to the optimizer, bit
    for bit, or within ``GRAD_TOL`` with the gap printed.  Then, all
    measured, each variant's step again under ``torch.profiler``: device
    busy ms (the union of the kernels' intervals); in ``full``'s every
    tail call's outputs kept (each step's recompute must return its
    forward's bits, the first call held to the plain version,
    ``TAIL_TOL``); in ``dots``' the ops the policy saves counted by name.
    Writes ``WORK_DIR/remat.json``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tacotron2_torch.config import ModelConfig
    from tacotron2_torch.models import decoder as decoder_mod
    from tacotron2_torch.models.tacotron2 import replace_config
    from tacotron2_torch.ops import _build
    from tacotron2_torch.ops import attention_kernel as ak
    from tacotron2_torch.ops.decoder_bwd_kernel import decoder_bwd_chain_mega
    from tacotron2_torch.ops.decoder_train_kernel import decoder_fwd_train_mega
    from tacotron2_torch.train import step as train

    prebuilt = all(_build.library_path(n).exists()
                   for n in _build.CUDA_SOURCES)
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    kernels = {"attention_tail": ak.attention_tail,
               "decoder_fwd_train_mega": decoder_fwd_train_mega,
               "decoder_bwd_chain_mega": decoder_bwd_chain_mega}
    out = {"prebuilt": prebuilt, "rows": [], "tail_err": 0.0}

    def one_step(state, cfg, tx, batch, seen):
        """A ``train_step``; the gradients handed to the optimizer are
        kept in ``seen`` (the same tensors: Adam only reads them)."""
        class Recorded:
            @staticmethod
            def update(model, opt_state, grads, names):
                seen.update(grads)
                tx.update(model, opt_state, grads, names)

        _, losses, _ = train.train_step(
            state, batch, cfg=cfg, tx=Recorded, use_postnet=True,
            sigma_warmup_steps=cfg.guided_attention.sigma_warmup_steps)
        torch.cuda.synchronize()
        return {k: float(v) for k, v in losses._asdict().items()}

    runs = {}
    for b in REMAT_BATCHES:
        host_batch = seeded_train_batch(ModelConfig(), b)
        state, cfg, tx = dp_state("bfloat16", host_batch, dev)
        runs[b] = (state, cfg, tx, train._to_device(host_batch, dev),
                   state_snapshot(state))

    def route(b, name):
        state, cfg, tx, batch, snap = runs[b]
        replace_config(state.model, **{**REMAT_ROUTE, **REMAT_VARIANTS[name]})
        state_restore(state, snap)
        return state, dataclasses.replace(cfg, model=state.model.cfg), tx, \
            batch

    big = max(REMAT_BATCHES)
    t1 = time.perf_counter()
    one_step(*route(big, "loop"), {})
    out["warm_ms"] = (time.perf_counter() - t1) * 1e3

    rows = {}
    for b in sorted(REMAT_BATCHES, reverse=True):
        ref = None
        for name in REMAT_VARIANTS:
            state, cfg, tx, batch = route(b, name)
            t_dec = batch["mel"].shape[2]
            for k in kernels.values():
                k.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            grads = {}
            t1 = time.perf_counter()
            losses = one_step(state, cfg, tx, batch, grads)
            wall = (time.perf_counter() - t1) * 1e3
            peak = torch.cuda.max_memory_allocated()
            launches = {k: v.launches for k, v in kernels.items()}
            grads = cpu_copy(grads)
            row = rows[b, name] = dict(
                b=b, variant=name, t_dec=t_dec, wall_ms=wall,
                peak_bytes=peak, held_bytes=held, launches=launches,
                losses=losses)
            if name == "loop":
                ref = (losses, grads)
            elif name != "split":
                errs = grad_errors(grads, ref[1], 1e-2)
                worst = max(errs, key=errs.get)
                row.update(
                    same_losses=losses == ref[0],
                    same_grads=set(grads) == set(ref[1]) and all(
                        torch.equal(grads[n], g) for n, g in ref[1].items()),
                    same_names=set(grads) == set(ref[1]),
                    loss_gap=max(abs(losses[k] - v) / max(abs(v), 1e-6)
                                 for k, v in ref[0].items()),
                    worst=worst, grad_gap=errs[worst], n_grads=len(grads))
            del grads

    for b in sorted(REMAT_BATCHES, reverse=True):
        for name in REMAT_VARIANTS:
            state, cfg, tx, batch = route(b, name)
            row = rows[b, name]
            calls, saved, policy = [], {}, decoder_mod.dots_policy
            launch = ak._forward

            def kept(*ins):
                o = launch(*ins)
                if not calls:
                    calls.append(ins)
                calls.append(tuple(x.clone() for x in o))
                return o

            def counted(ctx, op, *args, **kwargs):
                choice = policy(ctx, op, *args, **kwargs)
                if not ctx.is_recompute:
                    key = f"{op} {choice.name}"
                    saved[key] = saved.get(key, 0) + 1
                return choice

            if name == "full":
                ak._forward = kept
            if name == "dots":
                decoder_mod.dots_policy = counted
            try:
                t1 = time.perf_counter()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    one_step(state, cfg, tx, batch, {})
                row["profiled_wall_ms"] = (time.perf_counter() - t1) * 1e3
            finally:
                ak._forward = launch
                decoder_mod.dots_policy = policy
            # the union of the kernels', copies' and memsets' intervals,
            # from the profiler's raw events (no names: a name is a copy)
            spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                           for e in prof.profiler.kineto_results.events()
                           if e.device_type() == DeviceType.CUDA)
            busy, end = 0, -1
            for s0, s1 in spans:
                if s1 > end:
                    busy += s1 - max(s0, end)
                    end = s1
            row["busy_ms"] = busy / 1e6
            del prof, spans
            if name == "full":
                ins, outs = calls[0], calls[1:]
                n = len(outs)
                row.update(
                    tail_calls=n, tail_same=all(
                        torch.equal(x, y) for t in range(n // 2)
                        for x, y in zip(outs[t], outs[n - 1 - t])),
                    tail_err=max_err(outs[0],
                                     ak.attention_tail_reference(*ins)))
                out["tail_err"] = max(out["tail_err"], row["tail_err"])
            if name == "dots":
                row["policy"] = dict(sorted(saved.items(),
                                            key=lambda x: -x[1])[:8])
            del calls
    out["rows"] = [rows[b, name] for b in REMAT_BATCHES
                   for name in REMAT_VARIANTS]
    with open(os.path.join(work, "remat.json"), "w") as f:
        json.dump(out, f)
    return 0


def remat_phase(dev, smi: str) -> dict:
    """Phase 23: ``remat_measure`` in a fresh process, its results printed
    and held here.  Returns the kernels-line additions."""
    import shutil
    root = os.path.dirname(os.path.abspath(__file__))
    phase0 = time.perf_counter()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp()
    try:
        run_ranks([[sys.executable, os.path.abspath(__file__),
                    "--remat-phase", tmp]], root, tmp, "remat")
        with open(os.path.join(tmp, "remat.json")) as f:
            out = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(out["prebuilt"], "phase 23: kernels not prebuilt")
    print(f"[remat] a fresh process (no profiler before its measured steps)"
          f"; one warm-up step by the loop at B={max(REMAT_BATCHES)} "
          f"{out['warm_ms']:.1f} ms", flush=True)
    launches = {}
    for row in out["rows"]:
        b, name, t_dec = row["b"], row["variant"], row["t_dec"]
        wall, busy, peak, held = (row["wall_ms"], row["busy_ms"],
                                  row["peak_bytes"], row["held_bytes"])
        print(f"[remat B={b} T_enc=128 T_dec={t_dec} bf16 {name}] "
              f"train_step wall {wall:.1f} ms, device busy {busy:.1f} ms "
              f"({busy / wall:.3f} of it; busy read in a second step under "
              f"the profiler, {row['profiled_wall_ms']:.1f} ms); peak memory "
              f"{peak / 1e9:.3f} GB ({(peak - held) / 1e9:.3f} GB over the "
              f"{held / 1e9:.3f} GB held before the step); launches "
              + " ".join(f"{k}={v}" for k, v in row["launches"].items())
              + f"; loss {row['losses']['total']:.6f} ({smi})", flush=True)
        check(all(np.isfinite(v) for v in row["losses"].values()),
              f"phase 23 {name} B={b}: losses {row['losses']}")
        want = ({"attention_tail": 0, "decoder_fwd_train_mega": 1,
                 "decoder_bwd_chain_mega": 1} if name == "split"
                else {"attention_tail": t_dec * (1 if name == "loop" else 2),
                      "decoder_fwd_train_mega": 0,
                      "decoder_bwd_chain_mega": 0})
        check(row["launches"] == want, f"phase 23 {name} B={b}: launches "
              f"{row['launches']}, expected {want}")
        launches[f"B={b} {name}"] = row["launches"]
        if name in ("full", "dots"):
            print(f"[remat B={b} {name} vs loop] losses bit for bit: "
                  f"{row['same_losses']} (largest relative gap "
                  f"{row['loss_gap']:.2e}); {row['n_grads']} gradients bit "
                  f"for bit: {row['same_grads']} (worst {row['worst']} "
                  f"{row['grad_gap']:.2e}, limit {GRAD_TOL})", flush=True)
            check(row["same_names"] and row["loss_gap"] <= GRAD_TOL
                  and row["grad_gap"] <= GRAD_TOL,
                  f"phase 23 {name} B={b}: against the loop, losses "
                  f"{row['loss_gap']}, {row['worst']} {row['grad_gap']}")
        if name == "full":
            n = row["tail_calls"]
            print(f"[remat B={b} full attention_tail] {n} calls in the "
                  f"profiled step ({n // 2} forward, {n - n // 2} recompute):"
                  f" every recompute the forward's bits: {row['tail_same']};"
                  f" the first call within {row['tail_err']:.2e} of the "
                  f"plain version (tol {TAIL_TOL})", flush=True)
            check(n == 2 * t_dec and row["tail_same"]
                  and row["tail_err"] <= TAIL_TOL,
                  f"phase 23 B={b}: tail recompute {n} calls, same bits "
                  f"{row['tail_same']}, err {row['tail_err']}")
        if name == "dots":
            print(f"[remat B={b} dots policy] ops of a step's forward by the "
                  "policy's choice: " + ", ".join(
                      f"{k} {v}" for k, v in row["policy"].items()),
                  flush=True)
            check(any(k.endswith("MUST_SAVE") for k in row["policy"]),
                  f"phase 23 B={b}: dots saved nothing: {row['policy']}")
    print(f"[remat] phase 23 wall {time.perf_counter() - phase0:.1f} s "
          f"({smi})", flush=True)
    return {"attention_tail": {
                "remat_path_launches": {k: v["attention_tail"] for k, v in
                                        launches.items()},
                "remat_path_max_abs_err": out["tail_err"]},
            "decoder_fwd_train_mega": {"remat_phase_launches": {
                k: v["decoder_fwd_train_mega"] for k, v in launches.items()}},
            "decoder_bwd_chain_mega": {"remat_phase_launches": {
                k: v["decoder_bwd_chain_mega"] for k, v in launches.items()}},
            "rows": out["rows"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's kernels run "
              "only on a CUDA card", file=sys.stderr)
        return 2
    from tacotron2_torch.config import ModelConfig
    from tacotron2_torch.infer.synthesize import (
        synthesize_mels_tokens as synthesize_mels)
    from tacotron2_torch.models.decoder import decoder_infer_steps
    from tacotron2_torch.models.encoder import encoder_apply
    from tacotron2_torch.models.postnet import postnet_apply
    from tacotron2_torch.models.tacotron2 import (
        Tacotron2, _condition_memory, cast_params_bf16, init_weights,
        make_pad_mask, replace_config)
    from tacotron2_torch.ops import _build
    from tacotron2_torch.ops.attention_kernel import (
        attention_tail, attention_tail_reference, tail_plan)
    from tacotron2_torch.ops.convbn_kernel import conv_bn_act
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
    plans = {t: tail_plan(4, t, 128, 512, torch.float32)
             for t in (32, 112, 128, 600)}
    print("[build] attention_tail shared memory a block (fp32 memory, "
          "A=128, D=512): " + ", ".join(
              f"T_enc={t} {p.smem_bytes} bytes (split {p.split}, "
              f"{p.rows} rows, tiles of {p.tile_rows})"
              for t, p in plans.items()))
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
        for t in (37, 128, 200, 600):
            for b in (1, 16, 64):
                ins = tail_inputs(b, t, dtype, seed=b * 1000 + t)
                with torch.no_grad():
                    got = attention_tail(*ins)
                    ref = attention_tail_reference(*ins)
                    err = max_err(got, ref)
                    tail_err = max(tail_err, err)
                    ms = time_ms(lambda: attention_tail(*ins), 200)
                    dev_ms = graph_ms(lambda: attention_tail(*ins), 20)
                    plain = time_ms(lambda: attention_tail_reference(*ins),
                                    50)
                plan = tail_plan(b, t, 128, 512, ins[5].dtype)
                print(f"[attention_tail] {str(dtype)[6:]:8s} B={b:2d} "
                      f"T_enc={t:3d}: split {plan.split} x {plan.rows} rows "
                      f"(tiles of {plan.tile_rows}), max err {err:.3e}, "
                      f"device {dev_ms * 1e3:.2f} us (graph), "
                      f"{ms * 1e3:.2f} us a call, plain {plain:.4f} ms",
                      flush=True)
                check(err <= TAIL_TOL, f"attention_tail error {err} > "
                      f"{TAIL_TOL} at B={b} T={t} {dtype}")

    # 5. decoder_infer_mega kernel vs plain step loop, full width
    cfg = ModelConfig()
    base = init_weights(Tacotron2(cfg), seed=SEED)
    dec_err, gate_err = {}, {}
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
                    if b > 1:
                        gate_err[dtype] = max(gate_err.get(dtype, 0.0),
                                              errs["gates"])
        gate_fired_stops(dec, dtype, cfg, max(4 * gate_err[dtype], 1e-6),
                         dev,
                         decoder_infer_mega, decoder_infer_mega_reference,
                         make_pad_mask)
        del dec

    # 6. the main path: requests through synthesize_mels, bf16 weights
    model = cast_params_bf16(base).to(dev)
    rng = np.random.default_rng(SEED)
    seqs = [rng.integers(0, cfg.n_symbols, n).tolist()
            for n in rng.integers(20, 121, 4)]
    print(f"[main] {len(seqs)} requests of {[len(s) for s in seqs]} tokens, "
          f"max_steps {MAX_STEPS}, bf16 weights", flush=True)

    def set_megakernel(on: bool) -> None:
        replace_config(model, decoder_megakernel=on)

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
        conv_bn_act.launches = 0
        results[on] = serve(on)
        launches[on] = (decoder_infer_mega.launches, attention_tail.launches)
        check(conv_bn_act.launches == 8 * (1 + len(seqs)),
              f"phase 6 launched conv_bn_act {conv_bn_act.launches} times")
        conv_mels_launches = conv_bn_act.launches
        path = "decode kernel" if on else "step loop + attention kernel"
        frames = sum(m.shape[0] for mels, _, _ in results[on] for m in mels)
        batched, single = results[on][0], results[on][1:]
        steps_b = batched[1].shape[1]
        steps_s = sum(a.shape[1] for _, a, _ in single)
        print(f"[main] {path}: launches decoder_infer_mega="
              f"{launches[on][0]} attention_tail={launches[on][1]} "
              f"conv_bn_act={conv_bn_act.launches}; "
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
    with torch.no_grad():
        tail_ms = time_ms(lambda: attention_tail(*tail_args), 500)
        tail_graph_ms = graph_ms(lambda: attention_tail(*tail_args), 20)
        tail_prof_ms = device_ms(lambda: attention_tail(*tail_args), 100,
                                 "attention_tail_kernel")
        tail_plain_ms = time_ms(lambda: attention_tail_reference(*tail_args),
                                100)
    tail_plan_main = tail_plan(b, t_enc, a, e, tail_args[5].dtype)
    tail_bound = bound(
        qsum.numel() * qsum.element_size() + memory.numel() * 4
        + b * t_enc * (1 + 4) + a * 4 + b * e * 4,
        b * t_enc * (3 * a + 5 + 2 * e), torch.float32)
    print(f"[kernels] at the batched main path's shapes: B={b} T_enc={t_enc} "
          f"{str(cdt)[6:]}, decode of {n_steps} steps "
          f"(weights {wbytes / 1e6:.1f} MB, re-read every step: "
          f"{n_steps * wbytes / HBM_BYTES_PER_S * 1e3:.3f} ms)")
    kernels = [
        dict(name="attention_tail", route="cuda",
             source="tacotron2_torch/csrc/attention_tail.cu",
             replaces="tacotron2_tpu/ops/attention_kernel.py:167",
             launches=launches[False][1], max_abs_err=main_tail_err,
             sweep_max_abs_err=tail_err,
             ms=tail_ms, plain_ms=tail_plain_ms, bound_ms=tail_bound[0],
             bound_by=tail_bound[1], library_ms=None,
             device_ms=tail_graph_ms, profiler_device_ms=tail_prof_ms,
             plan=tail_plan_main._asdict(),
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
    del model, dec, cpu_model, results

    # 11. conv_bn_act against its plain version; 12, 13. text -> PCM
    conv_sweep_err = convbn_sweep(dev)
    with torch.no_grad():
        conv_kernel, speak_decode = text_to_pcm_main_path(dev, base, seqs)
    conv_kernel["sweep_max_abs_err"] = conv_sweep_err
    conv_kernel["mels_path_launches"] = conv_mels_launches
    kernels[1].update(speak_decode)
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"],
                                    speak_decode["speak_path_max_abs_err"])
    # 14. trained weights
    trained, kernels[0]["trained_path_launches"] = trained_weights_phase(
        dev, smi)
    kernels[1].update(trained)
    # 17. the serving path on the same checkpoint
    serve = serving_phase(dev, smi)

    # 8, 9. the training kernels against their plain versions
    sweep = train_kernel_phases(dev, base, cfg)
    # 10. the training main path
    ((kernels[0]["train_path_launches"],
      kernels[0]["train_path_max_abs_err"]),
     train_kernels) = train_main_path(dev)
    train_kernels[0]["sweep_max_abs_err"] = sweep["fwd"]
    train_kernels[1]["sweep_max_abs_err"] = sweep["bwd"]
    # 15. the training loop
    (kernels[0]["loop_launches"], train_kernels[0]["loop_launches"],
     train_kernels[1]["loop_launches"]) = training_loop_phase(dev, smi)
    # 16. widths the kernels were not written for, and C6's configs
    odd_widths_phase(dev)
    c6 = c6_widths(dev)
    # 18. the data path on the trained multi-speaker checkpoint
    tools_tmp = tempfile.TemporaryDirectory()
    processed = os.path.join(tools_tmp.name, "processed")
    quality = data_path_phase(dev, smi, processed)
    # 19. data parallelism: two ranks and two replicas on the one card,
    # against one process (also phase 20's reference)
    t1 = time.perf_counter()
    ref, lr = dp_reference(dev)
    reference = (ref, lr, time.perf_counter() - t1)
    torch.cuda.empty_cache()
    parallel = data_parallel_phase(dev, smi, reference)
    # 20. tensor parallelism: two and four ranks, two and four shards
    tensor = tensor_parallel_phase(dev, smi, reference)
    # 21. the neural letter-to-sound trainer
    lts_phase(dev, smi)
    # 22. the measurement and serving tools at the JAX tools' batch sizes
    try:
        tools = tools_phase(dev, smi, processed)
    finally:
        tools_tmp.cleanup()
    # 23. decoder-step rematerialisation on the step-loop training path
    remat = remat_phase(dev, smi)
    kernels += train_kernels + [conv_kernel]
    for entry in kernels:
        for phase in (serve, quality, parallel, tensor, c6, tools, remat):
            entry.update(phase.get(entry["name"], {}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:6]))
    if sys.argv[1:2] == ["--tp-rank"]:
        sys.exit(tp_rank(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:6]))
    if sys.argv[1:2] == ["--remat-phase"]:
        sys.exit(remat_measure(sys.argv[2]))
    sys.exit(main())
