"""The port's kernels against their plain versions, without JAX.

The tests marked ``cuda`` launch the CUDA ``attention_tail``,
``decoder_infer_mega``, ``decoder_fwd_train_mega``,
``decoder_bwd_chain_mega`` and ``conv_bn_act``; they skip where there is no
card.  This file
imports nothing of JAX, so on a machine with a card and no JAX it runs
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

The other tests run everywhere: the wrappers' routing and checks, the
build's failure without ``nvcc``, and the weight bytes that the decode
kernel's bound is computed from.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tacotron2_torch.config import ModelConfig
from tacotron2_torch.models.decoder import decoder_infer_steps
from tacotron2_torch.models.encoder import encoder_apply
from tacotron2_torch.models.layers import BatchNorm, Conv1d
from tacotron2_torch.models.postnet import postnet_apply
from tacotron2_torch.config import Config, TrainConfig
from tacotron2_torch.data.dataset import Example, collate
from tacotron2_torch.models.decoder import decoder_infer
from tacotron2_torch.models.tacotron2 import (Tacotron2, cast_params_bf16,
                                              init_projection_bias,
                                              init_weights, make_pad_mask,
                                              replace_config,
                                              tacotron2_infer)
from tacotron2_torch.train.optim import make_optimizer
from tacotron2_torch.train.state import create_train_state
from tacotron2_torch.train.step import train_step
from tacotron2_torch.ops import _build
from tacotron2_torch.ops.convbn_kernel import (_launch, conv_bn_act,
                                               conv_bn_act_reference,
                                               folded_weights)
from tacotron2_torch.ops.attention_kernel import (_lib as _tail_lib,
                                                  attention_tail,
                                                  attention_tail_reference,
                                                  tail_plan)
from tacotron2_torch.ops.decoder_bptt import core_params, decoder_scan_bptt
from tacotron2_torch.ops.decoder_bwd_kernel import (
    MAX_LOCATION_TAPS, _Args, _lib, c3_cols, chain_plan,
    decoder_bwd_chain_mega, decoder_bwd_chain_reference, product_weights)
from tacotron2_torch.ops.decoder_megakernel import (
    _lib as _dec_lib, decode_smem, decoder_infer_mega,
    decoder_infer_mega_reference, kernel_widths, weight_bytes)
from tacotron2_torch.ops.decoder_train_kernel import (
    _lib as _fwd_lib, decoder_fwd_train_mega, decoder_fwd_train_reference,
    fwd_smem, kernel_operands, operand_bytes)

# every width a multiple of 8, as the decode kernel's vector loads need
SMALL = dict(n_mels=8, prenet_dim=16, symbols_embedding_dim=32,
             encoder_embedding_dim=32, decoder_rnn_dim=64,
             attention_rnn_dim=64, attention_dim=16, location_n_filters=4,
             location_kernel_size=7, postnet_embedding_dim=32)
B, T_ENC, MAX = 2, 12, 14
# One limit per output (mels, gate logits, alignments); alignments here are
# ~1/T_ENC ~ 0.08.  fp32: the same products summed in another order; bf16:
# the kernel's composed location matrix is rounded once, the plain conv
# output per step.
DEC_OUTPUTS = ("mels", "gates", "aligns")
DEC_TOL = {torch.float32: {"mels": 1e-5, "gates": 1e-5, "aligns": 1e-6},
           torch.bfloat16: {"mels": 5e-3, "gates": 5e-3, "aligns": 1e-3}}


def cuda_device() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def tail_inputs(b, t, a, d, seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    lens = rng.integers(t // 2, t + 1, b)
    lens[0] = t
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(device)
    return (f(b, t, a).to(dtype), f(a) * 0.3, f(),
            torch.tensor(1.2).to(device),
            make_pad_mask(torch.from_numpy(lens), t).to(device), f(b, t, d))


def small_decoder(device, dtype=torch.float32, gate_bias=None, **widths):
    """The SMALL decoder (``widths`` override its config) on ``device``,
    with a seeded memory and mask."""
    model = init_weights(Tacotron2(ModelConfig(**dict(SMALL, **widths))),
                         seed=0)
    if gate_bias is not None:
        with torch.no_grad():
            model.decoder.gate_layer.bias.fill_(gate_bias)
    if dtype == torch.bfloat16:
        model = cast_params_bf16(model)
    rng = np.random.default_rng(1)
    memory = torch.from_numpy((rng.standard_normal(
        (B, T_ENC, SMALL["encoder_embedding_dim"])) * 0.5).astype(np.float32))
    mask = make_pad_mask(torch.tensor([T_ENC, 9]), T_ENC)
    return model.decoder.to(device), memory.to(device), mask.to(device)


def test_wrappers_reject_other_devices():
    ins = tail_inputs(2, 9, 16, 24, seed=0, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention_tail(*ins)
    dec, memory, mask = small_decoder("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        decoder_infer_mega(dec, memory.to("meta"), MAX, 0.5)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["decoder_infer"])


def test_library_path_follows_source():
    path = _build.library_path("decoder_infer")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libdecoder_infer-") and path.suffix == ".so"


@pytest.mark.parametrize("name", _build.CUDA_SOURCES)
def test_sources_share_the_header(name, monkeypatch, tmp_path):
    """Every decoder source includes the shared header once (the conv
    kernel stands alone), and every library's name follows the header's
    contents as well as its own source's."""
    assert (_build.CSRC / f"{name}.cu").read_text().count(
        '#include "decoder_common.cuh"') == int(name.startswith("decoder_"))
    before = _build.library_path(name)
    assert before.name.startswith(f"lib{name}-")
    for f in _build.CSRC.glob("*.cu*"):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    with open(tmp_path / "decoder_common.cuh", "a") as f:
        f.write("// edited\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.library_path(name).name != before.name


def test_weight_bytes_full_width():
    """The bytes every decode step reads: ~72.8 MB fp32, ~36.4 MB bf16."""
    cfg = ModelConfig()
    h, e, p = cfg.decoder_rnn_dim, cfg.encoder_embedding_dim, cfg.prenet_dim
    m, a, k = cfg.n_mels, cfg.attention_dim, cfg.location_kernel_size
    matrices = (m * p + p * p + 4 * h * (p + e + h) + 4 * h * (h + e + h)
                + a * h + 2 * k * a + (m + 1) * (h + e))
    fp32_vectors = 4 * h + 4 * h + (m + 1) + a + 2
    model = init_weights(Tacotron2(cfg), seed=0)
    assert weight_bytes(model.decoder) == 4 * (matrices + fp32_vectors)
    bf16 = weight_bytes(cast_params_bf16(model).decoder)
    assert bf16 == 2 * matrices + 4 * fp32_vectors
    assert 36.3e6 < bf16 < 36.5e6


# chip_smoke.py's TAIL_TOL: fp32 sums in another order over <= 600 positions
TAIL_TOL = 1e-5
# tools/attention_tail_probe.py's five shapes, then B=1 and B=64 at others
TAIL_SHAPES = [(torch.bfloat16, 1, 32), (torch.bfloat16, 4, 112),
               (torch.float32, 16, 128), (torch.bfloat16, 64, 200),
               (torch.float32, 4, 600), (torch.float32, 1, 37),
               (torch.bfloat16, 1, 1000), (torch.float32, 64, 7),
               (torch.bfloat16, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,t", TAIL_SHAPES)
def test_cuda_tail_matches_plain(dtype, b, t):
    dev = cuda_device()
    ins = tail_inputs(b, t, 128, 512, seed=b + t, device=dev, dtype=dtype)
    before = attention_tail.launches
    got = attention_tail(*ins)
    ref = attention_tail_reference(*ins)
    torch.cuda.synchronize()
    assert attention_tail.launches == before + 1
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=TAIL_TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tail_padded_chunk_and_row(dtype):
    """Item 1's last block holds padding only; item 2 is padded all
    through, so its attention is uniform, as the reference's."""
    dev = cuda_device()
    b, t = 3, 128
    ins = list(tail_inputs(b, t, 128, 512, seed=3, device=dev, dtype=dtype))
    plan = tail_plan(b, t, 128, 512, torch.float32)
    assert plan.split > 1
    lens = torch.tensor([t, (plan.split - 1) * plan.rows, 0])
    ins[4] = make_pad_mask(lens, t).to(dev)
    got = attention_tail(*ins)
    ref = attention_tail_reference(*ins)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=TAIL_TOL, rtol=0)
    assert torch.all(got[0][1, lens[1]:] == 0.0)
    torch.testing.assert_close(got[0][2], torch.full((t,), 1.0 / t,
                                                     device=dev),
                               atol=1e-7, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tail_is_repeatable(dtype):
    """No atomics: two launches give the same bits (several tiles a
    block at T_enc=1000)."""
    dev = cuda_device()
    ins = tail_inputs(16, 1000, 128, 512, seed=8, device=dev, dtype=dtype)
    first = attention_tail(*ins)
    second = attention_tail(*ins)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("mem_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 7, 112, 600, 1000])
def test_cuda_tail_plan_matches_the_kernel(t, mem_dtype):
    """The plan's shared memory is the kernel's own layout's."""
    cuda_device()
    plan = tail_plan(4, t, 128, 512, mem_dtype)
    assert _tail_lib().t2_attention_tail_smem(
        512, plan.split, plan.rows, plan.tile_rows,
        int(mem_dtype == torch.bfloat16)) == plan.smem_bytes


@pytest.mark.cuda
def test_cuda_tail_refuses():
    """Bad inputs raise, and nothing is launched; a bf16 memory row of 40
    bytes, which no bulk copy takes, is copied by plain loads and agrees
    with the plain version."""
    dev = cuda_device()
    ins = tail_inputs(2, 9, 16, 24, seed=0, device=dev)
    before = attention_tail.launches
    with pytest.raises(TypeError, match="dtypes"):
        attention_tail(ins[0].half(), *ins[1:])
    with pytest.raises(TypeError, match="dtypes"):
        attention_tail(*ins[:4], ins[4].to(torch.uint8), ins[5])
    with pytest.raises(ValueError, match="shape mismatch"):
        attention_tail(*ins[:5], ins[5][:, :8].contiguous())
    with pytest.raises(ValueError, match="different devices"):
        attention_tail(*ins[:5], ins[5].cpu())
    assert attention_tail.launches == before
    row40 = (*ins[:5], ins[5][..., :20].contiguous().to(torch.bfloat16))
    got = attention_tail(*row40)
    ref = attention_tail_reference(*row40)
    torch.cuda.synchronize()
    assert attention_tail.launches == before + 1
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=TAIL_TOL, rtol=0)


def offset_copy(x: torch.Tensor) -> torch.Tensor:
    """``x`` in a buffer that starts one element past a 16-byte boundary:
    contiguous, but no vector load or bulk copy may start at it."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mem_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,a,d,offset", [
    (2, 9, 30, 24, False),       # A no multiple of 4: four loads a lane
    (3, 37, 13, 7, False),       # and an odd D: rows padded in the ring
    (2, 200, 128, 510, False),   # several tiles of padded rows a block
    (4, 112, 128, 512, True),    # qsum and memory not 16-byte aligned
    (65536, 8, 16, 32, False)])  # a second launch for the last item
def test_cuda_tail_takes_any_a_and_d(b, t, a, d, offset, mem_dtype,
                                     q_dtype):
    """Shapes and alignments the vector loads and the bulk copy do not
    take: the kernel launches (once for every 65535 items) and agrees with
    the plain version at the usual limit."""
    dev = cuda_device()
    ins = list(tail_inputs(b, t, a, d, seed=a + d, device=dev,
                           dtype=q_dtype))
    ins[5] = ins[5].to(mem_dtype)
    if offset:
        ins[0], ins[5] = offset_copy(ins[0]), offset_copy(ins[5])
    before = attention_tail.launches
    got = attention_tail(*ins)
    ref = attention_tail_reference(*ins)
    torch.cuda.synchronize()
    assert attention_tail.launches == before + -(-b // 65535)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=TAIL_TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mem_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d", [(7, 7), (112, 510), (1000, 30)])
def test_cuda_tail_plan_matches_the_kernel_at_any_d(t, d, mem_dtype):
    """The plan's shared memory, rows padded to 16 bytes, is the kernel's
    own layout's."""
    cuda_device()
    plan = tail_plan(4, t, 30, d, mem_dtype)
    assert _tail_lib().t2_attention_tail_smem(
        d, plan.split, plan.rows, plan.tile_rows,
        int(mem_dtype == torch.bfloat16)) == plan.smem_bytes


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,mem_dtype,b,t,d", [
    (torch.float32, torch.float32, 1, 8, 16392),     # past a ring stage
    (torch.bfloat16, torch.float32, 2, 8, 16384),    # past a block
    (torch.float32, torch.float32, 1, 1100, 16392),  # two tiles of rows
    (torch.bfloat16, torch.bfloat16, 3, 40, 40001),  # odd D, bf16 rows
    (torch.float32, torch.bfloat16, 2, 37, 33000)])
def test_cuda_tail_takes_wide_rows(q_dtype, mem_dtype, b, t, d):
    """Memory rows too wide for the ring (C6) take the wide kernel: one
    launch, the plain version's values at the usual limit, two launches
    bit for bit, and the plan's shared memory the kernel's."""
    dev = cuda_device()
    plan = tail_plan(b, t, 128, d, mem_dtype)
    assert plan.wide
    assert _tail_lib().t2_attention_tail_wide_smem(
        plan.tile_rows) == plan.smem_bytes
    ins = list(tail_inputs(b, t, 128, d, seed=d, device=dev, dtype=q_dtype))
    ins[5] = ins[5].to(mem_dtype)
    before = attention_tail.launches
    got = attention_tail(*ins)
    again = attention_tail(*ins)
    ref = attention_tail_reference(*ins)
    torch.cuda.synchronize()
    assert attention_tail.launches == before + 2
    for g, r, x in zip(got, ref, again):
        torch.testing.assert_close(g, r, atol=TAIL_TOL, rtol=0)
        assert torch.equal(g, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_step_loop_with_the_tail(dtype):
    """The step loop with the kernel's tail against the plain loop:
    the same frame_ends, the outputs within the decode's limits."""
    dec, memory, mask = small_decoder(cuda_device(), dtype)
    args = (dec, memory, MAX, 0.5, True, mask, "all", 9)
    before = attention_tail.launches
    with torch.no_grad():
        got = decoder_infer_steps(*args, tail=attention_tail)
        ref = decoder_infer_steps(*args, tail=attention_tail_reference)
    torch.cuda.synchronize()
    assert attention_tail.launches > before
    assert torch.equal(got[4], ref[4]) and int(got[3]) == int(ref[3])
    for name, g, r in zip(DEC_OUTPUTS, got[:3], ref[:3]):
        torch.testing.assert_close(g, r, atol=DEC_TOL[dtype][name], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("force", [None, 0, 1, 6])
@pytest.mark.parametrize("stop_mode", ["any", "all"])
@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_matches_plain(dtype, drop, stop_mode, force):
    dec, memory, mask = small_decoder(cuda_device(), dtype)
    args = (dec, memory, MAX, 0.5, drop, mask, stop_mode, force)
    before = decoder_infer_mega.launches
    with torch.no_grad():
        got = decoder_infer_mega(*args)
        ref = decoder_infer_mega_reference(*args)
    torch.cuda.synchronize()
    assert decoder_infer_mega.launches == before + 1
    assert int(got[3]) == int(ref[3])
    assert torch.equal(got[4], ref[4])
    n = int(ref[3])
    for name, g, r in zip(DEC_OUTPUTS, got[:3], ref[:3]):
        torch.testing.assert_close(g[:, :n], r[:, :n],
                                   atol=DEC_TOL[dtype][name], rtol=0,
                                   msg=lambda m: f"{name}: {m}")
        assert torch.equal(g[:, n:], r[:, n:])    # post-stop rows exactly


@pytest.mark.cuda
def test_cuda_decode_natural_gate_fire():
    dec, memory, mask = small_decoder(cuda_device(), gate_bias=5.0)
    with torch.no_grad():
        got = decoder_infer_mega(dec, memory, MAX, 0.5, True, mask, "any")
    assert int(got[3]) == 2       # fires at the first eligible step
    assert got[4].tolist() == [2, 2]


def decode_pair(args):
    """The kernel's and the plain step loop's returns on the same inputs,
    held to each other as test_cuda_decode_matches_plain holds them."""
    dtype = args[0].attention_lstm.weight_ih.dtype
    before = decoder_infer_mega.launches
    with torch.no_grad():
        got = decoder_infer_mega(*args)
        ref = decoder_infer_mega_reference(*args)
    torch.cuda.synchronize()
    assert decoder_infer_mega.launches == before + 1
    assert int(got[3]) == int(ref[3])
    assert torch.equal(got[4], ref[4])
    n = int(ref[3])
    for name, g, r in zip(DEC_OUTPUTS, got[:3], ref[:3]):
        torch.testing.assert_close(g[:, :n], r[:, :n],
                                   atol=DEC_TOL[dtype][name], rtol=0,
                                   msg=lambda m: f"{name}: {m}")
        assert torch.equal(g[:, n:], r[:, n:])
    return got, ref


@pytest.mark.cuda
@pytest.mark.parametrize("b", [9, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_batch_in_passes(dtype, b):
    """More than kDecMTile (8) batch rows: every product runs in passes."""
    dev = cuda_device()
    dec = small_decoder(dev, dtype)[0]
    rng = np.random.default_rng(b)
    memory = torch.from_numpy((rng.standard_normal(
        (b, T_ENC, SMALL["encoder_embedding_dim"])) * 0.5).astype(
            np.float32)).to(dev)
    lens = torch.tensor([T_ENC - 3 * (i % 3) for i in range(b)])
    mask = make_pad_mask(lens, T_ENC).to(dev)
    for stop_mode, force in (("all", None), ("any", 6)):
        decode_pair((dec, memory, MAX, 0.5, True, mask, stop_mode, force))


@pytest.mark.cuda
@pytest.mark.parametrize("stop_mode", ["any", "all"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_gate_fired_stops(dtype, stop_mode):
    """Rows stopped by the gate itself at different frames: chip_smoke.py's
    gate-bias offset, picked from the plain loop's logits at four times the
    kernel's own gate error on the undisturbed decode (at least 1e-5) from
    the threshold; frame_ends exactly the plain loop's.  Four rows, memory
    at scale 2: the small model's logits move enough for that margin."""
    from chip_smoke import expected_ends, gate_stop_offset
    dev = cuda_device()
    dec = small_decoder(dev, dtype)[0]
    b = 4
    mask = make_pad_mask(torch.tensor([T_ENC - 3 * (i % 3) for i in range(b)]),
                         T_ENC).to(dev)

    def candidates():
        for seed in range(80):
            rng = np.random.default_rng(seed)
            yield torch.from_numpy((rng.standard_normal((b, T_ENC, 32)) * 2.0)
                                   .astype(np.float32)).to(dev), mask

    steps = 40
    memory0 = next(candidates())[0]
    got, ref = decode_pair((dec, memory0, steps, 0.5, False, mask, "all",
                            None))
    margin = max(1e-5, 4 * float((got[1] - ref[1]).abs().max()))
    picked = gate_stop_offset(dec, candidates(), steps, 0.5, margin, 30,
                              drop_first=False)
    assert picked is not None, f"no offset {margin:.1e} from the threshold"
    i, _, hot, stops = picked
    assert len({s for s in stops if 0 < s <= 30}) >= 2
    memory = list(candidates())[i][0]
    got, _ = decode_pair((hot, memory, steps, 0.5, False, mask, stop_mode,
                          None))
    n, ends = expected_ends(stops, stop_mode, steps)
    assert int(got[3]) == n and got[4].tolist() == ends


# --------------------------------------------------------------------------
# the training pair: decoder_fwd_train_mega, decoder_bwd_chain_mega
# --------------------------------------------------------------------------
T_DEC = 10
FWD_OUT = ("frames", "attn", "ha_s", "ca_s", "hd_s", "cd_s", "qsum_s",
           "aa_s", "ad_s")
BWD_OUT = ("g_att_s", "g_dec_s", "d_ctx_s", "d_pre_s", "d_qsum_s", "d_pq_s",
           "dv", "dpm", "scal")
# Kernel against plain version.  An element may differ by two bf16
# roundings of the plain value where the output is stored in bf16 (a
# rounding is at most 2^-7 of the value; both sides round at the same
# places, and a sum taken in another order flips one now and then), and
# beyond that by PAIR_TOL times the plain output's mean size (frames: about
# their per-channel mean, which is the projection bias and no product).
# fp32: the same products summed in another order.  bf16: what a flipped
# rounding carries into the later steps.
PAIR_TOL = {torch.float32: 5e-5, torch.bfloat16: 1.5e-2}


def train_inputs(device, dtype=torch.float32, dropout=True, b=B, t_enc=T_ENC,
                 t_dec=T_DEC, **widths):
    kw = dict(SMALL, **widths) if dropout else dict(
        SMALL, p_attention_dropout=0.0, p_decoder_dropout=0.0, **widths)
    model = init_weights(Tacotron2(ModelConfig(**kw)), seed=0)
    if dtype == torch.bfloat16:
        model = cast_params_bf16(model)
    dec = model.decoder.to(device)
    rng = np.random.default_rng(2)
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(device)
    pre = (f(t_dec, b, SMALL["prenet_dim"]) * 0.3).abs()
    memory = f(b, t_enc, SMALL["encoder_embedding_dim"]) * 0.5
    with torch.no_grad():
        pm = dec.attention.memory_layer(memory)
    lens = torch.tensor([t_enc - 3 * (i % 2) for i in range(b)])
    mask = make_pad_mask(lens, t_enc).to(device)
    h = SMALL["decoder_rnn_dim"]
    keep = lambda: (torch.from_numpy(rng.random((t_dec, b, h)) < 0.9)
                    .to(device) if dropout else None)
    ops = kernel_operands(core_params(dec))
    cots = (f(t_dec, b, SMALL["n_mels"] + 1) * 0.5, f(t_dec, b, t_enc))
    return dec, (dec.cfg, ops, pre, memory, pm, mask, keep(), keep()), cots


def error_share(name, g, r):
    """The largest error past two bf16 roundings (bf16 outputs only), as a
    share of the plain output's mean size."""
    stored_bf16 = r.dtype == torch.bfloat16
    g, r = g.float(), r.float()
    err = (g - r).abs()
    if stored_bf16:
        err = (err - 2 * 2.0 ** -7 * r.abs()).clamp(min=0)
    if name == "frames":
        r = r - r.mean(dim=(0, 1), keepdim=True)
    return float(err.max()) / float(r.abs().mean())


def assert_outputs_close(names, got, ref, tol):
    for name, g, r in zip(names, got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        assert bool(torch.isfinite(g).all()), name
        share = error_share(name, g, r)
        assert share <= tol, (name, share)


def test_train_pair_rejects_what_it_cannot_launch():
    dec, args, cots = train_inputs("cpu")
    cfg, ops, pre, memory, pm, mask, mka, mkd = args
    with pytest.raises(ValueError, match="unsupported device"):
        decoder_fwd_train_mega(cfg, ops, pre, memory.to("meta"), pm, mask,
                               mka, mkd)
    with pytest.raises(ValueError, match="unsupported device"):
        decoder_bwd_chain_mega(cfg, ops, memory.to("meta"), mka, mkd,
                               *([pre] * 8))
    # the pair reads the decoder's weights less the prenet, every step
    full = init_weights(Tacotron2(ModelConfig()), seed=0).decoder
    cfgf = full.cfg
    prenet = cfgf.prenet_dim * (cfgf.n_mels + cfgf.prenet_dim)
    assert (operand_bytes(kernel_operands(core_params(full)))
            == weight_bytes(full) - 4 * prenet)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [True, False])
@pytest.mark.parametrize("b,t_enc", [(2, 12), (3, 13), (9, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_train_forward_matches_plain(dtype, b, t_enc, dropout):
    _, args, _ = train_inputs(cuda_device(), dtype, dropout, b, t_enc)
    before = decoder_fwd_train_mega.launches
    got = decoder_fwd_train_mega(*args)
    torch.cuda.synchronize()
    assert decoder_fwd_train_mega.launches == before + 1
    assert_outputs_close(FWD_OUT, got, decoder_fwd_train_reference(*args),
                         PAIR_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [True, False])
@pytest.mark.parametrize("b", [16, 9, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_train_forward_batch_tile(dtype, b, dropout):
    """One pass of the forward's 16-row batch tile (B=16), a part of one
    (B=9) and two passes (B=24), against the plain version; two launches
    bit for bit."""
    _, args, _ = train_inputs(cuda_device(), dtype, dropout, b, 24)
    before = decoder_fwd_train_mega.launches
    got = decoder_fwd_train_mega(*args)
    again = decoder_fwd_train_mega(*args)
    torch.cuda.synchronize()
    assert decoder_fwd_train_mega.launches == before + 2
    assert_outputs_close(FWD_OUT, got, decoder_fwd_train_reference(*args),
                         PAIR_TOL[dtype])
    for name, x, y in zip(FWD_OUT, got, again):
        assert torch.equal(x, y), f"{name}: two runs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [True, False])
@pytest.mark.parametrize("b,t_enc", [(1, 13), (2, 12), (3, 13), (5, 13),
                                     (9, 24), (16, 37), (24, 37)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_train_backward_matches_plain(dtype, b, t_enc, dropout):
    """Batches below, at and above one 16-row M tile of the products, and
    encoder lengths that are not a multiple of 8."""
    _, args, cots = train_inputs(cuda_device(), dtype, dropout, b, t_enc)
    cfg, ops, _, memory, _, _, mka, mkd = args
    _, attns, _, ca_s, _, cd_s, qsum_s, aa_s, ad_s = (
        decoder_fwd_train_reference(*args))
    bargs = (cfg, ops, memory, mka, mkd, aa_s, ad_s, ca_s, cd_s, attns,
             qsum_s, *cots)
    before = decoder_bwd_chain_mega.launches
    got = decoder_bwd_chain_mega(*bargs)
    again = decoder_bwd_chain_mega(*bargs)
    torch.cuda.synchronize()
    assert decoder_bwd_chain_mega.launches == before + 2
    assert_outputs_close(BWD_OUT, got, decoder_bwd_chain_reference(*bargs),
                         PAIR_TOL[dtype])
    for name, x, y in zip(BWD_OUT, got, again):
        assert torch.equal(x, y), f"{name}: two runs differ"


# C6: an attention width or location conv whose location rows (the reverse
# chain's phase C3) or composed matrix (the forward's and the decode's
# shared memory) did not fit a block; refused on the card before
C6_WIDTHS = [(512, 31), (128, 95), (296, 31), (512, 95), (1024, 63)]


@pytest.mark.cuda
@pytest.mark.parametrize("a,k", C6_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_train_pair_at_c6_widths(dtype, a, k):
    """Both training kernels at widths past one block's location rows or
    matrix, against their plain versions; the reverse chain stages A in
    chunks, two runs bit for bit."""
    _, args, cots = train_inputs(cuda_device(), dtype, True, 5, 37,
                                 attention_dim=a, location_kernel_size=k)
    cfg, ops, _, memory, _, _, mka, mkd = args
    assert chain_plan(kernel_widths(cfg), 5, 37, k,
                      dtype).location_chunks > 1
    before = (decoder_fwd_train_mega.launches,
              decoder_bwd_chain_mega.launches)
    got = decoder_fwd_train_mega(*args)
    ref = decoder_fwd_train_reference(*args)
    torch.cuda.synchronize()
    assert_outputs_close(FWD_OUT, got, ref, PAIR_TOL[dtype])
    _, attns, _, ca_s, _, cd_s, qsum_s, aa_s, ad_s = ref
    bargs = (cfg, ops, memory, mka, mkd, aa_s, ad_s, ca_s, cd_s, attns,
             qsum_s, *cots)
    got = decoder_bwd_chain_mega(*bargs)
    again = decoder_bwd_chain_mega(*bargs)
    torch.cuda.synchronize()
    assert (decoder_fwd_train_mega.launches - before[0],
            decoder_bwd_chain_mega.launches - before[1]) == (1, 2)
    assert_outputs_close(BWD_OUT, got, decoder_bwd_chain_reference(*bargs),
                         PAIR_TOL[dtype])
    for name, x, y in zip(BWD_OUT, got, again):
        assert torch.equal(x, y), f"{name}: two runs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("a,k", [(512, 95), (1024, 63)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_at_c6_widths(dtype, a, k):
    """The decode kernel where its location matrix is left in L2 (fp32
    at both widths, bf16 at 1024 x 63) or only just fits, against the
    plain step loop."""
    dec, memory, mask = small_decoder(cuda_device(), dtype, attention_dim=a,
                                      location_kernel_size=k)
    _, resident = decode_smem(B, T_ENC, a, k, dtype)
    assert resident == (dtype == torch.bfloat16 and a == 512)
    decode_pair((dec, memory, MAX, 0.5, True, mask, "any", None))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("a,k", [(128, 31), (512, 95), (1024, 63),
                                 (384, 127), (296, 31)])
def test_cuda_c6_layouts_match_the_kernels(a, k, dtype):
    """The host's mirrors of the three decoder kernels' shared memory:
    the decode's and the forward's layouts (negative where the location
    matrix is left in L2), the reverse chain's C3 columns and its bytes."""
    cuda_device()
    bf16 = int(dtype == torch.bfloat16)
    smem, resident = decode_smem(4, 128, a, k, dtype)
    assert _dec_lib().t2_decoder_infer_smem_bytes(4, 128, a, k, bf16) == (
        smem if resident else -smem)
    smem, resident = fwd_smem(128, a, k, dtype)
    assert _fwd_lib().t2_decoder_train_fwd_smem_bytes(128, a, k, bf16) == (
        smem if resident else -smem)
    assert _lib().t2_decoder_train_bwd_c3_cols(a, k) == c3_cols(a, k)
    dims = dict(FULL_DIMS, A=a)
    args = _Args(B=16, T=128, K=k, **dims)
    assert _lib().t2_decoder_train_bwd_smem_bytes(args) == chain_plan(
        dims, 16, 128, k, dtype).smem_bytes
    assert _lib().t2_decoder_train_bwd_c3_cols(128, MAX_LOCATION_TAPS) == 8
    assert _lib().t2_decoder_train_bwd_c3_cols(128,
                                               MAX_LOCATION_TAPS + 1) == 0


FULL = ModelConfig()
FULL_DIMS = dict(H=FULL.decoder_rnn_dim, P=FULL.prenet_dim,
                 E=FULL.encoder_embedding_dim, A=FULL.attention_dim,
                 M=FULL.n_mels)
SMALL_DIMS = dict(H=SMALL["decoder_rnn_dim"], P=SMALL["prenet_dim"],
                  E=SMALL["encoder_embedding_dim"], A=SMALL["attention_dim"],
                  M=SMALL["n_mels"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t_enc", [37, 128])
@pytest.mark.parametrize("b", [2, 5, 8, 16, 24])
def test_chain_plan(b, t_enc, dtype):
    """The reverse chain's cut at full width: the batch in passes of 16
    rows, K-chunks covering a row of the 4H-wide operand, the head operand
    padded to 8 columns, position blocks covering T_enc, and shared memory
    that leaves room for two blocks an SM."""
    plan = chain_plan(FULL_DIMS, b, t_enc, FULL.location_kernel_size, dtype)
    h, m = FULL_DIMS["H"], FULL_DIMS["M"]
    assert 16 * (plan.m_tiles - 1) < b <= 16 * plan.m_tiles
    row_bytes = 4 * h * (2 if dtype == torch.bfloat16 else 4)
    assert (plan.k_chunks - 1) * 512 < row_bytes <= plan.k_chunks * 512
    assert plan.head_cols == 88 and m + 1 <= plan.head_cols
    assert (plan.position_chunks - 1) * 8 < t_enc <= plan.position_chunks * 8
    assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024
    small = chain_plan(SMALL_DIMS, b, t_enc, SMALL["location_kernel_size"],
                       dtype)
    assert small.smem_bytes == plan.smem_bytes      # the ring sets it
    assert small.k_chunks == (1 if dtype == torch.bfloat16 else 2)
    assert small.head_cols == 16


@pytest.mark.parametrize("dims,b,t_enc,dtype,err", [
    (FULL_DIMS, 0, 128, torch.bfloat16, ValueError),
    (FULL_DIMS, -1, 128, torch.float32, ValueError),
    (FULL_DIMS, 16, 0, torch.float32, ValueError),
    (FULL_DIMS, 16, 128, torch.float16, TypeError),
    (FULL_DIMS, 5, 37, torch.float64, TypeError)])
def test_chain_plan_rejects(dims, b, t_enc, dtype, err):
    """An empty batch or encoder and another weight dtype."""
    with pytest.raises(err):
        chain_plan(dims, b, t_enc, FULL.location_kernel_size, dtype)


@pytest.mark.parametrize("taps", [0, MAX_LOCATION_TAPS + 1])
def test_chain_plan_rejects_taps_past_its_limit(taps):
    """Past 1203 taps not even 8 columns of phase C3's staged rows and
    matrix fit a block."""
    assert MAX_LOCATION_TAPS == 1203
    with pytest.raises(ValueError, match="taps"):
        chain_plan(FULL_DIMS, 16, 128, taps, torch.bfloat16)


@pytest.mark.parametrize("a,taps,dtype,cols,chunks,smem", [
    # refused before C6's repair (staged rows past two blocks an SM)
    (512, 31, torch.bfloat16, 256, 2, 102400),
    (1024, 31, torch.float32, 256, 4, 102400),
    (296, 31, torch.bfloat16, 152, 2, 74240),
    (128, 95, torch.float32, 64, 2, 74752),
    (512, 95, torch.bfloat16, 88, 6, 102784),
    (128, MAX_LOCATION_TAPS, torch.bfloat16, 8, 16, 115712),
    # the default widths and one more wide A: one chunk, as before
    (128, 31, torch.bfloat16, 128, 1, 74240),
    (288, 31, torch.float32, 288, 1, 115200)])
def test_chain_plan_takes_wide_location(a, taps, dtype, cols, chunks, smem):
    """Where the kWarps + K - 1 location rows and the (2K, A) matrix do
    not fit a block at once, phase C3 stages A in chunks, a multiple of 8
    columns evened out; shared memory stays within two blocks an SM."""
    dims = dict(FULL_DIMS, A=a)
    plan = chain_plan(dims, 16, 128, taps, dtype)
    assert (plan.location_cols, plan.location_chunks) == (cols, chunks)
    assert plan.location_cols % 8 == 0
    assert (chunks - 1) * cols < a <= chunks * cols
    assert plan.smem_bytes == smem and 2 * (smem + 1024) <= 228 * 1024
    assert plan.location_cols == c3_cols(a, taps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [2, 5, 8, 16, 24])
def test_product_weights_match_the_products(b, dtype):
    """The stacked, transposed weights of phases B and E, one row per
    output, give the plain version's four products."""
    _, args, _ = train_inputs("cpu", dtype, b=b)
    ops = args[1]
    w_b, w_e = product_weights(ops)
    h = SMALL["decoder_rnn_dim"]
    assert w_b.is_contiguous() and w_e.is_contiguous()
    assert w_b.dtype == w_e.dtype == dtype
    rng = np.random.default_rng(b)
    g = torch.from_numpy(rng.standard_normal((b, 4 * h)).astype(
        np.float32)).to(dtype).float()
    for w, (i, hh) in zip((w_b, w_e), (("wi_d", "wh_d"), ("wi_a", "wh_a"))):
        got = g @ w.float().t()
        want = torch.cat([g @ ops[i].float(), g @ ops[hh].float()], dim=1)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_chain_plan_matches_the_kernel(dtype):
    """The shared memory the launcher asks for is the plan's."""
    cuda_device()
    for b, t_enc in ((5, 37), (24, 128)):
        plan = chain_plan(FULL_DIMS, b, t_enc, FULL.location_kernel_size,
                          dtype)
        args = _Args(B=b, T=t_enc, K=FULL.location_kernel_size, **FULL_DIMS)
        assert _lib().t2_decoder_train_bwd_smem_bytes(args) == plan.smem_bytes


def full_width_chain_inputs(dtype, b, t_enc=37, t_dec=6, dropout=True):
    """Full-width reverse-chain inputs on the card: K = 4H = 4096, so the
    products walk many K-chunks through the ring."""
    dev = cuda_device()
    cfg = FULL if dropout else dataclasses.replace(
        FULL, p_attention_dropout=0.0, p_decoder_dropout=0.0)
    model = init_weights(Tacotron2(cfg), seed=0)
    if dtype == torch.bfloat16:
        model = cast_params_bf16(model)
    dec = model.decoder.to(dev)
    rng = np.random.default_rng(3)
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev)
    pre = (f(t_dec, b, cfg.prenet_dim) * 0.5).relu()
    memory = f(b, t_enc, cfg.encoder_embedding_dim) * 0.5
    with torch.no_grad():
        pm = dec.attention.memory_layer(memory)
    mask = make_pad_mask(torch.tensor([t_enc - 5 * (i % 3)
                                       for i in range(b)]), t_enc).to(dev)
    h = cfg.decoder_rnn_dim
    keep = lambda: (torch.from_numpy(rng.random((t_dec, b, h)) < 0.9).to(dev)
                    if dropout else None)
    ops = kernel_operands(core_params(dec))
    mka, mkd = keep(), keep()
    fargs = (cfg, ops, pre, memory, pm, mask, mka, mkd)
    _, attns, _, ca_s, _, cd_s, qsum_s, aa_s, ad_s = (
        decoder_fwd_train_reference(*fargs))
    cots = (f(t_dec, b, cfg.n_mels + 1) * 0.1, f(t_dec, b, t_enc) * 0.1)
    return (cfg, ops, memory, mka, mkd, aa_s, ad_s, ca_s, cd_s, attns,
            qsum_s, *cots)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_train_backward_is_repeatable(dtype):
    """Two launches at full width give the same bits (no float atomics;
    every sum is taken in one fixed order)."""
    bargs = full_width_chain_inputs(dtype, b=16)
    got = decoder_bwd_chain_mega(*bargs)
    again = decoder_bwd_chain_mega(*bargs)
    torch.cuda.synchronize()
    for name, x, y in zip(BWD_OUT, got, again):
        assert torch.equal(x, y), f"{name}: two runs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("b", [5, 24])
def test_cuda_train_backward_full_width_matches_plain(b):
    """fp32 at full width, one M tile padded (B=5) and two (B=24)."""
    bargs = full_width_chain_inputs(torch.float32, b=b)
    got = decoder_bwd_chain_mega(*bargs)
    torch.cuda.synchronize()
    assert_outputs_close(BWD_OUT, got, decoder_bwd_chain_reference(*bargs),
                         PAIR_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("megakernel", [True, False])
def test_cuda_scan_bptt_routes(megakernel):
    """On CUDA tensors ``decoder_scan_bptt`` launches the pair when the
    config asks for it, else neither (the step loop launches the attention
    tail); both routes give the same gradients (fp32, 1e-4 relative)."""
    dev = cuda_device()
    dec, args, _ = train_inputs(dev)
    cfg, _, pre, memory, pm, mask, mka, mkd = args
    grads = {}
    for on in (megakernel, None):      # None: the plain pair on the CPU
        d = dec if on is not None else dec.cpu()
        where = dev if on is not None else "cpu"
        c = dataclasses.replace(cfg, decoder_megakernel=bool(on))
        p = {n: x.detach().to(where).requires_grad_(True)
             for n, x in core_params(d).items()}
        counts = (decoder_fwd_train_mega.launches,
                  decoder_bwd_chain_mega.launches, attention_tail.launches)
        out = decoder_scan_bptt(
            c, p, *(x.to(where) for x in (pre, memory, pm, mask, mka, mkd)))
        ((out[0] ** 2).sum() + (out[1] ** 2).sum()).backward()
        new = (decoder_fwd_train_mega.launches,
               decoder_bwd_chain_mega.launches, attention_tail.launches)
        if on is True:
            assert (new[0] - counts[0], new[1] - counts[1]) == (1, 1)
        else:
            assert new[:2] == counts[:2]
            assert (new[2] - counts[2]) == (T_DEC if on is False else 0)
        grads[on] = {n: x.grad.cpu() for n, x in p.items()}
    # relative to each gradient's largest value, with a floor of 1e-3 of
    # the largest gradient of all (the v bias's true gradient is zero)
    gscale = max(float(r.abs().max()) for r in grads[None].values())
    for n, r in grads[None].items():
        scale = float(r.abs().max()) + 1e-3 * gscale
        assert float((grads[megakernel][n] - r).abs().max()) < 1e-4 * scale, n


def conv_layer(c_in, c_out, k, dtype, seed, device):
    """A conv + BatchNorm layer with seeded non-identity statistics."""
    g = torch.Generator().manual_seed(seed)
    u = lambda *shape: torch.rand(*shape, generator=g)
    conv, bn = Conv1d(c_in, c_out, k), BatchNorm(c_out, 1e-5)
    bound = (c_in * k) ** -0.5
    with torch.no_grad():
        conv.weight.copy_((u(c_out, c_in, k) * 2 - 1) * bound)
        conv.bias.copy_((u(c_out) * 2 - 1) * bound)
        bn.weight.copy_(u(c_out) + 0.5)
        bn.bias.copy_(u(c_out) * 0.4 - 0.2)
        bn.running_mean.copy_(u(c_out) * 0.8 - 0.4)
        bn.running_var.copy_(u(c_out) * 1.7 + 0.3)
    for p in list(conv.parameters()) + list(bn.parameters()):
        p.data = p.data.to(dtype)
    return conv.to(device), bn.to(device)


# conv_bn_act kernel vs its plain version, as a share of the plain
# output's mean size.  fp32: the same fp32 products summed in another
# order.  bf16: both round the folded weight and the input at the same
# places; the tensor cores sum in another order (and the plain version's
# fp32 matmul of bf16-rounded values is exact per product too).
# Readings on an H100 at full width: 4.9e-5 (fp32), 8.3e-5 (bf16).
CONV_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-4}


def test_conv_bn_act_rejects_what_it_cannot_launch():
    conv, bn = conv_layer(8, 8, 5, torch.float32, 0, "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        conv_bn_act(torch.zeros(1, 8, 4, device="meta"), conv, bn, 1e-5,
                    "relu")
    with pytest.raises(ValueError, match="act must be"):
        conv_bn_act(torch.zeros(1, 8, 4), conv, bn, 1e-5, "gelu")


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["relu", "tanh", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in,c_out,k,b,t", [
    (32, 32, 5, 2, 13), (8, 32, 5, 3, 1), (32, 8, 5, 1, 37),
    (20, 70, 3, 2, 65), (80, 512, 5, 2, 130), (512, 80, 5, 1, 64),
    (36, 40, 7, 2, 129),
    # even kernel sizes ('same' padding one step longer after), and 8 and
    # 9 taps, which the bf16 kernel's second build holds
    (16, 16, 2, 1, 13), (32, 40, 4, 2, 65), (40, 32, 6, 1, 70),
    (40, 32, 8, 1, 70), (36, 40, 9, 2, 129),
    # the halo-8 and halo-16 builds: taps in groups of 9, fewer stages
    (512, 512, 11, 2, 130), (40, 72, 15, 1, 70), (64, 40, 33, 2, 129),
    (36, 40, 16, 1, 65),
    # past 33 taps (C6): tap groups of at most 30, each its own window
    (512, 512, 35, 2, 130), (40, 72, 64, 1, 70), (64, 40, 65, 2, 129),
    (36, 40, 129, 1, 200)])
def test_cuda_conv_bn_act_matches_plain(c_in, c_out, k, b, t, dtype, act):
    dev = cuda_device()
    conv, bn = conv_layer(c_in, c_out, k, dtype, seed=c_in + t, device=dev)
    x = torch.randn(b, c_in, t,
                    generator=torch.Generator().manual_seed(t)).to(dev)
    before = conv_bn_act.launches
    got = conv_bn_act(x, conv, bn, 1e-5, act)
    torch.cuda.synchronize()
    assert conv_bn_act.launches == before + 1
    ref = conv_bn_act_reference(x, conv, bn, 1e-5, act)
    assert got.shape == ref.shape == (b, c_out, t)
    assert got.dtype == torch.float32
    share = float((got - ref).abs().max()) / float(ref.abs().mean())
    assert share <= CONV_TOL[dtype], share


def conv_share(got, ref):
    return float((got - ref).abs().max()) / float(ref.abs().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 2, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [35, 64, 65, 129])
def test_cuda_conv_bn_act_long_kernels(k, dtype, split):
    """Kernel sizes past 33 taps (C6), odd and even, at each split of
    C_in over a cluster, against the plain version; two launches bit for
    bit."""
    dev = cuda_device()
    conv, bn = conv_layer(80, 512, k, dtype, seed=k, device=dev)
    x = torch.randn(1, 80, 37,
                    generator=torch.Generator().manual_seed(k)).to(dev)
    fold = folded_weights(conv, bn, 1e-5)
    before = conv_bn_act.launches
    got = _launch(x, fold, "tanh", split)
    again = _launch(x, fold, "tanh", split)
    torch.cuda.synchronize()
    assert conv_bn_act.launches == before + 2 and torch.equal(got, again)
    ref = conv_bn_act_reference(x, conv, bn, 1e-5, "tanh")
    assert conv_share(got, ref) <= CONV_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in,c_out,b,t", [
    (512, 512, 1, 32),      # one sentence's encoder layer
    (80, 512, 1, 37),       # ragged C_in: the postnet's first layer
    (36, 40, 2, 65),        # ragged C_in, two chunks
    (24, 70, 1, 9)])        # fewer chunks than blocks: empty slices
def test_cuda_conv_bn_act_split_matches_plain(c_in, c_out, b, t, dtype,
                                              split):
    """Every split of C_in across a cluster against the plain version, and
    two launches bit for bit."""
    dev = cuda_device()
    conv, bn = conv_layer(c_in, c_out, 5, dtype, seed=c_in + t, device=dev)
    x = torch.randn(b, c_in, t,
                    generator=torch.Generator().manual_seed(t)).to(dev)
    fold = folded_weights(conv, bn, 1e-5)
    got = _launch(x, fold, "tanh", split)
    torch.cuda.synchronize()
    ref = conv_bn_act_reference(x, conv, bn, 1e-5, "tanh")
    assert got.shape == ref.shape and conv_share(got, ref) <= CONV_TOL[dtype]
    assert torch.equal(_launch(x, fold, "tanh", split), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_conv_bn_act_is_repeatable(dtype):
    """At the wrapper's own split, two calls on one input give the same
    bits (the partials are summed in rank order, without atomics)."""
    dev = cuda_device()
    conv, bn = conv_layer(512, 512, 5, dtype, seed=7, device=dev)
    for b, t in ((1, 32), (4, 400)):
        x = torch.randn(b, 512, t,
                        generator=torch.Generator().manual_seed(b)).to(dev)
        assert torch.equal(conv_bn_act(x, conv, bn, 1e-5, "relu"),
                           conv_bn_act(x, conv, bn, 1e-5, "relu"))


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16)])
def test_cuda_conv_bn_act_takes_strided_input(x_dtype, w_dtype):
    """A transposed (B, T, C) input, as the encoder's embedding is, and a
    bf16 one, read in place: with the fold made a call dispatches nothing
    to PyTorch but its output's allocation (no copy, no cast, no fold),
    launches once, and gives the plain version's result."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    dev = cuda_device()
    conv, bn = conv_layer(40, 64, 5, w_dtype, seed=2, device=dev)
    x = torch.randn(3, 70, 40, generator=torch.Generator().manual_seed(2)
                    ).to(dev, x_dtype).transpose(1, 2)
    conv_bn_act(x, conv, bn, 1e-5, "relu")      # makes the fold
    before = conv_bn_act.launches
    with Ops() as seen:
        for _ in range(3):
            got = conv_bn_act(x, conv, bn, 1e-5, "relu")
    assert seen.ops == ["aten.empty.memory_format"] * 3, seen.ops
    assert conv_bn_act.launches == before + 3
    torch.cuda.synchronize()
    ref = conv_bn_act_reference(x, conv, bn, 1e-5, "relu")
    assert conv_share(got, ref) <= CONV_TOL[w_dtype]


@pytest.mark.cuda
def test_cuda_conv_bn_act_checks_inputs():
    dev = cuda_device()
    conv, bn = conv_layer(8, 8, 5, torch.float32, 0, dev)
    with pytest.raises(ValueError, match="does not fit"):
        conv_bn_act(torch.zeros(1, 9, 4, device=dev), conv, bn, 1e-5, "relu")
    with pytest.raises(TypeError, match="input dtype"):
        conv_bn_act(torch.zeros(1, 8, 4, device=dev, dtype=torch.float16),
                    conv, bn, 1e-5, "relu")
    # 35 taps, refused before C6's repair, now run in two tap groups
    long, _ = conv_layer(8, 8, 35, torch.float32, 0, dev)
    x = torch.randn(1, 8, 4, generator=torch.Generator().manual_seed(0))
    before = conv_bn_act.launches
    got = conv_bn_act(x.to(dev), long, bn, 1e-5, "relu")
    torch.cuda.synchronize()
    assert conv_bn_act.launches == before + 1
    ref = conv_bn_act_reference(x.to(dev), long, bn, 1e-5, "relu")
    assert conv_share(got, ref) <= CONV_TOL[torch.float32]
    cpu_conv, cpu_bn = conv_layer(8, 8, 5, torch.float32, 0, "cpu")
    with pytest.raises(ValueError, match="different devices"):
        conv_bn_act(torch.zeros(1, 8, 4, device=dev), cpu_conv, cpu_bn, 1e-5,
                    "relu")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_encoder_postnet_fused_route(dtype):
    """Eval encoder and postnet on the card: the fused route launches the
    kernel once a layer and agrees with the unfused (cuDNN, TF32 off)
    route: fp32 by summation order, bf16 by the folded weight's rounding."""
    dev = cuda_device()
    model = init_weights(Tacotron2(ModelConfig(**SMALL)), seed=3)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for bn in list(model.encoder.bns) + list(model.postnet.bns):
            bn.running_mean.copy_(torch.rand(bn.running_mean.shape,
                                             generator=g) - 0.5)
            bn.running_var.copy_(torch.rand(bn.running_var.shape,
                                            generator=g) + 0.5)
    if dtype == torch.bfloat16:
        model = cast_params_bf16(model)
    model = model.to(dev)
    tokens = torch.randint(0, 72, (3, 21), generator=g).to(dev)
    coarse = torch.randn(3, SMALL["n_mels"], 17, generator=g).to(dev)

    def run(on):
        replace_config(model, fused_convbn=on)
        with torch.no_grad():
            return (encoder_apply(model.encoder, tokens),
                    postnet_apply(model.postnet, coarse))

    before = conv_bn_act.launches
    fused = run(True)
    assert conv_bn_act.launches == before + 8
    unfused = run(False)
    assert conv_bn_act.launches == before + 8
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    for f, u in zip(fused, unfused):
        assert f.dtype == torch.float32 and f.shape == u.shape
        assert float((f - u).abs().max()) <= tol * max(
            1.0, float(u.abs().max()))


# ---------------------------------------------------------------------------
# configs whose widths are no multiples of 8 run the kernels on the card
# ---------------------------------------------------------------------------
# prenet_dim 12 pads P in the decoder kernels; "all odd" pads every width,
# gives the tail an A of 14 and memory rows of 120 bytes (60 in bf16), and
# the conv layers even kernel sizes
ODD = {"prenet_dim=12": dict(SMALL, prenet_dim=12),
       "all odd": dict(SMALL, prenet_dim=13, attention_dim=14, n_mels=9,
                       symbols_embedding_dim=30, encoder_embedding_dim=30,
                       decoder_rnn_dim=60, attention_rnn_dim=60,
                       encoder_kernel_size=6, postnet_kernel_size=4)}


def relative_errors(got, ref):
    """Per tensor, max |got - ref| over (max |ref| + 1e-3 x the largest
    value of all), the rule of test_cuda_scan_bptt_routes."""
    scale = max(float(r.abs().max()) for r in ref.values())
    return {n: float((got[n].detach().float().cpu() - r).abs().max())
            / (float(r.abs().max()) + 1e-3 * scale) for n, r in ref.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ODD))
def test_cuda_odd_widths_serve_the_decode_kernel(name):
    """``tacotron2_infer`` at widths that are no multiples of 8 launches
    the decode kernel and the conv kernel on the card and agrees with the
    CPU's plain request to 1e-4 relative; ``decoder_infer`` there agrees
    with the plain step loop at the decode's limits."""
    dev = cuda_device()
    model = init_weights(Tacotron2(ModelConfig(**ODD[name])), seed=0)
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, 72, (2, 11), generator=g)
    lengths = torch.tensor([11, 8])
    ref = tacotron2_infer(model, tokens, max_steps=MAX,
                          text_lengths=lengths, forced_stop_at=9,
                          device="cpu")
    model = model.to(dev)
    before = (decoder_infer_mega.launches, conv_bn_act.launches)
    got = tacotron2_infer(model, tokens, max_steps=MAX,
                          text_lengths=lengths, forced_stop_at=9,
                          device=dev)
    torch.cuda.synchronize()
    assert decoder_infer_mega.launches == before[0] + 1
    assert conv_bn_act.launches == before[1] + 8
    n = int(ref[1])
    assert int(got[1]) == n and torch.equal(got[2].cpu(), ref[2])
    errs = relative_errors({k: v[:, :n] for k, v in got[0]._asdict().items()},
                           {k: v[:, :n] for k, v in ref[0]._asdict().items()})
    assert max(errs.values()) < 1e-4, errs

    dec = model.decoder
    rng = np.random.default_rng(1)
    memory = torch.from_numpy((rng.standard_normal(
        (B, T_ENC, dec.cfg.encoder_embedding_dim)) * 0.5).astype(
            np.float32)).to(dev)
    mask = make_pad_mask(torch.tensor([T_ENC, 9]), T_ENC).to(dev)
    args = (dec, memory, MAX, 0.5, True, mask, "all", 9)
    with torch.no_grad():
        got = decoder_infer(*args)
        ref = decoder_infer_mega_reference(*args)
    assert decoder_infer_mega.launches == before[0] + 2
    assert torch.equal(got[4], ref[4]) and int(got[3]) == int(ref[3])
    for name_, g_, r in zip(DEC_OUTPUTS, got[:3], ref[:3]):
        torch.testing.assert_close(g_, r, atol=DEC_TOL[torch.float32][name_],
                                   rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ODD))
def test_cuda_odd_widths_train_the_kernel_pair(name):
    """At widths that are no multiples of 8, ``decoder_scan_bptt`` on the
    card runs the kernel pair (one launch each) and its gradients match
    the plain pair's on the CPU to 1e-4 relative (the rule of
    test_cuda_scan_bptt_routes); one ``train_step`` runs the same route
    and matches the same step on the CPU in its losses to 1e-4 relative
    and its BatchNorm statistics to 3e-4 (fp32, dropout off)."""
    dev = cuda_device()
    mc = ModelConfig(**dict(ODD[name], p_attention_dropout=0.0,
                            p_decoder_dropout=0.0, p_prenet_dropout=0.0,
                            p_postnet_dropout=0.0))
    counts = (decoder_fwd_train_mega.launches,
              decoder_bwd_chain_mega.launches)
    dec = init_weights(Tacotron2(mc), seed=0).decoder
    rng = np.random.default_rng(2)
    pre = torch.from_numpy(np.abs(rng.standard_normal(
        (T_DEC, B, mc.prenet_dim))).astype(np.float32) * 0.3)
    memory = torch.from_numpy((rng.standard_normal(
        (B, T_ENC, mc.encoder_embedding_dim)) * 0.5).astype(np.float32))
    mask = make_pad_mask(torch.tensor([T_ENC, T_ENC - 3]), T_ENC)
    grads = {}
    for where in ("cpu", dev):
        d = dec.to(where)
        p = {n: x.detach().clone().requires_grad_(True)
             for n, x in core_params(d).items()}
        m = memory.to(where)
        with torch.no_grad():
            pm = d.attention.memory_layer(m)
        out = decoder_scan_bptt(mc, p, pre.to(where), m, pm, mask.to(where),
                                None, None)
        ((out[0] ** 2).sum() + (out[1] ** 2).sum()).backward()
        grads[str(where)] = {n: x.grad.cpu() for n, x in p.items()}
    torch.cuda.synchronize()
    assert (decoder_fwd_train_mega.launches,
            decoder_bwd_chain_mega.launches) == (counts[0] + 1,
                                                 counts[1] + 1)
    errs = relative_errors(grads[str(dev)], grads["cpu"])
    assert max(errs.values()) < 1e-4, errs

    cfg = Config(model=mc, train=TrainConfig(precision="float32"))
    batch = collate([Example(
        text=rng.integers(0, mc.n_symbols, n).astype(np.int32),
        mel=(rng.standard_normal((mc.n_mels, m)) - 4.0).astype(np.float32))
        for n, m in ((13, 40), (9, 33))])
    tx = make_optimizer(cfg.train)
    states = {}
    for where in ("cpu", dev):
        state = create_train_state(cfg, seed=0, tx=tx, device=where)
        init_projection_bias(state.model, batch["mel"])
        states[str(where)] = train_step(state, batch, cfg=cfg, tx=tx,
                                        use_postnet=True,
                                        sigma_warmup_steps=100)[:2]
    torch.cuda.synchronize()
    assert (decoder_fwd_train_mega.launches,
            decoder_bwd_chain_mega.launches) == (counts[0] + 2,
                                                 counts[1] + 2)
    (ref, ref_losses), (got, got_losses) = states["cpu"], states[str(dev)]
    for name_ in ref_losses._fields:
        np.testing.assert_allclose(float(getattr(got_losses, name_)),
                                   float(getattr(ref_losses, name_)),
                                   rtol=1e-4, atol=1e-6, err_msg=name_)
    params = dict(got.model.named_parameters())
    for name_, r in ref.model.state_dict().items():
        if name_ not in params:
            g = got.model.state_dict()[name_].cpu()
            assert float((g - r).abs().max()) <= 3e-4 * max(
                1.0, float(r.abs().max())), name_


# --------------------------------------------------------------------------
# the batch sizes of the measurement tools: tools/bench_infer_scaling_torch.py
# decodes up to B=64, tools/bench_train_scaling_torch.py and
# tools/profile_train_step_torch.py train at B=128.  Full width, short
# decodes, against the plain versions at chip_smoke.py's full-width limits.
# --------------------------------------------------------------------------
def full_width_model(dtype):
    model = init_weights(Tacotron2(FULL), seed=0)
    return cast_params_bf16(model) if dtype == torch.bfloat16 else model


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 8, 16, 32, 64])
def test_decode_layout_at_tool_batches(b, dtype):
    """The decode kernel's shared memory at the mega sweep's batches: the
    location matrix stays resident and the per-row part grows by 12 bytes
    a row (rounded to 16)."""
    smem, resident = decode_smem(b, 128, FULL.attention_dim,
                                 FULL.location_kernel_size, dtype)
    one, _ = decode_smem(1, 128, FULL.attention_dim,
                         FULL.location_kernel_size, dtype)
    assert resident
    assert smem - one == (-(-b * 4 // 16) * 16 + -(-b * 8 // 16) * 16
                          - 16 - 16)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_at_tool_batches(dtype, b):
    """``decoder_infer_mega`` at full width and B=32, 64 (T_enc=128, ragged
    mask, 32 steps) against the plain step loop, by stop mode, with and
    without a forced stop: n_frames and frame_ends exactly, the rows past
    the stop exactly, each output within chip_smoke.py's ``DEC_TOL`` (the
    alignments' limit a share of their mean size)."""
    from chip_smoke import DEC_ALIGN_SHARE, DEC_TOL as FULL_DEC_TOL
    dev = cuda_device()
    dec = full_width_model(dtype).decoder.to(dev)
    rng = np.random.default_rng(b)
    memory = torch.from_numpy((rng.standard_normal(
        (b, 128, FULL.encoder_embedding_dim)) * 0.5).astype(np.float32)
                              ).to(dev)
    lens = torch.tensor([128 - 37 * (i % 3) for i in range(b)])
    mask = make_pad_mask(lens, 128).to(dev)
    for stop_mode, force in (("all", None), ("any", 20)):
        args = (dec, memory, 32, FULL.gate_threshold, True, mask, stop_mode,
                force)
        before = decoder_infer_mega.launches
        with torch.no_grad():
            got = decoder_infer_mega(*args)
            ref = decoder_infer_mega_reference(*args)
        torch.cuda.synchronize()
        assert decoder_infer_mega.launches == before + 1
        assert int(got[3]) == int(ref[3])
        assert torch.equal(got[4], ref[4])
        n = int(ref[3])
        tol = dict(FULL_DEC_TOL[dtype], aligns=DEC_ALIGN_SHARE[dtype] * float(
            ref[2][:, :n].abs().mean()))
        for name, g, r in zip(DEC_OUTPUTS, got[:3], ref[:3]):
            err = float((g[:, :n].float() - r[:, :n].float()).abs().max())
            assert err <= tol[name], (stop_mode, name, err, tol[name])
            assert torch.equal(g[:, n:], r[:, n:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_train_pair_at_tool_batch(dtype):
    """Both training kernels at full width and B=128 (eight 16-row batch
    tiles; T_enc=128, T_dec=16, dropout masks) against their plain
    versions, each output within chip_smoke.py's ``PAIR_TOL`` by this
    file's rule (two bf16 roundings, then a share of the mean size); the
    reverse chain's two runs bit for bit."""
    from chip_smoke import PAIR_TOL as FULL_PAIR_TOL
    dev = cuda_device()
    b, t_enc, t_dec = 128, 128, 16
    dec = full_width_model(dtype).decoder.to(dev)
    cfg = dec.cfg
    assert chain_plan(kernel_widths(cfg), b, t_enc, cfg.location_kernel_size,
                      dtype).m_tiles == 8
    rng = np.random.default_rng(3)
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev)
    pre = (f(t_dec, b, cfg.prenet_dim) * 0.3).abs()
    memory = f(b, t_enc, cfg.encoder_embedding_dim) * 0.5
    with torch.no_grad():
        pm = dec.attention.memory_layer(memory)
    mask = make_pad_mask(torch.tensor([t_enc - 37 * (i % 3)
                                       for i in range(b)]), t_enc).to(dev)
    keep = lambda: torch.from_numpy(
        rng.random((t_dec, b, cfg.decoder_rnn_dim)) < 0.9).to(dev)
    ops = kernel_operands(core_params(dec))
    args = (cfg, ops, pre, memory, pm, mask, keep(), keep())
    before = (decoder_fwd_train_mega.launches,
              decoder_bwd_chain_mega.launches)
    got = decoder_fwd_train_mega(*args)
    ref = decoder_fwd_train_reference(*args)
    torch.cuda.synchronize()
    for name, g, r in zip(FWD_OUT, got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        share = error_share(name, g, r)
        assert share <= FULL_PAIR_TOL[dtype][name], (name, share)
    _, attns, _, ca_s, _, cd_s, qsum_s, aa_s, ad_s = ref
    bargs = (cfg, ops, memory, args[6], args[7], aa_s, ad_s, ca_s, cd_s,
             attns, qsum_s, f(t_dec, b, cfg.n_mels + 1) * 0.5,
             f(t_dec, b, t_enc))
    got = decoder_bwd_chain_mega(*bargs)
    again = decoder_bwd_chain_mega(*bargs)
    torch.cuda.synchronize()
    assert (decoder_fwd_train_mega.launches - before[0],
            decoder_bwd_chain_mega.launches - before[1]) == (1, 2)
    for name, g, r in zip(BWD_OUT, got, decoder_bwd_chain_reference(*bargs)):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        assert bool(torch.isfinite(g).all()), name
        share = error_share(name, g, r)
        assert share <= FULL_PAIR_TOL[dtype][name], (name, share)
    for name, x, y in zip(BWD_OUT, got, again):
        assert torch.equal(x, y), f"{name}: two runs differ"
