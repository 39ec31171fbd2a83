"""BigVGAN (arXiv:2206.04658, NVIDIA's ``bigvgan_22khz_80band.json``)
counted from its widths ``h`` (the configuration's ``bigvgan`` block):
parameters, convolution operations a mel frame (a multiply-add is two) and
the anti-aliased activations' operations and bytes a mel frame.

Convolutions: C_in -> C_out with ``k`` taps cost 2 C_in C_out k an output
sample (a transposed one, an input sample), at the samples a frame of the
stage (the product of the upsampling rates so far).

Activations (109 a call at the published widths): each of a (C, T) input
at ``ratio`` = 2 times the rate.  Operations an input element: the
upsampler's ``taps`` multiply-adds spread over its ``ratio`` outputs (2
taps), the scale by the ratio (``ratio``), the snake a doubled sample
(multiply, sine, square, multiply, add: 5 ``ratio``, a sine counted as
one), the downsampler's ``taps`` multiply-adds an output (2 taps): 60.
Bytes: the input read once and the output written once, at ``dt`` bytes
a value; what the plain passes read and write besides is what a fused
pass would save.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple


def _stages(h: dict) -> List[Tuple[int, int, int, int]]:
    """Per stage: (channels in, channels out, samples a frame in, out)."""
    out, ch, spf = [], h["upsample_initial_channel"], 1
    for u in h["upsample_rates"]:
        out.append((ch, ch // 2, spf, spf * u))
        ch, spf = ch // 2, spf * u
    return out


def params(h: dict) -> int:
    ch = h["upsample_initial_channel"]
    total = h["num_mels"] * ch * 7 + ch
    for (c_in, c, _, _), k in zip(_stages(h), h["upsample_kernel_sizes"]):
        total += c_in * c * k + c
        for rk, dils in zip(h["resblock_kernel_sizes"],
                            h["resblock_dilation_sizes"]):
            total += len(dils) * (2 * (c * c * rk + c) + 2 * 2 * c)
    c_last = _stages(h)[-1][1]
    return total + 2 * c_last + c_last * 7 + 1


def frame(h: dict) -> int:
    """Convolution operations a mel frame."""
    ch = h["upsample_initial_channel"]
    total = 2 * h["num_mels"] * ch * 7
    for (c_in, c, spf_in, spf), k in zip(_stages(h),
                                         h["upsample_kernel_sizes"]):
        total += 2 * c_in * c * k * spf_in
        for rk, dils in zip(h["resblock_kernel_sizes"],
                            h["resblock_dilation_sizes"]):
            total += len(dils) * 2 * (2 * c * c * rk) * spf
    _, c, _, spf = _stages(h)[-1]
    return total + 2 * c * 7 * spf


def activations(h: dict) -> int:
    """Anti-aliased activations a call."""
    per_stage = sum(2 * len(d) for d in h["resblock_dilation_sizes"])
    return len(h["upsample_rates"]) * per_stage + 1


def act_elems(h: dict) -> int:
    """Elements of the activations' inputs a mel frame."""
    per_stage = sum(2 * len(d) for d in h["resblock_dilation_sizes"])
    total = sum(per_stage * c * spf for _, c, _, spf in _stages(h))
    _, c, _, spf = _stages(h)[-1]
    return total + c * spf


def act_ops_per_elem(h: dict) -> int:
    r, taps = h["aa_ratio"], h["aa_taps"]
    return 2 * taps + r + 5 * r + 2 * taps


def act_ops(h: dict, frames: int) -> int:
    return act_ops_per_elem(h) * act_elems(h) * frames


def act_bytes(h: dict, frames: int, dt: int = 4) -> int:
    return 2 * dt * act_elems(h) * frames


def nbytes(h: dict, frames: Iterable[int], dt: int = 4) -> int:
    """One call over rows of ``frames`` mel frames each, the whole
    vocoder: the weights once, each frame's mel in and samples out."""
    hop = _stages(h)[-1][3]
    return dt * (params(h) + (h["num_mels"] + hop)
                 * sum(int(f) for f in frames))
