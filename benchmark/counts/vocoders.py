"""Operations of the vocoders per mel frame (a multiply-add is two).

HiFi-GAN V1: each convolution of C_in -> C_out channels and ``k`` taps
costs 2 C_in C_out k an output sample (a transposed one, an input sample),
at the stage's samples per frame (the product of the upsampling rates so
far).  Griffin-Lim: the filterbank inversion's products (the
pseudo-inverse, then 100 projected steps of two products), and per round
one inverse and one forward real FFT of ``n_fft`` (2.5 n log2 n each),
with the final inverse.
"""

import math


def hifigan_frame(h: dict) -> int:
    ch = h["upsample_initial_channel"]
    total = 2 * h["n_mels"] * ch * 7
    per_frame = 1
    for u, k in zip(h["upsample_rates"], h["upsample_kernel_sizes"]):
        total += 2 * ch * (ch // 2) * k * per_frame
        ch //= 2
        per_frame *= u
        for rk, dils in zip(h["resblock_kernel_sizes"],
                            h["resblock_dilation_sizes"]):
            total += len(dils) * 2 * (2 * ch * ch * rk) * per_frame
    return total + 2 * ch * 1 * 7 * per_frame


def griffinlim_frame(audio: dict, n_iter: int) -> int:
    n, f = audio["n_fft"], audio["n_fft"] // 2 + 1
    fft = 2.5 * n * math.log2(n)
    inversion = 2 * f * audio["n_mels"] * (1 + 2 * 100)
    return int(inversion + (2 * n_iter + 1) * fft)
