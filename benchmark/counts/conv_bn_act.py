"""Kernel #5, the folded eval-mode convolution + BatchNorm + activation
(``conv_bn_act`` in ``ops/convbn_kernel.py``): the work one launch's
inputs need, over ``t`` positions (the sum of the batch's rows' true
lengths; the kernel also runs the padding, which is left out) with C_out
filters of ``k`` taps.  Bytes: input, folded weights and bias, output,
once, at ``dt`` bytes an element."""


def ops(t: int, c_in: int, c_out: int, k: int) -> int:
    return 2 * t * c_in * c_out * k


def nbytes(t: int, c_in: int, c_out: int, k: int, dt: int) -> int:
    return dt * (c_in * t + c_out * c_in * k + c_out + c_out * t)


def launches(m: dict, tokens: int, frames: int):
    """(t, c_in, c_out, k) of the eight launches of one serving forward:
    the encoder's convolutions over the rows' ``tokens``, the postnet's
    over their ``frames`` up to each row's stop."""
    e = m["encoder_embedding_dim"]
    out = [(tokens, e, e, m["encoder_kernel_size"])
           for _ in range(m["encoder_n_convolutions"])]
    n, c = m["postnet_n_convolutions"], m["postnet_embedding_dim"]
    dims = [m["n_mels"]] + [c] * (n - 1) + [m["n_mels"]]
    out += [(frames, dims[i], dims[i + 1], m["postnet_kernel_size"])
            for i in range(n)]
    return out
