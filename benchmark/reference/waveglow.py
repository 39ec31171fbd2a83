"""Plain WaveGlow for the reference (Prenger, Valle and Catanzaro,
arXiv:1811.00002, as NVIDIA's ``glow.py`` computes it): the inverse pass
(mel and noise -> audio) and the forward pass (audio and mel -> z and the
log-determinant), over a state dict of ``glow.py``'s keys with weight norm
folded (``upsample``, ``WN.{k}.start``, ``.in_layers.{i}``,
``.res_skip_layers.{i}``, ``.cond_layer``, ``.end``, ``convinv.{k}.conv``),
in plain fp32 ``torch``.  Products read their inputs through the rounding
``q`` of ``model.rounding``.

Widths ``w`` are the configuration file's ``waveglow`` block.  The mel is
upsampled by the transposed convolution and cut by ``kernel - stride``
samples, then folded by ``unfold`` into groups of ``n_group``; each WN's
conditioning is its whole ``cond_layer`` product, sliced by layer.  The
noise is the (B, n_group, groups) standard normal draw of
:func:`noise`; in the inverse pass channels ``n_group - n_k`` onwards of
``sigma * z`` (n_k the last flow's channels) start the audio and each
``n_early_size`` pair before them joins, in front, after the flow that
split it off in the forward pass: the forward pass's outputs, in order.
Rows are computed in blocks of ``rows``, so a batch of 64 rows of 512
frames fits one card.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .model import Round, rounding


def flow_channels(w: dict) -> List[int]:
    """The channels each flow k works on, in forward order."""
    out, n = [], w["n_group"]
    for k in range(w["n_flows"]):
        if k % w["n_early_every"] == 0 and k > 0:
            n -= w["n_early_size"]
        out.append(n)
    return out


def shapes(w: dict) -> Dict[str, Tuple[int, ...]]:
    """Every tensor of the state dict by name."""
    m, c, k = w["n_mel_channels"], w["n_channels"], w["kernel_size"]
    out = {"upsample.weight": (m, m, w["upsample_kernel"]),
           "upsample.bias": (m,)}
    for f, n in enumerate(flow_channels(w)):
        h, p = n // 2, f"WN.{f}"
        out[f"convinv.{f}.conv.weight"] = (n, n, 1)
        out[f"{p}.start.weight"], out[f"{p}.start.bias"] = (c, h, 1), (c,)
        for i in range(w["n_layers"]):
            rs = 2 * c if i < w["n_layers"] - 1 else c
            out[f"{p}.in_layers.{i}.weight"] = (2 * c, c, k)
            out[f"{p}.in_layers.{i}.bias"] = (2 * c,)
            out[f"{p}.res_skip_layers.{i}.weight"] = (rs, c, 1)
            out[f"{p}.res_skip_layers.{i}.bias"] = (rs,)
        out[f"{p}.cond_layer.weight"] = (2 * c * w["n_layers"],
                                         m * w["n_group"], 1)
        out[f"{p}.cond_layer.bias"] = (2 * c * w["n_layers"],)
        out[f"{p}.end.weight"], out[f"{p}.end.bias"] = (2 * h, c, 1), (2 * h,)
    return out


def noise(batch: int, groups: int, w: dict, seed: int, device
          ) -> torch.Tensor:
    """The standard normal (B, n_group, groups) draw from a generator on
    ``device`` seeded ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(batch, w["n_group"], groups, generator=gen,
                       device=device)


def _conv(sd, name, x, q: Round, dilation: int = 1):
    wt = sd[name + ".weight"]
    k = wt.shape[-1]
    return F.conv1d(q(x), q(wt), sd[name + ".bias"].float(),
                    dilation=dilation, padding=(k - 1) * dilation // 2)


def _spect(sd, w: dict, mel, q: Round):
    """Upsampled, cut and folded mel: (B, n_mel * n_group, groups)."""
    g = w["n_group"]
    spect = F.conv_transpose1d(q(mel), q(sd["upsample.weight"]),
                               sd["upsample.bias"].float(),
                               stride=w["upsample_stride"])
    spect = spect[:, :, :-(w["upsample_kernel"] - w["upsample_stride"])]
    spect = spect.unfold(2, g, g).permute(0, 2, 1, 3)
    return spect.contiguous().view(spect.shape[0], spect.shape[1],
                                   -1).permute(0, 2, 1)


def wn(sd, p: str, x0, spect, w: dict, q: Round):
    """WN of the coupling's first half and the folded mel: (b, s) stacked
    on the channels, (B, 2 h, groups)."""
    c, n = w["n_channels"], w["n_layers"]
    x = _conv(sd, f"{p}.start", x0, q)
    cond = _conv(sd, f"{p}.cond_layer", spect, q)
    skip = 0.0
    for i in range(n):
        a = (_conv(sd, f"{p}.in_layers.{i}", x, q, dilation=2 ** i)
             + cond[:, 2 * c * i:2 * c * (i + 1)])
        r = _conv(sd, f"{p}.res_skip_layers.{i}",
                  torch.tanh(a[:, :c]) * torch.sigmoid(a[:, c:]), q)
        if i < n - 1:
            x = x + r[:, :c]
            skip = skip + r[:, c:]
        else:
            skip = skip + r
    return _conv(sd, f"{p}.end", skip, q)


def w_inverse(wt) -> torch.Tensor:
    """W^-1 of a (n, n, 1) weight: float64 on the host, cast to fp32."""
    inv = torch.linalg.inv(wt[:, :, 0].detach().cpu().double())
    return inv.float().to(wt.device)[:, :, None]


def _infer_rows(sd, w: dict, mel, z, sigma: float, q: Round):
    spect = _spect(sd, w, mel, q)
    every, size = w["n_early_every"], w["n_early_size"]
    audio = sigma * z[:, w["n_group"] - flow_channels(w)[-1]:]
    for k in reversed(range(w["n_flows"])):
        h = audio.shape[1] // 2
        out = wn(sd, f"WN.{k}", audio[:, :h], spect, w, q)
        a1 = (audio[:, h:] - out[:, :h]) / torch.exp(out[:, h:])
        audio = torch.cat([audio[:, :h], a1], 1)
        w_inv = w_inverse(sd[f"convinv.{k}.conv.weight"])
        audio = F.conv1d(q(audio), q(w_inv))
        if k % every == 0 and k > 0:
            j = (k // every - 1) * size
            audio = torch.cat([sigma * z[:, j:j + size], audio], 1)
    return audio.permute(0, 2, 1).reshape(audio.shape[0], -1)


@torch.no_grad()
def infer(sd, w: dict, mel, z, sigma: float, q: Round = rounding("float32"),
          rows: int = 4) -> torch.Tensor:
    """mel (B, n_mel, T), z (B, n_group, T * stride / n_group) -> audio
    (B, T * stride), ``rows`` rows at a time."""
    return torch.cat([_infer_rows(sd, w, mel[i:i + rows].float(),
                                  z[i:i + rows].float(), sigma, q)
                      for i in range(0, mel.shape[0], rows)])


@torch.no_grad()
def forward(sd, w: dict, mel, audio, q: Round = rounding("float32")):
    """audio (B, T * stride) and its mel -> (z (B, n_group, groups), the
    log-determinant of the map per row): ``glow.py``'s forward pass,
    ``exp(s) * a1 + b`` and W a flow, the early outputs concatenated in
    order."""
    g, every, size = w["n_group"], w["n_early_every"], w["n_early_size"]
    spect = _spect(sd, w, mel.float(), q)
    audio = audio.float().unfold(1, g, g).permute(0, 2, 1)
    groups = audio.shape[2]
    outputs, log_det = [], torch.zeros(audio.shape[0], dtype=torch.float64,
                                       device=audio.device)
    for k in range(w["n_flows"]):
        if k % every == 0 and k > 0:
            outputs.append(audio[:, :size])
            audio = audio[:, size:]
        wt = sd[f"convinv.{k}.conv.weight"]
        audio = F.conv1d(q(audio), q(wt))
        log_det += groups * torch.logdet(wt[:, :, 0].double().cpu()).item()
        h = audio.shape[1] // 2
        out = wn(sd, f"WN.{k}", audio[:, :h], spect, w, q)
        s = out[:, h:]
        audio = torch.cat([audio[:, :h], torch.exp(s) * audio[:, h:]
                           + out[:, :h]], 1)
        log_det += s.double().sum((1, 2))
    outputs.append(audio)
    return torch.cat(outputs, 1), log_det
