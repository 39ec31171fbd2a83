"""One rank of the port's two-rank data-parallel tests on the CPU.

Launched by ``tests/test_torch_parallel.py`` (one subprocess a rank):

    python tests/torch_dp_worker.py RANK WORLD INIT_FILE SPEC OUT

It joins a gloo group at ``file://INIT_FILE``, reads the inputs the test
made (``SPEC``, a pickle of numpy arrays), runs this rank's part of every
case on its own rows and writes its results to ``OUT`` (a pickle):
global BatchNorm, the loss on ragged rows, the train steps (dropout off,
drawn from the generator, and handed in), ``eval_step`` and ``train()``
and ``train(debug_overfit=True)`` end to end.  Imports no JAX.
"""

import hashlib
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def _np(x):
    return x.detach().cpu().numpy().copy()


def bn_case(spec, rows):
    from tacotron2_torch.models.layers import BatchNorm
    x, cot = spec["x"], spec["cot"]
    bn = BatchNorm(x.shape[1], spec["eps"], spec["momentum"])
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, name).copy_(torch.from_numpy(spec[name]))
    xr = torch.from_numpy(x[rows]).requires_grad_(True)
    y = bn(xr, train=True)
    (y * torch.from_numpy(cot[rows])).sum().backward()
    return {"y": _np(y), "x_grad": _np(xr.grad),
            "weight_grad": _np(bn.weight.grad), "bias_grad": _np(bn.bias.grad),
            "running_mean": _np(bn.running_mean),
            "running_var": _np(bn.running_var)}


def loss_case(spec, rows):
    from tacotron2_torch.config import GuidedAttentionConfig
    from tacotron2_torch.train.loss import tacotron2_loss
    preds = {k: torch.from_numpy(spec[k][rows]).requires_grad_(True)
             for k in ("mel_postnet", "mel_coarse", "gate_logits",
                       "alignments")}
    losses = tacotron2_loss(
        preds["mel_postnet"], preds["mel_coarse"], preds["gate_logits"],
        preds["alignments"], torch.from_numpy(spec["mel_target"][rows]),
        torch.from_numpy(spec["mel_lengths"][rows]),
        torch.from_numpy(spec["text_lengths"][rows]), spec["loss_step"],
        GuidedAttentionConfig(), sigma_warmup_steps=spec["sigma_warmup"])
    losses.total.backward()
    return {"losses": {k: float(v.detach())
                       for k, v in losses._asdict().items()},
            "grads": {k: _np(v.grad) for k, v in preds.items()}}


def _state(cfg, params, model_state, seed):
    from tacotron2_torch.models.tacotron2 import Tacotron2
    from tacotron2_torch.parallel import shard_train_state
    from tacotron2_torch.train.optim import make_optimizer
    from tacotron2_torch.train.state import TrainState
    from tacotron2_torch.utils.weights import load_jax_params
    model = Tacotron2(cfg.model)
    load_jax_params(model, params, model_state)
    tx = make_optimizer(cfg.train)
    state = TrainState(model=model, opt_state=tx.init(model), step=0,
                       loss_step=0,
                       generator=torch.Generator().manual_seed(seed))
    return shard_train_state(state), tx


def _torch_masks(masks):
    if masks is None:
        return None
    return {k: [torch.from_numpy(m) for m in v] if isinstance(v, list)
            else torch.from_numpy(v) for k, v in masks.items()}


def step_case(spec, rank):
    """From the same start, a ``train_step`` and a ``train_step_accum`` on
    this rank's rows (the test cut them), then an ``eval_step``: the
    losses, the gradients each step hands the optimizer, the parameters,
    BatchNorm state and Adam moments after it."""
    from tacotron2_torch.train import step
    from tacotron2_torch.utils.weights import (export_jax_grads,
                                               export_jax_params)
    cfg = spec["cfg"]
    batch = spec["batch"][rank]
    out = {}

    class Recorded:
        """The optimizer, keeping the gradients it is handed."""
        @staticmethod
        def update(model, opt_state, grads):
            out[f"grads_{what}"] = export_jax_grads(model, grads)
            tx.update(model, opt_state, grads)

    for what in ("step", "accum"):
        state, tx = _state(cfg, spec["params"], spec["model_state"],
                           spec["seed"])
        if what == "step":
            state, losses, _ = step.train_step(
                state, batch, cfg=cfg, tx=Recorded, use_postnet=True,
                sigma_warmup_steps=800,
                masks=_torch_masks(spec["masks"][rank]))
        else:
            state, losses, _ = step.train_step_accum(
                state, spec["micro"][rank], cfg=cfg, tx=Recorded,
                use_postnet=True, sigma_warmup_steps=800, accum_steps=2)
        out[what] = {k: float(v) for k, v in losses._asdict().items()}
        out[f"params_{what}"], out[f"state_{what}"] = export_jax_params(
            state.model)
        out[f"moments_{what}"] = [export_jax_grads(state.model,
                                                   state.opt_state[m])
                                  for m in ("mu", "nu")]
        out[f"counters_{what}"] = (state.step, state.loss_step)
    losses, _, entropy = step.eval_step(state, batch, cfg=cfg,
                                        sigma_warmup_steps=800)
    out["eval"] = {k: float(v) for k, v in losses._asdict().items()}
    out["eval_entropy"] = float(entropy)
    return out


def train_case(spec, rank):
    """``train()`` end to end, then ``train(debug_overfit=True)``."""
    from tacotron2_torch.train.loop import train
    state = train(spec["meta"], spec["ckpt"], cfg=spec["cfg"], device="cpu")
    digest = hashlib.sha256()
    for t in state.model.state_dict().values():
        digest.update(t.numpy().tobytes())
    debug = train(spec["meta"], spec["debug_ckpt"], cfg=spec["cfg"],
                  debug_overfit=True, device="cpu")
    return {"step": state.step, "loss_step": state.loss_step,
            "param0": float(next(state.model.parameters()).reshape(-1)[0]),
            "digest": digest.hexdigest(), "debug_step": debug.step}


def main() -> None:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init_file, spec_path, out_path = sys.argv[3:6]
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(2)
    from tacotron2_torch.parallel import initialize_distributed
    assert initialize_distributed(init_method=f"file://{init_file}",
                                  world_size=world, rank=rank,
                                  backend="gloo")
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    out = {"bn": bn_case(spec["bn"], spec["bn"]["rows"][rank]),
           "loss": [loss_case(c, c["rows"][rank]) for c in spec["loss"]],
           "steps": {name: step_case(c, rank)
                     for name, c in spec["steps"].items()},
           "train": train_case(spec["train"], rank)}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()
    print(f"RANK {rank} DONE", flush=True)


if __name__ == "__main__":
    main()
