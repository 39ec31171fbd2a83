"""One rank of the port's tensor-parallel tests on the CPU.

Launched by ``tests/test_torch_tp.py`` (one subprocess a rank):

    python tests/torch_tp_worker.py RANK WORLD TP INIT_FILE SPEC OUT

It joins a gloo group at ``file://INIT_FILE``, lays the ranks out on a
``data`` x ``model`` grid of width TP along ``model``, reads the inputs the
test made (``SPEC``, a pickle of numpy arrays) and writes its results to
``OUT`` (a pickle): the four model-axis autograd ops, the shards each rank
keeps, the train steps on its data index's rows (the gradients and state
gathered whole, the replicated state's digest) and, where the spec asks,
``train(tensor_parallel=TP)`` end to end.  Imports no JAX.
"""

import hashlib
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def _np(x):
    return x.detach().cpu().numpy().copy()


def ops_case(spec):
    """The four ops on this rank's shards: a gate-split product of two
    inputs (copy in, gather out) and an input-split one (split in, reduce
    out), each differentiated against ``sum(y * cot)``."""
    from tacotron2_torch.models.layers import linear
    from tacotron2_torch.parallel.collectives import (
        copy_to_model, gather_from_model, model_axis_size, model_index,
        reduce_from_model, split_to_model)
    n, m = model_axis_size(), model_index()
    x, h = (torch.from_numpy(spec[k]).requires_grad_(True) for k in "xh")
    rows = spec["wi"].shape[0] // n
    wi, wh = (torch.from_numpy(spec[k][m * rows:(m + 1) * rows].copy())
              .requires_grad_(True) for k in ("wi", "wh"))
    xm, hm = copy_to_model(x, h)
    y = gather_from_model(linear(xm, wi) + linear(hm, wh))
    (y * torch.from_numpy(spec["cot"])).sum().backward()
    cols = spec["w2"].shape[1] // n
    x2 = torch.from_numpy(spec["x2"]).requires_grad_(True)
    w2 = torch.from_numpy(spec["w2"][:, m * cols:(m + 1) * cols].copy()
                          ).requires_grad_(True)
    y2 = reduce_from_model(linear(split_to_model(x2), w2))
    (y2 * torch.from_numpy(spec["cot2"])).sum().backward()
    return {"y": _np(y), "x_grad": _np(x.grad), "h_grad": _np(h.grad),
            "wi_grad": _np(wi.grad), "wh_grad": _np(wh.grad),
            "y2": _np(y2), "x2_grad": _np(x2.grad), "w2_grad": _np(w2.grad)}


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
    return shard_train_state(state, tensor_parallel=True), tx


def replicated_digest(state) -> str:
    """sha256 over the replicated part of a train state: every parameter
    and moment but the shards, the BatchNorm statistics, the counters and
    the generator."""
    from tacotron2_torch.parallel.mesh import sharded_names
    sharded = sharded_names(state.model)
    h = hashlib.sha256()
    opt = state.opt_state
    for name, t in state.model.state_dict().items():
        if name not in sharded:
            h.update(_np(t).tobytes())
    for m in ("mu", "nu"):
        for name in sorted(opt[m]):
            if name not in sharded:
                h.update(_np(opt[m][name]).tobytes())
    h.update(repr((state.step, state.loss_step, opt["count"])).encode())
    h.update(state.generator.get_state().numpy().tobytes())
    return h.hexdigest()


def shards_of(state):
    """This rank's shards of the sharded parameters and of their moments."""
    from tacotron2_torch.parallel.mesh import sharded_names
    opt = state.opt_state
    names = sorted(sharded_names(state.model))
    return {"params": {n: _np(state.model.get_parameter(n)) for n in names},
            "mu": {n: _np(opt["mu"][n]) for n in names},
            "nu": {n: _np(opt["nu"][n]) for n in names}}


def step_case(spec, data_index):
    """From the same start, a ``train_step`` on this data index's rows
    (the test cut them), then an ``eval_step``: the losses, the gradients
    handed to the optimizer and the state after the step, gathered whole
    and laid out as the JAX package's trees; the shards kept before the
    step; the replicated state's digest."""
    from tacotron2_torch.models.tacotron2 import Tacotron2
    from tacotron2_torch.parallel import gather_params, gather_train_state
    from tacotron2_torch.parallel.collectives import gather_model_axis
    from tacotron2_torch.parallel.mesh import param_shardings
    from tacotron2_torch.train import step
    from tacotron2_torch.utils.weights import (export_jax_grads,
                                               export_jax_params)
    cfg = spec["cfg"]
    batch = spec["batch"][data_index]
    out = {}
    state, tx = _state(cfg, spec["params"], spec["model_state"], spec["seed"])
    out["shards"] = shards_of(state)
    out["specs"] = param_shardings(state.model, True)
    whole_model = Tacotron2(cfg.model)

    class Recorded:
        """The optimizer, keeping the gradients it is handed, whole."""
        @staticmethod
        def update(model, opt_state, grads, names):
            whole = {n: gather_model_axis(g, out["specs"][n].index("model"))
                     if n in names else g for n, g in grads.items()}
            out["grads"] = export_jax_grads(whole_model, whole)
            tx.update(model, opt_state, grads, names)

    state, losses, _ = step.train_step(state, batch, cfg=cfg, tx=Recorded,
                                       use_postnet=True,
                                       sigma_warmup_steps=800)
    out["losses"] = {k: float(v) for k, v in losses._asdict().items()}
    whole = gather_train_state(state)
    out["params"], out["state"] = export_jax_params(whole.model)
    out["moments"] = [export_jax_grads(whole.model, whole.opt_state[m])
                      for m in ("mu", "nu")]
    out["gathered_equal"] = all(
        torch.equal(a, b) for a, b in zip(gather_params(state.model).values(),
                                          whole.model.state_dict().values()))
    out["counters"] = (state.step, state.loss_step)
    out["digest"] = replicated_digest(state)
    losses, _, entropy = step.eval_step(state, batch, cfg=cfg,
                                        sigma_warmup_steps=800)
    out["eval"] = {k: float(v) for k, v in losses._asdict().items()}
    out["eval_entropy"] = float(entropy)
    return out


def train_case(spec, tp):
    """``train(tensor_parallel=tp)`` end to end: the counters, this rank's
    shards after it and the replicated state's digest."""
    from tacotron2_torch.train.loop import train
    state = train(spec["meta"], spec["ckpt"], cfg=spec["cfg"],
                  tensor_parallel=tp, device="cpu")
    return {"step": state.step, "loss_step": state.loss_step,
            "shards": shards_of(state)["params"],
            "digest": replicated_digest(state)}


def main() -> None:
    rank, world, tp = (int(a) for a in sys.argv[1:4])
    init_file, spec_path, out_path = sys.argv[4:7]
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    from tacotron2_torch.parallel import (data_axis_size, init_tensor_parallel,
                                          initialize_distributed,
                                          model_axis_size, model_index)
    from tacotron2_torch.parallel import rank as data_index
    assert initialize_distributed(init_method=f"file://{init_file}",
                                  world_size=world, rank=rank,
                                  backend="gloo")
    init_tensor_parallel(tp)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    d = data_index()
    out = {"grid": (data_axis_size(), model_axis_size(), d, model_index()),
           "ops": ops_case(spec["ops"]),
           "steps": {name: step_case(c, d)
                     for name, c in spec["steps"].items()}}
    if "train" in spec:
        out["train"] = train_case(spec["train"], tp)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()
    print(f"RANK {rank} DONE", flush=True)


if __name__ == "__main__":
    main()
