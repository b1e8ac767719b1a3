"""The system under test: the PyTorch and CUDA port, ``oktopk_tpu_torch``.

The trainer is built through the command line's own ``build_trainer``
(``oktopk_tpu_torch.train.<cli>.build_trainer``, the module a
configuration names) from the configuration's and the cell's arguments.
The benchmark hands it its weights and reads back, in the JAX leaf order
and layout both sides share, its parameters and the optimizer state the
first step leaves. Nothing else of the program is reached.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import torch

# the flags the harness sets itself
_OWNED = ("--num-workers", "--batch-size", "--compressor", "--density",
          "--compute-dtype", "--seed", "--device", "--data-dir")


def cli_args(config: Dict, workload: Dict, seed: int, device) -> List[str]:
    extra = list(config["port"]["args"]) + list(workload["port_args"])
    clash = [a for a in extra if a in _OWNED]
    if clash:
        raise ValueError(f"port arguments {clash} are the harness's own")
    return extra + [
        "--num-workers", str(config["data_parallel_workers"]),
        "--batch-size", str(workload["batch_per_worker"]),
        "--compressor", workload["compressor"],
        "--density", repr(workload["density"]),
        "--compute-dtype", workload["compute_dtype"],
        "--seed", str(seed), "--device", str(device),
        # no corpus: the program's own loader is built and never read
        "--data-dir", "gpubench/no-corpus"]


def build_trainer(config: Dict, workload: Dict, seed: int, device):
    cli = importlib.import_module(
        f"oktopk_tpu_torch.train.{config['port']['cli']}")
    args = cli.parse_args(cli_args(config, workload, seed, device))
    return cli.build_trainer(args)[0]


def check_layout(trainer, table) -> None:
    """Raise unless the program's leaves are the reference's, by path
    and JAX shape, in the same order."""
    mine = [(name, tuple(shape)) for (name, _, _), shape in
            zip(trainer.leaves, trainer.jax_shapes)]
    want = [(path, tuple(shape)) for path, shape, _ in table]
    if mine != want:
        diff = next((a, b) for a, b in zip(mine + [None] * len(want),
                                           want + [None] * len(mine))
                    if a != b)
        raise ValueError(f"the program's leaves differ from the "
                         f"reference's at {diff}")


def _layout():
    from oktopk_tpu_torch.models.layout import from_jax_layout, to_jax_layout
    return from_jax_layout, to_jax_layout


@torch.no_grad()
def load_weights(trainer, flat: torch.Tensor) -> None:
    """Copy the flat weights (JAX order and layout) into the program."""
    from_jax, _ = _layout()
    off = 0
    for (_, p, lay), shape in zip(trainer.leaves, trainer.jax_shapes):
        size = p.numel()
        p.copy_(from_jax(flat[off:off + size].view(shape), lay))
        off += size
    if off != flat.numel():
        raise ValueError(f"{flat.numel()} weights for {off} parameters")


@torch.no_grad()
def flat_params(trainer) -> torch.Tensor:
    _, to_jax = _layout()
    return torch.cat([to_jax(p.detach(), lay).reshape(-1)
                      for _, p, lay in trainer.leaves])


@torch.no_grad()
def optimizer_state(trainer) -> torch.Tensor:
    """The state the optimizer's first step leaves, flat in JAX order:
    BertAdam's first moment, or SGD's momentum buffers."""
    opt = trainer.optimizer
    if getattr(opt, "m", None) is not None:
        return opt.m.detach().clone()
    bufs = getattr(opt, "momentum_buf", None)
    if bufs:
        _, to_jax = _layout()
        return torch.cat([to_jax(b, lay).reshape(-1)
                          for b, (_, _, lay) in zip(bufs, trainer.leaves)])
    raise ValueError(f"no first-step state in {type(opt).__name__}")


_OPTIMIZER_FIELDS = {"warmup_proportion": "warmup", "total_steps": "t_total"}


def check_config(trainer, config: Dict, workload: Dict,
                 exchange_settings: Dict) -> None:
    """Raise unless the program runs as the configuration states: its
    workers, precision, exchange and the exchange's own settings (its
    reference's ``program_settings``), and optimizer."""
    seen = {"workers": (trainer.cfg.num_workers,
                        config["data_parallel_workers"]),
            "compute_dtype": (trainer.cfg.compute_dtype,
                              workload["compute_dtype"]),
            "compressor": (trainer.cfg.compressor, workload["compressor"]),
            "density": (trainer.algo_cfg.density, workload["density"])}
    for key, want in exchange_settings.items():
        seen[key] = (getattr(trainer.algo_cfg, key), want)
    opt = trainer.optimizer
    for key, want in config["training"].items():
        if key != "optimizer":
            seen[key] = (getattr(opt, _OPTIMIZER_FIELDS.get(key, key)), want)
    if getattr(opt, "nesterov", False):
        seen["nesterov"] = (True, False)
    bad = {k: v for k, v in seen.items() if v[0] != v[1]}
    if bad:
        raise ValueError(f"the program departs from the configuration "
                         f"(program, configured): {bad}")
