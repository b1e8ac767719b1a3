"""The port's launch layer (``oktopk_tpu_torch/launch.py``) against the
JAX package's (``oktopk_tpu/launch.py``) on the same environments: every
case of ``tests/test_launch.py``, then what the port adds (the
``torchrun`` rule, the local rank, the device it picks, the
multi-process refusals of the entry points)."""

import pytest
import torch

from oktopk_tpu import launch as jax_launch
from oktopk_tpu_torch import launch

NODELISTS = ["nid01234", "a,b,c", "nid0[1234-1236]", "nid0[1234-1235,1240]",
             "n[08-10]", "login1,nid0[0001-0002]", "n[1-2]-ib"]

ENVS = {
    "single": {},
    "slurm": {"SLURM_PROCID": "3", "SLURM_NTASKS": "16",
              "SLURM_NODELIST": "nid0[1234-1249]"},
    "slurm step nodelist": {"SLURM_PROCID": "0", "SLURM_NTASKS": "2",
                            "SLURM_NODELIST": "wrong[1-9]",
                            "SLURM_STEP_NODELIST": "right1,right2"},
    "explicit over slurm": {"OKTOPK_NUM_PROCS": "4", "OKTOPK_PROC_ID": "1",
                            "OKTOPK_COORDINATOR": "tpu-host-0",
                            "SLURM_PROCID": "9", "SLURM_NTASKS": "99"},
    "explicit with port": {"OKTOPK_NUM_PROCS": "2", "OKTOPK_PROC_ID": "0",
                           "OKTOPK_COORDINATOR": "host:1234"},
    "openmpi": {"OMPI_COMM_WORLD_RANK": "2", "OMPI_COMM_WORLD_SIZE": "8",
                "OKTOPK_COORDINATOR": "head"},
    "slurm over torchrun": {"SLURM_PROCID": "1", "SLURM_NTASKS": "2",
                            "SLURM_NODELIST": "n[1-2]", "RANK": "5",
                            "WORLD_SIZE": "8"},
}
RAISES = {
    "openmpi without coordinator": ({"OMPI_COMM_WORLD_RANK": "0",
                                     "OMPI_COMM_WORLD_SIZE": "8"},
                                    "OKTOPK_COORDINATOR"),
    "explicit without proc id": ({"OKTOPK_NUM_PROCS": "4",
                                  "OKTOPK_COORDINATOR": "h"},
                                 "OKTOPK_PROC_ID"),
}
FIELDS = ("process_id", "num_processes", "coordinator", "source",
          "is_coordinator")


@pytest.mark.parametrize("nodelist", NODELISTS)
def test_expand_nodelist_matches_jax(nodelist):
    assert launch.expand_nodelist(nodelist) == \
        jax_launch.expand_nodelist(nodelist)


@pytest.mark.parametrize("name", list(ENVS))
def test_discover_matches_jax(name):
    env = ENVS[name]
    got, want = launch.discover(env=env), jax_launch.discover(env=env)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert launch.DEFAULT_PORT == jax_launch.DEFAULT_PORT


@pytest.mark.parametrize("name", list(RAISES))
def test_discover_raises_as_jax(name):
    env, match = RAISES[name]
    for discover in (launch.discover, jax_launch.discover):
        with pytest.raises(RuntimeError, match=match):
            discover(env=env)


def test_torchrun_rule():
    env = {"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1",
           "MASTER_ADDR": "10.0.0.2", "MASTER_PORT": "29500"}
    penv = launch.discover(env=env)
    assert (penv.process_id, penv.num_processes, penv.coordinator,
            penv.source, penv.local_rank) == (3, 4, "10.0.0.2:29500",
                                              "torchrun", 1)
    # the JAX package has no such rule: one process there
    assert jax_launch.discover(env=env).source == "single"


@pytest.mark.parametrize("env,want", [
    ({}, 0),
    ({"LOCAL_RANK": "2", "SLURM_LOCALID": "5"}, 2),
    ({"SLURM_PROCID": "7", "SLURM_NTASKS": "8", "SLURM_LOCALID": "3"}, 3),
    ({"OMPI_COMM_WORLD_RANK": "5", "OMPI_COMM_WORLD_SIZE": "8",
      "OKTOPK_COORDINATOR": "h", "OMPI_COMM_WORLD_LOCAL_RANK": "1"}, 1),
])
def test_local_rank(env, want):
    assert launch.discover(env=env).local_rank == want


def test_device_is_the_local_rank_card(monkeypatch):
    """``cuda:{local_rank}``, a named device as named, and a local rank
    beyond the host's cards raises: ranks never fold onto card 0."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    env = {"RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "1"}
    assert launch.local_device(launch.discover(env=env)) == \
        torch.device("cuda", 1)
    assert launch.local_device(launch.discover(env=env), "cuda:0") == \
        torch.device("cuda", 0)
    env["LOCAL_RANK"] = "2"
    with pytest.raises(RuntimeError, match="local rank 2 has no card"):
        launch.local_device(launch.discover(env=env))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.local_device(launch.discover(env={}))
    assert launch.local_device(launch.discover(env={}), "cpu").type == "cpu"


def test_maybe_initialize_single_process_noop():
    import torch.distributed as dist
    penv, dev = launch.maybe_initialize("gloo", "cpu", env={})
    assert penv.num_processes == 1 and dev.type == "cpu"
    assert not dist.is_initialized()


def test_nccl_needs_a_card():
    env = {"OKTOPK_NUM_PROCS": "2", "OKTOPK_PROC_ID": "0",
           "OKTOPK_COORDINATOR": "localhost"}
    with pytest.raises(ValueError, match="nccl"):
        launch.maybe_initialize("nccl", "cpu", env=env)


def test_entry_points_refuse_what_they_cannot_run(monkeypatch):
    """On a 4-process launch: ``main_trainer`` and ``main_bert`` refuse a
    ``--num-workers`` other than the world size (``main_bert`` no longer
    refuses the launch itself: each rank draws its own worker's dropout
    masks); the Trainer refuses a comm of another size (all before any
    rendezvous)."""
    from oktopk_tpu_torch.comm import StackedComm
    from oktopk_tpu_torch.config import TrainConfig
    from oktopk_tpu_torch.train import main_bert, main_trainer
    from oktopk_tpu_torch.train.trainer import Trainer

    for k, v in {"RANK": "0", "WORLD_SIZE": "4",
                 "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="one worker per process"):
        main_trainer.build_trainer(main_trainer.parse_args(
            ["--device", "cpu", "--num-workers", "2"]))
    with pytest.raises(ValueError, match="one worker per process"):
        main_bert.build_trainer(main_bert.parse_args(
            ["--model", "bert_tiny", "--device", "cpu", "--num-workers",
             "2"]))
    with pytest.raises(ValueError, match="comm of 2 workers"):
        Trainer(TrainConfig(dnn="vgg16", num_workers=4), device="cpu",
                comm=StackedComm(2))
