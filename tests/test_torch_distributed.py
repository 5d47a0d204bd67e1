"""The port's process-group start (gpsat_tpu_torch.parallel.multihost.
init_distributed, the JAX package's init_distributed with
torch.distributed in the place of jax.distributed): its no-op cases, the
arguments it hands to init_process_group, and two gloo processes on the CPU
that rendezvous over TCP on 127.0.0.1 and read (rank, 2) from process_info.
Every process runs in a subprocess with its own time limit, so a hung
rendezvous fails the test and leaves no process group in the test worker."""

import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist

from gpsat_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT = 120     # seconds a subprocess may take


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_all(scripts, env=None):
    """Start every script at once, wait for each within LIMIT, kill the rest
    on a timeout; returns [(returncode, stdout, stderr)]."""
    env = env or [{}] * len(scripts)
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(s)], cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO, **e},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for s, e in zip(scripts, env)]
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=LIMIT)
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def clear_env(monkeypatch):
    for k in ("GPSAT_PROCESS_ID", "GPSAT_NUM_PROCESSES", "SLURM_PROCID",
              "SLURM_NTASKS", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)


def test_single_process_is_a_no_op(monkeypatch):
    clear_env(monkeypatch)
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append(k))
    multihost.init_distributed()
    assert calls == [] and not dist.is_initialized()
    assert multihost.process_info() == (0, 1)


def test_arguments_reach_init_process_group(monkeypatch):
    """"host:port" becomes tcp://host:port; nccl with a card (the card
    picked by local_device_ids), gloo without; rank and world from the
    arguments, else from process_info."""
    clear_env(monkeypatch)
    calls, cards = [], []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **k: calls.append(k))
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    multihost.init_distributed("node1:2345", num_processes=4, process_id=3,
                               local_device_ids=[1, 0])
    assert cards == [1]
    k = calls.pop()
    assert (k["backend"], k["init_method"], k["world_size"], k["rank"]) == \
        ("nccl", "tcp://node1:2345", 4, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("GPSAT_PROCESS_ID", "2")
    monkeypatch.setenv("GPSAT_NUM_PROCESSES", "3")
    multihost.init_distributed(local_device_ids=0)
    assert cards == [1]
    k = calls.pop()
    assert (k["backend"], k["init_method"], k["world_size"], k["rank"]) == \
        ("gloo", None, 3, 2)


def test_already_initialised_is_a_no_op():
    """A process with a group (world 1) calls init_distributed with another
    address and world: nothing changes."""
    port = free_port()
    (rc, out, err), = run_all([f"""
        import torch.distributed as dist
        from gpsat_tpu_torch.parallel import multihost
        dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}",
                                world_size=1, rank=0)
        multihost.init_distributed("127.0.0.1:1", num_processes=2,
                                   process_id=1)
        print("info", multihost.process_info())
        dist.destroy_process_group()
    """])
    assert rc == 0, err[-2000:]
    assert "info (0, 1)" in out


@pytest.mark.parametrize("how", ["arguments", "environment"])
def test_two_gloo_processes(how):
    """Two processes start one group: by coordinator address, world and rank
    as arguments, or from GPSAT_PROCESS_ID / GPSAT_NUM_PROCESSES and
    MASTER_ADDR / MASTER_PORT with no argument. Each then reads (rank, 2)
    from process_info, its group is gloo, and a barrier passes."""
    port = free_port()
    scripts, env = [], []
    for r in range(2):
        call = (f'multihost.init_distributed("127.0.0.1:{port}", '
                f'num_processes=2, process_id={r})'
                if how == "arguments" else "multihost.init_distributed()")
        scripts.append(f"""
            import torch.distributed as dist
            from gpsat_tpu_torch.parallel import multihost
            {call}
            dist.barrier()
            print("info", multihost.process_info(), dist.get_backend())
            dist.destroy_process_group()
        """)
        env.append({"GPSAT_PROCESS_ID": str(r), "GPSAT_NUM_PROCESSES": "2",
                    "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
                   if how == "environment" else {})
    results = run_all(scripts, env)
    for r, (rc, out, err) in enumerate(results):
        assert rc == 0, err[-2000:]
        assert f"info ({r}, 2) gloo" in out, out
