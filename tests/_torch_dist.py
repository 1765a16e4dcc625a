"""Process groups for the port's sharded tests.

* ``world1`` — a fixture: a gloo group of one rank in this process (from a
  ``HashStore``: no launcher, no network), destroyed after the test, with
  the port's activation context cleared;
* ``run_ranks(tmp_path, world, body)`` — ``body`` (Python source defining
  ``worker(rank, world, io)``) run on ``world`` ranks of a gloo group,
  spawned by ``torch.multiprocessing`` inside one subprocess (so the ranks
  never share this process's state), with a 300 s limit. The group meets
  through a file in ``tmp_path``; ``io`` is ``tmp_path`` as a string, for
  the ranks' inputs and outputs.
"""

import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_LAUNCH = """
import os, sys, warnings
import torch
import torch.multiprocessing as mp

{body}


def _entry(rank, world, io):
    import torch.distributed as dist

    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(io, "group"), rank=rank,
                            world_size=world)
    try:
        worker(rank, world, io)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(_entry, args=({world}, {io!r}), nprocs={world}, join=True)
    print("RANKS_OK")
"""


def run_ranks(tmp_path, world: int, body: str, timeout: int = 300) -> str:
    script = pathlib.Path(tmp_path) / "ranks.py"
    script.write_text(_LAUNCH.format(body=textwrap.dedent(body), world=world, io=str(tmp_path)))
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, str(script)], env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0 and "RANKS_OK" in proc.stdout, (proc.stdout[-2000:], proc.stderr[-4000:])
    return proc.stdout


@pytest.fixture
def world1():
    import torch.distributed as dist

    from repro_torch.dist import sharding

    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        sharding.set_activation_ctx(None)
        dist.destroy_process_group()
