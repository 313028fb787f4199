"""Starting the port's gloo ranks for a test file, once.

``run_ranks(source, nproc, out_dir, *args)`` writes ``source`` to
``out_dir/worker.py`` and starts it on ``nproc`` ranks through the port's
own launcher (``python -m apex_tpu_torch.parallel.multiproc --nproc N
worker.py out_dir args...``, one subprocess, a timeout); each rank leaves
``out_dir/rank{r}.pt``, which come back as a list.  ``WORKER_PRELUDE``
is what every worker starts with: one thread, gloo on the CPU through
``parallel.init_distributed``, and ``finish(res)``, which saves the rank's
results, joins any collective thread that ``timed_flat_dist_call`` left
behind (ROADMAP C9) and tears the group down.
"""
import os
import socket
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER_PRELUDE = r'''
import os, sys, threading
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from apex_tpu_torch import parallel

OUT = sys.argv[1]
ARGS = [a for a in sys.argv[2:] if not a.startswith("--local_rank=")]
parallel.init_distributed(device="cpu", timeout_s=120)
RANK, WORLD = dist.get_rank(), dist.get_world_size()


def finish(res):
    torch.save(res, os.path.join(OUT, f"rank{RANK}.pt"))
    for t in threading.enumerate():
        if t.name == "apex-tpu-torch-collective":
            t.join(60)
    dist.barrier()
    dist.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(source, nproc, out_dir, *args, timeout=240):
    """Every rank's results of ``source`` run on ``nproc`` gloo ranks."""
    worker = os.path.join(out_dir, "worker.py")
    with open(worker, "w") as f:
        f.write(WORKER_PRELUDE + source)
    env = dict(os.environ, APEX_TPU_COORD_PORT=str(_free_port()),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc", "--nproc",
         str(nproc), worker, str(out_dir), *map(str, args)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-8000:]
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(nproc)]
