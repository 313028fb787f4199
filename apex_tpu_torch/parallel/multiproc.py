"""Multi-process launcher, the PyTorch counterpart of
``apex_tpu/parallel/multiproc.py`` (reference
``apex/parallel/multiproc.py:12-35``).

Starts one process per visible GPU, or ``--nproc N``, each running
``script.py args... --local_rank=<i>`` with ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` exported,
and beside them the variables ``init_distributed`` reads first
(``APEX_TPU_COORDINATOR``, ``APEX_TPU_NUM_PROCESSES``,
``APEX_TPU_PROCESS_ID``).  The port ``APEX_TPU_COORD_PORT`` names
(default 12355) is the rendezvous.  Exits with the first non-zero exit
code in rank order, or 0.  Importing the module does nothing.

Usage:  python -m apex_tpu_torch.parallel.multiproc [--nproc N]
        script.py args...
"""
from __future__ import annotations

import os
import subprocess
import sys


def rank_env(base, nproc: int, local_rank: int, port: int) -> dict:
    """The environment of rank ``local_rank`` of ``nproc`` on this host:
    ``base`` plus the rendezvous and rank variables."""
    env = dict(base)
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               RANK=str(local_rank), WORLD_SIZE=str(nproc),
               LOCAL_RANK=str(local_rank),
               APEX_TPU_COORDINATOR=f"127.0.0.1:{port}",
               APEX_TPU_NUM_PROCESSES=str(nproc),
               APEX_TPU_PROCESS_ID=str(local_rank))
    return env


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    nproc = None
    if argv[:1] == ["--nproc"]:
        nproc = int(argv[1])
        argv = argv[2:]
    if not argv:
        print(__doc__)
        return 1
    if nproc is None:
        import torch
        nproc = max(torch.cuda.device_count(), 1)
    port = int(os.environ.get("APEX_TPU_COORD_PORT", "12355"))
    procs = [subprocess.Popen(
        [sys.executable, argv[0], *argv[1:], f"--local_rank={r}"],
        env=rank_env(os.environ, nproc, r, port)) for r in range(nproc)]
    rc = 0
    for p in procs:
        p.wait()
        rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
