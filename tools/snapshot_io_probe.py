"""Time the file operations of the serve fleet's session snapshots on this
host: one KV block part of GPT-2 small (12 layers x 2 x 12 heads x 16
positions x 64, fp32: 1,179,648 bytes) copied from the card through a
pinned buffer, written, fsynced, renamed and CRC'd as
``runtime.resilience.stream_kv_handoff`` writes it; a small fsynced file
(a manifest); a hard link (a snapshot's unchanged block); a directory
fsync; and a block part copied from the card and CRC'd with no file (what
a snapshot that links a block only when its CRC matches the previous
snapshot's record would pay for every block).  Each in the temporary
directory and in ``build/`` of the checkout.

    python3 tools/snapshot_io_probe.py [N]
"""
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

import torch


def probe(where, n, blk, staging):
    d = tempfile.mkdtemp(dir=where)
    try:
        t0 = time.perf_counter()
        for i in range(n):
            staging.copy_(blk.view(torch.uint8))
            buf = staging.numpy()
            path = os.path.join(d, f"b{i}.bin")
            with open(path + ".tmp", "wb") as f:
                f.write(buf)
                f.flush()
                os.fsync(f.fileno())
            os.rename(path + ".tmp", path)
            zlib.crc32(buf)
        t1 = time.perf_counter()
        for i in range(n):
            with open(os.path.join(d, f"m{i}.pkl"), "wb") as f:
                f.write(b"x" * 2000)
                f.flush()
                os.fsync(f.fileno())
        t2 = time.perf_counter()
        links = os.path.join(d, "links")
        os.makedirs(links)
        for i in range(n):
            os.link(os.path.join(d, f"b{i}.bin"),
                    os.path.join(links, f"b{i}.bin"))
        t3 = time.perf_counter()
        fd = os.open(d, os.O_RDONLY)
        try:
            for _ in range(n):
                os.fsync(fd)
        finally:
            os.close(fd)
        t4 = time.perf_counter()
        for i in range(n):
            staging.copy_(blk.view(torch.uint8))
            zlib.crc32(staging.numpy())
        t5 = time.perf_counter()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    ms = [1e3 * (b - a) / n for a, b in ((t0, t1), (t1, t2), (t2, t3),
                                         (t3, t4), (t4, t5))]
    print(f"{where}: block file (copy, write, fsync, rename, CRC) "
          f"{ms[0]:.3f} ms; small fsynced file {ms[1]:.3f} ms; link "
          f"{ms[2]:.4f} ms; directory fsync {ms[3]:.4f} ms; copy and CRC "
          f"without a file {ms[4]:.4f} ms")


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    if not torch.cuda.is_available():
        print("snapshot_io_probe: no CUDA device", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0), torch.__version__)
    print(subprocess.run(["df", "-T", tempfile.gettempdir(), "."],
                         capture_output=True, text=True).stdout)
    blk = torch.randn(12 * 2 * 12 * 16 * 64, device="cuda")
    staging = torch.empty(blk.numel() * 4, dtype=torch.uint8,
                          pin_memory=True)
    os.makedirs("build", exist_ok=True)
    for where in (tempfile.gettempdir(), os.path.abspath("build")):
        probe(where, n, blk, staging)
    return 0


if __name__ == "__main__":
    sys.exit(main())
