"""What NCCL collectives at world size 1 do inside a CUDA graph capture.

Starts ``torch.distributed`` with NCCL on one card (world size 1), builds a
1-D ``DeviceMesh`` named ``"data"``, runs each collective the ZeRO and DP
train steps use (in-place ``all_reduce`` in bf16 and fp32, int32
``ReduceOp.MAX``, ``reduce_scatter_tensor``, ``all_gather_into_tensor``,
the same ``all_gather_into_tensor`` issued with ``async_op=True`` and
waited on) once eagerly on a side stream, then captures them into one
``torch.cuda.CUDAGraph``, replays it, checks every result, and prints the
graph's nodes by kind (kernel nodes by function, memcpy, event) from
``cudaGraphDebugDotPrint`` and the replay's device ms by CUDA events; the
whole DOT text is written to ``build/nccl_graph.dot``.

Usage (on the card): ``PYTHONPATH=. python3 tools/nccl_graph_probe.py``
"""
import collections
import os
import re
import socket
import sys
import tempfile

import torch
import torch.distributed as dist


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def body(group, t):
    """The collectives, on the tensors of ``t``, in place."""
    dist.all_reduce(t["ar16"], group=group)
    dist.all_reduce(t["ar32"], group=group)
    dist.all_reduce(t["flag"], op=dist.ReduceOp.MAX, group=group)
    dist.reduce_scatter_tensor(t["rs_out"], t["rs_in"], group=group)
    dist.all_gather_into_tensor(t["ag_out"], t["ag_in"], group=group)
    work = dist.all_gather_into_tensor(t["ag2_out"], t["ag2_in"], group=group,
                                       async_op=True)
    t["after"].copy_(t["ag_out"] * 2)
    work.wait()
    t["ag2_twice"].copy_(t["ag2_out"] * 2)


def main():
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          "nccl", ".".join(map(str, torch.cuda.nccl.version())))
    from apex_tpu_torch import parallel
    parallel.init_distributed(f"127.0.0.1:{_free_port()}", num_processes=1,
                              process_id=0, timeout_s=120)
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    group = mesh.get_group("data")
    print("mesh", mesh.mesh_dim_names, "group size",
          dist.get_world_size(group), "default group?",
          group == dist.group.WORLD)
    g = torch.Generator(device="cuda").manual_seed(0)
    n = 1 << 20

    def r(dtype):
        return torch.randn(n, device="cuda", generator=g).to(dtype)
    t = dict(ar16=r(torch.bfloat16), ar32=r(torch.float32),
             flag=torch.ones((), dtype=torch.int32, device="cuda"),
             rs_in=r(torch.float32), rs_out=torch.empty(n, device="cuda"),
             ag_in=r(torch.bfloat16),
             ag_out=torch.empty(n, dtype=torch.bfloat16, device="cuda"),
             ag2_in=r(torch.float32), ag2_out=torch.empty(n, device="cuda"),
             after=torch.empty(n, dtype=torch.bfloat16, device="cuda"),
             ag2_twice=torch.empty(n, device="cuda"))
    before = {k: v.clone() for k, v in t.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body(group, t)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    checks = dict(ar16=torch.equal(t["ar16"], before["ar16"]),
                  ar32=torch.equal(t["ar32"], before["ar32"]),
                  flag=int(t["flag"]) == 1,
                  rs=torch.equal(t["rs_out"], before["rs_in"]),
                  ag=torch.equal(t["ag_out"], before["ag_in"]),
                  ag_async=torch.equal(t["ag2_twice"], before["ag2_in"] * 2))
    print("eager", checks)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    for k in ("rs_out", "ag_out", "ag2_out", "after", "ag2_twice"):
        t[k].zero_()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        body(group, t)
    graph.instantiate()
    for k in ("rs_out", "ag_out", "ag2_out", "after", "ag2_twice"):
        t[k].zero_()
    t["rs_in"].copy_(before["rs_in"] + 1)
    graph.replay()
    torch.cuda.synchronize()
    checks = dict(ar16=torch.equal(t["ar16"], before["ar16"]),
                  rs=torch.equal(t["rs_out"], before["rs_in"] + 1),
                  ag=torch.equal(t["ag_out"], before["ag_in"]),
                  after=torch.equal(t["after"], before["ag_in"] * 2),
                  ag_async=torch.equal(t["ag2_twice"], before["ag2_in"] * 2))
    print("replay", checks)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "g.dot")
        graph.enable_debug_mode()
        graph.debug_dump(path)
        dot = open(path).read()
    kinds = collections.Counter()
    for m in re.finditer(r'label="\{?([A-Z_]+)[^"]*"', dot):
        kinds[m.group(1)] += 1
    names = collections.Counter(re.findall(r"\\<(\w+)", dot))
    print("graph node kinds", dict(kinds))
    print("kernel functions", dict(names.most_common(20)))
    print("nccl-named nodes", sum(v for k, v in names.items()
                                  if "nccl" in k.lower()))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(3):
        graph.replay()
    start.record()
    for _ in range(20):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    print("replay ms", start.elapsed_time(end) / 20)
    print(dot[:6000])
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "nccl_graph.dot"), "w") as f:
        f.write(dot)
    del graph
    dist.destroy_process_group()
    ok = all(checks.values())
    print("ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
