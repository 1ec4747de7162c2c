#!/usr/bin/env python3
"""Whether NCCL takes two ranks on one CUDA device: two processes join one
NCCL process group on cuda:0 and all-reduce one tensor.

    python3 tools/torch_nccl_probe.py [--timeout SECONDS]

Each process prints its outcome ("ok" and the sum, or the exception's text);
a process still running at the timeout (default 120 s, both together) is
killed and said to hang. Exits 0 whatever the outcome: the text is the result. Needs a
CUDA device.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time


def rank_main(rank: int, world: int, port: int) -> None:
    import torch

    torch.cuda.set_device(0)
    try:
        torch.distributed.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                             world_size=world, rank=rank)
        t = torch.ones(4, device="cuda:0") * (rank + 1)
        torch.distributed.all_reduce(t)
        torch.cuda.synchronize()
        print(f"rank {rank}: ok, sum {t.tolist()}", flush=True)
    except Exception as e:  # the probe's result is the error text
        print(f"rank {rank}: {type(e).__name__}: {e}", flush=True)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_nccl_probe: no CUDA device", file=sys.stderr)
        return 2
    timeout = float(argv[argv.index("--timeout") + 1]) if "--timeout" in argv else 120.0
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}, {torch.cuda.device_count()} "
          f"card(s): {torch.cuda.get_device_name(0)}", flush=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, NCCL_SOCKET_IFNAME="lo", NCCL_DEBUG="WARN")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                               "2", str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(2)]
    deadline = time.monotonic() + timeout
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            print(f"--- rank {r} (exit {p.returncode}) ---\n{out.rstrip()}", flush=True)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            print(f"--- rank {r}: still running after {timeout:.0f} s, killed (hangs) ---\n"
                  f"{out.rstrip()}", flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))
