"""Does gloo take ``all_to_all_single`` on CUDA tensors?  Two processes on
the one card over a gloo group: each sends uneven byte blocks (one of zero
length) to the other as CUDA tensors, then the same through pinned host
buffers (the exchange's staged route), and reports whether the direct call
was accepted, whether its bytes arrived, and the time of each route at
256 MB a process.  Run from the repository's root on a machine with a
card:

    python3 scripts/probe_gloo_cuda.py
"""

import datetime
import json
import os
import socket
import subprocess
import sys
import time

import torch

MB = 256


def child(rank: int, port: int) -> None:
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank,
                                         timeout=datetime.timedelta(seconds=120))
    dev = torch.device("cuda", 0)
    res = {"rank": rank, "torch": torch.__version__}
    # uneven: rank 0 sends 3 bytes to itself and 5 to rank 1; rank 1 sends 0 to rank 0 and 7 to itself
    table = [[3, 5], [0, 7]]  # table[q][r]: bytes q sends to r
    ins = table[rank]
    outs = [table[q][rank] for q in range(2)]
    send = torch.arange(sum(ins), dtype=torch.uint8, device=dev) + 10 * rank
    recv = torch.zeros(sum(outs), dtype=torch.uint8, device=dev)
    try:
        torch.distributed.all_to_all_single(recv, send, outs, ins)
        torch.cuda.synchronize()
        res["direct_small"] = recv.cpu().tolist()
    except Exception as err:  # the probe records what gloo says
        res["direct_small"] = f"{type(err).__name__}: {str(err)[:300]}"
    n = MB << 20
    big = torch.full((n,), rank + 1, dtype=torch.uint8, device=dev)
    got = torch.empty(n, dtype=torch.uint8, device=dev)
    for route in ("direct", "staged"):
        times = []
        for _ in range(3):
            torch.distributed.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                if route == "direct":
                    torch.distributed.all_to_all_single(got, big, [n // 2] * 2, [n // 2] * 2)
                else:
                    hs = torch.empty(n, dtype=torch.uint8, pin_memory=True)
                    hr = torch.empty(n, dtype=torch.uint8, pin_memory=True)
                    hs.copy_(big)
                    torch.distributed.all_to_all_single(hr, hs, [n // 2] * 2, [n // 2] * 2)
                    got.copy_(hr)
                torch.cuda.synchronize()
            except Exception as err:  # the probe records what gloo says
                times = f"{type(err).__name__}: {str(err)[:200]}"
                break
            times.append(1e3 * (time.perf_counter() - t0))
        ok = isinstance(times, list) and int(got[: n // 2].float().mean()) == 1 and int(got[n // 2:].float().mean()) == 2
        res[route] = {"ms": times, "bytes_right": ok}
    print(json.dumps(res), flush=True)
    torch.distributed.destroy_process_group()


def main() -> int:
    if len(sys.argv) == 3:
        child(int(sys.argv[1]), int(sys.argv[2]))
        return 0
    if not torch.cuda.is_available():
        print("probe_gloo_cuda: no CUDA device is available", file=sys.stderr)
        return 2
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    code = 0
    for p in procs:
        out, _ = p.communicate(timeout=300)
        print(out.strip()[-3000:])
        code |= p.returncode
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[probe] {card}")
    return code


if __name__ == "__main__":
    sys.exit(main())
