"""The library column of the segsum kernel's rows that the main path's
``segsum_split`` does not reach: ``torch.cumsum`` of a stream's int32
signs (+-1), the scan half of segsum only (no one PyTorch call computes
the run flags and the sums together), at the workflow's largest streams
(396,668 and 396,694 rows) and at a whole SF1 table (6,001,215 rows).

    python3 src/repro_torch/benchmarks/cumsum_times.py [ROWS ...]

prints one JSON line: per row count, the CUDA-event mean of 20 calls
after a warm-up, in ms, three times, with the card's name. Needs a CUDA
device.
"""
from __future__ import annotations

import json
import sys

ROWS = (396_668, 396_694, 6_001_215)


def cumsum_ms(torch, n: int, iters: int = 20, seed: int = 0) -> float:
    g = torch.Generator(device="cuda").manual_seed(seed)
    sg = torch.randint(0, 2, (n,), generator=g, device="cuda",
                       dtype=torch.int32) * 2 - 1
    torch.cumsum(sg, 0, dtype=torch.int32)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        torch.cumsum(sg, 0, dtype=torch.int32)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("cumsum_times: needs a CUDA device", file=sys.stderr)
        return 2
    rows = [int(a) for a in (argv if argv is not None else sys.argv[1:])] \
        or list(ROWS)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "cumsum_ms": {n: [cumsum_ms(torch, n)
                                        for _ in range(3)] for n in rows}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
