"""Device time of the flash forward kernel at the serve phase's prompt
lengths, for one or more checkouts of this repository, each timed in a
process of its own (its kernels built from its own sources).

    python3 src/repro_torch/benchmarks/flash_times.py ROOT [ROOT ...]

prints one JSON line per ROOT: for each prompt length (qwen1.5-0.5b's 16
heads of 64, causal, B 1) the kernel's device ms per launch from a
torch.profiler trace of 20 launches, and three CUDA-event means of 50
launches. Give the roots in turns (parent, change, change, parent) to
compare two versions of the kernel on one card. Needs a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

PROMPTS = (512, 768, 1024, 1536, 2048)


def time_tree(root: str) -> dict:
    """Time ``root``'s kernel in this process (its ``src`` first on the
    path)."""
    sys.path.insert(0, str(Path(root) / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import flash_attention
    dev = torch.device("cuda")
    out = {"tree": root, "device": torch.cuda.get_device_name(0)}
    for n in PROMPTS:
        g = torch.Generator(device=dev).manual_seed(n)
        q, k, v = (torch.randn((1, n, 16, 64), generator=g,
                               device=dev).bfloat16() for _ in range(3))
        for _ in range(5):
            flash_attention(q, k, v)
        torch.cuda.synchronize()
        events = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(50):
                flash_attention(q, k, v)
            stop.record()
            torch.cuda.synchronize()
            events.append(start.elapsed_time(stop) / 50)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                flash_attention(q, k, v)
            torch.cuda.synchronize()
        mine = [e for e in prof.key_averages() if "flash_fwd" in e.key]
        dev_us = sum(getattr(e, "self_device_time_total", 0) for e in mine)
        out[n] = {"device_ms": dev_us / 1e3 / 20, "event_ms": events}
    return out


def main(argv=None) -> int:
    roots = sys.argv[1:] if argv is None else argv
    if len(roots) == 2 and roots[0] == "--one":
        print(json.dumps(time_tree(roots[1])), flush=True)
        return 0
    for root in roots:
        run = subprocess.run([sys.executable, __file__, "--one", root])
        if run.returncode:
            return run.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
