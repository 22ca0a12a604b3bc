"""Device time of the flash attention kernels for one or more checkouts
of this repository, each timed in a process of its own (its kernels
built from its own sources).

    python3 src/repro_torch/benchmarks/flash_times.py ROOT [ROOT ...]

prints one JSON line per ROOT: the forward kernel at the serve phase's
prompt lengths (qwen1.5-0.5b's 16 heads of 64, causal, B 1), the
forward with its LSE stored at the training shape (``fwd_train``), and
the backward kernel at ``chip_smoke.BWD_SHAPES`` (``bwd``): each as
device ms per launch from a torch.profiler trace and three CUDA-event
means of back-to-back launches, beside SDPA's forward and backward
(through autograd) on the same inputs. Give the roots in turns (parent,
change, change, parent) to compare two versions of the kernels on one
card. Needs a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

PROMPTS = (512, 768, 1024, 1536, 2048)
#: chip_smoke.BWD_SHAPES (B, Sq, Sk, H, KV, hd, causal): the training
#: step's, then the forward table's (b) and (c)
BWD_SHAPES = ((4, 2048, 2048, 16, 16, 64, True),
              (1, 4096, 4096, 16, 8, 128, True),
              (2, 1024, 1500, 16, 16, 64, False))


def _times(torch, fn, focus: str, events: int = 50, traced: int = 20):
    """(device ms per call of the kernels whose name holds ``focus``,
    from a profiler trace; three CUDA-event means of ``events`` calls)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(events):
            fn()
        stop.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(stop) / events)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(traced):
            fn()
        torch.cuda.synchronize()
    mine = [e for e in prof.key_averages() if focus in e.key
            and e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(getattr(e, "self_device_time_total", 0) for e in mine)
    return dev_us / 1e3 / traced, means


def time_training_shapes(torch, out: dict) -> None:
    """The backward at BWD_SHAPES and the forward with LSE at the first,
    each beside SDPA's."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    out["bwd"] = {}
    for shape in BWD_SHAPES:
        b, sq, sk, h, kv, hd, causal = shape
        g = torch.Generator(device=dev).manual_seed(sq + sk)
        q, do = (torch.randn((b, sq, h, hd), generator=g,
                             device=dev).bfloat16() for _ in range(2))
        k, v = (torch.randn((b, sk, kv, hd), generator=g,
                            device=dev).bfloat16() for _ in range(2))
        o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        lib_out = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
        dot = do.transpose(1, 2)
        key = "x".join(map(str, shape[:6])) + (" causal" if causal
                                               else " all")
        dev_ms, events = _times(torch, lambda: flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal), "attn_bwd")
        lib_ms, _ = _times(torch, lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot, retain_graph=True), "", 10, 10)
        out["bwd"][key] = {"device_ms": dev_ms, "event_ms": events,
                           "sdpa_bwd_device_ms": lib_ms}
        if shape == BWD_SHAPES[0]:
            dev_ms, events = _times(torch, lambda: flash_attention(
                q, k, v, causal=causal, return_lse=True), "flash_fwd")
            with torch.no_grad():
                lib_ms, _ = _times(torch, lambda: sdpa(
                    qt, kt, vt, is_causal=causal, enable_gqa=True), "")
            out["fwd_train"] = {"shape": key, "device_ms": dev_ms,
                                "event_ms": events,
                                "sdpa_fwd_device_ms": lib_ms}
        del q, k, v, do, o, lse, qt, kt, vt, lib_out, dot
        torch.cuda.empty_cache()


def time_tree(root: str) -> dict:
    """Time ``root``'s kernel in this process (its ``src`` first on the
    path)."""
    sys.path.insert(0, str(Path(root) / "src"))
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    dev = torch.device("cuda")
    out = {"tree": root, "device": torch.cuda.get_device_name(0)}
    for n in PROMPTS:
        g = torch.Generator(device=dev).manual_seed(n)
        q, k, v = (torch.randn((1, n, 16, 64), generator=g,
                               device=dev).bfloat16() for _ in range(3))
        dev_ms, events = _times(torch, lambda: flash_attention(q, k, v),
                                "flash_fwd")
        out[n] = {"device_ms": dev_ms, "event_ms": events}
    time_training_shapes(torch, out)
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
