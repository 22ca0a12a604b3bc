"""The flash backward kernel and the plain bf16 attention path, each held
against the float32 backward over many explicit draws of dO (on the card).

At the shape of the card test
``test_flash_attention_autograd_on_the_card_matches_the_plain_path``
(B 2, 300 x 300 positions, 8 heads over 4 KV heads of 64, causal; q, k
and v drawn as the test draws them, seed 3), for each draw ``i`` of dO
from ``torch.Generator(device="cuda").manual_seed(base + i)``:

- each path's dq, dk and dv against ``ref.attention_bwd`` in float32 on
  the same bf16 inputs: the worst absolute error, and the worst excess
  over the card test's allowance ``atol + rtol * |want|`` (2e-2 each;
  above 0 means ``assert_close`` fails);
- whether the card test's own check, ``_bwd_close(kernel, plain)``,
  fails on the draw, and there, at the worst element, how far each path
  lies from the float32 value.

    python -m repro_torch.benchmarks.bwd_draws [--draws 512] [--base 0]

prints one JSON line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..kernels import ops, ref

SHAPE = (2, 300, 300, 8, 4, 64)    # B, Sq, Sk, H, KV, hd (causal)
SEED = 3                           # q, k, v, as the card test draws them
TOL = 2e-2                         # the card test's atol = rtol
REL_TOL = 6e-3                     # chip_smoke.BWD_REL_TOL


def qkv(dev, b, sq, sk, h, kv, hd, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).bfloat16()
            for shape in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd))]


def excess(got, want) -> float:
    """The worst ``|got - want| - (TOL + TOL * |want|)`` over the three
    gradients: above 0 where ``assert_close(atol=rtol=TOL)`` fails."""
    return max(float(((x.float() - w).abs() - TOL - TOL * w.abs()).max())
               for x, w in zip(got, want))


def bwd_close(got, want) -> bool:
    """The card test's ``_bwd_close`` as a predicate."""
    if excess(got, want) > 0:
        return False
    return all(float((x.float() - w).norm() / w.norm()) <= REL_TOL
               for x, w in zip(got, want) if float(w.norm()) > 1e-3)


def worst_element(kern, plain, true) -> dict:
    """Where ``kern`` exceeds the allowance around ``plain`` the most: the
    gradient, and each path's distance from the float32 value there."""
    best = None
    for name, k, p, t in zip(("dq", "dk", "dv"), kern, plain, true):
        k, p = k.float(), p.float()
        ex = (k - p).abs() - TOL - TOL * p.abs()
        i = int(ex.argmax())
        if best is None or float(ex.flatten()[i]) > best["excess"]:
            best = {"grad": name, "excess": float(ex.flatten()[i]),
                    "kernel_err": float((k - t).flatten()[i].abs()),
                    "plain_err": float((p - t).flatten()[i].abs())}
    return best


def run(draws: int, base: int, device="cuda") -> dict:
    """The record over ``draws`` draws (``device="cpu"`` runs the plain
    path on both sides: a rehearsal of the control flow only)."""
    dev = torch.device(device)
    q, k, v = (x.requires_grad_() for x in qkv(dev, *SHAPE, SEED))
    qf, kf, vf = (x.detach().float() for x in (q, k, v))
    o, lse = ref.attention_lse(qf, kf, vf, causal=True)
    worst = {"kernel_err": 0.0, "plain_err": 0.0,
             "kernel_excess": float("-inf"), "plain_excess": float("-inf")}
    over = {"kernel": [], "plain": []}
    failing = []
    for i in range(draws):
        seed = base + i
        g = torch.Generator(device=dev).manual_seed(seed)
        do = torch.randn(q.shape, generator=g, device=dev).bfloat16()
        true = ref.attention_bwd(qf, kf, vf, o, lse, do.float(),
                                 causal=True)
        got = {}
        for name, fwd in (("kernel", ops.attention(q, k, v, causal=True)),
                          ("plain", ref.attention(q, k, v, causal=True,
                                                  block=64))):
            got[name] = torch.autograd.grad(fwd, (q, k, v), do)
            err = max(float((x.float() - t).abs().max())
                      for x, t in zip(got[name], true))
            ex = excess(got[name], true)
            worst[f"{name}_err"] = max(worst[f"{name}_err"], err)
            worst[f"{name}_excess"] = max(worst[f"{name}_excess"], ex)
            if not bwd_close(got[name], true):
                over[name].append(seed)
        plain_f = [x.float() for x in got["plain"]]
        if not bwd_close(got["kernel"], plain_f):
            failing.append({"seed": seed, **worst_element(
                got["kernel"], plain_f, true)})
    return {"shape": list(SHAPE), "qkv_seed": SEED, "draws": draws,
            "do_seeds": [base, base + draws - 1], **worst,
            "kernel_not_close_to_float32": over["kernel"],
            "plain_not_close_to_float32": over["plain"],
            "kernel_not_close_to_plain": failing,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu")}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=512)
    ap.add_argument("--base", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_draws: needs a CUDA device")
    print(json.dumps(run(args.draws, args.base)), flush=True)


if __name__ == "__main__":
    main()
