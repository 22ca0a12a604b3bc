"""One run of ``test_torch_sharded_step.py``'s comparison with the
reference for the configs named, to replay a failure or to repeat it
under load: the module fixture's inputs (``_inputs``), the reference
process and the 4 ranks of ``_torch_mesh_jobs.py`` (``ref_archs`` the
configs named, no one-device checks), then one JSON line: the run's hash
seed and rwkv keys, its seconds and load, each process's exit code,
whether the ranks ran under deterministic algorithms, and
for each config every check of
``test_the_sharded_step_matches_the_reference_s`` as a margin, the gap
over its tolerance (at most 1 passes), with the leaf that sets it:

  loss, gnorm        the loss (rtol 1e-5) and the gradient norm (1e-4);
  mu, nu             the moments (``_close_trees``' tolerances);
  params, noise      the parameters off and on the noise floor, and
  moved              how far a noise element moved (``_close_params``);
  noise_share        the noise floor's share over its 5% limit.

Run from the checkout's root:

    PYTHONHASHSEED=1529 PYTHONPATH=src:tests:. python \\
        tests/_torch_mesh_sweep.py WORK [ARCH,...] [--hash-keyed] \\
        [--orders]

``--hash-keyed`` builds the weights as before rwkv's four hash-keyed
matrices were drawn from numpy (``test_torch_hybrid._dehashed`` in
``test_torch_train_encdec._weights``):
the reference's draw in this process's hash seed. A process that fails
leaves its output in ``WORK/fail<i>.log`` (0 the reference, 1-4 the
ranks). ``--orders`` adds each package's gradient norm on the run's
inputs in two row orders (:func:`orders`).
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def _worst(pairs):
    """(largest margin, its leaf) over (margin, leaf) pairs."""
    return max(pairs, default=(0.0, None), key=lambda p: p[0])


def margins(T, work, reports, arch):
    """The test's checks on ``arch`` as margins (module docstring)."""
    import _torch_mesh_jobs as jobs
    from test_torch_train import TRAIN_RTOL
    from test_torch_train_encdec import (GRAD_RTOL, GRAD_SCALE_TOL, _at,
                                         _cfgs, _leaf_paths)
    _, tcfg = _cfgs(arch)
    want, meta = T._ref_arrays(work, arch)
    got_m, ref_m = reports[0]["ref"][arch], meta["metrics"]
    out = {"loss": abs(got_m["loss"] - ref_m["loss"])
           / (1e-5 * abs(ref_m["loss"])),
           "gnorm": abs(got_m["grad_norm"] - ref_m["grad_norm"])
           / (GRAD_RTOL * abs(ref_m["grad_norm"]))}
    arrays = T._assemble(work, reports, arch)
    for part, k in (("mu", 1), ("nu", 2)):
        got = T._tree(tcfg, arrays, part)
        pairs = []
        for path, w in _leaf_paths(want[part]):
            w = np.asarray(w, np.float32)
            g = np.asarray(_at(got, path), np.float32)
            tol = k * (GRAD_RTOL * np.abs(w)
                       + GRAD_SCALE_TOL * np.abs(w).max()) + 1e-30
            pairs.append((float((np.abs(g - w) / tol).max()),
                          "/".join(path)))
        out[part], out[part + "_leaf"] = _worst(pairs)
    got = T._tree(tcfg, arrays, "params")
    with np.load(work / f"{arch}.npz") as f:
        before = jobs._unflatten(dict(f), "w/")
    lr = ref_m["lr"]
    off, on, moved = [], [], []
    n_noise = n_all = 0
    for path, w in _leaf_paths(want["params"]):
        w, g = np.asarray(w, np.float32), np.asarray(_at(got, path))
        m = np.abs(np.asarray(_at(want["mu"], path)))
        noise = (m > 0) & (m <= GRAD_SCALE_TOL * m.max())
        tol = TRAIN_RTOL * np.abs(w) + TRAIN_RTOL * np.abs(w).max()
        err, name = np.abs(g - w), "/".join(path)
        if (~noise).any():
            off.append((float((err / (tol + 1e-30))[~noise].max()), name))
        if noise.any():
            on.append((float((err / (2 * lr + tol))[noise].max()), name))
            step = np.abs(g - np.asarray(_at(before, path), np.float32))
            moved.append((float((step / (lr * (1 + 0.1 * np.abs(w)) + tol))
                                [noise].max()), name))
        n_noise, n_all = n_noise + int(noise.sum()), n_all + noise.size
    for key, pairs in (("params", off), ("noise", on), ("moved", moved)):
        out[key], out[key + "_leaf"] = _worst(pairs)
    out["noise_share"] = n_noise / n_all / 0.05
    out["worst"] = max(v for v in out.values() if isinstance(v, float))
    return out


def orders(work, arch):
    """The float32 gradient norm on the run's inputs, each package on one
    device over the step's two microbatches (their gradients averaged):
    with each microbatch's rows in order; reversed (the same sum in
    another order); and in order with every weight moved by about two
    float32 steps (times 1 + 2^-22 N(0, 1), numpy seed 0). With ``u``'s
    gradient norm for rwkv. Where weights two rounding steps away move a
    package's gradient by more than the test's rtol, the inputs are
    ill-conditioned in float32: two correct float32 steps that round
    differently part by as much, whatever the port does."""
    import jax
    import jax.numpy as jnp
    import torch

    import _torch_mesh_jobs as jobs
    import test_torch_sharded_step as T
    from repro.models import lm as r_lm
    from repro_torch.models.lm import loss_fn
    from test_torch_train_encdec import _cfgs, _model, params_to_numpy
    with np.load(work / f"{arch}.npz") as f:
        flat = dict(f)
    rng = np.random.default_rng(0)
    moved = {k: (v * (1 + 2.0 ** -22 * rng.standard_normal(v.shape)))
             .astype(v.dtype) if k.startswith("w/") else v
             for k, v in flat.items()}
    batch = jobs._unflatten(flat, "b/")
    rcfg, tcfg = _cfgs(arch)
    grad = jax.jit(jax.grad(lambda p, b: r_lm.loss_fn(
        rcfg, p, b, attn_block=T.ATTN_BLOCK)))

    def ref(mb, tree):
        return jax.tree.map(np.asarray, grad(
            jax.tree.map(jnp.asarray, tree),
            {k: jnp.asarray(v) for k, v in mb.items()}))

    def port(mb, tree):
        model = _model(tcfg, tree)
        model.requires_grad_()
        loss_fn(model, {k: torch.from_numpy(v).long()
                        if v.dtype == np.int32 else torch.from_numpy(v)
                        for k, v in mb.items()},
                attn_block=T.ATTN_BLOCK).backward()
        return params_to_numpy(tcfg, {n: p.grad for n, p in
                                      model.named_parameters()})

    n = T.N_MICRO
    out = {}
    for name, run in (("ref", ref), ("port", port)):
        for rows, step, weights in (("rows", 1, flat), ("reversed", -1, flat),
                                    ("moved", 1, moved)):
            tree = jobs._unflatten(weights, "w/")
            gs = [run({k: np.ascontiguousarray(
                v[i * len(v) // n:(i + 1) * len(v) // n][::step])
                for k, v in batch.items()}, tree) for i in range(n)]
            g = jax.tree.map(lambda *x: np.mean(
                [a.astype(np.float64) for a in x], 0), *gs)
            key = f"{name} {rows}"
            out[key] = float(np.sqrt(sum(np.sum(a * a)
                                         for a in jax.tree.leaves(g))))
            u = g["blocks"]["slot0"].get("u")
            if u is not None:
                out[key + " u"] = float(np.sqrt(np.sum(u * u)))
    return out


def main(argv):
    root = Path(__file__).resolve().parents[1]
    work = Path(argv[0])
    archs = argv[1].split(",") if len(argv) > 1 and argv[1][0] != "-" \
        else ["rwkv6-7b"]
    import test_torch_train_encdec
    if "--hash-keyed" in argv:
        test_torch_train_encdec._dehashed = lambda tree, seed: tree
    import test_torch_sharded_step as T
    work.mkdir(parents=True, exist_ok=True)
    for arch in archs:
        np.savez(work / f"{arch}.npz", **T._inputs(arch))
    job = {"work": str(work), "ref_archs": archs, "shape": list(T.SHAPE),
           "opt": T.OPT, "n_micro": T.N_MICRO, "attn_block": T.ATTN_BLOCK,
           "archs": [], "pod_arch": T.POD_ARCH, "hash_seed": T._hash_seed()}
    (work / "job.json").write_text(json.dumps(job))
    script = str(root / "tests" / "_torch_mesh_jobs.py")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, script, "ref", str(work / "job.json")],
        env=T._env({"XLA_FLAGS": "--xla_force_host_platform_device_count=4"}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen(
        [sys.executable, script, "rank", str(work / "job.json"), str(r)],
        env=T._env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(4)]
    try:
        outs = [p.communicate(timeout=T.LIMIT_S)[0] for p in procs]
    finally:            # a hung collective leaves no rank behind
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = {"seed": os.environ.get("PYTHONHASHSEED"),
           "keys": job["hash_seed"]["rwkv_keys"],
           "rcs": [p.returncode for p in procs],
           "s": round(time.perf_counter() - t0, 1),
           "load": os.getloadavg()[0]}
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode:
            (work / f"fail{i}.log").write_text(out)
    if not any(res["rcs"]):
        reports = [json.loads((work / f"rank{r}.json").read_text())
                   for r in range(4)]
        res["deterministic"] = all(r["deterministic"] for r in reports)
        for arch in archs:
            res[arch] = margins(T, work, reports, arch)
    if "--orders" in argv:
        res["orders"] = {arch: orders(work, arch) for arch in archs}
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
