"""The port's state-space mixers (``repro_torch.models.ssm``) against the
JAX reference's (``repro.models.ssm``) on the CPU.

Weights and inputs come from numpy generators at the reduced configs'
widths (d 64, mamba d_state 4, head dim 16, d_conv 4, expand 2; rwkv
head dim 16) and reach both packages as the same arrays; the constants
the reference initialises to 0, 1 or 0.5 are drawn off them so that the
comparison reaches them. Float32 outputs and states are held within
``F32_REL`` of the reference's largest magnitude; bf16 ones within the
bounds below (the products round to bf16 in another order). Sequence
lengths 64 and 128 run whole chunks, 100 runs chunks of 50 (the
reference's chunk-shrinking loop) and 7 a single short chunk.
"""
import ml_dtypes
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as r_ssm
from repro_torch.models import ssm

F32_REL = 2e-5
#: bf16 outputs: up to two bf16 ulps of the largest value (measured
#: 4.0-7.3e-3); mamba's float32 state inherits the bf16 rounding of v
#: (3.0-6.6e-3), rwkv's is float32 math on the same bf16 products
#: (at most 9e-7 here)
BF16_OUT_REL = 2e-2
BF16_MAMBA_STATE_REL = 2e-2
BF16_RWKV_STATE_REL = 1e-4
D, DS, HP, D_CONV, HD = 64, 4, 16, 4, 16
MAMBA = {"d_state": DS, "head_dim": HP, "d_conv": D_CONV}
#: leaves the reference keeps in float32 whatever the model dtype
F32_LEAVES = {"a_log", "dt_bias", "d_skip", "dec_bias", "u"}
LENGTHS = (64, 128, 100, 7)


def _mamba_params(seed=0):
    rng = np.random.default_rng(seed)
    di = 2 * D
    nh = di // HP
    p = {"w_in": rng.standard_normal((D, 2 * di)) / np.sqrt(D),
         "w_bcdt": rng.standard_normal((D, 2 * DS + nh)) / np.sqrt(D),
         "w_out": rng.standard_normal((di, D)) / np.sqrt(di),
         "conv": rng.standard_normal((D_CONV, di)) * 0.5,
         "a_log": rng.standard_normal(nh) * 0.3,
         "dt_bias": rng.standard_normal(nh) - 1.0,
         "d_skip": 1.0 + 0.1 * rng.standard_normal(nh)}
    return {k: v.astype(np.float32) for k, v in p.items()}


def _rwkv_params(seed=1):
    rng = np.random.default_rng(seed)
    p = {n: rng.uniform(0, 1, D) for n in ("mu_r", "mu_k", "mu_v", "mu_g",
                                           "mu_w")}
    for n in ("w_r", "w_k", "w_v", "w_g", "w_o"):
        p[n] = rng.standard_normal((D, D)) / np.sqrt(D)
    # decays across the clamp: some channels at -0.25, some above it
    p["w_dec"] = rng.standard_normal((D, D)) * 0.3
    p["dec_bias"] = rng.standard_normal(D) * 0.5 - 1.5
    p["u"] = rng.standard_normal((D // HD, HD)) * 0.3
    p["ln_x"] = 1.0 + 0.1 * rng.standard_normal(D)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(params, dtype):
    """The same leaves for each package: float32, or bf16 but for the
    float32 ones."""
    if dtype == "float32":
        return ({k: jnp.asarray(v) for k, v in params.items()},
                {k: torch.from_numpy(v) for k, v in params.items()})
    return ({k: jnp.asarray(v if k in F32_LEAVES
                            else v.astype(ml_dtypes.bfloat16))
             for k, v in params.items()},
            {k: torch.from_numpy(v) if k in F32_LEAVES
             else torch.from_numpy(v).bfloat16() for k, v in params.items()})


def _x(seed, S, dtype="float32", B=2):
    x = np.random.default_rng(seed).standard_normal((B, S, D)) \
        .astype(np.float32)
    if dtype == "float32":
        return jnp.asarray(x), torch.from_numpy(x)
    return jnp.asarray(x.astype(ml_dtypes.bfloat16)), \
        torch.from_numpy(x).bfloat16()


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy().astype(np.float64)
    return np.asarray(a.astype(jnp.float32), np.float64)


def _rel(got, want) -> float:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _dtypes(got_state, want_state):
    for g, w in zip(got_state, want_state):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)


def _state(seed, kind, dtype="float32", B=2):
    """A carried state: a mix over 40 positions of another input."""
    xr, xt = _x(seed, 40, dtype, B)
    if kind == "mamba":
        rp, tp = _both(_mamba_params(), dtype)
        return r_ssm.mamba_mix(rp, xr, **MAMBA)[1], \
            ssm.mamba_mix(tp, xt, **MAMBA)[1]
    rp, tp = _both(_rwkv_params(), dtype)
    return r_ssm.rwkv6_mix(rp, xr, head_dim=HD)[1], \
        ssm.rwkv6_mix(tp, xt, head_dim=HD)[1]


def _carried(state):
    r_state, t_state = state
    return (tuple(jnp.asarray(a) for a in r_state),
            tuple(t.clone() for t in t_state))


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("S", LENGTHS)
def test_mamba_mix_matches_the_reference_f32(S, carry):
    rp, tp = _both(_mamba_params(), "float32")
    xr, xt = _x(S, S)
    rs, ts = _carried(_state(9, "mamba")) if carry else (None, None)
    want, w_state = r_ssm.mamba_mix(rp, xr, rs, **MAMBA)
    got, g_state = ssm.mamba_mix(tp, xt, ts, **MAMBA)
    assert _rel(got, want) <= F32_REL
    for g, w in zip(g_state, w_state):
        assert _rel(g, w) <= F32_REL
    _dtypes(g_state, w_state)


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("S", LENGTHS)
def test_rwkv6_mix_matches_the_reference_f32(S, carry):
    rp, tp = _both(_rwkv_params(), "float32")
    xr, xt = _x(S + 1, S)
    rs, ts = _carried(_state(8, "rwkv")) if carry else (None, None)
    want, w_state = r_ssm.rwkv6_mix(rp, xr, rs, head_dim=HD)
    got, g_state = ssm.rwkv6_mix(tp, xt, ts, head_dim=HD)
    assert _rel(got, want) <= F32_REL
    for g, w in zip(g_state, w_state):
        assert _rel(g, w) <= F32_REL
    _dtypes(g_state, w_state)


@pytest.mark.parametrize("S", LENGTHS)
def test_chunked_decay_attn_matches_the_reference_f32(S):
    rng = np.random.default_rng(S)
    q, k = (rng.standard_normal((2, S, DS)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, S, 8, HP)).astype(np.float32)
    logw = -rng.uniform(0, 0.5, (2, S, 8)).astype(np.float32)
    h0 = rng.standard_normal((2, 8, DS, HP)).astype(np.float32)
    want, w_h = r_ssm._chunked_decay_attn(
        *map(jnp.asarray, (q, k, v, logw)), chunk=ssm.CHUNK,
        state=jnp.asarray(h0))
    got, g_h = ssm._chunked_decay_attn(
        *map(torch.from_numpy, (q, k, v, logw)), chunk=ssm.CHUNK,
        state=torch.from_numpy(h0))
    assert _rel(got, want) <= F32_REL and _rel(g_h, w_h) <= F32_REL


@pytest.mark.parametrize("kind", ["mamba", "rwkv"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_the_reference(kind, dtype):
    rs, ts = _carried(_state(7, kind, dtype))
    xr, xt = _x(11, 1, dtype)
    if kind == "mamba":
        rp, tp = _both(_mamba_params(), dtype)
        want, w_state = r_ssm.mamba_decode(rp, xr, rs, **MAMBA)
        got, g_state = ssm.mamba_decode(tp, xt, ts, **MAMBA)
    else:
        rp, tp = _both(_rwkv_params(), dtype)
        want, w_state = r_ssm.rwkv6_decode(rp, xr, rs, head_dim=HD)
        got, g_state = ssm.rwkv6_decode(tp, xt, ts, head_dim=HD)
    out_tol = F32_REL if dtype == "float32" else BF16_OUT_REL
    state_tol = F32_REL if dtype == "float32" else \
        BF16_MAMBA_STATE_REL if kind == "mamba" else BF16_RWKV_STATE_REL
    assert got.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    assert _rel(got, want) <= out_tol
    for g, w in zip(g_state, w_state):
        assert _rel(g, w) <= state_tol
    _dtypes(g_state, w_state)


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("kind", ["mamba", "rwkv"])
def test_mixers_match_the_reference_bf16(kind, S):
    xr, xt = _x(S + 2, S, "bfloat16")
    if kind == "mamba":
        rp, tp = _both(_mamba_params(), "bfloat16")
        want, w_state = r_ssm.mamba_mix(rp, xr, **MAMBA)
        got, g_state = ssm.mamba_mix(tp, xt, **MAMBA)
        state_tol = BF16_MAMBA_STATE_REL
    else:
        rp, tp = _both(_rwkv_params(), "bfloat16")
        want, w_state = r_ssm.rwkv6_mix(rp, xr, head_dim=HD)
        got, g_state = ssm.rwkv6_mix(tp, xt, head_dim=HD)
        state_tol = BF16_RWKV_STATE_REL
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) <= BF16_OUT_REL
    # the conv / shift state is a slice of the input: bit for bit
    assert _rel(g_state[0], w_state[0]) == 0.0
    assert _rel(g_state[1], w_state[1]) <= state_tol
    _dtypes(g_state, w_state)


def _prefill_then_decode(kind, params, x, S):
    """(the mix over S + 1 at its last position, a mix over S then one
    decode step), in the package of ``params``'s leaves."""
    torch_side = isinstance(x, torch.Tensor)
    mod = ssm if torch_side else r_ssm
    if kind == "mamba":
        full, _ = mod.mamba_mix(params, x, **MAMBA)
        _, state = mod.mamba_mix(params, x[:, :S], **MAMBA)
        dec, _ = mod.mamba_decode(params, x[:, S:], state, **MAMBA)
    else:
        full, _ = mod.rwkv6_mix(params, x, head_dim=HD)
        _, state = mod.rwkv6_mix(params, x[:, :S], head_dim=HD)
        dec, _ = mod.rwkv6_decode(params, x[:, S:], state, head_dim=HD)
    return full[:, -1], dec[:, 0]


@pytest.mark.parametrize("S", [64, 100, 7])
@pytest.mark.parametrize("kind", ["mamba", "rwkv"])
def test_chunked_form_matches_the_recurrent_form_f32(kind, S):
    """The port's prefill form over S positions, then its decode form over
    one, gives the prefill form's last output over S + 1."""
    params = _both(_mamba_params() if kind == "mamba" else _rwkv_params(),
                   "float32")[1]
    full, dec = _prefill_then_decode(kind, params, _x(S, S + 1)[1], S)
    assert _rel(dec, full) <= F32_REL


def test_mamba_prefill_and_decode_differ_in_bf16_by_design(S=100):
    """The reference's design, kept (ROADMAP Queue 3): ``mamba_mix`` keeps
    v in bf16 and rounds each chunk's y to bf16, ``mamba_decode`` computes
    v in float32. In float32 the two forms agree; in bf16 they differ by
    that rounding, in both packages alike (measured 4.1-5.5e-3 of the
    largest output), while rwkv6's two forms give the same bf16 bits."""
    gaps = {}
    for dtype in ("float32", "bfloat16"):
        for pkg, (params, x) in enumerate(zip(
                _both(_mamba_params(), dtype), _x(S, S + 1, dtype))):
            gaps[dtype, pkg] = _rel(*_prefill_then_decode("mamba", params,
                                                          x, S)[::-1])
        for pkg, (params, x) in enumerate(zip(
                _both(_rwkv_params(), dtype), _x(S, S + 1, dtype))):
            gaps["rwkv", dtype, pkg] = _rel(*_prefill_then_decode(
                "rwkv", params, x, S)[::-1])
    for pkg in (0, 1):
        assert gaps["float32", pkg] <= F32_REL
        assert gaps["bfloat16", pkg] > 100 * gaps["float32", pkg]
        assert 1e-3 < gaps["bfloat16", pkg] < BF16_OUT_REL
        assert gaps["rwkv", "bfloat16", pkg] == 0.0
    assert gaps["bfloat16", 1] <= 2 * gaps["bfloat16", 0]


def test_softplus_is_logaddexp_without_a_threshold():
    x = torch.tensor([-30.0, -1.0, 0.0, 1.0, 19.5, 25.0, 80.0])
    want = np.logaddexp(x.numpy().astype(np.float64), 0.0)
    np.testing.assert_allclose(ssm._softplus(x).numpy(), want, rtol=1e-7)
