"""The port's mixture of experts (``repro_torch.models.moe``) against the
JAX package's (``repro.models.moe``) on the same inputs, on the CPU.

Weights are drawn by ``repro.models.moe.moe_init`` and copied into the
port's module; inputs come from ``numpy.random.default_rng``.  Tolerances,
relative to max|ref|: 1e-4 in float32 on outputs, gate weights and the
auxiliary losses (only the order of float32 sums differs); routing ids and
dispatch destinations exactly.  The configurations are the reduced
granite-moe-1b-a400m's (8 experts, top-2) and llama4-scout's (4 experts,
top-1); ``capacity_factor`` 0.5 drops slots, E / top_k drops none.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models.common import KeyGen, split_params

from repro_torch.models import moe as tmoe

F32_TOL = 1e-4
CPU = torch.device("cpu")
CONFIGS = {  # d_model and the MoE of each reduced configuration
    "granite": (128, dict(n_experts=8, top_k=2, d_ff=64)),
    "llama4-scout": (128, dict(n_experts=4, top_k=1, d_ff=128)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads, and the suite runs
    in several worker processes at once: keep this file to one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, ref, tol, what=""):
    got = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - ref).max() if got.size else 0.0
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (what, err, np.abs(ref).max())


def _pair(name, seed=0, **over):
    """(reference config, reference params, port config, port module) with
    the reference's weights, and x (2, 12, d) from ``default_rng``."""
    d_model, kw = CONFIGS[name]
    kw = {**kw, **over}
    jcfg, tcfg = jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)
    jp, _ = split_params(jmoe.moe_init(KeyGen(seed), d_model, jcfg))
    tp = tmoe.MoE(d_model, tcfg, torch.float32, CPU)
    for key, value in jp.items():
        getattr(tp, key).copy_(torch.as_tensor(np.array(value)))
    x = np.random.default_rng(seed + 1).standard_normal((2, 12, d_model)).astype(np.float32)
    return jcfg, jp, tcfg, tp, x


def test_capacity_is_the_references_ceil():
    """Over a grid of lengths and factors, and at the fractional shape of
    ``tests/test_moe.py`` (s = 8, k = 2, E = 4, cf = 1.875: 7.5 -> 8)."""
    for s in (1, 2, 7, 8, 12, 16, 32, 33):
        for E, k in ((4, 2), (8, 2), (4, 1), (32, 8), (16, 1)):
            for cf in (0.01, 0.5, 1.0, 1.25, 1.875, 4.0, 8.0):
                kw = dict(n_experts=E, top_k=k, d_ff=16, capacity_factor=cf)
                assert tmoe.moe_capacity(s, tmoe.MoEConfig(**kw)) == \
                    jmoe.moe_capacity(s, jmoe.MoEConfig(**kw)), (s, E, k, cf)
    assert tmoe.moe_capacity(8, tmoe.MoEConfig(4, 2, 16, capacity_factor=1.875)) == 8


@pytest.mark.parametrize("name", list(CONFIGS))
def test_route_matches_reference(name):
    """ids exactly, gate weights and both losses within 1e-4; also with two
    router columns equal, where every token ties between those experts
    (the lower index comes first, as ``jax.lax.top_k`` orders it)."""
    jcfg, jp, tcfg, tp, x = _pair(name)
    for tie in (False, True):
        if tie:
            router = np.asarray(jp["router"]).copy()
            router[:, 1] = router[:, 0]
            jp = {**jp, "router": jnp.asarray(router)}
            tp.router.copy_(torch.as_tensor(router))
        jw, jids, jlb, jz = jmoe._route(jp, x, jcfg)
        tw, tids, tlb, tz = tmoe._route(tp, torch.as_tensor(x), tcfg)
        assert np.array_equal(tids.numpy(), np.asarray(jids)), tie
        close(tw, jw, F32_TOL, "weights")
        close(tlb, jlb, F32_TOL, "load balance")
        close(tz, jz, F32_TOL, "z-loss")
        if tie:  # where the tied pair reaches the top k, 0 is taken first
            ids = tids.numpy()
            first = np.argmax(np.isin(ids, (0, 1)), axis=-1)
            reached = np.isin(ids, (0, 1)).any(-1)
            assert reached.any()
            assert (np.take_along_axis(ids, first[..., None], -1)[..., 0][reached]
                    == 0).all()
    _, _, lb0, z0 = tmoe._route(tp, torch.as_tensor(x), tcfg, aux=False)
    assert lb0 == z0 == 0.0


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("cf", [0.5, 4.0])
def test_dispatch_matches_reference(name, cf):
    """``dest`` exactly and ``out_flat`` within 1e-4 of max|ref|; slots drop
    at capacity_factor 0.5 and none does at 4.0 (E / top_k or more)."""
    jcfg, jp, tcfg, tp, x = _pair(name, capacity_factor=cf)
    jout, jdest, jw, jlb, jz, jC = jmoe._dispatch_expert_outputs(jp, x, jcfg)
    tout, tdest, tw, tlb, tz, tC = tmoe._dispatch_expert_outputs(
        tp, torch.as_tensor(x), tcfg)
    assert tC == jC
    assert np.array_equal(tdest.numpy(), np.asarray(jdest))
    close(tout, jout, F32_TOL, "out_flat")
    assert not tout[:, -1].any()  # the row dropped slots read
    dropped = int((tdest == tcfg.n_experts * tC).sum())
    assert (dropped > 0) == (cf < tcfg.n_experts / tcfg.top_k), dropped
    with pytest.raises(ValueError, match="partition"):
        tmoe._dispatch_expert_outputs(tp, torch.as_tensor(x), tcfg, partition="dp")


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
def test_moe_apply_and_dense_oracle_match_reference(name, cf):
    jcfg, jp, tcfg, tp, x = _pair(name, capacity_factor=cf)
    tx = torch.as_tensor(x)
    jy, jaux = jmoe.moe_apply(jp, x, jcfg)
    for partition in ("ep", "tp"):  # the same function on one card
        ty, taux = tmoe.moe_apply(tp, tx, tcfg, partition)
        close(ty, jy, F32_TOL, f"moe_apply {partition}")
        close(taux, jaux, F32_TOL, "aux")
    assert tmoe.moe_apply(tp, tx, tcfg, aux=False)[1] == 0.0
    oracle = tmoe.moe_apply_dense_ref(tp, tx, tcfg)
    close(oracle, jmoe.moe_apply_dense_ref(jp, x, jcfg), F32_TOL, "dense oracle")
    if cf >= tcfg.n_experts / tcfg.top_k:  # nothing drops: the oracle is exact
        close(ty, oracle, F32_TOL, "against the oracle")


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("cf", [0.5, 4.0])
def test_moe_apply_spmspv_matches_reference_and_oracle(name, cf):
    """The combine through the spmspv tier (``impl="cuda"``: its plain
    version on CPU tensors) against the reference's ``impl="ref"``, and
    against the port's own ``moe_apply`` (drops and all, since the dispatch
    is shared) and, where nothing drops, the dense oracle."""
    jcfg, jp, tcfg, tp, x = _pair(name, capacity_factor=cf)
    tx = torch.as_tensor(x)
    ref = jmoe.moe_apply_spmspv(jp, x, jcfg, impl="ref")
    for impl in ("cuda", "ref"):
        got = tmoe.moe_apply_spmspv(tp, tx, tcfg, impl=impl)
        assert got.dtype == torch.float32 and got.device == CPU
        close(got, ref, F32_TOL, f"spmspv {impl}")
        close(got, tmoe.moe_apply(tp, tx, tcfg)[0], F32_TOL, "against moe_apply")
        if cf >= tcfg.n_experts / tcfg.top_k:
            close(got, tmoe.moe_apply_dense_ref(tp, tx, tcfg), F32_TOL, "oracle")


def test_moe_apply_spmspv_when_every_slot_of_a_token_drops():
    """A router that sends every token to expert 0 (top-1, capacity 1 at
    cf = 0.25 over 4 experts): past the first token of a row every slot
    drops, so those tokens are empty sparse right-hand sides and give 0."""
    jcfg, jp, tcfg, tp, x = _pair("llama4-scout", capacity_factor=0.25)
    router = np.zeros_like(np.asarray(jp["router"]))
    router[:, 0] = 1.0
    jp = {**jp, "router": jnp.asarray(router)}
    tp.router.copy_(torch.as_tensor(router))
    x = np.abs(x)  # every token's logit for expert 0 is the largest
    tx = torch.as_tensor(x)
    got = tmoe.moe_apply_spmspv(tp, tx, tcfg)
    close(got, jmoe.moe_apply_spmspv(jp, x, jcfg), F32_TOL, "spmspv")
    assert got[:, 0].abs().max() > 0 and not got[:, 1:].any()
    close(got, tmoe.moe_apply(tp, tx, tcfg)[0], F32_TOL, "moe_apply")


def test_bf16_module_keeps_a_float32_router_and_the_models_dtype():
    """The router is float32 whatever the model's dtype, as the reference
    makes it; the experts and the output take the model's dtype."""
    cfg = tmoe.MoEConfig(**CONFIGS["granite"][1])
    p = tmoe.moe_init(torch.Generator().manual_seed(0), 128, cfg, torch.bfloat16)
    assert p.router.dtype == torch.float32 and p.wo.dtype == torch.bfloat16
    assert tuple(p.wi_gate.shape) == (8, 128, 64) and tuple(p.wo.shape) == (8, 64, 128)
    x = torch.randn(2, 5, 128, generator=torch.Generator().manual_seed(1))
    y, aux = tmoe.moe_apply(p, x.to(torch.bfloat16), cfg)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    with pytest.raises(ValueError, match="partition"):
        tmoe.MoE(128, cfg, torch.float32, CPU, partition="dp")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jmoe.MoEConfig(**CONFIGS["granite"][1]))
