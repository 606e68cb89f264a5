"""The port's int8 error-feedback compression (``optim.compress``) against
the JAX package's on the CPU, bit for bit.

The JAX package's ``ef_compressed_psum`` runs under ``jax.vmap(...,
axis_name="d")`` on one CPU device (``vmap`` carries ``pmax`` and
``psum``); the port's takes the per-shard lists along a mesh axis of CPU
cells.  Both quantize to the axis's largest scale, so beside equality the
error-feedback identity holds exactly (g + e_old = q·scale_max + e_new, in
exact arithmetic: evaluated in float64) and the reduced sum is within
D·scale_max/2 of the exact one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as jc

from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import compress as tc

D = 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize_equal_the_references(dtype):
    rng = np.random.default_rng(0)
    for scale in (1e-6, 1.0, 1e3):
        x = jnp.asarray(rng.standard_normal((33, 7)).astype(np.float32) * scale).astype(dtype)
        jq, js = jc.quantize_int8(x)
        t = torch.as_tensor(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dtype))
        tq, ts = tc.quantize_int8(t)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.item() == float(js)
        np.testing.assert_array_equal(tc.dequantize_int8(tq, ts).numpy(),
                                      np.asarray(jc.dequantize_int8(jq, js)))
    zq, zs = tc.quantize_int8(torch.zeros(4, dtype=getattr(torch, dtype)))
    assert zs.item() == np.float32(1e-12) and not zq.any()  # the floor of the scale


@pytest.mark.parametrize("mesh_shape,axis", [((1, D, 1), "data"), ((2, D, 2), "data"),
                                             ((1, 2, D), "model")])
def test_ef_compressed_psum_equals_the_references_over_three_steps(mesh_shape, axis):
    """Shards of gradients 10^-6 ... 10^3 apart, so every shard but the
    largest quantizes at another's scale; three error-feedback steps."""
    mesh = make_mesh(*mesh_shape, device="cpu")
    rng = np.random.default_rng(1)
    mag = np.float32(10.0) ** rng.uniform(-6, 3, D).astype(np.float32)
    f = jax.jit(jax.vmap(lambda g, e: jc.ef_compressed_psum(g, e, "d"), axis_name="d"))
    j_err = jnp.zeros((D, 37, 5), jnp.float32)
    t_err = [torch.zeros(37, 5) for _ in range(D)]
    for step in range(3):
        g = (rng.standard_normal((D, 37, 5)) * mag[:, None, None]).astype(np.float32)
        j_out, j_err = f(jnp.asarray(g), j_err)
        e_old = [e.clone() for e in t_err]
        t_out, t_err = tc.ef_compressed_psum([torch.as_tensor(x) for x in g], t_err, mesh, axis)
        for i in range(D):
            np.testing.assert_array_equal(t_out[i].numpy(), np.asarray(j_out[i]))
            np.testing.assert_array_equal(t_err[i].numpy(), np.asarray(j_err[i]))
        assert all(torch.equal(t_out[0], o) for o in t_out)
        # the identity, and the distance from the exact sum
        gs = [torch.as_tensor(x) + e for x, e in zip(g, e_old)]
        s_max = max(float(tc.quantize_int8(x)[1]) for x in gs)
        s = torch.tensor(s_max, dtype=torch.float32)
        for x, e in zip(gs, t_err):
            q = torch.clamp(torch.round(x / s), -127, 127)
            assert torch.equal(q.double() * s.double() + e.double(), x.double())
        exact = sum(x.double() for x in gs)
        assert float((t_out[0].double() - exact).abs().max()) <= D * s_max / 2


def test_ef_compressed_psum_takes_one_entry_per_shard_and_bf16_gradients():
    mesh = make_mesh(1, 4, 2, device="cpu")
    g = [torch.randn(6, generator=torch.Generator().manual_seed(i)).to(torch.bfloat16)
         for i in range(4)]
    with pytest.raises(ValueError, match="4 shards"):
        tc.ef_compressed_psum(g[:3], [torch.zeros(6)] * 3, mesh, "data")
    out, err = tc.ef_compressed_psum(g, [torch.zeros(6)] * 4, mesh, "data")
    assert out[0].dtype == torch.float32 and err[0].dtype == torch.float32
    assert tc.axis_devices(mesh, "model") == [torch.device("cpu")] * 2
