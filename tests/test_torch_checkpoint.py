"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's on the CPU: the same contract (atomic publish, keep-N, a stray
``.tmp`` ignored, the snapshot taken at the call) and the same file
format, so a float32 checkpoint crosses between the packages both ways bit
for bit.  bf16 leaves are ``|V2`` records in both; the port restores the
JAX package's bf16 files, which the JAX package itself cannot (ROADMAP
C.28).  Every comparison here is exact."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.checkpoint.manager import tree_paths as j_tree_paths
from repro.configs import ARCH_IDS, get_reduced as j_get_reduced
from repro.data.pipeline import SyntheticTokens as JTokens
from repro.models import lm as jlm
from repro.optim import adamw as ja
from repro.runtime.trainer import make_train_step as j_make_train_step

from repro_torch.checkpoint import CheckpointManager, tree_paths
from repro_torch.interop import (
    lm_params_from_numpy,
    lm_params_to_numpy,
    port_config,
    stack_params,
)
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as ta
from repro_torch.runtime import trainer as tt

JTINY = jlm.ModelConfig(arch_id="tiny", family="dense", n_layers=2, d_model=64,
                        n_heads=4, n_kv_heads=2, d_ff=128, vocab=64,
                        dtype=jnp.float32, remat="none", attn_chunk=16)
CPU = torch.device("cpu")


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def bits(a) -> np.ndarray:
    """The raw bytes of an array's elements, for bit-for-bit comparison."""
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8).reshape(a.shape + (a.dtype.itemsize,))


def assert_same_tree(got: dict, ref: dict):
    g, r = tree_paths(got), j_tree_paths(ref)
    assert sorted(g) == sorted(r)
    for key in r:
        gv = g[key].float().numpy() if isinstance(g[key], torch.Tensor) else np.asarray(g[key])
        rv = np.asarray(r[key])
        assert gv.shape == rv.shape, key
        np.testing.assert_array_equal(gv.astype(np.float64), rv.astype(np.float64), key)


def test_checkpoint_roundtrip_keep_n_and_stray_tmp(tmp_path):
    """The reference's ``test_checkpoint_roundtrip_and_keep_n``, twinned."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)},
            "d": [torch.zeros(2, dtype=torch.int32), torch.full((3,), 2.5,
                                                               dtype=torch.bfloat16)]}
    for s in (1, 2, 3):
        mgr.save(s, tree, blocking=True)
    assert mgr.all_steps() == [2, 3]  # keep-N removed step 1
    out = mgr.restore(3, tree)
    for key, value in tree_paths(tree).items():
        got = tree_paths(out)[key]
        assert got.dtype == value.dtype and torch.equal(got, value), key
    os.makedirs(tmp_path / "step_00000009.tmp")  # atomic: a stray .tmp is ignored
    assert mgr.latest_step() == 3
    with open(tmp_path / "step_00000003" / "meta.json") as f:
        assert f.read() == '{"step": 3, "n_arrays": 4}'
    assert sorted(tree_paths(tree)) == ["a", "b/c", "d/0", "d/1"]


def test_save_snapshots_at_the_call(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1)
    t = torch.arange(5.0)
    mgr.save(1, {"t": t})  # async
    t.add_(100.0)  # training goes on in place
    mgr.wait()
    assert torch.equal(mgr.restore(1, {"t": t})["t"], torch.arange(5.0))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_params_to_numpy_inverts_from_numpy_bit_for_bit(arch):
    jcfg = j_get_reduced(arch)
    params = numpy_tree(jlm.init_model(jcfg, 0)[0])
    back = lm_params_to_numpy(jcfg, lm_params_from_numpy(jcfg, params, device="cpu"))
    ref, got = j_tree_paths(params), j_tree_paths(back)
    assert list(got) == list(ref)  # the reference's layout, in its order
    for key, value in ref.items():
        assert got[key].shape == value.shape, key
        if value.dtype == jnp.bfloat16:  # numpy holds no bf16: exact float32
            assert got[key].dtype == np.float32
            value = value.astype(np.float32)
        assert np.array_equal(bits(got[key]), bits(value)), key


def _reference_state(jcfg, moment=jnp.float32):
    """The reference's params and AdamW state after one train step."""
    params = jlm.init_model(jcfg, 0)[0]
    opt_cfg = ja.OptimConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10,
                             moment_dtype=moment)
    batch = {k: jnp.asarray(v) for k, v in JTokens(64, 2, 16, seed=1).batch_at(0).items()}
    step = jax.jit(j_make_train_step(jcfg, opt_cfg))
    params, opt, _ = step(params, ja.adamw_init(params, opt_cfg), batch)
    return {"params": params, "opt": opt}


def test_float32_checkpoint_crosses_between_the_packages_both_ways(tmp_path):
    ref = _reference_state(JTINY)
    JManager(str(tmp_path / "ref"), keep=1).save(5, ref, blocking=True)
    # the reference's file into the port: a model of other weights, restored
    cfg = port_config(JTINY)
    model = tlm.init_model(cfg, 1, device="cpu")
    opt = ta.adamw_init(tlm.trainable(model), ta.OptimConfig())
    mgr = CheckpointManager(str(tmp_path / "ref"), keep=1)
    assert mgr.latest_step() == 5
    tt._load_state(cfg, model, opt, mgr.restore(5, tt._state_tree(cfg, model, opt)))
    assert_same_tree(lm_params_to_numpy(cfg, model), numpy_tree(ref["params"]))
    assert_same_tree({"m": stack_params(cfg, opt["m"]), "v": stack_params(cfg, opt["v"]),
                      "count": opt["count"]}, numpy_tree(ref["opt"]))
    # and the port's file into the reference
    CheckpointManager(str(tmp_path / "port"), keep=1).save(
        7, tt._state_tree(cfg, model, opt), blocking=True)
    like = {"params": jlm.init_model(JTINY, 3)[0],
            "opt": ja.adamw_init(jlm.init_model(JTINY, 3)[0], ja.OptimConfig())}
    back = JManager(str(tmp_path / "port"), keep=1).restore(7, like)
    for key, value in j_tree_paths(ref).items():
        got = j_tree_paths(back)[key]
        assert got.dtype == value.dtype and np.array_equal(bits(got), bits(value)), key


def test_reference_bf16_checkpoint_restores_in_the_port_where_the_reference_raises(tmp_path):
    jcfg = dataclasses.replace(JTINY, dtype=jnp.bfloat16)
    ref = _reference_state(jcfg, moment=jnp.bfloat16)
    JManager(str(tmp_path), keep=1).save(4, ref, blocking=True)
    with np.load(tmp_path / "step_00000004" / "arrays.npz") as data:
        assert data["params/embed"].dtype == np.dtype("V2")
        assert data["opt/m/embed"].dtype == np.dtype("V2")
    # the reference cannot read its own bf16 file back (ROADMAP C.28)
    with pytest.raises(ValueError):
        JManager(str(tmp_path), keep=1).restore(4, ref)
    cfg = port_config(jcfg)
    model = tlm.init_model(cfg, 1, device="cpu")
    opt = ta.adamw_init(tlm.trainable(model), ta.OptimConfig(moment_dtype=torch.bfloat16))
    tt._load_state(cfg, model, opt, CheckpointManager(str(tmp_path)).restore(
        4, tt._state_tree(cfg, model, opt)))
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert_same_tree(lm_params_to_numpy(cfg, model), numpy_tree(ref["params"]))
    for key in ("m", "v"):
        assert all(t.dtype == torch.bfloat16 for t in opt[key].values())
        assert_same_tree(stack_params(cfg, opt[key]), numpy_tree(ref["opt"][key]))
    # the port writes the same |V2 records back, byte for byte
    CheckpointManager(str(tmp_path / "port"), keep=1).save(
        4, tt._state_tree(cfg, model, opt), blocking=True)
    with np.load(tmp_path / "step_00000004" / "arrays.npz") as a, \
            np.load(tmp_path / "port" / "step_00000004" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype and bits(a[key]).tobytes() == bits(
                b[key]).tobytes(), key
