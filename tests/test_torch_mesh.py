"""The port's LM meshes and sharded train step (``launch.mesh.make_mesh``,
``models.common.MeshRules``, ``models.lm.param_axes``,
``launch.shardspecs``, ``runtime.sharded``, ``runtime.trainer``'s mesh
path, ``launch.train --pods/--data/--model``) against the JAX package on
the CPU, every mesh cell on the CPU.

Tolerances (float32; only the order of float32 sums differs):

* Axes, rules and specs: equal.  The reference's specs come from its own
  ``fit_spec`` / ``opt_shardings`` / ``batch_shardings`` /
  ``decode_state_shardings`` on a ``jax.sharding.AbstractMesh`` of the
  same shape (they read only the mesh's shape), full-size shapes from its
  ``abstract_model`` and the port's ``init_model(device="meta")``.
* The sharded step on a 2x4 mesh (every family's reduced config, n_micro
  1 and 2) against the port's single-device step and the reference's
  single-device ``make_train_step`` on carried weights (its own sharded
  step fails under jax 0.9.0: ROADMAP C.1): the metrics within 1e-5
  relative (``aux`` 1e-5 absolute), the sharded gradient within 1e-4 of
  each leaf's max, the parameters within 2e-5 plus what AdamW's first
  step makes of the two gradients' rounding, lr·|Δ(g/(|g|+eps))| on the
  clipped gradients (ROADMAP C.30).
* Checkpoints across meshes: bit for bit.  ``train_loop(mesh=)``'s crash
  and resume: every loss within 1e-4 relative of an uninterrupted run.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.checkpoint.manager import tree_paths as j_tree_paths
from repro.configs import ARCH_IDS, get_config as j_get_config, get_reduced as j_get_reduced
from repro.launch import mesh as jmesh
from repro.launch import shardspecs as jss
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models.ffn import SparseFFNConfig as JSparseFFNConfig
from repro.optim import adamw as ja
from repro.runtime import trainer as jt

from repro_torch.core.distributed import Mesh
from repro_torch.data.pipeline import SyntheticTokens, make_batch
from repro_torch.interop import _stacked, lm_params_from_numpy, port_config
from repro_torch.launch import shardspecs as tss
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import batch_axes, make_mesh
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as ta
from repro_torch.runtime import trainer as tt
from repro_torch.runtime.sharded import leaf_layout

from test_torch_hybrid import perturbed

LOSS_REL = 1e-5
AUX_ABS = 1e-5
GRAD_TOL = 1e-4
PARAM_ABS = 2e-5
LR = 1e-3
FAMILY_ARCHS = ["qwen1.5-4b", "granite-moe-1b-a400m", "rwkv6-7b", "zamba2-2.7b",
                "whisper-tiny", "qwen2-vl-72b"]
SPEC_MESHES = [(2, 4), (1, 4, 2), (16, 16), (2, 16, 16)]
MESH_CFG = tlm.ModelConfig(arch_id="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                           n_kv_heads=4, d_ff=128, vocab=512, dtype=torch.float32,
                           remat="none", attn_chunk=16)
JTINY = jlm.ModelConfig(arch_id="tiny", family="dense", n_layers=2, d_model=64,
                        n_heads=4, n_kv_heads=2, d_ff=128, vocab=64,
                        dtype=jnp.float32, remat="none", attn_chunk=16)
TINY = port_config(JTINY)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: keep this file
    to one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def opt_cfgs(**kw):
    kw = {"lr_peak": LR, "warmup_steps": 1, "total_steps": 10, **kw}
    return ja.OptimConfig(**kw), ta.OptimConfig(**kw)


def cpu_mesh(shape) -> Mesh:
    return make_mesh(*((1,) + tuple(shape) if len(shape) == 2 else shape), device="cpu")


def rules_of(mesh):
    return tcommon.default_rules(multi_pod="pod" in mesh.axis_names)


def unstack_tree(cfg, tree) -> dict:
    """A reference tree of per-leaf values (specs, axes) under the port's
    names, each layer-stacked leaf dropping its leading layer entries."""
    lead = _stacked(cfg)

    def flat(node, prefix=""):
        for key, value in node.items():
            if isinstance(value, dict):
                yield from flat(value, f"{prefix}{key}.")
            else:
                yield f"{prefix}{key}", value

    out = {}
    for name, value in flat(tree):
        top, _, rest = name.partition(".")
        n = lead.get(top)
        if n is None:
            out[name] = value
            continue
        for index in np.ndindex(*n):
            out[f"{top}.{'.'.join(map(str, index))}.{rest}"] = value[len(n):]
    return out


def spec_tree(tree):
    """NamedSharding tree -> nested dict of spec tuples."""
    return {k: spec_tree(v) if isinstance(v, dict) else tuple(v.spec)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# meshes and rules
# ---------------------------------------------------------------------------
def test_make_mesh_axes_shapes_and_batch_axes():
    m2 = make_mesh(1, 2, 4, device="cpu")
    assert m2.axis_names == ("data", "model") and m2.shape == {"data": 2, "model": 4}
    assert m2.devices == (torch.device("cpu"),) * 8 and m2.n_devices == 1
    assert m2.device_at((1, 3)) == torch.device("cpu")
    m3 = make_mesh(2, 2, 2, device="cpu")
    assert m3.axis_names == ("pod", "data", "model") and list(m3.shape.values()) == [2, 2, 2]
    for mesh in (m2, m3, make_mesh(1, 16, 16, device="cpu"), make_mesh(2, 16, 16, device="cpu")):
        ref = AbstractMesh(tuple(mesh.shape.values()), mesh.axis_names)
        assert batch_axes(mesh) == jmesh.batch_axes(ref)
    with pytest.raises(ValueError, match=">= 1"):
        make_mesh(1, 0, 2, device="cpu")
    with pytest.raises(ValueError, match="distinct axis names"):
        Mesh([["cpu", "cpu"]], ("data",))


def test_make_mesh_places_cells_round_robin_where_jax_refuses(monkeypatch):
    """ROADMAP C.32: ``jax.make_mesh`` refuses more cells than devices; the
    port puts cell i (row-major) on card i mod the visible count."""
    with pytest.raises(ValueError):
        jax.make_mesh((2, 4), ("data", "model"))  # one CPU device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    mesh = make_mesh(1, 2, 4)
    assert [d.index for d in mesh.devices] == [0, 1, 2, 0, 1, 2, 0, 1]
    assert mesh.device_at((1, 0)) == torch.device("cuda", 1) and mesh.n_devices == 3
    assert [d.index for d in make_mesh(2, 2, 2).devices] == [0, 1, 2, 0, 1, 2, 0, 1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1, 2, 4)


def test_the_sparse_entry_points_refuse_a_mesh_with_more_axes():
    from repro_torch.core.formats import csr_from_dense
    from repro_torch.runtime.engine import SparseEngine
    from repro_torch.runtime.solver import SparseSolver
    from repro_torch.tune import SparseOperator

    a = csr_from_dense(np.eye(8, dtype=np.float32) * 2.0)
    mesh = make_mesh(1, 2, 2, device="cpu")
    for build in (lambda: SparseEngine(a, mesh=mesh), lambda: SparseSolver(a, mesh=mesh),
                  lambda: SparseOperator.build(a, k=1, mesh=mesh)):
        with pytest.raises(ValueError, match=r"1-D mesh.*\('data', 'model'\)"):
            build()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_default_rules_and_rules_for_equal_the_references(multi_pod):
    ref = jcommon.default_rules(multi_pod)
    got = tcommon.default_rules(multi_pod)
    assert got.rules == ref.rules
    shape = (2, 2, 4) if multi_pod else (2, 4)
    mesh = cpu_mesh(shape)
    assert tss.rules_for(mesh).rules == jss.rules_for(AbstractMesh(shape, mesh.axis_names)).rules
    axes = [("embed", "heads_flat"), ("batch", None, "act_model"), (None, "vocab"),
            ("experts", "embed", "expert_mlp"), ()]
    for ax in axes:
        assert got.spec(ax) == tuple(ref.spec(ax)), ax
    tree = {"a": axes[0], "b": {"c": axes[2]}}
    assert got.tree_specs(tree) == {"a": got.spec(axes[0]), "b": {"c": got.spec(axes[2])}}
    tcommon.set_active_rules(got)
    assert tcommon._ACTIVE_RULES[0] is got
    tcommon.set_active_rules(tcommon.DEFAULT_RULES)


def _variant_configs():
    base = j_get_reduced("qwen1.5-4b")
    return {
        "bcsr": dataclasses.replace(base, arch_id="bcsr", sparse_ffn=JSparseFFNConfig(
            kind="bcsr", block=(32, 32), impl="ref")),
        "structured": dataclasses.replace(base, arch_id="structured",
                                          sparse_ffn=JSparseFFNConfig(n_groups=4)),
        "moe-tp": dataclasses.replace(j_get_reduced("granite-moe-1b-a400m"),
                                      moe_partition="tp"),
    }


@pytest.mark.parametrize("arch", ARCH_IDS + ["bcsr", "structured", "moe-tp"])
def test_param_axes_equal_the_references(arch):
    jcfg = _variant_configs()[arch] if arch in _variant_configs() else j_get_reduced(arch)
    cfg = port_config(jcfg)
    ref = unstack_tree(cfg, jlm.init_model(jcfg, 0)[1])
    model = tlm.init_model(cfg, 0, device="meta")
    got = tlm.param_axes(cfg, model)
    assert list(got) == list(model.state_dict())
    assert got == ref


# ---------------------------------------------------------------------------
# shard specs at full size
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _full_size(arch):
    jcfg = j_get_config(arch)
    shapes, axes = jlm.abstract_model(jcfg)
    cfg = port_config(jcfg)
    model = tlm.init_model(cfg, 0, device="meta")
    return jcfg, cfg, shapes, axes, model, tlm.param_axes(cfg, model)


def _batch_shapes(cfg, b, s):
    shapes = {"tokens": (b, s), "labels": (b, s)}
    if cfg.family == "audio":
        shapes["frames"] = (b, cfg.enc_frames, cfg.d_model)
    if cfg.family == "vlm":
        shapes["vision_embeds"] = (b, cfg.n_vision_tokens, cfg.d_model)
        shapes["positions"] = (3, b, s)
    return shapes


@pytest.mark.parametrize("shape", SPEC_MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_size_specs_equal_the_references(arch, shape):
    jcfg, cfg, shapes, axes, model, t_axes = _full_size(arch)
    mesh = cpu_mesh(shape)
    amesh = AbstractMesh(tuple(mesh.shape.values()), mesh.axis_names)
    rules, jrules = tss.rules_for(mesh), jss.rules_for(amesh)
    t_shapes = {n: t.shape for n, t in model.state_dict().items()}
    # every leaf through fit_spec, and the parameter and optimizer trees
    ref = unstack_tree(cfg, spec_tree(jss.param_shardings(amesh, jrules, axes, shapes)))
    got = tss.param_shardings(mesh, rules, t_axes, t_shapes)
    assert got == ref
    assert got == {n: tss.fit_spec(mesh, rules.spec(t_axes[n]), t_shapes[n]) for n in got}
    opt_shapes = {"m": shapes, "v": shapes, "master": shapes}
    jopt = jss.opt_shardings(amesh, jrules, axes, shapes, opt_shapes)
    topt = tss.opt_shardings(mesh, rules, t_axes, t_shapes,
                             {"m": t_shapes, "v": t_shapes, "master": t_shapes})
    for key in ("m", "v", "master"):
        assert topt[key] == unstack_tree(cfg, spec_tree(jopt[key])), key
    assert topt["count"] == tuple(jopt["count"].spec) == ()
    # batches: one that the batch axes split, and a batch of one
    for b in (256, 1):
        bs = _batch_shapes(cfg, b, 64)
        jb = jss.batch_shardings(amesh, jcfg, {k: jax.ShapeDtypeStruct(v, jnp.int32)
                                               for k, v in bs.items()})
        assert tss.batch_shardings(mesh, cfg, bs) == spec_tree(jb), b
    # decode state
    jstate = jax.eval_shape(lambda: jlm.init_decode_state(jcfg, 32, 256))
    tstate = tlm.init_decode_state(cfg, 32, 256, device="meta")
    assert (tss.decode_state_shardings(mesh, cfg, tstate)
            == spec_tree(jss.decode_state_shardings(amesh, jcfg, jstate)))


def test_fit_spec_drops_an_axis_that_does_not_divide():
    mesh = cpu_mesh((16, 16))
    amesh = AbstractMesh((16, 16), ("data", "model"))
    for spec, shape in ((("data", "model"), (2560, 8)), ((("pod", "data"),), (4,)),
                        ((("data", "model"), None), (512, 3)), ((None, "model"), (3, 32))):
        if "pod" in str(spec):
            mesh3, amesh3 = cpu_mesh((2, 16, 16)), AbstractMesh((2, 16, 16),
                                                                 ("pod", "data", "model"))
            got = tss.fit_spec(mesh3, spec, shape)
            assert got == tuple(jss.fit_spec(amesh3, jax.sharding.PartitionSpec(*spec), shape))
            continue
        got = tss.fit_spec(mesh, spec, shape)
        assert got == tuple(jss.fit_spec(amesh, jax.sharding.PartitionSpec(*spec), shape))
    assert tss.fit_spec(mesh, ("data", "model"), (2560, 8)) == ("data", None)


def test_leaf_layouts_own_each_block_once_and_round_trip():
    mesh = make_mesh(1, 2, 4, device="cpu")
    lay = leaf_layout(mesh, ("data", "model"), (6, 8))
    assert lay.grid == (2, 4) and lay.block == (3, 2) and lay.n_blocks == 8
    assert lay.owned == {torch.device("cpu"): tuple(range(8))}
    from repro_torch.runtime.sharded import gather, reduce_into, scatter

    full = torch.arange(48.0).reshape(6, 8)
    stacks = scatter(lay, full)
    assert torch.equal(stacks[torch.device("cpu")][5], full[3:6, 2:4])  # block (1, 1)
    assert torch.equal(gather(lay, stacks, torch.empty(6, 8)), full)
    acc: dict = {}
    reduce_into(lay, acc, full, torch.float32)
    reduce_into(lay, acc, full, torch.float32)
    assert torch.equal(gather(lay, acc, torch.empty(6, 8)), 2 * full)
    # a (pod, data) tuple splits one dimension, pod major
    lay3 = leaf_layout(make_mesh(2, 2, 2, device="cpu"), (("pod", "data"), None), (8, 2))
    assert lay3.grid == (4, 1)


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------
def port_step_grads(cfg, model, batch, n_micro):
    """The single-device step's gradient as make_train_step forms it."""
    params = tlm.trainable(model)
    micro = tt._split_micro(tt._on(batch, model.device), n_micro)
    grads = {n: torch.zeros(p.shape, dtype=torch.float32) for n, p in params.items()}
    for i in range(n_micro):
        loss, _ = tlm.loss_fn(cfg, model, {k: v[i] for k, v in micro.items()})
        for n, g in zip(params, torch.autograd.grad(loss, list(params.values()))):
            grads[n] += g
    return {n: (g / n_micro).double() for n, g in grads.items()}


def ref_step_grads(jcfg, jparams, batch, n_micro, cfg):
    """The reference step's gradient: each microbatch's, summed in float32
    and divided by their count (its scan's order), under the port's names."""
    grad = jax.jit(jax.grad(lambda p, b: jlm.loss_fn(jcfg, p, b)[0]))
    micro = jt._split_micro({k: jnp.asarray(v) for k, v in batch.items()}, n_micro)
    total = None
    for i in range(n_micro):
        g = jax.tree.map(np.asarray, grad(jparams, {k: v[i] for k, v in micro.items()}))
        total = g if total is None else jax.tree.map(np.add, total, g)
    from repro_torch.interop import unstack_params

    flat = unstack_params(cfg, total)
    return {n: torch.as_tensor(np.asarray(v) / np.float32(n_micro)).double()
            for n, v in flat.items()}


def sharded_run(cfg, model, batch, n_micro, mesh, opt_cfg):
    """(metrics, sharded model, its step's whole gradient) of one sharded step."""
    rules = rules_of(mesh)
    sm = tt.shard_model(cfg, model, mesh, rules)
    acc, _, _ = tt.sharded_grads(cfg, sm, batch, n_micro)
    grads = {n: sm.full(n, acc).double() for n in acc}
    opt = tt.sharded_adamw_init(sm, opt_cfg, rules)
    sm, opt, metrics = tt.make_sharded_train_step(cfg, opt_cfg, n_micro)(sm, opt, batch)
    return {k: float(v) for k, v in metrics.items()}, sm, grads


def clipped(grads, clip=1.0):
    norm = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
    return {n: g * min(1.0, clip / max(norm, 1e-9)) for n, g in grads.items()}


def assert_params_close(got: dict, ref: dict, g_got: dict, g_ref: dict, what=""):
    """|Δp| <= 2e-5 + lr·|Δ(h/(|h|+eps))| on the clipped gradients (C.30)."""
    h1, h2 = clipped(g_ref), clipped(g_got)
    eps = ta.OptimConfig().eps
    for name, r in ref.items():
        d = (got[name].double() - torch.as_tensor(r).double()).abs()
        amp = LR * (h2[name] / (h2[name].abs() + eps)
                    - h1[name] / (h1[name].abs() + eps)).abs()
        assert bool((d <= PARAM_ABS + amp).all()), (what, name, float((d - amp).max()))


def assert_grads_close(got: dict, ref: dict, what=""):
    for name, r in ref.items():
        err = float((got[name] - r).abs().max())
        assert err <= GRAD_TOL * max(float(r.abs().max()), 1e-30), (what, name, err)


def assert_metrics_close(got: dict, ref: dict, what=""):
    assert set(got) == set(ref), what
    for key, r in ref.items():
        r, g = float(r), float(got[key])
        tol = AUX_ABS if key == "aux" else LOSS_REL * max(abs(r), 1e-30)
        assert abs(g - r) <= tol, (what, key, g, r)


def ref_params(jcfg, seed=0):
    params = jax.tree.map(np.asarray, jlm.init_model(jcfg, seed)[0])
    return perturbed(params, seed + 10) if jcfg.family == "hybrid" else params


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_sharded_step_matches_the_single_device_step_and_the_reference(arch, n_micro):
    """Every family trains on a 2x4 mesh: the gather-to-compute design runs
    the port's own ``loss_fn`` on each replica, so no family needs code of
    its own."""
    jcfg = dataclasses.replace(j_get_reduced(arch), dtype=jnp.float32)
    cfg = port_config(jcfg)
    params = ref_params(jcfg)
    batch = make_batch(jcfg, 4, 16, step=0)
    jopt_cfg, opt_cfg = opt_cfgs()
    mesh = make_mesh(1, 2, 4, device="cpu")
    # the port on one device
    single = lm_params_from_numpy(jcfg, params, device="cpu")
    g_single = port_step_grads(cfg, single, batch, n_micro)
    opt = ta.adamw_init(tlm.trainable(single), opt_cfg)
    single, _, m_single = tt.make_train_step(cfg, opt_cfg, n_micro)(single, opt, batch)
    # the port on the mesh
    m_mesh, sm, g_mesh = sharded_run(cfg, lm_params_from_numpy(jcfg, params, device="cpu"),
                                     batch, n_micro, mesh, opt_cfg)
    # the reference on one device
    jp = jax.tree.map(jnp.asarray, params)
    g_ref = ref_step_grads(jcfg, jp, batch, n_micro, cfg)
    jp, _, m_ref = jax.jit(jt.make_train_step(jcfg, jopt_cfg, n_micro))(
        jp, ja.adamw_init(jp, jopt_cfg), {k: jnp.asarray(v) for k, v in batch.items()})
    from repro_torch.interop import unstack_params

    ref_new = unstack_params(cfg, jax.tree.map(np.asarray, jp))
    got = sm.state_dict()
    assert_metrics_close(m_mesh, {k: float(v) for k, v in m_single.items()}, "single")
    assert_metrics_close(m_mesh, {k: float(v) for k, v in m_ref.items()}, "reference")
    assert_grads_close(g_mesh, g_single, "single")
    assert_grads_close(g_mesh, g_ref, "reference")
    assert_params_close(got, single.state_dict(), g_mesh, g_single, "single")
    assert_params_close(got, {n: ref_new[n] for n in got if n in g_ref}, g_mesh, g_ref,
                        "reference")
    assert any(len(lay.owned[torch.device("cpu")]) > 1 for lay in sm.layouts.values())


def _uneven_labels(batch, n_rows_masked, keep=3):
    labels = batch["labels"].copy()
    labels[:n_rows_masked, keep:] = -1
    return {**batch, "labels": labels}


EDGE_CASES = {
    # the first data half holds 3 valid labels, the second 64
    "uneven_mask": dict(mesh=(1, 2, 4), batch=4, masked=2, keep=3),
    # the first data half holds none: its own count would clamp to 1
    "empty_half": dict(mesh=(1, 2, 4), batch=4, masked=2, keep=0),
    # 6 rows over 4 data cells: fit_spec replicates the batch
    "replicated_batch": dict(mesh=(1, 4, 2), batch=6, masked=0, keep=0),
    "pod_data_model": dict(mesh=(2, 2, 2), batch=8, masked=3, keep=5),
}


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_sharded_step_edge_cases_match_the_single_device_step(case, n_micro):
    """A replica's losses divide by the microbatch's global count of valid
    labels (ROADMAP C.33), a batch the batch axes do not divide is computed
    once, and a 3-D mesh splits the batch over (pod, data)."""
    spec = EDGE_CASES[case]
    batch = SyntheticTokens(vocab=512, batch=spec["batch"], seq=32, seed=4).batch_at(0)
    if spec["masked"]:
        batch = _uneven_labels(batch, spec["masked"], spec["keep"])
    _, opt_cfg = opt_cfgs()
    single = tlm.init_model(MESH_CFG, 0, device="cpu")
    g_single = port_step_grads(MESH_CFG, single, batch, n_micro)
    opt = ta.adamw_init(tlm.trainable(single), opt_cfg)
    single, _, m_single = tt.make_train_step(MESH_CFG, opt_cfg, n_micro)(single, opt, batch)
    mesh = make_mesh(*spec["mesh"], device="cpu")
    m_mesh, sm, g_mesh = sharded_run(MESH_CFG, tlm.init_model(MESH_CFG, 0, device="cpu"),
                                     batch, n_micro, mesh, opt_cfg)
    assert_metrics_close(m_mesh, {k: float(v) for k, v in m_single.items()}, case)
    assert_grads_close(g_mesh, g_single, case)
    assert_params_close(sm.state_dict(), single.state_dict(), g_mesh, g_single, case)


def two_device_mesh(data: int, model: int) -> Mesh:
    """Cells alternating between ``cpu`` and ``cpu:0``: two distinct devices
    to the mesh (round-robin, as ``make_mesh`` places cells on two cards),
    both the host, so the owners, index gathers and cross-device
    reductions of a multi-card mesh run here."""
    devs = [torch.device("cpu"), torch.device("cpu", 0)]
    cells = np.empty(data * model, dtype=object)
    cells[:] = [devs[i % 2] for i in range(data * model)]
    return Mesh(cells.reshape(data, model), ("data", "model"))


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("shape", [(2, 3), (2, 2)], ids=["replicas_apart", "owners_strided"])
def test_sharded_step_over_two_devices_matches_the_single_device_step(shape, n_micro):
    """(2, 3): replica 1 computes on the second device and every split leaf
    has one block on each; (2, 2): both replicas compute on the first
    device, and each device owns every other block of a leaf."""
    mesh = two_device_mesh(*shape)
    assert mesh.n_devices == 2
    batch = _uneven_labels(SyntheticTokens(512, 4, 32, seed=4).batch_at(0), 2, 5)
    _, opt_cfg = opt_cfgs()
    single = tlm.init_model(MESH_CFG, 0, device="cpu")
    g_single = port_step_grads(MESH_CFG, single, batch, n_micro)
    opt = ta.adamw_init(tlm.trainable(single), opt_cfg)
    single, _, m_single = tt.make_train_step(MESH_CFG, opt_cfg, n_micro)(single, opt, batch)
    m_mesh, sm, g_mesh = sharded_run(MESH_CFG, tlm.init_model(MESH_CFG, 0, device="cpu"),
                                     batch, n_micro, mesh, opt_cfg)
    assert max(len(lay.owned) for lay in sm.layouts.values()) == 2
    owned = {ix for lay in sm.layouts.values() for ix in lay.owned.values()}
    assert ((0, 2) in owned) == (shape == (2, 2))  # every other block of a 2x2 grid
    assert {tt.replica_device(mesh, r) for r in range(2)} == (
        set(mesh.devices) if shape == (2, 3) else {torch.device("cpu")})
    assert_metrics_close(m_mesh, {k: float(v) for k, v in m_single.items()}, str(shape))
    assert_grads_close(g_mesh, g_single, str(shape))
    assert_params_close(sm.state_dict(), single.state_dict(), g_mesh, g_single, str(shape))
    # the logical state round-trips through another two-device layout
    other = two_device_mesh(shape[1], shape[0])
    sm2 = tt.shard_model(MESH_CFG, tlm.init_model(MESH_CFG, 1, device="cpu"), other,
                         rules_of(other))
    sm2.load(sm.state_dict())
    assert _bitwise(sm2.state_dict(), sm.state_dict())


def test_each_replica_sees_its_rows_and_the_naive_denominator_would_differ():
    """The replicas of a 2x4 mesh hold rows 0-1 and 2-3.  Dividing each by
    its own count (``loss_fn``'s default) would weight the sparse half's
    tokens up; the global count gives the single-device loss."""
    batch = _uneven_labels(SyntheticTokens(512, 4, 32, seed=4).batch_at(0), 2, 3)
    mesh = make_mesh(1, 2, 4, device="cpu")
    sm = tt.shard_model(MESH_CFG, tlm.init_model(MESH_CFG, 0, device="cpu"), mesh,
                        rules_of(mesh))
    seen = []
    _, loss, _ = tt.sharded_grads(MESH_CFG, sm, batch, 1,
                                  on_replica=lambda i, r, d, g: seen.append((i, r, d)))
    assert seen == [(0, 0, torch.device("cpu")), (0, 1, torch.device("cpu"))]
    model = tlm.init_model(MESH_CFG, 0, device="cpu")
    whole = float(tlm.loss_fn(MESH_CFG, model, batch)[0])
    halves = [{k: v[2 * r:2 * r + 2] for k, v in batch.items()} for r in range(2)]
    naive = sum(float(tlm.loss_fn(MESH_CFG, model, h, aux_weight=0.5)[0]) for h in halves)
    assert abs(float(loss) - whole) <= LOSS_REL * whole
    assert abs(naive - whole) > 100 * LOSS_REL * whole


def test_a_bf16_sharded_step_keeps_every_leafs_shape_and_dtype():
    cfg = tlm.ModelConfig(**{**dataclasses.asdict(MESH_CFG), "dtype": torch.bfloat16})
    model = tlm.init_model(cfg, 0, device="cpu")
    mesh = make_mesh(1, 2, 4, device="cpu")
    rules = rules_of(mesh)
    sm = tt.shard_model(cfg, model, mesh, rules)
    _, opt_cfg = opt_cfgs(moment_dtype=torch.bfloat16, master_fp32=True)
    opt = tt.sharded_adamw_init(sm, opt_cfg, rules)
    layout = {n: (tuple(t.shape), t.dtype) for n, t in sm.state_dict().items()}
    batch = SyntheticTokens(512, 4, 32, seed=1).batch_at(0)
    sm, opt, m = tt.make_sharded_train_step(cfg, opt_cfg, 2)(sm, opt, batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert {n: (tuple(t.shape), t.dtype) for n, t in sm.state_dict().items()} == layout
    assert all(s.dtype == torch.bfloat16 for b in opt["m"].values() for s in b.values())
    assert all(s.dtype == torch.float32 for b in opt["master"].values() for s in b.values())
    assert {int(c) for c in opt["count"].values()} == {1}


# ---------------------------------------------------------------------------
# train_loop, checkpoints across meshes, the CLI
# ---------------------------------------------------------------------------
def _mesh_run(tmp_path, name, mesh, steps=4, fault=None, cfg=TINY, **kw):
    tc = tt.TrainConfig(steps=steps, ckpt_every=kw.pop("ckpt_every", 2),
                        ckpt_dir=str(tmp_path / name), log_every=1000)
    _, opt_cfg = opt_cfgs(total_steps=30, warmup_steps=2)
    return tt.train_loop(cfg, opt_cfg, tc, SyntheticTokens(vocab=64, batch=4, seq=16, seed=2),
                         mesh=mesh, rules=rules_of(mesh) if mesh is not None else None,
                         fault_hook=fault, log=lambda s: None, device="cpu", **kw)


def _bitwise(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_a_mesh_checkpoint_restores_bit_for_bit_onto_one_device_and_another_mesh(tmp_path):
    mesh = make_mesh(1, 2, 4, device="cpu")
    sm, opt, _ = _mesh_run(tmp_path, "run", mesh, steps=3)
    saved = tt._state_tree(TINY, sm, opt)
    manager = tt.CheckpointManager(str(tmp_path / "run"))
    assert manager.latest_step() == 2
    # onto one device
    model = tlm.init_model(TINY, 1, device="cpu")
    o1 = ta.adamw_init(tlm.trainable(model), opt_cfgs()[1])
    tt._load_state(TINY, model, o1, manager.restore(2, tt._state_like(TINY, model, o1)))
    ref = j_tree_paths(saved)
    assert _bitwise(j_tree_paths(tt._state_tree(TINY, model, o1)), ref)
    # onto (data 4, model 2)
    other = make_mesh(1, 4, 2, device="cpu")
    rules = rules_of(other)
    sm2 = tt.shard_model(TINY, tlm.init_model(TINY, 1, device="cpu"), other, rules)
    o2 = tt.sharded_adamw_init(sm2, opt_cfgs()[1], rules)
    tt._load_state(TINY, sm2, o2, manager.restore(2, tt._state_like(TINY, sm2, o2)))
    assert _bitwise(j_tree_paths(tt._state_tree(TINY, sm2, o2)), ref)
    assert sm2.layouts["blocks.0.attn.wq"].grid == (4, 2)
    assert sm.layouts["blocks.0.attn.wq"].grid == (2, 4)


def test_the_reference_restores_a_mesh_checkpoint_bit_for_bit(tmp_path):
    mesh = make_mesh(1, 2, 4, device="cpu")
    sm, opt, _ = _mesh_run(tmp_path, "run", mesh, steps=3)
    saved = j_tree_paths(tt._state_tree(TINY, sm, opt))
    jparams, _ = jlm.init_model(JTINY, 1)
    jopt_cfg = opt_cfgs()[0]
    like = {"params": jparams, "opt": ja.adamw_init(jparams, jopt_cfg)}
    restored = j_tree_paths(jax.tree.map(np.asarray, JCheckpointManager(
        str(tmp_path / "run")).restore(2, like)))
    assert sorted(restored) == sorted(saved)
    for key, value in saved.items():
        assert np.array_equal(restored[key], value.numpy()), key


def test_mesh_train_loop_crash_and_resume_match_an_uninterrupted_run(tmp_path):
    mesh = make_mesh(1, 2, 4, device="cpu")
    crashed = []

    def fault(step):
        if step == 7 and not crashed:
            crashed.append(step)
            raise RuntimeError("injected")

    _, _, faulted = _mesh_run(tmp_path, "faulted", mesh, steps=12, fault=fault, ckpt_every=5)
    _, _, clean = _mesh_run(tmp_path, "clean", mesh, steps=12, ckpt_every=5)
    _, _, single = _mesh_run(tmp_path, "single", None, steps=12, ckpt_every=5)
    assert crashed == [7]
    steps = [h["step"] for h in faulted]
    assert steps[-1] == 11 and steps.count(7) == 1 and steps.count(6) == 2
    ref = {h["step"]: h["loss"] for h in clean}
    for h in faulted:
        assert abs(h["loss"] - ref[h["step"]]) <= GRAD_TOL * abs(ref[h["step"]]), h["step"]
    for a, b in zip(clean, single):
        assert abs(a["loss"] - b["loss"]) <= GRAD_TOL * abs(b["loss"]), a["step"]


@pytest.mark.parametrize("sizes", [(1, 2, 2), (2, 2, 2)], ids=["data2_model2", "pods2"])
def test_train_cli_trains_on_a_cpu_mesh_and_prints_it(tmp_path, capsys, sizes):
    pods, data, model = sizes
    argv = ["--arch", "qwen1.5-4b", "--reduced", "--steps", "3", "--batch", "4", "--seq",
            "16", "--markov", "--ckpt-dir", str(tmp_path), "--device", "cpu",
            "--pods", str(pods), "--data", str(data), "--model", str(model)]
    summary = train_cli.main(argv)
    want = {"pod": 2, "data": 2, "model": 2} if pods > 1 else {"data": 2, "model": 2}
    assert summary["mesh"] == want and summary["n_devices"] == 1
    assert summary["steps"] == 3 and np.isfinite(summary["last_loss"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
