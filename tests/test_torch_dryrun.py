"""The port's dry-run tools (``configs``' shape grid, ``launch.mesh.
make_production_mesh``, ``launch.op_analysis``, ``launch.dryrun``,
``launch.roofline``, ``launch.rescore``) against the JAX package's and
against the port's own sharded runtime, on the CPU.

Everything compared here is counted, not measured, so it must be equal:

* The shape grid, ``cell_supported`` and ``input_specs`` (shapes and
  dtypes) for every ``ARCH_ID`` x shape; ``param_counts`` and
  ``model_flops`` at full size.
* The roofline's arithmetic (``terms``, the remedy's branch, the numbers
  ``render_md`` prints) on the same records, with the port's H100
  constants set to the reference's.
* The analyzer's matmul FLOPs of a reduced dense train step against the
  2*M*N*K sum over the reference's compiled dot ops (loop trip counts
  multiplied, as ``hlo_analysis`` does), with and without remat;
  ``remat="full"`` adds the blocks' forward matmuls once more, less each
  block's last (whose output the backward does not read).
* The dry run's gather and reduce bytes, card by card, against what
  ``runtime.sharded`` copies between distinct devices in a real sharded
  step, and its mesh totals (FLOPs, matmul FLOPs, bytes) against the whole
  traced step.
"""
import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import hlo_analysis as ha
from repro.launch import roofline as jroof
from repro.models import lm as jlm
from repro.optim import adamw as ja
from repro.runtime import trainer as jt

from repro_torch import configs as tconfigs
from repro_torch.core.distributed import Mesh
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.interop import port_config
from repro_torch.launch import dryrun, rescore
from repro_torch.launch import roofline as troof
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.op_analysis import OpAnalyzer, op_cost
from repro_torch.models import lm as tlm
from repro_torch.models.common import default_rules, set_active_rules
from repro_torch.optim import adamw as ta
from repro_torch.runtime import trainer as tt

SMALL_TRAIN = tconfigs.ShapeSpec("small", "train", 32, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dtype(d) -> str:
    return str(d).removeprefix("torch.")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tuple(tree.shape), _dtype(tree.dtype)


# ---------------------------------------------------------------------------
# the grid, the meshes and the counts
# ---------------------------------------------------------------------------
def test_shapes_and_production_meshes():
    assert tconfigs.SHAPE_NAMES == jconfigs.SHAPE_NAMES
    assert ({k: dataclasses.astuple(v) for k, v in tconfigs.SHAPES.items()}
            == {k: dataclasses.astuple(v) for k, v in jconfigs.SHAPES.items()})
    for multi, shape, axes in ((False, (16, 16), ("data", "model")),
                               (True, (2, 16, 16), ("pod", "data", "model"))):
        mesh = make_production_mesh(multi_pod=multi)
        assert tuple(mesh.shape.values()) == shape and mesh.axis_names == axes
        assert mesh.n_devices == int(np.prod(shape)) == len(set(mesh.devices))
        assert str(mesh.devices[-1]) == f"meta:{int(np.prod(shape)) - 1}"
    # the card and host meshes keep their placement (ROADMAP C.15, C.32)
    assert make_mesh(1, 2, 4, device="cpu").n_devices == 1


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_cell_supported_and_input_specs_equal_the_references(arch):
    jcfg, cfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert tconfigs.is_subquadratic(cfg) == jconfigs.is_subquadratic(jcfg)
    for shape in jconfigs.SHAPES:
        ok = tconfigs.cell_supported(cfg, shape)
        assert ok == jconfigs.cell_supported(jcfg, shape), shape
        if not ok[0]:
            continue
        got = sorted(_leaves(tconfigs.input_specs(cfg, shape)))
        want = sorted(_leaves(jconfigs.input_specs(jcfg, shape)))
        assert got == want, shape
        assert all(t.device.type == "meta" for t in jax.tree.leaves(
            tconfigs.input_specs(cfg, shape), is_leaf=lambda x: isinstance(x, torch.Tensor)))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_counts_and_model_flops_equal_the_references(arch):
    assert troof.param_counts(arch) == jroof.param_counts(arch)
    for shape in jconfigs.SHAPES:
        assert troof.model_flops(arch, shape) == jroof.model_flops(arch, shape), shape


def _records():
    """Records of every branch: collective (MoE, all-reduce, another
    kind), memory (decode, train), compute; a skipped and an error cell."""
    def rec(arch, shape, mesh, flops, hbm, coll, kinds):
        return {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
                "per_device": {"flops": flops, "hbm_bytes": hbm, "collective_bytes": coll,
                               "collectives": kinds}}
    return [
        rec("granite-moe-1b-a400m", "train_4k", "16x16", 1e12, 1e9, 1e12, {"all-to-all": 1}),
        rec("qwen1.5-4b", "train_4k", "16x16", 1e12, 1e9, 1e12, {"all-reduce": 5, "x": 1}),
        rec("deepseek-67b", "prefill_32k", "2x16x16", 1e12, 1e9, 1e12, {"gather": 7}),
        rec("llama3-405b", "decode_32k", "16x16", 1e9, 1e12, 1e6, {}),
        rec("rwkv6-7b", "long_500k", "2x16x16", 1e9, 1e12, 1e6, {}),
        rec("h2o-danube-3-4b", "train_4k", "16x16", 1e9, 1e12, 1e6, {}),
        rec("whisper-tiny", "prefill_32k", "16x16", 3e15, 1e9, 1e6, {}),
        {"arch": "qwen1.5-4b", "shape": "long_500k", "mesh": "16x16", "status": "skipped",
         "reason": "pure full attention — long_500k skipped per spec"},
        {"arch": "zamba2-2.7b", "shape": "train_4k", "mesh": "16x16", "status": "error",
         "error": "RuntimeError: boom"},
    ]


def _ref_branch(text: str) -> str:
    if "moe_partition" in text:
        return "moe"
    if "TP activation all-reduces" in text:
        return "all-reduce"
    if text.startswith("dominant "):
        return text.split()[1].rstrip(":")
    if text.startswith("k=1 SpMV"):
        return "decode"
    if text.startswith("attention/remat"):
        return "memory"
    assert text.startswith("compute-bound"), text
    return "compute"


def test_roofline_arithmetic_equals_the_reference_with_its_constants(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(troof, name, getattr(jroof, name))
    recs = _records()
    for r in recs:
        if r["status"] != "ok":
            continue
        t, jt_ = troof.terms(r), jroof.terms(r)
        assert t == jt_, r["arch"]
        assert troof.remedy_branch(r, t) == _ref_branch(jroof.remedy(r, jt_)), r["arch"]
    got, want = troof.render_md(recs).splitlines(), jroof.render_md(recs).splitlines()
    assert len(got) == len(want) == len(recs) + 2
    for g, w in zip(got[2:], want[2:]):
        assert g.split("|")[1:10] == w.split("|")[1:10]  # all but the remedy's words


def test_the_port_names_no_tpu_figure():
    from pathlib import Path

    pkg = Path(troof.__file__).resolve().parents[1]
    pattern = re.compile(r"197e12|819e9|v5e|\bMXU\b|\bICI\b")
    for path in pkg.rglob("*.py"):
        assert not pattern.search(path.read_text()), path
    assert troof.PEAK_FLOPS == 989e12 and troof.HBM_BW == 3.35e12 and troof.LINK_BW == 50e9


# ---------------------------------------------------------------------------
# the analyzer against the reference's HLO
# ---------------------------------------------------------------------------
def _dot_flops(text: str) -> float:
    """2*M*N*K over the compiled module's dot ops, while bodies multiplied
    by their trip counts (``hlo_analysis``' parser and conventions)."""
    comps = ha._split_computations(text)
    memo: dict = {}

    def cost(name, stack=()):
        if name in memo:
            return memo[name]
        if name in stack or name not in comps:
            return 0.0
        shapes, total = {}, 0.0
        for line in comps[name]:
            parsed = ha._parse_op_line(line)
            if parsed is None:
                continue
            out_name, out_type, op, args, attrs = parsed
            shapes[out_name] = out_type
            rest = args + attrs
            if op == "while":
                body = re.search(r"body=%?([\w\.\-_]+)", rest)
                cond = re.search(r"condition=%?([\w\.\-_]+)", rest)
                trips = ha._trip_count(comps[cond.group(1)]) if cond else 1
                total += cost(body.group(1), stack + (name,)) * trips
            elif op in ("call", "conditional", "async-start", "fusion"):
                for callee in re.findall(r"(?:to_apply|branch_computations|called_computations"
                                         r"|calls)=\{?%?([\w\.\-_]+)", rest):
                    total += cost(callee, stack + (name,))
            elif op in ("dot", "dot-general"):
                operands = ha._OPERAND_RE.findall(args)
                lhs = ha._dims_of(shapes.get(operands[0], ""))
                k = 1
                cd = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", rest)
                for ci in (cd.group(1).split(",") if cd else []):
                    if ci:
                        k *= lhs[int(ci)]
                total += 2.0 * float(np.prod(ha._dims_of(out_type))) * k
        memo[name] = total
        return total

    return cost(ha._entry_name(text))


def _reference_step_text(jcfg, b, s):
    params, _ = jlm.abstract_model(jcfg, 0)
    opt_cfg = ja.OptimConfig()
    opt = jax.eval_shape(lambda: ja.adamw_init(params, opt_cfg))
    batch = {k: jax.ShapeDtypeStruct((b, s), jnp.int32) for k in ("tokens", "labels")}
    step = jax.jit(jt.make_train_step(jcfg, opt_cfg, 1))
    return step.lower(params, opt, batch).compile().as_text()


def _port_train(cfg, b, s):
    batch = {k: torch.empty((b, s), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    return dryrun.analyze_train_step(cfg, batch, ta.OptimConfig(), 1)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_analyzer_matmul_flops_equal_the_reference_dot_flops(remat):
    jcfg = dataclasses.replace(jconfigs.get_reduced("qwen1.5-4b"), dtype=jnp.float32,
                               remat=remat)
    b, s = 2, 32
    want = _dot_flops(_reference_step_text(jcfg, b, s))
    got = _port_train(port_config(jcfg), b, s)
    assert got["cost"].matmul_flops == want
    assert got["cost"].flops > got["cost"].matmul_flops


def test_remat_full_adds_the_blocks_forward_matmuls_once_more():
    """Each block's forward is recomputed in the backward pass, but for its
    last matmul (the FFN's down projection), whose output the backward
    does not read: ``torch.utils.checkpoint`` stops the recomputation
    before it, as XLA drops it from ``jax.checkpoint``'s (the ``full`` case
    above equals the reference's dots)."""
    cfg = dataclasses.replace(tconfigs.get_reduced("qwen1.5-4b"), dtype=torch.float32)
    b, s = 2, 32
    none = _port_train(dataclasses.replace(cfg, remat="none"), b, s)["cost"].matmul_flops
    full = _port_train(dataclasses.replace(cfg, remat="full"), b, s)["cost"].matmul_flops
    model = tlm.init_model(cfg, device="meta")
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32, device="meta")}
    with OpAnalyzer() as an, torch.no_grad():
        tlm.forward(cfg, model, batch)
    unembed = 2.0 * b * s * cfg.d_model * cfg.vocab_padded
    down = cfg.n_layers * 2.0 * b * s * cfg.d_ff * cfg.d_model
    assert full - none == an.cost().matmul_flops - unembed - down > 0


def test_op_cost_conventions():
    f32, bf16 = "torch.float32", "torch.bfloat16"
    assert op_cost("aten.mm.default", (((4, 8), f32), ((8, 3), f32)), (((4, 3), f32),)) == (
        2 * 4 * 3 * 8, 4 * (32 + 24 + 12), 2 * 4 * 3 * 8)
    assert op_cost("aten.addmm.default", (((3,), f32), ((4, 8), f32), ((8, 3), f32)),
                   (((4, 3), f32),))[0] == 2 * 4 * 3 * 8
    assert op_cost("aten.view.default", (((4, 8), f32),), (((32,), f32),)) == (0, 0, 0)
    assert op_cost("aten.add_.Tensor", (((4,), bf16), ((4,), bf16)), (((4,), bf16),)) == (
        4, 24, 0)
    assert op_cost("aten.copy_.default", (((4,), bf16), ((4,), f32)), (((4,), bf16),)) == (
        0, 16 + 8, 0)
    assert op_cost("aten.sum.default", (((4, 8), f32),), (((), f32),)) == (32, 132, 0)
    assert op_cost("aten.embedding.default", (((1000, 8), f32), ((2, 3), "torch.int64")),
                   (((2, 3, 8), f32),)) == (0, 2 * 192 + 48, 0)
    assert op_cost("aten.empty.memory_format", (), (((100,), f32),)) == (0, 0, 0)
    assert op_cost("aten.zeros.default", (), (((100,), f32),)) == (0, 400, 0)


def test_card_bytes_follow_the_caching_allocators_blocks():
    mib = 2**20
    assert dryrun.card_bytes(0) == 0 and dryrun.card_bytes(1) == 512
    assert dryrun.card_bytes(513) == 1024 and dryrun.card_bytes(mib) == mib
    assert dryrun.card_bytes(5 * mib + 3) == 5 * mib + 512  # split off a 20 MiB segment
    assert dryrun.card_bytes(2560 * 2560 * 2) == 2560 * 2560 * 2  # 1.5 MiB left: split
    assert dryrun.card_bytes(2560 * 6912 * 2) == 34 * mib  # 0.25 MiB left: kept
    assert dryrun.card_bytes(25 * mib) == 26 * mib  # exactly 1 MiB left: kept


def test_analyzer_tracks_live_and_peak_bytes():
    x = torch.empty((64, 128), device="meta", requires_grad=True)
    w = torch.empty((128, 256), device="meta", requires_grad=True)
    with OpAnalyzer() as an:
        y = torch.tanh(x @ w)
        g = torch.autograd.grad(y.sum(), [x, w])
        del y
    # the product and tanh (64 x 256 each), then tanh's gradient beside
    # them and the two parameter gradients
    assert an.peak_bytes >= 3 * 64 * 256 * 4
    assert an.live_bytes == sum(t.numel() * 4 for t in g)
    assert an.cost().matmul_flops == 3 * 2 * 64 * 128 * 256


# ---------------------------------------------------------------------------
# the dry run against the sharded runtime
# ---------------------------------------------------------------------------
def _logical_mesh(data: int, model: int) -> Mesh:
    """``data x model`` cells, each its own device to the runtime (the
    host's ``cpu`` and ``cpu:0``...``cpu:n-2``, all the same memory), as a
    mesh of that many cards places them."""
    n = data * model
    cells = np.empty(n, dtype=object)
    cells[:] = [torch.device("cpu")] + [torch.device("cpu", i) for i in range(n - 1)]
    return Mesh(cells.reshape(data, model), ("data", "model"))


@pytest.mark.parametrize("n_micro", [1, 2])
def test_collectives_and_mesh_totals_equal_the_runtime_step(n_micro):
    cfg = tconfigs.get_reduced("qwen1.5-4b")
    batch = {k: torch.as_tensor(v) for k, v in
             SyntheticTokens(cfg.vocab, SMALL_TRAIN.batch, SMALL_TRAIN.seq, seed=0)
             .batch_at(0).items()}
    opt = ta.OptimConfig()
    rules = default_rules(False)
    set_active_rules(rules)
    step = tt.make_sharded_train_step(cfg, opt, n_micro)
    knobs = {"microbatches": n_micro}

    # copies between the cells of a real step, by kind and receiving cell
    lmesh = _logical_mesh(2, 4)
    sm = tt.shard_model(cfg, tlm.init_model(cfg, 0, device="cpu"), lmesh, rules)
    step(sm, tt.sharded_adamw_init(sm, opt, rules), batch)
    copied = {kind: {lmesh.devices.index(d): v for d, v in by.items()}
              for kind, by in sm.copied.items()}
    reckoned = dryrun.reckon_cell(cfg, SMALL_TRAIN, make_mesh(1, 2, 4, device="meta"), knobs)
    per_cell = {"gather": {}, "reduce": {}}
    for cls in reckoned["classes"]:
        for card in cls["cards"]:
            for kind, v in cls["collectives"].items():
                per_cell[kind][int(card.split(":")[1])] = v
    assert copied == per_cell
    assert reckoned["compute_cards"] == 2 and reckoned["n_rep"] == 2
    totals = reckoned["mesh_totals"]
    assert totals["collectives"] == {k: sum(v.values()) for k, v in copied.items()}
    assert reckoned["per_device"]["collective_bytes"] == max(
        sum(copied[k].get(i, 0) for k in copied) for i in range(8))

    # the whole step traced on the host mesh against the dry run's totals
    mesh = make_mesh(1, 2, 4, device="cpu")
    sm = tt.shard_model(cfg, tlm.init_model(cfg, 0, device="cpu"), mesh, rules)
    state = tt.sharded_adamw_init(sm, opt, rules)
    with OpAnalyzer() as an:
        step(sm, state, batch)
    whole = an.cost()
    on_host = dryrun.reckon_cell(cfg, SMALL_TRAIN, mesh, knobs)["mesh_totals"]
    assert on_host["flops"] == whole.flops
    assert on_host["matmul_flops"] == whole.matmul_flops
    assert on_host["hbm_bytes"] == whole.hbm_bytes
    assert on_host["collective_bytes"] == 0


def test_dryrun_rescore_and_roofline_clis(tmp_path, capsys):
    out = str(tmp_path)
    args = ["--arch", "qwen1.5-4b", "--shape", "decode_32k", "--mesh", "both",
            "--reduced", "--outdir", out]
    dryrun.main(args)
    paths = sorted(tmp_path.glob("*.json"))
    assert [p.name for p in paths] == ["qwen1.5-4b__decode_32k__16x16__baseline.json",
                                       "qwen1.5-4b__decode_32k__2x16x16__baseline.json"]
    recs = [json.loads(p.read_text()) for p in paths]
    for rec in recs:
        assert rec["status"] == "ok" and rec["n_cards"] == (256 if "2x" not in rec["mesh"]
                                                           else 512)
        assert rec["per_device"]["flops"] > 0 and rec["memory"]["argument_size_in_bytes"] > 0
        assert set(rec["per_device"]["collectives"]) == {"state_gather", "state_scatter"}
    # rescoring the saved traces gives the same figures
    for p in paths:
        p.write_text(json.dumps({**json.loads(p.read_text()), "per_device": {}}))
    rescore.main(["--dir", out])
    again = [json.loads(p.read_text()) for p in paths]
    assert [r["per_device"] for r in again] == [r["per_device"] for r in recs]
    capsys.readouterr()
    rescore.main(["--dir", out, "--debug", paths[0].name[:-len(".json")]])
    assert "top 25 by bytes" in capsys.readouterr().out
    troof.main(["--dir", out, "--md", str(tmp_path / "roofline.md")])
    table = (tmp_path / "roofline.md").read_text().splitlines()
    assert len(table) == 4 and "qwen1.5-4b | decode_32k | 16x16" in table[2]


def test_a_cell_that_reaches_a_kernel_records_an_error(tmp_path):
    with pytest.raises(SystemExit, match="1 cells failed"):
        dryrun.main(["--arch", "qwen1.5-4b", "--shape", "decode_32k", "--reduced",
                     "--variant", "sparse_ffn=bcsr", "--outdir", str(tmp_path)])
    rec = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert rec["status"] == "error" and "per_device" not in rec
