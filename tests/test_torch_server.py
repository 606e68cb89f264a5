"""The port's LM server and CLI (``repro_torch.runtime.server``,
``repro_torch.launch.serve --arch``) against the JAX package's, on the CPU.

Weights are drawn by ``repro.models.lm.init_model`` and carried across
(``repro_torch.interop.lm_params_from_numpy``); prompts come from
``numpy.random.default_rng``.  In float32 the greedy tokens must equal the
reference server's; in bf16 tokens are not compared.  The port's greedy
argmax skips the pad columns of the logits (ROADMAP C.18), where the
reference's takes the padded vocabulary; the reduced configs have none
(vocab 512), and the pad-column case is held against the reference's
logits sliced to ``vocab``.  The hybrid (zamba2) runs on perturbed weights
(``tests/test_torch_hybrid.py::perturbed``): at the reference's init its
Mamba-2 layers are the identity (ROADMAP C.23).  The reference's server
cannot serve the audio and VLM families (it prefills with the tokens
alone, ROADMAP C.25), so their requests, which carry frames or vision
embeddings and M-RoPE positions, are held against a hand loop over the
reference's ``prefill``, ``decode_step`` and ``_merge_slot`` that
schedules as the server does, on perturbed norms
(``tests/test_torch_audio.py::perturb_affine``).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import lm as jlm
from repro.models.ffn import SparseFFNConfig as JSparseFFNConfig
from repro.runtime.server import BatchedServer as JServer
from repro.runtime.server import Request as JRequest
from repro.runtime.server import _merge_slot as j_merge_slot

from repro_torch.configs import get_reduced
from repro_torch.data.modality import request_inputs
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import lm as tlm
from repro_torch.models.ffn import SparseFFNConfig
from repro_torch.runtime.server import BatchedServer, Request, _merge_slot
from test_torch_audio import perturb_affine
from test_torch_hybrid import perturbed



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads, and the suite runs
    in several worker processes at once: keep this file to one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(n, vocab, seed=0, lens=(5, 9, 3, 12, 7)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, lens[i % len(lens)]).astype(np.int32)
            for i in range(n)]


def _serve(server_cls, request_cls, cfg, params, prompts, slots, max_new=6,
           max_seq=32):
    srv = server_cls(cfg, params, batch_slots=slots, max_seq=max_seq)
    reqs = [request_cls(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    return srv, reqs


def _pair(arch, bcsr, dtype=jnp.float32, impl="pallas"):
    sff = JSparseFFNConfig(kind="bcsr", block=(32, 32), impl=impl) if bcsr else None
    jcfg = dataclasses.replace(j_get_reduced(arch), dtype=dtype, sparse_ffn=sff)
    params, _ = jlm.init_model(jcfg, 0)
    params = (perturbed(params) if jcfg.family == "hybrid"
              else jax.tree.map(np.asarray, params))
    model = lm_params_from_numpy(jcfg, params, device="cpu")
    return jcfg, params, model


@pytest.mark.parametrize("arch,bcsr", [("qwen1.5-4b", False), ("qwen1.5-4b", True),
                                       ("h2o-danube-3-4b", False),
                                       ("granite-moe-1b-a400m", False),
                                       ("rwkv6-7b", False), ("zamba2-2.7b", False),
                                       ("zamba2-2.7b", True)])
def test_greedy_tokens_equal_the_reference_server(arch, bcsr):
    """Five requests of mixed prompt lengths through 2 slots (continuous
    batching: slots refill mid-run), float32: the same tokens, one prefill
    per request, and the same step and occupancy counts.  The MoE routes at
    its configured capacity factor; RWKV-6 merges its recurrent state into
    the slots, and zamba2 its shared block's caches and its Mamba-2 states
    (at their batch axis, the third)."""
    jcfg, params, model = _pair(arch, bcsr)
    assert jcfg.vocab_padded == jcfg.vocab  # no pad column: the argmaxes agree
    prompts = _prompts(5, jcfg.vocab)
    jsrv, jreqs = _serve(JServer, JRequest, jcfg, params, prompts, 2)
    tsrv, treqs = _serve(BatchedServer, Request, model.cfg, model, prompts, 2)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(r.done and len(r.out) == 6 for r in treqs)
    assert tsrv.prefills == jsrv.prefills == 5
    assert (tsrv.steps, tsrv.occupancy) == (jsrv.steps, jsrv.occupancy)
    assert all(r.latency_s >= 0 for r in treqs)


@pytest.mark.parametrize("ffn", ["dense", "bcsr", "rwkv6", "zamba2"])
def test_two_slots_give_the_tokens_of_two_one_slot_servers(ffn):
    """h2o-danube (its window wraps), dense and bcsr, rwkv6 and zamba2, whose
    recurrent states ``_merge_slot`` copies into the slot (the ``rwkv`` and
    ``mamba`` groups) as it copies KV caches (the ``kv`` group)."""
    sff = SparseFFNConfig(kind="bcsr", block=(32, 32)) if ffn == "bcsr" else None
    arch = {"rwkv6": "rwkv6-7b", "zamba2": "zamba2-2.7b"}.get(ffn, "h2o-danube-3-4b")
    cfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32, sparse_ffn=sff)
    model = tlm.init_model(cfg, 1, device="cpu")
    prompts = _prompts(2, cfg.vocab, seed=4, lens=(20, 6))  # 20 > the window
    _, both = _serve(BatchedServer, Request, cfg, model, prompts, 2, max_new=8)
    for p, r in zip(prompts, both):
        _, (alone,) = _serve(BatchedServer, Request, cfg, model, [p], 1, max_new=8)
        assert alone.out == r.out


def test_bf16_server_serves_and_merges_slots_by_layout():
    """A bf16 model serves every request (tokens not compared).  The slot
    merge writes slot i of every layer and nothing else, also where the
    slot count equals the layer count (2) or the kv-head count (4): the
    port merges on the state's known batch axis, where the reference
    searches for the axis by shape.  A hybrid's Mamba-2 states (n_super,
    period, B, ...) are merged at their third axis."""
    for arch, slots_ in (("qwen1.5-4b", (2, 4)),  # 2 layers, 4 kv heads
                         ("zamba2-2.7b", (2, 3))):  # 2 super-blocks of 2 layers
        cfg = get_reduced(arch)
        model = tlm.init_model(cfg, 0, device="cpu")
        srv, reqs = _serve(BatchedServer, Request, cfg, model, _prompts(3, cfg.vocab), 4)
        assert all(r.done for r in reqs) and srv.prefills == 3
        for slots in slots_:
            state = tlm.init_decode_state(cfg, slots, 16, "cpu")
            for leaves in state.values():
                for t in leaves.values():
                    t.copy_(torch.rand(t.shape) * 8)
            one, _ = tlm.prefill(cfg, model, {"tokens": np.arange(5)[None]}, 16)
            for group, leaves in state.items():
                ax = 2 if group == "mamba" else 1
                before = {k: v.clone() for k, v in leaves.items()}
                _merge_slot({group: leaves}, {group: one[group]}, 1)
                others = [i for i in range(slots) if i != 1]
                for key, t in leaves.items():
                    assert torch.equal(t.select(ax, 1), one[group][key].select(ax, 0)), key
                    assert torch.equal(t.index_select(ax, torch.tensor(others)),
                                       before[key].index_select(ax, torch.tensor(others))
                                       ), key


def test_auto_impl_routes_through_the_tuner_at_the_slot_count():
    """``impl="auto"``: the server resolves W1 and W2 through the measured
    search at k = slots on the given plan cache; each resolves to the kernel
    tier or the plain one, and the served tokens equal a pinned server's."""
    from repro_torch.tune import PlanCache

    base = dataclasses.replace(get_reduced("qwen1.5-4b"), dtype=torch.float32)
    auto = dataclasses.replace(base, sparse_ffn=SparseFFNConfig(
        kind="bcsr", block=(32, 32), impl="auto"))
    model = tlm.init_model(auto, 0, device="cpu")
    cache = PlanCache()
    srv = BatchedServer(auto, model, batch_slots=4, max_seq=32, plan_cache=cache)
    sff = srv.cfg.sparse_ffn
    assert sff.impl in ("cuda", "ref") and sff.impl_w2 in ("cuda", "ref")
    assert {p.k for p in cache.plans()} == {4}
    prompts = _prompts(4, base.vocab)
    for r in (Request(rid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)):
        srv.submit(r)
    got = [r.out for r in sorted(srv.run_until_drained(), key=lambda r: r.rid)]
    pinned = dataclasses.replace(auto, sparse_ffn=dataclasses.replace(
        sff, impl="cuda", impl_w2=None))
    _, ref = _serve(BatchedServer, Request, pinned, model, prompts, 4, max_new=4)
    assert got == [r.out for r in ref]


def test_auto_impl_tunes_a_hybrids_shared_ffn_where_the_reference_raises():
    """ROADMAP C.24.  The reduced zamba2 with a bcsr shared FFN at
    ``impl="auto"``, perturbed weights: ``repro``'s server reads the FFN
    from ``params["blocks"]`` (the Mamba-2 tree, since a hybrid's has
    ``blocks``) and raises ``KeyError``; the port's resolves W1 and W2 of
    the shared block through the search at k = slots and serves the tokens
    of ``repro``'s server run at the tiers it picked."""
    from repro_torch.tune import PlanCache

    jcfg, params, model = _pair("zamba2-2.7b", True, impl="auto")
    with pytest.raises(KeyError, match="ffn"):
        JServer(jcfg, params, batch_slots=2, max_seq=32)
    cache = PlanCache()
    srv = BatchedServer(model.cfg, model, batch_slots=2, max_seq=32, plan_cache=cache)
    tuned = srv.cfg.sparse_ffn
    assert tuned.impl in ("cuda", "ref") and tuned.impl_w2 in ("cuda", "ref")
    d, f = jcfg.d_model, jcfg.d_ff
    assert sorted(tuple(p.scale[:2]) for p in cache.plans()) == [(d, f), (f, d)]
    assert {p.k for p in cache.plans()} == {2}
    prompts = _prompts(5, jcfg.vocab)
    reqs = [Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    tier = {"cuda": "pallas", "ref": "ref"}
    at_tiers = dataclasses.replace(jcfg, sparse_ffn=dataclasses.replace(
        jcfg.sparse_ffn, impl=tier[tuned.impl], impl_w2=tier[tuned.impl_w2]))
    _, jreqs = _serve(JServer, JRequest, at_tiers, params, prompts, 2)
    assert [r.out for r in reqs] == [r.out for r in jreqs]


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "h2o-danube-3-4b", "deepseek-67b",
                                  "llama3-405b", "granite-moe-1b-a400m",
                                  "llama4-scout-17b-a16e", "rwkv6-7b", "zamba2-2.7b",
                                  "whisper-tiny", "qwen2-vl-72b"])
def test_cli_serves_every_request_on_the_cpu(arch, tmp_path, capsys):
    stats = tmp_path / "lm.json"
    serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "6",
                    "--slots", "4", "--prompt-len", "8", "--max-new", "5",
                    "--stats-json", str(stats)])
    out = capsys.readouterr().out
    assert "served 6/6 requests, 30 tokens" in out and "6 prefills" in out
    summary = json.loads(stats.read_text())
    assert summary["served"] == 6 and summary["tokens"] == 30
    assert summary["device"] == "cpu" and summary["latency_p99_s"] > 0
    with pytest.raises(SystemExit):
        serve_cli.main(["--arch", "qwen1.5-4b", "--sparse", "cant"])


def test_pad_columns_never_win_the_greedy_argmax():
    """ROADMAP C.18.  A reduced qwen1.5-4b with vocab 500 (512 columns)
    whose final norm keeps one channel and whose pad columns 500 and 501
    weigh it +-100: a pad column wins every argmax over the padded logits,
    so the reference's server emits pad ids only.  The port's server emits
    real tokens, each the argmax of the reference's logits sliced to
    ``vocab`` at its position (``forward`` over the served sequence)."""
    jcfg = dataclasses.replace(j_get_reduced("qwen1.5-4b"), vocab=500,
                               dtype=jnp.float32)
    assert jcfg.vocab_padded == 512
    params, _ = jlm.init_model(jcfg, 0)
    params = jax.tree.map(np.array, params)
    params["ln_f"]["g"][:] = 0.0
    params["ln_f"]["g"][0] = 1.0
    params["unembed"][:, 500:] = 0.0
    params["unembed"][0, 500], params["unembed"][0, 501] = 100.0, -100.0
    model = lm_params_from_numpy(jcfg, params, device="cpu")
    prompts = _prompts(2, jcfg.vocab, seed=5)
    _, jreqs = _serve(JServer, JRequest, jcfg, params, prompts, 2, max_new=4)
    assert all(t >= jcfg.vocab for r in jreqs for t in r.out)
    _, treqs = _serve(BatchedServer, Request, model.cfg, model, prompts, 2, max_new=4)
    for p, r in zip(prompts, treqs):
        assert r.done and all(t < jcfg.vocab for t in [r._first, *r.out])
        seq = np.concatenate([p, np.asarray([r._first, *r.out[:-1]], np.int32)])
        logits, _ = jlm.forward(jcfg, params, {"tokens": jnp.asarray(seq[None])})
        want = np.argmax(np.asarray(logits)[0, len(p) - 1:, :jcfg.vocab], axis=-1)
        assert [r._first, *r.out] == want.tolist()


# ---------------------------------------------------------------------------
# audio and VLM: requests that carry their own inputs
# ---------------------------------------------------------------------------
AV_ARCHES = ("whisper-tiny", "qwen2-vl-72b")


def _av_requests(cfg, n, seed=0, lens=(5, 9, 3, 12, 7)):
    """n requests of mixed prompt lengths (a VLM's after its vision
    slots), each with its seeded modality inputs."""
    rng = np.random.default_rng(seed)
    extra = cfg.n_vision_tokens if cfg.family == "vlm" else 0
    reqs = []
    for i in range(n):
        prompt = rng.integers(0, cfg.vocab, extra + lens[i % len(lens)]).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new=6,
                            **request_inputs(cfg, len(prompt), rng)))
    return reqs


def _reference_loop(jcfg, params, reqs, slots, max_seq=32):
    """The port server's schedule run by hand on the reference: each free
    slot takes the next request, whose batch-1 ``prefill`` (tokens and its
    modality inputs) is merged into the slot by ``_merge_slot``; each step
    decodes every active slot; greedy argmax over ``vocab``.  Returns
    {rid: [first token, *new tokens]}."""
    state = jlm.init_decode_state(jcfg, slots, max_seq)
    queue, slot_req, out = list(reqs), [None] * slots, {r.rid: [] for r in reqs}
    while queue or any(r is not None for r in slot_req):
        for i in range(slots):
            if slot_req[i] is None and queue:
                r = slot_req[i] = queue.pop(0)
                batch = {"tokens": jnp.asarray(r.prompt[None])}
                for key, value in r.inputs().items():
                    batch[key] = jnp.asarray(value[:, None] if key == "positions"
                                             else value[None])
                st1, lg = jlm.prefill(jcfg, params, batch, max_seq)
                state = j_merge_slot(state, st1, i)
                out[r.rid].append(int(np.argmax(np.asarray(lg)[0, :jcfg.vocab])))
        toks = np.zeros((slots, 1), np.int32)
        active = [i for i, r in enumerate(slot_req) if r is not None]
        for i in active:
            toks[i, 0] = out[slot_req[i].rid][-1]
        state, logits = jlm.decode_step(jcfg, params, state, jnp.asarray(toks))
        logits = np.asarray(logits)[:, 0, :jcfg.vocab]
        for i in active:
            r = slot_req[i]
            out[r.rid].append(int(np.argmax(logits[i])))
            if len(out[r.rid]) > r.max_new:
                slot_req[i] = None
    return out


def _av_pair(arch, bcsr):
    sff = JSparseFFNConfig(kind="bcsr", block=(32, 32), impl="pallas") if bcsr else None
    jcfg = dataclasses.replace(j_get_reduced(arch), dtype=jnp.float32, sparse_ffn=sff)
    params = perturb_affine(jlm.init_model(jcfg, 0)[0], 7)
    return jcfg, params, lm_params_from_numpy(jcfg, params, device="cpu")


@pytest.mark.parametrize("bcsr", [False, True], ids=["dense", "bcsr"])
@pytest.mark.parametrize("arch", AV_ARCHES)
def test_audio_and_vlm_tokens_equal_a_reference_hand_loop(arch, bcsr):
    """Five requests with frames (whisper) or vision embeddings and
    Qwen2-VL-layout positions (qwen2-vl), through 2 slots (slots refill
    mid-run), float32: every request's first and new tokens equal the
    reference hand loop's, so the cross keys and values (at their batch
    axis, the second) and the caches were merged into the right slot; a
    1-slot server gives each request the same tokens."""
    jcfg, params, model = _av_pair(arch, bcsr)
    reqs = _av_requests(model.cfg, 5)
    want = _reference_loop(jcfg, params, reqs, 2)
    srv = BatchedServer(model.cfg, model, batch_slots=2, max_seq=32)
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    assert srv.prefills == 5 and all(r.done and len(r.out) == 6 for r in reqs)
    assert {r.rid: [r._first, *r.out] for r in reqs} == want
    for r in _av_requests(model.cfg, 2):
        srv1 = BatchedServer(model.cfg, model, batch_slots=1, max_seq=32)
        srv1.submit(r)
        srv1.run_until_drained()
        assert [r._first, *r.out] == want[r.rid]


@pytest.mark.parametrize("arch", AV_ARCHES)
def test_reference_server_raises_where_the_port_serves(arch):
    """ROADMAP C.25.  The reference's server prefills with the tokens
    alone, so its audio and VLM prefills raise ``KeyError`` (``frames``,
    ``vision_embeds``) on the first step; the port's server serves the same
    prompts with their inputs."""
    jcfg, params, model = _av_pair(arch, False)
    reqs = _av_requests(model.cfg, 2)
    jsrv = JServer(jcfg, params, batch_slots=2, max_seq=32)
    for r in reqs:
        jsrv.submit(JRequest(rid=r.rid, prompt=r.prompt, max_new=r.max_new))
    with pytest.raises(KeyError, match="frames" if arch == "whisper-tiny"
                       else "vision_embeds"):
        jsrv.run_until_drained()
    srv = BatchedServer(model.cfg, model, batch_slots=2, max_seq=32)
    for r in reqs:
        srv.submit(r)
    assert len(srv.run_until_drained()) == 2 and all(r.done for r in reqs)


def test_requests_without_their_inputs_are_refused():
    """``submit`` refuses, with a ``ValueError`` that names the input: an
    audio request without frames or with frames of another shape, a VLM
    request without vision embeddings, a VLM prompt shorter than its
    vision slots, positions of the wrong shape, and inputs a family does
    not read (frames to a dense model, positions to whisper)."""
    whisper, vl, dense = (get_reduced(a) for a in ("whisper-tiny", "qwen2-vl-72b",
                                                   "qwen1.5-4b"))
    f = np.zeros((whisper.enc_frames, whisper.d_model), np.float32)
    v = np.zeros((vl.n_vision_tokens, vl.d_model), np.float32)
    long_ = np.zeros(vl.n_vision_tokens + 2, np.int32)
    cases = [
        (whisper, Request(0, np.zeros(3, np.int32), 4), "frames of shape"),
        (whisper, Request(0, np.zeros(3, np.int32), 4, frames=f[:-1]), r"got \(23, 64\)"),
        (whisper, Request(0, np.zeros(3, np.int32), 4, frames=f,
                          positions=np.zeros((3, 3), np.int32)), "takes no positions"),
        (vl, Request(0, long_, 4), "vision_embeds of shape"),
        (vl, Request(0, long_[:5], 4, vision_embeds=v), "shorter than"),
        (vl, Request(0, long_, 4, vision_embeds=v, positions=np.zeros((3, 4))),
         r"expected \(3, 10\)"),
        (dense, Request(0, np.zeros(3, np.int32), 4, frames=f), "reads no frames"),
    ]
    for cfg, req, match in cases:
        srv = BatchedServer(cfg, tlm.init_model(cfg, 0, device="cpu"), batch_slots=1,
                            max_seq=16)
        with pytest.raises(ValueError, match=match):
            srv.submit(req)
        assert not srv.queue
