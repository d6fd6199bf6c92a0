"""TorchServer's ``tp`` and ``mesh_sp`` knobs on the CPU (each test
stands up its own spawned gloo group and closes it in ``stop()``):
``tp=2`` serves a MeshEngine whose streams equal the tp=1 server's,
``TP=2`` selects it from the environment, and ``mesh_sp=2`` with a ring
config on two devices (``torchserver.serving_devices`` handed two CPU
ranks) scores (``predict``) and admits (the dense engine's
context-parallel prefill) over two ranks; with the preset's "xla"
attention on the CPU's one device ``mesh_sp`` builds no group, as the
JAX server's ``_mesh_for`` plans no sp axis for it. The tp=2 server builds each rank's shard on
that rank (seeded in bf16, int8 and W8A8, or from an HF checkpoint) and
no whole ``Transformer`` on rank 0, with the tp=1 server's streams."""

import dataclasses
import threading

import numpy as np
import pytest

from seldon_tpu_torch.models import transformer
from seldon_tpu_torch.models.config import get_config
from seldon_tpu_torch.parallel import ring_attention as ra
from seldon_tpu_torch.servers import hf_loader, torchserver
from seldon_tpu_torch.servers.mesh_engine import MeshEngine
from seldon_tpu_torch.servers.torchserver import TorchServer
from torch_port_helpers import one_intra_op_thread  # noqa: F401

REQ = {"prompt_token_ids": list(range(5, 25)), "max_new_tokens": 6,
       "temperature": 0.0}


@pytest.fixture(autouse=True)
def one_thread_ranks(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _server(**kw):
    return TorchServer(preset="tiny", max_slots=4, max_seq_len=128,
                       prefill_chunk=16, device="cpu", **kw)


def _serve(srv, reqs):
    srv.load()
    try:
        return [srv.generate(r)["token_ids"] for r in reqs]
    finally:
        srv.stop()


@pytest.mark.parametrize("knobs", [dict(ragged=1, ragged_kernel="pallas"),
                                   dict()], ids=["ragged", "dense"])
def test_tp2_server_streams_equal_tp1(knobs):
    """The tp=2 server's streams and scores equal tp=1's; once loaded it
    holds this rank's shard alone (the engine owns the weights), and its
    score runs on the shards of both ranks."""
    reqs = [dict(REQ, prompt_token_ids=list(range(5, 5 + n)))
            for n in (3, 17, 40)]
    ids = np.arange(3, 35).reshape(2, 16)
    plain = _server(**knobs)
    want_nll = plain.predict(ids, [])
    want = _serve(plain, reqs)
    full = plain.params.blocks[0].wq.shape[-1]
    srv = _server(tp=2, **knobs)
    srv.load()
    try:
        assert isinstance(srv.engine, MeshEngine)
        info = srv.engine.mesh_info()
        assert info["tp"] == 2 and info["route"] == "gloo"
        assert srv.params is srv.engine.params
        assert srv.params.blocks[0].wq.shape[-1] == full // 2
        got = [srv.generate(r)["token_ids"] for r in reqs]
        srv.engine.check_replicas()
        nll = srv.predict(ids, [])
    finally:
        srv.stop()
    assert got == want
    np.testing.assert_array_equal(nll, want_nll)
    assert srv.group.closed


def test_tp_env_knob(monkeypatch):
    monkeypatch.setenv("TP", "2")
    srv = _server()
    assert srv.tp == 2
    with pytest.raises(ValueError, match="mutually exclusive"):
        _server(mesh_sp=2)


def _two_cpu_ranks(monkeypatch):
    """The server plans over two devices: two CPU ranks."""
    monkeypatch.setattr(torchserver, "serving_devices",
                        lambda device: [device] * 2)


def _ring_config(monkeypatch):
    real = torchserver.get_config

    def ring(name, **kw):
        return dataclasses.replace(real(name, **kw), attn_impl="ring")

    monkeypatch.setattr(torchserver, "get_config", ring)


def test_mesh_sp_scores_and_admits_over_the_ring(monkeypatch):
    toks = np.random.default_rng(4).integers(3, 200, (2, 32))
    plain = _server()
    want_nll = plain.predict(toks, [])
    want = _serve(plain, [REQ])
    _ring_config(monkeypatch)
    _two_cpu_ranks(monkeypatch)
    calls = []
    real = ra.ring_attention
    monkeypatch.setattr(ra, "ring_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    srv = _server(mesh_sp=2)
    try:
        got_nll = srv.predict(toks, [])
        assert srv.group is not None and srv.group.ranks.world == 2
        n_score = len(calls)
        assert n_score == srv.cfg.n_layers
        # A 20-token prompt admits in the 32 bucket: 32 % 2 == 0, so the
        # dense admission prefills context-parallel.
        srv.load()
        got = srv.generate(REQ)["token_ids"]
        assert len(calls) == n_score + srv.cfg.n_layers
    finally:
        srv.stop()
    np.testing.assert_allclose(got_nll, want_nll, rtol=2e-2, atol=2e-2)
    assert got == want[0]


def test_mesh_sp_without_ring_attention_builds_no_group():
    srv = _server(mesh_sp=2)
    try:
        srv.predict(np.arange(3, 19)[None], [])
        assert srv.group is None
    finally:
        srv.stop()


def test_mesh_sp_scores_beside_generate(monkeypatch):
    """predict on request threads while the engine admits over the ring
    (mesh_sp=2): the group serialises each command with rank 0's
    collectives, so every score and stream equals what it gives alone."""
    toks = np.random.default_rng(5).integers(3, 200, (2, 32))
    _ring_config(monkeypatch)
    _two_cpu_ranks(monkeypatch)
    srv = _server(mesh_sp=2)
    try:
        want_nll = srv.predict(toks, [])
        srv.load()
        want = srv.generate(REQ)["token_ids"]
        got, nlls, errors = [], [], []

        def run(fn, out):
            try:
                for _ in range(4):
                    out.append(fn())
            except BaseException as e:  # noqa: BLE001 (reported below)
                errors.append(e)

        threads = [threading.Thread(target=run, args=(
                       lambda: srv.generate(REQ)["token_ids"], got)),
                   threading.Thread(target=run, args=(
                       lambda: srv.predict(toks, []), nlls)),
                   threading.Thread(target=run, args=(
                       lambda: srv.predict(toks[:1], []), []))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
    finally:
        srv.stop()
    assert got == [want] * 4
    for nll in nlls:
        np.testing.assert_array_equal(nll, want_nll)


WEIGHT_DTYPES = {"bf16": {}, "int8": dict(weight_dtype="int8"),
                 "w8a8": dict(weight_dtype="int8", act_dtype="int8")}
TP_REQS = [dict(REQ, prompt_token_ids=list(range(5, 5 + n)))
           for n in (3, 17, 40)]


@pytest.mark.parametrize("dtype", sorted(WEIGHT_DTYPES))
def test_tp2_server_seeded_shards_stream_as_tp1(dtype, monkeypatch):
    """Each rank seeds its own shard (replaying the whole model's draws);
    rank 0 builds no whole Transformer off the meta device and never
    takes the whole-model init; the streams are tp=1's."""
    kw = dict(init_seed=7, ragged=1, ragged_kernel="pallas",
              **WEIGHT_DTYPES[dtype])
    want = _serve(_server(**kw), TP_REQS)
    builds = []
    init = transformer.Transformer.__init__

    def counted(self, cfg, device=None):
        if str(device) != "meta":
            builds.append(device)
        init(self, cfg, device)

    monkeypatch.setattr(transformer.Transformer, "__init__", counted)
    monkeypatch.setattr(transformer, "init_params",
                        lambda *a, **k: builds.append("init_params"))
    srv = _server(tp=2, **kw)
    assert _serve(srv, TP_REQS) == want
    assert builds == []
    assert srv.params.blocks[0].w_up.shape[-1] == srv.cfg.d_ff // 2


def test_tp2_server_checkpoint_shards_stream_as_tp1(tmp_path, monkeypatch):
    """From an HF checkpoint each rank reads its own columns: rank 0 never
    takes the whole-model loader, and the streams are tp=1's."""
    transformers = pytest.importorskip("transformers")
    import torch

    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=300, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, eos_token_id=2, pad_token_id=0))
    hf.eval().save_pretrained(str(tmp_path), safe_serialization=True)
    kw = dict(model_uri=str(tmp_path), ragged=1, ragged_kernel="pallas")
    want = _serve(_server(**kw), TP_REQS)
    whole = []
    for name in ("load_hf_checkpoint", "hf_tree"):
        monkeypatch.setattr(hf_loader, name,
                            lambda *a, name=name, **k: whole.append(name))
    assert _serve(_server(tp=2, **kw), TP_REQS) == want
    assert whole == []
