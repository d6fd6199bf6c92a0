"""seldon_tpu_torch.servers.torchserver: the JAX server's knobs, a tiny
preset answering generate on the CPU, no quiet CPU fallback, and no quiet
preset for a model_uri it cannot read."""

import pytest
import torch

from seldon_tpu_torch.servers import torchserver
from seldon_tpu_torch.servers.torchserver import TorchServer


def _server(**kw):
    return TorchServer(preset="tiny", max_slots=4, max_seq_len=128,
                       prefill_chunk=16, device="cpu", **kw)


@pytest.mark.parametrize("kernel", ["pallas", "masked"])
def test_generate_answers_on_cpu(kernel):
    srv = _server(ragged=1, ragged_kernel=kernel)
    try:
        out = srv.generate({"prompt": "hello torch", "max_new_tokens": 5,
                            "temperature": 0.0})
        again = srv.generate({"prompt_token_ids": list(b"hello torch"),
                              "max_new_tokens": 5, "temperature": 0.0})
        sampled = srv.generate({"prompt": "hi", "max_new_tokens": 4,
                                "temperature": 0.9, "top_k": 20, "seed": 3})
        assert 1 <= len(out["token_ids"]) <= 5
        assert out["token_ids"] == again["token_ids"]
        assert out["prompt_tokens"] == len("hello torch")
        assert 1 <= len(sampled["token_ids"]) <= 4
        keys = {m["key"]: m["value"] for m in srv.metrics()}
        assert keys["torchserver_completed"] == 3.0
        assert srv.tags() == {"server": "torchserver", "preset": "tiny"}
    finally:
        srv.stop()
    assert srv.engine.debug_lifecycle_check() == {}


def test_env_knobs_select_the_kernel_leg(monkeypatch):
    monkeypatch.setenv("RAGGED", "1")
    monkeypatch.setenv("RAGGED_KERNEL", "pallas")
    srv = _server()
    assert srv.ragged and srv.paged_kv and srv.chunked_prefill
    ecfg = srv._engine_config(torchserver.get_config("tiny"))
    assert ecfg.ragged and ecfg.ragged_kernel == "pallas"
    assert ecfg.prompt_buckets == (32, 128)


def test_unported_paths_raise(tmp_path):
    # tp and mesh_sp (ring attention; ported with A11) exclude each
    # other, as in the JAX server.
    with pytest.raises(ValueError, match="mutually exclusive"):
        _server(tp=2, mesh_sp=2)
    # A model directory that is not an HF checkpoint is read as orbax, as
    # the JAX server reads it; with no config.json it fails as JAX's
    # load_config fails, never served from the preset.
    with pytest.raises(FileNotFoundError, match="config.json"):
        TorchServer(model_uri=str(tmp_path), device="cpu").load()
    with pytest.raises(ValueError, match="no prompt"):
        _server(ragged=1)._prompt_ids({})


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchServer(preset="tiny", ragged=1)


@pytest.mark.parametrize("env", [
    {}, {"PAGED_KV": "1"}, {"CHUNKED_PREFILL": "1"},
    {"PAGED_KV": "1", "CHUNKED_PREFILL": "1", "PREFIX_CACHE": "1"},
    {"SPEC": "1"}, {"SPEC": "1", "RAGGED_KERNEL": "pallas"},
    {"SPEC": "1", "SPEC_DRAFT": "tiny", "SPEC_K": "2"},
])
def test_bucketed_engines_answer_on_cpu(monkeypatch, env):
    """The JAX server's default engine (the dense slab) and the knobs
    that page it, chunk its prefills, and speculate on it all serve, with
    the same greedy tokens as the ragged engine. The spec gauges come
    from the sched ledger, as the JAX server's do, so it is armed."""
    monkeypatch.setenv("SCHED_LEDGER", "1")
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    req = {"prompt": "abcabcabc hello", "max_new_tokens": 6,
           "temperature": 0.0}
    srv = _server()
    try:
        assert not srv.ragged
        out = srv.generate(req)
        ecfg = srv.engine.ecfg
        assert ecfg.paged_kv == bool(env.get("PAGED_KV") or env.get("SPEC"))
        assert ecfg.spec_decode == bool(env.get("SPEC"))
        assert (srv.draft is not None) == bool(env.get("SPEC_DRAFT"))
        keys = {m["key"] for m in srv.metrics()}
        assert ("torchserver_spec_acceptance_rate" in keys) == \
            bool(env.get("SPEC"))
    finally:
        srv.stop()
    assert srv.engine.debug_lifecycle_check() == {}
    for key in env:
        monkeypatch.delenv(key)
    ragged = _server(ragged=1, ragged_kernel="pallas")
    try:
        assert out["token_ids"] == ragged.generate(req)["token_ids"]
    finally:
        ragged.stop()
