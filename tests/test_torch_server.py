"""seldon_tpu_torch.servers.torchserver: the JAX server's knobs, a tiny
preset answering generate on the CPU, and no quiet CPU fallback."""

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


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="A7"):
        _server().load()  # ragged off: the bucketed engine
    with pytest.raises(NotImplementedError, match="A12"):
        TorchServer(model_uri="/nowhere", device="cpu").load()
    with pytest.raises(ValueError, match="no prompt"):
        _server(ragged=1)._prompt_ids({})


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchServer(preset="tiny", ragged=1)
