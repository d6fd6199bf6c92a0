"""seldon_tpu_torch.servers.hf_loader and tokenizer against the JAX
package's, on tiny HF Llama checkpoints built in-process with
``transformers`` (``save_pretrained``: sharded with an index file, tied,
and saved in bf16), with no network.

 * The port's safetensors reader returns the bytes, dtypes and shapes
   ``safetensors.safe_open`` returns.
 * ``config_from_hf`` equals JAX's for llama, mistral, every
   ``rope_scaling`` kind and every error.
 * The parameter tree is bit-equal to the JAX loader's bfloat16 tree,
   and so is the port's ``Transformer`` built from it; the
   loaders fail alike on a missing tensor, ``embed_tokens`` or
   ``lm_head``.
 * The port's logits are within HF_LOGITS_ATOL of ``transformers``'
   forward and of the JAX loader's weights through JAX's forward.
 * ``TorchServer(model_uri=...)``'s greedy ``generate`` equals
   ``JAXServer``'s on the same directory.
 * ``load_tokenizer`` returns ``HFTokenizer`` for a directory with a
   tokenizer (a tiny BPE trained in-process), equal to JAX's in encode
   and decode."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

transformers = pytest.importorskip("transformers")
safetensors = pytest.importorskip("safetensors")

from seldon_tpu.servers import hf_loader as jhf  # noqa: E402
from seldon_tpu.servers import tokenizer as jtok  # noqa: E402
from seldon_tpu_torch.models import convert  # noqa: E402
from seldon_tpu_torch.models import transformer as ttf  # noqa: E402
from seldon_tpu_torch.servers import hf_loader as thf  # noqa: E402
from seldon_tpu_torch.servers import tokenizer as ttok  # noqa: E402
from seldon_tpu_torch.servers.torchserver import TorchServer  # noqa: E402

# bf16 weights and activations through the port against transformers'
# f32 forward and JAX's bf16 forward of the same checkpoint; measured
# max |diff| on these checkpoints is 2e-3 – 5e-3.
HF_LOGITS_ATOL = 2e-2

VOCAB = 300


def _hf_config(**kw):
    base = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=128,
                rope_theta=10000.0, rms_norm_eps=1e-5,
                tie_word_embeddings=False, eos_token_id=2, pad_token_id=0)
    base.update(kw)
    return transformers.LlamaConfig(**base)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """name -> (directory, transformers model). "sharded": f32 weights in
    several shards with model.safetensors.index.json; "tied": tied
    embeddings, one file; "bf16": saved in bfloat16."""
    out = {}
    for name, kw, dtype, shard in (
            ("sharded", {}, torch.float32, "60KB"),
            ("tied", dict(tie_word_embeddings=True), torch.float32, None),
            ("bf16", {}, torch.bfloat16, "80KB")):
        torch.manual_seed(len(out))
        model = transformers.LlamaForCausalLM(_hf_config(**kw)).eval()
        model = model.to(dtype)
        path = str(tmp_path_factory.mktemp(f"hf-{name}"))
        extra = {"max_shard_size": shard} if shard else {}
        model.save_pretrained(path, safe_serialization=True, **extra)
        out[name] = (path, model)
    assert os.path.exists(os.path.join(out["sharded"][0],
                                       "model.safetensors.index.json"))
    return out


def _leaf_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.itemsize])


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


# ---------------------------------------------------------------------------
# The reader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["sharded", "tied", "bf16"])
def test_reader_bytes_equal_safe_open(checkpoints, name):
    path, _ = checkpoints[name]
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    n = 0
    for fname in files:
        fpath = os.path.join(path, fname)
        ours = {nm: (tag, arr) for nm, tag, arr in
                thf.read_safetensors(fpath)}
        with safetensors.safe_open(fpath, framework="pt") as f:
            assert sorted(ours) == sorted(f.keys())
            for key in f.keys():
                want = f.get_tensor(key)
                tag, arr = ours[key]
                assert tag == {torch.float32: "F32",
                               torch.bfloat16: "BF16"}[want.dtype]
                assert tuple(arr.shape) == tuple(want.shape)
                assert arr.tobytes() == \
                    want.contiguous().view(torch.uint8).numpy().tobytes()
                n += 1
    assert n == 2 * 9 + 3 - (name == "tied")


def test_reader_yields_nothing_for_an_empty_file(tmp_path):
    path = tmp_path / "empty.safetensors"
    header = json.dumps({"__metadata__": {"format": "pt"}}).encode()
    path.write_bytes(len(header).to_bytes(8, "little") + header)
    assert list(thf.read_safetensors(str(path))) == []


@pytest.mark.parametrize("offsets,shape", [([0, 12], [2, 2]),
                                           ([8, 24], [2, 2]),
                                           ([4, 2], [1])])
def test_reader_refuses_offsets_outside_the_data(tmp_path, offsets, shape):
    path = tmp_path / "bad.safetensors"
    header = json.dumps({"w": {"dtype": "F32", "shape": shape,
                               "data_offsets": offsets}}).encode()
    path.write_bytes(len(header).to_bytes(8, "little") + header
                     + bytes(16))
    with pytest.raises(ValueError, match="data_offsets"):
        list(thf.read_safetensors(str(path)))


@pytest.mark.parametrize("n,size", [
    (64, 16),                                 # longer than the file
    (2**63, 16),                              # a hostile length
    (None, 2),                                # shorter than its length field
    (thf._MAX_HEADER_BYTES + 1,               # above the cap in a file
     thf._MAX_HEADER_BYTES + 64),             # (sparse) that would hold it
])
def test_reader_refuses_a_header_length_the_file_cannot_hold(tmp_path, n,
                                                             size):
    path = tmp_path / "bad.safetensors"
    with open(path, "wb") as f:
        f.write(b"" if n is None else n.to_bytes(8, "little"))
        f.truncate(size)
    with pytest.raises(ValueError, match="header length"):
        list(thf.read_safetensors(str(path)))


# ---------------------------------------------------------------------------
# config_from_hf
# ---------------------------------------------------------------------------

BASE = {"model_type": "llama", "vocab_size": 128, "hidden_size": 64,
        "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "rope_theta": 10000.0}
CONFIGS = {
    "llama": BASE,
    "mistral": dict(BASE, model_type="mistral", num_key_value_heads=2,
                    max_position_embeddings=32768, rms_norm_eps=1e-6),
    "no_model_type": {k: v for k, v in BASE.items() if k != "model_type"},
    "eos_list": dict(BASE, eos_token_id=[128001, 128009], pad_token_id=None),
    "tied": dict(BASE, tie_word_embeddings=True, pad_token_id=5),
    "rope_default": dict(BASE, rope_scaling={"rope_type": "default"}),
    "rope_linear": dict(BASE, rope_scaling={"type": "linear",
                                            "factor": 4.0}),
    "rope_llama3": dict(BASE, max_position_embeddings=131072,
                        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                      "low_freq_factor": 1.0,
                                      "high_freq_factor": 4.0,
                                      "original_max_position_embeddings":
                                          8192}),
    "rope_llama3_defaults": dict(BASE, rope_scaling={"rope_type": "llama3",
                                                     "factor": 2.0}),
    "rope_empty": dict(BASE, rope_scaling=None),
}
BAD_CONFIGS = {
    "gpt2": {"model_type": "gpt2"},
    "rope_yarn": dict(BASE, rope_scaling={"rope_type": "yarn",
                                          "factor": 2.0}),
    "rope_untyped": dict(BASE, rope_scaling={"factor": 2.0}),
    "no_vocab": {k: v for k, v in BASE.items() if k != "vocab_size"},
}


@pytest.mark.parametrize("name", CONFIGS)
def test_config_from_hf_equals_jax(name):
    want = jhf.config_from_hf(CONFIGS[name])
    got = thf.config_from_hf(CONFIGS[name])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("name", BAD_CONFIGS)
def test_config_from_hf_errors_equal_jax(name):
    with pytest.raises(Exception) as want:
        jhf.config_from_hf(BAD_CONFIGS[name])
    with pytest.raises(Exception) as got:
        thf.config_from_hf(BAD_CONFIGS[name])
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["sharded", "tied", "bf16"])
def test_tree_bit_equal_to_jax(checkpoints, name):
    path, _ = checkpoints[name]
    jparams, jcfg = jhf.load_hf_checkpoint(path, dtype="bfloat16")
    tree, cfg = thf.hf_tree(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    want = dict(_flatten(jax.tree.map(np.asarray, jparams)))
    got = dict(_flatten(tree))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert got[key].itemsize == want[key].itemsize, key
        np.testing.assert_array_equal(_leaf_bits(got[key]),
                                      _leaf_bits(want[key]), err_msg=key)
    assert ("lm_head" in got) == (name != "tied")


@pytest.mark.parametrize("name", ["sharded", "tied", "bf16"])
def test_transformer_bit_equal_to_jax_tree(checkpoints, name):
    path, _ = checkpoints[name]
    params, cfg = thf.load_hf_checkpoint(path, device="cpu")
    jparams, _ = jhf.load_hf_checkpoint(path)
    want = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    got_sd, want_sd = params.state_dict(), want.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for key, t in want_sd.items():
        assert got_sd[key].dtype == t.dtype, key
        assert torch.equal(got_sd[key].view(torch.uint8),
                           t.view(torch.uint8)), key
    assert params.device.type == "cpu"


def _copy_without(src, dst, drop, config_edit=None):
    """Copy checkpoint `src` to `dst` as one safetensors file, without
    the tensors named in `drop`."""
    from safetensors.torch import save_file

    os.makedirs(dst)
    tensors = {}
    for fname in sorted(os.listdir(src)):
        if fname.endswith(".safetensors"):
            with safetensors.safe_open(os.path.join(src, fname),
                                       framework="pt") as f:
                for key in f.keys():
                    if key not in drop:
                        tensors[key] = f.get_tensor(key)
    save_file(tensors, os.path.join(dst, "model.safetensors"))
    with open(os.path.join(src, "config.json")) as f:
        conf = json.load(f)
    if config_edit:
        conf.update(config_edit)
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(conf, f)


@pytest.mark.parametrize("drop,edit", [
    (("model.layers.1.mlp.up_proj.weight",), None),
    (("model.embed_tokens.weight",), None),
    (("lm_head.weight",), None),
    ((), {"num_hidden_layers": 3}),
])
def test_loader_errors_equal_jax(checkpoints, tmp_path, drop, edit):
    dst = str(tmp_path / "broken")
    _copy_without(checkpoints["sharded"][0], dst, set(drop), edit)
    with pytest.raises(ValueError) as want:
        jhf.load_hf_checkpoint(dst)
    with pytest.raises(ValueError) as got:
        thf.load_hf_checkpoint(dst, device="cpu")
    assert str(got.value) == str(want.value)


def test_missing_shards_error_equal_jax(tmp_path):
    # The directory holds a config and no safetensors.
    (tmp_path / "config.json").write_text(json.dumps(
        dict(BASE, num_key_value_heads=2)))
    with pytest.raises(FileNotFoundError) as want:
        jhf.load_hf_checkpoint(str(tmp_path))
    with pytest.raises(FileNotFoundError) as got:
        thf.load_hf_checkpoint(str(tmp_path), device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["sharded", "tied", "bf16"])
def test_logits_match_transformers_and_jax(checkpoints, name):
    from seldon_tpu.models import forward as jforward

    path, model = checkpoints[name]
    params, cfg = thf.load_hf_checkpoint(path, device="cpu")
    tokens = np.random.default_rng(0).integers(0, VOCAB, size=(2, 10))
    with torch.no_grad():
        hf = model.float()(torch.tensor(tokens)).logits.numpy()
        ours = ttf.forward(params, torch.tensor(tokens, dtype=torch.int32),
                           cfg).float().numpy()
    jparams, jcfg = jhf.load_hf_checkpoint(path)
    jax_logits = np.asarray(
        jforward(jparams, jnp.asarray(tokens, jnp.int32), jcfg)
    ).astype(np.float32)
    assert np.abs(hf).max() > 10 * HF_LOGITS_ATOL  # not a vacuous check
    np.testing.assert_allclose(ours, hf, rtol=0, atol=HF_LOGITS_ATOL)
    np.testing.assert_allclose(ours, jax_logits, rtol=0, atol=HF_LOGITS_ATOL)


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------


def test_torchserver_generate_equals_jaxserver(checkpoints):
    from seldon_tpu.servers.jaxserver import JAXServer

    path, _ = checkpoints["sharded"]
    kw = dict(model_uri=path, max_slots=4, max_seq_len=64, prefill_chunk=16,
              ragged=1)
    rng = np.random.default_rng(4)
    reqs = [{"prompt_token_ids": rng.integers(3, VOCAB, size=n).tolist(),
             "max_new_tokens": 6, "temperature": 0.0}
            for n in (5, 17, 30)]
    jsrv = JAXServer(**kw)
    jsrv.load()
    try:
        want = [jsrv.generate(r)["token_ids"] for r in reqs]
    finally:
        jsrv.engine.stop()
    srv = TorchServer(ragged_kernel="pallas", device="cpu", **kw)
    try:
        got = [srv.generate(r)["token_ids"] for r in reqs]
    finally:
        srv.stop()
    assert got == want
    assert srv.cfg.n_layers == 2 and srv.cfg.vocab_size == VOCAB
    assert srv.params.device.type == "cpu"
    assert isinstance(srv.tokenizer, ttok.ByteTokenizer)
    assert srv.engine.debug_lifecycle_check() == {}


def test_torchserver_model_uri_overrides_and_file_scheme(checkpoints,
                                                         caplog):
    path, _ = checkpoints["bf16"]
    srv = TorchServer(model_uri="file://" + path, weight_dtype="int8",
                      act_dtype="int8", max_slots=2, max_seq_len=64,
                      prefill_chunk=16, ragged=1, ragged_kernel="sparse",
                      device="cpu")
    with caplog.at_level("WARNING"):
        try:
            out = srv.generate({"prompt_token_ids": [5, 9, 33],
                                "max_new_tokens": 3, "temperature": 0.0})
        finally:
            srv.stop()
    assert 1 <= len(out["token_ids"]) <= 3
    assert srv.cfg.weight_dtype == "int8" and srv.cfg.act_dtype == "int8"
    assert srv.params.blocks[0].wq.dtype == torch.int8
    assert "W8A8" in caplog.text


# ---------------------------------------------------------------------------
# The tokenizer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    """A tiny BPE trained in-process and saved as a transformers fast
    tokenizer (tokenizer.json + tokenizer_config.json)."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    trainer = trainers.BpeTrainer(
        vocab_size=120, special_tokens=["[UNK]", "<pad>", "<s>", "</s>"])
    corpus = ["the quick brown fox jumps over the lazy dog",
              "serving graphs of models behind one endpoint",
              "a prefix cache shares the blocks of a system prompt"] * 20
    tok.train_from_iterator(corpus, trainer)
    fast = transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="[UNK]", pad_token="<pad>",
        bos_token="<s>", eos_token="</s>")
    path = str(tmp_path_factory.mktemp("tok"))
    fast.save_pretrained(path)
    return path


def test_load_tokenizer_equals_jax(tokenizer_dir, monkeypatch, tmp_path):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    got, want = (ttok.load_tokenizer(tokenizer_dir),
                 jtok.load_tokenizer(tokenizer_dir))
    assert isinstance(got, ttok.HFTokenizer)
    assert isinstance(want, jtok.HFTokenizer)
    for text in ("the lazy fox", "a system prompt of models",
                 "unseen words zq"):
        ids = got.encode(text)
        assert ids == want.encode(text)
        assert got.decode(ids) == want.decode(ids)
    assert (got.eos_token_id, got.pad_token_id) == \
        (want.eos_token_id, want.pad_token_id)
    assert got.eos_token_id == 3 and got.pad_token_id == 1
    # No tokenizer file, or no directory: bytes.
    for where in (str(tmp_path), None):
        assert isinstance(ttok.load_tokenizer(where), ttok.ByteTokenizer)
        assert isinstance(jtok.load_tokenizer(where), jtok.ByteTokenizer)
