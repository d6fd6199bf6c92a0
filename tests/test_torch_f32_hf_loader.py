"""The port's float32 HF load against the JAX package's: the twin of
tests/test_hf_loader.py's f32 cases on a tiny HF Llama checkpoint built
in-process with ``transformers`` (f32, several shards, no network).

 * ``load_hf_checkpoint(path, dtype="float32")``: every leaf bit-equal to
   JAX's ``load_hf_checkpoint(path, dtype="float32")`` (norms f32 as in
   bf16 loads), the config JAX's with ``dtype="float32"`` (JAX's loader
   returns its default dtype and its tests replace it), the shapes of
   tests/test_hf_loader.py's mapping test;
 * logits within 2e-4 of ``transformers``' f32 forward (JAX's own bound)
   and within 1e-4 of JAX's f32 forward on the JAX loader's weights;
 * greedy cached decode equals ``transformers``' greedy ``generate``;
 * a rank's shard (``load_hf_shard(..., dtype="float32")``) is the cut of
   the whole f32 model, bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from seldon_tpu.models import forward as jforward  # noqa: E402
from seldon_tpu.servers import hf_loader as jhf  # noqa: E402
from seldon_tpu_torch.models import tp_sharding  # noqa: E402
from seldon_tpu_torch.models import transformer as ttf  # noqa: E402
from seldon_tpu_torch.servers import hf_loader as thf  # noqa: E402

HF_ATOL = 2e-4  # tests/test_hf_loader.py's f32 bound against transformers
JAX_ATOL = 1e-4


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rope_theta=10000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg).eval()
    path = str(tmp_path_factory.mktemp("hf-llama-f32"))
    model.save_pretrained(path, safe_serialization=True,
                          max_shard_size="100KB")
    return path, model


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_f32_tree_and_model_bit_equal_to_jax(checkpoint):
    path, _ = checkpoint
    jparams, jcfg = jhf.load_hf_checkpoint(path, dtype="float32")
    tree, cfg = thf.hf_tree(path, dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        dataclasses.replace(jcfg, dtype="float32"))
    want = dict(_flatten(jax.tree.map(np.asarray, jparams)))
    got = dict(_flatten(tree))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype == np.float32, key
        np.testing.assert_array_equal(got[key].view(np.uint32),
                                      want[key].view(np.uint32), err_msg=key)
    params, pcfg = thf.load_hf_checkpoint(path, device="cpu",
                                          dtype="float32")
    assert pcfg == cfg and pcfg.n_layers == 3 and pcfg.n_kv_heads == 2
    assert tuple(params.blocks[0].wk.shape) == (64, 32)  # GQA: 2 kv heads
    assert tuple(params.lm_head.shape) == (64, 128)
    for name, t in params.named_parameters():
        assert t.dtype == torch.float32, name
    for i, bp in enumerate(params.blocks):
        np.testing.assert_array_equal(bp.w_gate.numpy(),
                                      want["blocks.w_gate"][i])
        np.testing.assert_array_equal(bp.attn_norm.numpy(),
                                      want["blocks.attn_norm"][i])


def test_f32_logits_match_transformers_and_jax(checkpoint):
    path, model = checkpoint
    params, cfg = thf.load_hf_checkpoint(path, device="cpu",
                                         dtype="float32")
    tokens = np.random.default_rng(0).integers(0, 128, size=(2, 10))
    with torch.no_grad():
        hf = model(torch.tensor(tokens)).logits.numpy()
    ours = ttf.forward(params, torch.tensor(tokens, dtype=torch.int32),
                       cfg).numpy()
    jparams, jcfg = jhf.load_hf_checkpoint(path, dtype="float32")
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    want = np.asarray(jforward(jparams, jnp.asarray(tokens), jcfg))
    np.testing.assert_allclose(ours, hf, rtol=HF_ATOL, atol=HF_ATOL)
    np.testing.assert_allclose(ours, want, rtol=0, atol=JAX_ATOL)


def test_f32_greedy_decode_matches_transformers(checkpoint):
    path, model = checkpoint
    params, cfg = thf.load_hf_checkpoint(path, device="cpu",
                                         dtype="float32")
    prompt = [[5, 17, 99, 3]]
    with torch.no_grad():
        hf_out = model.generate(
            torch.tensor(prompt), max_new_tokens=6, do_sample=False,
            pad_token_id=0).numpy()[0, 4:].tolist()
    cache = ttf.init_cache(cfg, 1, 32, device="cpu")
    assert cache["k"].dtype == torch.float32
    logits, cache = ttf.prefill(params, torch.tensor(prompt,
                                                     dtype=torch.int32),
                                torch.tensor([4], dtype=torch.int32), cache,
                                cfg)
    toks = [int(logits[0].argmax())]
    pos = torch.tensor([4], dtype=torch.int32)
    for _ in range(5):
        lg, cache = ttf.decode_step(params, torch.tensor(
            [toks[-1]], dtype=torch.int32), pos, cache, cfg)
        toks.append(int(lg[0].argmax()))
        pos = pos + 1
    assert toks == hf_out


@pytest.mark.parametrize("rank", [0, 1])
def test_f32_hf_shard_is_the_cut_of_the_whole(checkpoint, rank):
    path, _ = checkpoint
    whole, cfg = thf.load_hf_checkpoint(path, device="cpu", dtype="float32")
    shard, scfg = thf.load_hf_shard(path, "cpu", rank, 2, dtype="float32")
    assert scfg == cfg

    class Rank:
        world = 2

    Rank.rank = rank
    want = tp_sharding.shard_params(Rank, cfg, whole)
    got_sd, want_sd = shard.state_dict(), want.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for key, t in want_sd.items():
        assert got_sd[key].dtype == t.dtype == torch.float32, key
        assert torch.equal(got_sd[key], t), key
