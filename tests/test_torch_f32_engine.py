"""The port's serving engine on a float32 model against the JAX engine on
the same f32 model (``tiny``, JAX's weights carried across bit for bit):
the ragged engine on its masked, sparse and kernel legs (B1's plain
version on the CPU), and the bucketed engines (the dense slab and the
paged pool with chunked prefill), f32 or int8 KV, greedy and sampled
requests in one burst. Streams equal, except where the reference's top-2
gap (with the request's Gumbel noise when sampled) is below 1e-4: such a
parting is reported, not failed. The JAX engine runs with a copying
``jnp.asarray`` (ROADMAP.md C3). On the card an f32 model whose process
runs f32 matmuls in TF32 is refused."""

import dataclasses

import pytest
import torch

from seldon_tpu.models.config import PRESETS
from seldon_tpu_torch.models.config import ModelConfig as TModelConfig
from seldon_tpu_torch.ops import ragged_paged_attention as rpa
from seldon_tpu_torch.servers import engine as teng
from tests.torch_port_helpers import (ENGINE_ECFG, assert_streams_match,
                                      engine_prompts, params_pair,
                                      run_jax_engine, run_torch_engine)

F32_ATOL = 1e-4
GREEDY = dict(temperature=0.0, max_new_tokens=8)
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.95, max_new_tokens=8)
BUCKETED = dict(max_slots=4, max_seq_len=64, prompt_buckets=(16, 32),
                max_admit=4, decode_chunk=4, min_chunk=2, prefix_block=8,
                kv_block=8)
BUCKETED_MODES = {"dense": {},
                  "paged-chunked": dict(paged_kv=True, chunked_prefill=True,
                                        prefill_chunk=16)}


@pytest.fixture(scope="module", params=["f32", "int8"])
def weights(request):
    kv = "bf16" if request.param == "f32" else "int8"
    jcfg = dataclasses.replace(PRESETS["tiny"], dtype="float32",
                               kv_cache_dtype=kv)
    tcfg = TModelConfig(**dataclasses.asdict(jcfg))
    jp, tp = params_pair(jcfg, seed=5)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("knobs", [GREEDY, SAMPLED],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("leg", ["masked", "sparse", "pallas"])
def test_ragged_engine_legs_match_the_jax_f32_engine(weights, leg, knobs):
    jcfg, tcfg, jp, tp = weights
    prompts = engine_prompts(jcfg)
    want = run_jax_engine(jp, jcfg, prompts, knobs,
                          dict(ENGINE_ECFG, ragged_kernel=leg))
    before = rpa.launches
    got, eng = run_torch_engine(tp, tcfg, prompts, knobs, leg)
    assert rpa.launches == before  # the CPU runs the plain version
    assert eng._state["cache"]["k"].dtype == (
        torch.int8 if jcfg.kv_cache_dtype == "int8" else torch.float32)
    assert all(len(s) == knobs["max_new_tokens"] for s in want)
    assert_streams_match(got, want, jp, jcfg, prompts,
                         f"ragged/{leg}/{jcfg.kv_cache_dtype}",
                         knobs=knobs, atol=F32_ATOL)


@pytest.mark.parametrize("mode", list(BUCKETED_MODES))
def test_bucketed_engine_matches_the_jax_f32_engine(weights, mode):
    jcfg, tcfg, jp, tp = weights
    prompts = engine_prompts(jcfg)
    ecfg = dict(BUCKETED, **BUCKETED_MODES[mode])
    for knobs in (GREEDY, SAMPLED):
        want = run_jax_engine(jp, jcfg, prompts, knobs, ecfg)
        got, eng = run_torch_engine(
            tp, tcfg, prompts, knobs, "masked",
            {k: v for k, v in ecfg.items()})
        assert eng.stats.snapshot()["completed"] == len(prompts)
        assert_streams_match(got, want, jp, jcfg, prompts,
                             f"bucketed/{mode}/{jcfg.kv_cache_dtype}",
                             knobs=knobs, atol=F32_ATOL)


def test_f32_model_with_tf32_matmuls_is_refused():
    """``device.configure_gemms()`` reports TF32 on: an f32 model on the
    card is refused, a bf16 one and any model on the CPU are not."""
    f32 = TModelConfig(**dataclasses.asdict(dataclasses.replace(
        PRESETS["tiny"], dtype="float32")))
    bf16 = TModelConfig(**dataclasses.asdict(PRESETS["tiny"]))
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    on, off = {"tf32": True}, {"tf32": False}
    with pytest.raises(ValueError, match="TF32"):
        teng.check_f32_gemms(f32, cuda, on)
    teng.check_f32_gemms(f32, cuda, off)
    teng.check_f32_gemms(bf16, cuda, on)
    teng.check_f32_gemms(f32, cpu, on)
