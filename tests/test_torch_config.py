"""seldon_tpu_torch.models.config is a field-for-field copy of
seldon_tpu.models.config: drift in either fails here."""

import dataclasses

import pytest

from seldon_tpu.models import config as jcfg
from seldon_tpu_torch.models import config as tcfg


def _fields(cls):
    return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]


def test_model_config_fields_equal():
    assert _fields(tcfg.ModelConfig) == _fields(jcfg.ModelConfig)


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_presets_equal(name):
    assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)
    want = dataclasses.asdict(jcfg.PRESETS[name])
    got = dataclasses.asdict(tcfg.PRESETS[name])
    assert got == want
    assert tcfg.PRESETS[name].head_dim == jcfg.PRESETS[name].head_dim
    assert tcfg.PRESETS[name].q_per_kv == jcfg.PRESETS[name].q_per_kv


def test_get_config_overrides_and_validation_match():
    got = tcfg.get_config("tiny", kv_cache_dtype="int8", eos_token_id=9)
    want = jcfg.get_config("tiny", kv_cache_dtype="int8", eos_token_id=9)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for bad in (dict(attn_impl="nope"), dict(n_kv_heads=3),
                dict(rope_scaling_type="yarn")):
        with pytest.raises(AssertionError):
            jcfg.get_config("tiny", **bad)
        with pytest.raises(AssertionError):
            tcfg.get_config("tiny", **bad)
