"""The static shape lattice of seldon_tpu_torch against the JAX package's.

 * Module: ``servers/shape_lattice.py`` of the port against the JAX
   module over every spec of the certifier grid (``grid()``, the same
   specs in both): ``dispatch_keys``, ``simulate_keys``, ``warmup_order``
   and ``check_spec`` equal, and the closed form agrees with the
   simulation (no hole, no waste) in the port.
 * Engine: for each engine family (dense and paged bucketed, one-shot
   and chunked, with and without the prefix cache, the ragged wave,
   speculative decoding with the n-gram and the model drafter), the
   port engine's ``lattice_spec()`` and ``static_lattice()`` equal the
   JAX engine's for the same ``EngineConfig`` on the ``tiny`` preset.

Keys are integer tuples: the contract is equality, no tolerance."""

import dataclasses

import pytest

from seldon_tpu.models.config import PRESETS
from seldon_tpu.servers import engine as jeng
from seldon_tpu.servers import shape_lattice as jsl
from seldon_tpu_torch.models.config import PRESETS as TPRESETS
from seldon_tpu_torch.servers import engine as teng
from seldon_tpu_torch.servers import shape_lattice as tsl
from tests.torch_port_helpers import params_pair

GRID = list(range(tsl.GRID_COUNT))


def test_grid_and_families_equal():
    assert tsl.GRID_COUNT == jsl.GRID_COUNT
    assert tsl.FAMILIES == jsl.FAMILIES
    assert tsl.FAMILY_TAGS == jsl.FAMILY_TAGS
    assert [dataclasses.asdict(s) for s in tsl.grid()] == \
        [dataclasses.asdict(s) for s in jsl.grid()]


@pytest.mark.parametrize("i", GRID)
def test_closed_form_and_simulation_equal_jax(i):
    tspec, jspec = tsl.grid()[i], jsl.grid()[i]
    closed = tsl.dispatch_keys(tspec)
    seen = tsl.simulate_keys(tspec)
    assert closed == jsl.dispatch_keys(jspec)
    assert seen == jsl.simulate_keys(jspec)
    assert tsl.warmup_order(closed) == jsl.warmup_order(closed)
    assert tsl.check_spec(tspec) == jsl.check_spec(jspec) == ([], [])


def test_spec_validation_matches_jax():
    bad = [dict(buckets=()), dict(buckets=(64, 32)),
           dict(chunked=True), dict(ragged=True),
           dict(spec=True), dict(spec=True, paged=True, spec_rungs=(3,))]
    base = dict(buckets=(32, 64), max_seq_len=64, max_slots=4, max_admit=4,
                decode_rungs=(4,))
    for kw in bad:
        with pytest.raises(ValueError) as te:
            tsl.LatticeSpec(**dict(base, **kw))
        with pytest.raises(ValueError) as je:
            jsl.LatticeSpec(**dict(base, **kw))
        assert str(te.value) == str(je.value)


# Engine families: EngineConfig keywords over the shared base below.
FAMILIES = {
    "dense": {},
    "dense-prefix": dict(prefix_cache=True),
    "dense-chunked": dict(chunked_prefill=True, prefill_chunk=16),
    "dense-chunked-prefix": dict(chunked_prefill=True, prefill_chunk=16,
                                 prefix_cache=True, dispatch_token_budget=32),
    "paged": dict(paged_kv=True),
    "paged-prefix": dict(paged_kv=True, prefix_cache=True),
    "paged-chunked": dict(paged_kv=True, chunked_prefill=True,
                          prefill_chunk=16),
    "ragged": dict(paged_kv=True, chunked_prefill=True, prefill_chunk=16,
                   ragged=True),
    "ragged-prefix": dict(paged_kv=True, chunked_prefill=True,
                          prefill_chunk=16, ragged=True, prefix_cache=True),
    "spec": dict(paged_kv=True, spec_decode=True, spec_k=4),
    "spec-chunked": dict(paged_kv=True, spec_decode=True, spec_k=2,
                         chunked_prefill=True, prefill_chunk=16),
    "spec-draft": dict(paged_kv=True, spec_decode=True, spec_k=2),
}
BASE = dict(max_slots=4, max_seq_len=64, prompt_buckets=(16, 32, 64),
            max_admit=4, kv_block=16, prefix_block=16, decode_chunk=8,
            min_chunk=2)


@pytest.fixture(scope="module")
def weights():
    cfg, tcfg = PRESETS["tiny"], TPRESETS["tiny"]
    jparams, tparams = params_pair(cfg, seed=0)
    return cfg, tcfg, jparams, tparams


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_engine_lattice_equals_jax(weights, family):
    cfg, tcfg, jparams, tparams = weights
    kw = dict(BASE, **FAMILIES[family])
    draft = family == "spec-draft"
    jengine = jeng.InferenceEngine(
        jparams, cfg, jeng.EngineConfig(**kw),
        draft=(jparams, cfg) if draft else None)
    tengine = teng.InferenceEngine(
        tparams, tcfg, teng.EngineConfig(**kw), device="cpu",
        draft=(tparams, tcfg) if draft else None)
    assert dataclasses.asdict(tengine.lattice_spec()) == \
        dataclasses.asdict(jengine.lattice_spec())
    assert tengine.static_lattice() == jengine.static_lattice()
    assert tengine.static_lattice(), family
