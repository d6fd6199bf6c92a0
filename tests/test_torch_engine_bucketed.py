"""The bucketed and dense engine families of seldon_tpu_torch against the
JAX engine's, one by one, and the host logic around them.

 * Families: each device family of the port's ``InferenceEngine`` (a
   static method keeping its JAX name) against the JAX static method of
   the same name on the same seeded inputs, ``tiny`` preset, bf16 and int8
   KV: integer state (tokens, positions, active flags, budgets) bit-equal;
   KV within one bf16 rounding step; int8 codes within two codes (the
   bf16 values they quantize may differ by one rounding step, half a
   code at full scale, and the row's max moves the scale by as much
   again). Admission groups carry a padding row that repeats a real one
   (same slot, same data); decode chunks carry an idle row and a row
   that finishes inside the chunk.
 * Host logic: the decode-chunk ladder and ``_pick_chunk``'s rung for
   every occupancy, and the admission groups of one roster (one-shot and
   chunked, dense and paged: members, slots, finals, block tables),
   bit-equal to the JAX engine's.
 * Lifecycle: cancel and deadline reaping through ``_deactivate_impl``,
   with a clean leak audit, in the dense and paged bucketed engines."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_tpu.models import transformer as jtf
from seldon_tpu.models.config import PRESETS
from seldon_tpu.models.sampling import SamplingParams as JSamplingParams
from seldon_tpu.servers import engine as jeng
from seldon_tpu_torch.models.config import PRESETS as TPRESETS
from seldon_tpu_torch.models.sampling import SamplingParams
from seldon_tpu_torch.servers import engine as teng
from tests.torch_port_helpers import f32, params_pair, to_torch

B, SMAX, BLOCK = 4, 64, 8
NBS = SMAX // BLOCK
JE, TE = jeng.InferenceEngine, teng.InferenceEngine


@pytest.fixture(scope="module", params=["bf16", "int8"])
def fam(request):
    cfg = dataclasses.replace(PRESETS["tiny"], kv_cache_dtype=request.param)
    tcfg = dataclasses.replace(TPRESETS["tiny"],
                               kv_cache_dtype=request.param)
    jparams, tparams = params_pair(cfg, seed=0)
    return dict(cfg=cfg, tcfg=tcfg, jp=jparams, tp=tparams)


def _fresh(cfg, paged):
    cache = (jtf.init_paged_cache(cfg, B * NBS + 1, BLOCK) if paged
             else jtf.init_cache(cfg, B, SMAX))
    return {
        "cache": cache,
        "last_tok": jnp.zeros((B,), jnp.int32),
        "pos": jnp.zeros((B,), jnp.int32),
        "active": jnp.zeros((B,), jnp.bool_),
        "temp": jnp.ones((B,), jnp.float32),
        "top_k": jnp.zeros((B,), jnp.int32),
        "top_p": jnp.ones((B,), jnp.float32),
        "seeds": jnp.zeros((B,), jnp.uint32),
        "remaining": jnp.zeros((B,), jnp.int32),
    }


def _t(x):
    """A JAX / numpy value as the port's input (uint32 seeds as int64)."""
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    t = to_torch(x)
    return t.to(torch.int64) if np.asarray(x).dtype == np.uint32 else t


def _j(x):
    if isinstance(x, dict):
        return {k: _j(v) for k, v in x.items()}
    return jnp.asarray(x)


def _assert_kv(got, want, cfg, what):
    for key, arr in want.items():
        g, r = f32(got[key]), np.asarray(arr, np.float32)
        assert g.shape == r.shape, (what, key)
        if key in ("k", "v") and cfg.kv_cache_dtype == "int8":
            assert np.abs(g - r).max(initial=0) <= 2, (what, key)
        else:
            np.testing.assert_allclose(g, r, rtol=2.0 ** -7, atol=1e-2,
                                       err_msg=f"{what} {key}")


def _assert_state(got, want, cfg, what):
    for key in ("last_tok", "pos", "active", "remaining", "top_k", "seeds",
                "temp", "top_p"):
        np.testing.assert_array_equal(
            got[key].numpy().astype(np.float64),
            np.asarray(want[key]).astype(np.float64), err_msg=f"{what} {key}")
    _assert_kv(got["cache"], want["cache"], cfg, f"{what} cache")


def _both(f, name, jstate, *args, **kw):
    """The JAX static method and the port's on the same inputs (the
    port's cache is a converted copy: its families write in place)."""
    want = getattr(JE, name)(f["jp"], jstate, *map(_j, args), cfg=f["cfg"],
                             **kw)
    got = getattr(TE, name)(f["tp"], _t(jstate), *map(_t, args),
                            cfg=f["tcfg"], **kw)
    return got, want


def _admit_args(rng, cfg, lens, slots, S, temps):
    """Host arrays of a padded admission group: row i is prompt i, the
    last real row repeated for the padding."""
    G = len(slots)
    toks = np.full((G, S), cfg.pad_token_id, np.int32)
    plens = np.empty((G,), np.int32)
    for i in range(G):
        n = lens[min(i, len(lens) - 1)]
        if i < len(lens):
            row = rng.integers(3, cfg.vocab_size, n)
        toks[i, :n] = row
        plens[i] = n
    seeds = np.asarray([11 + i for i in range(len(lens))]
                       + [11 + len(lens) - 1] * (G - len(lens)), np.uint32)
    temps = np.asarray(temps, np.float32)
    top_ks = np.where(temps > 0, 20, 0).astype(np.int32)
    top_ps = np.where(temps > 0, 0.95, 1.0).astype(np.float32)
    max_news = np.full((G,), 5, np.int32)
    return toks, plens, seeds, temps, top_ks, top_ps, max_news, \
        np.asarray(slots, np.int32)


def _dense_admitted(f, rng):
    """JAX's dense state after a cold admission of three prompts into
    slots 2, 0, 3 (the group padded to 4 with slot 3 repeated)."""
    args = _admit_args(rng, f["cfg"], [16, 9, 5], [2, 0, 3, 3], 16,
                       [0.0, 0.8, 0.0, 0.0])
    state, _, _ = JE._admit_impl(f["jp"], _fresh(f["cfg"], False),
                                 *map(_j, args), cfg=f["cfg"])
    return state, args


def test_admit_impl_matches_jax(fam):
    rng = np.random.default_rng(0)
    args = _admit_args(rng, fam["cfg"], [16, 9, 5], [2, 0, 3, 3], 16,
                       [0.0, 0.8, 0.0, 0.0])
    got, want = _both(fam, "_admit_impl", _fresh(fam["cfg"], False), *args,
                      return_sub=True)
    for i, what in ((1, "first"), (2, "first_done")):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]),
                                      err_msg=what)
    _assert_state(got[0], want[0], fam["cfg"], "admit")
    _assert_kv(got[3], want[3], fam["cfg"], "admit sub")


def test_chunk_impl_matches_jax(fam):
    """Three decode steps over the dense slab: slot 1 idle, slot 3 with a
    budget that ends inside the chunk."""
    state, _ = _dense_admitted(fam, np.random.default_rng(0))
    state = dict(state, remaining=state["remaining"].at[3].set(1))
    got, want = _both(fam, "_chunk_impl", state, n_steps=3)
    for i, what in ((1, "toks"), (2, "valid"), (3, "active")):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]),
                                      err_msg=what)
    assert not np.asarray(want[2])[:, 1].any()
    assert np.asarray(want[2])[:, 3].tolist() == [True, False, False]
    _assert_state(got[0], want[0], fam["cfg"], "chunk")


def test_admit_prefix_impl_matches_jax(fam):
    """A warm admission on the dense slab: slot 2's first 8 positions as
    the reused prefix (zero-padded to the 16 bucket) of two prompts into
    slots 1 and 3."""
    rng = np.random.default_rng(1)
    state, _ = _dense_admitted(fam, rng)
    prefix = {k: np.asarray(v)[:, [2, 2], :, :16] for k, v in
              state["cache"].items()}
    for v in prefix.values():
        v[:, :, :, 8:] = 0
    toks, plens, *knobs = _admit_args(rng, fam["cfg"], [7, 12], [1, 3], 16,
                                      [0.0, 0.0])
    got, want = _both(fam, "_admit_prefix_impl", state, toks, plens + 8,
                      np.full((2,), 8, np.int32), prefix, *knobs)
    for i, what in ((1, "first"), (2, "first_done")):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]),
                                      err_msg=what)
    _assert_state(got[0], want[0], fam["cfg"], "admit prefix")
    _assert_kv(got[3], want[3], fam["cfg"], "admit prefix writes")


@pytest.mark.parametrize("width", [0, 16])
def test_admit_chunk_impl_matches_jax(fam, width):
    """A prefill chunk on the dense slab: the first chunk of a new prompt
    (no resident KV), or a continuation against slot 2's 16 resident
    positions; the final row samples and arms, the other only writes."""
    rng = np.random.default_rng(2)
    state, _ = _dense_admitted(fam, rng)
    toks, plens, *knobs = _admit_args(rng, fam["cfg"], [8, 8], [2, 1], 8,
                                      [0.0, 0.0])
    starts = np.asarray([width, 0], np.int32)
    plens = np.asarray([width + 8, 30], np.int32)
    finals = np.asarray([True, False])
    got, want = _both(fam, "_admit_chunk_impl", state, toks, plens, starts,
                      *knobs, finals, prefix_width=width, return_sub=True)
    for i, what in ((1, "first"), (2, "first_done")):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]),
                                      err_msg=what)
    _assert_state(got[0], want[0], fam["cfg"], "admit chunk")
    _assert_kv(got[3], want[3], fam["cfg"], "admit chunk writes")


def test_seed_prefix_impl_matches_jax(fam):
    state, _ = _dense_admitted(fam, np.random.default_rng(3))
    prefix = {k: np.asarray(v)[:, 2, :, :16] for k, v in
              state["cache"].items()}
    want = JE._seed_prefix_impl(state, _j(prefix), jnp.int32(1))
    got = TE._seed_prefix_impl(_t(state), _t(prefix), 1)
    _assert_state(got, want, fam["cfg"], "seed prefix")


def _paged_admitted(f, rng):
    """JAX's paged state and tables after a cold admission of prompts of
    16, 9 and 5 tokens into slots 2, 0, 3 (padded to 4)."""
    table = np.zeros((B, NBS), np.int32)
    for s in range(B):
        table[s, :4] = 1 + s * NBS + np.arange(4)
    args = _admit_args(rng, f["cfg"], [16, 9, 5], [2, 0, 3, 3], 16,
                       [0.0, 0.8, 0.0, 0.0])
    state, _, _ = JE._paged_admit_impl(
        f["jp"], _fresh(f["cfg"], True), jnp.asarray(table[args[-1]]),
        *map(_j, args[:2]), jnp.zeros((4,), jnp.int32), *map(_j, args[2:]),
        prefix_width=0, cfg=f["cfg"])
    return state, table


@pytest.mark.parametrize("warm", [False, True])
def test_paged_admit_impl_matches_jax(fam, warm):
    """Cold: a padded group of three through the flash-free cold prefill,
    written through the tables. Warm: slot 1 shares slot 2's first two
    blocks (a 16-token prefix, of which 12 are reused) and runs its
    suffix against them."""
    rng = np.random.default_rng(4)
    if warm:
        state, table = _paged_admitted(fam, rng)
        table[1, :2] = table[2, :2]
        toks, plens, seeds, *knobs = _admit_args(
            rng, fam["cfg"], [9], [1], 16, [0.0])
        pref = np.asarray([12], np.int32)
        args = (table[[1]], toks, plens + 12, pref, seeds, *knobs)
    else:
        state = _fresh(fam["cfg"], True)
        _, table = _paged_admitted(fam, rng)
        toks, plens, seeds, *knobs = _admit_args(
            rng, fam["cfg"], [16, 9, 5], [2, 0, 3, 3], 16,
            [0.0, 0.8, 0.0, 0.0])
        args = (table[knobs[-1]], toks, plens, np.zeros((4,), np.int32),
                seeds, *knobs)
    got, want = _both(fam, "_paged_admit_impl", state, *args,
                      prefix_width=16 if warm else 0)
    for i, what in ((1, "first"), (2, "first_done")):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]),
                                      err_msg=what)
    _assert_state(got[0], want[0], fam["cfg"], "paged admit")


def test_paged_admit_chunk_impl_matches_jax(fam):
    """A continuation chunk against slot 2's two resident blocks and a
    first chunk of a new prompt in slot 1, through the tables."""
    rng = np.random.default_rng(5)
    state, table = _paged_admitted(fam, rng)
    toks, _, *knobs = _admit_args(rng, fam["cfg"], [8, 8], [2, 1], 8,
                                  [0.0, 0.0])
    got, want = _both(fam, "_paged_admit_chunk_impl", state,
                      table[[2, 1]], toks, np.asarray([24, 30], np.int32),
                      np.asarray([16, 0], np.int32), *knobs,
                      np.asarray([True, False]), prefix_width=16)
    for i, what in ((1, "first"), (2, "first_done")):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]),
                                      err_msg=what)
    _assert_state(got[0], want[0], fam["cfg"], "paged admit chunk")


def test_paged_chunk_impl_matches_jax(fam):
    """Three paged decode steps: slot 1 idle with a zeroed table row (its
    writes land in the trash block), slot 3's budget ends inside."""
    state, table = _paged_admitted(fam, np.random.default_rng(6))
    state = dict(state, remaining=state["remaining"].at[3].set(1))
    table[1] = 0
    got, want = _both(fam, "_paged_chunk_impl", state, table, n_steps=3)
    for i, what in ((1, "toks"), (2, "valid"), (3, "active")):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]),
                                      err_msg=what)
    _assert_state(got[0], want[0], fam["cfg"], "paged chunk")


def test_deactivate_impl_matches_jax(fam):
    state, _ = _dense_admitted(fam, np.random.default_rng(7))
    keep = np.asarray([True, True, False, True])
    want = JE._deactivate_impl(state, jnp.asarray(keep))
    got = TE._deactivate_impl(_t(state), torch.from_numpy(keep))
    _assert_state(got, want, fam["cfg"], "deactivate")


# ---------------------------------------------------------------------------
# Host logic
# ---------------------------------------------------------------------------

LADDERS = [dict(), dict(decode_chunk=8, min_chunk=2),
           dict(decode_chunk=16, min_chunk=1), dict(adaptive_chunk=False),
           dict(decode_chunk=4, min_chunk=4)]


@pytest.mark.parametrize("ladder", LADDERS)
def test_pick_chunk_rungs_equal_jax(ladder):
    """The chunk ladder and the rung picked at every occupancy of a
    16-slot engine."""
    jparams, tparams = params_pair(PRESETS["tiny"], seed=0)
    ecfg = dict(max_slots=16, max_seq_len=64, prompt_buckets=(16, 32),
                max_admit=4, **ladder)
    j = JE(jparams, PRESETS["tiny"], jeng.EngineConfig(**ecfg))
    t = TE(tparams, TPRESETS["tiny"], teng.EngineConfig(**ecfg),
           device="cpu")
    assert t._chunk_sizes == j._chunk_sizes
    picks = []
    for busy in range(17):
        for eng in (j, t):
            eng._slots = [object()] * busy + [None] * (16 - busy)
        picks.append((j._pick_chunk(), t._pick_chunk()))
    assert [p[0] for p in picks] == [p[1] for p in picks], picks


def _groups(eng, chunked, passes):
    """The admission groups of successive boundaries (no decode): each
    group's (prompt lengths, slots, finals), and the block tables."""
    out = []
    with eng._book:
        for _ in range(passes):
            admits = (eng._dispatch_prefill_chunks() if chunked
                      else eng._dispatch_admits())
            out.append([([len(r.tokens) for r in g], [r.slot for r in g],
                         f) for g, f, _, _ in admits])
        table = (eng._table_host.copy() if eng._paged else None)
    return out, table


@pytest.mark.parametrize("mode", ["dense", "paged", "dense-chunked",
                                  "paged-chunked"])
def test_admission_groups_equal_jax(mode):
    """One roster of eleven prompts over four prompt buckets into eight
    slots: the groups, their slots and (chunked) finals, boundary after
    boundary, and the paged block tables."""
    jparams, tparams = params_pair(PRESETS["tiny"], seed=0)
    ecfg = dict(max_slots=8, max_seq_len=128, prompt_buckets=(8, 16, 32, 64),
                max_admit=4, kv_block=8, prefix_block=8)
    if "paged" in mode:
        ecfg.update(paged_kv=True)
    chunked = "chunked" in mode
    if chunked:
        ecfg.update(chunked_prefill=True, prefill_chunk=16,
                    dispatch_token_budget=48)
    lens = [5, 7, 30, 12, 14, 60, 3, 16, 33, 9, 40]
    rng = np.random.default_rng(8)
    prompts = [rng.integers(3, 256, n).tolist() for n in lens]
    j = JE(jparams, PRESETS["tiny"], jeng.EngineConfig(**ecfg))
    t = TE(tparams, TPRESETS["tiny"], teng.EngineConfig(**ecfg),
           device="cpu")
    for p in prompts:
        j.submit(p, JSamplingParams(max_new_tokens=4))
        t.submit(p, SamplingParams(max_new_tokens=4))
    passes = 4 if chunked else 1
    want, wtable = _groups(j, chunked, passes)
    got, gtable = _groups(t, chunked, passes)
    assert got == want
    assert sum(len(b) for b in got) >= 3
    if wtable is not None:
        np.testing.assert_array_equal(gtable, wtable)


# ---------------------------------------------------------------------------
# Lifecycle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True])
def test_cancel_and_deadline_reap_through_deactivate(monkeypatch, paged):
    calls = []
    orig = TE._deactivate_impl

    def counted(state, keep):
        calls.append(keep.clone())
        return orig(state, keep)

    monkeypatch.setattr(TE, "_deactivate_impl", staticmethod(counted))
    _, tparams = params_pair(PRESETS["tiny"], seed=0)
    ecfg = dict(max_slots=4, max_seq_len=64, prompt_buckets=(16, 32),
                decode_chunk=2, min_chunk=1)
    if paged:
        ecfg.update(paged_kv=True, kv_block=8, prefix_block=8)
    eng = TE(tparams, TPRESETS["tiny"], teng.EngineConfig(**ecfg),
             device="cpu")
    eng.start()
    try:
        long_q = eng.submit(list(range(3, 20)), SamplingParams(
            temperature=0.0, max_new_tokens=40))
        first = long_q.get(timeout=60)
        assert "tokens" in first
        assert eng.cancel(long_q.rid)
        late = eng.submit(list(range(5, 15)), SamplingParams(
            temperature=0.0, max_new_tokens=40, deadline_ms=1))
        kinds = {}
        for name, q in (("long", long_q), ("late", late)):
            items = []
            while True:
                item = q.get(timeout=60)
                if item is None:
                    break
                items.append(item)
            kinds[name] = [i["kind"] for i in items if "error" in i]
        ok = eng.generate_blocking(list(range(7, 12)), SamplingParams(
            temperature=0.0, max_new_tokens=4))
    finally:
        eng.stop()
    assert kinds["long"] == ["cancelled"]
    assert kinds["late"] == ["deadline"]
    assert len(ok["token_ids"]) == 4
    assert calls and not bool(calls[0].all())
    assert eng.debug_lifecycle_check() == {}
    snap = eng.stats.snapshot()
    assert snap["cancelled_total"] == 1
    assert snap["deadline_expired_total"] == 1
