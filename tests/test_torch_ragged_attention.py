"""seldon_tpu_torch.models.ragged_attention against the JAX package.

A mixed wave — row 0 a cold prefill that completes its prompt, row 1 a
chunk continuation, row 2 mid-decode, row 3 idle — through JAX's
``ragged_wave`` (the masked leg, the reference's bit-exact oracle) and
the port's ``ragged_wave`` on its masked, sparse, reference and kernel
legs (on the CPU the kernel leg runs the kernel's plain version). Greedy
``first`` / ``toks`` must be equal except at a near-tie: a position
whose top-2 logit gap in the JAX leg is below RAGGED_LOGITS_ATOL is
reported, not hidden. Raw logits stay within RAGGED_LOGITS_ATOL. The
sparse leg's greedy tokens equal the port's masked leg's bit for bit,
wave after wave, as tests/test_ragged_kernel.py pins for the JAX twin."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_tpu.models import ragged_attention as jra
from seldon_tpu.models import transformer as jtf
from seldon_tpu.models.config import PRESETS
from seldon_tpu_torch.models import ragged_attention as tra
from seldon_tpu_torch.models.config import PRESETS as TPRESETS
from seldon_tpu_torch.ops.ragged_paged_attention import RAGGED_LOGITS_ATOL
from tests.torch_port_helpers import f32, params_pair, to_torch

BLOCK, NBS, B, SC = 8, 16, 4, 8
SMAX = BLOCK * NBS


def _cfgs(kv_dtype):
    return (dataclasses.replace(PRESETS["tiny"], kv_cache_dtype=kv_dtype),
            dataclasses.replace(TPRESETS["tiny"], kv_cache_dtype=kv_dtype))


def _seed_row(cfg, params, pool, table, row, n, seed):
    """Prefill n tokens through the JAX dense path and scatter the KV into
    the row's pool blocks; returns (pool, greedy next token)."""
    tks = jnp.asarray(np.random.default_rng(seed).integers(
        2, cfg.vocab_size, size=(1, n)), jnp.int32)
    cache = jtf.init_cache(cfg, 1, SMAX)
    logits, cache = jtf.prefill(params, tks, jnp.asarray([n], jnp.int32),
                                cache, cfg)
    wr = {k: cache[k][:, 0:1, :, :n] for k in cache}
    pool = jtf.paged_scatter_tokens(pool, wr, table[row:row + 1],
                                    jnp.arange(n)[None, :])
    return pool, int(jnp.argmax(logits[0]))


@pytest.fixture(scope="module", params=["bf16", "int8"])
def wave(request):
    cfg_j, cfg_t = _cfgs(request.param)
    jp, tp = params_pair(cfg_j, seed=0)
    pool = jtf.init_paged_cache(cfg_j, B * NBS + 1, BLOCK)
    table = jnp.asarray(np.stack(
        [1 + i * NBS + np.arange(NBS) for i in range(B)]).astype(np.int32))
    rng = np.random.default_rng(7)
    toks = jnp.asarray(rng.integers(2, cfg_j.vocab_size, size=(B * SC,)),
                       jnp.int32)
    pool, _ = _seed_row(cfg_j, jp, pool, table, 1, 8, 101)
    pool, last2 = _seed_row(cfg_j, jp, pool, table, 2, 37, 202)
    state = {
        "cache": pool,
        "last_tok": jnp.asarray([0, 0, last2, 0], jnp.int32),
        "pos": jnp.asarray([0, 0, 37, 0], jnp.int32),
        "active": jnp.asarray([False, False, True, False]),
        "temp": jnp.zeros((B,), jnp.float32),
        "top_k": jnp.zeros((B,), jnp.int32),
        "top_p": jnp.ones((B,), jnp.float32),
        "seeds": jnp.asarray([11, 22, 33, 44], jnp.uint32),
        "remaining": jnp.asarray([0, 0, 3, 0], jnp.int32),
    }
    args = dict(
        tokens=toks,
        plens=jnp.asarray([6, 20, 0, 0], jnp.int32),
        starts=jnp.asarray([0, 8, SMAX, SMAX], jnp.int32),
        seeds=state["seeds"], temps=state["temp"], top_ks=state["top_k"],
        top_ps=state["top_p"],
        max_news=jnp.asarray([5, 5, 5, 5], jnp.int32),
        finals=jnp.asarray([True, False, False, False]),
        is_prefill=jnp.asarray([True, True, False, False]),
    )
    st2, first, fdone, wtoks, valid = jra.ragged_wave(
        jp, state, table, *args.values(), cfg_j, kernel="masked")
    want = dict(first=np.asarray(first), fdone=np.asarray(fdone),
                toks=np.asarray(wtoks), valid=np.asarray(valid),
                pos=np.asarray(st2["pos"]),
                active=np.asarray(st2["active"]),
                pool={k: np.asarray(v, np.float32)
                      for k, v in st2["cache"].items()})
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, jp=jp, tp=tp, state=state,
                table=table, args=args, want=want)


def _torch_state(state):
    st = {k: to_torch(v) for k, v in state.items() if k != "cache"}
    st["seeds"] = st["seeds"].to(torch.int64)
    st["cache"] = {k: to_torch(v) for k, v in state["cache"].items()}
    return st


def _torch_args(args):
    out = {k: to_torch(v) for k, v in args.items()}
    out["seeds"] = out["seeds"].to(torch.int64)
    return out


def _gap(logits_row):
    top2 = np.sort(np.asarray(logits_row, np.float32))[-2:]
    return float(top2[1] - top2[0])


def _assert_tokens(got, want, ref_logits, what):
    """Equal tokens, or a reported near-tie of the reference."""
    for i in np.nonzero(np.asarray(got) != np.asarray(want))[0]:
        gap = _gap(ref_logits[i])
        assert gap < RAGGED_LOGITS_ATOL, (what, i, got[i], want[i], gap)
        print(f"near-tie reported: {what} row {i} gap {gap:.3g}")


@pytest.mark.parametrize("kernel", ["masked", "reference", "pallas",
                                    "sparse"])
def test_wave_matches_jax(wave, kernel):
    w = wave
    st = _torch_state(w["state"])
    a = _torch_args(w["args"])
    has_prefill = bool(np.asarray(w["args"]["is_prefill"]).any())
    st2, first, fdone, toks, valid = tra.ragged_wave(
        w["tp"], st, to_torch(w["table"]), *a.values(), w["cfg_t"],
        kernel=kernel, has_prefill=has_prefill)
    want = w["want"]
    # The reference's own logits decide what counts as a near-tie.
    view = jtf.paged_prefix_view(w["state"]["cache"], w["table"], NBS)
    toks2 = w["args"]["tokens"].reshape(B, SC)
    pf_logits, _ = jtf.prefill_with_prefix(
        w["jp"], toks2, w["args"]["plens"], view, w["args"]["starts"],
        w["cfg_j"])
    dec_logits, _ = jtf.paged_decode_step(
        w["jp"], w["state"]["last_tok"], w["state"]["pos"],
        w["state"]["cache"], w["table"], w["cfg_j"])
    live_pf = slice(0, 2)
    _assert_tokens(first.numpy()[live_pf], want["first"][live_pf],
                   np.asarray(pf_logits)[live_pf], "first")
    np.testing.assert_array_equal(valid.numpy(), want["valid"])
    live = want["valid"][0]
    _assert_tokens(toks.numpy()[0][live], want["toks"][0][live],
                   np.asarray(dec_logits)[live], "decode")
    np.testing.assert_array_equal(st2["pos"].numpy(), want["pos"])
    np.testing.assert_array_equal(st2["active"].numpy(), want["active"])
    np.testing.assert_array_equal(fdone.numpy()[live_pf],
                                  want["fdone"][live_pf])
    # KV each row holds after the wave: positions t < pos. (Rows that do
    # not run write garbage at their frozen pos, which the legs compute
    # differently and the next chunk overwrites; block 0 is the trash.)
    tbl = np.asarray(w["table"])
    for row, n in enumerate(want["pos"]):
        blocks, offs = tbl[row, np.arange(n) // BLOCK], np.arange(n) % BLOCK
        for key, arr in want["pool"].items():
            g = f32(st2["cache"][key])[:, blocks, :, offs]
            r = arr[:, blocks, :, offs]
            if key in ("k", "v") and w["cfg_j"].kv_cache_dtype == "int8":
                assert np.abs(g - r).max(initial=0) <= 1
            else:
                np.testing.assert_allclose(g, r, rtol=2.0 ** -7, atol=1e-2)


@pytest.mark.parametrize("leg", ["prefill", "decode"])
def test_kernel_leg_logits_within_atol(wave, leg):
    """Raw-logit pin of the kernel leg against the JAX masked leg."""
    w = wave
    st = _torch_state(w["state"])
    a = _torch_args(w["args"])
    tt = to_torch(w["table"])
    if leg == "prefill":
        view = jtf.paged_prefix_view(w["state"]["cache"], w["table"], NBS)
        want, _ = jtf.prefill_with_prefix(
            w["jp"], w["args"]["tokens"].reshape(B, SC), w["args"]["plens"],
            view, w["args"]["starts"], w["cfg_j"])
        bound = torch.where(a["is_prefill"], a["starts"], 0).int()
        got, _ = tra._prefill_logits_sparse(
            w["tp"], a["tokens"].reshape(B, SC), a["plens"], a["starts"],
            bound, st["cache"], tt, w["cfg_t"], "pallas")
        live = np.asarray(w["args"]["is_prefill"])
    else:
        want, _ = jtf.paged_decode_step(
            w["jp"], w["state"]["last_tok"], w["state"]["pos"],
            w["state"]["cache"], w["table"], w["cfg_j"])
        bound = torch.where(st["active"], st["pos"], 0).int()
        got, _ = tra._decode_step_sparse(
            w["tp"], st["last_tok"], st["pos"], bound, st["cache"], tt,
            w["cfg_t"], "pallas")
        live = np.asarray(w["state"]["active"])
    err = np.abs(f32(got)[live] - np.asarray(want)[live]).max()
    assert err <= RAGGED_LOGITS_ATOL, err


def test_decode_only_wave_skips_prefill_leg(wave):
    """has_prefill=False on the kernel leg runs no prefill at all; the
    decode result equals the masked leg's (which always runs it)."""
    w = wave
    a = _torch_args(w["args"])
    a.update(plens=torch.zeros(B, dtype=torch.int32),
             starts=torch.full((B,), SMAX, dtype=torch.int32),
             finals=torch.zeros(B, dtype=torch.bool),
             is_prefill=torch.zeros(B, dtype=torch.bool))
    out = {}
    for kernel in ("masked", "pallas"):
        st2, first, fdone, toks, valid = tra.ragged_wave(
            w["tp"], _torch_state(w["state"]), to_torch(w["table"]),
            *a.values(), w["cfg_t"], kernel=kernel, has_prefill=False)
        out[kernel] = (toks.numpy(), st2["pos"].numpy())
    np.testing.assert_array_equal(out["masked"][0], out["pallas"][0])
    np.testing.assert_array_equal(out["masked"][1], out["pallas"][1])


def test_block_budget_sends_long_waves_to_the_masked_head(wave):
    """CPU only: the port carries the JAX budget there (on the card the
    kernel leg refuses it, see the next test)."""
    w = wave
    runs = {}
    for budget in (0, 1):
        st2, first, _, toks, _ = tra.ragged_wave(
            w["tp"], _torch_state(w["state"]), to_torch(w["table"]),
            *_torch_args(w["args"]).values(), w["cfg_t"], kernel="pallas",
            block_budget=budget, has_prefill=True)
        runs[budget] = (first.numpy()[:2], toks.numpy())
    st2, first, _, toks, _ = tra.ragged_wave(
        w["tp"], _torch_state(w["state"]), to_torch(w["table"]),
        *_torch_args(w["args"]).values(), w["cfg_t"], kernel="masked")
    np.testing.assert_array_equal(runs[1][0], first.numpy()[:2])
    np.testing.assert_array_equal(runs[1][1], toks.numpy())


@pytest.mark.parametrize("kernel,budget,device,refused", [
    ("pallas", 1, "cuda", True),
    ("reference", 4, "cuda", True),
    ("pallas", 0, "cuda", False),
    ("masked", 1, "cuda", False),
    ("pallas", 1, "cpu", False),
    ("sparse", 1, "cuda", False),
    ("sparse", 2, "cpu", False),
])
def test_block_budget_is_refused_on_the_card(kernel, budget, device,
                                             refused):
    dev = torch.device(device)  # naming a CUDA device needs no card
    if refused:
        with pytest.raises(NotImplementedError, match="B1"):
            tra.check_block_budget(kernel, budget, dev)
    else:
        tra.check_block_budget(kernel, budget, dev)


def _run(w, kernel, state=None, args=None, **kw):
    a = args if args is not None else _torch_args(w["args"])
    st2, first, fdone, toks, valid = tra.ragged_wave(
        w["tp"], state if state is not None else _torch_state(w["state"]),
        to_torch(w["table"]), *a.values(), w["cfg_t"], kernel=kernel, **kw)
    return st2, first, fdone, toks, valid


def test_sparse_wave_greedy_tokens_equal_the_masked_leg(wave):
    """The mixed wave, then decode-only waves until every row stops, on
    the masked and sparse legs: the same greedy tokens, positions and
    activity after every wave (bf16 and int8 pools, by the fixture)."""
    w = wave
    idle = dict(_torch_args(w["args"]),
                plens=torch.zeros(B, dtype=torch.int32),
                starts=torch.full((B,), SMAX, dtype=torch.int32),
                finals=torch.zeros(B, dtype=torch.bool),
                is_prefill=torch.zeros(B, dtype=torch.bool))
    states = {}
    for kernel in ("masked", "sparse"):
        st, first, fdone, toks, valid = _run(w, kernel)
        trail = [(first.numpy()[:2].tolist(), toks.numpy().tolist(),
                  valid.numpy().tolist())]
        for _ in range(4):
            st, _, _, toks, valid = _run(w, kernel, state=st, args=idle,
                                         has_prefill=False)
            trail.append((toks.numpy().tolist(), valid.numpy().tolist(),
                          st["pos"].tolist(), st["active"].tolist()))
        states[kernel] = trail
    assert states["sparse"] == states["masked"]
    assert any(v for step in states["masked"][1:] for v in step[1][0])


@pytest.mark.parametrize("leg", ["prefill", "decode"])
def test_sparse_leg_logits_within_atol(wave, leg):
    """Raw logits of the sparse leg against the JAX masked leg (within
    RAGGED_LOGITS_ATOL) and the JAX sparse leg (its twin: f32 sums in
    another order)."""
    w = wave
    st = _torch_state(w["state"])
    a = _torch_args(w["args"])
    tt = to_torch(w["table"])
    jst, jargs = w["state"], w["args"]
    if leg == "prefill":
        toks2 = jargs["tokens"].reshape(B, SC)
        jbound = jnp.where(jargs["is_prefill"], jargs["starts"],
                           0).astype(jnp.int32)
        view = jtf.paged_prefix_view(jst["cache"], w["table"], NBS)
        want, _ = jtf.prefill_with_prefix(
            w["jp"], toks2, jargs["plens"], view, jargs["starts"],
            w["cfg_j"])
        twin, _ = jra._prefill_logits_sparse(
            w["jp"], toks2, jargs["plens"], jargs["starts"], jbound,
            jst["cache"], w["table"], w["cfg_j"], "sparse")
        bound = torch.where(a["is_prefill"], a["starts"], 0).int()
        got, _ = tra._prefill_logits_sparse(
            w["tp"], a["tokens"].reshape(B, SC), a["plens"], a["starts"],
            bound, st["cache"], tt, w["cfg_t"], "sparse")
        live = np.asarray(jargs["is_prefill"])
    else:
        want, _ = jtf.paged_decode_step(
            w["jp"], jst["last_tok"], jst["pos"], jst["cache"], w["table"],
            w["cfg_j"])
        jbound = jnp.where(jst["active"], jst["pos"], 0).astype(jnp.int32)
        twin, _ = jra._decode_step_sparse(
            w["jp"], jst["last_tok"], jst["pos"], jbound, jst["cache"],
            w["table"], w["cfg_j"], "sparse")
        bound = torch.where(st["active"], st["pos"], 0).int()
        got, _ = tra._decode_step_sparse(
            w["tp"], st["last_tok"], st["pos"], bound, st["cache"], tt,
            w["cfg_t"], "sparse")
        live = np.asarray(jst["active"])
    for ref in (want, twin):
        err = np.abs(f32(got)[live] - np.asarray(ref)[live]).max()
        assert err <= RAGGED_LOGITS_ATOL, err


def test_sparse_leg_honours_a_block_budget(wave, monkeypatch):
    """block_budget=1: the prefill leg's walk (1 block) stays sparse, the
    decode leg's (5 blocks) goes to the masked head, as the JAX wave's
    ``lax.cond`` decides, on the host's count as on the device's; the
    tokens are the masked leg's."""
    w = wave
    m = _run(w, "masked")
    heads = []
    for name in ("prefill_with_prefix", "paged_decode_step"):
        orig = getattr(tra.transformer, name)

        def counted(*args, _orig=orig, _name=name, **kw):
            heads.append(_name)
            return _orig(*args, **kw)

        monkeypatch.setattr(tra.transformer, name, counted)
    for live_blocks in (None, (1, 5)):
        heads.clear()
        s = _run(w, "sparse", block_budget=1, has_prefill=True,
                 live_blocks=live_blocks)
        assert heads == ["paged_decode_step"]
        np.testing.assert_array_equal(s[1].numpy()[:2], m[1].numpy()[:2])
        np.testing.assert_array_equal(s[3].numpy(), m[3].numpy())
        np.testing.assert_array_equal(s[0]["pos"].numpy(),
                                      m[0]["pos"].numpy())
    heads.clear()
    s = _run(w, "sparse", block_budget=NBS, has_prefill=True)
    assert heads == []
    np.testing.assert_array_equal(s[3].numpy(), m[3].numpy())


def test_unknown_leg_is_refused(wave):
    with pytest.raises(ValueError, match="unknown ragged kernel"):
        _run(wave, "flash")
