"""The port's training step (``models/train.py``, the training route of
``models/transformer.py``, ``parallel/{sharding,distributed}.py``)
against the JAX package's, on tiny / tiny-moe:
 * the learning-rate schedule at counts 0-12 bit-equal to optax's
   jitted schedule (what JAX's train step runs); ``_decay_mask`` on the
   same leaves;
 * three AdamW updates from JAX's parameters and gradients (the JAX
   side jitted, as its train step runs it): bf16 parameters and moments
   within 1 bf16 ulp of optax's (measured: equal), f32 leaves within
   1e-6 relative (1e-9 absolute near zero), the count equal; with a
   leaf updated in many small chunks (cut across rows, as every large
   leaf is at 8B) bit-equal to optax;
 * ``loss_fn`` within 2e-3 of JAX's, with a loss mask that differs
   between the dp halves and tiny-moe's aux, on one rank and as the sum
   of the dp x sp parts; its gradients within JAX's own pipeline
   tolerances (rtol 5e-2, atol 5e-3);
 * three steps from JAX's ``init_fn`` state (carried by
   ``state_from_numpy``): losses within 2e-3 of JAX's, the first step
   (lr 0) leaving every parameter bit-equal;
 * JAX's sharded layouts (``test_train_step_sharded`` x2,
   ``test_ring_attn_train_step``) run on spawned gloo ranks: losses
   within 2e-3 and gradient norms within 5e-3 relative of the port's
   single-rank step; each rank's first-step gradients (reduced, before
   the update) against the single-rank gradients cut to that rank,
   element by element within JAX's rtol 5e-2 with an atol of 5e-2 x the
   leaf's largest |g| (at most JAX's 5e-3: these gradients are <= 0.11,
   so an absolute 5e-3 would hold nothing), and each shard's norm of
   the difference within 5e-2 of its norm (measured: the largest |d|
   <= 1.1e-2 of the largest |g|, the norm <= 1.1e-2 of the leaf's; a
   ``gather_replicated`` backward or a ``reduce_scatter`` that hands a
   rank another rank's slice fails it); every shard within 2e-3 of the
   single-rank parameters, every replicated leaf bit-equal across its
   replicas, the losses descending;
 * A29: the ring forward's MoE aux within 1e-5 of JAX's
   ``forward(..., return_aux=True, ring_mesh=...)`` and of the port's
   unsharded aux; a ring forward without the aux makes none of its
   all-reduces;
 * the data loader's batches through a dp = 2 step.
One spawned group at a time (``torch_train_ranks.Groups``), every rank
single-threaded, each group with a timeout."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seldon_tpu.models import get_config
from seldon_tpu.models import train as jtrain
from seldon_tpu.models import transformer as jtf
from seldon_tpu.parallel import MeshPlan, make_mesh
from seldon_tpu_torch.models import convert
from seldon_tpu_torch.models import train as ttrain
from seldon_tpu_torch.models import transformer as ttf
from seldon_tpu_torch.models.config import get_config as tget_config
from seldon_tpu_torch.parallel import mesh as tmesh
from seldon_tpu_torch.parallel import sharding as tshd
from seldon_tpu_torch.parallel.distributed import MeshRanks, RankGroup
from torch_port_helpers import one_intra_op_thread  # noqa: F401
from torch_train_ranks import Groups

B, S = 4, 16
OPT = dict(total_steps=10)
LOSS_ATOL = 2e-3
NORM_RTOL = 5e-3
PARAM_ATOL = 2e-3
GRAD_RTOL, GRAD_ATOL = 5e-2, 5e-3  # JAX's (tests/test_pipeline.py)
# The router's gradient under pp: the pipeline takes the MoE aux per
# microbatch (JAX's schedule), not over the whole batch as the one-rank
# reference does (measured 0.134 of the norm on tiny-moe).
PP_ROUTER_REL = 0.25


@pytest.fixture(scope="module")
def groups():
    g = Groups()
    yield g
    g.close()


def _batch(cfg, seed=1, s=S):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    mask = np.ones((B, s), np.float32)
    mask[: B // 2, :5] = 0.0  # the dp halves differ
    mask[B // 2:, -3:] = 0.0
    return tokens, mask


def _wire(tree):
    """A numpy tree with bf16 leaves as their uint16 bits (what crosses
    to a spawned rank without ml_dtypes)."""
    if isinstance(tree, dict):
        return {k: _wire(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _jax_state(cfg, seed=0):
    """JAX's init_fn state on a one-device mesh, and its numpy tree."""
    init_fn, step_fn = jtrain.make_sharded_train_step(
        make_mesh(MeshPlan()), cfg, jtrain.make_optimizer(**OPT))
    st = init_fn(jax.random.key(seed))
    adam = st.opt_state[1][0]
    tree = {"step": int(st.step), "count": int(adam.count),
            "params": _wire(jax.tree.map(np.asarray, st.params)),
            "mu": _wire(jax.tree.map(np.asarray, adam.mu)),
            "nu": _wire(jax.tree.map(np.asarray, adam.nu))}
    return st, step_fn, tree


class _Solo:
    ranks = RankGroup.solo("cpu")


def _single(cfg, tree, tokens, mask, n_steps=3, seq_sharded=True):
    return ttrain.spmd_steps(_Solo(), {}, cfg, tree, tokens, mask, n_steps,
                             OPT, seq_sharded)


def _f32_ulps(a, b) -> int:
    return abs(int(np.float32(a).view(np.int32))
               - int(np.float32(b).view(np.int32)))


def _ordered(bits: np.ndarray) -> np.ndarray:
    b = bits.view(np.int16).astype(np.int32)
    return np.where(b < 0, -(b & 0x7FFF), b)


@pytest.mark.parametrize("warmup", [0, 1, 3, 100])
def test_schedule_matches_optax(warmup):
    # Jitted, as JAX's train step computes it (XLA folds the divisions by
    # constants into products and fuses multiply-adds: up to 4 f32 ulps
    # from the eager schedule); measured bit-equal.
    want = jax.jit(optax.warmup_cosine_decay_schedule(
        0.0, 3e-4, warmup, max(10, warmup + 1), end_value=3e-5))
    got = ttrain.make_optimizer(warmup=warmup, total_steps=10)
    for count in range(13):
        w = np.float32(want(jnp.int32(count)))
        assert _f32_ulps(got.schedule(count), w) == 0, (count, w)
    if warmup:  # the first update has lr 0
        assert got.schedule(0) == 0.0


@pytest.mark.parametrize("preset", ["tiny", "tiny-moe"])
def test_decay_mask_matches_jax(preset):
    cfg = get_config(preset)
    jmask = jtrain._decay_mask(jtf.init_params(cfg, jax.random.key(0)))
    tparams = ttf.Transformer(tget_config(preset), "meta")
    got = ttrain._decay_mask(tparams)
    for (path, name), v in got.items():
        want = jmask["blocks"][name] if path else jmask[name]
        assert v == bool(want), (path, name)
    assert not got[((0,), "attn_norm")] and got[((), "embed")]


def _leaf(tree, path, name):
    return tree["blocks"][name][path[0]] if path else tree[name]


def _assert_tree_close(got: ttf.Transformer, want, what, bf16_ulps=1):
    want = jax.tree.map(np.asarray, want)
    for path, name, t in tshd.leaves(got):
        w = _leaf(want, path, name)
        if t.dtype == torch.bfloat16:
            ulps = np.abs(_ordered(t.detach().view(torch.int16).numpy())
                          - _ordered(w.view(np.int16)))
            assert ulps.max() <= bf16_ulps, (what, path, name, ulps.max())
        else:
            np.testing.assert_allclose(t.detach().numpy(), w, rtol=1e-6,
                                       atol=1e-9, err_msg=f"{what} {name}")


@pytest.mark.parametrize("preset,warmup,chunk", [
    ("tiny", 100, None), ("tiny-moe", 1, None),
    # Many chunks a leaf, cut across rows (at 8B every large leaf is
    # several chunks): bit-equal to optax.
    ("tiny", 1, 1000), ("tiny-moe", 1, 777)])
def test_optimizer_matches_optax(preset, warmup, chunk, monkeypatch):
    if chunk is not None:
        monkeypatch.setattr(ttrain, "_CHUNK", chunk)
        assert ttf.Transformer(tget_config(preset), "meta").embed.numel() \
            > 10 * chunk
    ulps = 1 if chunk is None else 0
    cfg = get_config(preset)
    tcfg = tget_config(preset)
    params = jtf.init_params(cfg, jax.random.key(0))
    opt = jtrain.make_optimizer(total_steps=10, warmup=warmup)
    ost = opt.init(params)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        tcfg, "cpu")
    topt = ttrain.make_optimizer(total_steps=10, warmup=warmup)
    tstate = topt.init(tparams)
    tokens, mask = _batch(cfg)
    grad_fn = jax.jit(jax.grad(jtrain.loss_fn), static_argnums=3)
    ranks = MeshRanks.single(tmesh.make_mesh(tmesh.MeshPlan(), ["cpu"]),
                             "cpu")
    for _ in range(3):
        grads = grad_fn(params, jnp.asarray(tokens), jnp.asarray(mask), cfg)
        gnorm = jax.jit(optax.global_norm)(grads)
        upd, ost = jax.jit(opt.update)(grads, ost, params)
        params = optax.apply_updates(params, upd)
        gtree = convert.params_from_numpy(jax.tree.map(np.asarray, grads),
                                          tcfg, "cpu")
        tgrads = {(p, n): t.detach() for p, n, t in tshd.leaves(gtree)}
        tnorm = ttrain.global_norm(tgrads, tshd.param_pspecs(tcfg), ranks,
                                   tcfg)
        assert float(tnorm) == float(gnorm)
        topt.update(tparams, tgrads, tstate, tnorm)
        adam = ost[1][0]
        assert tstate.count == int(adam.count) == int(ost[1][2].count)
        _assert_tree_close(tparams, params, "params", ulps)
        _assert_tree_close(tstate.mu, adam.mu, "mu", ulps)
        _assert_tree_close(tstate.nu, adam.nu, "nu", ulps)


@pytest.mark.parametrize("preset", ["tiny", "tiny-moe"])
def test_loss_and_grads_match_jax(preset):
    cfg = get_config(preset)
    params = jtf.init_params(cfg, jax.random.key(2))
    tokens, mask = _batch(cfg)
    jloss, jgrads = jax.value_and_grad(jtrain.loss_fn)(
        params, jnp.asarray(tokens), jnp.asarray(mask), cfg)
    tcfg = tget_config(preset)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        tcfg, "cpu")
    ttrain._trainable(tparams)
    loss = ttrain.loss_fn(tparams, torch.from_numpy(tokens),
                          torch.from_numpy(mask), tcfg)
    assert abs(float(loss.detach()) - float(jloss)) < LOSS_ATOL
    loss.backward()
    jgrads = jax.tree.map(lambda a: np.asarray(a, np.float32), jgrads)
    for path, name, t in tshd.leaves(tparams):
        np.testing.assert_allclose(
            t.grad.float().numpy(), _leaf(jgrads, path, name), rtol=5e-2,
            atol=5e-3, err_msg=f"{path} {name}")


def test_flash_route_carries_the_gradient_on_cpu():
    """On the CPU the flash wrapper runs its plain version, which carries
    the gradient (JAX's reference does the same there)."""
    cfg = tget_config("tiny")
    out = {}
    for impl in ("xla", "flash"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        p = ttf.init_params(c, torch.Generator().manual_seed(0), "cpu")
        ttrain._trainable(p)
        tokens, mask = _batch(c)
        loss = ttrain.loss_fn(p, torch.from_numpy(tokens),
                              torch.from_numpy(mask), c)
        loss.backward()
        out[impl] = (float(loss.detach()), p.blocks[0].wq.grad.float().numpy())
    assert abs(out["xla"][0] - out["flash"][0]) < LOSS_ATOL
    np.testing.assert_allclose(out["flash"][1], out["xla"][1], rtol=5e-2,
                               atol=5e-3)


@pytest.mark.parametrize("preset", ["tiny", "tiny-moe"])
def test_three_steps_follow_jax(preset):
    cfg = get_config(preset)
    st, step_fn, tree = _jax_state(cfg)
    tokens, mask = _batch(cfg)
    jlosses = []
    for _ in range(3):
        st, m = step_fn(st, jnp.asarray(tokens), jnp.asarray(mask))
        jlosses.append(float(m["loss"]))
    tcfg = tget_config(preset)
    _, tstep = ttrain.make_sharded_train_step(
        tmesh.make_mesh(tmesh.MeshPlan(), ["cpu"]), tcfg,
        ttrain.make_optimizer(**OPT), device="cpu")
    state = ttrain.state_from_numpy(tree, tcfg, device="cpu")
    before = ttrain.state_to_numpy(state)["params"]
    losses = []
    for i in range(3):
        state, m = tstep(state, tokens, mask)
        losses.append(m["loss"])
        if i == 0:  # lr(0) = 0: the first update changes nothing
            after = ttrain.state_to_numpy(state)["params"]
            for key, a in before.items():
                np.testing.assert_array_equal(after[key], a, err_msg=key)
    np.testing.assert_allclose(losses, jlosses, atol=LOSS_ATOL)
    assert state.step == 3 and state.opt_state.count == 3
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_rejects_what_it_cannot_train():
    cfg = tget_config("tiny")
    mesh = tmesh.make_mesh(tmesh.MeshPlan(sp=2), ["cpu", "cpu"])
    with pytest.raises(ValueError, match="MeshRanks"):
        ttrain.make_sharded_train_step(mesh, cfg, ttrain.make_optimizer())
    one = tmesh.make_mesh(tmesh.MeshPlan(), ["cpu"])
    from seldon_tpu_torch.models.quantize import quantize_params

    p = quantize_params(ttf.init_params(cfg, torch.Generator().manual_seed(0),
                                        "cpu"))
    with pytest.raises(ValueError, match="int8"):
        ttrain._trainable(p)
    with pytest.raises(ValueError, match="ep > 1"):
        ttrain.make_sharded_train_step(
            tmesh.make_mesh(tmesh.MeshPlan(ep=2), ["cpu"] * 2), cfg,
            ttrain.make_optimizer(), ranks=object())
    init_fn, _ = ttrain.make_sharded_train_step(one, cfg,
                                                ttrain.make_optimizer(),
                                                device="cpu")
    a, b = init_fn(3), init_fn(3)
    for (key, x), y in zip(ttrain.state_to_numpy(a)["params"].items(),
                           ttrain.state_to_numpy(b)["params"].values()):
        np.testing.assert_array_equal(x, y, err_msg=key)


# ---------------------------------------------------------------------------
# Spawned ranks (world 2, then 4, then 8: one group at a time)
# ---------------------------------------------------------------------------


def test_ring_moe_aux_is_the_whole_sequence_statistic(groups):
    """A29: under ring attention the aux is E x sum(frac x mean_prob) of
    the whole sequence (frac and mean_prob averaged over the sp ranks
    before the product), as JAX computes it."""
    cfg = dataclasses.replace(get_config("tiny-moe"), attn_impl="ring")
    params = jtf.init_params(cfg, jax.random.key(0))
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    mesh = make_mesh(MeshPlan(sp=2))
    _, jaux = jax.jit(lambda p, t: jtf.forward(
        p, t, cfg, return_aux=True, ring_mesh=mesh))(params, tokens)
    tcfg = dataclasses.replace(tget_config("tiny-moe"), attn_impl="ring")
    tree = _wire(jax.tree.map(np.asarray, params))
    outs = groups.get(2).spmd("torch_train_ranks:ring_aux", tcfg, tree,
                              tokens)
    for o in outs:
        assert abs(o["aux"] - float(jaux["moe_lb_loss"])) < 1e-5
        # The statistic's all-reduces (two a layer) are made only when
        # the aux is asked for; the logits do not depend on it.
        assert o["gathers_aux"] == o["gathers_plain"] + 2 * cfg.n_layers
        np.testing.assert_array_equal(o["plain"], o["logits"])
    assert outs[0]["aux"] == outs[1]["aux"]
    # On the same hidden states, the blocks' statistic averaged over the
    # ring before the product is the unsharded statistic.
    plain = convert.params_from_numpy(tree, tcfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 32, tcfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        _, whole = ttf.moe_block(x, plain.blocks[0], tcfg)
    parts = groups.get(2).spmd("torch_train_ranks:moe_aux_block", tcfg, tree,
                               x.view(torch.int16).numpy())
    for p in parts:
        assert abs(p - float(whole)) < 1e-5


def test_data_loader_feeds_dp2_step(groups, tmp_path):
    from seldon_tpu_torch.data import write_token_shard

    rng = np.random.default_rng(0)
    shards = [write_token_shard(str(tmp_path / "a.bin"),
                                rng.integers(0, 250, size=5000)),
              write_token_shard(str(tmp_path / "b.bin"),
                                rng.integers(0, 250, size=3000))]
    cfg = tget_config("tiny")
    _, _, tree = _jax_state(get_config("tiny"))
    outs = groups.get(2).spmd("torch_train_ranks:loader_steps", cfg,
                              tree["params"], shards, 2)
    assert all(np.isfinite(o).all() for o in outs)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("preset", ["tiny", "tiny-moe"])
def test_loss_parts_sum_to_the_loss(groups, preset):
    """dp = 2 x sp = 2: each rank's part of loss_fn (its rows, its block
    of the sequence, the aux's share) sums to JAX's loss."""
    cfg = get_config(preset)
    params = jtf.init_params(cfg, jax.random.key(2))
    tokens, mask = _batch(cfg)
    jloss = jtrain.loss_fn(params, jnp.asarray(tokens), jnp.asarray(mask),
                           cfg)
    tree = _wire(jax.tree.map(np.asarray, params))
    outs = groups.get(4).spmd("torch_train_ranks:loss_part",
                              dict(dp=2, sp=2), tget_config(preset), tree,
                              tokens, mask)
    assert abs(sum(o["part"] for o in outs) - float(jloss)) < LOSS_ATOL
    assert len({o["total"] for o in outs}) == 1
    assert abs(outs[0]["total"] - float(jloss)) < LOSS_ATOL


def _spec_axes(spec):
    return {a for part in spec if part is not None
            for a in ((part,) if isinstance(part, str) else part)}


def check_grads(got, want, what, rel=GRAD_RTOL):
    """A rank's gradient shard against the one-rank gradient cut to it
    (module docstring)."""
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=min(GRAD_ATOL, rel * scale),
                               err_msg=what)
    err = np.linalg.norm(got - want)
    assert err <= rel * np.linalg.norm(want), (what, err)


def check_layout(outs, ref, specs, what, loss_atol=LOSS_ATOL,
                 norm_rtol=NORM_RTOL, grad_rtol=GRAD_RTOL,
                 param_atol=PARAM_ATOL):
    """Every rank against the single-rank run ``ref``: losses, norms,
    its shard of the first step's gradients and of the final
    parameters; replicas bit-equal. The tolerances default to bf16's."""
    for o in outs:
        np.testing.assert_allclose(o["losses"], ref["losses"],
                                   atol=loss_atol, err_msg=what)
        np.testing.assert_allclose(o["grad_norms"], ref["grad_norms"],
                                   rtol=norm_rtol, err_msg=what)
        assert all(np.isfinite(o["losses"]))
        assert o["losses"][-1] < o["losses"][0], what
    assert len({tuple(o["losses"]) for o in outs}) == 1
    sizes = {a: 1 + max(o["coord"][a] for o in outs) for a in tmesh.AXES}
    for o in outs:
        assert o["grads"].keys() == o["params"].keys()
        for key, mine in o["grads"].items():
            spec = tshd.leaf_spec(specs, *key)
            want = tshd.cut(torch.from_numpy(ref["grads"][key]),
                            spec[1:] if key[0] else spec, o["coord"],
                            sizes).numpy()
            router_pp = key[1] == "router" and sizes["pp"] > 1
            check_grads(mine, want, f"{what} {o['coord']} grad {key}",
                        PP_ROUTER_REL if router_pp else grad_rtol)
    for kind in ("params", "mu", "nu"):
        for key in outs[0][kind]:
            spec = tshd.leaf_spec(specs, *key)
            cut_spec = spec[1:] if key[0] else spec
            held = {}
            for o in outs:
                if key not in o[kind]:
                    continue  # another stage's layer
                mine = o[kind][key]
                tag = tuple(o["coord"][a] for a in sorted(_spec_axes(spec)))
                if tag in held:  # a replica: bit-equal
                    np.testing.assert_array_equal(
                        mine, held[tag], err_msg=f"{what} {kind} {key}")
                held[tag] = mine
                if kind != "params":
                    continue
                whole = torch.from_numpy(ref[kind][key])
                want = tshd.cut(whole, cut_spec, o["coord"], sizes).numpy()
                if mine.dtype == np.int16:
                    mine = torch.from_numpy(mine).view(
                        torch.bfloat16).float().numpy()
                    want = torch.from_numpy(want).view(
                        torch.bfloat16).float().numpy()
                np.testing.assert_allclose(mine, want, atol=param_atol,
                                           err_msg=f"{what} {key}")


LAYOUTS = [
    # (preset, plan, attn_impl, world): JAX's test_train_step_sharded x2
    # and test_ring_attn_train_step.
    ("tiny-moe", dict(tp=2, ep=2), "xla", 4),
    ("tiny", dict(dp=2, tp=2, sp=2), "xla", 8),
    ("tiny", dict(dp=2, sp=2, tp=2), "ring", 8),
]


# float32 layouts: sums in other orders only (rank-order collectives,
# the ring's blocks), held far tighter than bf16's.
F32_LAYOUT = dict(loss_atol=1e-5, norm_rtol=1e-5, grad_rtol=1e-4,
                  param_atol=2e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("preset,plan,impl,world", LAYOUTS,
                         ids=["tp2-ep2-moe", "dp2-tp2-sp2", "ring-dp2-sp2-tp2"])
def test_sharded_layout_matches_single_rank(groups, preset, plan, impl,
                                            world, dtype):
    jcfg = dataclasses.replace(get_config(preset), attn_impl=impl,
                               dtype=dtype)
    _, _, tree = _jax_state(jcfg)
    cfg = dataclasses.replace(tget_config(preset), attn_impl=impl,
                              dtype=dtype)
    tokens, mask = _batch(cfg, s=32 if impl == "ring" else S)
    ref = _single(dataclasses.replace(cfg, attn_impl="xla"), tree, tokens,
                  mask)
    outs = groups.get(world).spmd("seldon_tpu_torch.models.train:spmd_steps",
                                  plan, cfg, tree, tokens, mask, 3, OPT)
    check_layout(outs, ref, tshd.param_pspecs(cfg), f"{dtype} {plan}",
                 **(F32_LAYOUT if dtype == "float32" else {}))
