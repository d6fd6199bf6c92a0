"""float32 training (``ModelConfig.dtype = "float32"``) in the port against
the JAX package's f32 train step, on tiny / tiny-moe, with JAX's weights,
moments and gradients carried across bit for bit.

XLA on the CPU computes optax's jitted f32 update with each ``a * b + c``
of the chain as one fused multiply-add, the divisions by constants as
products with their reciprocals, and ``mu / bc1 / (sqrt(nu / bc2) +
eps)`` as one division; the port computes the same operations
(``train._adamw_chunk``, ``AdamW.schedule``). Tolerances:
 * ``train._fma`` against XLA's contracted ``a * b + c``: bit-equal;
 * three AdamW updates (counts 1-3) from JAX's parameters, gradients and
   gradient norm, against JAX's jitted update and apply: parameters,
   ``mu`` and ``nu`` bit-equal, whole leaves or cut into many chunks;
   the port's own global norm of the same gradients within NORM_ULPS
   f32 ulps of ``optax.global_norm`` (measured: at most 4; XLA's tree
   reduction sums in another order);
 * from count 4 on the bias corrections ``1 - b ** count`` may differ by
   one f32 ulp (XLA's f32 power is not the correctly rounded one: 0.9 **
   4 is one ulp away), so later updates are held to the step tolerances;
 * ``loss_fn`` within LOSS_RTOL (1e-5) relative of ``jax.value_and_grad
   (loss_fn)``, every gradient leaf within GRAD_RTOL (1e-5) of its norm,
   the global norm within NORM_RTOL (1e-5) relative (measured: 1.7e-7,
   4.7e-7 and 1.8e-7);
 * three steps against JAX's ``make_sharded_train_step`` on a one-device
   mesh: the first (lr 0) leaving every parameter's bits, losses and
   gradient norms within LOSS_RTOL / NORM_RTOL relative (measured:
   8.6e-8, 1.2e-7), parameters within PARAM_ATOL (2e-5: a near-zero
   gradient whose sign differs moves its element by 2 lr a step, and the
   learning rates of counts 2 and 3 sum to 9e-6; measured 2.2e-8);
 * a carried f32 state (parameters, ``mu``, ``nu``) crosses bit for bit
   as f32, with no bf16 view;
 * every two-rank layout of the card's phase (dp, tp, sp under "ring"
   and "xla", ep, pp) on spawned gloo ranks against one rank, with
   replicas bit-equal (``test_torch_train.check_layout`` at F32_LAYOUT).
One spawned group at a time, every rank single-threaded."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seldon_tpu.models import train as jtrain
from seldon_tpu.models import transformer as jtf
from seldon_tpu.models.config import PRESETS
from seldon_tpu.parallel import MeshPlan, make_mesh
from seldon_tpu_torch.models import convert
from seldon_tpu_torch.models import train as ttrain
from seldon_tpu_torch.models.config import ModelConfig as TModelConfig
from seldon_tpu_torch.parallel import mesh as tmesh
from seldon_tpu_torch.parallel import pipeline as tpipe
from seldon_tpu_torch.parallel import sharding as tshd
from seldon_tpu_torch.parallel.distributed import MeshRanks
from test_torch_train import (F32_LAYOUT, OPT, _batch, _single, _wire,
                              check_layout)
from torch_port_helpers import one_intra_op_thread  # noqa: F401
from torch_train_ranks import Groups

NORM_ULPS = 8
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
NORM_RTOL = 1e-5
PARAM_ATOL = 2e-5
# (preset, plan, attn_impl) of the two-rank layouts (chip_smoke
# TRAIN_LAYOUTS).
TWO_RANK = [("tiny", dict(dp=2), "xla"), ("tiny", dict(tp=2), "xla"),
            ("tiny", dict(sp=2), "ring"), ("tiny", dict(sp=2), "xla"),
            ("tiny-moe", dict(ep=2), "xla"), ("tiny", dict(pp=2), "xla")]


@pytest.fixture(scope="module")
def groups():
    g = Groups()
    yield g
    g.close()


def _cfgs(preset, **kw):
    """(JAX config, the port's config), float32, with the same fields."""
    jcfg = dataclasses.replace(PRESETS[preset], dtype="float32", **kw)
    return jcfg, TModelConfig(**dataclasses.asdict(jcfg))


def _ordered(a) -> np.ndarray:
    """f32 bits as integers ordered like the values (ulp distances)."""
    b = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.where(b < 0, -(b & 0x7FFFFFFF), b)


def _ulps(a, b) -> int:
    return int(np.abs(_ordered(a) - _ordered(b)).max())


def _leaf(tree, path, name):
    return tree["blocks"][name][path[0]] if path else tree[name]


def _assert_tree_bits(got, want, what):
    want = jax.tree.map(np.asarray, want)
    for path, name, t in tshd.leaves(got):
        assert t.dtype == torch.float32, (what, path, name)
        np.testing.assert_array_equal(
            t.detach().numpy(), _leaf(want, path, name),
            err_msg=f"{what} {path} {name}")


def test_fma_matches_xla():
    """``a * b + c`` as XLA on the CPU computes it (one rounding), with
    products that land on and next to f32 ties."""
    rng = np.random.default_rng(0)
    n = 1 << 16
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    c = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    # Small integers: the exact product plus c sits on a tie of the sum.
    a[:4096] = rng.integers(1, 1 << 12, 4096).astype(np.float32)
    b[:4096] = rng.integers(1, 1 << 12, 4096).astype(np.float32)
    c[:4096] = np.ldexp(rng.integers(1, 8, 4096), 1).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    got = ttrain._fma(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, want)
    # The chain's scalar form: a Python number times a tensor.
    want = np.asarray(jax.jit(lambda b, c: np.float32(0.05) * b + c)(b, c))
    got = ttrain._fma(float(np.float32(0.05)), torch.from_numpy(b),
                      torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("preset,warmup,chunk", [
    ("tiny", 100, None), ("tiny-moe", 1, None), ("tiny", 1, 1000),
    ("tiny-moe", 1, 777)])
def test_f32_optimizer_matches_optax(preset, warmup, chunk, monkeypatch):
    if chunk is not None:
        monkeypatch.setattr(ttrain, "_CHUNK", chunk)
    jcfg, tcfg = _cfgs(preset)
    params = jtf.init_params(jcfg, jax.random.key(0))
    opt = jtrain.make_optimizer(total_steps=10, warmup=warmup)
    ost = opt.init(params)

    def update_apply(g, s, p):  # as the train step runs it: one jit
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s

    update_apply = jax.jit(update_apply)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        tcfg, "cpu")
    topt = ttrain.make_optimizer(total_steps=10, warmup=warmup)
    tstate = topt.init(tparams)
    tokens, mask = _batch(jcfg)
    grad_fn = jax.jit(jax.grad(jtrain.loss_fn), static_argnums=3)
    ranks = MeshRanks.single(tmesh.make_mesh(tmesh.MeshPlan(), ["cpu"]),
                             "cpu")
    for _ in range(3):
        grads = grad_fn(params, jnp.asarray(tokens), jnp.asarray(mask), jcfg)
        gnorm = jax.jit(optax.global_norm)(grads)
        params, ost = update_apply(grads, ost, params)
        gtree = convert.params_from_numpy(jax.tree.map(np.asarray, grads),
                                          tcfg, "cpu")
        tgrads = {(p, n): t.detach() for p, n, t in tshd.leaves(gtree)}
        tnorm = ttrain.global_norm(tgrads, tshd.param_pspecs(tcfg), ranks,
                                   tcfg)
        assert _ulps(float(tnorm), float(gnorm)) <= NORM_ULPS
        topt.update(tparams, tgrads, tstate,
                    torch.tensor(float(np.float32(gnorm))))
        adam = ost[1][0]
        assert tstate.count == int(adam.count)
        _assert_tree_bits(tparams, params, "params")
        _assert_tree_bits(tstate.mu, adam.mu, "mu")
        _assert_tree_bits(tstate.nu, adam.nu, "nu")


@pytest.mark.parametrize("preset", ["tiny", "tiny-moe"])
def test_f32_loss_and_grads_match_jax(preset):
    jcfg, tcfg = _cfgs(preset)
    params = jtf.init_params(jcfg, jax.random.key(2))
    tokens, mask = _batch(jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jtrain.loss_fn),
                            static_argnums=3)(
        params, jnp.asarray(tokens), jnp.asarray(mask), jcfg)
    jnorm = float(jax.jit(optax.global_norm)(jgrads))
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        tcfg, "cpu")
    ttrain._trainable(tparams)
    loss = ttrain.loss_fn(tparams, torch.from_numpy(tokens),
                          torch.from_numpy(mask), tcfg)
    assert loss.dtype == torch.float32
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_RTOL * abs(
        float(jloss))
    loss.backward()
    jgrads = jax.tree.map(np.asarray, jgrads)
    sq = 0.0
    for path, name, t in tshd.leaves(tparams):
        g, w = t.grad.numpy(), _leaf(jgrads, path, name)
        assert t.grad.dtype == torch.float32
        assert np.linalg.norm(g - w) <= GRAD_RTOL * np.linalg.norm(w), \
            (path, name)
        sq += float(np.sum(g.astype(np.float64) ** 2))
    assert abs(np.sqrt(sq) - jnorm) <= NORM_RTOL * jnorm


def _jax_state(jcfg, seed=0):
    """JAX's f32 init_fn state on a one-device mesh, its step and its
    numpy tree."""
    init_fn, step_fn = jtrain.make_sharded_train_step(
        make_mesh(MeshPlan()), jcfg, jtrain.make_optimizer(**OPT))
    st = init_fn(jax.random.key(seed))
    adam = st.opt_state[1][0]
    tree = {"step": int(st.step), "count": int(adam.count),
            "params": _wire(jax.tree.map(np.asarray, st.params)),
            "mu": _wire(jax.tree.map(np.asarray, adam.mu)),
            "nu": _wire(jax.tree.map(np.asarray, adam.nu))}
    return st, step_fn, tree


@pytest.mark.parametrize("preset", ["tiny", "tiny-moe"])
def test_f32_state_crosses_bit_for_bit(preset):
    jcfg, tcfg = _cfgs(preset)
    st, _, tree = _jax_state(jcfg)
    assert all(a.dtype == np.float32
               for a in jax.tree_util.tree_leaves(tree["params"]))
    state = ttrain.state_from_numpy(tree, tcfg, device="cpu")
    back = ttrain.state_tree(state)
    for kind in ("params", "mu", "nu"):
        for got, want in zip(jax.tree_util.tree_leaves(back[kind]),
                             jax.tree_util.tree_leaves(tree[kind])):
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    rank = ttrain.state_to_numpy(state)
    assert all(a.dtype == np.float32 for kind in ("params", "mu", "nu")
               for a in rank[kind].values())


@pytest.mark.parametrize("preset", ["tiny", "tiny-moe"])
def test_f32_three_steps_follow_jax(preset):
    jcfg, tcfg = _cfgs(preset)
    st, step_fn, tree = _jax_state(jcfg)
    tokens, mask = _batch(jcfg)
    jlosses, jnorms = [], []
    for _ in range(3):
        st, m = step_fn(st, jnp.asarray(tokens), jnp.asarray(mask))
        jlosses.append(float(m["loss"]))
        jnorms.append(float(m["grad_norm"]))
    _, tstep = ttrain.make_sharded_train_step(
        tmesh.make_mesh(tmesh.MeshPlan(), ["cpu"]), tcfg,
        ttrain.make_optimizer(**OPT), device="cpu")
    state = ttrain.state_from_numpy(tree, tcfg, device="cpu")
    before = ttrain.state_to_numpy(state)["params"]
    losses, norms = [], []
    for i in range(3):
        state, m = tstep(state, tokens, mask)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        if i == 0:  # lr(0) = 0: the first update changes no bit
            after = ttrain.state_to_numpy(state)["params"]
            for key, a in before.items():
                np.testing.assert_array_equal(after[key], a, err_msg=key)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(norms, jnorms, rtol=NORM_RTOL)
    want = jax.tree.map(np.asarray, st.params)
    for path, name, t in tshd.leaves(state.params):
        np.testing.assert_allclose(t.detach().numpy(),
                                   _leaf(want, path, name), rtol=0,
                                   atol=PARAM_ATOL, err_msg=f"{path} {name}")
    assert state.step == 3 and state.opt_state.count == 3
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("preset,plan,impl", TWO_RANK,
                         ids=["dp2", "tp2", "sp2-ring", "sp2-xla", "ep2",
                              "pp2"])
def test_f32_two_rank_layouts_match_one_rank(groups, preset, plan, impl):
    jcfg, cfg = _cfgs(preset, attn_impl=impl)
    _, _, tree = _jax_state(jcfg)
    pp = plan.get("pp", 1)
    tokens, mask = _batch(cfg, s=32 if impl == "ring" else 16)
    ref = _single(dataclasses.replace(cfg, attn_impl="xla"), tree, tokens,
                  mask, seq_sharded=pp == 1)
    outs = groups.get(2).spmd("seldon_tpu_torch.models.train:spmd_steps",
                              plan, cfg, tree, tokens, mask, 3, OPT, pp == 1,
                              2)
    specs = tpipe.pp_param_pspecs(cfg) if pp > 1 else tshd.param_pspecs(cfg)
    check_layout(outs, ref, specs, f"f32 {plan}", **F32_LAYOUT)
    for o in outs:
        assert all(a.dtype == np.float32 for kind in ("params", "mu", "nu")
                   for a in o[kind].values())
