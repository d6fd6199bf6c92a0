"""The training tables of the port (``parallel/sharding.py``,
``parallel/pipeline.pp_param_pspecs``) against the JAX package's: every
spec tree equal as tuples (``param_pspecs`` plain and quantized,
``cache_pspec`` bf16 and int8, ``batch_pspec``, ``activation_pspec``,
``pp_param_pspecs``) for tiny, tiny-moe and llama3-8b; and at every mesh
coordinate of ``MeshPlan(dp=2, tp=2, sp=2)``, ``(tp=2, ep=2)`` and
``(dp=2, pp=2, tp=2)`` the port's cut of every parameter and optimizer
moment (``train.state_from_numpy`` at that coordinate) bit-equal to
JAX's ``addressable_shards`` on the device at that coordinate of JAX's
train-step state. Host code only: a cut needs no rank group."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from seldon_tpu.models.config import get_config
from seldon_tpu.models.train import make_optimizer, make_sharded_train_step
from seldon_tpu.parallel import MeshPlan, make_mesh
from seldon_tpu.parallel import pipeline as jpipe
from seldon_tpu.parallel import sharding as jshd
from seldon_tpu_torch.models import train as ttrain
from seldon_tpu_torch.models.config import get_config as tget_config
from seldon_tpu_torch.parallel import mesh as tmesh
from seldon_tpu_torch.parallel import pipeline as tpipe
from seldon_tpu_torch.parallel import sharding as tshd

PRESETS = ["tiny", "tiny-moe", "llama3-8b"]


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("preset", PRESETS)
def test_param_pspecs_equal_jax(preset, quantized):
    got = tshd.param_pspecs(tget_config(preset), quantized)
    want = jshd.param_pspecs(get_config(preset), quantized)
    assert _tuples(got) == _tuples(want)
    for spec in list(got["blocks"].values()) + [v for k, v in got.items()
                                                 if k != "blocks"]:
        assert isinstance(spec, tshd.P)


@pytest.mark.parametrize("preset", PRESETS)
def test_pp_param_pspecs_equal_jax(preset):
    got = tpipe.pp_param_pspecs(tget_config(preset))
    want = jpipe.pp_param_pspecs(get_config(preset))
    assert _tuples(got) == _tuples(want)
    assert all(s[0] == "pp" for s in got["blocks"].values())


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("preset", PRESETS)
def test_cache_pspec_equal_jax(preset, kv):
    got = tshd.cache_pspec(tget_config(preset, kv_cache_dtype=kv))
    want = jshd.cache_pspec(get_config(preset, kv_cache_dtype=kv))
    assert _tuples(got) == _tuples(want)
    assert _tuples(tshd.cache_pspec()) == _tuples(jshd.cache_pspec())


@pytest.mark.parametrize("seq", [False, True])
def test_batch_and_activation_pspecs_equal_jax(seq):
    assert tuple(tshd.batch_pspec(seq)) == tuple(jshd.batch_pspec(seq))
    assert tuple(tshd.activation_pspec(seq)) == tuple(
        jshd.activation_pspec(seq))


def test_named_shardings_bind_every_spec():
    mesh = tmesh.make_mesh(tmesh.MeshPlan(tp=2, dp=2), ["cpu"] * 4)
    specs = tshd.param_pspecs(tget_config("tiny"))
    bound = tshd.named_shardings(mesh, specs)
    assert bound["embed"].spec == specs["embed"]
    assert bound["blocks"]["wo"].mesh is mesh
    x = torch.arange(8 * 6).reshape(8, 6)
    # embed P("tp", None): the tp=1 rank's rows [4, 8).
    got = bound["embed"].cut(x, {"dp": 1, "pp": 0, "sp": 0, "ep": 0,
                                 "tp": 1})
    assert torch.equal(got, x[4:])


def test_cut_orders_blocks_of_several_axes_first_major():
    sizes = {"dp": 2, "pp": 1, "sp": 1, "ep": 1, "tp": 2}
    x = torch.arange(8)
    for dp in range(2):
        for tp in range(2):
            got = tshd.cut(x, (("dp", "tp"),),
                           {"dp": dp, "pp": 0, "sp": 0, "ep": 0, "tp": tp},
                           sizes)
            i = dp * 2 + tp
            assert torch.equal(got, x[2 * i:2 * i + 2])


class _At:
    """A rank's place, as ``state_from_numpy`` reads it."""

    def __init__(self, mesh, coord):
        self.mesh, self.coord, self.device = mesh, coord, torch.device("cpu")


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _shard_at(arr, device):
    for sh in arr.addressable_shards:
        if sh.device == device:
            return np.asarray(sh.data)
    raise AssertionError(f"no shard on {device}")


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
            else t.numpy())


def _jnp(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


LAYOUTS = [("tiny", dict(dp=2, tp=2, sp=2)),
           ("tiny-moe", dict(tp=2, ep=2)),
           ("tiny", dict(dp=2, pp=2, tp=2))]


@pytest.mark.parametrize("preset,plan", LAYOUTS,
                         ids=["dp2-tp2-sp2", "tp2-ep2", "dp2-pp2-tp2"])
def test_rank_cuts_bit_equal_to_jax_shards(preset, plan):
    cfg = get_config(preset)
    mesh = make_mesh(MeshPlan(**plan))
    init_fn, _ = make_sharded_train_step(mesh, cfg,
                                         make_optimizer(total_steps=10),
                                         seq_sharded=plan.get("pp", 1) == 1,
                                         n_microbatches=2)
    state = init_fn(jax.random.key(0))
    adam = state.opt_state[1][0]
    trees = {"params": state.params, "mu": adam.mu, "nu": adam.nu}
    host = {"step": 0, "count": int(adam.count),
            **{k: _host(v) for k, v in trees.items()}}
    tcfg = tget_config(preset)
    tm = tmesh.make_mesh(tmesh.MeshPlan(**plan), ["cpu"] * mesh.size)
    specs = (tpipe.pp_param_pspecs(tcfg) if plan.get("pp", 1) > 1
             else tshd.param_pspecs(tcfg))
    names = tmesh.AXES
    for idx in np.ndindex(*mesh.devices.shape):
        coord = dict(zip(names, map(int, idx)))
        device = mesh.devices[idx]
        mine = ttrain.state_from_numpy(host, tcfg, ranks=_At(tm, coord),
                                       specs=specs)
        assert mine.opt_state.count == int(adam.count)
        held = set()
        for kind, tree in (("params", mine.params),
                           ("mu", mine.opt_state.mu),
                           ("nu", mine.opt_state.nu)):
            for path, name, t in tshd.leaves(tree):
                leaf = (trees[kind]["blocks"][name] if path
                        else trees[kind][name])
                want = _shard_at(leaf, device)
                if path:
                    # The rank's layers are the first axis of JAX's shard.
                    first = tshd.layers_of(tcfg, specs["blocks"][name][0],
                                           coord, tm.shape)[0]
                    want = want[path[0] - first]
                    held.add(path[0])
                np.testing.assert_array_equal(
                    _np(t), _jnp(want), err_msg=f"{kind} {path} {name} "
                                                f"at {coord}")
        n_stages = plan.get("pp", 1)
        assert len(held) == cfg.n_layers // n_stages


def test_indivisible_layouts_raise():
    cfg = tget_config("tiny")
    with pytest.raises(ValueError):
        tshd.cut(torch.zeros(3, 4), (None, "tp"),
                 {"dp": 0, "pp": 0, "sp": 0, "ep": 0, "tp": 0},
                 {"dp": 1, "pp": 1, "sp": 1, "ep": 1, "tp": 3})
    with pytest.raises(ValueError):
        tshd.layers_of(dataclasses.replace(cfg, n_layers=3), "pp",
                       {"pp": 0}, {"pp": 2})
