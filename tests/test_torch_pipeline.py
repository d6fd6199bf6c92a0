"""The GPipe schedule of the port (``parallel/pipeline.py``) on spawned
gloo ranks against the JAX package's tests of its pipeline
(``tests/test_pipeline.py``), with their tolerances:
 * the pipelined forward (dp=2, pp=2, tp=2, M=2) within 2e-2 of JAX's
   plain forward, rank by rank on its rows, the aux a scalar;
 * M = 1 and 4 over pp = 2 within 2e-2, T = M + P - 1 ticks;
 * the gradients of mean(logits ** 2) through the pipeline (pp = 2,
   M = 2), wq and w_down of both stages' layers, within rtol 5e-2,
   atol 5e-3 of JAX's plain ``jax.grad``;
 * the pp train step (dp=2, pp=2, tp=2, M=2, the sequence whole) runs
   and learns: losses finite and descending, within 2e-3 of the port's
   single-rank step, each rank's first-step gradients within the
   tolerances of ``test_torch_train.check_grads`` of the single-rank
   gradients cut to it (the router's, whose aux the pipeline takes per
   microbatch, within 0.25 of its norm), every shard within 2e-3 of its
   parameters, every
   pp-, dp- and tp-replicated leaf bit-equal across its replicas, the
   layer axis cut over pp; and the MoE aux of a pipelined tiny-moe;
 * ValueError for n_layers % pp and B % M, as JAX raises."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seldon_tpu.models import forward, get_config, init_params
from seldon_tpu_torch.models.config import get_config as tget_config
from seldon_tpu_torch.parallel import mesh as tmesh
from seldon_tpu_torch.parallel import pipeline as tpipe
from test_torch_train import (OPT, _batch, _jax_state, _single, _wire,
                              check_layout)
from torch_port_helpers import one_intra_op_thread  # noqa: F401
from torch_train_ranks import Groups


@pytest.fixture(scope="module")
def groups():
    g = Groups()
    yield g
    g.close()


@pytest.fixture(scope="module")
def tiny_setup():
    cfg = get_config("tiny")
    params = init_params(cfg, jax.random.key(0))
    tokens = np.array(jax.random.randint(jax.random.key(1), (4, 16), 0,
                                           cfg.vocab_size), np.int32)
    ref = np.asarray(forward(params, tokens, cfg))
    return cfg, _wire(jax.tree.map(np.asarray, params)), tokens, ref, params


@pytest.mark.parametrize("m", [1, 2, 4])
def test_pipeline_forward_microbatch_counts(groups, tiny_setup, m):
    cfg, tree, tokens, ref, _ = tiny_setup
    outs = groups.get(2).spmd("torch_train_ranks:pipeline_forward",
                              dict(pp=2), tget_config("tiny"), tree, tokens,
                              m)
    for o in outs:
        assert o["ticks"] == m + 2 - 1
        np.testing.assert_allclose(o["logits"], ref[o["rows"]], rtol=2e-2,
                                   atol=2e-2)
    np.testing.assert_array_equal(outs[0]["logits"], outs[1]["logits"])


def test_pipeline_grads_match_plain(groups, tiny_setup):
    cfg, tree, tokens, _, params = tiny_setup

    def plain_loss(p):
        return jnp.mean(forward(p, tokens, cfg).astype(jnp.float32) ** 2)

    want = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.grad(plain_loss)(params))
    outs = groups.get(2).spmd("torch_train_ranks:pipeline_grads", dict(pp=2),
                              tget_config("tiny"), tree, tokens, 2)
    seen = set()
    for o in outs:
        assert abs(o["loss"] - float(plain_loss(params))) < 1e-4
        for (layer, name), g in o["grads"].items():
            seen.add(layer)
            np.testing.assert_allclose(g, want["blocks"][name][layer],
                                       rtol=5e-2, atol=5e-3,
                                       err_msg=f"{name}[{layer}]")
    assert seen == set(range(cfg.n_layers))  # both stages' backward


def test_pipeline_rejects_indivisible():
    cfg = tget_config("tiny")
    mesh = tmesh.make_mesh(tmesh.MeshPlan(pp=2), ["cpu", "cpu"])
    with pytest.raises(ValueError):
        tpipe.make_pipeline_forward(mesh, dataclasses.replace(cfg,
                                                              n_layers=3), 2)
    pipe = tpipe.make_pipeline_forward(mesh, cfg, 3)

    class _Hints:
        class ranks:
            coord = {"dp": 0}

    with pytest.raises(ValueError, match="microbatches"):
        pipe.rows(4, _Hints())


def test_pipeline_forward_matches_plain(groups, tiny_setup):
    cfg, tree, tokens, ref, _ = tiny_setup
    outs = groups.get(8).spmd("torch_train_ranks:pipeline_forward",
                              dict(dp=2, pp=2, tp=2), tget_config("tiny"),
                              tree, tokens, 2)
    for o in outs:
        np.testing.assert_allclose(o["logits"], ref[o["rows"]], rtol=2e-2,
                                   atol=2e-2)
        assert np.ndim(o["aux"]) == 0
    rows = sorted(r for o in outs if o["coord"]["pp"] == 0
                  and o["coord"]["tp"] == 0 for r in o["rows"])
    assert rows == list(range(4))


@pytest.mark.parametrize("preset", ["tiny", "tiny-moe"])
def test_pp_train_step_runs_and_learns(groups, preset):
    plan = dict(dp=2, pp=2, tp=2) if preset == "tiny" else dict(pp=2, ep=2,
                                                                dp=2)
    jcfg = get_config(preset)
    _, _, tree = _jax_state(jcfg)
    cfg = tget_config(preset)
    tokens, mask = _batch(cfg)
    ref = _single(cfg, tree, tokens, mask, seq_sharded=False)
    outs = groups.get(8).spmd("seldon_tpu_torch.models.train:spmd_steps",
                              plan, cfg, tree, tokens, mask, 3, OPT, False, 2)
    check_layout(outs, ref, tpipe.pp_param_pspecs(cfg), str(plan))
    for o in outs:  # the layer axis is cut over pp
        layers = {k[0][0] for k in o["params"] if k[0]}
        assert layers == {o["coord"]["pp"]}
