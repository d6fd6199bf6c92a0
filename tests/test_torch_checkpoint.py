"""seldon_tpu_torch.servers.checkpoint against the JAX package's
``servers/checkpoint.py``, on ``tiny``.

 * The committed JAX-written fixtures (``tests/data/torch_orbax_tiny_*``,
   ``tests/torch_orbax_fixtures.py``) rebuild with the JAX package to the
   committed leaf digests and streams, and the port loads every leaf to
   its recorded SHA-256.
 * JAX ``save_checkpoint`` -> port ``load_checkpoint`` is bit-equal to
   ``params_from_numpy`` of JAX's params (dtypes and the int8 leaves'
   column-major layout included) for tiny bf16, int8, float32 and
   tiny-moe, with the configs equal field by field; port
   ``save_checkpoint`` -> JAX ``load_checkpoint`` is bit-equal to the
   tree saved, and the port's own round trip too.
 * ``TorchServer(model_uri=<JAX-saved tiny>, ragged=1,
   ragged_kernel="pallas")`` gives ``JAXServer``'s greedy streams on the
   same directory, near-ties reported; each tp = 2 rank's shard
   (``load_checkpoint_shard``, ``build_rank_shard(("orbax", path))``) is
   the slice of the whole, and ``TorchServer(tp=2)`` on two CPU ranks
   serves the tp = 1 streams."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from seldon_tpu.models import transformer as jtf
from seldon_tpu.models.config import get_config as jget
from seldon_tpu.models.quantize import quantize_params as jquant
from seldon_tpu.servers import checkpoint as jck
from seldon_tpu_torch.models import tp_sharding
from seldon_tpu_torch.models.config import get_config as tget
from seldon_tpu_torch.models.convert import params_from_numpy
from seldon_tpu_torch.servers import checkpoint as tck
from seldon_tpu_torch.servers import mesh_engine
from seldon_tpu_torch.servers.torchserver import TorchServer

import torch_orbax_fixtures as fx
from torch_port_helpers import assert_streams_match

KINDS = sorted(fx.KINDS)
# (preset, config overrides, quantized tree)
CASES = {"tiny-bf16": ("tiny", {}, False),
         "tiny-int8": ("tiny", {"weight_dtype": "int8"}, True),
         "tiny-f32": ("tiny", {"dtype": "float32"}, False),
         "tiny-moe": ("tiny-moe", {}, False)}


def _record(kind):
    with open(os.path.join(fx.fixture_dir(kind), "record.json")) as f:
        return json.load(f)


def _named(params) -> dict:
    return {k: t.detach() for k, t in list(params.named_parameters())
            + list(params.named_buffers()) if t is not None}


def _bits(t):
    return t if t.dtype == torch.int8 else t.contiguous().view(torch.uint8)


def _assert_same(got, want, what):
    """Bit for bit, with dtypes, shapes and 2-D layouts."""
    g, w = _named(got), _named(want)
    assert g.keys() == w.keys(), (what, g.keys() ^ w.keys())
    for k in w:
        assert (g[k].dtype, g[k].shape) == (w[k].dtype, w[k].shape), (what, k)
        assert torch.equal(_bits(g[k]), _bits(w[k])), f"{what}: {k} differs"
        if w[k].dim() == 2 and min(w[k].shape) > 1:
            assert g[k].stride() == w[k].stride(), (what, k)


def _jax_tree(case):
    preset, kw, quant = CASES[case]
    cfg = jget(preset, **kw)
    init_cfg = dataclasses.replace(cfg, weight_dtype=jget(preset).weight_dtype)
    params = jtf.init_params(init_cfg, jax.random.key(7))
    return (jquant(params) if quant else params), cfg


def _tree_bits_equal(a, b):
    return jax.tree.all(jax.tree.map(
        lambda x, y: x.dtype == y.dtype and x.shape == y.shape
        and np.array_equal(np.asarray(x).view(np.uint8),
                           np.asarray(y).view(np.uint8)), a, b))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """case -> (JAX-saved directory, JAX params, JAX cfg)."""
    out = {}
    for case in CASES:
        params, cfg = _jax_tree(case)
        path = str(tmp_path_factory.mktemp(case))
        jck.save_checkpoint(path, params, cfg)
        out[case] = (path, params, cfg)
    return out


# -- fixtures ----------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_fixture_rebuilds_to_committed_values(tmp_path, kind):
    got = fx.build(kind, str(tmp_path / kind))
    want = _record(kind)
    assert got["leaves"] == want["leaves"]
    assert got["prompts"] == want["prompts"]
    assert got["streams"] == want["streams"]
    np.testing.assert_allclose(got["top2_gaps"], want["top2_gaps"],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_fixture_leaves_load_to_recorded_digests(kind):
    params, cfg = tck.load_checkpoint(fx.fixture_dir(kind), "cpu")
    assert tck.leaf_sha256(params) == _record(kind)["leaves"]
    assert (cfg.weight_dtype == "int8") == (kind == "int8")


# -- JAX <-> port ------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_saved_port_loaded(saved, case):
    path, params, cfg = saved[case]
    preset, kw, _ = CASES[case]
    tcfg = tget(preset, **kw)
    got, got_cfg = tck.load_checkpoint(path, "cpu")
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(cfg)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(tcfg)
    want = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    _assert_same(got, want, case)
    assert tck.leaf_sha256(got) == fx.leaf_sha256(params)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_saved_jax_loaded(saved, tmp_path, case):
    path, params, cfg = saved[case]
    preset, kw, _ = CASES[case]
    model = params_from_numpy(jax.tree.map(np.asarray, params),
                              tget(preset, **kw), "cpu")
    out = str(tmp_path / "port")
    tck.save_checkpoint(out, model, tget(preset, **kw))
    back, back_cfg = jck.load_checkpoint(out)
    assert back_cfg == cfg
    assert _tree_bits_equal(back, params)
    again, _ = tck.load_checkpoint(out, "cpu")
    _assert_same(again, model, case)
    # Saving again replaces params/ (force=True in JAX).
    tck.save_checkpoint(out, again, tget(preset, **kw))
    assert sorted(os.listdir(out)) == ["config.json", "params"]
    assert _tree_bits_equal(jck.load_checkpoint(out)[0], params)


def test_refusals(tmp_path, saved):
    with pytest.raises(FileNotFoundError):
        tck.load_checkpoint(str(tmp_path), "cpu")
    path = saved["tiny-bf16"][0]
    meta = os.path.join(path, "params", "_METADATA")
    doc = json.load(open(meta))
    bad = str(tmp_path / "zarr3")
    os.makedirs(os.path.join(bad, "params"))
    with open(os.path.join(bad, "config.json"), "w") as f:
        f.write(open(os.path.join(path, "config.json")).read())
    with open(os.path.join(bad, "params", "_METADATA"), "w") as f:
        json.dump(dict(doc, use_zarr3=True), f)
    with pytest.raises(ValueError, match="zarr3"):
        tck.load_checkpoint(bad, "cpu")
    # A config that disagrees with the saved tree (int8 over bf16 leaves).
    cfg = json.load(open(os.path.join(path, "config.json")))
    mixed = str(tmp_path / "mixed")
    os.makedirs(mixed)
    os.symlink(os.path.join(path, "params"), os.path.join(mixed, "params"))
    with open(os.path.join(mixed, "config.json"), "w") as f:
        json.dump(dict(cfg, weight_dtype="int8"), f)
    with pytest.raises(TypeError, match="int8"):
        tck.load_checkpoint(mixed, "cpu")


# -- serving -----------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_torchserver_streams_equal_jaxserver(kind):
    path = fx.fixture_dir(kind)
    want = fx.jax_streams(path)
    srv = TorchServer(model_uri=path, device="cpu", **fx.SERVER_KW)
    try:
        got = [srv.generate({"prompt_token_ids": p,
                             "max_new_tokens": fx.MAX_NEW,
                             "temperature": 0.0})["token_ids"]
               for p in fx.PROMPTS]
    finally:
        srv.stop()
    jparams, jcfg = jck.load_checkpoint(path)
    assert_streams_match(got, want, jparams, jcfg, fx.PROMPTS,
                         f"orbax {kind}")
    assert_streams_match(got, _record(kind)["streams"], jparams, jcfg,
                         fx.PROMPTS, f"orbax {kind} (record)")
    assert srv.cfg.weight_dtype == jcfg.weight_dtype
    assert srv.engine.debug_lifecycle_check() == {}


class _Rank:
    """A rank's coordinates in a two-rank group (``shard_params``)."""

    def __init__(self, rank):
        self.rank, self.world = rank, 2


@pytest.mark.parametrize("kind", KINDS)
def test_rank_shards_are_slices_of_the_whole(kind):
    path = fx.fixture_dir(kind)
    whole, cfg = tck.load_checkpoint(path, "cpu")
    for rank in (0, 1):
        want = tp_sharding.shard_params(_Rank(rank), cfg, whole)
        got, got_cfg = tck.load_checkpoint_shard(path, "cpu", rank, 2)
        assert got_cfg == cfg
        _assert_same(got, want, f"{kind} rank {rank}")
        built = mesh_engine.build_rank_shard(cfg, ("orbax", path),
                                             torch.device("cpu"), rank, 2)
        _assert_same(built, want, f"{kind} build_rank_shard {rank}")


def test_torchserver_tp2_serves_tp1_streams(tmp_path):
    path = fx.fixture_dir("bf16")
    req = {"prompt_token_ids": fx.PROMPTS[1], "max_new_tokens": 6,
           "temperature": 0.0}
    one = TorchServer(model_uri=path, device="cpu", **fx.SERVER_KW)
    try:
        want = one.generate(req)["token_ids"]
    finally:
        one.stop()
    two = TorchServer(model_uri=path, device="cpu", tp=2, **fx.SERVER_KW)
    try:
        got = two.generate(req)["token_ids"]
        assert two.engine.mesh_info()["route"] == "gloo"
    finally:
        two.stop()
    assert got == want
