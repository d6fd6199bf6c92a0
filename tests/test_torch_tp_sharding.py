"""The exact-TP tables and the rank-group host code of the port
(``models/tp_sharding.py``, ``parallel/{mesh,distributed}.py``,
``servers/mesh_engine.device_budget`` / ``build_tp_mesh``) against the
JAX package's: validate's errors, the shard table of ``tiny``, of
``tiny`` with int8 weights (the scales follow their weight) and of
``tiny-moe`` (replicated), the state leaf specs, each rank's sliced
leaves bit-equal to JAX's own shards on a 2-device CPU mesh,
``MeshPlan.auto`` for n = 1..16 across the presets, the slice env
contract, and the MESH_DEVICES budget. Host code only: no rank group is
started here (``tests/test_torch_mesh_engine.py`` runs one)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from seldon_tpu.models import tp_sharding as jtp
from seldon_tpu.models.config import get_config
from seldon_tpu.models.quantize import quantize_params as jquantize
from seldon_tpu.parallel import distributed as jdist
from seldon_tpu.parallel import mesh as jmesh
from seldon_tpu.servers import mesh_engine as jme
from seldon_tpu_torch.models import tp_sharding as ttp
from seldon_tpu_torch.models.config import get_config as tget_config
from seldon_tpu_torch.parallel import distributed as tdist
from seldon_tpu_torch.parallel import mesh as tmesh
from seldon_tpu_torch.servers import mesh_engine as tme
from torch_port_helpers import bits, params_pair


@dataclasses.dataclass
class Rank:
    """A group handle's shape alone (rank r of world)."""

    rank: int
    world: int


def _jspec_sharded(spec) -> bool:
    parts = tuple(spec)
    return bool(parts) and parts[-1] == jtp.TP_AXIS


@pytest.mark.parametrize("tp", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("preset", ["tiny", "tiny-moe", "llama3-8b"])
def test_validate_errors_match_jax(preset, tp):
    jcfg, tcfg = get_config(preset), tget_config(preset)
    try:
        jtp.validate(jcfg, tp)
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        ttp.validate(tcfg, tp)
    else:
        with pytest.raises(ValueError) as got:
            ttp.validate(tcfg, tp)
        assert str(got.value) == want


def _table_pair(preset, int8=False):
    cfg = get_config(preset)
    jparams, tparams = params_pair(cfg, seed=3)
    if int8:
        jparams = jquantize(jparams)
        _, tparams = _quantized_pair(jparams, cfg)
    return cfg, jparams, tparams


def _quantized_pair(jparams, cfg):
    from seldon_tpu_torch.models import convert
    tree = jax.tree.map(np.asarray, jparams)
    return jparams, convert.params_from_numpy(tree, cfg, device="cpu")


@pytest.mark.parametrize("preset,int8", [("tiny", False), ("tiny", True),
                                         ("tiny-moe", False)])
def test_param_table_matches_jax(preset, int8):
    cfg, jparams, tparams = _table_pair(preset, int8)
    jspecs = jtp.param_pspecs(cfg, jparams)
    tspecs = ttp.param_pspecs(tget_config(preset), tparams)
    jtop = {k: _jspec_sharded(v) for k, v in jspecs.items()
            if k != "blocks"}
    ttop = {k: v is not None for k, v in tspecs.items() if k != "blocks"}
    assert ttop == jtop
    jb = {k: _jspec_sharded(v) for k, v in jspecs["blocks"].items()}
    tb = {k: v == ttp.SHARD_LAST for k, v in tspecs["blocks"].items()}
    assert tb == jb
    if int8:
        assert tb["wq_scale"] and not tb["wo_scale"]
    if preset == "tiny-moe":
        assert not any(tb.values())
    else:
        assert sorted(k for k, v in tb.items() if v and "scale" not in k) \
            == sorted(ttp._SHARDED_BLOCK_WEIGHTS)


@pytest.mark.parametrize("shape", [(2, 3, 4, 5, 6), (2, 3, 4, 5), (7,),
                                   (3, 4), (2, 2, 2)])
def test_state_leaf_spec_matches_jax(shape):
    x = np.zeros(shape, np.float32)
    jspec = tuple(jtp.state_leaf_spec(x))
    want = jspec.index(jtp.TP_AXIS) if jtp.TP_AXIS in jspec else None
    assert ttp.state_leaf_spec(torch.zeros(shape)) == want


def _jax_shard(x, rank, tp):
    """Rank ``rank``'s shard of a committed jax array: the shard whose
    index starts at rank * width on the sharded (last) dim, or the only
    shard when the leaf is replicated."""
    for sh in x.addressable_shards:
        idx = sh.index[-1] if sh.index else slice(None)
        start = idx.start or 0
        width = x.shape[-1] // tp if x.ndim else 0
        if x.ndim == 0 or sh.data.shape == x.shape or start == rank * width:
            return np.asarray(sh.data)
    raise AssertionError("no shard for rank")


def _colmajor(t: torch.Tensor) -> bool:
    return (t.dim() == 2 and t.shape[0] > 1 and t.shape[1] > 1
            and t.stride() == (1, t.shape[0]))


def _np(t: torch.Tensor) -> np.ndarray:
    return bits(t) if t.dtype == torch.bfloat16 else t.detach().numpy()


def _jnp(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("preset,int8", [("tiny", False), ("tiny", True),
                                         ("tiny-moe", False)])
def test_rank_leaves_bit_equal_to_jax_shards(preset, int8):
    cfg, jparams, tparams = _table_pair(preset, int8)
    mesh = jme.build_tp_mesh(2)
    jsharded = jtp.shard_params(mesh, cfg, jparams)
    tcfg = tget_config(preset)
    for rank in range(2):
        mine = ttp.shard_params(Rank(rank, 2), tcfg, tparams)
        for name, leaf in jsharded.items():
            if name == "blocks":
                continue
            want = _jax_shard(leaf, rank, 2)
            np.testing.assert_array_equal(_np(getattr(mine, name)),
                                          _jnp(want), err_msg=name)
        for name, leaf in jsharded["blocks"].items():
            want = _jax_shard(leaf, rank, 2)
            for i, bp in enumerate(mine.blocks):
                got = getattr(bp, name)
                assert tuple(got.shape) == want.shape[1:], name
                np.testing.assert_array_equal(
                    _np(got), _jnp(want[i]), err_msg=f"{name}[{i}]")
            # Sharded weights keep the full model's memory layout (the
            # int8 projections stay column-major for _int_mm).
            full = getattr(tparams.blocks[0], name)
            assert _colmajor(getattr(mine.blocks[0], name)) \
                == _colmajor(full), name


def test_shard_state_cuts_kv_heads():
    cfg = tget_config("tiny")
    from seldon_tpu_torch.servers.engine import init_state
    full = init_state(cfg, 4, 32, None, torch.device("cpu"))
    full["cache"]["k"].copy_(torch.arange(full["cache"]["k"].numel())
                             .reshape(full["cache"]["k"].shape))
    for rank in range(2):
        part = ttp.shard_state(Rank(rank, 2), full)
        h = cfg.n_kv_heads // 2
        assert torch.equal(part["cache"]["k"],
                           full["cache"]["k"][:, :, rank * h:(rank + 1) * h])
        assert part["pos"] is full["pos"]
        hints = ttp.TpHints(group=Rank(rank, 2), tp=2)
        hints.constrain_state(part, cfg)
        with pytest.raises(ValueError, match="shard"):
            hints.constrain_state(full, cfg)


def test_hints_refuse_group_mismatch():
    assert ttp.hints(None, 1) is None
    with pytest.raises(ValueError, match="requires a mesh"):
        ttp.hints(None, 2)
    with pytest.raises(ValueError, match="2-way"):
        ttp.hints(Rank(0, 2), 4)
    h = ttp.hints(Rank(1, 2), 2)
    assert h.tp == 2 and h.rank == 1
    cfg = tget_config("tiny")
    x = torch.arange(2 * 3 * cfg.n_heads * 4, dtype=torch.float32).reshape(
        2, 3, cfg.n_heads, 4)
    half = cfg.n_heads // 2
    assert torch.equal(h.heads(x, cfg), x[:, :, half:])
    assert h.heads(x[:, :, half:], cfg).shape == (2, 3, half, 4)
    with pytest.raises(ValueError, match="neither"):
        h.flat(torch.zeros(2, 5), 8)


@pytest.mark.parametrize("rank", [0, 1])
def test_attention_at_the_groups_head_count(rank):
    """``pad_heads`` sets a rank's heads at their place among zeros and
    ``own_heads`` takes them back; attention under the hints (decode,
    the ragged wave's fresh scores and combine) returns exactly the
    rank's heads of the whole-head result, and so does the prefill on
    the rank's heads alone (it runs unpadded)."""
    from seldon_tpu_torch.models import ragged_attention as tra
    from seldon_tpu_torch.models import transformer as ttf
    from seldon_tpu_torch.ops import ragged_paged_attention as rpa

    h = ttp.TpHints(group=Rank(rank, 2), tp=2)
    g = torch.Generator().manual_seed(rank)
    B, S, T, H, Hkv, Dh = 2, 3, 5, 4, 2, 8

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(torch.bfloat16)

    x = rnd(B, S, 1, Dh)
    padded = h.pad_heads(x, 2)
    assert padded.shape == (B, S, 2, Dh)
    assert torch.equal(h.own_heads(padded, 2), x)
    assert not padded.narrow(2, 1 - rank, 1).any()
    q, k, v = rnd(B, S, H, Dh), rnd(B, T, Hkv, Dh), rnd(B, T, Hkv, Dh)
    mine = slice(rank * H // 2, (rank + 1) * H // 2)
    kv = slice(rank * Hkv // 2, (rank + 1) * Hkv // 2)
    mask = torch.ones(B, S, T, dtype=torch.bool).tril(T - S)
    whole = ttf.gqa_attention(q, k, v, mask)
    part = ttf.gqa_attention(q[:, :, mine], k[:, :, kv], v[:, :, kv], mask)
    assert torch.equal(part, whole.unflatten(2, (H, Dh))[:, :, mine]
                       .flatten(2))
    ck, cv = rnd(B, Hkv, T, Dh), rnd(B, Hkv, T, Dh)
    kf, vf = rnd(B, 1, Hkv, Dh), rnd(B, 1, Hkv, Dh)
    lt = torch.ones(B, 1, T, dtype=torch.bool)
    whole = ttf.gqa_attention_decode(q[:, :1], ck, cv, kf, vf, lt)
    part = ttf.gqa_attention_decode(q[:, :1, mine], ck[:, kv], cv[:, kv],
                                    kf[:, :, kv], vf[:, :, kv], lt, tp=h)
    assert torch.equal(part, whole.unflatten(2, (H, Dh))[:, :, mine]
                       .flatten(2))
    qr = q.reshape(B, S, Hkv, H // Hkv, Dh)
    s_whole = tra._fresh_scores("bskgd,btkd->bkgst", qr, k[:, :S])
    s_part = tra._fresh_scores("bskgd,btkd->bkgst", qr[:, :, kv],
                               k[:, :S, kv], h)
    assert torch.equal(s_part, s_whole[:, kv])
    parts = (torch.zeros(B, Hkv, H // Hkv, S, 1),
             torch.ones(B, Hkv, H // Hkv, S, 1),
             torch.randn(B, Hkv, H // Hkv, S, Dh, generator=g))
    vt = v[:, :S].transpose(1, 2)
    whole = rpa.combine_fresh(parts, s_whole, vt)
    part = tra._combine_fresh(tuple(t[:, kv] for t in parts), s_part,
                              vt[:, kv], h)
    assert torch.equal(part, whole.unflatten(2, (Hkv, -1))[:, :, kv]
                       .flatten(2))


@pytest.mark.parametrize("preset", ["tiny", "tiny-moe", "llama3-8b",
                                    None])
def test_meshplan_auto_matches_jax(preset):
    for n in range(1, 17):
        jcfg = get_config(preset) if preset else None
        tcfg = tget_config(preset) if preset else None
        want = dataclasses.asdict(jmesh.MeshPlan.auto(n, jcfg))
        assert dataclasses.asdict(tmesh.MeshPlan.auto(n, tcfg)) == want
    assert tmesh.AXES == jmesh.AXES


def test_make_mesh_lays_devices_over_axes():
    plan = tmesh.MeshPlan(sp=2, tp=2)
    mesh = tmesh.make_mesh(plan, ["cpu"] * 4)
    jm = jmesh.make_mesh(jmesh.MeshPlan(sp=2, tp=2), jax.devices()[:4])
    assert mesh.shape == dict(jm.shape)
    assert [str(d) for d in mesh.flat_devices()] == ["cpu"] * 4
    with pytest.raises(ValueError, match="needs 4 devices"):
        tmesh.make_mesh(plan, ["cpu"] * 3)
    assert ttp.mesh_tp(mesh) == jtp.mesh_tp(jm) == 2
    assert ttp.mesh_tp(None) == jtp.mesh_tp(None) == 1


ENVS = [
    {},
    {jdist.ENV_HOSTNAMES_SVC: "svc", jdist.ENV_WORKER_COUNT: "1"},
    {"HOSTNAME": "mymodel-main-0-2", jdist.ENV_HOSTNAMES_SVC: "hosts",
     jdist.ENV_WORKER_COUNT: "4"},
    {"HOSTNAME": "a-b-7", jdist.ENV_HOSTNAMES_SVC: "s",
     jdist.ENV_WORKER_COUNT: "8", jdist.ENV_COORDINATOR_PORT: "9999"},
    {"HOSTNAME": "nopodordinal", jdist.ENV_HOSTNAMES_SVC: "svc",
     jdist.ENV_WORKER_COUNT: "2"},
    {"HOSTNAME": "x-0", jdist.ENV_WORKER_COUNT: "3"},
]


@pytest.mark.parametrize("env", ENVS)
def test_slice_config_from_env_matches_jax(env):
    def run(mod):
        try:
            got = mod.slice_config_from_env(env)
        except RuntimeError as e:
            return ("error", str(e))
        return None if got is None else dataclasses.asdict(got)

    assert run(tdist) == run(jdist)
    for host in ("x-main-0-3", "plainhost", "a-12", ""):
        assert tdist.pod_ordinal(host) == jdist.pod_ordinal(host)
    assert (tdist.ENV_HOSTNAMES_SVC, tdist.ENV_WORKER_COUNT,
            tdist.ENV_COORDINATOR_PORT, tdist.DEFAULT_COORDINATOR_PORT) == (
        jdist.ENV_HOSTNAMES_SVC, jdist.ENV_WORKER_COUNT,
        jdist.ENV_COORDINATOR_PORT, jdist.DEFAULT_COORDINATOR_PORT)


def test_readiness_single_host_and_forming():
    tdist.SliceReadiness(expected_hosts=1, device="cpu").check()
    with pytest.raises(RuntimeError, match="slice forming"):
        tdist.SliceReadiness(expected_hosts=2, device="cpu").check()


def test_ensure_initialized_needs_a_card_unless_told_cpu(monkeypatch):
    """A configured slice joins on the current card: with none, the call
    raises instead of joining on the CPU (the caller passes "cpu")."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(tdist.ENV_HOSTNAMES_SVC, raising=False)
    cfg = tdist.SliceConfig(coordinator="localhost:1", num_processes=2,
                            process_id=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdist.ensure_initialized(cfg)
    assert tdist.ensure_initialized(None, None) is False  # no slice env


@pytest.mark.parametrize("devices,route", [
    (["cpu", "cpu"], "gloo"),
    (["cuda:0", "cuda:1"], "nccl"),
    (["cuda:0", "cuda:0"], "staged"),
    (["cuda:0", "cuda:1", "cuda:1"], "staged"),
])
def test_route_follows_the_device_list(devices, route):
    assert tdist.route_for(devices) == route


def test_route_refuses_mixed_or_unindexed_lists():
    with pytest.raises(ValueError, match="CPUs only or on cards only"):
        tdist.route_for(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="index"):
        tdist.route_for(["cuda", "cuda"])


def test_device_budget_follows_mesh_devices(monkeypatch):
    # Eight cards, as the JAX tests' eight CPU devices.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    for cap, want in (("1", 1), ("4", 4), ("0", 8), ("", 8), ("junk", 8),
                      ("99", 8)):
        monkeypatch.setenv("MESH_DEVICES", cap)
        assert tme.device_budget() == want
        assert jme.device_budget() == want
    monkeypatch.setenv("MESH_DEVICES", "1")
    with pytest.raises(ValueError, match="MESH_DEVICES"):
        tme.build_tp_mesh(2)
    with pytest.raises(ValueError, match="MESH_DEVICES"):
        jme.build_tp_mesh(2)
    monkeypatch.setenv("MESH_DEVICES", "0")
    mesh = tme.build_tp_mesh(2)
    assert [str(d) for d in mesh.flat_devices()] == ["cuda:0", "cuda:1"]
    assert mesh.shape == dict(jme.build_tp_mesh(2).shape)


def test_build_tp_mesh_takes_explicit_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="only 0 are available"):
        tme.build_tp_mesh(2)
    mesh = tme.build_tp_mesh(2, ["cuda:0", "cuda:0"])
    assert [str(d) for d in mesh.flat_devices()] == ["cuda:0", "cuda:0"]
    with pytest.raises(ValueError, match="needs 3 devices, got 2"):
        tme.build_tp_mesh(3, ["cpu", "cpu"])
    with pytest.raises(ValueError, match=">= 1"):
        tme.build_tp_mesh(0)
    assert tme.build_tp_mesh(1, ["cpu"]).shape["tp"] == 1
