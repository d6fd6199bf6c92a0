"""Ring attention over the 'sp' ranks (``parallel/ring_attention.py``):
the port's ring over 2 and 4 spawned gloo CPU ranks against the JAX
package's ring on its sp=4 CPU mesh (the 2e-3 of
``tests/test_ops.py``), GQA against the ring on expanded K/V, causal and
full, and ``forward`` with ``attn_impl="ring"`` against ``"xla"`` (the
2e-2 of ``tests/test_ops.py``). Each group size is one spawned group
(a module-scoped fixture); every rank runs its block of the sequence."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from seldon_tpu.parallel import MeshPlan, make_mesh
from seldon_tpu.parallel.ring_attention import ring_attention as jring
from seldon_tpu_torch.models import transformer
from seldon_tpu_torch.models.config import get_config
from seldon_tpu_torch.parallel.mesh import MeshPlan as MeshPlan_t
from seldon_tpu_torch.parallel.mesh import make_mesh as make_tmesh
from seldon_tpu_torch.parallel.ring_attention import ring_attention
from seldon_tpu_torch.servers import mesh_engine
from torch_port_helpers import one_intra_op_thread  # noqa: F401


@pytest.fixture(scope="module", params=[2, 4], ids=["sp2", "sp4"])
def group(request):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        g = mesh_engine.spawn_group(
            make_tmesh(MeshPlan_t(sp=request.param),
                       ["cpu"] * request.param), timeout_s=60.0)
    yield g
    g.close()


def _qkv(B, S, H, Hkv, Dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, Dh), np.float32),
            rng.standard_normal((B, S, Hkv, Dh), np.float32),
            rng.standard_normal((B, S, Hkv, Dh), np.float32))


def _ring_case(ctx, q, k, v, causal):
    """Run on every rank: this rank's block through the ring, the output
    blocks all-gathered on the sequence axis."""
    ranks = ctx.ranks
    s = q.shape[1] // ranks.world
    lo = ranks.rank * s

    def block(x):
        return torch.from_numpy(x[:, lo:lo + s].copy())

    out = ring_attention(block(q), block(k), block(v), ranks, causal=causal)
    return ranks.all_gather(out, 1).numpy()


def _jax_ring(q, k, v, causal):
    mesh = make_mesh(MeshPlan(sp=4, dp=2))
    spec = NamedSharding(mesh, P(None, "sp", None, None))
    args = [jax.device_put(jnp.asarray(x), spec) for x in (q, k, v)]
    return np.asarray(jax.jit(
        lambda a, b, c: jring(a, b, c, mesh, causal=causal))(*args))


@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_jax_ring(group, causal):
    q, k, v = _qkv(2, 32, 4, 4, 16, seed=3)
    outs = group.spmd(f"{__name__}:_ring_case", q, k, v, causal)
    want = _jax_ring(q, k, v, causal)
    for out in outs:  # every rank ends with the whole output
        np.testing.assert_allclose(out, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_gqa_matches_expanded(group, causal):
    """GQA ring (Hkv-head K/V rotate) == the ring on K/V expanded to H
    heads (head h attends kv head h // G), and both match JAX's."""
    B, S, H, Hkv, Dh = 2, 32, 8, 2, 16
    q, k, v = _qkv(B, S, H, Hkv, Dh, seed=9)
    G = H // Hkv
    got = group.spmd(f"{__name__}:_ring_case", q, k, v, causal)[0]
    ref = group.spmd(f"{__name__}:_ring_case", q, np.repeat(k, G, axis=2),
                     np.repeat(v, G, axis=2), causal)[0]
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, _jax_ring(q, k, v, causal), rtol=2e-3,
                               atol=2e-3)


def test_ring_skips_blocks_above_the_diagonal(group, monkeypatch):
    """Causal: rank r updates with r + 1 blocks and makes world - 1 hops
    per K and V (the last rotation's hop is not made); full attention
    updates with every block."""
    from seldon_tpu_torch.parallel import ring_attention as ra

    q, k, v = _qkv(1, 8 * group.ranks.world, 2, 1, 8, seed=1)
    calls = []
    real = ra._block_attention_update
    monkeypatch.setattr(ra, "_block_attention_update",
                        lambda *a: calls.append(1) or real(*a))
    n = group.ranks.world
    for causal, want in ((True, 1), (False, n)):
        calls.clear()
        hops = group.ranks.gathers
        group.spmd(f"{__name__}:_ring_case", q, k, v, causal)
        assert len(calls) == want  # rank 0 holds the first block
        # 2 (n - 1) exchanges, then the output gather.
        assert group.ranks.gathers - hops == 2 * (n - 1) + 1


def test_forward_ring_matches_xla(group):
    """attn_impl="ring" with the sp group: the full forward (every rank
    its block of the sequence through every layer) equals the plain
    "xla" forward, as JAX's test_ring_attn_impl_forward_matches_xla."""
    cfg = get_config("tiny")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    ring_cfg = dataclasses.replace(cfg, attn_impl="ring")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    ref = transformer.forward(params, torch.from_numpy(tokens), cfg)
    mesh_engine.send_weights(group, ring_cfg, params, shard=False)
    out = group.score(tokens, lambda: transformer.forward(
        params, torch.from_numpy(tokens), ring_cfg, ring=group.ranks))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-2,
                               atol=2e-2)
    # The context-parallel prefill of the dense admission: the same
    # logits at each row's last token and the same K/V in the cache.
    plens = np.array([32, 20], np.int32)
    c_ref = transformer.init_cache(cfg, 2, 32, device="cpu")
    l_ref, c_ref = transformer.prefill(params, torch.from_numpy(tokens),
                                       torch.from_numpy(plens), c_ref, cfg)
    l_out, c_out = group.spmd(f"{__name__}:_ring_prefill", tokens,
                              plens)[0]
    np.testing.assert_allclose(l_out, l_ref.numpy(), rtol=2e-2, atol=2e-2)
    for key in c_ref:
        np.testing.assert_allclose(c_out[key], c_ref[key].float().numpy(),
                                   rtol=2e-2, atol=2e-2)
    group.release()


def _ring_prefill(ctx, tokens, plens):
    """Run on every rank: the tiny model's prefill of ``tokens`` with its
    sequence context-parallel over the group (the sp axis spans it)."""
    cfg = dataclasses.replace(get_config("tiny"), attn_impl="ring")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    cache = transformer.init_cache(cfg, *tokens.shape, device="cpu")
    logits, cache = transformer.prefill(
        params, torch.from_numpy(tokens), torch.from_numpy(plens), cache,
        cfg, ring=ctx.ranks)
    return logits.numpy(), {k: v.float().numpy() for k, v in cache.items()}
