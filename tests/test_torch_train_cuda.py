"""The training step on the card. Marked ``cuda``; skipped where there is
no card. This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_train_cuda.py

 * tiny on the card against the port on the CPU, from one carried state
   (the port's seeded init, made on the CPU): three steps, the losses
   within 2e-3, the gradient norms within 5e-3 relative, the first
   step's gradients element by element within rtol 5e-2 and an atol of
   5e-2 x the leaf's largest |g| (at most 5e-3) and within 5e-2 of each
   leaf's norm, every parameter within 2e-3 (the CPU tests' tolerances
   against JAX and between layouts);
 * no fallback: the training route under ``attn_impl="flash"`` on a CUDA
   tensor raises NotImplementedError naming the missing backward
   kernel."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from seldon_tpu_torch.models import train
from seldon_tpu_torch.models.config import get_config
from seldon_tpu_torch.parallel import mesh
from seldon_tpu_torch.parallel.distributed import RankGroup

B, S = 4, 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card with "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_train_cuda.py")
    return torch.device("cuda", 0)


def _steps(cfg, tree, device, tokens, mask):
    """Three one-rank steps on ``device`` from the numpy state ``tree``."""
    return train.spmd_steps(types.SimpleNamespace(
        ranks=RankGroup.solo(device)), {}, cfg, tree, tokens, mask, 3,
        dict(total_steps=10, warmup=1))


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["tiny", "tiny-moe"])
def test_card_steps_match_cpu(cuda, preset):
    cfg = get_config(preset)
    init_fn, _ = train.make_sharded_train_step(
        mesh.make_mesh(mesh.MeshPlan(), ["cpu"]), cfg,
        train.make_optimizer(), device="cpu")
    tree = train.state_tree(init_fn(0))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[:2, :5] = 0
    card = _steps(cfg, tree, cuda, tokens, mask)
    cpu = _steps(cfg, tree, torch.device("cpu"), tokens, mask)
    np.testing.assert_allclose(card["losses"], cpu["losses"], atol=2e-3)
    np.testing.assert_allclose(card["grad_norms"], cpu["grad_norms"],
                               rtol=5e-3)
    assert card["losses"][-1] < card["losses"][0]

    def f32(a):
        return (torch.from_numpy(a).view(torch.bfloat16).float().numpy()
                if a.dtype == np.int16 else a)

    for key, want in cpu["params"].items():
        np.testing.assert_allclose(f32(card["params"][key]), f32(want),
                                   atol=2e-3, err_msg=str(key))
    assert card["grads"].keys() == cpu["params"].keys()
    for key, want in cpu["grads"].items():
        got = card["grads"][key]
        np.testing.assert_allclose(
            got, want, rtol=5e-2, atol=min(5e-3, 5e-2 * np.abs(want).max()),
            err_msg=str(key))
        assert np.linalg.norm(got - want) <= 5e-2 * np.linalg.norm(want)


@pytest.mark.cuda
def test_flash_training_raises_on_the_card(cuda):
    cfg = dataclasses.replace(get_config("tiny"), attn_impl="flash")
    init_fn, step_fn = train.make_sharded_train_step(
        mesh.make_mesh(mesh.MeshPlan(), [cuda]), cfg, train.make_optimizer(),
        device=cuda)
    state = init_fn(0)
    tokens = np.zeros((1, 128), np.int32)
    with pytest.raises(NotImplementedError, match="backward"):
        step_fn(state, tokens, np.ones((1, 128), np.float32))
