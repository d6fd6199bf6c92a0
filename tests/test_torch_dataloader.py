"""The port's token loader (seldon_tpu_torch/data) against the JAX
package's (seldon_tpu/data): 10 batches per backend (the native prefetch
thread and the numpy path) bit-equal to JAX's for the same shards and
seed; windows are corpus slices; a rejected corpus raises on both
routes; close() joins the prefetch thread."""

import os

import numpy as np
import pytest

from seldon_tpu.data import TokenDataLoader as JaxLoader
from seldon_tpu_torch.data import TokenDataLoader, write_token_shard
from seldon_tpu_torch.data.loader import _splitmix64

BACKENDS = {"native": False, "numpy": True}  # -> force_fallback


@pytest.fixture()
def shards(tmp_path):
    rng = np.random.default_rng(0)
    p1 = write_token_shard(str(tmp_path / "a.bin"),
                           rng.integers(0, 250, size=5000))
    p2 = write_token_shard(str(tmp_path / "b.bin"),
                           rng.integers(0, 250, size=3000))
    return [p1, p2]


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("seed,batch,seq", [(42, 8, 64), (3, 16, 48),
                                            (0, 1, 7998)])
def test_batches_bit_equal_to_jax(shards, backend, seed, batch, seq):
    ours = TokenDataLoader(shards, batch_size=batch, seq_len=seq, seed=seed,
                           force_fallback=BACKENDS[backend])
    ref = JaxLoader(shards, batch_size=batch, seq_len=seq, seed=seed)
    ref_np = JaxLoader(shards, batch_size=batch, seq_len=seq, seed=seed,
                       force_fallback=True)
    try:
        assert ours.native == (backend == "native")
        assert ours.total_tokens == ref.total_tokens == 8000
        for _ in range(10):
            got, want = next(ours), next(ref)
            assert got.dtype == np.int32 and got.shape == (batch, seq + 1)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, next(ref_np))
    finally:
        ours.close()
        ref.close()


def test_write_token_shard_bytes_equal_to_jax(tmp_path):
    from seldon_tpu.data import write_token_shard as jax_write

    toks = np.random.default_rng(1).integers(0, 2**32 - 1, 100,
                                             dtype=np.uint64)
    a = write_token_shard(str(tmp_path / "a.bin"), toks)
    b = jax_write(str(tmp_path / "b.bin"), toks)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_splitmix64_equal_to_jax():
    from seldon_tpu.data.loader import _splitmix64 as jax_mix

    x = np.arange(1000, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    np.testing.assert_array_equal(_splitmix64(x), jax_mix(x))


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_windows_are_real_corpus_slices(shards, backend):
    corpus = np.concatenate([np.fromfile(p, dtype="<u4") for p in shards])
    dl = TokenDataLoader(shards, batch_size=16, seq_len=48, seed=3,
                         force_fallback=BACKENDS[backend])
    try:
        for _ in range(5):
            for row in next(dl):
                starts = np.where(
                    (corpus[:-49] == row[0]) & (corpus[1:-48] == row[1])
                )[0]
                assert any(
                    np.array_equal(corpus[s: s + 49], row) for s in starts
                ), "window is not a contiguous corpus slice"
    finally:
        dl.close()


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_too_small_corpus_raises(tmp_path, backend):
    p = write_token_shard(str(tmp_path / "tiny.bin"), [1, 2, 3])
    with pytest.raises(ValueError):
        TokenDataLoader([p], batch_size=1, seq_len=16,
                        force_fallback=BACKENDS[backend])


def test_missing_shard_raises_on_native(tmp_path):
    # The JAX loader drops to numpy here (and then fails reading); the
    # port's native route refuses the shards itself.
    with pytest.raises(ValueError, match="rejected the shards"):
        TokenDataLoader([str(tmp_path / "absent.bin")], batch_size=1,
                        seq_len=4)


def _os_threads() -> int:
    return len(os.listdir("/proc/self/task"))


@pytest.mark.skipif(not os.path.isdir("/proc/self/task"),
                    reason="needs Linux procfs to count OS threads")
def test_close_joins_prefetch_thread(shards):
    before = _os_threads()
    dl = TokenDataLoader(shards, batch_size=4, seq_len=32, seed=1,
                         prefetch=2)
    assert dl.native
    next(dl)
    assert _os_threads() == before + 1  # the C++ prefetch thread
    dl.close()
    # destroy() returns after joining it: gone at once.
    assert _os_threads() == before
    assert not dl.native
    dl.close()  # idempotent
