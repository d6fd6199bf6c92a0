"""The port's native host core (seldon_tpu_torch/native) against the JAX
package's (seldon_tpu/native): the tests/test_native.py cases on both,
bit for bit, on the port's native route and on its numpy route; the
library built under build/native/; a failed build raises instead of
falling back."""

import ctypes

import numpy as np
import pytest

from seldon_tpu import native as jax_native
from seldon_tpu_torch import native

ROUTES = [False, True]  # force_fallback: the native route, the numpy route


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("fallback", ROUTES)
def test_bf16_roundtrip_bit_equal_to_jax(fallback):
    x = (np.random.default_rng(0).standard_normal(4096) * 50).astype(
        np.float32
    )
    ours = native.f32_to_bf16(x, force_fallback=fallback)
    _bits_equal(ours, jax_native.f32_to_bf16(x))
    _bits_equal(native.bf16_to_f32(ours, force_fallback=fallback),
                jax_native.bf16_to_f32(jax_native.f32_to_bf16(x)))


@pytest.mark.parametrize("fallback", ROUTES)
def test_bf16_specials_bit_equal_to_jax(fallback):
    x = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45,
                  3.4e38, 65504.0, 1.00390625], np.float32)
    ours = native.f32_to_bf16(x, force_fallback=fallback)
    _bits_equal(ours, jax_native.f32_to_bf16(x))
    out = native.bf16_to_f32(ours, force_fallback=fallback)
    _bits_equal(out, jax_native.bf16_to_f32(jax_native.f32_to_bf16(x)))
    assert np.isnan(out[0])
    assert out[2] == np.inf and out[3] == -np.inf and out[4] == 0.0


@pytest.mark.parametrize("fallback", ROUTES)
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8])
def test_fuse_split_roundtrip_bit_equal_to_jax(fallback, dtype):
    rng = np.random.default_rng(1)
    parts = [rng.integers(0, 200, (i + 1, 3, 2)).astype(dtype)
             if np.issubdtype(dtype, np.integer)
             else (rng.standard_normal((i + 1, 3, 2)) * 100).astype(dtype)
             for i in range(4)]
    fused = native.fuse_rows(parts, force_fallback=fallback)
    _bits_equal(fused, jax_native.fuse_rows(parts))
    counts = [p.shape[0] for p in parts]
    back = native.split_rows(fused, counts, force_fallback=fallback)
    want = jax_native.split_rows(jax_native.fuse_rows(parts), counts)
    assert len(back) == len(want) == len(parts)
    for a, b, p in zip(back, want, parts):
        _bits_equal(a, b)
        _bits_equal(a, p)


@pytest.mark.parametrize("fallback", ROUTES)
def test_split_rejects_bad_counts(fallback):
    with pytest.raises(ValueError) as ours:
        native.split_rows(np.zeros((4, 2)), [1, 1], force_fallback=fallback)
    with pytest.raises(ValueError) as ref:
        jax_native.split_rows(np.zeros((4, 2)), [1, 1])
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("fallback", ROUTES)
def test_fuse_mixed_dtype_goes_through_numpy(fallback):
    a = np.zeros((1, 2), np.float32)
    b = np.ones((1, 2), np.float64)
    out = native.fuse_rows([a, b], force_fallback=fallback)
    assert out.dtype == np.float64 and out.shape == (2, 2)
    _bits_equal(out, jax_native.fuse_rows([a, b]))


def test_fuse_empty_raises_as_jax():
    with pytest.raises(ValueError):
        jax_native.fuse_rows([])
    with pytest.raises(ValueError):
        native.fuse_rows([])


def test_library_built_under_build_native():
    assert native.HAVE_NATIVE is True
    for so in native.SOURCES:
        lib = native.load_native_lib(so)
        assert isinstance(lib, ctypes.CDLL)
        path = native._lib_path(so)
        assert path.exists() and path.parent == native.BUILD_DIR
        assert native.BUILD_DIR.parts[-2:] == ("build", "native")
        assert lib._name == str(path)


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", "false")  # a compiler that always fails
    with pytest.raises(RuntimeError, match="building libseldon_native.so"):
        native.load_native_lib("libseldon_native.so")
    x = np.ones(4, np.float32)
    with pytest.raises(RuntimeError):
        native.f32_to_bf16(x)
    with pytest.raises(RuntimeError):
        native.fuse_rows([x[None], x[None]])
    assert native.HAVE_NATIVE is False
    # The numpy route is still there when asked for.
    _bits_equal(native.f32_to_bf16(x, force_fallback=True),
                jax_native.f32_to_bf16(x))
    assert not (tmp_path / "native").exists() or not any(
        p.suffix == ".so" and ".tmp" not in p.name
        for p in (tmp_path / "native").iterdir())


def test_unknown_library_raises():
    with pytest.raises(ValueError):
        native.load_native_lib("libnope.so")
